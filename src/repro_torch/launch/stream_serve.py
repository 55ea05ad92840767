"""Serving CLI for the streaming counter: ingest forever, answer queries
(``repro.launch.stream_serve``).

Runs a TriangleCountEngine over an edge stream and answers rolling
triangle-count queries mid-stream, the service shape of the paper's
unbounded-stream setting. Two query surfaces:

  * ``--report-every K``: every K batches, print each tenant's rolling
    estimate (``query step=.. tenant=.. ..`` lines);
  * ``--interactive``: also read queries from stdin while ingesting: a
    tenant id (``0``), ``all`` or ``quit``, each answered from the live
    state between batches. A closed or failing stdin is reported and
    interactive mode disabled; it never stops the serve loop (only ``quit``
    does).

A failing stream source is caught, the final state still reported, and the
process exits non-zero; under ``--backpressure`` report queries are served
from the stale estimate cache (printed with ``stale_age=N``);
``--fault-plan`` injects deterministic faults for drills.

``--elastic`` serves through the slab-allocated ``ElasticBankEngine``
instead: ``--sessions`` tenant streams (seeded ``--seed + i``) churn through
``--capacity`` slots behind an ``ElasticServeLoop``, with queries answered
concurrently with ingest. Session 0 goes through snapshot, evict and
restore at its halfway point (through the verified checkpoint store with
``--ckpt-dir``) while the others keep ingesting. Each session's final
estimate prints as ``session .. m=.. estimate=.. rel.err=..``, then a
``served ..`` line of the bank's and the loop's counters. The elastic tier
is insertion-only.

For the same arguments the lines are the JAX CLI's. The port's ``--device``
picks the device (CUDA by default; without a GPU it raises unless
``--device cpu``).

  PYTHONPATH=src python -m repro_torch.launch.stream_serve --graph ba \\
      --nodes 5000 --tenants 4 --estimators 32768 --batch 4096 --report-every 4
  PYTHONPATH=src python -m repro_torch.launch.stream_serve --device cpu \\
      --graph er --nodes 40 --edges 300 --estimators 512 --batch 32 --elastic \\
      --capacity 2 --sessions 5 --chunk 4
"""
from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time

import numpy as np

from repro_torch.core.sequential import count_triangles
from repro_torch.data.graph_stream import batches, signed_batches
from repro_torch.engine import (
    ElasticBankEngine,
    ElasticServeLoop,
    run_signed_stream,
    run_stream,
)
from repro_torch.engine.faults import active_fault_plan
from repro_torch.launch.mesh import make_stream_mesh
from repro_torch.launch.stream import (
    add_dynamic_flags,
    add_resilience_flags,
    add_scheme_flags,
    build_engine,
    format_topk,
    install_cli_fault_plan,
    make_dynamic_stream,
    make_stream,
    print_resilience_summary,
    resilience_from_args,
    scheme_args,
    write_diag_json,
)

# out-of-band markers the stdin thread posts, so the serve loop can tell
# "stdin went away" (keep serving, say so) from a quit
_STDIN_CLOSED = "__stdin_closed__"
_STDIN_ERROR = "__stdin_error__"


def _print_rolling(step, ests, edges_seen, tau=None, stale_age=0) -> None:
    # stale_age > 0: a cached answer served under backpressure; ``step`` is
    # the step the answer belongs to, and the tag says so
    tag = f" stale_age={stale_age}" if stale_age else ""
    for t, e in enumerate(ests):
        if np.ndim(e) > 0:  # a per-vertex scheme (local): a summary per tenant
            line = (f"query step={step} tenant={t} m={int(edges_seen[t])} "
                    f"sum/3={float(np.sum(e)) / 3:.1f} "
                    f"top={format_topk(e, top=3)}{tag}")
        else:
            line = (f"query step={step} tenant={t} m={int(edges_seen[t])} "
                    f"estimate={float(e):.1f}{tag}")
            if tau and not stale_age:
                line += f" rel.err={abs(float(e) - tau) / max(tau, 1):.3%}"
        print(line, flush=True)


def _stdin_queries(q: queue.Queue) -> None:
    """Forward stdin lines to the query queue. End of input or a failing
    stdin is not a quit: only its marker is posted, and the serve loop
    keeps ingesting and answering ``--report-every`` queries."""
    try:
        for line in sys.stdin:
            q.put(line.strip())
            if line.strip() == "quit":
                return
    except Exception as e:  # stdin torn down (closed fd, decode error, ...)
        q.put((_STDIN_ERROR, repr(e)))
        return
    q.put(_STDIN_CLOSED)


class _Session:
    """One tenant's life in the elastic churn: hot-add, submit its
    stream through the serve loop's bounded queue, optionally snapshot,
    evict and restore at ``snap_at`` batches, then a final query once
    every batch is ingested, and evict."""

    def __init__(self, tid, seed, stream, snap_at=0):
        self.tid = tid
        self.seed = seed
        self.stream = stream  # list of (W, n_valid)
        self.i = 0  # batches submitted so far
        self.phase = "submit"  # -> snap | flush | final -> (removed)
        self.snap_at = snap_at
        self.final = None


def _elastic_rel_err(est, tau):
    val = float(np.sum(est)) / 3 if np.ndim(est) > 0 else float(est)
    err = abs(val - tau) / max(tau, 1) if tau else None
    return val, err


def drive_sessions(loop, bank, todo: list, *, report_every: int, save: bool,
                   on_restore=None, on_final=None) -> None:
    """Churn ``_Session``s through a started serve loop until every one has
    finished: admit sessions into free slots (never growing the bank),
    submit their batches (a refused submit is retried on a later pass), ask
    a rolling query every ``report_every`` batches, run a session's
    snapshot, evict and restore once its first ``snap_at`` batches are
    ingested (through the loop's checkpoint store where ``save``), and once
    its stream is ingested take its final answer and evict it.
    ``on_restore(session, step)`` and ``on_final(session, answer)`` see
    those events, in the order they happen."""
    live: dict = {}
    while todo or live:
        while todo and len(live) < bank.capacity:
            s = todo.pop(0)
            loop.add_tenant(s.tid, seed=s.seed).result(60)
            live[s.tid] = s
        progress = False
        for s in list(live.values()):
            if s.phase == "submit":
                if s.i >= len(s.stream):
                    s.phase = "flush"
                    continue
                W, nv = s.stream[s.i]
                if loop.submit(s.tid, W, nv):  # False: backpressure
                    s.i += 1
                    progress = True
                    if s.i % report_every == 0:
                        loop.query(s.tid)  # a rolling query, answered meanwhile
                    if s.snap_at and s.i == s.snap_at:
                        s.phase = "snap"
            elif s.phase == "snap":
                if bank.step_of(s.tid) < s.i:
                    continue  # queued batches still draining
                snap = loop.snapshot_tenant(s.tid, save=save).result(60)
                loop.evict_tenant(s.tid).result(60)
                if save:
                    loop.restore_tenant(s.tid, step=int(snap["step"])).result(60)
                else:
                    loop.restore_tenant(s.tid, snap=snap).result(60)
                if on_restore is not None:
                    on_restore(s, int(snap["step"]))
                s.phase = "submit"
                progress = True
            elif s.phase == "flush":
                if bank.step_of(s.tid) >= s.i:  # every batch ingested
                    s.final = loop.query(s.tid)
                    s.phase = "final"
                    progress = True
            elif s.phase == "final" and s.final.done():
                if on_final is not None:
                    on_final(s, s.final.result())
                loop.evict_tenant(s.tid).result(60)
                del live[s.tid]
                progress = True
        if not progress:
            time.sleep(0.002)


def run_elastic(args) -> None:
    """The elastic mode: ``--sessions`` tenant streams churn through a
    ``--capacity``-slot bank; each session's final estimate, taken once its
    stream is ingested, is checked against the exact count under
    ``--assert-rel-err``."""
    if args.deletions or args.window or args.decay:
        sys.exit("--elastic is insertion-only (no turnstile/window/decay)")
    edges, tau = make_stream(args)
    install_cli_fault_plan(args)
    mesh = make_stream_mesh(args.mesh or "", device=args.device, host_devices=args.host_devices)
    bank = ElasticBankEngine(
        args.estimators, args.batch, capacity=args.capacity, backend=args.backend, mesh=mesh,
        groups=args.groups, chunk_size=args.chunk, tenant_axis=args.tenant_axis,
        device=args.device, **scheme_args(args))
    if mesh is not None:
        print(f"mesh: {dict(mesh.shape)} -> plan {bank.backend}", flush=True)
    n_sessions = args.sessions or 2 * bank.capacity
    stream = list(batches(edges, args.batch))
    print(f"stream: m={len(edges)} tau={tau} sessions={n_sessions} "
          f"capacity={bank.capacity} backend={bank.backend}", flush=True)

    loop = ElasticServeLoop(bank, queue_depth=args.queue_depth, queue_policy=args.queue_policy,
                            resilience=resilience_from_args(args),
                            checkpoint=args.ckpt_dir).start()
    todo = [_Session(f"s{sid}", args.seed + sid, stream,
                     snap_at=len(stream) // 2 if sid == 0 and len(stream) > 1 else 0)
            for sid in range(n_sessions)]
    failures = []

    def on_restore(s, step):
        print(f"serve: {s.tid} snapshot/evict/restore at step {step} under live traffic",
              flush=True)

    def on_final(s, answer):
        val, err = _elastic_rel_err(answer["estimate"], tau)
        line = f"session {s.tid} m={len(edges)} estimate={val:.1f}"
        if err is not None:
            line += f" rel.err={err:.3%}"
            if args.assert_rel_err and err > args.assert_rel_err:
                failures.append((s.tid, err))
        print(line, flush=True)

    t0 = time.perf_counter()
    try:
        drive_sessions(loop, bank, todo, report_every=max(args.report_every, 1),
                       save=bool(args.ckpt_dir), on_restore=on_restore, on_final=on_final)
    finally:
        stats = loop.stop()
    dt = time.perf_counter() - t0
    d = bank.diag
    print(f"served {n_sessions} sessions x {len(edges)} edges in {dt:.2f}s: "
          f"hot_adds={d.hot_adds} evictions={d.evictions} "
          f"restores={d.restores} tier_compiles={d.tier_compiles} "
          f"queries={stats.queries_answered} "
          f"(degraded={stats.degraded_queries}) retries={stats.retries}", flush=True)
    if args.diag_json:
        plan = active_fault_plan()
        with open(args.diag_json, "w") as f:
            json.dump({"diag": loop.report(), "fault_plan": plan.summary() if plan else None},
                      f, indent=2)
        print(f"diag written to {args.diag_json}", flush=True)
    if failures:
        sys.exit(f"rel.err exceeded {args.assert_rel_err:.3%} for "
                 + ", ".join(f"{t} ({e:.3%})" for t, e in failures))
    if args.assert_rel_err and tau:
        print(f"rel.err within {args.assert_rel_err:.3%} for all "
              f"{n_sessions} sessions OK", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", choices=("ba", "er", "planted"), default="ba")
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--edges", type=int, default=20000)
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--triangles", type=int, default=100)
    ap.add_argument("--estimators", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=1,
                    help="batches fused per dispatch (see launch.stream)")
    ap.add_argument("--groups", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default="auto")
    add_scheme_flags(ap)
    add_dynamic_flags(ap)
    add_resilience_flags(ap)
    ap.add_argument("--mesh", default="",
                    help="device mesh spec, e.g. 'tenants=2,estimators=4' "
                         "(repro_torch.launch.mesh.make_stream_mesh)")
    ap.add_argument("--tenant-axis", default="tenants",
                    help="mesh axis carrying the bank's tenant dimension")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="put all N shards of the mesh on the one --device")
    ap.add_argument("--report-every", type=int, default=4)
    ap.add_argument("--repeat", type=int, default=1,
                    help="replay the generated stream this many times "
                         "(simulates a longer-lived service)")
    ap.add_argument("--interactive", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--elastic", action="store_true",
                    help="serve through the slab-allocated elastic bank: "
                         "--sessions tenant streams churn (hot-add/evict) "
                         "through --capacity slots with queries answered "
                         "concurrently with ingest")
    ap.add_argument("--capacity", type=int, default=2,
                    help="elastic bank slot count (rounded up to a power "
                         "of 2); the session churn never grows past it")
    ap.add_argument("--sessions", type=int, default=0,
                    help="tenant sessions to cycle through the elastic "
                         "bank (0 = 2x capacity)")
    ap.add_argument("--queue-depth", type=int, default=64,
                    help="per-tenant bounded ingest queue depth")
    ap.add_argument("--queue-policy", choices=("drop", "stall"), default="stall",
                    help="full-queue policy: drop newest, or stall the "
                         "producer (counted either way in diag)")
    ap.add_argument("--assert-rel-err", type=float, default=0.0,
                    help="elastic mode: exit nonzero unless every session's "
                         "final estimate is within this relative error")
    args = ap.parse_args(argv)

    if args.elastic:
        run_elastic(args)
        return

    edges, tau = make_stream(args)
    signed = None
    if args.deletions or args.window or args.decay:
        if args.deletions and args.repeat > 1:
            sys.exit("--deletions with --repeat > 1 would re-insert edges "
                     "that are still live (single-live-copy contract)")
        stream, live = make_dynamic_stream(args, edges)
        if args.deletions:
            signed = stream
        tau = count_triangles(live) if len(live) <= 2_000_000 else None
        print(f"stream: m={len(edges)} live={len(live)} tau_live={tau} "
              f"tenants={args.tenants}", flush=True)
    else:
        print(f"stream: m={len(edges)} tau={tau} tenants={args.tenants}", flush=True)
    install_cli_fault_plan(args)
    engine = build_engine(args)

    qq: queue.Queue = queue.Queue()
    if args.interactive:
        threading.Thread(target=_stdin_queries, args=(qq,), daemon=True).start()

    stop = False
    interactive_down = False

    def on_report(step, ests, seen, stale_age=0):
        nonlocal stop, interactive_down
        _print_rolling(step, ests, seen, tau, stale_age)
        # take every pending command, then answer them in order from one
        # bank query: each sees the same state, and the report above filled
        # the engine's cache, so the whole batch costs no further query
        cmds: list = []
        while not qq.empty():
            cmds.append(qq.get_nowait())
        queries = [c for c in cmds if isinstance(c, str) and c not in ("quit", _STDIN_CLOSED)]
        if queries:
            answers = engine.estimate()
        for cmd in cmds:
            if cmd == "quit":
                stop = True
            elif cmd == _STDIN_CLOSED:
                if not interactive_down:
                    print("serve: stdin closed — interactive queries "
                          "disabled, still serving", flush=True)
                interactive_down = True
            elif isinstance(cmd, tuple) and cmd[0] == _STDIN_ERROR:
                if not interactive_down:
                    print(f"serve: stdin error {cmd[1]} — interactive "
                          "queries disabled, still serving", flush=True)
                interactive_down = True
            elif cmd == "all" or cmd == "":
                _print_rolling(step, answers, engine.edges_seen(), tau)
            else:
                # one bad id errors alone and never swallows another answer
                try:
                    t = int(cmd)
                except ValueError:
                    t = -1
                if not 0 <= t < engine.n_tenants:
                    print(f"answer error=bad query {cmd!r}", flush=True)
                elif np.ndim(answers[t]) > 0:  # a per-vertex scheme: sum/3
                    print(f"answer tenant={t} sum/3={float(np.sum(answers[t])) / 3:.1f}",
                          flush=True)
                else:
                    print(f"answer tenant={t} estimate={float(answers[t]):.1f}", flush=True)
        if stop:
            raise KeyboardInterrupt

    def feed():
        for _ in range(args.repeat):
            if signed is not None:
                yield from signed_batches(signed, args.batch)
            else:
                yield from batches(edges, args.batch)

    # deletion batches need the signed loop (reports and resume on
    # dyn_step); window and decay streams stay on the plain loop, where the
    # engine's window clock authors the expiries itself
    runner = run_signed_stream if signed is not None else run_stream
    rep = None
    failed = None
    try:
        rep = runner(engine, feed(), ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     report_every=max(args.report_every, 1), on_report=on_report,
                     resilience=resilience_from_args(args))
    except KeyboardInterrupt:
        print("serve: stopped by query loop", flush=True)
    except Exception as e:  # a failing source or ingest: report the state, exit non-zero
        failed = e
        print(f"serve: ingest loop failed: {e!r} — reporting final state", flush=True)
    _print_rolling(engine.step, engine.estimate(), engine.edges_seen(), tau)
    if rep is not None:
        print(f"served {rep.edges} edges in {rep.seconds:.2f}s "
              f"({rep.edges_per_s / 1e6:.2f}M edges/s x {args.tenants} tenants)", flush=True)
        print_resilience_summary(engine, rep)
        write_diag_json(args.diag_json, engine, rep)
    if failed is not None:
        sys.exit(1)


if __name__ == "__main__":
    main()
