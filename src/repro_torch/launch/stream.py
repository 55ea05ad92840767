"""Streaming triangle-count CLI: a thin front end over TriangleCountEngine
(``repro.launch.stream``).

Generates an edge stream, drains it through ``run_stream`` and prints the
reference CLI's lines: ``stream: m=.. tau=..``, ``processed ..``, then
``estimate: ..`` and ``rel.err ..`` where the true count is known, or for
``--scheme local`` the per-vertex line ``local[tenant 0] sum/3=.. top5=[..]
l1.err=..``. With ``--tenants N`` the same stream is counted by N
independent estimator banks seeded ``--seed + t`` in one bank: tenant 0 is
the one-tenant run bit for bit, an ``estimate[tenant t]: ..`` line follows
``estimate:`` for each further tenant (a ``local[tenant t]`` line each
under ``--scheme local``). For the same arguments these lines are the JAX
CLI's (run there with ``--ckpt-every 0``). ``--ckpt-every N`` saves a checkpoint every
N batches into ``--ckpt-dir`` (default ``repro_stream_ckpt`` in the temp
directory, ``/tmp`` unless ``TMPDIR`` says otherwise) and resumes from its
newest one.

Dynamic streams: ``--deletions p`` deletes each edge later in the stream
with probability p and drains the signed stream through
``run_signed_stream``; ``--window N`` keeps the newest N inserted edges
live, ``--decay D`` gives each a lifetime of mean D insertions. The
``stream:`` line then reads ``m=.. signed=.. live=.. tau_live=..``, a
``dynamic:`` line counts deletion batches and expired edges, and the truth
behind ``estimate:`` (or ``local[tenant 0]``) is the live edge set.

Resilience, as in the JAX CLI: ``--fault-plan`` installs a deterministic
fault plan (``site:kind@AT[xTIMES][~DELAY_S]``, comma-joined; it prints
``fault plan installed: ..``), ``--max-retries``/``--retry-base`` set the
bounded backoff, ``--backpressure``, ``--query-timeout`` and
``--no-validate`` the rest of the ``ResilienceConfig``. A ``resilience: ..``
line follows ``processed`` whenever a retry, quarantine, duplicate, stale
answer, query fallback or corrupt checkpoint happened, and ``--diag-json``
writes the engine's diag, the report's counters and the plan's summary. A
fault that outlasts the retries ends the run with a traceback and a
non-zero exit.

Meshes, as in the JAX CLI: ``--mesh`` lays out a one-process device mesh
(``repro_torch.launch.mesh.make_stream_mesh``: ``8``, ``tenants=2``,
``tenants=2,estimators=4``), ``--backend`` names the execution plan
(``auto`` picks one from the mesh, as the reference does), ``--tenant-axis``
the mesh axis the bank's tenants shard over, and ``--host-devices N`` puts
all N shards on the one device ``--device`` names (without it a mesh of n
shards takes n devices). A ``mesh: {..} -> plan ..`` line then follows the
``stream:`` line.

  PYTHONPATH=src python -m repro_torch.launch.stream --graph planted \\
      --triangles 300 --edges 20000 --nodes 30000 --estimators 65536 \\
      --batch 4096 --chunk 4              # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu --graph ba \\
      --nodes 500 --estimators 4096 --batch 512
  PYTHONPATH=src python -m repro_torch.launch.stream --scheme local --pools 4 \\
      --graph er --nodes 100 --edges 1500      # per-vertex counts, on the GPU
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu --graph er \\
      --nodes 30 --edges 200 --estimators 4096 --batch 16 --deletions 0.2
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu --graph ba \\
      --nodes 500 --estimators 4096 --batch 512 --tenants 3
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu --graph ba \\
      --nodes 500 --estimators 4096 --batch 512 --chunk 2 --retry-base 0.001 \\
      --fault-plan engine.ingest_chunk:raise@1,prefetch.get:dup@2 --diag-json diag.json
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu --graph ba \
      --nodes 500 --estimators 4096 --batch 512 --chunk 2 --tenants 4 \
      --host-devices 4 --mesh tenants=2,estimators=2   # tenant-sharded bank
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

from repro_torch.core.sequential import count_triangles, local_triangle_counts
from repro_torch.data.graph_stream import (
    barabasi_albert_stream,
    batches,
    churn_stream,
    dynamic_live_edges,
    erdos_renyi_stream,
    planted_triangle_stream,
    signed_batches,
)
from repro_torch.engine import (
    EngineConfig,
    ResilienceConfig,
    RetryPolicy,
    TriangleCountEngine,
    install_fault_plan,
    parse_fault_plan,
    run_signed_stream,
    run_stream,
)
from repro_torch.engine.faults import active_fault_plan
from repro_torch.launch.mesh import make_stream_mesh


def make_stream(args):
    if args.graph == "ba":
        edges = barabasi_albert_stream(args.nodes, args.degree, seed=args.seed)
        tau = count_triangles(edges) if args.nodes <= 20000 else None
    elif args.graph == "er":
        edges = erdos_renyi_stream(args.nodes, args.edges, seed=args.seed)
        tau = count_triangles(edges) if args.edges <= 2_000_000 else None
    else:
        edges, tau = planted_triangle_stream(
            args.triangles, args.edges, args.nodes, seed=args.seed)
    return edges, tau


def scheme_args(args) -> dict:
    """EngineConfig scheme kwargs from the CLI flags."""
    params = None
    if args.scheme == "local":
        params = (("n_pools", args.pools), ("n_vertices", args.vertices or args.nodes))
    return {"scheme": args.scheme, "scheme_params": params}


def add_scheme_flags(ap) -> None:
    ap.add_argument("--scheme", default="global",
                    help="estimator scheme: any name in repro_torch.core.schemes.SCHEMES "
                         "(global = one triangle count; local = per-vertex counts via "
                         "vertex-partitioned pools; naive = the edge-at-a-time strawman)")
    ap.add_argument("--vertices", type=int, default=0,
                    help="local scheme: vertex-id bound for the per-vertex output "
                         "(0 = use --nodes)")
    ap.add_argument("--pools", type=int, default=1,
                    help="local scheme: estimator pools vertices hash into "
                         "(must divide --estimators)")


def add_dynamic_flags(ap) -> None:
    """The turnstile and window flags."""
    ap.add_argument("--deletions", type=float, default=0.0,
                    help="turnstile churn: each edge is deleted later in the stream "
                         "with this probability (0 = insertion-only)")
    ap.add_argument("--window", type=int, default=0,
                    help="count-based sliding window: keep only the most recent N "
                         "inserted edges live (0 = unbounded)")
    ap.add_argument("--decay", type=float, default=0.0,
                    help="exponential decay: mean edge lifetime in insertions, > 1 "
                         "(0 = off; excludes --window)")


def add_resilience_flags(ap) -> None:
    """The chaos and resilience flags, the JAX CLI's."""
    ap.add_argument("--fault-plan", default="",
                    help="inject deterministic faults: comma-joined "
                         "site:kind@AT[xTIMES][~DELAY_S] specs, e.g. "
                         "'engine.ingest:raise@3x2,checkpoint.write:torn@1' "
                         "(sites and kinds: repro_torch.engine.faults)")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="bounded retries (exponential backoff + jitter) for "
                         "transient source, ingest and stage faults")
    ap.add_argument("--retry-base", type=float, default=0.02,
                    help="base backoff seconds (doubles per attempt)")
    ap.add_argument("--query-timeout", type=float, default=0.0,
                    help="per-query bound on a sharded plan's device-resident "
                         "estimate (no effect on the single plan; 0 = unbounded)")
    ap.add_argument("--backpressure", type=int, default=0,
                    help="answer report queries from the (stale, tagged) estimate "
                         "cache when the prefetch backlog reaches this depth "
                         "(0 = always query fresh)")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip batch validation and quarantine (trusted source)")
    ap.add_argument("--diag-json", default="",
                    help="write the engine's diag and the resilience counters to "
                         "this JSON file at exit")


def resilience_from_args(args) -> ResilienceConfig:
    return ResilienceConfig(
        retry=RetryPolicy(max_retries=args.max_retries, base_s=args.retry_base, seed=args.seed),
        validate=not args.no_validate,
        query_timeout_s=args.query_timeout or None,
        backpressure_depth=args.backpressure,
    )


def install_cli_fault_plan(args) -> None:
    """Parse and install ``--fault-plan`` process-wide (no-op when empty)."""
    plan = parse_fault_plan(args.fault_plan, seed=args.seed)
    if plan is not None:
        install_fault_plan(plan)
        print(f"fault plan installed: {args.fault_plan}", flush=True)


def write_diag_json(path: str, engine, rep) -> None:
    """The engine's diag, the report's resilience counters and the installed
    plan's summary as one JSON file, with the JAX CLI's keys."""
    if not path:
        return
    plan = active_fault_plan()
    payload = {
        "diag": dataclasses.asdict(engine.diag),
        "report": {
            "batches": rep.batches,
            "edges": rep.edges,
            "resumed_from": rep.resumed_from,
            "retries": rep.retries,
            "quarantined_batches": rep.quarantined_batches,
            "duplicate_batches": rep.duplicate_batches,
            "degraded_queries": rep.degraded_queries,
            "max_staleness": rep.max_staleness,
            "query_fallbacks": rep.query_fallbacks,
            "dead_letter_reasons": rep.dead_letters.reasons() if rep.dead_letters else [],
        },
        "fault_plan": plan.summary() if plan else None,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"diag written to {path}", flush=True)


def print_resilience_summary(engine, rep) -> None:
    """One line of resilience accounting where anything happened (silent on
    the happy path)."""
    d = engine.diag
    if not any((rep.retries, rep.quarantined_batches, rep.duplicate_batches,
                rep.degraded_queries, rep.query_fallbacks, d.ckpt_corrupt_skipped)):
        return
    print(f"resilience: retries={rep.retries} "
          f"quarantined={rep.quarantined_batches} "
          f"duplicates={rep.duplicate_batches} "
          f"degraded_queries={rep.degraded_queries} "
          f"(max_staleness={rep.max_staleness}) "
          f"query_fallbacks={rep.query_fallbacks} "
          f"ckpt_corrupt_skipped={d.ckpt_corrupt_skipped}", flush=True)


def build_engine(args) -> TriangleCountEngine:
    """The engine the flags describe (a bank of ``--tenants`` seeded
    ``--seed + t``), on the mesh ``--mesh`` lays out; prints the ``mesh:``
    line where there is one."""
    mesh = make_stream_mesh(args.mesh, device=args.device, host_devices=args.host_devices)
    engine = TriangleCountEngine(EngineConfig(
        r=args.estimators, batch_size=args.batch, groups=args.groups,
        n_tenants=args.tenants, seeds=tuple(args.seed + t for t in range(args.tenants)),
        backend=args.backend, tenant_axis=args.tenant_axis,
        chunk_size=args.chunk, window=args.window, decay=args.decay,
        device=args.device, **scheme_args(args),
    ), mesh=mesh)
    if mesh is not None:
        print(f"mesh: {dict(mesh.shape)} -> plan {engine.plan.name}", flush=True)
    return engine


def make_dynamic_stream(args, edges):
    """(signed stream, live edge set) for the dynamic flags: the live set,
    after deletions and window or decay expiry, is the estimate's truth."""
    if args.deletions:
        stream = churn_stream(edges, args.deletions, seed=args.seed + 1)
    else:  # window/decay only: an all-insert signed stream
        stream = np.concatenate([edges, np.ones((len(edges), 1), np.int32)], axis=1)
    live = dynamic_live_edges(stream, window=args.window, decay=args.decay, seed=args.seed)
    return stream, live


def format_topk(est, true_counts=None, top: int = 5) -> str:
    """``v:est`` (optionally ``(true t)``) for the top vertices."""
    parts = []
    for vtx in np.argsort(est)[::-1][:top]:
        s = f"{int(vtx)}:{float(est[vtx]):.1f}"
        if true_counts is not None:
            s += f"(true {int(true_counts[vtx])})"
        parts.append(s)
    return f"[{' '.join(parts)}]"


def print_local_estimates(est, tenant, true_counts=None, top: int = 5) -> None:
    """Per-vertex output: the sum/3 global cross-check plus the top vertices."""
    line = (f"local[tenant {tenant}] sum/3={float(est.sum()) / 3:.1f} "
            f"top{top}={format_topk(est, true_counts, top)}")
    if true_counts is not None:
        denom = np.maximum(true_counts.sum(), 1)
        line += f" l1.err={np.abs(est - true_counts).sum() / denom:.3%}"
    print(line, flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", choices=("ba", "er", "planted"), default="ba")
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--edges", type=int, default=20000)
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--triangles", type=int, default=100)
    ap.add_argument("--estimators", type=int, default=65536)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=1,
                    help="batches fused per update; state is bit-identical for any value")
    ap.add_argument("--groups", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tenants", type=int, default=1,
                    help="independent estimator banks over the same stream, seeded "
                         "--seed + t")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default="auto",
                    help="auto or any name in repro_torch.engine.backends.BACKENDS")
    ap.add_argument("--mesh", default="",
                    help="device mesh spec, e.g. '8' or 'tenants=2,estimators=4' "
                         "(repro_torch.launch.mesh.make_stream_mesh)")
    ap.add_argument("--tenant-axis", default="tenants",
                    help="mesh axis carrying the bank's tenant dimension")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="put all N shards of the mesh on the one --device (a mesh "
                         "on one card, or on the CPU)")
    add_scheme_flags(ap)
    add_dynamic_flags(ap)
    add_resilience_flags(ap)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_stream_ckpt"),
                    help="checkpoint directory, used where --ckpt-every is set; the "
                         "run resumes from its newest checkpoint that verifies")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save a checkpoint every N batches (0 = off)")
    ap.add_argument("--assert-rel-err", type=float, default=0.0,
                    help="exit nonzero unless the estimate lands within this "
                         "relative error of the true count")
    args = ap.parse_args(argv)

    edges, tau = make_stream(args)
    dynamic = bool(args.deletions or args.window or args.decay)
    truth_edges = edges
    if dynamic:
        stream, truth_edges = make_dynamic_stream(args, edges)
        tau = count_triangles(truth_edges) if len(truth_edges) <= 2_000_000 else None
        print(f"stream: m={len(edges)} signed={len(stream)} live={len(truth_edges)} "
              f"tau_live={tau}", flush=True)
    else:
        print(f"stream: m={len(edges)} tau={tau}", flush=True)
    install_cli_fault_plan(args)
    engine = build_engine(args)
    ckpt = {"ckpt_dir": args.ckpt_dir if args.ckpt_every else None,
            "ckpt_every": args.ckpt_every, "resilience": resilience_from_args(args)}
    if args.deletions:
        # deletion batches break insert runs, so the signed loop drives it
        rep = run_signed_stream(engine, signed_batches(stream, args.batch), **ckpt)
    else:
        rep = run_stream(engine, batches(edges, args.batch), **ckpt)
    dt = max(rep.seconds, 1e-9)
    print(f"processed {rep.edges} edges in {dt:.2f}s "
          f"({rep.edges / dt / 1e6:.2f}M edges/s, r={args.estimators}, "
          f"device={engine.device})", flush=True)
    print_resilience_summary(engine, rep)
    write_diag_json(args.diag_json, engine, rep)
    if dynamic:
        print(f"dynamic: deletes={engine.diag.delete_batches} batches "
              f"expired={engine.diag.window_expired} edges "
              f"(dyn_step={engine.dyn_step})", flush=True)
    ests = engine.estimate()
    if args.scheme == "local":
        true_counts = None
        if tau is not None:
            true_counts = local_triangle_counts(truth_edges, args.vertices or args.nodes)
        for t in range(args.tenants):
            print_local_estimates(ests[t], t, true_counts)
        return
    est = float(ests[0])
    print(f"estimate: {est:.1f}" + (
        f"  true: {tau}  rel.err: {abs(est - tau) / max(tau, 1):.3%}" if tau else ""))
    for t in range(1, args.tenants):
        e = float(ests[t])
        print(f"estimate[tenant {t}]: {e:.1f}" + (
            f"  rel.err: {abs(e - tau) / max(tau, 1):.3%}" if tau else ""))
    if args.assert_rel_err:
        if tau is None:
            sys.exit("--assert-rel-err needs a computable true count")
        err = abs(est - tau) / max(tau, 1)
        if err > args.assert_rel_err:
            sys.exit(f"estimate {est:.1f} misses true {tau} by {err:.3%} "
                     f"(> {args.assert_rel_err:.3%})")
        print(f"rel.err {err:.3%} within {args.assert_rel_err:.3%} OK")


if __name__ == "__main__":
    main()
