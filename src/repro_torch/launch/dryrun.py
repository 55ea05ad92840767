"""The dry run (``repro.launch.dryrun``): every (architecture x input-shape)
cell of ``configs/cells.py`` and the five ``configs/triangle_stream.py``
shapes, on the production mesh of 256 ranks (``pod``) or 512
(``multipod``), at full width with nothing allocated.

    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k [--multipod]
    python -m repro_torch.launch.dryrun --arch triangle-stream --shape coord_s1m_r2m
    python -m repro_torch.launch.dryrun --all --out-dir results/dryrun [--jobs 8]

The reference lowers each cell's step under ``jit`` with its shardings over
512 placeholder CPU devices and reads the compiled module. PyTorch has no
such partitioner. Here the mesh is ``launch/mesh.py::make_production_mesh``
with every rank on the ``meta`` device, a cell's arguments are the ``meta``
tensors of ``build_cell``, and its step runs on them, shapes only, under
``roofline/count.py::count_step`` (one ``StepCounter``). A stream cell
builds its ``EstimatorState`` and batch on ``meta`` (the key the port's
int64 (2,)), lays the state out with the plan's own ``layout`` over the
mesh and runs one update of ``make_pjit_update`` (``coordinated_xla``,
``independent``; ``n_valid`` a ``meta`` int32 scalar) or
``make_coordinated_update`` (``shardmap``, ``capacity_factor`` from
``--set``, default 2.0; ``n_valid`` the host int s, since the plan casts it
with ``int``).

The reference traces a layer stack, a chunk loop and the micro-batches
once each (``lax.scan``); the port's eager step runs every iteration, and
a ``prefill_32k`` step traced whole takes over 900 s. So an LM prefill or
decode cell is traced at ``FIT_LAYERS`` = 2, 3 and 4 layers (its other
overrides kept), and each count of the record is the degree-2 polynomial
through those three, taken at the config's ``n_layers`` in Python
integers and divided by ``chips`` only at the end (``model_counts``,
``fits_layers``). Their flops, aten ops and bytes are affine in the
layers, and their live-storage peak, a maximum over the step, is where
it was held to a whole trace: ``tests/test_torch_dryrun.py`` holds every count of the fit to a whole
trace at smoke width (6 layers) for every LM arch, ``chip_smoke.py``'s
phase cells at full width for smollm-135m ``decode_32k`` (batch 64), and
``tools/time_counters.py --whole`` at full width on the card's host
(``PERF.md`` §6, PR 27). A train step is traced whole: its bytes have a
constant second difference in the layers (one stacked gradient a layer),
which the fit would take, but its peak is a maximum over the forward, the
loss and the backward, and at full width the part that holds it changes
between 4 and 30 layers, so a fit from 2-4 layers is short of it. The
record's ``layer_fit`` is ``[2, 3, 4]`` (None where the step was traced
whole: train and non-LM cells, and an LM config of at most 4 layers).
A record (``--out-dir``/``{arch}__{shape}__{mesh}.json``) has
the reference's keys, which ``roofline/tables.py`` reads:

* ``chips`` (256 or 512), ``mesh``, ``arch``, ``shape``, ``ok``,
  ``overrides``, ``layer_fit``;
* ``model_flops`` and ``cost.flops_analytic_total`` (``roofline/flops.py``;
  absent for a stream cell, as in the reference): the reference's
  arithmetic, equal to its record, from the full cell;
* ``memory.argument_bytes``: every argument leaf's bytes on one rank, each
  dimension its spec shards ceil-divided by its axes' sizes
  (``train/sharding.py::local_bytes``), from the full cell. XLA's figure
  leaves out the arguments the step never reads (``jit``'s
  ``keep_unused=False``: the key of a GNN or LM train step, bert4rec's
  ``wu`` when it scores); counted with them, it equals this one up to the
  key's dtype (int64 (2,) here, uint32 (2,) there). ``output_bytes`` the
  same way from ``out_specs`` (the step's ``meta`` outputs, whole, where a
  cell has none); ``alias_bytes`` those of the outputs that are an
  argument tensor itself (identity; a ``meta`` storage has no address);
* ``memory.temp_bytes``: ``LiveBytes``' peak of the storages the whole
  step's ops made, less its new outputs' storages, over ``chips`` (rounded
  up): the floor of a perfect partition, as ``cost`` is. XLA's
  ``temp_size_in_bytes`` is one device's buffers after partitioning,
  fusion, scheduling and buffer reuse; this eager step fuses nothing and
  keeps every intermediate, on no partition, so it is a different
  quantity, comparable between cells and runs of the port;
* ``cost.flops`` and ``cost.bytes_accessed``: ``FlopCounterMode``'s (by its
  rules) and ``ByteCounter``'s counts over the whole step (every shard of a
  stream plan), divided by ``chips``: the floor of a perfect partition,
  without the work a partitioner replicates. ``FlopCounterMode`` counts
  products only, which no stream plan runs: a stream cell counts no flops
  and its ``cost.flops`` is 0;
* ``collectives``: ``roofline/collectives.py``'s dict, ``source``
  ``counted`` (a stream plan's own calls) or ``derived`` (a model cell's
  specs, with the ``rules`` that gave any; a floor);
* ``seconds_to_compile`` (the seconds of ``build_cell``, or of the stream
  cell's state, layout and plan, plus the trace; for a fitted record the
  full cell's build and the three traces) and ``hlo_size`` (the step's
  data-moving aten ops; fitted, the count a whole trace would give) keep
  the reference's names with these meanings.

A cell whose step fails on ``meta`` (a data-dependent shape, a host read
of a tensor) writes ``ok: false`` with the traceback, as a cell that fails
to compile does in the reference. ``--all`` runs every cell on both meshes,
one subprocess each (``--jobs`` at once, default 1), skipping those with an
``ok`` record; a subprocess past ``--timeout`` seconds is killed and its
cell written ``ok: false`` (the reference's ``--all`` stops there). Exit
codes are the reference's: 0, or 1 when a cell failed. With ``--jobs 8
--timeout 900`` on an 8-core host every cell finishes (``PERF.md`` §6).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import fractions
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import cells
from repro_torch.configs.triangle_stream import SHAPES as STREAM_SHAPES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import collectives
from repro_torch.roofline.count import count_step
from repro_torch.roofline.flops import cell_analytic_flops
from repro_torch.train.sharding import P, local_bytes, spec_leaves


def _bytes(tree, specs, mesh_shape) -> int:
    return sum(local_bytes(t, s, mesh_shape) for t, s in spec_leaves(tree, specs))


# the layer counts an LM cell is traced at; its counts are the degree-2
# polynomial through them, taken at the config's n_layers
FIT_LAYERS = (2, 3, 4)


def _trace(cell, sizes) -> dict:
    """One counted ``meta`` trace of ``cell``'s step: the whole step's
    counts (``count_step``) and the per-rank bytes of its outputs, in
    Python integers."""
    out, n = count_step(cell.fn, cell.args)
    if cell.out_specs is None:  # outputs left to the partitioner: count them whole
        outs = [(t, P()) for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    else:
        outs = list(spec_leaves(out, cell.out_specs))
    arg_ids = {id(t) for t in tree_leaves(cell.args)}
    return {"flops": n.flops, "bytes": n.bytes, "ops": n.ops, "peak": n.peak,
            "new_out_bytes": n.new_out_bytes,
            "output_bytes": sum(local_bytes(t, s, sizes) for t, s in outs),
            "alias_bytes": sum(local_bytes(t, s, sizes) for t, s in outs if id(t) in arg_ids)}


def fit_at(xs, ys, x) -> int:
    """The polynomial of degree ``len(xs) - 1`` through the integer points
    ``(xs, ys)``, at ``x``: Lagrange's form in exact fractions. Raises
    unless the value is an integer."""
    total = fractions.Fraction(0)
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        term = fractions.Fraction(yi)
        for j, xj in enumerate(xs):
            if j != i:
                term *= fractions.Fraction(x - xj, xi - xj)
        total += term
    if total.denominator != 1:
        raise ValueError(f"the fit through {list(zip(xs, ys))} is {total} at {x}")
    return int(total)


def _record(mesh, seconds, counts, argument_bytes, colls, model_flops) -> dict:
    """A record from a step's whole counts: cost and temporaries over the
    ranks, divided only here."""
    chips = mesh.size
    temp = max(counts["peak"] - counts["new_out_bytes"], 0)
    return {
        "chips": chips,
        "seconds_to_compile": seconds,
        "memory": {"argument_bytes": argument_bytes, "output_bytes": counts["output_bytes"],
                   "temp_bytes": -(-temp // chips), "alias_bytes": counts["alias_bytes"]},
        "cost": {"flops": counts["flops"] / chips, "bytes_accessed": counts["bytes"] / chips},
        "collectives": colls,
        "model_flops": model_flops,
        "hlo_size": counts["ops"],
    }


def fits_layers(cell) -> bool:
    """Whether the dry run fits ``cell``'s counts from ``FIT_LAYERS``: an
    LM prefill or decode step with more layers than those (module
    docstring)."""
    return (cell.arch in cells.LM_ARCHS and cell.kind != "train"
            and cell.config.n_layers > max(FIT_LAYERS))


def model_counts(arch: str, shape: str, axes, sizes, overrides=None, *,
                 smoke: bool = False) -> tuple:
    """(the cell, its step's counts, the layer counts they were fitted at
    or None). Where ``fits_layers``, the step is traced at each of
    ``FIT_LAYERS``, its other overrides kept, and every count is the
    degree-2 polynomial through those traces at the config's ``n_layers``;
    every other cell is traced whole, once. ``smoke`` builds the cell at
    its smoke config and shapes."""
    overrides = dict(overrides or {})
    cell = cells.build_cell(arch, shape, axes, smoke=smoke, overrides=overrides or None)
    if not fits_layers(cell):
        return cell, _trace(cell, sizes), None
    traces = [_trace(cells.build_cell(arch, shape, axes, smoke=smoke,
                                      overrides=overrides | {"n_layers": n}), sizes)
              for n in FIT_LAYERS]
    counts = {k: fit_at(FIT_LAYERS, [t[k] for t in traces], cell.config.n_layers)
              for k in traces[0]}
    return cell, counts, list(FIT_LAYERS)


def run_model_cell(arch: str, shape: str, multi_pod: bool, overrides=None) -> dict:
    """One model cell's record (module docstring; ``model_counts``)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = mesh.shape
    t0 = time.time()
    cell, counts, layers = model_counts(arch, shape, tuple(mesh.axis_names), sizes, overrides)
    seconds = time.time() - t0
    calls, rules = collectives.derive(cell, sizes)
    colls = collectives.collective_stats(calls) | {"source": "derived", "rules": rules}
    rec = _record(mesh, seconds, counts, _bytes(cell.args, cell.in_specs, sizes), colls,
                  cell.model_flops)
    rec["cost"]["flops_analytic_total"] = cell_analytic_flops(cell)  # None -> counted flops
    rec |= {"arch": arch, "shape": shape, "mesh": "multipod" if multi_pod else "pod",
            "layer_fit": layers}
    print(rec["memory"])
    print({"flops": rec["cost"]["flops"], "bytes accessed": rec["cost"]["bytes_accessed"]})
    return rec


def run_stream_cell(shape: str, multi_pod: bool, capacity_factor=2.0) -> dict:
    from repro_torch.core.distributed import (ShardedState, make_coordinated_update,
                                              make_pjit_update, scheme_state_specs)
    from repro_torch.core.state import EstimatorState

    mesh = make_production_mesh(multi_pod=multi_pod)
    axes = tuple(mesh.axis_names)
    spec = STREAM_SHAPES[shape]
    r, s, w_mode = spec["r"], spec["s"], spec["w_mode"]

    def sds(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    t0 = time.time()
    state = EstimatorState(
        f1=sds((r, 2), torch.int32),
        chi=sds((r,), torch.int32),
        f2=sds((r, 2), torch.int32),
        has_f3=sds((r,), torch.bool),
        m_seen=sds((), torch.int64),
    )
    W = sds((s, 2), torch.int32)
    nv = sds((), torch.int32)
    key = sds((2,), torch.int64)
    if w_mode == "shardmap":
        update = make_coordinated_update(mesh, r=r, s=s, capacity_factor=capacity_factor)
        n_valid = s  # the plan casts n_valid with int(), which a meta tensor refuses
    else:
        update = make_pjit_update(mesh, w_mode=w_mode, r=r)
        n_valid = nv
    sharded = ShardedState(update.layout.shard(state), update.layout)
    # the plans run no product that FlopCounterMode counts (a test holds its
    # count of a small update at 0), and skipping it saves a third of the trace
    with collectives.recording() as calls:
        out, n = count_step(update, (sharded, W, n_valid, key), flops=False)
    seconds = time.time() - t0
    sizes = mesh.shape
    state_specs = scheme_state_specs("global", axes)
    w_spec = P() if w_mode == "independent" else P(axes, None)
    out_state = out[0] if w_mode == "shardmap" else out
    counts = {
        "flops": 0, "bytes": n.bytes, "ops": n.ops, "peak": n.peak,
        "new_out_bytes": n.new_out_bytes,
        "output_bytes": _bytes(state, state_specs, sizes) + (8 if w_mode == "shardmap" else 0),
        "alias_bytes": sum(t.numel() * t.element_size() for t in out_state.shards[0]
                           if any(t is a for a in sharded.shards[0])),
    }
    # useful work floor: one pass of comparisons for sort(2s) + r estimator updates
    model_flops = 2 * s * max(math.log2(max(s, 2)), 1) + 4 * r
    colls = collectives.collective_stats(calls) | {"source": "counted"}
    argument_bytes = _bytes((state, W, nv, key), (state_specs, w_spec, P(), P()), sizes)
    rec = _record(mesh, seconds, counts, argument_bytes, colls, model_flops)
    rec |= {"arch": "triangle-stream", "shape": shape,
            "mesh": "multipod" if multi_pod else "pod"}
    print(rec["memory"])
    return rec


def _run_all(out_dir: pathlib.Path, timeout: int, jobs: int) -> int:
    todo = [(a, s) for a, s in cells.all_cells()]
    todo += [("triangle-stream", s) for s in STREAM_SHAPES]
    runs = []
    for arch, shape in todo:
        for mp in (False, True):
            tag = f"{arch}__{shape}__{'multipod' if mp else 'pod'}"
            out = out_dir / f"{tag}.json"
            if out.exists() and json.loads(out.read_text()).get("ok"):
                print(f"[skip] {tag}")
                continue
            runs.append((arch, shape, mp, tag, out))

    def one(run):
        arch, shape, mp, tag, out = run
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--out-dir", str(out_dir)] + (["--multipod"] if mp else [])
        print(f"[run ] {tag}", flush=True)
        t0 = time.time()
        try:
            pr = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
            rc, err = pr.returncode, pr.stderr
        except subprocess.TimeoutExpired:
            rc, err = None, f"timed out after {timeout} s"
        if rc != 0:
            out.write_text(json.dumps({
                "arch": arch, "shape": shape, "mesh": "multipod" if mp else "pod",
                "ok": False, "error": err[-4000:]}, indent=1))
            print(f"[FAIL] {tag}: {err[-400:]}", flush=True)
            return tag
        print(f"[ ok ] {tag} ({time.time()-t0:.0f}s)", flush=True)
        return None

    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(jobs, 1)) as pool:
        failures = [t for t in pool.map(one, runs) if t is not None]
    print(f"DONE failures={len(failures)} wall_s={time.time() - t0:.1f}: {failures}")
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="results/dryrun")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells run at once, one subprocess each")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (hillclimb experiments)")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        sys.exit(_run_all(out_dir, args.timeout, args.jobs))

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = json.loads(v)
    tag = f"{args.arch}__{args.shape}__{'multipod' if args.multipod else 'pod'}"
    if overrides:
        tag += "__" + "_".join(f"{k}-{v}" for k, v in overrides.items())
    try:
        if args.arch == "triangle-stream":
            rec = run_stream_cell(
                args.shape, args.multipod,
                capacity_factor=overrides.get("capacity_factor", 2.0),
            )
        else:
            rec = run_model_cell(args.arch, args.shape, args.multipod, overrides or None)
        rec["ok"] = True
        rec["overrides"] = overrides
    except Exception:
        traceback.print_exc()
        rec = {
            "arch": args.arch, "shape": args.shape,
            "mesh": "multipod" if args.multipod else "pod",
            "ok": False, "error": traceback.format_exc()[-4000:],
        }
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "ok")}))
    sys.exit(0 if rec["ok"] else 1)


if __name__ == "__main__":
    main()
