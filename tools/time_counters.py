#!/usr/bin/env python3
"""Host seconds of fitted dry-run records under each way of counting a
``meta`` trace: the three traces at 2, 3 and 4 layers of
``launch/dryrun.py::model_counts``, one subprocess a cell and way, all at
once; with ``--whole`` also each cell's whole step, traced once, to hold
the fit to.

    PYTHONPATH=src python3 tools/time_counters.py [--cells ARCH:SHAPE ...]
        [--ways stacked stacked_shapes single single_shapes] [--whole] [--timeout 1300]

Ways:

  stacked         ``FlopCounterMode``, ``count.ByteCounter`` and
                  ``count.LiveBytes`` stacked; each op runs its meta kernel;
  stacked_shapes  the same over a mode that runs each op through
                  ``count._MetaShapes``;
  single          one ``count.StepCounter``, each op running its meta kernel;
  single_shapes   ``count.count_step``: one ``StepCounter`` over
                  ``_MetaShapes``;
  whole           (``--whole``) ``count_step`` over all the config's layers.

Every cell is on the pod mesh at full width. Prints one JSON line a job
(the seconds of each trace and in all, the traced aten ops and ops a
second, the counts fitted at the config's ``n_layers`` or the whole
trace's), ``"timed_out"`` for a job past ``--timeout`` seconds, and one
line a cell saying whether every finished way fitted the same counts and,
with ``--whole``, which fitted counts differ from the whole trace's.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import cells
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import count


class _Shapes(TorchDispatchMode):
    """Runs each op through ``count._MetaShapes``."""

    def __init__(self):
        super().__init__()
        self.run = count._MetaShapes()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.run(func, args, kwargs or {})


def _stacked(fn, args, shapes: bool) -> count.StepCount:
    held = count._leaves(args)
    with contextlib.ExitStack() as stack:
        if shapes:
            stack.enter_context(_Shapes())
        fc = stack.enter_context(FlopCounterMode(display=False))
        moved = stack.enter_context(count.ByteCounter())
        live = stack.enter_context(count.LiveBytes(held))
        out = fn(*args)
    return count.StepCount(fc.get_total_flops(), moved.bytes, moved.ops, live.peak,
                           count._new_out_bytes(out, held))


def _single(fn, args) -> count.StepCount:
    held = count._leaves(args)
    mode = count.StepCounter(held)
    mode._run = count._plain
    with mode:
        out = fn(*args)
    return count.StepCount(mode.flops.total, mode.moved.bytes, mode.moved.ops, mode.live.peak,
                           count._new_out_bytes(out, held))


WAYS = {
    "stacked": lambda fn, args: _stacked(fn, args, shapes=False),
    "stacked_shapes": lambda fn, args: _stacked(fn, args, shapes=True),
    "single": _single,
    "single_shapes": lambda fn, args: count.count_step(fn, args)[1],
}


def run_way(way: str, arch: str, shape: str) -> dict:
    """One way's fitted record (or, ``whole``, one whole trace) of ``arch``
    ``shape`` on the pod mesh."""
    axes = tuple(make_production_mesh().axis_names)
    n_layers = cells.build_cell(arch, shape, axes).config.n_layers
    layers = (n_layers,) if way == "whole" else dryrun.FIT_LAYERS
    counter = WAYS.get(way, WAYS["single_shapes"])
    traces, seconds = [], []
    for n in layers:
        cell = cells.build_cell(arch, shape, axes, overrides={"n_layers": n})
        t0 = time.perf_counter()
        traces.append(vars(counter(cell.fn, cell.args)))
        seconds.append(time.perf_counter() - t0)
    counts = traces[0] if way == "whole" else {
        k: dryrun.fit_at(layers, [t[k] for t in traces], n_layers) for k in traces[0]}
    ops = sum(t["ops"] for t in traces)
    return {"way": way, "arch": arch, "shape": shape, "trace_s": seconds,
            "seconds": sum(seconds), "traced_aten_ops": ops,
            "aten_ops_per_s": ops / sum(seconds), "counts": counts}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", default=["smollm-135m:prefill_32k"])
    ap.add_argument("--ways", nargs="+", default=list(WAYS), choices=list(WAYS))
    ap.add_argument("--whole", action="store_true")
    ap.add_argument("--timeout", type=float, default=1300)
    ap.add_argument("--job", help=argparse.SUPPRESS)  # ARCH:SHAPE:WAY, in-process
    args = ap.parse_args()
    if args.job:
        torch.set_num_threads(1)
        arch, shape, way = args.job.split(":")
        print(json.dumps(run_way(way, arch, shape)))
        return 0
    ways = args.ways + (["whole"] if args.whole else [])
    procs = {(c, w): subprocess.Popen([sys.executable, __file__, "--job", f"{c}:{w}"],
                                      stdout=subprocess.PIPE, text=True)
             for c in args.cells for w in ways}
    results, t0, ok = {}, time.perf_counter(), True
    for (c, w), p in procs.items():
        try:
            out, _ = p.communicate(timeout=max(args.timeout - (time.perf_counter() - t0), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            print(json.dumps({"cell": c, "way": w, "timed_out": args.timeout}), flush=True)
            ok = False
            continue
        if p.returncode != 0:
            print(json.dumps({"cell": c, "way": w, "exit": p.returncode}), flush=True)
            ok = False
            continue
        results[c, w] = json.loads(out.strip().splitlines()[-1])
        print(json.dumps(results[c, w]), flush=True)
    for c in args.cells:
        fits = {w: results[c, w]["counts"] for w in args.ways if (c, w) in results}
        same = all(f == next(iter(fits.values())) for f in fits.values())
        line = {"cell": c, "finished": list(fits), "fitted_equal": same}
        if (c, "whole") in results:
            whole = results[c, "whole"]["counts"]
            line["differ_from_whole"] = sorted({k for f in fits.values() for k in f
                                                if f[k] != whole[k]})
        print(json.dumps(line), flush=True)
        ok = ok and same
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
