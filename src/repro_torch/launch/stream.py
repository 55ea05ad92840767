"""Streaming triangle-count CLI: a thin front end over TriangleCountEngine
(``repro.launch.stream``, single tenant, ``global`` scheme).

Generates an edge stream, drains it through ``run_stream`` and prints the
reference CLI's lines: ``stream: m=.. tau=..``, ``processed ..``,
``estimate: ..`` and ``rel.err ..`` where the true count is known. For the
same graph, size, ``--chunk``, ``--groups`` and ``--seed`` its ``estimate:``
line is the JAX CLI's.

  PYTHONPATH=src python -m repro_torch.launch.stream --graph planted \\
      --triangles 300 --edges 20000 --nodes 30000 --estimators 65536 \\
      --batch 4096 --chunk 4              # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu --graph ba \\
      --nodes 500 --estimators 4096 --batch 512
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.sequential import count_triangles
from repro_torch.data.graph_stream import (
    barabasi_albert_stream,
    batches,
    erdos_renyi_stream,
    planted_triangle_stream,
)
from repro_torch.engine import EngineConfig, TriangleCountEngine, run_stream


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
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--assert-rel-err", type=float, default=0.0,
                    help="exit nonzero unless the estimate lands within this "
                         "relative error of the true count")
    args = ap.parse_args(argv)

    edges, tau = make_stream(args)
    print(f"stream: m={len(edges)} tau={tau}", flush=True)
    engine = TriangleCountEngine(EngineConfig(
        r=args.estimators, batch_size=args.batch, groups=args.groups,
        seeds=(args.seed,), chunk_size=args.chunk, device=args.device,
    ))
    rep = run_stream(engine, batches(edges, args.batch))
    dt = max(rep.seconds, 1e-9)
    print(f"processed {rep.edges} edges in {dt:.2f}s "
          f"({rep.edges / dt / 1e6:.2f}M edges/s, r={args.estimators}, "
          f"device={engine.device})", flush=True)
    est = float(engine.estimate()[0])
    print(f"estimate: {est:.1f}" + (
        f"  true: {tau}  rel.err: {abs(est - tau) / max(tau, 1):.3%}" if tau else ""))
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
