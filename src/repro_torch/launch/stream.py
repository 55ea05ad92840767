"""Streaming triangle-count CLI: a thin front end over TriangleCountEngine
(``repro.launch.stream``, single tenant).

Generates an edge stream, drains it through ``run_stream`` and prints the
reference CLI's lines: ``stream: m=.. tau=..``, ``processed ..``, then
``estimate: ..`` and ``rel.err ..`` where the true count is known, or for
``--scheme local`` the per-vertex line ``local[tenant 0] sum/3=.. top5=[..]
l1.err=..``. For the same arguments these lines are the JAX CLI's (run
there with ``--ckpt-every 0``). ``--ckpt-dir DIR --ckpt-every N`` saves a
checkpoint every N batches and resumes from DIR's newest one.

  PYTHONPATH=src python -m repro_torch.launch.stream --graph planted \\
      --triangles 300 --edges 20000 --nodes 30000 --estimators 65536 \\
      --batch 4096 --chunk 4              # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu --graph ba \\
      --nodes 500 --estimators 4096 --batch 512
  PYTHONPATH=src python -m repro_torch.launch.stream --scheme local --pools 4 \\
      --graph er --nodes 100 --edges 1500      # per-vertex counts, on the GPU
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core.sequential import count_triangles, local_triangle_counts
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
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_scheme_flags(ap)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; the run resumes from its newest "
                         "checkpoint that verifies")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save a checkpoint every N batches (0 = off)")
    ap.add_argument("--assert-rel-err", type=float, default=0.0,
                    help="exit nonzero unless the estimate lands within this "
                         "relative error of the true count")
    args = ap.parse_args(argv)
    if args.ckpt_every and not args.ckpt_dir:
        ap.error("--ckpt-every needs --ckpt-dir")

    edges, tau = make_stream(args)
    print(f"stream: m={len(edges)} tau={tau}", flush=True)
    engine = TriangleCountEngine(EngineConfig(
        r=args.estimators, batch_size=args.batch, groups=args.groups,
        seeds=(args.seed,), chunk_size=args.chunk, device=args.device,
        **scheme_args(args),
    ))
    rep = run_stream(engine, batches(edges, args.batch),
                     ckpt_dir=args.ckpt_dir if args.ckpt_every else None,
                     ckpt_every=args.ckpt_every)
    dt = max(rep.seconds, 1e-9)
    print(f"processed {rep.edges} edges in {dt:.2f}s "
          f"({rep.edges / dt / 1e6:.2f}M edges/s, r={args.estimators}, "
          f"device={engine.device})", flush=True)
    ests = engine.estimate()
    if args.scheme == "local":
        true_counts = None
        if tau is not None:
            true_counts = local_triangle_counts(edges, args.vertices or args.nodes)
        print_local_estimates(ests[0], 0, true_counts)
        return
    est = float(ests[0])
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
