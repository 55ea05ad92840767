"""Quickstart (``examples/quickstart.py``): approximate-count the triangles
of a streaming graph in a few lines of the package-level API.

A Barabasi-Albert graph arrives as a stream of edges; r independent
neighborhood-sampling estimators take it one batch at a time through
``bulk_update_all`` (batch i under ``fold_in(PRNGKey(0), i)``, as the
example draws), and ``estimate`` answers with their median of means.

  python -m repro_torch.launch.quickstart                 # on the card
  python -m repro_torch.launch.quickstart --device cpu

It prints the example's one line, ``edges=..  true tau=..  estimate=..
rel.err=..``, equal to the reference's character for character: the
stream and every draw come from the example's seeds, so the estimator
state is bit-identical. On the card the update runs on the kernel route
(the tile sort, the scans and ``multisearch_counts``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device, rng
from repro_torch.core import bulk_update_all, estimate, init_state
from repro_torch.core.sequential import count_triangles
from repro_torch.data.graph_stream import barabasi_albert_stream, batches
from repro_torch.interop import estimator_sha256


def run(n: int = 3000, k: int = 8, graph_seed: int = 0, r: int = 100_000,
        batch_size: int = 4096, device="cuda", echo=print) -> dict:
    """The example end to end on ``device``; returns the estimate, the
    stream's length, its true triangle count ``tau``, the final state's
    sha256 (``interop.estimator_sha256``) and the printed line."""
    dev = resolve_device(device)
    # a power-law graph arriving as a stream of edges
    edges = barabasi_albert_stream(n=n, k=k, seed=graph_seed)
    tau = count_triangles(edges)

    # r independent neighborhood-sampling estimators, updated one batch at a time
    state = init_state(r, dev)
    key = rng.PRNGKey(0, dev)
    for i, (W, n_valid) in enumerate(batches(edges, batch_size)):
        state = bulk_update_all(state, torch.from_numpy(W).to(dev), n_valid,
                                rng.fold_in(key, i))

    est = float(estimate(state, groups=9))
    line = (f"edges={len(edges)}  true tau={tau}  estimate={est:.0f}  "
            f"rel.err={abs(est - tau) / tau:.2%}")
    echo(line)
    return {"estimate": est, "edges": len(edges), "tau": tau,
            "state_sha256": estimator_sha256([x.cpu().numpy() for x in state]), "line": line}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
