"""The paper's engine as a feature service for a GNN
(``examples/gnn_features.py``).

Streams a Barabasi-Albert graph once through the per-batch estimator
update to estimate its triangle density, then feeds that estimate as a
global node feature into a GAT node classifier: the point where the
streaming core and the model zoo meet.

  python -m repro_torch.launch.gnn_features               # on the card
  python -m repro_torch.launch.gnn_features --device cpu

It prints the example's lines (``streaming feature: triangles/edge = ..``,
``step .. loss ..`` every 20 steps, ``final loss ..``). The stream, the
estimator state and the GAT's params come from the example's seeds bit for
bit, so ``triangles/edge`` equals the reference's exactly. On the card the
per-batch update runs on the kernel route (``bulk_update_all`` with
``search="auto"``: the tile sort, the scans and ``multisearch_counts``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device, rng
from repro_torch.core.bulk import bulk_update_all
from repro_torch.core.estimate import estimate
from repro_torch.core.state import init_state
from repro_torch.data.graph_stream import barabasi_albert_stream, batches
from repro_torch.models.gnn import GNNConfig, init_params
from repro_torch.train.optimizer import adamw
from repro_torch.train.steps import make_gnn_train_step

# the example's node classifier
CFG = GNNConfig(name="gat-feat", kind="gat", n_layers=2, d_hidden=8, n_heads=4, d_in=2,
                n_classes=2, aggregator="attn")


def triangle_density(edges: np.ndarray, r: int, batch: int, device) -> float:
    """Triangles per edge of the stream ``edges``, estimated by r
    estimators fed batches of ``batch`` edges; batch i under
    ``fold_in(PRNGKey(0), i)``, as the example draws."""
    dev = resolve_device(device)
    state = init_state(r, dev)
    key = rng.PRNGKey(0, dev)
    for i, (W, nv) in enumerate(batches(edges, batch)):
        state = bulk_update_all(state, torch.from_numpy(W).to(dev), nv, rng.fold_in(key, i))
    return float(estimate(state)) / len(edges)


def node_task(edges: np.ndarray, n: int, tri_density: float, device) -> dict:
    """The example's GAT batch: node features (degree, the streamed
    density), labels ``degree > median`` and both edge directions."""
    dev = resolve_device(device)
    deg = np.zeros(n)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    feats = np.stack([deg, np.full(n, tri_density)], axis=1).astype(np.float32)
    labels = (deg > np.median(deg)).astype(np.int32)  # toy target
    ei = np.concatenate([edges.T, edges.T[::-1]], axis=1).astype(np.int32)
    return {"node_feats": torch.from_numpy(feats).to(dev),
            "edge_index": torch.from_numpy(ei).to(dev),
            "labels": torch.from_numpy(labels).to(dev),
            "label_mask": torch.ones((n,), dtype=torch.float32, device=dev)}


def run(n: int = 1500, k: int = 6, graph_seed: int = 3, r: int = 50_000, batch: int = 2048,
        steps: int = 60, lr: float = 5e-3, device="cuda", echo=print) -> dict:
    """The example end to end; returns the density, every step's loss, the
    host seconds of the streaming pass and of the training loop, and the
    GAT's batch (``node_task``)."""
    dev = resolve_device(device)
    edges = barabasi_albert_stream(n=n, k=k, seed=graph_seed)
    t0 = time.perf_counter()
    tri = triangle_density(edges, r, batch, dev)
    stream_s = time.perf_counter() - t0
    echo(f"streaming feature: triangles/edge = {tri:.3f}")

    params = init_params(rng.PRNGKey(1, dev), CFG)
    opt = adamw(lr=lr)
    opt_state = opt.init(params)
    step = make_gnn_train_step(CFG, opt)
    data = node_task(edges, n, tri, dev)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        params, opt_state, m = step(params, opt_state, data, None)
        losses.append(float(m["loss"]))
        if i % 20 == 0:
            echo(f"step {i:3d} loss {losses[-1]:.4f}")
    train_s = time.perf_counter() - t0
    echo(f"final loss {losses[-1]:.4f}")
    return {"edges": len(edges), "triangles_per_edge": tri, "losses": losses,
            "stream_seconds": stream_s, "train_seconds": train_s, "data": data}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
