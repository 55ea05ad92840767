"""k-hop neighbor sampling over CSR adjacency, GraphSAGE-style fanouts
(``repro.data.sampler``).

A copy, not an import: ``repro`` imports jax. Host-side numpy that makes
the same draws in the same order as the reference, so the same
``np.random.Generator`` gives the same padded subgraph arrays; their
static shapes are what the device step sees for every batch.
"""
from __future__ import annotations

import numpy as np


class CSRGraph:
    def __init__(self, n_nodes: int, edges: np.ndarray):
        """edges: (E, 2) undirected; builds symmetric CSR."""
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        order = np.argsort(src, kind="stable")
        self.n = n_nodes
        self.dst = dst[order].astype(np.int32)
        counts = np.bincount(src, minlength=n_nodes)
        self.indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def neighbors(self, u: int) -> np.ndarray:
        return self.dst[self.indptr[u] : self.indptr[u + 1]]


def sample_khop(
    g: CSRGraph,
    seeds: np.ndarray,
    fanouts: list[int],
    rng: np.random.Generator,
):
    """Sample a fanout-bounded k-hop subgraph around ``seeds``.

    Returns (nodes, edge_index (2, E_max), edge_mask, n_real_nodes) with static
    shapes: nodes padded to seeds * prod(1+f), edges to seeds * sum-product.
    edge_index entries point into ``nodes`` (local ids); pads point past end.
    """
    max_nodes = len(seeds)
    max_edges = 0
    frontier_bound = len(seeds)
    for f in fanouts:
        max_edges += frontier_bound * f
        frontier_bound *= f
        max_nodes += frontier_bound

    node_list: list[int] = list(map(int, seeds))
    local = {int(u): i for i, u in enumerate(seeds)}
    edges = []
    frontier = list(map(int, seeds))
    for f in fanouts:
        nxt = []
        for u in frontier:
            nbrs = g.neighbors(u)
            if len(nbrs) == 0:
                continue
            take = rng.choice(nbrs, size=min(f, len(nbrs)), replace=False)
            for v in map(int, take):
                if v not in local:
                    local[v] = len(node_list)
                    node_list.append(v)
                    nxt.append(v)
                edges.append((local[v], local[u]))  # message v -> u
        frontier = nxt

    nodes = np.full(max_nodes, -1, np.int32)
    nodes[: len(node_list)] = node_list
    ei = np.full((2, max_edges), max_nodes, np.int32)
    if edges:
        e = np.array(edges, np.int32).T
        ei[:, : e.shape[1]] = e
    mask = np.zeros(max_edges, bool)
    mask[: len(edges)] = True
    return nodes, ei, mask, len(node_list)
