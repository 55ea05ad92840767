"""Exact triangle counts for small graphs (``repro.core.sequential``): the
CLI's ground truth ``tau`` and, for the local scheme, per-vertex ``L_v``."""
from __future__ import annotations

import numpy as np


def count_triangles(edges: np.ndarray) -> int:
    """Exact triangle count of an undirected simple graph (edge list (m, 2))."""
    adj: dict[int, set[int]] = {}
    for u, v in edges:
        adj.setdefault(int(u), set()).add(int(v))
        adj.setdefault(int(v), set()).add(int(u))
    count = 0
    for u, v in edges:
        count += len(adj[int(u)] & adj[int(v)])
    return count // 3


def local_triangle_counts(edges: np.ndarray, n_vertices: int) -> np.ndarray:
    """Exact per-vertex incident-triangle counts L_v, the local scheme's
    ground truth. Vertices >= ``n_vertices`` are not reported, matching the
    scheme's per-vertex drop, so ``sum(L) == 3 * count_triangles(edges)``
    where the bound covers every vertex."""
    adj: dict[int, set[int]] = {}
    for u, v in edges:
        adj.setdefault(int(u), set()).add(int(v))
        adj.setdefault(int(v), set()).add(int(u))
    counts = np.zeros(n_vertices, dtype=np.int64)
    for u, v in edges:
        u, v = int(u), int(v)
        for w in adj[u] & adj[v]:
            # triangle {u, v, w} is met once per edge: each vertex nets +3
            for x in (u, v, w):
                if x < n_vertices:
                    counts[x] += 1
    return counts // 3
