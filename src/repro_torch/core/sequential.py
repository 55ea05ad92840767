"""Exact triangle count for small graphs (``repro.core.sequential``), the
CLI's ground truth ``tau``."""
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
