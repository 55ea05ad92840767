"""Sequential oracles (``repro.core.sequential``), plain numpy.

* ``SequentialNS``: edge-at-a-time neighbourhood sampling, the paper's
  sequential baseline (PTTW13), one estimator vector;
* ``count_triangles``: the exact count, the CLI's ground truth ``tau``;
* ``local_triangle_counts``: exact per-vertex counts ``L_v``, the local
  scheme's ground truth;
* ``gamma_after``: the |Gamma_S(e)| ground truth of the NBSI invariant.
"""
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


def gamma_after(edges: np.ndarray, i: int) -> int:
    """|Gamma_S(e_i)|: edges after position i sharing a vertex with e_i."""
    u, v = int(edges[i, 0]), int(edges[i, 1])
    n = 0
    for j in range(i + 1, len(edges)):
        a, b = int(edges[j, 0]), int(edges[j, 1])
        if a == u or a == v or b == u or b == v:
            n += 1
    return n


class SequentialNS:
    """Edge-at-a-time neighbourhood sampling with r estimators (PTTW13).

    Keeps the NBSI invariant exactly; the distributional oracle of the bulk
    algorithm and the sequential baseline. Its draws come from
    ``np.random.default_rng(seed)`` in the reference's order, so the same
    seed gives the reference's estimators.
    """

    def __init__(self, r: int, seed: int = 0):
        self.r = r
        self.rng = np.random.default_rng(seed)
        self.m = 0
        self.f1 = np.full((r, 2), -1, dtype=np.int64)
        self.chi = np.zeros(r, dtype=np.int64)
        self.f2 = np.full((r, 2), -1, dtype=np.int64)
        self.has_f3 = np.zeros(r, dtype=bool)

    def process_edge(self, u: int, v: int) -> None:
        self.m += 1
        r = self.r
        # level-1 reservoir
        take1 = self.rng.random(r) < 1.0 / self.m
        self.f1[take1] = (u, v)
        self.chi[take1] = 0
        self.f2[take1] = -1
        self.has_f3[take1] = False

        live = ~take1 & (self.f1[:, 0] >= 0)
        adj = live & ((self.f1[:, 0] == u) | (self.f1[:, 0] == v)
                      | (self.f1[:, 1] == u) | (self.f1[:, 1] == v))
        self.chi[adj] += 1
        take2 = adj & (self.rng.random(r) < 1.0 / np.maximum(self.chi, 1))
        cu, cv = min(u, v), max(u, v)
        self.f2[take2] = (cu, cv)
        self.has_f3[take2] = False

        # the closing-edge check for adjacent arrivals that keep a wedge
        chk = adj & ~take2 & (self.f2[:, 0] >= 0)
        if chk.any():
            f1u, f1v = self.f1[:, 0], self.f1[:, 1]
            a, b = self.f2[:, 0], self.f2[:, 1]
            o1 = np.where((f1u == a) | (f1u == b), f1v, f1u)
            o2 = np.where((a == f1u) | (a == f1v), b, a)
            closes = (np.minimum(o1, o2) == cu) & (np.maximum(o1, o2) == cv)
            self.has_f3 |= chk & closes

    def process(self, edges: np.ndarray) -> None:
        for u, v in edges:
            self.process_edge(int(u), int(v))

    def coarse(self) -> np.ndarray:
        return np.where(self.has_f3, self.chi.astype(np.float64) * self.m, 0.0)

    def estimate(self, groups: int = 9) -> float:
        x = self.coarse()
        per = len(x) // groups
        if per == 0:
            return float(np.mean(x))
        return float(np.median(np.mean(x[: per * groups].reshape(groups, per), 1)))
