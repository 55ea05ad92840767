"""Synthetic streaming graphs with known or computable triangle counts
(``repro.data.graph_stream``, insertion-only part).

A copy, not an import: ``repro`` imports jax. Each generator makes the same
numpy draws in the same order as the reference, so the same seed gives the
same stream.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def erdos_renyi_stream(n: int, m: int, seed: int = 0) -> np.ndarray:
    """m distinct uniform edges on n vertices, in random arrival order."""
    rng = np.random.default_rng(seed)
    seen: set[tuple[int, int]] = set()
    edges = []
    while len(edges) < m:
        u, v = rng.integers(0, n, size=2)
        if u == v:
            continue
        e = (min(int(u), int(v)), max(int(u), int(v)))
        if e not in seen:
            seen.add(e)
            edges.append(e)
    return np.array(edges, dtype=np.int32)


def barabasi_albert_stream(n: int, k: int, seed: int = 0) -> np.ndarray:
    """BA preferential-attachment graph (power-law degrees), arrival-shuffled."""
    rng = np.random.default_rng(seed)
    targets = list(range(k))
    repeated: list[int] = []
    edges = []
    for v in range(k, n):
        chosen = set()
        for t in targets:
            chosen.add(t)
        for u in chosen:
            edges.append((min(u, v), max(u, v)))
        repeated.extend(chosen)
        repeated.extend([v] * len(chosen))
        targets = [repeated[rng.integers(0, len(repeated))] for _ in range(k)]
    e = np.array(sorted(set(map(tuple, edges))), dtype=np.int32)
    rng.shuffle(e)
    return e


def planted_triangle_stream(
    n_triangles: int, n_noise_edges: int, n_vertices: int, seed: int = 0
) -> tuple[np.ndarray, int]:
    """Disjoint planted triangles plus triangle-free bipartite noise between
    two vertex classes disjoint from the triangles. Returns (edges, tau) with
    tau == n_triangles exactly."""
    rng = np.random.default_rng(seed)
    edges = []
    v = 0
    for _ in range(n_triangles):
        a, b, c = v, v + 1, v + 2
        v += 3
        edges += [(a, b), (a, c), (b, c)]
    base = v
    half = max(n_vertices - base, 2) // 2
    seen: set[tuple[int, int]] = set()
    while len(seen) < n_noise_edges:
        a = base + int(rng.integers(0, half))
        b = base + half + int(rng.integers(0, half))
        if (a, b) not in seen:
            seen.add((a, b))
    edges += sorted(seen)
    e = np.array(edges, dtype=np.int32)
    rng.shuffle(e)
    return e, n_triangles


def batches(edges: np.ndarray, batch_size: int) -> Iterator[tuple[np.ndarray, int]]:
    """Yield (W, n_valid) with W padded to batch_size with (0, 0) rows. Every
    edge appears in exactly one batch, in stream order; a ragged last batch
    is padded, never dropped; an empty stream yields nothing."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
    for lo in range(0, len(edges), batch_size):
        chunk = edges[lo : lo + batch_size]
        nv = len(chunk)
        if nv < batch_size:
            chunk = np.concatenate(
                [chunk, np.zeros((batch_size - nv, 2), dtype=edges.dtype)]
            )
        yield chunk, nv
