"""Synthetic streaming graphs with known or computable triangle counts, and
the fully-dynamic (signed) streams built over them (``repro.data.graph_stream``).

A copy, not an import: ``repro`` imports jax. Each generator makes the same
numpy draws in the same order as the reference, so the same seed gives the
same stream, and ``decay_ttls`` hashes positions with the same splitmix64.
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


# ---------------------------------------------------------------------------
# fully-dynamic (turnstile) streams: signed edges, churn, windows, decay
# ---------------------------------------------------------------------------
# A signed stream is an (m, 3) int32 array of (u, v, sign) rows with
# sign in {+1, -1}: +1 inserts the edge, -1 deletes it. Contract (the
# engine's single-live-copy rule): a -1 row only ever names an edge that is
# live at that point in the stream, and at most one live copy of any
# undirected edge key exists at a time.


def signed_batches(
    stream: np.ndarray, batch_size: int
) -> Iterator[tuple[np.ndarray, int, int]]:
    """Yield (W, n_valid, sign) padded batches from a signed stream.

    Batches never mix signs: consecutive same-sign runs are split on run
    boundaries first, then each run goes through ``batches`` (inheriting its
    tail contract — ragged run tails are padded, never dropped)."""
    stream = np.asarray(stream, dtype=np.int32).reshape(-1, 3)
    if len(stream) == 0:
        return
    sign = stream[:, 2]
    cuts = np.flatnonzero(np.diff(sign)) + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [len(stream)]])
    for lo, hi in zip(starts, ends):
        s = int(sign[lo])
        for W, nv in batches(stream[lo:hi, :2], batch_size):
            yield W, nv, s


def churn_stream(
    edges: np.ndarray, delete_rate: float, seed: int = 0
) -> np.ndarray:
    """Signed stream with turnstile churn over an insertion stream.

    Each edge of ``edges`` is inserted in order; with probability
    ``delete_rate`` it is also deleted at a uniformly random later point in
    the stream. Since every edge key appears at most once in ``edges``, the
    result honors the single-live-copy contract by construction. Returns an
    (m', 3) int32 signed stream, m' = m + (number of deleted edges)."""
    if not 0.0 <= delete_rate <= 1.0:
        raise ValueError(f"delete_rate must be in [0, 1], got {delete_rate}")
    edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
    rng = np.random.default_rng(seed)
    m = len(edges)
    events: list[tuple[float, int, int, int]] = []
    for i, (u, v) in enumerate(edges):
        events.append((float(i), int(u), int(v), 1))
        if rng.random() < delete_rate:
            # uniform position strictly after the insert, before stream end
            events.append((rng.uniform(i + 0.5, m), int(u), int(v), -1))
    events.sort(key=lambda e: e[0])
    return np.array(
        [(u, v, s) for _, u, v, s in events], dtype=np.int32
    ).reshape(-1, 3)


def windowed_stream(edges: np.ndarray, window: int) -> np.ndarray:
    """Signed stream materializing a count-based sliding window explicitly.

    The edge inserted at position i expires once the window has slid past it
    — immediately after insert number i + window arrives — matching the
    engine's window clock (edge live iff ``pos + window >= inserts_so_far``).
    Used by tests to check that the engine's implicit ``window=`` mode and an
    explicit deletion stream produce identical live graphs."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
    m = len(edges)
    events: list[tuple[float, int, int, int]] = []
    for i, (u, v) in enumerate(edges):
        events.append((float(i), int(u), int(v), 1))
        if i + window < m:
            events.append((i + window + 0.5, int(u), int(v), -1))
    events.sort(key=lambda e: e[0])
    return np.array(
        [(u, v, s) for _, u, v, s in events], dtype=np.int32
    ).reshape(-1, 3)


def live_edges(stream: np.ndarray) -> np.ndarray:
    """Apply a signed stream's signs; return the live (k, 2) int32 edge set.

    Raises KeyError if a deletion names an edge that is not live (a
    single-live-copy contract violation — surfaced loudly, because the
    estimator cannot detect it either)."""
    stream = np.asarray(stream, dtype=np.int32).reshape(-1, 3)
    live: dict[tuple[int, int], tuple[int, int]] = {}
    for u, v, s in stream:
        key = (min(int(u), int(v)), max(int(u), int(v)))
        if s >= 0:
            live[key] = (int(u), int(v))
        else:
            del live[key]
    return np.array(sorted(live.values()), dtype=np.int32).reshape(-1, 2)


def dynamic_live_edges(
    stream: np.ndarray, window: int = 0, decay: float = 0.0, seed: int = 0
) -> np.ndarray:
    """Live (k, 2) edge set after a signed stream under the engine's clock.

    Replays the signed stream and then applies the window/decay expiry rule
    exactly as ``TriangleCountEngine`` does (single tenant): an edge whose
    insertion position ``pos`` satisfies ``pos + window < total_inserts``
    (window mode) or ``pos + ttl < total_inserts`` with ``ttl =
    decay_ttls(seed, pos, 1, decay)`` (decay mode) is expired. The ground
    truth the CLIs and the brute-force test oracle both count triangles on.
    """
    stream = np.asarray(stream, dtype=np.int32).reshape(-1, 3)
    live: dict[tuple[int, int], tuple[int, int, int]] = {}
    inserts = 0
    for u, v, s in stream:
        key = (min(int(u), int(v)), max(int(u), int(v)))
        if s >= 0:
            live[key] = (int(u), int(v), inserts)
            inserts += 1
        else:
            del live[key]
    out = []
    for u, v, pos in live.values():
        if window and pos + window < inserts:
            continue
        if decay and pos + int(decay_ttls(seed, pos, 1, decay)[0]) < inserts:
            continue
        out.append((u, v))
    return np.array(sorted(out), dtype=np.int32).reshape(-1, 2)


def decay_cap(decay: float) -> int:
    """Hard TTL ceiling for exponential-decay mode: ~6 mean lifetimes.

    P(geometric TTL > 6*decay) < e^-6 < 0.25%, so the clamp is statistically
    invisible while making the engine's expiry-buffer capacity (and the
    snapshot array shapes) structural rather than data-dependent."""
    return int(6 * decay) + 8


def decay_ttls(seed: int, start: int, n: int, decay: float) -> np.ndarray:
    """Deterministic per-edge TTLs for exponential-decay mode: (n,) int64.

    Edge at absolute insertion position ``start + i`` gets a geometric
    lifetime with mean ``decay`` (success prob 1/decay, support >= 1) clamped
    to ``decay_cap(decay)``. The draw is a pure hash of (seed, position) —
    splitmix64 finalizer — so the engine and the oracle reproduce identical
    lifetimes independently, and snapshot/restore need not persist them."""
    if decay <= 1.0:
        raise ValueError(f"decay must be > 1, got {decay}")
    pos = np.arange(start, start + n, dtype=np.uint64)
    z = (pos + np.uint64(seed)) * np.uint64(0x9E3779B97F4A7C15)
    z ^= z >> np.uint64(30)
    z *= np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(27)
    z *= np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(31)
    u = (z >> np.uint64(11)).astype(np.float64) * 2.0**-53  # in [0, 1)
    ttl = 1.0 + np.floor(np.log1p(-u) / np.log1p(-1.0 / decay))
    return np.clip(ttl, 1, decay_cap(decay)).astype(np.int64)
