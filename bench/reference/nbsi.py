"""Plain reference of the streaming triangle-count estimator the benchmark
holds the program to.

Neighborhood sampling in bulk (Tangwongsan, Pavan, Tirthapura, CIKM'13,
arXiv:1308.2166, Section 4), one tenant and one batch at a time, written
with whole-tensor PyTorch operations only: a stable ``torch.sort`` for the
batch's arc and edge indexes and ``torch.searchsorted`` for every lookup.
The randomness is counter-based threefry-2x32 as ``jax.random`` draws it
(the estimator's published semantics are the JAX package's), so a stream
seeded the same way gives the same estimator state, slot for slot, whatever
implements it:

  * tenant key ``PRNGKey(seed)``; batch i draws from ``fold_in(key, i)``;
  * step 1 (level-1 reservoir over E + W) from the batch key's first split
    half: ``randint64`` over ``[0, m + n)``;
  * step 2's coin (``uniform`` float32 against chi+/chi in float32) and phi
    (``randint32`` over ``[0, chi+)``) from the two halves of the second.

The local scheme (vertex-partitioned pools, REPT arXiv:1811.09136) attributes
each closed sampled triangle to the vertices its estimator's pool owns.

``low=True`` is the control: the coin's threshold in bfloat16 and every
estimate in float32, the precision one step below the configuration's.
Nothing here imports the program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

M32 = 0xFFFFFFFF
INF = 0x7FFFFFFFFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


# -- threefry-2x32 as jax.random draws it -------------------------------------
def threefry(k0, k1, c0, c1):
    """20 rounds of threefry-2x32 on int64 tensors holding uint32 words."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & M32)
    x0 = (c0 + ks[0]) & M32
    x1 = (c1 + ks[1]) & M32
    for i in range(5):
        for rot in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << rot) | (x1 >> (32 - rot))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    s = int(seed) % (1 << 64)
    return (s >> 32, s & M32)


def _words(key: tuple[int, int], counters: torch.Tensor):
    """Threefry of the 64-bit counters under ``key`` (a pair of ints)."""
    return threefry(torch.full_like(counters, key[0]), torch.full_like(counters, key[1]),
                    counters >> 32, counters & M32)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    c = torch.tensor([int(data) & M32], dtype=torch.int64)
    y0, y1 = _words(key, c)
    return int(y0), int(y1)


def split(key: tuple[int, int]) -> tuple[tuple[int, int], tuple[int, int]]:
    c = torch.arange(2, dtype=torch.int64)
    y0, y1 = _words(key, c)
    return (int(y0[0]), int(y1[0])), (int(y0[1]), int(y1[1]))


def bits(key: tuple[int, int], n: int, device, width: int = 32) -> torch.Tensor:
    """``jax.random.bits``: one threefry block per element over the flat
    counter 0 .. n-1; 32-bit words are x0 ^ x1, 64-bit ones x0 << 32 | x1
    (carried in int64)."""
    y0, y1 = _words(key, torch.arange(n, dtype=torch.int64, device=device))
    return y0 ^ y1 if width == 32 else (y0 << 32) | y1


def uniform32(key, n: int, device) -> torch.Tensor:
    m = (bits(key, n, device) >> 9) | 0x3F800000
    return m.to(torch.int32).view(torch.float32) - 1.0


def _umod(x64: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit remainder of the int64 bit pattern ``x64`` by spans
    below 2**31: x = hi * 2**32 + lo, both words unsigned."""
    hi = (x64 >> 32) & M32
    lo = x64 & M32
    return ((hi % span) * ((1 << 32) % span) + lo % span) % span


def randint64(key, span: torch.Tensor, n: int, device) -> torch.Tensor:
    """``jax.random.randint(key, (n,), 0, span, int64)`` for spans >= 1 and
    below 2**31 (two 64-bit words, jax's span arithmetic)."""
    if int(span.max()) >= 1 << 31:
        raise ValueError("the reference's randint64 takes spans below 2**31")
    ka, kb = split(key)
    hi, lo = bits(ka, n, device, 64), bits(kb, n, device, 64)
    mult = ((1 << 32) % span) ** 2 % span
    return (_umod(hi, span) * mult + _umod(lo, span)) % span


def randint32(key, span: torch.Tensor, n: int, device) -> torch.Tensor:
    """``jax.random.randint(key, (n,), 0, span, int32)`` for spans >= 1: the
    uint32 products wrap at 2**32 as jax's do."""
    ka, kb = split(key)
    hi, lo = bits(ka, n, device), bits(kb, n, device)
    mult = ((65536 % span) ** 2) % span
    off = (((hi % span) * mult) & M32) + lo % span
    return (off & M32) % span


# -- the estimator ------------------------------------------------------------
@dataclass
class State:
    """One tenant's r estimators: level-1 edge, neighbourhood size, level-2
    edge (min, max), closing edge seen; -1 marks an empty slot."""

    f1: torch.Tensor  # (r, 2) int32
    chi: torch.Tensor  # (r,) int32
    f2: torch.Tensor  # (r, 2) int32
    has_f3: torch.Tensor  # (r,) bool
    m: int = 0

    @classmethod
    def empty(cls, r: int, device) -> "State":
        return cls(torch.full((r, 2), -1, dtype=torch.int32, device=device),
                   torch.zeros(r, dtype=torch.int32, device=device),
                   torch.full((r, 2), -1, dtype=torch.int32, device=device),
                   torch.zeros(r, dtype=torch.bool, device=device))


def _key(hi: torch.Tensor, lo) -> torch.Tensor:
    """hi << 32 | lo with lo sign-extended (an empty slot's -1 gives a
    negative key that matches nothing real)."""
    return (hi.to(torch.int64) << 32) | torch.as_tensor(lo).to(hi.device, torch.int64)


def _search(keys: torch.Tensor, q: torch.Tensor):
    return (torch.searchsorted(keys, q, side="left"),
            torch.searchsorted(keys, q, side="right"))


def update(st: State, W: torch.Tensor, n: int, key, *, low: bool = False) -> State:
    """Fold one batch (W (s, 2) int32, its first n rows real) into the
    estimators, drawing from ``key`` (the batch key)."""
    dev = W.device
    r, s = st.chi.shape[0], W.shape[0]
    k1, k2 = split(key)

    # step 1: level-1 reservoir over E + W
    total = st.m + n
    t = randint64(k1, torch.full((r,), max(total, 1), dtype=torch.int64, device=dev), r, dev)
    rep = (t >= st.m) & (total > 0)
    idx = torch.clamp(t - st.m, min=0, max=max(n - 1, 0))
    f1 = torch.where(rep[:, None], W[idx], st.f1)
    chi_m = torch.where(rep, 0, st.chi)
    f2 = torch.where(rep[:, None], -1, st.f2)
    has_f3 = st.has_f3 & ~rep
    f1_pos = torch.where(rep, idx, -1)

    # the batch's arcs by (src asc, position desc) and its edges by key
    pos = torch.arange(s, dtype=torch.int64, device=dev)
    real = pos < n
    src = torch.cat([W[:, 0], W[:, 1]]).to(torch.int64)
    dst = torch.cat([W[:, 1], W[:, 0]]).to(torch.int64)
    apos = torch.cat([pos, pos])
    akey = torch.where(torch.cat([real, real]), _key(src, (s - 1) - apos), INF)
    akey, perm = torch.sort(akey, stable=True)
    src, dst, apos = src[perm], dst[perm], apos[perm]
    first = torch.ones(2 * s, dtype=torch.bool, device=dev)
    first[1:] = src[1:] != src[:-1]
    ar = torch.arange(2 * s, device=dev)
    rank = ar - torch.cummax(torch.where(first, ar, 0), 0).values
    rkey = torch.where(ar < 2 * n, _key(src, rank), INF)
    lo_e = torch.minimum(W[:, 0], W[:, 1])
    hi_e = torch.maximum(W[:, 0], W[:, 1])
    ekey, eperm = torch.sort(torch.where(real, _key(lo_e, hi_e), INF), stable=True)
    epos = pos[eperm]

    # step 2: chi+ from each f1 endpoint's later arcs, then the level-2 coin
    u, v = f1[:, 0], f1[:, 1]
    have = u >= 0
    tail = (s - 1) - f1_pos
    deg = []
    for x in (u, v):
        lt_hi, le_hi = _search(akey, _key(x, tail))
        lt_lo, _ = _search(akey, _key(x, 0))
        w = lt_hi - lt_lo
        miss = (f1_pos >= 0) & ~(le_hi > lt_hi)
        deg.append(torch.where(have & ~miss, w, 0))
    ld, rd = deg
    chi_p = ld + rd
    chi = chi_m + chi_p
    kc, kp = split(k2)
    coin = uniform32(kc, r, dev)
    thr_dtype = torch.bfloat16 if low else torch.float32
    p = (chi_p.to(thr_dtype) / torch.clamp(chi.to(thr_dtype), min=1.0)).to(torch.float32)
    take = have & (chi_p > 0) & (coin < p)
    phi = randint32(kp, torch.clamp(chi_p, min=1), r, dev)
    q_src = torch.where(phi < ld, u, v)
    q_rank = torch.where(phi < ld, phi, phi - ld)
    lt, le = _search(rkey, _key(q_src, q_rank))
    j = torch.clamp(lt, max=2 * s - 1)
    take = take & (le > lt)
    a_new = torch.minimum(src[j], dst[j]).to(torch.int32)
    b_new = torch.maximum(src[j], dst[j]).to(torch.int32)
    f2 = torch.where(take[:, None], torch.stack([a_new, b_new], 1), f2)
    f2_pos = torch.where(take, apos[j], -1)
    has_f3 = has_f3 & ~take

    # step 3: the wedge's closing edge, arriving after f2
    a, b = f2[:, 0], f2[:, 1]
    wedge = have & (a >= 0)
    o1 = torch.where((u == a) | (u == b), v, u)
    o2 = torch.where((a == u) | (a == v), b, a)
    lt, le = _search(ekey, _key(torch.minimum(o1, o2), torch.maximum(o1, o2)))
    p3 = epos[torch.clamp(le - 1, min=0)]
    has_f3 = has_f3 | (wedge & (le > lt) & (p3 > f2_pos))
    return State(f1, chi, f2, has_f3, st.m + n)


def groups_of(r: int, groups: int) -> int:
    """The largest divisor of r that is at most ``groups``."""
    if groups > r:
        return 1
    g = max(1, groups)
    while r % g:
        g -= 1
    return g


def coarse(st: State, dtype) -> torch.Tensor:
    x = st.chi.to(dtype) * float(st.m)
    return torch.where(st.has_f3, x, torch.zeros_like(x))


def global_estimate(st: State, groups: int, *, low: bool = False) -> float:
    """Median of means: g contiguous groups' means, the median of them
    (the midpoint of the two middle values for an even g)."""
    dt = torch.float32 if low else torch.float64
    x = coarse(st, dt)
    r = x.shape[0]
    g = groups_of(r, groups)
    means = torch.sort(x.view(g, r // g).sum(1) * (1.0 / (r // g))).values
    return float((means[(g - 1) // 2] + means[g // 2]) * 0.5)


def vertex_pool(v: torch.Tensor, n_pools: int) -> torch.Tensor:
    """The pool owning vertex v: (uint32(v) * 2654435761 mod 2**32) mod
    n_pools, the product taken in two 16-bit halves of the multiplier so
    that no intermediate leaves int64."""
    a = v.to(torch.int64) & M32
    mult = 2654435761
    low = a * (mult & 0xFFFF) + (((a * (mult >> 16)) & 0xFFFF) << 16)
    return (low & M32) % n_pools


def local_estimate(st: State, n_vertices: int, n_pools: int, *,
                   low: bool = False) -> torch.Tensor:
    """(n_vertices,) per-vertex triangle counts: each closed sampled
    triangle adds its coarse estimate to the vertices that its estimator's
    pool owns; a pool's per-vertex mean is over its r / n_pools
    estimators."""
    dt = torch.float32 if low else torch.float64
    r = st.chi.shape[0]
    x = coarse(st, dt)
    u, v = st.f1[:, 0], st.f1[:, 1]
    a, b = st.f2[:, 0], st.f2[:, 1]
    third = torch.where((a == u) | (a == v), b, a)
    tri = torch.stack([u, v, third])  # (3, r)
    pool = torch.arange(r, device=x.device) // (r // n_pools)
    closed = st.has_f3 & (u >= 0) & (a >= 0)
    take = closed & (tri >= 0) & (tri < n_vertices) & (vertex_pool(tri, n_pools) == pool)
    out = torch.zeros(n_vertices, dtype=dt, device=x.device)
    out.index_add_(0, tri[take].to(torch.int64), x.expand(3, r)[take])
    return out / (r // n_pools)


def replay(streams, seeds: list, cfg: dict, batch_size: int, n_batches: int, steps,
           device, *, on_answer: Callable, on_state: Callable, low: bool = False) -> None:
    """Replay one job: tenant t ingests its stream (``streams[t]``, an (m, 2)
    int32 host array) in batches of ``batch_size``, ``n_batches`` of them,
    from ``PRNGKey(seeds[t])``. After each step in ``steps`` it hands
    ``on_answer(t, step, answer)`` the tenant's estimate (a float, or a
    float64 per-vertex tensor on the device for ``local``), and at the end
    ``on_state(t, state)``. Tenants replay one after the other, so one
    tenant's state is on the device at a time."""
    r, scheme = cfg["r"], cfg["scheme"]
    steps = set(steps)
    for t, edges in enumerate(streams):
        key = prng_key(seeds[t])
        st = State.empty(r, device)
        for i in range(n_batches):
            lo = i * batch_size
            chunk = torch.as_tensor(np.ascontiguousarray(edges[lo:lo + batch_size])).to(device)
            n = chunk.shape[0]
            if n < batch_size:
                pad = torch.zeros((batch_size - n, 2), dtype=chunk.dtype, device=device)
                chunk = torch.cat([chunk, pad])
            st = update(st, chunk, n, fold_in(key, i), low=low)
            if i + 1 in steps:
                if scheme == "local":
                    ans = local_estimate(st, cfg["scheme_params"]["n_vertices"],
                                         cfg["scheme_params"]["n_pools"], low=low)
                    on_answer(t, i + 1, ans.to(torch.float64))
                else:
                    on_answer(t, i + 1, global_estimate(st, cfg["groups"], low=low))
        on_state(t, st)
