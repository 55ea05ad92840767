"""bulkUpdateAll (paper Section 4): fold a batch of edges into all r
estimators while keeping the neighborhood sampling invariant
(``repro.core.bulk``), and its turnstile counterpart, which patches a batch
of edge deletions out of every estimator's sample.

  Step 1  level-1 reservoir over E ∪ W
  Step 2  rankAll(W), then the Q1 rank/degree multisearch and the Q2
          (src, rank) decode of the new level-2 edge
  Step 3  the closing-edge multisearch with the pos > pos(f2) arrival rule

Randomness is counter-based: batch i of a stream draws from
``fold_in(key, step0 + i)``, so ``bulk_update_chunk`` over K batches is
bit-identical to K ``bulk_update_all`` calls on every backend, and both are
bit-identical to the JAX reference for the same inputs.

``n_valid`` may be a Python int or an integer tensor; ``search`` names the
multisearch backend (``repro_torch.primitives.search``). Deletions draw no
randomness and never advance the step counter.

Banks: every update takes a bank of T tenants as well, the reference's
``vmap`` over its leading tenant axis: the state's fields, W (T, s, 2), the
key (T, 2) and ``n_valid`` (an int shared by every tenant, or a (T,)
tensor) all lead with T. Each operation then runs once over the whole bank,
so a bank issues the same device operations as one tenant, and each
search is one batched ``multisearch_counts`` launch, a row a tenant.

Shards: every update takes ``e0``, the global index of the state's first
estimator. A shard holding estimators ``[e0, e0 + r_local)`` of an
r-estimator state draws elements ``e0 ..`` of each full-r draw (the
reference's partitionable threefry, ``rng._block``), so the shards of a
sharded plan, updated apart, concatenate to the unsharded update bit for
bit. ``e0`` is 0 for an unsharded state.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch import rng
from repro_torch.core.rank import RankStructure, rank_all, rank_all_chunk
from repro_torch.core.state import EstimatorState
from repro_torch.primitives.ingest import randint_from_bits, resolve_ingest_backend
from repro_torch.primitives.search import (
    multisearch_bounds,
    multisearch_lt,
    resolve_multisearch_backend,
)
from repro_torch.primitives.sort import pack2
from repro_torch.spans import span

Tensor = torch.Tensor
IntLike = Union[int, Tensor]


def _canon(a: Tensor, b: Tensor) -> Tensor:
    return torch.stack([torch.minimum(a, b), torch.maximum(a, b)], dim=-1)


def _col(x: IntLike) -> IntLike:
    """A per-tenant (or per-batch) value as a column against (.., r) lanes;
    an int is shared by every lane as it is."""
    return x[..., None] if isinstance(x, Tensor) else x


def _rows(W: Tensor, idx: Tensor) -> Tensor:
    """``W[idx]`` over the last two axes: the (.., r, 2) edges at (.., r)
    row indices of (.., s, 2) batches."""
    return torch.gather(W, -2, idx.long()[..., None].expand(*idx.shape, 2))


def _at(x: Tensor, j: Tensor) -> Tensor:
    """``x[j]`` along the last axis, row by row for a bank."""
    return torch.gather(x, -1, j)


def step1_level1(state: EstimatorState, W: Tensor, n_valid: IntLike, key: Tensor,
                 e0: int = 0):
    """Reservoir-sample level-1 edges over E ∪ W (paper Section 4.2): draw
    t ~ U[0, m + n_valid); t >= m selects W[t - m]."""
    r = state.r
    m = _col(state.m_seen)
    total = m + _col(n_valid)
    with span("core.draw"):
        t = rng.randint64(key, torch.clamp(total, min=1), (r,), e0)
    replace = (t >= m) & (total > 0)
    last = (torch.clamp(_col(n_valid) - 1, min=0) if isinstance(n_valid, Tensor)
            else max(int(n_valid) - 1, 0))
    idx = torch.minimum(torch.clamp(t - m, min=0), torch.as_tensor(last)).to(torch.int32)
    f1 = torch.where(replace[..., None], _rows(W, idx), state.f1)
    chi = torch.where(replace, torch.zeros_like(state.chi), state.chi)
    f2 = torch.where(replace[..., None], torch.full_like(state.f2, -1), state.f2)
    has_f3 = state.has_f3 & ~replace
    f1_bpos = torch.where(replace, idx, torch.full_like(idx, -1))
    return f1, chi, f2, has_f3, f1_bpos


def _q1_queries(s: int, u: Tensor, v: Tensor, f1_bpos: Tensor) -> Tensor:
    """The four fused Q1 roles (own arc / segment end for u and v, segment
    starts for u and v) as one (4r,) query vector over the key_desc of a
    batch of s edges ((T, 4r) for a bank)."""
    zero = torch.zeros_like(f1_bpos)
    return torch.cat([
        pack2(u, (s - 1) - f1_bpos),
        pack2(v, (s - 1) - f1_bpos),
        pack2(u, zero),
        pack2(v, zero),
    ], dim=-1)


def rank_queries(R: RankStructure, u: Tensor, v: Tensor, f1_bpos: Tensor,
                 search: str = "auto"):
    """rank(endpoint -> other) for both f1 endpoints (paper Observation 4.4)
    in one multisearch over ``R.key_desc``: a fresh f1 reads its own arc's
    offset in the segment, an old one (f1_bpos = -1) the segment width."""
    with span("core.search"):
        lt, le = multisearch_bounds(R.key_desc, _q1_queries(R.s, u, v, f1_bpos), search)
    r = u.shape[-1]
    hi_u, hi_v = lt[..., :r], lt[..., r:2 * r]
    lo_u, lo_v = lt[..., 2 * r:3 * r], lt[..., 3 * r:]
    w_u = hi_u - lo_u
    w_v = hi_v - lo_v
    fresh = f1_bpos >= 0
    miss_u = fresh & ~(le[..., :r] > hi_u)
    miss_v = fresh & ~(le[..., r:2 * r] > hi_v)
    zero = torch.zeros_like(w_u)
    return torch.where(miss_u, zero, w_u), torch.where(miss_v, zero, w_v)


def _p_new(chi_plus: Tensor, chi_new: Tensor) -> Tensor:
    # float32 division, IEEE-rounded on both CPU and CUDA
    return chi_plus.to(torch.float32) / torch.clamp(chi_new.to(torch.float32), min=1.0)


def step2_level2(f1, chi_minus, f2, has_f3, f1_bpos, R: RankStructure, key,
                 search: str = "auto", e0: int = 0):
    """Update level-2 edges and chi (paper Section 4.3)."""
    u, v = f1[..., 0], f1[..., 1]
    have_f1 = u >= 0
    ld, rd = rank_queries(R, u, v, f1_bpos, search)
    zero = torch.zeros_like(ld)
    ld = torch.where(have_f1, ld, zero)
    rd = torch.where(have_f1, rd, zero)
    chi_plus = ld + rd
    chi_new = chi_minus + chi_plus

    r = f1.shape[-2]
    with span("core.draw"):
        k = rng.split(key)
        coin = rng.uniform(k[..., 0, :], (r,), e0)
    take_new = have_f1 & (chi_plus > 0) & (coin < _p_new(chi_plus, chi_new))

    with span("core.draw"):
        phi = rng.randint32(k[..., 1, :], torch.clamp(chi_plus, min=1), (r,), e0)
    t_src = torch.where(phi < ld, u, v)
    t_rank = torch.where(phi < ld, phi, phi - ld)
    with span("core.search"):
        lt, le = multisearch_bounds(R.key_rank, pack2(t_src, t_rank), search)
    found = le > lt
    j = torch.clamp(lt, max=R.key_rank.shape[-1] - 1).long()
    cand = _canon(_at(R.src, j), _at(R.dst, j))
    take_new = take_new & found

    f2_new = torch.where(take_new[..., None], cand, f2)
    f2_bpos = torch.where(take_new, _at(R.pos, j), torch.full_like(lt, -1))
    return f2_new, chi_new, has_f3 & ~take_new, f2_bpos


def _closing_query(f1: Tensor, f2: Tensor):
    u, v = f1[..., 0], f1[..., 1]
    a, b = f2[..., 0], f2[..., 1]
    have_wedge = (u >= 0) & (a >= 0)
    o1 = torch.where((u == a) | (u == b), v, u)
    o2 = torch.where((a == u) | (a == v), b, a)
    return have_wedge, pack2(torch.minimum(o1, o2), torch.maximum(o1, o2))


def step3_closing(f1, f2, has_f3, f2_bpos, R: RankStructure, search: str = "auto"):
    """Detect closing edges in W (paper Section 4.4): the edge joining the
    wedge's two free endpoints, arriving after f2. On duplicate edges the
    last copy's position is read (the structure's sort is stable)."""
    have_wedge, q = _closing_query(f1, f2)
    with span("core.search"):
        lt, le = multisearch_bounds(R.ekey, q, search)
    p3 = _at(R.epos, torch.clamp(le - 1, min=0).long())
    return has_f3 | (have_wedge & (le > lt) & (p3 > f2_bpos))


def bulk_update_all(state: EstimatorState, W: Tensor, n_valid: IntLike,
                    key: Tensor, search: str = "auto", e0: int = 0) -> EstimatorState:
    """Process one batch of edges into all estimators (paper Theorem 4.1).
    W: (s, 2) int32 on the state's device; the first n_valid rows are real;
    a bank's W is (T, s, 2) (module docstring). Where ``search`` resolves to
    the kernel, the structure is built by the chunk route's kernels too
    (``rank_all(use_kernels=True)``: the tile sort and the scans, over the
    bank's T batches at once). ``e0``: the module docstring's shards."""
    k = rng.split(key)
    f1, chi_m, f2, has_f3, f1_bpos = step1_level1(state, W, n_valid, k[..., 0, :], e0)
    with span("core.build"):
        R = rank_all(W, n_valid,
                     use_kernels=resolve_multisearch_backend(search, W.device) == "kernel")
    f2, chi, has_f3, f2_bpos = step2_level2(f1, chi_m, f2, has_f3, f1_bpos, R, k[..., 1, :],
                                            search, e0)
    has_f3 = step3_closing(f1, f2, has_f3, f2_bpos, R, search)
    return EstimatorState(f1, chi, f2, has_f3, state.m_seen + n_valid)


def chunk_steps(step0: IntLike, K: int, device) -> Tensor:
    """The K steps of a chunk from its first: (K,) for an int ``step0``,
    (T, K) for a bank's (T,) tensor of per-tenant first steps."""
    ks = torch.arange(K, dtype=torch.int64, device=device)
    return step0[..., None] + ks if isinstance(step0, Tensor) else step0 + ks


def batch_keys(key: Tensor, step0: IntLike, K: int) -> Tensor:
    """The K batch keys ``fold_in(key, step0 + k)`` of a chunk, (.., K, 2)."""
    return rng.fold_in(key, chunk_steps(step0, K, key.device))


def _bulk_update_chunk_scan(state: EstimatorState, Ws: Tensor, n_valids: Tensor,
                            key: Tensor, step0: IntLike = 0,
                            search: str = "auto", e0: int = 0) -> EstimatorState:
    """The reference chunk pipeline: K sequential ``bulk_update_all`` calls."""
    keys = batch_keys(key, step0, Ws.shape[-3])
    for i in range(Ws.shape[-3]):
        state = bulk_update_all(state, Ws[..., i, :, :], n_valids[..., i], keys[..., i, :],
                                search, e0)
    return state


def _chunk_randomness(state: EstimatorState, n_valids: Tensor, key: Tensor, steps: Tensor,
                      e0: int = 0):
    """Every random draw of a K-batch chunk at once, batched over K keys.
    Returns (m_before (K,), totals (K,), t (K, r), coin (K, r), phi_hi (K, r),
    phi_lo (K, r)), each with a bank's leading tenant axis; the phi words
    are int32 tensors carrying uint32 bits. Lane i draws element e0 + i."""
    r = state.r
    nv64 = n_valids.to(torch.int64)
    m_before = _col(state.m_seen) + torch.cumsum(nv64, -1) - nv64
    totals = m_before + nv64

    bkeys = rng.fold_in(key, steps)  # (.., K, 2)
    k12 = rng.split(bkeys)  # bulk_update_all's (k1, k2)
    kcp = rng.split(k12[..., 1, :])  # step 2's (k_coin, k_phi)
    kbits = rng.split(kcp[..., 1, :])  # randint's internal split

    t = rng.randint64(k12[..., 0, :], torch.clamp(totals, min=1)[..., None], (r,), e0)
    coin = rng.uniform(kcp[..., 0, :], (r,), e0)
    phi_hi = rng.bits32(kbits[..., 0, :], (r,), e0).to(torch.int32)
    phi_lo = rng.bits32(kbits[..., 1, :], (r,), e0).to(torch.int32)
    return m_before, totals, t, coin, phi_hi, phi_lo


def _step2_fused(f1, chi_minus, f2, has_f3, f1_bpos, R: RankStructure,
                 coin, phi_hi, phi_lo):
    """``step2_level2`` on hoisted coin/phi randomness with lt-only plain
    searches; value-identical to the reference on every lane (a fresh f1's
    own arc is always present, and the Q2 exact-match test is one key
    comparison at the lt point)."""
    u, v = f1[..., 0], f1[..., 1]
    have_f1 = u >= 0
    with span("core.search"):
        lt4 = multisearch_lt(R.key_desc, _q1_queries(R.s, u, v, f1_bpos), "eager")
    r = u.shape[-1]
    zero = torch.zeros_like(lt4[..., :r])
    ld = torch.where(have_f1, lt4[..., :r] - lt4[..., 2 * r:3 * r], zero)
    rd = torch.where(have_f1, lt4[..., r:2 * r] - lt4[..., 3 * r:], zero)
    chi_plus = ld + rd
    chi_new = chi_minus + chi_plus
    take_new = have_f1 & (chi_plus > 0) & (coin < _p_new(chi_plus, chi_new))

    phi = randint_from_bits(phi_hi, phi_lo, torch.clamp(chi_plus, min=1))
    t_src = torch.where(phi < ld, u, v)
    t_rank = torch.where(phi < ld, phi, phi - ld)
    qk = pack2(t_src, t_rank)
    n2 = R.key_rank.shape[-1]
    with span("core.search"):
        lt = multisearch_lt(R.key_rank, qk, "eager")
    j = torch.clamp(lt, max=n2 - 1).long()
    found = (lt < n2) & (_at(R.key_rank, j) == qk)
    take_new = take_new & found

    f2_new = torch.where(take_new[..., None], _canon(_at(R.src, j), _at(R.dst, j)), f2)
    f2_bpos = torch.where(take_new, _at(R.pos, j), torch.full_like(lt, -1))
    return f2_new, chi_new, has_f3 & ~take_new, f2_bpos


def fused_batch(f1, chi, f2, has_f3, R: RankStructure, replace, w_sel, f1_bpos,
                coin, phi_hi, phi_lo):
    """One batch of the fused pipeline's per-batch residue in plain PyTorch:
    the precomputed step-1 selects, ``_step2_fused`` and step 3."""
    f1 = torch.where(replace[..., None], w_sel, f1)
    chi_m = torch.where(replace, torch.zeros_like(chi), chi)
    f2 = torch.where(replace[..., None], torch.full_like(f2, -1), f2)
    has_f3 = has_f3 & ~replace
    f2, chi, has_f3, f2_bpos = _step2_fused(
        f1, chi_m, f2, has_f3, f1_bpos, R, coin, phi_hi, phi_lo)
    has_f3 = step3_closing(f1, f2, has_f3, f2_bpos, R, "eager")
    return f1, chi, f2, has_f3


def chunk_draws(state: EstimatorState, Ws: Tensor, n_valids: Tensor, key: Tensor,
                step0: IntLike, e0: int = 0):
    """Every draw and step-1 select of a K-batch chunk, hoisted out of the
    batch loop: ``fused_ingest_hoisted``'s arguments after the structures
    (replace, w_sel, f1_bpos, coin, phi_hi, phi_lo). The ``fused_ingest``
    kernel computes the same values in registers instead. ``step0`` is an
    int or a bank's (T,) tensor of per-tenant first steps; ``e0`` the
    state's first estimator (the module docstring's shards)."""
    dev = Ws.device
    n_valids = n_valids.to(device=dev, dtype=torch.int32)
    steps = chunk_steps(step0, Ws.shape[-3], dev)
    with span("core.draw"):
        m_before, totals, t, coin, phi_hi, phi_lo = _chunk_randomness(state, n_valids, key,
                                                                      steps, e0)

    # the reservoir decisions are deterministic in (t, m_seen trajectory),
    # and m_seen's trajectory is a cumsum of the batch sizes
    nv64 = n_valids.to(torch.int64)
    replace = (t >= m_before[..., None]) & (totals[..., None] > 0)
    idx = torch.minimum(
        torch.clamp(t - m_before[..., None], min=0), torch.clamp(nv64 - 1, min=0)[..., None]
    )
    w_sel = _rows(Ws, idx)
    f1_bpos = torch.where(replace, idx, torch.full_like(idx, -1)).to(torch.int32)
    return replace, w_sel, f1_bpos, coin, phi_hi, phi_lo


def chunk_structures(Ws: Tensor, n_valids: Tensor, *, use_kernels: bool):
    """The K rank structures' fields that the batch loop reads, as
    ``fused_ingest`` takes them: key_desc, key_rank, src, dst, pos, ekey,
    epos (a bank's T·K of them under its leading axis). ``use_kernels``
    builds them with the tile-sort and segscan kernels."""
    R = rank_all_chunk(Ws, n_valids.to(device=Ws.device, dtype=torch.int32),
                       use_kernels=use_kernels)
    return R.key_desc, R.key_rank, R.src, R.dst, R.pos, R.ekey, R.epos


def _bulk_update_chunk_fused(state: EstimatorState, Ws: Tensor, n_valids: Tensor,
                             key: Tensor, step0: IntLike, *,
                             use_kernels: bool, e0: int = 0) -> EstimatorState:
    """The fused K-batch pipeline. The kernel route (``use_kernels``) builds
    the structures with kernels and hands the chunk to the ``fused_ingest``
    kernel, which draws its own randomness; the plain route hoists the draws
    and selects (``chunk_draws``) and runs ``fused_ingest_hoisted``."""
    from repro_torch.kernels.fused_ingest import fused_ingest, fused_ingest_hoisted

    nv = n_valids.to(device=Ws.device, dtype=torch.int32)
    with span("core.build"):
        structs = chunk_structures(Ws, nv, use_kernels=use_kernels)
    st = (state.f1, state.chi, state.f2, state.has_f3)
    if use_kernels:
        with span("core.fused_ingest"):
            out = fused_ingest(*st, *structs, Ws, nv, state.m_seen, key, step0, e0)
    else:
        draws = chunk_draws(state, Ws, nv, key, step0, e0)
        with span("core.fused_ingest"):
            out = fused_ingest_hoisted(*st, *structs, *draws)
    return EstimatorState(*out, state.m_seen + torch.sum(nv.to(torch.int64), dim=-1))


def bulk_update_chunk(state: EstimatorState, Ws: Tensor, n_valids: Tensor,
                      key: Tensor, step0: IntLike = 0, *, backend: str = "auto",
                      search: str = "auto", e0: int = 0) -> EstimatorState:
    """Fold K stacked batches into the state: bit-for-bit equal to

        for i in range(K):
            state = bulk_update_all(state, Ws[i], n_valids[i],
                                    fold_in(key, step0 + i))

    Ws: (K, s, 2) int32; n_valids: (K,) integer tensor; ``key`` is the
    stream key. A bank takes Ws (T, K, s, 2), n_valids (T, K), key (T, 2)
    and ``step0`` an int or a (T,) int64 tensor (each tenant's own first
    step, the elastic tier's per-slot cursors). ``backend`` is an ingest backend
    (``repro_torch.primitives.ingest``); ``search`` is the multisearch
    backend of the "scan" route (the fused routes search inside the batch
    loop: plain searches, or the kernel's own). ``e0``: the module
    docstring's shards."""
    b = resolve_ingest_backend(backend, Ws.device)
    if b == "scan":
        return _bulk_update_chunk_scan(state, Ws, n_valids, key, step0, search, e0)
    return _bulk_update_chunk_fused(state, Ws, n_valids, key, step0,
                                    use_kernels=(b == "kernel"), e0=e0)


# ---------------------------------------------------------------------------
# turnstile deletions (CoCoS-style liveness patching, arXiv:1802.04249)
# ---------------------------------------------------------------------------
INF64 = torch.iinfo(torch.int64).max


def delete_keys(D: Tensor, n_valid: IntLike) -> Tensor:
    """Sorted canonical int64 keys of a deletion batch D ((s, 2) int32; the
    first ``n_valid`` rows are edges, in any order), or of stacked ones
    (D (K, s, 2) with n_valid (K,), a bank's (T, s, 2) with (T,), or (T, K,
    s, 2) with (T, K)), one sort over the last axis for all. Padding rows
    map to the INT64 max sentinel, which no state key can equal."""
    dmin = torch.minimum(D[..., 0], D[..., 1])
    dmax = torch.maximum(D[..., 0], D[..., 1])
    if isinstance(n_valid, Tensor) and n_valid.dim():
        n_valid = n_valid.to(device=D.device)[..., None]
    real = torch.arange(D.shape[-2], dtype=torch.int32, device=D.device) < n_valid
    return torch.sort(torch.where(real, pack2(dmin, dmax), INF64), dim=-1).values


def _delete_queries(state: EstimatorState) -> Tensor:
    """The (3r,) membership queries of a deletion batch: each estimator's
    f1 edge, f2 edge and the wedge's closing edge. Unset slots (-1
    endpoints) pack to negative keys through ``pack2``'s sign extension, so
    they match no real or sentinel key; ``_apply_delete_hits`` masks them
    besides. A bank's are (T, 3r)."""
    u, v = state.f1[..., 0], state.f1[..., 1]
    a, b = state.f2[..., 0], state.f2[..., 1]
    o1 = torch.where((u == a) | (u == b), v, u)
    o2 = torch.where((a == u) | (a == v), b, a)
    return torch.cat([
        pack2(torch.minimum(u, v), torch.maximum(u, v)),
        pack2(torch.minimum(a, b), torch.maximum(a, b)),
        pack2(torch.minimum(o1, o2), torch.maximum(o1, o2)),
    ], dim=-1)


def _apply_delete_hits(state: EstimatorState, hit: Tensor) -> EstimatorState:
    """The elementwise clears of one deletion batch, from the (3r,) hit mask
    of ``_delete_queries``: a dead f1 resets the slot, a dead f2 drops f2
    and the closing flag, a dead closing edge clears the flag."""
    r = state.r
    have_f1 = state.f1[..., 0] >= 0
    have_f2 = have_f1 & (state.f2[..., 0] >= 0)
    hit_f1 = hit[..., :r] & have_f1
    hit_f2 = hit[..., r:2 * r] & have_f2
    hit_f3 = hit[..., 2 * r:] & have_f2
    f1 = torch.where(hit_f1[..., None], torch.full_like(state.f1, -1), state.f1)
    chi = torch.where(hit_f1, torch.zeros_like(state.chi), state.chi)
    f2 = torch.where((hit_f1 | hit_f2)[..., None], torch.full_like(state.f2, -1), state.f2)
    has_f3 = state.has_f3 & ~(hit_f1 | hit_f2 | hit_f3)
    return EstimatorState(f1, chi, f2, has_f3, state.m_seen)


def bulk_delete_update(state: EstimatorState, D: Tensor, n_valid: IntLike,
                       search: str = "auto") -> EstimatorState:
    """Fold one batch of edge deletions into all estimators (the reference's
    ``bulk_delete_update``): one multisearch of the 3r queries against the
    batch's sorted keys, then the patch rules of ``_apply_delete_hits``.

    ``m_seen`` is not decremented: it stays the insertion count that every
    sampling draw is a function of, so a triangle whose three edges are live
    keeps its tracking probability 1 / (m * chi), and every dead one is
    zeroed; the estimate is unbiased for the live graph. Contract: at most
    one live copy per edge key. No randomness is drawn and no step advances,
    so an all-insertion signed stream equals the insertion-only path. A
    bank's batch D (T, s, 2) is sorted row by row and searched with one
    batched ``multisearch_counts`` launch."""
    lt, le = multisearch_bounds(delete_keys(D, n_valid), _delete_queries(state), search)
    return _apply_delete_hits(state, le > lt)


def bulk_delete_chunk(state: EstimatorState, Ds: Tensor, n_valids: Tensor, *,
                      backend: str = "auto", search: str = "auto") -> EstimatorState:
    """Fold K stacked deletion batches (Ds (K, s, 2), n_valids (K,); a
    bank's (T, K, s, 2) and (T, K)) into the state, bit-identical to K
    ``bulk_delete_update`` calls (deletions carry no randomness). On the
    "scan" ingest backend it is that loop; otherwise the K key sorts are
    hoisted into one batched sort and each membership test is ``count_lt``
    plus one gathered key comparison, an exact-match test equal to
    ``le > lt``."""
    K, n = Ds.shape[-3], Ds.shape[-2]
    if resolve_ingest_backend(backend, Ds.device) == "scan":
        for i in range(K):
            state = bulk_delete_update(state, Ds[..., i, :, :], n_valids[..., i], search)
        return state
    dks = delete_keys(Ds, n_valids)
    for i in range(K):
        dk = dks[..., i, :]
        q = _delete_queries(state)
        lt = multisearch_lt(dk, q, search)
        hit = (lt < n) & (_at(dk, torch.clamp(lt, max=n - 1).long()) == q)
        state = _apply_delete_hits(state, hit)
    return state
