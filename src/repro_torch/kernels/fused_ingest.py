"""fused_ingest: apply a K-batch chunk to the estimator state in one kernel
call that draws the chunk's randomness itself (CUDA kernel
``csrc/fused_ingest.cu``; the counterpart of ``repro/kernels/fused_ingest.py``).

Contract: bit-identical to the scan of ``bulk_update_all`` over the same
chunk (``repro_torch.kernels.ref.fused_ingest_ref``), given the chunk's K
rank structures from ``rank_all_chunk``, its edges, the stream key and the
chunk's first step.

``fused_ingest_hoisted`` is the batch loop on hoisted draws and selects, the
form of the Pallas kernel's arguments; ``fused_ingest_plain``, the kernel's
plain version, computes those draws and selects (``core.bulk.chunk_draws``)
and runs it.

Every argument may carry a leading tenant axis (a bank of T tenants, as the
reference runs its kernel under ``jax.vmap``): state (T, r, ..), structures
(T, K, ..), Ws (T, K, s, 2), n_valids (T, K), m_seen (T,), key (T, 2) and
step0 an int or a (T,) int64 tensor of per-tenant first steps. The kernel
route is then one launch a batch for all T tenants, as for one.

``e0`` is the global index of the state's first estimator: a shard of a
sharded plan holding estimators ``[e0, e0 + r)`` draws elements ``e0 ..``
of each full-r draw, so shards updated apart concatenate to one full-r call
bit for bit (a bank's tenants share one ``e0``). It is 0 for an unsharded
state.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor
_ARGS = [ctypes.c_void_p] * 20 + [ctypes.c_int64] * 5 + [ctypes.c_void_p, _build.QUEUED]


def fused_ingest_hoisted(
    f1, chi, f2, has_f3, key_desc, key_rank, src, dst, pos, ekey, epos,
    replace, w_sel, f1_bpos, coin, phi_hi, phi_lo,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The K-batch loop on hoisted draws in plain PyTorch: ``core.bulk.fused_batch``
    per batch with ``torch.searchsorted`` searches. Per (batch, estimator):
    replace (K, r) bool, w_sel (K, r, 2) int32, f1_bpos (K, r) int32, coin
    (K, r) float32, phi_hi/phi_lo (K, r) int32 carrying the uint32 bits; a
    bank adds its leading tenant axis to these and to the state."""
    from repro_torch.core.bulk import fused_batch
    from repro_torch.core.rank import RankStructure

    for k in range(replace.shape[-2]):
        # rank=None: the batch loop never reads the stored ranks; a bank's
        # searched keys are copied to contiguous rows, as searchsorted wants
        R = RankStructure(key_desc[..., k, :].contiguous(), key_rank[..., k, :].contiguous(),
                          src[..., k, :], dst[..., k, :], pos[..., k, :], None,
                          ekey[..., k, :].contiguous(), epos[..., k, :])
        f1, chi, f2, has_f3 = fused_batch(
            f1, chi, f2, has_f3, R, replace[..., k, :], w_sel[..., k, :, :],
            f1_bpos[..., k, :], coin[..., k, :], phi_hi[..., k, :], phi_lo[..., k, :])
    return f1, chi, f2, has_f3


def fused_ingest_plain(
    f1, chi, f2, has_f3, key_desc, key_rank, src, dst, pos, ekey, epos,
    Ws, n_valids, m_seen, key, step0, e0: int = 0,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The kernel's function in plain PyTorch: the chunk's draws and step-1
    selects (``core.bulk.chunk_draws``), then ``fused_ingest_hoisted``."""
    from repro_torch.core.bulk import chunk_draws
    from repro_torch.core.state import EstimatorState

    draws = chunk_draws(EstimatorState(f1, chi, f2, has_f3, m_seen), Ws, n_valids, key, step0,
                        e0)
    return fused_ingest_hoisted(f1, chi, f2, has_f3, key_desc, key_rank, src, dst, pos,
                                ekey, epos, *draws)


def fused_ingest(
    f1, chi, f2, has_f3, key_desc, key_rank, src, dst, pos, ekey, epos,
    Ws, n_valids, m_seen, key, step0, e0: int = 0,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Apply a K-batch chunk to the state; returns new (f1, chi, f2, has_f3).

    State: f1/f2 (r, 2) int32, chi (r,) int32, has_f3 (r,) bool. Structures:
    key_desc/key_rank (K, 2s) int64, src/dst/pos (K, 2s) int32, ekey (K, s)
    int64, epos (K, s) int32. The chunk: Ws (K, s, 2) int32, n_valids (K,)
    int32, m_seen the 0-d int64 stream length before it, key the (2,) int64
    stream key, step0 the chunk's first step (batch k draws from
    ``fold_in(key, step0 + k)``); with the tenant axis (module docstring)
    tenant t draws from ``fold_in(key[t], step0[t] + k)``. Everything stays
    on the device: no host sync. The caller owns the m_seen update. ``e0``:
    the module docstring's shards."""
    if f1.device.type == "cpu":
        return fused_ingest_plain(f1, chi, f2, has_f3, key_desc, key_rank, src, dst, pos,
                                  ekey, epos, Ws, n_valids, m_seen, key, step0, e0)
    dev = f1.device
    lead = tuple(f1.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"fused_ingest: f1 must be (r, 2) or (T, r, 2), got {tuple(f1.shape)}")
    T = lead[0] if lead else 1
    K, s = Ws.shape[-3], Ws.shape[-2]
    r = f1.shape[-2]
    i32, i64 = torch.int32, torch.int64
    for t, name, dt, shape in (
        (f1, "f1", i32, (r, 2)), (chi, "chi", i32, (r,)), (f2, "f2", i32, (r, 2)),
        (has_f3, "has_f3", torch.bool, (r,)),
        (key_desc, "key_desc", i64, (K, 2 * s)), (key_rank, "key_rank", i64, (K, 2 * s)),
        (src, "src", i32, (K, 2 * s)), (dst, "dst", i32, (K, 2 * s)),
        (pos, "pos", i32, (K, 2 * s)), (ekey, "ekey", i64, (K, s)),
        (epos, "epos", i32, (K, s)), (Ws, "Ws", i32, (K, s, 2)),
        (n_valids, "n_valids", i32, (K,)), (m_seen, "m_seen", i64, ()),
        (key, "key", i64, (2,)),
    ):
        _build.check(t, name, dt, lead + shape, dev)
    if isinstance(step0, Tensor):
        _build.check(step0, "step0", i64, lead, dev)
    else:  # the kernel reads every tenant's first step from the device
        step0 = torch.full(lead or (1,), int(step0), dtype=i64, device=dev)
    if s < 1 or 2 * s >= 2**31 or r >= 2**31:
        raise ValueError("fused_ingest: need 1 <= s and r, 2s below 2^31")
    e0 = int(e0)
    if e0 < 0 or e0 + r > 2**32:
        raise ValueError(f"fused_ingest: need 0 <= e0 and e0 + r <= 2^32, got e0={e0}, r={r}")
    f1_out = torch.empty_like(f1)
    chi_out = torch.empty_like(chi)
    f2_out = torch.empty_like(f2)
    has_f3_out = torch.empty_like(has_f3)
    if K == 0 or r == 0 or T == 0:
        return f1_out.copy_(f1), chi_out.copy_(chi), f2_out.copy_(f2), has_f3_out.copy_(has_f3)
    _build.launch(
        "fused_ingest", _build.load("fused_ingest", "fused_ingest", _ARGS),
        f1.data_ptr(), chi.data_ptr(), f2.data_ptr(), has_f3.data_ptr(),
        key_desc.data_ptr(), key_rank.data_ptr(), src.data_ptr(), dst.data_ptr(),
        pos.data_ptr(), ekey.data_ptr(), epos.data_ptr(), Ws.data_ptr(),
        n_valids.data_ptr(), m_seen.data_ptr(), key.data_ptr(), f1_out.data_ptr(),
        chi_out.data_ptr(), f2_out.data_ptr(), has_f3_out.data_ptr(),
        step0.data_ptr(), T, r, K, s, e0, _build.stream_handle(dev),
    )
    return f1_out, chi_out, f2_out, has_f3_out
