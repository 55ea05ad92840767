"""segment_sum: sums (n, d) float64 rows into ``num_segments`` bins by id,
dropping ids outside [0, num_segments) (CUDA kernel ``csrc/segment_sum.cu``;
the counterpart of ``repro/kernels/segment_sum.py``).

A bank of tenants, values (T, n, d) and ids (T, n), gives (T, num_segments,
d), each tenant's rows summed into its own bins (the reference runs its
kernel under ``jax.vmap`` over tenants); it is one launch, like the
one-tenant call."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, _build.QUEUED]


def segment_sum_plain(values: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """The sums as one ``index_add_`` over the rows whose id is in range
    (the reference's ``segment_sum_ref``); a bank's ids are offset into
    their tenant's bins after the range check."""
    lead, (n, d) = tuple(segment_ids.shape[:-1]), values.shape[-2:]
    T = math.prod(lead)
    ids = segment_ids.reshape(T, n)
    keep = (ids >= 0) & (ids < num_segments)
    bins = ids.long() + num_segments * torch.arange(T, device=ids.device)[:, None]
    out = torch.zeros((T * num_segments, d), dtype=values.dtype, device=values.device)
    out.index_add_(0, bins[keep], values.reshape(T, n, d)[keep])
    return out.view(*lead, num_segments, d)


def segment_sum(values: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """``out[..., k, :] = sum(values[..., i, :] for i with segment_ids[..., i]
    == k)``: values (n, d) or (T, n, d) float64, segment_ids (n,) or (T, n)
    int32, out (num_segments, d) or (T, num_segments, d) float64. Ids
    outside [0, num_segments), the -1 padding included, are dropped (within
    their tenant). ``num_segments == 0`` gives (.., 0, d); n == 0 gives
    zeros; neither launches.

    Exact only for integer-valued sums: the kernel adds with atomics in no
    fixed order, so it equals every other summation order where each value
    and each partial sum is an integer below 2**53 in magnitude. The local
    scheme's attribution sums (integer coarse estimates chi * m_seen) are
    that case."""
    if values.device.type == "cpu" and segment_ids.device.type == "cpu":
        return segment_sum_plain(values, segment_ids, num_segments)
    dev = values.device
    if values.dim() not in (2, 3):
        raise ValueError(f"segment_sum takes (n, d) or (T, n, d) values, got shape "
                         f"{tuple(values.shape)}")
    lead, (n, d) = tuple(values.shape[:-2]), values.shape[-2:]
    T = lead[0] if lead else 1
    _build.check(values, "values", torch.float64, device=dev)
    _build.check(segment_ids, "segment_ids", torch.int32, shape=(*lead, n), device=dev)
    if not 0 <= num_segments < 2**31:
        raise ValueError(f"segment_sum: num_segments={num_segments} out of int32 range")
    if n == 0 or num_segments == 0 or T == 0:
        return torch.zeros((*lead, num_segments, d), dtype=values.dtype, device=dev)
    out = torch.empty((*lead, num_segments, d), dtype=values.dtype, device=dev)
    _build.launch("segment_sum", _build.load("segment_sum", "segment_sum", _ARGS),
                  values.data_ptr(), segment_ids.data_ptr(), T, n, d, num_segments,
                  out.data_ptr(), _build.stream_handle(dev))
    return out
