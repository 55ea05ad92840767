"""segment_sum: sums (n, d) float64 rows into ``num_segments`` bins by id,
dropping ids outside [0, num_segments) (CUDA kernel ``csrc/segment_sum.cu``;
the counterpart of ``repro/kernels/segment_sum.py``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, _build.QUEUED]


def segment_sum_plain(values: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """The sums as one ``index_add_`` over the rows whose id is in range
    (the reference's ``segment_sum_ref``)."""
    out = torch.zeros((num_segments, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    return out.index_add_(0, segment_ids[keep].long(), values[keep])


def segment_sum(values: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """``out[k, :] = sum(values[i, :] for i with segment_ids[i] == k)``:
    values (n, d) float64, segment_ids (n,) int32, out (num_segments, d)
    float64. Ids outside [0, num_segments), the -1 padding included, are
    dropped. ``num_segments == 0`` gives (0, d); n == 0 gives zeros; neither
    launches.

    Exact only for integer-valued sums: the kernel adds with atomics in no
    fixed order, so it equals every other summation order where each value
    and each partial sum is an integer below 2**53 in magnitude. The local
    scheme's attribution sums (integer coarse estimates chi * m_seen) are
    that case."""
    if values.device.type == "cpu" and segment_ids.device.type == "cpu":
        return segment_sum_plain(values, segment_ids, num_segments)
    dev = values.device
    if values.dim() != 2:
        raise ValueError(f"segment_sum takes (n, d) values, got shape {tuple(values.shape)}")
    n, d = values.shape
    _build.check(values, "values", torch.float64, device=dev)
    _build.check(segment_ids, "segment_ids", torch.int32, shape=(n,), device=dev)
    if not 0 <= num_segments < 2**31:
        raise ValueError(f"segment_sum: num_segments={num_segments} out of int32 range")
    if n == 0 or num_segments == 0:
        return torch.zeros((num_segments, d), dtype=values.dtype, device=dev)
    out = torch.empty((num_segments, d), dtype=values.dtype, device=dev)
    _build.launch("segment_sum", _build.load("segment_sum", "segment_sum", _ARGS),
                  values.data_ptr(), segment_ids.data_ptr(), n, d, num_segments,
                  out.data_ptr(), _build.stream_handle(dev))
    return out
