"""multisearch_counts: searchsorted left/right of int64 queries in sorted
int64 keys (CUDA kernel ``csrc/multisearch.cu``; the counterpart of
``repro/kernels/multisearch.py``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor
_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, _build.QUEUED]


def multisearch_counts_plain(sorted_keys: Tensor, queries: Tensor) -> tuple[Tensor, Tensor]:
    """(count_lt, count_le) as two ``torch.searchsorted`` calls, int32
    (the reference's ``multisearch_counts_ref``)."""
    lt = torch.searchsorted(sorted_keys, queries, side="left", out_int32=True)
    le = torch.searchsorted(sorted_keys, queries, side="right", out_int32=True)
    return lt, le


def multisearch_counts(sorted_keys: Tensor, queries: Tensor) -> tuple[Tensor, Tensor]:
    """(count_lt, count_le) per query, int32: the insertion points of
    ``queries`` into ``sorted_keys`` (1-D int64, ascending). ``le`` never
    exceeds n; n == 0 or q == 0 gives zeros without a launch."""
    if sorted_keys.device.type == "cpu" and queries.device.type == "cpu":
        return multisearch_counts_plain(sorted_keys, queries)
    dev = queries.device
    _build.check(sorted_keys, "sorted_keys", torch.int64, device=dev)
    _build.check(queries, "queries", torch.int64, device=dev)
    if sorted_keys.dim() != 1 or queries.dim() != 1:
        raise ValueError("multisearch_counts takes 1-D keys and queries")
    n, q = sorted_keys.numel(), queries.numel()
    if n >= 2**31:
        raise ValueError(f"multisearch_counts: n={n} does not fit int32 counts")
    lt = torch.empty(q, dtype=torch.int32, device=dev)
    le = torch.empty(q, dtype=torch.int32, device=dev)
    if n == 0 or q == 0:
        lt.zero_()
        le.zero_()
        return lt, le
    _build.launch("multisearch_counts", _build.load("multisearch", "multisearch_counts", _ARGS),
                  sorted_keys.data_ptr(), n, queries.data_ptr(), q, lt.data_ptr(),
                  le.data_ptr(), _build.stream_handle(dev))
    return lt, le
