"""multisearch_counts: searchsorted left/right of int64 queries in sorted
int64 keys (CUDA kernel ``csrc/multisearch.cu``; the counterpart of
``repro/kernels/multisearch.py``).

One row, keys (n,) and queries (q,), or a bank of B rows, keys (B, n) and
queries (B, q), each row's keys sorted on their own: the reference runs its
kernel under ``jax.vmap`` over tenants. Both are one launch; the one-row call
is B = 1 of it."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor
_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, _build.QUEUED]


def multisearch_counts_plain(sorted_keys: Tensor, queries: Tensor) -> tuple[Tensor, Tensor]:
    """(count_lt, count_le) as two ``torch.searchsorted`` calls, int32
    (the reference's ``multisearch_counts_ref``); rows search their own
    keys."""
    lt = torch.searchsorted(sorted_keys, queries, side="left", out_int32=True)
    le = torch.searchsorted(sorted_keys, queries, side="right", out_int32=True)
    return lt, le


def _check_rows(t: Tensor, name: str, dev) -> None:
    if not isinstance(t, Tensor) or t.device != dev or t.dtype != torch.int64:
        raise TypeError(f"{name}: expected an int64 tensor on {dev}")
    if t.dim() not in (1, 2) or (t.shape[-1] > 1 and t.stride(-1) != 1):
        raise ValueError(f"{name}: must be 1-D or 2-D with contiguous rows")


def multisearch_counts(sorted_keys: Tensor, queries: Tensor) -> tuple[Tensor, Tensor]:
    """(count_lt, count_le) per query, int32: the insertion points of
    ``queries`` into ``sorted_keys`` (int64, ascending), (n,) and (q,), or
    row by row for (B, n) and (B, q), which may be row-strided views. ``le``
    never exceeds n; n == 0 or q == 0 gives zeros without a launch."""
    if sorted_keys.device.type == "cpu" and queries.device.type == "cpu":
        return multisearch_counts_plain(sorted_keys, queries)
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"queries: expected a CUDA tensor, got {dev}")
    _check_rows(sorted_keys, "sorted_keys", dev)
    _check_rows(queries, "queries", dev)
    if sorted_keys.dim() != queries.dim() or (
            queries.dim() == 2 and sorted_keys.shape[0] != queries.shape[0]):
        raise ValueError(f"multisearch_counts: keys {tuple(sorted_keys.shape)} and queries "
                         f"{tuple(queries.shape)} must have the same rows")
    rows = queries.shape[0] if queries.dim() == 2 else 1
    n, q = sorted_keys.shape[-1], queries.shape[-1]
    if n >= 2**31:
        raise ValueError(f"multisearch_counts: n={n} does not fit int32 counts")
    lt = torch.empty(queries.shape, dtype=torch.int32, device=dev)
    le = torch.empty(queries.shape, dtype=torch.int32, device=dev)
    if n == 0 or q == 0 or rows == 0:
        lt.zero_()
        le.zero_()
        return lt, le
    key_stride = sorted_keys.stride(0) if sorted_keys.dim() == 2 else n
    query_stride = queries.stride(0) if queries.dim() == 2 else q
    _build.launch("multisearch_counts", _build.load("multisearch", "multisearch_counts", _ARGS),
                  sorted_keys.data_ptr(), rows, n, key_stride, queries.data_ptr(), q,
                  query_stride, lt.data_ptr(), le.data_ptr(), _build.stream_handle(dev))
    return lt, le
