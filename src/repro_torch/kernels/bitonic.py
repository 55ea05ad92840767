"""bitonic_sort_tiles: sort each power-of-two tile of (int64 key, int32
payload) on its own (CUDA kernel ``csrc/bitonic.cu``, a shared-memory block
sort plus merge-path passes; the counterpart of ``repro/kernels/bitonic.py``,
whose name it keeps).

Contract (``repro/kernels/ref.py``): keys bit-equal to a stable sort of each
tile; payloads equal to it as a multiset per tile; payloads at keys equal to
the pad sentinel (int64 max) unspecified. The CUDA kernel's merges are
stable, so it also gives the stable sort's payloads, a stronger result than
the contract asks of it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor
INT64_MAX = 0x7FFFFFFFFFFFFFFF
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, _build.QUEUED]


def _pad(keys: Tensor, values: Tensor, tile: int) -> tuple[Tensor, Tensor]:
    """Copies of keys/values padded to a multiple of ``tile`` with int64 max
    keys and zero payloads."""
    n = keys.numel()
    n_pad = -(-n // tile) * tile
    k = torch.empty((n_pad,), dtype=keys.dtype, device=keys.device)
    v = torch.empty((n_pad,), dtype=values.dtype, device=values.device)
    k[:n] = keys
    k[n:] = INT64_MAX
    v[:n] = values
    v[n:] = 0
    return k, v


def bitonic_sort_tiles_plain(keys: Tensor, values: Tensor, tile: int) -> tuple[Tensor, Tensor]:
    """A stable ``torch.sort`` of each tile (the reference's
    ``bitonic_sort_tiles_ref``)."""
    n = keys.numel()
    if n == 0:
        return keys, values
    k, v = _pad(keys, values, tile)
    ks, order = torch.sort(k.view(-1, tile), dim=1, stable=True)
    vs = torch.gather(v.view(-1, tile), 1, order)
    return ks.reshape(-1)[:n], vs.reshape(-1)[:n]


def bitonic_sort_tiles(keys: Tensor, values: Tensor, tile: int) -> tuple[Tensor, Tensor]:
    """Sort each consecutive ``tile`` of (keys, values) by key, out of place;
    a ragged input is padded to a whole number of tiles and the result cut
    back to n. On the card: one launch for ``tile`` up to the kernel's block
    of 4096 entries, then one merge pass per doubling (10 at tile 2^21)."""
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    if keys.device.type == "cpu" and values.device.type == "cpu":
        return bitonic_sort_tiles_plain(keys, values, tile)
    dev = keys.device
    _build.check(keys, "keys", torch.int64, device=dev)
    _build.check(values, "values", torch.int32, shape=keys.shape, device=dev)
    if keys.dim() != 1:
        raise ValueError("bitonic_sort_tiles takes 1-D keys and values")
    n = keys.numel()
    if n == 0:
        return keys, values
    k, v = (keys, values) if n % tile == 0 else _pad(keys, values, tile)
    n_pad = k.numel()
    out_k, out_v = torch.empty_like(k), torch.empty_like(v)
    # the merge passes ping-pong through one scratch buffer of n entries,
    # held here until the launches are queued
    block = _build.load("bitonic", "bitonic_sort_block", [])()
    scratch = (torch.empty_like(k), torch.empty_like(v)) if tile > block else None
    _build.launch("bitonic_sort_tiles", _build.load("bitonic", "bitonic_sort_tiles", _ARGS),
                  k.data_ptr(), v.data_ptr(), out_k.data_ptr(), out_v.data_ptr(),
                  *((t.data_ptr() for t in scratch) if scratch else (None, None)),
                  n_pad, tile, _build.stream_handle(dev))
    return out_k[:n], out_v[:n]
