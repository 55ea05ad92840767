"""segscan: inclusive segmented scans of int32 values, flag = segment start
(CUDA kernel ``csrc/segscan.cu``, one launch a call; the counterpart of
``repro/kernels/segscan.py``). ``segscan`` sums, wrapping at 2^32;
``segmented_max_scan`` takes the running signed maximum, the same kernel
over another monoid."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.primitives.segscan import segmented_cummax, segmented_sum_scan

Tensor = torch.Tensor
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, _build.QUEUED]


def segscan_plain(values: Tensor, flags: Tensor) -> Tensor:
    """The sum scan in plain PyTorch (the reference's ``segscan_ref``)."""
    return segmented_sum_scan(values, flags.to(torch.bool))


def segmented_max_scan_plain(values: Tensor, flags: Tensor) -> Tensor:
    """The max scan in plain PyTorch (``segmented_cummax``)."""
    return segmented_cummax(values, flags.to(torch.bool))


def _scan(kernel: str, entry: str, values: Tensor, flags: Tensor) -> Tensor:
    dev = values.device
    _build.check(values, "values", torch.int32, device=dev)
    _build.check(flags, "flags", torch.bool, shape=values.shape, device=dev)
    if values.dim() != 1:
        raise ValueError(f"{kernel} takes 1-D values and flags")
    n = values.numel()
    if n == 0:
        return values
    tile = _build.load("segscan", "segscan_tile_size", [])()  # entries per CTA
    out = torch.empty_like(values)
    # the tile counter, then one status word a tile
    scratch = torch.empty(-(-n // tile) + 1, dtype=torch.int64, device=dev)
    _build.launch(kernel, _build.load("segscan", entry, _ARGS), values.data_ptr(),
                  flags.data_ptr(), n, out.data_ptr(), scratch.data_ptr(),
                  _build.stream_handle(dev))
    return out


def segscan(values: Tensor, flags: Tensor) -> Tensor:
    """Inclusive segmented sum scan over the whole 1-D array: each element is
    the sum of the values since the last set flag at or before it (from the
    start where there is none). int32 sums wrap. n == 0 returns the input."""
    if values.device.type == "cpu" and flags.device.type == "cpu":
        return segscan_plain(values, flags)
    return _scan("segscan", "segscan", values, flags)


def segmented_max_scan(values: Tensor, flags: Tensor) -> Tensor:
    """Inclusive segmented running maximum over the whole 1-D int32 array,
    reset at each set flag (from the start where there is none). n == 0
    returns the input."""
    if values.device.type == "cpu" and flags.device.type == "cpu":
        return segmented_max_scan_plain(values, flags)
    return _scan("segmented_max_scan", "segscan_max", values, flags)
