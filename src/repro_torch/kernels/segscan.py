"""segscan: inclusive segmented sum scan of int32 values, flag = segment
start (CUDA kernel ``csrc/segscan.cu``; the counterpart of
``repro/kernels/segscan.py``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.primitives.segscan import segmented_sum_scan

Tensor = torch.Tensor
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, _build.QUEUED]


def segscan_plain(values: Tensor, flags: Tensor) -> Tensor:
    """The scan in plain PyTorch (the reference's ``segscan_ref``)."""
    return segmented_sum_scan(values, flags.to(torch.bool))


def segscan(values: Tensor, flags: Tensor) -> Tensor:
    """Inclusive segmented sum scan over the whole 1-D array: each element is
    the sum of the values since the last set flag at or before it (from the
    start where there is none). int32 sums wrap. n == 0 returns the input."""
    if values.device.type == "cpu" and flags.device.type == "cpu":
        return segscan_plain(values, flags)
    dev = values.device
    _build.check(values, "values", torch.int32, device=dev)
    _build.check(flags, "flags", torch.bool, shape=values.shape, device=dev)
    if values.dim() != 1:
        raise ValueError("segscan takes 1-D values and flags")
    n = values.numel()
    if n == 0:
        return values
    tile = _build.load("segscan", "segscan_tile_size", [])()  # entries per CTA
    n_tiles = -(-n // tile)
    out = torch.empty_like(values)
    scratch = torch.empty(4 * n_tiles, dtype=torch.int32, device=dev)
    _build.launch("segscan", _build.load("segscan", "segscan", _ARGS), values.data_ptr(),
                  flags.data_ptr(), n, out.data_ptr(), scratch.data_ptr(),
                  _build.stream_handle(dev))
    return out
