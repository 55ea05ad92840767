"""Segmented scans, the paper's scan-with-reset (``repro.primitives.segscan``).

Each scan is written with whole-array PyTorch operations (``cummax``,
``cumsum``) instead of an associative scan; the results are exact for the
integer dtypes the ingest path scans.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def segment_starts(sorted_keys: Tensor) -> Tensor:
    """True where a new run of equal keys begins along the last axis (the
    first element always starts one)."""
    starts = torch.ones_like(sorted_keys, dtype=torch.bool)
    starts[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    return starts


def segmented_iota(starts: Tensor) -> Tensor:
    """Offset of each element within its segment (last axis), int32: the
    index minus a running maximum of the start indices."""
    idx = torch.arange(starts.shape[-1], dtype=torch.int64, device=starts.device)
    anchor = torch.where(starts, idx, torch.zeros_like(idx))
    return (idx - torch.cummax(anchor, dim=-1).values).to(torch.int32)


def segmented_cummax(values: Tensor, starts: Tensor) -> Tensor:
    """Inclusive segmented running maximum of int32 ``values`` (1-D), reset
    at each start flag: a plain running maximum over (segment id, value)
    packed into one int64, where the segment id dominates."""
    seg = torch.cumsum(starts.to(torch.int64), dim=-1)
    key = (seg << 32) | (values.to(torch.int64) + 2**31)
    return ((torch.cummax(key, dim=-1).values & 0xFFFFFFFF) - 2**31).to(
        values.dtype
    )


def segmented_sum_scan(values: Tensor, starts: Tensor) -> Tensor:
    """Inclusive segmented sum scan of integer ``values`` (1-D): a running
    sum in int64 minus its value just before each segment's start. Sums
    wrap to the input dtype, like the reference's int32 scan."""
    total = torch.cumsum(values.to(torch.int64), dim=-1)
    idx = torch.arange(values.shape[-1], dtype=torch.int64, device=values.device)
    first = torch.cummax(
        torch.where(starts, idx, torch.zeros_like(idx)), dim=-1
    ).values
    before = torch.where(
        first > 0,
        total.gather(-1, torch.clamp(first - 1, min=0)),
        torch.zeros_like(total),
    )
    return (total - before).to(values.dtype)
