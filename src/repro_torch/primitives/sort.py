"""Composite-key sorting primitives (``repro.primitives.sort``).

Multi-field keys (arcs by (src, -pos), edges by (min, max)) are packed into
one int64 key and sorted once.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def pack2(hi: Tensor, lo: Tensor) -> Tensor:
    """``(hi << 32) | lo`` as int64, exactly as the reference: ``lo`` is
    sign-extended, not masked, so ``lo = -1`` (an empty slot) gives the key
    -1 whatever ``hi`` is. Real keys pack non-negative ids and never collide
    with such keys."""
    return (hi.to(torch.int64) << 32) | lo.to(torch.int64)


def unpack2(key: Tensor) -> tuple[Tensor, Tensor]:
    """Inverse of ``pack2`` for non-negative fields."""
    return (key >> 32).to(torch.int32), (key & 0xFFFFFFFF).to(torch.int32)


def composite_key(major: Tensor, minor: Tensor, minor_bound: int) -> Tensor:
    """``major * minor_bound + minor`` as int64; requires 0 <= minor <
    minor_bound."""
    return major.to(torch.int64) * int(minor_bound) + minor.to(torch.int64)


def sort_by_key(keys: Tensor, *values: Tensor) -> tuple[Tensor, ...]:
    """Sort ``keys`` ascending along the last axis and apply the same
    permutation to each of ``values``. Stable, like ``jnp.argsort``: step 3
    reads the last copy of a duplicate-edge run and relies on it."""
    sk, perm = torch.sort(keys, dim=-1, stable=True)
    return (sk,) + tuple(torch.gather(v, -1, perm) for v in values)
