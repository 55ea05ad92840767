"""Sparse embedding substrate (``repro.models.embedding``): EmbeddingBag and
hash-bucketed tables, as a gather of table rows followed by a segment
reduction over bag ids.

The segment reductions keep ``jax.ops.segment_sum``/``segment_max``'s
contract: an id below 0 or at or past the number of segments adds nothing
(``index_add_`` would raise on it, so such rows go to a spare row that is
cut off), and an empty segment's maximum is ``-inf``. They are plain
``index_add``/``scatter_reduce``: the reference reduces here with XLA's
scatter, not with its Pallas ``segment_sum`` kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor
_HASH_MULT = 2654435761
M32 = 0xFFFFFFFF


def _spare_ids(ids: Tensor, num_segments: int) -> Tensor:
    """``ids`` as int64 with every id outside [0, num_segments) sent to the
    spare row ``num_segments``."""
    ids = ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids, torch.full_like(ids, num_segments))


def segment_sum(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """``jax.ops.segment_sum``: rows of ``data`` summed into ``num_segments``
    bins along axis 0; ids out of range are dropped."""
    ids = _spare_ids(segment_ids, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, ids, data)[:num_segments]


def segment_max(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """``jax.ops.segment_max``: the elementwise maximum of each bin's rows,
    ``-inf`` in an empty bin; ids out of range are dropped."""
    ids = _spare_ids(segment_ids, num_segments)
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), -torch.inf,
                     dtype=data.dtype, device=data.device)
    idx = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=False)[:num_segments]


def embedding_bag(
    table: Tensor,  # (V, d)
    indices: Tensor,  # (nnz,) int -- flattened multi-hot ids
    segment_ids: Tensor,  # (nnz,) int -- which bag each id belongs to
    num_bags: int,
    *,
    mode: str = "sum",
    weights: Optional[Tensor] = None,  # (nnz,) per-sample weights
    valid: Optional[Tensor] = None,  # (nnz,) bool -- padding mask
) -> Tensor:
    """``torch.nn.EmbeddingBag`` semantics the reference's way: ids clipped
    into the table, rows gathered, weighted, masked, then reduced per bag.
    ``max`` with ``valid`` turns every row entry equal to 0 into float32's
    lowest finite value before the reduction, and empty bags give 0."""
    v = table.shape[0]
    rows = table[torch.clamp(indices.long(), 0, v - 1)]
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    if valid is not None:
        rows = torch.where(valid[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))
    if mode == "sum":
        return segment_sum(rows, segment_ids, num_bags)
    if mode == "mean":
        s = segment_sum(rows, segment_ids, num_bags)
        ones = torch.ones(indices.shape[0], dtype=torch.float32, device=rows.device)
        if valid is not None:
            ones = torch.where(valid, ones, torch.zeros_like(ones))
        c = segment_sum(ones, segment_ids, num_bags)
        return s / torch.clamp(c[:, None], min=1.0).to(s.dtype)
    if mode == "max":
        r = rows
        if valid is not None:
            neg = torch.tensor(torch.finfo(torch.float32).min, dtype=torch.float32,
                               device=rows.device)
            r = torch.where(rows == 0, neg, rows)
        out = segment_max(r, segment_ids, num_bags)
        return torch.where(torch.isfinite(out.float()), out,
                           torch.zeros((), dtype=out.dtype, device=out.device))
    raise ValueError(mode)


def hash_bucket_lookup(table: Tensor, raw_ids: Tensor) -> Tensor:
    """Rows at ``(uint32(raw_id) * 2654435761 mod 2^32) mod V``, the
    reference's wrapping uint32 hash, reckoned in int64 (the product's low
    32 bits survive int64's wrap)."""
    v = table.shape[0]
    h = ((raw_ids.long() & M32) * _HASH_MULT) & M32
    return table[h % v]
