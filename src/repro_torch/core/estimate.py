"""Turning NBSI tuples into a triangle-count estimate (paper Lemma 3.2,
Thm 3.4; ``repro.core.estimate``).

Per estimator X = chi * m if the closing edge has been seen, else 0; E[X] =
tau. The estimate is a median of means over g groups of r/g estimators, with
``groups`` rounded down to the largest divisor of r (``effective_groups``).
A bank's state (a leading tenant axis) gets one estimate per tenant, the
reference's ``vmap(scheme.estimate)``.

Shardable decomposition (the device-resident query of the sharded plans,
``repro_torch.core.distributed``): a shard holding the contiguous estimator
slice ``[offset, offset + r_local)`` computes ``partial_group_sums``, its
coarse estimates added into the g group bins by global index, and
``combine_group_sums`` adds the shards' partials in shard order, divides by
the group size and takes the median. That is ``estimate`` bit for bit: each
coarse estimate is an integer (``chi * m_seen``) held exactly in float64, so
the group sums are exact integers below 2**53 in any order of addition.
"""
from __future__ import annotations

import torch

from repro_torch.core.state import EstimatorState


def effective_groups(r: int, groups: int) -> int:
    """Largest divisor of ``r`` that is <= ``groups`` (and >= 1); a request
    above r collapses to 1, the plain mean."""
    if r < 1:
        raise ValueError(f"need at least one estimator, got r={r}")
    if groups > r:
        return 1
    g = max(1, int(groups))
    while r % g:
        g -= 1
    return g


def coarse_estimates(state: EstimatorState) -> torch.Tensor:
    """(r,) float64 unbiased coarse estimates (Lemma 3.2); (T, r) for a
    bank."""
    x = state.chi.to(torch.float64) * state.m_seen.to(torch.float64)[..., None]
    return torch.where(state.has_f3, x, torch.zeros_like(x))


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last axis, as its 'midpoint' rule computes it:
    ``(low + high) * 0.5`` of the two middle values, which averages them for
    an even count (``torch.median`` would return the lower one)."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def estimate(state: EstimatorState, groups: int = 9) -> torch.Tensor:
    """Median-of-means over all r estimators, a 0-d float64 tensor; (T,)
    for a bank. A group's mean is its (exact, integer) sum times the
    float64 reciprocal of its size, as the reference's ``jnp.mean``
    computes it (XLA folds the division by a constant into that multiply),
    which differs from a division in the last bit where the size is not a
    power of two."""
    x = coarse_estimates(state)
    r = x.shape[-1]
    g = effective_groups(r, groups)
    return median(torch.sum(x.reshape(*x.shape[:-1], g, r // g), dim=-1) * (1.0 / (r // g)))


def partial_group_sums(x_local: torch.Tensor, offset: int, r: int, groups: int) -> torch.Tensor:
    """(g,) float64 partial group sums of the coarse estimates ``x_local``
    ((r_local,), or (T, r_local) for a bank's slice, giving (T, g)) whose
    first element is estimator ``offset`` of r. Groups are contiguous blocks
    of r // g, so a shard may straddle a boundary: each element lands in the
    bin its global index names, and bins the shard does not touch stay 0."""
    g = effective_groups(r, groups)
    n = x_local.shape[-1]
    gid = (offset + torch.arange(n, device=x_local.device)) // (r // g)
    out = torch.zeros(*x_local.shape[:-1], g, dtype=torch.float64, device=x_local.device)
    return out.index_add_(-1, gid, x_local.to(torch.float64))


def combine_group_sums(partials: torch.Tensor, r: int, groups: int) -> torch.Tensor:
    """Median of means from stacked (n_shards, .., g) partial group sums,
    added over the leading axis in shard order; equals ``estimate``."""
    g = effective_groups(r, groups)
    return median(torch.sum(partials, dim=0) / (r // g))
