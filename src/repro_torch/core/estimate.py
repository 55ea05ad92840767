"""Turning NBSI tuples into a triangle-count estimate (paper Lemma 3.2,
Thm 3.4; ``repro.core.estimate``).

Per estimator X = chi * m if the closing edge has been seen, else 0; E[X] =
tau. The estimate is a median of means over g groups of r/g estimators, with
``groups`` rounded down to the largest divisor of r (``effective_groups``).
A bank's state (a leading tenant axis) gets one estimate per tenant, the
reference's ``vmap(scheme.estimate)``.
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
    for a bank."""
    x = coarse_estimates(state)
    r = x.shape[-1]
    g = effective_groups(r, groups)
    return median(torch.mean(x.reshape(*x.shape[:-1], g, r // g), dim=-1))
