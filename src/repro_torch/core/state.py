"""Estimator state: r neighborhood-sampling estimators as a struct of arrays
(``repro.core.state``).

Per estimator (paper Invariant 3.1): level-1 edge f1, neighborhood size chi,
level-2 edge f2 (canonical (min, max)), and whether the closing edge f3 has
been seen. -1 marks an empty slot. m_seen is the stream length (int64).

A bank of T tenants is the same struct with a leading tenant axis on every
field (``init_state(r, n_tenants=T)``), the layout the reference's engine
keeps; every update and query of ``repro_torch.core`` takes either form.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

EMPTY = -1


class EstimatorState(NamedTuple):
    f1: torch.Tensor  # (r, 2) int32, -1 if unset
    chi: torch.Tensor  # (r,) int32
    f2: torch.Tensor  # (r, 2) int32 canonical (min, max), -1 if unset
    has_f3: torch.Tensor  # (r,) bool
    m_seen: torch.Tensor  # () int64

    @property
    def r(self) -> int:
        return self.f1.shape[-2]


def init_state(r: int, device: Union[str, torch.device] = "cpu",
               n_tenants: Optional[int] = None) -> EstimatorState:
    """Empty estimators; ``n_tenants`` adds the leading tenant axis of a
    bank."""
    lead = () if n_tenants is None else (n_tenants,)
    return EstimatorState(
        f1=torch.full(lead + (r, 2), EMPTY, dtype=torch.int32, device=device),
        chi=torch.zeros(lead + (r,), dtype=torch.int32, device=device),
        f2=torch.full(lead + (r, 2), EMPTY, dtype=torch.int32, device=device),
        has_f3=torch.zeros(lead + (r,), dtype=torch.bool, device=device),
        m_seen=torch.zeros(lead, dtype=torch.int64, device=device),
    )


def tenant_state(bank: EstimatorState, tenant: int) -> EstimatorState:
    """One tenant's state out of a bank (views, no copy)."""
    return EstimatorState(*(x[tenant] for x in bank))
