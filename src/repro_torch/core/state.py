"""Estimator state: r neighborhood-sampling estimators as a struct of arrays
(``repro.core.state``).

Per estimator (paper Invariant 3.1): level-1 edge f1, neighborhood size chi,
level-2 edge f2 (canonical (min, max)), and whether the closing edge f3 has
been seen. -1 marks an empty slot. m_seen is the stream length (int64).
"""
from __future__ import annotations

from typing import NamedTuple, Union

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
        return self.f1.shape[0]


def init_state(r: int, device: Union[str, torch.device] = "cpu") -> EstimatorState:
    return EstimatorState(
        f1=torch.full((r, 2), EMPTY, dtype=torch.int32, device=device),
        chi=torch.zeros((r,), dtype=torch.int32, device=device),
        f2=torch.full((r, 2), EMPTY, dtype=torch.int32, device=device),
        has_f3=torch.zeros((r,), dtype=torch.bool, device=device),
        m_seen=torch.zeros((), dtype=torch.int64, device=device),
    )
