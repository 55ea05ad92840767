"""Gradient all-reduce with error-feedback int8 compression
(``repro.train.grad_comm``).

Across the slower links between pods, compressing the all-reduce (int8
quantisation with error feedback) cuts its traffic 4x; error feedback keeps
what the quantisation lost and adds it back the next step, which preserves
convergence (Karimireddy et al., 2019).

The reference's ``psum`` over a named axis inside ``shard_map`` becomes,
on the port's one-process mesh, the plans' sum over per-shard tensors in
axis-index order (``core/distributed.py::_psum``): the arguments and
results are lists with one entry per shard of the mesh, and the sum runs
within each group of ``mesh.groups(axes)``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core.distributed import _psum
from repro_torch.train.optimizer import tree_map


class EFState(NamedTuple):
    residual: torch.Tensor  # the gradient's shape, float32


def init_ef(params):
    return tree_map(lambda p: EFState(torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device)), params)


def _quant_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantisation: (q, scale), rounding half to
    even as ``jnp.round`` does."""
    amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(grads: Sequence[torch.Tensor], efs: Sequence[EFState], mesh,
                    axes: Sequence[str]) -> tuple[list, list]:
    """Error-feedback int8 all-reduce of one gradient tensor per shard over
    ``axes``. Returns each shard's (mean gradient in float32, new EFState).
    The int8 payload is what would cross the links; the scales travel as
    float32 scalars."""
    deqs, new_efs = [], []
    for g, ef in zip(grads, efs):
        g = g.float() + ef.residual
        q, scale = _quant_int8(g)
        deqs.append(q.float() * scale)
        new_efs.append(EFState(g - deqs[-1]))  # what compression lost, re-applied next step
    means = [None] * mesh.size
    for group in mesh.groups(tuple(axes)):
        summed = _psum(mesh, group, [deqs[i] for i in group])
        mean = summed / float(len(group))
        for i in group:
            means[i] = mean.to(mesh.devices[i])
    return means, new_efs


def tree_compressed_psum(grads: Sequence, ef_trees: Sequence, mesh,
                         axes: Sequence[str]) -> tuple[list, list]:
    """``compressed_psum`` over every leaf of per-shard gradient trees
    (dicts): returns the per-shard trees of mean gradients and of new
    EFStates."""
    if isinstance(grads[0], dict):
        parts = {k: tree_compressed_psum([g[k] for g in grads], [e[k] for e in ef_trees],
                                         mesh, axes) for k in grads[0]}
        return ([{k: parts[k][0][i] for k in parts} for i in range(len(grads))],
                [{k: parts[k][1][i] for k in parts} for i in range(len(grads))])
    return compressed_psum(grads, ef_trees, mesh, axes)
