"""Elastic scaling (``repro.train.elastic``): change the estimator count,
and place a state on a new mesh.

The streaming estimator state is embarrassingly re-shardable: r
independent rows, and a counter-based RNG that does not depend on the
device count, so a restart on another mesh re-partitions the same global
arrays. ``reshard`` places a host or device state onto the port's
one-process ``Mesh`` (``launch/mesh.py``) through the layouts the
distributed plans use (``core/distributed.py``): an ``EstimatorState``
becomes a ``ShardedState`` that the pjit plans update, any other leaf a
list of per-shard tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import ShardedState, ShardPut, StateLayout
from repro_torch.core.schemes import ROLE_ESTIMATOR, ROLE_REPLICATED
from repro_torch.core.state import EMPTY, EstimatorState


def _axes(spec) -> tuple:
    """The mesh axes a spec (one entry per dimension, as a PartitionSpec:
    None, an axis name or a tuple of names) shards the leading dimension
    over; only the leading dimension may be sharded."""
    spec = tuple(spec)
    if any(s is not None for s in spec[1:]):
        raise ValueError(f"spec {spec}: only the leading dimension can be sharded")
    if not spec or spec[0] is None:
        return ()
    return (spec[0],) if isinstance(spec[0], str) else tuple(spec[0])


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def reshard(tree, mesh, spec_tree):
    """Place (host or device) arrays onto ``mesh`` with the given specs
    (``spec_tree`` has ``tree``'s structure, one spec a leaf). An
    ``EstimatorState`` whose sharded leaves name the same axes becomes a
    ``ShardedState`` (``.gather(device)`` reads it back); dicts, tuples
    and lists recurse; any other leaf becomes its per-shard tensors."""
    if isinstance(tree, EstimatorState):
        axes = {_axes(s) for s in spec_tree} - {()}
        if len(axes) > 1:
            raise ValueError(f"an EstimatorState shards over one set of axes, got {axes}")
        e_axes = axes.pop() if axes else ()
        roles = EstimatorState(*(ROLE_ESTIMATOR if _axes(s) else ROLE_REPLICATED
                                 for s in spec_tree))
        full = EstimatorState(*(_tensor(x) for x in tree))
        layout = StateLayout(mesh, roles, e_axes, None, full.r, None)
        return ShardedState(layout.shard(full), layout)
    if isinstance(tree, dict):
        return {k: reshard(v, mesh, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(reshard(x, mesh, s) for x, s in zip(tree, spec_tree))
    put = ShardPut(mesh, None, 0, _axes(spec_tree))
    return put.put(_tensor(tree), lambda block, dev: block.to(dev))


def shrink_or_grow_estimators(state: EstimatorState, new_r: int) -> EstimatorState:
    """Elastically change the estimator count (the accuracy-cost dial).

    Shrinking keeps a prefix (each estimator is i.i.d., so a prefix is an
    unbiased subsample). Growing appends fresh estimators (``f1 = f2 =
    -1``, ``chi = 0``, no ``f3``) that warm up on future batches only; their
    empty chi and f2 keep NBSI valid for the suffix stream (a documented
    bias: new estimators see a shorter stream, so production grows at
    stream boundaries or uses the prefix for estimates). ``m_seen`` is
    untouched."""
    r_old = state.f1.shape[0]
    if new_r <= r_old:
        return EstimatorState(f1=state.f1[:new_r], chi=state.chi[:new_r], f2=state.f2[:new_r],
                              has_f3=state.has_f3[:new_r], m_seen=state.m_seen)
    pad = new_r - r_old
    dev = state.f1.device
    return EstimatorState(
        f1=torch.cat([state.f1, torch.full((pad, 2), EMPTY, dtype=torch.int32, device=dev)]),
        chi=torch.cat([state.chi, torch.zeros((pad,), dtype=torch.int32, device=dev)]),
        f2=torch.cat([state.f2, torch.full((pad, 2), EMPTY, dtype=torch.int32, device=dev)]),
        has_f3=torch.cat([state.has_f3, torch.zeros((pad,), dtype=torch.bool, device=dev)]),
        m_seen=state.m_seen,
    )
