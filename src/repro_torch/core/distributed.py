"""The sharded execution plans on a one-process device mesh
(``repro.core.distributed``).

A sharded state is a list of per-shard states (``ShardedState``), shard i
on ``mesh.devices[i]``, laid out from the scheme's axis roles
(``scheme_state_sharding``): ``estimator``/``pair`` leaves split their
estimator axis into contiguous slices, ``replicated`` leaves (``m_seen``)
are copied to every shard; a banked state also splits its tenant axis over
the mesh axis named ``tenant_axis``. One engine drives every shard, and
the collectives are the private functions below over lists of per-shard
tensors, run in axis-index order: ``_all_to_all``, ``_all_gather``,
``_psum`` and ``Mesh.axis_index``. On one device they are tensor copies;
across GPUs they are peer copies.

The plans, each with the reference's call convention, so the engine does
not care which one it runs:

* ``make_pjit_update(mesh, w_mode)``: every shard updates its estimator
  slice with the whole batch. ``independent`` uploads W to every shard,
  ``coordinated_xla`` uploads each shard a block of W's rows and
  all-gathers them before the structure build. A shard holding estimators
  ``[e0, e0 + r_local)`` draws elements ``e0 ..`` of each full-r draw
  (``core.bulk``'s ``e0``), so the plan equals ``single`` bit for bit, as
  the reference's does under partitionable threefry.
* ``make_banked_pjit_update`` / ``make_banked_pjit_chunk_update``: the
  tenant-sharded bank, tenants over ``tenant_axis`` and estimators over the
  other axes; within a tenant group the ``w_mode`` choice is the same. The
  chunked form runs ``scheme.chunk_update`` per shard, where the kernel
  route's ``fused_ingest`` draws at the shard's ``e0``.
* ``make_pjit_delete`` / ``make_banked_delete``: deletions are elementwise
  per estimator and draw nothing, so each shard patches its slice against
  the whole deletion batch.
* ``make_sharded_estimate`` / ``make_banked_estimate``: the device-resident
  query. Each shard reduces its slice with ``scheme.partial_estimate``, the
  fixed-shape partials are gathered within the estimator group in
  axis-index order and ``scheme.combine_estimates`` answers, bit-identical
  to the gathered oracle (``core/estimate.py``).
* ``make_coordinated_update``: the explicit coordinated plan
  (``shardmap``). Arcs are hash-partitioned by source and the closing-edge
  index by min endpoint (the owner of vertex x is ``vertex_pool(x, p)``,
  the local scheme's uint32 hash) with one all_to_all each, so ranks computed on the
  owner shard are global ranks; every estimator lookup (the level-1 fetch,
  Q1 rank/degree, the Q2 decode, the closing probe) is a routed
  multisearch: queries go to the owner shard through capacity-padded
  buffers, are answered with the local structure and come back through the
  inverse exchange. A shard draws from ``fold_in(key, shard)`` split three
  ways, so this plan's state differs from ``single`` and equals the
  reference's ``shard_map`` plan. Rows past a (sender, receiver) buffer's
  capacity are dropped and counted; the update returns the overflow summed
  over the mesh, which the engine watches.

On CUDA tensors (the multisearch backend resolving to "kernel") the
``shardmap`` plan's sorts are ``bitonic_sort_tiles`` over one padded tile,
its segmented iotas ``segscan`` and its searches ``multisearch_counts``;
the pjit and banked plans reach the kernels through the core updates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.rank import _next_pow2
from repro_torch.core.schemes import (
    ROLE_ESTIMATOR,
    ROLE_PAIR,
    ROLE_REPLICATED,
    EstimatorScheme,
    GlobalScheme,
    resolve_scheme,
    vertex_pool,
)
from repro_torch.core.state import EstimatorState
from repro_torch.primitives.search import (
    exact_from_lt,
    exact_multisearch,
    multisearch_lt,
    resolve_multisearch_backend,
)
from repro_torch.primitives.segscan import segment_starts
from repro_torch.primitives.sort import pack2

Tensor = torch.Tensor
INF64 = torch.iinfo(torch.int64).max
GLOBAL = GlobalScheme()


# ---------------------------------------------------------------------------
# collectives over lists of per-shard tensors (axis-index order)
# ---------------------------------------------------------------------------
def _all_to_all(mesh, group: Sequence[int], bufs: Sequence[Tensor]) -> list[Tensor]:
    """``jax.lax.all_to_all(x, axes, 0, 0, tiled=True)`` over ``group``:
    block j of member i's buffer lands as block i of member j's."""
    p = len(group)
    cap = bufs[0].shape[0] // p
    return [torch.cat([bufs[i][j * cap:(j + 1) * cap].to(mesh.devices[group[j]])
                       for i in range(p)]) for j in range(p)]


def _all_gather(mesh, group: Sequence[int], xs: Sequence[Tensor], dim: int = 0,
                stack: bool = False) -> list[Tensor]:
    """Every member's tensors, concatenated (or stacked) along ``dim`` in
    axis-index order, on each member's device; members that share a device
    share one result."""
    out, by_dev = [], {}
    for j in group:
        dev = mesh.devices[j]
        if dev not in by_dev:
            parts = [x.to(dev) for x in xs]
            by_dev[dev] = torch.stack(parts, dim) if stack else torch.cat(parts, dim)
        out.append(by_dev[dev])
    return out


def _psum(mesh, group: Sequence[int], xs: Sequence[Tensor]) -> Tensor:
    """The sum of the members' tensors in axis-index order, on the first
    member's device."""
    dev = mesh.devices[group[0]]
    total = xs[0].to(dev)
    for x in xs[1:]:
        total = total + x.to(dev)
    return total


def _to(x, dev):
    """A tensor moved to ``dev``; anything else as it is."""
    return x.to(dev) if isinstance(x, Tensor) else x


# ---------------------------------------------------------------------------
# layouts: axis roles -> per-shard slices
# ---------------------------------------------------------------------------
def _split(n: int, k: int) -> list[tuple[int, int]]:
    """Contiguous blocks of ``ceil(n / k)`` (the last ones shorter, maybe
    empty), as jax lays a dimension out over k shards."""
    c = -(-n // k) if k else n
    return [(min(i * c, n), min((i + 1) * c, n)) for i in range(k)]


@dataclass(frozen=True)
class StateLayout:
    """Where each shard's block of a state lies: its tenant range (banked
    layouts) and its estimator range, and each leaf's role."""

    mesh: object
    roles: EstimatorState
    e_axes: tuple
    tenant_axis: Optional[str]
    r: int
    n_tenants: Optional[int]

    def _t(self, shard: int) -> Optional[tuple[int, int]]:
        if self.tenant_axis is None:
            return None
        t_size = self.mesh.shape[self.tenant_axis]
        return _split(self.n_tenants, t_size)[self.mesh.axis_index(shard, (self.tenant_axis,))]

    def e_range(self, shard: int) -> tuple[int, int]:
        return _split(self.r, self.mesh.axis_size(self.e_axes))[
            self.mesh.axis_index(shard, self.e_axes)]

    def t_range(self, shard: int) -> Optional[tuple[int, int]]:
        return self._t(shard)

    def e_groups(self) -> list[list[int]]:
        """The estimator groups: the shards of one tenant block, in
        estimator order, the groups in tenant order."""
        return self.mesh.groups(self.e_axes)

    def shard(self, full: EstimatorState) -> list[EstimatorState]:
        """Each shard's block of a full state, on the shard's device."""
        out = []
        for i, dev in enumerate(self.mesh.devices):
            lo, hi = self.e_range(i)
            t = self._t(i)
            fields = []
            for x, role in zip(full, self.roles):
                if t is not None:
                    x = x[t[0]:t[1]]
                if role in (ROLE_ESTIMATOR, ROLE_PAIR):
                    x = x[:, lo:hi] if t is not None else x[lo:hi]
                elif role != ROLE_REPLICATED:
                    raise ValueError(f"unknown axis role {role!r}")
                # a contiguous copy of its own on the shard's device
                fields.append(torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(x))
            out.append(EstimatorState(*fields))
        return out

    def gather(self, shards: Sequence[EstimatorState], device) -> EstimatorState:
        """The full state on ``device``: each tenant block's estimator slices
        concatenated in order, the blocks in tenant order."""
        axis = 1 if self.tenant_axis is not None else 0
        blocks = []
        for group in self.e_groups():
            fields = []
            for f, role in enumerate(self.roles):
                if role == ROLE_REPLICATED:
                    fields.append(shards[group[0]][f].to(device))
                else:
                    fields.append(torch.cat([shards[i][f].to(device) for i in group], axis))
            blocks.append(fields)
        if self.tenant_axis is None:
            return EstimatorState(*blocks[0])
        return EstimatorState(*(torch.cat([b[f] for b in blocks], 0)
                                for f in range(len(self.roles))))


class ShardedState(NamedTuple):
    """A state laid out over a mesh: ``shards[i]`` on ``mesh.devices[i]``."""

    shards: list
    layout: StateLayout

    def gather(self, device) -> EstimatorState:
        return self.layout.gather(self.shards, device)


def scheme_state_specs(scheme, estimator_axes, *, tenant_axis: Optional[str] = None):
    """Each leaf's layout, from the scheme's axis roles: a tuple per leaf,
    the tenant axis (banked) then ``estimator_axes`` for the estimator axis
    of ``estimator``/``pair`` leaves, or no estimator axes for a
    ``replicated`` leaf (the counterpart of the reference's PartitionSpecs)."""
    scheme = resolve_scheme(scheme)
    e = tuple(estimator_axes) if estimator_axes else None
    prefix = (tenant_axis,) if tenant_axis else ()

    def leaf(role):
        if role == ROLE_REPLICATED:
            return prefix + (None,)
        if role in (ROLE_ESTIMATOR, ROLE_PAIR):
            return prefix + (e,)
        raise ValueError(f"scheme {scheme.name!r} leaf has unknown axis role {role!r}")

    return EstimatorState(*(leaf(role) for role in scheme.axis_roles()))


def scheme_state_sharding(mesh, scheme, estimator_axes, *, tenant_axis: Optional[str] = None,
                          r: int, n_tenants: Optional[int] = None) -> StateLayout:
    """The layout of ``scheme``'s state over ``mesh`` (r estimators; a bank
    of ``n_tenants`` with ``tenant_axis``)."""
    scheme = resolve_scheme(scheme)
    scheme_state_specs(scheme, estimator_axes, tenant_axis=tenant_axis)  # validates the roles
    return StateLayout(mesh, scheme.axis_roles(), tuple(estimator_axes or ()), tenant_axis,
                       int(r), n_tenants)


def split_tenant_axis(mesh, tenant_axis: str = "tenants"):
    """(tenant axis size, estimator axes, estimator axes' size) of ``mesh``;
    raises where the mesh has no such axis."""
    if tenant_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh axes {tuple(mesh.axis_names)} have no {tenant_axis!r} axis; "
            "build one with repro_torch.launch.mesh.make_stream_mesh('tenants=...')")
    e_axes = tuple(a for a in mesh.axis_names if a != tenant_axis)
    t_size = mesh.shape[tenant_axis]
    return t_size, e_axes, mesh.size // t_size


def banked_state_sharding(mesh, tenant_axis: str = "tenants", scheme=GLOBAL, *, r: int,
                          n_tenants: int) -> StateLayout:
    """The layout of a (n_tenants, r, ..) bank: tenants over
    ``tenant_axis``, estimators over the other axes. The engine places fresh
    and restored banks through it, so a snapshot restores onto any mesh."""
    _, e_axes, _ = split_tenant_axis(mesh, tenant_axis)
    return scheme_state_sharding(mesh, scheme, e_axes, tenant_axis=tenant_axis, r=r,
                                 n_tenants=n_tenants)


# ---------------------------------------------------------------------------
# input layouts: host arrays -> per-shard tensors
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShardPut:
    """How an input array reaches the shards (the counterpart of an input
    NamedSharding): each shard takes its tenant block (``t_blocks``, a
    banked input's leading axis) and either every row of the batch axis
    ``row_axis`` or its block of rows over ``row_groups``' axes."""

    mesh: object
    t_blocks: Optional[tuple]  # per shard (lo, hi) over the leading tenant axis
    row_axis: int  # the batch-row axis (s) of the input
    row_axes: tuple  # mesh axes the rows split over; () = every row on every shard

    def slices(self, shape) -> list[tuple]:
        out = []
        n = shape[self.row_axis]
        for i in range(self.mesh.size):
            idx = [slice(None)] * len(shape)
            if self.t_blocks is not None:
                idx[0] = slice(*self.t_blocks[i])
            if self.row_axes:
                lo, hi = _split(n, self.mesh.axis_size(self.row_axes))[
                    self.mesh.axis_index(i, self.row_axes)]
                idx[self.row_axis] = slice(lo, hi)
            out.append(tuple(idx))
        return out

    def put(self, x, upload: Callable) -> list[Tensor]:
        """Per-shard tensors of ``x`` (a host array, or a tensor), each
        distinct (device, block) uploaded once: ``upload(host_block, device)``
        copies a host block, a tensor block is moved with ``.to``."""
        cache, out = {}, []
        for i, idx in enumerate(self.slices(x.shape)):
            dev = self.mesh.devices[i]
            key = (dev, tuple((s.start, s.stop) for s in idx))
            if key not in cache:
                block = x[idx]
                cache[key] = block.to(dev) if isinstance(block, Tensor) else upload(block, dev)
            out.append(cache[key])
        return out


def _t_blocks(mesh, tenant_axis, n_tenants):
    t_size = mesh.shape[tenant_axis]
    blocks = _split(n_tenants, t_size)
    return tuple(blocks[mesh.axis_index(i, (tenant_axis,))] for i in range(mesh.size))


def batch_w_sharding(mesh, w_mode: str = "coordinated_xla") -> ShardPut:
    """An unbanked (s, 2) batch: every row on every shard ("independent"),
    or a block of rows per shard over all the mesh's axes."""
    axes = () if w_mode == "independent" else tuple(mesh.axis_names)
    return ShardPut(mesh, None, 0, axes)


def banked_batch_w_sharding(mesh, w_mode: str = "coordinated_xla",
                            tenant_axis: str = "tenants", *, n_tenants: int) -> ShardPut:
    """A (T, s, 2) batch: each shard its tenant block, and every row or its
    block of rows over the estimator axes."""
    _, e_axes, _ = split_tenant_axis(mesh, tenant_axis)
    return ShardPut(mesh, _t_blocks(mesh, tenant_axis, n_tenants), 1,
                    () if w_mode == "independent" else e_axes)


def banked_chunk_w_sharding(mesh, w_mode: str = "coordinated_xla",
                            tenant_axis: str = "tenants", *, n_tenants: int) -> ShardPut:
    """A staged (T, K, s, 2) superbatch, laid out as ``banked_batch_w_sharding``."""
    _, e_axes, _ = split_tenant_axis(mesh, tenant_axis)
    return ShardPut(mesh, _t_blocks(mesh, tenant_axis, n_tenants), 2,
                    () if w_mode == "independent" else e_axes)


def _shards_of(x, put: ShardPut) -> list:
    """Per-shard inputs: a list as it is, a tensor cut and moved by ``put``."""
    if isinstance(x, (list, tuple)):
        return list(x)
    return put.put(x, lambda block, dev: torch.as_tensor(np.ascontiguousarray(block)).to(dev))


def _per_device(x: Tensor, devices) -> dict:
    return {dev: x.to(dev) for dev in set(devices)}


def _tenant_part(x, t, dev):
    """A per-tenant input (an int shared by every tenant, or a tensor with
    a leading tenant axis) for the tenant block ``t`` on ``dev``."""
    if isinstance(x, Tensor) and x.dim():
        return x[t[0]:t[1]].to(dev)
    return _to(x, dev)


# ---------------------------------------------------------------------------
# pjit plans
# ---------------------------------------------------------------------------
def make_pjit_update(mesh, w_mode: str = "coordinated_xla", scheme=GLOBAL, *, r: int,
                     search: str = "auto"):
    """``f(state, W, n_valid, key) -> state`` over an unbanked ShardedState
    (module docstring). W is (s, 2), a tensor or the per-shard list of
    ``batch_w_sharding(mesh, w_mode)``."""
    scheme = resolve_scheme(scheme)
    axes = tuple(mesh.axis_names)
    layout = scheme_state_sharding(mesh, scheme, axes, r=r)
    put = batch_w_sharding(mesh, w_mode)
    everyone = list(range(mesh.size))

    def update(state: ShardedState, W, n_valid, key) -> ShardedState:
        Ws = _shards_of(W, put)
        if w_mode != "independent":
            Ws = _all_gather(mesh, everyone, Ws)
        keys = _per_device(key, mesh.devices)
        out = []
        for i, (st, dev) in enumerate(zip(state.shards, mesh.devices)):
            out.append(scheme.bulk_update(st, Ws[i], _to(n_valid, dev), keys[dev],
                                          search=search, e0=layout.e_range(i)[0]))
        return ShardedState(out, layout)

    update.layout = layout
    return update


def make_banked_pjit_update(mesh, w_mode: str = "coordinated_xla",
                            tenant_axis: str = "tenants", scheme=GLOBAL, *, r: int,
                            n_tenants: int, search: str = "auto"):
    """Tenant-sharded bank update: ``f(bank, Wb (T, s, 2), n_valid (T,) or
    int, keys (T, 2)) -> bank``. Tenants over ``tenant_axis``, estimators
    over the other axes; "coordinated_xla" gathers W's rows within each
    tenant group before the (replicated) structure build."""
    scheme = resolve_scheme(scheme)
    layout = banked_state_sharding(mesh, tenant_axis, scheme, r=r, n_tenants=n_tenants)
    put = banked_batch_w_sharding(mesh, w_mode, tenant_axis, n_tenants=n_tenants)

    def update(bank: ShardedState, Wb, n_valid, keys) -> ShardedState:
        Ws = _gathered(mesh, layout, _shards_of(Wb, put), w_mode, dim=1)
        out = []
        for i, (st, dev) in enumerate(zip(bank.shards, mesh.devices)):
            t = layout.t_range(i)
            out.append(scheme.bulk_update(st, Ws[i], _tenant_part(n_valid, t, dev),
                                          keys[t[0]:t[1]].to(dev), search=search,
                                          e0=layout.e_range(i)[0]))
        return ShardedState(out, layout)

    update.layout = layout
    return update


def _gathered(mesh, layout: StateLayout, Ws: list, w_mode: str, dim: int) -> list:
    """Each shard's whole batch: as it arrived ("independent"), or its
    tenant group's row blocks all-gathered along ``dim``."""
    if w_mode == "independent":
        return Ws
    out = list(Ws)
    for group in layout.e_groups():
        for i, g in zip(group, _all_gather(mesh, group, [Ws[j] for j in group], dim)):
            out[i] = g
    return out


def make_banked_pjit_chunk_update(mesh, w_mode: str = "coordinated_xla",
                                  tenant_axis: str = "tenants", scheme=GLOBAL, *, r: int,
                                  n_tenants: int, per_tenant_step0: bool = False,
                                  backend: str = "auto", search: str = "auto"):
    """The K-batch form of ``make_banked_pjit_update``: ``f(bank, Wb (T, K,
    s, 2), n_valids (T, K), keys (T, 2), step0) -> bank``, each shard's
    ``scheme.chunk_update`` at its ``e0``. ``per_tenant_step0`` takes step0
    as a (T,) tensor of per-tenant first steps (the elastic tier's
    cursors), else one int for every tenant."""
    scheme = resolve_scheme(scheme)
    layout = banked_state_sharding(mesh, tenant_axis, scheme, r=r, n_tenants=n_tenants)
    put = banked_chunk_w_sharding(mesh, w_mode, tenant_axis, n_tenants=n_tenants)

    def update(bank: ShardedState, Wb, n_valids, keys, step0) -> ShardedState:
        Ws = _gathered(mesh, layout, _shards_of(Wb, put), w_mode, dim=2)
        out = []
        for i, (st, dev) in enumerate(zip(bank.shards, mesh.devices)):
            t = layout.t_range(i)
            s0 = _tenant_part(step0, t, dev) if per_tenant_step0 else int(step0)
            out.append(scheme.chunk_update(st, Ws[i], n_valids[t[0]:t[1]].to(dev),
                                           keys[t[0]:t[1]].to(dev), s0, backend=backend,
                                           search=search, e0=layout.e_range(i)[0]))
        return ShardedState(out, layout)

    update.layout = layout
    return update


# ---------------------------------------------------------------------------
# turnstile deletions
# ---------------------------------------------------------------------------
def make_pjit_delete(mesh, scheme=GLOBAL, *, r: int, search: str = "auto"):
    """``f(state, D (s, 2), n_valid) -> state`` for the unbanked plans
    (``pjit_*`` and ``shardmap``): every shard patches its slice against the
    whole deletion batch (elementwise, no randomness, no collective)."""
    scheme = resolve_scheme(scheme)
    layout = scheme_state_sharding(mesh, scheme, tuple(mesh.axis_names), r=r)
    put = batch_w_sharding(mesh, "independent")

    def delete(state: ShardedState, D, n_valid) -> ShardedState:
        Ds = _shards_of(D, put)
        return ShardedState([scheme.delete_update(st, Ds[i], _to(n_valid, mesh.devices[i]),
                                                  search=search)
                             for i, st in enumerate(state.shards)], layout)

    return delete


def make_banked_delete(mesh, tenant_axis: str = "tenants", scheme=GLOBAL, *, r: int,
                       n_tenants: int, search: str = "auto"):
    """``f(bank, Db (T, s, 2), n_valid (T,) or int) -> bank``: each tenant's
    deletion batch to its tenant group, every row on every member."""
    scheme = resolve_scheme(scheme)
    layout = banked_state_sharding(mesh, tenant_axis, scheme, r=r, n_tenants=n_tenants)
    put = banked_batch_w_sharding(mesh, "independent", tenant_axis, n_tenants=n_tenants)

    def delete(bank: ShardedState, Db, n_valid) -> ShardedState:
        Ds = _shards_of(Db, put)
        out = []
        for i, (st, dev) in enumerate(zip(bank.shards, mesh.devices)):
            out.append(scheme.delete_update(st, Ds[i], _tenant_part(n_valid, layout.t_range(i),
                                                                    dev), search=search))
        return ShardedState(out, layout)

    return delete


# ---------------------------------------------------------------------------
# the device-resident query
# ---------------------------------------------------------------------------
def _shardable(scheme) -> EstimatorScheme:
    scheme = resolve_scheme(scheme)
    if not scheme.shardable_estimate:
        raise ValueError(f"scheme {scheme.name!r} has no shardable estimate stage; "
                         "query via the gather-to-host path instead")
    return scheme


def make_banked_estimate(mesh, r: int, tenant_axis: str = "tenants", scheme=GLOBAL,
                         groups: int = 9, partials_only: bool = False, *,
                         backend: str = "auto"):
    """The query over a tenant-sharded bank without gathering it:
    ``f(bank) -> (n_tenants, ..)`` on the first shard's device. Each shard
    reduces its block with ``scheme.partial_estimate``, each tenant group
    gathers its fixed-shape partials in estimator order and combines them
    (``scheme.combine_estimates``); only the partials move.

    ``partials_only=True`` stops after the per-shard reduction: output
    ``(e_size, n_tenants, *partial)``, no gather and no combine (it times
    the gather's share of a query)."""
    scheme = _shardable(scheme)
    _, e_axes, e_size = split_tenant_axis(mesh, tenant_axis)
    if r % e_size:
        raise ValueError(f"r={r} must divide over the estimator axes (product {e_size})")

    def partials(bank: ShardedState) -> list:
        return [scheme.partial_estimate(st, offset=bank.layout.e_range(i)[0], r=r,
                                        groups=groups, backend=backend)
                for i, st in enumerate(bank.shards)]

    def query(bank: ShardedState) -> Tensor:
        parts = partials(bank)
        dev0 = mesh.devices[0]
        if partials_only:
            rows = [torch.cat([parts[g[e]].to(dev0) for g in bank.layout.e_groups()])
                    for e in range(e_size)]
            return torch.stack(rows)
        out = []
        for group in bank.layout.e_groups():
            stacked = _all_gather(mesh, group, [parts[i] for i in group], stack=True)[0]
            out.append(scheme.combine_estimates(stacked, r=r, groups=groups).to(dev0))
        return torch.cat(out)

    return query


def make_sharded_estimate(mesh, r: int, scheme=GLOBAL, groups: int = 9, *,
                          backend: str = "auto"):
    """The device-resident query of the unbanked plans (``pjit_*``,
    ``shardmap``): ``f(state) -> estimate`` on the first shard's device."""
    scheme = _shardable(scheme)
    p = mesh.size
    if r % p:
        raise ValueError(f"r={r} must divide the mesh size {p}")
    everyone = list(range(p))

    def query(state: ShardedState) -> Tensor:
        parts = [scheme.partial_estimate(st, offset=state.layout.e_range(i)[0], r=r,
                                         groups=groups, backend=backend)
                 for i, st in enumerate(state.shards)]
        stacked = _all_gather(mesh, everyone, parts, stack=True)[0]
        return scheme.combine_estimates(stacked, r=r, groups=groups)

    return query


# ---------------------------------------------------------------------------
# the explicit coordinated plan (shardmap)
# ---------------------------------------------------------------------------
def _sort_by_key(keys: Tensor, values: Tensor, kernels: bool) -> tuple[Tensor, Tensor]:
    """A stable sort of int64 keys carrying int32 values: the tile-sort
    kernel over one tile padded to a power of two with INT64 max (stable, so
    the padding sorts after any real INT64 max key), or ``torch.sort``."""
    n = keys.shape[0]
    if not kernels or n == 0:
        sk, perm = torch.sort(keys, stable=True)
        return sk, values[perm]
    from repro_torch.kernels.bitonic import bitonic_sort_tiles

    tile = _next_pow2(n)
    kp = torch.full((tile,), INF64, dtype=torch.int64, device=keys.device)
    kp[:n] = keys
    vp = torch.zeros((tile,), dtype=torch.int32, device=keys.device)
    vp[:n] = values
    sk, sv = bitonic_sort_tiles(kp, vp, tile)
    return sk[:n], sv[:n]


def _segmented_iota(starts: Tensor, kernels: bool) -> Tensor:
    """Offset of each element in its run (``primitives.segscan``), by the
    ``segscan`` kernel over ones where ``kernels``."""
    if kernels and starts.numel():
        from repro_torch.kernels.segscan import segscan

        ones = torch.ones(starts.shape, dtype=torch.int32, device=starts.device)
        return segscan(ones, starts) - 1
    from repro_torch.primitives.segscan import segmented_iota

    return segmented_iota(starts)


class _Route(NamedTuple):
    """One shard's side of a capacity-padded exchange."""

    order: Tensor  # (q,) int64: rows sorted by (dest, index)
    send_idx: Tensor  # (q,) int64: each sorted row's slot in the send buffer
    ok: Tensor  # (q,) bool: sorted row is valid and within its bucket's capacity
    overflow: Tensor  # () int64: valid rows past capacity


def _plan_route(row_valid: Tensor, dest: Tensor, p: int, cap: int, kernels: bool) -> _Route:
    """Slot every row in its destination's bucket, in row order; every row
    (valid or not) takes a slot, and valid rows past ``cap`` overflow."""
    q = dest.shape[0]
    dev = dest.device
    slot_key = dest.to(torch.int64) * (q + 1) + torch.arange(q, device=dev)
    _, order = _sort_by_key(slot_key, torch.arange(q, dtype=torch.int32, device=dev), kernels)
    order = order.to(torch.int64)
    d_sorted = dest[order].to(torch.int64)
    slot = _segmented_iota(segment_starts(d_sorted), kernels).to(torch.int64)
    send_idx = d_sorted * cap + slot
    v = row_valid[order]
    ok = (slot < cap) & v
    overflow = torch.sum((slot >= cap) & v)
    return _Route(order, send_idx, ok, overflow)


def _scatter_rows(rows: Tensor, rt: _Route, n: int) -> Tensor:
    """An (n, k) buffer of zeros with the ok rows at their slots (the
    others are written to a spare row, then cut)."""
    buf = torch.zeros((n + 1,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    buf[torch.where(rt.ok, rt.send_idx, torch.full_like(rt.send_idx, n))] = rows[rt.order]
    return buf[:n]


def _route_one_way(mesh, payloads, row_valids, dests, p: int, cap: int, kernels: bool):
    """Send (q, k) int32 rows to their ``dest`` shards, where they stay:
    per shard the received (p * cap, k + 1) rows, the last column the valid
    flag, and the overflow."""
    recv_in, overflow = [], []
    for payload, valid, dest in zip(payloads, row_valids, dests):
        rt = _plan_route(valid, dest, p, cap, kernels)
        rows = torch.cat([payload, torch.ones_like(payload[:, :1])], dim=1)
        recv_in.append(_scatter_rows(rows, rt, p * cap))
        overflow.append(rt.overflow)
    return _all_to_all(mesh, list(range(p)), recv_in), overflow


def _route_round_trip(mesh, payloads, row_valids, dests, p: int, cap: int, answer,
                      n_ans: int, kernels: bool):
    """Send (q, k) int32 rows to their ``dest`` shards, answer them there
    (``answer(shard, recv (p * cap, k), recv_valid)`` -> (p * cap, n_ans)
    int32) and send the answers back: per shard (q, n_ans) answers (0 for
    overflowed rows) and the overflow."""
    routes, bufs, valids = [], [], []
    for payload, valid, dest in zip(payloads, row_valids, dests):
        rt = _plan_route(valid, dest, p, cap, kernels)
        routes.append(rt)
        bufs.append(_scatter_rows(payload, rt, p * cap))
        valids.append(_scatter_rows(torch.ones_like(valid, dtype=torch.int32), rt, p * cap))
    everyone = list(range(p))
    recv = _all_to_all(mesh, everyone, bufs)
    recv_valid = _all_to_all(mesh, everyone, valids)
    ans = [answer(i, recv[i], recv_valid[i].to(torch.bool)) for i in everyone]
    back = _all_to_all(mesh, everyone, ans)
    out = []
    for rt, b, payload in zip(routes, back, payloads):
        got = b[torch.where(rt.ok, rt.send_idx, torch.zeros_like(rt.send_idx))]
        got = torch.where(rt.ok[:, None], got, torch.zeros_like(got))
        res = torch.zeros((payload.shape[0], n_ans), dtype=torch.int32, device=payload.device)
        res[rt.order] = got
        out.append(res)
    return out, [rt.overflow for rt in routes]


class _LocalStruct(NamedTuple):
    """One shard's part of the shared structure (arcs of the vertices it
    owns, and the closing-edge index of the edges whose min endpoint it
    owns)."""

    key_desc: Tensor  # (n,) int64 pack2(src, S-1-pos)
    key_rank: Tensor  # (n,) int64 pack2(src, rank)
    src: Tensor
    dst: Tensor
    pos: Tensor
    rank: Tensor
    ekey: Tensor  # (ne,) int64 pack2(min, max)
    epos: Tensor


def _build_structures(mesh, Ws, pos_gs, valid_es, p: int, S: int, cap_a: int, cap_e: int,
                      kernels: bool):
    """all_to_all the arcs and edges to their owner shards, then sort and
    rank there: per shard a ``_LocalStruct``, and the overflows."""
    arcs, valid_as, dest_a, edges, dest_e = [], [], [], [], []
    for W, pos_g, valid_e in zip(Ws, pos_gs, valid_es):
        src = torch.cat([W[:, 0], W[:, 1]])
        dst = torch.cat([W[:, 1], W[:, 0]])
        arcs.append(torch.stack([src, dst, torch.cat([pos_g, pos_g])], dim=1))
        valid_as.append(torch.cat([valid_e, valid_e]))
        dest_a.append(vertex_pool(src, p))
        emin = torch.minimum(W[:, 0], W[:, 1])
        emax = torch.maximum(W[:, 0], W[:, 1])
        edges.append(torch.stack([emin, emax, pos_g], dim=1))
        dest_e.append(vertex_pool(emin, p))
    recv_a, ovf_a = _route_one_way(mesh, arcs, valid_as, dest_a, p, cap_a, kernels)
    recv_e, ovf_e = _route_one_way(mesh, edges, valid_es, dest_e, p, cap_e, kernels)
    out = []
    for ra, re in zip(recv_a, recv_e):
        a_valid = ra[:, 3].to(torch.bool)
        kd = torch.where(a_valid, pack2(ra[:, 0], (S - 1) - ra[:, 2]),
                         torch.full_like(ra[:, 0], INF64, dtype=torch.int64))
        # src and pos come back out of the packed key, so the sort carries dst
        kd_s, dst_s = _sort_by_key(kd, ra[:, 1], kernels)
        src_s = (kd_s >> 32).to(torch.int32)
        pos_s = (S - 1) - (kd_s & 0xFFFFFFFF).to(torch.int32)
        n_val = torch.sum(a_valid)
        rank_s = _segmented_iota(segment_starts(src_s.to(torch.int64)), kernels)
        kr = torch.where(torch.arange(kd_s.shape[0], device=kd_s.device) < n_val,
                         pack2(src_s, rank_s), torch.full_like(kd_s, INF64))
        e_valid = re[:, 3].to(torch.bool)
        ek = torch.where(e_valid, pack2(re[:, 0], re[:, 1]),
                         torch.full_like(re[:, 0], INF64, dtype=torch.int64))
        ek_s, epos_s = _sort_by_key(ek, re[:, 2], kernels)
        out.append(_LocalStruct(kd_s, kr, src_s, dst_s, pos_s, rank_s, ek_s, epos_s))
    return out, [a + e for a, e in zip(ovf_a, ovf_e)]


def make_coordinated_update(mesh, r: int, s: int, capacity_factor: float = 2.0,
                            scheme=GLOBAL, *, search: str = "auto"):
    """The explicit coordinated update over ``mesh`` (all axes flattened):
    ``f(state, W, n_valid, key) -> (state, overflow)``, W (s, 2) as a tensor
    or the per-shard row blocks of ``batch_w_sharding(mesh)``, the overflow
    a 0-d int64 on the first shard's device (module docstring). r and s
    must divide by the mesh size; only ``update_kind == "nbsi"`` schemes
    run it."""
    scheme = resolve_scheme(scheme)
    if scheme.update_kind != "nbsi":
        raise ValueError(
            f"scheme {scheme.name!r} (update_kind={scheme.update_kind!r}) has "
            "no coordinated shard_map kernel; use a pjit or single plan")
    axes = tuple(mesh.axis_names)
    p = mesh.size
    if r % p or s % p:
        raise ValueError(f"make_coordinated_update needs r ({r}) and s ({s}) divisible by "
                         f"the mesh size {p}")
    s_local, r_local = s // p, r // p
    cap_a = max(int(2 * s_local * capacity_factor / p), 8)
    cap_e = max(int(s_local * capacity_factor / p), 8)
    cap_q = max(int(2 * r_local * capacity_factor / p), 8)
    layout = scheme_state_sharding(mesh, scheme, axes, r=r)
    put = batch_w_sharding(mesh)
    kernels = resolve_multisearch_backend(search, mesh.devices[0]) == "kernel"
    everyone = list(range(p))

    def route(payloads, valids, dests, answer, n_ans):
        return _route_round_trip(mesh, payloads, valids, dests, p, cap_q, answer, n_ans,
                                 kernels)

    def update(state: ShardedState, W, n_valid, key):
        n_valid = int(n_valid)
        Ws = _shards_of(W, put)
        sts = state.shards
        devs = mesh.devices
        keys = _per_device(key, devs)
        pos_g, valid_e, k1, k2, k3 = [], [], [], [], []
        for me, dev in enumerate(devs):
            pg = me * s_local + torch.arange(s_local, dtype=torch.int32, device=dev)
            pos_g.append(pg)
            valid_e.append(pg < n_valid)
            ks = rng.split(rng.fold_in(keys[dev], me), 3)
            k1.append(ks[0])
            k2.append(ks[1])
            k3.append(ks[2])
        structs, ovf_build = _build_structures(mesh, Ws, pos_g, valid_e, p, s, cap_a, cap_e,
                                               kernels)

        # ---- step 1: the level-1 reservoir; W[idx] fetched from its owner ----
        replace, idx = [], []
        for me in everyone:
            m = sts[me].m_seen
            total = m + n_valid
            t = rng.randint64(k1[me], torch.clamp(total, min=1), (r_local,))
            replace.append((t >= m) & (total > 0))
            idx.append(torch.clamp(t - m, min=0, max=max(n_valid - 1, 0)).to(torch.int32))

        def fetch_edge(me, recv, recv_valid):
            local = torch.clamp(recv[:, 0] - me * s_local, 0, s_local - 1).to(torch.int64)
            return Ws[me][local]

        edge_ans, ovf1 = route([i[:, None] for i in idx], replace,
                               [i // s_local for i in idx], fetch_edge, 2)
        f1, chi_minus, f2, has_f3, f1_bpos = [], [], [], [], []
        for me in everyone:
            st, rep = sts[me], replace[me]
            f1.append(torch.where(rep[:, None], edge_ans[me], st.f1))
            chi_minus.append(torch.where(rep, torch.zeros_like(st.chi), st.chi))
            f2.append(torch.where(rep[:, None], torch.full_like(st.f2, -1), st.f2))
            has_f3.append(st.has_f3 & ~rep)
            f1_bpos.append(torch.where(rep, idx[me], torch.full_like(idx[me], -1)))

        # ---- step 2: rank queries, u and v stacked into one routed batch ----
        def rank_answer(me, recv, recv_valid):
            R = structs[me]
            endp, bpos = recv[:, 0], recv[:, 1]
            q_exact = pack2(endp, (s - 1) - bpos)
            n = endp.shape[0]
            # one search for the exact arc and both ends of the endpoint's run
            lt = multisearch_lt(R.key_desc, torch.cat([
                q_exact, pack2(endp, torch.zeros_like(bpos)),
                pack2(endp, torch.full_like(bpos, s))]), search)
            j, found = exact_from_lt(R.key_desc, q_exact, lt[:n])
            r_fresh = torch.where(found, R.rank[torch.clamp(j, min=0)], torch.zeros_like(bpos))
            deg = (lt[2 * n:] - lt[n:2 * n]).to(torch.int32)
            return torch.where(bpos >= 0, r_fresh, deg)[:, None]

        us = [f[:, 0] for f in f1]
        vs = [f[:, 1] for f in f1]
        eps = [torch.cat([u, v]) for u, v in zip(us, vs)]
        rk, ovf2 = route([torch.stack([ep, torch.cat([b, b])], dim=1) for ep, b in zip(eps, f1_bpos)],
                         [torch.cat([u >= 0, u >= 0]) for u in us], [vertex_pool(ep, p) for ep in eps],
                         rank_answer, 1)
        chi, take_new, t_src, t_rank = [], [], [], []
        for me in everyone:
            lme, rme = rk[me][:r_local, 0], rk[me][r_local:, 0]
            chi_plus = lme + rme
            c = chi_minus[me] + chi_plus
            coin = rng.uniform(k2[me], (r_local,))
            p_new = chi_plus.to(torch.float32) / torch.clamp(c.to(torch.float32), min=1.0)
            take_new.append((us[me] >= 0) & (chi_plus > 0) & (coin < p_new))
            phi = rng.randint32(k3[me], torch.clamp(chi_plus, min=1), (r_local,))
            t_src.append(torch.where(phi < lme, us[me], vs[me]))
            t_rank.append(torch.where(phi < lme, phi, phi - lme))
            chi.append(c)

        def decode_answer(me, recv, recv_valid):
            R = structs[me]
            q = pack2(recv[:, 0], recv[:, 1])
            j, found = exact_multisearch(R.key_rank, q, backend=search)
            j = torch.clamp(j, min=0)
            a, b = R.src[j], R.dst[j]
            neg = torch.full_like(a, -1)
            return torch.stack([torch.where(found, torch.minimum(a, b), neg),
                                torch.where(found, torch.maximum(a, b), neg),
                                torch.where(found, R.pos[j], neg)], dim=1)

        dec, ovf3 = route([torch.stack([a, b], dim=1) for a, b in zip(t_src, t_rank)], take_new,
                          [vertex_pool(t, p) for t in t_src], decode_answer, 3)
        f2_bpos = []
        for me in everyone:
            tk = take_new[me] & (dec[me][:, 0] >= 0)
            f2[me] = torch.where(tk[:, None], dec[me][:, :2], f2[me])
            f2_bpos.append(torch.where(tk, dec[me][:, 2], torch.full_like(dec[me][:, 2], -1)))
            has_f3[me] = has_f3[me] & ~tk

        # ---- step 3: closing-edge lookups ----
        have_wedge, cmin, cmax = [], [], []
        for me in everyone:
            u, v = us[me], vs[me]
            a, b = f2[me][:, 0], f2[me][:, 1]
            have_wedge.append((u >= 0) & (a >= 0))
            o1 = torch.where((u == a) | (u == b), v, u)
            o2 = torch.where((a == u) | (a == v), b, a)
            cmin.append(torch.minimum(o1, o2))
            cmax.append(torch.maximum(o1, o2))

        def close_answer(me, recv, recv_valid):
            R = structs[me]
            q = pack2(recv[:, 0], recv[:, 1])
            j, found = exact_multisearch(R.ekey, q, backend=search)
            return torch.where(found, R.epos[torch.clamp(j, min=0)],
                               torch.full_like(recv[:, 0], -1))[:, None]

        cls, ovf4 = route([torch.stack([a, b], dim=1) for a, b in zip(cmin, cmax)], have_wedge,
                          [vertex_pool(c, p) for c in cmin], close_answer, 1)
        out, overflow = [], []
        for me in everyone:
            p3 = cls[me][:, 0]
            closed = have_wedge[me] & (p3 >= 0) & (p3 > f2_bpos[me])
            out.append(EstimatorState(f1[me], chi[me], f2[me], has_f3[me] | closed,
                                      sts[me].m_seen + n_valid))
            overflow.append(ovf_build[me] + ovf1[me] + ovf2[me] + ovf3[me] + ovf4[me])
        return ShardedState(out, layout), _psum(mesh, everyone, overflow)

    update.layout = layout
    return update
