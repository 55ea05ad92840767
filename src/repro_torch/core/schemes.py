"""Estimator schemes: one streaming engine, several triangle queries
(``repro.core.schemes``).

``EstimatorScheme`` bundles ``init_state`` / ``bulk_update`` /
``chunk_update`` / ``estimate`` / ``validate``; the engine dispatches through
it, so a scheme is a one-file addition. Registered schemes:

  * ``global``  the paper's query, one median-of-means triangle count
    (``core/bulk.py`` + ``core/estimate.py``); its chunked ingest is
    ``bulk_update_chunk``, the kernel route of the ingest path.
  * ``naive``   Section 1's strawman: the same global query over the
    edge-at-a-time update, O(r * s) sequential work per batch. It has no
    kernel, in the reference or here, and runs at small sizes only.
  * ``local``   per-vertex triangle counts via vertex-partitioned estimator
    pools (REPT, arXiv:1811.09136; CoCoS, arXiv:1802.04249). State and
    update are the global scheme's; pool p attributes each closed sampled
    triangle to the vertices it owns at estimate time, a scatter that runs in
    the ``segment_sum`` kernel on the kernel backend. Its chunked ingest is
    the base ``chunk_update``, the per-batch scan of ``bulk_update_all``, as
    in the reference.

Unbiasedness of the local estimate (the reference's argument): each triangle
T contributes exactly 1 to E[X] per estimator through its unique sampling
path, so for every vertex v, E[X * 1{v in sampled triangle}] = L_v, and pool
p's per-vertex mean over its r / n_pools estimators is unbiased for each
vertex it owns. ``sum_v L_v = 3 * tau`` is the cross-check the CLI prints.

The port's methods take the engine's backends as keywords: ``search`` (the
multisearch backend of the per-batch update), ``backend`` (the ingest
backend of the chunked update) and, for ``estimate``, ``backend`` decides
whether the local scatter runs in the kernel ("kernel") or plainly.

The sharded plans (``repro_torch.core.distributed``) read three things off a
scheme: ``axis_roles()``, how each state leaf relates to the estimator axis
(``estimator`` and ``pair`` leaves split their leading axis over the
shards, ``replicated`` ones, ``m_seen``, are copied); ``update_kind``, which
must be ``"nbsi"`` (the paper's bulkUpdateAll) for the ``shardmap`` plan,
whose routed multisearch writes that update out; and, where
``shardable_estimate`` is set, the pair ``partial_estimate`` /
``combine_estimates``: each shard reduces its contiguous estimator slice to
a fixed-shape partial (group sums for ``global``/``naive``, pool-local
attribution sums for ``local``) and the partials, added in shard order,
give ``estimate`` bit for bit (the integer-valued float64 argument of
``core/estimate.py``). The updates take ``e0``, the global index of the
state's first estimator, so a shard draws its slice of the full-r draws.

Deletions and window expiry (the reference's fully-dynamic extension,
CoCoS, arXiv:1802.04249) are one state transition for every scheme:
``delete_update`` patches the sample so that no dead edge can contribute,
drawing no randomness and leaving ``m_seen`` the insertion count, and
``expire`` aliases it (an expired edge is a deletion authored by the window
clock). ``local`` inherits both: its attribution happens at estimate time
from the patched sample.

Banks: every stage takes a bank of tenants (a leading tenant axis on the
state, the batches and the key; ``core.bulk``), and ``estimate`` then
answers per tenant, (T,) or (T, n_vertices), the reference's
``vmap(scheme.estimate)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from repro_torch import rng
from repro_torch.core.bulk import (
    batch_keys,
    bulk_delete_chunk,
    bulk_delete_update,
    bulk_update_all,
    bulk_update_chunk,
)
from repro_torch.core.estimate import (
    coarse_estimates,
    combine_group_sums,
    estimate,
    partial_group_sums,
)
from repro_torch.core.state import EstimatorState, init_state
from repro_torch.primitives.ingest import resolve_ingest_backend

Tensor = torch.Tensor
_HASH_MULT = 2654435761
_M32 = 0xFFFFFFFF

# axis roles: how a state leaf relates to the estimator axis
ROLE_ESTIMATOR = "estimator"
ROLE_PAIR = "pair"
ROLE_REPLICATED = "replicated"
ROLES = (ROLE_ESTIMATOR, ROLE_PAIR, ROLE_REPLICATED)
# the NBSI tuple's roles, shared by every scheme whose state is EstimatorState
NBSI_STATE_ROLES = EstimatorState(
    f1=ROLE_PAIR, chi=ROLE_ESTIMATOR, f2=ROLE_PAIR, has_f3=ROLE_ESTIMATOR,
    m_seen=ROLE_REPLICATED)


def vertex_pool(v: Tensor, n_pools: int) -> Tensor:
    """Owning pool of vertex ``v`` in [0, n_pools): the uint32 multiplicative
    hash ``(v * 2654435761) mod 2**32 mod n_pools``, with v cast to uint32
    first (so -1 is 2**32 - 1). Computed in int64 masked to 32 bits, the
    multiplier split in 16-bit halves so no product leaves int64."""
    a = v.to(torch.int64) & _M32
    lo = a * (_HASH_MULT & 0xFFFF)
    hi = ((a * (_HASH_MULT >> 16)) & 0xFFFF) << 16
    return (((lo + hi) & _M32) % n_pools).to(torch.int32)


class EstimatorScheme:
    """Base scheme: the paper's NBSI state and bulk update, query
    unspecified. Subclasses override ``estimate`` (and, for other updates,
    ``bulk_update`` and ``update_kind``)."""

    name: str = "?"
    update_kind: str = "nbsi"  # the paper's bulkUpdateAll; the shardmap plan needs it
    shardable_estimate: bool = False

    def init_state(self, r: int, device="cpu", n_tenants=None) -> EstimatorState:
        return init_state(r, device, n_tenants)

    def bulk_update(self, state, W, n_valid, key, *, search: str = "auto", e0: int = 0):
        return bulk_update_all(state, W, n_valid, key, search, e0)

    def chunk_update(self, state, Ws, n_valids, key, step0=0, *,
                     backend: str = "auto", search: str = "auto", e0: int = 0):
        """K stacked batches: batch i draws from ``fold_in(key, step0 + i)``,
        so this equals K sequential ``bulk_update`` calls (the reference's
        ``lax.scan``). ``backend`` is unused here."""
        keys = batch_keys(key, step0, Ws.shape[-3])
        for i in range(Ws.shape[-3]):
            state = self.bulk_update(state, Ws[..., i, :, :], n_valids[..., i], keys[..., i, :],
                                     search=search, e0=e0)
        return state

    # -- turnstile deletions / window expiry --------------------------------
    def delete_update(self, state, D, n_valid, *, search: str = "auto"):
        """Fold one batch of edge deletions into the state (no randomness;
        ``repro_torch.core.bulk.bulk_delete_update``)."""
        return bulk_delete_update(state, D, n_valid, search)

    def delete_chunk_update(self, state, Ds, n_valids, *, backend: str = "auto",
                            search: str = "auto"):
        """K stacked deletion batches; bit-equal to K ``delete_update``
        calls."""
        return bulk_delete_chunk(state, Ds, n_valids, backend=backend, search=search)

    def expire(self, state, D, n_valid, *, search: str = "auto"):
        """Window/decay expiry: the transition of ``delete_update``."""
        return self.delete_update(state, D, n_valid, search=search)

    def estimate(self, state, groups: int = 9, *, backend: str = "auto") -> Tensor:
        raise NotImplementedError

    def validate(self, r: int) -> None:
        """Raise ValueError if this scheme cannot run with ``r`` estimators."""
        if r < 1:
            raise ValueError(f"scheme {self.name!r} needs r >= 1, got {r}")

    def axis_roles(self) -> EstimatorState:
        """The state's structure with a role string for each leaf."""
        return NBSI_STATE_ROLES

    # -- the shardable query (module docstring) -----------------------------
    def partial_estimate(self, state, *, offset: int, r: int, groups: int = 9,
                         backend: str = "auto"):
        """The partial reduction of the contiguous estimator slice
        ``[offset, offset + r_local)`` of an r-estimator state, of a fixed
        shape whatever the slice."""
        raise NotImplementedError(f"scheme {self.name!r} has no shardable estimate stage")

    def combine_estimates(self, partials, *, r: int, groups: int = 9):
        """The estimate from ``(n_shards, ..)`` stacked partials, reduced in
        shard order."""
        raise NotImplementedError(f"scheme {self.name!r} has no shardable estimate stage")


class GlobalScheme(EstimatorScheme):
    """The paper's query: one global triangle count (Thm 3.4)."""

    name = "global"
    shardable_estimate = True  # group sums factor over contiguous shards

    def chunk_update(self, state, Ws, n_valids, key, step0=0, *,
                     backend: str = "auto", search: str = "auto", e0: int = 0):
        return bulk_update_chunk(state, Ws, n_valids, key, step0,
                                 backend=backend, search=search, e0=e0)

    def estimate(self, state, groups: int = 9, *, backend: str = "auto") -> Tensor:
        return estimate(state, groups)

    def partial_estimate(self, state, *, offset: int, r: int, groups: int = 9,
                         backend: str = "auto"):
        return partial_group_sums(coarse_estimates(state), offset, r, groups)

    def combine_estimates(self, partials, *, r: int, groups: int = 9):
        return combine_group_sums(partials, r, groups)


class NaiveScheme(GlobalScheme):
    """Section 1's strawman: the global query over the edge-at-a-time
    update (O(r * s) work per batch)."""

    name = "naive"
    update_kind = "naive"

    def bulk_update(self, state, W, n_valid, key, *, search: str = "auto", e0: int = 0):
        return naive_parallel_update(state, W, n_valid, key, e0)

    def chunk_update(self, state, Ws, n_valids, key, step0=0, *,
                     backend: str = "auto", search: str = "auto", e0: int = 0):
        return EstimatorScheme.chunk_update(self, state, Ws, n_valids, key, step0,
                                            backend=backend, search=search, e0=e0)


@dataclass(frozen=True)
class LocalScheme(EstimatorScheme):
    """Per-vertex triangle counts via vertex-partitioned estimator pools.

    ``estimate`` returns ``(n_vertices,)`` float64: vertex v's estimated
    incident-triangle count L_v. The r estimators form ``n_pools``
    contiguous pools; vertex v is owned by pool ``vertex_pool(v, n_pools)``
    and only that pool's estimators attribute to it. Within a pool the
    aggregate is the plain mean; ``groups`` is accepted and unused, because a
    per-vertex median of means biases sparse counts to zero."""

    n_vertices: int
    n_pools: int = 1
    name = "local"
    shardable_estimate = True  # the attribution scatter is shard-local

    def validate(self, r: int) -> None:
        super().validate(r)
        if self.n_vertices < 1:
            raise ValueError(
                f"local scheme needs n_vertices >= 1, got {self.n_vertices}")
        if self.n_pools < 1 or r % self.n_pools:
            raise ValueError(
                f"local scheme needs n_pools >= 1 dividing r={r}, got "
                f"n_pools={self.n_pools}")

    def attribution_inputs(self, state, offset: int, r: int) -> tuple[Tensor, Tensor]:
        """The scatter's operands over the contiguous estimator slice held in
        ``state`` (global indices ``offset + i``; pool membership is a
        function of the global index): values (3 r_local, 1) float64, each
        closed sampled triangle's coarse estimate once per vertex its pool
        owns, else 0; ids (3 r_local,) int32, that vertex, else
        ``n_vertices`` (out of range: dropped). A bank's are (T, 3 r_local,
        1) and (T, 3 r_local)."""
        r_pool = r // self.n_pools
        x = coarse_estimates(state)
        u, v = state.f1[..., 0], state.f1[..., 1]
        a, b = state.f2[..., 0], state.f2[..., 1]
        # the sampled triangle's third vertex: f2's endpoint not shared with f1
        o2 = torch.where((a == u) | (a == v), b, a)
        tri = torch.stack([u, v, o2], dim=-2)  # (.., 3, r_local)
        r_local = state.chi.shape[-1]
        pool = ((offset + torch.arange(r_local, dtype=torch.int32, device=x.device))
                // r_pool).to(torch.int32)
        closed = state.has_f3 & (u >= 0) & (a >= 0)
        take = (closed[..., None, :] & (tri >= 0) & (tri < self.n_vertices)
                & (vertex_pool(tri, self.n_pools) == pool))
        vert = torch.where(take, tri, torch.full_like(tri, self.n_vertices))
        vals = torch.where(take, x[..., None, :], torch.zeros_like(x)[..., None, :])
        lead = tuple(x.shape[:-1])
        return vals.reshape(*lead, -1, 1), vert.reshape(*lead, -1).to(torch.int32)

    def _attribution_sums(self, state, offset: int, r: int, *,
                          backend: str = "auto") -> Tensor:
        """(n_vertices,) float64 pool-local attribution sums ((T,
        n_vertices) for a bank, one scatter for all its tenants). ``backend``
        resolving to "kernel" runs the scatter in the ``segment_sum`` kernel;
        otherwise it is a plain ``index_add_``. Both are exact: the values
        are integer-valued float64 below 2**53."""
        from repro_torch.kernels.segment_sum import segment_sum, segment_sum_plain

        vals, ids = self.attribution_inputs(state, offset, r)
        scatter = (segment_sum if resolve_ingest_backend(backend, vals.device) == "kernel"
                   else segment_sum_plain)
        return scatter(vals, ids, self.n_vertices)[..., 0]

    def estimate(self, state, groups: int = 9, *, backend: str = "auto") -> Tensor:
        r = state.chi.shape[-1]
        self.validate(r)
        # vertex v's pool holds exactly r / n_pools estimators
        return self._attribution_sums(state, 0, r, backend=backend) / (r // self.n_pools)

    def partial_estimate(self, state, *, offset: int, r: int, groups: int = 9,
                         backend: str = "auto"):
        return self._attribution_sums(state, offset, r, backend=backend)

    def combine_estimates(self, partials, *, r: int, groups: int = 9):
        return torch.sum(partials, dim=0) / (r // self.n_pools)


SCHEMES: Dict[str, Callable[..., EstimatorScheme]] = {}


def register_scheme(name: str, factory: Callable[..., EstimatorScheme]) -> None:
    """Add a scheme factory (``factory(**params) -> EstimatorScheme``)."""
    SCHEMES[name] = factory


register_scheme("global", GlobalScheme)
register_scheme("naive", NaiveScheme)
register_scheme("local", LocalScheme)

GLOBAL = GlobalScheme()  # the default instance most call sites share


def resolve_scheme(name, params: Optional[dict | tuple] = None) -> EstimatorScheme:
    """Scheme instance from a registry name and params (or pass one through)."""
    if isinstance(name, EstimatorScheme):
        return name
    if name not in SCHEMES:
        raise ValueError(f"unknown scheme {name!r}; registered: {sorted(SCHEMES)}")
    try:
        return SCHEMES[name](**dict(params or {}))
    except TypeError as e:
        raise ValueError(
            f"bad params for scheme {name!r}: {e} "
            "(e.g. the local scheme needs n_vertices)"
        ) from e


# ---------------------------------------------------------------------------
# the Section 1 naive-parallel update
# ---------------------------------------------------------------------------
def _edge_update(state: EstimatorState, edge: Tensor, u1: Tensor, u2: Tensor) -> EstimatorState:
    """One stream arrival against all estimators; ``u1``/``u2`` are the
    arrival's two (r,) float64 uniform draws, compared with float32
    thresholds as in the reference (x64 makes its draws float64). A bank
    takes (T, 2) edges, (T, r) draws."""
    u, v = edge[..., 0:1], edge[..., 1:2]  # columns against the (.., r) lanes
    m_new = state.m_seen + 1

    take1 = u1 < 1.0 / m_new.to(torch.float32)[..., None]
    f1 = torch.where(take1[..., None], edge[..., None, :], state.f1)
    chi = torch.where(take1, torch.zeros_like(state.chi), state.chi)
    f2 = torch.where(take1[..., None], torch.full_like(state.f2, -1), state.f2)
    has_f3 = state.has_f3 & ~take1

    live = ~take1 & (f1[..., 0] >= 0)
    adj = live & ((f1[..., 0] == u) | (f1[..., 0] == v) | (f1[..., 1] == u) | (f1[..., 1] == v))
    chi = chi + adj.to(torch.int32)
    take2 = adj & (u2 < 1.0 / torch.clamp(chi, min=1).to(torch.float32))
    ce = torch.stack([torch.minimum(u, v), torch.maximum(u, v)], dim=-1)  # (.., 1, 2)
    f2 = torch.where(take2[..., None], ce, f2)
    has_f3 = has_f3 & ~take2

    chk = adj & ~take2 & (f2[..., 0] >= 0)
    a, b = f2[..., 0], f2[..., 1]
    o1 = torch.where((f1[..., 0] == a) | (f1[..., 0] == b), f1[..., 1], f1[..., 0])
    o2 = torch.where((a == f1[..., 0]) | (a == f1[..., 1]), b, a)
    closes = (torch.minimum(o1, o2) == ce[..., 0]) & (torch.maximum(o1, o2) == ce[..., 1])
    has_f3 = has_f3 | (chk & closes)
    return EstimatorState(f1, chi, f2, has_f3, m_new)


def _keep_where(skip: Tensor, old: EstimatorState, new: EstimatorState) -> EstimatorState:
    """Per tenant, the old state where ``skip`` (T,) is set, else the new."""
    return EstimatorState(*(torch.where(skip.view(-1, *([1] * (o.dim() - 1))), o, n)
                            for o, n in zip(old, new)))


def naive_parallel_update(state: EstimatorState, W: Tensor, n_valid, key: Tensor,
                          e0: int = 0) -> EstimatorState:
    """Process a batch edge at a time across all estimators (O(r * s) work).
    Edge i draws from ``split(split(key, s)[i])``, two float64
    ``uniform(., (r,))``;
    rows at or past ``n_valid`` leave the state as it is, so the loop stops
    there (a bank's loop stops at its largest count, and each tenant keeps
    its state at rows past its own). All s arrivals' draws are made up front
    in one batched call. Lane i draws element ``e0 + i`` (a shard's slice,
    ``core.bulk``'s module docstring)."""
    r, s = state.r, W.shape[-2]
    k = rng.split(rng.split(key, s))  # (.., s, 2, 2): each edge's (k1, k2)
    u1 = rng.uniform64(k[..., 0, :], (r,), e0)  # (.., s, r)
    u2 = rng.uniform64(k[..., 1, :], (r,), e0)
    per_tenant = isinstance(n_valid, torch.Tensor) and n_valid.dim() > 0
    n = int(n_valid.max()) if per_tenant else int(n_valid)
    for i in range(min(n, s)):
        new = _edge_update(state, W[..., i, :], u1[..., i, :], u2[..., i, :])
        state = _keep_where(i >= n_valid, state, new) if per_tenant else new
    return state
