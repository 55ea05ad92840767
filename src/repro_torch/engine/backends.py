"""Execution plans of TriangleCountEngine (``repro.engine.backends``).

One engine API, six plans over the same ``bulk_update_all`` semantics:

  single                   the bank on one device, every tenant in one
                           sequence of device operations (no mesh needed).
  pjit_independent         every shard updates its estimator slice with the
                           whole batch (W on every shard). Single-tenant.
  pjit_coordinated         W's rows arrive a block per shard and are
                           all-gathered before the structure build.
                           Single-tenant.
  shardmap                 the explicit coordinated plan: hash-partitioned
                           arcs and routed multisearches
                           (``core.distributed.make_coordinated_update``);
                           reports a bucket overflow the engine watches.
                           Single-tenant, NBSI schemes only.
  banked_pjit_independent  the tenant-sharded bank: tenants over the mesh
                           axis ``config.tenant_axis``, estimators over the
                           others; W on every member of a tenant group.
  banked_pjit_coordinated  the same layout with W's rows split over the
                           estimator axes and gathered within each group.

The mesh is the one-process ``repro_torch.launch.mesh.Mesh``; a plan's
builders take ``(config, mesh)``, and optionally the scheme instance to run
(the engine passes its own), and return callables with the reference's
call convention, over the engine's ``ShardedState`` on the sharded plans.
Chunked ingest (``build_chunk``) exists on ``single`` and the banked plans;
sharded plans also build the device-resident query (``build_estimate``),
None where the scheme's estimate cannot shard or r does not divide the
mesh, and then ``estimate()`` gathers. ``select_backend`` is the reference's
``auto`` policy with its error messages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.core.schemes import EstimatorScheme, resolve_scheme
from repro_torch.primitives.ingest import resolve_ingest_backend
from repro_torch.primitives.search import resolve_multisearch_backend

BACKENDS = (
    "single",
    "pjit_independent",
    "pjit_coordinated",
    "shardmap",
    "banked_pjit_independent",
    "banked_pjit_coordinated",
)


@dataclass(frozen=True)
class BackendPlan:
    """How the engine executes ingest: a name plus builders returning the
    update callables for a (config, mesh); the reference's fields."""

    name: str
    banked: bool  # state carries a leading (n_tenants,) axis
    reports_overflow: bool  # update returns (state, overflow)
    build: Callable  # (config, mesh) -> the per-batch update (state, W, n_valid, keys)
    # the K-batch update (state, Ws, n_valids, keys, step0); None = cannot chunk
    build_chunk: Optional[Callable] = None
    # the elastic tier's variant of build_chunk: step0 a (T,) tensor
    build_chunk_elastic: Optional[Callable] = None
    # (config, mesh) -> StateLayout the engine places fresh and restored
    # states through (mesh-portable snapshots); None = one device
    bank_sharding: Optional[Callable] = None
    # (config, mesh) -> ShardPut for a batch / a staged superbatch: the engine
    # uploads host -> shards in one copy each
    batch_w_sharding: Optional[Callable] = None
    chunk_w_sharding: Optional[Callable] = None
    # (config, mesh) -> the device-resident query, or None
    build_estimate: Optional[Callable] = None
    # (config, mesh) -> the deletion update (state, D, n_valid)
    build_delete: Optional[Callable] = None


def _tenant_axis(config) -> str:
    return getattr(config, "tenant_axis", "tenants")


def config_scheme(config) -> EstimatorScheme:
    """The EstimatorScheme an engine config names (default global)."""
    return resolve_scheme(getattr(config, "scheme", "global"),
                          getattr(config, "scheme_params", None))


def _device(config, mesh):
    return mesh.devices[0] if mesh is not None else config.device


def _search(config, mesh) -> str:
    return resolve_multisearch_backend(config.multisearch, _device(config, mesh))


def _ingest(config, mesh) -> str:
    return resolve_ingest_backend(config.ingest, _device(config, mesh))


def _build_single(config, mesh, scheme=None):
    scheme, search = scheme or config_scheme(config), _search(config, mesh)

    def update(bank, Wb, n_valid, keys):
        return scheme.bulk_update(bank, Wb, n_valid, keys, search=search)

    return update


def _build_single_chunk(config, mesh, scheme=None):
    scheme = scheme or config_scheme(config)
    search, backend = _search(config, mesh), _ingest(config, mesh)

    def update(bank, Wb, n_valids, keys, step0):
        return scheme.chunk_update(bank, Wb, n_valids, keys, step0, backend=backend,
                                   search=search)

    return update


def _build_single_delete(config, mesh, scheme=None):
    scheme, search = scheme or config_scheme(config), _search(config, mesh)

    def delete(bank, Db, n_valid):
        return scheme.delete_update(bank, Db, n_valid, search=search)

    return delete


def _build_pjit(w_mode: str):
    def build(config, mesh, scheme=None):
        from repro_torch.core.distributed import make_pjit_update

        return make_pjit_update(mesh, w_mode, scheme or config_scheme(config), r=config.r,
                                search=_search(config, mesh))

    return build


def _build_banked_pjit(w_mode: str):
    def build(config, mesh, scheme=None):
        from repro_torch.core.distributed import make_banked_pjit_update

        return make_banked_pjit_update(mesh, w_mode, _tenant_axis(config),
                                       scheme or config_scheme(config), r=config.r,
                                       n_tenants=config.n_tenants,
                                       search=_search(config, mesh))

    return build


def _build_banked_pjit_chunk(w_mode: str, per_tenant_step0: bool = False):
    def build(config, mesh, scheme=None):
        from repro_torch.core.distributed import make_banked_pjit_chunk_update

        return make_banked_pjit_chunk_update(
            mesh, w_mode, _tenant_axis(config), scheme or config_scheme(config), r=config.r,
            n_tenants=config.n_tenants, per_tenant_step0=per_tenant_step0,
            backend=_ingest(config, mesh), search=_search(config, mesh))

    return build


def _build_pjit_delete(config, mesh, scheme=None):
    from repro_torch.core.distributed import make_pjit_delete

    return make_pjit_delete(mesh, scheme or config_scheme(config), r=config.r,
                            search=_search(config, mesh))


def _build_banked_delete(config, mesh, scheme=None):
    from repro_torch.core.distributed import make_banked_delete

    return make_banked_delete(mesh, _tenant_axis(config), scheme or config_scheme(config),
                              r=config.r,
                              n_tenants=config.n_tenants, search=_search(config, mesh))


def _sharded_layout(config, mesh):
    from repro_torch.core.distributed import scheme_state_sharding

    return scheme_state_sharding(mesh, config_scheme(config), tuple(mesh.axis_names),
                                 r=config.r)


def _banked_layout(config, mesh):
    from repro_torch.core.distributed import banked_state_sharding

    return banked_state_sharding(mesh, _tenant_axis(config), config_scheme(config),
                                 r=config.r, n_tenants=config.n_tenants)


def _batch_w_sharding(w_mode: str):
    def f(config, mesh):
        from repro_torch.core.distributed import batch_w_sharding

        return batch_w_sharding(mesh, w_mode)

    return f


def _banked_batch_w_sharding(w_mode: str):
    def f(config, mesh):
        from repro_torch.core.distributed import banked_batch_w_sharding

        return banked_batch_w_sharding(mesh, w_mode, _tenant_axis(config),
                                       n_tenants=config.n_tenants)

    return f


def _banked_chunk_w_sharding(w_mode: str):
    def f(config, mesh):
        from repro_torch.core.distributed import banked_chunk_w_sharding

        return banked_chunk_w_sharding(mesh, w_mode, _tenant_axis(config),
                                       n_tenants=config.n_tenants)

    return f


def _build_banked_estimate(config, mesh, scheme=None) -> Optional[Callable]:
    from repro_torch.core.distributed import make_banked_estimate

    scheme = scheme or config_scheme(config)
    if not scheme.shardable_estimate:
        return None  # estimate() gathers
    return make_banked_estimate(mesh, config.r, _tenant_axis(config), scheme, config.groups,
                                backend=_ingest(config, mesh))


def _build_sharded_estimate(config, mesh, scheme=None) -> Optional[Callable]:
    from repro_torch.core.distributed import make_sharded_estimate

    scheme = scheme or config_scheme(config)
    # the pjit plans take an r that does not divide the mesh; the query
    # does not, and estimate() then gathers
    if not scheme.shardable_estimate or config.r % _mesh_size(mesh):
        return None
    return make_sharded_estimate(mesh, config.r, scheme, config.groups,
                                 backend=_ingest(config, mesh))


def _build_shardmap(config, mesh, scheme=None):
    from repro_torch.core.distributed import make_coordinated_update

    return make_coordinated_update(mesh, config.r, config.batch_size, config.capacity_factor,
                                   scheme or config_scheme(config),
                                   search=_search(config, mesh))


def _banked_plan(w_mode: str) -> BackendPlan:
    return BackendPlan(
        f"banked_pjit_{w_mode.replace('_xla', '')}",
        banked=True,
        reports_overflow=False,
        build=_build_banked_pjit(w_mode),
        build_chunk=_build_banked_pjit_chunk(w_mode),
        build_chunk_elastic=_build_banked_pjit_chunk(w_mode, per_tenant_step0=True),
        bank_sharding=_banked_layout,
        batch_w_sharding=_banked_batch_w_sharding(w_mode),
        chunk_w_sharding=_banked_chunk_w_sharding(w_mode),
        build_estimate=_build_banked_estimate,
        build_delete=_build_banked_delete,
    )


def _unbanked_plan(name: str, build, w_mode: str, overflow: bool = False) -> BackendPlan:
    return BackendPlan(
        name, banked=False, reports_overflow=overflow, build=build,
        bank_sharding=_sharded_layout, batch_w_sharding=_batch_w_sharding(w_mode),
        build_estimate=_build_sharded_estimate, build_delete=_build_pjit_delete)


_PLANS = {
    # the bank on one device; the chunked update takes a (T,) step0 as well
    "single": BackendPlan("single", True, False, _build_single, _build_single_chunk,
                          build_chunk_elastic=_build_single_chunk,
                          build_delete=_build_single_delete),
    "pjit_independent": _unbanked_plan("pjit_independent", _build_pjit("independent"),
                                       "independent"),
    "pjit_coordinated": _unbanked_plan("pjit_coordinated", _build_pjit("coordinated_xla"),
                                       "coordinated_xla"),
    "shardmap": _unbanked_plan("shardmap", _build_shardmap, "coordinated_xla", overflow=True),
    "banked_pjit_independent": _banked_plan("independent"),
    "banked_pjit_coordinated": _banked_plan("coordinated_xla"),
}


def _mesh_size(mesh: Any) -> int:
    return int(mesh.size) if mesh is not None else 1


def _banked_mesh_fit(config, mesh) -> Optional[tuple[int, int]]:
    """(t_size, e_size) where ``mesh`` can host this bank tenant-sharded:
    it has the tenant axis, the axis divides n_tenants, and any estimator
    axes divide r. None where the bank must fall back to ``single``."""
    if mesh is None:
        return None
    ta = _tenant_axis(config)
    if ta not in mesh.axis_names:
        return None
    t_size = int(mesh.shape[ta])
    e_size = int(mesh.size) // t_size
    if t_size < 1 or config.n_tenants % t_size != 0:
        return None
    if e_size > 1 and config.r % e_size != 0:
        return None
    return t_size, e_size


def select_backend(config, mesh: Optional[Any] = None) -> BackendPlan:
    """Resolve config.backend (possibly "auto") to a concrete BackendPlan,
    with the reference's policy and errors."""
    scheme = config_scheme(config)  # validates the scheme name and params early
    name = config.backend
    p = _mesh_size(mesh)
    if name == "auto":
        fit = _banked_mesh_fit(config, mesh) if p > 1 else None
        if fit is not None:
            t_size, e_size = fit
            # an estimator axis with divisible batches earns the W shard;
            # otherwise W goes whole to each tenant group
            name = ("banked_pjit_coordinated"
                    if e_size > 1 and config.batch_size % e_size == 0
                    else "banked_pjit_independent")
        elif config.n_tenants > 1 or p <= 1:
            name = "single"
        elif (scheme.update_kind == "nbsi" and config.r % p == 0
              and config.batch_size % p == 0):
            name = "shardmap"
        else:
            name = "pjit_coordinated"
    if name not in _PLANS:
        raise ValueError(f"unknown backend {name!r}; choose from {BACKENDS}")
    plan = _PLANS[name]
    if name == "shardmap" and scheme.update_kind != "nbsi":
        raise ValueError(
            f"backend 'shardmap' hardcodes the paper's NBSI update; scheme "
            f"{scheme.name!r} (update_kind={scheme.update_kind!r}) cannot run "
            "it — use 'single' or a pjit plan")
    if not plan.banked and config.n_tenants > 1:
        raise ValueError(
            f"backend {name!r} is single-tenant; multi-tenant banks need "
            "'single', a banked_pjit_* plan, or 'auto'")
    if plan.name != "single" and mesh is None:
        raise ValueError(f"backend {name!r} requires a mesh")
    if plan.name.startswith("banked_"):
        fit = _banked_mesh_fit(config, mesh)
        if fit is None:
            raise ValueError(
                f"backend {name!r} needs a mesh with a "
                f"{_tenant_axis(config)!r} axis whose size divides "
                f"n_tenants={config.n_tenants} and whose remaining axes "
                f"divide r={config.r}; got mesh "
                f"{dict(mesh.shape) if mesh is not None else None}")
        _, e_size = fit
        if (plan.name == "banked_pjit_coordinated" and e_size > 1
                and config.batch_size % e_size != 0):
            raise ValueError(
                f"banked_pjit_coordinated needs batch_size "
                f"({config.batch_size}) divisible by the estimator axes "
                f"product ({e_size}); use banked_pjit_independent (W "
                "replicated per tenant group) instead")
    if plan.name == "shardmap" and (config.r % p != 0 or config.batch_size % p != 0):
        raise ValueError(
            f"shardmap needs r ({config.r}) and batch_size "
            f"({config.batch_size}) divisible by mesh size {p}")
    if getattr(config, "chunk_size", 1) > 1 and plan.build_chunk is None:
        raise ValueError(
            f"backend {name!r} does not support chunked ingest; "
            "chunk_size > 1 needs a banked plan ('single' or 'banked_pjit_*')")
    return plan
