"""ElasticBankEngine: a slab-allocated tenant bank with hot-add, evict and
grow (``repro.engine.elastic``).

``TriangleCountEngine`` keeps a fixed bank of ``n_tenants``; onboarding one
more tenant means a new engine. The elastic bank is a slab instead:

  * **Capacity tiers.** The bank always holds ``capacity`` slots (a power of
    two). Everything the bank runs at a capacity (the plan's banked update,
    its chunked update with a per-slot ``step0``, the device-resident query
    and the input layouts) is built once per capacity tier, warmed with
    no-op dispatches, and cached (``diag.tier_compiles``, ``diag.tiers``).
    Nothing is compiled per shape here; what costs after warm-up is a kernel
    library built or loaded (``repro_torch.kernels.LIBRARY_EVENTS``). The
    contract: churn within a capacity (hot-add, evict, ingest, query,
    snapshot, restore) builds or loads no kernel library and no tier, and
    slot operations write the bank's rows in place, so every field keeps its
    storage across ``hot_add``, ``evict``, ``restore_tenant`` and
    ``snapshot_tenant``.
  * **Pad and mask.** Free slots ride along in every dispatch with
    ``n_valid = 0`` batches. A zero-valid batch is a bitwise no-op of the
    NBSI update (no reservoir replacement, no chi increment, no closing
    probe, ``m_seen += 0``), so inactive neighbours are never touched.
  * **Grow by doubling.** When the free list is empty the capacity doubles:
    the next tier is built (one tier build), the live bank is gathered to
    one layout, widened with fresh slots and re-placed through the new
    tier's layout. On the tenant-sharded plans the tenant axis splits in
    contiguous blocks, so doubling moves slots between shards; live slots
    stay bit-identical, new slots are fresh. Capacity never shrinks.
  * **Per-slot RNG cursors.** Each slot carries its own step: batch i of a
    slot draws from ``fold_in(PRNGKey(seed), i)``, the fixed engine's
    contract. ``ingest`` folds ``fold_in(root_keys[slot], steps[slot])``
    slot by slot; ``ingest_chunk`` runs the plan's
    ``build_chunk_elastic`` with the ``(C,)`` cursors as ``step0``, each
    slot's lane front-packed (real batches first, ``n_valid = 0`` padding
    after). A tenant's state after hot-add and ingest is therefore
    bit-identical to the same stream on a fresh one-tenant engine, on every
    banked plan and chunk size, and to the JAX reference's elastic bank.
    The cursors live on the host and reach the device through a fresh
    pinned buffer per dispatch, never one that is mutated afterwards.
  * **Per-tenant snapshots.** ``snapshot_tenant`` emits the reference's
    single-tenant snapshot dict (``(1, ..)`` fields, ``root_keys (1, 2)``,
    the slot's cursor as ``step`` and ``dyn_step``), which restores into a
    one-tenant ``TriangleCountEngine`` of either package
    (``repro_torch.interop``), round-trips ``CheckpointManager``, and feeds
    ``restore_tenant``, which takes either source.

The elastic tier runs on the banked plans only (``single`` and the
``banked_pjit_*`` pair) and is insertion-only, as the reference's is: no
window, decay or turnstile deletions (snapshot a tenant into a fixed engine
for those). ``repro_torch.engine.service.ElasticServeLoop`` drives it with
bounded per-tenant queues and concurrent queries. It runs on the card
unless ``device="cpu"`` (or a mesh of CPU shards).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device, rng
from repro_torch.core.distributed import ShardedState
from repro_torch.core.schemes import ROLE_REPLICATED
from repro_torch.core.state import EstimatorState
from repro_torch.engine.backends import select_backend
from repro_torch.engine.engine import EngineConfig, SnapshotMismatch, _snapshot_config
from repro_torch.engine.faults import FaultInjected, check_fault
from repro_torch.primitives.ingest import resolve_ingest_backend

_DTYPES = {"f1": torch.int32, "chi": torch.int32, "f2": torch.int32, "has_f3": torch.bool,
           "m_seen": torch.int64}


@dataclass
class ElasticDiagnostics:
    """Host-side operational counters for the elastic bank (the
    reference's fields, in its order)."""

    backend: str = ""
    capacity: int = 0
    tier_compiles: int = 0  # capacity-tier builds (the slab unit)
    grows: int = 0  # capacity doublings
    hot_adds: int = 0
    evictions: int = 0
    restores: int = 0
    snapshots_taken: int = 0
    batches_ingested: int = 0  # per-slot batches, summed
    edges_ingested: int = 0
    queries_answered: int = 0
    query_cache_hits: int = 0
    query_fallbacks: int = 0  # device-path queries degraded to the gather oracle
    tiers: List[int] = field(default_factory=list)  # capacities built, in order

    def as_dict(self) -> dict:
        return asdict(self)


class ElasticBankEngine:
    """Slab-allocated tenant bank (see module docstring).

    Mutating entry points (``ingest``, ``ingest_chunk``, ``hot_add``,
    ``evict``, ``restore_tenant``) are not thread-safe:
    ``ElasticServeLoop`` serialises them on its consumer thread, and direct
    users must do the same."""

    #: plans the elastic tier runs on (``BackendPlan.banked``)
    BANKED = ("single", "banked_pjit_independent", "banked_pjit_coordinated")

    def __init__(
        self,
        r: int,
        batch_size: int,
        *,
        capacity: int = 2,
        backend: str = "auto",
        mesh: Any = None,
        scheme: str = "global",
        scheme_params: Optional[tuple] = None,
        groups: int = 9,
        chunk_size: int = 1,
        tenant_axis: str = "tenants",
        device: str = "cuda",
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.r = int(r)
        self.batch_size = int(batch_size)
        self.groups = int(groups)
        self.chunk_size = int(chunk_size)
        self.mesh = mesh
        self.device = resolve_device(device)
        if mesh is not None:
            if any(d.type != self.device.type for d in mesh.devices):
                raise ValueError(f"mesh devices {[str(d) for d in mesh.devices]} are not "
                                 f"of the bank's device type {self.device.type!r}")
            self.device = mesh.devices[0]
        self._scheme_name = scheme
        self._scheme_params = scheme_params
        self._tenant_axis = tenant_axis
        cap = 1
        while cap < capacity:
            cap *= 2
        # resolve the plan once (auto must not flip plans between tiers);
        # validates scheme, mesh and divisibility through the engine's rules
        cfg0 = self._tier_config(cap, backend)
        plan = select_backend(cfg0, mesh)
        if not plan.banked:
            raise ValueError(
                f"elastic banks need a banked plan {self.BANKED}; "
                f"backend {backend!r} resolved to {plan.name!r}"
            )
        self._backend = plan.name
        self.scheme = cfg0.resolved_scheme()
        self._ingest_backend = resolve_ingest_backend("auto", self.device)
        # one fresh slot, written by hot_add and evict scrubs and tier growth
        self._fresh_one = self.scheme.init_state(self.r, self.device, 1)

        self.diag = ElasticDiagnostics(backend=self._backend)
        self._tiers: dict = {}
        self._tenants: dict = {}  # tenant id -> slot
        self._next_seed = 0
        self._version = 0  # bumped on every state mutation; the query-cache key
        self._est_cache: dict = {}

        self.capacity = cap
        self._steps = np.zeros((cap,), np.int64)  # per-slot RNG cursors
        self._free: List[int] = list(range(cap))
        self._root_keys = torch.stack([rng.PRNGKey(0, self.device)] * cap)
        self._enter_tier(cap)
        self._state = self._place(self.scheme.init_state(self.r, self.device, cap))
        self._warm_tier()

    # -- tier machinery -----------------------------------------------------
    def _tier_config(self, cap: int, backend: Optional[str] = None) -> EngineConfig:
        return EngineConfig(
            r=self.r, batch_size=self.batch_size, n_tenants=cap, groups=self.groups,
            backend=backend if backend is not None else self._backend,
            scheme=self._scheme_name, scheme_params=self._scheme_params,
            tenant_axis=self._tenant_axis, chunk_size=self.chunk_size,
            device=str(self.device))

    def _enter_tier(self, cap: int) -> None:
        if cap not in self._tiers:
            self._tiers[cap] = self._build_tier(cap)
            self.diag.tier_compiles += 1
            self.diag.tiers.append(cap)
        self._tier = self._tiers[cap]
        self.capacity = cap
        self.diag.capacity = cap

    def _build_tier(self, cap: int) -> dict:
        """Everything the bank runs at this capacity, built once; the
        kernels load at the warm-up's first dispatch (``_warm_tier``)."""
        cfg = self._tier_config(cap)
        plan = select_backend(cfg, self.mesh)
        mesh, scheme = self.mesh, self.scheme

        def maybe(make):
            return make(cfg, mesh) if make is not None else None

        return {
            "config": cfg,
            "plan": plan,
            "update": plan.build(cfg, mesh, scheme),
            "chunk": (plan.build_chunk_elastic(cfg, mesh, scheme)
                      if self.chunk_size > 1 else None),
            "estimate_device": (plan.build_estimate(cfg, mesh, scheme)
                                if plan.build_estimate is not None else None),
            "layout": maybe(plan.bank_sharding),
            "batch_put": maybe(plan.batch_w_sharding),
            "chunk_put": maybe(plan.chunk_w_sharding),
        }

    def _warm_tier(self) -> None:
        """Dispatch everything the tier runs once, so every kernel library
        it needs is built and loaded now, inside the tier window. Each call
        is a state no-op: the update and the chunk carry ``n_valid = 0``
        batches, the slot write writes back what the slot read read, and the
        key set re-sets an existing key."""
        C, s, K = self.capacity, self.batch_size, self.chunk_size
        t = self._tier
        self._state = t["update"](self._state, self._put(np.zeros((C, s, 2), np.int32), "batch"),
                                  self._upload(np.zeros((C,), np.int32)), self._slot_keys())
        if t["chunk"] is not None:
            self._state = t["chunk"](self._state,
                                     self._put(np.zeros((C, K, s, 2), np.int32), "chunk"),
                                     self._upload(np.zeros((C, K), np.int32)), self._root_keys,
                                     self._upload(self._steps))
        if t["estimate_device"] is not None:
            t["estimate_device"](self._state)
        self.scheme.estimate(self._bank(), self.groups, backend=self._ingest_backend)
        self._slot_write(0, self._slot_read(0))
        self._root_keys[0].copy_(self._root_keys[0].clone())
        self.sync()

    def _place(self, bank: EstimatorState):
        """A full bank laid out as the tier keeps it: on the bank's device,
        or a ShardedState through the tier's layout."""
        layout = self._tier["layout"]
        if layout is None:
            return EstimatorState(*(x.to(self.device) for x in bank))
        return ShardedState(layout.shard(bank), layout)

    def _bank(self) -> EstimatorState:
        """The whole bank on the bank's device (gathered on a sharded plan)."""
        if isinstance(self._state, ShardedState):
            return self._state.gather(self.device)
        return self._state

    def _upload(self, arr: np.ndarray, device=None) -> torch.Tensor:
        """A host array on ``device`` (the bank's by default) through a fresh
        pinned buffer, without blocking the host; a plain copy on the CPU.
        The source is copied before the call returns, so the caller may
        mutate it right after."""
        arr = np.asarray(arr)
        device = self.device if device is None else torch.device(device)
        if device.type == "cpu":
            return torch.from_numpy(np.array(arr, order="C"))
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        pinned = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
        np.copyto(pinned.numpy(), arr)
        return pinned.to(device, non_blocking=True)

    def _put(self, arr: np.ndarray, kind: str):
        """A host batch (``kind`` "batch") or chunk ("chunk") on the device,
        or its per-shard blocks through the tier's input layout."""
        put = self._tier[f"{kind}_put"]
        return self._upload(arr) if put is None else put.put(arr, self._upload)

    def _slot_keys(self) -> torch.Tensor:
        """(C, 2) keys, ``fold_in(root_keys[c], steps[c])`` slot by slot.
        ``rng.fold_in`` with a (C, 2) key and a (C,) tensor would fold all C
        counters into every key, so the counters pair up as (C, 1)."""
        steps = self._upload(self._steps)
        return rng.fold_in(self._root_keys, steps[:, None])[:, 0]

    # -- slot reads and writes (in place) -----------------------------------
    def _slot_blocks(self, slot: int) -> list:
        """Where a slot's rows live: ``(fields, row, e_lo, e_hi, sharded)``
        for every shard holding them, in estimator order (or the one state)."""
        st = self._state
        if not isinstance(st, ShardedState):
            return [(st, slot, 0, self.r, False)]
        lay = st.layout
        blocks = []
        for i, shard in enumerate(st.shards):
            lo, hi = lay.t_range(i)
            if lo <= slot < hi:
                blocks.append((shard, slot - lo, *lay.e_range(i), True))
        return sorted(blocks, key=lambda b: b[2])

    def _slot_write(self, slot: int, one: EstimatorState) -> None:
        """Write a ``(1, ..)`` state into a slot's rows in place."""
        roles = self.scheme.axis_roles()
        for fields, row, e_lo, e_hi, sharded in self._slot_blocks(slot):
            for x, o, role in zip(fields, one, roles):
                src = o[0]
                if sharded and role != ROLE_REPLICATED:
                    src = src[e_lo:e_hi]
                x[row].copy_(src)

    def _slot_read(self, slot: int) -> EstimatorState:
        """A slot's state as ``(1, ..)`` tensors on the bank's device (a
        copy), its estimator slices concatenated in order on a sharded plan."""
        roles = self.scheme.axis_roles()
        parts = [[] for _ in roles]
        for fields, row, _, _, _ in self._slot_blocks(slot):
            for f, (x, role) in enumerate(zip(fields, roles)):
                if role != ROLE_REPLICATED or not parts[f]:
                    parts[f].append(x[row].to(self.device))
        return EstimatorState(*(torch.cat(p)[None] if p[0].dim() else p[0].clone()[None]
                                for p in parts))

    # -- introspection ------------------------------------------------------
    @property
    def backend(self) -> str:
        return self._backend

    @property
    def n_active(self) -> int:
        return len(self._tenants)

    @property
    def version(self) -> int:
        """Mutation counter: bumps on every ingest, add, evict and restore.
        The query cache is keyed on it, so a cached answer is fresh iff its
        key equals the current version."""
        return self._version

    def tenants(self) -> tuple:
        return tuple(self._tenants)

    def slot_of(self, tid) -> int:
        return self._tenants[tid]

    def step_of(self, tid) -> int:
        """The tenant's RNG cursor: batches ingested since its hot-add."""
        return int(self._steps[self._tenants[tid]])

    def sync(self) -> None:
        """Block until every dispatched operation has finished on the
        devices."""
        if self.device.type == "cuda":
            for dev in (self.mesh.devices if self.mesh is not None else (self.device,)):
                torch.cuda.synchronize(dev)

    # -- tenancy ------------------------------------------------------------
    def hot_add(self, tid, seed: Optional[int] = None) -> int:
        """Place a new tenant in a free slot (growing the capacity if none is
        free) with a fresh state seeded ``PRNGKey(seed)``: one slot write and
        one key write, in place; the neighbours' rows are untouched."""
        if tid in self._tenants:
            raise ValueError(f"tenant {tid!r} is already resident")
        if not self._free:
            self._grow()
        slot = self._free.pop(0)
        if seed is None:
            seed = self._next_seed
        self._next_seed = max(self._next_seed, seed + 1)
        self._slot_write(slot, self._fresh_one)
        self._root_keys[slot].copy_(rng.PRNGKey(seed, self.device))
        self._steps[slot] = 0
        self._tenants[tid] = slot
        self._version += 1
        self.diag.hot_adds += 1
        return slot

    def evict(self, tid, scrub: bool = True) -> int:
        """Remove a tenant; its slot returns to the free list. ``scrub``
        overwrites the slot with fresh state so evicted data does not linger
        in the bank; False makes evict pure host bookkeeping (the next
        hot_add scrubs anyway)."""
        slot = self._tenants.pop(tid)
        if scrub:
            self._slot_write(slot, self._fresh_one)
        self._steps[slot] = 0
        self._free.append(slot)
        self._free.sort()
        self._version += 1
        self.diag.evictions += 1
        return slot

    def _grow(self) -> None:
        """Double the capacity: gather the live bank to one layout, append
        fresh slots, and re-place it through the new tier's layout (on the
        tenant-sharded plans a slot may move to another shard)."""
        new_cap = self.capacity * 2
        pad = new_cap - self.capacity
        bank = self._bank()
        fresh = self.scheme.init_state(self.r, self.device, pad)
        keys = torch.cat([self._root_keys, torch.stack([rng.PRNGKey(0, self.device)] * pad)])
        self._enter_tier(new_cap)
        self._state = self._place(EstimatorState(*(torch.cat([b, f])
                                                   for b, f in zip(bank, fresh))))
        self._root_keys = keys
        self._free.extend(range(new_cap - pad, new_cap))
        self._steps = np.concatenate([self._steps, np.zeros((pad,), np.int64)])
        self._version += 1
        self.diag.grows += 1
        self._warm_tier()

    # -- ingest -------------------------------------------------------------
    def _pad(self, W, n_valid: Optional[int] = None) -> tuple:
        s = self.batch_size
        W = np.asarray(W, np.int32)
        n = W.shape[0] if n_valid is None else int(n_valid)
        if W.shape[0] > s:
            raise ValueError(f"batch of {W.shape[0]} edges exceeds batch_size={s}")
        if W.shape[0] < s:
            W = np.concatenate([W, np.zeros((s - W.shape[0], 2), np.int32)], axis=0)
        return W, n

    def ingest(self, batches: Mapping[Any, Any]) -> None:
        """Fold one batch per listed tenant in one banked dispatch.

        ``batches`` maps tenant id -> ``(W, n_valid)`` (or a bare ``W``,
        ``(<=s, 2)``). Unlisted slots ride along with ``n_valid = 0``, a
        bitwise no-op that does not advance their cursor. A listed tenant's
        cursor advances by one even if its batch is empty, as the fixed
        engine's ``ingest`` does."""
        check_fault("engine.ingest")  # before any mutation
        C, s = self.capacity, self.batch_size
        Wb = np.zeros((C, s, 2), np.int32)
        nv = np.zeros((C,), np.int32)
        touched = []
        edges = 0
        for tid, item in batches.items():
            slot = self._tenants[tid]
            W, n = item if isinstance(item, tuple) else (item, None)
            Wb[slot], nv[slot] = self._pad(W, n)
            touched.append(slot)
            edges += int(nv[slot])
        self._state = self._tier["update"](self._state, self._put(Wb, "batch"),
                                           self._upload(nv), self._slot_keys())
        for slot in touched:
            self._steps[slot] += 1
        self._version += 1
        self.diag.batches_ingested += len(touched)
        self.diag.edges_ingested += edges

    def ingest_chunk(self, batches: Mapping[Any, Sequence]) -> None:
        """Fold up to ``chunk_size`` batches per listed tenant in one fused
        dispatch (the plan's chunked update with a per-slot ``step0``).

        ``batches`` maps tenant id -> a sequence of ``(W, n_valid)`` pairs
        (at most chunk_size). Each slot's lane is front-packed: its batches
        take chunk positions ``0 .. j-1`` and fold cursors ``step0 ..
        step0 + j - 1``, bit-identical to j ``ingest`` calls, while the
        trailing ``n_valid = 0`` padding and unlisted slots' lanes are
        no-ops."""
        if self._tier["chunk"] is None:
            raise ValueError("chunked elastic ingest needs chunk_size > 1 at construction")
        check_fault("engine.ingest_chunk")  # before any mutation
        C, K, s = self.capacity, self.chunk_size, self.batch_size
        Wb = np.zeros((C, K, s, 2), np.int32)
        nv = np.zeros((C, K), np.int32)
        advance = {}
        edges = 0
        for tid, items in batches.items():
            slot = self._tenants[tid]
            if len(items) > K:
                raise ValueError(f"{len(items)} batches for tenant {tid!r} exceed "
                                 f"chunk_size={K}")
            for k, item in enumerate(items):
                W, n = item if isinstance(item, tuple) else (item, None)
                Wb[slot, k], nv[slot, k] = self._pad(W, n)
                edges += int(nv[slot, k])
            advance[slot] = len(items)
        self._state = self._tier["chunk"](self._state, self._put(Wb, "chunk"), self._upload(nv),
                                          self._root_keys, self._upload(self._steps))
        for slot, j in advance.items():
            self._steps[slot] += j
        self._version += 1
        self.diag.batches_ingested += sum(advance.values())
        self.diag.edges_ingested += edges

    # -- queries ------------------------------------------------------------
    def estimate(self, *, gather: bool = False) -> np.ndarray:
        """Per-slot estimates, ``(capacity, ..)``: rows of inactive slots are
        the fresh state's (0 triangles) and meaningless. Device-resident on
        the sharded plans with the gather oracle as the fallback
        (``gather=True`` forces it and bypasses the cache); answers are
        cached per ``version``, so repeated queries between mutations cost
        one query in all."""
        if not gather:
            cached = self._est_cache.get(self._version)
            if cached is not None:
                self.diag.queries_answered += 1
                self.diag.query_cache_hits += 1
                return cached
        out = None
        if not gather and self._tier["estimate_device"] is not None:
            try:
                check_fault("engine.estimate")  # the device dispatch's fault site
                out = self._tier["estimate_device"](self._state).to(torch.float64).cpu().numpy()
            except FaultInjected:
                self.diag.query_fallbacks += 1
                out = None
        if out is None:
            est = self.scheme.estimate(self._bank(), self.groups, backend=self._ingest_backend)
            out = est.to(torch.float64).cpu().numpy()
        self.diag.queries_answered += 1
        if not gather:
            self._est_cache = {self._version: out}
        return out

    def cached_estimate(self) -> Optional[tuple]:
        """The newest cached answer as ``(version, estimates)``, or None;
        never queries. Under ingest backpressure the serve loop answers from
        here, tagged stale with age ``version - key``."""
        if not self._est_cache:
            return None
        v = max(self._est_cache)
        return v, self._est_cache[v]

    def estimate_tenant(self, tid):
        e = self.estimate()[self._tenants[tid]]
        return float(e) if np.ndim(e) == 0 else e

    def estimate_tenants(self, tids: Iterable) -> np.ndarray:
        ests = self.estimate()
        return ests[np.asarray([self._tenants[t] for t in tids], np.int64)]

    def edges_seen(self, tid) -> int:
        """The tenant's stream length, read from one shard's row."""
        fields, row, _, _, _ = self._slot_blocks(self._tenants[tid])[0]
        return int(fields.m_seen[row])

    # -- per-tenant snapshot / restore --------------------------------------
    def snapshot_tenant(self, tid) -> dict:
        """One tenant as a single-tenant ``TriangleCountEngine`` snapshot
        dict of host numpy arrays: it restores into a fresh one-tenant
        engine of either package bit-identically, round-trips
        ``CheckpointManager`` and feeds ``restore_tenant``. Only this slot's
        rows leave the device."""
        slot = self._tenants[tid]
        one = self._slot_read(slot)
        snap = {f: getattr(one, f).cpu().numpy() for f in EstimatorState._fields}
        snap["root_keys"] = self._root_keys[slot:slot + 1].cpu().numpy().astype(np.uint32)
        snap["step"] = np.int64(self._steps[slot])
        snap["dyn_step"] = np.int64(self._steps[slot])
        snap["config"] = np.array([self.r, self.batch_size, 1], np.int64)
        snap["scheme"] = np.array(self.scheme.name)
        self.diag.snapshots_taken += 1
        return snap

    def snapshot_template(self) -> dict:
        """A zero-filled single-tenant snapshot with this bank's shapes and
        dtypes: the template ``CheckpointManager.restore`` verifies a saved
        tenant snapshot against before ``restore_tenant`` accepts it."""
        snap = {f: np.zeros_like(getattr(self._fresh_one, f).cpu().numpy())
                for f in EstimatorState._fields}
        snap["root_keys"] = np.zeros((1, 2), np.uint32)
        snap["step"] = np.int64(0)
        snap["dyn_step"] = np.int64(0)
        snap["config"] = np.array([self.r, self.batch_size, 1], np.int64)
        snap["scheme"] = np.array(self.scheme.name)
        return snap

    def restore_tenant(self, tid, snap: dict) -> int:
        """Load a single-tenant snapshot into ``tid``'s slot (hot-adding the
        tenant first if absent): state rows, root key and RNG cursor, in
        place. The source may be ``snapshot_tenant`` or a one-tenant fixed
        engine's ``snapshot()`` of either package: the formats are the
        same."""
        got = _snapshot_config(snap)
        if got[0] != self.r or got[2] != 1:
            raise SnapshotMismatch(
                f"snapshot (r, batch_size, n_tenants)={got} does not fit an "
                f"elastic slot with r={self.r} (need n_tenants=1)")
        snap_scheme = str(np.asarray(snap.get("scheme", "global")))
        if snap_scheme != self.scheme.name:
            raise SnapshotMismatch(
                f"snapshot was written by scheme {snap_scheme!r}; this bank "
                f"runs {self.scheme.name!r}")
        if tid not in self._tenants:
            self.hot_add(tid)
        slot = self._tenants[tid]
        one = EstimatorState(**{
            f: torch.from_numpy(np.array(np.asarray(snap[f]))).to(dtype=dt)
            for f, dt in _DTYPES.items()})
        self._slot_write(slot, one)
        key = np.asarray(snap["root_keys"]).astype(np.int64).reshape(2)
        self._root_keys[slot].copy_(torch.from_numpy(key))
        self._steps[slot] = int(snap["step"])
        self._version += 1
        self.diag.restores += 1
        return slot
