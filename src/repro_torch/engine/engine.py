"""TriangleCountEngine on every execution plan (``repro.engine.engine``).

A long-lived streaming triangle counter for a bank of ``n_tenants`` edge
streams (one by default):

  * ``ingest(W)`` folds one batch into the estimators; on the ``single``
    plan with the kernel ingest backend (the card's default) it runs the
    batch as a one-batch chunk through the scheme's ``chunk_update``, bit
    for bit the per-batch update (``batches_as_chunk`` counts those);
  * ``stage_chunk`` / ``ingest_chunk`` fold K batches in one update, with
    the next chunk's upload staged while the current one computes;
  * ``estimate()`` answers the scheme's query, cached per ``step``, and
    ``cached_estimate()`` serves the newest cached answer without a query;
  * ``snapshot()`` / ``restore()`` round-trip the whole engine (estimators and
    RNG cursor) through host numpy arrays, in the JAX engine's flat-dict
    format, so a snapshot from either engine restores into the other
    (``repro_torch.interop``).

RNG contract: batch i of tenant t draws from ``fold_in(PRNGKey(seeds[t]),
i)``; nothing else carries random state, so chunked, per-batch and restored
runs are bit-identical to each other and to the JAX reference, and tenant t
of a bank to a one-tenant engine seeded ``seeds[t]`` on tenant t's stream.

Banks (the reference's ``single`` plan, ``vmap`` over tenants): the state is
one bank with a leading tenant axis (``core.state``), updated by one
sequence of device operations for all tenants, each kernel launched once
for the whole bank. ``W`` is ``(<=s, 2)``, broadcast to every tenant, or
``(T, <=s, 2)``, a batch per tenant; ``n_valid`` a scalar or ``(T,)``.
``estimate()`` answers ``(T,)`` (``(T, n_vertices)`` for ``local``), cached
per step and served to ``estimate_tenant`` and ``estimate_tenants``.

Schemes: ``EngineConfig.scheme`` names an estimator scheme
(``repro_torch.core.schemes``: ``global``, ``naive``, ``local``); the engine
initialises, ingests and answers queries through it, and a snapshot carries
the scheme's name, so restoring into an engine of another scheme raises
``SnapshotMismatch``.

Dynamic streams: ``delete(D)`` patches a batch of edge deletions out of the
estimators (``scheme.delete_update``: no randomness, ``step`` unchanged) and
``ingest_signed_stream`` drains a signed batch iterator. ``window=N`` keeps
only the newest N inserted edges of each tenant live and ``decay=D`` gives
each inserted edge a deterministic geometric lifetime of mean D insertions
(hashed from its tenant's seed); both keep one host ring per tenant of live
(edge, expiry) rows in insertion order (``_Rings``) and author expiry
deletion batches from them after every ingest (once per chunk on the
chunked path, as the reference does): each round takes every tenant's next
<= s expired rows into one (T, s, 2) batch. Snapshots of such engines carry
the rings at fixed capacity (``window_edges``, ``window_expiry``,
``window_len``), in the reference's format.

Plans (``engine.backends``): ``TriangleCountEngine(config, mesh)`` runs
the plan ``config.backend`` names (``auto`` picks one as the reference does)
on a one-process device mesh (``launch.mesh.Mesh``): ``single`` keeps the
bank on one device; the sharded plans (``pjit_independent``,
``pjit_coordinated``, ``shardmap``, ``banked_pjit_*``) keep a
``ShardedState``, one state per shard, placed through the plan's layout,
and upload each batch or staged chunk host -> shards through the plan's
``batch_w_sharding``/``chunk_w_sharding``. The ``shardmap`` update returns
its routing overflow; the engine keeps those device scalars and drains
them every 8 batches (and at every query and snapshot), and an overflow
doubles ``capacity_factor`` and rebuilds the update
(``diag.overflow_batches``, ``diag.capacity_escalations``). A restore drops
the undrained scalars of the stream it replaces
(``diag.pending_overflow_dropped``). On the sharded plans ``estimate()``
runs the device-resident query where the shards live; a fault at its
``engine.estimate`` site or a ``timeout_s`` that expires falls back to the
gather oracle, which gathers the shards and answers as ``single`` does,
counted in ``diag.query_fallbacks`` (and ``diag.query_timeouts``).
Snapshots stay mesh-free: they gather to the host and restore onto any
mesh shape, tenants-per-shard split, or no mesh.

Fault sites (``engine.faults``): ``engine.ingest`` first thing in
``ingest``, ``engine.stage_chunk`` after ``stage_chunk``'s shape checks and
before its upload, ``engine.ingest_chunk`` first thing in ``ingest_chunk``
(before an unstaged chunk is staged), each before any state change, and
``engine.estimate`` at the device-resident query's dispatch, at the
reference's points, so the same plan fires on the same calls in both
packages. ``single`` has no device-resident query, so ``engine.estimate``
never fires there and ``estimate(timeout_s=)`` has nothing to bound, as in
the reference.

The engine runs on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import concurrent.futures
from dataclasses import dataclass, field, replace
from typing import Any, Iterable, Optional

import numpy as np
import torch

from repro_torch import resolve_device, rng
from repro_torch.core.distributed import ShardedState
from repro_torch.core.schemes import EstimatorScheme, resolve_scheme
from repro_torch.core.state import EstimatorState
from repro_torch.engine.backends import BackendPlan, select_backend
from repro_torch.engine.faults import FaultInjected, check_fault
from repro_torch.primitives.ingest import resolve_ingest_backend
from repro_torch.primitives.search import resolve_multisearch_backend
from repro_torch.spans import span

_STATE_FIELDS = EstimatorState._fields


@dataclass(frozen=True)
class EngineConfig:
    """Static configuration. ``r``, ``batch_size`` and ``n_tenants`` go into
    the snapshot's ``config`` record. ``scheme_params`` is a ((name, value),
    ...) tuple (a dict is normalised to one), e.g. ``scheme="local",
    scheme_params={"n_vertices": 10_000, "n_pools": 8}``."""

    r: int  # estimators
    batch_size: int  # s: fixed ingest width (shorter batches are padded)
    n_tenants: int = 1
    groups: int = 9  # requested median-of-means groups (see effective_groups)
    seeds: Optional[tuple[int, ...]] = None  # per-tenant RNG seeds
    backend: str = "auto"  # auto, or a name in repro_torch.engine.backends.BACKENDS
    scheme: str = "global"
    scheme_params: Optional[tuple] = None
    # the mesh axis the bank's tenants shard over (banked_pjit_* plans); every
    # other axis shards the estimators
    tenant_axis: str = "tenants"
    capacity_factor: float = 2.0  # shardmap's routing capacity (core.distributed)
    chunk_size: int = 1  # K: batches fused per update
    # fully-dynamic modes, mutually exclusive: window=N keeps the newest N
    # inserted edges live (count-based sliding window); decay=D (> 1) gives
    # each inserted edge a geometric lifetime of mean D insertions, a hash of
    # (seed, insertion position). 0 = insertion-only.
    window: int = 0
    decay: float = 0.0
    device: str = "cuda"
    ingest: str = "auto"  # repro_torch.primitives.ingest.INGEST_BACKENDS
    multisearch: str = "auto"  # repro_torch.primitives.search.MULTISEARCH_BACKENDS

    def __post_init__(self):
        if isinstance(self.scheme_params, dict):
            object.__setattr__(self, "scheme_params", tuple(sorted(self.scheme_params.items())))
        if self.r <= 0 or self.batch_size <= 0:
            raise ValueError(f"bad config: {self}")
        if self.groups < 1:
            raise ValueError(f"groups must be >= 1, got {self.groups}")
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")
        if self.window < 0:
            raise ValueError(f"window must be >= 0, got {self.window}")
        if self.decay != 0.0 and self.decay <= 1.0:
            raise ValueError(f"decay must be > 1 (mean edge lifetime), got {self.decay}")
        if self.window and self.decay:
            raise ValueError(
                "window and decay are mutually exclusive dynamic modes; "
                f"got window={self.window}, decay={self.decay}")
        if self.n_tenants < 1:
            raise ValueError(f"n_tenants must be >= 1, got {self.n_tenants}")
        self.resolved_scheme()
        if self.seeds is not None and len(self.seeds) != self.n_tenants:
            raise ValueError(f"seeds has {len(self.seeds)} entries for {self.n_tenants} tenants")

    def resolved_scheme(self) -> EstimatorScheme:
        """The scheme instance this config names, validated against ``r``."""
        scheme = resolve_scheme(self.scheme, self.scheme_params)
        scheme.validate(self.r)
        return scheme

    def tenant_seeds(self) -> tuple[int, ...]:
        return tuple(self.seeds) if self.seeds is not None else tuple(range(self.n_tenants))


class SnapshotMismatch(ValueError):
    """Snapshot config does not match the engine it is being restored into."""


@dataclass
class EngineDiagnostics:
    """The reference's rolling counters, field for field and in its order
    (host-side, not part of the snapshot). The shardmap plan's overflow
    counters and the device-query fallbacks stay 0 on the other plans and
    on ``single`` respectively."""

    batches_ingested: int = 0
    edges_ingested: int = 0  # max over tenants, per batch
    overflow_batches: int = 0  # shardmap batches that reported bucket overflow
    capacity_escalations: int = 0  # recompiles triggered by overflow
    backend: str = ""
    queries_answered: int = 0  # estimate() calls (any path)
    query_cache_hits: int = 0  # answered from the per-step estimate cache
    delete_batches: int = 0  # explicit turnstile deletion batches applied
    edges_deleted: int = 0  # max-over-tenants valid edges in those batches
    window_expired: int = 0  # edges expired by the window/decay clock
    pending_overflow_dropped: int = 0  # shardmap overflow scalars a restore discarded
    query_fallbacks: int = 0  # device-path queries answered by the gather oracle
    query_timeouts: int = 0  # ... of those, due to the per-query timeout
    ckpt_corrupt_skipped: int = 0  # torn or corrupt checkpoints walked past on restore


@dataclass
class StagedChunk:
    """A K-batch superbatch already on the engine's device (``stage_chunk``),
    broadcast to the tenant axis. On CUDA the upload runs on a side stream;
    ``ready`` is the event the ingest waits for. The host rows stay for the
    window clock (``W_host`` is None on an insertion-only engine)."""

    Wb: Any  # (T, K, s, 2) int32 tensor, or its per-shard blocks on a sharded plan
    nv: torch.Tensor  # (T, K) int32
    edges: int  # max-over-tenants valid edges of each batch, summed (host-side)
    ready: Any = field(default=None, repr=False)
    W_host: Optional[np.ndarray] = field(default=None, repr=False)  # (T, K, s, 2) int32
    nv_host: Optional[np.ndarray] = field(default=None, repr=False)  # (T, K) int64


def _snapshot_config(snap: dict) -> tuple:
    return tuple(int(x) for x in np.asarray(snap["config"]).tolist())


def _edge_keys(E: np.ndarray) -> np.ndarray:
    """One int64 per undirected edge: (min << 32) | (max as uint32)."""
    E = np.asarray(E, np.int64)
    return (np.minimum(E[:, 0], E[:, 1]) << 32) | (np.maximum(E[:, 0], E[:, 1]) & 0xFFFFFFFF)


class _Rings:
    """One ring per tenant of live (edge, expiry) rows in insertion order,
    each preallocated at ``cap`` rows: an append writes at the tail in
    place, a cut of the oldest rows moves the head, and a masked removal
    compacts the survivors once. Rows ``lo ..`` of a ring are counted from
    its head."""

    def __init__(self, n_tenants: int, cap: int):
        self.cap = cap
        self.edges = np.empty((n_tenants, cap, 2), np.int32)
        self.expiry = np.empty((n_tenants, cap), np.int64)
        self.head = np.zeros((n_tenants,), np.int64)
        self.len = np.zeros((n_tenants,), np.int64)

    def _spans(self, t: int, lo: int, n: int) -> list:
        """Ring rows lo .. lo + n - 1 as at most two buffer slices."""
        a = int(self.head[t] + lo) % self.cap
        first = min(n, self.cap - a)
        return [slice(a, a + first)] + ([slice(0, n - first)] if n > first else [])

    def rows(self, t: int, lo: int = 0, n: Optional[int] = None) -> tuple:
        """(edges (n, 2), expiry (n,)) of ring rows lo .., in order: views
        where they lie in one piece, else copies."""
        n = int(self.len[t]) - lo if n is None else n
        spans = self._spans(t, lo, n)
        if len(spans) == 1:
            return self.edges[t, spans[0]], self.expiry[t, spans[0]]
        return (np.concatenate([self.edges[t, sp] for sp in spans]),
                np.concatenate([self.expiry[t, sp] for sp in spans]))

    def append(self, t: int, E: np.ndarray, X: np.ndarray) -> None:
        n = len(E)
        if self.len[t] + n > self.cap:
            raise RuntimeError(f"tenant {t}'s window ring overflows its {self.cap} rows")
        at = 0
        for sp in self._spans(t, int(self.len[t]), n):
            k = sp.stop - sp.start
            self.edges[t, sp] = E[at:at + k]
            self.expiry[t, sp] = X[at:at + k]
            at += k
        self.len[t] += n

    def count_below(self, t: int, clock: int) -> int:
        """The rows with expiry < clock, for a ring whose expiry rises in
        ring order (window mode): a prefix, found by bisection."""
        n = 0
        for sp in self._spans(t, 0, int(self.len[t])):
            x = self.expiry[t, sp]
            k = int(np.searchsorted(x, clock, side="left"))
            n += k
            if k < len(x):
                break
        return n

    def drop_oldest(self, t: int, n: int) -> None:
        self.head[t] = (self.head[t] + n) % self.cap
        self.len[t] -= n

    def load(self, t: int, E: np.ndarray, X: np.ndarray) -> None:
        """Replace tenant t's ring by rows E, X (from the buffer start)."""
        self.head[t], self.len[t] = 0, 0
        self.append(t, E, X)


class TriangleCountEngine:
    """Streaming triangle counter for a bank of tenants (see module
    docstring)."""

    def __init__(self, config: EngineConfig, mesh: Any = None):
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(config.device)
        if mesh is not None:
            if any(d.type != self.device.type for d in mesh.devices):
                raise ValueError(f"mesh devices {[str(d) for d in mesh.devices]} are not "
                                 f"of the engine's device type {self.device.type!r}")
            self.device = mesh.devices[0]
        self.scheme: EstimatorScheme = config.resolved_scheme()
        self._ingest_backend = resolve_ingest_backend(config.ingest, self.device)
        self._search = resolve_multisearch_backend(config.multisearch, self.device)
        self.plan: BackendPlan = select_backend(config, mesh)
        self._update = self.plan.build(config, mesh, self.scheme)
        self._update_chunk = (self.plan.build_chunk(config, mesh, self.scheme)
                              if config.chunk_size > 1 else None)
        # a lone batch as a one-batch chunk: on the kernel ingest backend the
        # single plan's chunk update draws in registers (fused_ingest) where
        # the per-batch update issues ~1,850 int64 operations. K = 1 is
        # bulk_update_all under fold_in(key, step), bit for bit; the other
        # plans keep the per-batch route until that is shown for them
        self._update_one = (self.plan.build_chunk(config, mesh, self.scheme)
                            if self._ingest_backend == "kernel" and self.plan.name == "single"
                            else None)
        self.batches_as_chunk = 0  # batches ingest() sent through _update_one
        self._delete = None  # the plan's deletion update, built on first use
        self._step = 0  # batches ingested so far: the RNG fold_in counter
        self._dyn_step = 0  # signed batches applied (inserts and deletions)
        self.diag = EngineDiagnostics(backend=self.plan.name)
        self._pending_overflow: list = []  # shardmap's device scalars, drained lazily
        # the window/decay clock: each tenant's insertions so far (equal to
        # its m_seen, kept on the host so no expiry check waits on the
        # device), and in window/decay mode each tenant's ring of live rows:
        # edges as inserted and each one's expiry position (dead once below
        # its tenant's clock). A ring holds at most the window (or TTL cap)
        # after a flush, plus what one ingest adds before the next
        self._dynamic = bool(config.window or config.decay)
        self._inserted = np.zeros((config.n_tenants,), np.int64)
        self._rings = (_Rings(config.n_tenants, self._window_capacity()
                              + config.chunk_size * config.batch_size)
                       if self._dynamic else None)
        self._root_key = torch.stack(
            [rng.PRNGKey(seed, self.device) for seed in config.tenant_seeds()])
        self._state = self._place(self.scheme.init_state(
            config.r, self.device, config.n_tenants if self.plan.banked else None))
        # the device-resident query (None on single and where the scheme's
        # estimate does not shard: estimate() then gathers)
        self._estimate_device = (self.plan.build_estimate(config, mesh, self.scheme)
                                 if self.plan.build_estimate is not None else None)
        self._query_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        # per-step estimate cache {step: answer}: an ingest leaves the previous
        # answer addressable for stale serving (cached_estimate); deletions and
        # restores clear it, as they change the state without a step
        self._est_cache: dict[int, np.ndarray] = {}
        # chunks are staged on a side stream where every shard is on the
        # engine's device (one card)
        one_device = mesh is None or all(d == self.device for d in mesh.devices)
        self._copy_stream = (
            torch.cuda.Stream(self.device)
            if self.device.type == "cuda" and one_device else None
        )

    def _place(self, state: EstimatorState):
        """A full state laid out as the plan keeps it: one state on the
        engine's device, or a ShardedState through the plan's layout (each
        shard's block copied to its device once)."""
        if self.plan.bank_sharding is None:
            return EstimatorState(*(x.to(self.device) for x in state))
        layout = self.plan.bank_sharding(self.config, self.mesh)
        return ShardedState(layout.shard(state), layout)

    def _bank(self, device) -> EstimatorState:
        """The whole bank (tenant axis first) on ``device``: gathered from
        the shards on a sharded plan."""
        st = self._state
        if isinstance(st, ShardedState):
            st = st.gather(device)
        else:
            st = EstimatorState(*(x.to(device) for x in st))
        if not self.plan.banked:
            st = EstimatorState(*(x[None] for x in st))
        return st

    @property
    def step(self) -> int:
        """Batches ingested (the RNG fold_in cursor)."""
        return self._step

    @property
    def dyn_step(self) -> int:
        """Signed batches applied (inserts and deletions): the resume cursor
        of a signed stream, equal to ``step`` on an insertion-only one."""
        return self._dyn_step

    @property
    def n_tenants(self) -> int:
        return self.config.n_tenants

    @property
    def state(self) -> EstimatorState:
        """The bank: every field leads with the tenant axis (on a sharded
        plan gathered from the shards to the engine's first device)."""
        if isinstance(self._state, ShardedState) or not self.plan.banked:
            return self._bank(self.device)
        return self._state

    def edges_seen(self) -> np.ndarray:
        """(n_tenants,) int64: stream length ingested per tenant."""
        st = self._state
        if isinstance(st, ShardedState):
            m = torch.cat([st.shards[g[0]].m_seen.reshape(-1).cpu()
                           for g in st.layout.e_groups()])
        else:
            m = st.m_seen.reshape(-1).cpu()
        return np.broadcast_to(m.numpy().astype(np.int64), (self.n_tenants,)).copy()

    # -- host -> device ------------------------------------------------------
    def _upload(self, arr: np.ndarray, device=None) -> torch.Tensor:
        """Copy a host array (a broadcast view too) to ``device`` (the
        engine's by default) through a pinned buffer without blocking the
        host (a plain copy on the CPU)."""
        with span("engine.upload"):
            arr = np.asarray(arr)
            device = self.device if device is None else torch.device(device)
            if device.type == "cpu":
                return torch.from_numpy(np.array(arr, order="C"))
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            pinned = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
            np.copyto(pinned.numpy(), arr)
            return pinned.to(device, non_blocking=True)

    def _put(self, arr: np.ndarray, sharding) -> list:
        """A host array's per-shard blocks through a plan's input layout,
        each block uploaded once to its device."""
        return sharding(self.config, self.mesh).put(np.asarray(arr), self._upload)

    def _pad(self, W: np.ndarray) -> tuple[np.ndarray, int]:
        s = self.config.batch_size
        W = np.asarray(W, dtype=np.int32)
        if W.ndim != 2 or W.shape[1] != 2:
            raise ValueError(f"a tenant's batch must be (s, 2), got {W.shape}")
        n = W.shape[0]
        if n > s:
            raise ValueError(f"batch of {n} edges exceeds batch_size={s}")
        if n < s:
            W = np.concatenate([W, np.zeros((s - n, 2), np.int32)])
        return W, n

    def _bank_batch(self, W, n_valid) -> tuple[np.ndarray, np.ndarray]:
        """A batch for every tenant, (T, s, 2) int32, and the valid counts,
        (T,) int64: ``W`` (<=s, 2) broadcast to every tenant, or
        (T, <=s, 2) one batch each; ``n_valid`` (a scalar, or (T,) for
        per-tenant batches) overrides the inferred counts when W is
        pre-padded."""
        W = np.asarray(W)
        T = self.n_tenants
        if W.ndim == 2:
            Wp, n = self._pad(W)
            n = n if n_valid is None else int(np.asarray(n_valid).reshape(-1)[0])
            return np.broadcast_to(Wp[None], (T,) + Wp.shape), np.full((T,), n, np.int64)
        if W.ndim != 3:
            raise ValueError(f"W must be (s, 2) or (T, s, 2), got {W.shape}")
        if W.shape[0] != T:
            raise ValueError(f"got {W.shape[0]} tenant batches for {T} tenants")
        padded = [self._pad(W[t]) for t in range(T)]
        Wb = np.stack([p[0] for p in padded])
        if n_valid is None:
            return Wb, np.array([p[1] for p in padded], np.int64)
        return Wb, np.broadcast_to(np.asarray(n_valid, np.int64).reshape(-1), (T,)).copy()

    def _counts(self, nv: np.ndarray):
        """The batch counts as the update takes them: one int where every
        tenant has the same count, else a (T,) tensor on the device."""
        return int(nv[0]) if (nv == nv[0]).all() else self._upload(nv.astype(np.int32))

    # -- ingestion -----------------------------------------------------------
    def ingest(self, W: np.ndarray, n_valid: Optional[Any] = None) -> None:
        """Fold one batch into every tenant's estimators: W (<=s, 2) int32,
        broadcast to every tenant, or (T, <=s, 2), a batch per tenant;
        ``n_valid`` (a scalar or (T,)) overrides the inferred counts when W
        is pre-padded."""
        check_fault("engine.ingest")  # before any conversion or state change
        Wb, nv = self._bank_batch(W, n_valid)
        if self._update_one is not None:
            out = self._update_one(self._state, self._upload(Wb)[:, None],
                                   self._upload(nv.astype(np.int32)[:, None]),
                                   self._root_key, self._step)
            self.batches_as_chunk += 1
        else:
            keys = rng.fold_in(self._root_key, self._step)
            if not self.plan.banked:  # the single-tenant sharded plans
                out = self._update(self._state, self._put(Wb[0], self.plan.batch_w_sharding),
                                   int(nv[0]), keys[0])
            elif self.plan.batch_w_sharding is not None:
                out = self._update(self._state, self._put(Wb, self.plan.batch_w_sharding),
                                   self._counts(nv), keys)
            else:
                out = self._update(self._state, self._upload(Wb), self._counts(nv), keys)
        if self.plan.reports_overflow:
            # kept on the device and drained every few batches, so the host
            # never waits on the device per batch; an escalation lands a few
            # batches late, and the state stays a valid NBSI realisation
            self._state, overflow = out
            self._pending_overflow.append(overflow)
            if len(self._pending_overflow) >= 8:
                self._drain_overflow()
        else:
            self._state = out
        self._step += 1
        self._dyn_step += 1
        self.diag.batches_ingested += 1
        self.diag.edges_ingested += int(nv.max())
        self._track_inserts(Wb, nv)
        self._flush_expired()

    def _drain_overflow(self) -> None:
        if not self._pending_overflow:
            return
        pending, self._pending_overflow = self._pending_overflow, []
        total = sum(int(o) for o in pending)
        if total > 0:
            self._escalate_capacity(total)

    def _escalate_capacity(self, overflow: int) -> None:
        """Hot vertices overflowed a routing bucket (those queries answered
        0, so the state stays a valid NBSI realisation that lost their
        samples' contribution): double the buckets for later batches and
        rebuild the update. The state is untouched."""
        self.diag.overflow_batches += 1
        self.diag.capacity_escalations += 1
        self.config = replace(self.config, capacity_factor=self.config.capacity_factor * 2.0)
        self._update = self.plan.build(self.config, self.mesh, self.scheme)

    def stage_chunk(self, Ws, n_valids=None) -> StagedChunk:
        """Upload a K-batch superbatch ahead of ``ingest_chunk``: (K, s, 2),
        broadcast to every tenant, or (T, K, s, 2); ``n_valids`` (K,) or
        (T, K), or one count for every batch, defaults to all-full. On CUDA
        the copy of the whole (T, K, s, 2) superbatch is issued on a side
        stream from a pinned buffer, so it overlaps the chunk the device is
        computing."""
        K, s, T = self.config.chunk_size, self.config.batch_size, self.n_tenants
        if self._update_chunk is None:
            raise ValueError("chunked ingest needs EngineConfig(chunk_size > 1) on a banked "
                             "plan ('single' or 'banked_pjit_*')")
        arr = np.asarray(Ws, dtype=np.int32)
        if arr.ndim == 3 and arr.shape == (K, s, 2):
            arr = np.broadcast_to(arr[None], (T, K, s, 2))
        if arr.shape != (T, K, s, 2):
            raise ValueError(f"chunk must be ({K}, {s}, 2) or ({T}, {K}, {s}, 2), "
                             f"got {arr.shape}")
        check_fault("engine.stage_chunk")  # before the upload: nothing issued yet
        nv_host = np.full((T, K), s, np.int64) if n_valids is None else (
            np.asarray(n_valids, np.int64))
        try:  # a scalar counts for every batch, (K,) for every tenant
            nv_host = np.broadcast_to(nv_host, (T, K)).copy()
        except ValueError:
            raise ValueError(f"n_valids must hold {K} counts or ({T}, {K}), "
                             f"got {nv_host.shape}") from None
        nv = nv_host.astype(np.int32)
        # max over tenants per batch, summed over K: what K ingest() calls count
        edges = int(nv_host.max(axis=0).sum())
        host = {"W_host": arr if self._dynamic else None, "nv_host": nv_host}

        def upload():
            if self.plan.chunk_w_sharding is not None:  # host -> shards, a copy each
                return self._put(arr, self.plan.chunk_w_sharding), self._upload(nv)
            return self._upload(arr), self._upload(nv)

        if self._copy_stream is None:
            return StagedChunk(*upload(), edges, **host)
        with torch.cuda.stream(self._copy_stream):
            Wb, nvb = upload()
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return StagedChunk(Wb, nvb, edges, ready, **host)

    def ingest_chunk(self, Ws, n_valids=None) -> None:
        """Fold ``chunk_size`` batches in one update (the scheme's
        ``chunk_update``); bit-for-bit equal to that many ``ingest`` calls.
        Accepts what ``stage_chunk`` accepts, or a ``StagedChunk``. In
        window/decay mode the expiry flush runs once after the chunk, as in
        the reference, so a windowed chunked run equals the reference's at
        the same K (and per-batch ingest only in distribution)."""
        check_fault("engine.ingest_chunk")  # before staging and any state change
        c = Ws if isinstance(Ws, StagedChunk) else self.stage_chunk(Ws, n_valids)
        if c.ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(c.ready)
            for t in (c.Wb if isinstance(c.Wb, list) else [c.Wb]) + [c.nv]:
                t.record_stream(cur)
        self._state = self._update_chunk(self._state, c.Wb, c.nv, self._root_key, self._step)
        K = self.config.chunk_size
        self._step += K
        self._dyn_step += K
        self.diag.batches_ingested += K
        self.diag.edges_ingested += c.edges
        for k in range(K):
            self._track_inserts(None if c.W_host is None else c.W_host[:, k], c.nv_host[:, k])
        self._flush_expired()

    def ingest_stream(self, batch_iter: Iterable[tuple[np.ndarray, int]]) -> int:
        """Drain a ``(W, n_valid)`` iterator: K-batch chunks where
        ``chunk_size > 1`` (the next one staged while the current one
        computes), the ragged tail batch by batch. Returns batches ingested."""
        from repro_torch.data.prefetch import superbatches

        K = self.config.chunk_size
        n = 0
        if K <= 1:
            for W, nv in batch_iter:
                self.ingest(W, nv)
                n += 1
            return n
        pending: Optional[StagedChunk] = None
        for kind, payload in superbatches(batch_iter, K, self.config.batch_size):
            if pending is not None:
                self.ingest_chunk(pending)
                n += K
                pending = None
            if kind == "chunk":
                pending = self.stage_chunk(*payload)
            else:
                self.ingest(*payload)
                n += 1
        if pending is not None:
            self.ingest_chunk(pending)
            n += K
        return n

    def sync(self) -> None:
        """Block until all dispatched work has completed on the devices."""
        self._drain_overflow()
        if self.device.type == "cuda":
            for dev in (self.mesh.devices if self.mesh is not None else (self.device,)):
                torch.cuda.synchronize(dev)

    # -- turnstile deletions / windowed expiry -------------------------------
    def _apply_delete(self, Db: np.ndarray, nv: np.ndarray) -> None:
        """Fold one padded (T, s, 2) deletion batch with its (T,) counts into
        the bank through the scheme's ``delete_update``. Internal: the
        explicit ``delete`` and the window clock's flush both come here;
        neither ``dyn_step`` nor the ring is touched."""
        if self._delete is None:
            self._delete = self.plan.build_delete(self.config, self.mesh, self.scheme)
        if self.plan.banked:
            self._state = self._delete(self._state, self._upload(Db), self._counts(nv))
        else:
            self._state = self._delete(self._state, self._upload(Db[0]), int(nv[0]))
        self._est_cache = {}  # the state changed without a step: cached answers are stale

    def delete(self, D: np.ndarray, n_valid: Optional[Any] = None) -> None:
        """Turnstile-delete one batch of edges from every tenant: (<=s, 2),
        broadcast to every tenant, or (T, <=s, 2), as ``ingest`` takes W.
        Each edge must be live (inserted and not yet deleted or expired),
        the single-live-copy contract of ``core.bulk.bulk_delete_update``.
        Draws no randomness and leaves ``step`` as it is; advances
        ``dyn_step``."""
        Db, nv = self._bank_batch(D, n_valid)
        self._apply_delete(Db, nv)
        if self._dynamic:
            self._forget_window(Db, nv)
        self._dyn_step += 1
        self.diag.delete_batches += 1
        self.diag.edges_deleted += int(nv.max())

    def ingest_signed_stream(self, batch_iter: Iterable) -> int:
        """Drain a signed batch iterator (``graph_stream.signed_batches``):
        ``(W, n_valid)`` pairs or ``(W, n_valid, sign)`` triples, sign +1 or
        -1. Each run of inserts goes through ``ingest_stream`` (chunked,
        staged), so an all-insert signed stream is the insertion path bit for
        bit; deletions apply between runs in stream order. Returns the
        batches applied (the ``dyn_step`` delta)."""
        it = iter(batch_iter)
        lookahead: list = []  # the deletion that ended an insert run

        def insert_run():
            while True:
                if lookahead:
                    item = lookahead.pop()
                else:
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                if len(item) > 2 and int(item[2]) < 0:
                    lookahead.append(item)
                    return
                yield item[0], item[1]

        n = 0
        while True:
            n += self.ingest_stream(insert_run())
            if not lookahead:
                return n
            W, nv, _sign = lookahead.pop()
            self.delete(W, nv)
            n += 1

    def _window_capacity(self) -> int:
        """The most live rows the ring holds after a flush, and the
        snapshot's window-array width: the window, or the decay TTL cap."""
        if self.config.window:
            return self.config.window
        from repro_torch.data.graph_stream import decay_cap

        return decay_cap(self.config.decay)

    def _track_inserts(self, W: Optional[np.ndarray], nv) -> None:
        """Advance each tenant's insertion clock past one applied batch (W
        (T, s, 2), nv (T,)); in window or decay mode also append tenant t's
        rows to its ring with their expiry positions (insert position +
        window, or + the edge's TTL drawn from tenant t's seed)."""
        nv = np.broadcast_to(np.asarray(nv, np.int64).reshape(-1), (self.n_tenants,))
        if not self._dynamic:
            self._inserted += nv
            return
        from repro_torch.data.graph_stream import decay_ttls

        seeds = self.config.tenant_seeds()
        for t in range(self.n_tenants):
            n, start = int(nv[t]), int(self._inserted[t])
            if n == 0:
                continue
            pos = start + np.arange(n, dtype=np.int64)
            if self.config.window:
                exp = pos + self.config.window
            else:
                exp = pos + decay_ttls(seeds[t], start, n, self.config.decay)
            self._rings.append(t, W[t, :n], exp)
            self._inserted[t] = start + n

    def _flush_expired(self) -> None:
        """Delete every ring row its tenant's clock has passed (expiry <
        insertions so far), as the reference does: in rounds, each taking
        every tenant's next <= s expired rows in ring order into one
        (T, s, 2) batch, until none is left. In window mode expiry rises
        along a ring, so the dead rows are its oldest and the head moves
        past them; in decay mode a mask picks them and the ring compacts
        once. No-op when nothing expired."""
        if not self._dynamic:
            return
        rings, expired = self._rings, []
        for t in range(self.n_tenants):
            clock = int(self._inserted[t])
            if self.config.window:
                d = rings.count_below(t, clock)
                expired.append(rings.rows(t, 0, d)[0])
                rings.drop_oldest(t, d)
            else:
                E, X = rings.rows(t)
                dead = X < clock
                expired.append(E[dead])
                if len(expired[-1]):
                    rings.load(t, E[~dead], X[~dead])
        total = sum(len(e) for e in expired)
        if total == 0:
            return
        self.diag.window_expired += total
        s, T = self.config.batch_size, self.n_tenants
        for lo in range(0, max(len(e) for e in expired), s):
            Db = np.zeros((T, s, 2), np.int32)
            nv = np.zeros((T,), np.int64)
            for t, e in enumerate(expired):
                take = e[lo:lo + s]
                Db[t, : len(take)] = take
                nv[t] = len(take)
            self._apply_delete(Db, nv)

    def _forget_window(self, Db: np.ndarray, nv: np.ndarray) -> None:
        """Drop explicitly deleted edges (Db (T, s, 2), nv (T,)) from their
        tenants' rings, matching on the canonical (min, max) pair, so the
        clock never authors a second deletion for them."""
        for t in range(self.n_tenants):
            n = int(nv[t])
            if n == 0 or self._rings.len[t] == 0:
                continue
            E, X = self._rings.rows(t)
            keep = ~np.isin(_edge_keys(E), _edge_keys(Db[t, :n]))
            if not keep.all():
                self._rings.load(t, E[keep], X[keep])

    # -- queries -------------------------------------------------------------
    def estimate(self, *, gather: bool = False, timeout_s: Optional[float] = None) -> np.ndarray:
        """Per-tenant estimates, one query for the whole bank, cached per
        step: (T,) float64 for the scalar schemes (the median of means),
        (T, n_vertices) float64 per-vertex counts for ``local``.

        On a sharded plan the query runs where the shards live (the plan's
        device-resident query: per-shard partials and a fixed-order
        combine), bit-identical to the gather oracle, which ``gather=True``
        forces: it gathers the shards to the engine's first device and
        answers as ``single`` does, bypassing the cache. ``timeout_s``
        bounds the device-resident query; on its expiry, or a fault at the
        ``engine.estimate`` site, the query falls back to the oracle,
        counted in ``diag.query_fallbacks`` (and ``diag.query_timeouts``).
        ``single`` has no device-resident query, so ``timeout_s`` has no
        effect there. Counted in ``diag.queries_answered`` and, from the
        cache, ``diag.query_cache_hits``."""
        self._drain_overflow()
        if not gather:
            cached = self._est_cache.get(self._step)
            if cached is not None:
                self.diag.queries_answered += 1
                self.diag.query_cache_hits += 1
                return cached
        out = None
        if not gather and self._estimate_device is not None:
            try:
                out = self._query_device(timeout_s)
                if not self.plan.banked:
                    out = out[None]
            except (FaultInjected, TimeoutError) as e:
                # degrade to the gather oracle below rather than fail the query
                if isinstance(e, TimeoutError):
                    self.diag.query_timeouts += 1
                self.diag.query_fallbacks += 1
                out = None
        if out is None:
            bank = self._state if self.plan.bank_sharding is None else self._bank(self.device)
            with span("query.compute"):
                est = self.scheme.estimate(bank, self.config.groups,
                                           backend=self._ingest_backend)
            with span("query.to_host"):
                out = est.to(torch.float64).cpu().numpy()
        self.diag.queries_answered += 1
        if not gather:
            self._est_cache = {self._step: out}
        return out

    def _query_device(self, timeout_s: Optional[float]) -> np.ndarray:
        """The device-resident query, bounded by ``timeout_s`` where given:
        it runs on a worker thread, which goes on past the deadline (a
        device query cannot be cancelled); the caller stops waiting."""

        def call() -> np.ndarray:
            check_fault("engine.estimate")  # the device dispatch's fault site
            with span("query.compute"):
                est = self._estimate_device(self._state)
            with span("query.to_host"):
                return est.to(torch.float64).cpu().numpy()

        if timeout_s is None:
            return call()
        if self._query_pool is None:
            self._query_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="engine-query")
        fut = self._query_pool.submit(call)
        try:
            return fut.result(timeout=timeout_s)
        except concurrent.futures.TimeoutError:
            raise TimeoutError(f"device query exceeded {timeout_s:.3f}s") from None

    def cached_estimate(self) -> Optional[tuple[int, np.ndarray]]:
        """The newest cached answer as ``(answer_step, estimates)``, or None
        where nothing is cached; never queries. The service loops serve it
        under backpressure, tagged with its age ``step - answer_step``."""
        if not self._est_cache:
            return None
        s = max(self._est_cache)
        return s, self._est_cache[s]

    def estimate_tenant(self, tenant: int = 0):
        """One tenant's estimate: a float for scalar schemes, else an array,
        served from the per-step cache."""
        e = self.estimate()[tenant]
        return float(e) if np.ndim(e) == 0 else e

    def estimate_tenants(self, tenants: Iterable[int]) -> np.ndarray:
        """Rows of ``estimate()`` for the given tenant ids, from the one
        cached bank query."""
        return self.estimate()[np.asarray(list(tenants), dtype=np.int64)]

    # -- snapshot / restore --------------------------------------------------
    def snapshot(self) -> dict:
        """The engine as a flat dict of host numpy arrays, in the JAX
        engine's format: state fields with a leading tenant axis,
        ``root_keys`` (T, 2) uint32, ``step``, ``dyn_step``, ``config`` =
        [r, batch_size, n_tenants] and ``scheme``; in window/decay mode also
        the ring, ``window_edges`` (T, C, 2) int32, ``window_expiry`` (T, C)
        int64 (-1 padding) and ``window_len`` (T,) int64, C the window or
        the decay TTL cap."""
        self._drain_overflow()
        self._flush_expired()  # no dead edge outlives the snapshot
        bank = self._bank(torch.device("cpu"))
        snap = {f: getattr(bank, f).numpy() for f in _STATE_FIELDS}
        snap["root_keys"] = self._root_key.cpu().numpy().astype(np.uint32)
        snap["step"] = np.int64(self._step)
        snap["dyn_step"] = np.int64(self._dyn_step)
        snap["config"] = np.array(
            [self.config.r, self.config.batch_size, self.config.n_tenants], np.int64)
        snap["scheme"] = np.array(self.scheme.name)
        if self._dynamic:
            # the rings at fixed capacity, so checkpoint templates have one shape
            T, C = self.n_tenants, self._window_capacity()
            snap["window_edges"] = np.zeros((T, C, 2), np.int32)
            snap["window_expiry"] = np.full((T, C), -1, np.int64)
            snap["window_len"] = self._rings.len.copy()
            for t in range(T):
                E, X = self._rings.rows(t)
                snap["window_edges"][t, : len(E)] = E
                snap["window_expiry"][t, : len(X)] = X
        return snap

    # the reference's name for the whole-bank snapshot (its elastic tests
    # compare a tenant's snapshot with it)
    bank_snapshot = snapshot

    def restore(self, snap: dict) -> None:
        """Restore from a snapshot dict of either engine. ``r`` and
        ``n_tenants`` must match; ``batch_size`` may differ (the state does
        not depend on it). The scheme must match too; a snapshot without a
        ``scheme`` key is ``global``. A window/decay engine needs the
        snapshot's ring at its own capacity; a windowed snapshot restores into
        an insertion-only engine, whose edges then stop expiring."""
        got = _snapshot_config(snap)
        want = (self.config.r, self.config.batch_size, self.config.n_tenants)
        if (got[0], got[2]) != (want[0], want[2]):
            raise SnapshotMismatch(f"snapshot (r, batch_size, n_tenants)={got} != engine {want}")
        scheme = str(np.asarray(snap.get("scheme", "global")))
        if scheme != self.scheme.name:
            raise SnapshotMismatch(
                f"snapshot was written by scheme {scheme!r}; this engine runs "
                f"{self.scheme.name!r} (pass scheme={scheme!r} or use "
                "from_snapshot, which adopts the snapshot's scheme)")
        if self._dynamic:
            if "window_edges" not in snap:
                raise SnapshotMismatch(
                    "engine runs a window/decay mode but the snapshot has no window "
                    "state (taken by an insertion-only engine?); the live-edge ring "
                    "cannot be reconstructed")
            we = np.asarray(snap["window_edges"])
            shape = (self.config.n_tenants, self._window_capacity(), 2)
            if we.shape != shape:
                raise SnapshotMismatch(
                    f"snapshot window state {we.shape} != engine capacity {shape}: the "
                    "snapshot was taken under a different window/decay configuration")
            wx = np.asarray(snap["window_expiry"])
            wl = np.asarray(snap["window_len"]).reshape(-1)
        T, r = self.n_tenants, self.config.r
        shapes = {"f1": (T, r, 2), "chi": (T, r), "f2": (T, r, 2), "has_f3": (T, r),
                  "m_seen": (T,), "root_keys": (T, 2)}
        for f, shape in shapes.items():
            if np.shape(snap[f]) != shape:
                raise SnapshotMismatch(f"snapshot {f} has shape {np.shape(snap[f])}, "
                                       f"engine needs {shape}")
        dtypes = {"f1": torch.int32, "chi": torch.int32, "f2": torch.int32,
                  "has_f3": torch.bool, "m_seen": torch.int64}
        host = EstimatorState(**{
            f: torch.from_numpy(np.array(np.asarray(snap[f]))).to(dtype=dtypes[f])
            for f in _STATE_FIELDS
        })
        if not self.plan.banked:
            host = EstimatorState(*(x[0] for x in host))
        # undrained overflow scalars describe batches before the restore:
        # draining them later would escalate for a stream this state never saw
        if self._pending_overflow:
            self.diag.pending_overflow_dropped += len(self._pending_overflow)
            self._pending_overflow = []
        self._state = self._place(host)  # host -> shards directly
        keys = np.asarray(snap["root_keys"]).astype(np.int64)
        self._root_key = torch.from_numpy(keys).to(self.device)
        self._step = int(snap["step"])
        self._dyn_step = int(snap.get("dyn_step", snap["step"]))
        self._est_cache = {}
        # deletions never touch m_seen, so the clock restores from the state
        self._inserted = np.asarray(snap["m_seen"], np.int64).reshape(T).copy()
        if self._dynamic:
            for t in range(T):
                n = int(wl[t])
                self._rings.load(t, we[t, :n], wx[t, :n])

    @classmethod
    def from_snapshot(cls, snap: dict, *, batch_size: Optional[int] = None, mesh: Any = None,
                      **config_kwargs) -> "TriangleCountEngine":
        r, s, t = _snapshot_config(snap)
        if "scheme" not in config_kwargs and "scheme" in snap:
            # adopt the snapshot's scheme; the local scheme's params still
            # come from the caller
            config_kwargs["scheme"] = str(np.asarray(snap["scheme"]))
        cfg = EngineConfig(r=r, batch_size=batch_size if batch_size is not None else s,
                           n_tenants=t, **config_kwargs)
        eng = cls(cfg, mesh=mesh)
        eng.restore(snap)
        return eng
