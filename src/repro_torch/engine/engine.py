"""TriangleCountEngine on the ``single`` plan (``repro.engine.engine``).

A long-lived streaming triangle counter for one tenant's edge stream:

  * ``ingest(W)`` folds one batch into the estimators;
  * ``stage_chunk`` / ``ingest_chunk`` fold K batches in one update, with
    the next chunk's upload staged while the current one computes;
  * ``estimate()`` answers the scheme's query, cached per ``step``;
  * ``snapshot()`` / ``restore()`` round-trip the whole engine (estimators and
    RNG cursor) through host numpy arrays, in the JAX engine's flat-dict
    format, so a snapshot from either engine restores into the other
    (``repro_torch.interop``).

RNG contract: batch i draws from ``fold_in(PRNGKey(seed), i)``; nothing else
carries random state, so chunked, per-batch and restored runs are
bit-identical to each other and to the JAX reference.

Schemes: ``EngineConfig.scheme`` names an estimator scheme
(``repro_torch.core.schemes``: ``global``, ``naive``, ``local``); the engine
initialises, ingests and answers queries through it, and a snapshot carries
the scheme's name, so restoring into an engine of another scheme raises
``SnapshotMismatch``.

Dynamic streams: ``delete(D)`` patches a batch of edge deletions out of the
estimators (``scheme.delete_update``: no randomness, ``step`` unchanged) and
``ingest_signed_stream`` drains a signed batch iterator. ``window=N`` keeps
only the newest N inserted edges live and ``decay=D`` gives each inserted
edge a deterministic geometric lifetime of mean D insertions; both keep a
host-side ring of live (edge, expiry) rows in insertion order and author
expiry deletion batches from it after every ingest (once per chunk on the
chunked path, as the reference does). Snapshots of such engines carry the
ring at fixed capacity (``window_edges``, ``window_expiry``,
``window_len``), in the reference's format.

The port runs one tenant; asking for more raises ``NotImplementedError``
naming the ROADMAP item that brings it. The engine runs on the card unless
``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

import numpy as np
import torch

from repro_torch import resolve_device, rng
from repro_torch.core.schemes import EstimatorScheme, resolve_scheme
from repro_torch.core.state import EstimatorState
from repro_torch.primitives.ingest import resolve_ingest_backend
from repro_torch.primitives.search import resolve_multisearch_backend

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
    scheme: str = "global"
    scheme_params: Optional[tuple] = None
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
        if self.n_tenants != 1:
            raise NotImplementedError(
                "the port runs one tenant; banks of tenants come with ROADMAP "
                "A.10, 'Multi-tenant banks'")
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
    """The reference's dynamic-stream counters (host-side, not part of the
    snapshot)."""

    delete_batches: int = 0  # explicit turnstile deletion batches applied
    edges_deleted: int = 0  # valid edges in those batches
    window_expired: int = 0  # edges expired by the window/decay clock


@dataclass
class StagedChunk:
    """A K-batch superbatch already on the engine's device (``stage_chunk``).
    On CUDA the upload runs on a side stream; ``ready`` is the event the
    ingest waits for. The host rows stay for the window clock (``W_host`` is
    None on an insertion-only engine)."""

    Wb: torch.Tensor  # (K, s, 2) int32
    nv: torch.Tensor  # (K,) int32
    edges: int  # total valid edges (host-side)
    ready: Any = field(default=None, repr=False)
    W_host: Optional[np.ndarray] = field(default=None, repr=False)  # (K, s, 2) int32
    nv_host: Optional[np.ndarray] = field(default=None, repr=False)  # (K,) int64


def _snapshot_config(snap: dict) -> tuple:
    return tuple(int(x) for x in np.asarray(snap["config"]).tolist())


def _edge_keys(E: np.ndarray) -> np.ndarray:
    """One int64 per undirected edge: (min << 32) | (max as uint32)."""
    E = np.asarray(E, np.int64)
    return (np.minimum(E[:, 0], E[:, 1]) << 32) | (np.maximum(E[:, 0], E[:, 1]) & 0xFFFFFFFF)


class TriangleCountEngine:
    """Streaming triangle counter for one tenant (see module docstring)."""

    def __init__(self, config: EngineConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self.scheme: EstimatorScheme = config.resolved_scheme()
        self._ingest_backend = resolve_ingest_backend(config.ingest, self.device)
        self._search = resolve_multisearch_backend(config.multisearch, self.device)
        self._step = 0  # batches ingested so far: the RNG fold_in counter
        self._dyn_step = 0  # signed batches applied (inserts and deletions)
        self.diag = EngineDiagnostics()
        # the window/decay clock: insertions so far (equal to m_seen, kept on
        # the host so no expiry check waits on the device), and the ring of
        # live rows in insertion order: edges (n, 2) int32 as inserted, and
        # each one's expiry position (dead once below the clock)
        self._dynamic = bool(config.window or config.decay)
        self._inserted = 0
        self._win_edges = np.zeros((0, 2), np.int32)
        self._win_expiry = np.zeros((0,), np.int64)
        self._root_key = rng.PRNGKey(config.tenant_seeds()[0], self.device)
        self._state = self.scheme.init_state(config.r, self.device)
        self._est_cache: dict[int, np.ndarray] = {}
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )

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
    def state(self) -> EstimatorState:
        return self._state

    def edges_seen(self) -> np.ndarray:
        """(n_tenants,) int64: stream length ingested."""
        return np.array([int(self._state.m_seen)], np.int64)

    # -- host -> device ------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Copy a host array to the device through a pinned buffer without
        blocking the host (a plain copy on the CPU)."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return host.clone()
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        return pinned.to(self.device, non_blocking=True)

    def _pad(self, W: np.ndarray) -> tuple[np.ndarray, int]:
        s = self.config.batch_size
        W = np.asarray(W, dtype=np.int32)
        if W.ndim == 3:
            if W.shape[0] != 1:
                raise ValueError(f"got {W.shape[0]} tenant batches for 1 tenant")
            W = W[0]
        if W.ndim != 2 or W.shape[1] != 2:
            raise ValueError(f"W must be (s, 2) or (1, s, 2), got {W.shape}")
        n = W.shape[0]
        if n > s:
            raise ValueError(f"batch of {n} edges exceeds batch_size={s}")
        if n < s:
            W = np.concatenate([W, np.zeros((s - n, 2), np.int32)])
        return W, n

    # -- ingestion -----------------------------------------------------------
    def ingest(self, W: np.ndarray, n_valid: Optional[Any] = None) -> None:
        """Fold one batch ((<=s, 2) int32, or (1, <=s, 2)) into the
        estimators; ``n_valid`` overrides the inferred count when W is
        pre-padded."""
        Wp, n = self._pad(W)
        nv = n if n_valid is None else int(np.asarray(n_valid).reshape(-1)[0])
        key = rng.fold_in(self._root_key, self._step)
        self._state = self.scheme.bulk_update(self._state, self._upload(Wp), nv, key,
                                              search=self._search)
        self._step += 1
        self._dyn_step += 1
        self._track_inserts(Wp, nv)
        self._flush_expired()

    def stage_chunk(self, Ws, n_valids=None) -> StagedChunk:
        """Upload a K-batch superbatch ((K, s, 2), or (1, K, s, 2)) ahead of
        ``ingest_chunk``; ``n_valids`` (K,), or one count for every batch,
        defaults to all-full. On CUDA the copy is issued on a side stream
        from a pinned buffer, so it overlaps the chunk the device is
        computing."""
        K, s = self.config.chunk_size, self.config.batch_size
        if K <= 1:
            raise ValueError("chunked ingest needs EngineConfig(chunk_size > 1)")
        arr = np.asarray(Ws, dtype=np.int32)
        if arr.ndim == 4 and arr.shape[0] == 1:
            arr = arr[0]
        if arr.shape != (K, s, 2):
            raise ValueError(f"chunk must be ({K}, {s}, 2), got {arr.shape}")
        nv_host = np.full((K,), s, np.int64) if n_valids is None else (
            np.asarray(n_valids, np.int64))
        if nv_host.ndim == 2 and nv_host.shape[0] == 1:
            nv_host = nv_host[0]
        if nv_host.shape not in ((), (1,), (K,)):
            raise ValueError(f"n_valids must hold {K} counts, got {nv_host.shape}")
        nv_host = np.broadcast_to(nv_host, (K,)).copy()  # a scalar counts for every batch
        nv = nv_host.astype(np.int32)
        host = {"W_host": arr if self._dynamic else None, "nv_host": nv_host}
        if self._copy_stream is None:
            return StagedChunk(self._upload(arr), self._upload(nv), int(nv.sum()), **host)
        with torch.cuda.stream(self._copy_stream):
            Wb, nvb = self._upload(arr), self._upload(nv)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return StagedChunk(Wb, nvb, int(nv.sum()), ready, **host)

    def ingest_chunk(self, Ws, n_valids=None) -> None:
        """Fold ``chunk_size`` batches in one update (the scheme's
        ``chunk_update``); bit-for-bit equal to that many ``ingest`` calls.
        Accepts what ``stage_chunk`` accepts, or a ``StagedChunk``. In
        window/decay mode the expiry flush runs once after the chunk, as in
        the reference, so a windowed chunked run equals the reference's at
        the same K (and per-batch ingest only in distribution)."""
        c = Ws if isinstance(Ws, StagedChunk) else self.stage_chunk(Ws, n_valids)
        if c.ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(c.ready)
            c.Wb.record_stream(cur)
            c.nv.record_stream(cur)
        self._state = self.scheme.chunk_update(
            self._state, c.Wb, c.nv, self._root_key, self._step,
            backend=self._ingest_backend, search=self._search)
        K = self.config.chunk_size
        self._step += K
        self._dyn_step += K
        for k in range(K):
            self._track_inserts(None if c.W_host is None else c.W_host[k], c.nv_host[k])
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
        """Block until all dispatched work has completed on the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- turnstile deletions / windowed expiry -------------------------------
    def _apply_delete(self, Dp: np.ndarray, n_valid: int) -> None:
        """Fold one padded (s, 2) deletion batch into the state through the
        scheme's ``delete_update``. Internal: the explicit ``delete`` and the
        window clock's flush both come here; neither ``dyn_step`` nor the
        ring is touched."""
        self._state = self.scheme.delete_update(self._state, self._upload(Dp), n_valid,
                                                search=self._search)
        self._est_cache = {}  # the state changed without a step: cached answers are stale

    def delete(self, D: np.ndarray, n_valid: Optional[Any] = None) -> None:
        """Turnstile-delete one batch of edges ((<=s, 2), or (1, <=s, 2)).
        Each edge must be live (inserted and not yet deleted or expired),
        the single-live-copy contract of ``core.bulk.bulk_delete_update``.
        Draws no randomness and leaves ``step`` as it is; advances
        ``dyn_step``."""
        Dp, n = self._pad(D)
        nv = n if n_valid is None else int(np.asarray(n_valid).reshape(-1)[0])
        self._apply_delete(Dp, nv)
        if self._dynamic:
            self._forget_window(Dp, nv)
        self._dyn_step += 1
        self.diag.delete_batches += 1
        self.diag.edges_deleted += nv

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

    def _track_inserts(self, W: Optional[np.ndarray], n_valid) -> None:
        """Advance the insertion clock past one applied batch; in window or
        decay mode also append its rows to the ring with their expiry
        positions (insert position + window, or + the edge's TTL)."""
        n = int(n_valid)
        start = self._inserted
        self._inserted = start + n
        if not self._dynamic or n == 0:
            return
        pos = start + np.arange(n, dtype=np.int64)
        if self.config.window:
            exp = pos + self.config.window
        else:
            from repro_torch.data.graph_stream import decay_ttls

            exp = pos + decay_ttls(self.config.tenant_seeds()[0], start, n, self.config.decay)
        self._win_edges = np.concatenate([self._win_edges, np.asarray(W[:n], np.int32)])
        self._win_expiry = np.concatenate([self._win_expiry, exp])

    def _flush_expired(self) -> None:
        """Delete every ring row the clock has passed (expiry < insertions
        so far), in ring order, in batches of at most s. No-op when nothing
        expired."""
        if not self._dynamic:
            return
        dead = self._win_expiry < self._inserted
        total = int(dead.sum())
        if total == 0:
            return
        expired = self._win_edges[dead]
        self._win_edges = self._win_edges[~dead]
        self._win_expiry = self._win_expiry[~dead]
        self.diag.window_expired += total
        s = self.config.batch_size
        for lo in range(0, total, s):
            take = expired[lo:lo + s]
            Dp = np.zeros((s, 2), np.int32)
            Dp[: len(take)] = take
            self._apply_delete(Dp, len(take))

    def _forget_window(self, Dp: np.ndarray, n_valid: int) -> None:
        """Drop explicitly deleted edges from the ring, so the clock never
        authors a second deletion for them."""
        if n_valid == 0 or len(self._win_edges) == 0:
            return
        keep = ~np.isin(_edge_keys(self._win_edges), _edge_keys(Dp[:n_valid]))
        self._win_edges = self._win_edges[keep]
        self._win_expiry = self._win_expiry[keep]

    # -- queries -------------------------------------------------------------
    def estimate(self) -> np.ndarray:
        """Estimates with a leading tenant axis, cached per step: (1,)
        float64 for the scalar schemes (the median of means), (1,
        n_vertices) float64 per-vertex counts for ``local``."""
        cached = self._est_cache.get(self._step)
        if cached is not None:
            return cached
        est = self.scheme.estimate(self._state, self.config.groups,
                                   backend=self._ingest_backend)
        out = est.to(torch.float64).cpu().numpy().reshape((1,) + tuple(est.shape))
        self._est_cache = {self._step: out}
        return out

    def estimate_tenant(self, tenant: int = 0):
        """One tenant's estimate: a float for scalar schemes, else an array,
        served from the per-step cache."""
        e = self.estimate()[tenant]
        return float(e) if np.ndim(e) == 0 else e

    # -- snapshot / restore --------------------------------------------------
    def snapshot(self) -> dict:
        """The engine as a flat dict of host numpy arrays, in the JAX
        engine's format: state fields with a leading tenant axis,
        ``root_keys`` (T, 2) uint32, ``step``, ``dyn_step``, ``config`` =
        [r, batch_size, n_tenants] and ``scheme``; in window/decay mode also
        the ring, ``window_edges`` (T, C, 2) int32, ``window_expiry`` (T, C)
        int64 (-1 padding) and ``window_len`` (T,) int64, C the window or
        the decay TTL cap."""
        self._flush_expired()  # no dead edge outlives the snapshot
        snap = {f: getattr(self._state, f).cpu().numpy()[None] for f in _STATE_FIELDS}
        snap["root_keys"] = self._root_key.cpu().numpy().astype(np.uint32)[None]
        snap["step"] = np.int64(self._step)
        snap["dyn_step"] = np.int64(self._dyn_step)
        snap["config"] = np.array(
            [self.config.r, self.config.batch_size, self.config.n_tenants], np.int64)
        snap["scheme"] = np.array(self.scheme.name)
        if self._dynamic:
            # the ring at fixed capacity, so checkpoint templates have one shape
            C, n = self._window_capacity(), len(self._win_edges)
            snap["window_edges"] = np.zeros((1, C, 2), np.int32)
            snap["window_edges"][0, :n] = self._win_edges
            snap["window_expiry"] = np.full((1, C), -1, np.int64)
            snap["window_expiry"][0, :n] = self._win_expiry
            snap["window_len"] = np.array([n], np.int64)
        return snap

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
        win_edges, win_expiry = np.zeros((0, 2), np.int32), np.zeros((0,), np.int64)
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
            n = int(np.asarray(snap["window_len"]).reshape(-1)[0])
            win_edges = we[0, :n].astype(np.int32)
            win_expiry = np.asarray(snap["window_expiry"])[0, :n].astype(np.int64)
        dtypes = {"f1": torch.int32, "chi": torch.int32, "f2": torch.int32,
                  "has_f3": torch.bool, "m_seen": torch.int64}
        self._state = EstimatorState(**{
            f: torch.from_numpy(np.array(np.asarray(snap[f])[0])).to(
                device=self.device, dtype=dtypes[f])
            for f in _STATE_FIELDS
        })
        keys = np.asarray(snap["root_keys"]).astype(np.int64)[0]
        self._root_key = torch.from_numpy(keys).to(self.device)
        self._step = int(snap["step"])
        self._dyn_step = int(snap.get("dyn_step", snap["step"]))
        self._est_cache = {}
        # deletions never touch m_seen, so the clock restores from the state
        self._inserted = int(np.asarray(snap["m_seen"]).reshape(-1)[0])
        self._win_edges, self._win_expiry = win_edges, win_expiry

    @classmethod
    def from_snapshot(cls, snap: dict, *, batch_size: Optional[int] = None,
                      **config_kwargs) -> "TriangleCountEngine":
        r, s, t = _snapshot_config(snap)
        if "scheme" not in config_kwargs and "scheme" in snap:
            # adopt the snapshot's scheme; the local scheme's params still
            # come from the caller
            config_kwargs["scheme"] = str(np.asarray(snap["scheme"]))
        cfg = EngineConfig(r=r, batch_size=batch_size if batch_size is not None else s,
                           n_tenants=t, **config_kwargs)
        eng = cls(cfg)
        eng.restore(snap)
        return eng
