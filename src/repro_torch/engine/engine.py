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

The port runs one tenant and insertion-only streams; asking for more raises
``NotImplementedError`` naming the ROADMAP item that brings it. The engine
runs on the card unless ``device="cpu"``.
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
        if self.n_tenants != 1:
            raise NotImplementedError(
                "the port runs one tenant; banks of tenants come with ROADMAP "
                "A.10, 'Multi-tenant banks'")
        self.resolved_scheme()
        if self.window or self.decay:
            raise NotImplementedError(
                "window/decay streams come with ROADMAP A.12, 'Dynamic streams'")
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
class StagedChunk:
    """A K-batch superbatch already on the engine's device (``stage_chunk``).
    On CUDA the upload runs on a side stream; ``ready`` is the event the
    ingest waits for."""

    Wb: torch.Tensor  # (K, s, 2) int32
    nv: torch.Tensor  # (K,) int32
    edges: int  # total valid edges (host-side)
    ready: Any = field(default=None, repr=False)


def _snapshot_config(snap: dict) -> tuple:
    return tuple(int(x) for x in np.asarray(snap["config"]).tolist())


class TriangleCountEngine:
    """Streaming triangle counter for one tenant (see module docstring)."""

    def __init__(self, config: EngineConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self.scheme: EstimatorScheme = config.resolved_scheme()
        self._ingest_backend = resolve_ingest_backend(config.ingest, self.device)
        self._search = resolve_multisearch_backend(config.multisearch, self.device)
        self._step = 0  # batches ingested so far: the RNG fold_in counter
        self._dyn_step = 0
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

    def stage_chunk(self, Ws, n_valids=None) -> StagedChunk:
        """Upload a K-batch superbatch ((K, s, 2), or (1, K, s, 2)) ahead of
        ``ingest_chunk``; ``n_valids`` (K,) defaults to all-full. On CUDA the
        copy is issued on a side stream from a pinned buffer, so it overlaps
        the chunk the device is computing."""
        K, s = self.config.chunk_size, self.config.batch_size
        if K <= 1:
            raise ValueError("chunked ingest needs EngineConfig(chunk_size > 1)")
        arr = np.asarray(Ws, dtype=np.int32)
        if arr.ndim == 4 and arr.shape[0] == 1:
            arr = arr[0]
        if arr.shape != (K, s, 2):
            raise ValueError(f"chunk must be ({K}, {s}, 2), got {arr.shape}")
        nv = np.full((K,), s, np.int32) if n_valids is None else (
            np.asarray(n_valids, np.int32).reshape(-1))
        if nv.shape != (K,):
            raise ValueError(f"n_valids must hold {K} counts, got {nv.shape}")
        if self._copy_stream is None:
            return StagedChunk(self._upload(arr), self._upload(nv), int(nv.sum()))
        with torch.cuda.stream(self._copy_stream):
            Wb, nvb = self._upload(arr), self._upload(nv)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return StagedChunk(Wb, nvb, int(nv.sum()), ready)

    def ingest_chunk(self, Ws, n_valids=None) -> None:
        """Fold ``chunk_size`` batches in one update (the scheme's
        ``chunk_update``); bit-for-bit equal to that many ``ingest`` calls.
        Accepts what ``stage_chunk`` accepts, or a ``StagedChunk``."""
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
        [r, batch_size, n_tenants] and ``scheme``."""
        snap = {f: getattr(self._state, f).cpu().numpy()[None] for f in _STATE_FIELDS}
        snap["root_keys"] = self._root_key.cpu().numpy().astype(np.uint32)[None]
        snap["step"] = np.int64(self._step)
        snap["dyn_step"] = np.int64(self._dyn_step)
        snap["config"] = np.array(
            [self.config.r, self.config.batch_size, self.config.n_tenants], np.int64)
        snap["scheme"] = np.array(self.scheme.name)
        return snap

    def restore(self, snap: dict) -> None:
        """Restore from a snapshot dict of either engine. ``r`` and
        ``n_tenants`` must match; ``batch_size`` may differ (the state does
        not depend on it). The scheme must match too; a snapshot without a
        ``scheme`` key is ``global``."""
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
