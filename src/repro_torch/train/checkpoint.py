"""Verified checkpoints: an npz shard plus a manifest, written atomically,
keep-k, optionally asynchronous (``repro.train.checkpoint`` without jax).

  * A checkpoint is a directory ``step_<N>/`` holding ``shard_00000.npz`` and
    ``manifest.json``. Both are written into a ``.tmp_step_*`` staging
    directory that is renamed into place last, so a visible manifest means a
    complete checkpoint.
  * The manifest carries a sha256 checksum per array; ``restore`` verifies
    them and raises ``CheckpointCorrupt`` on a mismatch, a missing array or
    an unreadable file, so a bit-flipped shard is never restored (the stream
    service walks back to an older checkpoint instead).
  * Torn checkpoints (no manifest) are ignored and their staging directories
    swept, at start-up and after every save: saves are serialised, so any
    ``.tmp`` entry seen outside a write is an orphan.
  * In async mode a writer thread does the disk work; its error is re-raised
    by the next ``wait()``.

Arrays are named as ``jax.tree_util.tree_flatten_with_path`` names a tree
of dicts (``"['chi']"``, nested entries joined by ``/``), so a checkpoint
directory written by either package restores in the other. One host writes
the one shard.

``checkpoint.write`` is a fault site (``repro_torch.engine.faults``) at the
entry of the writer: ``raise`` fails the save (in async mode on the next
``wait()``), and ``torn_write`` stops the writer between the shard write and
the atomic rename, so the staging directory leaks and no manifest becomes
visible, as a kill mid-write would leave it.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np


class CheckpointCorrupt(RuntimeError):
    """A checkpoint's data does not match its manifest (torn or corrupt
    write), or its files cannot be read at all."""


def _check_fault(site: str):
    # lazy: repro_torch.train sits below repro_torch.engine
    from repro_torch.engine.faults import check_fault

    return check_fault(site)


def _name(prefix: str, key) -> str:
    return f"{prefix}/[{key!r}]" if prefix else f"[{key!r}]"


def _leaves(tree, prefix: str = ""):
    """(name, leaf) pairs in ``tree_flatten_with_path`` order: dict entries
    by sorted key, everything that is not a dict a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], _name(prefix, k))
    else:
        yield prefix, tree


def _flatten_with_names(tree) -> dict[str, np.ndarray]:
    return {name: np.asarray(leaf) for name, leaf in _leaves(tree)}


def _unflatten_like(tree, named: dict[str, np.ndarray], prefix: str = ""):
    """``tree``'s structure with each leaf replaced by the array of the same
    name. A missing name raises KeyError and a shape that differs from the
    template's raises ValueError: both mean a config mismatch, not
    corruption."""
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, named, _name(prefix, k)) for k, v in tree.items()}
    arr = named[prefix]
    if arr.shape != np.shape(tree):
        raise ValueError(f"{prefix}: saved shape {arr.shape} != template {np.shape(tree)}")
    return arr


def config_hash(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def array_checksum(arr: np.ndarray) -> str:
    """Content hash of one array: dtype + shape + bytes (C-contiguous)."""
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None
        # start-up sweep: any staging dir left by a killed or torn writer
        self._sweep_tmp()

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, meta: Optional[dict] = None) -> None:
        named = _flatten_with_names(state)  # host copy happens here
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, named, meta or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, named, meta or {})

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._save_error is not None:
            e, self._save_error = self._save_error, None
            raise e

    def _write_guarded(self, step: int, named: dict, meta: dict) -> None:
        # async writer: park the error for the next wait() instead of
        # letting the daemon thread die silently
        try:
            self._write(step, named, meta)
        except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
            self._save_error = e

    def _write(self, step: int, named: dict, meta: dict) -> None:
        kind = _check_fault("checkpoint.write")
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f".tmp_step_{step:010d}_{time.time_ns()}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / "shard_00000.npz", **named)
        manifest = {
            "step": step,
            "n_hosts": 1,
            "keys": sorted(named.keys()),
            "checksums": {k: array_checksum(v) for k, v in named.items()},
            "time": time.time(),
            **meta,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if kind == "torn_write":
            return  # the staging dir leaks; no manifest becomes visible
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic: a manifest is visible only in complete dirs
        self._gc()

    def _gc(self) -> None:
        done = sorted(self.dir.glob("step_*"))
        for d in done[: -self.keep] if self.keep else []:
            shutil.rmtree(d, ignore_errors=True)
        self._sweep_tmp()

    def _sweep_tmp(self) -> None:
        """Remove orphaned staging dirs (torn writes)."""
        for t in list(self.dir.glob(".tmp_step_*")) + list(self.dir.glob("*.tmp")):
            shutil.rmtree(t, ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def manifest(self, step: Optional[int] = None) -> Optional[dict]:
        """The manifest of ``step`` (default: newest), or None if there is
        none; raises CheckpointCorrupt if it cannot be read."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        d = self.dir / f"step_{step:010d}"
        try:
            return json.loads((d / "manifest.json").read_text())
        except (OSError, ValueError) as e:
            raise CheckpointCorrupt(f"manifest of {d} is unreadable: {e!r}") from e

    def steps(self) -> list[int]:
        """All steps with a visible manifest, ascending."""
        out = []
        for d in self.dir.glob("step_*"):
            if (d / "manifest.json").exists():
                out.append(int(d.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None):
        """Restore into the structure of ``like``; returns (state, manifest),
        or (None, None) where there is no checkpoint.

        Every loaded array is checked against the manifest's checksum; a
        mismatch, a missing array or an unreadable file raises
        CheckpointCorrupt. A template mismatch (a key or shape ``like`` does
        not have) raises KeyError or ValueError: a config mismatch, not
        corruption."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        d = self.dir / f"step_{step:010d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
            named: dict[str, np.ndarray] = {}
            for shard in sorted(d.glob("shard_*.npz")):
                with np.load(shard) as z:
                    for k in z.files:
                        named[k] = z[k]
        except Exception as e:  # noqa: BLE001 -- any unreadable file is corruption
            raise CheckpointCorrupt(f"checkpoint {d} is unreadable: {e!r}") from e
        sums = manifest.get("checksums")  # None: a manifest from before checksums
        if sums is not None:
            missing = sorted(set(sums) - set(named))
            bad = sorted(k for k in sums if k in named and array_checksum(named[k]) != sums[k])
            if missing or bad:
                raise CheckpointCorrupt(
                    f"checkpoint {d} failed verification: "
                    f"missing arrays {missing}, checksum mismatches {bad}")
        return _unflatten_like(like, named), manifest
