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

Arrays are named as ``jax.tree_util.tree_flatten_with_path`` names a tree:
a dict entry ``['chi']`` (keys sorted), a tuple or list entry ``[0]``, a
NamedTuple field ``.f1``, nested entries joined by ``/`` (the trainer's
``(params, opt_state)`` gives ``[0]/['embed']`` and ``[1]/['count']``), so
a checkpoint directory written by either package restores in the other.
One host writes the one shard.

Leaves may be numpy arrays, scalars or tensors on any device; a tensor is
copied to the host when ``save`` is called. A bfloat16 leaf is stored as
its 2-byte words (``|V2``, what the reference's file holds for its
bfloat16 arrays) and its checksum is reckoned over the name ``bfloat16``,
as the reference reckons it at save time, and verified under that name.
``restore`` reads every leaf back as the template asks: a tensor template
gives a tensor of its dtype on its device (a bfloat16 one from the stored
words, bit for bit; a stored dtype other than the template's raises
ValueError, a config mismatch), anything else the stored numpy array.

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
import torch


class CheckpointCorrupt(RuntimeError):
    """A checkpoint's data does not match its manifest (torn or corrupt
    write), or its files cannot be read at all."""


def _check_fault(site: str):
    # lazy: repro_torch.train sits below repro_torch.engine
    from repro_torch.engine.faults import check_fault

    return check_fault(site)


def _join(prefix: str, part: str) -> str:
    return f"{prefix}/{part}" if prefix else part


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree, prefix: str = ""):
    """(name, leaf) pairs in ``tree_flatten_with_path`` order: dict entries
    by sorted key, tuple and list entries by index, NamedTuple fields in
    order; None holds no leaf, and everything else is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], _join(prefix, f"[{k!r}]"))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), _join(prefix, f".{f}"))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _leaves(x, _join(prefix, f"[{i}]"))
    elif tree is not None:
        yield prefix, tree


def _host(leaf) -> np.ndarray:
    """A leaf as the host array the shard file stores: a tensor copied off
    its device, bfloat16 as its 2-byte words (``|V2``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)  # a CPU tensor is copied too
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    """The dtype name a checksum is reckoned over: the 2-byte words of a
    bfloat16 leaf hash as ``bfloat16``, every other array by its own
    dtype."""
    return "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _flatten_with_names(tree) -> dict[str, np.ndarray]:
    return {name: _host(leaf) for name, leaf in _leaves(tree)}


def _from_host(arr: np.ndarray, like):
    """The stored array in the template leaf's type: for a tensor template
    a tensor on the template's device (bfloat16 from its words), else the
    stored array. A stored dtype other than the tensor template's raises
    ValueError, a config mismatch."""
    if not isinstance(like, torch.Tensor):
        return arr
    if arr.dtype.kind == "V":
        if arr.dtype != np.dtype("V2") or like.dtype != torch.bfloat16:
            raise ValueError(f"saved {arr.dtype} words do not read as {like.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
        if t.dtype != like.dtype:
            raise ValueError(f"saved {arr.dtype} does not read as {like.dtype}")
    return t.to(like.device)


def _unflatten_like(tree, named: dict[str, np.ndarray], prefix: str = ""):
    """``tree``'s structure with each leaf replaced by the array of the same
    name (``_from_host``). A missing name raises KeyError, and a shape or
    dtype that differs from the template's raises ValueError: each means a
    config mismatch, not corruption."""
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, named, _join(prefix, f"[{k!r}]")) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten_like(getattr(tree, f), named, _join(prefix, f".{f}"))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten_like(x, named, _join(prefix, f"[{i}]"))
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    arr = named[prefix]
    shape = tuple(tree.shape) if isinstance(tree, torch.Tensor) else np.shape(tree)
    if arr.shape != shape:
        raise ValueError(f"{prefix}: saved shape {arr.shape} != template {shape}")
    return _from_host(arr, tree)


def config_hash(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def array_checksum(arr: np.ndarray) -> str:
    """Content hash of one array: dtype name (``_dtype_name``) + shape +
    bytes (C-contiguous)."""
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(_dtype_name(a).encode())
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
