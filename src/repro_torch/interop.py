"""Carrying engine state between the JAX reference and the port.

Both engines snapshot to the same flat dict of host numpy arrays: ``f1``,
``chi``, ``f2``, ``has_f3``, ``m_seen`` (each with a leading tenant axis),
``root_keys`` (T, 2) uint32, ``step``, ``dyn_step``, ``config`` = [r,
batch_size, n_tenants] and ``scheme``; a window/decay engine adds its
live-edge ring, ``window_edges`` (T, C, 2) int32, ``window_expiry`` (T, C)
int64 and ``window_len`` (T,) int64. Because every random draw is a
function of (root key, step), a snapshot taken mid-stream by either engine
continues bit-identically in the other. These functions check a snapshot
against that format and normalise its dtypes, and hash states and estimates
for comparison; they need neither framework's arrays, only numpy.

``from_jax_params`` carries a transformer's param dict the other way: the
reference's params as numpy arrays (``jax.device_get``) into the port's
tensors, so both packages can run one model on the same weights;
``from_jax_param_tree`` does the same for the nested trees of the GNN,
equivariant and BERT4Rec families (``layer{i}`` -> ``edge`` -> ``w0``);
``from_jax_opt_state`` carries an optimizer's state (``train/optimizer.py``
keeps the reference's keys), so both can train on from one state.
"""
from __future__ import annotations

import hashlib

import numpy as np

_FIELDS = {
    "f1": np.int32, "chi": np.int32, "f2": np.int32, "has_f3": np.bool_,
    "m_seen": np.int64, "root_keys": np.uint32, "config": np.int64,
}
_WINDOW = {"window_edges": np.int32, "window_expiry": np.int64, "window_len": np.int64}


def _normalise(snap: dict) -> dict:
    missing = [k for k in (*_FIELDS, "step") if k not in snap]
    if missing:
        raise KeyError(f"snapshot lacks {missing}")
    out = {k: np.array(np.asarray(snap[k]), dtype=dt) for k, dt in _FIELDS.items()}
    T = int(out["config"][2])
    r = int(out["config"][0])
    for k, shape in (("f1", (T, r, 2)), ("chi", (T, r)), ("f2", (T, r, 2)),
                     ("has_f3", (T, r)), ("m_seen", (T,)), ("root_keys", (T, 2))):
        if out[k].shape != shape:
            raise ValueError(f"snapshot {k} has shape {out[k].shape}, expected {shape}")
    out["step"] = np.int64(snap["step"])
    out["dyn_step"] = np.int64(snap.get("dyn_step", snap["step"]))
    out["scheme"] = np.array(str(np.asarray(snap.get("scheme", "global"))))
    for k, dt in _WINDOW.items():
        if k in snap:
            out[k] = np.array(np.asarray(snap[k]), dtype=dt)
    return out


def from_jax_snapshot(snap: dict) -> dict:
    """A ``repro`` engine snapshot as one ``repro_torch``'s engine restores."""
    return _normalise(snap)


def to_jax_snapshot(snap: dict) -> dict:
    """A ``repro_torch`` engine snapshot as one ``repro``'s engine restores."""
    return _normalise(snap)


def tenant_snapshot(snap: dict, tenant: int) -> dict:
    """Tenant ``tenant`` of a bank's snapshot as a one-tenant snapshot in
    the same format (its state, root key and window ring; the bank's step
    cursors and scheme)."""
    s = _normalise(snap)
    out = {k: s[k][tenant:tenant + 1] for k in (*_FIELDS, *_WINDOW) if k in s and k != "config"}
    out["config"] = s["config"].copy()
    out["config"][2] = 1
    out.update(step=s["step"], dyn_step=s["dyn_step"], scheme=s["scheme"])
    return out


def estimator_sha256(fields) -> str:
    """sha256 over an estimator state's f1, chi, f2 (int32), has_f3 (one
    byte each) and m_seen (int64), given in that order as arrays numpy can
    read, little-endian. Equal digests mean bit-identical state."""
    h = hashlib.sha256()
    for a, dt in zip(fields, ("<i4", "<i4", "<i4", "u1", "<i8"), strict=True):
        h.update(np.ascontiguousarray(np.asarray(a).astype(dt)).tobytes())
    return h.hexdigest()


def state_sha256(snap: dict) -> str:
    """``estimator_sha256`` of a snapshot's state (every tenant's, in
    order)."""
    s = _normalise(snap)
    return estimator_sha256([s[k] for k in ("f1", "chi", "f2", "has_f3", "m_seen")])


def estimate_sha256(est) -> str:
    """sha256 over a (per-vertex) estimate as little-endian float64: equal
    digests mean bit-identical estimates."""
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(est, dtype="<f8")).tobytes()).hexdigest()


def window_sha256(snap: dict) -> str:
    """sha256 over a window/decay snapshot's live-edge ring: window_edges
    (int32), window_expiry and window_len (int64), little-endian. Equal
    digests mean the same ring, row for row."""
    s = _normalise(snap)
    h = hashlib.sha256()
    for k, dt in (("window_edges", "<i4"), ("window_expiry", "<i8"), ("window_len", "<i8")):
        h.update(np.ascontiguousarray(s[k].astype(dt)).tobytes())
    return h.hexdigest()


def _tensor(a):
    """A numpy array as a CPU tensor; a bfloat16 array (numpy's
    ``ml_dtypes.bfloat16``, which torch cannot take) crosses as its bits."""
    import torch

    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def from_jax_params(params_np: dict, cfg, device="cpu") -> dict:
    """The reference's transformer params (a dict of numpy arrays) as the
    port's tensors on ``device``. The port keeps the reference's keys and
    layouts (``models.transformer``), so each array keeps its shape. Every
    leaf but the float32 router must be in ``cfg.dtype``."""
    import torch

    out = {}
    for k, a in params_np.items():
        t = _tensor(a)
        want = torch.float32 if k == "router" else cfg.dtype
        if t.dtype != want:
            raise ValueError(f"param {k!r} is {t.dtype}, the config needs {want}")
        out[k] = t.to(device)
    return out


def from_jax_param_tree(tree_np: dict, cfg, device="cpu") -> dict:
    """The reference's nested param tree (dicts of dicts of numpy arrays,
    as ``jax.device_get`` returns a GNN's, an equivariant model's or
    BERT4Rec's params) as the same tree of the port's tensors on
    ``device``: every key kept, every leaf its shape. Every leaf must be
    in ``cfg.dtype``, the one dtype these configs name."""
    def conv(tree, path):
        if isinstance(tree, dict):
            return {k: conv(v, f"{path}/{k}") for k, v in tree.items()}
        t = _tensor(tree)
        if t.dtype != cfg.dtype:
            raise ValueError(f"param {path!r} is {t.dtype}, the config needs {cfg.dtype}")
        return t.to(device)

    if not isinstance(tree_np, dict):
        raise TypeError(f"a param tree is a dict, not {type(tree_np).__name__}")
    return conv(tree_np, "")


def from_jax_opt_state(opt_state_np: dict, params_like: dict) -> dict:
    """The reference's optimizer state (its tree of numpy arrays: adamw's
    ``m``/``v``/``count``, adafactor's ``f``/``count``, sgd's ``mu``) as the
    port's, on the device of ``params_like``'s tensors. Moments keep their
    float32 and the count its int32; a per-param entry must name a param of
    ``params_like``."""
    device = next(iter(params_like.values())).device

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree).to(device)

    out = conv(opt_state_np)
    for group in ("m", "v", "mu", "f"):
        if group in out and set(out[group]) != set(params_like):
            raise ValueError(f"opt state {group!r} names {sorted(out[group])}, the params "
                             f"{sorted(params_like)}")
    return out
