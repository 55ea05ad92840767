"""Optimizers as pure transforms over param trees (``repro.train.optimizer``):
``Optimizer(init, update)``, ``update(grads, state, params) -> (params,
state)``.

* adamw     -- moments in float32 whatever the params' dtype (mixed
  precision safe).
* adafactor -- factored second moments for params of 2 or more dims (row
  and column statistics), O(n + m) state for an (n, m) param; the
  1T-param MoE config trains with it.
* sgd       -- momentum SGD, the cheap baseline.

A param tree is a dict (nested dicts allowed) of tensors. The state trees
carry the reference's keys (``m``, ``v``, ``count``; ``f`` with ``vr`` and
``vc``, or ``v``, per leaf; ``mu``), so a checkpoint of optimizer state
crosses between the packages. Every update is reckoned in float32 and cast
back to the param's dtype, so bfloat16 params stay bfloat16. ``update``
runs under ``torch.no_grad()`` and returns new tensors: it writes into no
tensor it was given.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a dict tree (and the matching leaves of
    ``rest``), keeping the keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _count0(params) -> torch.Tensor:
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def adamw(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros32, params), "v": tree_map(_zeros32, params),
                "count": _count0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        c = state["count"] + 1
        cf = c.float()
        m = tree_map(lambda mo, g: b1 * mo + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda vo, g: b2 * vo + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        c1 = 1 - torch.pow(b1, cf)
        c2 = 1 - torch.pow(b2, cf)

        def step(p, mo, vo):
            upd = (mo / c1) / (torch.sqrt(vo / c2) + eps) + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype)

        return tree_map(step, params, m, v), {"m": m, "v": v, "count": c}

    return Optimizer(init, update)


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_threshold=1.0) -> Optimizer:
    """Adafactor without momentum (Shazeer & Stern): O(n + m) state for an
    (n, m) param."""

    def fac(p):
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                      device=p.device)}
        return {"v": _zeros32(p)}

    def init(params):
        return {"f": tree_map(fac, params), "count": _count0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        c = state["count"] + 1
        beta = 1.0 - torch.pow(c.float(), -decay)

        def step(p, g, f):
            g = g.float()
            g2 = torch.square(g) + eps
            if p.dim() >= 2:
                vr = beta * f["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * f["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                row = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
                denom = torch.sqrt(vr[..., None] * vc[..., None, :] / row[..., None])
                u = g / torch.clamp(denom, min=eps)
                nf = {"vr": vr, "vc": vc}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                u = g / torch.sqrt(v)
                nf = {"v": v}
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (p.float() - lr * u).to(p.dtype), nf

        def apply(p, g, f):
            if isinstance(p, dict):
                pairs = {k: apply(p[k], g[k], f[k]) for k in p}
                return ({k: new for k, (new, _) in pairs.items()},
                        {k: nf for k, (_, nf) in pairs.items()})
            return step(p, g, f)

        new_params, new_f = apply(params, grads, state["f"])
        return new_params, {"f": new_f, "count": c}

    return Optimizer(init, update)


def sgd(lr=1e-2, momentum=0.9) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros32, params)}

    @torch.no_grad()
    def update(grads, state, params):
        mu = tree_map(lambda m, g: momentum * m + g.float(), state["mu"], grads)
        new = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype), params, mu)
        return new, {"mu": mu}

    return Optimizer(init, update)


def get_optimizer(name: str, lr: float) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(lr=lr)
    if name == "sgd":
        return sgd(lr=lr)
    raise ValueError(f"unknown optimizer {name}")
