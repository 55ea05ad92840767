"""Shared NN layers (``repro.models.layers``): plain functions over tensors.

The reference's dtype policy holds: norms, activations and softmax run in
float32 and cast back to the input's dtype; every other op runs in the
input's dtype. Params come in explicitly; the initialisers draw from
``repro_torch.rng``, bit for bit as ``jax.random`` does.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import rng

Tensor = torch.Tensor


def uniform_init(key: Tensor, shape: tuple, scale: float, dtype) -> Tensor:
    """``jax.random.uniform(key, shape, float32, -scale, scale)`` cast to
    ``dtype``; leading axes of ``key`` draw one array per key (the
    reference's ``vmap``)."""
    return rng.uniform(key, tuple(shape), minval=-scale, maxval=scale).to(dtype)


def dense_init(key: Tensor, d_in: int, d_out: int, dtype, scale: Optional[float] = None) -> Tensor:
    """A (d_in, d_out) weight uniform in +-scale, by default 1/sqrt(d_in)
    computed in float64 and rounded once to float32, as the reference's x64
    mode does."""
    if scale is None:
        scale = float(torch.tensor(1.0 / math.sqrt(d_in), dtype=torch.float64).float())
    return uniform_init(key, (d_in, d_out), scale, dtype)


def rms_norm(x: Tensor, w: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm(x: Tensor, w: Tensor, b: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """Rotary embedding. x: (..., S, H, dh); positions: (..., S)."""
    half = x.shape[-1] // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(float(np.float32(theta)), expo)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def segment_softmax(scores: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """Softmax over entries sharing a segment id (GNN edge softmax)."""
    scores = scores.float()
    ids = segment_ids.long()
    seg_max = torch.full((num_segments,) + scores.shape[1:], -math.inf,
                         dtype=torch.float32, device=scores.device)
    idx = ids.reshape((-1,) + (1,) * (scores.dim() - 1)).expand_as(scores)
    seg_max = seg_max.scatter_reduce(0, idx, scores, "amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    e = torch.exp(scores - seg_max[ids])
    seg_sum = torch.zeros_like(seg_max).index_add(0, ids, e)
    return e / torch.clamp(seg_sum[ids], min=1e-20)


def softmax_xent(logits: Tensor, labels: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Mean cross entropy in float32. labels: int ids; mask: optional weights."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def recompute(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward, not
    kept (``jax.checkpoint``); nothing in it draws randomness."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
