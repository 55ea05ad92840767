"""The transformer LM family (``repro.models.transformer``): smollm,
qwen2/3, granite-moe and kimi-k2, as plain functions over the reference's
param dict.

The params are the reference's dict, key for key and in its layouts: layer
params stacked on a leading (L, ...) axis, projection weights (d_in,
d_out), so ``interop.from_jax_params`` only changes the array type.
``init_params`` draws them from ``repro_torch.rng`` bit for bit as the
reference draws them from ``jax.random``, so one seed gives one model in
both packages.

* Attention is the reference's two-level chunked online softmax, written
  in plain PyTorch: GQA by head grouping, ``k_pos = -1`` marks an empty
  cache slot, an f32 carry (max, sum, accumulator) across key chunks. It
  serves the causal forward and decoding (one query against the cache).
* MoE is the reference's sort-based capacity dispatch: tokens sorted
  stably by expert, each one's slot its rank within its expert's run
  (``primitives.segscan``), slots past the capacity dropped.
* Decoding updates the KV cache in place: one slice write at ``pos`` per
  layer into the (L, B, S_max, Hkv, dh) tensors; ``pos`` stays a device
  scalar, so a decode loop never waits on the device for it.

The layers run one after another (the reference scans over the stack).
Training runs through PyTorch's autograd: ``lm_loss`` and everything under
it (the online softmax, the MoE's index writes on fresh buffers, the norms,
rope, the chunked cross entropy) is differentiable, and ``train/steps.py``
takes its gradient. As in the reference, ``lm_loss`` recomputes each loss
chunk's logits in the backward (one ``torch.utils.checkpoint`` a chunk),
and ``cfg.remat`` recomputes each layer in the backward (one checkpoint a
layer, the reference's ``jax.checkpoint`` with nothing saveable). Remat
changes memory, not values: on the CPU the gradients are bit-identical
with and without it. The reference's inner checkpoint of each attention
key step is not reproduced: the attention stays a plain loop, whose
per-step probabilities autograd keeps, which the training shapes of this
port (sequences of a few hundred tokens) hold easily. ``decode_step`` runs
under ``torch.no_grad()``, so serving with params that require grad builds
no graph and its in-place cache writes never meet autograd. The options
``fsdp_params`` and ``fsdp_layer_gather`` are accepted and have no effect
on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.models.layers import (dense_init, layer_norm, recompute, rms_norm, rope,
                                       swiglu)
from repro_torch.primitives.segscan import segment_starts, segmented_iota

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoESettings:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 1
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    causal: bool = True
    pos: str = "rope"  # "rope" | "learned"
    norm: str = "rms"  # "rms" | "ln"
    ffn: str = "swiglu"  # "swiglu" | "gelu"
    rope_theta: float = 10000.0
    max_len: int = 8192  # for learned positions only
    moe: Optional[MoESettings] = None
    dtype: Any = torch.bfloat16
    chunk_q: int = 512
    chunk_k: int = 512
    remat: bool = False  # recompute each layer in the backward (module docstring)
    grad_accum: int = 1
    tie_embeddings: bool = True
    fsdp_params: bool = False  # no effect on one device
    fsdp_layer_gather: bool = False  # no effect on one device

    @property
    def dh(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        d, dh = self.d_model, self.dh
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * dh + self.n_heads * dh * d
        if self.moe:
            ff = (d * self.moe.n_experts
                  + 3 * self.moe.n_experts * d * self.moe.d_ff_expert
                  + 3 * self.moe.n_shared * d * self.moe.d_ff_expert)
        else:
            ff = 3 * d * self.d_ff if self.ffn == "swiglu" else 2 * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ff + 2 * d) + emb

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        d, dh = self.d_model, self.dh
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * dh + self.n_heads * dh * d
        ff = (d * self.moe.n_experts
              + 3 * (self.moe.top_k + self.moe.n_shared) * d * self.moe.d_ff_expert)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ff + 2 * d) + emb


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _scalar(x: float, dtype, device) -> Tensor:
    """The float64 ``x`` rounded once to ``dtype`` (round to nearest even),
    as the reference casts a float64 scalar; torch would round a float64
    to bfloat16 through float32, twice."""
    if dtype == torch.bfloat16 and x != 0.0:
        m, e = math.frexp(x)
        x = math.ldexp(round(m * 256.0), e - 8)  # 8 significant bits, ties to even
    return torch.tensor(x, dtype=torch.float64, device=device).to(dtype)


def init_params(key: Tensor, cfg: TransformerConfig) -> dict:
    """The reference's ``init_params`` from the same key (``rng.PRNGKey(
    seed, device)``), bit for bit: ``split(key, 24)``, one ``split(k, L)``
    per stacked leaf, ``split(kk, E)`` per layer for the experts. Drawn on
    the key's device, one layer at a time."""
    d, dh, L = cfg.d_model, cfg.dh, cfg.n_layers
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    keys = rng.split(key, 24)
    dt, dev = cfg.dtype, key.device

    def stack(fn, k):
        return torch.stack([fn(kk) for kk in rng.split(k, L)])

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    p: dict[str, Tensor] = {
        "embed": dense_init(keys[0], cfg.vocab, d, dt, scale=0.02),
        "ln_f": ones(d),
        "ln1": ones(L, d),
        "ln2": ones(L, d),
        "wq": stack(lambda k: dense_init(k, d, hq * dh, dt), keys[1]),
        "wk": stack(lambda k: dense_init(k, d, hkv * dh, dt), keys[2]),
        "wv": stack(lambda k: dense_init(k, d, hkv * dh, dt), keys[3]),
        "wo": stack(lambda k: dense_init(k, hq * dh, d, dt), keys[4]),
    }
    if cfg.norm == "ln":
        p["ln1_b"], p["ln2_b"], p["ln_f_b"] = zeros(L, d), zeros(L, d), zeros(d)
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = zeros(L, hq * dh), zeros(L, hkv * dh), zeros(L, hkv * dh)
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = ones(L, dh), ones(L, dh)
    if cfg.pos == "learned":
        p["pos_embed"] = dense_init(keys[5], cfg.max_len, d, dt, scale=0.02)
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(keys[6], d, cfg.vocab, dt, scale=0.02)

    if cfg.moe is None:
        p["wg"] = stack(lambda k: dense_init(k, d, cfg.d_ff, dt), keys[7])
        p["wu"] = stack(lambda k: dense_init(k, d, cfg.d_ff, dt), keys[8])
        p["wd"] = stack(lambda k: dense_init(k, cfg.d_ff, d, dt), keys[9])
    else:
        mo = cfg.moe
        E, ffe = mo.n_experts, mo.d_ff_expert

        def estack(k):  # (L, E, d, ffe): each layer's E expert keys draw at once
            return stack(lambda kk: dense_init(rng.split(kk, E), d, ffe, dt), k)

        p["router"] = stack(lambda k: dense_init(k, d, E, torch.float32), keys[10])
        p["e_wg"] = estack(keys[11])
        p["e_wu"] = estack(keys[12])
        p["e_wd"] = estack(keys[13]).transpose(-1, -2).contiguous() * _scalar(
            math.sqrt(d / ffe), dt, dev)
        ffs = mo.n_shared * ffe
        if mo.n_shared > 0:
            p["s_wg"] = stack(lambda k: dense_init(k, d, ffs, dt), keys[14])
            p["s_wu"] = stack(lambda k: dense_init(k, d, ffs, dt), keys[15])
            p["s_wd"] = stack(lambda k: dense_init(k, ffs, d, dt), keys[16])
    return p


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def flash_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
                    causal: bool, chunk_q: int, chunk_k: int) -> Tensor:
    """Two-level chunked online-softmax attention.

    q: (B, Sq, Hq, dh); k/v: (B, Sk, Hkv, dh); GQA via head grouping. A
    query attends where k_pos <= q_pos (if causal) and k_pos >= 0. Scores,
    the running max and sum and the accumulator are float32; the
    probabilities meet ``v`` in v's dtype, as in the reference.
    """
    B, Sq, Hq, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    nq, nk = -(-Sq // cq), -(-Sk // ck)
    scale = float(np.float32(1.0) / np.power(np.float32(dh), np.float32(0.5)))
    pq, pk = nq * cq - Sq, nk * ck - Sk
    q = F.pad(q, (0, 0, 0, 0, 0, pq))
    q_pos = F.pad(q_pos, (0, pq))
    k = F.pad(k, (0, 0, 0, 0, 0, pk))
    v = F.pad(v, (0, 0, 0, 0, 0, pk))
    k_pos = F.pad(k_pos, (0, pk), value=-1)

    qg = q.reshape(B, nq, cq, Hkv, G, dh)
    kg = k.reshape(B, nk, ck, Hkv, dh)
    vg = v.reshape(B, nk, ck, Hkv, dh)
    qp = q_pos.reshape(B, nq, cq)
    kp = k_pos.reshape(B, nk, ck)
    out = []
    for i in range(nq):
        qb, qpb = qg[:, i].float(), qp[:, i]
        acc = torch.zeros((B, cq, Hkv, G, dh), dtype=torch.float32, device=q.device)
        m = torch.full((B, cq, Hkv, G), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, cq, Hkv, G), dtype=torch.float32, device=q.device)
        for j in range(nk):
            kb, vb, kpb = kg[:, j].float(), vg[:, j], kp[:, j]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qb, kb) * scale
            mask = kpb[:, None, None, None, :] >= 0
            if causal:
                mask = mask & (kpb[:, None, None, None, :] <= qpb[:, :, None, None, None])
            s = s.masked_fill(~mask, -math.inf)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
            alpha = torch.exp(torch.clamp(m - m_safe, max=0.0))
            alpha = torch.where(torch.isfinite(m), alpha, torch.zeros_like(alpha))
            pexp = torch.exp(s - m_safe[..., None])
            pexp = torch.where(mask, pexp, torch.zeros_like(pexp))
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", pexp.to(v.dtype).float(), vb.float())
            l = l * alpha + torch.sum(pexp, dim=-1)
            m = m_new
        out.append(acc / torch.clamp(l[..., None], min=1e-20))
    o = torch.stack(out, dim=1).reshape(B, nq * cq, Hq, dh)[:, :Sq]
    return o.to(q.dtype)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def _top_k(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """``jax.lax.top_k`` along the last axis: ties go to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(x: Tensor, lp: dict, mo: MoESettings) -> tuple[Tensor, Tensor]:
    """Sort-based capacity dispatch. x: (T, d) -> (y (T, d), aux loss).
    The capacity is ``max(int(T * k * capacity_factor / E), 4)`` in Python
    floats; pairs past it in their expert's run are dropped (their slot
    writes go to a spare row that is cut off, where the reference's
    ``mode="drop"`` drops them, and they add nothing)."""
    T, d = x.shape
    E, k = mo.n_experts, mo.top_k
    C = max(int(T * k * mo.capacity_factor / E), 4)

    logits = x.float() @ lp["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, k)  # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(T * k)
    flat_w = top_w.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    slot = segmented_iota(segment_starts(e_sorted)).long()
    keep = slot < C
    buf_idx = torch.where(keep, e_sorted * C + slot, torch.full_like(slot, E * C))
    token = order // k

    # slot writes with the dropped pairs sent to a spare row past the
    # buffer (no boolean mask, so no wait on the device for its size)
    xb = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    xb[buf_idx] = x[token]
    xb = xb[:E * C].reshape(E, C, d)
    g = torch.bmm(xb, lp["e_wg"])
    u = torch.bmm(xb, lp["e_wu"])
    h = F.silu(g.float()).to(x.dtype) * u
    yb = torch.bmm(h, lp["e_wd"]).reshape(E * C, d)

    y_rows = torch.where(keep[:, None], yb[torch.clamp(buf_idx, max=E * C - 1)],
                         torch.zeros((), dtype=x.dtype, device=x.device))
    contrib = torch.empty_like(y_rows)
    contrib[order] = y_rows * flat_w[order, None].to(x.dtype)  # back to (token, choice)
    # each token's k terms added one at a time in the activation dtype, in
    # expert order: the reference's scatter-add order, and deterministic
    by_expert = torch.argsort(top_e, dim=1, stable=True)
    contrib = contrib.reshape(T, k, d).gather(1, by_expert[..., None].expand(T, k, d))
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]
    if "s_wg" in lp:
        y = y + swiglu(x, lp["s_wg"], lp["s_wu"], lp["s_wd"])

    # Switch-style load-balance aux loss
    experts = torch.arange(E, device=x.device)
    frac = torch.mean((top_e[..., None] == experts).float().sum(1), dim=0)
    imp = torch.mean(probs, dim=0)
    aux = mo.aux_loss_coef * E * torch.sum(frac * imp)
    return y, aux


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _norm(x, w, b, kind):
    return rms_norm(x, w) if kind == "rms" else layer_norm(x, w, b)


def _ffn(cfg: TransformerConfig, hn2: Tensor, lp: dict) -> tuple[Tensor, Tensor]:
    B, S, d = hn2.shape
    if cfg.moe is not None:
        ffv, aux = moe_ffn(hn2.reshape(B * S, d), lp, cfg.moe)
        return ffv.reshape(B, S, d), aux
    if cfg.ffn == "swiglu":
        ff = swiglu(hn2, lp["wg"], lp["wu"], lp["wd"])
    else:
        ff = F.gelu((hn2 @ lp["wg"]).float(), approximate="tanh").to(hn2.dtype) @ lp["wd"]
    return ff, torch.zeros((), dtype=torch.float32, device=hn2.device)


def _qkv(cfg: TransformerConfig, hn: Tensor, lp: dict, q_pos: Tensor):
    B, S, _ = hn.shape
    q, kk, vv = hn @ lp["wq"], hn @ lp["wk"], hn @ lp["wv"]
    if cfg.qkv_bias:
        q, kk, vv = q + lp["bq"], kk + lp["bk"], vv + lp["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.dh)
    kk = kk.reshape(B, S, cfg.n_kv_heads, cfg.dh)
    vv = vv.reshape(B, S, cfg.n_kv_heads, cfg.dh)
    if cfg.qk_norm:
        q, kk = rms_norm(q, lp["q_norm"]), rms_norm(kk, lp["k_norm"])
    if cfg.pos == "rope":
        q, kk = rope(q, q_pos, cfg.rope_theta), rope(kk, q_pos, cfg.rope_theta)
    return q, kk, vv


def _layer(cfg: TransformerConfig, h: Tensor, lp: dict, q_pos: Tensor, k_pos: Tensor,
           k_ext: Optional[Tensor] = None, v_ext: Optional[Tensor] = None):
    """One transformer block. If k_ext/v_ext are given (decode), attend to
    them. Returns (h, (k, v, aux))."""
    B, S, d = h.shape
    hn = _norm(h, lp["ln1"], lp.get("ln1_b"), cfg.norm)
    q, kk, vv = _qkv(cfg, hn, lp, q_pos)
    if k_ext is not None:
        k_all, v_all = k_ext, v_ext
    else:
        k_all, v_all, k_pos = kk, vv, q_pos
    attn = flash_attention(q, k_all, v_all, q_pos, k_pos, cfg.causal, cfg.chunk_q, cfg.chunk_k)
    h = h + attn.reshape(B, S, cfg.n_heads * cfg.dh) @ lp["wo"]
    ff, aux = _ffn(cfg, _norm(h, lp["ln2"], lp.get("ln2_b"), cfg.norm), lp)
    return h + ff, (kk, vv, aux)


_GLOBAL_PARAMS = ("embed", "unembed", "pos_embed", "ln_f", "ln_f_b")


def _layer_params(p: dict, layer: int) -> dict:
    """Layer ``layer``'s slice of the stacked params."""
    return {k: v[layer] for k, v in p.items() if k not in _GLOBAL_PARAMS}


def forward(params: dict, cfg: TransformerConfig, tokens: Tensor,
            positions: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    """tokens: (B, S) int -> final hidden states (B, S, d), aux loss."""
    B, S = tokens.shape
    h = params["embed"][tokens.long()]
    if cfg.pos == "learned":
        h = h + params["pos_embed"][torch.arange(S, device=h.device) % cfg.max_len][None]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=h.device)[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = cfg.remat and torch.is_grad_enabled()

    def block(hh, lp):
        h2, (_, _, a) = _layer(cfg, hh, lp, positions, positions)
        return h2, a

    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer)
        if remat:
            h, a = recompute(block, h, lp)
        else:
            h, a = block(h, lp)
        aux = aux + a
    return _norm(h, params["ln_f"], params.get("ln_f_b"), cfg.norm), aux


def logits_fn(params: dict, cfg: TransformerConfig, h: Tensor) -> Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return h @ w


def lm_loss(params: dict, cfg: TransformerConfig, tokens: Tensor, labels: Tensor,
            loss_chunk: int = 2048) -> Tensor:
    """Causal LM loss: the mean cross entropy over vocab-sized logits
    computed one token chunk at a time (chunk x V, in the params' dtype,
    then float32), plus the MoE aux loss. Under autograd each chunk's
    logits are recomputed in the backward, not kept, so the full (tokens x
    vocab) matrix never exists."""
    B, S = tokens.shape
    h, aux = forward(params, cfg, tokens)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    T = B * S
    hf, lf = h.reshape(T, -1), labels.reshape(T).long()

    def chunk_nll(hc, lc):
        logits = (hc @ w).float()
        logz = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, lc[:, None])[:, 0]
        return torch.sum(logz - ll)

    grad = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, T, min(loss_chunk, T)):
        hc, lc = hf[lo:lo + loss_chunk], lf[lo:lo + loss_chunk]
        total = total + (recompute(chunk_nll, hc, lc) if grad else chunk_nll(hc, lc))
    return total / T + aux


# --------------------------------------------------------------------------
# decode (serving)
# --------------------------------------------------------------------------
def init_cache(cfg: TransformerConfig, batch: int, max_len: int, device="cpu") -> dict:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def decode_step(params: dict, cfg: TransformerConfig, cache: dict,
                tokens: Tensor) -> tuple[Tensor, dict]:
    """One decode step: tokens (B, 1) given a filled cache -> (logits
    (B, 1, V), cache). Writes this step's keys and values into the cache's
    tensors in place at ``pos`` and returns the cache with ``pos + 1``.
    Runs without autograd (module docstring)."""
    B = tokens.shape[0]
    S_max = cache["k"].shape[2]
    pos = cache["pos"]
    h = params["embed"][tokens.long()]
    if cfg.pos == "learned":
        h = h + params["pos_embed"][(pos % cfg.max_len).long()][None, None]
    q_pos = pos.to(torch.int32).expand(B, 1)
    k_pos = torch.arange(S_max, dtype=torch.int32, device=h.device)[None].expand(B, S_max)
    k_pos = torch.where(k_pos <= pos, k_pos, torch.full_like(k_pos, -1))  # filled slots
    at = pos.long().reshape(1)
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer)
        hn = _norm(h, lp["ln1"], lp.get("ln1_b"), cfg.norm)
        q, kk, vv = _qkv(cfg, hn, lp, q_pos)
        kc, vc = cache["k"][layer], cache["v"][layer]
        kc.index_copy_(1, at, kk)
        vc.index_copy_(1, at, vv)
        attn = flash_attention(q, kc, vc, q_pos, k_pos, False, cfg.chunk_q,
                               max(cfg.chunk_k, 2048))
        h = h + attn.reshape(B, 1, cfg.n_heads * cfg.dh) @ lp["wo"]
        ff, _ = _ffn(cfg, _norm(h, lp["ln2"], lp.get("ln2_b"), cfg.norm), lp)
        h = h + ff
    h = _norm(h, params["ln_f"], params.get("ln_f_b"), cfg.norm)
    return logits_fn(params, cfg, h), {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
