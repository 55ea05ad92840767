"""The GNN family (``repro.models.gnn``): generic message passing (a
GraphCast-style encode-process-decode processor) and GAT, as plain
functions over the reference's nested param dict.

Message passing is a gather of endpoint rows and a segment reduction over
the edge list (``models.embedding.segment_sum``/``segment_max``: ids out
of range dropped, as ``jax.ops`` does). Graphs are ``(node_feats (N, F),
edge_index (2, E) int)``; padding edges carry index N, a ghost node row
appended inside ``forward`` and cut off again, so static shapes survive
sampling and batching. ``init_params`` draws from ``repro_torch.rng`` bit
for bit as the reference draws from ``jax.random``. ``cfg.remat``
recomputes each processor block in the backward (one non-reentrant
``torch.utils.checkpoint`` a block, the reference's ``jax.checkpoint``).
``mesh_refinement``, ``n_vars`` and ``shard_nodes`` are the reference's
metadata and dry-run knobs and change nothing here.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.models.embedding import segment_max, segment_sum
from repro_torch.models.layers import (dense_init, layer_norm, recompute, segment_softmax,
                                       softmax_xent)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str  # "mpnn" (graphcast-style) | "gat"
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    d_in: int = 128
    n_classes: int = 16
    aggregator: str = "sum"  # sum | mean | max | attn
    mesh_refinement: int = 0  # graphcast metadata (mesh graph synthesized)
    n_vars: int = 0  # graphcast: input variables per node
    dtype: Any = torch.float32
    remat: bool = False
    shard_nodes: str = "auto"  # auto | data | all | replicated (dry-run knob)


def _mlp_init(key: Tensor, dims, dt) -> dict:
    ks = rng.split(key, len(dims) - 1)
    dev = key.device
    return {f"w{i}": dense_init(ks[i], dims[i], dims[i + 1], dt)
            for i in range(len(dims) - 1)} | {
        f"b{i}": torch.zeros((dims[i + 1],), dtype=dt, device=dev)
        for i in range(len(dims) - 1)}


def _mlp(p: dict, x: Tensor, n: int, act=F.silu) -> Tensor:
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1:
            x = act(x.float()).to(x.dtype)
    return x


def init_params(key: Tensor, cfg: GNNConfig) -> dict:
    """The reference's ``init_params`` from the same key, bit for bit,
    drawn on the key's device."""
    dt, d, dev = cfg.dtype, cfg.d_hidden, key.device
    keys = rng.split(key, cfg.n_layers + 4)
    p: dict[str, Any] = {
        "encoder": _mlp_init(keys[0], (cfg.d_in, d, d), dt),
        "decoder": _mlp_init(keys[1], (d, d, cfg.n_classes), dt),
    }
    if cfg.kind == "mpnn":
        for i in range(cfg.n_layers):
            p[f"layer{i}"] = {
                "edge": _mlp_init(rng.fold_in(keys[2], i), (3 * d, d, d), dt),
                "node": _mlp_init(rng.fold_in(keys[3], i), (2 * d, d, d), dt),
                "ln_e": torch.ones((d,), dtype=dt, device=dev),
                "ln_e_b": torch.zeros((d,), dtype=dt, device=dev),
                "ln_n": torch.ones((d,), dtype=dt, device=dev),
                "ln_n_b": torch.zeros((d,), dtype=dt, device=dev),
            }
    elif cfg.kind == "gat":
        dh = d  # per-head dim
        for i in range(cfg.n_layers):
            k = rng.fold_in(keys[2], i)
            d_in_l = cfg.d_in if i == 0 else d * cfg.n_heads
            p[f"layer{i}"] = {
                "w": dense_init(rng.fold_in(k, 0), d_in_l, cfg.n_heads * dh, dt),
                "a_src": dense_init(rng.fold_in(k, 1), cfg.n_heads, dh, dt),
                "a_dst": dense_init(rng.fold_in(k, 2), cfg.n_heads, dh, dt),
            }
        p["decoder"] = _mlp_init(keys[1], (d * cfg.n_heads, d, cfg.n_classes), dt)
    else:
        raise ValueError(cfg.kind)
    return p


def _aggregate(messages: Tensor, dst: Tensor, n_nodes: int, how: str) -> Tensor:
    if how == "sum" or how == "attn":
        return segment_sum(messages, dst, n_nodes)
    if how == "mean":
        s = segment_sum(messages, dst, n_nodes)
        c = segment_sum(torch.ones_like(messages[:, :1]), dst, n_nodes)
        return s / torch.clamp(c, min=1.0)
    if how == "max":
        return segment_max(messages, dst, n_nodes)
    raise ValueError(how)


def forward(params: dict, cfg: GNNConfig, node_feats: Tensor, edge_index: Tensor,
            edge_mask: Tensor = None) -> Tensor:
    """node_feats: (N, d_in); edge_index: (2, E) int (pad entries point at
    N) -> (N, n_classes)."""
    n = node_feats.shape[0]
    src, dst = edge_index[0].long(), edge_index[1].long()
    if edge_mask is None:
        edge_mask = (src < n) & (dst < n)
    src = torch.clamp(src, max=n)  # ghost row n
    dst = torch.clamp(dst, max=n)
    zero = torch.zeros((), dtype=cfg.dtype, device=node_feats.device)

    if cfg.kind == "mpnn":
        h = _mlp(params["encoder"], node_feats.to(cfg.dtype), 2)
        h = torch.cat([h, torch.zeros((1, h.shape[1]), dtype=h.dtype, device=h.device)], 0)
        e = torch.zeros((src.shape[0], cfg.d_hidden), dtype=h.dtype, device=h.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(cfg.n_layers):
            lp = params[f"layer{i}"]

            def block(h, e, lp):
                msg_in = torch.cat([h[src], h[dst], e], dim=-1)
                e2 = e + layer_norm(_mlp(lp["edge"], msg_in, 2), lp["ln_e"], lp["ln_e_b"])
                e2 = torch.where(edge_mask[:, None], e2, zero)
                agg = _aggregate(e2, dst, n + 1, cfg.aggregator)
                h2 = h + layer_norm(_mlp(lp["node"], torch.cat([h, agg], -1), 2),
                                    lp["ln_n"], lp["ln_n_b"])
                return h2, e2

            h, e = recompute(block, h, e, lp) if remat else block(h, e, lp)
        return _mlp(params["decoder"], h[:n], 2)

    # --- GAT ---
    h = node_feats.to(cfg.dtype)
    for i in range(cfg.n_layers):
        lp = params[f"layer{i}"]
        z = (h @ lp["w"]).reshape(n, cfg.n_heads, -1)
        z = torch.cat([z, torch.zeros((1,) + tuple(z.shape[1:]), dtype=z.dtype,
                                      device=z.device)], 0)
        e_src = torch.einsum("ehd,hd->eh", z[src], lp["a_src"])
        e_dst = torch.einsum("ehd,hd->eh", z[dst], lp["a_dst"])
        logits = F.leaky_relu((e_src + e_dst).float(), negative_slope=0.2)
        logits = torch.where(edge_mask[:, None], logits,
                             torch.tensor(-1e30, dtype=torch.float32, device=z.device))
        alpha = segment_softmax(logits, dst, n + 1)  # (E, H)
        msg = z[src] * alpha[..., None].to(z.dtype)
        agg = segment_sum(torch.where(edge_mask[:, None, None], msg, zero), dst, n + 1)[:n]
        h = F.elu(agg.float()).to(cfg.dtype).reshape(n, -1)
    return _mlp(params["decoder"], h, 2)


def node_classification_loss(params: dict, cfg: GNNConfig, node_feats: Tensor,
                             edge_index: Tensor, labels: Tensor, label_mask: Tensor) -> Tensor:
    logits = forward(params, cfg, node_feats, edge_index)
    return softmax_xent(logits, labels, label_mask)


def regression_loss(params: dict, cfg: GNNConfig, node_feats: Tensor, edge_index: Tensor,
                    targets: Tensor) -> Tensor:
    """Next-state regression (a GraphCast-style rollout step): the mean
    squared error in float32."""
    out = forward(params, cfg, node_feats, edge_index)
    return torch.mean(torch.square(out.float() - targets.float()))
