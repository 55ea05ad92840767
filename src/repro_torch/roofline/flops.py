"""Analytic FLOP counts per cell (``repro.roofline.flops``), the same
formulas.

The reference validates these against XLA's HLO flop count on scan-free
configurations, to about 15%. The port validates them against PyTorch's
``torch.utils.flop_counter.FlopCounterMode`` around the eager step, which
counts every matmul, attention product and convolution as it runs (loops
included, so no scan correction is needed): on the scan-free probe of the
reference's ``tests/test_roofline.py`` the two agree exactly
(``tests/test_torch_roofline.py``).

Matmul flops only (2mnk per (m, n, k) matmul); elementwise work and the
softmax are left out. Attention counts full (unmasked) rectangles, as the
chunked kernel computes them.
"""
from __future__ import annotations

import math


def lm_flops(cfg, kind: str, B: int, S: int) -> float:
    """Global FLOPs for one step of the given kind ("train"/"prefill"/"decode")."""
    d, dh = cfg.d_model, cfg.dh
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    L, V = cfg.n_layers, cfg.vocab

    if kind == "decode":
        T, s_kv = B, S
    else:
        T, s_kv = B * S, S

    qkvo = 2 * T * d * (hq * dh) + 2 * 2 * T * d * (hkv * dh) + 2 * T * (hq * dh) * d
    attn = 4 * T * s_kv * hq * dh  # scores + values
    if cfg.moe is None:
        n_mat = 3 if cfg.ffn == "swiglu" else 2
        ffn = n_mat * 2 * T * d * cfg.d_ff
    else:
        mo = cfg.moe
        rows = T * mo.top_k * mo.capacity_factor  # capacity buckets computed fully
        ffn = (
            2 * T * d * mo.n_experts  # router
            + 3 * 2 * rows * d * mo.d_ff_expert  # routed experts
            + 3 * 2 * T * d * (mo.n_shared * mo.d_ff_expert)  # shared
        )
    per_layer = qkvo + attn + ffn
    logits_T = T if kind == "train" else B
    logits = 2 * logits_T * d * V
    fwd = L * per_layer + logits

    if kind == "train":
        mult = 3.0 + (1.0 if cfg.remat else 0.0)  # fwd + bwd(2x) [+ remat fwd]
        return fwd * mult
    return float(fwd)


def recsys_flops(cfg, kind: str, B: int, C: int = 0, n_neg: int = 1023) -> float:
    b = cfg.backbone
    S = cfg.seq_len
    fwd = lm_flops(b, "prefill", B, S) - 2 * B * b.d_model * b.vocab  # no logits
    if kind == "train":
        score = 2 * B * S * cfg.embed_dim * (1 + n_neg)
        return (fwd + score) * 3.0
    return fwd + 2 * B * C * cfg.embed_dim


def stream_flops(r: int, s: int, scheme: str, p: int = 512) -> float:
    """Comparison-ops floor for one batch: sort(2s) + 3 multisearches of
    O(r) queries x log(s) + r scalar updates, whatever the scheme."""
    lg = max(math.log2(max(s, 2)), 1.0)
    return 2 * s * lg + 3 * r * lg + 6 * r


def cell_analytic_flops(cell) -> float | None:
    """Global per-step FLOPs for a Cell at its shape table's batch, or None
    where the count of the step itself is exact (GNN and equivariant cells:
    Python-loop layers, no scan in the reference either)."""
    from repro_torch.configs import cells as cmod

    if cell.arch in cmod.LM_ARCHS:
        sh = cmod.LM_SHAPES[cell.shape]
        return lm_flops(cell.config, cell.kind, sh["batch"], sh["seq"])
    if cell.arch == "bert4rec":
        sh = cmod.RECSYS_SHAPES[cell.shape]
        return recsys_flops(cell.config, cell.kind, sh["batch"], sh.get("cands", 0))
    return None
