"""BERT4Rec (Sun et al., arXiv:1904.06690; ``repro.models.bert4rec``): a
bidirectional transformer over item sequences trained by cloze (masked
items); serving scores candidate items against the last position's state.

The backbone is ``models.transformer`` with ``causal=False``, learned
positions, LayerNorm and a GELU FFN, and the params are its dict. The
cloze step draws its mask and its shared negatives with ``repro_torch.rng``
from the step's key, bit for bit as the reference draws them with
``jax.random``. ``retrieval_cand`` scores one user against ~10^6
candidates as one batched product.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import rng
from repro_torch.models import transformer as tr
from repro_torch.models.layers import softmax_xent

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str
    n_items: int
    embed_dim: int
    n_blocks: int
    n_heads: int
    seq_len: int
    mask_frac: float = 0.2
    dtype: Any = torch.float32

    @property
    def backbone(self) -> tr.TransformerConfig:
        return tr.TransformerConfig(
            name=self.name + "-backbone",
            n_layers=self.n_blocks,
            d_model=self.embed_dim,
            n_heads=self.n_heads,
            n_kv_heads=self.n_heads,
            d_ff=4 * self.embed_dim,
            vocab=self.n_items + 2,  # +PAD, +MASK
            causal=False,
            pos="learned",
            norm="ln",
            ffn="gelu",
            max_len=self.seq_len,
            dtype=self.dtype,
            chunk_q=256,
            chunk_k=256,
        )

    @property
    def mask_id(self) -> int:
        return self.n_items + 1


def init_params(key: Tensor, cfg: Bert4RecConfig) -> dict:
    return tr.init_params(key, cfg.backbone)


def encode(params: dict, cfg: Bert4RecConfig, item_seq: Tensor) -> Tensor:
    """item_seq: (B, S) int -> hidden states (B, S, d)."""
    h, _ = tr.forward(params, cfg.backbone, item_seq)
    return h


def cloze_draws(cfg: Bert4RecConfig, shape: tuple[int, int], key: Tensor,
                n_neg: int = 1023) -> tuple[Tensor, Tensor]:
    """The cloze step's randomness from its key: the (B, S) bool mask
    (``uniform < mask_frac`` in float32) and ``n_neg`` int32 negatives in
    [1, n_items), as the reference's ``split(key)`` draws them."""
    k = rng.split(key)
    frac = torch.tensor(cfg.mask_frac, dtype=torch.float32, device=key.device)
    mask = rng.uniform(k[0], tuple(shape)) < frac
    negs = rng.randint32(k[1], cfg.n_items, (n_neg,), minval=1)
    return mask, negs


def cloze_loss(params: dict, cfg: Bert4RecConfig, item_seq: Tensor, key: Tensor,
               n_neg: int = 1023) -> Tensor:
    """Mask a fraction of positions and predict the original items there,
    by a sampled softmax: each masked position scores its true item (slot
    0) against ``n_neg`` negatives shared by the batch."""
    mask, negs = cloze_draws(cfg, tuple(item_seq.shape), key, n_neg)
    inp = torch.where(mask, torch.full_like(item_seq, cfg.mask_id), item_seq)
    h = encode(params, cfg, inp)  # (B, S, d)
    emb_neg = params["embed"][negs.long()]  # (n_neg, d)
    pos_scores = torch.sum(h * params["embed"][item_seq.long()].to(h.dtype), dim=-1,
                           dtype=torch.float32)  # (B, S)
    # float32 products of the params' dtype (the reference's preferred_element_type)
    neg_scores = torch.einsum("bsd,nd->bsn", h.float(), emb_neg.float())
    logits = torch.cat([pos_scores[..., None], neg_scores], dim=-1)
    labels = torch.zeros(tuple(item_seq.shape), dtype=torch.int64, device=item_seq.device)
    return softmax_xent(logits, labels, mask)


def score_candidates(params: dict, cfg: Bert4RecConfig, item_seq: Tensor,
                     candidates: Tensor) -> Tensor:
    """candidates: (B, C) or (C,) item ids -> (B, C) scores by the last
    position's state."""
    h = encode(params, cfg, item_seq)[:, -1]  # (B, d)
    emb = params["embed"][candidates.long()]  # (..., C, d)
    if emb.dim() == 2:
        return h @ emb.T
    return torch.einsum("bd,bcd->bc", h, emb)
