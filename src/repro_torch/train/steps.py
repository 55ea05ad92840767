"""Step builders (``repro.train.steps``): ``(params, opt_state, batch, key)
-> (params', opt_state', metrics)`` train steps for every family, and the
serve steps of the LM and recsys families.

Gradients come from PyTorch's autograd: ``value_and_grad`` takes the loss
at fresh leaves that share the params' storage, so the caller's tensors
never require grad; a leaf the loss does not reach gets zeros, as
``jax.grad`` gives it (BERT4Rec's GELU FFN leaves ``wu`` unread, EGNN's
last coordinate MLP feeds no energy).
"""
from __future__ import annotations

import torch

from repro_torch.models import bert4rec as b4r
from repro_torch.models import equivariant as eqv
from repro_torch.models import gnn
from repro_torch.models import transformer as tr
from repro_torch.train.optimizer import Optimizer, tree_map


def value_and_grad(loss_fn, params, batch):
    """``jax.value_and_grad(loss_fn)(params, batch)``: the loss (detached)
    and a tree of gradients in the params' dtypes."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = []
        tree_map(leaves.append, live)
        loss = loss_fn(live, batch)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad_of(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), tree_map(grad_of, live)


def _accum_grads(loss_fn, params, batches, accum: int):
    """Microbatched gradient accumulation (memory = one microbatch): the
    batch split on its leading axis into ``accum`` microbatches, float32
    accumulators, the sums times ``1 / accum``."""
    if accum <= 1:
        return value_and_grad(loss_fn, params, batches)
    split = {k: x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))
             for k, x in batches.items()}
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    l_acc = None
    for i in range(accum):
        loss, g = value_and_grad(loss_fn, params, {k: x[i] for k, x in split.items()})
        g_acc = tree_map(lambda a, b: a + b.float(), g_acc, g)
        l_acc = loss if l_acc is None else l_acc + loss
    inv = float(torch.tensor(1.0 / accum, dtype=torch.float32))
    return l_acc * inv, tree_map(lambda x: x * inv, g_acc)


def make_lm_train_step(cfg: tr.TransformerConfig, opt: Optimizer):
    def loss_fn(params, batch):
        return tr.lm_loss(params, cfg, batch["tokens"], batch["labels"])

    def step(params, opt_state, batch, key):
        loss, grads = _accum_grads(loss_fn, params, batch, cfg.grad_accum)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss}

    return step


def make_lm_prefill_step(cfg: tr.TransformerConfig):
    @torch.no_grad()
    def step(params, batch):
        h, _ = tr.forward(params, cfg, batch["tokens"])
        return tr.logits_fn(params, cfg, h[:, -1:, :])

    return step


def make_lm_decode_step(cfg: tr.TransformerConfig):
    def step(params, cache, batch):
        return tr.decode_step(params, cfg, cache, batch["tokens"])

    return step


def make_gnn_train_step(cfg: gnn.GNNConfig, opt: Optimizer):
    def loss_fn(params, batch):
        if "targets" in batch:  # regression (graphcast rollout)
            return gnn.regression_loss(params, cfg, batch["node_feats"], batch["edge_index"],
                                       batch["targets"])
        return gnn.node_classification_loss(params, cfg, batch["node_feats"],
                                            batch["edge_index"], batch["labels"],
                                            batch["label_mask"])

    def step(params, opt_state, batch, key):
        loss, grads = value_and_grad(loss_fn, params, batch)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss}

    return step


def make_equivariant_train_step(cfg: eqv.EquivariantConfig, opt: Optimizer):
    def loss_fn(params, batch):
        return eqv.energy_loss(params, cfg, batch["node_feats"], batch["coords"],
                               batch["edge_index"], batch["edge_mask"], batch["energy"])

    def step(params, opt_state, batch, key):
        loss, grads = value_and_grad(loss_fn, params, batch)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss}

    return step


def make_recsys_train_step(cfg: b4r.Bert4RecConfig, opt: Optimizer):
    """The cloze step; its mask and negatives are drawn from ``key``."""
    def step(params, opt_state, batch, key):
        loss, grads = value_and_grad(lambda p, b: b4r.cloze_loss(p, cfg, b["items"], key),
                                     params, batch)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss}

    return step


def make_recsys_score_step(cfg: b4r.Bert4RecConfig):
    @torch.no_grad()
    def step(params, batch):
        return b4r.score_candidates(params, cfg, batch["items"], batch["candidates"])

    return step
