"""Cell definitions (``repro.configs.cells``): every (architecture x
input-shape) combination as an abstract unit: its step function, its
arguments as ``meta`` tensors (shapes and dtypes, no storage), PartitionSpec
trees for a ``("data", "model")`` or ``("pod", "data", "model")`` mesh
(``train/sharding.py``) and its useful-work floor (``model_flops``).

40 assigned cells: 5 LM x 4, 4 GNN x 4, 1 recsys x 4. ``LM_ARCHS`` maps each
LM name to its config module and its optimizer's name (the serving and
training CLIs read it), ``GNN_ARCHS`` and ``EQV_ARCHS`` each GNN name to its
config module, and the shape tables give each family's input shapes at full
and smoke size. ``build_cell(arch, shape, mesh_axes_names)`` returns the
cell, which also carries its family's ``init_params`` and its optimizer;
its params come from each family's ``init_params`` on a ``meta`` key,
which draws shapes only (``rng``), so even kimi-k2's 1T params and their
adafactor state allocate nothing. Running a cell means materialising its
arguments on a device, which is the caller's job (the tests, ``chip_smoke.py``,
``roofline/count.py``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Optional

import torch

from repro_torch.train import steps as steps_mod
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.sharding import (P, batch_axes, lm_param_specs, opt_state_specs,
                                        replicated_like)

# ---------------------------------------------------------------------------
# shape tables
# ---------------------------------------------------------------------------
LM_SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    # long-context decode: one token against a 512k KV cache
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}
GNN_SHAPES = {
    "full_graph_sm": {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
                      "n_classes": 7},
    "minibatch_lg": {"n_nodes": 169984, "n_edges": 168960, "d_feat": 602,
                     "n_classes": 41},
    "ogb_products": {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
                     "n_classes": 47},
    "molecule": {"n_nodes": 3840, "n_edges": 8192, "d_feat": 64,
                 "n_classes": 16},
}
GNN_SMOKE_SHAPES = {
    "full_graph_sm": {"n_nodes": 40, "n_edges": 120, "d_feat": 12,
                      "n_classes": 5},
    "minibatch_lg": {"n_nodes": 176, "n_edges": 160, "d_feat": 12,
                     "n_classes": 5},
    "ogb_products": {"n_nodes": 64, "n_edges": 200, "d_feat": 12,
                     "n_classes": 5},
    "molecule": {"n_nodes": 20, "n_edges": 48, "d_feat": 8, "n_classes": 4},
}
RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "score", "batch": 512, "cands": 1024,
                  "per_user": True},
    "serve_bulk": {"kind": "score", "batch": 262144, "cands": 1024,
                   "per_user": False},
    "retrieval_cand": {"kind": "score", "batch": 1, "cands": 1_000_000,
                       "per_user": False},
}

LM_ARCHS = {
    "smollm-135m": ("repro_torch.configs.smollm_135m", "adamw"),
    "qwen3-4b": ("repro_torch.configs.qwen3_4b", "adamw"),
    "qwen2-1.5b": ("repro_torch.configs.qwen2_1_5b", "adamw"),
    "kimi-k2-1t-a32b": ("repro_torch.configs.kimi_k2_1t_a32b", "adafactor"),
    "granite-moe-1b-a400m": ("repro_torch.configs.granite_moe_1b_a400m", "adamw"),
}
GNN_ARCHS = {
    "graphcast": "repro_torch.configs.graphcast",
    "gat-cora": "repro_torch.configs.gat_cora",
}
EQV_ARCHS = {
    "egnn": "repro_torch.configs.egnn",
    "mace": "repro_torch.configs.mace",
}

ALL_ARCHS = (
    list(LM_ARCHS) + list(GNN_ARCHS) + list(EQV_ARCHS) + ["bert4rec"]
)
# the smoke cases (the reference's tests/test_archs_smoke.py): every LM
# shape, two graph shapes for each GNN, every recsys shape
SMOKE_CASES = (
    [(a, s) for a in LM_ARCHS for s in LM_SHAPES]
    + [(a, s) for a in list(GNN_ARCHS) + list(EQV_ARCHS) for s in ("full_graph_sm", "molecule")]
    + [("bert4rec", s) for s in RECSYS_SHAPES]
)


def arch_shapes(arch: str) -> list[str]:
    if arch in LM_ARCHS:
        return list(LM_SHAPES)
    if arch in GNN_ARCHS or arch in EQV_ARCHS:
        return list(GNN_SHAPES)
    if arch == "bert4rec":
        return list(RECSYS_SHAPES)
    raise ValueError(arch)


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ALL_ARCHS for s in arch_shapes(a)]


def _pad_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple  # meta tensors (abstract) or tensors on a device (materialised)
    in_specs: Any  # PartitionSpec tree matching args
    out_specs: Any  # PartitionSpec tree or None (auto)
    config: Any = None
    model_flops: float = 0.0  # useful-work floor (6ND etc.)
    init_params: Optional[Callable] = None  # the family's init_params(key, config)
    optimizer: Any = None  # the train step's optimizer (None where the cell does not train)


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _key_spec() -> torch.Tensor:
    """The port's key (``rng.PRNGKey``: two uint32 words in int64), on meta."""
    return _sds((2,), torch.int64)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def _lm_cell(arch, shape, mesh_axes_names, smoke=False, overrides=None):
    from repro_torch.models.transformer import init_params

    mod, opt_name = LM_ARCHS[arch]
    cfg = getattr(importlib.import_module(mod), "SMOKE" if smoke else "FULL")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    sh = dict(LM_SHAPES[shape])
    if smoke:
        sh["seq"], sh["batch"] = 16, 4
        if sh["kind"] == "decode":
            sh["seq"] = 32
    opt = get_optimizer(opt_name, 1e-3 if not smoke else 1e-2)
    bp = batch_axes(mesh_axes_names)
    pspec = lm_param_specs(cfg, mesh_axes_names, fsdp=getattr(cfg, "fsdp_params", False))
    ospec = opt_state_specs(opt_name, pspec)
    params_s = init_params(_key_spec(), cfg)
    B, S = sh["batch"], sh["seq"]
    d = cfg.active_param_count()

    if sh["kind"] == "train":
        opt_s = opt.init(params_s)
        batch = {
            "tokens": _sds((B, S), torch.int32),
            "labels": _sds((B, S), torch.int32),
        }
        fn = steps_mod.make_lm_train_step(cfg, opt)
        args = (params_s, opt_s, batch, _key_spec())
        bspec = {"tokens": P(bp, None), "labels": P(bp, None)}
        in_specs = (pspec, ospec, bspec, P())
        out_specs = (pspec, ospec, {"loss": P()})
        mf = 6.0 * d * B * S
    elif sh["kind"] == "prefill":
        batch = {"tokens": _sds((B, S), torch.int32)}
        fn = steps_mod.make_lm_prefill_step(cfg)
        args = (params_s, batch)
        in_specs = (pspec, {"tokens": P(bp, None)})
        out_specs = P(bp, None, None)
        mf = 2.0 * d * B * S
    else:  # decode
        cache = {
            "k": _sds((cfg.n_layers, B, S, cfg.n_kv_heads, cfg.dh), cfg.dtype),
            "v": _sds((cfg.n_layers, B, S, cfg.n_kv_heads, cfg.dh), cfg.dtype),
            "pos": _sds((), torch.int32),
        }
        batch = {"tokens": _sds((B, 1), torch.int32)}
        fn = steps_mod.make_lm_decode_step(cfg)
        args = (params_s, cache, batch)
        bq = bp if B > 1 else None
        cspec = {
            "k": P(None, bq, "model", None, None),
            "v": P(None, bq, "model", None, None),
            "pos": P(),
        }
        in_specs = (pspec, cspec, {"tokens": P(bq, None)})
        out_specs = (P(bq, None, None), cspec)
        mf = 2.0 * d * B  # one token per sequence
    return Cell(arch, shape, sh["kind"], fn, args, in_specs, out_specs, cfg, mf, init_params,
                opt if sh["kind"] == "train" else None)


# ---------------------------------------------------------------------------
# GNN / equivariant cells
# ---------------------------------------------------------------------------
def _gnn_batch_specs(sh, mesh_axes_names, equivariant, graphcast_targets,
                     shard_nodes="auto"):
    axes = tuple(mesh_axes_names)
    bp = batch_axes(mesh_axes_names)
    N, E, F = sh["n_nodes"], sh["n_edges"], sh["d_feat"]
    big = N > 500_000
    if shard_nodes == "auto":
        node_p = P(bp, None) if big else P(None, None)
        node_p1 = P(bp) if big else P(None)
    elif shard_nodes == "all":
        node_p, node_p1 = P(axes, None), P(axes)
    elif shard_nodes == "data":
        node_p, node_p1 = P(bp, None), P(bp)
    else:  # replicated
        node_p, node_p1 = P(None, None), P(None)
    batch = {
        "node_feats": _sds((N, F), torch.float32),
        "edge_index": _sds((2, E), torch.int32),
    }
    bspec = {
        "node_feats": node_p,
        "edge_index": P(None, axes),
    }
    if equivariant:
        batch |= {
            "coords": _sds((N, 3), torch.float32),
            "edge_mask": _sds((E,), torch.bool),
            "energy": _sds((), torch.float32),
        }
        bspec |= {
            "coords": node_p,
            "edge_mask": P(axes),
            "energy": P(),
        }
    elif graphcast_targets is not None:
        batch |= {"targets": _sds((N, graphcast_targets), torch.float32)}
        bspec |= {"targets": node_p}
    else:
        batch |= {
            "labels": _sds((N,), torch.int32),
            "label_mask": _sds((N,), torch.float32),
        }
        bspec |= {
            "labels": node_p1,
            "label_mask": node_p1,
        }
    return batch, bspec


def _gnn_cell(arch, shape, mesh_axes_names, smoke=False, overrides=None):
    sh = dict((GNN_SMOKE_SHAPES if smoke else GNN_SHAPES)[shape])
    # pad edge/node counts to device multiples for even sharding
    if not smoke:
        sh["n_edges"] = _pad_to(sh["n_edges"], 1024)
        if sh["n_nodes"] > 500_000:
            sh["n_nodes"] = _pad_to(sh["n_nodes"], 1024)
    equivariant = arch in EQV_ARCHS
    opt = get_optimizer("adamw", 1e-3)

    if equivariant:
        from repro_torch.models.equivariant import init_params

        mod = importlib.import_module(EQV_ARCHS[arch])
        cfg = mod.SMOKE if smoke else mod.FULL
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        sh["d_feat"] = cfg.d_hidden  # input h is the embedded atom features
        batch, bspec = _gnn_batch_specs(
            sh, mesh_axes_names, True, None,
            shard_nodes=getattr(cfg, "shard_nodes", "auto"),
        )
        fn = steps_mod.make_equivariant_train_step(cfg, opt)
        N, E, d = sh["n_nodes"], sh["n_edges"], cfg.d_hidden
        if cfg.kind == "mace":
            per_layer = (
                2 * E * cfg.n_rbf * d + 2 * E * d * 9 * d  # radial MLP
                + E * 9 * d * 3  # msg outer products
                + 2 * N * 4 * d * d  # product-basis mix
                + 2 * N * (2 * d * d + d * d)  # node MLP
            )
        else:  # egnn
            per_layer = 2 * E * ((2 * d + 1) * d + d * d) + 2 * E * (d * d + d) \
                + 2 * N * (2 * d * d + d * d)
        mf = 3.0 * (cfg.n_layers * per_layer + 2 * N * d * d)  # x3 train
    else:
        from repro_torch.models.gnn import init_params

        mod = importlib.import_module(GNN_ARCHS[arch])
        gc_targets = None
        n_cls = sh["n_classes"]
        if arch == "graphcast":
            gc_targets = 227 if not smoke else 9
            n_cls = gc_targets
        cfg = (mod.smoke if smoke else mod.full)(sh["d_feat"], n_cls)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        if isinstance(cfg.dtype, str):
            cfg = dataclasses.replace(cfg, dtype=getattr(torch, cfg.dtype))
        batch, bspec = _gnn_batch_specs(
            sh, mesh_axes_names, False, gc_targets,
            shard_nodes=getattr(cfg, "shard_nodes", "auto"),
        )
        fn = steps_mod.make_gnn_train_step(cfg, opt)
        N, E, d = sh["n_nodes"], sh["n_edges"], cfg.d_hidden
        if cfg.kind == "gat":
            w = d * cfg.n_heads
            per_layer = 2 * N * sh["d_feat"] * w + 4 * E * w + 2 * E * w
            mf = 3.0 * (cfg.n_layers * per_layer + 2 * N * w * n_cls)
        else:  # mpnn: edge MLP (3d->d->d) + node MLP (2d->d->d) per layer
            per_layer = 2 * E * (3 * d * d + d * d) + 2 * N * (2 * d * d + d * d)
            enc_dec = 2 * N * (sh["d_feat"] * d + d * d) + 2 * N * (d * d + d * n_cls)
            mf = 3.0 * (cfg.n_layers * per_layer + enc_dec)

    params_s = init_params(_key_spec(), cfg)
    opt_s = opt.init(params_s)
    prep = replicated_like(params_s)
    ospec = replicated_like(opt_s)
    args = (params_s, opt_s, batch, _key_spec())
    in_specs = (prep, ospec, bspec, P())
    out_specs = (prep, ospec, {"loss": P()})
    return Cell(arch, shape, "train", fn, args, in_specs, out_specs, cfg, mf, init_params, opt)


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------
def _recsys_cell(arch, shape, mesh_axes_names, smoke=False, overrides=None):
    from repro_torch.models.bert4rec import init_params
    from repro_torch.roofline.flops import recsys_flops

    mod = importlib.import_module("repro_torch.configs.bert4rec")
    cfg = mod.SMOKE if smoke else mod.FULL
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    sh = dict(RECSYS_SHAPES[shape])
    if smoke:
        sh["batch"] = 4
        sh["cands"] = min(sh.get("cands", 64), 64)
    bp = batch_axes(mesh_axes_names)
    axes = tuple(mesh_axes_names)
    pspec = lm_param_specs(cfg.backbone, mesh_axes_names)
    params_s = init_params(_key_spec(), cfg)
    B, S = sh["batch"], cfg.seq_len
    mf = recsys_flops(cfg, sh["kind"], B, sh.get("cands", 0))
    opt = None

    if sh["kind"] == "train":
        opt = get_optimizer("adamw", 1e-3)
        opt_s = opt.init(params_s)
        batch = {"items": _sds((B, S), torch.int32)}
        fn = steps_mod.make_recsys_train_step(cfg, opt)
        args = (params_s, opt_s, batch, _key_spec())
        ospec = opt_state_specs("adamw", pspec)
        in_specs = (pspec, ospec, {"items": P(bp, None)}, P())
        out_specs = (pspec, ospec, {"loss": P()})
    else:
        C = sh["cands"]
        if not smoke and C >= 1_000_000:
            C = _pad_to(C, 1024)  # even sharding over 512 devices (pad ids repeat)
        if sh["per_user"]:
            batch = {
                "items": _sds((B, S), torch.int32),
                "candidates": _sds((B, C), torch.int32),
            }
            bspec = {"items": P(bp, None), "candidates": P(bp, None)}
            out_specs = P(bp, None)
        else:
            batch = {
                "items": _sds((B, S), torch.int32),
                "candidates": _sds((C,), torch.int32),
            }
            big_c = C >= 1_000_000
            bspec = {
                "items": P(bp, None) if B > 1 else P(None, None),
                "candidates": P(axes) if big_c else P(None),
            }
            out_specs = P(None, axes) if big_c else P(bp, None)
        fn = steps_mod.make_recsys_score_step(cfg)
        args = (params_s, batch)
        in_specs = (pspec, bspec)
    return Cell(arch, shape, sh["kind"], fn, args, in_specs, out_specs, cfg, mf, init_params, opt)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------
def build_cell(
    arch: str,
    shape: str,
    mesh_axes_names=("data", "model"),
    smoke: bool = False,
    overrides: Optional[dict] = None,
) -> Cell:
    if arch in LM_ARCHS:
        return _lm_cell(arch, shape, mesh_axes_names, smoke, overrides)
    if arch in GNN_ARCHS or arch in EQV_ARCHS:
        return _gnn_cell(arch, shape, mesh_axes_names, smoke, overrides)
    if arch == "bert4rec":
        return _recsys_cell(arch, shape, mesh_axes_names, smoke, overrides)
    raise ValueError(arch)
