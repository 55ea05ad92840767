"""Sharding rules (``repro.train.sharding``): param, batch and optimizer
state PartitionSpec trees per architecture family.

Baseline policy:
  * batch dims over ("pod", "data"); tensor-parallel over "model".
  * LM: attention QKV/O sharded on the flattened head dim; FFN on d_ff; MoE
    experts over "model" (EP) when their count divides by 16; vocab over
    "model" when divisible, else the embedding's d dim.
  * optimizer state mirrors its param's spec (adafactor's factored vectors
    drop the corresponding axis).

A spec is the port's own ``P``: a tuple with one entry per dimension, each
``None``, a mesh axis name or a tuple of names; ``P()`` is replicated. The
one-process meshes of ``launch/mesh.py`` read specs in this form
(``train/elastic.py``), and the cells (``configs/cells.py``) carry them.
``local_shape``, ``local_bytes`` and ``spec_leaves`` read a tree of specs
against its tensors, as the dry run does (``launch/dryrun.py``).
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import tree_map


class P(tuple):
    """A PartitionSpec: ``P("data", None)``. An entry that is a tuple of
    one name is that name and an empty tuple is ``None``, as jax
    canonicalises them, so ``P(("data",), None) == P("data", None)``."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e

        return super().__new__(cls, (canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


def batch_axes(axes) -> tuple:
    return tuple(a for a in axes if a in ("pod", "data"))


def lm_param_specs(cfg: TransformerConfig, axes, fsdp: bool = False) -> dict:
    """PartitionSpec tree matching ``init_params(cfg)``. ``fsdp``
    additionally shards the largest dims over 'data' (ZeRO-3-style fully
    sharded params)."""
    tp = "model"
    dp = "data" if fsdp else None
    v_ok = cfg.vocab % 16 == 0
    specs = {
        "embed": P(tp, dp) if v_ok else P(dp, tp),
        "ln_f": P(None),
        "ln1": P(None, None),
        "ln2": P(None, None),
        "wq": P(None, dp, tp),
        "wk": P(None, dp, tp),
        "wv": P(None, dp, tp),
        "wo": P(None, tp, dp),
    }
    if cfg.norm == "ln":
        specs |= {"ln1_b": P(None, None), "ln2_b": P(None, None), "ln_f_b": P(None)}
    if cfg.qkv_bias:
        specs |= {"bq": P(None, tp), "bk": P(None, tp), "bv": P(None, tp)}
    if cfg.qk_norm:
        specs |= {"q_norm": P(None, None), "k_norm": P(None, None)}
    if cfg.pos == "learned":
        specs |= {"pos_embed": P(None, None)}
    if not cfg.tie_embeddings:
        specs |= {"unembed": P(dp, tp) if v_ok else P(tp, dp)}
    if cfg.moe is None:
        specs |= {
            "wg": P(None, dp, tp),
            "wu": P(None, dp, tp),
            "wd": P(None, tp, dp),
        }
    else:
        ep = tp if cfg.moe.n_experts % 16 == 0 else None
        specs |= {
            "router": P(None, None, ep),
            "e_wg": P(None, ep, dp, None),
            "e_wu": P(None, ep, dp, None),
            "e_wd": P(None, ep, None, dp),
        }
        if cfg.moe.n_shared > 0:
            specs |= {
                "s_wg": P(None, dp, tp),
                "s_wu": P(None, dp, tp),
                "s_wd": P(None, tp, dp),
            }
    return specs


def opt_state_specs(opt_name: str, param_specs) -> dict:
    """Mirror param specs onto the optimizer state of ``opt_name``
    (``train/optimizer.py``'s keys)."""
    if opt_name == "adamw":
        return {"m": param_specs, "v": param_specs, "count": P()}
    if opt_name == "sgd":
        return {"mu": param_specs}
    if opt_name == "adafactor":

        def fac_spec(spec):
            if len(spec) >= 2:
                return {"vr": P(*spec[:-1]), "vc": P(*(spec[:-2] + spec[-1:]))}
            return {"v": spec}

        return {"f": tree_map(fac_spec, param_specs), "count": P()}
    raise ValueError(opt_name)


def replicated_like(tree):
    """``P()`` for every leaf of a dict tree (tensors or specs)."""
    return tree_map(lambda _: P(), tree)


def spec_axes(spec) -> tuple:
    """The mesh axes a spec shards over, in the order its entries name them."""
    out = []
    for e in spec:
        out += [e] if isinstance(e, str) else list(e or ())
    return tuple(out)


def local_shape(shape, spec, mesh_shape: dict) -> tuple:
    """One shard's block of a ``shape`` laid out by ``spec`` over a mesh of
    ``mesh_shape`` (axis name -> size): each sharded dimension ceil-divided
    by the product of its axes' sizes, as jax lays a dimension out; the
    dimensions past the spec's entries are whole."""
    out = list(shape)
    for i, e in enumerate(spec):
        if e is not None:
            k = 1
            for a in ([e] if isinstance(e, str) else e):
                k *= mesh_shape[a]
            out[i] = -(-out[i] // k)
    return tuple(out)


def local_bytes(t, spec, mesh_shape: dict) -> int:
    """The bytes of one shard's block of tensor ``t`` (``local_shape``)."""
    n = 1
    for d in local_shape(t.shape, spec, mesh_shape):
        n *= d
    return n * t.element_size()


def spec_leaves(tree, specs):
    """(tensor, spec) for every tensor leaf of ``tree`` with the spec tree
    that lays it out: dicts matched by key, tuples and lists by position."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from spec_leaves(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        if len(tree) != len(specs):
            raise ValueError(f"a tree of {len(tree)} entries against {len(specs)} specs")
        for v, s in zip(tree, specs):
            yield from spec_leaves(v, s)
