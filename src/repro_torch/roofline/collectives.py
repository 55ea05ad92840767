"""Collective traffic of a dry-run record: the port's counterpart of
``repro.roofline.hlo``'s pricing. The reference parses XLA's partitioned
module for every collective and its replica groups; the port has no
partitioner and produces no such text, so the parser is not ported. Here
each collective is a ``Collective`` (kind, result bytes a shard, group
size), priced by the same ring formulas (wire bytes a chip):

    all-gather        : out_bytes * (g-1)/g    (out = the gathered buffer)
    reduce-scatter    : out_bytes * (g-1)      (out = one shard's piece)
    all-reduce        : 2 * out_bytes * (g-1)/g  (reduce-scatter + all-gather)
    all-to-all        : out_bytes * (g-1)/g
    collective-permute: out_bytes

``collective_stats`` sums a list of them into the reference's dict
(``counts``, ``out_bytes``, ``wire_bytes``, ``wire_bytes_total``). The
collectives come from one of two sources, which the record names
(``source``):

* ``counted`` (the stream cells): ``recording()`` logs every call the
  plans of ``core/distributed.py`` make to its collectives while it is
  active: ``_all_to_all`` (an all-to-all of one member's buffer),
  ``_all_gather`` (an all-gather, its result the members' tensors joined)
  and ``_psum`` (an all-reduce of one member's tensor). These are the
  plan's own collectives, exactly. The recording wraps the three functions
  for the length of the block and passes every call through unchanged.
* ``derived`` (the model cells): ``derive(cell, mesh_shape)`` reads the
  cell's ``in_specs`` and the step's kind by three rules, and the record
  lists those that gave a collective (``rules``):

  (a) in a train step, each parameter leaf's gradient is all-reduced at
      its local bytes over the batch axes (``train/sharding.py::
      batch_axes``) that do not shard it;
  (b) a parameter leaf sharded over ``"data"`` (fsdp) is all-gathered over
      ``"data"`` before use, and in a train step its gradient is
      reduce-scattered over ``"data"``;
  (c) an LM's dense blocks all-reduce the local (batch, seq, d_model)
      activation over ``"model"`` after each row-parallel product (``wo``,
      ``wd``, ``s_wd`` of ``lm_param_specs``, where ``"model"`` shards
      their input dimension), once in the forward pass; a train step adds
      the backward's and, under ``remat``, the recompute's, each of its
      ``grad_accum`` micro-batches at its share of the batch.

  Collectives these rules do not cover are left out: an MoE's expert
  all-to-all, the GNN and recsys activations, the loss's reductions. The
  derived term is a floor of the partition the rules describe, not of
  every partition: XLA may pick another, such as gathering small weights
  in place of reducing activations (``PERF.md`` §6 sets the two side by
  side).
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import NamedTuple

from repro_torch.configs.cells import LM_ARCHS
from repro_torch.core import distributed as dist
from repro_torch.train.sharding import (batch_axes, local_bytes, local_shape, spec_axes,
                                        spec_leaves)


class Collective(NamedTuple):
    kind: str  # "all-gather", "reduce-scatter", "all-reduce", "all-to-all", "collective-permute"
    out_bytes: int  # the result's bytes on one shard
    group: int  # the members of one group


def wire_bytes(c: Collective) -> float:
    """The ring algorithm's bytes on the wire for one chip (module docstring)."""
    g = c.group
    if c.kind == "all-gather":
        return c.out_bytes * (g - 1) / g
    if c.kind == "reduce-scatter":
        return c.out_bytes * (g - 1)
    if c.kind == "all-reduce":
        return 2 * c.out_bytes * (g - 1) / g
    if c.kind == "all-to-all":
        return c.out_bytes * (g - 1) / g
    if c.kind == "collective-permute":
        return c.out_bytes
    raise ValueError(f"unknown collective {c.kind!r}")


def collective_stats(calls) -> dict:
    """Per-kind counts, result bytes and wire bytes a chip, and their total:
    ``repro.roofline.hlo.collective_stats``' dict."""
    counts, out_bytes, wire = defaultdict(int), defaultdict(int), defaultdict(float)
    for c in calls:
        counts[c.kind] += 1
        out_bytes[c.kind] += c.out_bytes
        wire[c.kind] += wire_bytes(c)
    return {"counts": dict(counts), "out_bytes": dict(out_bytes), "wire_bytes": dict(wire),
            "wire_bytes_total": float(sum(wire.values()))}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def recording():
    """Log the collectives of ``core/distributed.py``'s plans run inside
    the block: yields the list that each call appends its ``Collective``
    to."""
    calls: list[Collective] = []
    a2a, gather, psum = dist._all_to_all, dist._all_gather, dist._psum

    def all_to_all(mesh, group, bufs):
        calls.append(Collective("all-to-all", _nbytes(bufs[0]), len(group)))
        return a2a(mesh, group, bufs)

    def all_gather(mesh, group, xs, dim=0, stack=False):
        calls.append(Collective("all-gather", sum(_nbytes(x) for x in xs), len(group)))
        return gather(mesh, group, xs, dim, stack)

    def all_reduce(mesh, group, xs):
        calls.append(Collective("all-reduce", _nbytes(xs[0]), len(group)))
        return psum(mesh, group, xs)

    dist._all_to_all, dist._all_gather, dist._psum = all_to_all, all_gather, all_reduce
    try:
        yield calls
    finally:
        dist._all_to_all, dist._all_gather, dist._psum = a2a, gather, psum


# the row-parallel products of an LM block: "model" shards their input dimension
ROW_PARALLEL = ("wo", "wd", "s_wd")


def derive(cell, mesh_shape: dict) -> tuple[list, list]:
    """The collectives of ``cell``'s step on a mesh of ``mesh_shape`` (axis
    name -> size) by rules (a)-(c) of the module docstring, and the rules
    that gave any: (calls, rule letters)."""
    train = cell.kind == "train"
    bp = batch_axes(tuple(mesh_shape))
    calls, rules = [], []

    def add(rule, kind, nbytes, axes):
        g = 1
        for a in axes:
            g *= mesh_shape[a]
        if g > 1 and nbytes:
            calls.append(Collective(kind, nbytes, g))
            if rule not in rules:
                rules.append(rule)

    pspecs = cell.in_specs[0]
    for t, spec in spec_leaves(cell.args[0], pspecs):
        local = local_bytes(t, spec, mesh_shape)
        sharded = spec_axes(spec)
        if "data" in sharded:
            add("b", "all-gather", local * mesh_shape["data"], ("data",))
            if train:
                add("b", "reduce-scatter", local, ("data",))
        if train:
            add("a", "all-reduce", local, tuple(a for a in bp if a not in sharded))

    if cell.arch in LM_ARCHS and "model" in mesh_shape:
        cfg = cell.config
        batch = next(b for b in cell.args[1:] if isinstance(b, dict) and "tokens" in b)
        bspec = next(s for s in cell.in_specs[1:] if isinstance(s, dict) and "tokens" in s)
        b_local, seq = local_shape(batch["tokens"].shape, bspec["tokens"], mesh_shape)
        n_row = sum(1 for name in ROW_PARALLEL
                    if name in pspecs and "model" in spec_axes(pspecs[name][1:2]))
        passes, micro = 1, 1
        if train:
            passes = 2 + (1 if cfg.remat else 0)
            micro = max(getattr(cfg, "grad_accum", 1), 1)
        act = -(-b_local // micro) * seq * cfg.d_model * cfg.dtype.itemsize
        for _ in range(cfg.n_layers * n_row * passes * micro):
            add("c", "all-reduce", act, ("model",))
    return calls, rules

