"""A one-card record of a real step: the counterpart of the reference's
dry-run analysis (``repro.launch.dryrun._analyze``), which reads a step's
cost from XLA's compiled module. Here the step runs, eagerly, on the tensors
it is given, and is counted op by op as it runs:

* ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  attention products, convolutions, the backward's included);
* ``cost.bytes_accessed``: a ``TorchDispatchMode`` that adds up the bytes of
  every aten op's tensor operands and results (each operand once and each
  result once an op; a broadcast operand counts its distinct elements).
  Ops that move nothing count nothing: views (their result aliases an
  operand; ``_unsafe_view`` too, which a 3-D by 2-D product and a reshape
  that copies end with, though its schema does not say it aliases) and
  ops that only allocate (``empty``, ``empty_like``, ``new_empty``,
  ``empty_strided``). Some operands are not read: a gather reads the rows
  it returns, not its whole source; ``zeros_like`` and its kind read only
  their operand's shape; ``copy_``, ``fill_`` and ``zero_`` overwrite their
  target. Eager PyTorch fuses nothing, so this is the traffic the step asks
  of memory; the card's 50 MB L2 serves some of it, so it is an upper bound
  on the HBM traffic;
* ``cost.flops_analytic_total``: ``roofline.flops.cell_analytic_flops``
  (None for a smoke cell, whose shapes are not its shape table's: the
  count is then the step's flops);
* ``memory``: the arguments' bytes, the outputs' (``alias_bytes`` for those
  that share an argument's storage, as the decode step's cache does), and
  on a CUDA device the peak the step allocated beyond what was held before
  it (``temp_bytes``: that peak less the new outputs; 0 elsewhere, where no
  allocator statistics exist);
* ``collectives``: none on one card, so ``wire_bytes_total`` is 0.

``roofline.report.roofline_terms`` and ``roofline.tables.table`` read the
record as they read the reference's. A batch cut from the cell's (a cell
too large for one card) scales ``model_flops`` and the analytic flops by
``batch_scale``, the batch that ran over the cell's: every LM and recsys
formula is linear in the batch. ``python -m repro_torch.roofline.tables``
renders a directory of such records.

``count_step`` runs the two counters around one call; the dry run
(``launch/dryrun.py``) uses it on a cell's ``meta`` arguments. ``record``
refuses ``meta`` arguments (see its docstring).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import rng
from repro_torch.configs import cells
from repro_torch.roofline.flops import cell_analytic_flops


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements (a stride-0 axis counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensor_bytes(xs) -> int:
    """The bytes of the distinct tensors (by identity) among ``xs`` and the
    lists and tuples in it (an aten op's operands or results)."""
    seen = {}
    for x in xs:
        if isinstance(x, torch.Tensor):
            seen[id(x)] = x
        elif isinstance(x, (list, tuple)):
            seen.update((id(y), y) for y in x if isinstance(y, torch.Tensor))
    return sum(_nbytes(t) for t in seen.values())


_aten = torch.ops.aten
# views whose schema does not mark the result as an alias
_VIEWS = {_aten._unsafe_view.default}
# ops that only allocate: their result is not written
_ALLOCATES = {_aten.empty.memory_format, _aten.empty_like.default, _aten.new_empty.default,
              _aten.empty_strided.default, _aten.new_empty_strided.default}
# gathers: their source (operand 0) is read only where the result comes from
_GATHERS = {_aten.index.Tensor, _aten.index_select.default, _aten.gather.default,
            _aten.embedding.default}
# ops that do not read operand 0: they take its shape, or overwrite it
_UNREAD_FIRST = {_aten.zeros_like.default, _aten.ones_like.default, _aten.full_like.default,
                 _aten.new_zeros.default, _aten.new_ones.default, _aten.new_full.default,
                 _aten.rand_like.default, _aten.randn_like.default, _aten.copy_.default,
                 _aten.fill_.Scalar, _aten.fill_.Tensor, _aten.zero_.default}


class ByteCounter(TorchDispatchMode):
    """Adds up the bytes of each aten op's tensor operands and results, and
    counts the ops that move data (module docstring): views (ops whose
    result aliases an input without writing it, and ``_unsafe_view``) and
    ops that only allocate are skipped; a gather's source counts as the
    bytes it returns; operand 0 of ``_UNREAD_FIRST`` is not read."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self._skip: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        skip = self._skip.get(func)
        if skip is None:
            ret = func._schema.returns
            skip = self._skip[func] = func in _VIEWS or func in _ALLOCATES or bool(
                ret and ret[0].alias_info is not None and not ret[0].alias_info.is_write)
        if skip:
            return out
        outs = out if isinstance(out, (list, tuple)) else (out,)
        if func in _GATHERS:
            self.bytes += _tensor_bytes((*args[1:], *kwargs.values())) + 2 * _tensor_bytes(outs)
        elif func in _UNREAD_FIRST:
            self.bytes += _tensor_bytes((*args[1:], *kwargs.values())) + _tensor_bytes(outs)
        else:
            self.bytes += _tensor_bytes((*args, *kwargs.values())) + _tensor_bytes(outs)
        self.ops += 1
        return out


def _leaves(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors) -> int:
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}.values())


def batch_scale(cell: cells.Cell, args) -> float:
    """The batch in ``args`` over the batch of the cell's own arguments: the
    leading axis of the step's ``tokens`` or ``items``; 1 for graphs."""
    for want, got in zip(cell.args, args):
        if isinstance(want, dict):
            for name in ("tokens", "items"):
                if name in want:
                    return got[name].shape[0] / want[name].shape[0]
    return 1.0


def count_step(fn, args) -> tuple:
    """Run ``fn(*args)`` once under both counters: (its outputs, the flops
    of ``FlopCounterMode``, the bytes and the data-moving aten ops of
    ``ByteCounter``). On ``meta`` arguments this is a shape-only trace
    (``launch/dryrun.py``)."""
    with FlopCounterMode(display=False) as flops, ByteCounter() as moved:
        out = fn(*args)
    return out, float(flops.get_total_flops()), float(moved.bytes), moved.ops


def record(cell: cells.Cell, args, smoke: bool = False) -> dict:
    """Run ``cell.fn(*args)`` once, counted, and return its record (module
    docstring). ``args`` are tensors on one device, shaped as
    ``cell.args`` (the batch may be cut); ``smoke`` says the cell was built
    with ``smoke=True``. ``meta`` arguments are refused: every ``meta``
    storage's ``data_ptr`` is 0, so the memory fields, which tell storages
    apart by it, would fold every argument into one; the dry run
    (``launch/dryrun.py``) records a ``meta`` step."""
    dev = next(iter(_leaves(args))).device
    if dev.type == "meta":
        raise ValueError("count.record runs a step on a device; meta arguments have no "
                         "storage to measure (use repro_torch.launch.dryrun)")
    on_cuda = dev.type == "cuda"
    arg_ptrs = {t.untyped_storage().data_ptr() for t in _leaves(args)}
    if on_cuda:
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out, flops, moved, ops = count_step(cell.fn, args)
    if on_cuda:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - held
    outs = _leaves(out)
    new_outs = [t for t in outs if t.untyped_storage().data_ptr() not in arg_ptrs]
    aliased = [t for t in outs if t.untyped_storage().data_ptr() in arg_ptrs]
    out_bytes = _storage_bytes(new_outs)
    scale = batch_scale(cell, args)
    analytic = None if smoke else cell_analytic_flops(cell)
    return {
        "arch": cell.arch,
        "shape": cell.shape,
        "mesh": "card",
        "chips": 1,
        "device": torch.cuda.get_device_name(dev) if on_cuda else dev.type,
        "smoke": smoke,
        "batch_scale": scale,
        "memory": {
            "argument_bytes": _storage_bytes(_leaves(args)),
            "output_bytes": out_bytes,
            "temp_bytes": max(peak - out_bytes, 0) if on_cuda else 0,
            "alias_bytes": _storage_bytes(aliased),
        },
        "cost": {
            "flops": flops,
            "bytes_accessed": moved,
            "flops_analytic_total": None if analytic is None else analytic * scale,
            "aten_ops": ops,
        },
        "collectives": {"counts": {}, "out_bytes": {}, "wire_bytes": {},
                        "wire_bytes_total": 0.0},
        "model_flops": cell.model_flops * scale,
        "ok": True,
    }


def materialize(cell: cells.Cell, device, seed: int = 0, batch: int | None = None) -> tuple:
    """Tensors on ``device`` for ``cell.args``: the family's ``init_params``
    from ``rng.PRNGKey(seed)``, the optimizer's fresh state, the step's key
    ``PRNGKey(seed + 7)``, and a batch from numpy's generator at ``seed``
    that is valid for the model (the reference smoke tests' ranges): tokens
    and labels in the vocabulary, items and candidates in ``[1, n_items)``,
    graph edges between existing nodes, class labels, coordinates, a decode
    cache filled at 0.02 scale with ``pos`` 3. ``batch`` cuts the leading
    batch axis of the step's sequences (and the decode cache's)."""
    dev = torch.device(device)
    cfg = cell.config
    g = np.random.default_rng(seed)
    gen = torch.Generator(dev).manual_seed(seed)

    def ints(t, lo, hi, shape=None):
        return torch.from_numpy(g.integers(lo, hi, shape or tuple(t.shape)).astype(np.int32)).to(dev)

    def normal(t, shape=None, scale=0.02):
        x = torch.randn(shape or tuple(t.shape), generator=gen, dtype=t.dtype, device=dev)
        return x.mul_(scale)

    def cut(t, axis=0):
        shape = list(t.shape)
        if batch is not None:
            shape[axis] = batch
        return tuple(shape)

    def fill(name, t, step_batch):
        if name in ("tokens", "labels") and "tokens" in step_batch:
            return ints(t, 0, cfg.vocab, cut(t))
        if name == "items" or (name == "candidates" and t.dim() == 2):
            return ints(t, 1, cfg.n_items, cut(t))
        if name == "candidates":
            return ints(t, 1, cfg.n_items)
        if name == "edge_index":
            return ints(t, 0, step_batch["node_feats"].shape[0])
        if name == "labels":
            return ints(t, 0, cfg.n_classes)
        if name in ("label_mask", "edge_mask"):
            return torch.ones(t.shape, dtype=t.dtype, device=dev)
        if name == "coords":
            return normal(t, scale=1.0)
        if name == "energy":
            return torch.tensor(1.5, dtype=t.dtype, device=dev)
        return normal(t)  # node_feats, targets

    params = cell.init_params(rng.PRNGKey(seed, dev), cfg)
    out = [params]
    for i, want in enumerate(cell.args[1:], 1):
        if cell.kind == "train" and i == 1:
            out.append(cell.optimizer.init(params))
        elif isinstance(want, torch.Tensor):  # the step's key
            out.append(rng.PRNGKey(seed + 7, dev))
        elif "pos" in want:  # the decode cache
            out.append({"k": normal(want["k"], cut(want["k"], 1)),
                        "v": normal(want["v"], cut(want["v"], 1)),
                        "pos": torch.tensor(3, dtype=torch.int32, device=dev)})
        else:
            out.append({k: fill(k, t, want) for k, t in want.items()})
    return tuple(out)
