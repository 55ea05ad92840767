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
  ``temp_bytes``, the step's peak less its new outputs: on a CUDA device
  the peak the allocator gave out beyond what was held before the step;
  elsewhere ``LiveBytes``' peak of the storages the step's ops made;
* ``collectives``: none on one card, so ``wire_bytes_total`` is 0.

``roofline.report.roofline_terms`` and ``roofline.tables.table`` read the
record as they read the reference's. A batch cut from the cell's (a cell
too large for one card) scales ``model_flops`` and the analytic flops by
``batch_scale``, the batch that ran over the cell's: every LM and recsys
formula is linear in the batch. ``python -m repro_torch.roofline.tables``
renders a directory of such records.

``count_step`` runs the three counters (flops, bytes, live storage) around
one call; the dry run (``launch/dryrun.py``) uses it on a cell's ``meta``
arguments. ``record`` refuses ``meta`` arguments (see its docstring).
"""
from __future__ import annotations

import dataclasses
import weakref

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


class _Counter(TorchDispatchMode):
    """A mode that runs each aten op and hands it, with its results, to
    ``count``."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.count(func, args, kwargs, out)
        return out


class ByteCounter(_Counter):
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

    def count(self, func, args, kwargs, out):
        skip = self._skip.get(func)
        if skip is None:
            ret = func._schema.returns
            skip = self._skip[func] = func in _VIEWS or func in _ALLOCATES or bool(
                ret and ret[0].alias_info is not None and not ret[0].alias_info.is_write)
        if skip:
            return
        outs = out if isinstance(out, (list, tuple)) else (out,)
        if func in _GATHERS:
            self.bytes += _tensor_bytes((*args[1:], *kwargs.values())) + 2 * _tensor_bytes(outs)
        elif func in _UNREAD_FIRST:
            self.bytes += _tensor_bytes((*args[1:], *kwargs.values())) + _tensor_bytes(outs)
        else:
            self.bytes += _tensor_bytes((*args, *kwargs.values())) + _tensor_bytes(outs)
        self.ops += 1


class LiveBytes(_Counter):
    """The peak of the bytes held at once by the storages that the ops
    under it make. Each op result's storage (``untyped_storage()``, keyed by
    its ``_cdata``: a view shares its base's, and an in-place op returns a
    storage already there) adds its ``nbytes()`` when it first appears and
    is taken off when it is freed, by a weak reference's callback (PyTorch
    keeps a storage's Python object alive as long as any tensor holds the
    storage). The storages of ``held``, the step's arguments, add nothing.
    Autograd's saved tensors keep their storages alive until the backward
    frees them, so they count. Shapes alone decide the count, so a ``meta``
    run gives a CPU or CUDA run's; what a kernel allocates inside one op
    (a library's workspace) is not seen."""

    def __init__(self, held=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._known = {t.untyped_storage()._cdata for t in held}
        self._refs: dict = {}

    def count(self, func, args, kwargs, out):
        for t in out if isinstance(out, (list, tuple)) else (out,):
            if isinstance(t, torch.Tensor):
                self._add(t.untyped_storage())

    def _add(self, storage):
        key = storage._cdata
        if key in self._known:
            return
        n = storage.nbytes()
        self._known.add(key)
        self._refs[key] = weakref.ref(storage, lambda _, key=key, n=n: self._free(key, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key, n):
        self.live -= n
        self._known.discard(key)
        del self._refs[key]


_CIA = torch._C.DispatchKey.CompositeImplicitAutograd


def _plain(func, args, kwargs):
    return func(*args, **kwargs)


class _Flops(TorchDispatchMode):
    """``FlopCounterMode``'s total, by its rules and its formulas
    (``flop_registry``), without its per-module bookkeeping: an op that
    has a ``CompositeImplicitAutograd`` kernel is decomposed under this
    mode and its parts counted; every other op counts its formula, if it
    has one, on its operands and results."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self._registry = FlopCounterMode(display=False).flop_registry
        self._decomposes: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.run(func, args, kwargs or {})

    def run(self, func, args, kwargs, runner=_plain):
        """``func`` run by ``runner(func, args, kwargs)``, counted."""
        dec = self._decomposes.get(func)
        if dec is None:
            dec = self._decomposes[func] = func is not torch.ops.prim.device.default and (
                _CIA in func.py_kernels
                or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), _CIA))
        if dec:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = runner(func, args, kwargs)
        formula = self._registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


class _MetaShapes:
    """Runs an aten op; on ``meta`` operands, an op whose results are
    fresh tensors (no operand or result aliased or written in its schema,
    and no result sharing an operand's storage when first run) runs once
    for each set of operand shapes, strides, dtypes and other arguments,
    and after that its results are new ``meta`` tensors of the shapes,
    strides and dtypes it gave. A ``meta`` op computes only those, many of
    them in Python (``torch._refs``), so the trace is the same and
    faster."""

    _SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
                torch.memory_format)

    def __init__(self):
        self._fresh: dict = {}
        self._results: dict = {}

    def _key(self, x):
        if isinstance(x, torch.Tensor):
            if x.device.type != "meta":
                raise TypeError
            return (tuple(x.shape), x.stride(), x.dtype)
        if isinstance(x, self._SCALARS):
            return (type(x), x)
        if isinstance(x, (list, tuple)):
            return (type(x), tuple(self._key(y) for y in x))
        raise TypeError

    def __call__(self, func, args, kwargs):
        fresh = self._fresh.get(func)
        if fresh is None:
            schema = func._schema
            fresh = self._fresh[func] = bool(schema.returns) and not schema.is_mutable and all(
                a.alias_info is None for a in (*schema.arguments, *schema.returns)) and all(
                str(r.type) == "Tensor" for r in schema.returns)
        if not fresh:
            return func(*args, **kwargs)
        try:
            key = (func, self._key(args), self._key(tuple(sorted(kwargs.items()))))
        except TypeError:
            return func(*args, **kwargs)
        got = self._results.get(key)
        if got is not None:
            outs = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                    for shape, stride, dtype in got[1]]
            return tuple(outs) if got[0] else outs[0]
        out = func(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        ins = {t.untyped_storage()._cdata for t in _leaves((args, kwargs))}
        if any(t.untyped_storage()._cdata in ins for t in outs):
            self._fresh[func] = False  # aliases though its schema does not say so
        elif all(t.is_meta for t in outs):
            self._results[key] = (isinstance(out, tuple),
                                  [(tuple(t.shape), t.stride(), t.dtype) for t in outs])
        return out


class StepCounter(TorchDispatchMode):
    """``_Flops``, ``ByteCounter`` and ``LiveBytes`` in one mode, so an op
    passes through Python once: each op the mode receives counts its bytes
    and storage, and its flops by ``_Flops``' rules (``flops=False`` leaves
    them out); on ``meta`` arguments (``held``) ops run through
    ``_MetaShapes``. The counts equal those of the three modes stacked,
    ``FlopCounterMode`` innermost (a test holds them equal)."""

    def __init__(self, held=(), flops: bool = True):
        super().__init__()
        self.flops = _Flops() if flops else None
        self.moved = ByteCounter()
        self.live = LiveBytes(held)
        self._run = _MetaShapes() if any(t.is_meta for t in held) else _plain

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.flops is None:
            out = self._run(func, args, kwargs)
        else:
            out = self.flops.run(func, args, kwargs, self._run)
        self.moved.count(func, args, kwargs, out)
        self.live.count(func, args, kwargs, out)
        return out


def _leaves(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors) -> int:
    """The bytes of the distinct storages (by ``_cdata``, which a ``meta``
    storage has too) under ``tensors``."""
    return sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in tensors}.values())


def _new_out_bytes(out, held) -> int:
    """The bytes of the storages of ``out``'s tensors that are not one of
    ``held``'s."""
    keys = {t.untyped_storage()._cdata for t in held}
    return _storage_bytes([t for t in _leaves(out) if t.untyped_storage()._cdata not in keys])


def batch_scale(cell: cells.Cell, args) -> float:
    """The batch in ``args`` over the batch of the cell's own arguments: the
    leading axis of the step's ``tokens`` or ``items``; 1 for graphs."""
    for want, got in zip(cell.args, args):
        if isinstance(want, dict):
            for name in ("tokens", "items"):
                if name in want:
                    return got[name].shape[0] / want[name].shape[0]
    return 1.0


@dataclasses.dataclass
class StepCount:
    """One counted call, in Python integers: ``FlopCounterMode``'s flops,
    ``ByteCounter``'s bytes and data-moving aten ops, ``LiveBytes``' peak,
    and the bytes of the storages of the outputs that are not an
    argument's (``new_out_bytes``)."""

    flops: int
    bytes: int
    ops: int
    peak: int
    new_out_bytes: int

    @property
    def temp_bytes(self) -> int:
        """The peak less the new outputs (``record``'s definition on CUDA)."""
        return max(self.peak - self.new_out_bytes, 0)


def count_step(fn, args, flops: bool = True) -> tuple:
    """Run ``fn(*args)`` once under ``StepCounter``: (its outputs, a
    ``StepCount``). ``flops=False`` counts no flops (0). On ``meta``
    arguments this is a shape-only trace (``launch/dryrun.py``)."""
    held = _leaves(args)
    with StepCounter(held, flops) as c:
        out = fn(*args)
    return out, StepCount(c.flops.total if c.flops else 0, c.moved.bytes, c.moved.ops,
                          c.live.peak, _new_out_bytes(out, held))


def record(cell: cells.Cell, args, smoke: bool = False) -> dict:
    """Run ``cell.fn(*args)`` once, counted, and return its record (module
    docstring). ``args`` are tensors on one device, shaped as
    ``cell.args`` (the batch may be cut); ``smoke`` says the cell was built
    with ``smoke=True``. ``meta`` arguments are refused: a record is of a
    step that ran on a device; the dry run (``launch/dryrun.py``) records a
    ``meta`` step, per rank of its mesh."""
    dev = next(iter(_leaves(args))).device
    if dev.type == "meta":
        raise ValueError("count.record runs a step on a device; for meta arguments "
                         "use repro_torch.launch.dryrun")
    on_cuda = dev.type == "cuda"
    arg_keys = {t.untyped_storage()._cdata for t in _leaves(args)}
    if on_cuda:
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out, n = count_step(cell.fn, args)
    if on_cuda:
        torch.cuda.synchronize(dev)
        temp = max(torch.cuda.max_memory_allocated(dev) - held - n.new_out_bytes, 0)
    else:
        temp = n.temp_bytes
    aliased = [t for t in _leaves(out) if t.untyped_storage()._cdata in arg_keys]
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
            "output_bytes": n.new_out_bytes,
            "temp_bytes": temp,
            "alias_bytes": _storage_bytes(aliased),
        },
        "cost": {
            "flops": float(n.flops),
            "bytes_accessed": float(n.bytes),
            "flops_analytic_total": None if analytic is None else analytic * scale,
            "aten_ops": n.ops,
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
    meta = dev.type == "meta"
    cfg = cell.config
    g = np.random.default_rng(seed)
    gen = None if meta else torch.Generator(dev).manual_seed(seed)

    def ints(t, lo, hi, shape=None):
        if meta:
            return torch.empty(shape or tuple(t.shape), dtype=torch.int32, device=dev)
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
