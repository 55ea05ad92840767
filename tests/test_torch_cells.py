"""The port's cell builders and sharding rules against the JAX reference on
the CPU: ``train/sharding.py``'s spec trees, every one of the 40 cells at
full and smoke size (kind, useful-work floor, analytic flops, every
argument leaf's shape and dtype, in and out specs), the abstract build's
cost (shapes only, on ``meta``), and one step of every smoke case.

Specs are compared through ``tuple(spec)``: jax's ``PartitionSpec`` is not a
tuple, the port's ``P`` is. Trees are compared by key (the reference's trees
flatten with sorted keys). Dtypes map once, in ``DTYPES``: the reference's
key is two uint32 words, the port's the same words in int64
(``rng.PRNGKey``). ``model_flops`` and the analytic flops use the same
expressions in the same order, so they are equal floats. The one step run
in both packages is float32 (the SMOKE dtype overridden), its loss within
1e-5 relative: the two packages' float32 matmuls, exp and reductions sum in
other orders (``tests/test_torch_train.py``'s margin).
"""
import math
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import repro  # noqa: E402,F401  -- enables x64, as the reference's CLIs run
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import cells as jcells  # noqa: E402
from repro.roofline import flops as jflops  # noqa: E402
from repro.train import sharding as jsharding  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs import cells  # noqa: E402
from repro_torch.roofline import count  # noqa: E402
from repro_torch.roofline import flops  # noqa: E402
from repro_torch.train import sharding  # noqa: E402

DTYPES = {
    jnp.dtype(jnp.bfloat16): torch.bfloat16,
    jnp.dtype(jnp.float32): torch.float32,
    jnp.dtype(jnp.int32): torch.int32,
    jnp.dtype(bool): torch.bool,
    jnp.dtype(jnp.uint32): torch.int64,  # the key: two uint32 words
}
MESHES = [("data", "model"), ("pod", "data", "model")]
ALL = cells.all_cells()


def assert_specs_equal(want, got, path="specs"):
    """A reference spec tree against the port's, by key."""
    if isinstance(want, JP):
        assert isinstance(got, sharding.P), (path, got)
        assert tuple(got) == tuple(want), (path, tuple(got), tuple(want))
    elif want is None:
        assert got is None, path
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_specs_equal(want[k], got[k], f"{path}.{k}")
    else:
        assert isinstance(want, (tuple, list)) and len(got) == len(want), (path, got)
        for i, (w, g) in enumerate(zip(want, got)):
            assert_specs_equal(w, g, f"{path}[{i}]")


def assert_args_equal(want, got, path="args"):
    """A reference ShapeDtypeStruct tree against the port's meta tensors."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_args_equal(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_args_equal(w, g, f"{path}[{i}]")
    else:
        assert got.is_meta, path
        assert tuple(got.shape) == tuple(want.shape), (path, tuple(got.shape), want.shape)
        assert got.dtype == DTYPES[jnp.dtype(want.dtype)], (path, got.dtype, want.dtype)


def _configs(arch):
    import importlib

    jmod, _ = jcells.LM_ARCHS[arch]
    tmod, _ = cells.LM_ARCHS[arch]
    return importlib.import_module(jmod).FULL, importlib.import_module(tmod).FULL


@pytest.mark.parametrize("axes", MESHES, ids=len)
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", list(cells.LM_ARCHS))
def test_lm_spec_trees_match_jax(arch, fsdp, axes):
    jcfg, tcfg = _configs(arch)
    want = jsharding.lm_param_specs(jcfg, axes, fsdp=fsdp)
    got = sharding.lm_param_specs(tcfg, axes, fsdp=fsdp)
    assert_specs_equal(want, got)
    for opt in ("adamw", "sgd", "adafactor"):
        assert_specs_equal(jsharding.opt_state_specs(opt, want),
                           sharding.opt_state_specs(opt, got), opt)
    assert_specs_equal(jsharding.replicated_like(want), sharding.replicated_like(got))
    assert sharding.batch_axes(axes) == jsharding.batch_axes(axes)
    with pytest.raises(ValueError):
        sharding.opt_state_specs("lion", got)


def test_P_canonicalises_as_jax():
    for entries in [(), (None,), ("data", None), (("data",), None), ((), "model"),
                    (("pod", "data"), None, "model")]:
        assert tuple(sharding.P(*entries)) == tuple(JP(*entries)), entries
    assert sharding.P(("data",)) == sharding.P("data")
    assert repr(sharding.P("data", None)) == "P('data', None)"


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch,shape", ALL)
def test_cell_matches_jax(arch, shape, smoke):
    for axes in MESHES:
        want = jcells.build_cell(arch, shape, axes, smoke=smoke)
        got = cells.build_cell(arch, shape, axes, smoke=smoke)
        assert (got.arch, got.shape, got.kind) == (want.arch, want.shape, want.kind)
        assert got.model_flops == want.model_flops
        assert flops.cell_analytic_flops(got) == jflops.cell_analytic_flops(want)
        assert_args_equal(want.args, got.args)
        assert_specs_equal(want.in_specs, got.in_specs, "in_specs")
        assert_specs_equal(want.out_specs, got.out_specs, "out_specs")
        assert got.config.name == want.config.name


def test_cell_overrides_and_unknown_arch():
    got = cells.build_cell("smollm-135m", "train_4k", smoke=True,
                           overrides={"dtype": torch.float32})
    assert got.args[0]["embed"].dtype == torch.float32
    gat = cells.build_cell("gat-cora", "full_graph_sm", smoke=True,
                           overrides={"dtype": "bfloat16"})
    assert gat.config.dtype == torch.bfloat16
    assert gat.args[0]["layer0"]["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        cells.build_cell("resnet", "train_4k")


def test_all_40_full_cells_build_on_meta_in_seconds():
    t0 = time.perf_counter()
    built = [cells.build_cell(a, s) for a, s in ALL]
    seconds = time.perf_counter() - t0
    assert len(built) == 40
    assert seconds < 10, seconds
    n = 0
    for c in built:
        for t in count._leaves(c.args):
            assert t.is_meta, (c.arch, c.shape)
            n += t.numel()
    kimi = next(c for c in built if c.arch == "kimi-k2-1t-a32b" and c.kind == "train")
    assert sum(t.numel() for t in count._leaves(kimi.args[0])) > 10**12
    assert n > 4 * 10**12  # kimi-k2's params in each of its 4 cells, none allocated


@pytest.mark.parametrize("arch", ["smollm-135m", "kimi-k2-1t-a32b", "gat-cora", "mace", "bert4rec"])
def test_meta_draws_give_the_real_draws_shapes(arch):
    """On a meta key every draw is shapes only; on a real key it is the
    draw (the goldens of test_torch_rng, _models and _gnn pin its bits)."""
    cell = cells.build_cell(arch, cells.arch_shapes(arch)[0], smoke=True)
    real = cell.init_params(rng.PRNGKey(0), cell.config)
    meta = cell.init_params(torch.empty(2, dtype=torch.int64, device="meta"), cell.config)
    assert [(tuple(t.shape), t.dtype) for t in count._leaves(real)] == \
        [(tuple(t.shape), t.dtype) for t in count._leaves(meta)]
    key = torch.empty(3, 2, dtype=torch.int64, device="meta")
    for got, shape, dtype in [(rng.split(key, 5), (3, 5, 2), torch.int64),
                              (rng.fold_in(key, 4), (3, 2), torch.int64),
                              (rng.fold_in(key[0], torch.arange(6)), (6, 2), torch.int64),
                              (rng.bits32(key, (4,)), (3, 4), torch.int64),
                              (rng.uniform(key, (4, 2), minval=-1.0, maxval=1.0), (3, 4, 2),
                               torch.float32),
                              (rng.randint32(key, 9, (7,)), (3, 7), torch.int32)]:
        assert got.is_meta and tuple(got.shape) == shape and got.dtype == dtype


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(t.float()).all()) for t in count._leaves(tree)
               if t.is_floating_point())


@pytest.mark.parametrize("arch,shape", cells.SMOKE_CASES)
def test_smoke_case_one_step(arch, shape):
    """The reference's smoke cases (tests/test_archs_smoke.py), the port
    alone: one step of each on the CPU, finite, shapes kept, params
    changed where the step trains."""
    cell = cells.build_cell(arch, shape, smoke=True)
    args = count.materialize(cell, "cpu", seed=42)
    out = cell.fn(*args)
    if cell.kind == "train":
        params, opt_state, metrics = out
        assert math.isfinite(float(metrics["loss"])) and _finite(params) and _finite(opt_state)
        before, after = count._leaves(args[0]), count._leaves(params)
        assert [t.shape for t in before] == [t.shape for t in after]
        assert max(float((a.float() - b.float()).abs().max()) for a, b in zip(before, after)) > 0
    elif cell.kind == "prefill":
        assert out.dim() == 3 and _finite(out)
    elif cell.kind == "decode":
        logits, cache = out
        assert logits.shape[0] == args[2]["tokens"].shape[0] and _finite(logits)
        assert cache["k"].shape == args[1]["k"].shape and int(cache["pos"]) == 4
    else:
        assert out.shape == (args[1]["items"].shape[0], args[1]["candidates"].shape[-1])
        assert _finite(out)


def test_lm_train_smoke_step_matches_jax():
    """smollm-135m train_4k at SMOKE size, float32, in both packages on the
    same params (each package's init_params from seed 0: bit-identical) and
    tokens: the losses within 1e-5 relative. (The new params are not
    compared: adamw's first step is nearly ``lr * sign(g)``, so a gradient
    near zero that differs in its last bit moves a whole step.)"""
    jcell = jcells.build_cell("smollm-135m", "train_4k", smoke=True,
                              overrides={"dtype": jnp.float32})
    tcell = cells.build_cell("smollm-135m", "train_4k", smoke=True,
                             overrides={"dtype": torch.float32})
    from repro.models.transformer import init_params as jinit
    from repro.train.optimizer import get_optimizer as jopt
    from repro_torch.models.transformer import init_params as tinit
    from repro_torch.train.optimizer import get_optimizer as topt

    g = np.random.default_rng(3)
    toks = g.integers(0, tcell.config.vocab, (2, 4, 16)).astype(np.int32)
    jp = jinit(jax.random.PRNGKey(0), jcell.config)
    tp = tinit(rng.PRNGKey(0), tcell.config)
    jout = jax.jit(jcell.fn)(jp, jopt("adamw", 1e-2).init(jp),
                             {"tokens": jnp.asarray(toks[0]), "labels": jnp.asarray(toks[1])},
                             jax.random.PRNGKey(7))
    tout = tcell.fn(tp, topt("adamw", 1e-2).init(tp),
                    {"tokens": torch.from_numpy(toks[0]), "labels": torch.from_numpy(toks[1])},
                    rng.PRNGKey(7))
    jl, tl = float(jout[2]["loss"]), float(tout[2]["loss"])
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
