"""The port's GNN and equivariant families, the sparse embedding ops, the
k-hop sampler and the streamed-feature GNN against the JAX reference on
the CPU, at the ``SMOKE`` sizes.

Tolerances, and why:

* ``init_params``, ``sample_khop``, ``hash_bucket_lookup`` and
  ``embedding_bag``'s max mode: bit-identical (the same draws, the same
  numpy, integer arithmetic, a maximum).
* ``embedding_bag``'s sum and mean: within 1e-6 relative (the packages'
  scatter-adds may add a bag's rows in another order).
* Forwards in float32 on the reference's weights (carried by
  ``interop.from_jax_param_tree``): within ``FWD_TOL = 1e-5`` of the
  largest |output|. The two packages' matmuls, exp and segment sums add
  in other orders; 1e-5 is about a hundred float32 ulps of the largest
  entry.
* Losses within ``LOSS_RTOL = 1e-5`` relative; each leaf's gradient within
  ``GRAD_TOL = 1e-4`` of that leaf's largest |g|, the LM tests' margin (a
  backward doubles the chain of roundings of a forward).
* Three adamw steps of each step builder: each step's loss within
  ``STEP_LOSS_RTOL = 1e-4`` relative (adamw's first steps are nearly
  ``lr * sign(g)``, so a gradient that differs in its last bits near zero
  moves a param by up to 2 lr; losses, not params, are compared).
* EGNN and MACE energies under a random rotation plus translation of the
  coordinates, with params and inputs cast to float64: within ``INV_RTOL
  = 1e-6`` relative, EGNN's output coordinates rotated with them within
  1e-6 of their largest |x|. The energy is a sum of per-atom terms of
  both signs, so float32 rounding of the rotated coordinates could move
  it by a share of itself far above that; in float64 only the MLPs' silu
  still rounds to float32 (as in the reference), which moves a symmetric
  model by float32 rounding of the activations at most, while MACE-lite's
  broken symmetry moves it by ~3e-4 (ROADMAP C.6).
* The streamed-feature GNN: ``triangles/edge`` equal (the estimator state
  is bit-identical). At a small size, each of 5 GAT steps' loss within
  ``STEP_LOSS_RTOL``. At the example's own size (60 adamw steps at lr
  5e-3 on raw degree features) free-running losses are no oracle: on the
  same params the two packages' loss and gradients agree within
  ``LOSS_RTOL`` and ``GRAD_TOL`` at every step, yet the trajectories part
  (1.6e-3 relative at step 20, 2% at step 59), and so does the reference
  against itself with its edge list permuted (4.7% at step 59). So the
  golden file keeps the reference's params at steps 0, 20, 40 and 59, and
  the port is held to each step's loss (``LOSS_RTOL``) and gradient norms
  (``GRAD_TOL``) from them.

``src/repro_torch/golden/gnn_small.json`` (the reference's float32 inputs,
outputs, step-0 loss, gradient norms and 3 adamw steps' losses for every
SMOKE arch, bert4rec's cloze draws and scores, the sampler's arrays, and
``examples/gnn_features.py``'s density, losses and the params of four of
its steps at its own size; ``chip_smoke.py``
phases golden_gnn and gnn_features replay it on the card) is rewritten
with ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_gnn.py
--write``.
"""
import dataclasses
import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import repro  # noqa: E402,F401  -- enables x64, as the reference runs
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import bert4rec as jcfg_b4r  # noqa: E402
from repro.configs import egnn as jcfg_egnn  # noqa: E402
from repro.configs import gat_cora as jcfg_gat  # noqa: E402
from repro.configs import graphcast as jcfg_gc  # noqa: E402
from repro.configs import mace as jcfg_mace  # noqa: E402
from repro.core import bulk_update_all_jit, estimate as jestimate, init_state as jinit_state  # noqa: E402
from repro.data import graph_stream as jgs  # noqa: E402
from repro.data import sampler as jsampler  # noqa: E402
from repro.models import bert4rec as jb4r  # noqa: E402
from repro.models import embedding as jemb  # noqa: E402
from repro.models import equivariant as jeqv  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs import bert4rec as tcfg_b4r  # noqa: E402
from repro_torch.configs import egnn as tcfg_egnn  # noqa: E402
from repro_torch.configs import gat_cora as tcfg_gat  # noqa: E402
from repro_torch.configs import graphcast as tcfg_gc  # noqa: E402
from repro_torch.configs import mace as tcfg_mace  # noqa: E402
from repro_torch.configs.cells import GNN_SMOKE_SHAPES  # noqa: E402
from repro_torch.data import sampler as tsampler  # noqa: E402
from repro_torch.interop import from_jax_param_tree  # noqa: E402
from repro_torch.launch import gnn_features  # noqa: E402
from repro_torch.models import bert4rec as tb4r  # noqa: E402
from repro_torch.models import embedding as temb  # noqa: E402
from repro_torch.models import equivariant as teqv  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

FWD_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STEP_LOSS_RTOL = 1e-4
INV_RTOL = 1e-6
LR = 1e-3  # the reference cells' adamw
GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "gnn_small.json"
# the sampled graphcast batch: seeds x fanouts give minibatch_lg's smoke
# shape (16 + 32 + 128 = 176 node slots, 32 + 128 = 160 edge slots)
SAMPLE = {"graph_nodes": 300, "graph_edges": 1200, "seeds": 16, "fanouts": [2, 4]}
# examples/gnn_features.py at its own size, and the test's small size
EXAMPLE = {"n": 1500, "k": 6, "graph_seed": 3, "r": 50_000, "batch": 2048, "steps": 60,
           "lr": 5e-3}
EXAMPLE_SMALL = {"n": 200, "k": 4, "graph_seed": 3, "r": 4096, "batch": 256, "steps": 5,
                 "lr": 5e-3}
# the example's steps whose starting params the golden file keeps: the card
# replays each step's loss and gradient from the reference's params
TEACHER_STEPS = (0, 20, 40, 59)


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed; stored in the golden file for the card's replay)
# ---------------------------------------------------------------------------
def classification_batch(shape: str, seed: int) -> dict:
    """A node-classification graph at a smoke shape: a ring (every node
    receives a message), random edges and 4 padding edges at N."""
    sh = GNN_SMOKE_SHAPES[shape]
    N, E, F, C = sh["n_nodes"], sh["n_edges"], sh["d_feat"], sh["n_classes"]
    g = np.random.default_rng(seed)
    ring = np.stack([np.arange(N), (np.arange(N) + 1) % N])
    ei = np.concatenate([ring, g.integers(0, N, (2, E - N - 4)), np.full((2, 4), N)], 1)
    return {"node_feats": g.normal(size=(N, F)).astype(np.float32),
            "edge_index": ei.astype(np.int32),
            "labels": g.integers(0, C, N).astype(np.int32),
            "label_mask": (g.random(N) < 0.7).astype(np.float32)}


def sampled_graph(seed: int) -> tuple:
    g = np.random.default_rng(seed)
    edges = g.integers(0, SAMPLE["graph_nodes"], (SAMPLE["graph_edges"], 2))
    seeds = g.choice(SAMPLE["graph_nodes"], SAMPLE["seeds"], replace=False)
    return edges, seeds, g


def regression_batch(seed: int, sampler=tsampler) -> dict:
    """graphcast's batch: a ``sample_khop`` subgraph of a random graph,
    normal features and 9 regression targets a node slot."""
    edges, seeds, g = sampled_graph(seed)
    csr = sampler.CSRGraph(SAMPLE["graph_nodes"], edges)
    nodes, ei, mask, n_real = sampler.sample_khop(csr, seeds, SAMPLE["fanouts"], g)
    N = len(nodes)
    return {"node_feats": g.normal(size=(N, 12)).astype(np.float32),
            "edge_index": ei, "targets": g.normal(size=(N, 9)).astype(np.float32)}


def molecule_batch(d: int, seed: int) -> dict:
    """An equivariant batch at the molecule smoke shape: atom features of
    the config's width, coordinates, 4 padding edges at N (clamped to the
    last atom) and two more masked edges."""
    sh = GNN_SMOKE_SHAPES["molecule"]
    N, E = sh["n_nodes"], sh["n_edges"]
    g = np.random.default_rng(seed)
    ei = np.concatenate([g.integers(0, N, (2, E - 4)), np.full((2, 4), N)], 1)
    mask = np.ones(E, bool)
    mask[-4:] = False
    mask[g.choice(E - 4, 2, replace=False)] = False
    return {"node_feats": g.normal(size=(N, d)).astype(np.float32),
            "coords": (1.5 * g.normal(size=(N, 3))).astype(np.float32),
            "edge_index": ei.astype(np.int32), "edge_mask": mask,
            "energy": np.float32(g.normal())}


def item_batch(cfg, B: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, cfg.n_items, (B, cfg.seq_len)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the archs: (jax cfg, port cfg, batch, the loss and forward of each side)
# ---------------------------------------------------------------------------
def _jeqv_forward(cfg):
    def fwd(p, b):
        args = (b["node_feats"], b["coords"], b["edge_index"], b["edge_mask"])
        if cfg.kind == "egnn":
            e, x = jeqv.egnn_forward(p, cfg, *args)
            return jnp.concatenate([e.reshape(1), x.reshape(-1)])
        return jeqv.mace_forward(p, cfg, *args).reshape(1)
    return fwd


def _teqv_forward(cfg):
    def fwd(p, b):
        args = (b["node_feats"], b["coords"], b["edge_index"], b["edge_mask"])
        if cfg.kind == "egnn":
            e, x = teqv.egnn_forward(p, cfg, *args)
            return torch.cat([e.reshape(1), x.reshape(-1)])
        return teqv.mace_forward(p, cfg, *args).reshape(1)
    return fwd


def arch_case(name: str, **overrides) -> dict:
    """Everything a parity test needs for one SMOKE arch (name as in the
    golden file), float32."""
    if name.startswith("gat-cora"):
        shape = name.split(":")[1]
        sh = GNN_SMOKE_SHAPES[shape]
        jc = dataclasses.replace(jcfg_gat.smoke(sh["d_feat"], sh["n_classes"]), **overrides)
        tc = dataclasses.replace(tcfg_gat.smoke(sh["d_feat"], sh["n_classes"]), **overrides)
        batch = classification_batch(shape, 1)
    elif name.startswith("graphcast"):
        jc = dataclasses.replace(jcfg_gc.smoke(12, 9), remat=True, **overrides)
        tc = dataclasses.replace(tcfg_gc.smoke(12, 9), remat=True, **overrides)
        batch = regression_batch(2)
    elif name.startswith("mpnn"):  # graphcast's processor under another aggregator
        agg = name.split(":")[1]
        sh = GNN_SMOKE_SHAPES["full_graph_sm"]
        jc = dataclasses.replace(jcfg_gc.smoke(sh["d_feat"], sh["n_classes"]), aggregator=agg)
        tc = dataclasses.replace(tcfg_gc.smoke(sh["d_feat"], sh["n_classes"]), aggregator=agg)
        batch = classification_batch("full_graph_sm", 3)
    elif name in ("egnn", "mace"):
        jc = {"egnn": jcfg_egnn, "mace": jcfg_mace}[name].SMOKE
        tc = {"egnn": tcfg_egnn, "mace": tcfg_mace}[name].SMOKE
        batch = molecule_batch(jc.d_hidden, 4)
    else:
        raise ValueError(name)
    if name in ("egnn", "mace"):
        return {"jcfg": jc, "tcfg": tc, "batch": batch, "family": "eqv",
                "jinit": jeqv.init_params, "tinit": teqv.init_params,
                "jfwd": _jeqv_forward(jc), "tfwd": _teqv_forward(tc),
                "jloss": lambda p, b: jeqv.energy_loss(
                    p, jc, b["node_feats"], b["coords"], b["edge_index"], b["edge_mask"],
                    b["energy"]),
                "tloss": lambda p, b: teqv.energy_loss(
                    p, tc, b["node_feats"], b["coords"], b["edge_index"], b["edge_mask"],
                    b["energy"]),
                "jstep": jsteps.make_equivariant_train_step,
                "tstep": tsteps.make_equivariant_train_step}
    if "targets" in batch:
        jloss = lambda p, b: jgnn.regression_loss(  # noqa: E731
            p, jc, b["node_feats"], b["edge_index"], b["targets"])
        tloss = lambda p, b: tgnn.regression_loss(  # noqa: E731
            p, tc, b["node_feats"], b["edge_index"], b["targets"])
    else:
        jloss = lambda p, b: jgnn.node_classification_loss(  # noqa: E731
            p, jc, b["node_feats"], b["edge_index"], b["labels"], b["label_mask"])
        tloss = lambda p, b: tgnn.node_classification_loss(  # noqa: E731
            p, tc, b["node_feats"], b["edge_index"], b["labels"], b["label_mask"])
    return {"jcfg": jc, "tcfg": tc, "batch": batch, "family": "gnn",
            "jinit": jgnn.init_params, "tinit": tgnn.init_params,
            "jfwd": lambda p, b: jgnn.forward(p, jc, b["node_feats"], b["edge_index"]),
            "tfwd": lambda p, b: tgnn.forward(p, tc, b["node_feats"], b["edge_index"]),
            "jloss": jloss, "tloss": tloss,
            "jstep": jsteps.make_gnn_train_step, "tstep": tsteps.make_gnn_train_step}


GOLDEN_ARCHS = ["gat-cora:full_graph_sm", "gat-cora:molecule", "graphcast", "egnn", "mace"]


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jbatch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b: dict, device="cpu") -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in b.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@functools.lru_cache(maxsize=None)
def jax_record(name: str) -> dict:
    """The reference in float32 with seed 0's weights: the forward, the
    step-0 loss and gradients, and the losses of 3 adamw steps at LR
    (``value_and_grad`` then ``opt.update``, its step builder's body)."""
    c = arch_case(name)
    jb = _jbatch(c["batch"])
    p = c["jinit"](jax.random.PRNGKey(0), c["jcfg"])
    fwd = _np(jax.jit(c["jfwd"])(p, jb))
    loss, g = jax.jit(jax.value_and_grad(c["jloss"]))(p, jb)
    opt = jopt.adamw(lr=LR)
    step = jax.jit(c["jstep"](c["jcfg"], opt))
    q, o, losses = p, opt.init(p), []
    for i in range(3):
        q, o, m = step(q, o, jb, jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    return {"params": jax.device_get(p), "forward": fwd, "loss": float(loss),
            "grads": {k: _np(v) for k, v in _flat(g)}, "step_losses": losses}


def _close_grads(got: dict, want: dict, name: str):
    got = dict(_flat(got))
    assert sorted(got) == sorted(want), name
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == w.shape, (name, k)
        scale = float(np.abs(w).max())
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= GRAD_TOL * scale or err == 0.0, (name, k, err, scale)


# ---------------------------------------------------------------------------
# init, forward, loss, gradients, steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["gat-cora:full_graph_sm", "graphcast", "egnn", "mace"])
def test_init_params_bit_identical(name):
    c = arch_case(name)
    for seed in (0, 1):
        want = dict(_flat(jax.device_get(c["jinit"](jax.random.PRNGKey(seed), c["jcfg"]))))
        got = dict(_flat(c["tinit"](rng.PRNGKey(seed), c["tcfg"])))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            assert got[k].numpy().dtype == w.dtype == np.float32 and got[k].shape == w.shape
            np.testing.assert_array_equal(got[k].numpy().view(np.uint32), w.view(np.uint32),
                                          err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", GOLDEN_ARCHS + ["mpnn:mean", "mpnn:max"])
def test_forward_loss_and_grads_match_jax(name):
    """On the reference's weights (carried by ``from_jax_param_tree``);
    graphcast with remat on, the processor also under mean and max."""
    c = arch_case(name)
    ref = jax_record(name)
    tp = from_jax_param_tree(ref["params"], c["tcfg"])
    tb = tbatch(c["batch"])
    with torch.no_grad():
        out = c["tfwd"](tp, tb).numpy()
    scale = float(np.abs(ref["forward"]).max())
    assert np.isfinite(out).all() and out.shape == ref["forward"].shape
    assert float(np.abs(out - ref["forward"]).max()) <= FWD_TOL * scale, name
    loss, grads = tsteps.value_and_grad(c["tloss"], tp, tb)
    assert abs(float(loss) - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"]), (
        name, float(loss), ref["loss"])
    _close_grads(grads, ref["grads"], name)


@pytest.mark.parametrize("name", GOLDEN_ARCHS)
def test_three_adamw_steps_of_the_step_builders_match_jax(name):
    c = arch_case(name)
    ref = jax_record(name)
    tp = from_jax_param_tree(ref["params"], c["tcfg"])
    opt = topt.adamw(lr=LR)
    step = c["tstep"](c["tcfg"], opt)
    st, tb, losses = opt.init(tp), tbatch(c["batch"]), []
    for i in range(3):
        tp, st, m = step(tp, st, tb, rng.PRNGKey(i))
        losses.append(float(m["loss"]))
    for a, b in zip(losses, ref["step_losses"]):
        assert abs(a - b) <= STEP_LOSS_RTOL * abs(b), (name, losses, ref["step_losses"])
    assert int(st["count"]) == 3


def test_remat_gradients_bit_identical():
    c = arch_case("graphcast")
    tp = c["tinit"](rng.PRNGKey(3), c["tcfg"])
    tb = tbatch(c["batch"])
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(c["tcfg"], remat=remat)
        out.append(tsteps.value_and_grad(
            lambda p, b: tgnn.regression_loss(p, cfg, b["node_feats"], b["edge_index"],
                                              b["targets"]), tp, tb))
    assert torch.equal(out[0][0], out[1][0])
    for (k, a), (_, b) in zip(_flat(out[0][1]), _flat(out[1][1])):
        assert torch.equal(a, b), k


def test_param_tree_converter_keeps_shapes_and_refuses_other_dtypes():
    c = arch_case("graphcast")
    ref = jax_record("graphcast")["params"]
    tp = from_jax_param_tree(ref, c["tcfg"])
    assert sorted(k for k, _ in _flat(tp)) == sorted(k for k, _ in _flat(ref))
    assert tp["layer1"]["edge"]["w0"].shape == (96, 32)
    bad = jax.tree.map(lambda x: x, ref)
    bad["layer0"]["node"]["b1"] = np.zeros(32, np.float64)
    with pytest.raises(ValueError, match="layer0/node/b1"):
        from_jax_param_tree(bad, c["tcfg"])


@pytest.mark.parametrize("name", ["gat_cora", "graphcast", "egnn", "mace", "bert4rec"])
def test_configs_equal_the_references(name):
    """FULL and SMOKE (``full(d_in, n_classes)``/``smoke(..)`` for the GNNs)
    field for field, the dtype the same float32."""
    import importlib

    jm = importlib.import_module(f"repro.configs.{name}")
    tm = importlib.import_module(f"repro_torch.configs.{name}")
    if hasattr(jm, "FULL"):
        pairs = [(jm.FULL, tm.FULL), (jm.SMOKE, tm.SMOKE)]
    else:
        pairs = [(jm.full(1433, 7), tm.full(1433, 7)), (jm.smoke(12, 5), tm.smoke(12, 5))]
    for jc, tc in pairs:
        j, t = dataclasses.asdict(jc), dataclasses.asdict(tc)
        assert (j.pop("dtype"), t.pop("dtype")) == (jnp.float32, torch.float32)
        assert j == t


def test_cell_tables_equal_the_references():
    from repro.configs import cells as jcells
    from repro_torch.configs import cells as tcells

    for k in ("LM_SHAPES", "GNN_SHAPES", "GNN_SMOKE_SHAPES", "RECSYS_SHAPES", "ALL_ARCHS"):
        assert getattr(tcells, k) == getattr(jcells, k), k
    for k in ("GNN_ARCHS", "EQV_ARCHS"):
        assert getattr(tcells, k) == {a: m.replace("repro.", "repro_torch.", 1)
                                      for a, m in getattr(jcells, k).items()}, k
    assert tcells.LM_ARCHS == {a: (m.replace("repro.", "repro_torch.", 1), o)
                               for a, (m, o) in jcells.LM_ARCHS.items()}
    assert tcells.all_cells() == jcells.all_cells() and len(tcells.all_cells()) == 40
    for arch in tcells.ALL_ARCHS:
        assert tcells.arch_shapes(arch) == jcells.arch_shapes(arch)
    with pytest.raises(ValueError):
        tcells.arch_shapes("nope")


# ---------------------------------------------------------------------------
# equivariance
# ---------------------------------------------------------------------------
def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def _eqv64(name):
    """The arch in float64: the port's config, seed 0's params cast up,
    and the batch's float arrays cast up."""
    c = arch_case(name)
    cfg = dataclasses.replace(c["tcfg"], dtype=torch.float64)
    tp = topt.tree_map(lambda x: x.double(), c["tinit"](rng.PRNGKey(0), c["tcfg"]))
    b = {k: v.astype(np.float64) if v.dtype == np.float32 else v
         for k, v in c["batch"].items()}
    return c, cfg, tp, b


def _energy(tp, cfg, b):
    tb = tbatch(b)
    args = (tb["node_feats"], tb["coords"], tb["edge_index"], tb["edge_mask"])
    with torch.no_grad():
        if cfg.kind == "egnn":
            return teqv.egnn_forward(tp, cfg, *args)
        return teqv.mace_forward(tp, cfg, *args), None


@pytest.mark.parametrize("name", ["egnn", "mace"])
def test_energy_invariant_under_rotation_and_translation(name):
    """EGNN under a rotation plus a translation: the energy unchanged and
    the output coordinates moved with the input. MACE-lite under the
    translation; its rotations are the next test's (ROADMAP C.6)."""
    _, cfg, tp, b = _eqv64(name)
    R = _rotation(5) if name == "egnn" else np.eye(3)
    t = np.array([0.7, -1.3, 2.1])
    e0, x0 = _energy(tp, cfg, b)
    e1, x1 = _energy(tp, cfg, dict(b, coords=b["coords"] @ R.T + t))
    assert abs(float(e1) - float(e0)) <= INV_RTOL * abs(float(e0)), (float(e0), float(e1))
    if cfg.kind == "egnn":
        want = x0.numpy() @ R.T + t
        assert np.abs(x1.numpy() - want).max() <= INV_RTOL * np.abs(want).max()


def test_mace_lite_rotation_invariance_is_broken_as_in_the_reference(monkeypatch):
    """ROADMAP C.6: the reference's MACE-lite energy is not invariant under
    rotations, and the port reproduces it. In float64 a rotation moves the
    energy by ~3e-4 of itself in both packages alike. The causes are three:
    the radial MLP gives each m of an l its own weight, the l = 2 harmonics
    lack their relative factors (sqrt(3) on xy, yz, xz; 1/2 on 3z^2 - 1;
    sqrt(3)/2 on x^2 - y^2), and a zero-length edge (a self loop) gives a
    Y20 that does not rotate. With all three mended the port's energy is
    invariant to INV_RTOL."""
    c, cfg, tp, b = _eqv64("mace")
    R, t = _rotation(5), np.array([0.7, -1.3, 2.1])
    moved = dict(b, coords=b["coords"] @ R.T + t)
    e0, e1 = (float(_energy(tp, cfg, bb)[0]) for bb in (b, moved))
    jc = dataclasses.replace(c["jcfg"], dtype=jnp.float64)
    jp = jax.tree.map(lambda x: jnp.asarray(np.asarray(x.numpy()), jnp.float64), tp)
    j0, j1 = (float(jeqv.mace_forward(jp, jc, *(jnp.asarray(bb[k]) for k in (
        "node_feats", "coords", "edge_index", "edge_mask")))) for bb in (b, moved))
    # not invariant, and alike: both packages' MLPs take silu in float32,
    # so they agree to float32's rounding, far inside the rotation's move
    assert abs(e1 - e0) > 1e-6 * abs(e0) and abs(j1 - j0) > 1e-6 * abs(j0)
    assert abs(e0 - j0) <= LOSS_RTOL * abs(j0) and abs(e1 - j1) <= LOSS_RTOL * abs(j1)
    assert abs((e1 - e0) - (j1 - j0)) <= 0.1 * abs(j1 - j0)
    # mend the three causes: tie the radial weights of each l, normalise
    # the l = 2 harmonics, drop the self loops
    d = cfg.d_hidden
    for i in range(cfg.n_layers):
        rad = tp[f"layer{i}"]["radial"]
        w, bias = rad["w1"].reshape(d, 9, d).clone(), rad["b1"].reshape(9, d).clone()
        for lo, hi in ((1, 4), (4, 9)):
            w[:, lo:hi], bias[lo:hi] = w[:, lo:lo + 1], bias[lo:lo + 1]
        rad["w1"], rad["b1"] = w.reshape(d, 9 * d), bias.reshape(9 * d)
    s3 = np.sqrt(3.0)
    factors = torch.tensor([1, 1, 1, 1, s3, s3, 0.5, s3, s3 / 2], dtype=torch.float64)
    harmonics = teqv.real_sph_harm_l2
    monkeypatch.setattr(teqv, "real_sph_harm_l2", lambda u: harmonics(u) * factors)
    loops = b["edge_index"][0] == b["edge_index"][1]
    b = dict(b, edge_mask=b["edge_mask"] & ~loops)
    moved = dict(b, coords=b["coords"] @ R.T + t)
    e0, e1 = (float(_energy(tp, cfg, bb)[0]) for bb in (b, moved))
    assert abs(e1 - e0) <= INV_RTOL * abs(e0), (e0, e1)


# ---------------------------------------------------------------------------
# embedding ops and the sampler
# ---------------------------------------------------------------------------
def _bag_inputs():
    g = np.random.default_rng(0)
    table = g.normal(size=(10, 4)).astype(np.float32)
    table[3, 1] = 0.0  # a zero entry, which max mode with `valid` replaces
    idx = np.array([0, 3, 3, 12, -2, 7, 9, 1, 5, 4, 2, 8], np.int32)  # 12, -2 clipped
    seg = np.array([0, 0, 1, 1, 2, 4, -1, 5, 9, 2, 2, 1], np.int32)  # -1, 5, 9 dropped
    w = g.uniform(0.5, 2.0, size=12).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 1, 1, 1, 1, 1, 0, 1, 1], bool)
    return table, idx, seg, w, valid


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("extras", ["plain", "weights", "valid", "both"])
def test_embedding_bag_matches_jax_and_drops_bad_bag_ids(mode, extras):
    """5 bags; bag 3 is empty; bag ids -1, 5 and 9 are dropped; table ids
    12 and -2 are clipped into the table."""
    table, idx, seg, w, valid = _bag_inputs()
    kw_j, kw_t = {}, {}
    if extras in ("weights", "both"):
        kw_j["weights"], kw_t["weights"] = jnp.asarray(w), torch.from_numpy(w)
    if extras in ("valid", "both"):
        kw_j["valid"], kw_t["valid"] = jnp.asarray(valid), torch.from_numpy(valid)
    want = np.asarray(jemb.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                         jnp.asarray(seg), 5, mode=mode, **kw_j))
    got = temb.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                             torch.from_numpy(seg), 5, mode=mode, **kw_t).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (5, 4)
    if mode == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[3] == 0).all()  # the empty bag
    # the dropped rows add nothing: the same bags without them
    keep = (seg >= 0) & (seg < 5)
    sub = temb.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx[keep]),
                             torch.from_numpy(seg[keep]), 5, mode=mode,
                             **{k: v[torch.from_numpy(keep)] for k, v in kw_t.items()})
    torch.testing.assert_close(sub, torch.from_numpy(got), rtol=0, atol=0)


def test_segment_max_gradient_and_empty_segments():
    x = torch.tensor([[1.0, -2.0], [3.0, 0.5], [2.0, 4.0]], requires_grad=True)
    out = temb.segment_max(x, torch.tensor([0, 0, 2]), 4)
    assert torch.isinf(out[1]).all() and torch.isinf(out[3]).all() and (out[1] < 0).all()
    out[[0, 2]].sum().backward()
    torch.testing.assert_close(x.grad, torch.tensor([[0.0, 0.0], [1.0, 1.0], [1.0, 1.0]]))


def test_hash_bucket_lookup_wraps_as_uint32():
    table = np.random.default_rng(1).normal(size=(97, 3)).astype(np.float32)
    raw = np.array([0, 1, 12345, 2**31 - 1, 2**31, 2**31 + 7, 2**32 - 1, 2**32 + 5,
                    3 * 2**33 + 11, -1, -(2**31)], np.int64)
    want = np.asarray(jemb.hash_bucket_lookup(jnp.asarray(table), jnp.asarray(raw)))
    got = temb.hash_bucket_lookup(torch.from_numpy(table), torch.from_numpy(raw)).numpy()
    np.testing.assert_array_equal(got, want)
    want32 = np.asarray(jemb.hash_bucket_lookup(jnp.asarray(table),
                                                jnp.asarray(raw[:4].astype(np.int32))))
    got32 = temb.hash_bucket_lookup(torch.from_numpy(table),
                                    torch.from_numpy(raw[:4].astype(np.int32))).numpy()
    np.testing.assert_array_equal(got32, want32)


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_khop_arrays_equal(seed):
    edges, seeds, _ = sampled_graph(seed)
    jg, tg = (m.CSRGraph(SAMPLE["graph_nodes"], edges) for m in (jsampler, tsampler))
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.dst, jg.dst)
    want = jsampler.sample_khop(jg, seeds, SAMPLE["fanouts"], np.random.default_rng(seed))
    got = tsampler.sample_khop(tg, seeds, SAMPLE["fanouts"], np.random.default_rng(seed))
    assert got[3] == want[3] and got[0].shape == (176,) and got[1].shape == (2, 160)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # a vertex without neighbours is skipped, as in the reference
    iso = np.array([[0, 1], [1, 2]])
    for m in (jsampler, tsampler):
        nodes, ei, mask, n_real = m.sample_khop(m.CSRGraph(4, iso), np.array([3, 0]), [2],
                                                np.random.default_rng(0))
        assert n_real == 3 and mask.sum() == 1


# ---------------------------------------------------------------------------
# the streamed-feature GNN (examples/gnn_features.py)
# ---------------------------------------------------------------------------
def jax_gnn_features(n, k, graph_seed, r, batch, steps, lr, record_at=()) -> dict:
    """The example's code at the given size, on the reference; at each step
    of ``record_at``, the params that step starts from, their loss and
    gradient norms."""
    edges = jgs.barabasi_albert_stream(n=n, k=k, seed=graph_seed)
    state = jinit_state(r)
    key = jax.random.PRNGKey(0)
    for i, (W, nv) in enumerate(jgs.batches(edges, batch)):
        state = bulk_update_all_jit(state, jnp.asarray(W), jnp.int32(nv),
                                    jax.random.fold_in(key, i))
    tri = float(jestimate(state)) / len(edges)
    deg = np.zeros(n)
    for u, v in edges:
        deg[u] += 1
        deg[v] += 1
    feats = np.stack([deg, np.full(n, tri)], axis=1).astype(np.float32)
    labels = (deg > np.median(deg)).astype(np.int32)
    cfg = jgnn.GNNConfig(name="gat-feat", kind="gat", n_layers=2, d_hidden=8, n_heads=4,
                         d_in=2, n_classes=2, aggregator="attn")
    params = jgnn.init_params(jax.random.PRNGKey(1), cfg)
    opt = jopt.adamw(lr=lr)
    opt_state = opt.init(params)
    ei = jnp.asarray(np.concatenate([edges.T, edges.T[::-1]], axis=1), jnp.int32)
    nf, lab, mask = jnp.asarray(feats), jnp.asarray(labels), jnp.ones((n,), jnp.float32)
    vg = jax.jit(jax.value_and_grad(
        lambda p: jgnn.node_classification_loss(p, cfg, nf, ei, lab, mask)))
    update = jax.jit(opt.update)

    losses, teacher = [], {}
    for i in range(steps):
        loss, g = vg(params)  # the example's jitted step, in two jits
        if i in record_at:
            teacher[str(i)] = {"params": jax.device_get(params), "loss": float(loss),
                               "grad_norms": _grad_norms({k: _np(v) for k, v in _flat(g)})}
        params, opt_state = update(g, opt_state, params)
        losses.append(float(loss))
    return {"edges": len(edges), "triangles_per_edge": tri, "losses": losses,
            "teacher": teacher}


@pytest.mark.parametrize("r", [50_000, 600, 4096])
def test_estimate_matches_jax_at_group_sizes_not_a_power_of_two(r):
    """``jnp.mean`` multiplies a group's sum by the reciprocal of its size
    (XLA folds the division by a constant), which differs from a division
    in the last bit unless the size is a power of two; the port's
    ``estimate`` computes the same. r = 50,000 (the example's: 8 groups of
    6,250), 600 (8 of 75) and 4096 (8 of 512); a bank of two too."""
    from repro.core.state import EstimatorState as JState
    from repro_torch.core.estimate import estimate
    from repro_torch.core.state import EstimatorState as TState

    g = np.random.default_rng(r)
    chi = g.integers(0, 40, (2, r)).astype(np.int32)
    has = g.random((2, r)) < 0.3
    m = np.array([8860, 123457], np.int64)
    f = np.zeros((r, 2), np.int32)
    for t in range(2):
        want = float(jestimate(JState(jnp.asarray(f), jnp.asarray(chi[t]), jnp.asarray(f),
                                      jnp.asarray(has[t]), jnp.int64(m[t]))))
        got = estimate(TState(torch.from_numpy(f), torch.from_numpy(chi[t]),
                              torch.from_numpy(f), torch.from_numpy(has[t]),
                              torch.tensor(m[t])))
        assert got.dtype == torch.float64 and float(got) == want, (r, t, float(got), want)
        bank = estimate(TState(torch.from_numpy(np.stack([f, f])), torch.from_numpy(chi),
                               torch.from_numpy(np.stack([f, f])), torch.from_numpy(has),
                               torch.from_numpy(m)))
        assert float(bank[t]) == want


def test_gnn_features_composition_matches_jax():
    want = jax_gnn_features(**EXAMPLE_SMALL)
    lines = []
    got = gnn_features.run(**EXAMPLE_SMALL, device="cpu", echo=lines.append)
    assert got["triangles_per_edge"] == want["triangles_per_edge"] > 0
    assert got["edges"] == want["edges"]
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= STEP_LOSS_RTOL * abs(b), (got["losses"], want["losses"])
    assert lines[0] == f"streaming feature: triangles/edge = {want['triangles_per_edge']:.3f}"
    assert lines[-1] == f"final loss {got['losses'][-1]:.4f}"


# ---------------------------------------------------------------------------
# the golden record
# ---------------------------------------------------------------------------
B4R_B, B4R_CANDS, B4R_NEG = 4, 64, 1023


def jax_b4r_record() -> dict:
    """bert4rec SMOKE in float32, seed 0's weights: the cloze draws of the
    step-0 key, its loss and gradients, 3 adamw steps (keys PRNGKey(i)),
    and the candidate scores of both shapes."""
    cfg = jcfg_b4r.SMOKE
    items = item_batch(cfg, B4R_B, 7)
    g = np.random.default_rng(8)
    cand1 = g.integers(0, cfg.n_items + 2, B4R_CANDS).astype(np.int32)
    cand2 = g.integers(0, cfg.n_items + 2, (B4R_B, B4R_CANDS)).astype(np.int32)
    p = jb4r.init_params(jax.random.PRNGKey(0), cfg)
    key = jax.random.PRNGKey(0)
    km, kn = jax.random.split(key)
    mask = np.asarray(jax.random.uniform(km, items.shape, jnp.float32) < cfg.mask_frac)
    negs = np.asarray(jax.random.randint(kn, (B4R_NEG,), 1, cfg.n_items, dtype=jnp.int32))
    loss, gr = jax.jit(jax.value_and_grad(
        lambda q: jb4r.cloze_loss(q, cfg, jnp.asarray(items), key)))(p)
    opt = jopt.adamw(lr=LR)
    step = jax.jit(jsteps.make_recsys_train_step(cfg, opt))
    q, o, losses = p, opt.init(p), []
    for i in range(3):
        q, o, m = step(q, o, {"items": jnp.asarray(items)}, jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    score = jax.jit(jsteps.make_recsys_score_step(cfg))
    s1 = _np(score(p, {"items": jnp.asarray(items), "candidates": jnp.asarray(cand1)}))
    s2 = _np(score(p, {"items": jnp.asarray(items), "candidates": jnp.asarray(cand2)}))
    return {"params": jax.device_get(p), "items": items, "cand1": cand1, "cand2": cand2,
            "mask": mask, "negs": negs, "loss": float(loss),
            "grads": {k: _np(v) for k, v in _flat(gr)}, "step_losses": losses,
            "scores1": s1, "scores2": s2}


def _f(a) -> list:
    return np.asarray(a).tolist()


def _grad_norms(grads: dict) -> dict:
    return {k: float(np.linalg.norm(np.asarray(v, np.float64))) for k, v in grads.items()}


def _golden() -> dict:
    out = {"param_seed": 0, "lr": LR, "steps": 3, "fwd_tol": FWD_TOL, "loss_rtol": LOSS_RTOL,
           "grad_tol": GRAD_TOL, "step_loss_rtol": STEP_LOSS_RTOL, "archs": {}}
    for name in GOLDEN_ARCHS:
        r, c = jax_record(name), arch_case(name)
        out["archs"][name] = {
            "batch": {k: _f(v) for k, v in c["batch"].items()},
            "forward": _f(r["forward"]), "max_abs_forward": float(np.abs(r["forward"]).max()),
            "loss": r["loss"], "grad_norms": _grad_norms(r["grads"]),
            "step_losses": r["step_losses"]}
    b = jax_b4r_record()
    out["bert4rec"] = {
        "items": _f(b["items"]), "cand1": _f(b["cand1"]), "cand2": _f(b["cand2"]),
        "key_seed": 0, "n_neg": B4R_NEG, "mask": _f(b["mask"]), "negs": _f(b["negs"]),
        "loss": b["loss"], "grad_norms": _grad_norms(b["grads"]),
        "step_losses": b["step_losses"], "scores1": _f(b["scores1"]),
        "scores2": _f(b["scores2"]),
        "max_abs_score": float(max(np.abs(b["scores1"]).max(), np.abs(b["scores2"]).max()))}
    edges, seeds, _ = sampled_graph(0)
    nodes, ei, mask, n_real = jsampler.sample_khop(
        jsampler.CSRGraph(SAMPLE["graph_nodes"], edges), seeds, SAMPLE["fanouts"],
        np.random.default_rng(0))
    out["sampler"] = {**SAMPLE, "edges": _f(edges), "seeds": _f(seeds), "rng_seed": 0,
                      "nodes": _f(nodes), "edge_index": _f(ei), "edge_mask": _f(mask),
                      "n_real": n_real}
    ex = jax_gnn_features(**EXAMPLE, record_at=TEACHER_STEPS)
    out["gnn_features"] = {
        "args": EXAMPLE, "edges": ex["edges"], "triangles_per_edge": ex["triangles_per_edge"],
        "losses": ex["losses"], "loss_rtol": LOSS_RTOL, "grad_tol": GRAD_TOL,
        "teacher": {i: {"params": jax.tree.map(_f, t["params"]), "loss": t["loss"],
                        "grad_norms": t["grad_norms"]} for i, t in ex["teacher"].items()}}
    return out


def test_golden_gnn_small_is_the_reference():
    """``golden/gnn_small.json`` holds what the reference computes for the
    SMOKE archs (its inputs are this file's), and the port replays each
    arch's record within the stated tolerances, as phase golden_gnn does on
    the card; the port's streamed density at the example's size equals
    the record's, and each recorded step's loss and gradient norms from the
    reference's params are held as phase gnn_features holds them."""
    gold = json.loads(GOLDEN.read_text())
    for name in GOLDEN_ARCHS:
        g, c = gold["archs"][name], arch_case(name)
        for k, v in c["batch"].items():
            np.testing.assert_array_equal(np.asarray(g["batch"][k], dtype=np.asarray(v).dtype), v)
        r = jax_record(name)
        np.testing.assert_array_equal(np.asarray(g["forward"], np.float32), r["forward"])
        assert (g["loss"], g["step_losses"]) == (r["loss"], r["step_losses"])
        assert g["grad_norms"] == _grad_norms(r["grads"])
        tp = c["tinit"](rng.PRNGKey(gold["param_seed"]), c["tcfg"])
        loss, grads = tsteps.value_and_grad(c["tloss"], tp, tbatch(c["batch"]))
        assert abs(float(loss) - g["loss"]) <= LOSS_RTOL * abs(g["loss"])
        for k, v in _flat(grads):
            assert norm_rel_err(v, g["grad_norms"][k]) <= GRAD_TOL, k
    s = gold["sampler"]
    edges, seeds, _ = sampled_graph(0)
    np.testing.assert_array_equal(np.asarray(s["edges"]), edges)
    nodes, ei, mask, n_real = tsampler.sample_khop(
        tsampler.CSRGraph(s["graph_nodes"], edges), seeds, s["fanouts"],
        np.random.default_rng(s["rng_seed"]))
    np.testing.assert_array_equal(nodes, np.asarray(s["nodes"]))
    np.testing.assert_array_equal(ei, np.asarray(s["edge_index"]))
    assert n_real == s["n_real"] and mask.tolist() == s["edge_mask"]
    check_gnn_features(gold["gnn_features"], "cpu")


def norm_rel_err(grad, norm: float) -> float:
    """The relative error of ``grad``'s norm against ``norm``; where the
    reference's gradient is zero (a leaf the loss does not reach, or a
    saturated one), the norm itself."""
    n = float(torch.linalg.vector_norm(grad.double()))
    return abs(n - norm) / norm if norm else n


def check_gnn_features(gf: dict, device) -> dict:
    """The example at its size: the streamed density equal to the record's,
    and from each recorded step's params the loss within ``loss_rtol`` and
    the gradient norms within ``grad_tol`` (the replay phase gnn_features
    runs on the card); returns the errors."""
    a = gf["args"]
    edges = jgs.barabasi_albert_stream(n=a["n"], k=a["k"], seed=a["graph_seed"])
    tri = gnn_features.triangle_density(edges, a["r"], a["batch"], device)
    assert tri == gf["triangles_per_edge"], (tri, gf["triangles_per_edge"])
    data = gnn_features.node_task(edges, a["n"], tri, device)
    errs = {}
    for i, t in gf["teacher"].items():
        tp = topt.tree_map(lambda x: torch.tensor(x, dtype=torch.float32, device=device),
                           t["params"])
        loss, grads = tsteps.value_and_grad(
            lambda p, b: tgnn.node_classification_loss(
                p, gnn_features.CFG, b["node_feats"], b["edge_index"], b["labels"],
                b["label_mask"]), tp, data)
        loss_err = abs(float(loss) - t["loss"]) / abs(t["loss"])
        norm_err = max(norm_rel_err(v, t["grad_norms"][k]) for k, v in _flat(grads))
        assert loss_err <= gf["loss_rtol"] and norm_err <= gf["grad_tol"], (i, loss_err, norm_err)
        errs[i] = {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err}
    return errs


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        GOLDEN.write_text(json.dumps(_golden()) + "\n")
        print(f"wrote {GOLDEN}")
