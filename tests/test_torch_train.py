"""The port's LM training path against the JAX reference on the CPU, at the
``SMOKE`` sizes: the data pipeline, the optimizers, ``lm_loss``'s gradient,
the train steps, the fault-tolerant trainer, checkpoints of training state
and the training CLI.

Tolerances, and why:

* The data pipeline (``synthetic_corpus``, ``lm_batches``) is numpy on
  both sides: bit-identical.
* The optimizers are fed the **same** numpy gradients and held to float32
  rounding: params and state within ``OPT_RTOL = 4e-6`` relative (about 32
  float32 ulps) plus an absolute floor of 1e-7 times the step size. They
  are not held through a model's gradients: adamw's first step is nearly
  ``lr * sign(g)``, so a gradient that differs in its last bit near zero
  would flip a whole ``lr`` step. The packages' ``pow``, ``sqrt`` and mean
  reductions differ in their last bits, and three steps compound that.
* ``lm_loss``'s value and gradient in float32: the loss within 1e-5
  relative and each leaf's gradient within 1e-4 of that leaf's largest
  |g|, the margin of ``tests/test_torch_models.py`` (the two packages'
  float32 matmuls, exp and reductions sum in other orders; 1e-4 is about a
  thousand float32 ulps of the largest entry, and a backward doubles the
  chain of roundings of a forward). The MoE archs route by a top-k over
  the router's probabilities, so a near-tie could pick another expert in
  one package: the test records every token's router margin and requires
  it far above float32 resolution, so the comparison is of one routing.
* Remat changes memory, not values: bit-identical gradients.
* The training CLI runs bfloat16: its first logged loss within 3e-2
  relative (the bfloat16 logits tolerance of the model tests), its
  ``arch=`` line equal.

``src/repro_torch/golden/train_small.json`` (the reference's float32 step-0
loss, gradient norms, every 4th column of the embedding's gradient and 3
optimizer steps' losses for each arch, and the JAX CLI's lines at
``--smoke --steps 3 --batch 2 --seq 16``; ``chip_smoke.py`` phases
golden_train and cli replay it on the card) is rewritten with
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train.py --write``.
"""
import collections
import dataclasses
import functools
import importlib
import io
import json
import sys
import tempfile
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import repro  # noqa: E402,F401  -- enables x64, as the reference's CLI runs
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.cells import LM_ARCHS as JAX_ARCHS  # noqa: E402
from repro.data import prefetch as jax_prefetch  # noqa: E402
from repro.data import tokens as jax_tokens  # noqa: E402
from repro.launch import train as jax_train_cli  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs.cells import LM_ARCHS  # noqa: E402
from repro_torch.data import prefetch  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.interop import from_jax_opt_state, from_jax_params  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

ARCHS = list(LM_ARCHS)
B, S = 2, 12  # S > chunk_q = chunk_k = 8: a padded query chunk and key chunk
OPT_RTOL = 4e-6
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = 3e-2
STEP_LOSS_RTOL = 1e-4
STEP_TOL = 1e-4
GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "train_small.json"
CLI_ARGS = ["--smoke", "--steps", "3", "--batch", "2", "--seq", "16"]


def _cfgs(arch, dtype="f32", **kw):
    jc = getattr(importlib.import_module(JAX_ARCHS[arch][0]), "SMOKE")
    tc = getattr(importlib.import_module(LM_ARCHS[arch][0]), "SMOKE")
    if dtype == "f32":
        jc = dataclasses.replace(jc, dtype=jnp.float32)
        tc = dataclasses.replace(tc, dtype=torch.float32)
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_synthetic_corpus_and_lm_batches_bit_identical():
    for n, vocab, seed in ((5000, 128, 0), (777, 101, 3)):
        a = tokens.synthetic_corpus(n, vocab, seed=seed)
        b = jax_tokens.synthetic_corpus(n, vocab, seed=seed)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        ours, ref = tokens.lm_batches(a, 3, 16, seed), jax_tokens.lm_batches(b, 3, 16, seed)
        for _ in range(4):
            x, y = next(ours), next(ref)
            assert sorted(x) == sorted(y) == ["labels", "tokens"]
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])


def test_work_stealing_shards_matches_jax():
    """The reference's pin (every item, short shards leave the rotation)
    and its exact round-robin order."""
    shards = [lambda: iter([1, 2]), lambda: iter([10]), lambda: iter([100, 200, 300])]
    out = list(prefetch.work_stealing_shards(shards))
    assert sorted(out) == [1, 2, 10, 100, 200, 300]
    assert out == list(jax_prefetch.work_stealing_shards(shards)) == [1, 10, 100, 2, 200, 300]
    assert list(prefetch.work_stealing_shards([])) == []


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
def _opt_inputs(dtype=np.float32, seed=0):
    g = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "stack": (3, 4, 5), "b": (7,)}
    params = {k: g.normal(size=s).astype(dtype) for k, s in shapes.items()}
    grads = [{k: (g.normal(size=s) * 10.0 ** g.integers(-3, 1)).astype(dtype)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, atol, msg):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), msg
        for k in want:
            _close(got[k], want[k], atol, f"{msg}/{k}")
        return
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (msg, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=OPT_RTOL, atol=atol, err_msg=msg)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizers_match_jax_on_equal_gradients(name):
    """Three updates fed the same gradients: params and state to float32
    rounding (module docstring)."""
    lr = 0.05
    params, grads = _opt_inputs()
    jo, to = jopt.get_optimizer(name, lr), topt.get_optimizer(name, lr)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jo.init(jp)
    tp = _to_torch(params)
    ts = to.init(tp)
    for i, g in enumerate(grads):
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update(_to_torch(g), ts, tp)
        _close(tp, jax.device_get(jp), 1e-7 * lr, f"{name} params, step {i}")
        _close(ts, jax.device_get(js), 1e-7 * lr, f"{name} state, step {i}")
    # the port's state restores the reference's state, key for key
    back = from_jax_opt_state(jax.device_get(js), tp)
    _close(back, jax.device_get(js), 0.0, f"{name} from_jax_opt_state")


def test_optimizers_write_no_tensor_they_were_given():
    params, grads = _opt_inputs()
    for name in ("adamw", "adafactor", "sgd"):
        opt = topt.get_optimizer(name, 0.1)
        tp, tg = _to_torch(params), _to_torch(grads[0])
        st = opt.init(tp)
        before = [t.clone() for t in (*tp.values(), *tg.values())]
        new, st2 = opt.update(tg, st, tp)
        assert all(torch.equal(a, b) for a, b in zip(before, (*tp.values(), *tg.values())))
        assert all(not t.requires_grad for t in new.values())


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_quadratic_converges(name):
    """The reference's pin (``tests/test_substrate.py``) on the port."""
    opt = topt.get_optimizer(name, 0.05)
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 6)).astype(np.float32))
    params = {"w": torch.zeros((8, 6)), "b": torch.zeros((6,))}
    state = opt.init(params)

    def loss(p):
        return torch.mean((p["w"] - target) ** 2) + torch.mean(p["b"] ** 2)

    l0 = float(loss(params))
    for _ in range(200):
        _, g = tsteps.value_and_grad(lambda p, _: loss(p), params, None)
        params, state = opt.update(g, state, params)
    assert float(loss(params)) < 0.05 * l0


def test_adafactor_state_is_factored_and_bf16_params_stay_bf16():
    st = topt.adafactor().init({"w": torch.zeros((128, 64))})
    assert sum(x.numel() for x in st["f"]["w"].values()) + 1 < 128 * 64 / 10
    assert sorted(st["f"]["w"]) == ["vc", "vr"] and st["count"].dtype == torch.int32
    opt = topt.adamw(lr=0.1)
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    newp, state = opt.update({"w": torch.ones((4, 4), dtype=torch.bfloat16)},
                             opt.init(params), params)
    assert newp["w"].dtype == torch.bfloat16 and state["m"]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# lm_loss's gradient
# ---------------------------------------------------------------------------
def _batches(vocab):
    """The golden batches: ``lm_batches`` over a 4096-token corpus, (B, S)
    windows, seed 0."""
    return tokens.lm_batches(tokens.synthetic_corpus(4096, vocab, 0), B, S, 0)


@functools.lru_cache(maxsize=None)
def _jax_record(arch) -> dict:
    """The reference in float32 with seed 0's weights, on the first three
    golden batches: the step-0 loss and gradients, and the losses of three
    steps of the arch's optimizer at lr 1e-2 (``value_and_grad`` then
    ``opt.update``, the reference's ``make_lm_train_step``). Computed once
    a process, for the parity and the golden tests."""
    jc, _ = _cfgs(arch)
    vg = jax.jit(jax.value_and_grad(lambda p, t, l: jt.lm_loss(p, jc, t, l)))
    opt = jopt.get_optimizer(JAX_ARCHS[arch][1], 1e-2)
    update = jax.jit(opt.update)
    p = jt.init_params(jax.random.PRNGKey(0), jc)
    o, data, losses = opt.init(p), _batches(jc.vocab), []
    for i in range(3):
        batch = next(data)
        loss, g = vg(p, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]))
        if i == 0:
            out = {"params": jax.device_get(p), "batch": batch, "loss": float(loss),
                   "grads": {k: _np(v) for k, v in g.items()}}
        p, o = update(g, o, p)
        losses.append(float(loss))
    out["step_losses"] = losses
    return out


def _router_margins(tc, tp, toks, monkeypatch):
    """Each (token, layer)'s gap between its k-th and (k+1)-th expert
    probability, relative to the k-th, in the port's forward."""
    margins = []
    moe_ffn = tt.moe_ffn

    def recorded(x, lp, mo):
        with torch.no_grad():
            p = torch.sort(torch.softmax(x.float() @ lp["router"], -1), -1, descending=True)[0]
            margins.append(((p[:, mo.top_k - 1] - p[:, mo.top_k]) / p[:, mo.top_k - 1]).numpy())
        return moe_ffn(x, lp, mo)

    monkeypatch.setattr(tt, "moe_ffn", recorded)
    with torch.no_grad():
        tt.forward(tp, tc, torch.from_numpy(toks))
    monkeypatch.undo()
    return np.concatenate(margins)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_value_and_grad_match_jax(arch, monkeypatch):
    """On the first golden batch ((2, 12) tokens: a padded query chunk and
    key chunk), seed 0's weights, float32."""
    _, tc = _cfgs(arch)
    ref = _jax_record(arch)
    tp = from_jax_params(ref["params"], tc)
    toks, labels = ref["batch"]["tokens"], ref["batch"]["labels"]
    want_loss, want = ref["loss"], ref["grads"]
    loss, grads = tsteps.value_and_grad(
        lambda p, b: tt.lm_loss(p, tc, b[0], b[1]), tp,
        (torch.from_numpy(toks), torch.from_numpy(labels)))
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss), (float(loss), want_loss)
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        assert g.dtype == tp[k].dtype and g.shape == tp[k].shape, k
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(g.numpy() - want[k]).max())
        assert err <= GRAD_TOL * scale, (arch, k, err, scale)
    if tc.moe is not None:
        m = _router_margins(tc, tp, toks, monkeypatch)
        assert m.min() > 1e-4, ("router near-tie in the test's inputs", m.min())


def test_moe_dropped_pairs_get_the_references_gradient():
    """A capacity that drops pairs: the port's ``moe_ffn`` gradient (x,
    router, experts) equals the reference's ``mode="drop"``, so a dropped
    pair adds nothing and gets nothing back."""
    from repro_torch.models.transformer import MoESettings

    mo_t = MoESettings(n_experts=4, top_k=2, d_ff_expert=8, n_shared=0, capacity_factor=0.5)
    mo_j = jt.MoESettings(n_experts=4, top_k=2, d_ff_expert=8, n_shared=0,
                          capacity_factor=0.5)
    g = np.random.default_rng(0)
    T, d = 24, 6
    x = g.normal(size=(T, d)).astype(np.float32)
    lp = {"router": g.normal(size=(d, 4)), "e_wg": g.normal(size=(4, d, 8)),
          "e_wu": g.normal(size=(4, d, 8)), "e_wd": g.normal(size=(4, 8, d))}
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    w_out = g.normal(size=(T, d)).astype(np.float32)

    def jloss(x, lp):
        y, aux = jt.moe_ffn(x, lp, mo_j)
        return jnp.sum(y * w_out) + aux

    jgx, jgp = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()})

    def tloss(p, _):
        y, aux = tt.moe_ffn(p["x"], {k: v for k, v in p.items() if k != "x"}, mo_t)
        return torch.sum(y * torch.from_numpy(w_out)) + aux

    _, tg = tsteps.value_and_grad(tloss, _to_torch({"x": x, **lp}), None)
    C = max(int(T * 2 * 0.5 / 4), 4)
    assert C * 4 < T * 2  # pairs are dropped
    for k, want in (("x", jgx), *jgp.items()):
        want = _np(want)
        err = float(np.abs(tg[k].numpy() - want).max())
        assert err <= GRAD_TOL * float(np.abs(want).max()), (k, err)


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m"])
def test_remat_gradients_bit_identical(arch):
    _, tc = _cfgs(arch)
    tp = tt.init_params(rng.PRNGKey(3), tc)
    toks, labels = torch.from_numpy(_tokens(tc.vocab, 1)), torch.from_numpy(_tokens(tc.vocab, 2))
    out = []
    for remat in (False, True):
        c = dataclasses.replace(tc, remat=remat)
        out.append(tsteps.value_and_grad(
            lambda p, _: tt.lm_loss(p, c, toks, labels, loss_chunk=10), tp, None))
    assert torch.equal(out[0][0], out[1][0])
    for k in tp:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_gradients_finite_with_padded_queries_and_empty_slots():
    """The online softmax's backward on a batch with both kinds of padding:
    queries padded past Sq (Sq = 5 with chunk_q = 4), key slots with
    k_pos = -1 (a cache's empty slots, and one query row that sees no key
    at all): every gradient finite, and zero for the masked keys."""
    g = np.random.default_rng(0)
    Bq, Sq, Sk, H, dh = 2, 5, 7, 2, 4
    q = torch.from_numpy(g.normal(size=(Bq, Sq, H, dh)).astype(np.float32)).requires_grad_()
    k = torch.from_numpy(g.normal(size=(Bq, Sk, 1, dh)).astype(np.float32)).requires_grad_()
    v = torch.from_numpy(g.normal(size=(Bq, Sk, 1, dh)).astype(np.float32)).requires_grad_()
    q_pos = torch.tensor([[0, 1, 2, 3, 4], [-1, 1, 2, 3, 4]], dtype=torch.int32)
    k_pos = torch.tensor([[0, 1, 2, -1, -1, -1, -1], [0, 1, -1, 3, 4, -1, -1]],
                         dtype=torch.int32)
    o = tt.flash_attention(q, k, v, q_pos, k_pos, True, 4, 3)
    torch.sum(o * torch.linspace(-1, 1, o.numel()).reshape(o.shape)).backward()
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all()
    assert (k.grad[k_pos < 0] == 0).all() and (v.grad[k_pos < 0] == 0).all()
    assert (q.grad[1, 0] == 0).all()  # the row that sees no key
    # and through the whole model: lm_loss with padded query and key chunks
    _, tc = _cfgs("qwen3-4b")
    tp = tt.init_params(rng.PRNGKey(0), tc)
    _, grads = tsteps.value_and_grad(
        lambda p, _: tt.lm_loss(p, tc, torch.from_numpy(_tokens(tc.vocab, 3)),
                                torch.from_numpy(_tokens(tc.vocab, 4))), tp, None)
    assert all(torch.isfinite(x).all() for x in grads.values())


def test_decode_builds_no_graph_with_params_that_require_grad():
    _, tc = _cfgs("smollm-135m")
    tp = {k: v.requires_grad_() for k, v in tt.init_params(rng.PRNGKey(0), tc).items()}
    cache = tt.init_cache(tc, 2, 4)
    logits, cache = tt.decode_step(tp, tc, cache, torch.zeros((2, 1), dtype=torch.int32))
    assert logits.grad_fn is None and not cache["k"].requires_grad
    prefill = tsteps.make_lm_prefill_step(tc)(tp, {"tokens": torch.zeros((2, 3), dtype=torch.int32)})
    assert prefill.grad_fn is None and prefill.shape == (2, 1, tc.vocab)
    dec, _ = tsteps.make_lm_decode_step(tc)(tp, tt.init_cache(tc, 2, 4),
                                            {"tokens": torch.zeros((2, 1), dtype=torch.int32)})
    torch.testing.assert_close(dec, logits, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------
def test_train_step_with_grad_accum_matches_jax():
    """``make_lm_train_step`` at grad_accum = 2 (float32 accumulators over
    two microbatches) against the reference's, one adamw step: the loss,
    ``m`` within GRAD_TOL (module docstring), and each param's step.

    The step is held as ``(p_new - p) / lr``, which adamw's first step
    makes nearly ``sign(g) + wd * p``: within STEP_TOL (8 float32 ulps of
    a unit param, over lr) wherever the reference's gradient is above
    4 * GRAD_TOL of its leaf's largest |g|. Below that the two gradients
    may differ in sign, and a flipped sign moves the step by up to 2."""
    jc, tc = _cfgs("smollm-135m", grad_accum=2)
    lr, b1 = 1e-2, 0.9
    jp = jt.init_params(jax.random.PRNGKey(0), jc)
    tp = from_jax_params(jax.device_get(jp), tc)
    tp0 = {k: v.clone() for k, v in tp.items()}
    toks, labels = _tokens(tc.vocab, 7), _tokens(tc.vocab, 8)
    jo, to = jopt.adamw(lr=lr, b1=b1), topt.adamw(lr=lr, b1=b1)
    jstep = jax.jit(jsteps.make_lm_train_step(jc, jo))
    jp2, js2, jm = jstep(jp, jo.init(jp), {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels)},
                         jax.random.PRNGKey(0))
    tp2, ts2, tm = tsteps.make_lm_train_step(tc, to)(
        tp, to.init(tp), {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)},
        rng.PRNGKey(0))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    for k in tp:
        scale = float(np.abs(_np(js2["m"][k])).max())
        err = float(np.abs(ts2["m"][k].numpy() - _np(js2["m"][k])).max())
        assert err <= GRAD_TOL * scale, (k, err, scale)
        g = np.abs(_np(js2["m"][k])) / (1 - b1)  # one step: m = (1 - b1) g
        near0 = g <= 4 * GRAD_TOL * g.max()
        got = (tp2[k].numpy().astype(np.float64) - tp0[k].numpy()) / lr
        want = (_np(jp2[k]).astype(np.float64) - _np(jp[k])) / lr
        diff = np.abs(got - want)
        assert np.abs(want[~near0]).min() > 0.5, k  # the step moved every such param
        assert diff[~near0].max() <= STEP_TOL, (k, float(diff[~near0].max()))
        assert (diff[near0] <= 2 + STEP_TOL).all(), k
    assert int(ts2["count"]) == int(js2["count"]) == 1
    # accumulation is the mean of the microbatches' gradients
    l1, g1 = tsteps._accum_grads(
        lambda p, b: tt.lm_loss(p, tc, b["tokens"], b["labels"]), tp,
        {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}, 2)
    halves = [tsteps.value_and_grad(lambda p, b: tt.lm_loss(p, tc, b[0], b[1]), tp,
                                    (torch.from_numpy(toks[i:i + 1]),
                                     torch.from_numpy(labels[i:i + 1]))) for i in (0, 1)]
    torch.testing.assert_close(l1, (halves[0][0] + halves[1][0]) * 0.5, rtol=1e-6, atol=0)
    for k in tp:
        assert g1[k].dtype == torch.float32
        torch.testing.assert_close(g1[k], (halves[0][1][k] + halves[1][1][k]) * 0.5,
                                   rtol=1e-6, atol=1e-9)


def test_lm_loss_decreases():
    """The reference's pin (``tests/test_archs_smoke.py``) at the port's
    SMOKE: 30 adamw steps at lr 1e-2 on a (4, 16) batch over a 16-token
    slice of the vocabulary lower the loss by more than 0.5."""
    tc = getattr(importlib.import_module(LM_ARCHS["smollm-135m"][0]), "SMOKE")
    opt = topt.get_optimizer("adamw", 1e-2)
    params = tt.init_params(rng.PRNGKey(0), tc)
    state = opt.init(params)
    step = tsteps.make_lm_train_step(tc, opt)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 16, (4, 16)).astype(np.int32))
    losses = []
    for i in range(30):
        params, state, m = step(params, state, {"tokens": toks, "labels": toks},
                                rng.PRNGKey(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]
    assert params["embed"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# checkpoints of training state
# ---------------------------------------------------------------------------
NT = collections.namedtuple("NT", ["f1", "chi"])


def _tree_jax():
    g = np.random.default_rng(0)
    return ({"embed": jnp.asarray(g.normal(size=(5, 3)), jnp.bfloat16),
             "wq": jnp.asarray(g.normal(size=(2, 3, 3)), jnp.float32)},
            {"m": {"embed": jnp.zeros((5, 3), jnp.float32)}, "count": jnp.int32(4)},
            NT(jnp.arange(4, dtype=jnp.int32), [jnp.ones(2, bool), None]),
            [jnp.float32(2.5)])


def _tree_port(jtree):
    def conv(x):
        if x is None:
            return None
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))

    return jax.tree.map(conv, jtree, is_leaf=lambda x: x is None)


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def test_checkpoint_names_of_tuples_lists_and_namedtuples_match_jax():
    jtree = _tree_jax()
    ttree = _tree_port(jtree)
    want = list(jckpt._flatten_with_names(jtree))
    assert want[:2] == ["[0]/['embed']", "[0]/['wq']"] and "[2]/.f1" in want
    assert list(tckpt._flatten_with_names(ttree)) == want
    back = tckpt._unflatten_like(ttree, tckpt._flatten_with_names(ttree))
    assert isinstance(back[2], NT) and back[2].chi[1] is None and isinstance(back[3], list)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ttree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_reference_bf16_tuple_checkpoint_restores_bit_for_bit(tmp_path):
    """The reference writes a (bfloat16 params, float32 state) tuple tree;
    the port restores it with equal bits in the template's dtypes, and its
    own checkpoint of the same tree carries the reference's keys and
    checksums (bfloat16 leaves hashed under ``bfloat16``)."""
    jtree = _tree_jax()
    ttree = _tree_port(jtree)
    jckpt.CheckpointManager(str(tmp_path / "jax")).save(3, jtree)
    got, manifest = tckpt.CheckpointManager(str(tmp_path / "jax")).restore(ttree)
    assert manifest["step"] == 3
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ttree)):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    tckpt.CheckpointManager(str(tmp_path / "port")).save(3, ttree)
    jm = json.loads((tmp_path / "jax/step_0000000003/manifest.json").read_text())
    pm = json.loads((tmp_path / "port/step_0000000003/manifest.json").read_text())
    assert pm["keys"] == jm["keys"] and pm["checksums"] == jm["checksums"]
    with np.load(tmp_path / "port/step_0000000003/shard_00000.npz") as z:
        assert z["[0]/['embed']"].dtype == np.dtype("V2")
    # a flipped bit in a bfloat16 leaf fails verification
    d = tmp_path / "port/step_0000000003"
    with np.load(d / "shard_00000.npz") as z:
        named = {k: z[k] for k in z.files}
    w = named["[0]/['embed']"].view(np.uint16).copy()
    w[0] ^= 1
    named["[0]/['embed']"] = w.view("V2")
    np.savez(d / "shard_00000.npz", **named)
    with pytest.raises(tckpt.CheckpointCorrupt, match="checksum"):
        tckpt.CheckpointManager(str(tmp_path / "port")).restore(ttree)


@pytest.mark.parametrize("stored,template", [
    (torch.float32, torch.bfloat16), (torch.int64, torch.int32),
    (torch.bfloat16, torch.float32), (torch.float32, torch.float64)])
def test_checkpoint_restore_refuses_another_dtype(tmp_path, stored, template):
    """A stored leaf whose dtype is not the tensor template's raises
    ValueError, a config mismatch, as a shape mismatch does: restore never
    casts (the reference's restore keeps the stored dtype)."""
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(0, {"x": torch.arange(6, dtype=stored).reshape(2, 3)})
    with pytest.raises(ValueError, match="does not read as|do not read as"):
        mgr.restore({"x": torch.zeros((2, 3), dtype=template)})
    got, _ = mgr.restore({"x": torch.zeros((2, 3), dtype=stored)})
    torch.testing.assert_close(got["x"], torch.arange(6, dtype=stored).reshape(2, 3),
                               rtol=0, atol=0)


def test_checkpoint_restore_places_leaves_on_the_templates_device(tmp_path):
    """A tensor leaf comes back on its template leaf's device, a numpy leaf
    as the stored array; here the ``meta`` device stands for the card."""
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(0, ({"w": torch.ones(3, dtype=torch.bfloat16)}, {"count": np.int32(4)}))
    got, _ = mgr.restore(({"w": torch.empty(3, dtype=torch.bfloat16, device="meta")},
                          {"count": np.int32(0)}))
    assert got[0]["w"].device.type == "meta" and got[0]["w"].dtype == torch.bfloat16
    assert isinstance(got[1]["count"], np.ndarray) and int(got[1]["count"]) == 4


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _failing(step, fail_at):
    calls = {"n": 0}

    def fn(state, batch, i):
        calls["n"] += 1
        if calls["n"] in fail_at:
            raise RuntimeError("simulated device loss")
        return step(state, batch, i)

    return fn


def test_failure_restart_loop_matches_jax(tmp_path):
    """The reference's pin (``tests/test_substrate.py``) with a tuple
    ``(params, opt_state)`` state: under the same injected failure (the 7th
    call) the port's trainer with bfloat16 params gives the TrainLog, the
    batch order after the restore (the iterator is not rewound) and the
    final state of the reference's with float32 params. The reference
    cannot restore its own bfloat16 checkpoint (ROADMAP C.5): with
    bfloat16 params its restore raises CheckpointCorrupt."""
    def jstep(state, batch, i):
        p, o = state
        return (({"w": (p["w"].astype(jnp.float32) + batch).astype(p["w"].dtype)},
                 {"count": o["count"] + 1}), {"loss": jnp.float32(batch)})

    def tstep(state, batch, i):
        p, o = state
        return (({"w": (p["w"].float() + batch).to(p["w"].dtype)},
                 {"count": o["count"] + 1}), {"loss": torch.tensor(float(batch))})

    def run(tr, step, state, name):
        return tr.run_loop(_failing(step, {7}), state, iter(range(1, 101)), 12,
                           tr.TrainerConfig(ckpt_dir=str(tmp_path / name), ckpt_every=2,
                                            async_save=False, log_every=1))

    jfinal, jlog = run(jtrainer, jstep, ({"w": jnp.zeros(3, jnp.float32)},
                                         {"count": jnp.int32(0)}), "jax")
    tfinal, tlog = run(ttrainer, tstep, ({"w": torch.zeros(3, dtype=torch.bfloat16)},
                                         {"count": torch.tensor(0, dtype=torch.int32)}), "port")
    assert (tlog.steps, tlog.losses, tlog.restarts, tlog.stale_steps) == (
        jlog.steps, jlog.losses, jlog.restarts, jlog.stale_steps)
    assert tfinal[0]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tfinal[0]["w"].float().numpy(), np.asarray(jfinal[0]["w"]))
    assert int(tfinal[1]["count"]) == int(jfinal[1]["count"])
    assert tlog.restarts >= 1 and int(tfinal[1]["count"]) >= 10  # progress past the failure
    with pytest.raises(jckpt.CheckpointCorrupt, match="checksum"):
        run(jtrainer, jstep, ({"w": jnp.zeros(3, jnp.bfloat16)}, {"count": jnp.int32(0)}),
            "jax_bf16")


def _cli_run(tmp_path, name, steps, fail_at=(), max_retries=3, ckpt_every=4):
    run = train_cli.build("smollm-135m", True, lr=1e-2, seed=0, batch=2, seq=16,
                          corpus_tokens=4096, device="cpu")
    tcfg = ttrainer.TrainerConfig(ckpt_dir=str(tmp_path / name), ckpt_every=ckpt_every,
                                  async_save=True, max_retries=max_retries, log_every=1)
    return run, ttrainer.run_loop(_failing(run["step_fn"], set(fail_at)),
                                  (run["params"], run["opt_state"]), run["batches"](), steps,
                                  tcfg)


def test_resume_after_a_kill_is_bit_identical(tmp_path):
    """A run cut at step 6 by a failure that outlasts max_retries (the
    checkpoint of step 4 is restored once, steps 5 and 6 retried) and
    resumed on the same directory ends with the params of a run that loads
    the step-4 checkpoint and takes steps 5-9 on the stream's first 5
    batches, as the resumed run does."""
    _, (_, full_log) = _cli_run(tmp_path, "full", 10)
    with pytest.raises(RuntimeError, match="simulated"):
        _cli_run(tmp_path, "cut", 10, fail_at={7, 9}, max_retries=1)
    assert tckpt.CheckpointManager(str(tmp_path / "cut")).steps() == [4]
    run, (state, log) = _cli_run(tmp_path, "cut", 10)
    assert log.restarts == 1 and log.steps == list(range(5, 10))
    # the same 5 steps from the step-4 checkpoint on the stream's start
    ref = train_cli.build("smollm-135m", True, lr=1e-2, seed=0, batch=2, seq=16,
                          corpus_tokens=4096, device="cpu")
    like = (ref["params"], ref["opt_state"])
    st, _ = tckpt.CheckpointManager(str(tmp_path / "cut")).restore(like, step=4)
    data = ref["batches"]()
    for i in range(5, 10):
        st, _ = ref["step_fn"](st, next(data), i)
    for k in st[0]:
        assert torch.equal(st[0][k], state[0][k]), k
        assert torch.equal(st[1]["m"][k], state[1]["m"][k]), k
    assert int(state[1]["count"]) == 10
    assert full_log.losses[-1] < full_log.losses[0]


# ---------------------------------------------------------------------------
# the CLI and the golden records
# ---------------------------------------------------------------------------
def _cli_lines(main, argv) -> list:
    buf = io.StringIO()
    with redirect_stdout(buf):
        if main is jax_train_cli.main:
            old = sys.argv
            sys.argv = ["train", *argv]
            try:
                main()
            finally:
                sys.argv = old
        else:
            main(argv)
    return buf.getvalue().splitlines()


def _first_loss(lines) -> float:
    line = next(ln for ln in lines if ln.startswith("loss: first logged ="))
    return float(line.split("=")[1].split()[0])


@functools.lru_cache(maxsize=None)
def _jax_cli() -> tuple:
    with tempfile.TemporaryDirectory() as d:
        return tuple(_cli_lines(jax_train_cli.main, [*CLI_ARGS, "--ckpt-dir", d]))


def test_train_cli_lines_match_jax_cli(tmp_path):
    """Each CLI on a fresh ``--ckpt-dir`` (ROADMAP C.5): the same ``arch=``
    line, and the first logged loss within the bfloat16 tolerance; both
    equal the golden record."""
    gold = json.loads(GOLDEN.read_text())["cli"]
    ours = _cli_lines(train_cli.main, [*CLI_ARGS, "--device", "cpu",
                                       "--ckpt-dir", str(tmp_path / "port")])
    ref = _jax_cli()
    assert ours[0] == ref[0] == gold["arch_line"]
    assert ours[1].startswith("steps=3 time=")
    assert _first_loss(ref) == gold["first_loss"]
    assert abs(_first_loss(ours) - gold["first_loss"]) <= BF16_LOSS_RTOL * gold["first_loss"]


def _golden() -> dict:
    """For each arch, ``_jax_record``: the step-0 loss, each leaf's
    gradient norm (float64 of the float32 gradient), every 4th column of
    the embedding's gradient and the 3 step losses; and the JAX CLI's
    ``arch=`` line and first logged loss at CLI_ARGS."""
    out = {"B": B, "S": S, "param_seed": 0, "corpus_tokens": 4096, "data_seed": 0,
           "column_stride": 4, "lr": 1e-2, "steps": 3, "loss_rtol": LOSS_RTOL,
           "grad_tol": GRAD_TOL, "step_loss_rtol": STEP_LOSS_RTOL, "archs": {}}
    for arch in ARCHS:
        r = _jax_record(arch)
        g = r["grads"]
        out["archs"][arch] = {
            "loss": r["loss"],
            "grad_norms": {k: float(np.linalg.norm(v.astype(np.float64))) for k, v in g.items()},
            "embed_grad": np.round(g["embed"][:, ::4].astype(np.float64), 10).tolist(),
            "embed_grad_max": float(np.abs(g["embed"]).max()),
            "step_losses": r["step_losses"]}
    lines = _jax_cli()
    out["cli"] = {"args": CLI_ARGS, "arch_line": lines[0], "first_loss": _first_loss(lines)}
    return out


def port_record(arch, gold, device="cpu") -> dict:
    """What the golden records, from the port on ``device`` (the replay of
    phase golden_train): the step-0 loss and gradients, and 3 step losses."""
    _, tc = _cfgs(arch)
    tp = tt.init_params(rng.PRNGKey(gold["param_seed"], device), tc)
    opt = topt.get_optimizer(LM_ARCHS[arch][1], gold["lr"])
    step = tsteps.make_lm_train_step(tc, opt)
    data = _batches(tc.vocab)
    o, losses = opt.init(tp), []
    for i in range(gold["steps"]):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(data).items()}
        if i == 0:
            loss, grads = tsteps.value_and_grad(
                lambda p, b: tt.lm_loss(p, tc, b["tokens"], b["labels"]), tp, batch)
        tp, o, m = step(tp, o, batch, None)
        losses.append(float(m["loss"]))
    return {"loss": float(loss), "grads": grads, "step_losses": losses}


def check_record(arch, got, gold) -> dict:
    """Hold a port record to the golden one; returns the errors."""
    g = gold["archs"][arch]
    loss_err = abs(got["loss"] - g["loss"]) / abs(g["loss"])
    assert loss_err <= gold["loss_rtol"], (arch, got["loss"], g["loss"])
    norm_err = 0.0
    for k, norm in g["grad_norms"].items():
        n = float(torch.linalg.vector_norm(got["grads"][k].double()))
        norm_err = max(norm_err, abs(n - norm) / norm)
    assert norm_err <= gold["grad_tol"], (arch, norm_err)
    emb = got["grads"]["embed"].cpu().numpy()[:, ::gold["column_stride"]]
    emb_err = float(np.abs(emb - np.array(g["embed_grad"])).max()) / g["embed_grad_max"]
    assert emb_err <= gold["grad_tol"], (arch, emb_err)
    step_err = max(abs(a - b) / abs(b) for a, b in zip(got["step_losses"], g["step_losses"]))
    assert step_err <= gold["step_loss_rtol"], (arch, got["step_losses"], g["step_losses"])
    return {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
            "embed_grad_err": emb_err, "step_loss_rel_err": step_err}


def test_golden_train_small_is_the_reference():
    """``golden/train_small.json`` is what the reference computes, and the
    port reproduces it on the CPU within the stated tolerances (the replay
    that phase golden_train runs on the card)."""
    gold = json.loads(GOLDEN.read_text())
    for arch in gold["archs"]:
        check_record(arch, port_record(arch, gold), gold)
    assert _golden() == gold


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        GOLDEN.write_text(json.dumps(_golden()) + "\n")
        print(f"wrote {GOLDEN}")
