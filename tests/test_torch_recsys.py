"""The port's recsys family (BERT4Rec) and ``rng.randint32``'s ``minval``
against the JAX reference on the CPU, at the ``SMOKE`` size.

Tolerances, and why:

* ``randint32`` and the cloze step's mask and negatives: bit-identical
  (counter-based threefry, integer span arithmetic); the draws of the
  existing callers (``minval`` 0, a span per lane) unchanged.
* ``cloze_loss`` in float32 on the reference's weights: within
  ``LOSS_RTOL = 1e-5`` relative; each leaf's gradient within ``GRAD_TOL =
  1e-4`` of that leaf's largest |g| (``tests/test_torch_train.py``'s
  reasoning). The backbone runs the transformer branches no LM config
  takes: bidirectional attention, learned positions, LayerNorm and the
  GELU FFN, at seq 12 in one 256-wide chunk and, in a second case, in
  chunks of 5 (padded query and key chunks).
* ``score_candidates`` (per-user (B, C) and shared (C,) candidates) and the
  score step: within ``FWD_TOL = 1e-5`` of the largest |score|; the two
  shapes agree with each other on the same ids to float32 rounding.
* Three adamw steps of the recsys train step (each step's key
  ``PRNGKey(i)``): each loss within ``STEP_LOSS_RTOL = 1e-4`` relative.
"""
import dataclasses
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

from repro.configs import bert4rec as jcfg  # noqa: E402
from repro.models import bert4rec as jb4r  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs import bert4rec as tcfg  # noqa: E402
from repro_torch.interop import from_jax_param_tree  # noqa: E402
from repro_torch.models import bert4rec as tb4r  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

FWD_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STEP_LOSS_RTOL = 1e-4
B = 4


def _items(cfg, seed):
    return np.random.default_rng(seed).integers(1, cfg.n_items, (B, cfg.seq_len)).astype(
        np.int32)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# randomness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lo,hi,shape", [(1, 500, (1023,)), (-7, 3, (5, 9)), (5, 5, (17,)),
                                         (9, 2, (4,)), (0, 2**31 - 1, (64,)),
                                         (-(2**31), 2**31 - 1, (33,))])
def test_randint32_minval_bit_identical(lo, hi, shape):
    """jax.random.randint(key, shape, minval, maxval, int32), empty and
    reversed ranges (the span 1, so minval) and the full int32 range."""
    for seed in (0, 11):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi,
                                             dtype=jnp.int32))
        got = rng.randint32(rng.PRNGKey(seed), hi, shape, minval=lo)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_randint32_lane_spans_unchanged():
    """The estimator's draws: a span per lane from 0 (``core/bulk.py``'s
    phi), with ``offset`` as a shard draws its slice, as before."""
    spans = np.random.default_rng(2).integers(-3, 1000, 257).astype(np.int32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.vmap(
        lambda m: jax.random.randint(key, (), 0, m, dtype=jnp.int32))(jnp.asarray(spans)))
    full = np.asarray(jax.random.randint(key, (257,), 0, jnp.asarray(spans), dtype=jnp.int32))
    got = rng.randint32(rng.PRNGKey(4), torch.from_numpy(spans), (257,))
    np.testing.assert_array_equal(got.numpy(), full)
    tail = rng.randint32(rng.PRNGKey(4), torch.from_numpy(spans[100:]), (157,), offset=100)
    np.testing.assert_array_equal(tail.numpy(), full[100:])
    assert ((want >= 0) & (want < np.maximum(spans, 1))).all()
    with_min = rng.randint32(rng.PRNGKey(4), torch.from_numpy(spans), (257,),
                             minval=torch.zeros(257, dtype=torch.int32))
    torch.testing.assert_close(with_min, got, rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 3])
def test_cloze_mask_and_negatives_bit_identical(seed):
    cfg = tcfg.SMOKE
    key = jax.random.PRNGKey(seed)
    km, kn = jax.random.split(key)
    want_mask = np.asarray(jax.random.uniform(km, (B, cfg.seq_len), jnp.float32)
                           < cfg.mask_frac)
    want_negs = np.asarray(jax.random.randint(kn, (1023,), 1, cfg.n_items, dtype=jnp.int32))
    mask, negs = tb4r.cloze_draws(cfg, (B, cfg.seq_len), rng.PRNGKey(seed))
    assert mask.dtype == torch.bool and negs.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(negs.numpy(), want_negs)
    assert 0 < want_mask.sum() < want_mask.size


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _cfgs(**kw):
    return dataclasses.replace(jcfg.SMOKE, **kw), dataclasses.replace(tcfg.SMOKE, **kw)


def test_backbone_takes_the_bidirectional_branches():
    jc, tc = _cfgs()
    b = tc.backbone
    assert (b.causal, b.pos, b.norm, b.ffn, b.chunk_q, b.chunk_k, b.vocab, b.max_len) == (
        False, "learned", "ln", "gelu", 256, 256, 502, 12)
    assert dataclasses.asdict(jc.backbone) == {
        **dataclasses.asdict(b), "dtype": jnp.float32, "moe": None}
    assert tc.mask_id == jc.mask_id == 501


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _chunked(cfg, chunk: int):
    """``cfg`` whose backbone attends in chunks of ``chunk`` (a subclass of
    its own config class, in either package)."""
    base = type(cfg)

    @dataclasses.dataclass(frozen=True)
    class Chunked(base):
        chunk: int = 256

        @property
        def backbone(self):
            return dataclasses.replace(base.backbone.fget(self), chunk_q=self.chunk,
                                       chunk_k=self.chunk)

    return Chunked(**dataclasses.asdict(cfg), chunk=chunk)


@pytest.mark.parametrize("chunk", [256, 5])
def test_cloze_loss_and_grads_match_jax(chunk):
    """Chunk 256 holds the whole sequence; chunk 5 pads a query and a key
    chunk (12 = 5 + 5 + 2) through the bidirectional online softmax."""
    jc, tc = (_chunked(c, chunk) for c in _cfgs())
    items = _items(tc, 1)
    jp = jb4r.init_params(jax.random.PRNGKey(0), jc)
    key = jax.random.PRNGKey(5)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jb4r.cloze_loss(p, jc, jnp.asarray(items), key)))(jp)
    tp = from_jax_param_tree(jax.device_get(jp), tc)
    loss, grads = tsteps.value_and_grad(
        lambda p, b: tb4r.cloze_loss(p, tc, b, rng.PRNGKey(5)), tp, torch.from_numpy(items))
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    want = {k: _np(v) for k, v in want.items()}
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(g.numpy() - want[k]).max())
        assert err <= GRAD_TOL * scale or err == 0.0, (k, err, scale)
    assert float(grads["wu"].abs().max()) == 0.0 == float(np.abs(want["wu"]).max())


def test_score_candidates_both_shapes_and_score_step_match_jax():
    jc, tc = _cfgs()
    items = _items(tc, 2)
    g = np.random.default_rng(3)
    shared = g.integers(0, tc.n_items + 2, 64).astype(np.int32)
    own = g.integers(0, tc.n_items + 2, (B, 64)).astype(np.int32)
    jp = jb4r.init_params(jax.random.PRNGKey(1), jc)
    tp = from_jax_param_tree(jax.device_get(jp), tc)
    jstep, tstep = jsteps.make_recsys_score_step(jc), tsteps.make_recsys_score_step(tc)
    for cands in (shared, own):
        want = _np(jstep(jp, {"items": jnp.asarray(items), "candidates": jnp.asarray(cands)}))
        got = tstep(tp, {"items": torch.from_numpy(items), "candidates": torch.from_numpy(cands)})
        assert got.shape == want.shape == (B, 64) and got.grad_fn is None
        assert float(np.abs(got.numpy() - want).max()) <= FWD_TOL * float(np.abs(want).max())
        direct = tb4r.score_candidates(tp, tc, torch.from_numpy(items), torch.from_numpy(cands))
        torch.testing.assert_close(direct, got, rtol=0, atol=0)
    # the shared ids, given per user, score the same
    per_user = tstep(tp, {"items": torch.from_numpy(items),
                          "candidates": torch.from_numpy(np.tile(shared, (B, 1)))})
    one = tstep(tp, {"items": torch.from_numpy(items), "candidates": torch.from_numpy(shared)})
    torch.testing.assert_close(per_user, one, rtol=1e-6, atol=1e-6)
    enc = tb4r.encode(tp, tc, torch.from_numpy(items))
    want_enc, _ = jt.forward(jp, jc.backbone, jnp.asarray(items))
    assert float(np.abs(enc.detach().numpy() - _np(want_enc)).max()) <= FWD_TOL * float(
        np.abs(_np(want_enc)).max())


def test_three_adamw_steps_of_the_recsys_train_step_match_jax():
    jc, tc = _cfgs()
    items = _items(tc, 4)
    jp = jb4r.init_params(jax.random.PRNGKey(0), jc)
    tp = from_jax_param_tree(jax.device_get(jp), tc)
    jo, to = jopt.adamw(lr=1e-3), topt.adamw(lr=1e-3)
    jstep = jax.jit(jsteps.make_recsys_train_step(jc, jo))
    tstep = tsteps.make_recsys_train_step(tc, to)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        jp, js, jm = jstep(jp, js, {"items": jnp.asarray(items)}, jax.random.PRNGKey(i))
        tp, ts, tm = tstep(tp, ts, {"items": torch.from_numpy(items)}, rng.PRNGKey(i))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= STEP_LOSS_RTOL * abs(
            float(jm["loss"])), (i, float(tm["loss"]), float(jm["loss"]))
    assert int(ts["count"]) == 3 and tp["embed"].dtype == torch.float32
