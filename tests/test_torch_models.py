"""The port's LM serving path against the JAX reference, for each of the
five LM architectures at its ``SMOKE`` size, on the CPU.

* ``init_params`` from one seed is bit-identical to the reference's, in
  bfloat16 and in float32.
* ``forward`` (and ``logits_fn``) and teacher-forced ``decode_step`` on the
  same weights (the reference's, through ``interop.from_jax_params``) and
  the same tokens. Tolerances, as fractions of the largest |logit|: float32
  1e-4, with equal greedy tokens (the two packages' float32 matmuls, pow
  and exp differ in the last bits; 1e-4 is a thousand float32 ulps of the
  largest logit); bfloat16 3e-2 (activations round to 8 significant bits
  at every matmul, and the MoE combine adds in bfloat16 in an order that
  differs between the packages), except at an MoE router's near-tie
  below bfloat16's resolution, where one rounding picks another expert.
* ``moe_ffn`` against the reference's and against a per-token oracle
  built on ``moe_dispatch_ref``; ``lm_loss``'s value.
* ``python -m repro_torch.launch.serve --smoke`` prints the JAX CLI's
  ``sample:`` line at seeds 0 and 1 for each architecture.

``golden/lm_small.json`` (the reference's seed-0 float32 logits and greedy
tokens for each ``SMOKE`` arch, which ``chip_smoke.py`` phase golden_serve
replays on the card) is rewritten with ``PYTHONPATH=src JAX_PLATFORMS=cpu
python tests/test_torch_models.py --write``.
"""
import dataclasses
import importlib
import io
import json
import sys
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
from repro.kernels.ref import moe_dispatch_ref as jax_dispatch  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs.cells import LM_ARCHS  # noqa: E402
from repro_torch.interop import from_jax_params  # noqa: E402
from repro_torch.kernels.ref import moe_dispatch_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = list(LM_ARCHS)
MOE_ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
TOL = {"f32": 1e-4, "bf16": 3e-2}
B, S = 2, 12  # S > chunk_q = chunk_k = 8: two query and two key chunks
GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "lm_small.json"


def _cfgs(arch, dtype="bf16"):
    """The reference's and the port's SMOKE config of ``arch``."""
    jc = getattr(importlib.import_module(JAX_ARCHS[arch][0]), "SMOKE")
    tc = getattr(importlib.import_module(LM_ARCHS[arch][0]), "SMOKE")
    if dtype == "f32":
        jc = dataclasses.replace(jc, dtype=jnp.float32)
        tc = dataclasses.replace(tc, dtype=torch.float32)
    return jc, tc


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype]).numpy()


def _tokens(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_logits(jp, jc, toks):
    """The reference's forward logits and its teacher-forced decode logits."""
    fwd = jax.jit(lambda p, t: jt.logits_fn(p, jc, jt.forward(p, jc, t)[0]))
    step = jax.jit(lambda p, c, t: jt.decode_step(p, jc, c, t))
    cache = jt.init_cache(jc, B, S)
    dec = []
    for i in range(S):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, i:i + 1]))
        dec.append(_np(lg)[:, 0])
    return _np(fwd(jp, jnp.asarray(toks))), np.stack(dec, axis=1)


def _port_logits(tp, tc, toks, monkeypatch):
    """The port's forward and teacher-forced decode logits, and for an MoE
    arch each (token, position)'s router margin: over the layers, the
    least gap between its k-th and (k+1)-th expert probability relative to
    the k-th (a near-tie where two experts could trade places)."""
    t = torch.from_numpy(toks)
    margins = []
    if tc.moe is not None:
        moe_ffn = tt.moe_ffn

        def recorded(x, lp, mo):
            p = torch.sort(torch.softmax(x.float() @ lp["router"], -1), -1, descending=True)[0]
            margins.append(((p[:, mo.top_k - 1] - p[:, mo.top_k]) / p[:, mo.top_k - 1]).numpy())
            return moe_ffn(x, lp, mo)

        monkeypatch.setattr(tt, "moe_ffn", recorded)
    fwd = tt.logits_fn(tp, tc, tt.forward(tp, tc, t)[0]).float().numpy()
    cache = tt.init_cache(tc, B, S)
    dec = []
    for i in range(S):
        lg, cache = tt.decode_step(tp, tc, cache, t[:, i:i + 1])
        dec.append(lg.float().numpy()[:, 0])
    if not margins:
        return fwd, np.stack(dec, axis=1), None, None
    L = tc.n_layers
    m_fwd = np.min(np.stack(margins[:L]), axis=0).reshape(B, S)
    m_dec = np.min(np.stack(margins[L:]).reshape(S, L, B), axis=1).T
    return fwd, np.stack(dec, axis=1), m_fwd, m_dec


def _assert_close(got, want, tol, msg, argmax=False, margin=None):
    """Within ``tol`` of the largest |logit| at every position; in
    bfloat16 an MoE position may exceed it only where its router had a
    near-tie below bfloat16's resolution (2^-8), so that one rounding
    apart the two packages pick different experts."""
    scale = float(np.abs(want).max())
    err = np.abs(got - want).max(axis=-1)
    over = err > tol * scale
    if margin is not None:
        assert (margin[over] < 2.0 ** -8).all(), (msg, err[over], margin[over])
        over &= ~(margin < 2.0 ** -8)
    assert not over.any(), f"{msg}: max |diff| {err.max()} > {tol} x {scale}"
    if argmax:
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1), err_msg=msg)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_bit_identical_to_jax(arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    jp = jax.device_get(jt.init_params(jax.random.PRNGKey(5), jc))
    tp = tt.init_params(rng.PRNGKey(5), tc)
    ref = from_jax_params(jp, tc)
    assert sorted(tp) == sorted(jp)
    for k in tp:
        assert tp[k].shape == ref[k].shape and tp[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(_bits(tp[k]), _bits(ref[k]), err_msg=k)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_logits_match_jax(arch, dtype, monkeypatch):
    """Seed 0's weights on (2, 12) tokens. One bfloat16 case meets a
    router near-tie: granite-moe, token 7 of row 0, layer 1, where experts
    0 and 1 hold 0.19345 and 0.19308 (0.2% apart, below bfloat16's 0.4%):
    XLA's fused bfloat16 arithmetic and the port's op-by-op rounding pick
    different experts there, and that position's logits differ by 8% of
    the largest; every other position is within the tolerance."""
    jc, tc = _cfgs(arch, dtype)
    jp = jt.init_params(jax.random.PRNGKey(0), jc)
    tp = from_jax_params(jax.device_get(jp), tc)
    toks = _tokens(tc.vocab, seed=1)
    jf, jd = _jax_logits(jp, jc, toks)
    tf, td, m_fwd, m_dec = _port_logits(tp, tc, toks, monkeypatch)
    assert np.isfinite(tf).all() and np.isfinite(td).all()
    f32 = dtype == "f32"
    _assert_close(tf, jf, TOL[dtype], f"{arch} {dtype} forward", f32, None if f32 else m_fwd)
    _assert_close(td, jd, TOL[dtype], f"{arch} {dtype} decode", f32, None if f32 else m_dec)


def test_layers_match_jax():
    """Each shared layer on seeded float32 inputs, to float32 rounding."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    g = np.random.default_rng(7)
    x = g.standard_normal((2, 5, 3, 8)).astype(np.float32)
    w, b = g.standard_normal(8).astype(np.float32), g.standard_normal(8).astype(np.float32)
    pos = g.integers(0, 50, (2, 5)).astype(np.int32)
    wg, wu = (g.standard_normal((8, 6)).astype(np.float32) for _ in range(2))
    wd = g.standard_normal((6, 8)).astype(np.float32)
    scores = g.standard_normal((30, 2)).astype(np.float32)
    ids = g.integers(0, 7, 30).astype(np.int32)  # 7 segments, some maybe empty
    logits = g.standard_normal((4, 9, 11)).astype(np.float32)
    labels = g.integers(0, 11, (4, 9)).astype(np.int32)
    mask = (g.random((4, 9)) < 0.6).astype(np.float32)
    T_ = torch.from_numpy
    cases = {
        "rms_norm": (tl.rms_norm(T_(x), T_(w)), jl.rms_norm(x, w)),
        "layer_norm": (tl.layer_norm(T_(x), T_(w), T_(b)), jl.layer_norm(x, w, b)),
        "rope": (tl.rope(T_(x), T_(pos), 500.0), jl.rope(x, pos, 500.0)),
        "swiglu": (tl.swiglu(T_(x), T_(wg), T_(wu), T_(wd)), jl.swiglu(x, wg, wu, wd)),
        "segment_softmax": (tl.segment_softmax(T_(scores), T_(ids), 7),
                            jl.segment_softmax(scores, ids, 7)),
        "softmax_xent": (tl.softmax_xent(T_(logits), T_(labels)),
                         jl.softmax_xent(logits, labels)),
        "softmax_xent_mask": (tl.softmax_xent(T_(logits), T_(labels), T_(mask)),
                              jl.softmax_xent(logits, labels, mask)),
    }
    for name, (got, want) in cases.items():
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-6, atol=2e-6, err_msg=name)


def test_layer_norm_learned_positions_gelu_untied_match_jax(monkeypatch):
    """The config options no LM config of the zoo sets (layer norm, learned
    positions, a gelu FFN, an untied unembedding), in float32: the same
    init bits, forward and decode logits."""
    jc, tc = _cfgs("smollm-135m", "f32")
    opts = dict(norm="ln", pos="learned", ffn="gelu", tie_embeddings=False, max_len=16)
    jc, tc = dataclasses.replace(jc, **opts), dataclasses.replace(tc, **opts)
    jp = jt.init_params(jax.random.PRNGKey(8), jc)
    tp = tt.init_params(rng.PRNGKey(8), tc)
    ref = from_jax_params(jax.device_get(jp), tc)
    assert sorted(tp) == sorted(ref) and {"pos_embed", "unembed", "ln1_b"} <= set(tp)
    for k in tp:
        np.testing.assert_array_equal(_bits(tp[k]), _bits(ref[k]), err_msg=k)
    toks = _tokens(tc.vocab, seed=2)
    jf, jd = _jax_logits(jp, jc, toks)
    tf, td, _, _ = _port_logits(tp, tc, toks, monkeypatch)
    _assert_close(tf, jf, TOL["f32"], "variant forward", argmax=True)
    _assert_close(td, jd, TOL["f32"], "variant decode", argmax=True)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax_and_the_dispatch_oracle(arch):
    """``moe_ffn`` on 40 tokens in float32: equal (to 1e-5 of the largest
    output) to the reference's, and to a per-token sum over the kept
    (token, expert) pairs that ``moe_dispatch_ref`` names; the aux loss
    too, at a capacity that drops pairs."""
    jc, tc = _cfgs(arch, "f32")
    # capacity factor 0.5: C = 10 slots an expert for an average of 20 pairs
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, capacity_factor=0.5))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, capacity_factor=0.5))
    mo = tc.moe
    jp = jt.init_params(jax.random.PRNGKey(2), jc)
    tp = from_jax_params(jax.device_get(jp), tc)
    x = np.random.default_rng(3).standard_normal((40, tc.d_model)).astype(np.float32)
    lp = {k: v[1] for k, v in tp.items() if k not in ("embed", "ln_f")}
    jlp = {k: v[1] for k, v in jp.items() if k not in ("embed", "ln_f")}
    y, aux = tt.moe_ffn(torch.from_numpy(x), lp, mo)
    jy, jaux = jt.moe_ffn(jnp.asarray(x), jlp, jc.moe)
    scale = float(np.abs(_np(jy)).max())
    assert float(np.abs(y.numpy() - _np(jy)).max()) <= 1e-5 * scale
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    # the oracle: route, then add each kept pair's expert output token by token
    xt = torch.from_numpy(x)
    probs = torch.softmax(xt @ lp["router"], -1)
    w, e = tt._top_k(probs, mo.top_k)
    w = w / w.sum(-1, keepdim=True)
    C = max(int(40 * mo.top_k * mo.capacity_factor / mo.n_experts), 4)
    flat = e.reshape(-1)
    order = torch.argsort(flat, stable=True)
    slot, keep = moe_dispatch_ref(flat[order], C, mo.n_experts)
    assert (~keep).any() and keep.any()
    want = torch.zeros_like(xt)
    for j in torch.nonzero(keep)[:, 0].tolist():
        i = int(order[j])
        tok, ex = i // mo.top_k, int(flat[i])
        h = torch.nn.functional.silu(xt[tok] @ lp["e_wg"][ex]) * (xt[tok] @ lp["e_wu"][ex])
        want[tok] += w.reshape(-1)[i] * (h @ lp["e_wd"][ex])
    if mo.n_shared:
        want += tt.swiglu(xt, lp["s_wg"], lp["s_wu"], lp["s_wd"])
    assert float((y - want).abs().max()) <= 1e-5 * scale
    # the contract itself, against the reference's
    idx = np.random.default_rng(4).integers(0, 5, 300).astype(np.int32)
    js, jk = jax_dispatch(jnp.asarray(idx), 40, 5)
    ts, tk = moe_dispatch_ref(torch.from_numpy(idx), 40, 5)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax(arch):
    jc, tc = _cfgs(arch, "f32")
    jp = jt.init_params(jax.random.PRNGKey(4), jc)
    tp = from_jax_params(jax.device_get(jp), tc)
    toks, labels = _tokens(tc.vocab, 5), _tokens(tc.vocab, 6)
    want = float(jax.jit(lambda p, t, l: jt.lm_loss(p, jc, t, l, loss_chunk=10))(
        jp, jnp.asarray(toks), jnp.asarray(labels)))
    got = float(tt.lm_loss(tp, tc, torch.from_numpy(toks), torch.from_numpy(labels),
                           loss_chunk=10))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def _sample_line(main, argv) -> str:
    buf = io.StringIO()
    old = sys.argv
    with redirect_stdout(buf):
        if main is jax_serve.main:
            sys.argv = ["serve", *argv]
            try:
                main()
            finally:
                sys.argv = old
        else:
            main(argv)
    return next(ln for ln in buf.getvalue().splitlines() if ln.startswith("sample:"))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_sample_line_matches_jax_cli(arch, seed):
    """bfloat16 greedy decoding, as both CLIs run it: the same sample line
    (no token flips on a bfloat16 near-tie at these seeds)."""
    argv = ["--arch", arch, "--smoke", "--seed", str(seed)]
    assert _sample_line(serve.main, [*argv, "--device", "cpu"]) == _sample_line(
        jax_serve.main, argv)


def _jax_greedy(jp, jc, batch=4, prompt_len=8, gen=16, seed=0):
    """The JAX CLI's decoding loop (prompt from ``default_rng(seed)``,
    prefilled token by token, then greedy) under ``jc``."""
    prompt = np.random.default_rng(seed).integers(0, jc.vocab, (batch, prompt_len))
    prompt = jnp.asarray(prompt, jnp.int32)
    step = jax.jit(lambda p, c, t: jt.decode_step(p, jc, c, t))
    cache = jt.init_cache(jc, batch, prompt_len + gen)
    toks, out = prompt[:, :1], [prompt[:, :1]]
    for i in range(prompt_len + gen - 1):
        logits, cache = step(jp, cache, toks)
        toks = (prompt[:, i + 1:i + 2] if i + 1 < prompt_len
                else jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32))
        out.append(toks)
    return np.asarray(jnp.concatenate(out, axis=1))


def _golden() -> dict:
    """For each arch, the reference in float32 with seed 0's weights: its
    forward and teacher-forced decode logits over (B, S) tokens drawn with
    seed 1 (every 4th vocab column, to keep the file small), the forward's
    greedy tokens, and the CLI's decoding loop's tokens (batch 4, prompt 8,
    16 generated)."""
    out = {"B": B, "S": S, "token_seed": 1, "param_seed": 0, "column_stride": 4,
           "tolerance": TOL["f32"], "archs": {}}
    for arch in ARCHS:
        jc, _ = _cfgs(arch, "f32")
        jp = jt.init_params(jax.random.PRNGKey(0), jc)
        toks = _tokens(jc.vocab, seed=1)
        fwd, dec = _jax_logits(jp, jc, toks)
        out["archs"][arch] = {
            "tokens": toks.tolist(),
            "forward": np.round(fwd[..., ::4].astype(np.float64), 8).tolist(),
            "decode": np.round(dec[..., ::4].astype(np.float64), 8).tolist(),
            "argmax": fwd.argmax(-1).tolist(),
            "max_abs_logit": float(np.abs(fwd).max()),
            "greedy": _jax_greedy(jp, jc).tolist()}
    return out


def test_golden_lm_small_is_the_reference(monkeypatch):
    """``golden/lm_small.json`` is what the reference computes, and the
    port reproduces it on the CPU within the float32 tolerance, with the
    same greedy tokens."""
    gold = json.loads(GOLDEN.read_text())
    for arch, g in gold["archs"].items():
        _, tc = _cfgs(arch, "f32")
        tp = tt.init_params(rng.PRNGKey(gold["param_seed"]), tc)
        toks = np.array(g["tokens"], np.int32)
        tol = gold["tolerance"] * g["max_abs_logit"]
        fwd, dec, _, _ = _port_logits(tp, tc, toks, monkeypatch)
        np.testing.assert_array_equal(fwd.argmax(-1), np.array(g["argmax"]), err_msg=arch)
        for name, got in (("forward", fwd), ("decode", dec)):
            err = float(np.abs(got[..., ::gold["column_stride"]] - np.array(g[name])).max())
            assert err <= tol, (arch, name, err)
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, tc.vocab, (4, 8)).astype(np.int32))
        seq, _ = serve.generate(tp, tc, prompt, 16)
        assert seq.tolist() == g["greedy"], arch
    assert _golden() == gold


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        GOLDEN.write_text(json.dumps(_golden()) + "\n")
        print(f"wrote {GOLDEN}")
