"""The port's ``train/elastic.py`` and ``train/grad_comm.py`` against the
JAX reference on the CPU.

* ``shrink_or_grow_estimators``: the reference's pins
  (``tests/test_train_elastic.py``) on the same ingested state, bit for
  bit, and the resized state's next batch equal to the reference's.
* ``reshard`` onto a one-process mesh (every shard on the CPU): reading the
  placed state back gives the original values, and ingest continues
  bit-identically, on the one-shard mesh of the reference's pin and on
  ``estimators=4`` through the pjit plan.
* ``_quant_int8`` bit-identical to the reference's on the same float32
  input (round half to even), and ``compressed_psum`` over a 2-shard group
  equal to the reference's under a named axis: the reference runs under
  ``jax.vmap(..., axis_name=...)`` in this process, whose ``psum`` sums
  the two members as ``shard_map``'s does (a + b in float32), so no
  subprocess with forced host devices is needed.
"""
import functools
import sys
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

from repro.core.schemes import resolve_scheme as jax_scheme  # noqa: E402
from repro.data.graph_stream import batches as jax_batches  # noqa: E402
from repro.data.graph_stream import erdos_renyi_stream as jax_er  # noqa: E402
from repro.train import elastic as jel  # noqa: E402
from repro.train import grad_comm as jgc  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.core.distributed import make_pjit_update, scheme_state_specs  # noqa: E402
from repro_torch.core.schemes import resolve_scheme  # noqa: E402
from repro_torch.core.state import EstimatorState  # noqa: E402
from repro_torch.data.graph_stream import batches, erdos_renyi_stream  # noqa: E402
from repro_torch.launch.mesh import make_stream_mesh  # noqa: E402
from repro_torch.train import elastic as tel  # noqa: E402
from repro_torch.train import grad_comm as tgc  # noqa: E402

FIELDS = ("f1", "chi", "f2", "has_f3", "m_seen")


@functools.lru_cache(maxsize=None)
def _jax_state(r=64, seed=4):
    """The reference pin's ``_ingested_state`` (once a process; nothing
    writes into a state)."""
    scheme = jax_scheme("global", None)
    st = scheme.init_state(r)
    key = jax.random.PRNGKey(3)
    for i, (W, nv) in enumerate(jax_batches(jax_er(30, 120, seed=seed), 16)):
        st = scheme.bulk_update(st, jnp.asarray(W), jnp.asarray(nv), jax.random.fold_in(key, i))
    return scheme, st


@functools.lru_cache(maxsize=None)
def _port_state(r=64, seed=4):
    scheme = resolve_scheme("global")
    st = scheme.init_state(r)
    key = rng.PRNGKey(3)
    for i, (W, nv) in enumerate(batches(erdos_renyi_stream(30, 120, seed=seed), 16)):
        st = scheme.bulk_update(st, torch.from_numpy(W), nv, rng.fold_in(key, i))
    return scheme, st


def _equal(port, ref, msg=""):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f"{msg}{f}")


def _next_batch(seed=0, s=16):
    return np.random.default_rng(seed).integers(0, 20, (s, 2)).astype(np.int32)


def test_ingested_states_are_the_references():
    _, js = _jax_state()
    _, ts = _port_state()
    _equal(ts, js)


@pytest.mark.parametrize("new_r", [24, 64, 96])
def test_shrink_or_grow_matches_jax_and_ingest_continues(new_r):
    """The resize pins (shrink keeps the exact prefix, grow appends empty
    estimators, ``m_seen`` untouched) bit for bit against the reference's
    resize of the same state, and the resized state's next batch equal to
    the reference's."""
    jscheme, js = _jax_state()
    tscheme, ts = _port_state()
    jr, tr = jel.shrink_or_grow_estimators(js, new_r), tel.shrink_or_grow_estimators(ts, new_r)
    _equal(tr, jr, f"resize to {new_r}: ")
    keep = min(new_r, 64)
    for f in ("f1", "chi", "f2", "has_f3"):
        assert torch.equal(getattr(tr, f)[:keep], getattr(ts, f)[:keep]), f
    if new_r > 64:
        assert (tr.f1[64:] == -1).all() and (tr.f2[64:] == -1).all()
        assert (tr.chi[64:] == 0).all() and not tr.has_f3[64:].any()
    assert int(tr.m_seen) == int(ts.m_seen)
    W = _next_batch()
    jn = jscheme.bulk_update(jr, jnp.asarray(W), jnp.asarray(16),
                             jax.random.fold_in(jax.random.PRNGKey(1), 9))
    tn = tscheme.bulk_update(tr, torch.from_numpy(W), 16, rng.fold_in(rng.PRNGKey(1), 9))
    _equal(tn, jn, f"continue after resize to {new_r}: ")


def test_shrink_then_grow_is_prefix_stable():
    _, ts = _port_state()
    back = tel.shrink_or_grow_estimators(tel.shrink_or_grow_estimators(ts, 32), 64)
    for f in ("f1", "chi", "f2", "has_f3"):
        assert torch.equal(getattr(back, f)[:32], getattr(ts, f)[:32]), f


def test_reshard_roundtrip_continues_bit_identically():
    """The reference's pin: host arrays placed on a one-shard
    ``estimators`` mesh read back unchanged, and the next batch on the
    placed state equals the reference's on its own."""
    jscheme, js = _jax_state(r=32, seed=1)
    tscheme, ts = _port_state(r=32, seed=1)
    host = EstimatorState(*(x.numpy() for x in ts))
    mesh = make_stream_mesh("estimators=1", "cpu")
    spec = EstimatorState(*([("estimators",)] * 4), m_seen=())
    placed = tel.reshard(host, mesh, spec)
    assert len(placed.shards) == 1
    _equal(placed.gather("cpu"), js, "placed: ")
    W = _next_batch()
    key = rng.fold_in(rng.PRNGKey(1), 9)
    tn = tscheme.bulk_update(placed.shards[0], torch.from_numpy(W), 16, key)
    jn = jscheme.bulk_update(js, jnp.asarray(W), jnp.asarray(16),
                             jax.random.fold_in(jax.random.PRNGKey(1), 9))
    _equal(tn, jn, "continue: ")


def test_reshard_onto_four_shards_then_pjit_equals_unsharded():
    """``reshard`` with the specs the plans use (``scheme_state_specs``)
    onto ``estimators=4``: each shard holds its contiguous block, the
    gather is the original state, one pjit update equals the same update
    unsharded, and a dict of other leaves splits by rows."""
    scheme, ts = _port_state(r=64, seed=2)
    mesh = make_stream_mesh("estimators=4", "cpu", host_devices=4)
    spec = scheme_state_specs(scheme, ("estimators",))
    placed = tel.reshard(ts, mesh, spec)
    assert [int(s.f1.shape[0]) for s in placed.shards] == [16] * 4
    for f in FIELDS:
        assert torch.equal(getattr(placed.gather("cpu"), f), getattr(ts, f)), f
    W, key = _next_batch(3), rng.fold_in(rng.PRNGKey(5), 4)
    update = make_pjit_update(mesh, "coordinated_xla", scheme, r=64)
    got = update(placed, torch.from_numpy(W), 16, key).gather("cpu")
    want = scheme.bulk_update(ts, torch.from_numpy(W), 16, key)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    rows = tel.reshard({"x": np.arange(10), "y": [np.ones(3)]}, mesh,
                       {"x": ("estimators",), "y": [()]})
    assert [t.tolist() for t in rows["x"]] == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]
    assert len(rows["y"][0]) == 4 and all(t.tolist() == [1.0] * 3 for t in rows["y"][0])
    with pytest.raises(ValueError, match="leading"):
        tel.reshard({"x": np.zeros((2, 2))}, mesh, {"x": (None, "estimators")})


def _grad_inputs(seed=0, n=2, shape=(5, 7)):
    g = np.random.default_rng(seed)
    grads = (g.normal(size=(n,) + shape) * 3).astype(np.float32)
    resid = (g.normal(size=(n,) + shape) * 0.01).astype(np.float32)
    return grads, resid


def test_quant_int8_bit_identical():
    """On inputs with exact half steps (round half to even), zeros, a
    single spike and random values."""
    cases = [np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 126.5], np.float32),
             np.zeros((3, 4), np.float32),
             np.array([1e-3, 0.0, -4.0, 1e6], np.float32),
             _grad_inputs(1)[0][0]]
    for x in cases:
        qj, sj = jgc._quant_int8(jnp.asarray(x))
        qt, st = tgc._quant_int8(torch.from_numpy(x))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert st.numpy().tobytes() == np.asarray(sj, np.float32).tobytes()


def test_compressed_psum_matches_jax_over_two_shards():
    """Two error-feedback steps over a 2-shard group (``estimators=2``):
    each shard's mean gradient and residual equal the reference's under a
    named axis of size 2, bit for bit; and the tree form over a dict."""
    mesh = make_stream_mesh("estimators=2", "cpu", host_devices=2)
    fn = jax.vmap(lambda g, r: jgc.compressed_psum(g, jgc.EFState(r), "pod"), axis_name="pod")
    efs = [tgc.EFState(torch.zeros((5, 7))) for _ in range(2)]
    jres = jnp.zeros((2, 5, 7), jnp.float32)
    for step in range(2):
        grads, _ = _grad_inputs(step)
        jmean, jef = fn(jnp.asarray(grads), jres)
        means, efs = tgc.compressed_psum([torch.from_numpy(g) for g in grads], efs, mesh,
                                         ("estimators",))
        for i in range(2):
            np.testing.assert_array_equal(means[i].numpy(), np.asarray(jmean[i]))
            np.testing.assert_array_equal(efs[i].residual.numpy(), np.asarray(jef.residual[i]))
        jres = jef.residual
    grads, _ = _grad_inputs(7)
    tree = [{"a": torch.from_numpy(grads[i]), "b": torch.from_numpy(grads[i][0])}
            for i in range(2)]
    ef_trees = [tgc.init_ef(t) for t in tree]
    means, new = tgc.tree_compressed_psum(tree, ef_trees, mesh, ("estimators",))
    jmean, _ = fn(jnp.asarray(grads), jnp.zeros((2, 5, 7), jnp.float32))
    for i in range(2):
        np.testing.assert_array_equal(means[i]["a"].numpy(), np.asarray(jmean[i]))
        assert isinstance(new[i]["b"], tgc.EFState) and new[i]["b"].residual.shape == (7,)
