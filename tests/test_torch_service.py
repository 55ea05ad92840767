"""The port's service loop against the JAX reference: default batch
validation and quarantine (same dead letters, same step, same state), and
checkpointed resume (the same manifests, directories that resume across
packages, the walk-back past a corrupt newest checkpoint). Everything runs
on the CPU; inputs are seeded numpy."""
import json
import pathlib
import shutil

import numpy as np
import pytest

import repro  # noqa: F401  -- enables x64
import jax

from repro.data.graph_stream import batches as jax_batches
from repro.engine import EngineConfig as JaxConfig
from repro.engine import TriangleCountEngine as JaxEngine
from repro.engine import run_stream as jax_run_stream
from repro.engine.faults import DeadLetterBuffer as JaxDeadLetters
from repro.engine.faults import validate_batch as jax_validate
from repro.train import checkpoint as jckpt
from repro_torch.data.graph_stream import batches, planted_triangle_stream
from repro_torch.engine import (
    DeadLetterBuffer,
    EngineConfig,
    ResilienceConfig,
    SnapshotMismatch,
    TriangleCountEngine,
    run_stream,
    validate_batch,
)
from repro_torch.interop import state_sha256
from repro_torch.train import checkpoint as tckpt

R, S = 512, 64
LOCAL = {"n_vertices": 900, "n_pools": 4}


def _edges(seed=0):
    edges, _ = planted_triangle_stream(40, 700, 900, seed=seed)
    return edges  # 820 edges: 12 full batches of 64 and a ragged one of 52


def _port(K=1, scheme="global", params=None):
    return TriangleCountEngine(EngineConfig(r=R, batch_size=S, chunk_size=K, seeds=(5,),
                                            scheme=scheme, scheme_params=params,
                                            device="cpu"))


def _jax(K=1, scheme="global", params=None):
    return JaxEngine(JaxConfig(r=R, batch_size=S, chunk_size=K, seeds=(5,),
                               scheme=scheme, scheme_params=params))


def _poisoned_stream(edges):
    """The stream's batches with three poisoned ones inserted: a self-loop
    batch (source position 3, inside the first K = 4 chunk of admitted
    batches), a negative-id batch (position 6, between two chunks) and a
    malformed three-column batch (position 13, among the batches that form
    the third chunk)."""
    good = list(batches(edges, S))
    loop = good[1][0].copy()
    loop[5] = (7, 7)
    neg = good[3][0].copy()
    neg[0, 1] = -4
    bad_shape = np.zeros((S, 3), np.int32)
    out = good[:2] + [(loop, S)] + good[2:4] + [(neg, S)] + good[4:10] + [(bad_shape, S)]
    return out + good[10:]


@pytest.mark.parametrize("K", [1, 4])
def test_quarantine_matches_jax(K):
    stream = _poisoned_stream(_edges())
    jeng, peng = _jax(K), _port(K)
    jrep = jax_run_stream(jeng, iter(stream))
    prep = run_stream(peng, iter(stream))
    assert prep.quarantined_batches == jrep.quarantined_batches == 3
    assert prep.dead_letters.reasons() == jrep.dead_letters.reasons()
    positions = [it["position"] for it in prep.dead_letters.items]
    assert positions == [it["position"] for it in jrep.dead_letters.items] == [3, 6, 13]
    assert peng.step == jeng.step == 13
    assert (prep.batches, prep.edges) == (jrep.batches, jrep.edges) == (13, 820)
    assert state_sha256(peng.snapshot()) == state_sha256(jeng.snapshot())
    # the quarantined batches changed nothing: the clean stream gives the same state
    clean = _port(K)
    run_stream(clean, batches(_edges(), S))
    assert state_sha256(clean.snapshot()) == state_sha256(peng.snapshot())


def test_validation_off_and_max_vertex():
    stream = list(batches(_edges(), S))
    loop = stream[2][0].copy()
    loop[0] = (3, 3)
    stream.insert(2, (loop, S))
    eng = _port()
    rep = run_stream(eng, iter(stream), resilience=ResilienceConfig(validate=False))
    assert rep.quarantined_batches == 0 and eng.step == 14
    # ids of the planted triangles are 0..119 and the noise's 120..899
    capped = _port()
    rep = run_stream(capped, iter(stream), resilience=ResilienceConfig(max_vertex=880,
                                                                      dead_letter_capacity=4))
    from repro.engine import ResilienceConfig as JaxResilience

    jcapped = _jax()
    jrep = jax_run_stream(jcapped, iter(stream), resilience=JaxResilience(max_vertex=880,
                                                                        dead_letter_capacity=4))
    assert rep.quarantined_batches == jrep.quarantined_batches > 4
    assert rep.dead_letters.total == rep.quarantined_batches and len(rep.dead_letters) == 4
    assert rep.dead_letters.reasons() == jrep.dead_letters.reasons()
    assert capped.step == jcapped.step
    assert state_sha256(capped.snapshot()) == state_sha256(jcapped.snapshot())


@pytest.mark.parametrize("W,nv,max_vertex", [
    (np.array([[1, 2], [3, 4]], np.int32), 2, None),
    (np.array([[1, 2], [3, 3]], np.int32), 2, None),
    (np.array([[1, 2], [3, 3]], np.int32), 1, None),
    (np.array([[0, -1]], np.int32), 1, None),
    (np.array([[0, 99]], np.int32), 1, 50),
    (np.zeros((4, 3), np.int32), 4, None),
    (np.zeros((4,), np.int32), None, None),
    (np.zeros((4, 2), np.int32), 9, None),
    (np.zeros((4, 2)), 4, None),
    (np.array([[[0, 1], [0, 1]], [[0, 1], [5, 5]]], np.int32), [2, 1], None),
    (np.array([[[0, 1], [0, 1]], [[0, 1], [5, 5]]], np.int32), [2, 2], None),
])
def test_validate_batch_reasons_match_jax(W, nv, max_vertex):
    assert validate_batch(W, nv, max_vertex=max_vertex) == jax_validate(W, nv, max_vertex=max_vertex)


def test_dead_letter_buffer_matches_jax():
    ours, ref = DeadLetterBuffer(capacity=2), JaxDeadLetters(capacity=2)
    for i in range(5):
        ours.put(f"r{i}", i, None)
        ref.put(f"r{i}", i, None)
    assert (ours.total, len(ours), ours.reasons()) == (ref.total, len(ref), ref.reasons())
    assert [it["position"] for it in ours.items] == [it["position"] for it in ref.items] == [3, 4]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_names_match_jax_tree_paths():
    tree = {"b": np.arange(3), "a": {"y": np.float32(2.0), "x": np.zeros((2, 2))},
            "scheme": np.array("local"), "step": np.int64(7)}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = ["/".join(str(p) for p in path) for path, _ in flat]
    assert list(tckpt._flatten_with_names(tree)) == want
    assert list(jckpt._flatten_with_names(tree)) == want
    back = tckpt._unflatten_like(tree, tckpt._flatten_with_names(tree))
    np.testing.assert_array_equal(back["a"]["x"], tree["a"]["x"])
    assert int(back["step"]) == 7
    assert str(back["scheme"]) == "local"
    with pytest.raises(ValueError, match="shape"):
        tckpt._unflatten_like({"b": np.arange(4)}, {"['b']": np.arange(3)})
    with pytest.raises(KeyError):
        tckpt._unflatten_like({"c": np.arange(3)}, {"['b']": np.arange(3)})
    assert tckpt.config_hash({"r": 1}) == jckpt.config_hash({"r": 1})
    a = np.arange(6, dtype=np.int32)
    assert tckpt.array_checksum(a) == jckpt.array_checksum(a)


def _manifests(d: pathlib.Path) -> dict:
    return {p.parent.name: json.loads(p.read_text()) for p in sorted(d.glob("step_*/manifest.json"))}


@pytest.mark.parametrize("K", [1, 4])
def test_manifests_equal_jax(K, tmp_path):
    edges = _edges(1)
    jax_run_stream(_jax(K), jax_batches(edges, S), ckpt_dir=str(tmp_path / "jax"), ckpt_every=4)
    run_stream(_port(K), batches(edges, S), ckpt_dir=str(tmp_path / "port"), ckpt_every=4)
    jm, pm = _manifests(tmp_path / "jax"), _manifests(tmp_path / "port")
    assert list(jm) == list(pm) and len(pm) == 3  # keep-3 of steps 4, 8, 12, 13
    for step in jm:
        for m in (jm[step], pm[step]):
            del m["time"]
        assert pm[step] == jm[step], step


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("K,scheme", [(1, "global"), (4, "global"), (4, "local")])
def test_checkpoint_dir_resumes_across_packages(writer, K, scheme, tmp_path):
    """A run cut after 6 batches and resumed by the other package ends in
    the state of one uninterrupted run."""
    params = LOCAL if scheme == "local" else None
    edges = _edges(2)
    straight = _port(K, scheme, params)
    run_stream(straight, batches(edges, S))
    ck = str(tmp_path / "ck")
    head = list(batches(edges, S))[:6]
    if writer == "jax":
        jax_run_stream(_jax(K, scheme, params), iter(head), ckpt_dir=ck, ckpt_every=2)
        resumed = _port(K, scheme, params)
        rep = run_stream(resumed, batches(edges, S), ckpt_dir=ck, ckpt_every=2)
        assert rep.resumed_from == 6 and rep.batches == 7
        snap = resumed.snapshot()
    else:
        run_stream(_port(K, scheme, params), iter(head), ckpt_dir=ck, ckpt_every=2)
        resumed = _jax(K, scheme, params)
        rep = jax_run_stream(resumed, jax_batches(edges, S), ckpt_dir=ck, ckpt_every=2)
        assert rep.resumed_from == 6 and rep.batches == 7
        snap = resumed.snapshot()
    assert str(snap["scheme"]) == scheme
    assert state_sha256(snap) == state_sha256(straight.snapshot())


def test_chunked_checkpoint_never_skips_a_staged_batch(tmp_path):
    """With K = 4 the checkpoint after the first chunk is written while the
    second chunk (source positions 7-10) is already staged: its source_pos
    counts only what was ingested or quarantined before, so a run killed
    there and resumed ingests every batch exactly once."""
    stream = _poisoned_stream(_edges(3))
    straight = _port(4)
    run_stream(straight, iter(stream))
    ck = tmp_path / "ck"
    run_stream(_port(4), iter(stream[:12]), ckpt_dir=str(ck), ckpt_every=4)
    mgr = tckpt.CheckpointManager(str(ck))
    assert mgr.steps() == [4, 8, 10]
    assert [(mgr.manifest(s)["step"], mgr.manifest(s)["source_pos"]) for s in (4, 8, 10)] == [
        (4, 5), (8, 10), (10, 12)]
    for s in (8, 10):  # the kill: only the checkpoint taken with chunk 2 staged survives
        shutil.rmtree(ck / f"step_{s:010d}")
    resumed = _port(4)
    rep = run_stream(resumed, iter(stream), ckpt_dir=str(ck), ckpt_every=4)
    assert rep.resumed_from == 4 and rep.quarantined_batches == 2  # positions 6 and 13
    assert state_sha256(resumed.snapshot()) == state_sha256(straight.snapshot())


def _corrupt_shard(d: pathlib.Path):
    """Silent corruption that leaves the zip readable: only the manifest's
    checksums catch it."""
    shard = next(d.glob("shard_*.npz"))
    with np.load(shard) as z:
        data = {k: z[k] for k in z.files}
    key = max(data, key=lambda k: data[k].size)
    data[key] = data[key] + 1
    np.savez(shard.with_suffix(""), **data)


def test_corrupt_newest_checkpoint_is_walked_past(tmp_path):
    edges = _edges(4)
    straight = _port()
    run_stream(straight, batches(edges, S))
    ck = tmp_path / "ck"
    run_stream(_port(), iter(list(batches(edges, S))[:9]), ckpt_dir=str(ck), ckpt_every=3)
    newest = sorted(ck.glob("step_*"))[-1]
    assert newest.name == "step_0000000009"
    _corrupt_shard(newest)
    eng = _port()
    rep = run_stream(eng, batches(edges, S), ckpt_dir=str(ck), ckpt_every=3)
    assert rep.ckpt_corrupt_skipped == 1 and rep.resumed_from == 6
    assert eng.diag.ckpt_corrupt_skipped == 1  # counted where the reference counts it
    assert state_sha256(eng.snapshot()) == state_sha256(straight.snapshot())
    # and the JAX loop walks past the same corruption in a port-written directory
    ck2 = tmp_path / "ck2"
    run_stream(_port(), iter(list(batches(edges, S))[:9]), ckpt_dir=str(ck2), ckpt_every=3)
    _corrupt_shard(sorted(ck2.glob("step_*"))[-1])
    jeng = _jax()
    jrep = jax_run_stream(jeng, jax_batches(edges, S), ckpt_dir=str(ck2), ckpt_every=3)
    assert jeng.diag.ckpt_corrupt_skipped == 1 and jrep.resumed_from == 6
    assert state_sha256(jeng.snapshot()) == state_sha256(straight.snapshot())


def test_resume_refuses_other_batch_size_and_scheme(tmp_path):
    ck = str(tmp_path / "ck")
    run_stream(_port(), iter(list(batches(_edges(), S))[:3]), ckpt_dir=ck)
    other = TriangleCountEngine(EngineConfig(r=R, batch_size=32, seeds=(5,), device="cpu"))
    with pytest.raises(SnapshotMismatch, match="batch_size"):
        run_stream(other, batches(_edges(), 32), ckpt_dir=ck)
    with pytest.raises(SnapshotMismatch, match="scheme"):
        run_stream(_port(1, "local", LOCAL), batches(_edges(), S), ckpt_dir=ck)
    wider = TriangleCountEngine(EngineConfig(r=2 * R, batch_size=S, device="cpu"))
    with pytest.raises(SnapshotMismatch, match="does not fit"):
        run_stream(wider, batches(_edges(), S), ckpt_dir=ck)


def test_checkpoint_manager_integrity(tmp_path):
    orphan = tmp_path / ".tmp_step_0000000009_123"
    orphan.mkdir()
    (tmp_path / "stray.tmp").mkdir()
    ckpt = tckpt.CheckpointManager(str(tmp_path), keep=2)
    assert not orphan.exists() and not (tmp_path / "stray.tmp").exists()
    state = {"x": np.arange(8, dtype=np.int32), "y": np.float32(3.5)}
    for s in (1, 2, 3):
        ckpt.save(s, {**state, "x": state["x"] + s})
    assert ckpt.steps() == [2, 3]
    restored, manifest = ckpt.restore(state)
    np.testing.assert_array_equal(restored["x"], state["x"] + 3)
    assert manifest["keys"] == ["['x']", "['y']"]
    _corrupt_shard(tmp_path / "step_0000000003")
    with pytest.raises(tckpt.CheckpointCorrupt):
        ckpt.restore(state, step=3)
    (tmp_path / "step_0000000002" / "manifest.json").write_text("{oops")
    with pytest.raises(tckpt.CheckpointCorrupt):
        ckpt.manifest(2)
    # the JAX manager reads a port-written checkpoint and verifies it
    jm = jckpt.CheckpointManager(str(tmp_path / "j"))
    pm = tckpt.CheckpointManager(str(tmp_path / "j"))
    pm.save(4, state)
    assert jm.verify(4)
    np.testing.assert_array_equal(jm.restore(state)[0]["x"], state["x"])


def test_async_save_error_surfaces_on_wait(tmp_path):
    ckpt = tckpt.CheckpointManager(str(tmp_path), async_save=True)
    ckpt.save("one", {"x": np.arange(4)})  # the writer thread cannot name this step
    with pytest.raises(ValueError):
        ckpt.wait()
    ckpt.save(2, {"x": np.arange(4)})  # still usable
    ckpt.wait()
    assert ckpt.latest_step() == 2
