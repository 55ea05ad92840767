"""The port's kernels: each plain version against the JAX package's
``kernels/ref.py`` oracle on the oracle harness's adversarial inputs, once
against the Pallas kernel in interpret mode at a tiny shape, the wrappers'
CPU dispatch and argument checks, and (on a CUDA machine only) each CUDA
kernel against its plain version."""
import ctypes
import itertools
import sys
import pathlib

import numpy as np
import pytest

import repro  # noqa: F401  -- enables x64
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from _kernel_oracle import _adversarial_stream, key_families  # noqa: E402
from repro.core.state import init_state as jax_init_state  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro.kernels import ref as kref  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.core.bulk import bulk_update_chunk, chunk_draws, chunk_structures  # noqa: E402
from repro_torch.core.state import init_state  # noqa: E402
from repro_torch.kernels import CUDA_LAUNCHES, LAUNCHES, _build, ref  # noqa: E402
from repro_torch.kernels.bitonic import bitonic_sort_tiles, bitonic_sort_tiles_plain  # noqa: E402
from repro_torch.kernels.fused_ingest import (  # noqa: E402
    fused_ingest,
    fused_ingest_hoisted,
    fused_ingest_plain,
)
from repro_torch.kernels.multisearch import multisearch_counts, multisearch_counts_plain  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_plain  # noqa: E402
from repro_torch.kernels.segscan import (  # noqa: E402
    segmented_max_scan,
    segmented_max_scan_plain,
    segscan,
    segscan_plain,
)
from repro.primitives.segscan import segmented_cummax as jax_segmented_cummax  # noqa: E402

INF64 = np.iinfo(np.int64).max
T = torch.from_numpy
FIELDS = ("f1", "chi", "f2", "has_f3")
jax_segscan_ref = jax.jit(kref.segscan_ref)
jax_cummax = jax.jit(jax_segmented_cummax)
SCAN_TILE = 8192  # entries per CTA of csrc/segscan.cu
I32 = np.iinfo(np.int32)


def _queries(n, q, seed):
    g = np.random.default_rng(seed)
    qs = np.concatenate([g.integers(-5, max(4 * n, 8), max(q - 2, 0)),
                         np.array([INF64] * min(q, 1) + [0] * min(max(q - 1, 0), 1))])
    return qs[:q].astype(np.int64)


def _families(n, seed):
    """The oracle harness's key families and negative keys (-1, as pack2
    makes for empty slots)."""
    fams = key_families(n, seed)
    g = np.random.default_rng(seed + 1)
    fams["negative"] = np.where(g.random(n) < 0.5, -1, g.integers(-3, max(n, 2), n)).astype(np.int64)
    return fams


def _sort_families(n, seed):
    return {**_families(n, seed), "sorted": np.arange(n, dtype=np.int64),
            "reversed": np.arange(n, 0, -1, dtype=np.int64)}


def _search_families(n, seed):
    """Sorted keys: the families and equal runs of up to about n/40 keys,
    longer than the CUDA kernel's sample spacing (ceil(n / 8192))."""
    fams = _families(n, seed)
    fams["long_runs"] = np.random.default_rng(seed).integers(0, 40, n).astype(np.int64) * 1000
    return {k: np.sort(v) for k, v in fams.items()}


def _edge_queries(keys, q, seed):
    """Random queries, then one below every key, one above, the first and
    last keys below INT64 max, 0 and INT64 max."""
    n = len(keys)
    lo = int(keys[0]) if n else 0
    hi = int(keys[keys < INF64].max()) if (keys < INF64).any() else 0
    edge = np.array([lo - 1, hi + 1, lo, hi, 0, INF64], np.int64)
    return np.concatenate([_queries(n, q, seed), edge])


@pytest.mark.parametrize("n,q", [(0, 4), (4, 0), (1, 1), (63, 33), (64, 65), (65, 200)])
def test_multisearch_plain_vs_jax_ref(n, q):
    for name, keys in key_families(n, n + q).items():
        keys = np.sort(keys)
        qs = _queries(n, q, n * q)
        want = kref.multisearch_counts_ref(jnp.asarray(keys), jnp.asarray(qs))
        got = multisearch_counts(T(keys), T(qs))  # CPU tensors: the plain version
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)


@pytest.mark.parametrize("n", [8191, 8192, 8193, 3 * 8192 + 5, 100_003])
def test_multisearch_plain_vs_jax_ref_long_runs(n):
    """n below, at and above the CUDA kernel's 8192-key sample, not a power
    of two, equal runs longer than the sample spacing, queries outside the
    keys and at INT64 max."""
    for name, keys in _search_families(n, n).items():
        qs = _edge_queries(keys, 500, n)
        want = kref.multisearch_counts_ref(jnp.asarray(keys), jnp.asarray(qs))
        got = multisearch_counts(T(keys), T(qs))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 4097])
def test_segscan_plain_vs_jax_ref(n):
    g = np.random.default_rng(n)
    v = g.integers(-5, 7, n).astype(np.int32)
    for name, f in {"random": g.random(n) < 0.2, "sparse": g.random(n) < 0.002,
                    "none": np.zeros(n, bool), "all": np.ones(n, bool)}.items():
        want = jax_segscan_ref(jnp.asarray(v), jnp.asarray(f)) if n else v
        np.testing.assert_array_equal(np.asarray(want), segscan(T(v), T(f)).numpy(), err_msg=name)


def _scan_values(n, seed):
    """Small values, and values at INT32_MIN / INT32_MAX and around them."""
    g = np.random.default_rng(seed)
    return {"small": g.integers(-5, 7, n).astype(np.int32),
            "extremes": g.choice([I32.min, I32.max, I32.min + 1, I32.max - 1, -1, 0, 1],
                                 n).astype(np.int32)}


def _scan_flags(n, seed):
    """Flag families: random, segments that cross the kernel's tile, none,
    every entry."""
    g = np.random.default_rng(seed)
    return {"random": g.random(n) < 0.2, "cross_tile": g.random(n) < 3.0 / SCAN_TILE,
            "none": np.zeros(n, bool), "all": np.ones(n, bool)}


@pytest.mark.parametrize("n", [0, 1, 127, SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1,
                               3 * SCAN_TILE + 5])
def test_segmented_max_scan_plain_vs_jax(n):
    """The max-scan wrapper on CPU tensors (its plain version) against the
    JAX package's segmented_cummax on the same inputs."""
    for (vname, v), (fname, f) in itertools.product(_scan_values(n, n).items(),
                                                    _scan_flags(n, n + 1).items()):
        want = np.asarray(jax_cummax(jnp.asarray(v), jnp.asarray(f))) if n else v
        got = segmented_max_scan(T(v), T(f))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy(), err_msg=f"{vname} {fname}")


@pytest.mark.parametrize("n,tile", [
    (0, 16), (15, 16), (16, 16), (17, 16), (255, 256), (513, 256),
    # tiles below the CUDA kernel's 4096-entry block (many to a block), at
    # it, and 1 to 5 merge passes above it; ragged n
    (9000, 1), (20_001, 2), (3 * 8192 + 16, 16), (50_000, 64), (3 * 2048 + 1, 2048),
    (5 * 4096, 4096), (8193, 8192), (3 * 16384 - 7, 16384), (2 * 32768 + 1, 32768),
    (2**17, 2**17)])
def test_bitonic_plain_vs_jax_ref(n, tile):
    """The plain version is a stable sort: it equals the (stable) oracle
    element for element, payloads included, on the key families and on
    negative, sorted and reversed keys."""
    for name, keys in _sort_families(n, n + tile).items():
        vals = np.arange(n, dtype=np.int32)
        want = kref.bitonic_sort_tiles_ref(jnp.asarray(keys), jnp.asarray(vals), tile)
        got = bitonic_sort_tiles(T(keys), T(vals), tile)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)


@pytest.mark.parametrize("r,s,K", [(33, 6, 3), (200, 40, 4), (64, 16, 1)])
def test_fused_ingest_plain_vs_jax_ref(r, s, K):
    """The structures + the wrapper on CPU tensors (its plain version: the
    chunk's draws and selects, then the hoisted loop) against the JAX scan
    of bulk_update_all over the same chunk."""
    Ws, nv = _adversarial_stream(r, s, K, seed=r)
    want = kref.fused_ingest_ref(jax_init_state(r), jnp.asarray(Ws), jnp.asarray(nv),
                                 jax.random.PRNGKey(r), 5)
    st = init_state(r)
    structs = chunk_structures(T(Ws), T(nv), use_kernels=False)
    got = fused_ingest(st.f1, st.chi, st.f2, st.has_f3, *structs, T(Ws), T(nv), st.m_seen,
                       rng.PRNGKey(r), 5)
    for f, g in zip(FIELDS, got):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), g.numpy(), err_msg=f)
    chunk = bulk_update_chunk(st, T(Ws), T(nv), rng.PRNGKey(r), 5, backend="kernel")
    assert int(chunk.m_seen) == int(want.m_seen)
    port_ref = ref.fused_ingest_ref(init_state(r), T(Ws), T(nv), rng.PRNGKey(r), 5)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port_ref, f).numpy(), np.asarray(getattr(want, f)))
        np.testing.assert_array_equal(getattr(chunk, f).numpy(), np.asarray(getattr(want, f)))


def _segment_sum_families(n, m, d, seed):
    """The oracle harness's segment_sum families (integer-valued float64
    values; ids in range, with dropped ids on both sides, all in one bin)."""
    g = np.random.default_rng(seed)
    vals = g.integers(-3, 9, (n, d)).astype(np.float64)
    ids = {"random": g.integers(0, max(m, 1), n),
           "with_dropped": g.integers(-2, max(m, 1) + 3, n),
           "all_one_segment": np.zeros(n, np.int64)}
    return vals, {k: v.astype(np.int32) for k, v in ids.items()}


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("n,m", [(0, 8), (8, 0), (63, 31), (64, 32), (65, 33), (129, 65)])
def test_segment_sum_plain_vs_jax(n, m, d):
    """The wrapper on CPU tensors (its plain version) against the JAX
    Pallas kernel in interpret mode, at the oracle harness's blocks (values
    64, segments 32, so n and m straddle both), and against both oracles."""
    vals, fams = _segment_sum_families(n, m, d, seed=41 + n + m)
    for name, ids in fams.items():
        want = np.asarray(ops.segment_sum_op(jnp.asarray(vals), jnp.asarray(ids), m,
                                             v_block=64, out_block=32))
        got = segment_sum(T(vals), T(ids), m)
        assert got.shape == (m, d) and got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(kref.segment_sum_ref(jnp.asarray(vals), jnp.asarray(ids), m)), want)
        np.testing.assert_array_equal(ref.segment_sum_ref(T(vals), T(ids), m).numpy(), want)


def test_plain_versions_vs_pallas_interpret():
    """Each plain version once against the Pallas kernel itself, run in
    interpret mode at a tiny shape."""
    g = np.random.default_rng(0)
    keys = np.sort(g.integers(0, 50, 70)).astype(np.int64)
    qs = _queries(70, 40, 1)
    for w, t in zip(ops.multisearch_counts_op(jnp.asarray(keys), jnp.asarray(qs), q_block=32, k_block=64),
                    multisearch_counts_plain(T(keys), T(qs))):
        np.testing.assert_array_equal(np.asarray(w), t.numpy())
    v = g.integers(-3, 5, 300).astype(np.int32)
    f = g.random(300) < 0.1
    np.testing.assert_array_equal(np.asarray(ops.segscan_op(jnp.asarray(v), jnp.asarray(f), block=128)),
                                  segscan_plain(T(v), T(f)).numpy())
    k = g.integers(0, 1000, 64).astype(np.int64)  # distinct-ish keys: exact payloads
    k = np.unique(k)[:32]
    g.shuffle(k)
    vals = np.arange(32, dtype=np.int32)
    for w, t in zip(ops.bitonic_sort_tiles_op(jnp.asarray(k), jnp.asarray(vals), tile=16),
                    bitonic_sort_tiles_plain(T(k), T(vals), 16)):
        np.testing.assert_array_equal(np.asarray(w), t.numpy())
    r, s, K = 40, 8, 2
    Ws, nv = _adversarial_stream(r, s, K, seed=3)
    st = init_state(r)
    args = (*chunk_structures(T(Ws), T(nv), use_kernels=False),
            *chunk_draws(st, T(Ws), T(nv), rng.PRNGKey(3), 0))
    plain = fused_ingest_hoisted(st.f1, st.chi, st.f2, st.has_f3, *args)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    jargs[-2:] = [a.astype(jnp.uint32) for a in jargs[-2:]]  # phi words as uint32
    js = jax_init_state(r)
    pallas = ops.fused_ingest_op(js.f1, js.chi, js.f2, js.has_f3, *jargs, est_block=16)
    for w, t in zip(pallas, plain):
        np.testing.assert_array_equal(np.asarray(w), t.numpy())


def test_wrappers_take_plain_version_only_on_cpu():
    before, cuda_before = dict(LAUNCHES), dict(CUDA_LAUNCHES)
    k = torch.arange(10, dtype=torch.int64)
    multisearch_counts(k, k)
    segscan(torch.ones(10, dtype=torch.int32), torch.zeros(10, dtype=torch.bool))
    segmented_max_scan(torch.ones(10, dtype=torch.int32), torch.zeros(10, dtype=torch.bool))
    bitonic_sort_tiles(k.flip(0).contiguous(), torch.zeros(10, dtype=torch.int32), 16)
    segment_sum(torch.ones(10, 1, dtype=torch.float64), torch.zeros(10, dtype=torch.int32), 3)
    assert LAUNCHES == before  # no launch counted off the card
    assert CUDA_LAUNCHES == cuda_before


def test_launch_counts_what_the_entry_reports(monkeypatch):
    """``_build.launch`` passes the C entry an out-count as its last
    argument: on success it adds one wrapper launch and the CUDA kernels the
    entry reports; on an error it raises and counts nothing."""
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(LAUNCHES, 0))
    monkeypatch.setattr(_build, "CUDA_LAUNCHES", dict.fromkeys(LAUNCHES, 0))
    proto = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int64, _build.QUEUED)

    def entry(err, queued):
        queued[0] = 0 if err else 3
        return err

    fn = proto(entry)
    _build.launch("segscan", fn, 0)
    _build.launch("segscan", fn, 0)
    assert _build.LAUNCHES["segscan"] == 2 and _build.CUDA_LAUNCHES["segscan"] == 6
    with pytest.raises(RuntimeError, match="error code 9"):
        _build.launch("segscan", fn, 9)
    assert _build.LAUNCHES["segscan"] == 2 and _build.CUDA_LAUNCHES["segscan"] == 6


def test_wrapper_argument_checks():
    with pytest.raises(ValueError, match="CUDA"):
        _build.check(torch.zeros(3, dtype=torch.int64), "keys", torch.int64)
    with pytest.raises(ValueError, match="power of two"):
        bitonic_sort_tiles(torch.zeros(6, dtype=torch.int64), torch.zeros(6, dtype=torch.int32), 6)
    with pytest.raises(RuntimeError, match="error code 7"):
        _build.raise_on_error(7, "segscan")


def test_build_is_keyed_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    names = {_build.library_path(n).name for n in _build.SOURCES}
    assert len(names) == 5 and all(n.startswith("lib") and n.endswith(".so") for n in names)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "segscan.cu").write_text("// one\n")
    one = _build.library_path("segscan")
    (tmp_path / "segscan.cu").write_text("// two\n")
    two = _build.library_path("segscan")
    assert two != one
    # a shared header is part of every source's key
    (tmp_path / "search.cuh").write_text("// h1\n")
    h1 = _build.library_path("segscan")
    assert h1 != two
    (tmp_path / "search.cuh").write_text("// h2\n")
    assert _build.library_path("segscan") != h1
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q", [(0, 5), (5, 0), (257, 1000), (100_000, 4096)])
def test_cuda_multisearch(cuda, n, q):
    for keys in key_families(n, q).values():
        k, qs = T(np.sort(keys)).to(cuda), T(_queries(n, q, 7)).to(cuda)
        for a, b in zip(multisearch_counts(k, qs), multisearch_counts_plain(k, qs)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4095, 4097, 1_000_003])
def test_cuda_segscan(cuda, n):
    g = np.random.default_rng(n)
    v = T(g.integers(-5, 7, n).astype(np.int32)).to(cuda)
    for p in (0.0, 0.0005, 0.2, 1.0):
        f = T(g.random(n) < p).to(cuda)
        assert torch.equal(segscan(v, f), segscan_plain(v, f))


@pytest.mark.cuda
@pytest.mark.parametrize("n,q", [(8191, 300), (8192, 300), (8193, 300), (3 * 8192 + 5, 300),
                                 (100_003, 4096)])
def test_cuda_multisearch_sample_edges(cuda, n, q):
    """n below, at and above the kernel's shared-memory sample; equal runs
    longer than its spacing; queries outside the keys and at INT64 max."""
    for name, keys in _search_families(n, n).items():
        k, qs = T(keys).to(cuda), T(_edge_queries(keys, q, n)).to(cuda)
        for a, b in zip(multisearch_counts(k, qs), multisearch_counts_plain(k, qs)):
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("n,tile", [(17, 16), (8193, 8192), (3 * 2**16, 2**16),
                                    (50_000, 2), (3 * 8192 + 16, 16), (2048, 2048),
                                    (4096, 4096), (3 * 2**17 - 5, 2**17)])
def test_cuda_bitonic(cuda, n, tile):
    """Tiles below the kernel's block, at it, and 1 to 5 merge passes above
    it, ragged n, on distinct keys and every family. The kernel's merges are
    stable, so it equals the stable plain version entry for entry, payloads
    included, and it leaves its input as it was."""
    fams = {"distinct": np.random.default_rng(n).permutation(n).astype(np.int64),
            **_sort_families(n, n + tile)}
    for name, keys in fams.items():
        k = T(keys).to(cuda)
        v = torch.arange(n, dtype=torch.int32, device=cuda)
        for a, b in zip(bitonic_sort_tiles(k, v, tile), bitonic_sort_tiles_plain(k, v, tile)):
            assert torch.equal(a, b), name
        assert torch.equal(k.cpu(), T(keys)), "the sort is out of place"


@pytest.mark.cuda
@pytest.mark.parametrize("tile,most", [(16, 1), (4096, 1), (2**20, 10), (2**21, 10)])
def test_cuda_bitonic_launches_per_call(cuda, tile, most, monkeypatch):
    """One tile sort call queues at most 10 CUDA kernels at the ingest
    path's tiles (55 with the network of global passes), one where a tile
    fits the kernel's shared-memory block; a search queues one."""
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(LAUNCHES, 0))
    monkeypatch.setattr(_build, "CUDA_LAUNCHES", dict.fromkeys(LAUNCHES, 0))
    k = torch.randint(-5, 2**40, (2 * tile,), dtype=torch.int64, device=cuda)
    v = torch.arange(2 * tile, dtype=torch.int32, device=cuda)
    bitonic_sort_tiles(k, v, tile)
    assert _build.LAUNCHES["bitonic_sort_tiles"] == 1
    assert 1 <= _build.CUDA_LAUNCHES["bitonic_sort_tiles"] <= most
    multisearch_counts(torch.sort(k).values, k)
    assert _build.LAUNCHES["multisearch_counts"] == _build.CUDA_LAUNCHES["multisearch_counts"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,K", [(33, 6, 3), (5000, 512, 4)])
def test_cuda_fused_ingest(cuda, r, s, K):
    """The kernel, drawing its own randomness, against its plain version
    (the hoisted draws and selects, then the hoisted loop) and against the
    JAX scan of bulk_update_all; K launches per call."""
    Ws, nv = _adversarial_stream(r, s, K, seed=s)
    want = kref.fused_ingest_ref(jax_init_state(r), jnp.asarray(Ws), jnp.asarray(nv),
                                 jax.random.PRNGKey(s), 0)
    st = init_state(r, cuda)
    Wt, nvt = T(Ws).to(cuda), T(nv).to(cuda)
    args = (*chunk_structures(Wt, nvt, use_kernels=True), Wt, nvt, st.m_seen,
            rng.PRNGKey(s, cuda), 0)
    before = CUDA_LAUNCHES["fused_ingest"]
    got = fused_ingest(st.f1, st.chi, st.f2, st.has_f3, *args)
    assert CUDA_LAUNCHES["fused_ingest"] - before == K
    for f, a, b in zip(FIELDS, got, fused_ingest_plain(st.f1, st.chi, st.f2, st.has_f3, *args)):
        assert torch.equal(a, b), f
        np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,K,m_seen,step0,empty", [
    (513, 511, 4, 2**32 + 17, 2**32 - 2, (1,)),  # 64-bit spans, the fold-in wrap
    (511, 512, 3, 0, 0, (0,)),  # a fresh state whose first batch is empty
    (1537, 513, 2, 2**40, 7, ()),  # 2s around the kernel's 1024-key samples
    (5000, 1023, 2, 123_456, 2**32 - 1, ()),  # s around them
    (1025, 1025, 2, 3, 2**33, ()),
])
def test_cuda_fused_ingest_edges(cuda, r, s, K, m_seen, step0, empty):
    """The kernel equals its plain version on a populated state at stream
    lengths above 2^32 and at 0, across the 32-bit wrap of the fold-in
    counter, with empty batches, r off the kernel's 512-estimator tile and
    the structures below, at and above its shared samples."""
    Ws, nv = _adversarial_stream(r, s, K, seed=r + s)
    nv[list(empty)] = 0
    Wt, nvt = T(Ws).to(cuda), T(nv).to(cuda)
    key = rng.PRNGKey(s, cuda)
    st = bulk_update_chunk(init_state(r, cuda), Wt, nvt, key, backend="kernel")
    st = st._replace(m_seen=torch.tensor(m_seen, dtype=torch.int64, device=cuda)) if m_seen \
        else init_state(r, cuda)
    args = (st.f1, st.chi, st.f2, st.has_f3, *chunk_structures(Wt, nvt, use_kernels=True),
            Wt, nvt, st.m_seen, key, step0)
    for f, a, b in zip(FIELDS, fused_ingest(*args), fused_ingest_plain(*args)):
        assert torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("n,m", [(0, 8), (8, 0), (255, 31), (257, 1000), (1_000_003, 4096)])
def test_cuda_segment_sum(cuda, n, m, d):
    vals, fams = _segment_sum_families(n, m, d, seed=n + m)
    v = T(vals).to(cuda)
    for ids in fams.values():
        i = T(ids).to(cuda)
        assert torch.equal(segment_sum(v, i, m), segment_sum_plain(v, i, m))


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", ["sum", "max"])
@pytest.mark.parametrize("n", [0, 1, SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1, 2**23 + 3])
def test_cuda_segscan_monoids(cuda, monoid, n):
    """Both monoids of the single-pass scan against their plain versions at
    n = 0, 1, the tile +-1 and 2^23 + 3, on small and extreme values (sums
    that wrap, INT32_MIN and INT32_MAX), at random flag densities, with no
    flag (the longest look-back chains) and every entry flagged, and on a
    view off 16-byte alignment (the kernel's scalar loads)."""
    fn, plain = {"sum": (segscan, segscan_plain),
                 "max": (segmented_max_scan, segmented_max_scan_plain)}[monoid]
    g = np.random.default_rng(n)
    flags = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
             **{f"p={p}": g.random(n) < p for p in (0.5, 0.01, 3.0 / SCAN_TILE, 1e-6)}}
    for (vname, v), (fname, f) in itertools.product(_scan_values(n, n).items(), flags.items()):
        vt, ft = T(v).to(cuda), T(f).to(cuda)
        for a, b in ((vt, ft), (vt[1:], ft[1:])):
            assert torch.equal(fn(a, b), plain(a, b)), f"{vname} {fname} n={a.numel()}"


@pytest.mark.cuda
@pytest.mark.parametrize("fam,d", [("random", 1), ("all_dropped", 1), ("all_one_segment", 1),
                                   ("random", 2)])
def test_cuda_segment_sum_past_the_resident_grid(cuda, fam, d):
    """More rows (9,000,001) than the cooperative grid holds in registers
    (about 4.3M ids), so the rest are read after the barrier: ids in range,
    every id out of range, every row in one bin, d = 2, and an unaligned
    view of the ids."""
    n, m = 9_000_001, 2**22 if d == 1 else 1000
    g = np.random.default_rng(d)
    ids = {"random": g.integers(-1, m, n), "all_dropped": np.full(n, m),
           "all_one_segment": np.zeros(n, np.int64)}[fam].astype(np.int32)
    v = T(g.integers(-3, 9, (n, d)).astype(np.float64)).to(cuda)
    i = T(ids).to(cuda)
    for a, b in ((v, i), (v[1:], i[1:])):
        assert torch.equal(segment_sum(a, b, m), segment_sum_plain(a, b, m))


@pytest.mark.cuda
def test_cuda_scans_and_segment_sum_launch_once(cuda, monkeypatch):
    """segscan (both monoids) and segment_sum queue one CUDA kernel per
    call, as their C entries report it (segscan's memset of its scratch and
    nothing of segment_sum's zero-fill is a kernel launch)."""
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(LAUNCHES, 0))
    monkeypatch.setattr(_build, "CUDA_LAUNCHES", dict.fromkeys(LAUNCHES, 0))
    n = 3 * 2**20 + 7
    v = torch.randint(-9, 9, (n,), dtype=torch.int32, device=cuda)
    f = torch.rand(n, device=cuda) < 0.001
    segscan(v, f)
    segmented_max_scan(v, f)
    segment_sum(v.to(torch.float64)[:, None], v, 5)
    for name in ("segscan", "segmented_max_scan", "segment_sum"):
        assert _build.LAUNCHES[name] == _build.CUDA_LAUNCHES[name] == 1, name
