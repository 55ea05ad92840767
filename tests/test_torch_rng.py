"""The port's threefry RNG against ``jax.random`` (jax's partitionable
threefry), bit for bit: keys, fold_in, split, 32/64-bit bits, uniform, and
randint for int32 (a span per lane) and int64 (spans above 2**32)."""
import numpy as np
import pytest

import repro  # noqa: F401  -- enables x64
import jax
import jax.numpy as jnp
import torch

from repro.primitives.ingest import randint_from_bits as jax_randint_from_bits
from repro_torch import rng
from repro_torch.primitives.ingest import randint_from_bits, split_randint_key

SEEDS = [0, 1, 42, 2**33 + 5, -3]


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    k = jax.random.PRNGKey(seed)
    tk = rng.PRNGKey(seed)
    np.testing.assert_array_equal(_np(k), tk.numpy())
    for step in (0, 1, 7, 123456, 2**32 - 1):
        np.testing.assert_array_equal(_np(jax.random.fold_in(k, step)),
                                      rng.fold_in(tk, step).numpy())
    steps = np.arange(5, dtype=np.int64) + 3
    batched = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.asarray(steps))
    np.testing.assert_array_equal(_np(batched), rng.fold_in(tk, torch.from_numpy(steps)).numpy())
    np.testing.assert_array_equal(_np(jax.random.split(k)), rng.split(tk).numpy())
    np.testing.assert_array_equal(_np(jax.random.split(k, 5)), rng.split(tk, 5).numpy())
    np.testing.assert_array_equal(_np(jax.vmap(jax.random.split)(batched)),
                                  rng.split(rng.fold_in(tk, torch.from_numpy(steps))).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 37, 1000])
def test_bits_and_uniform(seed, n):
    k, tk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.bits(k, (n,), jnp.uint32)).astype(np.int64),
                                  rng.bits32(tk, (n,)).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.bits(k, (n,), jnp.uint64)).view(np.int64),
                                  rng.bits64(tk, (n,)).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(k, (n,), dtype=jnp.float32)),
                                  rng.uniform(tk, (n,)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_randint32_span_per_lane(seed):
    g = np.random.default_rng(seed & 0xFF)
    spans = g.integers(1, 2**31 - 1, 600).astype(np.int32)
    spans[:8] = [1, 2, 3, 255, 65536, 65537, 2**31 - 1, 0]  # 0 -> span 1
    k, tk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    want = jax.random.randint(k, (600,), 0, jnp.asarray(spans), dtype=jnp.int32)
    np.testing.assert_array_equal(np.asarray(want),
                                  rng.randint32(tk, torch.from_numpy(spans), (600,)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("maxval", [1, 2, 3, 10**9, 2**32 - 1, 2**32 + 7, 3 * 2**40 + 11,
                                    2**62 + 3, 2**63 - 1])
def test_randint64_wide_spans(seed, maxval):
    k, tk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    want = jax.random.randint(k, (300,), jnp.int64(0), jnp.int64(maxval), dtype=jnp.int64)
    np.testing.assert_array_equal(np.asarray(want),
                                  rng.randint64(tk, torch.tensor(maxval), (300,)).numpy())


def test_randint64_batched_keys_and_spans():
    """The chunk draw: K keys from vmap(fold_in), one span per key."""
    k, tk = jax.random.PRNGKey(9), rng.PRNGKey(9)
    steps = np.arange(4, dtype=np.int64) + 11
    spans = np.array([5, 2**33 + 1, 10**12, 1], np.int64)
    keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.asarray(steps))
    want = jax.vmap(lambda kk, m: jax.random.randint(kk, (50,), jnp.int64(0), m, dtype=jnp.int64))(
        keys, jnp.asarray(spans))
    got = rng.randint64(rng.fold_in(tk, torch.from_numpy(steps)), torch.from_numpy(spans)[:, None], (50,))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", [0, 5])
def test_randint_from_bits_wraps_like_jax(seed):
    """uint32 products that pass 2**32: spans near 2**31 and 2**32 with
    words near 2**32."""
    g = np.random.default_rng(seed)
    hi = g.integers(0, 2**32, 400, dtype=np.uint64).astype(np.uint32)
    lo = g.integers(0, 2**32, 400, dtype=np.uint64).astype(np.uint32)
    hi[:4] = lo[:4] = 2**32 - 1
    span = g.integers(1, 2**31 - 1, 400).astype(np.int32)
    span[:6] = [2**31 - 1, 2**31 - 2, 65537, 46341, 3, 1]
    want = jax_randint_from_bits(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(span))
    for words in ((hi.astype(np.int64), lo.astype(np.int64)), (hi.view(np.int32), lo.view(np.int32))):
        got = randint_from_bits(torch.from_numpy(words[0]), torch.from_numpy(words[1]),
                                torch.from_numpy(span))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_split_randint_key_matches_randint():
    k, tk = jax.random.PRNGKey(3), rng.PRNGKey(3)
    spans = torch.arange(1, 101, dtype=torch.int32)
    khi, klo = split_randint_key(tk)
    got = randint_from_bits(rng.bits32(khi, (100,)), rng.bits32(klo, (100,)), spans)
    want = jax.random.randint(k, (100,), 0, jnp.arange(1, 101, dtype=jnp.int32), dtype=jnp.int32)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
