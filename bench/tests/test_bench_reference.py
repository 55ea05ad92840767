"""The reference's draws are jax.random's, as the program's are (the
program's own tests hold it to JAX; here the two are held to each other
on the CPU)."""
import torch

from bench.reference import nbsi
from repro_torch import rng

SEEDS = (0, 3, 2**31 + 5, 2**40 + 17)


def _key(seed):
    return rng.PRNGKey(seed)


def test_keys_fold_in_and_split():
    for seed in SEEDS:
        k = nbsi.prng_key(seed)
        assert tuple(int(x) for x in _key(seed)) == k
        assert tuple(int(x) for x in rng.fold_in(_key(seed), 41)) == nbsi.fold_in(k, 41)
        sp = rng.split(_key(seed))
        assert [tuple(int(x) for x in row) for row in sp] == list(nbsi.split(k))


def test_draws():
    n = 5000
    for seed in SEEDS:
        k = nbsi.prng_key(seed)
        assert torch.equal(rng.bits32(_key(seed), (n,)), nbsi.bits(k, n, "cpu"))
        assert torch.equal(rng.bits64(_key(seed), (n,)), nbsi.bits(k, n, "cpu", 64))
        assert torch.equal(rng.uniform(_key(seed), (n,)), nbsi.uniform32(k, n, "cpu"))
        span = torch.randint(1, 1 << 30, (n,), dtype=torch.int64)
        assert torch.equal(rng.randint64(_key(seed), span, (n,)),
                           nbsi.randint64(k, span, n, "cpu"))
        span32 = torch.randint(1, 5000, (n,), dtype=torch.int64)
        assert torch.equal(rng.randint32(_key(seed), span32, (n,)).to(torch.int64),
                           nbsi.randint32(k, span32, n, "cpu"))


def test_vertex_pool():
    from repro_torch.core.schemes import vertex_pool

    v = torch.tensor([-1, 0, 1, 2**22 - 1, 123456789, 2**31 - 1])
    assert torch.equal(vertex_pool(v, 8).to(torch.int64), nbsi.vertex_pool(v, 8))
