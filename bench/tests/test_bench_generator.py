"""The Kronecker generator and the job source."""
import numpy as np
import torch

from bench.traffic import generator


def _graph(seed, scale=10):
    return generator.kronecker(scale, 16, 0.57, 0.19, 0.19, seed, "cpu")


def test_deterministic_by_seed():
    a, b, c = _graph(5), _graph(5), _graph(6)
    assert torch.equal(a, b)
    assert not (a.shape == c.shape and torch.equal(a, c))


def test_no_loops_no_duplicates_min_max():
    E = _graph(3).numpy().astype(np.int64)
    assert E.dtype == np.int64 and E.shape[1] == 2
    assert (E[:, 0] < E[:, 1]).all()  # (min, max) and no self-loop
    assert len(np.unique(E[:, 0] << 10 | E[:, 1])) == len(E)
    assert E.min() >= 0 and E.max() < 1 << 10
    assert 0.5 * (16 << 10) < len(E) < 16 << 10


def test_skewed_degrees():
    E = _graph(4).numpy()
    deg = np.bincount(E.reshape(-1), minlength=1 << 10)
    assert deg.max() > 10 * deg.mean()
    assert (deg == 0).sum() > 0.1 * len(deg)  # Kronecker graphs leave vertices isolated


def test_shuffled_order():
    E = _graph(7).numpy().astype(np.int64)
    keys = E[:, 0] << 10 | E[:, 1]
    assert not (np.diff(keys) > 0).all()


def test_large_seed():
    assert _graph(2**31 + 99).shape[0] > 0
    assert generator.mix(2**40 + 3, 7, -1, 0) != generator.mix(2**40 + 3, 7, 0, 0)


def test_job_graphs_cut_and_tenants():
    traffic = {"scale": 10, "edgefactor": 16, "a": 0.57, "b": 0.19, "c": 0.19,
               "graph_per_tenant": True}
    G, unique = generator.job_graphs(traffic, 3, 11, "cpu")
    assert G.shape == (3, min(unique), 2) and len(unique) == 3 and len(set(unique)) > 1
    assert not np.array_equal(G[0], G[1])
    one, _ = generator.job_graphs({**traffic, "graph_per_tenant": False}, 2, 11, "cpu")
    assert one.shape[1] == unique[0] and np.array_equal(one[0], one[1])
    assert np.array_equal(one[0, :min(unique)], G[0])


def test_job_source_batches_and_stamps():
    G = np.arange(2 * 10 * 2, dtype=np.int32).reshape(2, 10, 2)
    stamps = []
    items = list(generator.job_source(G, 4, stamps))
    assert [n for _, n in items] == [4, 4, 2]
    assert len(stamps) == 3 and stamps == sorted(stamps)
    W, n = items[-1]
    assert W.shape == (2, 4, 2) and (W[:, n:] == 0).all() and (W[:, :n] == G[:, 8:]).all()
    one = list(generator.job_source(G[:1], 4, []))
    assert one[0][0].shape == (4, 2)
    assert generator.n_batches(10, 4) == 3


def test_job_graphs_whole_by_default():
    traffic = {"scale": 10, "edgefactor": 16, "a": 0.57, "b": 0.19, "c": 0.19,
               "graph_per_tenant": False}
    G, unique = generator.job_graphs(traffic, 1, 11, "cpu")
    assert G.shape == (1, unique[0], 2)
    assert np.array_equal(G[0], _graph(generator.mix(11, 0)).numpy())
