"""The port's sequential baseline (``repro_torch.core.sequential``) against
the reference's: ``gamma_after`` on every position of a stream, and
``SequentialNS`` from the same seed, whose estimator arrays, coarse
estimates and median-of-means estimate must be equal, not close."""
import numpy as np
import pytest

from repro.core import sequential as jseq
from repro.data import graph_stream as jgs
from repro_torch.core import sequential as tseq


@pytest.mark.parametrize("seed", [0, 1])
def test_gamma_after_matches_reference(seed):
    edges = jgs.erdos_renyi_stream(25, 90, seed=seed)
    got = [tseq.gamma_after(edges, i) for i in range(len(edges))]
    assert got == [jseq.gamma_after(edges, i) for i in range(len(edges))]
    assert max(got) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_sequential_ns_matches_reference(seed):
    edges, tau = jgs.planted_triangle_stream(15, 120, 200, seed=seed)
    port, ref = tseq.SequentialNS(r=3000, seed=seed), jseq.SequentialNS(r=3000, seed=seed)
    port.process(edges)
    ref.process(edges)
    assert port.m == ref.m == len(edges)
    for k in ("f1", "chi", "f2", "has_f3"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k), err_msg=k)
    assert port.has_f3.any()
    np.testing.assert_array_equal(port.coarse(), ref.coarse())
    for groups in (9, 1, 5000):  # 5000 > r: the plain mean
        assert port.estimate(groups) == ref.estimate(groups)
    assert abs(port.estimate() - tau) < tau  # the baseline estimates tau
