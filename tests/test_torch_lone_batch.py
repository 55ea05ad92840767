"""The lone-batch route on the card: on the kernel ingest backend the
``single`` plan ingests a batch that fills no chunk as a one-batch chunk
(``fused_ingest`` at K = 1), bit-identical to ``bulk_update_all`` with the
kernel search. CUDA only; the route's parity with the JAX reference on the
CPU is ``tests/test_torch_engine.py``'s lone-batch tests. This file imports
no JAX, so that it runs where the card is."""
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.core.bulk import bulk_update_all
from repro_torch.core.state import init_state
from repro_torch.engine import EngineConfig, TriangleCountEngine
from repro_torch.kernels import LAUNCHES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2**21, 20_971_520])
def test_cuda_lone_batches_take_fused_ingest(cuda, r):
    """A full and a ragged batch at s = 2^20: the engine's state equals
    ``bulk_update_all`` with the kernel search after each, with one
    ``fused_ingest`` launch a batch and no ``multisearch_counts``."""
    s, seed = 2**20, 2**33 + 9
    g = np.random.default_rng(r)
    batches = [(g.integers(0, 60_000, size=(s, 2), dtype=np.int32), n) for n in (s, s // 3 + 7)]
    eng = TriangleCountEngine(EngineConfig(r=r, batch_size=s, seeds=(seed,), chunk_size=4))
    want = init_state(r, cuda, n_tenants=1)
    root = rng.PRNGKey(seed, cuda)[None]
    for step, (W, n) in enumerate(batches):
        before = dict(LAUNCHES)
        eng.ingest(W[:n])
        torch.cuda.synchronize()
        assert LAUNCHES["fused_ingest"] - before["fused_ingest"] == 1
        assert LAUNCHES["multisearch_counts"] == before["multisearch_counts"]
        Wt = torch.from_numpy(np.where(np.arange(s)[:, None] < n, W, 0)).to(cuda)[None]
        want = bulk_update_all(want, Wt, n, rng.fold_in(root, step), search="kernel")
        for f, a, b in zip(want._fields, eng.state, want):
            assert torch.equal(a, b), f"{f} after batch {step}"
    assert eng.batches_as_chunk == 2 and eng.step == 2
