"""The comparison that decides ``correct``, driven through a whole run of
each cell at a tiny size on the CPU (the harness's look for a chip is the
entry point's, which these tests skip): sound runs are correct, and each
fault planted under the timed path, and the lower-precision control, are
not."""
import time

import pytest

from bench import control, harness
from bench.tests.conftest import GLOBAL, LOCAL, TINY


def _run(cell, root, hook=None, seed=2**31 + 7, trace=False):
    return harness.run(cell, seed, 0.5, trace, root=root, t_start=time.perf_counter(),
                       device="cpu", overrides=TINY[cell], hook=hook)


def _failed(out):
    return sorted(k for k, c in out.checks.items() if c["value"] > c["limit"])


@pytest.mark.parametrize("cell", [GLOBAL, LOCAL])
def test_sound_run_is_correct(cell, cell_root):
    out = _run(cell, cell_root)
    assert out.result["correct"] and _failed(out) == []
    assert out.result["failed"] == 0 and out.result["attempted"] > 0
    assert list(out.result)[-1] == "checks"
    assert not out.banned
    names = set(out.result["metrics"])
    assert "setup_s" in names and "result_latency_p95_ms" in names


@pytest.mark.parametrize("cell", [GLOBAL, LOCAL])
def test_traced_run_is_correct_and_reads_host_spans(cell, cell_root):
    out = _run(cell, cell_root, trace=True)
    assert out.result["correct"]
    names = set(out.result["metrics"])
    assert "estimate_ms" in names and any(n.startswith("service_host_ms") for n in names)
    assert not any(n.startswith(("update_busy", "device_idle")) for n in names)  # no device


def _unchanged(engine):
    engine._update = lambda state, *args: state
    if engine._update_chunk is not None:
        engine._update_chunk = lambda state, *args: state


def _half_batch(engine):
    update, chunk = engine._update, engine._update_chunk
    engine._update = lambda state, W, n, key: update(state, W, n // 2, key)
    if chunk is not None:
        engine._update_chunk = lambda state, Wb, nv, key, step: chunk(state, Wb, nv // 2, key,
                                                                     step)


def _altered_answer(engine):
    estimate = engine.estimate
    engine.estimate = lambda *a, **k: estimate(*a, **k) + 1.0


@pytest.mark.parametrize("cell", [GLOBAL, LOCAL])
@pytest.mark.parametrize("fault,fails", [
    (_unchanged, {"state_mismatch"}),
    (_half_batch, {"state_mismatch"}),
    (_altered_answer, {"answer_gap"}),
])
def test_planted_fault_is_not_correct(cell, fault, fails, cell_root):
    out = _run(cell, cell_root, hook=fault)
    assert not out.result["correct"]
    assert fails <= set(_failed(out))


@pytest.mark.parametrize("cell", [GLOBAL, LOCAL])
def test_lower_precision_control_is_not_correct(cell, cell_root):
    for seed in (1, 2, 3):
        r = control.readings(cell, seed, "cpu", root=cell_root, overrides=TINY[cell])
        assert r["failed_checks"], r
