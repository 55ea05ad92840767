"""The readers of the program's own spans (``bench/program_spans.py``): a
traced run of each cell at a tiny size on the CPU reads every host span the
cell runs, and a reader gives None where its span did not run or the
program has no recorder."""
import sys
import time
from types import SimpleNamespace

import pytest

from bench import harness
from bench.tests.conftest import GLOBAL, LOCAL, TINY

HOST = {"validate_ms_per_batch": "service.validate", "stack_ms_per_batch": "service.stack",
        "prefetch_wait_ms_per_batch": "service.prefetch_wait",
        "upload_host_ms_per_batch": "engine.upload"}


def _read(metric, ctx):
    return harness.load_reader(metric)(ctx)


def _ctx(batches=10):
    return SimpleNamespace(window=harness.Window(batches=batches))


def _rec(name, ms):
    return SimpleNamespace(name=name, start=0, end=int(ms * 1e6))


@pytest.mark.parametrize("cell", [GLOBAL, LOCAL])
def test_traced_run_reads_the_programs_host_spans(cell, cell_root):
    out = harness.run(cell, 2**31 + 7, 0.5, True, root=cell_root,
                      t_start=time.perf_counter(), device="cpu", overrides=TINY[cell])
    assert out.result["correct"]
    got = out.result["metrics"]
    suffix = ".global" if cell == GLOBAL else ".bank"
    for name in ("validate_ms_per_batch", "prefetch_wait_ms_per_batch",
                 "upload_host_ms_per_batch"):
        assert got[name + suffix]["value"] > 0 and got[name + suffix]["unit"] == "ms"
    # only the chunk route stacks superbatches (the bank cell runs K = 1)
    assert ("stack_ms_per_batch" + suffix in got) == (cell == GLOBAL)


def test_untraced_run_records_no_span():
    from repro_torch import spans

    harness.run(GLOBAL, 11, 0.2, False, root=harness.BENCH.parent,
                t_start=time.perf_counter(), device="cpu", overrides=TINY[GLOBAL])
    assert spans.take()[0] == []


def test_readers_sum_their_span_per_batch():
    ctx = _ctx()
    ctx.program_spans = [_rec("service.validate", 3.0), _rec("service.validate", 2.0),
                         _rec("engine.upload", 4.0), _rec("service.stack", 1.5)]
    assert _read("validate_ms_per_batch.global", ctx) == pytest.approx(0.5)
    assert _read("upload_host_ms_per_batch.global", ctx) == pytest.approx(0.4)
    assert _read("stack_ms_per_batch.global", ctx) == pytest.approx(0.15)
    assert _read("prefetch_wait_ms_per_batch.global", ctx) is None  # the span did not run
    ctx = _ctx(batches=0)
    ctx.program_spans = [_rec("service.validate", 3.0)]
    assert _read("validate_ms_per_batch.global", ctx) is None


def test_readers_give_none_for_a_program_without_the_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)  # its import fails
    for name in HOST:
        assert _read(name + ".global", _ctx()) is None


def test_readers_take_the_records_once_a_run():
    from repro_torch import spans

    spans.enable()
    try:
        with spans.span("service.validate"):
            pass
        with spans.span("service.stack"):
            with spans.span("engine.upload"):
                pass
        ctx = _ctx(batches=1)
        assert all(_read(name + ".global", ctx) is not None
                   for name in HOST if name != "prefetch_wait_ms_per_batch")
        assert spans.take()[0] == [] and len(ctx.program_spans) == 3
    finally:
        spans.disable()
