"""The port's ``PrefetchQueue`` and CLI resilience against the JAX reference.

The queue tests mirror the reference's (``tests/test_prefetch.py``'s
deadline and producer-error tests, ``tests/test_faults.py``'s
``TestPrefetchResilience``) with the same sources and timing margins, each
run on the port's queue and on the reference's, which must deliver the same
items with the same counters. The CLI tests run ``python -m
repro_torch.launch.stream`` and ``python -m repro.launch.stream`` under the
same ``--fault-plan``: the same ``estimate:``, ``resilience:`` and ``fault
plan installed:`` lines, and ``--diag-json`` files with the same ``diag``,
``report`` and ``fault_plan`` blocks (the plan's log as a set: the producer
thread's entries interleave with the loop's in whatever order the threads
ran). ``src/repro_torch/golden/resilience_small.json`` records the JAX
CLI's, so that ``chip_smoke.py`` can hold the port's CLI to them on the card,
where there is no JAX. Rewrite it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_prefetch.py --write
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import repro  # noqa: F401,E402  -- enables x64
from repro.data.prefetch import PrefetchQueue as JaxPrefetchQueue  # noqa: E402
from repro.engine import install_fault_plan as jax_install_fault_plan  # noqa: E402
from repro.engine import parse_fault_plan as jax_parse_fault_plan  # noqa: E402
from repro.engine.faults import FaultInjected as JaxFaultInjected  # noqa: E402
from repro.engine.faults import RetryPolicy as JaxRetryPolicy  # noqa: E402

from repro_torch.data.prefetch import PrefetchQueue  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    FaultInjected,
    RetryPolicy,
    install_fault_plan,
    parse_fault_plan,
)

GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "resilience_small.json"
# the golden CLI arguments of stream_small.json: 6,900 edges in 14 batches of
# 512, so three K = 4 chunks and a ragged tail of two batches
CLI_ARGS = ["--graph", "planted", "--triangles", "300", "--edges", "6000",
            "--nodes", "9000", "--estimators", "8192", "--batch", "512",
            "--chunk", "4", "--seed", "1"]
# one transient fault at every seam of the chunked path and a redelivery:
# a retried staging (the second chunk), ingest_chunk (the third), the tail's
# first ingest, a source item, and a duplicated one
PLAN = ("engine.stage_chunk:raise@1,engine.ingest_chunk:raise@2,engine.ingest:raise@0,"
        "prefetch.get:raise@3,prefetch.get:dup@6")
FAULT_ARGS = [*CLI_ARGS, "--fault-plan", PLAN, "--retry-base", "0.001"]
FATAL_ARGS = [*CLI_ARGS, "--fault-plan", "engine.ingest_chunk:raise@1x9", "--retry-base", "0.001"]
LINES = ("fault plan installed: ", "resilience: ", "estimate: ")

QUEUES = {"port": (PrefetchQueue, RetryPolicy, parse_fault_plan, install_fault_plan,
                   FaultInjected),
          "jax": (JaxPrefetchQueue, JaxRetryPolicy, jax_parse_fault_plan,
                  jax_install_fault_plan, JaxFaultInjected)}


@pytest.fixture(autouse=True)
def _no_leaked_plans():
    yield
    install_fault_plan(None)
    jax_install_fault_plan(None)


def counters(pf) -> dict:
    return {k: getattr(pf, k) for k in ("stale_steps", "late_drops", "duplicate_drops",
                                        "redelivered", "retries", "unmatched_standins")}


# ---------------------------------------------------------------- deadlines
@pytest.mark.parametrize("impl", list(QUEUES))
def test_deadline_miss_drops_the_late_duplicate(impl):
    """After a stand-in for a late batch, the late batch is dropped when it
    lands: the batches out (real and stale) equal the source's."""
    def src():
        yield 1
        yield 2
        time.sleep(0.3)
        yield 3
        yield 4

    pf = QUEUES[impl][0](src(), depth=1, deadline_s=0.15)
    out = [pf.get(), pf.get(), pf.get()]  # the third misses: the backup stands in
    time.sleep(0.4)  # the late 3 lands
    out.append(pf.get())  # 3 is dropped on arrival; 4 comes through
    assert [v for v, _ in out] == [1, 2, 2, 4]
    assert [s for _, s in out] == [False, False, True, False]
    assert (pf.stale_steps, pf.late_drops, pf.unmatched_standins) == (1, 1, 0)
    with pytest.raises(StopIteration):
        pf.get()


@pytest.mark.parametrize("impl", list(QUEUES))
def test_one_standin_per_late_item(impl):
    """Misses gated on the same straggler mint one stand-in, not one each."""
    def src():
        yield 1
        yield 2
        time.sleep(0.5)
        yield 3

    pf = QUEUES[impl][0](src(), depth=1, deadline_s=0.15)
    out = [pf.get(), pf.get(), pf.get()]
    with pytest.raises(StopIteration):
        pf.get()  # waits for the late 3, drops it, meets the end
    assert [v for v, _ in out] == [1, 2, 2]
    assert (pf.stale_steps, pf.late_drops, pf.unmatched_standins) == (1, 1, 0)


@pytest.mark.parametrize("impl", list(QUEUES))
def test_end_of_stream_standin_is_counted(impl):
    """A miss whose late item is the end of the stream has delivered one
    batch the source never produced: counted, not silent."""
    def src():
        yield 1
        yield 2
        time.sleep(0.5)  # a slow end instead of a third item

    pf = QUEUES[impl][0](src(), depth=1, deadline_s=0.15)
    out = [pf.get(), pf.get(), pf.get()]
    with pytest.raises(StopIteration):
        pf.get()
    assert [v for v, _ in out] == [1, 2, 2]
    assert (pf.stale_steps, pf.late_drops, pf.unmatched_standins) == (1, 0, 1)


def test_no_deadline_never_stands_in():
    def src():
        yield 1
        time.sleep(0.3)
        yield 2

    pf = PrefetchQueue(src(), depth=1)
    assert list(pf) == [(1, False), (2, False)]
    assert pf.stale_steps == 0


# ---------------------------------------------------------------- producer errors
@pytest.mark.parametrize("impl", list(QUEUES))
def test_producer_exception_reaches_the_consumer(impl):
    def src():
        yield 1
        raise RuntimeError("boom mid-stream")

    pf = QUEUES[impl][0](src(), depth=2)
    assert pf.get()[0] == 1
    with pytest.raises(RuntimeError, match="boom mid-stream"):
        pf.get()


def test_producer_exception_is_raised_again():
    def src():
        yield 1
        raise KeyError("bad tail")

    pf = PrefetchQueue(src(), depth=2)
    assert pf.get() == (1, False)
    for _ in range(2):  # the end marker stays for later calls
        with pytest.raises(KeyError, match="bad tail"):
            pf.get()


@pytest.mark.parametrize("impl", list(QUEUES))
def test_clean_exhaustion_is_stopiteration(impl):
    pf = QUEUES[impl][0](iter([1]), depth=2)
    assert pf.get()[0] == 1
    with pytest.raises(StopIteration):
        pf.get()


def test_producer_touches_no_device(monkeypatch):
    """The producer thread runs host code only: with every way to reach
    CUDA made to raise, a faulted queue still delivers."""
    import torch

    def refuse(*args, **kwargs):
        raise AssertionError("the producer touched CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    install_fault_plan(parse_fault_plan("prefetch.get:dup@0,prefetch.get:raise@2"))
    pf = PrefetchQueue(iter(range(4)), depth=8, retry=RetryPolicy(base_s=0.001))
    assert [v for v, _ in pf] == [0, 1, 2, 3]
    assert (pf.duplicate_drops, pf.retries) == (1, 1)


# ---------------------------------------------------------------- resilience
@pytest.mark.parametrize("impl", list(QUEUES))
def test_duplicate_delivery_deduped(impl):
    cls, _, parse, install, _ = QUEUES[impl]
    install(parse("prefetch.get:dup@1x2"))
    pf = cls(iter(range(6)), depth=8)
    out = []
    while True:
        try:
            out.append(pf.get()[0])
        except StopIteration:
            break
    assert out == list(range(6))
    assert (pf.duplicate_drops, pf.redelivered) == (2, 2)


@pytest.mark.parametrize("impl", list(QUEUES))
def test_producer_retries_a_transient_source_fault(impl):
    cls, policy, parse, install, _ = QUEUES[impl]
    install(parse("prefetch.get:raise@1x2"))
    pf = cls(iter(range(5)), depth=4, retry=policy(max_retries=3, base_s=0.001))
    out = []
    while True:
        try:
            out.append(pf.get()[0])
        except StopIteration:
            break
    assert out == list(range(5))
    assert pf.retries == 2


@pytest.mark.parametrize("impl", list(QUEUES))
def test_producer_retry_exhaustion_reaches_the_consumer(impl):
    cls, policy, parse, install, exc = QUEUES[impl]
    install(parse("prefetch.get:raise@1x99"))
    pf = cls(iter(range(5)), depth=4, retry=policy(max_retries=1, base_s=0.001))
    got = [pf.get()[0]]
    with pytest.raises(exc):
        while True:
            got.append(pf.get()[0])
    assert got == [0] and pf.retries == 1


def test_no_retry_policy_fails_the_first_fault():
    install_fault_plan(parse_fault_plan("prefetch.get:raise@0"))
    pf = PrefetchQueue(iter(range(3)), depth=4)
    with pytest.raises(FaultInjected):
        pf.get()
    assert pf.retries == 0


@pytest.mark.parametrize("impl", list(QUEUES))
def test_backlog_reports_the_queue_depth(impl):
    pf = QUEUES[impl][0](iter(range(4)), depth=8)
    deadline = time.time() + 5
    while pf.backlog() < 5 and time.time() < deadline:  # 4 items and the end marker
        time.sleep(0.01)
    assert pf.backlog() == 5
    pf.get()
    assert pf.backlog() == 4


def test_same_counters_as_jax_under_one_plan():
    """Redelivery and retries together: the same items and counters from
    both queues."""
    got = []
    for impl in ("port", "jax"):
        cls, policy, parse, install, _ = QUEUES[impl]
        install(parse("prefetch.get:raise@1x2,prefetch.get:dup@3,prefetch.get:dup@5x2"))
        pf = cls(iter(range(9)), depth=16, retry=policy(base_s=0.001))
        items = []
        while True:
            try:
                items.append(pf.get())
            except StopIteration:
                break
        install(None)
        got.append((items, counters(pf)))
    assert got[0] == got[1]
    assert got[0][1]["duplicate_drops"] == 3 and got[0][1]["retries"] == 2


# ---------------------------------------------------------------- the CLI
def cli(module: str, args, tmp: pathlib.Path, extra=(), check=True):
    """Run a stream CLI on the CPU with ``--diag-json``; returns (stdout
    lines, diag dict or None, the completed process)."""
    diag = tmp / f"{module.split('.')[0]}_diag.json"
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "-m", module, *args, "--diag-json", str(diag), *extra], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300, check=check)
    return (proc.stdout.splitlines(), json.loads(diag.read_text()) if diag.exists() else None,
            proc)


def record(lines, diag) -> dict:
    """What the port's CLI must reproduce: the three lines, and the diag's
    blocks with the plan's log as a sorted list."""
    plan = dict(diag["fault_plan"])
    plan["log"] = sorted(plan["log"])
    return {"lines": {p: next((ln for ln in lines if ln.startswith(p)), None) for p in LINES},
            "diag": diag["diag"], "report": diag["report"], "fault_plan": plan}


def jax_record(tmp: pathlib.Path) -> dict:
    lines, diag, _ = cli("repro.launch.stream", FAULT_ARGS, tmp, ["--ckpt-every", "0"])
    return {"written_by": "repro (JAX) CLI via tests/test_torch_prefetch.py",
            "args": FAULT_ARGS, **record(lines, diag)}


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    return jax_record(tmp_path_factory.mktemp("jax_cli"))


def test_cli_faulted_run_matches_jax_cli(jax_cli, tmp_path):
    lines, diag, _ = cli("repro_torch.launch.stream", FAULT_ARGS, tmp_path, ["--device", "cpu"])
    got = record(lines, diag)
    assert got["lines"] == jax_cli["lines"]
    assert got["report"] == jax_cli["report"]
    assert got["fault_plan"] == jax_cli["fault_plan"]
    assert got["diag"] == jax_cli["diag"]
    # every transient fault was ridden out: the fault-free estimate
    gold = json.loads(GOLDEN.with_name("stream_small.json").read_text())["cli"]
    assert gold["args"] == CLI_ARGS
    assert got["lines"]["estimate: "] == gold["estimate_line"]
    assert got["lines"]["resilience: "] == (
        "resilience: retries=4 quarantined=0 duplicates=1 degraded_queries=0 "
        "(max_staleness=0) query_fallbacks=0 ckpt_corrupt_skipped=0")


def test_cli_happy_path_prints_no_resilience_line(tmp_path):
    lines, diag, _ = cli("repro_torch.launch.stream", CLI_ARGS, tmp_path, ["--device", "cpu"])
    assert not any(ln.startswith(("resilience: ", "fault plan installed: ")) for ln in lines)
    assert diag["fault_plan"] is None and diag["report"]["retries"] == 0


def test_cli_fatal_plan_exits_nonzero_like_jax(tmp_path):
    procs = {}
    for module, extra in (("repro.launch.stream", ["--ckpt-every", "0"]),
                          ("repro_torch.launch.stream", ["--device", "cpu"])):
        lines, diag, proc = cli(module, FATAL_ARGS, tmp_path, extra, check=False)
        assert proc.returncode != 0 and diag is None
        assert "FaultInjected: injected fault at engine.ingest_chunk (call #4)" in proc.stderr
        assert lines[1] == "fault plan installed: engine.ingest_chunk:raise@1x9"
        assert not any(ln.startswith("estimate: ") for ln in lines)
        procs[module] = proc.returncode
    assert procs["repro.launch.stream"] == procs["repro_torch.launch.stream"]


def test_committed_golden_is_what_the_jax_cli_prints(jax_cli):
    assert json.loads(GOLDEN.read_text()) == jax_cli


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit(__doc__)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        GOLDEN.write_text(json.dumps(jax_record(pathlib.Path(d)), indent=1) + "\n")
    print(GOLDEN.read_text())
