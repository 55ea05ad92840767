"""The benchmark of the PyTorch/CUDA streaming triangle counter
(``repro_torch``): one run of one cell.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the engine's settings) and a traffic mix (``traffic/<name>.json``: the
generator's parameters, ``traffic/generator.py``). A run

  1. builds the program's kernels (into the checkout's ``build/``),
  2. draws the cell's graphs on the device from the seed,
  3. runs one whole job untimed, so every shape the window uses is warm,
  4. runs jobs back to back for ``seconds``: a job is a fresh
     ``TriangleCountEngine`` (per-job seeds from the run's seed and the
     job's index) fed the job's batches through ``run_stream``, with report
     queries answered through ``on_report``, then its final ``estimate()``;
     at ``seconds`` the running job's stream ends (it hands over no more
     batches) and the window closes with that job's final answer; the job
     to be checked is never cut,
  5. checks the outputs of one job of the window, drawn from the seed,
     against the plain reference (``reference/``),
  6. computes the cell's metrics with the readers in ``metrics/`` (one file
     per metric, found by its name).

With ``trace`` the window runs under ``torch.profiler`` and the engine's
``ingest``, ``stage_chunk``, ``ingest_chunk``, ``estimate`` and ``sync`` are
wrapped in ``bench.<call>`` ranges and host clocks, for this run only.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from collections import defaultdict
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from bench import trace as tracing
from bench.reference import compare
from bench.traffic.generator import job_graphs, job_source, mix, n_batches

BENCH = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
WRAPPED = ("ingest", "stage_chunk", "ingest_chunk", "estimate", "sync")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path) -> dict:
    return _json(root / "BENCHMARK.json")


def find_cell(man: dict, name: str) -> dict:
    for cell in man["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                   f"have {[c['name'] for c in man['workloads']]}")


def load_config(name: str, bench: Path = BENCH) -> dict:
    return _json(bench / "configs" / f"{name}.json")


def load_traffic(name: str, bench: Path = BENCH) -> dict:
    return _json(bench / "traffic" / f"{name}.json")


def load_reader(metric: str, bench: Path = BENCH) -> Callable:
    """The ``read(ctx)`` of ``metrics/<metric>.py``, or, for a metric split
    by cell (``name.suffix``), of ``metrics/<name>.py``."""
    for stem in (metric, metric.split(".")[0]):
        path = bench / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"bench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {metric!r} under {bench / 'metrics'}")


def cell_settings(root: Path, cell_name: str, overrides: Optional[dict] = None) -> tuple:
    """The cell of ``root``'s ``BENCHMARK.json`` named ``cell_name``, its
    configuration and its traffic (read under ``root``'s ``bench/``), with
    the tests' ``overrides`` ({"config": {..}, "traffic": {..}}) laid over
    them."""
    cell = find_cell(manifest(root), cell_name)
    over = overrides or {}
    cfg = {**load_config(cell["config"], root / "bench"), **over.get("config", {})}
    traffic = {**load_traffic(cell["traffic"], root / "bench"), **over.get("traffic", {})}
    return cell, cfg, traffic


def metrics_of(man: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer ones."""
    entries = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def peaks_of(kind: str) -> Optional[dict]:
    """The published peaks of the card named ``kind`` (``peaks.json``)."""
    for name, row in _json(BENCH / "peaks.json").items():
        if name in kind:
            return row
    return None


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


@dataclass
class Window:
    """What the measured window did."""

    seconds: float = 0.0
    jobs: int = 0
    handed: int = 0  # batches the source handed to the service
    batches: int = 0  # batches ingested
    edges: int = 0  # edges ingested, every tenant counted
    lost: int = 0  # batches not ingested exactly once (quarantined, stood in, redelivered)
    latencies_ms: list = field(default_factory=list)
    host_s: dict = field(default_factory=lambda: defaultdict(float))  # call -> host s
    calls: dict = field(default_factory=lambda: defaultdict(int))
    service_s: float = 0.0  # run_stream's host time outside the wrapped calls
    job_s: list = field(default_factory=list)  # each job's host seconds


@dataclass
class Context:
    """What a metric's reader sees."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window: Window
    trace: Optional[tracing.TraceSummary] = None
    peaks: Optional[dict] = None


class Spans:
    """Host clocks, and with the profiler on ``bench.<name>`` ranges, around
    the harness's calls into the program."""

    def __init__(self, window: Window, on: bool):
        self.w, self.on = window, on

    def range(self, name: str):
        if not self.on:
            return nullcontext()
        return torch.profiler.record_function(tracing.PREFIX + name)

    def wrap(self, engine) -> None:
        if not self.on:
            return
        for name in WRAPPED:
            setattr(engine, name, self._timed(name, getattr(engine, name)))

    def _timed(self, name: str, fn: Callable) -> Callable:
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with self.range(name):
                    return fn(*args, **kwargs)
            finally:
                self.w.host_s[name] += time.perf_counter() - t0
                self.w.calls[name] += 1
        return call

    def inside(self) -> float:
        return sum(self.w.host_s[n] for n in WRAPPED)


@dataclass
class Job:
    """One job's outputs: each answer (step it covers, host clock, value)."""

    seeds: tuple
    answers: list = field(default_factory=list)
    stamps: list = field(default_factory=list)
    state: Optional[dict] = None
    report: object = None
    engine: object = None
    seconds: float = 0.0


def engine_config(cfg: dict, seeds: tuple, device: torch.device):
    from repro_torch.engine import EngineConfig

    return EngineConfig(r=cfg["r"], batch_size=cfg["batch_size"], n_tenants=cfg["n_tenants"],
                        groups=cfg["groups"], seeds=seeds, scheme=cfg["scheme"],
                        scheme_params=cfg.get("scheme_params") or None,
                        chunk_size=cfg["chunk_size"], device=device.type)


def job_seeds(seed: int, job: int, n_tenants: int) -> tuple:
    return tuple(mix(seed, 7, job, t) for t in range(n_tenants))


def run_job(cfg: dict, traffic: dict, graphs: np.ndarray, seeds: tuple, device,
            spans: Spans, keep: bool, hook: Optional[Callable] = None,
            deadline: Optional[float] = None) -> Job:
    """One job: a fresh engine fed the job's batches through ``run_stream``
    (until ``deadline``, where given), then its final estimate. ``keep``
    keeps every answer's value (else only its step and clock) and the
    engine; ``hook`` may replace parts of the engine (the tests' planted
    faults)."""
    from repro_torch.engine import TriangleCountEngine, run_stream

    job = Job(seeds)
    with spans.range("engine_init"):
        engine = TriangleCountEngine(engine_config(cfg, seeds, device))
    spans.wrap(engine)
    if hook is not None:
        hook(engine)

    def on_report(step, ests, seen):
        job.answers.append((int(step), time.perf_counter(), ests if keep else None))

    inside0, t0 = spans.inside(), time.perf_counter()
    with spans.range("run_stream"):
        job.report = run_stream(engine, job_source(graphs, cfg["batch_size"], job.stamps,
                                                   deadline),
                                report_every=traffic["report_every"], on_report=on_report)
    spans.w.service_s += time.perf_counter() - t0 - (spans.inside() - inside0)
    with spans.range("final_estimate"):
        est = engine.estimate()
    job.answers.append((engine.step, time.perf_counter(), est if keep else None))
    job.seconds = time.perf_counter() - t0
    if keep:
        job.engine = engine  # its state is read once the window has closed
    return job


def take_state(job: Job) -> None:
    """The job's final estimator state, every tenant's, to the host; the
    engine goes."""
    st = job.engine.state
    job.state = {f: getattr(st, f).cpu() for f in ("f1", "chi", "f2", "has_f3", "m_seen")}
    job.engine = None


def account(w: Window, job: Job, n_tenants: int) -> None:
    rep = job.report
    w.jobs += 1
    w.handed += len(job.stamps)
    w.batches += rep.batches
    w.edges += rep.edges * n_tenants
    w.lost += (len(job.stamps) - rep.batches + rep.stale_batches + rep.duplicate_batches
               + rep.phantom_batches)
    for step, t, _ in job.answers:
        if 1 <= step <= len(job.stamps):
            w.latencies_ms.append((t - job.stamps[step - 1]) * 1e3)


def expected_steps(n: int, K: int, every: int) -> list:
    """The steps a job's answers cover: a report after each ingest call whose
    position is a multiple of ``every`` (K batches a call while whole
    chunks last, then one), and the final answer."""
    pos, steps = 0, []
    while pos < n:
        pos += K if n - pos >= K and K > 1 else 1
        if every and pos % every == 0:
            steps.append(pos)
    return steps + [n]


@dataclass
class Outcome:
    result: dict
    checks: dict
    banned: list
    notes: list


def run(cell_name: str, seed: int, seconds: float, trace: bool, *, root: Path,
        t_start: float, device: str = "cuda", overrides: Optional[dict] = None,
        hook: Optional[Callable] = None) -> Outcome:
    """One run of ``cell_name``. ``overrides`` (see ``cell_settings``) and
    ``hook`` are for the tests, which run a cell at a tiny size on the CPU,
    with faults planted."""
    man = manifest(root)
    cell, cfg, traffic = cell_settings(root, cell_name, overrides)
    dev = torch.device(device)
    notes = []
    cuda = dev.type == "cuda"

    build_s = 0.0
    if cuda:
        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        _build.build()
        build_s = time.perf_counter() - t0
    notes.append(f"build_s {build_s}")

    T, s, K = cfg["n_tenants"], cfg["batch_size"], cfg["chunk_size"]
    graphs, unique = job_graphs(traffic, T, seed, dev)
    nb = n_batches(graphs.shape[1], s)
    notes.append(f"graphs unique_edges {unique} edges_per_job {graphs.shape[1]} batches {nb}")

    w = Window()
    spans = Spans(w, trace)
    # the warm-up, untimed: a whole job, or its first warmup_batches batches
    # where every batch of a job has one shape
    warm = traffic.get("warmup_batches") or graphs.shape[1]
    run_job(cfg, traffic, graphs[:, :warm * s], job_seeds(seed, -1, T), dev,
            Spans(Window(), False), False, hook)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    check_job = mix(seed, 11) % max(1, int(traffic["check_among_jobs"]))
    kept: Optional[Job] = None

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    deadline = t_open + seconds
    with spans.range("window"):
        while True:
            j = w.jobs
            with spans.range("job"):
                job = run_job(cfg, traffic, graphs, job_seeds(seed, j, T), dev, spans,
                              keep=j == check_job, hook=hook,
                              deadline=deadline if j > check_job else None)
            account(w, job, T)
            w.job_s.append(job.seconds)
            if j == check_job:
                kept = job
            job = None
            if j >= check_job and time.perf_counter() >= deadline:
                break
    w.seconds = time.perf_counter() - t_open
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        if cuda:
            summary = tracing.summarize(prof)
        prof = None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    banned = banned_modules()
    if cuda:
        from repro_torch.kernels import CUDA_LAUNCHES, LAUNCHES

        notes.append(f"kernel launches in the window and warm-up {dict(LAUNCHES)} "
                     f"cuda {dict(CUDA_LAUNCHES)}")

    take_state(kept)
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = compare.check_job(kept, graphs, cfg, traffic, nb, dev,
                               expected=expected_steps(nb, K, traffic["report_every"]),
                               lost=w.lost)
    notes.append(f"checked job {check_job} of {w.jobs}, reference "
                 f"{time.perf_counter() - t_check:.1f} s")
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    ctx = Context(cell, cfg, traffic, setup_s, w, summary, peaks_of(kind))
    metrics = {}
    for m in metrics_of(man, cell_name, trace):
        v = load_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": w.handed, "failed": w.lost,
              "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": tracing.top_ops(summary),
                               "idle_gaps": tracing.gap_table(summary)}
        notes.append(f"trace device_ops {summary.device_ops} unattributed_device_s "
                     f"{summary.unattributed_device_s} range_device_s "
                     f"{summary.range_device_s} longest_gaps {summary.longest_gaps}")
    if trace:
        notes.append(f"host_s {dict(w.host_s)} calls {dict(w.calls)} service_s {w.service_s}")
    result["build_s"] = build_s
    result["window"] = {"seconds": w.seconds, "jobs": w.jobs, "batches": w.batches,
                        "edges": w.edges, "queries": len(w.latencies_ms),
                        "job_s": [round(x, 4) for x in w.job_s]}
    result["checks"] = checks
    return Outcome(result, checks, banned, notes)
