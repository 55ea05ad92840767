"""A later PR adds a configuration, a traffic mix and a per-layer metric as
files of their own; the harness finds them by name and no file that was
there changes."""
import hashlib
import json
import shutil

from bench import harness
from bench.tests.conftest import ROOT


def _digests(tree):
    return {p.relative_to(tree): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_traffic_and_metric_are_found(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "bench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(bench)

    cfg = json.loads((bench / "configs" / "tc-global-r20m-s1m.json").read_text())
    cfg.update(name="tc-global-window16m-r2m-s1m", r=1 << 21)
    (bench / "configs" / "tc-global-window16m-r2m-s1m.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "kron22-jobs.json").read_text())
    tr.update(name="kron18-small-jobs", scale=18)
    (bench / "traffic" / "kron18-small-jobs.json").write_text(json.dumps(tr))
    (bench / "metrics" / "tail_batches_per_job.py").write_text(
        "def read(ctx):\n    return ctx.window.batches / ctx.window.jobs\n")

    # the manifest is the one file a later PR edits to name them
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": cfg["name"], "source": "https://arxiv.org/abs/1308.2166",
                           "file": "bench/configs/tc-global-window16m-r2m-s1m.json",
                           "reduced": [], "why": "a test"})
    cell = "tc-global-window16m-r2m-s1m.kron18-small-jobs"
    man["workloads"].append({"name": cell, "config": cfg["name"], "traffic": tr["name"],
                             "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "tail_batches_per_job", "unit": "batches",
                             "better": "lower", "source": "program_counter", "layer": "service",
                             "moves": "edges_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    found = harness.find_cell(harness.manifest(tmp_path), cell)
    assert harness.load_config(found["config"], bench)["r"] == 1 << 21
    assert harness.load_traffic(found["traffic"], bench)["scale"] == 18
    names = [m["name"] for m in harness.metrics_of(harness.manifest(tmp_path), cell, True)]
    assert names == ["tail_batches_per_job"]  # the others list their cells
    w = harness.Window(jobs=2, batches=74)
    ctx = harness.Context(found, {}, {}, 0.0, w)
    assert harness.load_reader("tail_batches_per_job", bench)(ctx) == 37
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert len(after) == len(before) + 3
