"""BENCHMARK.json keeps to the benchmark's contract: names, units, keys,
files, bounds and the run length."""
import json
import re

import pytest

from bench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(man["command"]) <= 32 and all(_line(w) for w in man["command"])
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    for word in man["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in man["paths"])
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51


def test_run_length_fits_a_full_check(man):
    cells = 24  # later PRs may fill the benchmark up to this
    runs = 2 + 14 * cells
    assert runs * (man["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_configs(man):
    names = [c["name"] for c in man["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    files = [c["file"] for c in man["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert sorted(c["reduced"]) == sorted(body.get("reduced", {}))
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank")) and k in body


def test_workloads(man):
    names = [w["name"] for w in man["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in man["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(names) // 4)
    configs = {c["name"] for c in man["configs"]}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()


def _metrics(man):
    return man["end_to_end"] + man["per_layer"]


def test_metric_names_units_and_keys(man):
    names = [m["name"] for m in _metrics(man)]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in man["workloads"]}
    for m in _metrics(man):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
    assert 1 <= len(man["end_to_end"]) <= 16 and 1 <= len(man["per_layer"]) <= 128
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in man["workloads"]:
        mine = [m["name"] for m in man["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2
        layers = [m for m in man["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layers
        for m in layers:  # what a per-layer metric moves is reported in its cells
            assert m["moves"] in mine


def test_one_layer_name_per_layer(man):
    by_reader = {}
    for m in man["per_layer"]:
        by_reader.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_reader.values())


def test_every_metric_has_a_reader(man):
    from bench import harness

    for m in _metrics(man):
        assert callable(harness.load_reader(m["name"]))
