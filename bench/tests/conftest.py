"""Shared helpers of the benchmark's CPU tests: the cells at a tiny size.

Besides the cells of ``BENCHMARK.json`` the tests run a bank cell of their
own (``LOCAL``: the ``local`` scheme, 4 tenants on 4 graphs, a query after
every batch) from a copy of the benchmark with its two files added, the way
a later PR adds a cell, so the harness's bank path stays tried."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

GLOBAL = "tc-global-r20m-s1m.kron22-jobs"
LOCAL = "tc-local-bank4-tiny.kron8-jobs-query-every-batch"
KRON8 = {"scale": 8, "edgefactor": 16, "a": 0.57, "b": 0.19, "c": 0.19, "check_among_jobs": 2}
TINY = {
    GLOBAL: {"config": {"r": 8192, "batch_size": 256}, "traffic": KRON8},
    LOCAL: {},
}
BANK_CONFIG = {
    "name": "tc-local-bank4-tiny", "scheme": "local",
    "scheme_params": {"n_vertices": 1024, "n_pools": 8}, "r": 4096, "batch_size": 256,
    "chunk_size": 1, "groups": 9, "n_tenants": 4, "reduced": {},
    "check_limits": {"batches_lost": 0, "answers_missing": 0, "state_mismatch": 0,
                     "answer_gap": 1e-12},
}
BANK_TRAFFIC = {"name": "kron8-jobs-query-every-batch", **KRON8, "graph_per_tenant": True,
                "report_every": 1, "warmup_batches": 4}


@pytest.fixture
def root():
    return ROOT


@pytest.fixture(scope="session")
def bank_root(tmp_path_factory):
    """A checkout's copy of ``BENCHMARK.json`` and ``bench/`` with the bank
    cell added as a configuration, a traffic mix and a manifest entry."""
    top = tmp_path_factory.mktemp("bank_root")
    bench = top / "bench"
    shutil.copytree(ROOT / "bench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "configs" / f"{BANK_CONFIG['name']}.json").write_text(json.dumps(BANK_CONFIG))
    (bench / "traffic" / f"{BANK_TRAFFIC['name']}.json").write_text(json.dumps(BANK_TRAFFIC))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": BANK_CONFIG["name"], "source": "a test",
                           "file": f"bench/configs/{BANK_CONFIG['name']}.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": LOCAL, "config": BANK_CONFIG["name"],
                             "traffic": BANK_TRAFFIC["name"], "chips": 1, "why": "a test"})
    for m in list(man["end_to_end"] + man["per_layer"]):  # the bank reports as the global cell
        if GLOBAL in m.get("workloads", []):
            if m["name"].endswith(".global"):
                entries = man["per_layer"] if m in man["per_layer"] else man["end_to_end"]
                entries.append({**m, "name": m["name"][:-len("global")] + "bank",
                                "workloads": [LOCAL]})
            else:
                m["workloads"].append(LOCAL)
    (top / "BENCHMARK.json").write_text(json.dumps(man))
    return top


@pytest.fixture
def cell_root(request, bank_root):
    """The root whose ``BENCHMARK.json`` holds the test's ``cell``."""
    return bank_root if request.getfixturevalue("cell") == LOCAL else ROOT
