"""The golden files: the JAX reference's results on small streams, which
the port must reproduce bit for bit.

  ``stream_small.json``  the global scheme on a chunked stream with a ragged
                         tail: the final state's sha256, the estimate, and
                         the CLI's ``estimate:`` line;
  ``local_small.json``   the local scheme (4 pools) on the same stream: the
                         state's sha256, the per-vertex estimate's sha256 and
                         ``sum/3``, and the CLI's ``local[tenant 0]`` line;
  ``naive_small.json``   the naive scheme on three batches (one K = 2 chunk
                         and a ragged batch): the state's sha256.
  ``dynamic_small.json`` three dynamic runs on the same stream: ``global``
                         under churn (p = 0.2) through ``run_signed_stream``,
                         ``global`` with a sliding window chunked at K = 4,
                         and ``local`` with exponential decay; each run's
                         state and window-ring sha256, its estimate (or
                         estimate sha256 and ``sum/3``) and its counters.

``chip_smoke.py`` holds the port's CUDA kernel path to them on a machine
without JAX. These tests regenerate them from the JAX package, check the
committed copies, and hold the port's CPU paths to them. Rewrite the files
with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import repro  # noqa: F401,E402  -- enables x64
from repro.data.graph_stream import batches as jax_batches  # noqa: E402
from repro.data.graph_stream import churn_stream as jax_churn  # noqa: E402
from repro.data.graph_stream import signed_batches as jax_signed  # noqa: E402
from repro.data.graph_stream import planted_triangle_stream as jax_planted  # noqa: E402
from repro.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.engine import TriangleCountEngine as JaxEngine  # noqa: E402
from repro.engine import run_signed_stream as jax_run_signed_stream  # noqa: E402
from repro.engine import run_stream as jax_run_stream  # noqa: E402

from repro_torch.data.graph_stream import (  # noqa: E402
    batches,
    churn_stream,
    planted_triangle_stream,
    signed_batches,
)
from repro_torch.engine import (  # noqa: E402
    EngineConfig,
    TriangleCountEngine,
    run_signed_stream,
    run_stream,
)
from repro_torch.interop import estimate_sha256, state_sha256, window_sha256  # noqa: E402

GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "stream_small.json"
LOCAL_GOLDEN = GOLDEN.with_name("local_small.json")
NAIVE_GOLDEN = GOLDEN.with_name("naive_small.json")
DYNAMIC_GOLDEN = GOLDEN.with_name("dynamic_small.json")
# planted graph: 150 triangles + 2000 noise edges = 2450 edges in batches of
# 256 -> 9 full batches and a ragged one of 146; with K = 4 that is two
# chunks, then one full and one ragged batch on the per-batch path
STREAM = {"triangles": 150, "noise_edges": 2000, "vertices": 3000, "seed": 3}
ENGINE = {"r": 4096, "batch_size": 256, "chunk_size": 4, "groups": 9, "seed": 3}
CLI_ARGS = ["--graph", "planted", "--triangles", "300", "--edges", "6000",
            "--nodes", "9000", "--estimators", "8192", "--batch", "512",
            "--chunk", "4", "--seed", "1"]
LOCAL = {"n_pools": 4, "n_vertices": STREAM["vertices"]}
LOCAL_CLI_ARGS = [*CLI_ARGS, "--scheme", "local", "--pools", "4"]
# the naive scheme is O(r * s) sequential per batch: its first 700 edges,
# batches of 256 -> one K = 2 chunk and a ragged batch of 188
NAIVE = {"edges": 700, "chunk_size": 2}
# the dynamic runs: churn over the stream's first 1,200 edges (signed runs of
# about 1/p edges, batch by batch), a window of 1,500 edges that expires 548
# after the second chunk, then 256 and 146 after the two tail batches, and
# decay of mean lifetime 1,500 insertions under the local scheme, batch by
# batch
DYNAMIC = {
    "churn": {"scheme": "global", "chunk_size": 1, "deletions": 0.2, "churn_seed": 4,
              "edges": 1200},
    "window": {"scheme": "global", "chunk_size": 4, "window": 1500},
    "decay": {"scheme": "local", "chunk_size": 1, "decay": 1500.0},
}


def jax_golden() -> dict:
    """The golden record, computed by the JAX reference."""
    edges, tau = jax_planted(STREAM["triangles"], STREAM["noise_edges"],
                             STREAM["vertices"], seed=STREAM["seed"])
    eng = JaxEngine(JaxConfig(r=ENGINE["r"], batch_size=ENGINE["batch_size"],
                              chunk_size=ENGINE["chunk_size"], groups=ENGINE["groups"],
                              seeds=(ENGINE["seed"],)))
    jax_run_stream(eng, jax_batches(edges, ENGINE["batch_size"]))
    snap = eng.snapshot()
    return {
        "written_by": "repro (JAX) engine via tests/test_torch_golden.py",
        "stream": STREAM, "engine": ENGINE, "m": int(len(edges)), "tau": int(tau),
        "step": int(snap["step"]), "state_sha256": state_sha256(snap),
        "estimate": float(eng.estimate()[0]),
    }


def _jax_scheme_run(scheme: str, params, chunk_size: int, n_edges=None):
    edges, _ = jax_planted(STREAM["triangles"], STREAM["noise_edges"],
                           STREAM["vertices"], seed=STREAM["seed"])
    eng = JaxEngine(JaxConfig(r=ENGINE["r"], batch_size=ENGINE["batch_size"],
                              chunk_size=chunk_size, groups=ENGINE["groups"],
                              seeds=(ENGINE["seed"],), scheme=scheme, scheme_params=params))
    jax_run_stream(eng, jax_batches(edges[:n_edges], ENGINE["batch_size"]))
    return eng


def jax_local_golden() -> dict:
    """The local-scheme golden record, computed by the JAX reference."""
    eng = _jax_scheme_run("local", LOCAL, ENGINE["chunk_size"])
    est = np.asarray(eng.estimate()[0])
    return {
        "written_by": "repro (JAX) engine via tests/test_torch_golden.py",
        "stream": STREAM, "engine": ENGINE, "scheme": "local", "scheme_params": LOCAL,
        "step": int(eng.snapshot()["step"]), "state_sha256": state_sha256(eng.snapshot()),
        "estimate_sha256": estimate_sha256(est), "sum3": float(est.sum()) / 3,
    }


def jax_naive_golden() -> dict:
    """The naive-scheme golden record, computed by the JAX reference."""
    eng = _jax_scheme_run("naive", None, NAIVE["chunk_size"], NAIVE["edges"])
    return {
        "written_by": "repro (JAX) engine via tests/test_torch_golden.py",
        "stream": STREAM, "engine": {**ENGINE, "chunk_size": NAIVE["chunk_size"]},
        "edges": NAIVE["edges"], "scheme": "naive", "step": int(eng.snapshot()["step"]),
        "state_sha256": state_sha256(eng.snapshot()), "estimate": float(eng.estimate()[0]),
    }


def _dynamic_record(snap, est, diag, scheme: str) -> dict:
    """What a dynamic golden run records, from either package's engine."""
    rec = {"step": int(snap["step"]), "dyn_step": int(snap["dyn_step"]),
           "state_sha256": state_sha256(snap), "delete_batches": int(diag.delete_batches),
           "window_expired": int(diag.window_expired)}
    if "window_edges" in snap:
        rec["window_sha256"] = window_sha256(snap)
    if scheme == "local":
        rec.update(estimate_sha256=estimate_sha256(est), sum3=float(est.sum()) / 3)
    else:
        rec["estimate"] = float(est)
    return rec


def _dynamic_config(run: dict) -> dict:
    """The engine keyword arguments of a dynamic run."""
    return {"r": ENGINE["r"], "batch_size": ENGINE["batch_size"],
            "chunk_size": run["chunk_size"], "groups": ENGINE["groups"],
            "seeds": (ENGINE["seed"],), "scheme": run["scheme"],
            "scheme_params": LOCAL if run["scheme"] == "local" else None,
            "window": run.get("window", 0), "decay": run.get("decay", 0.0)}


def jax_dynamic_golden() -> dict:
    """The dynamic golden record, computed by the JAX reference."""
    edges, _ = jax_planted(STREAM["triangles"], STREAM["noise_edges"],
                           STREAM["vertices"], seed=STREAM["seed"])
    runs = {}
    for name, run in DYNAMIC.items():
        eng = JaxEngine(JaxConfig(**_dynamic_config(run)))
        if run.get("deletions"):
            stream = jax_churn(edges[: run["edges"]], run["deletions"], seed=run["churn_seed"])
            jax_run_signed_stream(eng, jax_signed(stream, ENGINE["batch_size"]))
        else:
            jax_run_stream(eng, jax_batches(edges, ENGINE["batch_size"]))
        rec = _dynamic_record(eng.snapshot(), np.asarray(eng.estimate()[0]), eng.diag,
                              run["scheme"])
        runs[name] = {**run, **rec}
    return {"written_by": "repro (JAX) engine via tests/test_torch_golden.py",
            "stream": STREAM, "engine": ENGINE, "scheme_params_local": LOCAL, "runs": runs}


def port_dynamic_run(name: str, device: str = "cpu", ingest: str = "auto",
                     multisearch: str = "auto") -> dict:
    """One dynamic golden run through the port; returns its record."""
    run = DYNAMIC[name]
    edges, _ = planted_triangle_stream(STREAM["triangles"], STREAM["noise_edges"],
                                       STREAM["vertices"], seed=STREAM["seed"])
    eng = TriangleCountEngine(EngineConfig(device=device, ingest=ingest,
                                           multisearch=multisearch, **_dynamic_config(run)))
    if run.get("deletions"):
        stream = churn_stream(edges[: run["edges"]], run["deletions"], seed=run["churn_seed"])
        run_signed_stream(eng, signed_batches(stream, ENGINE["batch_size"]))
    else:
        run_stream(eng, batches(edges, ENGINE["batch_size"]))
    return _dynamic_record(eng.snapshot(), eng.estimate()[0], eng.diag, run["scheme"])


def _cli_line(module: str, args, prefix: str, extra=()) -> str:
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", module, *args, *extra], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300, check=True).stdout
    return next(line for line in out.splitlines() if line.startswith(prefix))


def _cli_estimate_line(module: str, extra=()) -> str:
    return _cli_line(module, CLI_ARGS, "estimate:", extra)


def port_run(device: str = "cpu", ingest: str = "auto", multisearch: str = "auto",
             scheme: str = "global", params=None, chunk_size=None, n_edges=None):
    """A golden stream through the port's engine; returns the engine."""
    edges, _ = planted_triangle_stream(STREAM["triangles"], STREAM["noise_edges"],
                                       STREAM["vertices"], seed=STREAM["seed"])
    eng = TriangleCountEngine(EngineConfig(
        r=ENGINE["r"], batch_size=ENGINE["batch_size"],
        chunk_size=chunk_size or ENGINE["chunk_size"], groups=ENGINE["groups"],
        seeds=(ENGINE["seed"],), device=device, ingest=ingest, multisearch=multisearch,
        scheme=scheme, scheme_params=params))
    run_stream(eng, batches(edges[:n_edges], ENGINE["batch_size"]))
    return eng


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_committed_golden_matches_jax(golden):
    fresh = jax_golden()
    for k in ("m", "tau", "step", "state_sha256", "estimate"):
        assert golden[k] == fresh[k], k


@pytest.mark.parametrize("ingest,multisearch", [
    ("scan", "eager"), ("fused", "eager"), ("kernel", "kernel"), ("scan", "kernel"),
])
def test_port_reproduces_golden(golden, ingest, multisearch):
    eng = port_run("cpu", ingest, multisearch)
    assert eng.step == golden["step"]
    assert state_sha256(eng.snapshot()) == golden["state_sha256"]
    # f64 means of the same integer coarse estimates, summed in another order
    np.testing.assert_allclose(eng.estimate()[0], golden["estimate"], rtol=1e-12)


def test_cli_estimate_line_matches_jax_cli(golden):
    jax_line = _cli_estimate_line("repro.launch.stream", ["--ckpt-every", "0"])
    port_line = _cli_estimate_line("repro_torch.launch.stream", ["--device", "cpu"])
    assert port_line == jax_line
    assert golden["cli"] == {"args": CLI_ARGS, "estimate_line": jax_line}


@pytest.fixture(scope="module")
def local_golden():
    return json.loads(LOCAL_GOLDEN.read_text())


def test_committed_local_and_naive_golden_match_jax(local_golden):
    fresh = jax_local_golden()
    for k in ("step", "state_sha256", "estimate_sha256", "sum3"):
        assert local_golden[k] == fresh[k], k
    naive, fresh = json.loads(NAIVE_GOLDEN.read_text()), jax_naive_golden()
    for k in ("step", "state_sha256", "estimate"):
        assert naive[k] == fresh[k], k


@pytest.fixture(scope="module")
def dynamic_golden():
    return json.loads(DYNAMIC_GOLDEN.read_text())


def test_committed_dynamic_golden_matches_jax(dynamic_golden):
    fresh = jax_dynamic_golden()
    assert dynamic_golden["runs"] == fresh["runs"]
    assert {k: v for k, v in dynamic_golden.items() if k != "written_by"} == {
        k: v for k, v in json.loads(json.dumps(fresh)).items() if k != "written_by"}


@pytest.mark.parametrize("name", list(DYNAMIC))
@pytest.mark.parametrize("ingest,multisearch", [("scan", "eager"), ("kernel", "kernel")])
def test_port_reproduces_dynamic_golden(dynamic_golden, name, ingest, multisearch):
    want = {k: v for k, v in dynamic_golden["runs"][name].items() if k not in DYNAMIC[name]}
    assert port_dynamic_run(name, "cpu", ingest, multisearch) == want
    assert want["window_expired"] > 0 or want["delete_batches"] > 0
    assert want.get("estimate", want.get("sum3")) > 0


@pytest.mark.parametrize("ingest,multisearch", [("scan", "eager"), ("kernel", "kernel")])
def test_port_reproduces_local_golden(local_golden, ingest, multisearch):
    eng = port_run("cpu", ingest, multisearch, "local", LOCAL)
    est = eng.estimate()[0]
    assert eng.step == local_golden["step"]
    assert state_sha256(eng.snapshot()) == local_golden["state_sha256"]
    assert estimate_sha256(est) == local_golden["estimate_sha256"]
    assert float(est.sum()) / 3 == local_golden["sum3"]


def test_port_reproduces_naive_golden():
    naive = json.loads(NAIVE_GOLDEN.read_text())
    eng = port_run("cpu", scheme="naive", chunk_size=NAIVE["chunk_size"], n_edges=NAIVE["edges"])
    assert eng.step == naive["step"] == 3
    assert state_sha256(eng.snapshot()) == naive["state_sha256"]
    assert float(eng.estimate()[0]) == naive["estimate"]


def test_cli_local_line_matches_golden(local_golden):
    port_line = _cli_line("repro_torch.launch.stream", LOCAL_CLI_ARGS, "local[tenant 0] ",
                          ["--device", "cpu"])
    assert local_golden["cli"] == {"args": LOCAL_CLI_ARGS, "local_line": port_line}


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit(__doc__)
    rec = jax_golden()
    rec["cli"] = {"args": CLI_ARGS,
                  "estimate_line": _cli_estimate_line("repro.launch.stream", ["--ckpt-every", "0"])}
    GOLDEN.write_text(json.dumps(rec, indent=1) + "\n")
    local = jax_local_golden()
    local["cli"] = {"args": LOCAL_CLI_ARGS,
                    "local_line": _cli_line("repro.launch.stream", LOCAL_CLI_ARGS,
                                            "local[tenant 0] ", ["--ckpt-every", "0"])}
    LOCAL_GOLDEN.write_text(json.dumps(local, indent=1) + "\n")
    NAIVE_GOLDEN.write_text(json.dumps(jax_naive_golden(), indent=1) + "\n")
    DYNAMIC_GOLDEN.write_text(json.dumps(jax_dynamic_golden(), indent=1) + "\n")
    for path in (GOLDEN, LOCAL_GOLDEN, NAIVE_GOLDEN, DYNAMIC_GOLDEN):
        print(path.read_text())
