"""The golden file: the JAX reference's final state for one small chunked
stream with a ragged tail, which the port must reproduce bit for bit.

``src/repro_torch/golden/stream_small.json`` records the sha256 of the JAX
engine's final estimator state and its estimate; ``chip_smoke.py`` holds the
port's CUDA kernel path to it on a machine without JAX. These tests
regenerate it from the JAX package, check the committed copy, and hold the
port's CPU paths to it. Rewrite the file with

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
from repro.data.graph_stream import planted_triangle_stream as jax_planted  # noqa: E402
from repro.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.engine import TriangleCountEngine as JaxEngine  # noqa: E402
from repro.engine import run_stream as jax_run_stream  # noqa: E402

from repro_torch.data.graph_stream import batches, planted_triangle_stream  # noqa: E402
from repro_torch.engine import EngineConfig, TriangleCountEngine, run_stream  # noqa: E402
from repro_torch.interop import state_sha256  # noqa: E402

GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "stream_small.json"
# planted graph: 150 triangles + 2000 noise edges = 2450 edges in batches of
# 256 -> 9 full batches and a ragged one of 146; with K = 4 that is two
# chunks, then one full and one ragged batch on the per-batch path
STREAM = {"triangles": 150, "noise_edges": 2000, "vertices": 3000, "seed": 3}
ENGINE = {"r": 4096, "batch_size": 256, "chunk_size": 4, "groups": 9, "seed": 3}
CLI_ARGS = ["--graph", "planted", "--triangles", "300", "--edges", "6000",
            "--nodes", "9000", "--estimators", "8192", "--batch", "512",
            "--chunk", "4", "--seed", "1"]


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


def _cli_estimate_line(module: str, extra=()) -> str:
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", module, *CLI_ARGS, *extra], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300, check=True).stdout
    return next(line for line in out.splitlines() if line.startswith("estimate:"))


def port_run(device: str = "cpu", ingest: str = "auto", multisearch: str = "auto"):
    """The golden stream through the port's engine; returns the engine."""
    edges, _ = planted_triangle_stream(STREAM["triangles"], STREAM["noise_edges"],
                                       STREAM["vertices"], seed=STREAM["seed"])
    eng = TriangleCountEngine(EngineConfig(
        r=ENGINE["r"], batch_size=ENGINE["batch_size"], chunk_size=ENGINE["chunk_size"],
        groups=ENGINE["groups"], seeds=(ENGINE["seed"],), device=device,
        ingest=ingest, multisearch=multisearch))
    run_stream(eng, batches(edges, ENGINE["batch_size"]))
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


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit(__doc__)
    rec = jax_golden()
    rec["cli"] = {"args": CLI_ARGS,
                  "estimate_line": _cli_estimate_line("repro.launch.stream", ["--ckpt-every", "0"])}
    GOLDEN.write_text(json.dumps(rec, indent=1) + "\n")
    print(json.dumps(rec, indent=1))
