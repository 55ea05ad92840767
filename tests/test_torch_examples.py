"""The port's example entry points against the JAX reference's examples.

``launch/quickstart.py``, ``launch/streaming_triangle_count.py`` and
``launch/train_lm.py`` are the counterparts of ``examples/quickstart.py``,
``examples/streaming_triangle_count.py`` and ``examples/train_lm.py``. On
the CPU, at small sizes, each example's code is re-enacted on the
reference (as ``tests/test_torch_gnn.py::jax_gnn_features`` re-enacts
``gnn_features``) and the port must print the same lines, apart from the
seconds, from a bit-identical state: the same state sha256 for the
quickstart, the same ``resumed_from`` and equal per-tenant estimates for
the streaming example. Exact, because every draw is counter-based.

``src/repro_torch/golden/examples_small.json`` holds what the reference's
own scripts print at their own sizes (the sizes read from the scripts by
``ast``): the quickstart's line, the streaming example's lines without the
seconds (its checkpoint directory moved to a fresh temporary one), and the
``arch=`` line and first logged loss of ``examples/train_lm.py --steps 1``
(smollm-135m at full width). ``chip_smoke.py``'s phase examples holds the
port to it on the card. It is rewritten with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_examples.py --write
"""
import ast
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import repro  # noqa: E402,F401  -- enables x64, as the reference runs
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import bulk_update_all_jit, estimate as jestimate, init_state as jinit_state  # noqa: E402
from repro.core.sequential import count_triangles  # noqa: E402
from repro.data.graph_stream import barabasi_albert_stream, batches  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import TriangleCountEngine as JEngine  # noqa: E402
from repro.engine import run_stream as jrun_stream  # noqa: E402
from repro_torch.interop import estimator_sha256  # noqa: E402
from repro_torch.launch import quickstart, streaming_triangle_count, train_lm  # noqa: E402

GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "examples_small.json"
EXAMPLES = ROOT / "examples"
REF_CKPT = '"/tmp/repro_stream_demo_ckpt"'  # the streaming example's checkpoint directory
SECONDS = re.compile(r" in [0-9.]+s")
# examples/train_lm.py's run for the golden: one step on a fresh --ckpt-dir
TRAIN_ARGS = ["--steps", "1"]


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


def _call(tree, name: str, positional: tuple) -> dict:
    """The literal arguments of the one call of ``name`` in ``tree``,
    positional ones under the names ``positional``."""
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", getattr(n.func, "attr", None)) == name]
    assert len(calls) == 1, (name, len(calls))
    out = {p: ast.literal_eval(a) for p, a in zip(positional, calls[0].args)}
    out.update({kw.arg: ast.literal_eval(kw.value) for kw in calls[0].keywords})
    return out


def _literal_assigns(tree) -> dict:
    """``a, b = 1, 2`` and ``a = 1`` at a script's top level."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t, v = node.targets[0], node.value
            pairs = (zip(t.elts, v.elts) if isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple)
                     else [(t, v)])
            for name, value in pairs:
                if isinstance(name, ast.Name) and isinstance(value, ast.Constant):
                    out[name.id] = value.value
    return out


def example_sizes() -> dict:
    """The sizes the reference's example scripts run at, and
    ``examples/train_lm.py``'s command, read from their source."""
    qs = ast.parse((EXAMPLES / "quickstart.py").read_text())
    ba, lit = _call(qs, "barabasi_albert_stream", ("n", "k")), _literal_assigns(qs)
    quick = {"n": ba["n"], "k": ba["k"], "graph_seed": ba["seed"], "r": lit["r"],
             "batch_size": lit["batch_size"]}
    st = ast.parse((EXAMPLES / "streaming_triangle_count.py").read_text())
    ba, cfg = _call(st, "barabasi_albert_stream", ("n", "k")), _call(st, "EngineConfig", ())
    assert cfg["n_tenants"] == len(cfg["seeds"]), cfg
    stream = {"n": ba["n"], "k": ba["k"], "graph_seed": ba["seed"], "r": cfg["r"],
              "batch_size": cfg["batch_size"], "seeds": list(cfg["seeds"])}
    tl = ast.parse((EXAMPLES / "train_lm.py").read_text())
    cmd = next(n for n in ast.walk(tl) if isinstance(n, ast.List))
    return {"quickstart": quick, "streaming": stream,
            "train_lm": [e.value for e in cmd.elts if isinstance(e, ast.Constant)]}


def jax_quickstart(n, k, graph_seed, r, batch_size) -> tuple[str, str]:
    """``examples/quickstart.py``'s code at the given size, on the
    reference: its line and the final state's sha256."""
    edges = barabasi_albert_stream(n=n, k=k, seed=graph_seed)
    tau = count_triangles(edges)
    state = jinit_state(r)
    key = jax.random.PRNGKey(0)
    for i, (W, n_valid) in enumerate(batches(edges, batch_size)):
        state = bulk_update_all_jit(state, jnp.asarray(W), jnp.int32(n_valid),
                                    jax.random.fold_in(key, i))
    est = float(jestimate(state, groups=9))
    line = (f"edges={len(edges)}  true tau={tau}  estimate={est:.0f}  "
            f"rel.err={abs(est - tau) / tau:.2%}")
    return line, estimator_sha256([np.asarray(x) for x in state])


def jax_streaming(n, k, graph_seed, r, batch_size, seeds, ckpt_dir) -> dict:
    """``examples/streaming_triangle_count.py``'s three phases at the given
    size, on the reference: its printed lines, ``resumed_from`` and the
    resumed run's per-tenant estimates."""
    out = []
    edges = barabasi_albert_stream(n, k, seed=graph_seed)
    tau = count_triangles(edges)
    out.append(f"stream: m={len(edges)} tau={tau}")
    cfg = JEngineConfig(r=r, batch_size=batch_size, n_tenants=len(seeds), seeds=tuple(seeds))
    out.append("\n=== phase 1: ingest half the stream, checkpointing every 2 batches ===")
    engine = JEngine(cfg)
    it = list(batches(edges, cfg.batch_size))
    rep = jrun_stream(engine, it[: len(it) // 2], ckpt_dir=ckpt_dir, ckpt_every=2)
    out.append(f"ingested {rep.edges} edges in {rep.seconds:.2f}s; "
               f"rolling estimates: {np.round(engine.estimate(), 1)}")
    out.append("\n=== phase 2: 'crash' — a fresh engine resumes from the checkpoint "
               "and finishes the stream ===")
    engine2 = JEngine(cfg)
    rep2 = jrun_stream(engine2, it, ckpt_dir=ckpt_dir, ckpt_every=2)
    out.append(f"resumed at batch {rep2.resumed_from}, ingested {rep2.batches} more")
    ests = engine2.estimate()
    for t, e in enumerate(ests):
        out.append(f"tenant {t}: estimate={e:.1f} rel.err={abs(e-tau)/tau:.3%}")
    out.append("\n=== determinism check: an uninterrupted run matches the resumed one "
               "bit-for-bit (counter-based RNG) ===")
    engine3 = JEngine(cfg)
    jrun_stream(engine3, it)
    assert np.array_equal(engine3.estimate(), ests), "resume is not deterministic!"
    out.append("OK: resumed estimates == uninterrupted estimates")
    return {"lines": out, "resumed_from": rep2.resumed_from, "estimates": np.asarray(ests)}


def printed(lines) -> list:
    """Printed lines as stdout shows them, without the seconds."""
    return SECONDS.sub("", "\n".join(lines)).splitlines()


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("size", [
    {"n": 300, "k": 8, "graph_seed": 0, "r": 4096, "batch_size": 256},
    {"n": 400, "k": 5, "graph_seed": 3, "r": 3000, "batch_size": 200},  # groups of 333
])
def test_quickstart_matches_the_reference_bit_for_bit(size):
    want_line, want_sha = jax_quickstart(**size)
    got = quickstart.run(**size, device="cpu", echo=lambda _: None)
    assert got["line"] == want_line
    assert got["state_sha256"] == want_sha


def test_streaming_example_matches_the_reference(tmp_path):
    size = {"n": 2000, "k": 8, "graph_seed": 0, "r": 8192, "batch_size": 512, "seeds": (0, 1, 2)}
    want = jax_streaming(**size, ckpt_dir=str(tmp_path / "jax"))
    shown = []
    got = streaming_triangle_count.run(**size, ckpt_dir=str(tmp_path / "port"), device="cpu",
                                       echo=shown.append)
    assert shown == got["lines"]
    assert printed(got["lines"]) == printed(want["lines"])
    assert got["resumed_from"] == want["resumed_from"] > 0
    np.testing.assert_array_equal(got["estimates"], want["estimates"])
    np.testing.assert_array_equal(got["uninterrupted"], want["estimates"])


def test_train_lm_passes_the_reference_arguments(monkeypatch):
    sizes = example_sizes()
    assert sizes["train_lm"] == ["-m", "repro.launch.train", *train_lm.ARGS]
    seen = []
    monkeypatch.setattr(train_lm.subprocess, "run", lambda cmd, **kw: seen.append((cmd, kw)))
    train_lm.main(["--smoke", "--device", "cpu"])
    assert seen == [([sys.executable, "-m", "repro_torch.launch.train", *train_lm.ARGS,
                      "--smoke", "--device", "cpu"], {"check": True})]


def test_golden_sizes_are_the_examples_and_the_defaults(golden):
    sizes = example_sizes()
    assert golden["quickstart"]["args"] == sizes["quickstart"]
    assert golden["streaming"]["args"] == sizes["streaming"]
    assert golden["train_lm"]["command"] == sizes["train_lm"]
    for mod, args in ((quickstart, sizes["quickstart"]),
                      (streaming_triangle_count, sizes["streaming"])):
        defaults = {k: p.default for k, p in inspect.signature(mod.run).parameters.items()}
        assert {k: defaults[k] for k in args} == {k: tuple(v) if k == "seeds" else v
                                                   for k, v in args.items()}


def test_quickstart_golden_is_the_reference_script(golden):
    out = subprocess.run([sys.executable, str(EXAMPLES / "quickstart.py")], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert out.splitlines() == [golden["quickstart"]["line"]]


def test_quickstart_at_the_example_size_prints_the_golden_line(golden):
    got = quickstart.run(device="cpu", echo=lambda _: None)
    assert got["line"] == golden["quickstart"]["line"]


@pytest.mark.parametrize("entry", ["quickstart", "streaming_triangle_count"])
def test_entry_points_run_on_the_card_by_default(entry, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"quickstart": quickstart, "streaming_triangle_count": streaming_triangle_count}[entry]
    argv = [] if entry == "quickstart" else ["--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


def _write() -> dict:
    """Run the reference's three scripts at their own sizes, at once."""
    sizes = example_sizes()
    tmp = Path(tempfile.mkdtemp(prefix="examples_golden_"))
    src = (EXAMPLES / "streaming_triangle_count.py").read_text()
    assert src.count(REF_CKPT) == 1, "the streaming example's checkpoint directory moved"
    src = src.replace(REF_CKPT, repr(str(tmp / "stream_ckpt")))
    cmds = {"quickstart": [sys.executable, str(EXAMPLES / "quickstart.py")],
            "streaming": [sys.executable, "-c", src],
            "train_lm": [sys.executable, str(EXAMPLES / "train_lm.py"), *TRAIN_ARGS,
                         "--ckpt-dir", str(tmp / "train_ckpt")]}
    try:
        procs = {k: subprocess.Popen(c, cwd=ROOT, env=_env(), stdout=subprocess.PIPE, text=True)
                 for k, c in cmds.items()}
        out = {}
        for k, p in procs.items():
            out[k] = p.communicate()[0].splitlines()
            assert p.returncode == 0, (k, out[k])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    first = next(ln for ln in out["train_lm"] if ln.startswith("loss: first logged ="))
    return {
        "quickstart": {"args": sizes["quickstart"], "line": out["quickstart"][0]},
        "streaming": {"args": sizes["streaming"], "lines": printed(out["streaming"])},
        "train_lm": {"command": sizes["train_lm"], "args": TRAIN_ARGS,
                     "arch_line": out["train_lm"][0],
                     "first_loss": float(first.split("=")[1].split()[0])},
    }


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(__doc__)
    GOLDEN.write_text(json.dumps(_write(), indent=1, ensure_ascii=False) + "\n")
    print(GOLDEN.read_text())
