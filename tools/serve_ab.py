#!/usr/bin/env python3
"""``chip_smoke.py``'s serve_full phase read from two checkouts of the
PyTorch port in alternation, each run in a fresh process, on one NVIDIA GPU.

    python3 tools/serve_ab.py --base DIR

``DIR`` is the root of another checkout (unpack it with ``git archive`` into
an ignored directory). The variants separate the port's serving code from
what the full script sets up around the phase:

  base           DIR's phase_serve_full alone
  head           this checkout's phase_serve_full alone
  head_ws        the same under CUBLAS_WORKSPACE_CONFIG=:4096:8, which this
                 checkout's chip_smoke.py sets for the whole process
  head_ws_train  the same after this checkout's phase_golden_train, the
                 phase that now runs before it in chip_smoke.py

The variants run in this order and then in reverse. Prints one
JSON line per run (the variant, its decode loop's ms a step and tok/s for
smollm-135m and granite-moe-1b-a400m, two runs each as the phase makes
them), and last one line with each variant's runs gathered.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HEAD = Path(__file__).resolve().parents[1]
VARIANTS = ("base", "head", "head_ws", "head_ws_train")
WORKSPACE = ":4096:8"


def child(tree: Path, golden_train: bool) -> None:
    """Import ``tree``'s chip_smoke.py and run its serve_full phase (after
    golden_train where asked); chip_smoke prints the phase's JSON line."""
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    dev = torch.device("cuda", 0)
    card = smoke.phase_card()
    if golden_train:
        smoke.phase_golden_train(dev)
    smoke.phase_serve_full(dev, card)


def run(variant: str, base: Path) -> dict:
    tree = base if variant == "base" else HEAD
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    if variant.startswith("head_ws"):
        env["CUBLAS_WORKSPACE_CONFIG"] = WORKSPACE
    cmd = [sys.executable, __file__, "--child", str(tree)]
    if variant == "head_ws_train":
        cmd.append("--golden-train")
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=900, check=True)
    phase = next(json.loads(ln) for ln in out.stdout.splitlines()
                 if ln.startswith("{") and json.loads(ln).get("phase") == "serve_full")
    return {"variant": variant, "card": phase["card"],
            **{f"{arch}_{key}": phase[arch][key]
               for arch in ("smollm-135m", "granite-moe-1b-a400m")
               for key in ("ms_per_step", "tok_per_s")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--golden-train", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child is not None:
        child(a.child.resolve(), a.golden_train)
        return 0
    if a.base is None or not (a.base / "chip_smoke.py").is_file():
        ap.error("--base must be the root of a checkout holding chip_smoke.py")
    gathered: dict[str, list] = {v: [] for v in VARIANTS}
    for variant in VARIANTS + VARIANTS[::-1]:
        row = run(variant, a.base.resolve())
        print(json.dumps(row), flush=True)
        gathered[variant].append(row)
    print(json.dumps({"serve_ab": {v: {"smollm_ms_per_step": [r["smollm-135m_ms_per_step"]
                                                              for r in rows],
                                       "granite_ms_per_step": [
                                           r["granite-moe-1b-a400m_ms_per_step"] for r in rows]}
                                   for v, rows in gathered.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
