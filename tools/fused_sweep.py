#!/usr/bin/env python3
"""Time variants of the fused_ingest CUDA kernel at the full shape on one GPU.

    python3 tools/fused_sweep.py [VARIANT ...]      # VARIANT: EST=1,SAMPLE=4096

A variant is ``csrc/fused_ingest.cu`` with some of its ``constexpr int``
constants (EST: estimators a thread carries; SAMPLE: keys in each shared
sample; MIN_CTAS: the launch bound's CTAs an SM; THREADS) set otherwise. Each is built by nvcc with the port's flags
into ``build/fused_sweep/`` and called through the ``fused_ingest`` wrapper
in place of the shipped library, on the stream's second chunk over the
state its first chunk left (``tools/torch_rates.py --fused-once``'s
inputs). Its result must equal the shipped kernel's. One JSON line per
variant: CUDA-event ms over 10 calls after 2 warm-ups, the shipped kernel
timed before and after it, and ptxas's registers and spills.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT = ["EST=1,SAMPLE=4096", "EST=4,SAMPLE=4096", "EST=2,SAMPLE=2048", "EST=2,SAMPLE=8192"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fused_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    from chip_smoke import FULL, planted_full, time_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_ingest as fi
    from torch_rates import fused_inputs

    dev = torch.device("cuda", 0)
    args = fused_inputs(dev, planted_full(FULL["seed"])[0])
    want = fi.fused_ingest(*args)
    shipped = _build.load("fused_ingest", "fused_ingest", fi._ARGS)
    source = (_build.CSRC / "fused_ingest.cu").read_text()
    out = _build.BUILD_DIR.parent / "fused_sweep"
    out.mkdir(parents=True, exist_ok=True)
    for variant in sys.argv[1:] or DEFAULT:
        src = source
        for name, value in (kv.split("=") for kv in variant.split(",")):
            src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};", src)
            if n != 1:
                raise ValueError(f"no constant {name} in fused_ingest.cu")
        tag = variant.replace("=", "").replace(",", "_")
        cu, lib = out / f"fused_ingest_{tag}.cu", out / f"libfused_ingest_{tag}.so"
        cu.write_text(src)
        log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                              str(lib), str(cu)], capture_output=True, text=True, check=True)
        ptxas = [ln.strip() for ln in (log.stdout + log.stderr).splitlines()
                 if "registers" in ln or "spill" in ln]
        fn = ctypes.CDLL(str(lib)).fused_ingest
        fn.argtypes, fn.restype = fi._ARGS, ctypes.c_int

        def call(f):
            _build._FUNCS["fused_ingest", "fused_ingest"] = f
            return fi.fused_ingest(*args)

        got = call(fn)
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        before = time_ms(lambda: call(shipped), reps=10)
        ms = time_ms(lambda: call(fn), reps=10)
        after = time_ms(lambda: call(shipped), reps=10)
        _build._FUNCS["fused_ingest", "fused_ingest"] = shipped
        print(json.dumps({"variant": variant, "equal": equal, "ms": ms, "shipped_ms_before": before,
                          "shipped_ms_after": after, "ptxas": ptxas}), flush=True)
        if not equal:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
