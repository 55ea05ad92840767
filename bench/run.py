"""Run one benchmark cell of the streaming triangle counter on one GPU.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` a ``breakdown``,
and the compared numbers beside their limits under ``checks``), and the
compared numbers again as the last lines of standard error. Exits non-zero,
printing no result, without a CUDA device (or with fewer than the cell
asks for), or where JAX or the JAX package is loaded once the window has
closed.
"""
import time

T_START = time.perf_counter()  # noqa: E402 -- set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout (the program builds its kernels into ``build/repro_torch``)."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_dirs(ROOT)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench import harness

    cell = harness.find_cell(harness.manifest(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), root=ROOT,
                      t_start=T_START)
    for note in out.notes:
        print(note, file=sys.stderr)
    if out.banned:
        print(f"JAX or the JAX package was loaded: {out.banned}", file=sys.stderr)
        return 3
    for name, c in out.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
