"""Builds and loads the CUDA kernels, and checks their arguments.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (one ``extern "C"`` entry per kernel, returning
``cudaGetLastError()`` and, through its last argument, how many CUDA kernels
it queued) and loaded with ``ctypes``. The build happens at first
use, from the sources in the checkout only, into ``build/repro_torch/`` at the
root of the checkout; the library's file name carries a hash of its source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and a stale library never loads.
``build()`` compiles several sources at once, one ``nvcc`` process each.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable, Optional, Sequence

import torch

SOURCES = ("fused_ingest", "bitonic", "segscan", "multisearch", "segment_sum")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launch counts, one per kernel: a wrapper adds one where it launches its
# kernel on the card, and nowhere else (its plain version on CPU tensors and
# its no-launch short cuts do not count).
# segmented_max_scan is the segscan kernel over the max monoid, counted
# apart so that a run shows both monoids were launched.
LAUNCHES = {name: 0 for name in ("fused_ingest", "bitonic_sort_tiles", "segscan",
                                 "segmented_max_scan", "multisearch_counts", "segment_sum")}
# The CUDA kernels those wrapper calls queued, as each C entry reports them
# (a tile sort, for one, queues a block sort and one kernel per merge pass).
CUDA_LAUNCHES = dict(LAUNCHES)
# Library events: ``builds`` counts the nvcc processes started, ``loads`` the
# C entries bound (a library is opened at its first entry's bind). Once a
# caller has used every kernel it needs, neither moves: the elastic tier's
# steady churn is held to that (``engine/elastic.py``).
LIBRARY_EVENTS = {"builds": 0, "loads": 0}
# The C entries' last argument: where they write how many kernels they queued.
QUEUED = ctypes.POINTER(ctypes.c_int)

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        CUDA_LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels need it")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source,
    every ``csrc/*.cuh`` header (any source may include any of them) and
    the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> dict[str, float]:
    """Compile every named source whose library is missing, all in parallel.
    Returns the seconds each build took (0.0 where the library was already
    there); raises with the compiler's output if one fails. Each build's
    compiler log (registers, shared memory, spills) is kept beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        log = open(target.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        LIBRARY_EVENTS["builds"] += 1
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, target, log)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, target, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n{target.with_suffix('.log').read_text()[-4000:]}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str, fn: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``fn`` of library ``name``, built and loaded at its first
    use, with its argument types set (``c_void_p`` for every pointer and the
    stream)."""
    if (name, fn) not in _FUNCS:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        f = getattr(_LIBS[name], fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _FUNCS[name, fn] = f
        LIBRARY_EVENTS["loads"] += 1
    return _FUNCS[name, fn]


def launch(kernel: str, fn: ctypes._CFuncPtr, *args) -> None:
    """Call the C entry ``fn`` (whose last argument is ``QUEUED``) on
    ``args``; raise if it failed, else count one launch of ``kernel`` and the
    CUDA kernels the entry reports it queued."""
    queued = ctypes.c_int(0)
    raise_on_error(fn(*args, ctypes.byref(queued)), kernel)
    LAUNCHES[kernel] += 1
    CUDA_LAUNCHES[kernel] += queued.value


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: Optional[tuple] = None,
          device: Optional[torch.device] = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype (and
    shape and device, where given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error code {err}")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
