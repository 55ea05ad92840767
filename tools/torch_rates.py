#!/usr/bin/env python3
"""Stream rates and kernel times of one checkout of the PyTorch port, on
one NVIDIA GPU, at the full size of ``chip_smoke.py``.

    python3 tools/torch_rates.py [--src DIR] [--streams N] [--profile]
    python3 tools/torch_rates.py --variants segscan:THREADS=256,ITEMS=32 segment_sum:HELD=4 ...
    python3 tools/torch_rates.py [--src DIR] --fused-once    # a profiler's target

``--src`` is the ``src`` directory whose ``repro_torch`` is measured (by
default this checkout's), so that two commits can be compared on one card
in one session: unpack the other with ``git archive`` into an ignored
directory and run the script once against each, alternating. The stream
(chip_smoke's 9,088,608-edge planted-triangle stream) is built the same way
for both.

Prints one JSON line per phase:

  streams   the kernel route's host seconds and edges/s for ``N`` fresh
            engines run one after another in this process, under the
            ``global`` and the ``local`` scheme, so that a slow first run
            shows apart from the later ones;
  kernels   the tile sort at both of its shapes on the path (4 tiles of
            2^21 arcs, 4 of 2^20 edges), multisearch_counts at all three
            (Q1, Q2, step 3), segscan's sums over 4 x 2^21 and 2^21 entries
            and its max over 4 x 2^20 (the plain segmented_cummax where the
            checkout has no max kernel), and segment_sum over the final
            local state: CUDA-event ms over 20 launches, and the CUDA
            launches of one call where the checkout reports them, and each
            shape's device time with the host's cost kept out
            (chip_smoke.device_ms);
  chunk     one K-batch chunk over the final global state on the kernel
            route: the whole chunk, its structure build and fused_ingest in
            the checkout's own signature (the stream key, or the hoisted
            draws), CUDA-event ms, the launches of one fused_ingest call and
            the chunk's peak device bytes, and the ragged tail's per-batch
            update. Where fused_ingest takes hoisted draws, also those draws
            and selects alone, and the kernel run as K one-batch calls
            (batch-major order). Then the device's busy time in one chunk
            and in the tail's update (chip_smoke.device_busy), and the
            structure build and that update stage by stage
            (chip_smoke.build_splits);
  variants  (with ``--variants``) each variant of csrc/segscan.cu or
            csrc/segment_sum.cu against the shipped kernel at its path
            shapes (``kernel_variants``);
  profile   (with ``--profile``) cProfile's top host functions by own time
            over one more ``global`` stream in a fresh engine.

``--fused-once`` does nothing but two ``fused_ingest`` calls at the full
shape (a warm-up, then the call to profile), on the stream's second chunk
over the state its first chunk left, for a profiler such as Nsight Compute:

    ncu --kernel-name regex:fused --launch-skip N ... python3 tools/torch_rates.py --fused-once
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_tenant(state):
    """Tenant 0 of an engine's state: the engine keeps a bank since banks
    were ported; an older tree's engine keeps one tenant's state."""
    return type(state)(*(x[0] for x in state)) if state.m_seen.dim() else state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--streams", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--fused-once", action="store_true")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="variants of a kernel's constants, e.g. segscan:THREADS=256,ITEMS=32")
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_rates: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(a.src).resolve()))
    import repro_torch
    from chip_smoke import (
        FULL,
        build_splits,
        device_busy,
        device_ms,
        planted_full,
        tail_batch,
        time_ms,
    )
    from repro_torch import rng as trng
    from repro_torch.core import bulk
    from repro_torch.core.bulk import _closing_query, _q1_queries
    from repro_torch.core.rank import INF64, _next_pow2, rank_all_chunk
    from repro_torch.data.graph_stream import batches
    from repro_torch.engine import EngineConfig, TriangleCountEngine, run_stream
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitonic import bitonic_sort_tiles
    from repro_torch.kernels.fused_ingest import fused_ingest
    from repro_torch.kernels import segscan as kseg
    from repro_torch.kernels.multisearch import multisearch_counts
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.kernels.segscan import segscan
    from repro_torch.primitives.segscan import segment_starts, segmented_cummax
    from repro_torch.primitives.sort import pack2

    def emit(obj) -> None:
        print(json.dumps(obj), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit({"phase": "card", "card": smi.splitlines()[0],
          "repro_torch": str(Path(repro_torch.__file__).resolve().parent)})
    dev = torch.device("cuda", 0)
    _build.build()
    edges, _ = planted_full(FULL["seed"])
    s, K = FULL["s"], FULL["K"]
    if a.fused_once:
        return fused_once(dev, edges)

    def engine(scheme):
        params = {"n_vertices": FULL["vertices"], "n_pools": FULL["pools"]} \
            if scheme == "local" else None
        return TriangleCountEngine(EngineConfig(
            r=FULL["r"], batch_size=s, chunk_size=K, groups=FULL["groups"],
            seeds=(FULL["seed"],), device=dev.type, ingest="kernel", multisearch="kernel",
            scheme=scheme, scheme_params=params))

    state = local = None
    for scheme in ("global", "local"):
        runs = []
        for _ in range(a.streams):
            eng = engine(scheme)
            rep = run_stream(eng, batches(edges, s))
            runs.append({"seconds": rep.seconds, "edges_per_s": rep.edges_per_s})
            if scheme == "global":
                state = one_tenant(eng.state)
            else:
                local = eng
        emit({"phase": "streams", "scheme": scheme, "runs": runs})

    # the tile sort's two shapes, padded as rank_all_chunk pads them, and the
    # per-batch route's three searches over the final global state
    Ws = torch.from_numpy(edges[: K * s].reshape(K, s, 2)).to(dev)
    nv = torch.full((K,), s, dtype=torch.int32, device=dev)
    key = trng.PRNGKey(FULL["seed"], dev)
    hoisted = not hasattr(bulk, "chunk_structures")  # fused_ingest takes hoisted draws
    if hoisted:
        args, _ = bulk.chunk_inputs(state, Ws, nv, key, 0, use_kernels=False)
        structs = args[:7]
    else:
        structs = bulk.chunk_structures(Ws, nv, use_kernels=False)
        args = (*structs, Ws, nv, state.m_seen, key, 0)
    key_desc, key_rank, ekey = structs[0], structs[1], structs[5]
    tile, tile_e = _next_pow2(2 * s), _next_pow2(s)
    kd = torch.full((K, tile), INF64, dtype=torch.int64, device=dev)
    kd[:, : 2 * s] = pack2(torch.cat([Ws[:, :, 0], Ws[:, :, 1]], 1),
                           (s - 1) - torch.arange(s, device=dev, dtype=torch.int32).repeat(2)[None, :])
    arc = torch.zeros((K, tile), dtype=torch.int32, device=dev)
    arc[:, : 2 * s] = torch.arange(2 * s, dtype=torch.int32, device=dev)
    ek = torch.full((K, tile_e), INF64, dtype=torch.int64, device=dev)
    ek[:, :s] = pack2(torch.minimum(Ws[:, :, 0], Ws[:, :, 1]), torch.maximum(Ws[:, :, 0], Ws[:, :, 1]))
    ep = torch.zeros((K, tile_e), dtype=torch.int32, device=dev)
    ep[:, :s] = torch.arange(s, dtype=torch.int32, device=dev)
    f1b = torch.full((FULL["r"],), -1, dtype=torch.int32, device=dev)
    searches = {
        "q1": (key_desc[0].contiguous(), _q1_queries(s, state.f1[:, 0], state.f1[:, 1], f1b)),
        "q2": (key_rank[0].contiguous(), pack2(state.f1[:, 0], torch.clamp(state.chi, min=0))),
        "step3": (ekey[0].contiguous(), _closing_query(state.f1, state.f2)[1]),
    }
    calls = {
        f"sort {K} tiles of {tile} (arcs)": (
            "bitonic_sort_tiles", lambda: bitonic_sort_tiles(kd.view(-1), arc.view(-1), tile)),
        f"sort {K} tiles of {tile_e} (edges)": (
            "bitonic_sort_tiles", lambda: bitonic_sort_tiles(ek.view(-1), ep.view(-1), tile_e)),
        **{f"{name}: {q.numel()} queries into {k.numel()} keys": (
            "multisearch_counts", lambda k=k, q=q: multisearch_counts(k, q))
           for name, (k, q) in searches.items()},
    }
    # segscan's sums (the chunk's ranks, one batch's ranks), its max over the
    # chunk's sorted edges where the checkout has that kernel (else the plain
    # segmented_cummax the structure build ran), and segment_sum over the
    # final local state
    ones = torch.ones(K * 2 * s, dtype=torch.int32, device=dev)
    arc_starts = segment_starts(structs[2]).reshape(-1).contiguous()
    one_batch = segment_starts(structs[2][0]).contiguous()
    epos, estarts = structs[6].reshape(-1).contiguous(), segment_starts(ekey).reshape(-1)
    calls[f"segscan sum over {K * 2 * s}"] = ("segscan", lambda: segscan(ones, arc_starts))
    calls[f"segscan sum over {2 * s}"] = ("segscan", lambda: segscan(ones[: 2 * s], one_batch))
    if hasattr(kseg, "segmented_max_scan"):
        calls[f"segscan max over {K * s}"] = (
            "segmented_max_scan", lambda: kseg.segmented_max_scan(epos, estarts))
    else:
        calls[f"plain segmented_cummax over {K * s}"] = (
            None, lambda: segmented_cummax(epos, estarts))
    vals, ids = local.scheme.attribution_inputs(one_tenant(local.state), 0, FULL["r"])
    calls[f"segment_sum {ids.numel()} rows into {local.scheme.n_vertices} bins"] = (
        "segment_sum", lambda: segment_sum(vals, ids, local.scheme.n_vertices))
    counted = getattr(_build, "CUDA_LAUNCHES", None)  # absent before it was added
    shapes = []
    for label, (kernel, fn) in calls.items():
        per_call = None
        if counted is not None and kernel is not None:
            counted[kernel] = 0
            fn()
            per_call = counted[kernel]
        shapes.append({"shape": label, "ms": time_ms(fn, reps=20), "device_ms": device_ms(fn),
                       "launches_per_call": per_call})
    emit({"phase": "kernels", "shapes": shapes})
    if a.variants:
        kernel_variants(a.variants, {
            "segscan": {"sum_chunk": ("segscan", (ones, arc_starts)),
                        "sum_batch": ("segscan", (ones[: 2 * s], one_batch)),
                        "max_chunk": ("segscan_max", (epos, estarts))},
            "segment_sum": {"local_estimate": ("segment_sum",
                                               (vals, ids, local.scheme.n_vertices))}})

    st = (state.f1, state.chi, state.f2, state.has_f3)
    fused = {"fused_ingest": lambda: fused_ingest(*st, *args)}
    if hoisted:
        fused["draws_and_selects"] = lambda: bulk.chunk_inputs(state, Ws, nv, key, 0,
                                                               use_kernels=False)
        fused["fused_ingest_as_K_one_batch_calls"] = lambda: [
            fused_ingest(*st, *(a[k:k + 1] for a in args)) for k in range(K)]
    chunk = {
        "chunk": lambda: bulk.bulk_update_chunk(state, Ws, nv, key, 0, backend="kernel"),
        "structures": lambda: rank_all_chunk(Ws, nv, use_kernels=True),
        **fused,
    }
    times = {name: time_ms(fn, reps=10) for name, fn in chunk.items()}
    if hoisted:  # chunk_inputs builds the structures too: leave them out
        times["draws_and_selects"] -= time_ms(lambda: rank_all_chunk(Ws, nv, use_kernels=False),
                                              reps=10)
    per_call = None
    if counted is not None:
        counted["fused_ingest"] = 0
        fused["fused_ingest"]()
        per_call = counted["fused_ingest"]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    chunk["chunk"]()
    torch.cuda.synchronize(dev)
    W_tail, n_tail = tail_batch(edges, dev)
    times["tail_batch"] = time_ms(lambda: bulk.bulk_update_all(state, W_tail, n_tail, key,
                                                               "kernel"), reps=3)
    emit({"phase": "chunk", "ms": times, "fused_ingest_launches_per_call": per_call,
          "chunk_peak_device_bytes": torch.cuda.max_memory_allocated(dev),
          "fused_ingest_takes": "hoisted draws" if hoisted else "the stream key",
          "chunk_profile": device_busy(chunk["chunk"]),
          "tail_batch_profile": device_busy(lambda: bulk.bulk_update_all(state, W_tail, n_tail,
                                                                         key, "kernel")),
          **build_splits(state, Ws, nv, W_tail, n_tail, key)})

    if a.profile:
        prof = cProfile.Profile()
        eng = engine("global")
        prof.enable()
        rep = run_stream(eng, batches(edges, s))
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(15)
        emit({"phase": "profile", "seconds": rep.seconds, "top_tottime": out.getvalue().splitlines()})
    return 0


def kernel_variants(variants, inputs) -> None:
    """Build each variant (``NAME:CONST=V,...``: ``csrc/NAME.cu`` with some
    of its ``constexpr int`` constants set otherwise, for segscan THREADS,
    ITEMS, MIN_CTAS; for segment_sum THREADS, HELD, BATCH, MIN_CTAS) into
    ``build/kernel_variants/`` and call its C entry directly on ``inputs``
    (name -> label -> (entry, args)), beside the checkout's shipped library.
    Each result must equal the shipped kernel's. One JSON line per variant:
    device ms (``chip_smoke.device_ms``) of the variant and of the shipped
    kernel before and after it at each label, and ptxas's registers and
    spills."""
    import ctypes
    import re

    import torch

    from chip_smoke import device_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_sum as ksum
    from repro_torch.kernels import segscan as kseg

    out_dir = _build.BUILD_DIR.parent / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    def caller(lib, name, entry, args):
        fn = getattr(lib, entry)
        queued = ctypes.c_int(0)
        dev = args[0].device
        if name == "segscan":
            vals, flags = args
            fn.argtypes, fn.restype = kseg._ARGS, ctypes.c_int
            tile = lib.segscan_tile_size()
            out = torch.empty_like(vals)
            scratch = torch.empty(-(-vals.numel() // tile) + 1, dtype=torch.int64, device=dev)
            ptrs = (vals.data_ptr(), flags.data_ptr(), vals.numel(), out.data_ptr(),
                    scratch.data_ptr())
        else:
            vals, ids, m = args
            fn.argtypes, fn.restype = ksum._ARGS, ctypes.c_int
            out = torch.empty((m, vals.shape[1]), dtype=vals.dtype, device=dev)
            ptrs = (vals.data_ptr(), ids.data_ptr(), vals.shape[0], vals.shape[1], m,
                    out.data_ptr())

        def call():
            _build.raise_on_error(fn(*ptrs, _build.stream_handle(dev), ctypes.byref(queued)), entry)
            return out
        return call

    for spec in variants:
        name, variant = spec.split(":")
        src = (_build.CSRC / f"{name}.cu").read_text()
        for const, value in (kv.split("=") for kv in variant.split(",")):
            src, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {int(value)};",
                             src)
            if n != 1:
                raise ValueError(f"no constant {const} in {name}.cu")
        tag = f"{name}_" + variant.replace("=", "").replace(",", "_")
        cu, lib_path = out_dir / f"{tag}.cu", out_dir / f"lib{tag}.so"
        cu.write_text(src)
        log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                              str(lib_path), str(cu)], capture_output=True, text=True, check=True)
        lib, shipped = ctypes.CDLL(str(lib_path)), ctypes.CDLL(str(_build.library_path(name)))
        row = {"variant": spec, "ptxas": [ln.strip() for ln in (log.stdout + log.stderr).splitlines()
                                          if "registers" in ln or "spill" in ln]}
        for label, (entry, args) in inputs[name].items():
            mine, ship = caller(lib, name, entry, args), caller(shipped, name, entry, args)
            if not torch.equal(mine().clone(), ship()):
                raise AssertionError(f"variant {spec} differs from the shipped kernel at {label}")
            row[label] = {"shipped_ms_before": device_ms(ship), "ms": device_ms(mine),
                          "shipped_ms_after": device_ms(ship)}
        print(json.dumps(row), flush=True)


def fused_inputs(dev, edges) -> tuple:
    """fused_ingest's arguments at the full shape, in the checkout's own
    signature: the stream's second chunk over the state its first chunk
    left."""
    import torch

    from chip_smoke import FULL
    from repro_torch import rng as trng
    from repro_torch.core import bulk
    from repro_torch.core.state import init_state

    s, K = FULL["s"], FULL["K"]
    key = trng.PRNGKey(FULL["seed"], dev)
    nv = torch.full((K,), s, dtype=torch.int32, device=dev)
    chunks = torch.from_numpy(edges[: 2 * K * s].reshape(2, K, s, 2)).to(dev)
    state = bulk.bulk_update_chunk(init_state(FULL["r"], dev), chunks[0], nv, key, 0,
                                   backend="kernel")
    Ws = chunks[1]
    if hasattr(bulk, "chunk_structures"):
        args = (*bulk.chunk_structures(Ws, nv, use_kernels=True), Ws, nv, state.m_seen, key, K)
    else:  # fused_ingest takes hoisted draws
        args, _ = bulk.chunk_inputs(state, Ws, nv, key, K, use_kernels=True)
    return (state.f1, state.chi, state.f2, state.has_f3, *args)


def fused_once(dev, edges) -> int:
    import torch

    from repro_torch.kernels.fused_ingest import fused_ingest

    args = fused_inputs(dev, edges)
    for _ in range(2):
        fused_ingest(*args)
        torch.cuda.synchronize(dev)
    print(json.dumps({"phase": "fused_once", "ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
