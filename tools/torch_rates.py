#!/usr/bin/env python3
"""Stream rates and kernel times of one checkout of the PyTorch port, on
one NVIDIA GPU, at the full size of ``chip_smoke.py``.

    python3 tools/torch_rates.py [--src DIR] [--streams N] [--profile]
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
            2^21 arcs, 4 of 2^20 edges) and multisearch_counts at all three
            (Q1, Q2, step 3): CUDA-event ms over 20 launches, and the CUDA
            launches of one call where the checkout reports them;
  chunk     one K-batch chunk over the final global state on the kernel
            route: the whole chunk, its structure build and fused_ingest in
            the checkout's own signature (the stream key, or the hoisted
            draws), CUDA-event ms, the launches of one fused_ingest call and
            the chunk's peak device bytes. Where fused_ingest takes hoisted
            draws, also those draws and selects alone, and the kernel run as
            K one-batch calls (batch-major order);
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--streams", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--fused-once", action="store_true")
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_rates: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(a.src).resolve()))
    import repro_torch
    from chip_smoke import FULL, planted_full, time_ms
    from repro_torch import rng as trng
    from repro_torch.core import bulk
    from repro_torch.core.bulk import _closing_query, _q1_queries
    from repro_torch.core.rank import INF64, _next_pow2, rank_all_chunk
    from repro_torch.data.graph_stream import batches
    from repro_torch.engine import EngineConfig, TriangleCountEngine, run_stream
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitonic import bitonic_sort_tiles
    from repro_torch.kernels.fused_ingest import fused_ingest
    from repro_torch.kernels.multisearch import multisearch_counts
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

    state = None
    for scheme in ("global", "local"):
        runs = []
        for _ in range(a.streams):
            eng = engine(scheme)
            rep = run_stream(eng, batches(edges, s))
            runs.append({"seconds": rep.seconds, "edges_per_s": rep.edges_per_s})
            if scheme == "global":
                state = eng.state
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
    counted = getattr(_build, "CUDA_LAUNCHES", None)  # absent before it was added
    shapes = []
    for label, (kernel, fn) in calls.items():
        per_call = None
        if counted is not None:
            counted[kernel] = 0
            fn()
            per_call = counted[kernel]
        shapes.append({"shape": label, "ms": time_ms(fn, reps=20), "launches_per_call": per_call})
    emit({"phase": "kernels", "shapes": shapes})

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
    emit({"phase": "chunk", "ms": times, "fused_ingest_launches_per_call": per_call,
          "chunk_peak_device_bytes": torch.cuda.max_memory_allocated(dev),
          "fused_ingest_takes": "hoisted draws" if hoisted else "the stream key"})

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
