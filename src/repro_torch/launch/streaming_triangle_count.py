"""TriangleCountEngine end to end (``examples/streaming_triangle_count.py``):
a long-lived multi-tenant counter with a mid-stream kill and a bit-exact
resume, driven through the engine API (no CLI).

  python -m repro_torch.launch.streaming_triangle_count            # on the card
  python -m repro_torch.launch.streaming_triangle_count --device cpu

Three phases over one Barabasi-Albert stream and a bank of three tenants:
half the stream, checkpointed every 2 batches; a fresh engine that resumes
from the checkpoint and finishes; an uninterrupted engine whose estimates
must equal the resumed one's (an assert). It prints the example's lines;
only the phase-1 seconds (``in X.XXs``) differ from the reference's. The
checkpoint directory is emptied first.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.sequential import count_triangles
from repro_torch.data.graph_stream import barabasi_albert_stream, batches
from repro_torch.engine import EngineConfig, TriangleCountEngine, run_stream

CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_stream_demo_ckpt")


def run(n: int = 20_000, k: int = 8, graph_seed: int = 0, r: int = 200_000,
        batch_size: int = 8192, seeds: tuple = (0, 1, 2), ckpt_dir: str = CKPT,
        device="cuda", echo=print) -> dict:
    """The example end to end on ``device``; returns the stream's length
    and ``tau``, phase 1's report, phase 2's ``resumed_from`` and batch
    count, the per-tenant estimates of the resumed and the uninterrupted
    run, and every printed line."""
    dev = resolve_device(device)
    lines = []

    def say(text: str) -> None:
        lines.append(text)
        echo(text)

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    edges = barabasi_albert_stream(n, k, seed=graph_seed)
    tau = count_triangles(edges)
    say(f"stream: m={len(edges)} tau={tau}")

    # Three tenants over one stream = three accuracy tiers (seed replicas) in
    # one bank; tenant 0 is bit-identical to a standalone run.
    cfg = EngineConfig(r=r, batch_size=batch_size, n_tenants=len(seeds), seeds=tuple(seeds),
                       device=str(dev))

    say("\n=== phase 1: ingest half the stream, checkpointing every 2 batches ===")
    engine = TriangleCountEngine(cfg)
    it = list(batches(edges, cfg.batch_size))
    rep = run_stream(engine, it[: len(it) // 2], ckpt_dir=ckpt_dir, ckpt_every=2)
    say(f"ingested {rep.edges} edges in {rep.seconds:.2f}s; "
        f"rolling estimates: {np.round(engine.estimate(), 1)}")

    say("\n=== phase 2: 'crash' — a fresh engine resumes from the checkpoint "
        "and finishes the stream ===")
    engine2 = TriangleCountEngine(cfg)
    rep2 = run_stream(engine2, it, ckpt_dir=ckpt_dir, ckpt_every=2)
    say(f"resumed at batch {rep2.resumed_from}, ingested {rep2.batches} more")

    ests = engine2.estimate()
    for t, e in enumerate(ests):
        say(f"tenant {t}: estimate={e:.1f} rel.err={abs(e-tau)/tau:.3%}")

    say("\n=== determinism check: an uninterrupted run matches the resumed one "
        "bit-for-bit (counter-based RNG) ===")
    engine3 = TriangleCountEngine(cfg)
    run_stream(engine3, it)
    uninterrupted = engine3.estimate()
    assert np.array_equal(uninterrupted, ests), "resume is not deterministic!"
    say("OK: resumed estimates == uninterrupted estimates")
    return {"edges": len(edges), "tau": tau, "phase1": rep, "resumed_from": rep2.resumed_from,
            "resumed_batches": rep2.batches, "estimates": ests,
            "uninterrupted": uninterrupted, "lines": lines}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=CKPT, help="emptied first")
    args = ap.parse_args(argv)
    run(ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
