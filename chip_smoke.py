#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold each CUDA
kernel to its plain PyTorch version.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises on failure (nothing is caught):

  card       the GPU's name and power limit, as nvidia-smi prints them;
  build      nvcc builds the five kernels from csrc/, in parallel;
  edges      each kernel against its plain version on the edge cases of the
             JAX package's oracle harness (tile sizes +-1, n = 0, q = 0,
             all-equal, duplicate-heavy, negative and INF64 keys; for both
             segscan monoids (sum, max) n around the 8192-entry tile, 2^23 + 3
             entries with no flag (the longest look-back), values at INT32_MIN
             and INT32_MAX, segments that cross tiles and an unaligned view;
             for the tile sort tiles below, at and 1-5
             merge passes above its 4096-entry block, ragged n, sorted and
             reversed input; for multisearch n below, at and above its
             8192-key sample, equal runs longer than the sample spacing,
             queries below, above and equal to every key and INT64 max; for
             the deletion path's shapes: 2^20 keys that are INT64 max but
             for 700,000 (a ragged expiry batch) or one (one edge expired),
             negative queries (unset slots) and 3r queries against n = 1;
             for segment_sum dropped ids, every row in one bin, n = 0, m = 0,
             d = 1 and 2, and 9,000,001 rows, past what its resident grid
             holds in registers, with every id out of range, all in one bin,
             d = 2 and an unaligned view; for fused_ingest, which draws its
             own randomness, stream lengths above 2^32 and at 0, the fold-in
             counter across its 32-bit wrap, empty batches, r off its
             512-estimator tile, and 2s and s below, at and above its
             1024-key samples; and at an estimator offset e0, a shard's,
             one tenant and a bank of 2, whose shards concatenate to one
             full-r call, and e0 near the top of the 32-bit counter), equal
             under each kernel's contract;
  golden     the kernel path on a small chunked stream with a ragged tail
             reproduces the JAX reference's final-state sha256 and estimate
             (src/repro_torch/golden/stream_small.json, written by JAX);
  golden_local  the same stream under the local scheme (4 pools) on the
             kernel path reproduces JAX's state sha256, per-vertex estimate
             sha256 and sum/3 (golden/local_small.json);
  naive      the naive scheme (no kernel) on three batches reproduces JAX's
             state sha256 (golden/naive_small.json);
  golden_dynamic  three dynamic runs on the kernel route reproduce JAX's
             state and window-ring sha256, estimate (or estimate sha256 and
             sum/3) and counters (golden/dynamic_small.json): global under
             churn through run_signed_stream, global with a sliding window
             chunked at K = 4, local with exponential decay;
  golden_serve  the LM serving path (models/transformer.py) for each of the
             five SMOKE archs in float32 with TF32 off, seed 0's weights
             drawn on the card: forward and teacher-forced decode_step
             logits within 1e-4 of the largest |logit| of the JAX
             reference's (golden/lm_small.json, every 4th vocab column),
             equal argmax, and the CLI decoding loop's greedy tokens equal;
  golden_train  the LM training path (train/steps.py, autograd through
             lm_loss) for each SMOKE arch in float32 with TF32 off, seed 0's
             weights drawn on the card: the step-0 loss within 1e-5
             relative, each leaf's gradient norm and every 4th column of
             the embedding's gradient within 1e-4, and 3 steps of the
             arch's optimizer within 1e-4 of the JAX reference's records
             (golden/train_small.json);
  golden_gnn  the GNN, equivariant and recsys families (models/gnn.py,
             equivariant.py, bert4rec.py, train/steps.py) for each SMOKE
             arch in float32 with TF32 off, seed 0's weights drawn on the
             card: gat-cora on two smoke shapes, graphcast with remat on a
             sample_khop batch, egnn and mace: the forward within 1e-5 of
             the largest |output|, the step-0 loss within 1e-5 relative,
             each leaf's gradient norm within 1e-4 relative and 3 adamw
             steps' losses within 1e-4 relative of the JAX reference's
             records (golden/gnn_small.json); bert4rec's cloze mask and
             negatives bit for bit, its loss, gradient norms and 3 steps
             likewise, score_candidates of both shapes within 1e-5 of the
             largest |score|; sample_khop's arrays equal;
  full       the paper's bulk_s1m_r2m shape (r = 2^21 estimators, batch
             s = 2^20, chunk K = 4) through TriangleCountEngine + run_stream on
             a 9,088,608-edge planted-triangle stream: two chunks, then a
             ragged batch of 700,000 edges as a one-batch chunk. It checks
             that every kernel of the chunk route was launched and
             multisearch_counts never was, that the state is bit-identical
             to the plain path (scan ingest, torch.searchsorted), that a
             snapshot after chunk 1 restored into a fresh engine finishes
             with the same state, that the second chunk on the kernel route
             draws no randomness outside fused_ingest (the host's draws
             patched to raise) and equals the plain route, and that
             rel.err <= 5%; it also times a
             second run of the stream in a fresh engine, and the default
             batch validation on the host;
  local_full the same stream under the local scheme (8 pools, 2^22
             vertices) through TriangleCountEngine + run_stream: per-batch
             ingest (multisearch_counts) and the per-vertex estimate
             (segment_sum). It checks that both kernels were launched, that
             the estimate equals the plain path's exactly, that a snapshot
             after chunk 1 restored into a fresh engine and a checkpointed
             run cut after chunk 1 and resumed both finish equal, and that
             sum/3 is within 5% of tau; it prints l1.err against the
             planted truth without gating on it;
  dynamic_full  the full shape on dynamic streams, global scheme: (a) a
             sliding window of 6,291,456 edges through run_stream on the
             same stream (2,097,152 edges expire after chunk 2 and 700,000
             after the tail: 3 deletion batches), and (b) one deletion burst
             of 1,048,576 of the first 8,388,608 edges, then the tail, through
             engine.ingest_signed_stream. Each checks that the kernel route
             equals the plain route, that multisearch_counts was launched on
             the deletion path, and rel.err against the live triangles
             (counted from the planted construction) within a limit
             reckoned from this run's numbers; (a) also a snapshot after
             chunk 1 restored and run on, (b) a run_signed_stream
             checkpoint cut right after the burst and resumed. It records
             edges/s, peak device bytes and one full-width
             bulk_delete_update: its time back to back (CUDA events), its
             device busy time (torch.profiler) and its host enqueue time;
             and the host seconds of the window clock: ring appends, flushes,
             and of the flushes, enqueueing their deletion batches;
  chaos_full  the resilience layer at the full width on phase full's
             stream, global scheme, kernel route, each run under a fault
             plan and held to a state sha256 an earlier phase held to the
             plain route: (a) one transient raise at engine.stage_chunk,
             engine.ingest_chunk, the tail's engine.ingest and prefetch.get,
             and a prefetch.get redelivery, ridden out with retries (1 ms
             base): phase full's state, and the retries, duplicates and
             fired counts the plan reckons; (b) checkpoint.write torn at save
             #1 (after chunk 2) and a fatal raise at the tail's ingest: the
             loop dies at step 8 with the torn staging dir leaked, a fresh
             engine resumes from save #0 (step 4) and ends in phase full's
             state; (c) report_every 1 under backpressure depth 1, with a
             query answered before the stream and a 0.5 s delay before the
             first chunk's ingest, so the report after chunk 1 is served
             stale from the cache: every stale answer equals the fresh one of
             its step, the state phase full's; (d) dynamic_full's deletion
             burst through run_signed_stream under a transient engine.ingest
             raise and a redelivery: that burst's state, multisearch_counts
             launched on the deletion batch. Each run's host seconds and
             edges/s are recorded beside phase full's, with the card, and
             the host us of a check_fault with no plan installed and of a
             with_retries around a call that does not fail;
  tenants_full  a bank of 4 tenants at the full width through the same
             engine: (a) global over four distinct streams, the planted
             stream under four seed-drawn vertex relabelings (the identity
             for tenant 0, so tau = 262,144 each), chunked with the ragged
             tail per batch: tenant t's state equals a one-tenant engine
             seeded 7 + t on stream t, tenant 0 phase full's; (b) local (8
             pools, 2^22 vertices) on the broadcast stream: tenant 0 equals
             phase local_full, every tenant's estimate its own one-tenant
             scatter; (c) dynamic_full's deletion burst, broadcast, through
             ingest_signed_stream: tenant 0 equals that burst; (d)
             dynamic_full's window of 6,291,456 edges over (a)'s four
             streams, one ring per tenant: equal to the plain route (state
             and rings), tenant t to a one-tenant windowed engine seeded
             7 + t, tenant 0 to dynamic_full (a), with the window clock's
             host seconds. Every tenant's
             rel.err is gated (rel_err_limit; sum/3 for local). It records
             aggregate edges/s, peak device bytes, and a bank chunk's and a
             bank per-batch update's time, device busy time and device
             operations beside one tenant's;
  plans_full  the sharded plans at the same width on one-process meshes
             of 4 shards, all on this card (host_devices=4), kernel route:
             (a) pjit_independent and pjit_coordinated on estimators=4,
             batch by batch, each ending in phase full's state; (b) shardmap
             on estimators=4 at capacity factor 2.0: no overflow, equal to
             its plain route, rel.err within 5%, the device-resident query
             equal to the gather oracle; (c) banked_pjit_coordinated on
             tenants=2,estimators=2 over tenants_full's four streams,
             chunked (fused_ingest at e0 = r/2 on two shards): each tenant
             equals tenants_full (a); (d) local on banked_pjit_independent
             over tenants=4: the per-vertex device query equals the oracle
             and tenants_full (b); (e) (c)'s snapshot after chunk 1 restored
             into single and tenants=4 engines, each run on to (c)'s end;
             (f) the device query's fallbacks under a fault and a timeout.
             It records host seconds, edges/s, peak bytes, an update's
             device-busy ms and shardmap's routing-copy share, and the
             kernels-line row of fused_ingest on (c)'s shard at e0 = r/2
             beside its time at e0 = 0;
  elastic_full  the elastic serving tier at the same width, kernel route:
             (a) the churn drill: an ElasticBankEngine of capacity 4 on
             single behind an ElasticServeLoop (stall policy, depth 64),
             eight sessions seeded 7-14 on tenants_full's four streams
             (session i on stream i mod 4), a rolling query every 4 batches,
             session 0 snapshotted, evicted and restored after batch 4
             through a CheckpointManager, one engine.ingest_chunk raise
             retried: sessions 0-3 end in tenants_full (a)'s states, 4-7 in
             one-tenant engines seeded 11-14, every rel.err within 5%, and
             after the tier's warm-up no kernel library built or loaded and
             no tier built; (b) a fifth tenant into the full bank: capacity
             8, exactly one new tier, the residents unchanged; (c) the
             per-batch route with a tenant joining three batches late; (d)
             banked_pjit_coordinated on tenants=2,estimators=2 (4 shards),
             capacity 2; (e) a local tenant whose per-vertex estimate is
             phase local_full's. (c)-(e) each equal the earlier phase. It
             records host seconds, aggregate edges/s, the queries' latency,
             peak bytes, a chunk dispatch's time and device busy ms beside
             tenants_full's, the grow's seconds, a snapshot_tenant's ms and
             the allocator segments the churn created;
  serve_full  the LM serving path at full width, bfloat16, through the
             serving CLI's entry point (launch.serve.serve): batch 4, prompt
             8, 16 generated tokens. smollm-135m FULL twice: finite logits,
             equal tokens, every decode step's logits within 3e-2 of the
             largest |logit| of forward's over the same sequence (the KV
             cache at full width), and the decode loop once more under
             CUDA's sync debug mode, counting host waits; then
             granite-moe-1b-a400m FULL twice: equal tokens, finite logits.
             It records tok/s, decode seconds, one step's device busy time,
             the params' bytes and each decode loop's peak bytes beyond
             what was already held. No kernel of csrc/ is on this path;
  train_full  the LM training path at full width, bfloat16, through the
             training CLI's functions at its defaults (batch 8, seq 256,
             adamw 3e-4): smollm-135m FULL for 30 steps with asynchronous
             checkpoints every 10 (the logged loss falls); a run cut at step
             15 by a failure that outlasts its retries and resumed from the
             step-10 checkpoint, equal bit for bit (deterministic algorithms
             on) to a run loaded from that checkpoint over the same batches;
             granite-moe-1b-a400m FULL for 5 steps (finite losses). It
             records ms a step, tokens/s, a step's device busy ms and
             operations, peak bytes, the params' and optimizer state's
             bytes and MFU (6 N tokens over the step's seconds at 989e12
             FLOP/s). No kernel of csrc/ is on this path;
  train_elastic  phase full's state after its two chunks resized by
             train.elastic.shrink_or_grow_estimators to 2^20 and 2^22 (the
             prefix kept, the appended rows empty), each then ingesting the
             ragged tail and one more chunk on the kernel route, equal to
             the plain route; the state resharded onto estimators=4 on this
             card, read back unchanged, and one pjit update equal to the
             same update unsharded;
  gnn_features  examples/gnn_features.py at its own size
             (launch/gnn_features.py): a 1,500-vertex Barabasi-Albert
             stream into 50,000 estimators in batches of 2,048 on the
             per-batch kernel route (multisearch_counts, the tile sort and
             segscan each launched, counted from 0 around the run), then 60
             adamw steps of a GAT on the streamed density: triangles/edge
             equal to the reference's exactly, the step-0 loss within 1e-5
             relative, and from the reference's params at steps 0, 20, 40
             and 59 each step's loss within 1e-5 relative and gradient norms
             within 1e-4 (free-running trajectories part by chaos, so their
             losses are recorded, not gated); the loss falls;
  examples   the reference's last three examples at their own sizes, through
             the port's entry points as a user calls them: launch/quickstart.py
             (3,000-vertex Barabasi-Albert stream, 100,000 estimators, batches
             of 4,096, one tenant on the per-batch kernel route, through
             repro_torch.core's package-level API) prints the golden line of
             examples/quickstart.py exactly; launch/streaming_triangle_count.py
             (a bank of 3 under run_stream at chunk size 1, 200,000 estimators,
             batches of 8,192: half the stream checkpointed every 2 batches, a
             fresh engine that resumes and finishes, an uninterrupted run whose
             estimates must equal the resumed one's) prints the golden lines of
             examples/streaming_triangle_count.py but for the seconds; in the
             first multisearch_counts, the tile sort and segscan each
             launched, in the second (lone batches as one-batch chunks)
             fused_ingest, the tile sort and both scans (counted from 0
             around the run); python -m
             repro_torch.launch.train_lm --steps 20 --ckpt-every 10 on a fresh
             --ckpt-dir (smollm-135m FULL, bfloat16, the step count cut) prints
             examples/train_lm.py's arch= line and a first logged loss within
             3e-2 of its (golden/examples_small.json, written by JAX);
  gnn_full   the families at full width, float32, adamw at 1e-3: gat-cora
             FULL on full_graph_sm (20 steps, the loss falls), graphcast
             FULL (16 layers, d 512, remat) on 5 minibatch_lg batches that
             sample_khop draws from a uniform graph of ogbn-products' size
             (2,449,029 vertices, 61,859,140 edges; the CSR build and each
             sample timed on the host), egnn and mace FULL on molecule (20
             steps each; in float64 the energy within 1e-4 relative under a
             translation, and for egnn under a rotation too, with the
             coordinates moved alike; mace's move under a rotation is
             recorded: ROADMAP C.6), bert4rec FULL (a cloze step at batch
             4,096, serve_p99, retrieval_cand; a (C,) and a (B, C)
             candidate set of the same ids within 1e-5 of the largest
             |score|), all finite; each records ms a step, device busy ms
             over device operations, peak bytes beyond what was held and
             the params' bytes. No kernel of csrc/ is on these models;
  cells      the cell builders (configs/cells.py) and the roofline
             (roofline/): (a) all 40 FULL cells built as meta tensors with
             torch.cuda.memory_allocated() unchanged, one line each with its
             params', optimizer state's and arguments' bytes and model_flops;
             (b) the reference's 32 smoke cases (tests/test_archs_smoke.py)
             one step each on the card, arguments from seed 42
             (roofline.count.materialize): finite, shapes kept, params moved
             where the step trains; (c) five cells at full width (CELL_RUNS,
             two of them batch-cut to fit one card): each warmed up by a
             step that roofline/count.py counts (FlopCounterMode flops, the
             bytes of every aten op's operands and results, memory), timed
             over 3 more steps by CUDA events, one more step's device busy
             time over its operations (the device traced alone; gat-cora's
             also read from the raw events and from the event list of one
             profile, which must agree), its roofline terms on
             the H100's constants and its ms over their lower bound, and
             its temp_bytes (the CUDA allocator's peak less the new
             outputs) beside the live-storage counter's (count.LiveBytes)
             on a meta trace of the same shapes, within 10% of it on the
             two LM cells, and decode_32k's meta counts (the peak among
             them) given exactly by the dry run's layer fit from 2, 3 and
             4 layers (a train step is not fitted); their records written to
             build/roofline/ and rendered by roofline.tables.table. No
             kernel of csrc/ is on these steps;
  dryrun     python -m repro_torch.launch.dryrun on the card's host with no
             GPU visible to it, six runs at once: gat-cora molecule on the
             pod (256 ranks) and multipod (512) meshes, bert4rec serve_p99,
             smollm-135m prefill_32k (its counts fitted from traces at 2, 3
             and 4 layers), and the stream shapes bulk_s1m_r2m
             (coordinated_xla) and coord_s1m_r2m (shardmap) on pod; each
             record ok, with its mesh's chips, positive model flops, bytes,
             argument bytes and temp_bytes, positive counted flops on a
             model cell, the LM cell fitted and its model_flops the cell
             builder's, wire bytes exactly where a plan's calls or a rule
             gave a collective, and each stream plan's own calls (pjit's one
             all_gather; shardmap's 14 all_to_alls and one psum); the pod
             records rendered by python -m repro_torch.roofline.tables. No
             kernel of csrc/ is on this path;
  kernels    each kernel and its plain version at the main path's full-size
             shapes: equal, and timed with CUDA events beside its bound and,
             where one PyTorch call computes the same function, that call;
             the tile sort at both of its shapes (arc and edge tiles),
             multisearch at all three (Q1, Q2, step 3), and in a row of its
             own at the deletion shape (3r queries into the 2^20 keys of
             the tail's expiry batch; its membership le > lt also equal to
             kernels.ref.delete_hits_ref), and segscan at all
             three (sum over K x 2s and over 2s, max over K x s, each beside
             an unsegmented torch.cumsum); segment_sum beside index_add_ on
             pre-filtered rows and over every row; for every kernel and
             shape the CUDA launches of one wrapper call, as its C entry
             reports them; then where one chunk's device time goes on the
             kernel route (structure build, fused_ingest), the plain
             route's chunk and its hoisted draws, and the ragged tail
             batch's time; and the structure build and the tail's
             per-batch update stage by stage (CUDA events between stages,
             each replica held equal to the function it writes out); then
             each kernel's bank form at T = 4 (fused_ingest over the bank's
             chunk with a (T,) step0, the tile sort over T·K tiles, segscan
             over T·K segments, multisearch_counts over T rows of Q1, a
             row-strided view, segment_sum over the local bank): equal to
             its plain version and to T one-tenant calls bit for bit, with
             the CUDA launches of one one-tenant call, and timed beside T
             times the one-tenant call;
  cli        python -m repro_torch.launch.stream prints the golden CLI lines
             (global and local), and under the golden --fault-plan the JAX
             CLI's estimate:, resilience: and fault plan installed: lines
             and --diag-json blocks (golden/resilience_small.json), and for a
             bank of 4 on --mesh tenants=2,estimators=2 --host-devices 4 the
             JAX CLI's mesh: and estimate[tenant t] lines
             (golden/plans_small.json); python -m
             repro_torch.launch.stream_serve prints the JAX serving CLI's
             rolling query lines and, under --elastic with a fault plan, its
             session, snapshot-drill and served lines
             (golden/serve_small.json); python -m repro_torch.launch.train
             --smoke --steps 3 --batch 2 --seq 16 on a fresh --ckpt-dir
             prints the JAX CLI's arch= line and a first logged loss within
             3e-2 of its (golden/train_small.json).

Tolerance: exact. Every kernel computes integer or bit-defined results
(segment_sum sums integer-valued float64 below 2^53, where any order of its
atomic adds gives the same sums), so each is held to its plain version with
max |diff| = 0 (the tile sort under its split contract: keys bit-equal,
payloads equal as a multiset per tile).

The line before last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Exits nonzero without a CUDA device or without
the repository around it.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet), at the full 700 W power limit; the HBM
# rate and the bfloat16 peak are repro_torch.roofline.report's HBM_BW and
# PEAK_FLOPS, read where they are used (the package is imported only once
# main() has found the checkout)
# no integer row in the data sheet: the 32-bit rate outside the tensor cores
# (67 T/s for float32) is taken for 32-bit integer operations, and an int64
# comparison or add counts as two of them
INT32_OPS_PER_S = 67e12
# FP64 outside the tensor cores (NVIDIA data sheet, H100 SXM)
FP64_OPS_PER_S = 34e12
FULL = {"r": 2**21, "s": 2**20, "K": 4, "edges": 9_088_608, "triangles": 262_144,
        "vertices": 2**22, "seed": 7, "groups": 9, "pools": 8, "tenants": 4}
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "fused_ingest": ("src/repro_torch/csrc/fused_ingest.cu",
                     "src/repro/kernels/fused_ingest.py:67"),
    "bitonic_sort_tiles": ("src/repro_torch/csrc/bitonic.cu",
                           "src/repro/kernels/bitonic.py:45"),
    "segscan": ("src/repro_torch/csrc/segscan.cu", "src/repro/kernels/segscan.py:41"),
    "multisearch_counts": ("src/repro_torch/csrc/multisearch.cu",
                           "src/repro/kernels/multisearch.py:28"),
    "segment_sum": ("src/repro_torch/csrc/segment_sum.cu",
                    "src/repro/kernels/segment_sum.py:25"),
}
INF64 = np.iinfo(np.int64).max
# the rel.err limit of the full-size global estimate and of the local
# scheme's sum/3 (the reckoning is in phase_full)
REL_ERR_LIMIT = 0.05


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches, by CUDA
    events around the whole run, after ``warmup`` untimed calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back calls
    with the host's cost kept out: every call is enqueued while the device
    spins (``torch.cuda._sleep``) for longer than the host takes to enqueue
    them, so the events around the calls time the device alone. A kernel
    of tens of microseconds costs its wrapper about as much host time, and
    ``time_ms`` then times the host. Raises if the enqueue outlasted the
    spin (a call that waits on the device, or a full launch queue)."""
    import torch

    for _ in range(warmup):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(1_000_000)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / ev[0].elapsed_time(ev[1])
    for _ in range(3):
        torch.cuda.synchronize()
        ev[0].record()
        torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms + 1)))
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ev[2].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
    raise AssertionError(f"device_ms: enqueueing {reps} calls took {host_ms:.3f} ms, "
                         "longer than the device's spin")


def profiled(fn, host: bool = True):
    """One call of ``fn`` under torch.profiler, with the host's operations
    recorded too where ``host`` (the device's own operations are traced
    either way)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def device_ops(prof) -> dict:
    """name -> (count, device us) of the device's operations in a profile,
    from the profiler's raw events: ``prof.events()`` builds the same
    events into a tree first, which takes minutes for a step of ~300,000
    operations (``busy_readings`` holds the two readings together)."""
    import torch

    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_hidden_event():
            n, us = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    return by_name


def busy_summary(by_name: dict, top: int) -> dict:
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"device_busy_ms": sum(us for _, us in by_name.values()) / 1e3,
            "device_ops": sum(n for n, _ in by_name.values()),
            "top": [[name[:90], n, us / 1e3] for name, (n, us) in ranked[:top]]}


def device_busy(fn, top: int = 8, warmup: bool = True, host: bool = True) -> dict:
    """One call of ``fn`` under torch.profiler (after one unprofiled call
    where ``warmup``): the device's busy milliseconds (the sum of its
    kernels' and memory operations' device time), the count of those
    operations, and the ``top`` device operations by their summed time
    (name cut to 90 characters, count, ms). The profiler slows the host, so
    the call's own time comes from ``time_ms``, not from here."""
    import torch

    if warmup:
        fn()
        torch.cuda.synchronize()
    return busy_summary(device_ops(profiled(fn, host)), top)


def busy_readings(fn) -> dict:
    """One profile of ``fn`` (``device_busy``'s) read two ways: from the raw
    events (``device_ops``) and from the profiler's event list
    (``prof.events()``, each device event's ``time_range``); raises unless
    they find the same operations and the same busy time to 1 us."""
    import torch

    prof = profiled(fn)
    raw = busy_summary(device_ops(prof), 0)
    listed: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = listed.get(e.name, (0, 0.0))
            listed[e.name] = (n + 1, us + e.time_range.elapsed_us())
    tree = busy_summary(listed, 0)
    if (raw["device_ops"] != tree["device_ops"]
            or abs(raw["device_busy_ms"] - tree["device_busy_ms"]) > 1e-3):
        raise AssertionError(f"busy_readings: raw events {raw} != event list {tree}")
    return {"raw_events": raw, "event_list": tree}


def stage_ms(run, reps: int = 5, warmup: int = 1) -> dict:
    """Mean device milliseconds of each stage of ``run(mark)``, which calls
    ``mark(name)`` at the end of each stage: a CUDA event is recorded there,
    and a stage's time is the time from the previous event to its own.
    Where the device is slower than the host issues its work (the structure
    build), that is the device's time; where the host is slower (the
    per-batch update, about 1,900 small ops), the device waits on it and the
    stages read the host's pace: ``device_busy`` tells the two apart."""
    import torch

    for _ in range(warmup):
        run(lambda name: None)
    totals: dict = {}
    for _ in range(reps):
        marks = []

        def mark(name, marks=marks):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        start = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        run(mark)
        torch.cuda.synchronize()
        prev = start
        for name, ev in marks:
            totals[name] = totals.get(name, 0.0) + prev.elapsed_time(ev)
            prev = ev
    return {name: t / reps for name, t in totals.items()}


def structure_stages(Ws, n_valids, mark):
    """``core.rank._rank_all_chunk_kernels`` written out op by op, with
    ``mark`` after each stage, in the checkout's own kernels: the stability
    patch runs ``segmented_max_scan`` where the checkout has it, else the
    plain ``segmented_cummax`` split into its cumsum, its packing and its
    cummax. Returns the RankStructure, which the caller holds against
    ``rank_all_chunk``."""
    import torch

    from repro_torch.core.rank import INF64 as PAD
    from repro_torch.core.rank import RankStructure, _inf_where, _next_pow2
    from repro_torch.kernels import segscan as kseg
    from repro_torch.kernels.bitonic import bitonic_sort_tiles
    from repro_torch.primitives.segscan import segment_starts
    from repro_torch.primitives.sort import pack2

    K, s, _ = Ws.shape
    dev = Ws.device
    pos1 = torch.arange(s, dtype=torch.int32, device=dev)
    nv = n_valids.to(torch.int64)[:, None]
    valid_e = pos1[None, :] < nv
    src = torch.cat([Ws[:, :, 0], Ws[:, :, 1]], dim=1)
    dst = torch.cat([Ws[:, :, 1], Ws[:, :, 0]], dim=1)
    pos2 = torch.cat([pos1, pos1])
    valid_a = torch.cat([valid_e, valid_e], dim=1)
    kd = _inf_where(valid_a, pack2(src, (s - 1) - pos2[None, :]))
    mark("arc_keys")
    tile = _next_pow2(2 * s)
    kd_p = torch.full((K, tile), PAD, dtype=torch.int64, device=dev)
    kd_p[:, : 2 * s] = kd
    arc_p = torch.zeros((K, tile), dtype=torch.int32, device=dev)
    arc_p[:, : 2 * s] = torch.arange(2 * s, dtype=torch.int32, device=dev)
    mark("arc_padding")
    ks, perm = bitonic_sort_tiles(kd_p.view(-1), arc_p.view(-1), tile)
    mark("arc_tile_sort")
    kd_s = ks.view(K, tile)[:, : 2 * s]
    perm = perm.view(K, tile)[:, : 2 * s].to(torch.int64)
    src_s = torch.gather(src, 1, perm)
    dst_s = torch.gather(dst, 1, perm)
    pos_s = torch.gather(pos2[None, :].expand(K, 2 * s), 1, perm)
    mark("arc_gathers")
    starts = segment_starts(src_s)
    mark("segment_starts")
    ones = torch.ones(K * 2 * s, dtype=torch.int32, device=dev)
    rank_s = kseg.segscan(ones, starts.reshape(-1)).view(K, 2 * s) - 1
    mark("segscan")
    arc = torch.arange(2 * s, device=dev)[None, :]
    kr = _inf_where(arc < 2 * nv, pack2(src_s, rank_s))
    mark("key_rank")
    emin = torch.minimum(Ws[:, :, 0], Ws[:, :, 1])
    emax = torch.maximum(Ws[:, :, 0], Ws[:, :, 1])
    ek = _inf_where(valid_e, pack2(emin, emax))
    tile_e = _next_pow2(s)
    ek_p = torch.full((K, tile_e), PAD, dtype=torch.int64, device=dev)
    ek_p[:, :s] = ek
    ep_p = torch.zeros((K, tile_e), dtype=torch.int32, device=dev)
    ep_p[:, :s] = pos1
    mark("edge_keys_and_padding")
    eks, eps = bitonic_sort_tiles(ek_p.view(-1), ep_p.view(-1), tile_e)
    mark("edge_tile_sort")
    ek_s = eks.view(K, tile_e)[:, :s]
    epos_s = eps.view(K, tile_e)[:, :s].contiguous()
    estarts = segment_starts(ek_s)
    mark("edge_starts")
    if hasattr(kseg, "segmented_max_scan"):
        epos_s = kseg.segmented_max_scan(epos_s.reshape(-1), estarts.reshape(-1)).view(K, s)
        mark("stability_max_scan")
    else:  # primitives.segscan.segmented_cummax, stage by stage
        seg = torch.cumsum(estarts.reshape(-1).to(torch.int64), dim=-1)
        mark("stability_cumsum")
        packed = (seg << 32) | (epos_s.reshape(-1).to(torch.int64) + 2**31)
        mark("stability_pack")
        top = torch.cummax(packed, dim=-1).values
        mark("stability_cummax")
        epos_s = ((top & 0xFFFFFFFF) - 2**31).to(torch.int32).view(K, s)
        mark("stability_unpack")
    out = RankStructure(kd_s.contiguous(), kr, src_s, dst_s, pos_s, rank_s,
                        ek_s.contiguous(), epos_s)
    mark("outputs")
    return out


def per_batch_stages(state, W, n_valid, key, mark):
    """``core.bulk.bulk_update_all`` on the kernel searches written out
    stage by stage, with ``mark`` after each: step 1 with its draw,
    ``rank_all`` on the kernels (the chunk route's structure build, one
    batch's tiles, which ``structure_stages`` splits further; in a checkout
    before that, a ``torch.sort`` build), step 2 with its draws, and step 3.
    Returns the new state, which the caller holds against
    ``bulk_update_all``."""
    import inspect

    from repro_torch import rng as trng
    from repro_torch.core import rank as trank
    from repro_torch.core.bulk import step1_level1, step2_level2, step3_closing
    from repro_torch.core.state import EstimatorState

    k = trng.split(key)
    f1, chi_m, f2, has_f3, f1_bpos = step1_level1(state, W, n_valid, k[0])
    mark("step1_level1")
    kernels = "use_kernels" in inspect.signature(trank.rank_all).parameters
    R = trank.rank_all(W, n_valid, **({"use_kernels": True} if kernels else {}))
    mark("rank_all")
    f2, chi, has_f3, f2_bpos = step2_level2(f1, chi_m, f2, has_f3, f1_bpos, R, k[1], "kernel")
    mark("step2_level2")
    has_f3 = step3_closing(f1, f2, has_f3, f2_bpos, R, "kernel")
    mark("step3_closing")
    return EstimatorState(f1, chi, f2, has_f3, state.m_seen + n_valid)


def tail_batch(edges, dev):
    """The stream's ragged tail after its two chunks, padded to one batch
    of s edges, and its edge count."""
    import torch

    s, K = FULL["s"], FULL["K"]
    tail = edges[2 * K * s:]
    W = torch.zeros((s, 2), dtype=torch.int32, device=dev)
    W[: len(tail)] = torch.from_numpy(tail).to(dev)
    return W, len(tail)


def build_splits(state, Ws, nv, W_tail, n_tail, key) -> dict:
    """The step-0 splits: the kernel route's structure build and one
    per-batch update (the ragged tail) stage by stage, each replica held
    against the function it writes out, and the per-batch update's draws
    timed alone (step 1's int64 randint; step 2's uniform and int32
    randint, at the state's r)."""
    import torch

    from repro_torch import rng as trng
    from repro_torch.core.bulk import bulk_update_all
    from repro_torch.core.rank import rank_all_chunk

    got = structure_stages(Ws, nv, lambda name: None)
    want = rank_all_chunk(Ws, nv, use_kernels=True)
    for f in want._fields:
        require_equal(f"structure split {f}", getattr(got, f), getattr(want, f))
    got = per_batch_stages(state, W_tail, n_tail, key, lambda name: None)
    want = bulk_update_all(state, W_tail, n_tail, key, "kernel")
    for f in want._fields:
        require_equal(f"per-batch split {f}", getattr(got, f), getattr(want, f))
    r = state.r
    k = trng.split(key)
    k2 = trng.split(k[1])
    total = state.m_seen + n_tail
    maxval = torch.clamp(state.chi, min=1).to(torch.int32)
    return {
        "structure_build_stages_ms": stage_ms(lambda mark: structure_stages(Ws, nv, mark)),
        "per_batch_stages_ms": stage_ms(
            lambda mark: per_batch_stages(state, W_tail, n_tail, key, mark), reps=3),
        "per_batch_draws_alone_ms": {
            "step1_randint64": time_ms(lambda: trng.randint64(k[0], torch.clamp(total, min=1),
                                                              (r,)), reps=3),
            "step2_uniform": time_ms(lambda: trng.uniform(k2[0], (r,)), reps=3),
            "step2_randint32": time_ms(lambda: trng.randint32(k2[1], maxval, (r,)), reps=3)},
    }


def bound(nbytes: float, ops: float, ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    from repro_torch.roofline.report import HBM_BW

    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs(a, b) -> float:
    import torch

    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def require_equal(name: str, got, want) -> None:
    import torch

    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel and plain version disagree "
                             f"(max |diff| {max_abs(got, want) if got.shape == want.shape else 'shape'})")


# ---------------------------------------------------------------------------
# the split contract of the tile sort
# ---------------------------------------------------------------------------
def check_tile_sort(name, keys, vals, tile, got, want) -> float:
    """Keys bit-equal; (key, payload) pairs equal as a multiset per tile over
    keys below the INT64 max sentinel. Returns the max |diff| of the keys."""
    import torch

    gk, gv = got
    wk, wv = want
    require_equal(f"{name} keys", gk, wk)
    n = keys.numel()
    tid = torch.arange(n, device=keys.device) // tile
    real = gk != INF64

    def canon(k, v):
        k, v, t = k[real], v[real], tid[real]
        o = torch.argsort(v, stable=True)
        o = o[torch.argsort(k[o], stable=True)]
        o = o[torch.argsort(t[o], stable=True)]
        return k[o], v[o]

    ck, cv = canon(gk, gv)
    ek, ev = canon(wk, wv)
    require_equal(f"{name} pairs", cv, ev)
    return max_abs(gk, wk)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    line = smi.splitlines()[0]
    print(line, flush=True)
    name, limit = (x.strip() for x in line.split(",", 1))
    emit({"phase": "card", "name": name, "power_limit": limit})
    return line


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    logs = {}
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        logs[name] = [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln] if log.exists() else []
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": seconds, "ptxas": logs})


def key_families(n: int, seed: int) -> dict:
    """The adversarial key families of the JAX package's oracle harness, and
    negative keys (-1, as pack2 makes for empty slots)."""
    rng = np.random.default_rng(seed)
    fams = {
        "random": rng.integers(0, max(4 * n, 4), n),
        "duplicate_heavy": rng.integers(0, max(n // 8, 2), n),
        "all_equal": np.full(n, 7),
        "inf_sentinels": np.where(rng.random(n) < 0.25, INF64, rng.integers(0, max(n, 2), n)),
        "negative": np.where(rng.random(n) < 0.5, -1, rng.integers(-3, max(n, 2), n)),
    }
    return {k: v.astype(np.int64) for k, v in fams.items()}


def sort_families(n: int, seed: int) -> dict:
    """The key families, and input already sorted and reversed."""
    return {**key_families(n, seed), "sorted": np.arange(n, dtype=np.int64),
            "reversed": np.arange(n, 0, -1, dtype=np.int64)}


def search_queries(keys: np.ndarray, q: int, seed: int) -> np.ndarray:
    """q queries: random ones around the keys, then (as far as q reaches,
    from the end) the first and last keys below INT64 max, one below every
    key, one above them, 0 and INT64 max."""
    n = len(keys)
    g = np.random.default_rng(seed)
    lo = int(keys[0]) if n else 0
    hi = int(keys[keys < INF64].max()) if (keys < INF64).any() else 0
    edge = [lo, hi, lo - 1, hi + 1, 0, INF64]
    return np.concatenate([g.integers(-5, max(4 * n, 8), max(q - len(edge), 0)),
                           edge])[-q:].astype(np.int64) if q else np.zeros(0, np.int64)


def fused_chunk(g, s: int, K: int, dev, empty=()):
    """K batches of s edges over a small vertex set (heavy duplicates), with
    a self-loop and a duplicate edge in one batch, ragged batch sizes (the
    first full) and the batches in ``empty`` holding no valid edge."""
    import torch

    Ws = g.integers(0, max(3 * s // 2, 4), size=(K, s, 2)).astype(np.int32)
    Ws[0, 0] = [1, 1]  # self-loop
    if K > 1:
        Ws[1, 1] = Ws[1, 0]  # duplicate edge in one batch
    nv = g.integers(1, s + 1, size=K).astype(np.int32)
    nv[0] = s
    nv[list(empty)] = 0
    return torch.from_numpy(Ws).to(dev), torch.from_numpy(nv).to(dev)


def phase_edges(dev) -> None:
    import torch

    from repro_torch import rng as trng
    from repro_torch.core.bulk import bulk_update_chunk, chunk_structures
    from repro_torch.core.state import init_state
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitonic import bitonic_sort_tiles
    from repro_torch.kernels.fused_ingest import fused_ingest, fused_ingest_plain
    from repro_torch.kernels.multisearch import multisearch_counts
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.kernels.segscan import segmented_max_scan, segscan

    cases = 0
    # multisearch: n below, at and above the shared-memory sample (8192
    # keys), n not a power of two, and equal runs (duplicate_heavy, all_equal,
    # the long runs) longer than the sample spacing
    for n, q in itertools.chain(
            itertools.product((0, 1, 255, 256, 257, 4097), (0, 1, 33, 257)),
            itertools.product((8191, 8192, 8193, 3 * 8192 + 5, 100_003), (7, 5000))):
        fams = key_families(n, n + q)
        fams["long_runs"] = np.random.default_rng(n).integers(0, 40, n) * 1000
        for fam, keys in fams.items():
            keys = np.sort(keys)
            k = torch.from_numpy(keys).to(dev)
            qt = torch.from_numpy(search_queries(keys, q, q + n)).to(dev)
            lt, le = multisearch_counts(k, qt)
            elt, ele = ref.multisearch_counts_ref(k, qt)
            require_equal(f"multisearch lt n={n} q={q} {fam}", lt, elt)
            require_equal(f"multisearch le n={n} q={q} {fam}", le, ele)
            cases += 1
    # the deletion path's shapes: a batch's 2^20 sorted keys, INT64 max but
    # for 700,000 real ones (the tail's expiry batch) or for one (one edge
    # expired; also with no real key), against 3r-sized query vectors with
    # negative queries (unset slots pack to -1, or to -2^32 + x); and q = 3r
    # against n = 1
    g = np.random.default_rng(16)
    s, q3 = 2**20, 3 * 2**21
    for n_real in (700_000, 1, 0):
        keys = np.full(s, INF64, np.int64)
        keys[:n_real] = np.sort(g.integers(0, 2**40, n_real))
        qs = np.concatenate([g.choice(keys[:max(n_real, 1)], q3 // 3),
                             g.integers(-2**33, 2**40, q3 // 3),
                             np.where(g.random(q3 // 3) < 0.5, -1, INF64)])
        k, qt = torch.from_numpy(keys).to(dev), torch.from_numpy(qs.astype(np.int64)).to(dev)
        lt, le = multisearch_counts(k, qt)
        elt, ele = ref.multisearch_counts_ref(k, qt)
        require_equal(f"multisearch deletion keys n_real={n_real} lt", lt, elt)
        require_equal(f"multisearch deletion keys n_real={n_real} le", le, ele)
        cases += 1
    for key in (-1, 0, 5, INF64):
        k = torch.tensor([key], dtype=torch.int64, device=dev)
        qt = torch.from_numpy(np.concatenate([g.integers(-10, 10, q3 - 3), [-1, key, INF64]])
                              .astype(np.int64)).to(dev)
        lt, le = multisearch_counts(k, qt)
        elt, ele = ref.multisearch_counts_ref(k, qt)
        require_equal(f"multisearch n=1 key={key} lt", lt, elt)
        require_equal(f"multisearch n=1 key={key} le", le, ele)
        cases += 1
    # both monoids of the segscan kernel: n around its 8192-entry tile, and
    # 2^23 + 3 entries with no flag (the longest look-back chains); small
    # values, and values at INT32_MIN / INT32_MAX (sums that wrap); a view
    # off 16-byte alignment takes the kernel's scalar loads
    i32 = np.iinfo(np.int32)
    for n in (0, 1, 8191, 8192, 8193, 3 * 8192 + 5, 100_003, 2**23 + 3):
        g = np.random.default_rng(n)
        values = {"small": g.integers(-5, 7, n),
                  "extremes": g.choice([i32.min, i32.max, i32.min + 1, -1, 0, 1, 2**30], n)}
        for (vname, v), (fam, f) in itertools.product(values.items(), {
                "random": g.random(n) < 0.2, "cross_tile": g.random(n) < 0.0005,
                "no_flags": np.zeros(n, bool), "all_flags": np.ones(n, bool)}.items()):
            vt = torch.from_numpy(v.astype(np.int32)).to(dev)
            ft = torch.from_numpy(f).to(dev)
            cuts = ((vt, ft), (vt[1:], ft[1:])) if n == 100_003 else ((vt, ft),)
            for a, b in cuts:
                require_equal(f"segscan n={a.numel()} {vname} {fam}", segscan(a, b),
                              ref.segscan_ref(a, b))
                require_equal(f"segmented_max_scan n={a.numel()} {vname} {fam}",
                              segmented_max_scan(a, b), ref.segmented_max_scan_ref(a, b))
                cases += 2
    # the tile sort: tiles below its block (4096 entries), many to a block;
    # at the block; and 1, 2, 3 and 5 merge passes above it; ragged n
    for tile, sizes in ((1, (3, 9000)), (2, (5, 20_001)), (16, (15, 16, 17, 3 * 8192 + 16)),
                        (64, (50_000,)), (2048, (2048, 3 * 2048 + 1)),
                        (4096, (4095, 4096, 4097, 5 * 4096)),
                        (8192, (8191, 8192, 8193, 3 * 8192)), (16384, (16384, 3 * 16384 - 7)),
                        (32768, (2 * 32768 + 1,)), (2**17, (2**17, 2 * 2**17 + 3))):
        for n in sizes:
            for fam, keys in sort_families(n, tile + n).items():
                kt = torch.from_numpy(keys).to(dev)
                vt = torch.arange(n, dtype=torch.int32, device=dev)
                check_tile_sort(f"bitonic tile={tile} n={n} {fam}", kt, vt, tile,
                                bitonic_sort_tiles(kt, vt, tile),
                                ref.bitonic_sort_tiles_ref(kt, vt, tile))
                cases += 1
    for r, s, K, seed in ((33, 6, 3, 4), (1000, 64, 4, 5), (4099, 300, 2, 6)):
        g = np.random.default_rng(seed)
        Wt, nvt = fused_chunk(g, s, K, dev)
        key = trng.PRNGKey(seed, dev)
        want = ref.fused_ingest_ref(init_state(r, dev), Wt, nvt, key, 3)
        got = bulk_update_chunk(init_state(r, dev), Wt, nvt, key, 3, backend="kernel")
        for f in want._fields:
            require_equal(f"fused chunk r={r} s={s} K={K} {f}", getattr(got, f), getattr(want, f))
        cases += 1
    # fused_ingest against its plain version on a populated state: stream
    # lengths above 2^32 (64-bit spans) and at 0 (a first batch with
    # totals = 0), the fold-in counter across its 32-bit wrap, empty
    # batches, r off the CTA's 512-estimator tile, and 2s (key_desc,
    # key_rank) and s (ekey) below, at and above the 1024-key samples
    for r, s, K, m_seen, step0, empty in (
            (513, 511, 4, 2**32 + 17, 2**32 - 2, (1,)), (511, 512, 3, 0, 0, (0,)),
            (1537, 513, 2, 2**40, 7, ()), (5000, 1023, 2, 123_456, 2**32 - 1, ()),
            (4097, 1024, 3, 2**31 - 9, 5, (2,)), (1025, 1025, 2, 3, 2**33, ()),
            (2**16 + 3, 20_000, 4, 2**33, 0, (1, 3))):
        g = np.random.default_rng(r + s)
        key = trng.PRNGKey(s, dev)
        warm = bulk_update_chunk(init_state(r, dev), *fused_chunk(g, s, 2, dev), key,
                                 backend="kernel")
        st = init_state(r, dev) if m_seen == 0 else warm._replace(
            m_seen=torch.tensor(m_seen, dtype=torch.int64, device=dev))
        Wt, nvt = fused_chunk(g, s, K, dev, empty)
        args = (st.f1, st.chi, st.f2, st.has_f3, *chunk_structures(Wt, nvt, use_kernels=True),
                Wt, nvt, st.m_seen, key, step0)
        for f, a, b in zip(("f1", "chi", "f2", "has_f3"), fused_ingest(*args),
                           fused_ingest_plain(*args)):
            require_equal(f"fused_ingest r={r} s={s} K={K} m_seen={m_seen} step0={step0} {f}", a, b)
        cases += 1
    # fused_ingest at an estimator offset e0 (a shard of a sharded plan):
    # shards off the 512-estimator tile, one tenant and a bank of 2, equal to
    # the plain version and, concatenated, to one full-r call; and offsets
    # near the top of the 32-bit counter
    for r, s, K, bounds, T in ((1537, 513, 2, (0, 1, 512, 1025, 1537), None),
                               (5000, 1023, 3, (0, 2500, 4999, 5000), None),
                               (2**16 + 3, 20_000, 2, (0, 3, 2**15, 2**16 + 3), 2)):
        g = np.random.default_rng(r)
        key = trng.PRNGKey(r, dev)
        Wt, nvt = fused_chunk(g, s, K, dev, (1,) if K > 2 else ())
        st = bulk_update_chunk(init_state(r, dev), *fused_chunk(g, s, 2, dev), key,
                               backend="kernel")
        if T is not None:  # a bank: tenant 1 another state, keys and first step
            st2 = bulk_update_chunk(init_state(r, dev), *fused_chunk(g, s, 2, dev),
                                    trng.PRNGKey(r + 1, dev), backend="kernel")
            st = type(st)(*(torch.stack([a, b]) for a, b in zip(st, st2)))
            Wt, nvt = torch.stack([Wt, Wt.flip(1)]), torch.stack([nvt, nvt.flip(0)])
            key = torch.stack([key, trng.PRNGKey(r + 2, dev)])
            step0 = torch.tensor([5, 2**32 - 1], dtype=torch.int64, device=dev)
        else:
            step0 = 9
        structs = chunk_structures(Wt, nvt, use_kernels=True)
        lead = () if T is None else (slice(None),)
        whole = fused_ingest(*st[:4], *structs, Wt, nvt, st.m_seen, key, step0)
        for lo, hi in zip(bounds, bounds[1:]):
            part = [x[lead + (slice(lo, hi),)].contiguous() for x in st[:4]]
            a_s = (*part, *structs, Wt, nvt, st.m_seen, key, step0, lo)
            for f, a, b, w in zip(("f1", "chi", "f2", "has_f3"), fused_ingest(*a_s),
                                  fused_ingest_plain(*a_s), whole):
                require_equal(f"fused_ingest r={r} T={T} e0={lo} {f}", a, b)
                require_equal(f"fused_ingest r={r} T={T} e0={lo} {f}: the full-r call's rows",
                              a, w[lead + (slice(lo, hi),)])
            cases += 1
    for e0 in (2**31 - 7, 2**32 - 1537):
        g = np.random.default_rng(e0 % 1000)
        st = bulk_update_chunk(init_state(1537, dev), *fused_chunk(g, 513, 2, dev),
                               trng.PRNGKey(3, dev), backend="kernel")
        Wt, nvt = fused_chunk(g, 513, 3, dev)
        a_s = (*st[:4], *chunk_structures(Wt, nvt, use_kernels=True), Wt, nvt, st.m_seen,
               trng.PRNGKey(4, dev), 2**32 - 2, e0)
        for f, a, b in zip(("f1", "chi", "f2", "has_f3"), fused_ingest(*a_s),
                           fused_ingest_plain(*a_s)):
            require_equal(f"fused_ingest e0={e0} {f}", a, b)
        cases += 1
    # segment_sum: integer-valued float64, so atomics in any order are exact
    for n, m, d in itertools.product((0, 1, 255, 256, 257, 4097, 100_003), (0, 1, 31, 1000),
                                     (1, 2)):
        g = np.random.default_rng(n + m + d)
        v = torch.from_numpy(g.integers(-3, 9, (n, d)).astype(np.float64)).to(dev)
        for fam, ids in {"random": g.integers(0, max(m, 1), n),
                         "with_dropped": g.integers(-2, max(m, 1) + 3, n),
                         "all_one_segment": np.zeros(n, np.int64)}.items():
            it = torch.from_numpy(ids.astype(np.int32)).to(dev)
            require_equal(f"segment_sum n={n} m={m} d={d} {fam}", segment_sum(v, it, m),
                          ref.segment_sum_ref(v, it, m))
            cases += 1
    # segment_sum past what its resident grid holds in registers (about 4.3M
    # ids): ids in range, every id out of range, every row in one bin, d = 2,
    # and views off 16-byte alignment (the ids read again after the barrier)
    n, m = 9_000_001, 2**22
    g = np.random.default_rng(n)
    for fam, ids, d in (("random", g.integers(-1, m, n), 1), ("all_dropped", np.full(n, m), 1),
                        ("all_one_segment", np.zeros(n, np.int64), 1),
                        ("random", g.integers(-1, 1000, n), 2)):
        v = torch.from_numpy(g.integers(-3, 9, (n, d)).astype(np.float64)).to(dev)
        it = torch.from_numpy(ids.astype(np.int32)).to(dev)
        mm = m if d == 1 else 1000
        for a, b in ((v, it), (v[1:], it[1:])):
            require_equal(f"segment_sum n={b.numel()} m={mm} d={d} {fam}", segment_sum(a, b, mm),
                          ref.segment_sum_ref(a, b, mm))
            cases += 1
    torch.cuda.synchronize()
    emit({"phase": "edges", "cases": cases, "ok": True})


def phase_golden(dev) -> None:
    from repro_torch.data.graph_stream import batches, planted_triangle_stream
    from repro_torch.engine import EngineConfig, TriangleCountEngine, run_stream
    from repro_torch.interop import state_sha256

    gold = json.loads((ROOT / "src/repro_torch/golden/stream_small.json").read_text())
    st, en = gold["stream"], gold["engine"]
    edges, _ = planted_triangle_stream(st["triangles"], st["noise_edges"], st["vertices"],
                                       seed=st["seed"])
    eng = TriangleCountEngine(EngineConfig(
        r=en["r"], batch_size=en["batch_size"], chunk_size=en["chunk_size"],
        groups=en["groups"], seeds=(en["seed"],), device=dev.type, ingest="kernel",
        multisearch="kernel"))
    run_stream(eng, batches(edges, en["batch_size"]))
    digest = state_sha256(eng.snapshot())
    est = float(eng.estimate()[0])
    if digest != gold["state_sha256"] or eng.step != gold["step"]:
        raise AssertionError(f"golden: state sha256 {digest} != JAX {gold['state_sha256']}")
    if abs(est - gold["estimate"]) > 1e-12 * abs(gold["estimate"]):
        raise AssertionError(f"golden: estimate {est!r} != JAX {gold['estimate']!r}")
    emit({"phase": "golden", "state_sha256": digest, "estimate": est, "ok": True})


def phase_golden_local(dev) -> None:
    from repro_torch.data.graph_stream import batches, planted_triangle_stream
    from repro_torch.engine import EngineConfig, TriangleCountEngine, run_stream
    from repro_torch.interop import estimate_sha256, state_sha256

    gold = json.loads((ROOT / "src/repro_torch/golden/local_small.json").read_text())
    st, en = gold["stream"], gold["engine"]
    edges, _ = planted_triangle_stream(st["triangles"], st["noise_edges"], st["vertices"],
                                       seed=st["seed"])
    eng = TriangleCountEngine(EngineConfig(
        r=en["r"], batch_size=en["batch_size"], chunk_size=en["chunk_size"],
        groups=en["groups"], seeds=(en["seed"],), device=dev.type, ingest="kernel",
        multisearch="kernel", scheme="local", scheme_params=gold["scheme_params"]))
    run_stream(eng, batches(edges, en["batch_size"]))
    est = eng.estimate()[0]
    got = {"step": eng.step, "state_sha256": state_sha256(eng.snapshot()),
           "estimate_sha256": estimate_sha256(est), "sum3": float(est.sum()) / 3}
    for k, v in got.items():
        if v != gold[k]:
            raise AssertionError(f"golden_local: {k} {v!r} != JAX {gold[k]!r}")
    emit({"phase": "golden_local", **got, "ok": True})


def phase_naive(dev) -> None:
    from repro_torch.data.graph_stream import batches, planted_triangle_stream
    from repro_torch.engine import EngineConfig, TriangleCountEngine, run_stream
    from repro_torch.interop import state_sha256

    gold = json.loads((ROOT / "src/repro_torch/golden/naive_small.json").read_text())
    st, en = gold["stream"], gold["engine"]
    edges, _ = planted_triangle_stream(st["triangles"], st["noise_edges"], st["vertices"],
                                       seed=st["seed"])
    eng = TriangleCountEngine(EngineConfig(
        r=en["r"], batch_size=en["batch_size"], chunk_size=en["chunk_size"],
        groups=en["groups"], seeds=(en["seed"],), device=dev.type, scheme="naive"))
    run_stream(eng, batches(edges[: gold["edges"]], en["batch_size"]))
    digest, est = state_sha256(eng.snapshot()), float(eng.estimate()[0])
    if digest != gold["state_sha256"] or eng.step != gold["step"] or est != gold["estimate"]:
        raise AssertionError(f"naive: state sha256 {digest} != JAX {gold['state_sha256']}")
    emit({"phase": "naive", "state_sha256": digest, "estimate": est, "ok": True})


def phase_golden_dynamic(dev) -> None:
    """The three dynamic golden runs on the kernel route, held to the JAX
    engine's records (the global estimate to 1e-12 relative, as phase
    golden holds it; everything else exactly)."""
    from repro_torch.data.graph_stream import (
        batches,
        churn_stream,
        planted_triangle_stream,
        signed_batches,
    )
    from repro_torch.engine import EngineConfig, TriangleCountEngine, run_signed_stream, run_stream
    from repro_torch.interop import estimate_sha256, state_sha256, window_sha256

    gold = json.loads((ROOT / "src/repro_torch/golden/dynamic_small.json").read_text())
    st, en = gold["stream"], gold["engine"]
    edges, _ = planted_triangle_stream(st["triangles"], st["noise_edges"], st["vertices"],
                                       seed=st["seed"])
    s = en["batch_size"]
    out = {}
    for name, run in gold["runs"].items():
        eng = TriangleCountEngine(EngineConfig(
            r=en["r"], batch_size=s, chunk_size=run["chunk_size"], groups=en["groups"],
            seeds=(en["seed"],), device=dev.type, ingest="kernel", multisearch="kernel",
            scheme=run["scheme"],
            scheme_params=gold["scheme_params_local"] if run["scheme"] == "local" else None,
            window=run.get("window", 0), decay=run.get("decay", 0.0)))
        if run.get("deletions"):
            stream = churn_stream(edges[: run["edges"]], run["deletions"], seed=run["churn_seed"])
            run_signed_stream(eng, signed_batches(stream, s))
        else:
            run_stream(eng, batches(edges, s))
        snap = eng.snapshot()
        est = eng.estimate()[0]
        got = {"step": eng.step, "dyn_step": eng.dyn_step, "state_sha256": state_sha256(snap),
               "delete_batches": eng.diag.delete_batches,
               "window_expired": eng.diag.window_expired}
        if "window_sha256" in run:
            got["window_sha256"] = window_sha256(snap)
        if run["scheme"] == "local":
            got.update(estimate_sha256=estimate_sha256(est), sum3=float(est.sum()) / 3)
        for k, v in got.items():
            if v != run[k]:
                raise AssertionError(f"golden_dynamic {name}: {k} {v!r} != JAX {run[k]!r}")
        if "estimate" in run:
            got["estimate"] = float(est)
            if abs(got["estimate"] - run["estimate"]) > 1e-12 * abs(run["estimate"]):
                raise AssertionError(f"golden_dynamic {name}: estimate {got['estimate']!r} "
                                     f"!= JAX {run['estimate']!r}")
        out[name] = got
    emit({"phase": "golden_dynamic", "runs": out, "ok": True})


def planted_full(seed: int):
    """262,144 disjoint triangles plus distinct bipartite noise edges on 2^22
    vertices, shuffled (vectorised; the same construction as
    graph_stream.planted_triangle_stream, so tau = 262,144 exactly)."""
    g = np.random.default_rng(seed)
    T, V, m = FULL["triangles"], FULL["vertices"], FULL["edges"]
    a = np.arange(T, dtype=np.int64) * 3
    tri = np.stack([np.stack([a, a + 1], 1), np.stack([a, a + 2], 1),
                    np.stack([a + 1, a + 2], 1)], 1).reshape(-1, 2)
    base = 3 * T
    half = (V - base) // 2
    need = m - len(tri)
    codes = np.unique(g.integers(0, half * half, size=int(need * 1.05)))
    codes = codes[g.permutation(len(codes))[:need]]
    if len(codes) != need:
        raise RuntimeError("too few distinct noise edges drawn")
    noise = np.stack([base + codes // half, base + half + codes % half], 1)
    edges = np.concatenate([tri, noise]).astype(np.int32)
    return edges[g.permutation(len(edges))], T


def phase_full(dev) -> dict:
    import torch

    from repro_torch.core.state import tenant_state
    from repro_torch.data.graph_stream import batches
    from repro_torch.engine import EngineConfig, TriangleCountEngine, run_stream
    from repro_torch.interop import state_sha256
    from repro_torch.kernels import CUDA_LAUNCHES, LAUNCHES, reset_launches

    edges, tau = planted_full(FULL["seed"])
    s, K = FULL["s"], FULL["K"]

    def engine(ingest, multisearch):
        return TriangleCountEngine(EngineConfig(
            r=FULL["r"], batch_size=s, chunk_size=K, groups=FULL["groups"],
            seeds=(FULL["seed"],), device=dev.type, ingest=ingest, multisearch=multisearch))

    eng = engine("kernel", "kernel")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    rep = run_stream(eng, batches(edges, s))
    launches, cuda_launches = dict(LAUNCHES), dict(CUDA_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    # the same stream again in a fresh engine: a first run that is slow on
    # the host shows apart from a later one
    rep_again = run_stream(engine("kernel", "kernel"), batches(edges, s))
    missing = [k for k in CHUNK_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"full: kernels never launched on the main path: {missing}")
    # the ragged tail goes as a one-batch chunk through fused_ingest: no search
    if launches["multisearch_counts"]:
        raise AssertionError(f"full: the tail searched {launches['multisearch_counts']} times "
                             "(want 0: fused_ingest searches in registers)")
    digest = state_sha256(eng.snapshot())
    est = float(eng.estimate()[0])
    rel = abs(est - tau) / tau
    # Reckoning for the 5% limit: one estimator's coarse estimate has
    # Var <= m * D * tau, with D bounding chi for a tracked triangle, so the
    # mean of r has relative sigma sqrt(m * D / (r * tau)). With D ~ 15 (the
    # noise's degrees) that is sqrt(9.09e6 * 15 / (2^21 * 262144)) ~ 1.6%;
    # for these disjoint triangles chi <= 2, about 0.6%. The median of 8
    # group means widens it a little; 5% is about three of the looser sigmas.
    if rel > REL_ERR_LIMIT:
        raise AssertionError(f"full: rel.err {rel:.4%} > {REL_ERR_LIMIT:.0%}")

    plain = engine("scan", "eager")
    t0 = time.perf_counter()
    run_stream(plain, batches(edges, s))
    plain_s = time.perf_counter() - t0

    # host cost of the default validation, per batch of s edges
    from repro_torch.engine.faults import validate_batch

    t0 = time.perf_counter()
    n_checked = 0
    for W, nv in batches(edges, s):
        if validate_batch(W, nv) is not None:
            raise AssertionError("full: a generated batch failed validation")
        n_checked += 1
    validate_ms = (time.perf_counter() - t0) * 1e3 / n_checked
    if state_sha256(plain.snapshot()) != digest:
        raise AssertionError("full: kernel path state differs from the plain path")

    first = engine("kernel", "kernel")
    run_stream(first, itertools.islice(batches(edges, s), K))
    resumed = engine("kernel", "kernel")
    resumed.restore(first.snapshot())
    run_stream(resumed, batches(edges, s))  # run_stream skips the first engine.step batches
    if state_sha256(resumed.snapshot()) != digest:
        raise AssertionError("full: snapshot after chunk 1 + restore diverged")
    chunk_two_without_host_draws(dev, tenant_state(first.state, 0), edges)

    emit({"phase": "full", "r": FULL["r"], "s": s, "K": K, "m": int(len(edges)),
          "tau": tau, "estimate": est, "rel_err": rel, "edges_per_s": rep.edges_per_s,
          "seconds": rep.seconds, "edges_per_s_second_run": rep_again.edges_per_s,
          "plain_path_seconds": plain_s, "peak_device_bytes": peak, "launches": launches,
          "cuda_launches": cuda_launches, "state_sha256": digest,
          "plain_path_equal": True, "restore_equal": True,
          "validate_ms_per_batch": validate_ms, "kernel_route_without_host_draws_equal": True})
    return {"launches": launches, "state": tenant_state(eng.state, 0), "edges": edges, "tau": tau,
            "digest": digest, "edges_per_s": rep.edges_per_s}


def chunk_two_without_host_draws(dev, state, edges) -> None:
    """The stream's second chunk on the kernel route while every way to draw
    randomness outside the kernel raises (the hoisted draws, the int64
    randint and the threefry block that all of rng.py's draws go through),
    then on the plain route (hoisted draws and selects, plain searches):
    the two states must be equal."""
    import torch

    from repro_torch import rng as trng
    from repro_torch.core import bulk

    s, K = FULL["s"], FULL["K"]
    Ws = torch.from_numpy(edges[K * s: 2 * K * s].reshape(K, s, 2)).to(dev)
    nv = torch.full((K,), s, dtype=torch.int32, device=dev)
    key = trng.PRNGKey(FULL["seed"], dev)

    def refuse(name):
        def raise_(*args, **kwargs):
            raise AssertionError(f"full: the kernel route called {name} outside fused_ingest")
        return raise_

    saved = (bulk._chunk_randomness, trng.randint64, trng.threefry2x32)
    bulk._chunk_randomness = refuse("_chunk_randomness")
    trng.randint64 = refuse("rng.randint64")
    trng.threefry2x32 = refuse("rng.threefry2x32")
    try:
        got = bulk.bulk_update_chunk(state, Ws, nv, key, K, backend="kernel")
        torch.cuda.synchronize(dev)
    finally:
        bulk._chunk_randomness, trng.randint64, trng.threefry2x32 = saved
    want = bulk.bulk_update_chunk(state, Ws, nv, key, K, backend="fused")
    for f in want._fields:
        require_equal(f"full: chunk 2 without host draws, {f}", getattr(got, f), getattr(want, f))


def phase_local_full(dev, full: dict) -> dict:
    import torch

    from repro_torch.core.state import tenant_state
    from repro_torch.data.graph_stream import batches
    from repro_torch.engine import EngineConfig, TriangleCountEngine, run_stream
    from repro_torch.interop import state_sha256
    from repro_torch.kernels import CUDA_LAUNCHES, LAUNCHES, reset_launches

    edges, tau = full["edges"], full["tau"]
    s, K, V = FULL["s"], FULL["K"], FULL["vertices"]
    params = {"n_vertices": V, "n_pools": FULL["pools"]}

    def engine(ingest, multisearch):
        return TriangleCountEngine(EngineConfig(
            r=FULL["r"], batch_size=s, chunk_size=K, groups=FULL["groups"],
            seeds=(FULL["seed"],), device=dev.type, ingest=ingest, multisearch=multisearch,
            scheme="local", scheme_params=params))

    eng = engine("kernel", "kernel")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    rep = run_stream(eng, batches(edges, s))
    t0 = time.perf_counter()
    est = eng.estimate()[0]
    estimate_s = time.perf_counter() - t0
    launches, cuda_launches = dict(LAUNCHES), dict(CUDA_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    missing = [k for k in ("segscan", "multisearch_counts", "segment_sum") if launches[k] == 0]
    if missing:
        raise AssertionError(f"local_full: kernels never launched on the local path: {missing}")
    digest = state_sha256(eng.snapshot())
    sum3 = float(est.sum()) / 3
    rel = abs(sum3 - tau) / tau
    # the planted triangles are disjoint on vertices 0 .. 3 tau - 1: each of
    # those is in exactly one triangle, every other vertex in none
    truth = np.zeros(V, np.int64)
    truth[: 3 * tau] = 1
    l1 = float(np.abs(est - truth).sum() / truth.sum())
    # sum/3 is the mean of r coarse estimates: the global estimator's mean
    # without the median, so the 5% limit of the full phase holds here too
    if rel > REL_ERR_LIMIT:
        raise AssertionError(f"local_full: sum/3 {sum3} misses tau {tau} by {rel:.4%} > "
                             f"{REL_ERR_LIMIT:.0%}")

    plain = engine("scan", "eager")
    run_stream(plain, batches(edges, s))
    if state_sha256(plain.snapshot()) != digest or not np.array_equal(plain.estimate()[0], est):
        raise AssertionError("local_full: kernel path estimate differs from the plain path")

    first = engine("kernel", "kernel")
    run_stream(first, itertools.islice(batches(edges, s), K))
    resumed = engine("kernel", "kernel")
    resumed.restore(first.snapshot())
    run_stream(resumed, batches(edges, s))  # run_stream skips the first engine.step batches
    if state_sha256(resumed.snapshot()) != digest or not np.array_equal(resumed.estimate()[0], est):
        raise AssertionError("local_full: snapshot after chunk 1 + restore diverged")

    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="ckpt_smoke_", dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        run_stream(engine("kernel", "kernel"), itertools.islice(batches(edges, s), K),
                   ckpt_dir=ckpt_dir, ckpt_every=K)
        cut_s = time.perf_counter() - t0
        again = engine("kernel", "kernel")
        rep2 = run_stream(again, batches(edges, s), ckpt_dir=ckpt_dir, ckpt_every=K)
    finally:
        shutil.rmtree(ckpt_dir)
    if rep2.resumed_from != K or state_sha256(again.snapshot()) != digest \
            or not np.array_equal(again.estimate()[0], est):
        raise AssertionError("local_full: checkpointed run cut after chunk 1 and resumed diverged")

    emit({"phase": "local_full", "r": FULL["r"], "s": s, "K": K, "pools": FULL["pools"],
          "n_vertices": V, "m": int(len(edges)), "tau": tau, "sum3": sum3, "rel_err": rel,
          "l1_err": l1, "edges_per_s": rep.edges_per_s, "seconds": rep.seconds,
          "estimate_seconds": estimate_s, "ckpt_cut_run_seconds": cut_s,
          "peak_device_bytes": peak, "launches": launches, "cuda_launches": cuda_launches,
          "state_sha256": digest, "plain_path_equal": True, "restore_equal": True,
          "ckpt_resume_equal": True})
    return {"launches": launches, "state": tenant_state(eng.state, 0), "scheme": eng.scheme,
            "digest": digest, "estimate": est, "edges_per_s": rep.edges_per_s}


def live_triangles(live: np.ndarray, T: int) -> int:
    """The planted triangles whose three edges are all in ``live``: the T
    triangles are disjoint on vertices 0 .. 3T - 1, which no noise edge
    touches, so an edge with both ends below 3T belongs to triangle
    min // 3, and each of its three edges occurs once."""
    lo = np.minimum(live[:, 0], live[:, 1]).astype(np.int64)
    hi = np.maximum(live[:, 0], live[:, 1])
    return int((np.bincount(lo[hi < 3 * T] // 3, minlength=T) == 3).sum())


def rel_err_limit(m: int, tau: int) -> float:
    """The rel.err limit of a dynamic full-size run, reckoned as for phase
    full: one estimator's coarse estimate has Var <= m * D * tau, with m the
    insertion count (deletions leave m_seen alone, and a live triangle is
    tracked with probability 1 / (m * chi) as before) and D ~ 15 bounding chi
    for the noise's degrees, so the mean of r has relative sigma
    sqrt(m * D / (r * tau)); the limit is three of those sigmas (4.8% at
    phase full's tau). Fewer live triangles widen it."""
    return 3 * math.sqrt(m * 15 / (FULL["r"] * tau))


def time_window_clock(eng) -> dict:
    """Host seconds inside ``eng``'s window clock, accumulated as it runs:
    appending each batch to the rings (``track_inserts``), each flush
    (``flush_expired``), and of that, enqueueing its deletion batches
    (``apply_delete``); the flush's own ring work is the difference
    (``flush_ring``, filled in by ``ring_seconds``)."""
    ring_s = {"track_inserts": 0.0, "flush_expired": 0.0, "apply_delete": 0.0}

    def timed(name, fn):
        def call(*args):
            t0 = time.perf_counter()
            fn(*args)
            ring_s[name] += time.perf_counter() - t0
        return call

    for name in ring_s:
        setattr(eng, f"_{name}", timed(name, getattr(eng, f"_{name}")))
    return ring_s


def ring_seconds(ring_s: dict) -> dict:
    return {**ring_s, "flush_ring": ring_s["flush_expired"] - ring_s["apply_delete"]}


def phase_dynamic_full(dev, full: dict) -> dict:
    import torch

    from repro_torch.core.bulk import bulk_delete_update
    from repro_torch.core.state import tenant_state
    from repro_torch.data.graph_stream import batches
    from repro_torch.engine import EngineConfig, TriangleCountEngine, run_signed_stream, run_stream
    from repro_torch.interop import state_sha256, window_sha256
    from repro_torch.kernels import CUDA_LAUNCHES, LAUNCHES, reset_launches

    edges, T = full["edges"], full["tau"]
    s, K, r = FULL["s"], FULL["K"], FULL["r"]
    m, head = len(edges), 2 * FULL["K"] * FULL["s"]
    window, n_tail = 6 * s, m - head

    def engine(ingest, multisearch, **kw):
        return TriangleCountEngine(EngineConfig(
            r=r, batch_size=s, chunk_size=K, groups=FULL["groups"], seeds=(FULL["seed"],),
            device=dev.type, ingest=ingest, multisearch=multisearch, **kw))

    # (a) a sliding window of 6 s edges: nothing expires after chunk 1,
    # 2 s edges after chunk 2 and the tail's 700,000 after it
    eng = engine("kernel", "kernel", window=window)
    ring_s = time_window_clock(eng)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    rep = run_stream(eng, batches(edges, s))
    launches, cuda_launches = dict(LAUNCHES), dict(CUDA_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    n_del = -(-(head - window) // s) + -(-n_tail // s)  # expiry batches of at most s
    # each deletion batch searches once; the tail, a one-batch chunk through
    # fused_ingest, not at all
    if eng.diag.window_expired != m - window or launches["multisearch_counts"] != n_del:
        raise AssertionError(f"dynamic_full: expired {eng.diag.window_expired} edges "
                             f"(want {m - window}), multisearch_counts launched "
                             f"{launches['multisearch_counts']} times (want {n_del})")
    snap = eng.snapshot()
    digest, ring = state_sha256(snap), window_sha256(snap)
    est = float(eng.estimate()[0])
    tau_w = live_triangles(edges[m - window:], T)
    rel_w, limit_w = abs(est - tau_w) / tau_w, rel_err_limit(m, tau_w)
    if rel_w > limit_w:
        raise AssertionError(f"dynamic_full window: rel.err {rel_w:.4%} > {limit_w:.4%}")
    plain = engine("scan", "eager", window=window)
    run_stream(plain, batches(edges, s))
    if (state_sha256(plain.snapshot()), window_sha256(plain.snapshot())) != (digest, ring):
        raise AssertionError("dynamic_full window: kernel route differs from the plain route")
    first = engine("kernel", "kernel", window=window)
    run_stream(first, itertools.islice(batches(edges, s), K))
    resumed = engine("kernel", "kernel", window=window)
    resumed.restore(first.snapshot())
    run_stream(resumed, batches(edges, s))  # skips the first engine.step batches
    if (state_sha256(resumed.snapshot()), window_sha256(resumed.snapshot())) != (digest, ring):
        raise AssertionError("dynamic_full window: snapshot after chunk 1 + restore diverged")
    # one full-width deletion batch: the tail's expiry batch (700,000 real
    # keys, the rest INT64 max) against the final state's 3r queries
    D = torch.zeros((s, 2), dtype=torch.int32, device=dev)
    D[:n_tail] = torch.from_numpy(edges[head - window: m - window]).to(dev)
    state = tenant_state(eng.state, 0)

    def delete_once():
        return bulk_delete_update(state, D, n_tail, "kernel")

    # back to back with CUDA events, the device's busy time of one call
    # (torch.profiler), and the host's time to enqueue one call: the
    # device-spin timing (device_ms) needs the enqueue to outrun the device
    delete_ms = time_ms(delete_once, reps=20)
    delete_profile = device_busy(delete_once)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(20):
        delete_once()
    delete_enqueue_ms = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize(dev)

    # (b) one burst of s deletions drawn from the first 2 K s edges, between
    # the two chunks and the tail
    pick = np.random.default_rng(FULL["seed"] + 1).choice(head, size=s, replace=False)
    items = [(W, nv, 1) for W, nv in batches(edges[:head], s)]
    items += [(edges[pick], s, -1), *((W, nv, 1) for W, nv in batches(edges[head:], s))]
    burst = engine("kernel", "kernel")
    reset_launches()
    t0 = time.perf_counter()
    burst.ingest_signed_stream(iter(items))
    burst.sync()
    burst_s = time.perf_counter() - t0
    burst_launches = dict(LAUNCHES)
    if burst_launches["multisearch_counts"] != 1 or burst.diag.edges_deleted != s:
        raise AssertionError(f"dynamic_full burst: multisearch_counts launched "
                             f"{burst_launches['multisearch_counts']} times (want 1, the "
                             "deletion batch's), "
                             f"{burst.diag.edges_deleted} edges deleted")
    digest_b = state_sha256(burst.snapshot())
    est_b = float(burst.estimate()[0])
    tau_b = live_triangles(np.delete(edges, pick, axis=0), T)
    rel_b, limit_b = abs(est_b - tau_b) / tau_b, rel_err_limit(m, tau_b)
    if rel_b > limit_b:
        raise AssertionError(f"dynamic_full burst: rel.err {rel_b:.4%} > {limit_b:.4%}")
    plain = engine("scan", "eager")
    plain.ingest_signed_stream(iter(items))
    if state_sha256(plain.snapshot()) != digest_b:
        raise AssertionError("dynamic_full burst: kernel route differs from the plain route")
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="ckpt_dynamic_", dir=ROOT / "build")
    cut = 2 * K + 1  # the checkpoint right after the burst
    try:
        run_signed_stream(engine("kernel", "kernel"), iter(items[:cut]), ckpt_dir=ckpt_dir,
                          ckpt_every=cut)
        again = engine("kernel", "kernel")
        rep2 = run_signed_stream(again, iter(items), ckpt_dir=ckpt_dir, ckpt_every=cut)
    finally:
        shutil.rmtree(ckpt_dir)
    if rep2.resumed_from != cut or rep2.batches != len(items) - cut \
            or state_sha256(again.snapshot()) != digest_b:
        raise AssertionError("dynamic_full burst: checkpoint cut after the burst and resumed "
                             "diverged")

    emit({"phase": "dynamic_full", "r": r, "s": s, "K": K, "m": m,
          "window": {"window": window, "expired": eng.diag.window_expired,
                     "deletion_batches": n_del, "tau_live": tau_w, "estimate": est,
                     "rel_err": rel_w, "rel_err_limit": limit_w,
                     "edges_per_s": rep.edges_per_s, "seconds": rep.seconds,
                     "window_clock_host_s": ring_seconds(ring_s), "peak_device_bytes": peak,
                     "launches": launches,
                     "cuda_launches": cuda_launches, "state_sha256": digest,
                     "window_sha256": ring, "plain_path_equal": True, "restore_equal": True},
          "burst": {"deleted": s, "tau_live": tau_b, "estimate": est_b, "rel_err": rel_b,
                    "rel_err_limit": limit_b, "seconds": burst_s,
                    "edges_per_s": (m + s) / burst_s, "launches": burst_launches,
                    "state_sha256": digest_b, "plain_path_equal": True,
                    "ckpt_resume_equal": True},
          "bulk_delete_update_ms": delete_ms, "bulk_delete_update_profile": delete_profile,
          "bulk_delete_update_host_enqueue_ms": delete_enqueue_ms, "ok": True})
    return {"launches": launches, "state": state, "D": D, "n_valid": n_tail, "burst_items": items,
            "burst_digest": digest_b, "burst_tau": tau_b, "burst_s": burst_s,
            "window": window, "window_digest": digest, "window_ring": ring,
            "window_s": rep.seconds, "window_clock_s": ring_seconds(ring_s)}


# the kernels of the chunked path, and of the per-batch path (the ragged
# tail, run_signed_stream's batches)
CHUNK_KERNELS = ("fused_ingest", "bitonic_sort_tiles", "segscan", "segmented_max_scan")
BATCH_KERNELS = ("multisearch_counts", "bitonic_sort_tiles", "segscan")


def loop_threads(before: set) -> list:
    """The prefetch producers and checkpoint writers started since
    ``before`` was taken that are still running."""
    import threading

    return [t for t in threading.enumerate() if t not in before
            and getattr(getattr(t, "_target", None), "__name__", "") in ("_produce",
                                                                       "_write_guarded")]


def reckon(plan) -> dict:
    """What a plan of transient faults must cost, from its specs alone: each
    raise is retried ``times`` times, each redelivery dropped ``times``
    times, and every spec fires ``times`` times (each spec's calls are
    reached on the stream)."""
    retries = sum(s.times for s in plan.specs if s.kind == "raise")
    dups = sum(s.times for s in plan.specs if s.kind == "duplicate")
    fired: dict = {}
    for s in plan.specs:
        fired[s.site] = fired.get(s.site, 0) + s.times
    return {"retries": retries, "duplicate_batches": dups, "fired": fired}


def phase_chaos_full(dev, card: str, full: dict, dynamic: dict) -> None:
    """The resilience layer at the full width (r = 2^21, s = 2^20, K = 4) on
    phase full's stream, global scheme, kernel route, each part held to a
    state sha256 an earlier phase held to the plain route: (a) one transient
    raise at each seam of the chunked path (stage_chunk, ingest_chunk, the
    tail's ingest, the source) and a redelivered item, ridden out; (b) a
    torn checkpoint, then a kill in the tail, then a fresh engine that
    resumes from the same directory; (c) stale answers under backpressure;
    (d) dynamic_full's deletion burst through run_signed_stream under a
    transient raise and a redelivery. Host seconds and edges/s of each run
    are recorded beside phase full's, not gated."""
    import threading

    import torch

    from repro_torch.data.graph_stream import batches
    from repro_torch.engine import (
        EngineConfig,
        FaultInjected,
        ResilienceConfig,
        RetryPolicy,
        TriangleCountEngine,
        fault_plan,
        parse_fault_plan,
        run_signed_stream,
        run_stream,
    )
    from repro_torch.interop import state_sha256
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.train.checkpoint import CheckpointManager

    edges, s, K = full["edges"], FULL["s"], FULL["K"]
    m = len(edges)
    retry = RetryPolicy(max_retries=3, base_s=0.001, seed=FULL["seed"])

    def engine():
        return TriangleCountEngine(EngineConfig(
            r=FULL["r"], batch_size=s, chunk_size=K, groups=FULL["groups"],
            seeds=(FULL["seed"],), device=dev.type, ingest="kernel", multisearch="kernel"))

    def drive(name, spec, fn, kernels=CHUNK_KERNELS, killed=False):
        """``fn()`` under the plan ``spec`` with every count zeroed just
        before and read just after, every kernel of the path launched, and
        the threads the loop started joined (bounded) while the plan is
        installed. With ``killed`` the run must die of the injected fault."""
        plan = parse_fault_plan(spec, seed=FULL["seed"])
        before = set(threading.enumerate())
        torch.cuda.synchronize(dev)
        reset_launches()
        t0 = time.perf_counter()
        out = None
        with fault_plan(plan):
            try:
                out = fn()
            except FaultInjected:  # the kill this run is built to die of
                if not killed:
                    raise
            else:
                if killed:
                    raise AssertionError(f"chaos_full {name}: the fatal fault never fired")
            finally:
                for t in loop_threads(before):
                    t.join(60)
                    if t.is_alive():
                        raise AssertionError(f"chaos_full {name}: {t.name} outlived the run")
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        missing = [k for k in kernels if launches[k] == 0]
        if missing:
            raise AssertionError(f"chaos_full {name}: kernels never launched: {missing}")
        return out, plan, launches, seconds

    def same(name, eng, digest):
        if state_sha256(eng.snapshot()) != digest:
            raise AssertionError(f"chaos_full {name}: the state differs from the unfaulted run's")

    # (a) transient faults at every seam of the chunked path
    spec_a = ("engine.stage_chunk:raise@1,engine.ingest_chunk:raise@0,engine.ingest:raise@0,"
              "prefetch.get:raise@2,prefetch.get:dup@5")
    eng = engine()
    rep_a, plan_a, launches_a, _ = drive("a", spec_a, lambda: run_stream(
        eng, batches(edges, s), resilience=ResilienceConfig(retry=retry)))
    same("a", eng, full["digest"])
    want = reckon(plan_a)
    got = {"retries": rep_a.retries, "duplicate_batches": rep_a.duplicate_batches,
           "fired": plan_a.summary()["fired"]}
    if got != want:
        raise AssertionError(f"chaos_full a: counted {got}, the plan reckons {want}")

    # (b) save #0 after chunk 1 lands, save #1 after chunk 2 is torn, the
    # tail's ingest dies; a fresh engine resumes from the same directory
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="ckpt_chaos_", dir=ROOT / "build")
    try:
        ck = {"ckpt_dir": ckpt_dir, "ckpt_every": K,
              "resilience": ResilienceConfig(retry=retry)}
        killed = engine()
        _, plan_b, launches_b, kill_s = drive(
            "b kill", "checkpoint.write:torn@1,engine.ingest:raise@0x999",
            lambda: run_stream(killed, batches(edges, s), **ck), kernels=CHUNK_KERNELS,
            killed=True)
        torn = sorted(p.name for p in Path(ckpt_dir).glob(".tmp_step_*"))
        if killed.step != 2 * K or len(torn) != 1 or not torn[0].startswith(
                f".tmp_step_{2 * K:010d}_"):
            raise AssertionError(f"chaos_full b: killed at step {killed.step} with staging "
                                 f"dirs {torn}; want step {2 * K} and the torn save's")
        if plan_b.summary()["fired"] != {"checkpoint.write": 1, "engine.ingest": 4}:
            raise AssertionError(f"chaos_full b: fired {plan_b.summary()['fired']}")
        steps = CheckpointManager(ckpt_dir).steps()  # start-up sweep of the torn dir
        resumed = engine()
        rep_b, _, launches_b2, _ = drive(
            "b resume", "", lambda: run_stream(resumed, batches(edges, s), **ck))
    finally:
        shutil.rmtree(ckpt_dir)
    if steps != [K] or rep_b.resumed_from != K or rep_b.batches != len(range(0, m, s)) - K:
        raise AssertionError(f"chaos_full b: checkpoints {steps}, resumed from "
                             f"{rep_b.resumed_from} with {rep_b.batches} batches")
    same("b", resumed, full["digest"])

    # (c) a query before the stream caches the step-0 answer; a delay before
    # the first chunk's ingest lets the producer queue the rest of the
    # stream, so the report after chunk 1 finds a backlog and is served
    # from the cache, aged K; later reports find the queue empty
    eng = engine()
    fresh = {0: eng.estimate().copy()}
    served = []

    def on_report(step, ests, seen, stale_age=0):
        served.append((step, stale_age, ests.copy()))
        if stale_age == 0:
            fresh[step] = ests.copy()

    rep_c, _, launches_c, _ = drive("c", "engine.ingest_chunk:delay@0~0.5", lambda: run_stream(
        eng, batches(edges, s), report_every=1, on_report=on_report,
        resilience=ResilienceConfig(retry=retry, backpressure_depth=1)))
    same("c", eng, full["digest"])
    stale = [(st, age) for st, age, _ in served if age > 0]
    if not stale or rep_c.degraded_queries != len(stale) or \
            rep_c.max_staleness != max(age for _, age in stale):
        raise AssertionError(f"chaos_full c: served {[(st, a) for st, a, _ in served]}, "
                             f"degraded {rep_c.degraded_queries}")
    for st, age, ests in served:
        if age > 0 and not np.array_equal(ests, fresh[st]):
            raise AssertionError(f"chaos_full c: a stale answer for step {st} differs from "
                                 "the fresh one")

    # (d) the deletion burst of dynamic_full (b) through run_signed_stream
    items = dynamic["burst_items"]
    signed = engine()
    rep_d, plan_d, launches_d, _ = drive(
        "d", "engine.ingest:raise@3,prefetch.get:dup@4", lambda: run_signed_stream(
            signed, iter(items), resilience=ResilienceConfig(retry=retry)),
        kernels=BATCH_KERNELS)
    same("d", signed, dynamic["burst_digest"])
    # the inserts go through fused_ingest, one batch a chunk: only the
    # deletion batch searches
    if launches_d["multisearch_counts"] != 1 or signed.diag.edges_deleted != s \
            or (rep_d.retries, rep_d.duplicate_batches) != (1, 1):
        raise AssertionError(f"chaos_full d: multisearch_counts launched "
                             f"{launches_d['multisearch_counts']} times (want 1, "
                             f"the deletion batch's), retries {rep_d.retries}, "
                             f"duplicates {rep_d.duplicate_batches}")

    def timing(rep):
        return {"seconds": rep.seconds, "edges_per_s": rep.edges_per_s}

    # what the fault-free path pays: check_fault with no plan installed, and
    # one with_retries around a call that does not fail, in host us a call
    from repro_torch.engine.faults import active_fault_plan, check_fault, with_retries

    if active_fault_plan() is not None:
        raise AssertionError("chaos_full: a fault plan outlived its run")
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        check_fault("engine.ingest")
    check_us = (time.perf_counter() - t0) * 1e6 / n
    t0 = time.perf_counter()
    for _ in range(n):
        with_retries(retry, int)
    retry_us = (time.perf_counter() - t0) * 1e6 / n

    emit({"phase": "chaos_full", "card": card, "r": FULL["r"], "s": s, "K": K, "m": m,
          "full_edges_per_s": full["edges_per_s"],
          "a": {"plan": spec_a, "retries": rep_a.retries,
                "duplicate_batches": rep_a.duplicate_batches, "fired": got["fired"],
                "launches": launches_a, **timing(rep_a), "state_equal": True},
          "b": {"killed_at_step": 2 * K, "kill_host_s": kill_s, "resumed_from": K,
                "resume_batches": rep_b.batches, "launches_kill": launches_b,
                "launches_resume": launches_b2, **timing(rep_b), "state_equal": True},
          "c": {"degraded_queries": rep_c.degraded_queries, "max_staleness": rep_c.max_staleness,
                "queries": rep_c.queries, "served": [(st, a) for st, a, _ in served],
                "launches": launches_c, **timing(rep_c), "state_equal": True},
          "fault_free_host_us": {"check_fault": check_us, "with_retries": retry_us},
          "d": {"retries": rep_d.retries, "duplicate_batches": rep_d.duplicate_batches,
                "multisearch_counts": launches_d["multisearch_counts"], "launches": launches_d,
                "seconds": rep_d.seconds, "edges_per_s": (m + s) / rep_d.seconds,
                "state_equal": True},
          "ok": True})


def relabeled(edges: np.ndarray, tenant: int) -> np.ndarray:
    """Tenant ``tenant``'s stream: ``edges`` under a vertex relabeling drawn
    from the seed (the identity for tenant 0), an isomorphic graph with the
    same tau and the same edge order."""
    if tenant == 0:
        return edges
    perm = np.random.default_rng(FULL["seed"] + 100 + tenant).permutation(FULL["vertices"])
    return perm.astype(np.int32)[edges]


def bank_batches(streams: list):
    """(W (T, s, 2), n_valid) items of T equally long streams, one batch of
    each per item; the ragged tail's count is the same for every tenant."""
    s, T, m = FULL["s"], len(streams), len(streams[0])
    for lo in range(0, m, s):
        n = min(s, m - lo)
        W = np.zeros((T, s, 2), np.int32)
        for t, e in enumerate(streams):
            W[t, :n] = e[lo:lo + n]
        yield W, n


def phase_tenants_full(dev, full: dict, local: dict, dynamic: dict) -> dict:
    """A bank of T = 4 tenants at the full width (r = 2^21, s = 2^20, K = 4):
    (a) global over four distinct streams, the planted stream under four
    vertex relabelings (the identity for tenant 0), through run_stream:
    tenant t equals a one-tenant engine seeded 7 + t on stream t, tenant 0
    phase full's state; (b) local (8 pools, 2^22 vertices) on the broadcast
    stream: tenant 0 equals phase local_full, every tenant's estimate the
    one-tenant scatter of its own state; (c) the deletion burst of phase
    dynamic_full, broadcast, through ingest_signed_stream: tenant 0 equals
    that phase's burst. Each tenant's rel.err is gated with rel_err_limit.
    Records aggregate edges/s, peak bytes (and what a chunk and its
    structure build allocate beyond the resident state), and a bank chunk's
    and a bank per-batch update's device time and operations beside one
    tenant's."""
    import torch

    from repro_torch import rng as trng
    from repro_torch.core.bulk import bulk_update_all, bulk_update_chunk, chunk_structures
    from repro_torch.core.state import tenant_state
    from repro_torch.data.graph_stream import batches
    from repro_torch.engine import EngineConfig, TriangleCountEngine, run_stream
    from repro_torch.interop import state_sha256, tenant_snapshot, window_sha256
    from repro_torch.kernels import LAUNCHES, reset_launches

    edges, tau = full["edges"], full["tau"]
    s, K, r, T, V = FULL["s"], FULL["K"], FULL["r"], FULL["tenants"], FULL["vertices"]
    m = len(edges)
    seeds = tuple(FULL["seed"] + t for t in range(T))

    def engine(n_tenants, tenant_seeds, ingest="kernel", multisearch="kernel", **kw):
        return TriangleCountEngine(EngineConfig(
            r=r, batch_size=s, chunk_size=K, groups=FULL["groups"], n_tenants=n_tenants,
            seeds=tenant_seeds, device=dev.type, ingest=ingest, multisearch=multisearch, **kw))

    def run(name, kernels, drive):
        """Drive the bank with every count zeroed just before and read just
        after; every kernel of the path must have launched."""
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        out = drive()
        torch.cuda.synchronize(dev)
        launches = dict(LAUNCHES)
        missing = [k for k in kernels if launches[k] == 0]
        if missing:
            raise AssertionError(f"tenants_full {name}: kernels never launched: {missing}")
        return out, launches, torch.cuda.max_memory_allocated(dev)

    def rel_errs(ests, truth):
        errs = [abs(float(e) - truth) / truth for e in ests]
        limit = rel_err_limit(m, truth)
        if max(errs) > limit:
            raise AssertionError(f"tenants_full: rel.err {errs} over the limit {limit:.4%}")
        return errs, limit

    # (a) global over four relabeled streams
    streams = [relabeled(edges, t) for t in range(T)]
    bank = engine(T, seeds)
    rep, launches, peak = run("global", CHUNK_KERNELS,
                              lambda: run_stream(bank, bank_batches(streams)))
    snap = bank.snapshot()
    digests = [state_sha256(tenant_snapshot(snap, t)) for t in range(T)]
    if digests[0] != full["digest"]:
        raise AssertionError("tenants_full global: tenant 0 differs from phase full")
    t0 = time.perf_counter()
    for t in range(1, T):
        one = engine(1, (seeds[t],))
        run_stream(one, batches(streams[t], s))
        if state_sha256(one.snapshot()) != digests[t]:
            raise AssertionError(f"tenants_full global: tenant {t} differs from a one-tenant "
                                 f"engine seeded {seeds[t]} on its stream")
    one_tenant_runs_s = time.perf_counter() - t0
    errs, limit = rel_errs(bank.estimate(), tau)
    # a bank chunk and a bank per-batch update (the ragged tail) beside one
    # tenant's: device time, device busy time and operations
    state = bank.state
    keys = torch.stack([trng.PRNGKey(seed, dev) for seed in seeds])
    Ws = torch.from_numpy(np.stack([e[:K * s].reshape(K, s, 2) for e in streams])).to(dev)
    nv = torch.full((T, K), s, dtype=torch.int32, device=dev)
    head = 2 * K * s
    W_tail = torch.zeros((T, s, 2), dtype=torch.int32, device=dev)
    W_tail[:, : m - head] = torch.from_numpy(np.stack([e[head:] for e in streams])).to(dev)
    n_tail = m - head
    one_state = tenant_state(state, 0)
    bank_chunk = lambda: bulk_update_chunk(state, Ws, nv, keys, 0, backend="kernel")
    one_chunk = lambda: bulk_update_chunk(one_state, Ws[0], nv[0], keys[0], 0, backend="kernel")
    bank_tail = lambda: bulk_update_all(state, W_tail, n_tail, keys, "kernel")
    one_tail = lambda: bulk_update_all(one_state, W_tail[0], n_tail, keys[0], "kernel")
    def extra_peak(fn) -> int:
        """The device bytes ``fn`` allocates at its peak beyond what is
        already allocated (the banks' states, the staged chunks)."""
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize(dev)
        return torch.cuda.max_memory_allocated(dev) - held

    splits = {
        "state_bytes": {"bank": nbytes(*state), "one_tenant": nbytes(*one_state)},
        "chunk_extra_peak_bytes": {"bank": extra_peak(bank_chunk),
                                   "one_tenant": extra_peak(one_chunk)},
        "structure_build_extra_peak_bytes": {
            "bank": extra_peak(lambda: chunk_structures(Ws, nv, use_kernels=True)),
            "one_tenant": extra_peak(lambda: chunk_structures(Ws[0], nv[0], use_kernels=True))},
        "chunk_ms": {"bank": time_ms(bank_chunk, reps=5), "one_tenant": time_ms(one_chunk, reps=5)},
        "chunk_profile": {"bank": device_busy(bank_chunk), "one_tenant": device_busy(one_chunk)},
        "per_batch_ms": {"bank": time_ms(bank_tail, reps=3), "one_tenant": time_ms(one_tail, reps=3)},
        "per_batch_profile": {"bank": device_busy(bank_tail), "one_tenant": device_busy(one_tail)},
    }
    global_out = {"seeds": seeds, "edges_per_s_aggregate": T * m / rep.seconds,
                  "seconds": rep.seconds, "rel_err": errs, "rel_err_limit": limit,
                  "peak_device_bytes": peak, "launches": launches, "state_sha256": digests,
                  "one_tenant_equal": True, "tenant0_equals_phase_full": True,
                  "one_tenant_runs_seconds": one_tenant_runs_s,
                  "one_tenant_edges_per_s_phase_full": full["edges_per_s"], **splits}

    # (b) local on the broadcast stream
    params = {"n_vertices": V, "n_pools": FULL["pools"]}
    lbank = engine(T, seeds, scheme="local", scheme_params=params)

    def drive_local():
        rep = run_stream(lbank, batches(edges, s))
        return rep, lbank.estimate()  # the estimate runs segment_sum

    (rep_l, est_l), launches_l, peak_l = run(
        "local", ("segscan", "multisearch_counts", "segment_sum"), drive_local)
    if state_sha256(tenant_snapshot(lbank.snapshot(), 0)) != local["digest"] or \
            not np.array_equal(est_l[0], local["estimate"]):
        raise AssertionError("tenants_full local: tenant 0 differs from phase local_full")
    for t in range(T):
        alone = lbank.scheme.estimate(tenant_state(lbank.state, t), backend="kernel")
        if not np.array_equal(alone.cpu().numpy(), est_l[t]):
            raise AssertionError(f"tenants_full local: tenant {t}'s bank estimate differs from "
                                 "its one-tenant scatter")
    sum3 = [float(e.sum()) / 3 for e in est_l]
    rel_l = [abs(x - tau) / tau for x in sum3]
    if max(rel_l) > REL_ERR_LIMIT:  # the limit of phase local_full
        raise AssertionError(f"tenants_full local: sum/3 rel.err {rel_l} > {REL_ERR_LIMIT:.0%}")
    local_out = {"edges_per_s_aggregate": T * m / rep_l.seconds, "seconds": rep_l.seconds,
                 "sum3": sum3, "rel_err": rel_l, "peak_device_bytes": peak_l,
                 "launches": launches_l, "tenant0_equals_phase_local_full": True,
                 "one_tenant_edges_per_s_phase_local_full": local["edges_per_s"]}

    # (c) the deletion burst, broadcast
    items = dynamic["burst_items"]
    burst = engine(T, seeds)
    t0 = time.perf_counter()
    _, launches_b, peak_b = run("burst", ("multisearch_counts",), lambda: (
        burst.ingest_signed_stream(iter(items)), burst.sync()))
    burst_s = time.perf_counter() - t0
    if launches_b["multisearch_counts"] != 1 or burst.diag.edges_deleted != s:
        raise AssertionError(f"tenants_full burst: multisearch_counts launched "
                             f"{launches_b['multisearch_counts']} times (want 1, the "
                             "deletion batch's), "
                             f"{burst.diag.edges_deleted} edges deleted")
    if state_sha256(tenant_snapshot(burst.snapshot(), 0)) != dynamic["burst_digest"]:
        raise AssertionError("tenants_full burst: tenant 0 differs from phase dynamic_full")
    errs_b, limit_b = rel_errs(burst.estimate(), dynamic["burst_tau"])
    burst_out = {"seconds": burst_s, "one_tenant_seconds": dynamic["burst_s"],
                 "signed_edges_per_s_aggregate": T * (m + s) / burst_s, "rel_err": errs_b,
                 "rel_err_limit": limit_b, "peak_device_bytes": peak_b, "launches": launches_b,
                 "tenant0_equals_phase_dynamic_full": True}

    # (d) dynamic_full's window of 6 s edges over the four relabeled streams:
    # one ring per tenant, expiry batches of every tenant's next rows
    window = dynamic["window"]
    wbank = engine(T, seeds, window=window)
    ring_s = time_window_clock(wbank)
    rep_w, launches_w, peak_w = run("window", ("fused_ingest", "bitonic_sort_tiles", "segscan",
                                               "segmented_max_scan", "multisearch_counts"),
                                    lambda: run_stream(wbank, bank_batches(streams)))
    snap_w = wbank.snapshot()
    digests_w = [state_sha256(tenant_snapshot(snap_w, t)) for t in range(T)]
    rings_w = [window_sha256(tenant_snapshot(snap_w, t)) for t in range(T)]
    if (digests_w[0], rings_w[0]) != (dynamic["window_digest"], dynamic["window_ring"]):
        raise AssertionError("tenants_full window: tenant 0 differs from phase dynamic_full (a)")
    for t in range(1, T):
        one = engine(1, (seeds[t],), window=window)
        run_stream(one, batches(streams[t], s))
        if (state_sha256(one.snapshot()), window_sha256(one.snapshot())) != (
                digests_w[t], rings_w[t]):
            raise AssertionError(f"tenants_full window: tenant {t} differs from a one-tenant "
                                 f"windowed engine seeded {seeds[t]} on its stream")
        del one
    plain = engine(T, seeds, "scan", "eager", window=window)
    run_stream(plain, bank_batches(streams))
    if (state_sha256(plain.snapshot()), window_sha256(plain.snapshot())) != (
            state_sha256(snap_w), window_sha256(snap_w)):
        raise AssertionError("tenants_full window: kernel route differs from the plain route")
    del plain
    tau_w = live_triangles(edges[m - window:], tau)  # the same for every relabeling
    errs_w, limit_w = rel_errs(wbank.estimate(), tau_w)
    window_out = {"window": window, "seconds": rep_w.seconds,
                  "edges_per_s_aggregate": T * m / rep_w.seconds,
                  "one_tenant_seconds": dynamic["window_s"],
                  "window_clock_host_s": ring_seconds(ring_s),
                  "one_tenant_window_clock_host_s": dynamic["window_clock_s"],
                  "expired": wbank.diag.window_expired, "tau_live": tau_w, "rel_err": errs_w,
                  "rel_err_limit": limit_w, "peak_device_bytes": peak_w,
                  "launches": launches_w, "state_sha256": digests_w, "window_sha256": rings_w,
                  "one_tenant_equal": True, "plain_route_equal": True,
                  "tenant0_equals_phase_dynamic_full": True}
    del wbank
    emit({"phase": "tenants_full", "tenants": T, "r": r, "s": s, "K": K, "m": m, "tau": tau,
          "global": global_out, "local": local_out, "burst": burst_out, "window": window_out,
          "ok": True})
    launches_all = {k: launches[k] + launches_l[k] + launches_b[k] + launches_w[k]
                    for k in launches}
    return {"launches": launches_all, "state": state, "streams": streams, "keys": keys,
            "chunk_ms": splits["chunk_ms"]["bank"],
            "chunk_busy_ms": splits["chunk_profile"]["bank"]["device_busy_ms"],
            "local_state": lbank.state, "local_scheme": lbank.scheme, "digests": digests,
            "local_estimates": est_l}


def phase_plans_full(dev, card: str, full: dict, tenants: dict) -> list:
    """The sharded plans at the full width (r = 2^21, s = 2^20, phase full's
    stream) on one-process meshes whose 4 shards all lie on this card
    (``host_devices=4``), kernel route: (a) pjit_independent and
    pjit_coordinated on ``estimators=4``, batch by batch (these plans do not
    chunk): each ends in phase full's state; (b) shardmap on
    ``estimators=4`` at capacity factor 2.0: no overflow and no escalation,
    the state equal to the same plan on the plain route (scan ingest,
    torch.searchsorted and torch.sort), rel.err within 5%, the
    device-resident query equal to the gather oracle; (c)
    banked_pjit_coordinated on ``tenants=2,estimators=2`` over
    tenants_full's four streams (seeds 7-10), chunked at K = 4 (fused_ingest
    runs on each shard at its estimator offset, 0 or r/2): each tenant
    equals tenants_full (a); (d) local (8 pools, 2^22 vertices) on
    banked_pjit_independent over ``tenants=4``: the device query's
    per-vertex answer equals the gather oracle and tenants_full (b); (e) a
    snapshot of (c)'s engine after its first chunk restored into a
    ``single`` engine and a ``tenants=4`` one, each run on to (c)'s end
    state; (f) on engines restored from (c)'s end: a fault at the
    engine.estimate site and a timeout below the query's time each fall
    back to the gather oracle, counted, with the oracle's answer. Every run
    zeroes the launch counts just before it and requires its path's
    kernels after; it records host seconds, edges/s, peak device bytes and
    the device-busy ms of one update (torch.profiler), and for shardmap the
    share of one update's device time spent between the routing
    all_to_all copies' events. The 4 shards share one card, so these
    numbers show per-shard overheads, not scaling. Returns the kernels-line
    row of fused_ingest on (c)'s shard at e0 = r/2."""
    import torch

    from repro_torch import rng as trng
    from repro_torch.core import distributed
    from repro_torch.core.bulk import chunk_structures
    from repro_torch.data.graph_stream import batches
    from repro_torch.engine import EngineConfig, TriangleCountEngine, run_stream
    from repro_torch.engine.faults import FaultPlan, FaultSpec, fault_plan
    from repro_torch.interop import state_sha256, tenant_snapshot
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.fused_ingest import fused_ingest, fused_ingest_plain
    from repro_torch.launch.mesh import make_stream_mesh

    edges, tau = full["edges"], full["tau"]
    s, K, r, T, V = FULL["s"], FULL["K"], FULL["r"], FULL["tenants"], FULL["vertices"]
    m = len(edges)
    seed = FULL["seed"]
    seeds = tuple(seed + t for t in range(T))
    streams = tenants["streams"]

    def engine(spec, backend, n_tenants=1, tenant_seeds=(seed,), chunk=1, plain=False, **kw):
        mesh = make_stream_mesh(spec, device=dev, host_devices=4) if spec else None
        return TriangleCountEngine(EngineConfig(
            r=r, batch_size=s, chunk_size=chunk, groups=FULL["groups"], n_tenants=n_tenants,
            seeds=tenant_seeds, backend=backend, device=dev.type,
            ingest="scan" if plain else "kernel", multisearch="eager" if plain else "kernel",
            **kw), mesh=mesh)

    def run(name, kernels, eng, items):
        """Drive ``eng`` with every count zeroed just before and read just
        after; every kernel of the path must have launched."""
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        rep = run_stream(eng, items)
        torch.cuda.synchronize(dev)
        launches = dict(LAUNCHES)
        missing = [k for k in kernels if launches[k] == 0]
        if missing:
            raise AssertionError(f"plans_full {name}: kernels never launched: {missing}")
        if eng.plan.name != name.split(":")[0]:
            raise AssertionError(f"plans_full: ran plan {eng.plan.name}, not {name}")
        return {"seconds": rep.seconds, "edges_per_s": rep.edges_per_s * eng.n_tenants,
                "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                "launches": launches}

    tail = torch.zeros((s, 2), dtype=torch.int32, device=dev)
    n_tail = m - 2 * K * s
    tail[:n_tail] = torch.from_numpy(edges[2 * K * s:]).to(dev)
    tail_key = trng.fold_in(trng.PRNGKey(seed, dev), 2 * K)
    batch_kernels = ("multisearch_counts", "bitonic_sort_tiles", "segscan")
    out = {}

    # (a) the pjit plans, batch by batch: phase full's state
    for w in ("independent", "coordinated"):
        eng = engine("estimators=4", f"pjit_{w}")
        res = run(f"pjit_{w}", batch_kernels, eng, batches(edges, s))
        if state_sha256(eng.snapshot()) != full["digest"]:
            raise AssertionError(f"plans_full pjit_{w}: state differs from phase full's")
        upd, st = eng._update, eng._state
        res["tail_update_profile"] = device_busy(lambda: upd(st, tail, n_tail, tail_key))
        out[f"pjit_{w}"] = {**res, "state_equal_phase_full": True}
        del eng, upd, st

    # (b) shardmap, kernel route against the plain route
    sm = engine("estimators=4", "shardmap", capacity_factor=2.0)
    res = run("shardmap", batch_kernels, sm, batches(edges, s))
    digest = state_sha256(sm.snapshot())
    est = sm.estimate()
    if not np.array_equal(est, sm.estimate(gather=True)):
        raise AssertionError("plans_full shardmap: device query differs from the gather oracle")
    if sm.diag.overflow_batches or sm.diag.capacity_escalations:
        raise AssertionError(f"plans_full shardmap: overflow {sm.diag}")
    rel = abs(float(est[0]) - tau) / tau
    if rel > REL_ERR_LIMIT:
        raise AssertionError(f"plans_full shardmap: rel.err {rel:.4%} > {REL_ERR_LIMIT:.0%}")
    plain = engine("estimators=4", "shardmap", capacity_factor=2.0, plain=True)
    t0 = time.perf_counter()
    run_stream(plain, batches(edges, s))
    plain_s = time.perf_counter() - t0
    if state_sha256(plain.snapshot()) != digest:
        raise AssertionError("plans_full shardmap: kernel route differs from the plain route")
    del plain
    upd, st = sm._update, sm._state
    res["tail_update_profile"] = device_busy(lambda: upd(st, tail, n_tail, tail_key))
    # the routing copies' share: events around every all_to_all of one update
    orig, pairs = distributed._all_to_all, []

    def timed(mesh, group, bufs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        got = orig(mesh, group, bufs)
        b.record()
        pairs.append((a, b))
        return got

    upd(st, tail, n_tail, tail_key)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    distributed._all_to_all = timed
    try:
        torch.cuda.synchronize(dev)
        ev[0].record()
        upd(st, tail, n_tail, tail_key)
        ev[1].record()
        torch.cuda.synchronize(dev)
    finally:
        distributed._all_to_all = orig
    route_ms = sum(a.elapsed_time(b) for a, b in pairs)
    update_ms = ev[0].elapsed_time(ev[1])
    out["shardmap"] = {**res, "state_sha256": digest, "plain_route_equal": True,
                       "plain_route_seconds": plain_s, "estimate": float(est[0]), "rel_err": rel,
                       "overflow_batches": 0, "capacity_escalations": 0,
                       "device_query_equals_gather": True,
                       "device_query_ms": time_ms(lambda: sm._estimate_device(st), reps=5),
                       "update_ms": update_ms, "all_to_all_calls": len(pairs),
                       "routing_copies_ms": route_ms, "routing_share": route_ms / update_ms}
    del sm, upd, st

    # (c) the tenant-sharded bank, chunked: each tenant equals tenants_full (a)
    bank = engine("tenants=2,estimators=2", "banked_pjit_coordinated", T, seeds, chunk=K)
    res = run("banked_pjit_coordinated", CHUNK_KERNELS + ("multisearch_counts",), bank,
              bank_batches(streams))
    snap_c = bank.snapshot()
    digests = [state_sha256(tenant_snapshot(snap_c, t)) for t in range(T)]
    if digests != tenants["digests"]:
        raise AssertionError("plans_full banked_pjit_coordinated: tenants differ from "
                             "tenants_full (a)")
    if not np.array_equal(bank.estimate(), bank.estimate(gather=True)):
        raise AssertionError("plans_full banked: device query differs from the gather oracle")
    Ws = torch.from_numpy(np.stack([e[:K * s].reshape(K, s, 2) for e in streams])).to(dev)
    nv = torch.full((T, K), s, dtype=torch.int32, device=dev)
    keys = torch.stack([trng.PRNGKey(x, dev) for x in seeds])
    upd, st = bank._update_chunk, bank._state
    res["chunk_profile"] = device_busy(lambda: upd(st, Ws, nv, keys, 0))
    res["chunk_ms"] = time_ms(lambda: upd(st, Ws, nv, keys, 0), reps=3)
    out["banked_pjit_coordinated"] = {**res, "state_sha256": digests, "tenants_equal": True}
    launches_c = res["launches"]
    del upd, st

    # the kernels-line row: fused_ingest on (c)'s second estimator shard of
    # tenant block 0 (2 tenants, r/2 estimators at e0 = r/2), against its
    # plain version and against the same rows of one full-r call
    half = r // 2
    full_state = tenants["state"]
    sh = [x[:2, half:].contiguous() if x.dim() > 1 else x[:2].contiguous() for x in full_state]
    structs = chunk_structures(Ws[:2], nv[:2], use_kernels=True)
    args = (*sh[:4], *structs, Ws[:2], nv[:2], sh[4], keys[:2], 0, half)
    got = fused_ingest(*args)
    want = fused_ingest_plain(*args)
    whole = fused_ingest(*[x[:2].contiguous() for x in full_state[:4]], *structs, Ws[:2],
                         nv[:2], full_state.m_seen[:2], keys[:2], 0)
    for f, a, b, c in zip(("f1", "chi", "f2", "has_f3"), got, want, whole):
        require_equal(f"fused_ingest shard e0={half} {f}", a, b)
        require_equal(f"fused_ingest shard e0={half} {f}, full-r call", a, c[:, half:])
    args0 = args[:-1] + (0,)
    tf_ops = 5 * (20 * 3 + 6 * 3)
    search_ops = 2 * (5 * math.ceil(math.log2(2 * s + 1)) + 2 * math.ceil(math.log2(s + 1)))
    b_ms, b_by = bound(nbytes(*args[:-3], args[-3]) + nbytes(*sh[:4]),
                       2 * half * K * (tf_ops + search_ops))
    src_path, replaces = KERNELS["fused_ingest"]
    row = {"name": f"fused_ingest (shard: 2 tenants x r/2 at e0 = {half})", "route": "cuda",
           "source": src_path, "replaces": replaces, "launches": launches_c["fused_ingest"],
           "max_abs_err": max(max_abs(a, b) for a, b in zip(got, want)),
           "ms": time_ms(lambda: fused_ingest(*args), reps=10),
           "plain_ms": time_ms(lambda: fused_ingest_plain(*args), reps=2, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "ms_at_e0_0": time_ms(lambda: fused_ingest(*args0), reps=10),
           "ms_at_e0_again": time_ms(lambda: fused_ingest(*args), reps=10)}
    del sh, structs, args, args0, got, want, whole

    # (d) local on tenants=4: the device query's per-vertex answers
    params = {"n_vertices": V, "n_pools": FULL["pools"]}
    lbank = engine("tenants=4", "banked_pjit_independent", T, seeds, chunk=K, scheme="local",
                   scheme_params=params)
    torch.cuda.synchronize(dev)
    res = run("banked_pjit_independent:local", batch_kernels, lbank, batches(edges, s))
    reset_launches()
    est_l = lbank.estimate()
    if LAUNCHES["segment_sum"] != T:
        raise AssertionError(f"plans_full local: segment_sum launched {LAUNCHES['segment_sum']} "
                             f"times in the device query (want {T}, one a shard)")
    if not np.array_equal(est_l, lbank.estimate(gather=True)) or \
            not np.array_equal(est_l, tenants["local_estimates"]):
        raise AssertionError("plans_full local: the device query differs from the gather "
                             "oracle or from tenants_full (b)")
    qst = lbank._state
    res["device_query_ms"] = time_ms(lambda: lbank._estimate_device(qst), reps=3)
    res["gather_query_ms"] = time_ms(lambda: lbank.estimate(gather=True), reps=3)
    res["device_query_profile"] = device_busy(lambda: lbank._estimate_device(qst))
    out["banked_pjit_independent_local"] = {**res, "estimates_equal_tenants_full": True}
    del lbank, qst

    # (e) (c)'s snapshot after its first chunk, restored into other meshes
    first = engine("tenants=2,estimators=2", "banked_pjit_coordinated", T, seeds, chunk=K)
    run_stream(first, itertools.islice(bank_batches(streams), K))
    snap1 = first.snapshot()
    del first
    for spec, plan in (("", "single"), ("tenants=4", "banked_pjit_independent")):
        e = engine(spec, plan, T, seeds, chunk=K)
        e.restore(snap1)
        run_stream(e, bank_batches(streams))  # skips the restored prefix
        sn = e.snapshot()
        if [state_sha256(tenant_snapshot(sn, t)) for t in range(T)] != digests:
            raise AssertionError(f"plans_full: (c)'s snapshot restored into {plan} diverged")
        del e
    out["snapshots_cross_meshes"] = ["single", "banked_pjit_independent"]

    # (f) the device query's fallbacks, on engines restored from (c)'s end
    want = bank.estimate(gather=True)
    del bank
    q = engine("tenants=2,estimators=2", "banked_pjit_coordinated", T, seeds, chunk=K)
    q.restore(snap_c)
    with fault_plan(FaultPlan([FaultSpec("engine.estimate", "raise")])):
        got_f = q.estimate()
    q2 = engine("tenants=2,estimators=2", "banked_pjit_coordinated", T, seeds, chunk=K)
    q2.restore(snap_c)
    qs = q2._state
    query_ms = time_ms(lambda: q2._estimate_device(qs), reps=3)
    got_t = q2.estimate(timeout_s=1e-6)
    if (q.diag.query_fallbacks, q.diag.query_timeouts) != (1, 0) or \
            (q2.diag.query_fallbacks, q2.diag.query_timeouts) != (1, 1):
        raise AssertionError(f"plans_full: fallbacks {q.diag}, {q2.diag}")
    if not (np.array_equal(got_f, want) and np.array_equal(got_t, want)):
        raise AssertionError("plans_full: a fallback answer differs from the oracle")
    out["fallbacks"] = {"fault": {"query_fallbacks": 1, "query_timeouts": 0},
                        "timeout_s": 1e-6, "device_query_ms": query_ms,
                        "timeout": {"query_fallbacks": 1, "query_timeouts": 1},
                        "answers_equal_oracle": True}
    del q, q2, qs
    emit({"phase": "plans_full", "card": card, "shards": 4, "host_devices": 4, "r": r, "s": s,
          "K": K, "m": m, "tau": tau, **out, "ok": True})
    return [row]


def phase_elastic_full(dev, card: str, full: dict, local: dict, tenants: dict) -> None:
    """The elastic serving tier at the full width (r = 2^21, s = 2^20,
    K = 4), kernel route (the default on the card), each part zeroing the launch counts just before
    it and requiring its path's kernels just after: (a) the churn drill: an
    ElasticBankEngine of capacity 4 on ``single`` behind an ElasticServeLoop
    (stall, depth 64): eight sessions seeded 7-14, session i on
    tenants_full's stream i mod 4, a rolling query every 4 batches, session
    0 snapshotted, evicted and restored after batch 4 through a
    CheckpointManager, one engine.ingest_chunk raise retried. Sessions 0-3
    end in tenants_full (a)'s tenant states, sessions 4-7 in one-tenant
    engines seeded 11-14 on their streams; every rel.err within
    REL_ERR_LIMIT; after the tier's warm-up no kernel library is built or
    loaded and no tier built. (b) A fifth tenant into the full bank: the
    capacity doubles with exactly one new tier and the residents' states
    unchanged. (c) The per-batch route (chunk 1) with a tenant that joins
    three batches late: each equals tenants_full. (d) banked_pjit_coordinated
    on ``tenants=2,estimators=2`` (4 shards of this card), capacity 2: each
    tenant equals tenants_full. (e) A ``local`` tenant seeded 7: its
    per-vertex estimate equals phase local_full's. Records host seconds,
    aggregate edges/s, the queries' latency from ``query()`` to the answer,
    peak bytes, one chunk dispatch's time and device busy ms beside
    tenants_full's, the grow's seconds, a snapshot_tenant's ms, and the
    allocator segments the steady churn created."""
    import torch

    from repro_torch.data.graph_stream import batches
    from repro_torch.engine import (
        ElasticBankEngine,
        ElasticServeLoop,
        EngineConfig,
        ResilienceConfig,
        RetryPolicy,
        TriangleCountEngine,
        install_fault_plan,
        parse_fault_plan,
        run_stream,
    )
    from repro_torch.interop import state_sha256
    from repro_torch.kernels import LAUNCHES, LIBRARY_EVENTS, reset_launches
    from repro_torch.launch.mesh import make_stream_mesh
    from repro_torch.launch.stream_serve import _Session, drive_sessions
    from repro_torch.train.checkpoint import CheckpointManager

    s, K, r, T = FULL["s"], FULL["K"], FULL["r"], FULL["tenants"]
    tau, m = full["tau"], len(full["edges"])
    streams, digests = tenants["streams"], tenants["digests"]
    its = [list(batches(e, s)) for e in streams]
    chunk_kernels = ("fused_ingest", "bitonic_sort_tiles", "segscan", "segmented_max_scan")
    batch_kernels = ("multisearch_counts", "bitonic_sort_tiles", "segscan")

    def bank(capacity, chunk=K, **kw):
        return ElasticBankEngine(r, s, capacity=capacity, chunk_size=chunk,
                                 groups=FULL["groups"], device=dev.type, **kw)

    def sha(b, tid):
        return state_sha256(b.snapshot_tenant(tid))

    def counted(name, kernels, drive):
        """Run ``drive`` with the launch counts zeroed just before and read
        just after; every kernel of its path must have launched."""
        torch.cuda.synchronize(dev)
        reset_launches()
        out = drive()
        torch.cuda.synchronize(dev)
        launches = dict(LAUNCHES)
        missing = [k for k in kernels if launches[k] == 0]
        if missing:
            raise AssertionError(f"elastic_full {name}: kernels never launched: {missing}")
        return out, launches

    out = {}
    # (a) the churn drill
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    drill = bank(4)
    events0 = dict(LIBRARY_EVENTS)
    segments0 = torch.cuda.memory_stats(dev)["segment.all.allocated"]
    ckpt_dir = tempfile.mkdtemp(prefix="elastic_full_")
    finals, restored, latencies = {}, [], []
    loop = ElasticServeLoop(drill, queue_depth=64, queue_policy="stall",
                            resilience=ResilienceConfig(retry=RetryPolicy(base_s=0.001,
                                                                          seed=FULL["seed"])),
                            checkpoint=CheckpointManager(ckpt_dir, async_save=True))
    query = loop.query

    def timed_query(tid):
        t0 = time.perf_counter()
        fut = query(tid)
        fut.add_done_callback(lambda f: latencies.append(time.perf_counter() - t0))
        return fut

    loop.query = timed_query
    sessions = [_Session(f"s{i}", FULL["seed"] + i, its[i % T], snap_at=4 if i == 0 else 0)
                for i in range(2 * T)]

    def final(sess, answer):
        # the session's whole stream is ingested: its state, before the evict
        snap = loop.snapshot_tenant(sess.tid).result(60)
        finals[sess.tid] = (answer["estimate"], state_sha256(snap))

    def drive():
        install_fault_plan(parse_fault_plan("engine.ingest_chunk:raise@1", seed=FULL["seed"]))
        loop.start()
        t0 = time.perf_counter()
        try:
            drive_sessions(loop, drill, list(sessions), report_every=4, save=True,
                           on_restore=lambda sess, step: restored.append([sess.tid, step]),
                           on_final=final)
            loop.drain()
        finally:
            stats = loop.stop()
            install_fault_plan(None)
        return stats, time.perf_counter() - t0

    try:
        (stats, drill_s), launches_a = counted("drill", chunk_kernels, drive)
    finally:
        shutil.rmtree(ckpt_dir)
    peak_a = torch.cuda.max_memory_allocated(dev)
    events1 = dict(LIBRARY_EVENTS)
    segments1 = torch.cuda.memory_stats(dev)["segment.all.allocated"]
    if events1 != events0 or drill.diag.tier_compiles != 1:
        raise AssertionError(f"elastic_full drill: kernel libraries {events0} -> {events1}, "
                             f"tier builds {drill.diag.tier_compiles}")
    if stats.retries != 1 or restored != [["s0", 4]] or len(finals) != 2 * T:
        raise AssertionError(f"elastic_full drill: retries {stats.retries}, restores {restored},"
                             f" {len(finals)} sessions finished")
    # sessions 0-3 end in tenants_full (a)'s states, 4-7 in one-tenant
    # engines seeded 11-14 on streams 0-3
    t0 = time.perf_counter()
    rel = {}
    for i, sess in enumerate(sessions):
        est, digest = finals[sess.tid]
        if i < T:
            want_digest, want_est = digests[i], None
        else:
            one = TriangleCountEngine(EngineConfig(
                r=r, batch_size=s, chunk_size=K, groups=FULL["groups"], seeds=(sess.seed,),
                device=dev.type, ingest="kernel", multisearch="kernel"))
            run_stream(one, batches(streams[i - T], s))
            want_digest, want_est = state_sha256(one.snapshot()), float(one.estimate()[0])
            del one
        if digest != want_digest or (want_est is not None and float(est) != want_est):
            raise AssertionError(f"elastic_full drill: session {sess.tid} differs from the "
                                 "engine it is held to")
        rel[sess.tid] = abs(float(est) - tau) / tau
        if rel[sess.tid] > REL_ERR_LIMIT:
            raise AssertionError(f"elastic_full drill: {sess.tid} rel.err {rel[sess.tid]:.4%}")
    out["drill"] = {"sessions": 2 * T, "capacity": 4, "seconds": drill_s,
                    "edges_per_s_aggregate": 2 * T * m / drill_s,
                    "queries": stats.queries_answered, "query_latency_ms": {
                        "p50": float(np.percentile(latencies, 50)) * 1e3,
                        "p99": float(np.percentile(latencies, 99)) * 1e3,
                        "max": max(latencies) * 1e3, "n": len(latencies)},
                    "ticks": stats.ticks, "ingest_dispatches": stats.ingest_dispatches,
                    "batches": stats.batches, "retries": stats.retries, "restored": restored,
                    "rel_err": rel, "peak_device_bytes": peak_a, "launches": launches_a,
                    "library_events": events1, "tier_compiles": drill.diag.tier_compiles,
                    "allocator_segments_created": segments1 - segments0,
                    "queue": loop.queues.diag(), "sessions_0_3_equal_tenants_full": True,
                    "sessions_4_7_equal_one_tenant_engines": True,
                    "check_seconds": time.perf_counter() - t0}
    loop.query = query

    # (b) one chunk dispatch at capacity 4, then the grow
    for t in range(T):
        drill.hot_add(f"g{t}", seed=FULL["seed"] + t)
    work = {f"g{t}": its[t][:K] for t in range(T)}
    chunk_ms = time_ms(lambda: drill.ingest_chunk(work), reps=3, warmup=1)
    chunk_profile = device_busy(lambda: drill.ingest_chunk(work))
    before = [sha(drill, f"g{t}") for t in range(T)]
    snap_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        drill.snapshot_tenant("g0")
        snap_ms.append((time.perf_counter() - t0) * 1e3)
    events2 = dict(LIBRARY_EVENTS)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    drill.hot_add("g4", seed=FULL["seed"] + T)
    drill.sync()
    grow_s = time.perf_counter() - t0
    if (drill.capacity, drill.diag.tier_compiles, drill.diag.grows) != (8, 2, 1) or \
            [sha(drill, f"g{t}") for t in range(T)] != before:
        raise AssertionError(f"elastic_full grow: capacity {drill.capacity}, "
                             f"{drill.diag.tier_compiles} tiers, residents changed?")
    out["grow"] = {"seconds": grow_s, "capacity": [4, 8], "tier_compiles": 2,
                   "residents_unchanged": True,
                   "library_events_in_grow": {k: LIBRARY_EVENTS[k] - events2[k]
                                              for k in events2},
                   "chunk_dispatch_ms": chunk_ms, "chunk_dispatch_profile": chunk_profile,
                   "tenants_full_bank_chunk_ms": tenants["chunk_ms"],
                   "tenants_full_bank_chunk_busy_ms": tenants["chunk_busy_ms"],
                   "snapshot_tenant_ms": snap_ms}
    del drill, work

    # (c) the per-batch route, a tenant joining three batches late
    def per_batch():
        b = bank(2, chunk=1)
        b.hot_add("a", seed=FULL["seed"])
        for i in range(len(its[0]) + 3):
            items = {}
            if i < len(its[0]):
                items["a"] = its[0][i]
            if i == 3:
                b.hot_add("b", seed=FULL["seed"] + 1)
            if i >= 3:
                items["b"] = its[1][i - 3]
            b.ingest(items)
        b.sync()
        return b

    t0 = time.perf_counter()
    pb, launches_c = counted("per-batch", batch_kernels, per_batch)
    pb_s = time.perf_counter() - t0
    if [sha(pb, "a"), sha(pb, "b")] != digests[:2]:
        raise AssertionError("elastic_full per-batch: tenants differ from tenants_full")
    out["per_batch"] = {"seconds": pb_s, "dispatches": len(its[0]) + 3,
                        "launches": launches_c, "tenants_equal": True}
    del pb

    # (d) the tenant-sharded bank on 4 shards of this card
    def sharded():
        mesh = make_stream_mesh("tenants=2,estimators=2", device=dev, host_devices=4)
        b = bank(2, backend="banked_pjit_coordinated", mesh=mesh)
        for t in range(2):
            b.hot_add(t, seed=FULL["seed"] + t)
        for lo in range(0, len(its[0]), K):
            b.ingest_chunk({t: its[t][lo:lo + K] for t in range(2)})
        b.sync()
        return b

    t0 = time.perf_counter()
    sb, launches_d = counted("sharded", chunk_kernels, sharded)
    sb_s = time.perf_counter() - t0
    if sb.backend != "banked_pjit_coordinated" or [sha(sb, 0), sha(sb, 1)] != digests[:2]:
        raise AssertionError("elastic_full sharded: tenants differ from tenants_full")
    if not np.array_equal(sb.estimate(), sb.estimate(gather=True)):
        raise AssertionError("elastic_full sharded: device query differs from the oracle")
    out["sharded"] = {"plan": sb.backend, "seconds": sb_s, "launches": launches_d,
                      "tenants_equal": True}
    del sb

    # (e) a local tenant: its per-vertex estimate is phase local_full's
    def local_tenant():
        b = bank(2, scheme="local",
                 scheme_params=(("n_pools", FULL["pools"]), ("n_vertices", FULL["vertices"])))
        b.hot_add("v", seed=FULL["seed"])
        for lo in range(0, len(its[0]), K):
            b.ingest_chunk({"v": its[0][lo:lo + K]})
        return b, b.estimate_tenant("v")

    (lb, est_l), launches_e = counted("local", ("multisearch_counts", "segment_sum"),
                                      local_tenant)
    if sha(lb, "v") != local["digest"] or not np.array_equal(est_l, local["estimate"]):
        raise AssertionError("elastic_full local: differs from phase local_full")
    out["local"] = {"launches": launches_e, "equals_local_full": True}
    del lb
    launches_all = {k: launches_a[k] + launches_c[k] + launches_d[k] + launches_e[k]
                    for k in launches_a}
    missing = [k for k in KERNELS if launches_all[k] == 0]
    if missing:
        raise AssertionError(f"elastic_full: kernels never launched on the elastic path: "
                             f"{missing}")
    emit({"phase": "elastic_full", "card": card, "r": r, "s": s, "K": K, "m": m, "tau": tau,
          **out, "launches": launches_all, "ok": True})


def bank_kernel_rows(dev, tenants: dict) -> list:
    """Each kernel's bank form at T = 4 and the full shape: equal to its
    plain version and to T one-tenant calls bit for bit (the tile sort's
    keys bit-equal to its plain version and its payloads equal under the
    split contract), with the CUDA launches of one one-tenant call, timed
    beside T times the one-tenant call's time."""
    import torch

    from repro_torch.core.bulk import _q1_queries, chunk_structures
    from repro_torch.core.rank import INF64 as KEY_PAD
    from repro_torch.core.rank import _next_pow2
    from repro_torch.kernels import CUDA_LAUNCHES
    from repro_torch.kernels.bitonic import bitonic_sort_tiles, bitonic_sort_tiles_plain
    from repro_torch.kernels.fused_ingest import fused_ingest, fused_ingest_plain
    from repro_torch.kernels.multisearch import multisearch_counts, multisearch_counts_plain
    from repro_torch.kernels.segment_sum import segment_sum, segment_sum_plain
    from repro_torch.kernels.segscan import segmented_max_scan, segscan, segscan_plain
    from repro_torch.primitives.segscan import segment_starts
    from repro_torch.primitives.sort import pack2

    s, K, r, T = FULL["s"], FULL["K"], FULL["r"], FULL["tenants"]
    state, keys = tenants["state"], tenants["keys"]
    Ws = torch.from_numpy(np.stack([e[:K * s].reshape(K, s, 2) for e in tenants["streams"]])).to(dev)
    nv = torch.full((T, K), s, dtype=torch.int32, device=dev)
    structs = chunk_structures(Ws, nv, use_kernels=False)
    rows = []

    def per_call(name, fn) -> int:
        CUDA_LAUNCHES[name] = 0
        fn()
        torch.cuda.synchronize(dev)
        return CUDA_LAUNCHES[name]

    def row(name, err, bank_fn, one_fns, plain_fn, lib_fn, nb, ops, timer=time_ms,
            ops_per_s=INT32_OPS_PER_S, **extra):
        """The bank form's row: one_fns are the T one-tenant calls; tenant
        0's call is timed as the one-tenant call."""
        n_bank, n_one = per_call(name, bank_fn), per_call(name, one_fns[0])
        if n_bank != n_one:
            raise AssertionError(f"{name} bank form: {n_bank} CUDA launches a call, one "
                                 f"tenant's call {n_one}")
        ms, one_ms = timer(bank_fn), timer(one_fns[0])
        b_ms, b_by = bound(nb, ops, ops_per_s)
        src_path, replaces = KERNELS[name]
        rows.append({"name": f"{name} (bank of {T} tenants)", "route": "cuda",
                     "source": src_path, "replaces": replaces,
                     "launches": tenants["launches"][name], "max_abs_err": err, "ms": ms,
                     "plain_ms": time_ms(plain_fn, reps=2, warmup=1), "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None if lib_fn is None else timer(lib_fn),
                     "tenants": T, "launches_per_call": n_bank,
                     "one_tenant_launches_per_call": n_one, "one_tenant_ms": one_ms,
                     "tenants_times_one_tenant_ms": T * one_ms, **extra})

    # fused_ingest: the bank's first chunk over the final bank state, each
    # tenant from its own first step (a (T,) step0 tensor)
    st = (state.f1, state.chi, state.f2, state.has_f3)
    step0 = torch.arange(T, dtype=torch.int64, device=dev) * K
    args = (*st, *structs, Ws, nv, state.m_seen, keys, step0)
    got = fused_ingest(*args)
    want = fused_ingest_plain(*args)
    ones = []
    for t in range(T):
        one_args = (*(x[t] for x in st), *(x[t] for x in structs), Ws[t], nv[t],
                    state.m_seen[t], keys[t], int(step0[t]))
        ones.append(lambda a=one_args: fused_ingest(*a))
        for f, a, b, c in zip(("f1", "chi", "f2", "has_f3"), got, want, ones[t]()):
            require_equal(f"fused_ingest bank {f}", a, b)
            require_equal(f"fused_ingest bank {f}, tenant {t} alone", a[t], c)
    del want
    tf_ops = 5 * (20 * 3 + 6 * 3)
    search_ops = 2 * (5 * math.ceil(math.log2(2 * s + 1)) + 2 * math.ceil(math.log2(s + 1)))
    row("fused_ingest", 0.0, lambda: fused_ingest(*args), ones,
        lambda: fused_ingest_plain(*args), None, nbytes(*args) + nbytes(*st),
        T * r * K * (tf_ops + search_ops))

    # bitonic_sort_tiles: the bank's T·K arc tiles of 2^21 in one call
    tile = _next_pow2(2 * s)
    Wf = Ws.reshape(T * K, s, 2)
    kd_p = torch.full((T * K, tile), KEY_PAD, dtype=torch.int64, device=dev)
    kd_p[:, : 2 * s] = pack2(torch.cat([Wf[:, :, 0], Wf[:, :, 1]], 1),
                             (s - 1) - torch.arange(s, device=dev, dtype=torch.int32).repeat(2))
    arc_p = torch.zeros((T * K, tile), dtype=torch.int32, device=dev)
    arc_p[:, : 2 * s] = torch.arange(2 * s, dtype=torch.int32, device=dev)
    kf, vf = kd_p.view(-1), arc_p.view(-1)
    got = bitonic_sort_tiles(kf, vf, tile)
    check_tile_sort("bitonic bank", kf, vf, tile, got, bitonic_sort_tiles_plain(kf, vf, tile))
    per = K * tile
    ones = [lambda t=t: bitonic_sort_tiles(kf[t * per:(t + 1) * per], vf[t * per:(t + 1) * per],
                                           tile) for t in range(T)]
    for t in range(T):
        ak, av = ones[t]()
        require_equal(f"bitonic bank keys, tenant {t} alone", got[0][t * per:(t + 1) * per], ak)
        require_equal(f"bitonic bank payloads, tenant {t} alone", got[1][t * per:(t + 1) * per], av)

    def library_tile_sort():
        sk, order = torch.sort(kd_p, dim=1)
        return sk, torch.gather(arc_p, 1, order)

    row("bitonic_sort_tiles", 0.0, lambda: bitonic_sort_tiles(kf, vf, tile), ones,
        lambda: bitonic_sort_tiles_plain(kf, vf, tile), library_tile_sort, 2 * nbytes(kf, vf),
        2 * kf.numel() * int(math.log2(tile)), shape=f"{T * K} tiles of {tile} (arcs)")
    del kd_p, arc_p, kf, vf, got

    # segscan: the bank chunk's ranks, a sum over T·K·2s; its max over the
    # bank's T·K·s tile-sorted edges as a second shape
    ones_v = torch.ones(T * K * 2 * s, dtype=torch.int32, device=dev)
    flags = segment_starts(structs[2]).reshape(-1).contiguous()
    got = segscan(ones_v, flags)
    require_equal("segscan bank", got, segscan_plain(ones_v, flags))
    per = K * 2 * s
    seg_ones = [lambda t=t: segscan(ones_v[t * per:(t + 1) * per], flags[t * per:(t + 1) * per])
                for t in range(T)]
    for t in range(T):
        require_equal(f"segscan bank, tenant {t} alone", got[t * per:(t + 1) * per], seg_ones[t]())
    epos, estarts = structs[6].reshape(-1).contiguous(), segment_starts(structs[5]).reshape(-1)
    mx = segmented_max_scan(epos, estarts)
    per_e = K * s
    for t in range(T):
        require_equal(f"segmented_max_scan bank, tenant {t} alone", mx[t * per_e:(t + 1) * per_e],
                      segmented_max_scan(epos[t * per_e:(t + 1) * per_e],
                                         estarts[t * per_e:(t + 1) * per_e]))
    row("segscan", 0.0, lambda: segscan(ones_v, flags), seg_ones,
        lambda: segscan_plain(ones_v, flags), None, nbytes(ones_v, flags) + nbytes(ones_v),
        2 * ones_v.numel(), timer=device_ms, shape=f"sum over {ones_v.numel()} (bank ranks)",
        max_scan_ms=device_ms(lambda: segmented_max_scan(epos, estarts)),
        max_scan_one_tenant_ms=device_ms(lambda: segmented_max_scan(epos[:per_e],
                                                                    estarts[:per_e])))
    del ones_v, flags, got

    # multisearch_counts: Q1 of the bank, each tenant's 4r queries into its
    # own batch-0 key_desc, a row-strided view of the chunk's structures
    kd_rows = structs[0][:, 0]
    f1b = torch.full((T, r), -1, dtype=torch.int32, device=dev)
    q1 = _q1_queries(s, state.f1[..., 0], state.f1[..., 1], f1b)
    lt, le = multisearch_counts(kd_rows, q1)
    wlt, wle = multisearch_counts_plain(kd_rows, q1)
    require_equal("multisearch bank lt", lt, wlt)
    require_equal("multisearch bank le", le, wle)
    ms_ones = [lambda t=t: multisearch_counts(kd_rows[t], q1[t]) for t in range(T)]
    for t in range(T):
        a, b = ms_ones[t]()
        require_equal(f"multisearch bank lt, tenant {t} alone", lt[t], a)
        require_equal(f"multisearch bank le, tenant {t} alone", le[t], b)
    kd_dense = kd_rows.contiguous()
    depth = math.ceil(math.log2(2 * s + 1))
    row("multisearch_counts", 0.0, lambda: multisearch_counts(kd_rows, q1), ms_ones,
        lambda: multisearch_counts_plain(kd_rows, q1),
        lambda: (torch.searchsorted(kd_dense, q1, side="left", out_int32=True),
                 torch.searchsorted(kd_dense, q1, side="right", out_int32=True)),
        nbytes(kd_dense, q1) + 2 * 4 * q1.numel(), 2 * 2 * q1.numel() * depth,
        shape=f"Q1: {T} rows of {q1.shape[1]} queries into {kd_rows.shape[1]} keys",
        library_call="two torch.searchsorted on the (B, n) rows")
    del q1, lt, le, wlt, wle, kd_dense

    # segment_sum: the local bank's attribution, 3r rows a tenant into
    # n_vertices bins each
    scheme = tenants["local_scheme"]
    m = scheme.n_vertices
    vals, ids = scheme.attribution_inputs(tenants["local_state"], 0, r)
    got = segment_sum(vals, ids, m)
    require_equal("segment_sum bank", got, segment_sum_plain(vals, ids, m))
    ss_ones = [lambda t=t: segment_sum(vals[t], ids[t], m) for t in range(T)]
    for t in range(T):
        require_equal(f"segment_sum bank, tenant {t} alone", got[t], ss_ones[t]())
    keep = (ids >= 0) & (ids < m)
    bins = (ids.long() + m * torch.arange(T, device=dev)[:, None])[keep]
    vals_in = vals[keep]
    kept = int(bins.numel())
    row("segment_sum", 0.0, lambda: segment_sum(vals, ids, m), ss_ones,
        lambda: segment_sum_plain(vals, ids, m),
        lambda: torch.zeros((T * m, 1), dtype=torch.float64, device=dev).index_add_(
            0, bins, vals_in), nbytes(ids) + 8 * kept + T * m * 8, kept, timer=device_ms,
        ops_per_s=FP64_OPS_PER_S, rows_in_range=kept,
        library_call="zeros(T * m, d) + index_add_ on the pre-filtered in-range rows, "
                     "offset by tenant")
    emit({"phase": "kernels_bank", "tenants": T, "ok": True})
    return rows


def phase_kernels(dev, full: dict, local: dict, dynamic: dict) -> list:
    import torch

    from repro_torch import rng as trng
    from repro_torch.core.bulk import (
        _chunk_randomness,
        _closing_query,
        _delete_queries,
        _q1_queries,
        bulk_update_all,
        bulk_update_chunk,
        chunk_draws,
        chunk_structures,
        delete_keys,
    )
    from repro_torch.core.rank import INF64 as KEY_PAD
    from repro_torch.core.rank import _next_pow2, rank_all_chunk
    from repro_torch.kernels import CUDA_LAUNCHES, _build
    from repro_torch.kernels.bitonic import bitonic_sort_tiles, bitonic_sort_tiles_plain
    from repro_torch.kernels.fused_ingest import fused_ingest, fused_ingest_plain
    from repro_torch.kernels.multisearch import multisearch_counts, multisearch_counts_plain
    from repro_torch.kernels.ref import delete_hits_ref
    from repro_torch.kernels.segment_sum import segment_sum, segment_sum_plain
    from repro_torch.kernels.segscan import (
        segmented_max_scan,
        segmented_max_scan_plain,
        segscan,
        segscan_plain,
    )
    from repro_torch.primitives.segscan import segment_starts
    from repro_torch.primitives.sort import pack2

    s, K, r = FULL["s"], FULL["K"], FULL["r"]
    state = full["state"]
    Ws = torch.from_numpy(full["edges"][: K * s].reshape(K, s, 2)).to(dev)
    nv = torch.full((K,), s, dtype=torch.int32, device=dev)
    key = trng.PRNGKey(FULL["seed"], dev)
    structs = chunk_structures(Ws, nv, use_kernels=False)
    key_desc, key_rank, src, dst, pos, ekey, epos = structs
    rows = []

    def per_call(name, fn) -> int:
        """The CUDA kernels one wrapper call queues, as its C entry reports
        them: the count is zeroed just before the call and read after it."""
        CUDA_LAUNCHES[name] = 0
        fn()
        return CUDA_LAUNCHES[name]

    def row(name, err, ms, plain_ms, lib_ms, nb, ops, fn, ops_per_s=INT32_OPS_PER_S, path=full):
        b_ms, b_by = bound(nb, ops, ops_per_s)
        src_path, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": src_path, "replaces": replaces,
                     "launches": path["launches"][name], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms, "launches_per_call": per_call(name, fn)})

    def shape(label, name, fn, plain, library, nb, ops):
        """One shape a kernel runs at on the path: its CUDA launches per
        wrapper call and its times, the kernel timed before and after its
        library call."""
        b_ms, b_by = bound(nb, ops)
        ms = time_ms(fn, reps=20)
        lib_ms = time_ms(library, reps=20)
        return {"shape": label, "launches_per_call": per_call(name, fn), "ms": ms,
                "ms_after_library": time_ms(fn, reps=20), "plain_ms": time_ms(plain),
                "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}

    # fused_ingest: one K-batch chunk of the full-size stream over the final
    # state, its draws made in the kernel from the stream key
    st = (state.f1, state.chi, state.f2, state.has_f3)
    args = (*st, *structs, Ws, nv, state.m_seen, key, 0)
    got = fused_ingest(*args)
    want = fused_ingest_plain(*args)
    for f, a, b in zip(("f1", "chi", "f2", "has_f3"), got, want):
        require_equal(f"fused_ingest {f}", a, b)
    err = max(max_abs(a, b) for a, b in zip(got, want))
    # operations per (batch, estimator): 5 threefry blocks of 20 rounds (an
    # add, a rotate, a xor) and 6 key injections (3 adds), and the searches'
    # int64 compares (2 operations each), log2 of the keys per bound: 4
    # bounds over key_desc, 1 over key_rank, 2 over ekey
    tf_ops = 5 * (20 * 3 + 6 * 3)
    search_ops = 2 * (5 * math.ceil(math.log2(2 * s + 1)) + 2 * math.ceil(math.log2(s + 1)))
    row("fused_ingest", err, time_ms(lambda: fused_ingest(*args), reps=10),
        time_ms(lambda: fused_ingest_plain(*args), reps=2, warmup=1), None,
        nbytes(*args[:-1]) + nbytes(*st), r * K * (tf_ops + search_ops),
        lambda: fused_ingest(*args))

    # bitonic_sort_tiles: the arc tiles of that chunk (K tiles of 2^21) and
    # its edge tiles (K tiles of 2^20), as rank_all_chunk pads them
    block = _build.load("bitonic", "bitonic_sort_block", [])()
    tile, tile_e = _next_pow2(2 * s), _next_pow2(s)
    kd = pack2(torch.cat([Ws[:, :, 0], Ws[:, :, 1]], 1),
               (s - 1) - torch.arange(s, device=dev, dtype=torch.int32).repeat(2)[None, :])
    kd_p = torch.full((K, tile), KEY_PAD, dtype=torch.int64, device=dev)
    kd_p[:, : 2 * s] = kd
    arc_p = torch.zeros((K, tile), dtype=torch.int32, device=dev)
    arc_p[:, : 2 * s] = torch.arange(2 * s, dtype=torch.int32, device=dev)
    ek_p = torch.full((K, tile_e), KEY_PAD, dtype=torch.int64, device=dev)
    ek_p[:, :s] = pack2(torch.minimum(Ws[:, :, 0], Ws[:, :, 1]),
                        torch.maximum(Ws[:, :, 0], Ws[:, :, 1]))
    ep_p = torch.zeros((K, tile_e), dtype=torch.int32, device=dev)
    ep_p[:, :s] = torch.arange(s, dtype=torch.int32, device=dev)
    sort_shapes, err = [], 0.0
    for label, kp, vp, t in ((f"{K} tiles of {tile} (arcs)", kd_p, arc_p, tile),
                             (f"{K} tiles of {tile_e} (edges)", ek_p, ep_p, tile_e)):
        kf, vf = kp.view(-1), vp.view(-1)
        err = max(err, check_tile_sort(f"bitonic full tile={t}", kf, vf, t,
                                       bitonic_sort_tiles(kf, vf, t),
                                       bitonic_sort_tiles_plain(kf, vf, t)))

        def library_tile_sort(kp=kp, vp=vp):  # keys and payloads, as the kernel returns them
            keys, order = torch.sort(kp, dim=1)
            return keys, torch.gather(vp, 1, order)

        # a comparison sort's least work: log2(tile) int64 compares an entry
        sort_shapes.append(shape(label, "bitonic_sort_tiles",
                                 lambda kf=kf, vf=vf, t=t: bitonic_sort_tiles(kf, vf, t),
                                 lambda kf=kf, vf=vf, t=t: bitonic_sort_tiles_plain(kf, vf, t),
                                 library_tile_sort, 2 * nbytes(kf, vf),
                                 2 * kf.numel() * int(math.log2(t))))
    # the block sort alone: the arc tiles sorted in tiles of one block
    sort_shapes[0]["block_sort_ms"] = time_ms(lambda: bitonic_sort_tiles(kd_p.view(-1), arc_p.view(-1),
                                                                          block), reps=20)
    main = sort_shapes[0]
    row("bitonic_sort_tiles", err, main["ms"], main["plain_ms"], main["library_ms"],
        2 * nbytes(kd_p, arc_p), 2 * kd_p.numel() * int(math.log2(tile)),
        lambda: bitonic_sort_tiles(kd_p.view(-1), arc_p.view(-1), tile))
    rows[-1]["shapes"] = sort_shapes

    # segscan at its three shapes on the path: the chunk's Lemma 4.3 ranks
    # (sum over K x 2s), one batch's ranks on the per-batch route (sum over
    # 2s) and the stability patch over the chunk's tile-sorted edges (max
    # over K x s); 9 bytes an entry (values and flags in, the scan out)
    eks, eps = bitonic_sort_tiles(ek_p.view(-1), ep_p.view(-1), tile_e)
    scans = (
        (f"sum over {K * 2 * s} (chunk ranks)", "segscan", segscan, segscan_plain,
         torch.ones(K * 2 * s, dtype=torch.int32, device=dev),
         segment_starts(src).reshape(-1).contiguous()),
        (f"sum over {2 * s} (per-batch ranks)", "segscan", segscan, segscan_plain,
         torch.ones(2 * s, dtype=torch.int32, device=dev), segment_starts(src[0]).contiguous()),
        (f"max over {K * s} (stability patch)", "segmented_max_scan", segmented_max_scan,
         segmented_max_scan_plain, eps.view(K, tile_e)[:, :s].reshape(-1).contiguous(),
         segment_starts(eks.view(K, tile_e)[:, :s]).reshape(-1).contiguous()),
    )
    scan_shapes, err = [], 0.0
    for label, name, fn, plain, vals, flags in scans:
        got, want = fn(vals, flags), plain(vals, flags)
        require_equal(f"{name} full {label}", got, want)
        err = max(err, max_abs(got, want))
        b_ms, b_by = bound(nbytes(vals, flags) + nbytes(vals), 2 * vals.numel())
        # device times with the host kept out (device_ms); host_paced_ms is
        # the same calls back to back, which the wrapper's host cost paces
        scan_shapes.append({
            "shape": label, "launches_per_call": per_call(name, lambda: fn(vals, flags)),
            "ms": device_ms(lambda: fn(vals, flags)),
            "host_paced_ms": time_ms(lambda: fn(vals, flags), reps=20),
            "plain_ms": time_ms(lambda: plain(vals, flags)), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "unsegmented_cumsum_ms": device_ms(lambda: torch.cumsum(vals, 0, dtype=torch.int32))})
    main = scan_shapes[0]
    ones, flags = scans[0][4], scans[0][5]
    row("segscan", err, main["ms"], main["plain_ms"], None, nbytes(ones, flags) + nbytes(ones),
        2 * ones.numel(), lambda: segscan(ones, flags))
    # both wrappers run the one kernel: its launches on the path are theirs
    rows[-1]["launches"] += full["launches"]["segmented_max_scan"]
    rows[-1]["launches_by_wrapper"] = {k: full["launches"][k]
                                       for k in ("segscan", "segmented_max_scan")}
    rows[-1]["launches_local"] = local["launches"]["segscan"]
    rows[-1]["shapes"] = scan_shapes

    # multisearch_counts: the per-batch path's three searches (Q1 over
    # key_desc, Q2 over key_rank, step 3 over ekey); timed at Q1, the largest
    f1b = torch.full((r,), -1, dtype=torch.int32, device=dev)
    kd0, kr0, ek0 = key_desc[0].contiguous(), key_rank[0].contiguous(), ekey[0].contiguous()
    q1 = _q1_queries(s, state.f1[:, 0], state.f1[:, 1], f1b)
    q2 = pack2(state.f1[:, 0], torch.clamp(state.chi, min=0))
    q3 = _closing_query(state.f1, state.f2)[1]
    err, search_shapes = 0.0, []
    for name, keys, q in (("q1", kd0, q1), ("q2", kr0, q2), ("step3", ek0, q3)):
        got, want = multisearch_counts(keys, q), multisearch_counts_plain(keys, q)
        for side, a, b in zip(("lt", "le"), got, want):
            require_equal(f"multisearch {name} {side}", a, b)
            err = max(err, max_abs(a, b))
        depth = math.ceil(math.log2(keys.numel() + 1))
        search_shapes.append(shape(
            f"{name}: {q.numel()} queries into {keys.numel()} keys", "multisearch_counts",
            lambda keys=keys, q=q: multisearch_counts(keys, q),
            lambda keys=keys, q=q: multisearch_counts_plain(keys, q),
            lambda keys=keys, q=q: (torch.searchsorted(keys, q, side="left", out_int32=True),
                                    torch.searchsorted(keys, q, side="right", out_int32=True)),
            nbytes(keys, q) + 2 * 4 * q.numel(), 2 * 2 * q.numel() * depth))
    main = search_shapes[0]
    depth = math.ceil(math.log2(kd0.numel() + 1))
    row("multisearch_counts", err, main["ms"], main["plain_ms"], main["library_ms"],
        nbytes(kd0, q1) + 2 * 4 * q1.numel(), 2 * 2 * q1.numel() * depth,
        lambda: multisearch_counts(kd0, q1))
    rows[-1]["shapes"] = search_shapes

    # multisearch_counts on the deletion path: each estimator's f1, f2 and
    # closing edge (3r queries, negative for unset slots) into the sorted
    # keys of the tail's expiry batch (2^20, INT64 max past its 700,000
    # edges), over the window run's final state; launches are the window
    # run's (3 deletion batches and the tail's 3 searches)
    dk = delete_keys(dynamic["D"], dynamic["n_valid"])
    dq = _delete_queries(dynamic["state"])
    got, want = multisearch_counts(dk, dq), multisearch_counts_plain(dk, dq)
    for side, a, b in zip(("lt", "le"), got, want):
        require_equal(f"multisearch deletion {side}", a, b)
    # the probe's membership (le > lt) against the deletion oracle
    require_equal("multisearch deletion hits", got[1] > got[0], delete_hits_ref(dk, dq))
    depth = math.ceil(math.log2(dk.numel() + 1))
    row("multisearch_counts", max(max_abs(a, b) for a, b in zip(got, want)),
        time_ms(lambda: multisearch_counts(dk, dq), reps=20),
        time_ms(lambda: multisearch_counts_plain(dk, dq)),
        time_ms(lambda: (torch.searchsorted(dk, dq, side="left", out_int32=True),
                         torch.searchsorted(dk, dq, side="right", out_int32=True)), reps=20),
        nbytes(dk, dq) + 2 * 4 * dq.numel(), 2 * 2 * dq.numel() * depth,
        lambda: multisearch_counts(dk, dq), path=dynamic)
    rows[-1]["shape"] = (f"deletion: {dq.numel()} queries into {dk.numel()} keys "
                         f"({dynamic['n_valid']} below INT64 max)")
    rows[-1]["device_busy_ms"] = device_busy(lambda: multisearch_counts(dk, dq))["device_busy_ms"]

    # segment_sum: the local scheme's attribution scatter over the local
    # run's final state, 3r rows into n_vertices bins
    vals, ids = local["scheme"].attribution_inputs(local["state"], 0, r)
    m = local["scheme"].n_vertices
    got, want = segment_sum(vals, ids, m), segment_sum_plain(vals, ids, m)
    require_equal("segment_sum full", got, want)
    keep = (ids >= 0) & (ids < m)
    ids_in, vals_in = ids[keep].long(), vals[keep]
    kept = int(ids_in.numel())
    row("segment_sum", max_abs(got, want), device_ms(lambda: segment_sum(vals, ids, m)),
        time_ms(lambda: segment_sum_plain(vals, ids, m)),
        device_ms(lambda: torch.zeros((m, 1), dtype=torch.float64, device=dev).index_add_(
            0, ids_in, vals_in)),
        nbytes(ids) + 8 * kept + m * 8, kept, lambda: segment_sum(vals, ids, m),
        FP64_OPS_PER_S, local)
    rows[-1]["rows_in_range"] = kept
    # library_ms times index_add_ on rows already filtered into range, the
    # filter over every id left out; the second figure is one index_add_
    # over every row, the out-of-range ones sent to a spare bin
    rows[-1]["library_call"] = "zeros + index_add_ on the pre-filtered in-range rows"
    rows[-1]["host_paced_ms"] = time_ms(lambda: segment_sum(vals, ids, m))
    rows[-1]["library_ms_all_rows"] = device_ms(
        lambda: torch.zeros((m + 1, 1), dtype=torch.float64, device=dev).index_add_(
            0, torch.where((ids >= 0) & (ids < m), ids, m), vals)[:m])
    rows[-1]["library_call_all_rows"] = (
        "zeros(m + 1, d).index_add_(0, where(in_range, ids, m), values)[:m]")
    emit({"phase": "kernels", "ok": True})

    # where one chunk's device time goes on the kernel route (the structure
    # build, then fused_ingest, which draws its own randomness); the plain
    # route's hoisted draws and selects, which only it computes; and the
    # ragged tail batch on the per-batch route
    steps = torch.arange(K, dtype=torch.int64, device=dev)
    W_tail, n_tail = tail_batch(full["edges"], dev)
    emit({"phase": "breakdown",
          "chunk_ms": time_ms(lambda: bulk_update_chunk(state, Ws, nv, key, 0, backend="kernel"), reps=5),
          "structures_ms": time_ms(lambda: rank_all_chunk(Ws, nv, use_kernels=True), reps=5),
          "fused_ingest_ms": rows[0]["ms"],
          "plain_route_chunk_ms": time_ms(lambda: bulk_update_chunk(state, Ws, nv, key, 0,
                                                                    backend="fused"), reps=3),
          "plain_route_randomness_ms": time_ms(lambda: _chunk_randomness(state, nv, key, steps), reps=3),
          "plain_route_draws_and_selects_ms": time_ms(lambda: chunk_draws(state, Ws, nv, key, 0), reps=3),
          "tail_batch_ms": time_ms(lambda: bulk_update_all(state, W_tail, n_tail, key, "kernel"), reps=3),
          "chunk_profile": device_busy(lambda: bulk_update_chunk(state, Ws, nv, key, 0,
                                                                 backend="kernel")),
          "tail_batch_profile": device_busy(lambda: bulk_update_all(state, W_tail, n_tail, key,
                                                                    "kernel")),
          **build_splits(state, Ws, nv, W_tail, n_tail, key)})
    return rows


def phase_golden_serve(dev) -> None:
    """The LM serving path against the reference's float32 records
    (golden/lm_small.json, written by JAX), for each SMOKE arch with seed
    0's weights drawn on the card: forward and teacher-forced decode logits
    within 1e-4 of the largest |logit| with equal argmax, and the CLI's
    decoding loop's greedy tokens equal. TF32 is off, so a float32 matmul
    is a float32 matmul."""
    import dataclasses

    import torch

    from repro_torch import rng
    from repro_torch.launch.serve import generate, load_config
    from repro_torch.models import transformer as tt

    gold = json.loads((ROOT / "src/repro_torch/golden/lm_small.json").read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stride, out = gold["column_stride"], {}
    for arch, g in gold["archs"].items():
        cfg = dataclasses.replace(load_config(arch, smoke=True), dtype=torch.float32)
        params = tt.init_params(rng.PRNGKey(gold["param_seed"], dev), cfg)
        toks = torch.tensor(g["tokens"], dtype=torch.int32, device=dev)
        fwd = tt.logits_fn(params, cfg, tt.forward(params, cfg, toks)[0])
        B, S = toks.shape
        cache = tt.init_cache(cfg, B, S, dev)
        steps = []
        for i in range(S):
            lg, cache = tt.decode_step(params, cfg, cache, toks[:, i:i + 1])
            steps.append(lg[:, 0])
        dec = torch.stack(steps, dim=1)
        tol = gold["tolerance"] * g["max_abs_logit"]
        errs = {}
        for name, got in (("forward", fwd), ("decode", dec)):
            got = got.cpu().numpy()
            if not np.isfinite(got).all():
                raise AssertionError(f"golden_serve {arch}: {name} logits not finite")
            errs[name] = float(np.abs(got[..., ::stride] - np.array(g[name])).max())
            if errs[name] > tol:
                raise AssertionError(f"golden_serve {arch}: {name} max |diff| {errs[name]} "
                                     f"> {tol}")
        if fwd.argmax(-1).cpu().tolist() != g["argmax"]:
            raise AssertionError(f"golden_serve {arch}: forward argmax differs from JAX")
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (4, 8)).astype(np.int32)).to(dev)
        seq, _ = generate(params, cfg, prompt, 16)
        if seq.cpu().tolist() != g["greedy"]:
            raise AssertionError(f"golden_serve {arch}: greedy tokens differ from JAX")
        out[arch] = {"max_abs_err": errs, "tolerance": tol, "greedy_equal": True}
    emit({"phase": "golden_serve", "archs": out, "tf32": False, "ok": True})


# the bfloat16 tolerance of the model tests: a fraction of the largest |logit|
BF16_LOGIT_TOL = 3e-2


def phase_serve_full(dev, card: str) -> dict:
    """The serving path at full width through ``launch.serve.serve`` (the
    CLI's entry point), bfloat16, batch 4, prompt 8, 16 generated tokens:
    (a) smollm-135m FULL, twice (the first call pays cuBLAS's set-up):
    finite logits, and every decode step's logits within the bfloat16
    tolerance of ``forward``'s over the same sequence (the KV cache's check
    at full width); the second call's decode loop runs under CUDA's sync
    debug mode, counting host waits on the device, and one decode step's
    device busy time and operations; (b) granite-moe-1b-a400m FULL twice:
    equal tokens and finite logits. It records tok/s, decode seconds, ms a
    step, the params' bytes and what each decode loop allocated at its
    peak."""
    import warnings

    import torch

    from repro_torch.launch.serve import generate, serve
    from repro_torch.models import transformer as tt

    def memory(rs, params) -> dict:
        """tok/s and seconds of each run; the params' bytes, and the bytes
        each decode loop allocated at its peak beyond what the process held
        when it started (this script's earlier phases hold device memory
        too, so their absolute peak is not the serving path's)."""
        return {"params": sum(p.numel() for p in params.values()),
                "param_bytes": nbytes(*params.values()),
                "tok_per_s": [r["tok_per_s"] for r in rs], "seconds": [r["seconds"] for r in rs],
                "decode_extra_peak_bytes": [r["peak_device_bytes"] - r["held_device_bytes"]
                                            for r in rs],
                "held_device_bytes": [r["held_device_bytes"] for r in rs]}

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": card}
    runs = [serve("smollm-135m", False, 4, 8, 16, 0, dev.type, keep_logits=True)
            for _ in range(2)]
    a = runs[1]
    cfg, params, seq = a["cfg"], a["params"], a["seq"]
    if not torch.equal(runs[0]["seq"], seq):
        raise AssertionError("serve_full smollm: two runs decode different tokens")
    steps = torch.stack(a["logits"], dim=1).float()  # (B, P + gen - 1, V)
    fwd = tt.logits_fn(params, cfg, tt.forward(params, cfg, seq[:, :-1])[0]).float()
    if not (torch.isfinite(steps).all() and torch.isfinite(fwd).all()):
        raise AssertionError("serve_full smollm: logits not finite")
    err = float((steps - fwd).abs().max())
    scale = float(fwd.abs().max())
    if err > BF16_LOGIT_TOL * scale:
        raise AssertionError(f"serve_full smollm: decode vs forward max |diff| {err} > "
                             f"{BF16_LOGIT_TOL} x {scale}")
    # the decode loop again, under the sync debug mode: each synchronising
    # call (a device value read on the host) warns once
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            generate(params, cfg, a["prompt"], 16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    # one decode step (from a fresh cache): the device's busy time and its
    # operations, beside the loop's wall time per step
    step = device_busy(lambda: tt.decode_step(params, cfg, tt.init_cache(cfg, 4, 24, dev),
                                              seq[:, :1]), top=5)
    out["smollm-135m"] = {
        **memory(runs, params), "decode_vs_forward_max_abs_err": err, "max_abs_logit": scale,
        "tolerance": BF16_LOGIT_TOL * scale, "host_syncs_in_decode_loop": syncs,
        "ms_per_step": [r["seconds"] * 1e3 / 23 for r in runs], "step_profile": step,
        "sample": seq[0, :16].tolist()}
    del runs, a, params, steps, fwd
    torch.cuda.empty_cache()
    moe = [serve("granite-moe-1b-a400m", False, 4, 8, 16, 0, dev.type, keep_logits=True)
           for _ in range(2)]
    if not torch.equal(moe[0]["seq"], moe[1]["seq"]):
        raise AssertionError("serve_full granite: two runs decode different tokens")
    if not all(torch.isfinite(lg).all() for r in moe for lg in r["logits"]):
        raise AssertionError("serve_full granite: logits not finite")
    out["granite-moe-1b-a400m"] = {**memory(moe, moe[0]["params"]), "runs_equal": True,
                                   "ms_per_step": [r["seconds"] * 1e3 / 23 for r in moe],
                                   "sample": moe[0]["seq"][0, :16].tolist()}
    del moe
    torch.cuda.empty_cache()
    emit({"phase": "serve_full", "batch": 4, "prompt": 8, "gen": 16, "dtype": "bfloat16",
          **out, "ok": True})
    return out


# the bfloat16 tolerance of the training tests' first logged loss (relative)
BF16_LOSS_RTOL = 3e-2


def phase_golden_train(dev) -> None:
    """The LM training path against the reference's float32 records
    (golden/train_small.json, written by JAX), for each SMOKE arch with
    seed 0's weights drawn on the card, TF32 off: the step-0 loss, each
    leaf's gradient norm and every 4th column of the embedding's gradient,
    and the losses of 3 steps of the arch's optimizer on the golden
    batches, each within the CPU tests' tolerance."""
    import dataclasses

    import torch

    from repro_torch import rng
    from repro_torch.configs.cells import LM_ARCHS
    from repro_torch.data.tokens import lm_batches, synthetic_corpus
    from repro_torch.launch.train import load_config
    from repro_torch.models import transformer as tt
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.steps import make_lm_train_step, value_and_grad

    gold = json.loads((ROOT / "src/repro_torch/golden/train_small.json").read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for arch, g in gold["archs"].items():
        cfg = dataclasses.replace(load_config(arch, smoke=True), dtype=torch.float32)
        params = tt.init_params(rng.PRNGKey(gold["param_seed"], dev), cfg)
        opt = get_optimizer(LM_ARCHS[arch][1], gold["lr"])
        step = make_lm_train_step(cfg, opt)
        data = lm_batches(synthetic_corpus(gold["corpus_tokens"], cfg.vocab, gold["data_seed"]),
                          gold["B"], gold["S"], gold["data_seed"])
        state, losses = opt.init(params), []
        for i in range(gold["steps"]):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
            if i == 0:
                loss, grads = value_and_grad(
                    lambda p, b: tt.lm_loss(p, cfg, b["tokens"], b["labels"]), params, batch)
            params, state, m = step(params, state, batch, None)
            losses.append(float(m["loss"]))
        if not all(bool(torch.isfinite(x).all()) for x in grads.values()):
            raise AssertionError(f"golden_train {arch}: gradients not finite")
        errs = {"loss_rel_err": abs(float(loss) - g["loss"]) / abs(g["loss"])}
        errs["grad_norm_rel_err"] = max(
            abs(float(torch.linalg.vector_norm(grads[k].double())) - n) / n
            for k, n in g["grad_norms"].items())
        emb = grads["embed"].cpu().numpy()[:, ::gold["column_stride"]]
        errs["embed_grad_err"] = float(np.abs(emb - np.array(g["embed_grad"])).max()) / g[
            "embed_grad_max"]
        errs["step_loss_rel_err"] = max(abs(a - b) / abs(b)
                                        for a, b in zip(losses, g["step_losses"]))
        for name, limit in (("loss_rel_err", gold["loss_rtol"]),
                            ("grad_norm_rel_err", gold["grad_tol"]),
                            ("embed_grad_err", gold["grad_tol"]),
                            ("step_loss_rel_err", gold["step_loss_rtol"])):
            if errs[name] > limit:
                raise AssertionError(f"golden_train {arch}: {name} {errs[name]} > {limit}")
        out[arch] = {**errs, "step_losses": losses}
    emit({"phase": "golden_train", "archs": out, "tf32": False, "ok": True})


def train_records(run: dict, card: str) -> dict:
    """One train step of a ``launch.train.build`` result at its batch:
    ms a step (CUDA events over 5 steps after 2 warm-up steps, each on the
    state the last left), tokens/s, one step's device busy ms and device
    operations (torch.profiler), the step's peak bytes beyond what was
    held before it, the params' and the optimizer state's bytes, and MFU =
    6 N tokens / (step s x 989e12), N the params a token meets (the active
    params of an MoE), 989e12 being ``roofline.report.PEAK_FLOPS``."""
    import torch

    from repro_torch.roofline.report import PEAK_FLOPS

    cfg, dev = run["cfg"], run["device"]
    data = run["batches"]()
    batch = next(data)
    tokens = batch["tokens"].size
    state = [(run["params"], run["opt_state"])]

    def one():
        state[0], _ = run["step_fn"](state[0], batch, 0)

    ms = time_ms(one, reps=5, warmup=2)
    busy = device_busy(one, top=6)
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    one()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    n = cfg.active_param_count()
    return {"card": card, "ms_per_step": ms, "tokens_per_step": tokens,
            "tokens_per_s": tokens / (ms / 1e3), "step_profile": busy,
            "device_idle_share": 1.0 - busy["device_busy_ms"] / ms,
            "step_peak_bytes_beyond_held": peak - held, "held_bytes": held,
            "param_bytes": nbytes(*tensors(state[0][0])),
            "opt_state_bytes": nbytes(*tensors(state[0][1])), "params_per_token": n,
            "mfu": 6 * n * tokens / (ms / 1e3 * PEAK_FLOPS)}


def tensors(tree):
    """The tensors of a tree of dicts."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    else:
        yield tree


class InjectedFailure(RuntimeError):
    """The step failure phase train_full injects."""


def phase_train_full(dev, card: str) -> dict:
    """The LM training path at full width, bfloat16, through the training
    CLI's own functions (``launch.train.build`` and ``train``) at the
    reference CLI's defaults: batch 8, seq 256, adamw at 3e-4, 2,000,000
    corpus tokens, remat off. (a) smollm-135m FULL, 30 steps with
    asynchronous checkpoints every 10: the last logged loss below the
    first. (b) Kill and resume: a run on a fresh directory saves at step
    10 and is cut at step 15 by a failure that outlasts max_retries = 1
    (restored once to step 10, failing at 15 again); a third run on that
    directory resumes at step 11 and ends at step 29; it must equal, bit
    for bit, a run that loads the step-10 checkpoint and takes the same 19
    steps on the stream's first 19 batches (a resumed run draws from the
    start of a fresh stream, as in the reference). Both run under
    ``torch.use_deterministic_algorithms(True)`` (cuBLAS on one stream with
    a fixed workspace, and the embedding's and the loss gather's backward
    by their sorted, deterministic kernels rather than atomics), so the
    comparison is exact. (c) granite-moe-1b-a400m FULL, 5 steps at the
    same batch and sequence: finite losses. Each records a step's ms,
    tokens/s, device busy ms and operations, peak bytes, the params' and
    the optimizer state's bytes and MFU."""
    import torch

    from repro_torch.launch.train import build, train
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.trainer import TrainerConfig, run_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    args = {"batch": 8, "seq": 256, "lr": 3e-4, "corpus_tokens": 2_000_000, "seed": 0}
    root = Path(tempfile.mkdtemp(prefix="train_full_"))
    out = {"card": card, **args}
    try:
        def smollm():
            return build("smollm-135m", False, args["lr"], args["seed"], args["batch"],
                         args["seq"], args["corpus_tokens"], dev.type)

        def tcfg(name, **kw):
            return TrainerConfig(ckpt_dir=str(root / name), ckpt_every=10, async_save=True,
                                 log_every=10, **kw)

        run = smollm()
        _, log, seconds, tput = train(run, 30, tcfg("a"), args["lr"], args["batch"], args["seq"])
        if not (log.losses and all(math.isfinite(x) for x in log.losses)
                and log.losses[-1] < log.losses[0]):
            raise AssertionError(f"train_full smollm: losses {log.losses} do not fall")
        out["smollm-135m"] = {"run_seconds": seconds, "run_tokens_per_s": tput,
                              "logged_steps": log.steps, "logged_losses": log.losses,
                              **train_records(smollm(), card)}
        shutil.rmtree(root / "a")

        # (b) kill and resume
        cut = smollm()

        def failing(state, batch, i):
            if i == 15:
                raise InjectedFailure(f"injected failure at step {i}")
            return cut["step_fn"](state, batch, i)

        try:
            run_loop(failing, (cut["params"], cut["opt_state"]), cut["batches"](), 30,
                     tcfg("b", max_retries=1))
        except InjectedFailure:
            pass
        else:
            raise AssertionError("train_full: the injected failure did not cut the run")
        if CheckpointManager(str(root / "b")).steps() != [10]:
            raise AssertionError("train_full: the cut run left "
                                 f"{CheckpointManager(str(root / 'b')).steps()}, not [10]")
        torch.use_deterministic_algorithms(True)
        try:
            resumed = smollm()
            (params, opt_state), rlog = run_loop(
                resumed["step_fn"], (resumed["params"], resumed["opt_state"]),
                resumed["batches"](), 30, tcfg("b"))
            ref = smollm()
            st, _ = CheckpointManager(str(root / "b")).restore(
                (ref["params"], ref["opt_state"]), step=10)
            data = ref["batches"]()
            for i in range(11, 30):
                st, _ = ref["step_fn"](st, next(data), i)
            torch.cuda.synchronize(dev)
        finally:
            torch.use_deterministic_algorithms(False)
        if rlog.restarts != 1 or rlog.steps != [20] or int(opt_state["count"]) != 30:
            raise AssertionError(f"train_full resume: restarts {rlog.restarts}, logged "
                                 f"{rlog.steps}, count {int(opt_state['count'])}")
        for k in params:
            for name, got, want in (("param", params[k], st[0][k]),
                                    ("m", opt_state["m"][k], st[1]["m"][k]),
                                    ("v", opt_state["v"][k], st[1]["v"][k])):
                if not torch.equal(got, want):
                    raise AssertionError(f"train_full resume: {name} {k} differs from the "
                                         "run loaded from the step-10 checkpoint")
        out["resume"] = {"deterministic_algorithms": True, "cut_at_step": 15,
                         "resumed_from_step": 10, "end_step": 29, "restarts": rlog.restarts,
                         "bit_equal": True, "resumed_run_seconds": rlog.seconds}
        del run, cut, resumed, ref, params, opt_state, st
        torch.cuda.empty_cache()

        # (c) the MoE at full width
        moe = build("granite-moe-1b-a400m", False, args["lr"], args["seed"], args["batch"],
                    args["seq"], args["corpus_tokens"], dev.type)
        state, data, losses = (moe["params"], moe["opt_state"]), moe["batches"](), []
        for i in range(5):
            state, m = moe["step_fn"](state, next(data), i)
            losses.append(float(m["loss"]))
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train_full granite: losses {losses} not finite")
        moe["params"], moe["opt_state"] = state
        out["granite-moe-1b-a400m"] = {"losses": losses, **train_records(moe, card)}
        del moe, state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "train_full", **out, "ok": True})
    return out


def phase_train_elastic(dev, full: dict) -> dict:
    """Phase full's r = 2^21 state after its two chunks, resized by
    ``train.elastic.shrink_or_grow_estimators`` to 2^20 and 2^22: the kept
    prefix bit-equal and the appended rows empty; each resized state then
    ingests phase full's ragged tail (per-batch route) and one further
    chunk (chunk 1's edges again, at step 2K + 1) on the kernel route,
    equal bit for bit to the plain route (eager searches, the scan chunk).
    Then ``reshard`` of the 2^21 state onto ``estimators=4`` on this card
    and one pjit update with the tail equal to the same update
    unsharded."""
    import torch

    from repro_torch import rng as trng
    from repro_torch.core import bulk
    from repro_torch.core.distributed import GLOBAL, make_pjit_update, scheme_state_specs
    from repro_torch.core.state import init_state
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_stream_mesh
    from repro_torch.train.elastic import reshard, shrink_or_grow_estimators

    edges, s, K, r = full["edges"], FULL["s"], FULL["K"], FULL["r"]
    key = trng.PRNGKey(FULL["seed"], dev)
    nv = torch.full((K,), s, dtype=torch.int32, device=dev)
    chunks = [torch.from_numpy(edges[c * K * s:(c + 1) * K * s].reshape(K, s, 2)).to(dev)
              for c in range(2)]
    state = init_state(r, dev)
    for c in range(2):
        state = bulk.bulk_update_chunk(state, chunks[c], nv, key, c * K, backend="kernel")
    W_tail, n_tail = tail_batch(edges, dev)
    k_tail = trng.fold_in(key, 2 * K)
    out = {}
    for new_r in (2**20, 2**22):
        rs = shrink_or_grow_estimators(state, new_r)
        keep = min(new_r, r)
        for f in ("f1", "chi", "f2", "has_f3"):
            require_equal(f"train_elastic r={new_r} prefix {f}", getattr(rs, f)[:keep],
                          getattr(state, f)[:keep])
        if new_r > r and not (bool((rs.f1[r:] == -1).all()) and bool((rs.f2[r:] == -1).all())
                              and bool((rs.chi[r:] == 0).all()) and not bool(rs.has_f3[r:].any())):
            raise AssertionError(f"train_elastic r={new_r}: the appended rows are not empty")
        require_equal(f"train_elastic r={new_r} m_seen", rs.m_seen, state.m_seen)
        reset_launches()
        got = bulk.bulk_update_all(rs, W_tail, n_tail, k_tail, "kernel")
        got = bulk.bulk_update_chunk(got, chunks[0], nv, key, 2 * K + 1, backend="kernel")
        torch.cuda.synchronize(dev)
        launches = {k: LAUNCHES[k] for k in ("fused_ingest", "multisearch_counts",
                                             "bitonic_sort_tiles", "segscan")}
        if launches["fused_ingest"] == 0 or launches["multisearch_counts"] == 0:
            raise AssertionError(f"train_elastic r={new_r}: kernels not launched {launches}")
        want = bulk.bulk_update_all(rs, W_tail, n_tail, k_tail, "eager")
        want = bulk.bulk_update_chunk(want, chunks[0], nv, key, 2 * K + 1, backend="scan",
                                      search="eager")
        for f in want._fields:
            require_equal(f"train_elastic r={new_r} ingest {f}", getattr(got, f),
                          getattr(want, f))
        out[str(new_r)] = {"prefix_equal": True, "kernel_equals_plain": True,
                           "launches": launches}
    mesh = make_stream_mesh("estimators=4", dev.type, host_devices=4)
    placed = reshard(state, mesh, scheme_state_specs(GLOBAL, ("estimators",)))
    back = placed.gather(dev)
    for f in state._fields:
        require_equal(f"train_elastic reshard {f}", getattr(back, f), getattr(state, f))
    update = make_pjit_update(mesh, "coordinated_xla", GLOBAL, r=r, search="kernel")
    got = update(placed, W_tail, n_tail, k_tail).gather(dev)
    want = bulk.bulk_update_all(state, W_tail, n_tail, k_tail, "kernel")
    for f in want._fields:
        require_equal(f"train_elastic pjit after reshard {f}", getattr(got, f), getattr(want, f))
    out["reshard_estimators_4"] = {"roundtrip_equal": True, "pjit_equals_unsharded": True}
    emit({"phase": "train_elastic", "r": r, **out, "ok": True})
    return out


# --------------------------------------------------------------------------
# the GNN, equivariant and recsys families
# --------------------------------------------------------------------------
# the sampled shape: 1,024 seeds at fanouts [15, 10] (minibatch_lg), over a
# graph of ogbn-products' size
OGB_PRODUCTS = {"vertices": 2_449_029, "edges": 61_859_140}
MINIBATCH = {"seeds": 1024, "fanouts": [15, 10], "d_feat": 602, "targets": 227}
# the equivariant models' energy under a rotation plus a translation of the
# coordinates, in float64 (relative)
INV_RTOL = 1e-4


def gnn_smoke_case(name: str, batch: dict, dev) -> dict:
    """One SMOKE arch of golden/gnn_small.json as the CPU tests build it
    (tests/test_torch_gnn.py::arch_case): the port's config, its batch on
    ``dev`` in the reference's dtypes, and its init, forward, loss and
    step builder."""
    import dataclasses

    import torch

    from repro_torch.configs import egnn, gat_cora, graphcast, mace
    from repro_torch.configs.cells import GNN_SMOKE_SHAPES
    from repro_torch.models import equivariant as eqv
    from repro_torch.models import gnn
    from repro_torch.train import steps

    dtypes = {"node_feats": torch.float32, "edge_index": torch.int32, "labels": torch.int32,
              "label_mask": torch.float32, "targets": torch.float32, "coords": torch.float32,
              "edge_mask": torch.bool, "energy": torch.float32}
    b = {k: torch.tensor(v, dtype=dtypes[k], device=dev) for k, v in batch.items()}
    if name in ("egnn", "mace"):
        cfg = {"egnn": egnn, "mace": mace}[name].SMOKE

        def fwd(p, b):
            args = (b["node_feats"], b["coords"], b["edge_index"], b["edge_mask"])
            if cfg.kind == "egnn":
                e, x = eqv.egnn_forward(p, cfg, *args)
                return torch.cat([e.reshape(1), x.reshape(-1)])
            return eqv.mace_forward(p, cfg, *args).reshape(1)

        return {"cfg": cfg, "batch": b, "init": eqv.init_params, "forward": fwd,
                "loss": lambda p, b: eqv.energy_loss(p, cfg, b["node_feats"], b["coords"],
                                                     b["edge_index"], b["edge_mask"],
                                                     b["energy"]),
                "step": steps.make_equivariant_train_step}
    if name == "graphcast":
        cfg = dataclasses.replace(graphcast.smoke(12, 9), remat=True)
    else:
        sh = GNN_SMOKE_SHAPES[name.split(":")[1]]
        cfg = gat_cora.smoke(sh["d_feat"], sh["n_classes"])
    if "targets" in b:
        loss = lambda p, b: gnn.regression_loss(  # noqa: E731
            p, cfg, b["node_feats"], b["edge_index"], b["targets"])
    else:
        loss = lambda p, b: gnn.node_classification_loss(  # noqa: E731
            p, cfg, b["node_feats"], b["edge_index"], b["labels"], b["label_mask"])
    return {"cfg": cfg, "batch": b, "init": gnn.init_params,
            "forward": lambda p, b: gnn.forward(p, cfg, b["node_feats"], b["edge_index"]),
            "loss": loss, "step": steps.make_gnn_train_step}


def flat_tree(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_tree(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def norm_rel_err(grad, norm: float) -> float:
    """A gradient's norm against the reference's, relative; where the
    reference's is zero (a leaf the loss does not reach), the norm itself."""
    import torch

    n = float(torch.linalg.vector_norm(grad.double()))
    return abs(n - norm) / norm if norm else n


def phase_golden_gnn(dev) -> None:
    """The GNN, equivariant and recsys families against the reference's
    float32 records (golden/gnn_small.json, written by JAX), seed 0's
    weights drawn on the card, TF32 off: for gat-cora on two smoke shapes,
    graphcast (remat on, on a sample_khop batch), egnn and mace, the
    forward within 1e-5 of the largest |output|, the step-0 loss within
    1e-5 relative, each leaf's gradient norm within 1e-4, and 3 adamw steps'
    losses within 1e-4; for bert4rec the cloze mask and negatives bit for
    bit, the loss, gradient norms and 3 steps likewise, and score_candidates
    of both shapes within 1e-5 of the largest |score|; sample_khop's arrays
    equal."""
    import torch

    from repro_torch import rng
    from repro_torch.configs import bert4rec as b4r_cfg
    from repro_torch.data.sampler import CSRGraph, sample_khop
    from repro_torch.models import bert4rec as b4r
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.steps import (make_recsys_score_step, make_recsys_train_step,
                                         value_and_grad)

    gold = json.loads((ROOT / "src/repro_torch/golden/gnn_small.json").read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}

    def check(name, errs):
        for key, limit in (("forward_err", gold["fwd_tol"]), ("loss_rel_err", gold["loss_rtol"]),
                           ("grad_norm_rel_err", gold["grad_tol"]),
                           ("step_loss_rel_err", gold["step_loss_rtol"])):
            if key in errs and not errs[key] <= limit:
                raise AssertionError(f"golden_gnn {name}: {key} {errs[key]} > {limit}")
        out[name] = errs

    def steps_of(step, params, batch, keys):
        opt = adamw(lr=gold["lr"])
        state, losses = opt.init(params), []
        for k in keys:
            params, state, m = step(params, state, batch, k)
            losses.append(float(m["loss"]))
        return losses

    def rel(got, want):
        return max(abs(a - b) / abs(b) for a, b in zip(got, want))

    for name, g in gold["archs"].items():
        c = gnn_smoke_case(name, g["batch"], dev)
        params = c["init"](rng.PRNGKey(gold["param_seed"], dev), c["cfg"])
        with torch.no_grad():
            fwd = c["forward"](params, c["batch"]).cpu().numpy()
        if not np.isfinite(fwd).all():
            raise AssertionError(f"golden_gnn {name}: forward not finite")
        loss, grads = value_and_grad(c["loss"], params, c["batch"])
        losses = steps_of(c["step"](c["cfg"], adamw(lr=gold["lr"])), params, c["batch"],
                          [rng.PRNGKey(i, dev) for i in range(gold["steps"])])
        check(name, {
            "forward_err": float(np.abs(fwd - np.array(g["forward"])).max()) / g[
                "max_abs_forward"],
            "loss_rel_err": abs(float(loss) - g["loss"]) / abs(g["loss"]),
            "grad_norm_rel_err": max(norm_rel_err(v, g["grad_norms"][k])
                                     for k, v in flat_tree(grads)),
            "step_loss_rel_err": rel(losses, g["step_losses"]), "step_losses": losses})

    g = gold["bert4rec"]
    cfg = b4r_cfg.SMOKE
    items = torch.tensor(g["items"], dtype=torch.int32, device=dev)
    params = b4r.init_params(rng.PRNGKey(gold["param_seed"], dev), cfg)
    key = rng.PRNGKey(g["key_seed"], dev)
    mask, negs = b4r.cloze_draws(cfg, tuple(items.shape), key, g["n_neg"])
    np.testing.assert_array_equal(mask.cpu().numpy(), np.array(g["mask"]),
                                  err_msg="golden_gnn bert4rec cloze mask")
    np.testing.assert_array_equal(negs.cpu().numpy(), np.array(g["negs"], np.int32),
                                  err_msg="golden_gnn bert4rec negatives")
    loss, grads = value_and_grad(lambda p, b: b4r.cloze_loss(p, cfg, b, key, g["n_neg"]),
                                 params, items)
    losses = steps_of(make_recsys_train_step(cfg, adamw(lr=gold["lr"])), params,
                      {"items": items}, [rng.PRNGKey(i, dev) for i in range(gold["steps"])])
    score = make_recsys_score_step(cfg)
    score_err = max(
        float(np.abs(score(params, {"items": items, "candidates": torch.tensor(
            g[cands], dtype=torch.int32, device=dev)}).cpu().numpy()
            - np.array(g[want])).max()) / g["max_abs_score"]
        for cands, want in (("cand1", "scores1"), ("cand2", "scores2")))
    check("bert4rec", {
        "cloze_draws_equal": True, "forward_err": score_err,
        "loss_rel_err": abs(float(loss) - g["loss"]) / abs(g["loss"]),
        "grad_norm_rel_err": max(norm_rel_err(v, g["grad_norms"][k])
                                 for k, v in flat_tree(grads)),
        "step_loss_rel_err": rel(losses, g["step_losses"]), "step_losses": losses})

    s = gold["sampler"]
    got = sample_khop(CSRGraph(s["graph_nodes"], np.array(s["edges"])), np.array(s["seeds"]),
                      s["fanouts"], np.random.default_rng(s["rng_seed"]))
    for name, a, want in (("nodes", got[0], s["nodes"]), ("edge_index", got[1], s["edge_index"]),
                          ("edge_mask", got[2], s["edge_mask"])):
        np.testing.assert_array_equal(a, np.array(want, dtype=a.dtype),
                                      err_msg=f"golden_gnn sample_khop {name}")
    if got[3] != s["n_real"]:
        raise AssertionError(f"golden_gnn sample_khop: {got[3]} real nodes, not {s['n_real']}")
    emit({"phase": "golden_gnn", "archs": out, "sampler_equal": True, "tf32": False, "ok": True})


def phase_gnn_features(dev, card: str) -> dict:
    """examples/gnn_features.py at its own size through
    ``launch.gnn_features.run``: a 1,500-vertex Barabasi-Albert stream (k = 6)
    into 50,000 estimators in batches of 2,048 on the per-batch kernel route,
    then 60 adamw steps of a GAT on the streamed density. The launch counts
    are set to 0 just before and read just after: multisearch_counts, the
    tile sort and segscan must each have launched. triangles/edge must equal
    the reference's exactly, the step-0 loss within 1e-5 relative, and from
    the reference's params at steps 0, 20, 40 and 59 (golden/gnn_small.json)
    each step's loss within 1e-5 relative and its gradient norms within 1e-4:
    free-running, the two trajectories part by chaos, not by a fault (the
    reference parts from itself as far under a permutation of its edge
    list; tests/test_torch_gnn.py), so their losses are recorded beside the
    reference's, not gated. The loss must fall."""
    import torch

    from repro_torch.data.graph_stream import barabasi_albert_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import gnn_features
    from repro_torch.models.gnn import node_classification_loss
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.steps import value_and_grad

    gf = json.loads((ROOT / "src/repro_torch/golden/gnn_small.json").read_text())["gnn_features"]
    torch.backends.cuda.matmul.allow_tf32 = False
    a = gf["args"]
    lines = []
    reset_launches()
    run = gnn_features.run(**a, device=dev, echo=lines.append)
    torch.cuda.synchronize(dev)
    launches = {k: LAUNCHES[k] for k in ("multisearch_counts", "bitonic_sort_tiles", "segscan")}
    if not all(launches.values()):
        raise AssertionError(f"gnn_features: kernels not launched on the stream: {launches}")
    if run["triangles_per_edge"] != gf["triangles_per_edge"]:
        raise AssertionError(f"gnn_features: triangles/edge {run['triangles_per_edge']!r} != "
                             f"JAX {gf['triangles_per_edge']!r}")
    losses, want = run["losses"], gf["losses"]
    step0 = abs(losses[0] - want[0]) / want[0]
    if not (step0 <= gf["loss_rtol"] and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"gnn_features: losses {losses[0]} .. {losses[-1]} against JAX "
                             f"{want[0]} .. {want[-1]}")
    edges = barabasi_albert_stream(n=a["n"], k=a["k"], seed=a["graph_seed"])
    data = gnn_features.node_task(edges, a["n"], run["triangles_per_edge"], dev)
    teacher = {}
    for i, t in gf["teacher"].items():
        params = tree_map(lambda x: torch.tensor(x, dtype=torch.float32, device=dev),
                          t["params"])
        loss, grads = value_and_grad(
            lambda p, b: node_classification_loss(p, gnn_features.CFG, b["node_feats"],
                                                  b["edge_index"], b["labels"],
                                                  b["label_mask"]), params, data)
        errs = {"loss_rel_err": abs(float(loss) - t["loss"]) / t["loss"],
                "grad_norm_rel_err": max(norm_rel_err(v, t["grad_norms"][k])
                                         for k, v in flat_tree(grads))}
        if errs["loss_rel_err"] > gf["loss_rtol"] or errs["grad_norm_rel_err"] > gf["grad_tol"]:
            raise AssertionError(f"gnn_features step {i} from the reference's params: {errs}")
        teacher[i] = errs
    out = {"card": card, "args": a, "edges": run["edges"],
           "triangles_per_edge": run["triangles_per_edge"], "launches": launches,
           "step0_loss_rel_err": step0, "teacher_forced": teacher,
           "free_running_losses": {i: [losses[i], want[i]] for i in (0, 20, 40, 59)},
           "free_running_max_rel_dev": max(abs(x - y) / y for x, y in zip(losses, want)),
           "stream_host_s": run["stream_seconds"], "train_host_s": run["train_seconds"],
           "ms_per_gat_step": run["train_seconds"] * 1e3 / a["steps"], "lines": lines}
    emit({"phase": "gnn_features", **out, "ok": True})
    return out


SECONDS = re.compile(r" in [0-9.]+s")


def phase_examples(dev, card: str) -> dict:
    """The reference's quickstart, streaming and train_lm examples through
    the port's entry points, held to what the reference's own scripts print
    at their own sizes (golden/examples_small.json). Around each stream the
    launch counts are set to 0 and read after: multisearch_counts, the tile
    sort and segscan must each have launched. The quickstart's line must
    equal the golden's exactly, the streaming example's lines but for the
    seconds (its determinism assert must hold), and train_lm's arch= line
    exactly and its first logged loss within BF16_LOSS_RTOL."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import quickstart, streaming_triangle_count

    gold = json.loads((ROOT / "src/repro_torch/golden/examples_small.json").read_text())
    out = {"card": card}

    def counted(name: str, kernels: tuple, fn) -> dict:
        lines = []
        reset_launches()
        t0 = time.perf_counter()
        res = fn(lines.append)
        torch.cuda.synchronize(dev)
        host_s = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in kernels}
        if not all(launches.values()):
            raise AssertionError(f"examples {name}: kernels not launched: {launches}")
        out[name] = {"host_s": host_s, "launches": launches, "lines": lines}
        return res

    q = counted("quickstart", BATCH_KERNELS, lambda echo: quickstart.run(
        **gold["quickstart"]["args"], device=dev, echo=echo))
    if out["quickstart"]["lines"] != [gold["quickstart"]["line"]]:
        raise AssertionError(f"examples quickstart: {out['quickstart']['lines']} != "
                             f"JAX {gold['quickstart']['line']!r}")
    out["quickstart"]["state_sha256"] = q["state_sha256"]

    args = dict(gold["streaming"]["args"], seeds=tuple(gold["streaming"]["args"]["seeds"]))
    ckpt_dir = tempfile.mkdtemp(prefix="examples_stream_")
    try:
        # the engine's lone batches go as one-batch chunks through fused_ingest
        st = counted("streaming", CHUNK_KERNELS, lambda echo: streaming_triangle_count.run(
            **args, ckpt_dir=ckpt_dir, device=dev, echo=echo))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    shown = SECONDS.sub("", "\n".join(out["streaming"]["lines"])).splitlines()
    if shown != gold["streaming"]["lines"]:
        raise AssertionError(f"examples streaming: {shown} != JAX {gold['streaming']['lines']}")
    out["streaming"].update(phase1_s=st["phase1"].seconds, resumed_from=st["resumed_from"],
                            estimates=st["estimates"].tolist())

    tgold = gold["train_lm"]
    ckpt_dir = tempfile.mkdtemp(prefix="examples_train_lm_")
    t0 = time.perf_counter()
    try:
        text = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train_lm", "--steps", "20",
             "--ckpt-every", "10", "--ckpt-dir", ckpt_dir], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), capture_output=True, text=True,
            timeout=600, check=True).stdout
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    lines = text.splitlines()
    first = float(next(ln for ln in lines if ln.startswith("loss: first logged ="))
                  .split("=")[1].split()[0])
    if lines[0] != tgold["arch_line"]:
        raise AssertionError(f"examples train_lm: {lines[0]!r} != JAX {tgold['arch_line']!r}")
    if abs(first - tgold["first_loss"]) > BF16_LOSS_RTOL * tgold["first_loss"]:
        raise AssertionError(f"examples train_lm: first logged loss {first} vs JAX "
                             f"{tgold['first_loss']}")
    out["train_lm"] = {"host_s": time.perf_counter() - t0, "lines": lines,
                       "first_loss_rel_err": abs(first - tgold["first_loss"]) / tgold["first_loss"]}
    emit({"phase": "examples", **out, "ok": True})
    return out


def model_records(one, n_steps: int, params, extra=(), card: str = "") -> dict:
    """``n_steps`` calls of ``one`` (each returning its loss or output), each
    timed by CUDA events; the peak bytes those calls allocated beyond what
    was held before them; one more call's device busy ms over its device
    operations (``device_busy``, which calls ``one`` twice); the params'
    bytes (and ``extra``'s, the optimizer state)."""
    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms, outs = [], []
    for _ in range(n_steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        outs.append(one())
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    peak = torch.cuda.max_memory_allocated()
    busy = device_busy(one, top=5)
    steady = sorted(ms[1:] or ms)[len(ms[1:] or ms) // 2]
    return {"card": card, "ms": ms, "ms_per_step_median_after_first": steady,
            "step_profile": busy, "device_idle_share": 1.0 - busy["device_busy_ms"] / steady,
            "peak_bytes_beyond_held": peak - held, "held_bytes": held,
            "param_bytes": nbytes(*tensors(params)),
            "opt_state_bytes": nbytes(*(t for e in extra for t in tensors(e)))}, outs


def molecule_batch(n_atoms: int, n_edges: int, d: int, seed: int, dev) -> dict:
    """Molecules of 30 atoms (normal coordinates around a random centre, a
    1.5 A spread) whose edges join two distinct atoms of one molecule,
    n_edges / molecules of them each; atom features normal of width d."""
    import torch

    g = np.random.default_rng(seed)
    per, n_mol = 30, n_atoms // 30
    centre = np.repeat(g.normal(scale=20.0, size=(n_mol, 3)), per, axis=0)
    coords = centre + 1.5 * g.normal(size=(n_atoms, 3))
    k = n_edges // n_mol
    base = np.repeat(np.arange(n_mol) * per, k)
    src = g.integers(0, per, n_mol * k)
    dst = (src + g.integers(1, per, n_mol * k)) % per  # never src
    ei = np.stack([base + src, base + dst]).astype(np.int32)
    return {"node_feats": torch.from_numpy(g.normal(size=(n_atoms, d)).astype(np.float32)).to(dev),
            "coords": torch.from_numpy(coords.astype(np.float32)).to(dev),
            "edge_index": torch.from_numpy(ei).to(dev),
            "edge_mask": torch.ones(ei.shape[1], dtype=torch.bool, device=dev),
            "energy": torch.tensor(float(g.normal() * n_mol), dtype=torch.float32, device=dev)}


def rotation(seed: int) -> np.ndarray:
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def phase_gnn_full(dev, card: str) -> dict:
    """The GNN, equivariant and recsys families at full width, float32 with
    TF32 off, adamw at the cells' 1e-3, seed 0's weights and data from seeds.
    (a) gat-cora FULL on full_graph_sm: 2,708 nodes, 10,556 edges padded to
    10,752 slots, 1,433 binary bag-of-words features at Cora's 1.27% density,
    7 classes learnt from the features, 140 labelled nodes: 20 steps, the
    loss falls. (b) graphcast FULL (16 layers, d 512, remat) on minibatch_lg
    batches: a uniform random graph at ogbn-products' 2,449,029 vertices and
    61,859,140 edges (its CSR build timed on the host), 1,024 seeds at
    fanouts [15, 10] through sample_khop (timed): 169,984 node and 168,960
    edge slots, 602 features, 227 targets; 5 steps on 5 samples, finite.
    (c) egnn FULL and mace FULL on molecule: 3,840 atoms in molecules of 30,
    8,192 edges: 20 steps each, finite; then in float64 (the trained params
    cast up) the energy under a random rotation plus translation within
    1e-4 relative and EGNN's coordinates moved with them, and MACE's energy
    under the translation; MACE's move under the rotation is recorded, not
    gated (ROADMAP C.6: the reference's MACE-lite is not rotation
    invariant). (d) bert4rec FULL (1,048,578 x 64 items): one cloze train
    step at batch 4,096 (cut from 65,536: the (B, 200, 1,024) float32 score
    tensor alone is 53.6 GB there), serve_p99 (512 users x 1,024 own
    candidates) and retrieval_cand (1 user x 1,000,448 candidates, the
    reference's 1,000,000 padded to 1,024s by repeating ids): finite, and a
    (C,) and a (B, C) candidate set of the same ids score alike. Each
    records ms a step (CUDA events), device busy ms over device operations,
    peak bytes beyond what was held and the params' bytes."""
    import dataclasses

    import torch

    from repro_torch import rng
    from repro_torch.configs import bert4rec as b4r_cfg
    from repro_torch.configs import egnn, gat_cora, graphcast, mace
    from repro_torch.configs.cells import GNN_SHAPES, RECSYS_SHAPES
    from repro_torch.data.sampler import CSRGraph, sample_khop
    from repro_torch.models import bert4rec as b4r
    from repro_torch.models import equivariant as eqv
    from repro_torch.models import gnn
    from repro_torch.train.optimizer import adamw, tree_map
    from repro_torch.train.steps import (make_equivariant_train_step, make_gnn_train_step,
                                         make_recsys_score_step, make_recsys_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": card}

    def train(cfg, make_step, init, batch, n_steps, name):
        params = init(rng.PRNGKey(0, dev), cfg)
        opt = adamw(lr=1e-3)
        st = [params, opt.init(params)]
        step = make_step(cfg, opt)
        key = rng.PRNGKey(0, dev)  # the GNN steps ignore it; the cloze step draws from it

        def one():
            st[0], st[1], m = step(st[0], st[1], batch, key)
            return m["loss"]

        rec, losses = model_records(one, n_steps, params, (st[1],), card)
        losses = [float(x) for x in losses]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"gnn_full {name}: losses {losses} not finite")
        rec["losses"] = losses
        return rec, st[0]

    # (a) gat-cora on full_graph_sm
    sh = GNN_SHAPES["full_graph_sm"]
    N, E, F, C = sh["n_nodes"], sh["n_edges"], sh["d_feat"], sh["n_classes"]
    slots = -(-E // 1024) * 1024
    g = np.random.default_rng(0)
    feats = (g.random((N, F)) < 0.0127).astype(np.float32)
    labels = np.argmax(feats @ g.normal(size=(F, C)), axis=1).astype(np.int32)
    ei = np.full((2, slots), N, np.int32)
    ei[:, :E] = g.integers(0, N, (2, E))
    mask = np.zeros(N, np.float32)
    mask[:140] = 1.0
    batch = {"node_feats": torch.from_numpy(feats).to(dev), "edge_index": torch.from_numpy(ei).to(dev),
             "labels": torch.from_numpy(labels).to(dev), "label_mask": torch.from_numpy(mask).to(dev)}
    rec, _ = train(gat_cora.full(F, C), make_gnn_train_step, gnn.init_params, batch, 20,
                   "gat-cora")
    if not rec["losses"][-1] < rec["losses"][0]:
        raise AssertionError(f"gnn_full gat-cora: losses {rec['losses']} do not fall")
    out["gat-cora"] = {"nodes": N, "edge_slots": slots, "d_feat": F, "classes": C, **rec}
    del batch
    torch.cuda.empty_cache()

    # (b) graphcast on minibatch_lg, sampled from a products-sized graph
    g = np.random.default_rng(1)
    t0 = time.perf_counter()
    edges = g.integers(0, OGB_PRODUCTS["vertices"], (OGB_PRODUCTS["edges"], 2))
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = CSRGraph(OGB_PRODUCTS["vertices"], edges)
    csr_s = time.perf_counter() - t0
    del edges
    samples, sample_s = [], []
    for i in range(5):
        t0 = time.perf_counter()
        seeds = g.choice(OGB_PRODUCTS["vertices"], MINIBATCH["seeds"], replace=False)
        samples.append(sample_khop(csr, seeds, MINIBATCH["fanouts"], g))
        sample_s.append(time.perf_counter() - t0)
    del csr
    n_slots, e_slots = len(samples[0][0]), samples[0][1].shape[1]
    if (n_slots, e_slots) != (GNN_SHAPES["minibatch_lg"]["n_nodes"],
                              GNN_SHAPES["minibatch_lg"]["n_edges"]):
        raise AssertionError(f"gnn_full: sample_khop gave {n_slots} x {e_slots} slots")
    gen = torch.Generator(device=dev).manual_seed(1)
    nf = torch.randn((n_slots, MINIBATCH["d_feat"]), generator=gen, device=dev)
    tg = torch.randn((n_slots, MINIBATCH["targets"]), generator=gen, device=dev)
    batches = [{"node_feats": nf, "edge_index": torch.from_numpy(s[1]).to(dev), "targets": tg}
               for s in samples]
    cfg = graphcast.full(MINIBATCH["d_feat"], MINIBATCH["targets"])
    it = iter(batches * 2)
    params = gnn.init_params(rng.PRNGKey(0, dev), cfg)
    opt = adamw(lr=1e-3)
    st = [params, opt.init(params)]
    step = make_gnn_train_step(cfg, opt)

    def gc_one():
        st[0], st[1], m = step(st[0], st[1], next(it), None)
        return m["loss"]

    rec, losses = model_records(gc_one, 5, params, (st[1],), card)
    rec["losses"] = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"gnn_full graphcast: losses {rec['losses']} not finite")
    out["graphcast"] = {
        "graph": OGB_PRODUCTS, "graph_draw_host_s": draw_s, "csr_build_host_s": csr_s,
        "sample_khop_host_s": sample_s, "real_nodes": [s[3] for s in samples],
        "real_edges": [int(s[2].sum()) for s in samples], "node_slots": n_slots,
        "edge_slots": e_slots, "layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
        "remat": cfg.remat, **rec}
    del batches, st, params, step, it, nf, tg, samples
    torch.cuda.empty_cache()

    # (c) egnn and mace on molecule
    sh = GNN_SHAPES["molecule"]
    R, t = rotation(5), np.array([0.7, -1.3, 2.1])
    for name, mod in (("egnn", egnn), ("mace", mace)):
        cfg = mod.FULL
        batch = molecule_batch(sh["n_nodes"], sh["n_edges"], cfg.d_hidden, 2, dev)
        rec, params = train(cfg, make_equivariant_train_step, eqv.init_params, batch, 20, name)
        c64 = dataclasses.replace(cfg, dtype=torch.float64)
        p64 = tree_map(lambda x: x.double(), params)

        def energy(coords, c64=c64, p64=p64, batch=batch, name=name):
            args = (batch["node_feats"].double(), coords, batch["edge_index"],
                    batch["edge_mask"])
            with torch.no_grad():
                if name == "egnn":
                    return eqv.egnn_forward(p64, c64, *args)
                return eqv.mace_forward(p64, c64, *args), None

        x = batch["coords"].double()
        Rt, tt = torch.from_numpy(R).to(dev), torch.from_numpy(t).to(dev)
        e0, x0 = energy(x)
        e1, x1 = energy(x @ Rt.T + tt)
        e2, _ = energy(x + tt)
        rot = abs(float(e1) - float(e0)) / abs(float(e0))
        trans = abs(float(e2) - float(e0)) / abs(float(e0))
        inv = {"float64_translation_rel_change": trans, "float64_rotation_rel_change": rot}
        if trans > INV_RTOL:
            raise AssertionError(f"gnn_full {name}: energy moves {trans} under a translation")
        if name == "egnn":
            want = x0 @ Rt.T + tt
            inv["coords_rel_err"] = float((x1 - want).abs().max() / want.abs().max())
            if rot > INV_RTOL or inv["coords_rel_err"] > INV_RTOL:
                raise AssertionError(f"gnn_full egnn: not equivariant: {inv}")
        out[name] = {"atoms": sh["n_nodes"], "edges": sh["n_edges"], **rec, "invariance": inv}
        del batch, params, p64
        torch.cuda.empty_cache()

    # (d) bert4rec
    cfg = b4r_cfg.FULL
    g = np.random.default_rng(3)
    B = 4096
    items = torch.from_numpy(g.integers(1, cfg.n_items, (B, cfg.seq_len)).astype(np.int32)).to(dev)
    rec, params = train(cfg, make_recsys_train_step, b4r.init_params, {"items": items}, 1,
                        "bert4rec")
    out["bert4rec"] = {"train": {"batch": B, "batch_cut_from": RECSYS_SHAPES["train_batch"][
        "batch"], **rec}}
    del items
    torch.cuda.empty_cache()
    score = make_recsys_score_step(cfg)
    batches = {}
    for shape in ("serve_p99", "retrieval_cand"):
        sh = RECSYS_SHAPES[shape]
        Bs, Cs = sh["batch"], sh["cands"]
        users = torch.from_numpy(g.integers(1, cfg.n_items, (Bs, cfg.seq_len)).astype(
            np.int32)).to(dev)
        if sh["per_user"]:
            cands = g.integers(0, cfg.n_items + 2, (Bs, Cs))
        else:
            cands = g.integers(0, cfg.n_items + 2, Cs)
            pad = -(-Cs // 1024) * 1024 - Cs
            cands = np.concatenate([cands, cands[:pad]])
        batch = batches[shape] = {"items": users,
                                  "candidates": torch.from_numpy(cands.astype(np.int32)).to(dev)}
        rec, scores = model_records(lambda: score(params, batch), 5, params, (), card)
        s = scores[0]
        if s.shape != (Bs, batch["candidates"].shape[-1]) or not bool(torch.isfinite(s).all()):
            raise AssertionError(f"gnn_full bert4rec {shape}: scores {tuple(s.shape)} not finite")
        out["bert4rec"][shape] = {"users": Bs, "candidates": int(batch["candidates"].shape[-1]),
                                  **rec}
        del scores, s
    # one candidate set as (C,) and as (B, C): serve_p99's users against the
    # first 1,024 of retrieval_cand's ids, the same scores
    users = batches["serve_p99"]["items"]
    shared = batches["retrieval_cand"]["candidates"][:1024]
    one_d = score(params, {"items": users, "candidates": shared})
    two_d = score(params, {"items": users, "candidates": shared.expand(users.shape[0], -1)})
    err = float((one_d - two_d).abs().max() / one_d.abs().max())
    if err > 1e-5:
        raise AssertionError(f"gnn_full bert4rec: (C,) and (B, C) candidates differ by {err}")
    out["bert4rec"]["candidate_shapes_max_rel_err"] = err
    del params, batches, batch, users, one_d, two_d
    torch.cuda.empty_cache()
    emit({"phase": "gnn_full", **out, "ok": True})
    return out


# phase cells (c): how far the live-storage counter's temp_bytes on meta
# may be from the CUDA allocator's on an LM cell
TEMP_RTOL = 0.10

# phase cells (c): (arch, shape, the batch run on one card or None for the
# cell's own). smollm-135m train_4k at seq 4,096 runs 8 of its 256
# sequences: with remat, one layer's recomputed attention keeps its float32
# scores, probabilities and masks for all 8 x 8 chunk pairs for the backward
# (about 2.3 GB a sequence), so 16 is about the most that fits in 80 GB, and
# a step at 8 already takes seconds (~300,000 aten operations, ~13 TB of
# operand traffic). decode_32k runs 64 of its 128 sequences: the bfloat16
# KV cache of 128 is 96.6 GB.
CELL_RUNS = (
    ("smollm-135m", "train_4k", 8),
    ("smollm-135m", "decode_32k", 64),
    ("gat-cora", "full_graph_sm", None),
    ("egnn", "molecule", None),
    ("bert4rec", "serve_p99", None),
)


def layer_fit(arch: str, shape: str, batch, whole) -> dict:
    """The dry run's layer fit (``launch/dryrun.py::model_counts``) of a
    full-width LM prefill or decode cell at a cut batch: its step traced
    on ``meta`` at ``FIT_LAYERS`` layers and each count of
    ``count.StepCount`` (flops, bytes, aten ops, the live-storage peak,
    the new outputs' bytes) taken at the config's ``n_layers``. Raises unless every count equals
    ``whole``'s, the trace of all the layers at the same shapes."""
    from repro_torch.configs import cells
    from repro_torch.launch import dryrun
    from repro_torch.roofline import count

    traces = []
    for n in dryrun.FIT_LAYERS:
        c = cells.build_cell(arch, shape, overrides={"n_layers": n})
        traces.append(vars(count.count_step(c.fn, count.materialize(c, "meta", batch=batch))[1]))
    n_layers = cells.build_cell(arch, shape).config.n_layers
    fitted = {k: dryrun.fit_at(dryrun.FIT_LAYERS, [t[k] for t in traces], n_layers)
              for k in traces[0]}
    if fitted != vars(whole):
        raise AssertionError(f"cells (c) {arch} {shape} (batch {batch}): the layer fit "
                             f"{fitted} is not the whole trace's {vars(whole)}")
    return fitted


def tree_nbytes(tree) -> int:
    """The bytes of a tree's tensors (from their shapes: meta tensors too)."""
    return nbytes(*tensors(tree)) if isinstance(tree, dict) else nbytes(tree)


def smoke_step(cell, args) -> dict:
    """One step of a materialised cell, checked as the reference's smoke
    tests check theirs: a finite loss and params of the same shapes that
    moved (train), finite logits with (B, 1, V) rows and the cache kept
    (decode), finite (B, S_or_1, V) logits (prefill), finite (B, C) scores."""
    import torch

    def finite(ts):
        return all(bool(torch.isfinite(t.float()).all()) for t in ts if t.is_floating_point())

    name = f"cells (b) {cell.arch} {cell.shape}"
    out = cell.fn(*args)
    if cell.kind == "train":
        params, opt_state, metrics = out
        loss = float(metrics["loss"])
        before, after = list(tensors(args[0])), list(tensors(params))
        if [t.shape for t in before] != [t.shape for t in after]:
            raise AssertionError(f"{name}: the step changed the params' shapes")
        moved = max(float((a.float() - b.float()).abs().max()) for a, b in zip(before, after))
        if not (math.isfinite(loss) and finite(after) and finite(tensors(opt_state)) and moved > 0):
            raise AssertionError(f"{name}: loss {loss}, params moved by {moved}")
        return {"loss": loss, "max_param_move": moved}
    if cell.kind == "decode":
        logits, cache = out
        if (logits.shape[0] != args[2]["tokens"].shape[0] or not finite([logits])
                or cache["k"].shape != args[1]["k"].shape):
            raise AssertionError(f"{name}: logits {tuple(logits.shape)} or cache wrong")
        return {"logits": list(logits.shape)}
    if out.dim() != (3 if cell.kind == "prefill" else 2) or not finite([out]):
        raise AssertionError(f"{name}: output {tuple(out.shape)} not finite or misshaped")
    if cell.kind == "score" and tuple(out.shape) != (args[1]["items"].shape[0],
                                                     args[1]["candidates"].shape[-1]):
        raise AssertionError(f"{name}: scores {tuple(out.shape)}")
    return {"out": list(out.shape)}


def cell_steps(cell, args, n: int) -> tuple[list, list]:
    """``n`` steps of a materialised cell, each on the state the last left
    (a train step's params and optimizer state, a decode step's cache),
    each timed by CUDA events; returns the ms and the last arguments."""
    import torch

    st, ms = list(args), []
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = cell.fn(*st)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        if cell.kind == "train":
            st[0], st[1] = out[0], out[1]
        elif cell.kind == "decode":
            st[1] = out[1]
        del out
    return ms, st


def phase_cells(dev, card: str) -> dict:
    """The cell builders and the roofline on the card (module docstring,
    phase cells). Float32 cells run with TF32 off, as in phase gnn_full; the
    roofline's compute term takes the bfloat16 peak for every cell
    (``roofline.report``), so for them it is a loose floor."""
    import torch

    from repro_torch.configs import cells
    from repro_torch.launch import dryrun
    from repro_torch.roofline import count, tables
    from repro_torch.roofline.report import roofline_terms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": card}

    # (a) every FULL cell, abstract: nothing allocated on the card
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    built = [cells.build_cell(a, s) for a, s in cells.all_cells()]
    seconds = time.perf_counter() - t0
    if torch.cuda.memory_allocated(dev) != held:
        raise AssertionError("cells (a): building the cells allocated on the card")
    for c in built:
        if not all(t.is_meta for a in c.args for t in (tensors(a) if isinstance(a, dict) else [a])):
            raise AssertionError(f"cells (a) {c.arch} {c.shape}: an argument is not on meta")
        emit({"phase": "cells", "part": "a", "cell": f"{c.arch} {c.shape}", "kind": c.kind,
              "param_bytes": tree_nbytes(c.args[0]),
              "opt_state_bytes": tree_nbytes(c.args[1]) if c.kind == "train" else 0,
              "arg_bytes": sum(tree_nbytes(a) for a in c.args), "model_flops": c.model_flops})
    out["a"] = {"cells": len(built), "seconds": seconds, "allocated_before": held,
                "allocated_after": torch.cuda.memory_allocated(dev)}
    del built

    # (b) the reference's smoke cases, one step each
    t0 = time.perf_counter()
    smoke = {}
    for a, s in cells.SMOKE_CASES:
        cell = cells.build_cell(a, s, smoke=True)
        smoke[f"{a} {s}"] = smoke_step(cell, count.materialize(cell, dev, seed=42))
    torch.cuda.synchronize(dev)
    out["b"] = {"cases": len(smoke), "seconds": time.perf_counter() - t0, "steps": smoke}

    # (c) five cells at full width, timed and counted into a one-card roofline
    emit({"phase": "cells", "part": "c", "cuts": {
        f"{a} {s}": {"batch": b, "cut_from": cells.LM_SHAPES[s]["batch"]}
        for a, s, b in CELL_RUNS if b is not None}})
    rec_dir = ROOT / "build" / "roofline"
    rec_dir.mkdir(parents=True, exist_ok=True)
    records, runs = [], {}
    for arch, shape, batch in CELL_RUNS:
        cell = cells.build_cell(arch, shape)
        t0 = time.perf_counter()
        args = count.materialize(cell, dev, seed=0, batch=batch)
        torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec = count.record(cell, args)  # the warm-up step, counted
        count_s = time.perf_counter() - t0
        # the live-storage counter on a meta trace of the same shapes
        t0 = time.perf_counter()
        _, meta = count.count_step(cell.fn, count.materialize(cell, "meta", batch=batch))
        meta_s = time.perf_counter() - t0
        temp = {"cuda": rec["memory"]["temp_bytes"], "meta_live": meta.temp_bytes,
                "meta_over_cuda": meta.temp_bytes / max(rec["memory"]["temp_bytes"], 1),
                "meta_trace_s": meta_s, "meta_flops": meta.flops, "meta_aten_ops": meta.ops}
        # the LM steps allocate nothing inside an op that is large beside
        # their temporaries: the two counts agree within TEMP_RTOL there
        if not meta.temp_bytes > 0 or (arch in cells.LM_ARCHS and abs(
                temp["meta_over_cuda"] - 1) > TEMP_RTOL):
            raise AssertionError(f"cells (c) {arch} {shape}: temp_bytes {temp}")
        if dryrun.fits_layers(cell):  # the dry run's layer fit at full width
            t0 = time.perf_counter()
            layer_fit(arch, shape, batch, meta)
            temp["layer_fit_s"] = time.perf_counter() - t0
        ms, st = cell_steps(cell, args, 3)
        del args
        t0 = time.perf_counter()
        busy = device_busy(lambda: cell.fn(*st), top=5, warmup=False, host=False)
        busy_s = time.perf_counter() - t0
        # a small step: device_busy's raw-event reading beside the event
        # list's, on one profile taken as the earlier phases take theirs
        readings = busy_readings(lambda: cell.fn(*st)) if arch == "gat-cora" else None
        t = roofline_terms(rec)
        steady = sorted(ms)[1]
        analytic = rec["cost"]["flops_analytic_total"]
        run = {"batch": batch, "setup_s": setup_s, "profile_s": busy_s, "count_s": count_s,
               "temp_bytes": temp, "ms": ms, "ms_median": steady,
               "step_profile": busy, "device_idle_share": 1.0 - busy["device_busy_ms"] / steady,
               "busy_readings": readings,
               "terms": {k: t[k] for k in ("compute_s", "memory_s", "collective_s", "bound",
                                           "step_s_lower_bound", "useful_flop_ratio",
                                           "roofline_fraction")},
               "ms_over_bound": steady / (t["step_s_lower_bound"] * 1e3),
               "counted_over_analytic_flops": rec["cost"]["flops"] / analytic if analytic else None}
        if not (math.isfinite(steady) and rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0):
            raise AssertionError(f"cells (c) {arch} {shape}: {run}")
        (rec_dir / f"{arch}__{shape}__card.json").write_text(json.dumps(rec, indent=1))
        emit({"phase": "cells", "part": "c", "cell": f"{arch} {shape}", "card": card,
              "record": rec, **run})
        records.append(rec)
        runs[f"{arch} {shape}"] = run
        del st
        torch.cuda.empty_cache()
    table = tables.table(records)
    print(table, flush=True)
    for cell_name, run in runs.items():
        t = run["temp_bytes"]
        print(f"cells (c) temp_bytes {cell_name} (batch {run['batch']}): cuda {t['cuda']} "
              f"meta live {t['meta_live']} meta/cuda {t['meta_over_cuda']}", flush=True)
    out["c"] = {"runs": runs, "table": table}
    emit({"phase": "cells", "a": out["a"], "b_cases": out["b"]["cases"],
          "b_seconds": out["b"]["seconds"], "ok": True})
    return out


# the dry run's cells on the card's host: (arch, shape, multipod)
DRYRUN_CELLS = (("gat-cora", "molecule", False), ("gat-cora", "molecule", True),
                ("bert4rec", "serve_p99", False), ("smollm-135m", "prefill_32k", False),
                ("triangle-stream", "bulk_s1m_r2m", False),
                ("triangle-stream", "coord_s1m_r2m", False))
# the collectives a stream plan calls on the pod mesh: make_pjit_update's
# all_gather of the batch, make_coordinated_update's 14 all_to_alls and
# its overflow's psum
DRYRUN_STREAM_COUNTS = {"bulk_s1m_r2m": {"all-gather": 1},
                        "coord_s1m_r2m": {"all-to-all": 14, "all-reduce": 1}}


def phase_dryrun(card: str) -> dict:
    """The dry run (module docstring, phase dryrun): each cell of
    DRYRUN_CELLS through ``python -m repro_torch.launch.dryrun``, all at once,
    with no GPU visible to them; each record checked, then the pod records
    rendered by ``python -m repro_torch.roofline.tables``. smollm-135m
    prefill_32k, which timed out at 900 s when traced whole, is fitted from
    2, 3 and 4 layers; its chips and model_flops are the cell builder's,
    which a whole trace also writes."""
    from repro_torch.configs import cells
    from repro_torch.launch.mesh import make_production_mesh

    out_dir = ROOT / "build" / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    procs = []
    try:
        for arch, shape, mp in DRYRUN_CELLS:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--out-dir", str(out_dir)] + (["--multipod"] if mp else [])
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        done = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    cells_out = []
    for (arch, shape, mp), p, (_, err) in zip(DRYRUN_CELLS, procs, done):
        mesh = "multipod" if mp else "pod"
        if p.returncode != 0:
            raise AssertionError(f"dryrun {arch} {shape} {mesh}: exit {p.returncode}\n{err[-3000:]}")
        rec = json.loads((out_dir / f"{arch}__{shape}__{mesh}.json").read_text())
        coll = rec["collectives"]
        stream = arch == "triangle-stream"
        lm = arch in cells.LM_ARCHS
        if lm:
            axes = tuple(make_production_mesh(multi_pod=mp).axis_names)
            want_mf = cells.build_cell(arch, shape, axes).model_flops
        ok = (rec["ok"] and rec["chips"] == (512 if mp else 256) and rec["mesh"] == mesh
              and rec["model_flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
              and rec["memory"]["argument_bytes"] > 0 and rec["hlo_size"] > 0
              and rec["memory"]["temp_bytes"] > 0
              and (not lm or (rec["layer_fit"] == [2, 3, 4] and rec["model_flops"] == want_mf))
              and (stream or rec["cost"]["flops"] > 0)
              # positive wire bytes wherever a plan's calls or a rule gave a collective
              and (coll["wire_bytes_total"] > 0) == bool(coll["counts"])
              and (not stream or coll["counts"] == DRYRUN_STREAM_COUNTS[shape])
              and (stream or bool(coll["rules"]) == bool(coll["counts"])))
        if not ok:
            raise AssertionError(f"dryrun {arch} {shape} {mesh}: {rec}")
        cells_out.append({"cell": f"{arch} {shape} {mesh}",
                          "seconds_to_compile": rec["seconds_to_compile"],
                          "hlo_size": rec["hlo_size"], "flops": rec["cost"]["flops"],
                          "bytes_accessed": rec["cost"]["bytes_accessed"],
                          "argument_bytes": rec["memory"]["argument_bytes"],
                          "temp_bytes": rec["memory"]["temp_bytes"],
                          "layer_fit": rec.get("layer_fit"), "collectives": coll})
    table = subprocess.run(
        [sys.executable, "-m", "repro_torch.roofline.tables", "--dir", str(out_dir), "--mesh",
         "pod"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        check=True).stdout
    print(table, flush=True)
    rows = [[c.strip() for c in ln.strip("|").split("|")][:2] for ln in table.splitlines()[2:]]
    want = sorted([a, s] for a, s, mp in DRYRUN_CELLS if not mp)
    if sorted(rows) != want:
        raise AssertionError(f"dryrun: the table's rows {rows} are not the pod cells {want}")
    print(f"dryrun: phase wall {wall:.1f} s", flush=True)
    emit({"phase": "dryrun", "card": card, "seconds": wall, "cells": cells_out, "ok": True})
    return {"seconds": wall, "cells": cells_out, "table": table}


def cli_lines(args) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.stream", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600, check=True).stdout
    lines = out.splitlines()
    for prefix in ("stream: m=", "processed "):
        if not any(ln.startswith(prefix) for ln in lines):
            raise AssertionError(f"cli: no {prefix!r} line in:\n{out}")
    return lines


def serve_cli(args) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.stream_serve", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600, check=True).stdout


def phase_cli() -> None:
    gold = json.loads((ROOT / "src/repro_torch/golden/stream_small.json").read_text())
    lines = cli_lines(gold["cli"]["args"])
    est_line = next((ln for ln in lines if ln.startswith("estimate: ")), None)
    if est_line != gold["cli"]["estimate_line"]:
        raise AssertionError(f"cli: {est_line!r} != JAX CLI {gold['cli']['estimate_line']!r}")
    local = json.loads((ROOT / "src/repro_torch/golden/local_small.json").read_text())
    lines = cli_lines(local["cli"]["args"])
    local_line = next((ln for ln in lines if ln.startswith("local[tenant 0] ")), None)
    if local_line != local["cli"]["local_line"]:
        raise AssertionError(f"cli: {local_line!r} != JAX CLI {local['cli']['local_line']!r}")
    # the golden arguments under a plan of transient faults at every seam:
    # the JAX CLI's lines, and its diag file's blocks (the plan's log as a
    # sorted list: the producer's entries interleave with the loop's)
    res = json.loads((ROOT / "src/repro_torch/golden/resilience_small.json").read_text())
    (ROOT / "build").mkdir(exist_ok=True)
    diag_path = ROOT / "build" / "cli_resilience_diag.json"
    diag_path.unlink(missing_ok=True)
    lines = cli_lines([*res["args"], "--diag-json", str(diag_path)])
    got = {p: next((ln for ln in lines if ln.startswith(p)), None) for p in res["lines"]}
    if got != res["lines"]:
        raise AssertionError(f"cli: resilience lines {got} != JAX CLI {res['lines']}")
    diag = json.loads(diag_path.read_text())
    diag["fault_plan"]["log"] = sorted(diag["fault_plan"]["log"])
    for block in ("diag", "report", "fault_plan"):
        if diag[block] != res[block]:
            raise AssertionError(f"cli: diag {block} {diag[block]} != JAX CLI {res[block]}")
    # a tenant-sharded bank on a 4-shard mesh on this card: the JAX CLI's
    # mesh: and estimate[tenant t] lines for the same flags
    plans = json.loads((ROOT / "src/repro_torch/golden/plans_small.json").read_text())
    lines = cli_lines(plans["args"])
    plan_lines = [ln for ln in lines if ln.startswith(("mesh:", "estimate"))]
    if plan_lines != plans["lines"]:
        raise AssertionError(f"cli: mesh lines {plan_lines} != JAX CLI {plans['lines']}")
    # the serving CLI: the fixed bank's rolling queries, and the elastic
    # churn with its checkpointed snapshot drill under a fault plan
    serve = json.loads((ROOT / "src/repro_torch/golden/serve_small.json").read_text())
    fixed = [ln for ln in serve_cli(serve["fixed"]["args"]).splitlines()
             if ln.startswith(("stream:", "query step="))]
    if fixed != serve["fixed"]["lines"]:
        raise AssertionError(f"cli: serve lines {fixed} != JAX CLI {serve['fixed']['lines']}")
    ckpt_dir = tempfile.mkdtemp(prefix="serve_cli_")
    try:
        text = serve_cli([*serve["elastic"]["args"], "--ckpt-dir", ckpt_dir])
    finally:
        shutil.rmtree(ckpt_dir)
    lines = [re.sub(r" in [0-9.]+s", "", ln) for ln in text.splitlines()]
    elastic = {"lines": [ln for ln in lines if not ln.startswith("session ")],
               "sessions": sorted(ln for ln in lines if ln.startswith("session "))}
    if elastic != {"lines": serve["elastic"]["lines"], "sessions": serve["elastic"]["sessions"]}:
        raise AssertionError(f"cli: elastic serve lines {elastic} != JAX CLI {serve['elastic']}")
    # the training CLI on a fresh --ckpt-dir: the JAX CLI's arch= line and,
    # within the bfloat16 tolerance, its first logged loss
    tgold = json.loads((ROOT / "src/repro_torch/golden/train_small.json").read_text())["cli"]
    ckpt_dir = tempfile.mkdtemp(prefix="train_cli_")
    try:
        text = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *tgold["args"],
             "--ckpt-dir", ckpt_dir], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=600, check=True).stdout
    finally:
        shutil.rmtree(ckpt_dir)
    train_lines = text.splitlines()
    first = float(next(ln for ln in train_lines if ln.startswith("loss: first logged ="))
                  .split("=")[1].split()[0])
    if train_lines[0] != tgold["arch_line"]:
        raise AssertionError(f"cli: {train_lines[0]!r} != JAX CLI {tgold['arch_line']!r}")
    if abs(first - tgold["first_loss"]) > BF16_LOSS_RTOL * tgold["first_loss"]:
        raise AssertionError(f"cli: first logged loss {first} vs JAX CLI {tgold['first_loss']}")
    emit({"phase": "cli", "estimate_line": est_line, "local_line": local_line,
          "resilience_lines": got, "diag_report": diag["report"], "mesh_lines": plan_lines,
          "serve_lines": fixed, "elastic_serve": elastic, "train_lines": train_lines,
          "ok": True})


def main() -> int:
    # train_full's resume check runs under torch.use_deterministic_algorithms,
    # which asks for a fixed cuBLAS workspace; this is the size PyTorch gives
    # cuBLAS on Hopper by default
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    phase_edges(dev)
    phase_golden(dev)
    phase_golden_local(dev)
    phase_naive(dev)
    phase_golden_dynamic(dev)
    phase_golden_serve(dev)
    phase_golden_train(dev)
    phase_golden_gnn(dev)
    full = phase_full(dev)
    local = phase_local_full(dev, full)
    dynamic = phase_dynamic_full(dev, full)
    phase_chaos_full(dev, card, full, dynamic)
    tenants = phase_tenants_full(dev, full, local, dynamic)
    plan_rows = phase_plans_full(dev, card, full, tenants)
    phase_elastic_full(dev, card, full, local, tenants)
    phase_serve_full(dev, card)
    phase_train_full(dev, card)
    phase_train_elastic(dev, full)
    phase_gnn_features(dev, card)
    phase_examples(dev, card)
    phase_gnn_full(dev, card)
    phase_cells(dev, card)
    phase_dryrun(card)
    rows = phase_kernels(dev, full, local, dynamic)
    rows += bank_kernel_rows(dev, tenants) + plan_rows
    phase_cli()
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
