"""Fault-tolerant training loop (``repro.train.trainer``).

Wraps a step with checkpoint and restart (auto-resume from the newest
complete checkpoint), straggler-tolerant prefetch, retry with state
restore after a failed step, and step accounting. Works for any ``(state,
batch, step) -> (state, metrics)`` step: the LM trainer's ``(params,
opt_state)`` or the streaming triangle counter's state.

As in the reference, a resumed or restored run takes its batches on from
where the iterator stands: the loop does not rewind the stream, so a
resumed run draws its batches from the start of a fresh stream. Restored
arrays go back onto the device of ``init_state``'s leaves. Nothing in the
loop waits on the device except the logged loss's ``float()`` and a
checkpoint's host copy. One repair over the reference: a failed step waits
for a save still in flight before it restores, so the retry always finds
the newest checkpoint and no writer outlives a loop that gives up.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

from repro_torch.data.prefetch import PrefetchQueue
from repro_torch.train.checkpoint import CheckpointManager, config_hash


@dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    async_save: bool = True
    max_retries: int = 3
    prefetch_depth: int = 4
    deadline_s: Optional[float] = None
    log_every: int = 10


@dataclass
class TrainLog:
    steps: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    restarts: int = 0
    stale_steps: int = 0
    seconds: float = 0.0


def run_loop(
    step_fn: Callable,  # (state, batch, step_idx) -> (state, metrics)
    init_state: Any,
    batches: Iterator,
    n_steps: int,
    tcfg: TrainerConfig,
    meta: Optional[dict] = None,
) -> tuple[Any, TrainLog]:
    ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep, async_save=tcfg.async_save)
    log = TrainLog()
    state = init_state
    start = 0
    restored, manifest = ckpt.restore(init_state)
    if restored is not None:
        state = restored
        start = manifest["step"] + 1
        log.restarts += 1

    pf = PrefetchQueue(batches, depth=tcfg.prefetch_depth, deadline_s=tcfg.deadline_s)
    step = start
    retries = 0
    t0 = time.time()
    while step < n_steps:
        try:
            batch, stale = pf.get()
        except StopIteration:
            break
        log.stale_steps += int(stale)
        try:
            state, metrics = step_fn(state, batch, step)
        except Exception:
            # node failure path: restore the last complete checkpoint and retry
            retries += 1
            log.restarts += 1
            ckpt.wait()
            if retries > tcfg.max_retries:
                raise
            restored, manifest = ckpt.restore(init_state)
            if restored is not None:
                state = restored
                step = manifest["step"] + 1
            continue
        if metrics and "loss" in metrics and step % tcfg.log_every == 0:
            log.steps.append(step)
            log.losses.append(float(metrics["loss"]))
        if tcfg.ckpt_every and step % tcfg.ckpt_every == 0 and step > start:
            ckpt.save(step, state, {"config_hash": config_hash(meta), **(meta or {})})
        step += 1
    ckpt.wait()
    ckpt.save(step - 1, state, {"config_hash": config_hash(meta), **(meta or {})})
    ckpt.wait()
    log.seconds = time.time() - t0
    return state, log
