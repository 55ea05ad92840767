"""End-to-end LM training driver (``repro.launch.train``): a ~100M-param
model for a few hundred steps on synthetic structured text, with
checkpoint and restart.

  python -m repro_torch.launch.train --arch smollm-135m --steps 300 \\
      --batch 8 --seq 256       # the full 135M config
  python -m repro_torch.launch.train --smoke --steps 50 --device cpu

The reference's flags plus ``--device``. It builds ``--arch``'s config
(``FULL`` or, with ``--smoke``, ``SMOKE``) with the reference's
``remat=False, grad_accum=1``, draws the params from ``--seed`` bit for
bit as the reference does, the corpus and the batches from the same seed
as the reference (numpy), and runs ``train/trainer.py::run_loop`` with
asynchronous checkpoints every ``--ckpt-every`` steps into ``--ckpt-dir``
(a run on a directory that holds a checkpoint resumes from it). It prints
the reference's three lines: ``arch=.. params=..M vocab=..`` (equal to the
JAX CLI's), ``steps=.. time=..s tokens/s=..`` and ``loss: first logged =
..  last = ..``. On the card the clock stops after a synchronise. Runs on
the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device, rng
from repro_torch.configs.cells import LM_ARCHS
from repro_torch.data.tokens import lm_batches, synthetic_corpus
from repro_torch.models.transformer import init_params
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.steps import make_lm_train_step
from repro_torch.train.trainer import TrainerConfig, run_loop


def load_config(arch: str, smoke: bool):
    """``arch``'s config as the training CLI runs it: the reference's
    ``remat=False, grad_accum=1``."""
    mod, _ = LM_ARCHS[arch]
    cfg = getattr(importlib.import_module(mod), "SMOKE" if smoke else "FULL")
    return dataclasses.replace(cfg, remat=False, grad_accum=1)


def upload(batch: dict, device: torch.device) -> dict:
    """A host batch on ``device`` through pinned buffers, without blocking
    the host (a plain copy on the CPU)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t if device.type == "cpu" else t.pin_memory().to(device, non_blocking=True)
    return out


def build(arch: str = "smollm-135m", smoke: bool = False, lr: float = 3e-4, seed: int = 0,
          batch: int = 8, seq: int = 256, corpus_tokens: int = 2_000_000,
          device="cuda") -> dict:
    """Everything a run needs, as the CLI makes it: the config, the
    optimizer, the params and optimizer state on ``device``, the jitted
    step's counterpart ``step_fn(state, batch, i)`` (the trainer's
    signature, ``state = (params, opt_state)``), and ``batches()``, which
    starts a fresh iterator of host batches."""
    dev = resolve_device(device)
    _, opt_name = LM_ARCHS[arch]
    cfg = load_config(arch, smoke)
    opt = get_optimizer(opt_name, lr)
    params = init_params(rng.PRNGKey(seed, dev), cfg)
    opt_state = opt.init(params)
    step = make_lm_train_step(cfg, opt)
    key = rng.PRNGKey(seed)  # the step's key: unused on the LM path, as in the reference

    def step_fn(state, host_batch, i):
        params, opt_state = state
        params, opt_state, metrics = step(params, opt_state, upload(host_batch, dev),
                                          rng.fold_in(key, i))
        return (params, opt_state), metrics

    corpus = synthetic_corpus(corpus_tokens, cfg.vocab, seed=seed)
    return {"cfg": cfg, "opt": opt, "params": params, "opt_state": opt_state, "device": dev,
            "step_fn": step_fn, "batches": lambda: lm_batches(corpus, batch, seq, seed=seed)}


def train(run: dict, steps: int, tcfg: TrainerConfig, lr: float, batch: int, seq: int):
    """``run_loop`` over a ``build`` result; returns ((params, opt_state),
    log, seconds, tokens/s)."""
    dev = run["device"]
    t0 = time.time()
    state, log = run_loop(run["step_fn"], (run["params"], run["opt_state"]), run["batches"](),
                          steps, tcfg, meta={"arch": run["cfg"].name, "lr": lr})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    return state, log, dt, steps * batch * seq / dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list(LM_ARCHS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--corpus-tokens", type=int, default=2_000_000)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    run = build(args.arch, args.smoke, args.lr, args.seed, args.batch, args.seq,
                args.corpus_tokens, args.device)
    cfg = run["cfg"]
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M vocab={cfg.vocab}")
    _, log, dt, tput = train(
        run, args.steps,
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, async_save=True,
                      log_every=10),
        args.lr, args.batch, args.seq)
    print(f"steps={args.steps} time={dt:.1f}s tokens/s={tput:.0f}")
    print("loss: first logged =", log.losses[0] if log.losses else None,
          " last =", log.losses[-1] if log.losses else None)


if __name__ == "__main__":
    main()
