"""Serving CLI: batched greedy decoding with a KV cache
(``repro.launch.serve``).

  python -m repro_torch.launch.serve --smoke --batch 4 --prompt-len 8 --gen 16

Builds ``--arch``'s model (``FULL`` or, with ``--smoke``, ``SMOKE``) from
``--seed`` with the reference's init, draws a random prompt from
``np.random.default_rng(seed)``, prefills it token by token, then decodes
greedily; prints ``decoded BxL in ..s (.. tok/s)`` and ``sample: [..]``,
the first sequence's prompt and first 8 generated tokens. For the same
flags the ``sample:`` line is the JAX CLI's. Tokens stay on the device
through the loop; on the card the clock stops after a synchronise. Runs
on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import time

import numpy as np
import torch

from repro_torch import resolve_device, rng
from repro_torch.configs.cells import LM_ARCHS
from repro_torch.models.transformer import decode_step, init_cache, init_params


def load_config(arch: str, smoke: bool):
    mod, _ = LM_ARCHS[arch]
    cfg = getattr(importlib.import_module(mod), "SMOKE" if smoke else "FULL")
    return dataclasses.replace(cfg, remat=False)


@torch.no_grad()
def generate(params: dict, cfg, prompt: torch.Tensor, gen: int,
             keep_logits: bool = False) -> tuple[torch.Tensor, list]:
    """Prefill ``prompt`` (B, P) token by token, then decode ``gen - 1``
    more tokens greedily (the reference's loop: P + gen - 1 steps).
    Returns the (B, P + gen) int32 sequence and, with ``keep_logits``,
    every step's (B, V) logits. Runs without autograd."""
    B, P = prompt.shape
    max_len = P + gen
    cache = init_cache(cfg, B, max_len, prompt.device)
    toks = prompt[:, :1]
    out, kept = [toks], []
    for i in range(max_len - 1):
        logits, cache = decode_step(params, cfg, cache, toks)
        if keep_logits:
            kept.append(logits[:, -1])
        if i + 1 < P:
            toks = prompt[:, i + 1:i + 2]
        else:
            toks = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(toks)
    return torch.cat(out, dim=1), kept


def serve(arch: str, smoke: bool, batch: int, prompt_len: int, gen: int, seed: int,
          device="cuda", keep_logits: bool = False) -> dict:
    """Build the model and decode; returns the sequence, the seconds the
    decode loop took (after a synchronise on the card), tok/s, the params
    and, with ``keep_logits``, every step's logits; on the card also the
    device bytes allocated when the loop starts (the params and whatever
    the process already held) and at the loop's peak (None on the CPU)."""
    dev = resolve_device(device)
    cfg = load_config(arch, smoke)
    params = init_params(rng.PRNGKey(seed, dev), cfg)
    g = np.random.default_rng(seed)
    prompt = torch.from_numpy(g.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32))
    prompt = prompt.to(dev)
    held = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    seq, logits = generate(params, cfg, prompt, gen, keep_logits)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return {"cfg": cfg, "params": params, "prompt": prompt, "seq": seq, "logits": logits,
            "seconds": dt, "tok_per_s": batch * (prompt_len + gen) / dt,
            "held_device_bytes": held, "peak_device_bytes": peak}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list(LM_ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    out = serve(args.arch, args.smoke, args.batch, args.prompt_len, args.gen, args.seed,
                args.device)
    max_len = args.prompt_len + args.gen
    print(f"decoded {args.batch}x{max_len} in {out['seconds']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s)")
    print("sample:", out["seq"][0].cpu().numpy()[: args.prompt_len + 8])


if __name__ == "__main__":
    main()
