"""Chunked-ingest backend switch and the replayed randint
(``repro.primitives.ingest``).

``repro_torch.core.bulk.bulk_update_chunk`` resolves its implementation here:

  "scan"    the reference: K sequential ``bulk_update_all`` calls. Every other
            backend is bit-identical to it.
  "fused"   randomness, step-1 selects and all K rank structures hoisted out
            of the batch loop, then the per-batch residue in plain PyTorch
            (the counterpart of the reference's "xla").
  "kernel"  the structures built by the ``bitonic_sort_tiles`` and
            ``segscan`` kernels, and the batch loop, its draws and its
            step-1 selects in the ``fused_ingest`` kernel (the counterpart
            of "pallas", which reads hoisted draws). On CPU tensors each
            kernel wrapper runs its plain version.
  "auto"    "kernel" for CUDA tensors, "fused" for CPU tensors.

``randint_from_bits`` replays ``jax.random.randint``'s span arithmetic on
pre-drawn 32-bit words, so the one state-dependent draw (phi, whose span is
chi+) can hoist its raw bits out of the loop.
"""
from __future__ import annotations

import torch

from repro_torch import rng

Tensor = torch.Tensor

INGEST_BACKENDS = ("auto", "scan", "fused", "kernel")


def resolve_ingest_backend(name: str, device: torch.device) -> str:
    if name not in INGEST_BACKENDS:
        raise ValueError(
            f"unknown ingest backend {name!r}; choose from {INGEST_BACKENDS}"
        )
    if name == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "fused"
    return name


def split_randint_key(key: Tensor) -> tuple[Tensor, Tensor]:
    """The (bits_hi_key, bits_lo_key) pair ``randint`` derives from its key."""
    k = rng.split(key)
    return k[..., 0, :], k[..., 1, :]


def randint_from_bits(hi_bits: Tensor, lo_bits: Tensor, maxval: Tensor) -> Tensor:
    """``randint(key, shape, 0, maxval, int32)`` replayed on the 32-bit words
    drawn with ``bits32`` on ``split_randint_key(key)``. The words may come as
    int64 values in [0, 2**32) or as int32 tensors carrying the uint32 bits.
    Requires ``maxval >= 1``. The uint32 products wrap at 2**32 exactly as
    in the reference (int64 arithmetic masked after every ``*`` and ``+``)."""
    hi = hi_bits.to(torch.int64) & rng.M32
    lo = lo_bits.to(torch.int64) & rng.M32
    return rng.span_offset32(hi, lo, maxval.to(torch.int64)).to(torch.int32)
