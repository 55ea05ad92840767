"""Multisearch primitives (paper Lemma 3.5; ``repro.primitives.search``).

``multisearch_bounds`` answers a whole fused query vector against one sorted
int64 structure: both insertion points per query, int32. A backend switch
picks how:

  "eager"   two ``torch.searchsorted`` calls (the plain path);
  "kernel"  the ``multisearch_counts`` CUDA kernel
            (``repro_torch.kernels.multisearch``), which on CPU tensors runs
            its plain version;
  "auto"    "kernel" for CUDA tensors, "eager" for CPU tensors.

A bank searches row by row: keys (T, n), each row sorted, and queries
(T, q) go to one batched kernel launch, or to ``torch.searchsorted``, which
takes the same rows.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

MULTISEARCH_BACKENDS = ("auto", "eager", "kernel")


def resolve_multisearch_backend(name: str, device: torch.device) -> str:
    if name not in MULTISEARCH_BACKENDS:
        raise ValueError(
            f"unknown multisearch backend {name!r}; choose from "
            f"{MULTISEARCH_BACKENDS}"
        )
    if name == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "eager"
    return name


def multisearch_bounds(
    sorted_keys: Tensor, queries: Tensor, backend: str = "auto"
) -> tuple[Tensor, Tensor]:
    """(count_lt, count_le) per query: the searchsorted left/right insertion
    points into ``sorted_keys``, int32."""
    if resolve_multisearch_backend(backend, queries.device) == "kernel":
        from repro_torch.kernels.multisearch import multisearch_counts

        return multisearch_counts(sorted_keys, queries)
    lt = torch.searchsorted(sorted_keys, queries, side="left", out_int32=True)
    le = torch.searchsorted(sorted_keys, queries, side="right", out_int32=True)
    return lt, le


def multisearch_lt(
    sorted_keys: Tensor, queries: Tensor, backend: str = "auto"
) -> Tensor:
    """count_lt only, int32. The kernel computes both bounds in one pass, so
    on that backend this drops ``le``."""
    if resolve_multisearch_backend(backend, queries.device) == "kernel":
        from repro_torch.kernels.multisearch import multisearch_counts

        return multisearch_counts(sorted_keys, queries)[0]
    return torch.searchsorted(sorted_keys, queries, side="left", out_int32=True)
