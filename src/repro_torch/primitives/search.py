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


def exact_from_lt(sorted_keys: Tensor, queries: Tensor, lt: Tensor,
                  valid_n=None) -> tuple[Tensor, Tensor]:
    """``exact_multisearch``'s answer from the queries' left insertion
    points ``lt`` (for callers that fuse that search with others)."""
    n = sorted_keys.shape[-1]
    if n == 0:
        miss = torch.zeros_like(queries, dtype=torch.bool)
        return torch.full_like(queries, -1, dtype=torch.int64), miss
    i = lt.to(torch.int64)
    i_c = torch.clamp(i, max=n - 1)
    found = (i < n) & (torch.gather(sorted_keys, -1, i_c) == queries)
    if valid_n is not None:
        found = found & (i < valid_n)
    return torch.where(found, i_c, torch.full_like(i_c, -1)), found


def exact_multisearch(sorted_keys: Tensor, queries: Tensor, valid_n=None,
                      backend: str = "auto") -> tuple[Tensor, Tensor]:
    """For each query, the index of an equal key in ``sorted_keys`` (its
    first, the left insertion point) or -1, and whether it was found.
    ``valid_n``: only the first ``valid_n`` keys are real (the rest are
    sentinel padding) and matches past it are rejected."""
    return exact_from_lt(sorted_keys, queries, multisearch_lt(sorted_keys, queries, backend),
                         valid_n)


def count_eq(sorted_keys: Tensor, queries: Tensor, backend: str = "auto") -> Tensor:
    """The number of keys equal to each query (degree queries), int32."""
    lt, le = multisearch_bounds(sorted_keys, queries, backend)
    return le - lt


def predecessor_multisearch(sorted_keys: Tensor, queries: Tensor,
                            backend: str = "auto") -> Tensor:
    """Index of the last key <= each query, or -1 where every key is greater
    (predEQMultiSearch), int32."""
    return multisearch_bounds(sorted_keys, queries, backend)[1] - 1
