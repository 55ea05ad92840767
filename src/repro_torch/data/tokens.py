"""LM token pipeline (``repro.data.tokens``): a synthetic corpus with
learnable structure and shuffled training windows. Nothing is downloaded:
the text is generated, a Zipf-distributed stream with sparse bigram
structure, so a ~100M-param model has real signal to learn.

Both functions are numpy only and draw from ``np.random.default_rng(seed)``
exactly as the reference does, so one seed gives bit-identical arrays in
both packages.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_corpus(n_tokens: int, vocab: int, seed: int = 0, order: int = 2) -> np.ndarray:
    """Zipf unigram + sparse bigram structure: cheap, learnable, stationary.
    ``order`` is accepted, as in the reference, and unused."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    base = rng.choice(vocab, size=n_tokens, p=p).astype(np.int32)
    # deterministic bigram transitions on 30% of positions -> predictable
    succ = rng.integers(0, vocab, size=vocab).astype(np.int32)
    mask = rng.random(n_tokens - 1) < 0.3
    out = base.copy()
    idx = np.nonzero(mask)[0]
    out[idx + 1] = succ[out[idx]]
    return out


def lm_batches(tokens: np.ndarray, batch: int, seq: int, seed: int = 0) -> Iterator[dict]:
    """Yield ``{tokens, labels}`` (batch, seq) int32 windows forever, from
    shuffled starts; labels are the tokens shifted by one."""
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        tok = np.stack([tokens[s: s + seq] for s in starts])
        lab = np.stack([tokens[s + 1: s + seq + 1] for s in starts])
        yield {"tokens": tok, "labels": lab}
