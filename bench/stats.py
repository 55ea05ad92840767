"""The benchmark's arithmetic: rates, tails and the least bytes a batch of
the estimator must move."""
from __future__ import annotations

import math
from typing import Optional, Sequence


def rate(total: float, seconds: float) -> Optional[float]:
    """All the work over all the time of a window; None for an empty one."""
    return total / seconds if seconds > 0 and total > 0 else None


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank q-th percentile over every sample: the smallest value
    with at least q% of the samples at or below it."""
    if not values:
        return None
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def least_bytes_per_batch(config: dict) -> float:
    """What one batch must move at the least, for every tenant: its s edges
    read once (8 bytes each) and, once every K batches, the 21-byte
    estimator state (f1 8, chi 4, f2 8, has_f3 1) read and written."""
    T, s, r = config["n_tenants"], config["batch_size"], config["r"]
    K = config.get("chunk_size", 1)
    return T * (8.0 * s + 42.0 * r / K)


def roofline_pct(nbytes: float, busy_s: float, bytes_per_s: float) -> Optional[float]:
    """The least time to move ``nbytes`` at the peak rate over the time the
    device took, in percent."""
    if busy_s <= 0 or not bytes_per_s:
        return None
    return 100.0 * nbytes / bytes_per_s / busy_s
