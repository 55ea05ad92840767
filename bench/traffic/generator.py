"""The benchmark's one traffic generator: Graph500 Kronecker graphs, cut
into jobs of s-edge batches.

A traffic file (``traffic/<name>.json``) names the graph's parameters and
the load; everything here reads them and nothing else:

  scale, edgefactor, a, b, c   the Graph500 generator (2**scale vertices,
                               edgefactor * 2**scale edge draws, initiator
                               probabilities A, B, C and D = 1 - A - B - C)
  graph_per_tenant             one independent graph for each tenant of a
                               bank (else every tenant counts the one graph);
                               a job counts its graph whole, ragged last
                               batch included, and a bank's tenants as many
                               edges each: the first edges of each graph, as
                               many as the smallest graph has (Kronecker
                               graphs of one scale differ by seed by about
                               0.01%)
  report_every                 a report query every this many batches
  check_among_jobs             the checked job is drawn from the first this
                               many jobs of the window (it is never cut at
                               the window's end)
  warmup_batches               the untimed warm-up's batches (default: a
                               whole job); fewer where one job's batches
                               share one shape

Graphs are drawn on the device from the run's seed with a ``torch.Generator``
(Graph500's reference generator: one quadrant choice per level for every
draw), their vertex labels permuted, self-loops and duplicate undirected
edges dropped, each edge written (min, max) and the edge order shuffled.
"""
from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np
import torch


def mix(*parts: int) -> int:
    """A 63-bit seed derived from whole numbers of any size (the run's seed,
    a graph's or a job's index)."""
    words = np.random.SeedSequence([int(p) % (1 << 64) for p in parts]).generate_state(2)
    return (int(words[0]) << 31 | int(words[1])) & ((1 << 63) - 1)


def kronecker(scale: int, edgefactor: int, a: float, b: float, c: float, seed: int,
              device) -> torch.Tensor:
    """The unique undirected edges of one Kronecker graph, (m, 2) int32 on
    ``device``: (min, max) rows in an order shuffled from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    draws = edgefactor << scale
    ab = a + b
    c_norm, a_norm = c / (1.0 - ab), a / ab
    u = torch.zeros(draws, dtype=torch.int64, device=device)
    v = torch.zeros(draws, dtype=torch.int64, device=device)
    for level in range(scale):
        ii = torch.rand(draws, generator=g, device=device) > ab
        jj = torch.rand(draws, generator=g, device=device) > torch.where(ii, c_norm, a_norm)
        u |= ii.to(torch.int64) << level
        v |= jj.to(torch.int64) << level
    label = torch.randperm(1 << scale, generator=g, device=device)
    u, v = label[u], label[v]
    lo, hi = torch.minimum(u, v), torch.maximum(u, v)
    keys = torch.unique((lo << scale) | hi)  # sorted, duplicates gone
    keys = keys[(keys >> scale) != (keys & ((1 << scale) - 1))]  # no self-loops
    keys = keys[torch.randperm(keys.numel(), generator=g, device=device)]
    return torch.stack([keys >> scale, keys & ((1 << scale) - 1)], 1).to(torch.int32)


def job_graphs(traffic: dict, n_tenants: int, seed: int, device) -> tuple[np.ndarray, list]:
    """The cell's graphs as one host array (T, m, 2) int32, a tenant's job
    stream in each row, and each graph's unique-edge count. m is the whole
    graph's, the smallest graph's for a bank of graphs. With
    ``graph_per_tenant`` false every row is the same graph."""
    n_graphs = n_tenants if traffic.get("graph_per_tenant") else 1
    graphs = [kronecker(traffic["scale"], traffic["edgefactor"], traffic["a"], traffic["b"],
                        traffic["c"], mix(seed, i), device).cpu().numpy()
              for i in range(n_graphs)]
    unique = [len(E) for E in graphs]
    m = min(unique)
    if n_tenants == 1:
        return graphs[0][None, :m], unique
    out = np.empty((n_tenants, m, 2), np.int32)
    for t in range(n_tenants):
        out[t] = graphs[t % n_graphs][:m]
    return out, unique


def n_batches(edges: int, batch_size: int) -> int:
    return -(-edges // batch_size)


def job_source(graphs: np.ndarray, batch_size: int, stamps: list,
               deadline: Optional[float] = None) -> Iterator:
    """A job's batches as ``run_stream`` takes them: ``(W, n_valid)`` with W
    (s, 2) for one tenant or (T, s, 2) for a bank, the last batch padded with
    (0, 0) rows. ``stamps`` gets the host clock of each batch's hand-off to
    the service's prefetch thread, which calls this generator. Past
    ``deadline`` (a host clock) the job hands over nothing more: its stream
    ends there."""
    T, m, _ = graphs.shape
    for lo in range(0, m, batch_size):
        if deadline is not None and lo and time.perf_counter() >= deadline:
            return
        rows = graphs[:, lo:lo + batch_size]
        n = rows.shape[1]
        if n < batch_size:
            W = np.zeros((T, batch_size, 2), np.int32)
            W[:, :n] = rows
        else:
            W = rows
        stamps.append(time.perf_counter())
        yield (W[0] if T == 1 else W), n
