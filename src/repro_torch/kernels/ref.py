"""Plain PyTorch oracles for every kernel (the correctness contracts),
mirroring ``repro/kernels/ref.py``. The tests hold each kernel's wrapper, on
the CPU and on the card, against these."""
from __future__ import annotations

from repro_torch.kernels.bitonic import bitonic_sort_tiles_plain as bitonic_sort_tiles_ref
from repro_torch.kernels.multisearch import multisearch_counts_plain as multisearch_counts_ref
from repro_torch.kernels.segment_sum import segment_sum_plain as segment_sum_ref
from repro_torch.kernels.segscan import segmented_max_scan_plain as segmented_max_scan_ref
from repro_torch.kernels.segscan import segscan_plain as segscan_ref


def fused_ingest_ref(state, Ws, n_valids, key, step0=0):
    """Chunk-ingest oracle: the sequential scan of ``bulk_update_all`` with
    plain searches, for one tenant or a bank (a leading tenant axis on every
    argument, ``step0`` an int or a (T,) tensor). The fused kernel path must
    be bit-identical to it."""
    from repro_torch.core.bulk import _bulk_update_chunk_scan

    return _bulk_update_chunk_scan(state, Ws, n_valids, key, step0, "eager")


def delete_hits_ref(sorted_delete_keys, queries):
    """Membership of canonical edge ``queries`` in a sorted batch of
    deletion keys, the contract of the turnstile delete probe: ``le > lt``
    of the two searchsorted points. INT64 max padding never matches a real
    key (real keys pack non-negative vertex ids)."""
    import torch

    lt = torch.searchsorted(sorted_delete_keys, queries, side="left")
    le = torch.searchsorted(sorted_delete_keys, queries, side="right")
    return le > lt


def moe_dispatch_ref(expert_idx, capacity: int, n_experts: int):
    """(slot, keep): the slot of each token within its expert's capacity
    buckets, the MoE layer's routing contract. ``slot`` is the token's rank
    among same-expert tokens in arrival order; a token with slot >= capacity
    is dropped (keep False)."""
    import torch

    one_hot = torch.nn.functional.one_hot(expert_idx.long(), n_experts).to(torch.int32)
    pos_in_expert = torch.cumsum(one_hot, dim=0) - 1  # (t, E)
    slot = pos_in_expert.gather(1, expert_idx.long()[:, None])[:, 0]
    return slot.to(torch.int32), slot < capacity


__all__ = ["bitonic_sort_tiles_ref", "delete_hits_ref", "fused_ingest_ref", "moe_dispatch_ref",
           "multisearch_counts_ref", "segment_sum_ref", "segmented_max_scan_ref",
           "segscan_ref"]
