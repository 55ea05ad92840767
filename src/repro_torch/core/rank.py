"""rankAll (paper Definition 4.2 / Lemma 4.3) and the batch closing-edge index
(``repro.core.rank``).

For a batch W of s edges (the first ``n_valid`` real), build the structure
every estimator queries:

  * 2s directed arcs {src, dst, pos} sorted by (src asc, pos desc); in that
    order rank(src->dst) is the offset within the src segment, and the same
    order is sorted by (src asc, rank asc), so Q2 lookups reuse it;
  * a (min, max)-sorted copy of W for the step-3 closing-edge search.

Padding arcs and edges get the key INF64 and sort to the tail.

Both builds take leading axes: ``rank_all`` a bank's (T, s, 2) batches,
``rank_all_chunk`` (K, s, 2) or a bank's (T, K, s, 2). On the kernels
either folds all its batches into one call of each kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch.primitives.segscan import segment_starts, segmented_iota
from repro_torch.primitives.sort import pack2, sort_by_key

Tensor = torch.Tensor
INF64 = 0x7FFFFFFFFFFFFFFF


class RankStructure(NamedTuple):
    """Shared per-batch structure (paper Section 4.3). Arrays are length 2s
    except the edge index (length s); a batch's leading axes (tenants, the
    chunk's K) lead every array."""

    key_desc: Tensor  # (2s,) int64: pack2(src, s-1-pos); INF64 for padding
    key_rank: Tensor  # (2s,) int64: pack2(src, rank); INF64 for padding
    src: Tensor  # (2s,) int32
    dst: Tensor  # (2s,) int32
    pos: Tensor  # (2s,) int32
    rank: Tensor  # (2s,) int32
    ekey: Tensor  # (s,) int64: pack2(min, max); INF64 for padding
    epos: Tensor  # (s,) int32

    @property
    def s(self) -> int:
        return self.ekey.shape[-1]


def _inf_where(valid: Tensor, key: Tensor) -> Tensor:
    return torch.where(valid, key, torch.full_like(key, INF64))


def _per_batch(n_valid: Union[int, Tensor]) -> Union[int, Tensor]:
    """A batch count as a column against the batch's lanes: a tensor of
    counts, one per leading index, gains a trailing axis; an int stays."""
    return n_valid[..., None] if isinstance(n_valid, Tensor) else n_valid


def rank_all(W: Tensor, n_valid: Union[int, Tensor], *,
             use_kernels: bool = False) -> RankStructure:
    """Build the RankStructure for batch ``W`` ((s, 2) int32, first n_valid
    real) with a stable sort; ``W`` may carry leading axes, with
    ``n_valid`` an int or a tensor of those leading dims. ``use_kernels=True``
    builds it as the chunk's kernel route does (``rank_all_chunk``): one
    tile sort of every batch's arcs and one of its edges, the ``segscan``
    ranks and the stability patch, whatever the leading axes hold, in place
    of ``torch.sort`` (which sorts long rows one at a time) and
    ``segmented_iota``'s ``torch.cummax``. The fields the update reads are
    the stable sort's (``rank_all_chunk`` says where the padding may
    differ)."""
    if use_kernels:
        return rank_all_chunk(W, n_valid, use_kernels=True)
    s = W.shape[-2]
    dev = W.device
    nv = _per_batch(n_valid)
    pos1 = torch.arange(s, dtype=torch.int32, device=dev)
    valid_e = pos1 < nv

    src = torch.cat([W[..., 0], W[..., 1]], dim=-1)
    dst = torch.cat([W[..., 1], W[..., 0]], dim=-1)
    pos = torch.cat([pos1, pos1]).expand(src.shape)
    valid_a = torch.cat([valid_e, valid_e], dim=-1)

    kd = _inf_where(valid_a, pack2(src, (s - 1) - pos))
    kd_s, src_s, dst_s, pos_s = sort_by_key(kd, src, dst, pos)

    rank_s = segmented_iota(segment_starts(src_s))
    arc = torch.arange(2 * s, device=dev)
    kr = _inf_where(arc < 2 * nv, pack2(src_s, rank_s))

    emin = torch.minimum(W[..., 0], W[..., 1])
    emax = torch.maximum(W[..., 0], W[..., 1])
    ek = _inf_where(valid_e, pack2(emin, emax))
    ek_s, epos_s = sort_by_key(ek, pos1.expand(ek.shape))
    return RankStructure(kd_s, kr, src_s, dst_s, pos_s, rank_s, ek_s, epos_s)


def rank_all_chunk(
    Ws: Tensor, n_valids: Tensor, *, use_kernels: bool = False
) -> RankStructure:
    """Stacked RankStructure over K batches (every array gains a leading K
    axis), or over a bank's T·K batches (Ws (T, K, s, 2), n_valids (T, K):
    every array gains (T, K)). ``n_valids`` is an integer tensor of the
    leading dims on ``Ws``'s device, or an int for every batch. The plain
    build is ``rank_all`` over every batch at once.

    ``use_kernels=True`` builds with the ``bitonic_sort_tiles``,
    ``segscan`` and ``segmented_max_scan`` kernels. The tile sort's
    contract does not promise a stable order (the reference's network is
    not stable; the CUDA merge sort is), so the two places a stable order
    is observable are patched as in the reference: equal arc keys arise
    only from the two orientations of a self-loop (identical payloads), and
    equal closing-edge keys (duplicate edges in one batch) get a segmented
    running maximum of their positions, so the right insertion point still
    reads the last copy's position. Only the padding tails, masked to INF64
    or never read, may differ from the eager build.
    """
    if not use_kernels:
        return rank_all(Ws, n_valids)
    lead, (s, two) = tuple(Ws.shape[:-2]), Ws.shape[-2:]
    nv = n_valids.reshape(-1) if isinstance(n_valids, Tensor) else n_valids
    R = _rank_all_chunk_kernels(Ws.reshape(-1, s, two), nv)
    return RankStructure(*(x.view(*lead, *x.shape[1:]) for x in R))


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _rank_all_chunk_kernels(Ws: Tensor, n_valids: Union[int, Tensor]) -> RankStructure:
    """The kernel build over K batches (a bank's T·K, folded into one tile
    axis; n_valids (K,) or an int for every batch): one tile sort of the
    arcs, one of the edges, one ``segscan`` and one ``segmented_max_scan``,
    whatever K."""
    from repro_torch.kernels.bitonic import bitonic_sort_tiles
    from repro_torch.kernels.segscan import segmented_max_scan, segscan

    K, s, _ = Ws.shape
    dev = Ws.device
    pos1 = torch.arange(s, dtype=torch.int32, device=dev)
    nv = n_valids.to(torch.int64)[:, None] if isinstance(n_valids, Tensor) else n_valids
    valid_e = pos1[None, :] < nv  # (K, s)

    src = torch.cat([Ws[:, :, 0], Ws[:, :, 1]], dim=1)  # (K, 2s)
    dst = torch.cat([Ws[:, :, 1], Ws[:, :, 0]], dim=1)
    pos2 = torch.cat([pos1, pos1])
    valid_a = torch.cat([valid_e, valid_e], dim=1)
    kd = _inf_where(valid_a, pack2(src, (s - 1) - pos2[None, :]))

    # one tile per batch, padded to a power of two with INF64; the payload is
    # the arc's index within its row, used to gather the columns back
    tile = _next_pow2(2 * s)
    kd_p = torch.full((K, tile), INF64, dtype=torch.int64, device=dev)
    kd_p[:, : 2 * s] = kd
    arc_p = torch.zeros((K, tile), dtype=torch.int32, device=dev)
    arc_p[:, : 2 * s] = torch.arange(2 * s, dtype=torch.int32, device=dev)
    ks, perm = bitonic_sort_tiles(kd_p.view(-1), arc_p.view(-1), tile)
    # real keys are < INF64, so the first 2s slots of a sorted tile hold
    # every real arc; the cut tail is padding
    kd_s = ks.view(K, tile)[:, : 2 * s]
    perm = perm.view(K, tile)[:, : 2 * s].to(torch.int64)
    src_s = torch.gather(src, 1, perm)
    dst_s = torch.gather(dst, 1, perm)
    pos_s = torch.gather(pos2[None, :].expand(K, 2 * s), 1, perm)

    # Lemma 4.3 ranks by the segscan kernel over the flattened rows; every
    # row opens with a start flag, so no sum crosses batches
    starts = segment_starts(src_s)
    ones = torch.ones(K * 2 * s, dtype=torch.int32, device=dev)
    rank_s = segscan(ones, starts.reshape(-1)).view(K, 2 * s) - 1

    arc = torch.arange(2 * s, device=dev)[None, :]
    kr = _inf_where(arc < 2 * nv, pack2(src_s, rank_s))

    emin = torch.minimum(Ws[:, :, 0], Ws[:, :, 1])
    emax = torch.maximum(Ws[:, :, 0], Ws[:, :, 1])
    ek = _inf_where(valid_e, pack2(emin, emax))
    tile_e = _next_pow2(s)
    ek_p = torch.full((K, tile_e), INF64, dtype=torch.int64, device=dev)
    ek_p[:, :s] = ek
    ep_p = torch.zeros((K, tile_e), dtype=torch.int32, device=dev)
    ep_p[:, :s] = pos1
    eks, eps = bitonic_sort_tiles(ek_p.view(-1), ep_p.view(-1), tile_e)
    ek_s = eks.view(K, tile_e)[:, :s]
    epos_s = eps.view(K, tile_e)[:, :s].contiguous()
    # restore the stable-sort guarantee step 3 reads: a segmented running
    # maximum of the positions over each run of equal keys
    estarts = segment_starts(ek_s)
    epos_s = segmented_max_scan(epos_s.reshape(-1), estarts.reshape(-1)).view(K, s)
    return RankStructure(
        kd_s.contiguous(), kr, src_s, dst_s, pos_s, rank_s, ek_s.contiguous(), epos_s
    )
