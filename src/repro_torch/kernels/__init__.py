"""Hand-written CUDA kernels, each beside its plain PyTorch version.

  fused_ingest        kernels/fused_ingest.py  (csrc/fused_ingest.cu)
  bitonic_sort_tiles  kernels/bitonic.py       (csrc/bitonic.cu)
  segscan             kernels/segscan.py       (csrc/segscan.cu, sum)
  segmented_max_scan  kernels/segscan.py       (csrc/segscan.cu, max)
  multisearch_counts  kernels/multisearch.py   (csrc/multisearch.cu)
  segment_sum         kernels/segment_sum.py   (csrc/segment_sum.cu)

A wrapper launches its kernel for CUDA tensors (or raises) and runs its plain
version for CPU tensors; ``LAUNCHES`` counts the wrapper calls that launched
on the card, ``CUDA_LAUNCHES`` the CUDA kernels those calls queued, ``LIBRARY_EVENTS``
the kernel libraries built and the entries loaded.
``kernels/ref.py`` collects the oracles the tests hold both against.
"""
from repro_torch.kernels._build import CUDA_LAUNCHES, LAUNCHES, LIBRARY_EVENTS, reset_launches

__all__ = ["CUDA_LAUNCHES", "LAUNCHES", "LIBRARY_EVENTS", "reset_launches"]
