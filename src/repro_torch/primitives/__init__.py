"""Sort / scan / multisearch building blocks (counterparts of
``repro.primitives``).

The package exports the reference's public names but two: the reference's
process-wide ``multisearch_backend`` and ``set_multisearch_backend`` have no
counterpart, since the port picks its search per engine
(``EngineConfig.multisearch``) and per call (``search=`` or ``backend=``).
"""
from repro_torch.primitives.sort import pack2, sort_by_key, composite_key
from repro_torch.primitives.segscan import (
    segment_starts,
    segmented_iota,
    segmented_sum_scan,
)
from repro_torch.primitives.search import (
    exact_multisearch,
    count_eq,
    multisearch_bounds,
    predecessor_multisearch,
)

__all__ = [
    "pack2",
    "sort_by_key",
    "composite_key",
    "segment_starts",
    "segmented_iota",
    "segmented_sum_scan",
    "exact_multisearch",
    "count_eq",
    "multisearch_bounds",
    "predecessor_multisearch",
]
