"""The estimator (counterpart of ``repro.core``): state, rankAll, the bulk
update, the estimate, the schemes and the sequential oracles.

The package exports the reference's public names. ``estimate`` here is the
function, as ``repro.core.estimate`` is; its module is reached by the
dotted path (``from repro_torch.core.estimate import ...``). The
reference's ``*_jit`` wrappers have no counterpart: the port's functions
run eagerly (or launch their kernels) as they are."""
from repro_torch.core.state import EstimatorState, init_state
from repro_torch.core.rank import rank_all, RankStructure
from repro_torch.core.bulk import (
    bulk_delete_chunk,
    bulk_delete_update,
    bulk_update_all,
    bulk_update_chunk,
)
from repro_torch.core.estimate import coarse_estimates, effective_groups, estimate
from repro_torch.core.schemes import (
    GLOBAL,
    EstimatorScheme,
    GlobalScheme,
    LocalScheme,
    NaiveScheme,
    SCHEMES,
    register_scheme,
    resolve_scheme,
)

__all__ = [
    "EstimatorState",
    "init_state",
    "rank_all",
    "RankStructure",
    "bulk_delete_chunk",
    "bulk_delete_update",
    "bulk_update_all",
    "bulk_update_chunk",
    "coarse_estimates",
    "effective_groups",
    "estimate",
    "GLOBAL",
    "EstimatorScheme",
    "GlobalScheme",
    "LocalScheme",
    "NaiveScheme",
    "SCHEMES",
    "register_scheme",
    "resolve_scheme",
]
