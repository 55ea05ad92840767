"""mace [gnn]: 2 layers d_hidden=128, l_max=2, correlation order 3, 8 radial
Bessel functions, E(3)-ACE higher-order message passing [arXiv:2206.07697]."""
from repro_torch.models.equivariant import EquivariantConfig

FULL = EquivariantConfig(
    name="mace", kind="mace", n_layers=2, d_hidden=128, l_max=2,
    correlation_order=3, n_rbf=8,
)
SMOKE = EquivariantConfig(
    name="mace-smoke", kind="mace", n_layers=1, d_hidden=16, l_max=2,
    correlation_order=3, n_rbf=4,
)
