"""egnn [gnn]: 4 layers d_hidden=64, E(n)-equivariant [arXiv:2102.09844]."""
from repro_torch.models.equivariant import EquivariantConfig

FULL = EquivariantConfig(name="egnn", kind="egnn", n_layers=4, d_hidden=64)
SMOKE = EquivariantConfig(name="egnn-smoke", kind="egnn", n_layers=2, d_hidden=16)
