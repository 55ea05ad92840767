"""graphcast [gnn]: 16-layer d_hidden=512 encoder-processor-decoder mesh GNN,
mesh_refinement=6, n_vars=227, sum aggregator [arXiv:2212.12794]. The grid2mesh
frontend applies only to the weather grid; on assigned graph shapes the encoder
is a feature projection and the 16-layer processor is exercised as-is."""
from repro_torch.models.gnn import GNNConfig


def full(d_in: int, n_classes: int) -> GNNConfig:
    return GNNConfig(
        name="graphcast", kind="mpnn", n_layers=16, d_hidden=512,
        aggregator="sum", mesh_refinement=6, n_vars=227,
        d_in=d_in, n_classes=n_classes, remat=True,
    )


def smoke(d_in: int, n_classes: int) -> GNNConfig:
    return GNNConfig(
        name="graphcast-smoke", kind="mpnn", n_layers=2, d_hidden=32,
        aggregator="sum", d_in=d_in, n_classes=n_classes,
    )
