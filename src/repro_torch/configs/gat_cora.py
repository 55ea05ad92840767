"""gat-cora [gnn]: 2 layers, 8 heads, d_hidden=8 per head, attention
aggregator [arXiv:1710.10903]."""
from repro_torch.models.gnn import GNNConfig


def full(d_in: int, n_classes: int) -> GNNConfig:
    return GNNConfig(
        name="gat-cora", kind="gat", n_layers=2, d_hidden=8, n_heads=8,
        aggregator="attn", d_in=d_in, n_classes=n_classes,
    )


def smoke(d_in: int, n_classes: int) -> GNNConfig:
    return GNNConfig(
        name="gat-smoke", kind="gat", n_layers=2, d_hidden=4, n_heads=2,
        aggregator="attn", d_in=d_in, n_classes=n_classes,
    )
