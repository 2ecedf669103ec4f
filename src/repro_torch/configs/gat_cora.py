"""gat-cora [gnn] — GAT (arXiv:1710.10903): 2 layers, 8 heads x 8 hidden."""
from repro_torch.configs.base import GNN_SHAPES, GNNConfig

CONFIG = GNNConfig(
    name="gat-cora",
    n_layers=2,
    d_hidden=8,
    n_heads=8,
    aggregator="attn",
)
SHAPES = GNN_SHAPES
