"""gat-cora [gnn] — 2 layers, d_hidden=8, 8 attention heads
[arXiv:1710.10903; paper].  The same numbers as
``repro.configs.gat_cora``."""
from repro_torch.models.gnn.gat import GATConfig

FULL = GATConfig(name="gat-cora", n_layers=2, d_in=1433, d_hidden=8,
                 n_heads=8, n_classes=7)


def reduced() -> GATConfig:
    return GATConfig(name="gat-reduced", n_layers=2, d_in=32, d_hidden=4,
                     n_heads=2, n_classes=4)
