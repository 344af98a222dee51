"""gcn-cora [gnn] — 2 layers, d_hidden=16, sym-norm aggregation
[arXiv:1609.02907; paper].  The same numbers as
``repro.configs.gcn_cora``."""
from repro_torch.models.gnn.gcn import GCNConfig

FULL = GCNConfig(name="gcn-cora", n_layers=2, d_in=1433, d_hidden=16,
                 n_classes=7)


def reduced() -> GCNConfig:
    return GCNConfig(name="gcn-reduced", n_layers=2, d_in=32, d_hidden=8,
                     n_classes=4)
