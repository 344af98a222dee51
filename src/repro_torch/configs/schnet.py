"""schnet [gnn] — 3 interactions, d_hidden=64, 300 RBF, cutoff 10
[arXiv:1706.08566; paper].  The same numbers as ``repro.configs.schnet``."""
from repro_torch.models.gnn.schnet import SchNetConfig

FULL = SchNetConfig(name="schnet", n_interactions=3, d_hidden=64, n_rbf=300,
                    cutoff=10.0)


def reduced() -> SchNetConfig:
    return SchNetConfig(name="schnet-reduced", n_interactions=2, d_hidden=16,
                        n_rbf=16, cutoff=10.0)
