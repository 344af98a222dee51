"""dlrm-rm2 [recsys] — 13 dense, 26 sparse, embed_dim=64,
bot 13-512-256-64, top 512-512-256-1, dot interaction
[arXiv:1906.00091; paper].  The same numbers as
``repro.configs.dlrm_rm2``."""
from repro_torch.models.recsys.dlrm import DLRMConfig

FULL = DLRMConfig(name="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
                  bot_mlp=(13, 512, 256, 64),
                  top_mlp_hidden=(512, 512, 256, 1))


def reduced() -> DLRMConfig:
    return DLRMConfig(name="dlrm-reduced", n_dense=13, n_sparse=4,
                      embed_dim=8, bot_mlp=(13, 16, 8),
                      top_mlp_hidden=(16, 1),
                      vocab_sizes=(1000, 100, 50, 10))
