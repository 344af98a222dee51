"""dimenet [gnn] — 6 blocks, d_hidden=128, n_bilinear=8, n_spherical=7,
n_radial=6 [arXiv:2003.03123; unverified].  The same numbers as
``repro.configs.dimenet``."""
from repro_torch.models.gnn.dimenet import DimeNetConfig

FULL = DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128, n_bilinear=8,
                     n_spherical=7, n_radial=6)


def reduced() -> DimeNetConfig:
    return DimeNetConfig(name="dimenet-reduced", n_blocks=2, d_hidden=16,
                         n_bilinear=4, n_spherical=3, n_radial=3)
