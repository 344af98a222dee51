"""Counter-hash draw kernel (port of ``repro.kernels.forest_sampler``)."""
from repro_torch.kernels.forest_sampler.forest_sampler import (
    LIBRARY, hash_draws, hash_draws_plain, split64)

__all__ = ["LIBRARY", "hash_draws", "hash_draws_plain", "split64"]
