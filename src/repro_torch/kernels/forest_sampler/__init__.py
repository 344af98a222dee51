"""Counter-hash draw kernel and the fused forest sample (port of
``repro.kernels.forest_sampler`` and of the device sampler's gathers)."""
from repro_torch.kernels.forest_sampler.forest_sampler import (
    FOREST_LIBRARY, LIBRARY, MAX_HOPS, forest_sample, forest_sample_plain,
    hash_draws, hash_draws_plain, split64)

__all__ = ["FOREST_LIBRARY", "LIBRARY", "MAX_HOPS", "forest_sample",
           "forest_sample_plain", "hash_draws", "hash_draws_plain",
           "split64"]
