"""Public wrapper for the EmbeddingBag kernel (port of
``repro.kernels.embedding_bag.ops``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.embedding_bag import (
    embedding_bag, embedding_bag_plain)


def lookup(ids: torch.Tensor, table: torch.Tensor, batch_tile: int = 8,
           use_kernel: bool = True) -> torch.Tensor:
    """ids (B, F, M) → (B, F, D).  ``use_kernel=False`` asks for the plain
    version, as the reference's ``use_kernel=False`` asks for its oracle."""
    b, f, _ = ids.shape
    if use_kernel:
        out = embedding_bag(ids, table, batch_tile=batch_tile)
    else:
        out = embedding_bag_plain(ids, table)
    return out.reshape(b, f, -1)
