"""EmbeddingBag kernel (port of ``repro.kernels.embedding_bag``)."""
from repro_torch.kernels.embedding_bag.embedding_bag import (
    LIBRARY, embedding_bag, embedding_bag_plain, take_rows)
from repro_torch.kernels.embedding_bag.ops import lookup

__all__ = ["LIBRARY", "embedding_bag", "embedding_bag_plain", "lookup",
           "take_rows"]
