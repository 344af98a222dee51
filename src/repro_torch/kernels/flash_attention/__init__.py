"""Causal flash attention kernel (port of
``repro.kernels.flash_attention``)."""
from repro_torch.kernels.flash_attention.flash_attention import (
    LIBRARY, causal_attention_plain, flash_attention)
from repro_torch.kernels.flash_attention.ops import mha_causal

__all__ = ["LIBRARY", "causal_attention_plain", "flash_attention",
           "mha_causal"]
