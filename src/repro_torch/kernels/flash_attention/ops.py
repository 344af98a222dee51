"""Public wrapper: (B, S, H, hd) GQA attention → the flash kernel's layout
(port of ``repro.kernels.flash_attention.ops``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    causal_attention_plain, flash_attention)


def mha_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               block_q: int = 256, block_k: int = 256,
               use_kernel: bool = True) -> torch.Tensor:
    """q (B, S, H, hd); k/v (B, S, KV, hd) → (B, S, H, hd).  Each kv head
    is repeated for its H/KV query heads, as ``jnp.repeat`` does.
    ``use_kernel=False`` asks for the plain version, as the reference's
    ``use_kernel=False`` asks for its oracle."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    if use_kernel:
        of = flash_attention(qf, kf, vf, block_q=block_q, block_k=block_k)
    else:
        of = causal_attention_plain(qf, kf, vf)
    return of.reshape(b, h, s, hd).transpose(1, 2)
