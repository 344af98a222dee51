"""Public wrapper for the SDDMM kernel (port of
``repro.kernels.sddmm.ops``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.sddmm.sddmm import sddmm, sddmm_plain


def edge_scores(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor, edge_block: int = 256,
                use_kernel: bool = True) -> torch.Tensor:
    """Per-edge scores for any E: the edge lists are padded with index 0 to
    a multiple of ``edge_block`` and the scores sliced back to ``(E,)``.
    ``use_kernel=False`` asks for the plain version, as the reference's
    ``use_kernel=False`` asks for its oracle."""
    e = src.shape[0]
    pad = (-e) % edge_block
    if pad:
        src = F.pad(src, (0, pad))
        dst = F.pad(dst, (0, pad))
    if use_kernel:
        out = sddmm(src, dst, x, y, edge_block=edge_block)
    else:
        out = sddmm_plain(src, dst, x, y)
    return out[:e]
