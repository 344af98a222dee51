"""Shared NN building blocks (port of ``repro.models.common``): parameter
trees are plain dicts of tensors, in the reference's ``(d_in, d_out)``
weight layout, so ``x @ w + b`` reads the same on both sides."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gaussian ``(d_in, d_out)`` weight scaled by ``1/√d_in``, drawn on the
    generator's device."""
    return torch.randn((d_in, d_out), generator=generator, dtype=dtype,
                       device=generator.device) / d_in ** 0.5


def mlp_init(generator: torch.Generator, dims: Sequence[int],
             dtype: torch.dtype = torch.float32,
             device: Optional[torch.device] = None) -> Params:
    """``{"w{i}": (dims[i], dims[i+1]), "b{i}": zeros}`` on ``device`` (the
    generator's device when None)."""
    dev = generator.device if device is None else device
    out = {f"w{i}": dense_init(generator, dims[i], dims[i + 1],
                               dtype=dtype).to(dev)
           for i in range(len(dims) - 1)}
    out.update({f"b{i}": torch.zeros((dims[i + 1],), dtype=dtype,
                                     device=dev)
                for i in range(len(dims) - 1)})
    return out


def mlp_apply(params: Params, x: torch.Tensor,
              act: Callable[[torch.Tensor], torch.Tensor] = F.silu,
              final_act: bool = False) -> torch.Tensor:
    """``x @ w_i + b_i`` per layer, then ``act`` on every layer but the last
    (and on the last too with ``final_act``)."""
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x
