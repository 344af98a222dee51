"""Shared NN building blocks (port of ``repro.models.common``): parameter
trees are plain dicts of tensors, in the reference's ``(d_in, d_out)``
weight layout, so ``x @ w + b`` reads the same on both sides."""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import tree

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


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x / √(mean(x²) + eps) · gamma``, the mean taken in f32."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """``(x − mean) / √(var + eps) · gamma + beta`` in f32, the population
    variance as ``jnp.var`` takes it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """SchNet's ssp(x) = ln(0.5 eˣ + 0.5): ``jax.nn.softplus`` (which is
    ``logaddexp(x, 0)``) minus ln 2."""
    return torch.logaddexp(x, torch.zeros_like(x)) - math.log(2.0)


def count_params(params) -> int:
    """Number of scalars in a parameter tree."""
    return sum(p.numel() for p in tree.leaves(params))


def pin_rows(x: torch.Tensor, dp_axes) -> torch.Tensor:
    """The reference's ``_pin``: node- and edge-major tensors stay sharded
    over ``dp_axes`` along their first dim (a redistribute of a
    ``DTensor``; no-op on a plain tensor or with no axes)."""
    if not dp_axes:
        return x
    from repro_torch.core.distributed import constrain
    return constrain(x, (tuple(dp_axes),) + (None,) * (x.ndim - 1))
