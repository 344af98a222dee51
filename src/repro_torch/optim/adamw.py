"""AdamW with global-norm clipping on nested dicts of tensors (port of
``repro.optim.adamw``).

The arithmetic is the reference's, in its order: the clip scale
``min(1, clip / max(‖g‖, 1e-9))``, ``m = b1·m + (1−b1)·g``, ``v = b2·v +
(1−b2)·g·g``, ``m̂ = m / (1 − b1ᵗ)``, ``v̂ = v / (1 − b2ᵗ)``, then ``p −
lr·(m̂ / (√v̂ + eps) + wd·p)``.  ``torch.optim.AdamW`` differs (eps after
``√v / √(1 − b2ᵗ)``, no global-norm clip) and is not used.  Each step is
a few ``torch._foreach_*`` launches over all leaves.  State (step, m, v)
is f32 whatever the parameters' dtype, and stays on their device: the
step count is a 0-d int32 tensor, so a step reads nothing back to the
host.  Functions are pure: they return new tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    m: dict
    v: dict


def init_state(params) -> AdamWState:
    leaves, structure = tree.flatten(params)
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves]
    step = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    return AdamWState(step=step, m=tree.unflatten(structure, zeros),
                      v=tree.unflatten(structure, [z.clone() for z in zeros]))


def global_norm(grads) -> torch.Tensor:
    """√(Σ_leaves Σ g²) in f32, leaves summed in order."""
    total = None
    for g in tree.leaves(grads):
        s = torch.sum(torch.square(g.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig):
    """One AdamW step → (new params, new state, the gradients' global
    norm before clipping)."""
    flat_p, structure = tree.flatten(params)
    g = [t.to(torch.float32) for t in tree.leaves(grads)]
    gnorm = global_norm(g)
    if cfg.grad_clip > 0:
        # divide tensor by tensor: a Python number over a tensor is a
        # reciprocal and a product in PyTorch
        clip = torch.full_like(gnorm, cfg.grad_clip)
        g = torch._foreach_mul(g, torch.clamp(
            clip / torch.clamp(gnorm, min=1e-9), max=1.0))
    step = state.step + 1
    t = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, t)
    b2c = 1.0 - torch.pow(cfg.b2, t)
    m = torch._foreach_mul(tree.leaves(state.m), cfg.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    v = torch._foreach_mul(tree.leaves(state.v), cfg.b2)
    gg = torch._foreach_mul(g, 1 - cfg.b2)
    torch._foreach_mul_(gg, g)
    torch._foreach_add_(v, gg)
    den = torch._foreach_sqrt(torch._foreach_div(v, b2c))
    torch._foreach_add_(den, cfg.eps)
    delta = torch._foreach_div(torch._foreach_div(m, b1c), den)
    p32 = [p.to(torch.float32) for p in flat_p]
    if cfg.weight_decay:
        torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
    new_p = torch._foreach_sub(p32, torch._foreach_mul(delta, cfg.lr))
    new_p = [q.to(p.dtype) for q, p in zip(new_p, flat_p)]
    return (tree.unflatten(structure, new_p),
            AdamWState(step=step, m=tree.unflatten(structure, m),
                       v=tree.unflatten(structure, v)),
            gnorm)
