"""Gradient compression: per-block int8 quantization with error feedback
(port of ``repro.optim.compression``).

A compressed all-reduce sends int8 blocks and one f32 scale a block in
place of the gradient: a quarter of the f32 bytes and half of the bf16
bytes, plus ``4 / block`` bytes an element of scales.  Error feedback
(Karimireddy et al. 2019) carries each leaf's quantization error into the
next step's gradient, which keeps SGD and Adam converging.

The arithmetic is the reference's, in its order and in its dtypes: the
flat array is zero-padded to whole blocks, ``scale = max|block| / 127``
in the input's dtype (an all-zero block gets exactly 1.0), ``q =
clip(round(x / scale), -127, 127)`` rounded half to even as
``jnp.round``, and the scales are returned in f32.  Decoding multiplies
in f32 and casts to the requested dtype; ``error_feedback_compress``
keeps the residual in f32.  Every function runs on the device of its
input.

Not here: ``compressed_psum``, the collective that sums the decoded
blocks over a mesh axis (ROADMAP queue A7).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization of ``x`` flattened →
    ``(q (n_blocks, block) int8, scale (n_blocks, 1) f32)``."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % block))
    blocks = flat.reshape(-1, block)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    # divided element by element: a CUDA division by a Python scalar
    # multiplies by its reciprocal, one ulp off the reference's quotient
    scale = amax / torch.full_like(amax, 127.0)
    # all-zero blocks: an explicit scale of 1.0 (not an epsilon floor)
    # keeps round(0 / scale) exact and the decoded block exactly zero
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: Sequence[int], dtype: torch.dtype
                    ) -> torch.Tensor:
    """The first ``prod(shape)`` decoded values (``q · scale`` in f32) as
    a ``shape`` tensor of ``dtype``."""
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(tuple(shape)).to(dtype)


def _leaf(g: torch.Tensor, r: torch.Tensor, block: int):
    x = g.to(torch.float32) + r
    q, scale = quantize_int8(x, block)
    dec = dequantize_int8(q, scale, x.shape, torch.float32)
    return dec.to(g.dtype), x - dec


def error_feedback_compress(grads, residual, block: int = 256):
    """Quantize ``grads + residual`` leaf by leaf → (decoded gradients in
    each gradient's dtype, new f32 residual).  The decoded tree is what a
    compressed all-reduce would deliver; the residual carries each leaf's
    quantization error to the next step.  ``residual`` has ``grads``'
    structure (``init_residual``)."""
    flat_g, structure = tree.flatten(grads)
    flat_r = tree.leaves(residual)
    if len(flat_r) != len(flat_g):
        raise ValueError(f"residual holds {len(flat_r)} leaves, the "
                         f"gradients {len(flat_g)}")
    out = [_leaf(g, r, block) for g, r in zip(flat_g, flat_r)]
    return (tree.unflatten(structure, [o[0] for o in out]),
            tree.unflatten(structure, [o[1] for o in out]))


def init_residual(params):
    """A zero f32 residual per leaf of ``params``, on each leaf's
    device."""
    leaves, structure = tree.flatten(params)
    return tree.unflatten(structure, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in leaves])


def wire_bytes(params, block: int = 256) -> int:
    """Bytes a compressed all-reduce sends for one copy of ``params``:
    int8 blocks (padding included) and one f32 scale a block."""
    total = 0
    for p in tree.leaves(params):
        n_blocks = -(-p.numel() // block)
        total += n_blocks * (block + 4)
    return total
