"""Causal flash attention (forward): CUDA kernel, plain version, wrapper and
launch counter.

Port of ``repro.kernels.flash_attention.flash_attention.flash_attention``:
causal ``softmax(q·kᵀ/√d)·v`` on ``(BH, S, d)`` with the kv heads already
repeated, f32 accumulation, output in ``q``'s type.  The CUDA kernel
(``csrc/flash_attention.cu``) keeps the reference's online softmax and
constants with its own tiling, for every head dim 1 ≤ d ≤ 256: bf16
inputs run on ``wgmma`` fed by a TMA K/V ring (128-row q tiles, 128-key kv
tiles, 64-key at d > 128), f32 inputs as 3xTF32 on ``mma.sync`` (128-row q
and 64-key kv tiles, 64 and 32 at d > 128), never single-pass TF32 and
whatever torch's TF32 flags say.  The kernel is compiled at the widths
``KERNEL_HEAD_DIMS`` names, with d a constant; any other d runs at the
next wider one, q, k and v padded with zero columns on the card and the
output cut back, the scale staying 1/√d of the true d.  A d past
``MAX_HEAD_DIM`` raises, on every device: nothing falls back.  The bf16
kernel rounds the probabilities P to bf16 before P·v, where the reference
keeps P in f32 (its row sums stay f32); the f32 kernel keeps P in f32.

``flash_attention`` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from repro_torch.kernels import build

LIBRARY = build.KernelLibrary(
    name="flash_attention",
    sources=(pathlib.Path(__file__).parent / "csrc" / "flash_attention.cu",),
    functions=(("flash_attention_launch",
                (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_float, ctypes.c_void_p)),))

DTYPES = (torch.float32, torch.bfloat16)
# the kernel's compiled head dims for each dtype (csrc/flash_attention.cu)
KERNEL_HEAD_DIMS = {torch.float32: (16, 32, 64, 128, 256),
                    torch.bfloat16: (64, 128, 256)}
MAX_HEAD_DIM = 256                     # the kernel's widest instantiation


def padded_head_dim(d: int, dtype: torch.dtype) -> int:
    """The width the kernel runs head dim ``d`` at in ``dtype``: the
    narrowest compiled width at least ``d``, the rest zero columns."""
    return next(w for w in KERNEL_HEAD_DIMS[dtype] if w >= d)


def causal_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``ref.py``): the whole masked score matrix in
    f32, softmax, product with v, cast to ``q.dtype``."""
    _, s, d = q.shape
    sc = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril_()
    sc.masked_fill_(~mask, -1e30)
    w = torch.softmax(sc, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 256, block_k: int = 256) -> torch.Tensor:
    """q/k/v (BH, S, d), f32 or bf16, kv pre-repeated to full heads (the
    GQA repeat happens in the caller).  Causal.  → (BH, S, d) in
    ``q.dtype``.

    ``block_q``/``block_k`` are the reference's tiles: they are cut to S and
    must divide it, as there; the CUDA kernel tiles on its own.
    """
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q, k, v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must all be (BH, S, d)")
    bh, s, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: B8 takes head dims up to "
                         f"{MAX_HEAD_DIM}")
    block_q, block_k = min(block_q, s), min(block_k, s)
    if block_q < 1 or block_k < 1 or s % block_q or s % block_k:
        raise ValueError(f"blocks ({block_q}, {block_k}) must divide "
                         f"S = {s}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous")
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    dp = padded_head_dim(d, q.dtype)
    if dp != d:           # zero columns add nothing to q·k; cut off below
        q, k, v = (torch.nn.functional.pad(t, (0, dp - d))
                   for t in (q, k, v))
    out = torch.empty_like(q)
    lib = build.load(LIBRARY)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s,
            dp, int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), stream)
    build.check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out if dp == d else out[..., :d].contiguous()


flash_attention.launches = 0
