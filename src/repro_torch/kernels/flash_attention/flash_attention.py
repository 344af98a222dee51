"""Causal flash attention (forward): CUDA kernel, plain version, wrapper and
launch counter.

Port of ``repro.kernels.flash_attention.flash_attention.flash_attention``:
causal ``softmax(q·kᵀ/√d)·v`` on ``(BH, S, d)`` with the kv heads already
repeated, f32 accumulation, output in ``q``'s type.  The CUDA kernel
(``csrc/flash_attention.cu``) keeps the reference's online softmax and
constants with its own tiling, for every head dim d ≥ 1: bf16 and f16
inputs run on ``wgmma`` fed by a TMA K/V ring (128-row q tiles, 128-key kv
tiles, 64-key at d > 128), f32 inputs as 3xTF32 on ``mma.sync`` (128-row q
and 64-key kv tiles, 64 and 32 at d > 128), never single-pass TF32 and
whatever torch's TF32 flags say.  Up to 256 the kernel is compiled at the
widths ``KERNEL_HEAD_DIMS`` names, with d a constant; any other d ≤ 256
runs at the next wider one, q, k and v padded with zero columns on the
card and the output cut back, the scale staying 1/√d of the true d.  Past
256, d is padded on the card to a multiple of ``SLICE`` (64) and one wide
kernel a dtype family takes it: a block streams q and k through shared
memory in 64-column slices and computes P·v for ``WIDE_CHUNK`` of v's
columns, recomputing q·kᵀ and the softmax for each chunk, so its shared
memory does not grow with d.  The 16-bit kernels round the probabilities
P to the input's type (bf16, or f16 with 3 more mantissa bits) before P·v,
where the reference keeps P in f32 (its row sums stay f32); the f32 kernel
keeps P in f32.

Inputs: the reference upcasts each of q, k and v to f32 on its own and
casts the output to q's dtype.  Where q, k and v are all f32, all bf16 or
all f16 the kernel of that type runs; any other real dtype or mix (f64,
integers, q f32 with k bf16, ...) is cast to f32 on the card and runs the
f32 kernel, the output cast to q's dtype: the reference's arithmetic.
Complex inputs raise ``TypeError`` (the upcast would drop their imaginary
part).

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

# the launcher's dtype codes (csrc/flash_attention.cu FA_*)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernel's compiled head dims up to 256 for each dtype
KERNEL_HEAD_DIMS = {torch.float32: (16, 32, 64, 128, 256),
                    torch.bfloat16: (64, 128, 256),
                    torch.float16: (64, 128, 256)}
SLICE = 64        # past 256: d padded to a multiple of it, q and k by it
# past 256: the v columns one block of the wide kernel computes
WIDE_CHUNK = {torch.float32: 128, torch.bfloat16: 256, torch.float16: 256}


def padded_head_dim(d: int, dtype: torch.dtype) -> int:
    """The width the kernel runs head dim ``d`` at in ``dtype``: up to 256
    the narrowest compiled width at least ``d``, past it the next multiple
    of ``SLICE``; the rest zero columns."""
    widths = KERNEL_HEAD_DIMS[dtype]
    if d <= widths[-1]:
        return next(w for w in widths if w >= d)
    return -(-d // SLICE) * SLICE


def value_chunks(d: int, dtype: torch.dtype) -> int:
    """Blocks a q tile takes along v's columns: 1 up to 256, past it
    ``ceil(padded d / WIDE_CHUNK)``, each recomputing q·kᵀ."""
    dp = padded_head_dim(d, dtype)
    if dp <= KERNEL_HEAD_DIMS[dtype][-1]:
        return 1
    return -(-dp // WIDE_CHUNK[dtype])


def kernel_dtype(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.dtype:
    """The type the kernel runs q, k and v in: theirs where all three are
    f32, bf16 or f16, f32 otherwise (each cast on its own, as the
    reference upcasts)."""
    if q.dtype in DTYPE_CODES and k.dtype == q.dtype and v.dtype == q.dtype:
        return q.dtype
    return torch.float32


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
    """q/k/v (BH, S, d) of any real dtype, kv pre-repeated to full heads
    (the GQA repeat happens in the caller).  Causal.  → (BH, S, d) in
    ``q.dtype``.

    ``block_q``/``block_k`` are the reference's tiles: they are cut to S and
    must divide it, as there; the CUDA kernel tiles on its own.
    """
    if any(t.is_complex() for t in (q, k, v)):
        raise TypeError(f"flash_attention takes real q, k, v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must all be (BH, S, d)")
    bh, s, d = q.shape
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
    out_dtype, dtype = q.dtype, kernel_dtype(q, k, v)
    dp = padded_head_dim(d, dtype)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    if dp != d:           # zero columns add nothing to q·k; cut off below
        q, k, v = (torch.nn.functional.pad(t, (0, dp - d))
                   for t in (q, k, v))
    out = torch.empty_like(q)
    lib = build.load(LIBRARY)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s,
            dp, DTYPE_CODES[dtype], 1.0 / math.sqrt(d), stream)
    build.check_launch("flash_attention", err)
    flash_attention.launches += 1
    if dp != d:
        out = out[..., :d].contiguous()
    return out.to(out_dtype)


flash_attention.launches = 0
