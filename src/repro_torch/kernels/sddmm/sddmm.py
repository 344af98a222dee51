"""SDDMM edge scores: CUDA kernel, plain version, wrapper and launch counter.

Port of ``repro.kernels.sddmm.sddmm.sddmm``: ``score[e] = Σ_d x[src[e], d] ·
y[dst[e], d]``.  The CUDA kernel (``csrc/sddmm.cu``) runs one warp per edge
and reduces the row-pair product with warp shuffles.  Indices follow
``jnp.take``'s default, the reference oracle's: ``i`` in ``[-N, 0)`` reads
row ``i + N``, and an index outside ``[-N, N)`` gives NaN.

``sddmm`` takes the plain version only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.embedding_bag.embedding_bag import take_rows

LIBRARY = build.KernelLibrary(
    name="sddmm",
    sources=(pathlib.Path(__file__).parent / "csrc" / "sddmm.cu",),
    functions=(("sddmm_launch",
                (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                 ctypes.c_void_p)),))

PLAIN_EDGE_CHUNK = 1 << 20


def sddmm_plain(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``ref.py``'s gather, product and sum), over
    ``PLAIN_EDGE_CHUNK`` edges at a time so that the gathered rows stay
    small beside the operands (2 × 24.7 GB unchunked at ogb_products)."""
    out = torch.empty(src.shape[0], dtype=torch.float32, device=x.device)
    for lo in range(0, src.shape[0], PLAIN_EDGE_CHUNK):
        hi = lo + PLAIN_EDGE_CHUNK
        out[lo:hi] = (take_rows(x, src[lo:hi])
                      * take_rows(y, dst[lo:hi])).sum(-1)
    return out


def sddmm(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
          y: torch.Tensor, edge_block: int = 256) -> torch.Tensor:
    """src/dst (E,) int32, E % edge_block == 0; x (Nx, D), y (Ny, D) f32 →
    ``(E,)`` f32.

    ``edge_block`` is the reference's grid tile; the CUDA kernel has its own
    (one warp per edge) and keeps only the reference's divisibility check.
    """
    if src.dtype != torch.int32 or dst.dtype != torch.int32:
        raise TypeError(f"sddmm takes int32 src and dst, got {src.dtype} "
                        f"and {dst.dtype}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"sddmm takes float32 x and y, got {x.dtype} and "
                        f"{y.dtype}")
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError(f"src {tuple(src.shape)} and dst {tuple(dst.shape)} "
                         "must be the same 1-D shape")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} must be "
                         "2-D with one width")
    if edge_block < 1 or src.shape[0] % edge_block:
        raise ValueError(f"{src.shape[0]} edges are not a multiple of "
                         f"edge_block {edge_block}")
    for name, t in (("src", src), ("dst", dst), ("y", y)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if not all(t.is_contiguous() for t in (src, dst, x, y)):
        raise ValueError("src, dst, x and y must be contiguous")
    if x.device.type == "cpu":
        return sddmm_plain(src, dst, x, y)
    if x.device.type != "cuda":
        raise ValueError(f"sddmm runs on cuda or cpu, not {x.device}")
    out = torch.empty(src.shape[0], dtype=torch.float32, device=x.device)
    lib = build.load(LIBRARY)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sddmm_launch(src.data_ptr(), dst.data_ptr(), x.data_ptr(),
                               y.data_ptr(), out.data_ptr(), src.shape[0],
                               x.shape[0], y.shape[0], x.shape[1], stream)
    build.check_launch("sddmm", err)
    sddmm.launches += 1
    return out


sddmm.launches = 0
