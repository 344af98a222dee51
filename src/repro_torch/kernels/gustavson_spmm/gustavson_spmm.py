"""Gustavson SpMM on the dedup-chunk layout: CUDA kernel, plain version,
wrapper and launch counter.

Port of ``repro.kernels.gustavson_spmm.gustavson_spmm.spmm_dedup_chunks``.
The kernel (``csrc/spmm_dedup_chunks.cu``) runs one thread block per
(output block, feature tile) and walks the block's chunk range
``block_ptr[b] .. block_ptr[b+1]``; the source says what bounds it.

``spmm_dedup_chunks`` takes the plain PyTorch version only for tensors on
the CPU.  For CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = build.KernelLibrary(
    name="spmm_dedup_chunks",
    sources=(pathlib.Path(__file__).parent / "csrc"
             / "spmm_dedup_chunks.cu",),
    functions=(("spmm_dedup_chunks_launch",
                (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),))

MAX_D_TILE = 32
STATIC_SHARED_BYTES = 48 * 1024     # dynamic smem above this needs opt-in


def d_tile_for(d: int) -> int:
    """Smallest power of two ≥ ``d``, capped at ``MAX_D_TILE``."""
    t = 1
    while t < min(d, MAX_D_TILE):
        t *= 2
    return t


def spmm_dedup_chunks_plain(u_cols: torch.Tensor, remaining: torch.Tensor,
                            block_ptr: torch.Tensor, a: torch.Tensor,
                            x: torch.Tensor, *,
                            block_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per chunk, coefficient tile ×
    gathered live operands, chunks summed into their block in order.
    Lanes ``u ≥ remaining[k]`` are neither gathered nor added."""
    n_chunks, width = u_cols.shape
    n_blocks = block_ptr.shape[0] - 1
    lane = torch.arange(width, device=u_cols.device)
    live = lane[None, :] < remaining[:, None].to(torch.int64)
    idx = torch.where(live, u_cols.to(torch.int64), 0)
    land = x.index_select(0, idx.reshape(-1)).reshape(n_chunks, width, -1)
    land = torch.where(live[:, :, None], land, 0.0)
    contrib = torch.bmm(a.reshape(n_chunks, block_rows, width), land)
    out_block = torch.repeat_interleave(
        torch.arange(n_blocks, device=u_cols.device),
        (block_ptr[1:] - block_ptr[:-1]).to(torch.int64))
    y = contrib.new_zeros((n_blocks, block_rows, x.shape[1]))
    y.index_add_(0, out_block, contrib)
    return y.reshape(n_blocks * block_rows, x.shape[1])


def _check(u_cols, remaining, block_ptr, a, x, block_rows):
    dev = x.device
    for name, t in (("u_cols", u_cols), ("remaining", remaining),
                    ("block_ptr", block_ptr), ("a", a), ("x", x)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("u_cols", u_cols), ("remaining", remaining),
                    ("block_ptr", block_ptr)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("a", a), ("x", x)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype} "
                            "(the kernel is f32 only)")
    if u_cols.ndim != 2 or x.ndim != 2:
        raise ValueError(f"u_cols and x must be 2-D, got {tuple(u_cols.shape)}"
                         f" and {tuple(x.shape)}")
    n_chunks, width = u_cols.shape
    if remaining.shape != (n_chunks,):
        raise ValueError(f"remaining has shape {tuple(remaining.shape)}, "
                         f"expected ({n_chunks},)")
    if a.shape != (n_chunks * block_rows, width):
        raise ValueError(f"a has shape {tuple(a.shape)}, expected "
                         f"({n_chunks * block_rows}, {width})")
    if block_ptr.ndim != 1 or not 1 <= block_ptr.shape[0] <= n_chunks + 1:
        raise ValueError(f"block_ptr has shape {tuple(block_ptr.shape)}; it "
                         "needs n_blocks + 1 entries and every block owns "
                         f"at least one of the {n_chunks} chunks")


def spmm_dedup_chunks(u_cols: torch.Tensor, remaining: torch.Tensor,
                      block_ptr: torch.Tensor, a: torch.Tensor,
                      x: torch.Tensor, *, block_rows: int) -> torch.Tensor:
    """y = A @ x on the dedup-chunk layout → ``(n_blocks·block_rows, D)``.

    u_cols (n_chunks, width) int32; remaining (n_chunks,) int32; block_ptr
    (n_blocks+1,) int32; a (n_chunks·block_rows, width) f32; x (N, D) f32.
    """
    _check(u_cols, remaining, block_ptr, a, x, block_rows)
    if x.device.type == "cpu":
        return spmm_dedup_chunks_plain(u_cols, remaining, block_ptr, a, x,
                                       block_rows=block_rows)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_dedup_chunks runs on cuda or cpu, not "
                         f"{x.device}")
    n_blocks = block_ptr.shape[0] - 1
    width = u_cols.shape[1]
    d = x.shape[1]
    d_tile = d_tile_for(d)
    if d_tile * block_rows > 1024:
        raise ValueError(f"block_rows={block_rows} × d_tile={d_tile} exceeds "
                         "1024 threads per block")
    if width * d_tile * 4 > STATIC_SHARED_BYTES:
        raise ValueError(f"width={width} needs {width * d_tile * 4} bytes of "
                         "shared memory; pack with a smaller width_cap")
    y = torch.empty((n_blocks * block_rows, d), dtype=x.dtype,
                    device=x.device)
    lib = build.load(LIBRARY)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spmm_dedup_chunks_launch(
            u_cols.data_ptr(), remaining.data_ptr(), block_ptr.data_ptr(),
            a.data_ptr(), x.data_ptr(), y.data_ptr(), n_blocks, block_rows,
            width, d, d_tile, stream)
    build.check_launch("spmm_dedup_chunks", err)
    spmm_dedup_chunks.launches += 1
    return y


spmm_dedup_chunks.launches = 0
