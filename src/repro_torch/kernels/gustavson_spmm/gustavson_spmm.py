"""Gustavson SpMM on the dedup-chunk layout, f32 and int8: CUDA kernels,
plain versions, wrappers and launch counters.

Port of ``repro.kernels.gustavson_spmm.gustavson_spmm.spmm_dedup_chunks``
and ``spmm_dedup_chunks_q8``.  Each kernel (``csrc/spmm_dedup_chunks.cu``,
``csrc/spmm_dedup_chunks_q8.cu``) runs one thread block per (output block,
column tile of ``d_tile_for(D)`` ≤ 32 columns) and walks the block's chunk
range ``block_ptr[b] .. block_ptr[b+1]``; each source says what bounds it.
The int8 kernel's feature scales cover a wider *scale* tile,
``auto_d_tile(D)`` (up to 512 columns); the two tiles are separate knobs.

The wrappers take the plain PyTorch version only for tensors on the CPU.
For CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

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

LIBRARY_Q8 = build.KernelLibrary(
    name="spmm_dedup_chunks_q8",
    sources=(pathlib.Path(__file__).parent / "csrc"
             / "spmm_dedup_chunks_q8.cu",),
    functions=(("spmm_dedup_chunks_q8_launch",
                (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                 _P)),))

MAX_D_TILE = 32
STATIC_SHARED_BYTES = 48 * 1024     # dynamic smem above this needs opt-in
MAX_SINGLE_TILE_D = 512  # auto_d_tile: one scale tile up to this width


def d_tile_for(d: int) -> int:
    """Smallest power of two ≥ ``d``, capped at ``MAX_D_TILE``."""
    t = 1
    while t < min(d, MAX_D_TILE):
        t *= 2
    return t


def auto_d_tile(d: int) -> int:
    """Width of an int8 feature *scale* tile (the reference's
    ``_auto_d_tile``): one tile up to ``MAX_SINGLE_TILE_D``; beyond that
    the smallest even split, rounded up to 8 columns.  Not the thread
    block's column tile (``d_tile_for``)."""
    if d <= MAX_SINGLE_TILE_D:
        return d
    n_tiles = -(-d // MAX_SINGLE_TILE_D)
    per_tile = -(-d // n_tiles)
    return -(-per_tile // 8) * 8


def fold_q8_in_order(isum: torch.Tensor, scale: torch.Tensor,
                     block_ptr: torch.Tensor) -> torch.Tensor:
    """The int8 kernels' fold: for each output block, chunk after chunk,
    ``y = fma(isum[k], scale[k], y)`` in f32 — one rounding per chunk, as
    the kernels' ``__fmaf_rn`` and the reference's contracted ``y + dot·s``.

    ``isum`` (n_chunks, ...) holds integer-valued chunk sums (< 2²⁴) and
    ``scale`` the f32 factor per chunk, broadcastable to one chunk's slice.
    The FMA is emulated in f64, where the product of such an integer and
    an f32 is exact.  Blocks are folded in order on every device
    (``index_add_`` on a GPU adds in no fixed order), which reads the
    deepest block's chunk count back to the host."""
    n_blocks = block_ptr.shape[0] - 1
    start = block_ptr[:-1].to(torch.int64)
    count = block_ptr[1:].to(torch.int64) - start
    y = torch.zeros((n_blocks,) + tuple(isum.shape[1:]),
                    dtype=torch.float32, device=isum.device)
    for i in range(int(count.max()) if n_blocks else 0):
        blocks = torch.nonzero(count > i).reshape(-1)
        k = start[blocks] + i
        y[blocks] = (isum[k].to(torch.float64) * scale[k].to(torch.float64)
                     + y[blocks].to(torch.float64)).to(torch.float32)
    return y


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


def _check(u_cols, remaining, block_ptr, a, x, block_rows, dtype,
           scales=()):
    """Devices, dtypes, contiguity and shapes shared by both kernels:
    ``dtype`` is the tiles' and operands' (f32, or int8 for the int8
    kernel), ``scales`` the int8 kernel's (name, f32 tensor) scales."""
    dev = x.device
    for name, t in (("u_cols", u_cols), ("remaining", remaining),
                    ("block_ptr", block_ptr), ("a", a), ("x", x), *scales):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("u_cols", u_cols), ("remaining", remaining),
                    ("block_ptr", block_ptr)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("a", a), ("x", x)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    for name, t in scales:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
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
    _check(u_cols, remaining, block_ptr, a, x, block_rows, torch.float32)
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


# ---------------------------------------------------------------------------
# int8: spmm_dedup_chunks_q8
# ---------------------------------------------------------------------------

def spmm_dedup_chunks_q8_plain(u_cols: torch.Tensor, remaining: torch.Tensor,
                               block_ptr: torch.Tensor, a_q8: torch.Tensor,
                               a_scale: torch.Tensor, x_q8: torch.Tensor,
                               x_scale: torch.Tensor, *, block_rows: int,
                               q_tile: int) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel, in its fold order: per
    chunk the integer products summed exactly (f32 sums of int8·int8 stay
    below 2²⁴), folded into the block as ``fma(isum, a_scale[k]·
    x_scale[col // q_tile], y)`` chunk after chunk (``fold_q8_in_order``).
    Lanes ``u ≥ remaining[k]`` are not read."""
    n_chunks, width = u_cols.shape
    d = x_q8.shape[1]
    lane = torch.arange(width, device=u_cols.device)
    live = lane[None, :] < remaining[:, None].to(torch.int64)
    idx = torch.where(live, u_cols.to(torch.int64), 0)
    land = x_q8.index_select(0, idx.reshape(-1)).reshape(
        n_chunks, width, d).to(torch.float32)
    land = torch.where(live[:, :, None], land, 0.0)
    a3 = torch.where(live[:, None, :], a_q8.reshape(
        n_chunks, block_rows, width).to(torch.float32), 0.0)
    isum = torch.bmm(a3, land)
    col_scale = torch.repeat_interleave(x_scale, q_tile)[:d]
    scale = (a_scale[:, None] * col_scale[None, :])[:, None, :]
    n_blocks = block_ptr.shape[0] - 1
    return fold_q8_in_order(isum, scale, block_ptr).reshape(
        n_blocks * block_rows, d)


def spmm_dedup_chunks_q8(u_cols: torch.Tensor, remaining: torch.Tensor,
                         block_ptr: torch.Tensor, a_q8: torch.Tensor,
                         a_scale: torch.Tensor, x_q8: torch.Tensor,
                         x_scale: torch.Tensor, *, block_rows: int,
                         q_tile: Optional[int] = None) -> torch.Tensor:
    """int8 y ≈ A @ x on the dedup-chunk layout → ``(n_blocks·block_rows,
    D)`` f32.

    u_cols (n_chunks, width) int32; remaining (n_chunks,) int32; block_ptr
    (n_blocks+1,) int32; a_q8 (n_chunks·block_rows, width) int8 with
    a_scale (n_chunks,) f32; x_q8 (N, D) int8 with x_scale
    (ceil(D/q_tile),) f32.  ``q_tile`` is the scale tile the features were
    quantized with (default ``auto_d_tile(D)``).
    """
    q_tile = auto_d_tile(x_q8.shape[1]) if q_tile is None else int(q_tile)
    _check(u_cols, remaining, block_ptr, a_q8, x_q8, block_rows, torch.int8,
           (("a_scale", a_scale), ("x_scale", x_scale)))
    d = x_q8.shape[1]
    n_scales = -(-d // q_tile) if q_tile >= 1 else -1
    if a_scale.shape != remaining.shape or x_scale.shape != (n_scales,):
        raise ValueError(f"a_scale has shape {tuple(a_scale.shape)} for "
                         f"{remaining.shape[0]} chunks and x_scale "
                         f"{tuple(x_scale.shape)} for D={d} in scale tiles "
                         f"of {q_tile} — quantize with the tile the kernel "
                         "runs with")
    if x_q8.device.type == "cpu":
        return spmm_dedup_chunks_q8_plain(
            u_cols, remaining, block_ptr, a_q8, a_scale, x_q8, x_scale,
            block_rows=block_rows, q_tile=q_tile)
    if x_q8.device.type != "cuda":
        raise ValueError(f"spmm_dedup_chunks_q8 runs on cuda or cpu, not "
                         f"{x_q8.device}")
    n_blocks = block_ptr.shape[0] - 1
    width = u_cols.shape[1]
    d_tile = d_tile_for(d)
    if d_tile * block_rows > 1024:
        raise ValueError(f"block_rows={block_rows} × d_tile={d_tile} exceeds "
                         "1024 threads per block")
    if width * d_tile * 4 > STATIC_SHARED_BYTES:
        raise ValueError(f"width={width} needs {width * d_tile * 4} bytes of "
                         "shared memory; pack with a smaller width_cap")
    y = torch.empty((n_blocks * block_rows, d), dtype=torch.float32,
                    device=x_q8.device)
    lib = build.load(LIBRARY_Q8)
    with torch.cuda.device(x_q8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spmm_dedup_chunks_q8_launch(
            u_cols.data_ptr(), remaining.data_ptr(), block_ptr.data_ptr(),
            a_q8.data_ptr(), a_scale.data_ptr(), x_q8.data_ptr(),
            x_scale.data_ptr(), y.data_ptr(), n_blocks, block_rows, width,
            d, d_tile, q_tile, stream)
    build.check_launch("spmm_dedup_chunks_q8", err)
    spmm_dedup_chunks_q8.launches += 1
    return y


spmm_dedup_chunks_q8.launches = 0
