"""SpGEMM hash-pad numeric phase, f32 and int8: CUDA kernels, plain
versions, wrappers and launch counters.

Port of ``repro.kernels.spgemm_pad.spgemm_pad.spgemm_hashpad`` and
``spgemm_hashpad_q8``.  Each kernel (``csrc/spgemm_hashpad.cu``,
``csrc/spgemm_hashpad_q8.cu``) runs one thread block per (output block,
h tile), keeps the block's hash pad in registers while it walks the block's
chunk range ``block_ptr[b] .. block_ptr[b+1]``, and writes the pad once at
the end (rolling eviction); each source says what bounds it.

The wrappers take the plain PyTorch version only for tensors on the CPU.
For CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = build.KernelLibrary(
    name="spgemm_hashpad",
    sources=(pathlib.Path(__file__).parent / "csrc" / "spgemm_hashpad.cu",),
    functions=(("spgemm_hashpad_launch",
                (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),))

LIBRARY_Q8 = build.KernelLibrary(
    name="spgemm_hashpad_q8",
    sources=(pathlib.Path(__file__).parent / "csrc"
             / "spgemm_hashpad_q8.cu",),
    functions=(("spgemm_hashpad_q8_launch",
                (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),))

MAX_H_TILE = 256                    # threads per block, one pad lane each
MAX_PAD_WIDTH = 1 << 16
BLOCK_ROWS = 8                      # the kernel's compiled pad height
STATIC_SHARED_BYTES = 48 * 1024


def h_tile_for(pad_width: int) -> int:
    """Pad lanes per thread block: the whole pad up to ``MAX_H_TILE``."""
    return min(pad_width, MAX_H_TILE)


def spgemm_hashpad_plain(remaining: torch.Tensor, block_ptr: torch.Tensor,
                         a: torch.Tensor, slab: torch.Tensor, *,
                         block_rows: int, pad_width: int) -> torch.Tensor:
    """Plain PyTorch version (the reference's ``ref.py`` oracle): per chunk
    coefficient tile @ slab tile, chunks summed into their block in order.
    Lanes ``u ≥ remaining[k]`` are masked out of both operands."""
    n_chunks = remaining.shape[0]
    width = a.shape[1]
    n_blocks = block_ptr.shape[0] - 1
    lane = torch.arange(width, device=a.device)
    live = lane[None, :] < remaining[:, None].to(torch.int64)
    a3 = torch.where(live[:, None, :],
                     a.reshape(n_chunks, block_rows, width), 0.0)
    s3 = torch.where(live[:, :, None],
                     slab.reshape(n_chunks, width, pad_width), 0.0)
    contrib = torch.bmm(a3, s3)
    out_block = torch.repeat_interleave(
        torch.arange(n_blocks, device=a.device),
        (block_ptr[1:] - block_ptr[:-1]).to(torch.int64))
    y = contrib.new_zeros((n_blocks, block_rows, pad_width))
    y.index_add_(0, out_block, contrib)
    return y.reshape(n_blocks * block_rows, pad_width)


def _check(remaining, block_ptr, a, slab, block_rows, pad_width,
           tile_dtype, scales=()):
    """Devices, dtypes and shapes shared by both kernels; ``scales`` are
    the int8 kernel's (name, tensor) per-chunk scale vectors."""
    dev = slab.device
    for name, t in (("remaining", remaining), ("block_ptr", block_ptr),
                    ("a", a), ("slab", slab), *scales):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, slab on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("remaining", remaining), ("block_ptr", block_ptr)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("a", a), ("slab", slab)):
        if t.dtype != tile_dtype:
            raise TypeError(f"{name} must be {tile_dtype}, got {t.dtype}")
    for name, t in scales:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.shape != remaining.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(remaining.shape)}")
    if (pad_width < 1 or pad_width > MAX_PAD_WIDTH
            or pad_width & (pad_width - 1)):
        raise ValueError(f"pad_width {pad_width} must be a power of two "
                         f"≤ {MAX_PAD_WIDTH}")
    if remaining.ndim != 1 or a.ndim != 2:
        raise ValueError(f"remaining must be 1-D and a 2-D, got "
                         f"{tuple(remaining.shape)} and {tuple(a.shape)}")
    n_chunks = remaining.shape[0]
    width = a.shape[1]
    if a.shape[0] != n_chunks * block_rows:
        raise ValueError(f"a has shape {tuple(a.shape)}, expected "
                         f"({n_chunks * block_rows}, width)")
    if slab.shape != (n_chunks * width, pad_width):
        raise ValueError(f"slab has shape {tuple(slab.shape)}, expected "
                         f"({n_chunks * width}, {pad_width})")
    if block_ptr.ndim != 1 or not 1 <= block_ptr.shape[0] <= n_chunks + 1:
        raise ValueError(f"block_ptr has shape {tuple(block_ptr.shape)}; it "
                         "needs n_blocks + 1 entries and every block owns "
                         f"at least one of the {n_chunks} chunks")


def spgemm_hashpad(remaining: torch.Tensor, block_ptr: torch.Tensor,
                   a: torch.Tensor, slab: torch.Tensor, *, block_rows: int,
                   pad_width: int) -> torch.Tensor:
    """C_pad = fold(A_tiles @ slab) over each block's chunks →
    ``(n_blocks·block_rows, pad_width)`` f32.

    remaining (n_chunks,) int32 — live lanes per chunk; block_ptr
    (n_blocks+1,) int32 — each output block's chunk range; a
    (n_chunks·block_rows, width) f32 coefficient tiles; slab
    (n_chunks·width, pad_width) f32 hashed B rows.  Row r of the result is
    row r's hash pad; the caller gathers C's nonzeros out of it.
    """
    _check(remaining, block_ptr, a, slab, block_rows, pad_width,
           torch.float32)
    if slab.device.type == "cpu":
        return spgemm_hashpad_plain(remaining, block_ptr, a, slab,
                                    block_rows=block_rows,
                                    pad_width=pad_width)
    if slab.device.type != "cuda":
        raise ValueError(f"spgemm_hashpad runs on cuda or cpu, not "
                         f"{slab.device}")
    if block_rows != BLOCK_ROWS:
        raise ValueError(f"block_rows={block_rows}: the kernel is compiled "
                         f"for {BLOCK_ROWS}")
    width = a.shape[1]
    if block_rows * width * 4 > STATIC_SHARED_BYTES:
        raise ValueError(f"width={width} needs {block_rows * width * 4} "
                         "bytes of shared memory; pack with a smaller "
                         "width_cap")
    n_blocks = block_ptr.shape[0] - 1
    c_pad = torch.empty((n_blocks * block_rows, pad_width),
                        dtype=torch.float32, device=slab.device)
    lib = build.load(LIBRARY)
    with torch.cuda.device(slab.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spgemm_hashpad_launch(
            remaining.data_ptr(), block_ptr.data_ptr(), a.data_ptr(),
            slab.data_ptr(), c_pad.data_ptr(), n_blocks, block_rows, width,
            pad_width, h_tile_for(pad_width), stream)
    build.check_launch("spgemm_hashpad", err)
    spgemm_hashpad.launches += 1
    return c_pad


spgemm_hashpad.launches = 0


# ---------------------------------------------------------------------------
# int8: spgemm_hashpad_q8
# ---------------------------------------------------------------------------

def spgemm_hashpad_q8_plain(remaining: torch.Tensor, block_ptr: torch.Tensor,
                            a_q8: torch.Tensor, a_scale: torch.Tensor,
                            slab_q8: torch.Tensor, slab_scale: torch.Tensor,
                            *, block_rows: int,
                            pad_width: int) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel, in its fold order: per
    chunk the integer products summed exactly (f32 sums of int8·int8 stay
    below 2²⁴), folded into the block's pad as ``fma(isum, a_scale[k]·
    slab_scale[k], pad)`` chunk after chunk (``fold_q8_in_order``).  Lanes
    ``u ≥ remaining[k]`` are masked out of both operands."""
    from repro_torch.kernels.gustavson_spmm.gustavson_spmm import (
        fold_q8_in_order)
    n_chunks = remaining.shape[0]
    width = a_q8.shape[1]
    n_blocks = block_ptr.shape[0] - 1
    lane = torch.arange(width, device=a_q8.device)
    live = lane[None, :] < remaining[:, None].to(torch.int64)
    a3 = torch.where(live[:, None, :], a_q8.reshape(
        n_chunks, block_rows, width).to(torch.float32), 0.0)
    s3 = torch.where(live[:, :, None], slab_q8.reshape(
        n_chunks, width, pad_width).to(torch.float32), 0.0)
    isum = torch.bmm(a3, s3)
    del s3
    return fold_q8_in_order(isum, (a_scale * slab_scale)[:, None, None],
                            block_ptr).reshape(n_blocks * block_rows,
                                               pad_width)


def spgemm_hashpad_q8(remaining: torch.Tensor, block_ptr: torch.Tensor,
                      a_q8: torch.Tensor, a_scale: torch.Tensor,
                      slab_q8: torch.Tensor, slab_scale: torch.Tensor, *,
                      block_rows: int, pad_width: int) -> torch.Tensor:
    """int8 C_pad ≈ fold(A_tiles @ slab) over each block's chunks →
    ``(n_blocks·block_rows, pad_width)`` f32.

    remaining (n_chunks,) int32; block_ptr (n_blocks+1,) int32; a_q8
    (n_chunks·block_rows, width) int8 with a_scale (n_chunks,) f32; slab_q8
    (n_chunks·width, pad_width) int8 with slab_scale (n_chunks,) f32 — both
    scales per dedup chunk, applied to each chunk's fold before it is added
    into the pad.
    """
    _check(remaining, block_ptr, a_q8, slab_q8, block_rows, pad_width,
           torch.int8, (("a_scale", a_scale), ("slab_scale", slab_scale)))
    if slab_q8.device.type == "cpu":
        return spgemm_hashpad_q8_plain(remaining, block_ptr, a_q8, a_scale,
                                       slab_q8, slab_scale,
                                       block_rows=block_rows,
                                       pad_width=pad_width)
    if slab_q8.device.type != "cuda":
        raise ValueError(f"spgemm_hashpad_q8 runs on cuda or cpu, not "
                         f"{slab_q8.device}")
    if block_rows != BLOCK_ROWS:
        raise ValueError(f"block_rows={block_rows}: the kernel is compiled "
                         f"for {BLOCK_ROWS}")
    width = a_q8.shape[1]
    if block_rows * width * 4 > STATIC_SHARED_BYTES:
        raise ValueError(f"width={width} needs {block_rows * width * 4} "
                         "bytes of shared memory; pack with a smaller "
                         "width_cap")
    n_blocks = block_ptr.shape[0] - 1
    c_pad = torch.empty((n_blocks * block_rows, pad_width),
                        dtype=torch.float32, device=slab_q8.device)
    lib = build.load(LIBRARY_Q8)
    with torch.cuda.device(slab_q8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spgemm_hashpad_q8_launch(
            remaining.data_ptr(), block_ptr.data_ptr(), a_q8.data_ptr(),
            a_scale.data_ptr(), slab_q8.data_ptr(), slab_scale.data_ptr(),
            c_pad.data_ptr(), n_blocks, block_rows, width, pad_width,
            h_tile_for(pad_width), stream)
    build.check_launch("spgemm_hashpad_q8", err)
    spgemm_hashpad_q8.launches += 1
    return c_pad


spgemm_hashpad_q8.launches = 0
