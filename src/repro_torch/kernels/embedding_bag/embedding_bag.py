"""EmbeddingBag sum lookup: CUDA kernel, plain version, wrapper and launch
counter.

Port of ``repro.kernels.embedding_bag.embedding_bag.embedding_bag``: for ids
``(B, F, M)`` and a table ``(V, D)``, ``out[b, f·D:(f+1)·D] = Σ_m
table[ids[b, f, m]]``.  The CUDA kernel (``csrc/embedding_bag.cu``) gives a
bag ``lane_layout``'s lanes (two bags a warp at D = 64), keeps several bags'
rows in flight and sums each bag in registers in m order; the plain
version sums in the same order, so the two agree bit for bit.  Ids follow
``jnp.take``'s default, the reference oracle's: ``i`` in ``[-V, 0)`` reads
row ``i + V``, and an id outside ``[-V, V)`` gives NaN.

``embedding_bag`` takes the plain version only for tensors on the CPU.  For
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Tuple

import torch

from repro_torch.kernels import build

LIBRARY = build.KernelLibrary(
    name="embedding_bag",
    sources=(pathlib.Path(__file__).parent / "csrc" / "embedding_bag.cu",),
    functions=(("embedding_bag_launch",
                (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p)),))


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with ``jnp.take``'s default semantics: negative ids in
    ``[-V, 0)`` wrap, ids outside ``[-V, V)`` give rows of NaN."""
    n_rows = table.shape[0]
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + n_rows, i)
    ok = (i >= 0) & (i < n_rows)
    rows = table[torch.where(ok, i, 0)]
    return rows.masked_fill_(~ok[..., None], float("nan"))


def embedding_bag_plain(ids: torch.Tensor, table: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch version (``ref.py``'s gather and sum), summing each bag
    in m order from zero as the kernel does → ``(B, F·D)`` f32."""
    b, f, m = ids.shape
    rows = take_rows(table, ids)                   # (B, F, M, D)
    out = torch.zeros_like(rows[:, :, 0], dtype=torch.float32,
                           memory_format=torch.contiguous_format)
    for j in range(m):
        out += rows[:, :, j]
    return out.reshape(b, -1)


def lane_layout(dim: int, *tensors: torch.Tensor) -> Tuple[int, int]:
    """(floats per load, lanes per bag): VEC = 4, 2 or 1, the widest that
    divides ``dim`` and every pointer's float alignment; lanes = dim / VEC
    rounded up to a power of two of at most 32 (wider rows take several
    passes of 32 lanes)."""
    vec = 1
    for v in (4, 2):
        if dim % v == 0 and all(t.data_ptr() % (4 * v) == 0
                                for t in tensors):
            vec = v
            break
    return vec, min(32, 1 << (max(1, dim // vec) - 1).bit_length())


def embedding_bag(ids: torch.Tensor, table: torch.Tensor,
                  batch_tile: int = 8) -> torch.Tensor:
    """ids (B, F, M) int32, B % batch_tile == 0; table (V, D) f32 →
    ``(B, F·D)`` f32 (reshape to (B, F, D) outside).

    ``batch_tile`` is the reference's grid tile; the CUDA kernel has its own
    (a fixed grid striding over bags) and keeps only the reference's divisibility check.
    """
    if ids.dtype != torch.int32 or table.dtype != torch.float32:
        raise TypeError(f"embedding_bag takes int32 ids and a float32 table, "
                        f"got {ids.dtype} and {table.dtype}")
    if ids.ndim != 3 or table.ndim != 2:
        raise ValueError(f"ids must be (B, F, M) and table (V, D), got "
                         f"{tuple(ids.shape)} and {tuple(table.shape)}")
    b, f, m = ids.shape
    if batch_tile < 1 or b % batch_tile:
        raise ValueError(f"batch {b} is not a multiple of batch_tile "
                         f"{batch_tile}")
    if ids.device != table.device:
        raise ValueError(f"ids are on {ids.device}, table on {table.device}")
    if not (ids.is_contiguous() and table.is_contiguous()):
        raise ValueError("ids and table must be contiguous")
    if table.device.type == "cpu":
        return embedding_bag_plain(ids, table)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag runs on cuda or cpu, not "
                         f"{table.device}")
    n_rows, dim = table.shape
    out = torch.empty((b, f * dim), dtype=torch.float32, device=table.device)
    lib = build.load(LIBRARY)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.embedding_bag_launch(
            ids.data_ptr(), table.data_ptr(), out.data_ptr(), b * f, m,
            n_rows, dim, *lane_layout(dim, table, out), stream)
    build.check_launch("embedding_bag", err)
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
