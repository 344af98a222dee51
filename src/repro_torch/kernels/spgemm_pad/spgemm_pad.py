"""SpGEMM hash-pad numeric phase, f32 and int8: CUDA kernels, plain
versions, wrappers and launch counters.

Port of ``repro.kernels.spgemm_pad.spgemm_pad.spgemm_hashpad`` and
``spgemm_hashpad_q8``.  They compute, for every output block of
``block_rows`` rows and every chunk k of it in order, ``pad[r, h] +=
Σ_u a[k][r, u] · slab[k][u, h]``, then evict row r's bucket
``out_bucket[i]`` as C's value i.  The reference streams the dense hashed
slab; the kernels here (one templated walk in ``csrc/spgemm_hashpad.cu``,
instantiated for f32 and int8) take the slab as its nonzero cells
(``sparse.spgemm.symbolic.compact_cells``), keep the pad in shared memory
indexed by bucket, and write C's values directly.  A C entry whose bucket
lies outside ``[0, pad_width)`` comes out NaN, in the kernels and in the
compact plain versions alike.

Plain versions: ``spgemm_hashpad_compact_plain`` and
``spgemm_hashpad_q8_compact_plain`` compute the kernels' function on the
same compact inputs in the kernels' summation order;
``spgemm_hashpad_plain`` and ``spgemm_hashpad_q8_plain`` compute the
reference's on the dense slab and return the whole pad, the oracle held
against the reference's Pallas kernels and ``ref.py``.

The wrappers take the compact plain version only for tensors on the CPU.
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
    functions=(("spgemm_hashpad_launch", (_P,) * 10 + (_I,) * 9 + (_P,)),
               ("spgemm_hashpad_q8_launch",
                (_P,) * 12 + (_I,) * 9 + (_P,))))

# Pad buckets per thread block: the pad tile is BLOCK_ROWS × H_TILE f32 in
# shared memory (32 KB at 1024), small enough for several blocks per SM,
# which hide each other's chains of dependent loads (every block's work is
# a few hundred cells); a wider pad is split over gridDim.y.
H_TILE = 1024
MAX_PAD_WIDTH = 1 << 16
BLOCK_ROWS = 8                      # the kernels' compiled pad height
# dynamic shared memory a block may opt in to (227 KB), less 1 KB kept for
# the kernels' static row pointers
MAX_SHARED_BYTES = 226 * 1024


# ---------------------------------------------------------------------------
# dense-slab plain versions: the reference's function, the oracle
# ---------------------------------------------------------------------------

def spgemm_hashpad_plain(remaining: torch.Tensor, block_ptr: torch.Tensor,
                         a: torch.Tensor, slab: torch.Tensor, *,
                         block_rows: int, pad_width: int) -> torch.Tensor:
    """Plain PyTorch version of the reference's kernel (its ``ref.py``
    oracle) on the dense hashed slab: per chunk coefficient tile @ slab
    tile, chunks summed into their block in order → the whole pad
    ``(n_blocks·block_rows, pad_width)``.  Lanes ``u ≥ remaining[k]`` are
    masked out of both operands."""
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


def spgemm_hashpad_q8_plain(remaining: torch.Tensor, block_ptr: torch.Tensor,
                            a_q8: torch.Tensor, a_scale: torch.Tensor,
                            slab_q8: torch.Tensor, slab_scale: torch.Tensor,
                            *, block_rows: int,
                            pad_width: int) -> torch.Tensor:
    """Plain PyTorch version of the reference's int8 kernel on the dense
    int8 slab, in its fold order: per chunk the integer products summed
    exactly (f32 sums of int8·int8 stay below 2²⁴), folded into the block's
    pad as ``fma(isum, a_scale[k]·slab_scale[k], pad)`` chunk after chunk
    (``fold_q8_in_order``) → the whole pad.  Lanes ``u ≥ remaining[k]`` are
    masked out of both operands."""
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


# ---------------------------------------------------------------------------
# compact plain versions: the kernels' function, in their order
# ---------------------------------------------------------------------------

def _position_in_group(group: torch.Tensor) -> torch.Tensor:
    """Each element's index among the earlier elements of its group."""
    order = torch.argsort(group, stable=True)
    g = group[order]
    n = g.numel()
    first = torch.ones(n, dtype=torch.bool, device=g.device)
    first[1:] = g[1:] != g[:-1]
    idx = torch.arange(n, device=g.device)
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    pos = torch.empty_like(idx)
    pos[order] = idx - start
    return pos


def _fma32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """f32 ``fma(x, y, z)``, emulated in f64 (the product of two f32 is
    exact there)."""
    return (x.double() * y.double() + z.double()).float()


def _compact_fold(remaining, block_ptr, cell_ptr, cell_lane, cell_bucket,
                  cell_vals, c_indptr, out_bucket, block_rows, pad_width,
                  run_sums, fold):
    """The kernels' walk over compact cells, shared by both plain versions.

    Per chunk, a *run* is the cells of one bucket (consecutive, lanes in
    order); ``run_sums(chunk, lane, vals, run, n_runs, live)`` returns each
    run's ``(n_runs, block_rows)`` partial sum.  Runs then fold into their
    pad column (block, bucket) chunk after chunk through ``fold(pad, part,
    run_chunk)``, and row r of block b evicts ``pad[(b, out_bucket[i])]``
    as C's value i (zero where no cell touched the column).  As in the
    kernels, cells on lanes outside ``[0, remaining[k])`` are skipped,
    cells with a bucket outside ``[0, pad_width)`` touch no column, and a
    C entry with such a bucket is NaN."""
    dev = cell_lane.device
    i64 = torch.int64
    n_chunks = remaining.shape[0]
    n_blocks = block_ptr.shape[0] - 1
    n_rows = c_indptr.shape[0] - 1
    nnz = out_bucket.shape[0]
    if int(c_indptr[-1]) != nnz:
        raise ValueError(f"c_indptr ends at {int(c_indptr[-1])}, "
                         f"out_bucket has {nnz} entries")
    chunk = torch.repeat_interleave(
        torch.arange(n_chunks, device=dev),
        (cell_ptr[1:] - cell_ptr[:-1]).to(i64),
        output_size=cell_lane.shape[0])
    bucket = cell_bucket.to(i64)
    in_pad = (bucket >= 0) & (bucket < pad_width)
    chunk, bucket = chunk[in_pad], bucket[in_pad]
    lane, vals = cell_lane.to(i64)[in_pad], cell_vals[in_pad]
    n_cells = lane.shape[0]
    live = (lane >= 0) & (lane < remaining.to(i64)[chunk])
    new_run = torch.ones(n_cells, dtype=torch.bool, device=dev)
    new_run[1:] = (chunk[1:] != chunk[:-1]) | (bucket[1:] != bucket[:-1])
    run = torch.cumsum(new_run.to(i64), 0) - 1
    run_first = torch.nonzero(new_run).reshape(-1)
    n_runs = run_first.numel()
    part = run_sums(chunk, lane, vals, run, n_runs, live)
    chunk_block = torch.repeat_interleave(
        torch.arange(n_blocks, device=dev),
        (block_ptr[1:] - block_ptr[:-1]).to(i64), output_size=n_chunks)
    run_chunk = chunk[run_first]
    keys, col = torch.unique(chunk_block[run_chunk] * pad_width
                             + bucket[run_first], return_inverse=True)
    pad = torch.zeros((keys.numel(), block_rows), dtype=torch.float32,
                      device=dev)
    depth = _position_in_group(col)       # runs of a column in chunk order
    for d in range(int(depth.max()) + 1 if n_runs else 0):
        sel = torch.nonzero(depth == d).reshape(-1)
        pad[col[sel]] = fold(pad[col[sel]], part[sel], run_chunk[sel])
    ob = out_bucket.to(i64)
    c_vals = torch.zeros(nnz, dtype=torch.float32, device=dev)
    if keys.numel():
        row = torch.repeat_interleave(
            torch.arange(n_rows, device=dev),
            (c_indptr[1:] - c_indptr[:-1]).to(i64), output_size=nnz)
        block = row // block_rows
        key = block * pad_width + ob
        at = torch.searchsorted(keys, key).clamp(max=keys.numel() - 1)
        c_vals = torch.where(keys[at] == key,
                             pad[at, row - block * block_rows], 0.0)
    return torch.where((ob >= 0) & (ob < pad_width), c_vals, float("nan"))


def spgemm_hashpad_compact_plain(remaining, block_ptr, a, cell_ptr,
                                 cell_lane, cell_bucket, cell_val, c_indptr,
                                 out_bucket, *, block_rows: int,
                                 pad_width: int) -> torch.Tensor:
    """Plain PyTorch version of the f32 kernel on B's compact cells → C's
    values ``(nnz_out,)``, in the kernel's order: per run of one bucket,
    ``part[r] = fma(a[k][r, lane], val, part[r])`` over its lanes in order,
    then ``pad[r, bucket] += part[r]`` chunk after chunk.  Cells on lanes
    ``≥ remaining[k]`` are skipped; a's dead lanes are never read."""
    width = a.shape[1]
    a3 = a.reshape(-1, block_rows, width)

    def run_sums(chunk, lane, vals, run, n_runs, live):
        coef = torch.where(live[:, None],
                           a3[chunk, :, torch.where(live, lane, 0)], 0.0)
        v = torch.where(live, vals.to(torch.float32), 0.0)[:, None]
        part = torch.zeros((n_runs, block_rows), dtype=torch.float32,
                           device=a.device)
        pos = _position_in_group(run)
        for d in range(int(pos.max()) + 1 if n_runs else 0):
            sel = torch.nonzero((pos == d) & live).reshape(-1)
            part[run[sel]] = _fma32(coef[sel], v[sel], part[run[sel]])
        return part

    return _compact_fold(remaining.clamp(0, width), block_ptr, cell_ptr,
                         cell_lane, cell_bucket, cell_val, c_indptr,
                         out_bucket, block_rows, pad_width, run_sums,
                         lambda pad, part, _k: pad + part)


def spgemm_hashpad_q8_compact_plain(remaining, block_ptr, a_q8, a_scale,
                                    cell_ptr, cell_lane, cell_bucket,
                                    cell_q8, slab_scale, c_indptr,
                                    out_bucket, *, block_rows: int,
                                    pad_width: int) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel on B's int8 cells → C's
    values ``(nnz_out,)``: per run of one bucket the integer sum
    ``Σ a_q8[k][r, lane]·cell_q8`` (exact), folded chunk after chunk as
    ``pad = fma(isum, a_scale[k]·slab_scale[k], pad)`` in f32.  Cells on
    lanes ``≥ remaining[k]`` are skipped."""
    width = a_q8.shape[1]
    a3 = a_q8.reshape(-1, block_rows, width).to(torch.int64)
    scale = a_scale * slab_scale             # f32, as the kernel's __fmul_rn

    def run_sums(chunk, lane, vals, run, n_runs, live):
        prod = a3[chunk, :, torch.where(live, lane, 0)] \
            * vals.to(torch.int64)[:, None]
        isum = torch.zeros((n_runs, block_rows), dtype=torch.int64,
                           device=a_q8.device)
        isum.index_add_(0, run, torch.where(live[:, None], prod, 0))
        return isum.to(torch.float32)        # |isum| < 2²⁴: exact

    return _compact_fold(remaining.clamp(0, width), block_ptr, cell_ptr,
                         cell_lane, cell_bucket, cell_q8, c_indptr,
                         out_bucket, block_rows, pad_width, run_sums,
                         lambda pad, part, k: _fma32(part, scale[k][:, None],
                                                     pad))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(remaining, block_ptr, a, cell_ptr, cell_lane, cell_bucket, cells,
           c_indptr, out_bucket, block_rows, pad_width, tile_dtype,
           scales=()):
    """Devices, dtypes and shapes shared by both kernels; ``cells`` is the
    (name, tensor) of the cell values and ``scales`` the int8 kernel's
    (name, tensor) per-chunk scale vectors."""
    ints = (("remaining", remaining), ("block_ptr", block_ptr),
            ("cell_ptr", cell_ptr), ("cell_lane", cell_lane),
            ("cell_bucket", cell_bucket), ("c_indptr", c_indptr),
            ("out_bucket", out_bucket))
    dev = a.device
    for name, t in (*ints, ("a", a), cells, *scales):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.ndim != (2 if name == "a" else 1):
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
    for name, t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("a", a), cells):
        if t.dtype != tile_dtype:
            raise TypeError(f"{name} must be {tile_dtype}, got {t.dtype}")
    n_chunks = remaining.shape[0]
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
    if a.shape[0] != n_chunks * block_rows:
        raise ValueError(f"a has shape {tuple(a.shape)}, expected "
                         f"({n_chunks * block_rows}, width)")
    if cell_ptr.shape[0] != n_chunks + 1:
        raise ValueError(f"cell_ptr has {cell_ptr.shape[0]} entries, "
                         f"expected n_chunks + 1 = {n_chunks + 1}")
    if not cell_lane.shape == cell_bucket.shape == cells[1].shape:
        raise ValueError("cell_lane, cell_bucket and the cell values must "
                         "have one entry per cell")
    n_rows = c_indptr.shape[0] - 1
    n_blocks = -(-n_rows // block_rows)
    if n_rows < 0 or block_ptr.shape[0] != n_blocks + 1:
        raise ValueError(f"block_ptr has {block_ptr.shape[0]} entries; the "
                         f"{n_rows} rows of c_indptr make {n_blocks} blocks "
                         "of block_rows")
    if n_rows == 0 and out_bucket.shape[0]:
        raise ValueError("out_bucket has entries but c_indptr no rows")


def _launch(name, fn, args, c_vals, block_rows, pad_width, width, n_cells):
    """Check the kernel's limits, then launch ``fn`` on ``args`` (device
    tensors, in the launch function's order) into ``c_vals``."""
    if block_rows != BLOCK_ROWS:
        raise ValueError(f"{name}: block_rows={block_rows}, the kernel is "
                         f"compiled for {BLOCK_ROWS}")
    h_tile = min(pad_width, H_TILE)
    # a block's pad tile and coefficient tile (f32, or int8 widened to int)
    smem = 4 * BLOCK_ROWS * (h_tile + width)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: width {width} needs {smem} bytes of "
                         "shared memory; take a smaller width_cap")
    remaining, block_ptr, c_indptr, out_bucket = (
        args[0], args[1], args[-2], args[-1])
    with torch.cuda.device(c_vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in args), c_vals.data_ptr(),
                 block_ptr.shape[0] - 1, remaining.shape[0], n_cells,
                 c_indptr.shape[0] - 1, out_bucket.shape[0], block_rows,
                 width, pad_width, h_tile, stream)
    build.check_launch(name, err)


def spgemm_hashpad(remaining: torch.Tensor, block_ptr: torch.Tensor,
                   a: torch.Tensor, cell_ptr: torch.Tensor,
                   cell_lane: torch.Tensor, cell_bucket: torch.Tensor,
                   cell_val: torch.Tensor, c_indptr: torch.Tensor,
                   out_bucket: torch.Tensor, *, block_rows: int,
                   pad_width: int) -> torch.Tensor:
    """C's values of sparse×sparse C = A @ B → ``(nnz_out,)`` f32.

    remaining (n_chunks,) int32 — live lanes per chunk; block_ptr
    (n_blocks+1,) int32 — each output block's chunk range; a
    (n_chunks·block_rows, width) f32 coefficient tiles; cell_ptr
    (n_chunks+1,), cell_lane, cell_bucket (n_cells,) int32 and cell_val
    (n_cells,) f32 — B's compact cells, chunk by chunk, ordered by (bucket,
    lane); c_indptr (n_rows+1,) int32 — C's row pointers; out_bucket
    (nnz_out,) int32 — the pad bucket of each of C's entries.  An entry
    whose bucket is outside ``[0, pad_width)`` comes out NaN.
    """
    cells = ("cell_val", cell_val)
    _check(remaining, block_ptr, a, cell_ptr, cell_lane, cell_bucket, cells,
           c_indptr, out_bucket, block_rows, pad_width, torch.float32)
    args = (remaining, block_ptr, a, cell_ptr, cell_lane, cell_bucket,
            cell_val, c_indptr, out_bucket)
    if a.device.type == "cpu":
        return spgemm_hashpad_compact_plain(*args, block_rows=block_rows,
                                            pad_width=pad_width)
    if a.device.type != "cuda":
        raise ValueError(f"spgemm_hashpad runs on cuda or cpu, not "
                         f"{a.device}")
    c_vals = torch.empty(out_bucket.shape, dtype=torch.float32,
                         device=a.device)
    _launch("spgemm_hashpad", build.load(LIBRARY).spgemm_hashpad_launch,
            args, c_vals, block_rows, pad_width, a.shape[1],
            cell_lane.shape[0])
    spgemm_hashpad.launches += 1
    return c_vals


spgemm_hashpad.launches = 0


def spgemm_hashpad_q8(remaining: torch.Tensor, block_ptr: torch.Tensor,
                      a_q8: torch.Tensor, a_scale: torch.Tensor,
                      cell_ptr: torch.Tensor, cell_lane: torch.Tensor,
                      cell_bucket: torch.Tensor, cell_q8: torch.Tensor,
                      slab_scale: torch.Tensor, c_indptr: torch.Tensor,
                      out_bucket: torch.Tensor, *, block_rows: int,
                      pad_width: int) -> torch.Tensor:
    """int8 C's values ≈ those of C = A @ B → ``(nnz_out,)`` f32.

    As ``spgemm_hashpad`` with a_q8 (n_chunks·block_rows, width) int8 and
    a_scale (n_chunks,) f32, and B's cells as cell_q8 (n_cells,) int8 with
    slab_scale (n_chunks,) f32 — both scales per dedup chunk, applied to
    each chunk's integer sums as they fold into the pad.
    """
    cells = ("cell_q8", cell_q8)
    scales = (("a_scale", a_scale), ("slab_scale", slab_scale))
    _check(remaining, block_ptr, a_q8, cell_ptr, cell_lane, cell_bucket,
           cells, c_indptr, out_bucket, block_rows, pad_width, torch.int8,
           scales)
    args = (remaining, block_ptr, a_q8, a_scale, cell_ptr, cell_lane,
            cell_bucket, cell_q8, slab_scale, c_indptr, out_bucket)
    if a_q8.device.type == "cpu":
        return spgemm_hashpad_q8_compact_plain(*args, block_rows=block_rows,
                                               pad_width=pad_width)
    if a_q8.device.type != "cuda":
        raise ValueError(f"spgemm_hashpad_q8 runs on cuda or cpu, not "
                         f"{a_q8.device}")
    c_vals = torch.empty(out_bucket.shape, dtype=torch.float32,
                         device=a_q8.device)
    _launch("spgemm_hashpad_q8", build.load(LIBRARY).spgemm_hashpad_q8_launch,
            args, c_vals, block_rows, pad_width, a_q8.shape[1],
            cell_lane.shape[0])
    spgemm_hashpad_q8.launches += 1
    return c_vals


spgemm_hashpad_q8.launches = 0
