"""Gustavson SpMM on the dedup-chunk layout, f32, bf16 and int8: CUDA
kernels, plain versions, wrappers and launch counters.

Port of ``repro.kernels.gustavson_spmm.gustavson_spmm.spmm_dedup_chunks``
and ``spmm_dedup_chunks_q8``.  The kernels are one templated walk in
``csrc/spmm_dedup_chunks.cu``, built as one library (f32, bf16 x with f32
tiles, and int8): a group of threads
owns one output block (8 rows) and a stripe of columns held in registers,
one vector of ``lane_layout``'s width (as wide as D and the pointers allow)
per thread; it walks the block's chunk range ``block_ptr[b] ..
block_ptr[b+1]`` in slices of 64 lanes whose metadata lands in shared
memory one slice ahead.  Several groups share a thread block where the
plan is small (``blocks_per_cta``).  The int8 kernel's feature scales
cover a *scale* tile, ``auto_d_tile(D)`` (up to 512 columns), which has
nothing to do with the stripes.  The source says what bounds the kernels.

A bf16 ``x`` keeps the reference's rounding (its ``_fold`` on a bf16
landing buffer): the f32 coefficients are rounded to bf16, a chunk's sum is
taken in f32 and rounded to bf16, and a block is rounded once per chunk —
its first chunk sets it, each later one is added in f32 and rounded back.

The wrappers take the plain PyTorch version only for tensors on the CPU.
For CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = build.KernelLibrary(
    name="spmm_dedup_chunks",
    sources=(pathlib.Path(__file__).parent / "csrc"
             / "spmm_dedup_chunks.cu",),
    functions=(("spmm_dedup_chunks_launch", (_P,) * 6 + (_I,) * 8 + (_P,)),
               ("spmm_dedup_chunks_bf16_launch",
                (_P,) * 6 + (_I,) * 8 + (_P,)),
               ("spmm_dedup_chunks_q8_launch",
                (_P,) * 8 + (_I,) * 10 + (_P,))))

X_DTYPES = (torch.float32, torch.bfloat16)  # what spmm_dedup_chunks takes
ROWS = 8                  # output rows per block the kernels fold (csrc)
MAX_THREADS = 256         # per thread block (csrc)
MAX_GROUPS = 8            # output blocks per thread block (csrc)
MAX_LANES = MAX_THREADS   # column threads a stripe (the GPU tests lower it)
NARROW_VECTORS = 16       # rows of at most this many vectors: a row a thread
MAX_SINGLE_TILE_D = 512   # auto_d_tile: one scale tile up to this width
# A test hook, not a setting: output blocks per thread block.  None, the
# default: ``blocks_per_cta``'s choice.  The GPU tests set it to 1 and to
# the most a layout allows to hold the bits independent of it.
BLOCKS_PER_CTA: Optional[int] = None


def lane_layout(d: int, *tensors: torch.Tensor) -> Tuple[int, int, int]:
    """(elements per load, column threads per stripe, rows a thread holds)
    for rows of ``d`` columns.  The load is VEC = 4, 2 or 1 elements, the
    widest that divides ``d`` and every pointer's alignment in its own
    element size (f32: 16, 8 or 4 bytes; bf16: 8, 4 or 2; int8: 4, 2 or 1).  Rows of at
    most ``NARROW_VECTORS`` vectors give each column thread one row
    (``ROWS`` row threads a column), wider rows all ``ROWS`` rows; either
    way a column thread holds one vector.  A stripe takes up to
    ``MAX_LANES`` column threads, so wider rows take several stripes of
    equal width; a power of two up to 32, else a multiple of 32."""
    vec = 1
    for v in (4, 2):
        if d % v == 0 and all(t.data_ptr() % (v * t.element_size()) == 0
                              for t in tensors):
            vec = v
            break
    n_vec = max(1, d // vec)
    rows = 1 if n_vec <= NARROW_VECTORS else ROWS
    stripes = -(-n_vec // MAX_LANES)
    per = -(-n_vec // stripes)
    lanes = 1 << (per - 1).bit_length() if per <= 32 else -(-per // 32) * 32
    return vec, lanes, rows


def stripes_for(d: int, vec: int, lanes: int) -> int:
    """Column stripes of ``lanes`` column threads that cover ``d``
    columns."""
    return -(-(d // vec) // lanes)


def group_threads(lanes: int, rows: int) -> int:
    """Threads that fold one output block's stripe: ``lanes`` column
    threads, times ``ROWS`` row threads where each holds one row."""
    return lanes * (ROWS // rows)


def blocks_per_cta(n_blocks: int, stripes: int, group: int,
                   n_sms: int) -> int:
    """Output blocks (groups of ``group`` threads) per thread block: enough
    that one thread block per SM covers every (block, stripe), at most
    ``MAX_GROUPS`` and ``MAX_THREADS`` threads.  ``BLOCKS_PER_CTA``
    overrides it (clamped to the same limits)."""
    most = max(1, min(MAX_GROUPS, MAX_THREADS // group))
    want = (-(-n_blocks * stripes // max(1, n_sms))
            if BLOCKS_PER_CTA is None else BLOCKS_PER_CTA)
    return min(max(1, want), most)


def auto_d_tile(d: int) -> int:
    """Width of an int8 feature *scale* tile (the reference's
    ``_auto_d_tile``): one tile up to ``MAX_SINGLE_TILE_D``; beyond that
    the smallest even split, rounded up to 8 columns.  Not a column
    stripe of the kernels (``lane_layout``)."""
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


def _live_landing(u_cols, remaining, x):
    """Each chunk's gathered operand rows ``(n_chunks, width, D)`` in
    ``x.dtype``, zero at the lanes ``u ≥ remaining[k]``, which are not
    read."""
    n_chunks, width = u_cols.shape
    lane = torch.arange(width, device=u_cols.device)
    live = lane[None, :] < remaining[:, None].to(torch.int64)
    idx = torch.where(live, u_cols.to(torch.int64), 0)
    land = x.index_select(0, idx.reshape(-1)).reshape(n_chunks, width, -1)
    return torch.where(live[:, :, None], land, 0)


def fold_bf16_in_order(part: torch.Tensor,
                       block_ptr: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's fold: per output block, its first chunk's bf16
    sum ``part[k]`` sets the block and every later one is added in f32 and
    rounded back to bf16, chunk after chunk (the reference's ``_fold`` on a
    bf16 output block).  Reads the deepest block's chunk count back to the
    host."""
    n_blocks = block_ptr.shape[0] - 1
    start = block_ptr[:-1].to(torch.int64)
    count = block_ptr[1:].to(torch.int64) - start
    y = torch.zeros((n_blocks,) + tuple(part.shape[1:]),
                    dtype=torch.bfloat16, device=part.device)
    for i in range(int(count.max()) if n_blocks else 0):
        blocks = torch.nonzero(count > i).reshape(-1)
        k = start[blocks] + i
        y[blocks] = part[k] if i == 0 else (
            y[blocks].float() + part[k].float()).to(torch.bfloat16)
    return y


def _plain_bf16(u_cols, remaining, block_ptr, a, x, block_rows):
    """bf16 ``x``: the kernel's arithmetic step for step.  Each lane's
    product of a bf16-rounded coefficient and a bf16 operand is exact in
    f32, so adding the lanes in ascending ``u`` gives the kernel's chunk
    sums bit for bit; each is rounded to bf16 and folded in order."""
    n_chunks, width = u_cols.shape
    land = _live_landing(u_cols, remaining, x).float()
    a3 = a.reshape(n_chunks, block_rows, width).to(torch.bfloat16).float()
    part = land.new_zeros((n_chunks, block_rows, x.shape[1]))
    for u in range(width):
        part += a3[:, :, u, None] * land[:, None, u, :]
    y = fold_bf16_in_order(part.to(torch.bfloat16), block_ptr)
    return y.reshape(-1, x.shape[1])


def spmm_dedup_chunks_plain(u_cols: torch.Tensor, remaining: torch.Tensor,
                            block_ptr: torch.Tensor, a: torch.Tensor,
                            x: torch.Tensor, *,
                            block_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per chunk, coefficient tile ×
    gathered live operands, chunks summed into their block in order.
    Lanes ``u ≥ remaining[k]`` are neither gathered nor added.  A bf16
    ``x`` follows the bf16 kernel's rounding (``_plain_bf16``)."""
    if x.dtype == torch.bfloat16:
        return _plain_bf16(u_cols, remaining, block_ptr, a, x, block_rows)
    n_chunks, width = u_cols.shape
    n_blocks = block_ptr.shape[0] - 1
    land = _live_landing(u_cols, remaining, x)
    contrib = torch.bmm(a.reshape(n_chunks, block_rows, width), land)
    out_block = torch.repeat_interleave(
        torch.arange(n_blocks, device=u_cols.device),
        (block_ptr[1:] - block_ptr[:-1]).to(torch.int64))
    y = contrib.new_zeros((n_blocks, block_rows, x.shape[1]))
    y.index_add_(0, out_block, contrib)
    return y.reshape(n_blocks * block_rows, x.shape[1])


def _check(u_cols, remaining, block_ptr, a, x, block_rows, a_dtype,
           x_dtypes, scales=()):
    """Devices, dtypes, contiguity and shapes shared by the kernels:
    ``a_dtype`` is the tiles' (f32, or int8 for the int8 kernel),
    ``x_dtypes`` the operands' allowed types, ``scales`` the int8 kernel's
    (name, f32 tensor) scales."""
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
    if a.dtype != a_dtype:
        raise TypeError(f"a must be {a_dtype}, got {a.dtype}")
    if x.dtype not in x_dtypes:
        raise TypeError(f"x must be one of {', '.join(map(str, x_dtypes))}, "
                        f"got {x.dtype}")
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


def _kernel_layout(u_cols, a, x, y,
                   block_rows) -> Tuple[int, int, int, int]:
    """What the CUDA kernels take beyond ``_check``, and their layout:
    ``lane_layout``'s three numbers and the output blocks per thread
    block.  The kernels fold ``ROWS``-row blocks and stage 64-lane slices
    of ``u_cols`` and the tiles with 16-byte copies, so the width must be a
    multiple of 16 and those two pointers 16-byte aligned (what
    ``pack_dedup_chunks`` gives); each thread block stages at most
    ``MAX_GROUPS`` × 2 slices (36 KB in f32), whatever the width."""
    width = u_cols.shape[1]
    if block_rows != ROWS:
        raise ValueError(f"the CUDA kernels fold blocks of {ROWS} rows, not "
                         f"block_rows={block_rows}")
    if width % 16 or u_cols.data_ptr() % 16 or a.data_ptr() % 16:
        raise ValueError(f"the CUDA kernels need a width that is a multiple "
                         f"of 16 (got {width}) and 16-byte aligned u_cols "
                         "and tiles; pack with width_multiple=16")
    n_blocks = y.shape[0] // ROWS
    d = x.shape[1]
    vec, lanes, rows = lane_layout(d, x, y)
    n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return vec, lanes, rows, blocks_per_cta(
        n_blocks, stripes_for(d, vec, lanes),
        group_threads(lanes, rows), n_sms)


def spmm_dedup_chunks(u_cols: torch.Tensor, remaining: torch.Tensor,
                      block_ptr: torch.Tensor, a: torch.Tensor,
                      x: torch.Tensor, *, block_rows: int) -> torch.Tensor:
    """y = A @ x on the dedup-chunk layout → ``(n_blocks·block_rows, D)``
    in ``x.dtype``.

    u_cols (n_chunks, width) int32; remaining (n_chunks,) int32; block_ptr
    (n_blocks+1,) int32; a (n_chunks·block_rows, width) f32; x (N, D) f32
    or bf16 (the tiles stay f32 and are rounded to bf16 in the kernel).
    """
    _check(u_cols, remaining, block_ptr, a, x, block_rows, torch.float32,
           X_DTYPES)
    if x.device.type == "cpu":
        return spmm_dedup_chunks_plain(u_cols, remaining, block_ptr, a, x,
                                       block_rows=block_rows)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_dedup_chunks runs on cuda or cpu, not "
                         f"{x.device}")
    n_blocks = block_ptr.shape[0] - 1
    n_chunks, width = u_cols.shape
    d = x.shape[1]
    y = torch.empty((n_blocks * block_rows, d), dtype=x.dtype,
                    device=x.device)
    vec, lanes, rows, groups = _kernel_layout(u_cols, a, x, y, block_rows)
    lib = build.load(LIBRARY)
    bf16 = x.dtype == torch.bfloat16
    launch = (lib.spmm_dedup_chunks_bf16_launch if bf16
              else lib.spmm_dedup_chunks_launch)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            u_cols.data_ptr(), remaining.data_ptr(), block_ptr.data_ptr(),
            a.data_ptr(), x.data_ptr(), y.data_ptr(), n_blocks, n_chunks,
            width, d, vec, lanes, rows, groups, stream)
    build.check_launch("spmm_dedup_chunks", err)
    spmm_dedup_chunks.launches += 1
    spmm_dedup_chunks.launches_bf16 += bf16
    return y


spmm_dedup_chunks.launches = 0


def spmm_blocked_ell(cols, row_local, vals, remaining, x: torch.Tensor, *,
                     block_rows: int = 8) -> torch.Tensor:
    """y = A @ x for A in the per-lane ``BlockedELL`` layout (host arrays
    or tensors of ``sparse.graph.pack_blocked_ell``) → ``(n_blocks ·
    block_rows, D)``: the live lanes are re-packed on the host into dedup
    chunks (per call — a plan packs once) and B1 runs on them
    (``spmm_dedup_chunks``: the kernel on a CUDA ``x``, its plain version
    on a CPU one)."""
    import numpy as np

    from repro_torch.sparse.graph import pack_dedup_chunks
    from repro_torch.sparse.plan import block_ptr_from_first

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)
    cols, row_local, vals, remaining = map(host, (cols, row_local, vals,
                                                  remaining))
    n_blocks, nnz_pad = cols.shape
    live = np.arange(nnz_pad)[None, :] < remaining[:, None]
    b_idx = np.nonzero(live)[0]
    rows_g = row_local[live] + b_idx * block_rows
    ch = pack_dedup_chunks(rows_g, cols[live], vals[live],
                           n_blocks * block_rows, int(x.shape[0]),
                           block_rows=block_rows)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(x.device)
    return spmm_dedup_chunks(
        dev(ch.u_cols), dev(ch.remaining),
        dev(block_ptr_from_first(ch.first, ch.n_blocks)), dev(ch.a),
        x.contiguous(), block_rows=block_rows)
spmm_dedup_chunks.launches_bf16 = 0     # the bf16 instantiation's share


# ---------------------------------------------------------------------------
# int8: spmm_dedup_chunks_q8
# ---------------------------------------------------------------------------

def _lane_scales(x_scale: torch.Tensor,
                 n_blocks: int) -> Tuple[torch.Tensor, int]:
    """``x_scale`` as ``(lanes, d_tiles)`` and the output blocks of a lane:
    a 1-D ``x_scale`` is one lane over every block; a 2-D one holds a row
    of feature scales per serving lane, the lanes' blocks in equal runs."""
    if x_scale.ndim == 1:
        return x_scale[None], max(n_blocks, 1)
    if (x_scale.ndim != 2 or x_scale.shape[0] < 1
            or n_blocks % x_scale.shape[0]):
        raise ValueError(
            f"x_scale of shape {tuple(x_scale.shape)} does not split "
            f"{n_blocks} output blocks into equal runs, one a lane")
    return x_scale, max(n_blocks // x_scale.shape[0], 1)


def spmm_dedup_chunks_q8_plain(u_cols: torch.Tensor, remaining: torch.Tensor,
                               block_ptr: torch.Tensor, a_q8: torch.Tensor,
                               a_scale: torch.Tensor, x_q8: torch.Tensor,
                               x_scale: torch.Tensor, *, block_rows: int,
                               q_tile: int) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel, in its fold order: per
    chunk the integer products summed exactly (f32 sums of int8·int8 stay
    below 2²⁴), folded into the block as ``fma(isum, a_scale[k]·
    x_scale[lane][col // q_tile], y)`` chunk after chunk
    (``fold_q8_in_order``), where a chunk's lane is its output block ÷
    the blocks of a lane (one lane unless ``x_scale`` is 2-D).  Lanes
    ``u ≥ remaining[k]`` are not read."""
    n_chunks, width = u_cols.shape
    d = x_q8.shape[1]
    n_blocks = block_ptr.shape[0] - 1
    scales, per_lane = _lane_scales(x_scale, n_blocks)
    lane = torch.arange(width, device=u_cols.device)
    live = lane[None, :] < remaining[:, None].to(torch.int64)
    idx = torch.where(live, u_cols.to(torch.int64), 0)
    land = x_q8.index_select(0, idx.reshape(-1)).reshape(
        n_chunks, width, d).to(torch.float32)
    land = torch.where(live[:, :, None], land, 0.0)
    a3 = torch.where(live[:, None, :], a_q8.reshape(
        n_chunks, block_rows, width).to(torch.float32), 0.0)
    isum = torch.bmm(a3, land)
    out_block = torch.repeat_interleave(
        torch.arange(n_blocks, device=u_cols.device),
        (block_ptr[1:] - block_ptr[:-1]).to(torch.int64))
    col_scale = torch.repeat_interleave(scales, q_tile, dim=1)[:, :d]
    scale = (a_scale[:, None]
             * col_scale.index_select(0, out_block // per_lane))[:, None, :]
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
    (ceil(D/q_tile),) f32, or ``(lanes, ceil(D/q_tile))`` for a stack of
    serving lanes that split the output blocks into equal runs, lane l's
    chunks reading only lane l's rows and scales.  ``q_tile`` is the
    scale tile the features were quantized with (default
    ``auto_d_tile(D)``).
    """
    q_tile = auto_d_tile(x_q8.shape[1]) if q_tile is None else int(q_tile)
    _check(u_cols, remaining, block_ptr, a_q8, x_q8, block_rows, torch.int8,
           (torch.int8,), (("a_scale", a_scale), ("x_scale", x_scale)))
    d = x_q8.shape[1]
    n_blocks = block_ptr.shape[0] - 1
    n_scales = -(-d // q_tile) if q_tile >= 1 else -1
    scales, _ = _lane_scales(x_scale, n_blocks)
    if a_scale.shape != remaining.shape or scales.shape[1] != n_scales:
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
    n_chunks, width = u_cols.shape
    y = torch.empty((n_blocks * block_rows, d), dtype=torch.float32,
                    device=x_q8.device)
    vec, lanes, rows, groups = _kernel_layout(u_cols, a_q8, x_q8, y,
                                              block_rows)
    lib = build.load(LIBRARY)
    with torch.cuda.device(x_q8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spmm_dedup_chunks_q8_launch(
            u_cols.data_ptr(), remaining.data_ptr(), block_ptr.data_ptr(),
            a_q8.data_ptr(), a_scale.data_ptr(), x_q8.data_ptr(),
            scales.data_ptr(), y.data_ptr(), n_blocks, n_chunks, width, d,
            q_tile, vec, lanes, rows, groups, scales.shape[0], stream)
    build.check_launch("spmm_dedup_chunks_q8", err)
    spmm_dedup_chunks_q8.launches += 1
    spmm_dedup_chunks_q8.launches_lanes += scales.shape[0] > 1
    return y


spmm_dedup_chunks_q8.launches = 0
spmm_dedup_chunks_q8.launches_lanes = 0  # the lane-scaled launches' share
