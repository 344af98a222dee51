"""SDDMM edge scores: CUDA kernel, plain version, wrapper and launch counter.

Port of ``repro.kernels.sddmm.sddmm.sddmm``: ``score[e] = Σ_d x[src[e], d] ·
y[dst[e], d]``.  The CUDA kernel (``csrc/sddmm.cu``) gives each edge a group
of lanes with vector loads and reduces the row-pair product with shuffles.
When x takes more than twice the card's L2 (``groups_by_source``), the call
first groups the edges by source with its own counting sort, so that each x
row is read about once; otherwise it runs in the caller's edge order.  Indices follow
``jnp.take``'s default, the reference oracle's: ``i`` in ``[-N, 0)`` reads
row ``i + N``, and an index outside ``[-N, N)`` gives NaN.

``sddmm`` takes the plain version only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.embedding_bag.embedding_bag import take_rows

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = build.KernelLibrary(
    name="sddmm",
    sources=(pathlib.Path(__file__).parent / "csrc" / "sddmm.cu",),
    functions=(
        ("sddmm_launch",
         (_P, _P, _P, _P, _P, _I64, _I64, _I64, _INT, _INT, _INT, _P)),
        ("sddmm_grouped_scratch", (_I64, _I64, _INT, _P)),
        ("sddmm_grouped_launch",
         (_P, _P, _P, _P, _P, _I64, _I64, _I64, _INT, _INT, _INT, _P, _I64,
          _P)),
    ))

PLAIN_EDGE_CHUNK = 1 << 20
SLOTS = 4                 # loads per lane per column tile (csrc/sddmm.cu)
# The grouping's ranks and slots are int32: it counts fewer edges than this.
GROUP_MAX_EDGES = 2 ** 31 - 1
# A test hook, not a setting: the bytes of x above which the call groups
# edges by source.  None, the default: twice the card's L2
# (cudaDeviceProp::l2CacheSize), where chip_smoke.py's B7 path sweep finds
# the two paths equal at ogb_products' width and degree.  The GPU tests and
# that sweep set it to 0 or 2**63 - 1 to force one path.
GROUP_ABOVE_X_BYTES: Optional[int] = None


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


def lane_layout(dim: int, *tensors: torch.Tensor) -> Tuple[int, int]:
    """(floats per load, lanes per edge): float4 loads where ``dim % 4 ==
    0`` and every pointer is 16-byte aligned, scalar loads otherwise; the
    fewest lanes, a power of two up to 32, that cover a row in ``SLOTS``
    loads each."""
    vec = 4 if dim % 4 == 0 and all(t.data_ptr() % 16 == 0
                                    for t in tensors) else 1
    per_lane = max(1, -(-(dim // vec) // SLOTS))
    return vec, min(32, 1 << (per_lane - 1).bit_length())


def groups_by_source(n_edges: int, x_bytes: int, l2_bytes: int) -> bool:
    """Whether the call groups edges by source: when x takes more than
    ``GROUP_ABOVE_X_BYTES`` (by default twice ``l2_bytes``) and the
    grouping can count the edges; otherwise it runs the direct path."""
    threshold = (2 * l2_bytes if GROUP_ABOVE_X_BYTES is None
                 else GROUP_ABOVE_X_BYTES)
    return x_bytes > threshold and n_edges < GROUP_MAX_EDGES


def sddmm(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
          y: torch.Tensor, edge_block: int = 256) -> torch.Tensor:
    """src/dst (E,) int32, E % edge_block == 0; x (Nx, D), y (Ny, D) f32 →
    ``(E,)`` f32.

    ``edge_block`` is the reference's grid tile; the CUDA kernel has its own
    (fixed chunks of edges per block) and keeps only the reference's
    divisibility check.
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
    (e,), (nx, d), ny = src.shape, x.shape, y.shape[0]
    if max(nx, ny) >= 2 ** 31 - 1:
        raise ValueError(f"sddmm indexes rows in int32: Nx={nx}, Ny={ny}")
    out = torch.empty(e, dtype=torch.float32, device=x.device)
    if e == 0:
        return out
    vec, lanes = lane_layout(d, x, y)
    lib = build.load(LIBRARY)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        l2 = torch.cuda.get_device_properties(x.device).L2_cache_size
        if groups_by_source(e, x.numel() * 4, l2):
            words = ctypes.c_int64()
            build.check_launch("sddmm", lib.sddmm_grouped_scratch(
                e, nx, lanes, ctypes.addressof(words)))
            scratch = torch.empty(words.value, dtype=torch.int32,
                                  device=x.device)
            err = lib.sddmm_grouped_launch(
                src.data_ptr(), dst.data_ptr(), x.data_ptr(), y.data_ptr(),
                out.data_ptr(), e, nx, ny, d, vec, lanes, scratch.data_ptr(),
                words.value, stream)
        else:
            err = lib.sddmm_launch(
                src.data_ptr(), dst.data_ptr(), x.data_ptr(), y.data_ptr(),
                out.data_ptr(), e, nx, ny, d, vec, lanes, stream)
    build.check_launch("sddmm", err)
    sddmm.launches += 1
    return out


sddmm.launches = 0
