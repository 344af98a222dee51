"""Counter-hash draws ``splitmix64(z) mod deg``: CUDA kernel, plain
version, wrapper and launch counter.

Port of ``repro.kernels.forest_sampler.forest_sampler.hash_draws``.  The
counter ``z`` travels as int64 holding the uint64 bits.  The CUDA kernel
(``csrc/hash_draws.cu``) hashes native ``uint64``.  The plain version has
only int64 to work with: the wrapping multiply gives the same bits, right
shifts are masked to be logical, and ``mod d`` goes through the hi/lo split
(``t = hi % d; t = t·(2³² mod d) % d``, every step under 2⁶²).  Both must
equal ``repro.sparse.sampler._mix64(z) % deg`` bit for bit.

``hash_draws`` takes the plain version only for tensors on the CPU.  For
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import pathlib

import numpy as np
import torch

from repro_torch.kernels import build

LIBRARY = build.KernelLibrary(
    name="hash_draws",
    sources=(pathlib.Path(__file__).parent / "csrc" / "hash_draws.cu",),
    functions=(("hash_draws_launch",
                (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int64, ctypes.c_void_p)),))


def _i64(c: int) -> int:
    """uint64 constant → the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


_SM_GAMMA = _i64(0x9E3779B97F4A7C15)
_SM_M1 = _i64(0xBF58476D1CE4E5B9)
_SM_M2 = _i64(0x94D049BB133111EB)
_MASK32 = 0xFFFFFFFF


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64-held uint64 bits."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def mix64_plain(z: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64-held uint64 bits (wrapping)."""
    z = z + _SM_GAMMA
    z = (z ^ _shr(z, 30)) * _SM_M1
    z = (z ^ _shr(z, 27)) * _SM_M2
    return z ^ _shr(z, 31)


def mod_u64_plain(z: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``uint64(z) mod d`` for 1 ≤ d < 2³¹ in int64 arithmetic."""
    d = d.to(torch.int64)
    hi = _shr(z, 32)
    lo = z & _MASK32
    t = hi % d
    t = (t * ((1 << 32) % d)) % d          # both factors < 2³¹
    return (t + lo % d) % d


def hash_draws_plain(z: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``mix64(z) mod deg`` as int32."""
    return mod_u64_plain(mix64_plain(z), deg).to(torch.int32)


def split64(z) -> tuple:
    """int64-held uint64 bits → ``(hi, lo)`` uint32 numpy halves (the JAX
    kernel's operand layout)."""
    if isinstance(z, torch.Tensor):
        z = z.cpu().numpy()
    u = np.asarray(z, np.int64).view(np.uint64)
    return ((u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(_MASK32)).astype(np.uint32))


def hash_draws(z: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """``mix64(z) mod deg`` elementwise → int32 draws of ``z``'s shape.

    z: int64 holding uint64 bits; deg: int32 moduli ≥ 1 (callers pass
    ``max(degree, 1)``), same shape and device.
    """
    if z.dtype != torch.int64 or deg.dtype != torch.int32:
        raise TypeError(f"hash_draws takes int64 z and int32 deg, got "
                        f"{z.dtype} and {deg.dtype}")
    if z.shape != deg.shape:
        raise ValueError(f"z {tuple(z.shape)} and deg {tuple(deg.shape)} "
                         "differ in shape")
    if z.device != deg.device:
        raise ValueError(f"z is on {z.device}, deg on {deg.device}")
    if not (z.is_contiguous() and deg.is_contiguous()):
        raise ValueError("z and deg must be contiguous")
    if z.device.type == "cpu":
        return hash_draws_plain(z, deg)
    if z.device.type != "cuda":
        raise ValueError(f"hash_draws runs on cuda or cpu, not {z.device}")
    out = torch.empty(z.shape, dtype=torch.int32, device=z.device)
    lib = build.load(LIBRARY)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hash_draws_launch(z.data_ptr(), deg.data_ptr(),
                                    out.data_ptr(), z.numel(), stream)
    build.check_launch("hash_draws", err)
    hash_draws.launches += 1
    return out


hash_draws.launches = 0
