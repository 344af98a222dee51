"""Counter-hash draws ``splitmix64(z) mod deg`` and the fused forest
sample built on them: CUDA kernels, plain versions, wrappers and launch
counters.

``hash_draws`` ports ``repro.kernels.forest_sampler.forest_sampler.
hash_draws``.  The counter ``z`` travels as int64 holding the uint64 bits.
The CUDA kernel (``csrc/hash_draws.cu``) hashes native ``uint64``.  The
plain version has only int64 to work with: the wrapping multiply gives the
same bits, right shifts are masked to be logical, and ``mod d`` goes
through the hi/lo split (``t = hi % d; t = t·(2³² mod d) % d``, every step
under 2⁶²).  Both must equal ``repro.sparse.sampler._mix64(z) % deg`` bit
for bit.

``forest_sample`` is what the device sampler runs: a bucket's whole forest
(every hop of every tree, the draws fused into their CSR gathers) in one
launch of ``csrc/forest_sample.cu``, equal to the reference's
``DeviceSamplerPlane.sample_bucket``.  Its plain version,
``forest_sample_plain``, is the eager per-hop loop around ``hash_draws``.
Both kernels hash through one header, ``csrc/mix64.cuh``.

The wrappers take the plain versions only for tensors on the CPU.  For
CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math
import pathlib
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import build

_CSRC = pathlib.Path(__file__).parent / "csrc"
LIBRARY = build.KernelLibrary(
    name="hash_draws",
    sources=(_CSRC / "hash_draws.cu", _CSRC / "mix64.cuh"),
    functions=(("hash_draws_launch",
                (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int64, ctypes.c_void_p)),))
FOREST_LIBRARY = build.KernelLibrary(
    name="forest_sample",
    sources=(_CSRC / "forest_sample.cu", _CSRC / "mix64.cuh"),
    functions=(("forest_sample_launch",
                (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
                 ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                 ctypes.c_void_p)),))
# forest_sample.cu's FOREST_MAX_HOPS
MAX_HOPS = 6


def _i64(c: int) -> int:
    """uint64 constant → the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


_SM_GAMMA = _i64(0x9E3779B97F4A7C15)
_SM_M1 = _i64(0xBF58476D1CE4E5B9)
_SM_M2 = _i64(0x94D049BB133111EB)
_K_HOP = 0x8CB92BA72F3D8DD7                 # sampler._K_HOP, _K_LANE
_K_LANE = 0x2545F4914F6CDD1D
_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


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


def forest_sample_plain(indptr: torch.Tensor, indices: torch.Tensor,
                        trees: torch.Tensor, fanouts: Sequence[int],
                        key_c: int):
    """Plain PyTorch version of ``forest_sample``: one vectorized pass per
    hop around ``hash_draws``, gathers clamped explicitly (JAX clips where
    torch faults).  Hop h's counter terms are ``key_c ⊕ (h+1)·C₂ ⊕
    lane·C₃`` over its ``Πfanouts[:h+1]`` lanes."""
    fanouts = tuple(int(f) for f in fanouts)
    dev = trees.device
    seeds, tkm, live = trees[0], trees[1], trees[2] != 0
    t = seeds.shape[0]
    last = indptr.shape[0] - 1
    n_edges = indices.shape[0]
    frontier = torch.where(live, seeds, 0).reshape(t, 1)
    live_l = live.reshape(t, 1)
    levels = [torch.where(live, seeds, -1)]
    valid_hops = []
    lanes = 1
    for h, f in enumerate(fanouts):
        start = indptr[frontier.clamp(0, last)]
        deg = indptr[(frontier + 1).clamp(0, last)] - start
        has_nbr = deg > 0
        hop = _i64((key_c ^ ((h + 1) * _K_HOP)) & _MASK64)
        lane = torch.arange(lanes * f, dtype=torch.int64, device=dev)
        z = tkm[:, None] ^ ((lane * _K_LANE) ^ hop)[None, :]
        dmax = deg.clamp_min(1).to(torch.int32).repeat_interleave(f, 1)
        r = hash_draws(z.contiguous(), dmax.contiguous())
        r = r.reshape(t, lanes, f).to(torch.int64)
        if n_edges:
            gather = (start[:, :, None] + r).clamp(0, n_edges - 1)
            nbr = indices[gather]
        else:
            nbr = torch.zeros((t, lanes, f), dtype=torch.int64, device=dev)
        valid = (has_nbr & live_l)[:, :, None].expand(t, lanes, f)
        nbr = torch.where(valid, nbr, -1)
        levels.append(nbr.reshape(-1))
        valid_hops.append(valid.reshape(-1))
        frontier = torch.where(valid, nbr, 0).reshape(t, lanes * f)
        live_l = valid.reshape(t, lanes * f)
        lanes *= f
    return torch.cat(levels), torch.cat(valid_hops)


def forest_sample(indptr: torch.Tensor, indices: torch.Tensor,
                  trees: torch.Tensor, fanouts: Sequence[int], key_c: int):
    """A bucket's forest sample in its breadth-major layout.

    indptr (N+1,) and indices (E,): the graph's CSR, int64.  trees (3, T)
    int64: row 0 the seeds, row 1 each tree's ``tree_key · C₁`` bits
    (``serve.device_sampler.tree_key_mix``), row 2 live (0 ⇒ a padding
    tree: −1 nodes and no valid edge at any level).  fanouts: 1 to
    ``MAX_HOPS`` hops.  key_c: the sampler key's term ``mix64(key)`` as
    an int (``sparse.sampler._mix64``).

    Returns ``(node_ids (T·Σ level sizes,) int64, hop_valid (T·Σ hop
    budgets,) bool)``: level by level, tree-major inside a level.
    """
    fanouts = tuple(int(f) for f in fanouts)
    for name, x in (("indptr", indptr), ("indices", indices),
                    ("trees", trees)):
        if x.dtype != torch.int64:
            raise TypeError(f"forest_sample takes int64 {name}, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if indptr.dim() != 1 or indices.dim() != 1 or indptr.numel() < 1:
        raise ValueError("indptr (N+1,) and indices (E,) must be 1-D, "
                         "indptr non-empty")
    if trees.dim() != 2 or trees.shape[0] != 3:
        raise ValueError(f"trees must be (3, T), got {tuple(trees.shape)}")
    if not (indptr.device == indices.device == trees.device):
        raise ValueError(f"indptr on {indptr.device}, indices on "
                         f"{indices.device}, trees on {trees.device}")
    if not 1 <= len(fanouts) <= MAX_HOPS or min(fanouts) < 1:
        raise ValueError(f"fanouts {fanouts}: 1 to {MAX_HOPS} hops, each "
                         "at least 1")
    if math.prod(fanouts) >= 2 ** 31:
        raise ValueError(f"fanouts {fanouts}: a tree's last level must "
                         "hold fewer than 2**31 nodes")
    if trees.device.type == "cpu":
        return forest_sample_plain(indptr, indices, trees, fanouts, key_c)
    if trees.device.type != "cuda":
        raise ValueError(f"forest_sample runs on cuda or cpu, not "
                         f"{trees.device}")
    n_trees = trees.shape[1]
    per_tree = sum(math.prod(fanouts[:h]) for h in range(len(fanouts) + 1))
    node_ids = torch.empty(n_trees * per_tree, dtype=torch.int64,
                           device=trees.device)
    hop_valid = torch.empty(n_trees * (per_tree - 1), dtype=torch.bool,
                            device=trees.device)
    if n_trees == 0:
        return node_ids, hop_valid
    lib = build.load(FOREST_LIBRARY)
    fan = (ctypes.c_int64 * len(fanouts))(*fanouts)
    with torch.cuda.device(trees.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.forest_sample_launch(
            indptr.data_ptr(), indices.data_ptr(), trees.data_ptr(),
            node_ids.data_ptr(), hop_valid.data_ptr(), indptr.numel() - 1,
            indices.numel(), n_trees, key_c % (1 << 64), fan, len(fanouts),
            stream)
    build.check_launch("forest_sample", err)
    forest_sample.launches += 1
    return node_ids, hop_valid


forest_sample.launches = 0
