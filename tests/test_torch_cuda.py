"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips without a CUDA device.  On a machine with
one, run ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.forest_sampler import hash_draws, hash_draws_plain
from repro_torch.kernels.gustavson_spmm import (spmm_dedup_chunks,
                                                spmm_dedup_chunks_plain)
from repro_torch.kernels.spgemm_pad import (spgemm_hashpad,
                                            spgemm_hashpad_plain)
from repro_torch.sparse import backend as sb
from repro_torch.sparse.graph import pack_dedup_chunks
from repro_torch.sparse.plan import block_ptr_from_first, make_plan
from repro_torch.sparse.spgemm import make_spgemm_plan
from repro_torch.sparse.sampler import _mix64

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(n, e, d, seed, width_cap, dev):
    rng = np.random.default_rng(seed)
    ch = pack_dedup_chunks(rng.integers(0, n, e), rng.integers(0, n, e),
                           rng.normal(size=e).astype(np.float32), n, n,
                           width_cap=width_cap)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                 (ch.u_cols, ch.remaining,
                  block_ptr_from_first(ch.first, ch.n_blocks), ch.a, x))


@pytest.mark.parametrize("n,e,d,width_cap", [
    (40, 300, 7, 128), (40, 300, 16, 128), (64, 900, 33, 8),
    (300, 2000, 600, 128), (200, 30, 16, 128)])
def test_spmm_kernel_matches_plain(cuda, n, e, d, width_cap):
    args = _args(n, e, d, seed=n + d, width_cap=width_cap, dev=cuda)
    before = spmm_dedup_chunks.launches
    got = spmm_dedup_chunks(*args, block_rows=8)
    assert spmm_dedup_chunks.launches == before + 1
    want = spmm_dedup_chunks_plain(*args, block_rows=8)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert float((got - want).abs().max()) <= 1e-5


def test_spmm_kernel_never_reads_dead_lanes(cuda):
    u, rem, ptr, a, x = _args(32, 150, 16, seed=1, width_cap=128, dev=cuda)
    x = torch.cat([x, torch.full((1, 16), float("nan"), device=cuda)])
    lane = torch.arange(u.shape[1], device=cuda)
    u = torch.where(lane[None, :] >= rem[:, None], 32, u).to(torch.int32)
    got = spmm_dedup_chunks(u.contiguous(), rem, ptr, a, x, block_rows=8)
    assert bool(torch.isfinite(got).all())


def test_spmm_wrapper_raises_on_bf16(cuda):
    u, rem, ptr, a, x = _args(16, 60, 8, seed=2, width_cap=128, dev=cuda)
    with pytest.raises(TypeError):
        spmm_dedup_chunks(u, rem, ptr, a, x.to(torch.bfloat16), block_rows=8)


def test_hash_draws_kernel_exact(cuda):
    rng = np.random.default_rng(0)
    z = rng.integers(0, 2 ** 63, 5000, dtype=np.int64).view(np.uint64)
    z[::3] |= np.uint64(1 << 63)
    z[:4] = [0, 2 ** 64 - 1, 2 ** 63, 2 ** 63 - 1]
    deg = rng.integers(1, 2 ** 31 - 1, 5000).astype(np.int32)
    deg[:2], deg[2:4] = 1, 2 ** 31 - 1
    zt = torch.from_numpy(z.view(np.int64).copy()).to(cuda)
    dt = torch.from_numpy(deg).to(cuda)
    want = (_mix64(z) % deg.astype(np.uint64)).astype(np.int32)
    assert np.array_equal(hash_draws(zt, dt).cpu().numpy(), want)
    assert np.array_equal(hash_draws_plain(zt, dt).cpu().numpy(), want)


def test_cuda_executor_matches_dense(cuda):
    rng = np.random.default_rng(3)
    s, r = rng.integers(0, 500, 4000), rng.integers(0, 500, 4000)
    w = rng.normal(size=4000).astype(np.float32)
    plan = make_plan(s, r, 501, edge_weight=w, device=cuda,
                     backends=("dense", "cuda"))
    x = torch.from_numpy(rng.normal(size=(501, 16)).astype(np.float32)
                         ).to(cuda)
    got = sb.aggregate(plan, None, x, backend="cuda")
    want = sb.aggregate(plan, None, x, backend="dense")
    assert float((got - want).abs().max()) <= 1e-4


def _spgemm_plan(n, e, seed, dev, **kw):
    rng = np.random.default_rng(seed)
    r, s = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    return make_spgemm_plan(r, s, n, r, s, n, a_vals=w, b_vals=w,
                            device=dev, **kw), rng


@pytest.mark.parametrize("n,e,width_cap,pad_slack,lanes", [
    (200, 100, 128, 2.0, "below_32"),     # a pad of 8 lanes
    (300, 3000, 128, 2.0, "h_tiles"),     # pad split into several h tiles
    (64, 1500, 8, 2.0, "chunks"),         # several chunks per block
    (64, 1500, 8, 64.0, "h_tiles")])
def test_hashpad_kernel_matches_plain(cuda, n, e, width_cap, pad_slack,
                                      lanes):
    plan, rng = _spgemm_plan(n, e, seed=n + e, dev=cuda, width_cap=width_cap,
                             pad_slack=pad_slack)
    if lanes == "below_32":
        assert plan.pad_width < 32
    elif lanes == "h_tiles":
        assert plan.pad_width > 256
    else:
        assert plan.n_chunks > plan.n_blocks
    slab = torch.from_numpy(rng.normal(size=(
        plan.n_chunks * plan.width, plan.pad_width)).astype(np.float32)
                            ).to(cuda)
    args = (plan.ell_remaining, plan.ell_block_ptr, plan.ell_a, slab)
    kw = dict(block_rows=plan.block_rows, pad_width=plan.pad_width)
    before = spgemm_hashpad.launches
    got = spgemm_hashpad(*args, **kw)
    assert spgemm_hashpad.launches == before + 1
    want = spgemm_hashpad_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert float((got - want).abs().max()) <= 1e-5


def test_hashpad_kernel_never_reads_dead_lanes(cuda):
    plan, _ = _spgemm_plan(64, 500, seed=4, dev=cuda)
    lane = torch.arange(plan.width, device=cuda)
    dead = (lane[None, :] >= plan.ell_remaining[:, None]).reshape(-1)
    slab = torch.zeros((plan.n_chunks * plan.width, plan.pad_width),
                       device=cuda)
    slab[dead] = float("nan")
    got = spgemm_hashpad(plan.ell_remaining, plan.ell_block_ptr, plan.ell_a,
                         slab, block_rows=8, pad_width=plan.pad_width)
    assert bool(dead.any()) and bool(torch.isfinite(got).all())


def test_spgemm_cuda_executor_matches_reference(cuda):
    plan, rng = _spgemm_plan(500, 4000, seed=5, dev=cuda)
    got = sb.spgemm(plan, backend="cuda")
    assert float((got - sb.spgemm(plan, backend="reference")).abs().max()
                 ) <= 1e-4
    assert float((got - sb.spgemm(plan, backend="dense")).abs().max()
                 ) <= 1e-4
    av = torch.from_numpy(rng.normal(size=plan.nnz_a).astype(np.float32)
                          ).to(cuda)
    got = sb.spgemm(plan, av, None, backend="cuda")
    want = sb.spgemm(plan, av, None, backend="reference")
    assert float((got - want).abs().max()) <= 1e-4
