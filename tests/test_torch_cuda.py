"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips without a CUDA device.  On a machine with
one, run ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where JAX is not installed.
"""
import ctypes
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_plain)
from repro_torch.kernels.embedding_bag.embedding_bag import lane_layout
from repro_torch.kernels.flash_attention import (causal_attention_plain,
                                                 flash_attention, mha_causal)
from repro_torch.kernels.forest_sampler import hash_draws, hash_draws_plain
from repro_torch.kernels.gustavson_spmm import gustavson_spmm as spmm_module
from repro_torch.kernels.gustavson_spmm import (auto_d_tile,
                                                spmm_dedup_chunks,
                                                spmm_dedup_chunks_plain,
                                                spmm_dedup_chunks_q8,
                                                spmm_dedup_chunks_q8_plain)
from repro_torch.kernels.sddmm import edge_scores, sddmm, sddmm_plain
from repro_torch.kernels.spgemm_pad import (spgemm_hashpad,
                                            spgemm_hashpad_compact_plain,
                                            spgemm_hashpad_plain,
                                            spgemm_hashpad_q8,
                                            spgemm_hashpad_q8_compact_plain,
                                            spgemm_hashpad_q8_plain)
from repro_torch.kernels.spgemm_pad import spgemm_pad as hashpad_module
from repro_torch.kernels.spgemm_pad.spgemm_pad import H_TILE
from repro_torch.sparse import quantize as qz
from repro_torch.sparse import backend as sb
from repro_torch.sparse.graph import pack_dedup_chunks
from repro_torch.sparse.plan import block_ptr_from_first, make_plan
from repro_torch.sparse.spgemm import make_spgemm_plan
from repro_torch.sparse.spgemm.numeric import hashed_slab_q8
from repro_torch.sparse.sampler import _mix64
from spgemm_cells import drop_block_chunks, with_dead_lane_cells

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


def _offset_view(t, offset):
    """``t``'s values in a buffer ``offset`` elements in (a view whose
    pointer is only ``offset`` elements aligned)."""
    base = torch.zeros(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = base[offset:offset + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def _spmm_both(args, q_tile=None):
    """The f32 kernel on ``args`` = (u, rem, ptr, a, x) and the int8 kernel
    on their quantized tiles and features."""
    u, rem, ptr, a, x = args
    a_q8, a_scale = qz.quantize_chunk_tiles(a, u.shape[0])
    qt = auto_d_tile(x.shape[1]) if q_tile is None else q_tile
    x_q8, x_scale = qz.quantize_feature_tiles(x, qt)
    q8_args = (u, rem, ptr, a_q8, a_scale, x_q8, x_scale)
    return (spmm_dedup_chunks(*args, block_rows=8),
            spmm_dedup_chunks_q8(*q8_args, block_rows=8, q_tile=qt),
            q8_args, qt)


@pytest.mark.parametrize("d", [7, 16, 33, 64, 602, 1433])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_spmm_kernels_every_load_width(cuda, d, offset):
    # wide and unaligned rows: x (and x_q8) viewed offset elements into a
    # buffer, so lane_layout picks 4-, 2- and 1-element loads; the sums do
    # not depend on the load width
    u, rem, ptr, a, x = _args(300, 2000, d, seed=d + offset, width_cap=128,
                              dev=cuda)
    xv = _offset_view(x, offset)
    got = spmm_dedup_chunks(u, rem, ptr, a, xv, block_rows=8)
    want = spmm_dedup_chunks_plain(u, rem, ptr, a, xv, block_rows=8)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got, spmm_dedup_chunks(u, rem, ptr, a, x,
                                              block_rows=8))
    _, q8, (u, rem, ptr, a_q8, a_scale, x_q8, x_scale), qt = _spmm_both(
        (u, rem, ptr, a, x))
    x_q8v = _offset_view(x_q8, offset)
    assert spmm_module.lane_layout(d, x_q8v)[0] == (
        1 if d % 2 or offset % 2 else 2 if d % 4 or offset else 4)
    got_q8 = spmm_dedup_chunks_q8(u, rem, ptr, a_q8, a_scale, x_q8v,
                                  x_scale, block_rows=8, q_tile=qt)
    assert torch.equal(got_q8, q8)
    assert torch.equal(got_q8, spmm_dedup_chunks_q8_plain(
        u, rem, ptr, a_q8, a_scale, x_q8v, x_scale, block_rows=8,
        q_tile=qt))


def test_spmm_kernels_hub_split_over_many_chunks(cuda):
    # one row with 260 distinct operands, width_cap 8: its block folds 33+
    # chunks in order, with the next chunk's metadata loaded ahead
    rng = np.random.default_rng(21)
    n, d = 600, 96
    rows = np.concatenate([np.full(260, 3), rng.integers(0, n, 1500)])
    cols = np.concatenate([rng.permutation(n)[:260],
                           rng.integers(0, n, 1500)])
    vals = (rng.normal(size=rows.size) * 0.05).astype(np.float32)
    ch = pack_dedup_chunks(rows, cols, vals, n, n, width_cap=8)
    assert int((ch.out_block == 0).sum()) >= 200 // 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    args = tuple(torch.from_numpy(np.ascontiguousarray(t)).to(cuda) for t in
                 (ch.u_cols, ch.remaining,
                  block_ptr_from_first(ch.first, ch.n_blocks), ch.a, x))
    got, got_q8, q8_args, qt = _spmm_both(args)
    want = spmm_dedup_chunks_plain(*args, block_rows=8)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got_q8, spmm_dedup_chunks_q8_plain(
        *q8_args, block_rows=8, q_tile=qt))


@pytest.mark.parametrize("d,width_cap", [(7, 128), (602, 128), (1433, 8)])
def test_spmm_kernels_dead_lanes_poisoned_with_nan(cuda, d, width_cap):
    # dead lanes name a NaN row (f32) or a row of 127s (int8) and carry NaN
    # (f32) or -127 (int8) coefficients: the bits do not change
    args = _args(200, 1500, d, seed=d, width_cap=width_cap, dev=cuda)
    clean, clean_q8, (u, rem, ptr, a_q8, a_scale, x_q8, x_scale), qt = \
        _spmm_both(args)
    _, _, _, a, x = args
    dead = torch.arange(u.shape[1], device=cuda)[None, :] >= rem[:, None]
    assert bool(dead.any())
    dead_rows = dead.repeat_interleave(8, 0)
    u_bad = torch.where(dead, 200, u).to(torch.int32).contiguous()
    x_bad = torch.cat([x, torch.full((1, d), float("nan"), device=cuda)])
    a_bad = torch.where(dead_rows, float("nan"), a).contiguous()
    assert torch.equal(spmm_dedup_chunks(u_bad, rem, ptr, a_bad, x_bad,
                                         block_rows=8), clean)
    x_q8_bad = torch.cat([x_q8, torch.full((1, d), 127, dtype=torch.int8,
                                           device=cuda)])
    a_q8_bad = torch.where(dead_rows, -127, a_q8).to(torch.int8).contiguous()
    assert torch.equal(spmm_dedup_chunks_q8(
        u_bad, rem, ptr, a_q8_bad, a_scale, x_q8_bad, x_scale, block_rows=8,
        q_tile=qt), clean_q8)


@pytest.mark.parametrize("d,width_cap", [(7, 128), (64, 8), (1433, 128)])
def test_spmm_kernels_bitwise_across_stripes_and_blocks_per_cta(
        cuda, monkeypatch, d, width_cap):
    # the same bits run to run, whatever the stripe width (MAX_LANES) and
    # the output blocks per thread block (BLOCKS_PER_CTA)
    args = _args(400, 3000, d, seed=d, width_cap=width_cap, dev=cuda)
    first, first_q8, _, _ = _spmm_both(args)
    for max_lanes, per_cta in ((256, None), (32, 1), (32, 16), (4, 16),
                               (256, 16), (8, 1)):
        monkeypatch.setattr(spmm_module, "MAX_LANES", max_lanes)
        monkeypatch.setattr(spmm_module, "BLOCKS_PER_CTA", per_cta)
        got, got_q8, _, _ = _spmm_both(args)
        assert torch.equal(got, first), (max_lanes, per_cta)
        assert torch.equal(got_q8, first_q8), (max_lanes, per_cta)


@pytest.mark.parametrize("d,q_tile", [(1433, None), (1433, 100), (602, 30),
                                      (64, 24), (33, 10)])
def test_spmm_q8_kernel_equals_plain_across_scale_tiles(cuda, d, q_tile):
    # D = 1433 in three scale tiles (auto_d_tile), and scale tiles that a
    # thread's 4 columns or a 16-byte row segment straddle
    args = _args(300, 2000, d, seed=d + 1, width_cap=128, dev=cuda)
    _, got, q8_args, qt = _spmm_both(args, q_tile)
    assert q8_args[6].numel() == (3 if q_tile is None else -(-d // qt))
    assert q_tile is None or q_tile % 16
    assert torch.equal(got, spmm_dedup_chunks_q8_plain(
        *q8_args, block_rows=8, q_tile=qt))


def test_spmm_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    u, rem, ptr, a, x = _args(40, 300, 16, seed=4, width_cap=128, dev=cuda)
    with pytest.raises(ValueError, match="block_rows"):
        spmm_dedup_chunks(u, rem, ptr, torch.cat([a, a]), x, block_rows=16)
    with pytest.raises(ValueError, match="multiple of 16"):
        spmm_dedup_chunks(u[:, :8].contiguous(), rem.clamp(max=8), ptr,
                          a[:, :8].contiguous(), x, block_rows=8)


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


def _spgemm_plan(n, e, seed, dev, dup=False, **kw):
    rng = np.random.default_rng(seed)
    r, s = rng.integers(0, n, e), rng.integers(0, n, e)
    if dup:
        r[:5], s[:5] = 7, 3         # B entry (7, 3) five times: one cell
    w = rng.normal(size=e).astype(np.float32)
    return make_spgemm_plan(r, s, n, r, s, n, a_vals=w, b_vals=w,
                            device=dev, **kw), rng


def _b2_args(plan, a=None, cell_val=None):
    return (plan.ell_remaining, plan.ell_block_ptr,
            plan.ell_a if a is None else a, plan.cell_ptr, plan.cell_lane,
            plan.cell_bucket, plan.cell_val if cell_val is None else cell_val,
            plan.c_indptr, plan.out_bucket)


def _dense_of_cells(plan, vals):
    """The cells scattered into the dense hashed slab (the oracle's input)."""
    chunk = torch.repeat_interleave(
        torch.arange(plan.n_chunks, device=vals.device),
        (plan.cell_ptr[1:] - plan.cell_ptr[:-1]).long())
    slab = torch.zeros((plan.n_chunks * plan.width, plan.pad_width),
                       dtype=vals.dtype, device=vals.device)
    slab[chunk * plan.width + plan.cell_lane.long(),
         plan.cell_bucket.long()] = vals
    return slab


def _gather(plan, c_pad):
    return c_pad[plan.out_row.long(), plan.out_bucket.long()]


@pytest.mark.parametrize("n,e,width_cap,pad_slack,lanes", [
    (200, 100, 128, 2.0, "below_32"),     # a pad of 8 lanes
    (300, 3000, 128, 2.0, "h_tiles"),     # pad split into several h tiles
    (64, 1500, 8, 2.0, "chunks"),         # several chunks per block
    (64, 1500, 8, 64.0, "h_tiles")])
def test_hashpad_kernel_matches_plain(cuda, monkeypatch, n, e, width_cap,
                                      pad_slack, lanes):
    plan, rng = _spgemm_plan(n, e, seed=n + e, dev=cuda, width_cap=width_cap,
                             pad_slack=pad_slack)
    if lanes == "below_32":
        assert plan.pad_width < 32
    elif lanes == "h_tiles":
        assert plan.pad_width > 256
    else:
        assert plan.n_chunks > plan.n_blocks
    if pad_slack > 2.0:                  # several bucket tiles by default
        assert plan.pad_width > H_TILE
    vals = torch.from_numpy(rng.normal(size=plan.n_cells).astype(
        np.float32)).to(cuda)
    args = _b2_args(plan, cell_val=vals)
    kw = dict(block_rows=plan.block_rows, pad_width=plan.pad_width)
    before = spgemm_hashpad.launches
    got = spgemm_hashpad(*args, **kw)
    assert spgemm_hashpad.launches == before + 1
    want = spgemm_hashpad_compact_plain(*args, **kw)
    oracle = _gather(plan, spgemm_hashpad_plain(
        plan.ell_remaining, plan.ell_block_ptr, plan.ell_a,
        _dense_of_cells(plan, vals), **kw))
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.shape == (plan.nnz_out,)
    assert float((got - want).abs().max()) <= 1e-5
    assert float((got - oracle).abs().max()) <= 1e-5
    assert torch.equal(spgemm_hashpad(*args, **kw), got)    # run to run
    # the same pad split into tiles of 64 buckets: the same bits
    monkeypatch.setattr(hashpad_module, "H_TILE", 64)
    assert torch.equal(spgemm_hashpad(*args, **kw), got)


def test_hashpad_kernel_never_reads_dead_lanes(cuda):
    plan, _ = _spgemm_plan(64, 500, seed=4, dev=cuda)
    kw = dict(block_rows=8, pad_width=plan.pad_width)
    want = spgemm_hashpad(*_b2_args(plan), **kw)
    lane = torch.arange(plan.width, device=cuda)
    dead = lane[None, :] >= plan.ell_remaining[:, None]
    a = torch.where(dead.repeat_interleave(8, 0), float("nan"), plan.ell_a)
    ptr, c_lane, c_bucket, c_val = with_dead_lane_cells(
        plan, plan.cell_val, float("nan"))
    assert bool(dead.any()) and c_lane.numel() > plan.n_cells
    got = spgemm_hashpad(plan.ell_remaining, plan.ell_block_ptr,
                         a.contiguous(), ptr, c_lane, c_bucket, c_val,
                         plan.c_indptr, plan.out_bucket, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_hashpad_kernels_block_without_chunks(cuda, dtype):
    plan, _ = _spgemm_plan(120, 900, seed=9, dev=cuda,
                           executors=("cuda_q8",))
    b = plan.n_blocks // 2
    kw = dict(block_rows=8, pad_width=plan.pad_width)
    out = (plan.c_indptr, plan.out_bucket)
    if dtype == "f32":
        args = (*drop_block_chunks(plan, b, plan.ell_a, plan.cell_val), *out)
        got = spgemm_hashpad(*args, **kw)
        want = spgemm_hashpad_compact_plain(*args, **kw)
    else:
        rem, bp, a, a_scale, slab_scale, *cells = drop_block_chunks(
            plan, b, plan.ell_a_q8, plan.cell_q8,
            (plan.ell_a_scale, plan.slab_scale))
        args = (rem, bp, a, a_scale, *cells, slab_scale, *out)
        got = spgemm_hashpad_q8(*args, **kw)
        want = spgemm_hashpad_q8_compact_plain(*args, **kw)
    torch.cuda.synchronize()
    assert int(args[1][b + 1] - args[1][b]) == 0
    rows = plan.c_indptr[8 * b], plan.c_indptr[min(8 * b + 8, plan.n_rows)]
    assert int(rows[1] - rows[0]) > 0
    assert torch.equal(got[rows[0]:rows[1]],
                       torch.zeros_like(got[rows[0]:rows[1]]))
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_hashpad_kernels_narrower_pad_width_gives_nan(cuda, dtype):
    """A pad width below the plan's: C's entries whose bucket no longer
    fits come out NaN, the rest as at the plan's width — never the memory
    that the output's allocation held before (poisoned here first)."""
    plan, _ = _spgemm_plan(300, 3000, seed=11, dev=cuda,
                           executors=("cuda_q8",))
    if dtype == "f32":
        fn, args = spgemm_hashpad, _b2_args(plan)
    else:
        fn, args = spgemm_hashpad_q8, _b5_args(plan)
    full = fn(*args, block_rows=8, pad_width=plan.pad_width)
    half = plan.pad_width // 2
    junk = torch.full((plan.nnz_out,), 12345.0, device=cuda)
    del junk                           # its block is the next allocation's
    got = fn(*args, block_rows=8, pad_width=half)
    want = spgemm_hashpad_compact_plain(*args, block_rows=8, pad_width=half) \
        if dtype == "f32" else spgemm_hashpad_q8_compact_plain(
            *args, block_rows=8, pad_width=half)
    torch.cuda.synchronize()
    out = plan.out_bucket >= half
    assert bool(out.any()) and bool((~out).any())
    assert bool(torch.isnan(got[out]).all())
    assert torch.equal(got[~out], full[~out])
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert float((got[~out] - want[~out]).abs().max()) <= 1e-5


def test_spgemm_cuda_executor_matches_reference(cuda):
    for dup in (False, True):
        plan, rng = _spgemm_plan(500, 4000, seed=5, dev=cuda, dup=dup)
        if dup:
            assert plan.n_cells < plan.pp_dedup     # entries share cells
        got = sb.spgemm(plan, backend="cuda")
        assert float((got - sb.spgemm(plan, backend="reference")).abs().max()
                     ) <= 1e-4
        assert float((got - sb.spgemm(plan, backend="dense")).abs().max()
                     ) <= 1e-4
        assert torch.equal(sb.spgemm(plan, backend="cuda"), got)
        av, bv = (torch.from_numpy(rng.normal(size=n).astype(np.float32)
                                   ).to(cuda)
                  for n in (plan.nnz_a, plan.nnz_b))
        for a2, b2 in ((av, None), (None, bv), (av, bv)):
            got = sb.spgemm(plan, a2, b2, backend="cuda")
            want = sb.spgemm(plan, a2, b2, backend="reference")
            assert float((got - want).abs().max()) <= 1e-4
            assert torch.equal(sb.spgemm(plan, a2, b2, backend="cuda"), got)


# ---------------------------------------------------------------------------
# int8 kernels: spmm_dedup_chunks_q8 (B4) and spgemm_hashpad_q8 (B5)
# ---------------------------------------------------------------------------

def _q8_args(n, e, d, seed, width_cap, dev):
    u, rem, ptr, a, x = _args(n, e, d, seed, width_cap, dev)
    a_q8, a_scale = qz.quantize_chunk_tiles(a, u.shape[0])
    x_q8, x_scale = qz.quantize_feature_tiles(x, auto_d_tile(d))
    return u, rem, ptr, a_q8, a_scale, x_q8, x_scale


@pytest.mark.parametrize("n,e,d,width_cap", [
    (40, 300, 7, 128), (40, 300, 16, 128), (64, 900, 33, 8),
    (300, 2000, 600, 128), (64, 900, 600, 8), (200, 30, 16, 128)])
def test_spmm_q8_kernel_matches_plain(cuda, n, e, d, width_cap):
    args = _q8_args(n, e, d, seed=n + d, width_cap=width_cap, dev=cuda)
    before = spmm_dedup_chunks_q8.launches
    got = spmm_dedup_chunks_q8(*args, block_rows=8)
    assert spmm_dedup_chunks_q8.launches == before + 1
    want = spmm_dedup_chunks_q8_plain(*args, block_rows=8,
                                      q_tile=auto_d_tile(d))
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5


def test_quantizers_on_the_card_equal_the_cpu_bitwise(cuda):
    # the int8 values, and so every kernel result, must not depend on the
    # device that quantized them
    rng = np.random.default_rng(11)
    a = (rng.normal(size=(64 * 8, 48)) * rng.choice(
        [1e-3, 1.0, 37.0], (64 * 8, 1))).astype(np.float32)
    x = (rng.normal(size=(300, 600)) * 5).astype(np.float32)
    chunk = np.sort(rng.integers(0, 64, a.size))
    for fn, args in ((qz.quantize_chunk_tiles, (a, 64)),
                     (qz.quantize_feature_tiles, (x, 304)),
                     (qz.quantize_chunk_entries, (a.reshape(-1), chunk,
                                                  64))):
        host = [torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for v in args]
        want = fn(*host)
        got = fn(*[v.to(cuda) if isinstance(v, torch.Tensor) else v
                   for v in host])
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), fn.__name__


def test_spmm_q8_kernel_never_reads_dead_lanes(cuda):
    u, rem, ptr, a, sa, x, sx = _q8_args(32, 150, 16, seed=1, width_cap=8,
                                         dev=cuda)
    want = spmm_dedup_chunks_q8(u, rem, ptr, a, sa, x, sx, block_rows=8)
    dead = torch.arange(u.shape[1], device=cuda)[None, :] >= rem[:, None]
    x = torch.cat([x, torch.full((1, 16), 127, dtype=torch.int8,
                                 device=cuda)])
    u = torch.where(dead, 32, u).to(torch.int32).contiguous()
    a = torch.where(dead.repeat_interleave(8, 0), -127, a).to(
        torch.int8).contiguous()
    got = spmm_dedup_chunks_q8(u, rem, ptr, a, sa, x, sx, block_rows=8)
    torch.cuda.synchronize()
    assert bool(dead.any()) and torch.equal(got, want)


def test_spmm_q8_wrapper_raises_on_f32(cuda):
    u, rem, ptr, a, sa, x, sx = _q8_args(16, 60, 8, seed=2, width_cap=128,
                                         dev=cuda)
    with pytest.raises(TypeError):
        spmm_dedup_chunks_q8(u, rem, ptr, a, sa, x.float(), sx, block_rows=8)
    with pytest.raises(TypeError):
        spmm_dedup_chunks_q8(u, rem, ptr, a.float(), sa, x, sx, block_rows=8)


def _b5_args(plan, a_q8=None, cell_q8=None):
    return (plan.ell_remaining, plan.ell_block_ptr,
            plan.ell_a_q8 if a_q8 is None else a_q8, plan.ell_a_scale,
            plan.cell_ptr, plan.cell_lane, plan.cell_bucket,
            plan.cell_q8 if cell_q8 is None else cell_q8, plan.slab_scale,
            plan.c_indptr, plan.out_bucket)


@pytest.mark.parametrize("n,e,width_cap,pad_slack,lanes", [
    (200, 100, 128, 2.0, "below_32"),
    (300, 3000, 128, 2.0, "h_tiles"),
    (64, 1500, 8, 2.0, "chunks"),
    (64, 1500, 8, 64.0, "h_tiles")])
def test_hashpad_q8_kernel_matches_plain(cuda, monkeypatch, n, e, width_cap,
                                         pad_slack, lanes):
    plan, _ = _spgemm_plan(n, e, seed=n + e, dev=cuda, width_cap=width_cap,
                           pad_slack=pad_slack, dup=True,
                           executors=("reference", "cuda_q8"))
    if lanes == "below_32":
        assert plan.pad_width < 32
    elif lanes == "h_tiles":
        assert plan.pad_width > 256
    else:
        assert plan.n_chunks > plan.n_blocks
    if pad_slack > 2.0:
        assert plan.pad_width > H_TILE
    args = _b5_args(plan)
    kw = dict(block_rows=plan.block_rows, pad_width=plan.pad_width)
    before = spgemm_hashpad_q8.launches
    got = spgemm_hashpad_q8(*args, **kw)
    assert spgemm_hashpad_q8.launches == before + 1
    want = spgemm_hashpad_q8_compact_plain(*args, **kw)
    oracle = _gather(plan, spgemm_hashpad_q8_plain(
        plan.ell_remaining, plan.ell_block_ptr, plan.ell_a_q8,
        plan.ell_a_scale, hashed_slab_q8(plan), plan.slab_scale, **kw))
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.shape == (plan.nnz_out,)
    assert float((got - want).abs().max()) <= 1e-5
    assert float((got - oracle).abs().max()) <= 1e-5
    assert torch.equal(spgemm_hashpad_q8(*args, **kw), got)
    monkeypatch.setattr(hashpad_module, "H_TILE", 64)
    assert torch.equal(spgemm_hashpad_q8(*args, **kw), got)


def test_hashpad_q8_kernel_never_reads_dead_lanes(cuda):
    plan, _ = _spgemm_plan(64, 1500, seed=4, dev=cuda, width_cap=8,
                           executors=("cuda_q8",))
    kw = dict(block_rows=8, pad_width=plan.pad_width)
    want = spgemm_hashpad_q8(*_b5_args(plan), **kw)
    lane = torch.arange(plan.width, device=cuda)
    dead = lane[None, :] >= plan.ell_remaining[:, None]
    a = torch.where(dead.repeat_interleave(8, 0), -127,
                    plan.ell_a_q8).to(torch.int8)
    ptr, c_lane, c_bucket, c_q8 = with_dead_lane_cells(plan, plan.cell_q8,
                                                       127)
    assert bool(dead.any()) and c_lane.numel() > plan.n_cells
    got = spgemm_hashpad_q8(plan.ell_remaining, plan.ell_block_ptr,
                            a.contiguous(), plan.ell_a_scale, ptr, c_lane,
                            c_bucket, c_q8, plan.slab_scale, plan.c_indptr,
                            plan.out_bucket, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_hashpad_q8_wrapper_raises_on_f32(cuda):
    plan, _ = _spgemm_plan(64, 500, seed=6, dev=cuda, executors=("cuda_q8",))
    args = list(_b5_args(plan))
    args[7] = plan.cell_q8.float()
    before = spgemm_hashpad_q8.launches
    with pytest.raises(TypeError):
        spgemm_hashpad_q8(*args, block_rows=8, pad_width=plan.pad_width)
    assert spgemm_hashpad_q8.launches == before


def test_q8_executors_within_their_bounds(cuda):
    rng = np.random.default_rng(7)
    s, r = rng.integers(0, 500, 4000), rng.integers(0, 500, 4000)
    w = rng.normal(size=4000).astype(np.float32)
    plan = make_plan(s, r, 501, edge_weight=w, device=cuda,
                     backends=("dense", "cuda_q8"))
    x = torch.from_numpy(rng.normal(size=(501, 16)).astype(np.float32)
                         ).to(cuda)
    before = spmm_dedup_chunks_q8.launches
    got = sb.aggregate(plan, None, x, backend="cuda_q8")
    assert spmm_dedup_chunks_q8.launches == before + 1
    _, xs = qz.quantize_feature_tiles(x, 16)
    bound = qz.aggregate_q8_bound(plan.ell_remaining, plan.ell_out_block,
                                  plan.n_blocks, plan.ell_a_scale, xs)
    dev = float((got - sb.aggregate(plan, None, x, backend="dense")
                 ).abs().max())
    assert qz.q8_gate(dev, bound)
    sp, _ = _spgemm_plan(500, 4000, seed=5, dev=cuda,
                         executors=("reference", "cuda_q8"))
    got = sb.spgemm(sp, backend="cuda_q8")
    bound = qz.spgemm_q8_bound(sp.width, sp.ell_out_block, sp.n_blocks,
                               sp.ell_a_scale, sp.slab_scale)
    dev = float((got - sb.spgemm(sp, backend="reference")).abs().max())
    assert qz.q8_gate(dev, bound)


# ---------------------------------------------------------------------------
# embedding_bag (B6), sddmm (B7), flash_attention (B8)
# ---------------------------------------------------------------------------

def _same(got, want):
    """Equal, NaN where the other is NaN."""
    return torch.equal(got.isnan(), want.isnan()) and torch.equal(
        got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("b,f,m,v,d", [
    (8, 4, 1, 50, 16), (16, 26, 1, 200, 64), (8, 3, 4, 77, 32),
    (64, 5, 3, 1000, 7), (32, 2, 2, 300, 128)])
def test_embedding_bag_kernel_matches_plain(cuda, b, f, m, v, d):
    rng = np.random.default_rng(b + f + d)
    ids = rng.integers(-v, v, (b, f, m)).astype(np.int32)
    ids.reshape(-1)[:3] = [v, -v - 1, 2 ** 31 - 1]       # NaN bags
    ids_t = torch.from_numpy(ids).to(cuda)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)
                             ).to(cuda)
    before = embedding_bag.launches
    got = embedding_bag(ids_t, table, batch_tile=4)
    assert embedding_bag.launches == before + 1
    want = embedding_bag_plain(ids_t, table)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.shape == (b, f * d)
    assert _same(got, want)         # same rows summed in the same order


def test_embedding_bag_kernel_past_2_31_elements(cuda):
    # 2**25 + 4096 rows of 64: row * 64 passes 2**31 from row 2**25 on
    n_rows, d = 2 ** 25 + 4096, 64
    table = torch.randn((n_rows, d), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, n_rows, (256, 3, 2)).astype(np.int32)
    ids[0, :, 0] = [n_rows - 1, 2 ** 25, 2 ** 25 - 1]
    ids[1, :, 1] = [-1, -n_rows, n_rows - 4095]
    ids_t = torch.from_numpy(ids).to(cuda)
    assert int(ids.max()) * d >= 2 ** 31
    got = embedding_bag(ids_t, table)
    want = embedding_bag_plain(ids_t, table)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[0, :d], table[n_rows - 1] + table[int(ids[0, 0,
                                                                  1])])


def test_sddmm_kernel_matches_plain(cuda):
    for n, ny, e, d in [(40, 40, 256, 32), (17, 17, 100, 64),
                        (8, 8, 64, 128), (300, 11, 5000, 100),
                        (50, 60, 333, 7)]:
        rng = np.random.default_rng(e + d)
        src = rng.integers(-n, n, e).astype(np.int32)
        dst = rng.integers(0, ny, e).astype(np.int32)
        src[:2], dst[2] = [n, -n - 1], ny             # NaN scores
        x = rng.normal(size=(n, d)).astype(np.float32)
        y = rng.normal(size=(ny, d)).astype(np.float32)
        args = [torch.from_numpy(a).to(cuda) for a in (src, dst, x, y)]
        before = sddmm.launches
        got = edge_scores(*args, edge_block=64)
        assert sddmm.launches == before + 1
        want = sddmm_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == (e,) and torch.equal(got.isnan(), want.isnan())
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5,
                              equal_nan=True)


# B7's two paths: the grouping threshold (x bytes) at 0 groups every call,
# at its maximum none
sddmm_module = importlib.import_module("repro_torch.kernels.sddmm.sddmm")
SDDMM_PATHS = {"grouped": 0, "direct": 2 ** 63 - 1}


@pytest.fixture(params=sorted(SDDMM_PATHS))
def sddmm_path(request, cuda, monkeypatch):
    monkeypatch.setattr(sddmm_module, "GROUP_ABOVE_X_BYTES",
                        SDDMM_PATHS[request.param])
    return request.param


def _sddmm_args(n, ny, e, d, seed, dev, src=None):
    rng = np.random.default_rng(seed)
    if src is None:
        src = rng.integers(-n, n, e)
    dst = rng.integers(-ny, ny, e)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(ny, d)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        np.asarray(src, np.int32), dst.astype(np.int32), x, y)]


def _sddmm_vs_plain(args):
    before = sddmm.launches
    got = sddmm(*args, edge_block=1)
    assert sddmm.launches == before + (args[0].shape[0] > 0)
    want = sddmm_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got.isnan(), want.isnan())
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)
    return got


@pytest.mark.parametrize("d", [1, 3, 7, 64, 100, 128, 257])
def test_sddmm_paths_match_plain(sddmm_path, d):
    n, ny, e = 300, 170, 5000
    args = _sddmm_args(n, ny, e, d, d, "cuda")
    args[0][:3] = torch.tensor([n, -n - 1, 2 ** 31 - 1])     # NaN scores
    args[1][3:5] = torch.tensor([ny, -ny - 1])
    got = _sddmm_vs_plain(args)
    assert bool(got[:5].isnan().all()) and not bool(got[5:].isnan().any())


def test_sddmm_paths_empty_edge_list(sddmm_path):
    args = _sddmm_args(30, 20, 0, 16, 0, "cuda")
    before = sddmm.launches
    got = edge_scores(*args)
    assert got.shape == (0,) and sddmm.launches == before


def test_sddmm_paths_hub_source(sddmm_path):
    # 90% of the edges on one source: the hub spans many chunks of 512
    rng = np.random.default_rng(3)
    n, e = 1000, 20000
    src = np.where(rng.random(e) < 0.9, 7, rng.integers(0, n, e))
    _sddmm_vs_plain(_sddmm_args(n, 900, e, 100, 3, "cuda", src=src))


def test_sddmm_paths_sorted_sources(sddmm_path):
    rng = np.random.default_rng(4)
    n, e = 500, 12000
    src = np.sort(rng.integers(0, n, e))
    _sddmm_vs_plain(_sddmm_args(n, 700, e, 100, 4, "cuda", src=src))


@pytest.mark.parametrize("sources", ["spread", "gapped"])
def test_sddmm_grouped_scan_over_many_tiles(cuda, monkeypatch, sources):
    # 600,001 counters: 293 scan tiles, more than one pass of the single
    # block that scans the tile sums; "gapped" leaves ~600K empty groups
    # between the first 100 sources and the last
    monkeypatch.setattr(sddmm_module, "GROUP_ABOVE_X_BYTES", 0)
    rng = np.random.default_rng(5)
    n = 600_000
    low = n if sources == "spread" else 100
    src = np.concatenate([rng.integers(0, low, 150_000),
                          np.full(50_000, n - 1)])
    _sddmm_vs_plain(_sddmm_args(n, 1000, src.size, 4, 5, "cuda", src=src))


def test_sddmm_grouped_scratch_words(cuda):
    # csrc/sddmm.cu sizes the grouped path's scratch.  ogb_products at D =
    # 100 (8 lanes): a rank and a grouped dst per edge (61,859,140 each),
    # 2,449,030 group starts, scan tiles of 2048 (1196), chunks of 512
    # (120,819), buckets of 4096 slots (15,103): ~0.5 GB
    lib = build.load(sddmm_module.LIBRARY)

    def words(n_edges, nx, lanes):
        n = ctypes.c_int64(-1)
        err = lib.sddmm_grouped_scratch(n_edges, nx, lanes,
                                        ctypes.addressof(n))
        return err, n.value
    assert words(61_859_140, 2_449_029, 8) == (0, 126_304_428)
    assert 4 * 126_304_428 == 505_217_712
    assert words(0, 0, 1) == (0, 2)            # one start, one scan tile
    assert words(4097, 10, 32) == (0, 2 * 4097 + 11 + 1 + 33 + 2)
    assert words(10, 10, 3)[0] != 0            # lanes not a power of two


def test_sddmm_grouped_launch_rejects_short_scratch(cuda):
    lib = build.load(sddmm_module.LIBRARY)
    src, dst, x, y = _sddmm_args(40, 30, 256, 8, 6, cuda)
    out = torch.full((256,), 7.0, device=cuda)
    n = ctypes.c_int64()
    assert lib.sddmm_grouped_scratch(256, 40, 2, ctypes.addressof(n)) == 0
    scratch = torch.empty(n.value, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (src, dst, x, y, out)]
    assert lib.sddmm_grouped_launch(*ptrs, 256, 40, 30, 8, 4, 2,
                                    scratch.data_ptr(), n.value - 1,
                                    stream) != 0
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())            # nothing launched
    assert lib.sddmm_grouped_launch(*ptrs, 256, 40, 30, 8, 4, 2,
                                    scratch.data_ptr(), n.value, stream) == 0
    want = sddmm_plain(src, dst, x, y)
    torch.cuda.synchronize()
    assert torch.allclose(out, want, rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("d", [7, 64, 100])
def test_sddmm_scores_bitwise_stable(cuda, monkeypatch, d):
    # run to run, under a permutation of the edges, and across both paths
    args = _sddmm_args(400, 300, 9000, d, d + 1, cuda)
    args[0][:2] = torch.tensor([400, -401])
    perm = torch.from_numpy(np.random.default_rng(d).permutation(9000)).to(
        cuda)
    runs = {}
    for path, threshold in SDDMM_PATHS.items():
        monkeypatch.setattr(sddmm_module, "GROUP_ABOVE_X_BYTES", threshold)
        first = sddmm(*args, edge_block=1)
        assert _same(sddmm(*args, edge_block=1), first)
        permuted = sddmm(args[0][perm].contiguous(),
                         args[1][perm].contiguous(), *args[2:],
                         edge_block=1)
        back = torch.empty_like(permuted)
        back[perm] = permuted
        assert _same(back, first)
        runs[path] = first
    assert _same(runs["grouped"], runs["direct"])


@pytest.mark.parametrize("d", [4, 16, 64, 96, 128, 200])
@pytest.mark.parametrize("m", [1, 2, 4, 7])
def test_embedding_bag_lane_layouts_match_plain(cuda, d, m):
    rng = np.random.default_rng(d * 10 + m)
    v = 500
    ids = rng.integers(-v, v, (32, 3, m)).astype(np.int32)
    ids.reshape(-1)[:2] = [v, -v - 1]                    # NaN bags
    ids_t = torch.from_numpy(ids).to(cuda)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)
                             ).to(cuda)
    got = embedding_bag(ids_t, table)
    want = embedding_bag_plain(ids_t, table)
    torch.cuda.synchronize()
    assert _same(got, want)


@pytest.mark.parametrize("offset,vec", [(1, 1), (2, 2)])
def test_embedding_bag_unaligned_table_view(cuda, offset, vec):
    rng = np.random.default_rng(offset)
    v, d = 300, 64
    base = torch.from_numpy(rng.normal(size=v * d + 4).astype(np.float32)
                            ).to(cuda)
    table = base[offset:offset + v * d].view(v, d)
    assert lane_layout(d, table)[0] == vec
    ids_t = torch.from_numpy(rng.integers(0, v, (16, 5, 2)).astype(
        np.int32)).to(cuda)
    got = embedding_bag(ids_t, table)
    assert torch.equal(got, embedding_bag_plain(ids_t, table))
    assert torch.equal(got, embedding_bag(ids_t, table.clone()))


def test_embedding_bag_grid_strides_over_bags(cuda):
    # 212,992 bags: more than the fixed grid holds in one sweep
    rng = np.random.default_rng(9)
    ids_t = torch.from_numpy(rng.integers(0, 100_000, (8192, 26, 1)).astype(
        np.int32)).to(cuda)
    table = torch.randn((100_000, 64), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(9))
    got = embedding_bag(ids_t, table)
    assert torch.equal(got, embedding_bag_plain(ids_t, table))


@pytest.mark.parametrize("b,s,h,kv,hd", [
    (2, 128, 4, 2, 32), (1, 256, 2, 2, 64), (3, 64, 8, 1, 16),
    (1, 320, 4, 2, 128), (2, 96, 2, 1, 64)])       # 96: a ragged q/kv tile
def test_flash_attention_kernel_matches_plain(cuda, b, s, h, kv, hd):
    rng = np.random.default_rng(s + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, hd)).astype(
        np.float32)).to(cuda) for n in (h, kv, kv))
    before = flash_attention.launches
    got = mha_causal(q, k, v, block_q=32, block_k=32)
    assert flash_attention.launches == before + 1
    want = mha_causal(q, k, v, use_kernel=False)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (b, s, h, hd)
    assert float((got - want).abs().max()) <= 2e-5


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_attention_kernel_bf16(cuda, hd):
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 192, 2, hd)).astype(
        np.float32)).to(cuda).bfloat16() for _ in range(3))
    before = flash_attention.launches
    got = mha_causal(q, k, v, block_q=64, block_k=64)
    assert flash_attention.launches == before + 1
    want = mha_causal(q.float(), k.float(), v.float(), use_kernel=False)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want).abs().max()) <= 2e-2


def _flat_qkv(bh, s, d, seed, dev, dtype):
    """(BH, S, d) q, k, v drawn from a numpy seed, in ``dtype`` on ``dev``."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(bh, s, d)).astype(
        np.float32)).to(dev).to(dtype) for _ in range(3))


def _one_launch(q, k, v):
    before = flash_attention.launches
    out = flash_attention(q, k, v, block_q=32, block_k=32)   # divide S
    assert flash_attention.launches == before + 1
    return out


# S = 96, 192, 320: ragged 64- and 128-row tiles, and q tiles that are not
# the kv tiles (f32 pairs 128-row q tiles with 64-row kv tiles)
@pytest.mark.parametrize("s", [96, 192, 320])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_attention_f32_kernel_shapes(cuda, d, s):
    q, k, v = _flat_qkv(3, s, d, d + s, cuda, torch.float32)
    got = _one_launch(q, k, v)
    want = causal_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert float((got - want).abs().max()) <= 2e-5


@pytest.mark.parametrize("s", [96, 192, 320])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_attention_bf16_kernel_shapes(cuda, d, s):
    q, k, v = _flat_qkv(3, s, d, d + s, cuda, torch.bfloat16)
    got = _one_launch(q, k, v)
    want = causal_attention_plain(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert float((got.float() - want).abs().max()) <= 2e-2


def test_flash_attention_bf16_kernel_long_rows(cuda):
    # eight 128-key tiles per row at the last q tile: the ring wraps
    q, k, v = _flat_qkv(2, 1024, 128, 1024, cuda, torch.bfloat16)
    got = _one_launch(q, k, v)
    want = causal_attention_plain(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= 2e-2


def test_flash_attention_f32_kernel_ignores_tf32_flags(cuda):
    # the kernel's precision is its own: 3xTF32 whatever torch allows
    q, k, v = _flat_qkv(2, 320, 128, 7, cuda, torch.float32)
    want = causal_attention_plain(q, k, v)          # before the flag
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = _one_launch(q, k, v)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert float((got - want).abs().max()) <= 2e-5


def test_new_wrappers_raise_on_unsupported_dtypes(cuda):
    counts = lambda: (embedding_bag.launches, sddmm.launches,  # noqa: E731
                      flash_attention.launches)
    before = counts()
    ids = torch.zeros((8, 2, 1), dtype=torch.int32, device=cuda)
    table = torch.zeros((4, 16), device=cuda)
    with pytest.raises(TypeError):
        embedding_bag(ids, table.half())
    with pytest.raises(TypeError):
        embedding_bag(ids.long(), table)
    idx = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sddmm(idx, idx, table.double(), table.double(), edge_block=64)
    with pytest.raises(TypeError):
        sddmm(idx.long(), idx.long(), table, table, edge_block=64)
    q = torch.zeros((2, 64, 32), device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):                 # no d = 48 kernel
        flash_attention(*(torch.zeros((2, 64, 48), device=cuda),) * 3)
    assert counts() == before          # nothing launched, nothing fell back
