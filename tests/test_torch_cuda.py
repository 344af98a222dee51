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
from repro_torch.data.synthetic import cora_like
from repro_torch.kernels.forest_sampler import (MAX_HOPS, forest_sample,
                                                forest_sample_plain,
                                                hash_draws, hash_draws_plain)
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
from repro_torch.serve.device_sampler import pack_trees
from repro_torch.sparse import quantize as qz
from repro_torch.sparse import backend as sb
from repro_torch.sparse.graph import coo_to_csr, pack_dedup_chunks
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
    # bf16 tiles and f16/f64 x raise; a bf16 x launches the bf16 kernel
    u, rem, ptr, a, x = _args(16, 60, 8, seed=2, width_cap=128, dev=cuda)
    before = spmm_dedup_chunks.launches_bf16
    y = spmm_dedup_chunks(u, rem, ptr, a, x.to(torch.bfloat16), block_rows=8)
    assert y.dtype == torch.bfloat16 and y.device.type == "cuda"
    assert spmm_dedup_chunks.launches_bf16 == before + 1
    for bad in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            spmm_dedup_chunks(u, rem, ptr, a, x.to(bad), block_rows=8)
    with pytest.raises(TypeError):
        spmm_dedup_chunks(u, rem, ptr, a.to(torch.bfloat16),
                          x.to(torch.bfloat16), block_rows=8)


@pytest.mark.parametrize("n,e,d,width_cap", [
    (40, 300, 7, 128), (40, 300, 16, 128), (64, 900, 33, 8),
    (300, 2000, 602, 128), (300, 2000, 1433, 8), (200, 30, 16, 128)])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_spmm_bf16_kernel_equals_plain_bitwise(cuda, n, e, d, width_cap,
                                               offset):
    # bf16 x at every load width (offset views: 8-, 4- and 2-byte loads)
    # and with hub splits (width_cap 8): equal to the plain version, which
    # adds each chunk's exact products in the kernel's order and rounds as
    # it does, and to itself run to run
    u, rem, ptr, a, x = _args(n, e, d, seed=n + d + offset,
                              width_cap=width_cap, dev=cuda)
    xv = _offset_view(x.to(torch.bfloat16), offset)
    assert spmm_module.lane_layout(d, xv)[0] == (
        1 if d % 2 or offset % 2 else 2 if d % 4 or offset else 4)
    got = spmm_dedup_chunks(u, rem, ptr, a, xv, block_rows=8)
    want = spmm_dedup_chunks_plain(u, rem, ptr, a, xv, block_rows=8)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert torch.equal(got, spmm_dedup_chunks(u, rem, ptr, a, xv,
                                              block_rows=8))


@pytest.mark.parametrize("d,width_cap", [(7, 128), (64, 8), (1433, 128)])
def test_spmm_bf16_bitwise_across_stripes_and_blocks_per_cta(
        cuda, monkeypatch, d, width_cap):
    u, rem, ptr, a, x = _args(400, 3000, d, seed=d, width_cap=width_cap,
                              dev=cuda)
    x16 = x.to(torch.bfloat16)
    first = spmm_dedup_chunks(u, rem, ptr, a, x16, block_rows=8)
    for max_lanes, per_cta in ((32, 1), (4, 16), (256, 16), (8, 1)):
        monkeypatch.setattr(spmm_module, "MAX_LANES", max_lanes)
        monkeypatch.setattr(spmm_module, "BLOCKS_PER_CTA", per_cta)
        assert torch.equal(spmm_dedup_chunks(u, rem, ptr, a, x16,
                                             block_rows=8), first)


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


def _forest_graph(name):
    """Phase 2's forest_sample graphs (the minibatch_lg one cut to ~10⁶
    edges): (indptr, indices) as int64 numpy arrays."""
    if name == "cora":
        s, r, _, _, _ = cora_like(seed=0)
        indptr, indices, _ = coo_to_csr(s, r, 2708)
    elif name == "isolated":
        # every fifth row empty, and the last (the end-of-CSR corner)
        s, r, _, _, _ = cora_like(seed=0)
        keep = (r % 5 != 0) & (r != 2707)
        indptr, indices, _ = coo_to_csr(s[keep], r[keep], 2708)
    else:                                     # minibatch_lg, cut
        rng = np.random.default_rng(19)
        n, e = 23_296, 1_146_158
        w = (1 - rng.random(n)) ** -0.5
        deg = np.floor(w * (e / w.sum())).astype(np.int64)
        deg[rng.permutation(n)[:e - deg.sum()]] += 1
        indptr = np.concatenate([[0], np.cumsum(deg)])
        indices = rng.integers(0, n, e)
    return np.asarray(indptr, np.int64), np.asarray(indices, np.int64)


@pytest.mark.parametrize("graph,n_trees,n_live,fanouts", [
    ("cora", 1, 1, (5, 3)), ("cora", 16, 16, (5, 3)),
    ("cora", 16, 5, (5, 3)), ("isolated", 16, 16, (5, 3)),
    ("cora", 16, 16, (2, 2, 2)), ("minibatch_lg", 1024, 1024, (15, 10)),
    ("cora", 7, 7, (2, 2, 2, 2, 2, 2)), ("cora", 300, 250, (3,))])
def test_forest_sample_kernel_equals_plain(cuda, graph, n_trees, n_live,
                                          fanouts):
    indptr, indices = _forest_graph(graph)
    rng = np.random.default_rng(n_trees + n_live)
    seeds = rng.integers(0, indptr.shape[0] - 1, n_trees)
    seeds[:2] = [0, indptr.shape[0] - 2][:n_trees]
    live = np.arange(n_trees) < n_live
    tkm = rng.integers(-2 ** 63, 2 ** 63, n_trees, dtype=np.int64)
    args = (torch.from_numpy(indptr).to(cuda),
            torch.from_numpy(indices).to(cuda),
            torch.from_numpy(pack_trees(seeds, tkm, live)).to(cuda), fanouts,
            int(_mix64(rng.integers(0, 2 ** 62, dtype=np.uint64))))
    before = forest_sample.launches
    got = forest_sample(*args)
    assert forest_sample.launches == before + 1
    want = forest_sample_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[0][:n_trees][~torch.from_numpy(live).to(cuda)] == -1).all()
    host = forest_sample_plain(*(a.cpu() if torch.is_tensor(a) else a
                                 for a in args))
    assert torch.equal(got[0].cpu(), host[0])
    assert torch.equal(got[1].cpu(), host[1])


def test_forest_sample_edgeless_graph_reads_no_indices(cuda):
    indptr = torch.zeros(33, dtype=torch.int64, device=cuda)
    indices = torch.zeros(0, dtype=torch.int64, device=cuda)
    trees = torch.from_numpy(pack_trees([0, 7, 32], [1, 2, 3],
                                        [1, 1, 0])).to(cuda)
    got = forest_sample(indptr, indices, trees, (3, 2), 5)
    want = forest_sample_plain(indptr, indices, trees, (3, 2), 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not got[1].any()


def test_forest_sample_wrapper_raises_on_the_card(cuda):
    indptr = torch.tensor([0, 1, 2], dtype=torch.int64, device=cuda)
    indices = torch.tensor([1, 0], dtype=torch.int64, device=cuda)
    trees = torch.from_numpy(pack_trees([0, 1], [5, 6], [1, 1])).to(cuda)
    with pytest.raises(TypeError):
        forest_sample(indptr, indices.int(), trees, (2,), 0)
    with pytest.raises(ValueError, match="contiguous"):
        forest_sample(indptr, indices, trees.t().contiguous().t(), (2,), 0)
    with pytest.raises(ValueError, match="indptr on cpu"):
        forest_sample(indptr.cpu(), indices, trees, (2,), 0)
    with pytest.raises(ValueError, match="hops"):
        forest_sample(indptr, indices, trees, (1,) * (MAX_HOPS + 1), 0)


def test_device_sampled_step_launches_forest_sample_once(cuda):
    from repro_torch.configs.gcn_cora import reduced
    from repro_torch.models.gnn import gcn
    from repro_torch.serve import FeatureStore, GNNServer, offline_replay
    indptr, indices = _forest_graph("cora")
    cfg = reduced()
    x = np.random.default_rng(1).normal(size=(2708, cfg.d_in)).astype(
        np.float32)
    params = gcn.init_params(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    store = FeatureStore.build(2708, x, device=cuda)
    with GNNServer("gcn", cfg, params, indptr, indices, store,
                   fanouts=(5, 3), backend="cuda", sampler="device",
                   max_batch_seeds=16, device=cuda) as server:
        server.warmup()
        forest_sample.launches = hash_draws.launches = 0
        reqs = [server.submit([int(s)]) for s in range(0, 2708, 97)]
        server.drain()
        assert forest_sample.launches == server.stats()["n_batches"] > 0
        assert hash_draws.launches == 0
        for req in reqs:
            assert np.abs(req.result - offline_replay(server, req)).max() \
                <= 1e-5


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


# ---------------------------------------------------------------------------
# the training Functions: B1 again on the transpose layout for dX
# ---------------------------------------------------------------------------

def _grad_plans(name, dev):
    """(card plan, CPU plan, x rows) at Cora scale (sym-normed, self loops)
    or at a plan whose hub row is split across many chunks."""
    from repro_torch.sparse.graph import sym_norm_weights
    if name == "cora":
        s, r, _, _, _ = cora_like(seed=0)
        s, r, w = sym_norm_weights(s, r, 2708)
        n, cap = 2709, 128
    else:
        rng = np.random.default_rng(11)
        n, e, cap = 300, 3000, 16
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        r[:1000] = 3
        s[1000:1400] = 5                    # and a hub column
        w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    kw = dict(edge_weight=w, backends=("cuda", "cuda_q8"), width_cap=cap)
    return (make_plan(s, r, n, device=dev, **kw),
            make_plan(s, r, n, device="cpu", **kw), n)


def _function_grads(plan, x, dy, q8):
    """(y, dA, dX) of the Function on the plan's own tiles."""
    from repro_torch.kernels.gustavson_spmm.ops import (spmm_dedup_grad,
                                                        spmm_dedup_grad_q8)
    a = plan.ell_a.clone().requires_grad_()
    xx = x.clone().requires_grad_()
    args = (plan.ell_u_cols, plan.ell_remaining, plan.ell_block_ptr,
            plan.ell_out_block, a, plan.ell_t_u_cols, plan.ell_t_remaining,
            plan.ell_t_block_ptr, plan.ell_t_a, xx)
    if q8:
        y = spmm_dedup_grad_q8(*args, a_q8=plan.ell_a_q8,
                               a_scale=plan.ell_a_scale, block_rows=8)
    else:
        y = spmm_dedup_grad(*args, block_rows=8)
    da, dx = torch.autograd.grad(y, (a, xx), dy)
    return y.detach(), da, dx


@pytest.mark.parametrize("graph", ["cora", "hub"])
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("d", [7, 16])
def test_function_backward_matches_plain(cuda, graph, q8, d):
    """y, dX (B1 on the transpose layout) and dA of each Function on the
    card equal the same Function on the CPU, the plain versions (≤1e-5);
    dX and dA are bitwise equal run to run; the backward launches B1 once
    and nothing falls back."""
    plan, cpu_plan, n = _grad_plans(graph, cuda)
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(plan.n_blocks * 8, d)).astype(
        np.float32))
    b1, b4 = spmm_dedup_chunks.launches, spmm_dedup_chunks_q8.launches
    y, da, dx = _function_grads(plan, x.to(cuda), dy.to(cuda), q8)
    torch.cuda.synchronize()
    assert spmm_dedup_chunks.launches - b1 == (1 if q8 else 2)
    assert spmm_dedup_chunks_q8.launches - b4 == (1 if q8 else 0)
    y_c, da_c, dx_c = _function_grads(cpu_plan, x, dy, q8)
    assert float((y.cpu() - y_c).abs().max()) <= 1e-5
    assert float((dx.cpu() - dx_c).abs().max()) <= 1e-5
    assert float((da.cpu() - da_c).abs().max()) <= 1e-5
    _, da2, dx2 = _function_grads(plan, x.to(cuda), dy.to(cuda), q8)
    assert torch.equal(dx, dx2) and torch.equal(da, da2)


@pytest.mark.parametrize("graph", ["cora", "hub"])
@pytest.mark.parametrize("backend", ["cuda", "cuda_q8"])
def test_executor_value_gradients_match_cpu(cuda, graph, backend):
    """Traced edge values through the executors: dX and d(vals) on the
    card equal the CPU's (≤1e-5), and two runs on the card are bitwise
    equal: the tiles come from the plan's order-fixed scatter (repeated
    edges share cells in both graphs' plans)."""
    plan, cpu_plan, n = _grad_plans(graph, cuda)
    assert plan.ell_first_slots is not None
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    vals = cpu_plan.base_vals.clone()
    out = []
    for p, dev in ((plan, cuda), (plan, cuda),
                   (cpu_plan, torch.device("cpu"))):
        xx = x.to(dev).requires_grad_()
        vv = vals.to(dev).requires_grad_()
        y = sb.aggregate(p, vv, xx, backend=backend)
        out.append([y.detach().cpu()] + [
            t.cpu() for t in torch.autograd.grad(y, (xx, vv), dy.to(dev))])
    for a, b in zip(out[0], out[1]):
        assert torch.equal(a, b)
    for got, want in zip(out[0], out[2]):
        assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("graph", ["cora", "hub"])
@pytest.mark.parametrize("backend", ["dense", "chunked"])
def test_ordered_executors_bitwise_run_to_run(cuda, graph, backend):
    """``dense`` and ``chunked`` on the orders the plan keeps: y, dX and
    d(vals) bitwise equal run to run and within 1e-5 of the CPU's; the
    second run builds no order."""
    plan, cpu_plan, n = _grad_plans(graph, cuda)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    vals = cpu_plan.base_vals.clone()
    out, n_orders = [], []
    for p, dev in ((plan, cuda), (plan, cuda),
                   (cpu_plan, torch.device("cpu"))):
        xx = x.to(dev).requires_grad_()
        vv = vals.to(dev).requires_grad_()
        y = sb.aggregate(p, vv, xx, backend=backend)
        out.append([y.detach().cpu()] + [
            t.cpu() for t in torch.autograd.grad(y, (xx, vv), dy.to(dev))])
        n_orders.append(len(p.orders))
    assert n_orders[0] == n_orders[1] > 0
    for a, b in zip(out[0], out[1]):
        assert torch.equal(a, b)
    for got, want in zip(out[0], out[2]):
        assert float((got - want).abs().max()) <= 1e-5


def test_function_backward_takes_any_grad_output(cuda):
    """A non-contiguous, an unaligned and a sliced ``grad_output`` give the
    same dX as a fresh contiguous one: the backward makes it contiguous
    and B1's load width follows the pointer's alignment."""
    plan, _, n = _grad_plans("cora", cuda)
    rng = np.random.default_rng(5)
    d = 16
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)
                         ).to(cuda).requires_grad_()
    dy = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)
                          ).to(cuda)
    y = sb.aggregate(plan, None, x, backend="cuda")
    want = torch.autograd.grad(y, x, dy, retain_graph=True)[0]
    transposed = dy.t().contiguous().t()                 # stride (1, n)
    unaligned = torch.empty(n * d + 1, device=cuda)[1:].view(n, d)
    unaligned.copy_(dy)
    for g in (transposed, unaligned):
        assert torch.equal(torch.autograd.grad(y, x, g,
                                               retain_graph=True)[0], want)
    # the loss read through a view of y[:n_rows]: slice_backward's zeros
    w = torch.from_numpy(rng.normal(size=(n - 9, d)).astype(np.float32)
                         ).to(cuda)
    got = torch.autograd.grad((y[: n - 9] * w).sum(), x)[0]
    dy_cut = torch.zeros_like(dy)
    dy_cut[: n - 9] = w
    y = sb.aggregate(plan, None, x, backend="cuda")
    assert torch.equal(got, torch.autograd.grad(y, x, dy_cut)[0])


def test_cuda_training_step_matches_dense(cuda, monkeypatch):
    """gcn-cora at full width: one training step through ``cuda`` and
    ``dense`` on the card, the loss (≤1e-4) and every gradient (rtol 1e-3,
    atol 1e-4), with 4 B1 launches (2 forward, 2 backward)."""
    from repro_torch.configs import registry
    from repro_torch.launch.train import _gnn_setup
    from repro_torch.optim import adamw
    cfg = registry.get_config("gcn-cora")
    grads = {}
    apply = adamw.apply_updates

    def spy(params, g, state, opt_cfg):
        grads[len(grads)] = g
        return apply(params, g, state, opt_cfg)
    monkeypatch.setattr(adamw, "apply_updates", spy)
    out = {}
    for backend in ("dense", "cuda"):
        params, step, batches = _gnn_setup("gcn-cora", cfg, 0,
                                           backend=backend, device=cuda)
        before = spmm_dedup_chunks.launches
        _, _, m = step(params, adamw.init_state(params), next(batches))
        torch.cuda.synchronize()
        out[backend] = (float(m["loss"]), grads[len(grads) - 1],
                        spmm_dedup_chunks.launches - before)
    assert out["cuda"][2] == 4 and out["dense"][2] == 0
    assert abs(out["cuda"][0] - out["dense"][0]) <= 1e-4
    for layer, p in out["cuda"][1].items():
        for k, g in p.items():
            want = out["dense"][1][layer][k]
            torch.testing.assert_close(g, want, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# order-fixed sums: segment ops, tile scatter, GAT/GIN, the DLRM lookup
# ---------------------------------------------------------------------------

def _twice_and_cpu(fn, dev):
    """fn(device) → list of tensors, run twice on the card and once on the
    CPU: (first card run, second card run, CPU run), all on the CPU."""
    runs = [[t.detach().cpu() for t in fn(d)]
            for d in (dev, dev, torch.device("cpu"))]
    torch.cuda.synchronize()
    return runs


@pytest.mark.parametrize("op", ["segment_sum", "segment_max",
                                "segment_mean", "segment_softmax"])
def test_segment_ops_bitwise_run_to_run(cuda, op):
    """Each op and its gradient on the card: bitwise run to run, and equal
    to the CPU's within 1e-6 (sums of 4,000 entries into 50 segments)."""
    from repro_torch.sparse import segment_ops as so
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 51, 4000)                    # 50: dropped
    x = rng.normal(size=(4000, 8)).astype(np.float32)
    c = rng.normal(size=(4000, 8)).astype(np.float32)

    def run(dev):
        xx = torch.from_numpy(x).to(dev).requires_grad_()
        y = getattr(so, op)(xx, torch.from_numpy(ids).to(dev), 50)
        cc = torch.from_numpy(c).to(dev)[: y.shape[0]]
        (g,) = torch.autograd.grad((y * cc).sum(), xx)
        return y, g
    a, b, cpu = _twice_and_cpu(run, cuda)
    for u, v, w in zip(a, b, cpu):
        assert torch.equal(u, v)
        torch.testing.assert_close(u, w, rtol=1e-5, atol=1e-6)


def test_tile_scatter_equals_cpu_bitwise(cuda):
    """The layered scatter adds a shared cell's values in edge order on the
    card too: the forward and transpose tiles equal the CPU's bit for bit
    at the Cora-scale plan (99 repeated pairs, up to 3 edges a cell)."""
    from repro_torch.sparse.plan import forward_tiles, transpose_tiles
    s, r, _, _, _ = cora_like(seed=0)
    plans = [make_plan(s, r, 2709, backends=("cuda",), device=d)
             for d in (cuda, "cpu")]
    assert len(plans[0].ell_dup_bounds) == 2
    v = torch.from_numpy(np.random.default_rng(1).normal(
        size=s.shape[0]).astype(np.float32))
    for build in (forward_tiles, transpose_tiles):
        got = build(plans[0], v.to(cuda)).cpu()
        assert torch.equal(got, build(plans[1], v))


def _gnn_batch(arch, dev):
    """(model, cfg, params, loss closure) at small widths on the Cora-scale
    graph (GAT; repeated edges) or a molecule batch (GIN)."""
    from repro_torch.data.synthetic import molecule_batch
    from repro_torch.models.gnn import gat, gin
    gen = torch.Generator().manual_seed(0)
    if arch == "gat":
        s, r, x, y, _ = cora_like(seed=0)
        cfg = gat.GATConfig(d_in=1433, d_hidden=8, n_heads=4, n_classes=7)
        x = np.vstack([x, np.zeros((1, 1433), np.float32)])
        params = gat.init_params(cfg, gen, dev)
        n = 2708
        extra = dict(labels=torch.from_numpy(np.append(y, 0)).to(dev),
                     mask=(torch.arange(n + 1) < 140).to(dev))
    else:
        _, _, snd, rcv, _, _ = molecule_batch(32, seed=0)
        offs = (np.arange(32) * 30)[:, None]
        s, r = (snd + offs).ravel(), (rcv + offs).ravel()
        n = 32 * 30
        rng = np.random.default_rng(3)
        x = np.vstack([rng.normal(size=(n, 64)),
                       np.zeros((1, 64))]).astype(np.float32)
        cfg = gin.GINConfig()
        params = gin.init_params(cfg, gen, dev)
        gid = np.append(np.repeat(np.arange(32), 30), 32)
        extra = dict(gid=torch.from_numpy(gid).to(dev),
                     labels=torch.from_numpy(rng.integers(0, 4, 32)).to(dev))
    return s, r, n, torch.from_numpy(x).to(dev), cfg, params, extra


@pytest.mark.parametrize("arch", ["gat", "gin"])
@pytest.mark.parametrize("backend", ["dense", "cuda", "cuda_q8"])
def test_gnn_loss_gradients_bitwise_run_to_run(cuda, arch, backend):
    """GAT's traced-value aggregations (one per head) and GIN's sum
    aggregations with its readout: the loss and every gradient bitwise
    equal run to run on the card; against the CPU the loss within 1e-5
    (f32; the int8 path within ``Q8_E2E_TOL``), relative past 1, and the
    f32 gradients within rtol 1e-4, atol 1e-5."""
    from repro_torch import tree
    from repro_torch.models.gnn import gat, gin
    from repro_torch.sparse.quantize import Q8_E2E_TOL

    def run(dev):
        s, r, n, x, cfg, params, extra = _gnn_batch(arch, dev)
        plan = make_plan(s, r, n + 1, backends=("dense", "chunked", "cuda",
                                                "cuda_q8"), device=dev)
        leaves, structure = tree.flatten(params)
        live = [t.requires_grad_() for t in leaves]
        p = tree.unflatten(structure, live)
        if arch == "gat":
            loss = gat.loss_fn(p, cfg, x, None, None, None, extra["labels"],
                               extra["mask"], backend=backend, plan=plan)
        else:
            loss = gin.loss_fn(p, cfg, x, None, None, None, extra["gid"], 32,
                               extra["labels"], backend=backend, plan=plan)
        return [loss] + list(torch.autograd.grad(loss, live,
                                                 materialize_grads=True))
    a, b, cpu = _twice_and_cpu(run, cuda)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    tol = Q8_E2E_TOL if backend == "cuda_q8" else 1e-5
    assert abs(float(a[0]) - float(cpu[0])) <= tol * max(1.0, abs(float(
        cpu[0])))
    if backend != "cuda_q8":
        for u, w in zip(a[1:], cpu[1:]):
            torch.testing.assert_close(u, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("m", [1, 4])
def test_trainable_lookup_bitwise_run_to_run(cuda, m):
    """The lookup's Function: forward equal to B6's plain version, the
    table gradient (power-law ids: repeats) bitwise run to run and equal
    to the CPU's within 1e-6, one B6 launch a forward."""
    from repro_torch.kernels.embedding_bag.ops import lookup
    rng = np.random.default_rng(4)
    v, d, b, f = 5000, 64, 4096, 8
    ids = np.minimum((v * rng.random((b, f, m)) ** 3).astype(np.int32),
                     v - 1)
    table = rng.normal(size=(v, d)).astype(np.float32)
    c = rng.normal(size=(b, f, d)).astype(np.float32)

    def run(dev):
        t = torch.from_numpy(table).to(dev).requires_grad_()
        before = embedding_bag.launches
        out = lookup(torch.from_numpy(ids).to(dev), t)
        assert embedding_bag.launches == before + (dev.type == "cuda")
        (g,) = torch.autograd.grad(
            (out * torch.from_numpy(c).to(dev)).sum(), t)
        return out, g
    a, b2, cpu = _twice_and_cpu(run, cuda)
    for u, w in zip(a, b2):
        assert torch.equal(u, w)
    assert torch.equal(a[0], embedding_bag_plain(
        torch.from_numpy(ids), torch.from_numpy(table)).reshape(b, f, d))
    torch.testing.assert_close(a[1], cpu[1], rtol=1e-5, atol=1e-6)


def test_dlrm_training_step_bitwise_run_to_run(cuda):
    """Two steps of ``build_recsys_step("train")`` at dlrm-rm2's widths
    (vocabularies cut to ≤ 20,000 rows), batch 4,096: bitwise run to run on
    the card, one B6 launch a step, the loss within 1e-4 of the CPU's."""
    import dataclasses as dc
    from repro_torch.configs import dlrm_rm2
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.data.synthetic import dlrm_batch
    from repro_torch.launch.steps import build_recsys_step
    from repro_torch.models.recsys import dlrm
    from repro_torch.optim import adamw
    cfg = dc.replace(dlrm_rm2.FULL, vocab_sizes=tuple(
        min(v, 20_000) for v in dlrm_rm2.FULL.vocab_sizes))

    def run(dev):
        params = dlrm.init_params(cfg, torch.Generator().manual_seed(0), dev)
        step = build_recsys_step(cfg, RECSYS_SHAPES["train_batch"],
                                 adamw.AdamWConfig(lr=1e-3))
        opt, losses = adamw.init_state(params), []
        for i in range(2):
            dn, ids, y = dlrm_batch(4096, cfg.n_dense, cfg.vocab_sizes,
                                    seed=i)
            before = embedding_bag.launches
            params, opt, met = step(params, opt, {
                "dense": torch.from_numpy(dn).to(dev),
                "sparse_ids": torch.from_numpy(ids).to(dev),
                "labels": torch.from_numpy(y).to(dev)})
            assert embedding_bag.launches == before + (dev.type == "cuda")
            losses.append(met["loss"])
        return losses + [params["table"], params["top"]["w0"]]
    a, b, cpu = _twice_and_cpu(run, cuda)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    for u, w in zip(a[:2], cpu[:2]):
        assert abs(float(u) - float(w)) <= 1e-4


# ---------------------------------------------------------------------------
# the cluster's lane-stacked round: B1 on the stacked plan, lane-scaled B4
# ---------------------------------------------------------------------------

def _lane_case(cuda, backend, n_lanes, d, bucket=4, seed=0):
    """A stack of ``n_lanes`` bucket plans re-valued with each lane's own
    weights and validity, its x with the lanes at very different
    magnitudes, and each lane's single-lane plan and x."""
    from repro_torch.serve import compute as tcompute
    from repro_torch.serve.buckets import build_bucket_structure
    from repro_torch.sparse.plan import plan_with_values
    struct = build_bucket_structure(bucket, (5, 3), with_loops=True)
    pl = tcompute.bucket_plan(struct, backend, True, cuda, n_lanes)
    p1 = tcompute.bucket_plan(struct, backend, True, cuda)
    rng = np.random.default_rng(seed)
    n, rows = struct.n_nodes, pl.lane_rows or struct.n_nodes
    lanes = []
    x = torch.zeros(n_lanes * rows, d, device=cuda)
    for lane in range(n_lanes):
        w = torch.from_numpy(rng.uniform(0.1, 1, struct.n_edges).astype(
            np.float32)).to(cuda)
        v = torch.from_numpy(rng.random(struct.n_edges) < 0.8).to(cuda)
        xl = torch.from_numpy((rng.normal(size=(n, d)) * 4.0 ** lane).astype(
            np.float32)).to(cuda)
        x[lane * rows:lane * rows + n] = xl
        lanes.append((plan_with_values(p1, edge_weight=w, edge_valid=v), xl,
                      w, v))
    pl = plan_with_values(pl, edge_weight=torch.cat([c[2] for c in lanes]),
                          edge_valid=torch.cat([c[3] for c in lanes]))
    return pl, x, lanes, n, rows


@pytest.mark.parametrize("n_lanes", [1, 2, 4])
@pytest.mark.parametrize("d", [7, 16, 1433])
def test_stacked_b1_plan_bitwise_per_lane(cuda, n_lanes, d):
    pl, x, lanes, n, rows = _lane_case(cuda, "cuda", n_lanes, d)
    args = (pl.ell_u_cols, pl.ell_remaining, pl.ell_block_ptr, pl.ell_a, x)
    y = spmm_dedup_chunks(*args, block_rows=8)
    torch.cuda.synchronize()
    assert float((y - spmm_dedup_chunks_plain(*args, block_rows=8)).abs()
                 .max()) <= 1e-5 * max(1.0, float(x.abs().max()))
    assert torch.equal(y, spmm_dedup_chunks(*args, block_rows=8))
    for lane, (p1, xl, _, _) in enumerate(lanes):
        y1 = spmm_dedup_chunks(p1.ell_u_cols, p1.ell_remaining,
                               p1.ell_block_ptr, p1.ell_a, xl, block_rows=8)
        assert torch.equal(y[lane * rows:lane * rows + n], y1[:n]), lane


@pytest.mark.parametrize("n_lanes", [1, 2, 4])
@pytest.mark.parametrize("d", [7, 16, 1433])
def test_lane_scaled_b4_bitwise_plain_and_per_lane(cuda, n_lanes, d):
    pl, x, lanes, n, rows = _lane_case(cuda, "cuda_q8", n_lanes, d)
    qt = auto_d_tile(d)
    x_q8, x_scale = qz.quantize_feature_tiles(x, qt, n_lanes, rows, n)
    args = (pl.ell_u_cols, pl.ell_remaining, pl.ell_block_ptr, pl.ell_a_q8,
            pl.ell_a_scale, x_q8, x_scale)
    before = (spmm_dedup_chunks_q8.launches,
              spmm_dedup_chunks_q8.launches_lanes)
    y = spmm_dedup_chunks_q8(*args, block_rows=8, q_tile=qt)
    assert (spmm_dedup_chunks_q8.launches,
            spmm_dedup_chunks_q8.launches_lanes) == (
        before[0] + 1, before[1] + (n_lanes > 1))
    assert torch.equal(y, spmm_dedup_chunks_q8_plain(*args, block_rows=8,
                                                     q_tile=qt))
    assert torch.equal(y, spmm_dedup_chunks_q8(*args, block_rows=8,
                                               q_tile=qt))
    for lane, (p1, xl, _, _) in enumerate(lanes):
        q, s = qz.quantize_feature_tiles(xl, qt)
        y1 = spmm_dedup_chunks_q8(p1.ell_u_cols, p1.ell_remaining,
                                  p1.ell_block_ptr, p1.ell_a_q8,
                                  p1.ell_a_scale, q, s, block_rows=8,
                                  q_tile=qt)
        assert torch.equal(y[lane * rows:lane * rows + n], y1[:n]), lane
    # the executor on the stacked plan quantizes lane by lane the same way
    got = sb.aggregate(pl, None, x, backend="cuda_q8")
    assert torch.equal(got, y[:pl.n_rows])


@pytest.mark.parametrize("d", [7, 16, 600])
def test_b4_one_lane_path_unchanged(cuda, d):
    """One row of lane scales over every block is the 1-D call, bit for
    bit, and both equal the plain version."""
    u, rem, ptr, a, sa, x, sx = _q8_args(300, 2000, d, seed=d,
                                         width_cap=128, dev=cuda)
    qt = auto_d_tile(d)
    want = spmm_dedup_chunks_q8(u, rem, ptr, a, sa, x, sx, block_rows=8)
    got = spmm_dedup_chunks_q8(u, rem, ptr, a, sa, x, sx[None].contiguous(),
                               block_rows=8)
    assert torch.equal(got, want)
    assert torch.equal(want, spmm_dedup_chunks_q8_plain(
        u, rem, ptr, a, sa, x, sx, block_rows=8, q_tile=qt))
    # three rows of scales do not split its 38 blocks into equal runs
    assert (ptr.shape[0] - 1) % 3
    with pytest.raises(ValueError, match="equal runs"):
        spmm_dedup_chunks_q8(u, rem, ptr, a, sa, x,
                             sx[None].repeat(3, 1).contiguous(),
                             block_rows=8)


@pytest.mark.parametrize("backend,kernel", [("cuda", "spmm_dedup_chunks"),
                                            ("cuda_q8",
                                             "spmm_dedup_chunks_q8")])
def test_lane_step_launches_one_kernel_a_layer_for_all_lanes(cuda, backend,
                                                             kernel):
    from repro_torch.launch.gnn_serve import build_world
    from repro_torch.serve import compute as tcompute
    from repro_torch.serve.buckets import build_bucket_structure
    cfg, params, indptr, indices, store = build_world(256, 1024, 16, 0,
                                                      cuda)
    struct = build_bucket_structure(4, (3, 2), with_loops=True)
    step = tcompute.build_lane_infer_step("gcn", cfg, struct,
                                          backend=backend)
    fetch = tcompute.build_fetch_step(store)
    counter = {"spmm_dedup_chunks": spmm_dedup_chunks,
               "spmm_dedup_chunks_q8": spmm_dedup_chunks_q8}[kernel]
    for n_lanes in (1, 4):
        node_ids = np.random.default_rng(n_lanes).integers(
            -1, 256, (n_lanes, struct.n_nodes))
        hop_valid = node_ids[:, :struct.n_hop_edges] >= 0
        x = fetch(node_ids)
        step(params, x, node_ids, hop_valid)          # builds the plan
        before = counter.launches
        out = step(params, x, node_ids, hop_valid)
        torch.cuda.synchronize()
        assert out.shape == (n_lanes, 4, cfg.n_classes)
        assert counter.launches - before == cfg.n_layers


# ---------------------------------------------------------------------------
# Incremental plans (sparse.delta) on the card
# ---------------------------------------------------------------------------

def _mutated_delta(n, e, seed, width_cap=128, epochs=3):
    from repro_torch.sparse.delta import DeltaGraphError, DeltaGraphState
    rng = np.random.default_rng(seed)
    d = DeltaGraphState(rng.integers(0, n, e), rng.integers(0, n, e), n,
                        weights=rng.uniform(0.1, 1, e).astype(np.float32),
                        width_cap=width_cap)
    for _ in range(epochs):
        for _ in range(48):
            d.insert_edge(int(rng.integers(0, n)), int(rng.integers(0, n)),
                          float(rng.uniform(0.1, 1)))
        for _ in range(16):
            k = int(rng.integers(0, d.n_edges))
            try:
                d.delete_edge(int(d._s[k]), int(d._r[k]))
            except DeltaGraphError:
                pass
        d.flush()
    return d


@pytest.mark.parametrize("n,e,d,width_cap", [(300, 2000, 16, 128),
                                             (300, 2000, 600, 128),
                                             (64, 900, 33, 8)])
def test_incremental_plan_b1_b4_equal_cold_plan(cuda, n, e, d, width_cap):
    from repro_torch.sparse.delta import plans_match
    dl = _mutated_delta(n, e, seed=n + d, width_cap=width_cap)
    backends = ("dense", "cuda", "cuda_q8")
    inc = dl.plan(backends=backends, device=cuda)
    cold = dl.cold_plan(backends=backends, device=cuda)
    ok, detail = plans_match(inc, cold, tol=0.0)
    assert ok, detail
    x = torch.from_numpy(np.random.default_rng(d).normal(
        size=(inc.n_rows, d)).astype(np.float32)).to(cuda)

    def b1(p):
        return spmm_dedup_chunks(p.ell_u_cols, p.ell_remaining,
                                 p.ell_block_ptr, p.ell_a, x, block_rows=8)
    qt = auto_d_tile(d)
    x_q8, x_scale = qz.quantize_feature_tiles(x, qt)

    def b4(p):
        return spmm_dedup_chunks_q8(p.ell_u_cols, p.ell_remaining,
                                    p.ell_block_ptr, p.ell_a_q8,
                                    p.ell_a_scale, x_q8, x_scale,
                                    block_rows=8, q_tile=qt)
    assert torch.equal(b1(inc), b1(cold))
    assert torch.equal(b4(inc), b4(cold))
    want = spmm_dedup_chunks_plain(inc.ell_u_cols, inc.ell_remaining,
                                   inc.ell_block_ptr, inc.ell_a, x,
                                   block_rows=8)
    assert float((b1(inc) - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("backend", ["cuda", "cuda_q8"])
def test_incremental_plan_gcn_forward_equals_cold(cuda, backend):
    from repro_torch.configs.gcn_cora import GCNConfig
    from repro_torch.models.gnn import gcn
    dl = _mutated_delta(500, 3000, seed=7)
    cfg = GCNConfig(d_in=32, d_hidden=16, n_classes=7)
    params = gcn.init_params(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(501, 32)).astype(np.float32)).to(cuda)
    backends = ("dense", "cuda", "cuda_q8")
    ys = [gcn.forward(params, cfg, x, backend=backend, plan=p)
          for p in (dl.plan(backends=backends, device=cuda),
                    dl.cold_plan(backends=backends, device=cuda))]
    assert ys[0].device.type == "cuda"
    assert torch.equal(ys[0], ys[1])


# ---------------------------------------------------------------------------
# the LM family on the card
# ---------------------------------------------------------------------------

LM_ARCHS = ("llama4-maverick-400b-a17b", "grok-1-314b", "gemma-7b",
            "qwen3-0.6b", "deepseek-67b")
LM_TOL = 1e-4


def _lm_on(params, dev):
    from repro_torch import tree
    leaves, structure = tree.flatten(params)
    return tree.unflatten(structure, [t.to(dev) for t in leaves])


def _lm_case(arch, dev):
    """(cfg, CPU params, card params, CPU tokens, the prefill's attention:
    B8 where it takes the head dim, the blocked attention elsewhere)."""
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import token_batch
    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS
    from repro_torch.models.lm import transformer as T
    resolve_device(dev)
    cfg = registry.get_config(arch, reduced=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(token_batch(2, 32, cfg.vocab, seed=3))
    attention = "flash" if cfg.head_dim in HEAD_DIMS else "blocked"
    return cfg, params, _lm_on(params, dev), toks, attention


def _lm_close(got, want, what):
    err = float((got.cpu().float() - want.float()).abs().max())
    assert err <= LM_TOL, f"{what}: {err:.3e}"


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_reduced_on_card_matches_cpu(cuda, arch):
    """Each reduced arch's forward, prefill and decode steps (fixed and
    ragged) on the card against the port on the CPU, f32."""
    from repro_torch import tree
    from repro_torch.models.lm import transformer as T
    cfg, params, on, toks, attention = _lm_case(arch, cuda)
    with torch.no_grad():
        _lm_close(T.forward(on, cfg, toks.to(cuda)),
                  T.forward(params, cfg, toks), "forward")
        got, kv = T.prefill(on, cfg, toks[:, :8].to(cuda),
                            attention=attention)
        want, kv_cpu = T.prefill(params, cfg, toks[:, :8],
                                 attention=attention)
        _lm_close(got, want, f"prefill ({attention})")
        for a, b in zip(tree.leaves(kv), tree.leaves(kv_cpu)):
            _lm_close(a, b, "prefill cache")
        caches = []
        for dev, src in ((cuda, kv), ("cpu", kv_cpu)):
            cache = T.init_cache(cfg, 2, 16, device=dev)
            for dst, s in zip(tree.leaves(cache), tree.leaves(src)):
                dst[:, :, :8] = s
            caches.append(cache)
        step = toks[:, 8:9]
        got, _ = T.decode_step(on, cfg, step.to(cuda), caches[0], 8)
        want, _ = T.decode_step(params, cfg, step, caches[1], 8)
        _lm_close(got, want, "decode_step")
        pos = torch.tensor([9, 3])
        got, gc_ = T.decode_step_ragged(on, cfg, step.to(cuda), caches[0],
                                        pos.to(cuda))
        want, wc = T.decode_step_ragged(params, cfg, step, caches[1], pos)
        _lm_close(got, want, "decode_step_ragged")
        for a, b in zip(tree.leaves(gc_), tree.leaves(wc)):
            _lm_close(a, b, "ragged cache")


def test_lm_prefill_b8_matches_blocked(cuda):
    """B8 inside the reduced qwen3's prefill (head_dim 16): one launch a
    layer, logits and cache against the blocked attention's on the card."""
    from repro_torch import tree
    from repro_torch.models.lm import transformer as T
    cfg, _, on, toks, attention = _lm_case("qwen3-0.6b", cuda)
    assert attention == "flash"
    with torch.no_grad():
        before = flash_attention.launches
        got, kv = T.prefill(on, cfg, toks.to(cuda), attention="flash")
        torch.cuda.synchronize()
        assert flash_attention.launches == before + cfg.n_layers
        want, kv_b = T.prefill(on, cfg, toks.to(cuda), attention="blocked")
        assert flash_attention.launches == before + cfg.n_layers
    _lm_close(got, want.cpu(), "flash vs blocked")
    for a, b in zip(tree.leaves(kv), tree.leaves(kv_b)):
        # the first layer's k, v come before any attention; later layers'
        # carry the earlier layers' attention outputs
        assert torch.equal(a[0], b[0])
        _lm_close(a, b.cpu(), "flash vs blocked cache")


def test_lm_flash_raises_for_head_dims_b8_lacks(cuda):
    from repro_torch.models.lm import transformer as T
    cfg, _, on, toks, attention = _lm_case("gemma-7b", cuda)
    assert attention == "blocked"
    with torch.no_grad(), pytest.raises(ValueError, match="head dim"):
        T.prefill(on, cfg, toks.to(cuda), attention="flash")


# --- A8c and A8d: compression, NeuraSim and op_costs on the card ----------

def test_compression_on_card_bitwise_cpu(cuda):
    from repro_torch.optim import compression as C
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.normal(size=(3, 1000)).astype(
        np.float32)).to(torch.bfloat16),
         "b": torch.from_numpy(rng.normal(size=(777,)).astype(np.float32)),
         "z": torch.zeros(300)}
    g_card = {k: v.to(cuda) for k, v in g.items()}
    r, r_card = C.init_residual(g), C.init_residual(g_card)
    for _ in range(3):
        d, r = C.error_feedback_compress(g, r)
        d_card, r_card = C.error_feedback_compress(g_card, r_card)
        for k in g:
            assert torch.equal(d_card[k].cpu(), d[k]), k
            assert torch.equal(r_card[k].cpu(), r[k]), k
    for x in (g["a"], g["b"]):
        q, s = C.quantize_int8(x)
        q_card, s_card = C.quantize_int8(x.to(cuda))
        assert torch.equal(q_card.cpu(), q) and torch.equal(s_card.cpu(), s)


def test_neurasim_stats_on_card_equal_cpu(cuda):
    from repro_torch.neurasim import datasets, machine, model
    s, r, n = datasets.synth("facebook")
    w_card = model.stats_from_coo(s, r, n, device=cuda)
    w = model.stats_from_coo(s, r, n, device="cpu")
    assert (w_card.pp_interim, w_card.nnz_out) == (w.pp_interim, w.nnz_out)
    assert w_card.row_tags.device.type == "cuda"
    assert torch.equal(w_card.row_tags.cpu(), w.row_tags)
    for mapping in ("ring", "modular", "random", "drhm"):
        assert torch.equal(
            model.mapping_loads(w_card.row_tags, 32, mapping,
                                device=cuda).cpu(),
            model.mapping_loads(w.row_tags, 32, mapping, device="cpu"))
    for cfg in machine.CONFIGS.values():
        assert model.simulate_spgemm(w_card, cfg) == \
            model.simulate_spgemm(w, cfg)


def test_step_costs_on_card_equal_fake_count(cuda):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import op_costs
    from repro_torch.models.common import mlp_apply, mlp_init
    params = mlp_init(torch.Generator().manual_seed(0), [64, 128, 32],
                      torch.float32, cuda)
    x = torch.randn(256, 64, device=cuda)

    def step(p, x):
        loss = mlp_apply(p, x, act=torch.relu).square().mean()
        return torch.autograd.grad(loss, list(p.values()))
    live = {k: v.requires_grad_() for k, v in params.items()}
    flops, byts, _ = op_costs.step_costs(step, live, x)
    with FakeTensorMode():
        fp = {k: torch.empty(v.shape).requires_grad_()
              for k, v in params.items()}
        f_flops, f_bytes, _ = op_costs.step_costs(step, fp,
                                                  torch.empty(256, 64))
    assert flops == f_flops > 0
    assert byts > 0 and f_bytes > 0
