"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips without a CUDA device.  On a machine with
one, run ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_plain)
from repro_torch.kernels.flash_attention import (causal_attention_plain,
                                                 flash_attention, mha_causal)
from repro_torch.kernels.forest_sampler import hash_draws, hash_draws_plain
from repro_torch.kernels.gustavson_spmm import (auto_d_tile,
                                                spmm_dedup_chunks,
                                                spmm_dedup_chunks_plain,
                                                spmm_dedup_chunks_q8,
                                                spmm_dedup_chunks_q8_plain)
from repro_torch.kernels.sddmm import edge_scores, sddmm, sddmm_plain
from repro_torch.kernels.spgemm_pad import (spgemm_hashpad,
                                            spgemm_hashpad_plain,
                                            spgemm_hashpad_q8,
                                            spgemm_hashpad_q8_plain)
from repro_torch.sparse import quantize as qz
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


@pytest.mark.parametrize("n,e,width_cap,pad_slack,lanes", [
    (200, 100, 128, 2.0, "below_32"),
    (300, 3000, 128, 2.0, "h_tiles"),
    (64, 1500, 8, 2.0, "chunks"),
    (64, 1500, 8, 64.0, "h_tiles")])
def test_hashpad_q8_kernel_matches_plain(cuda, n, e, width_cap, pad_slack,
                                         lanes):
    plan, _ = _spgemm_plan(n, e, seed=n + e, dev=cuda, width_cap=width_cap,
                           pad_slack=pad_slack,
                           executors=("reference", "cuda_q8"))
    if lanes == "below_32":
        assert plan.pad_width < 32
    elif lanes == "h_tiles":
        assert plan.pad_width > 256
    else:
        assert plan.n_chunks > plan.n_blocks
    args = (plan.ell_remaining, plan.ell_block_ptr, plan.ell_a_q8,
            plan.ell_a_scale, plan.slab_q8, plan.slab_scale)
    kw = dict(block_rows=plan.block_rows, pad_width=plan.pad_width)
    before = spgemm_hashpad_q8.launches
    got = spgemm_hashpad_q8(*args, **kw)
    assert spgemm_hashpad_q8.launches == before + 1
    want = spgemm_hashpad_q8_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert float((got - want).abs().max()) <= 1e-5


def test_hashpad_q8_kernel_never_reads_dead_lanes(cuda):
    plan, _ = _spgemm_plan(64, 1500, seed=4, dev=cuda, width_cap=8,
                           executors=("cuda_q8",))
    kw = dict(block_rows=8, pad_width=plan.pad_width)
    want = spgemm_hashpad_q8(plan.ell_remaining, plan.ell_block_ptr,
                             plan.ell_a_q8, plan.ell_a_scale, plan.slab_q8,
                             plan.slab_scale, **kw)
    lane = torch.arange(plan.width, device=cuda)
    dead = lane[None, :] >= plan.ell_remaining[:, None]
    slab = torch.where(dead.reshape(-1, 1), 127, plan.slab_q8).to(torch.int8)
    a = torch.where(dead.repeat_interleave(8, 0), -127,
                    plan.ell_a_q8).to(torch.int8)
    got = spgemm_hashpad_q8(plan.ell_remaining, plan.ell_block_ptr,
                            a.contiguous(), plan.ell_a_scale,
                            slab.contiguous(), plan.slab_scale, **kw)
    torch.cuda.synchronize()
    assert bool(dead.any()) and torch.equal(got, want)


def test_hashpad_q8_wrapper_raises_on_f32(cuda):
    plan, _ = _spgemm_plan(64, 500, seed=6, dev=cuda, executors=("cuda_q8",))
    with pytest.raises(TypeError):
        spgemm_hashpad_q8(plan.ell_remaining, plan.ell_block_ptr,
                          plan.ell_a_q8, plan.ell_a_scale,
                          plan.slab_q8.float(), plan.slab_scale,
                          block_rows=8, pad_width=plan.pad_width)


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
