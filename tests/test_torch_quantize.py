"""The port's int8 quantization (``repro_torch.sparse.quantize``) against the
JAX reference's ``repro.sparse.quantize`` on the same numpy inputs: int8
values and scales bitwise equal (zero tiles, empty layouts, padded feature
tiles included), both error bounds and ``q8_gate`` equal, and no read back
to the host in the quantizers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.backend_sweep import Q8_E2E_TOL as REFERENCE_Q8_E2E_TOL
from repro.kernels.gustavson_spmm.gustavson_spmm import _auto_d_tile
from repro.sparse import quantize as jq
from repro_torch.kernels.gustavson_spmm import auto_d_tile
from repro_torch.sparse import quantize as tq


def _bitwise(t_pair, j_pair):
    for t, j in zip(t_pair, j_pair):
        t, j = t.numpy(), np.asarray(j)
        assert t.dtype == j.dtype and t.shape == j.shape
        assert np.array_equal(t.view(np.uint8) if t.dtype == np.int8 else t,
                              j.view(np.uint8) if j.dtype == np.int8 else j)


@pytest.mark.parametrize("n_chunks,rows,width,scale", [
    (6, 8, 16, 3.0), (2, 8, 128, 1e-3), (40, 16, 64, 250.0)])
def test_chunk_tiles_bitwise_equal_reference(n_chunks, rows, width, scale):
    rng = np.random.default_rng(n_chunks + width)
    a = (rng.normal(size=(n_chunks * rows, width)) * scale).astype(np.float32)
    a[:rows] = 0.0                                   # an all-zero tile
    a[rows, :3] = [0.5, -0.5, 1.5]                   # half-way values
    got = tq.quantize_chunk_tiles(torch.from_numpy(a), n_chunks)
    _bitwise(got, jq.quantize_chunk_tiles(jnp.asarray(a), n_chunks))
    assert float(got[1][0]) == 1.0 and not got[0][:rows].any()


def test_chunk_tiles_empty_layout():
    got = tq.quantize_chunk_tiles(torch.zeros((0, 8)), 0)
    _bitwise(got, jq.quantize_chunk_tiles(np.zeros((0, 8), np.float32), 0))


@pytest.mark.parametrize("n,d,d_tile", [
    (12, 16, 16), (12, 33, 16), (30, 7, 7), (9, 600, 304), (5, 3, 8)])
def test_feature_tiles_bitwise_equal_reference(n, d, d_tile):
    rng = np.random.default_rng(n * d)
    x = (rng.normal(size=(n, d)) * 4).astype(np.float32)
    if d > d_tile:
        x[:, :d_tile] = 0.0                          # an all-zero tile
    got = tq.quantize_feature_tiles(torch.from_numpy(x), d_tile)
    _bitwise(got, jq.quantize_feature_tiles(jnp.asarray(x), d_tile))
    assert got[1].shape == (-(-d // d_tile),)
    qf = tq.quantize_features(torch.from_numpy(x), d_tile)
    assert isinstance(qf, tq.QuantizedFeatures)
    _bitwise((qf.q8, qf.scale), got)


@pytest.mark.parametrize("d", [1, 16, 512, 513, 600, 1433, 4096])
def test_auto_d_tile_equals_reference(d):
    assert auto_d_tile(d) == _auto_d_tile(d)


def test_chunk_entries_equal_dense_tiles():
    # the SpGEMM slab bake quantizes only the nonzero cells of a layout
    rng = np.random.default_rng(3)
    n_chunks, rows, width = 7, 4, 8
    dense = np.zeros((n_chunks * rows, width), np.float32)
    cells = rng.choice(dense.size, 60, replace=False)
    cells = cells[cells // (rows * width) != 2]      # chunk 2 stays empty
    dense.reshape(-1)[cells] = rng.normal(size=cells.size) * 9
    want_q, want_s = tq.quantize_chunk_tiles(torch.from_numpy(dense),
                                             n_chunks)
    q, s = tq.quantize_chunk_entries(
        torch.from_numpy(dense.reshape(-1)[cells]),
        torch.from_numpy(cells // (rows * width)), n_chunks)
    assert torch.equal(s, want_s) and float(s[2]) == 1.0
    assert torch.equal(q, want_q.reshape(-1)[torch.from_numpy(cells)])


def test_bounds_and_gate_equal_reference():
    rng = np.random.default_rng(5)
    rem = rng.integers(1, 17, 30).astype(np.int32)
    ob = np.sort(rng.integers(0, 12, 30)).astype(np.int32)
    sa = rng.uniform(1e-3, 1, 30).astype(np.float32)
    sb = rng.uniform(1e-3, 1, 30).astype(np.float32)
    sx = rng.uniform(1e-3, 1, 3).astype(np.float32)
    want = jq.aggregate_q8_bound(rem, ob, 12, sa, sx)
    assert tq.aggregate_q8_bound(rem, ob, 12, sa, sx) == want
    assert tq.aggregate_q8_bound(*map(torch.from_numpy, (rem, ob)), 12,
                                 torch.from_numpy(sa),
                                 torch.from_numpy(sx)) == want
    want = jq.spgemm_q8_bound(16, ob, 12, sa, sb)
    assert tq.spgemm_q8_bound(16, torch.from_numpy(ob), 12,
                              torch.from_numpy(sa),
                              torch.from_numpy(sb)) == want
    assert tq.aggregate_q8_bound([], [], 0, [], []) == \
        jq.aggregate_q8_bound([], [], 0, [], [])
    for dev, bound in ((0.0, 0.0), (1.0, 1.0), (1.0105, 1.0), (2.0, 1.0),
                       (float("nan"), 1.0), (5e-7, 0.0)):
        assert tq.q8_gate(dev, bound) == jq.q8_gate(dev, bound)
    assert tq.Q8_MAX == jq.Q8_MAX
    assert tq.Q8_E2E_TOL == REFERENCE_Q8_E2E_TOL


def test_quantizers_read_nothing_back(monkeypatch):
    # a serving step re-quantizes on the device: no .item(), .cpu() or
    # Python conversion of a tensor may happen there
    def refuse(*_a, **_k):
        raise AssertionError("read back to the host")
    a = torch.randn(5 * 8, 16)
    x = torch.randn(20, 600)
    for name in ("item", "cpu", "tolist", "numpy", "__float__", "__int__",
                 "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    tq.quantize_chunk_tiles(a, 5)
    tq.quantize_feature_tiles(x, 304)
    tq.quantize_chunk_entries(a.reshape(-1), torch.arange(640) // 128, 5)


def test_record_q8_stats_at_plan_build():
    from repro_torch.sparse import stats
    from repro_torch.sparse.plan import make_plan, plan_with_values
    stats.reset()
    rng = np.random.default_rng(0)
    s, r = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    plan = make_plan(s, r, 41, backends=("cuda_q8",), device="cpu")
    snap = stats.kernel_stats().snapshot()
    assert snap["counters"]["q8.tile_quants"] == 1
    assert snap["series"]["q8.scale_max"]["max"] == float(
        plan.ell_a_scale.max())
    plan_with_values(plan, torch.ones(200))          # re-values, no stats
    assert stats.kernel_stats().snapshot()["counters"]["q8.tile_quants"] == 1
