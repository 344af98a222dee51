"""The port's int8 slice against the JAX reference's ``pallas_q8`` path on
the CPU (the reference's Pallas kernels in interpret mode): plans' int8
tiles bitwise equal, the two kernels' plain versions and the two
``cuda_q8`` executors ≤1e-6, a quantized serving step ≤1e-5, a quantized
``GNNServer``, and Â² / coarsening / GCN over Â² through ``cuda_q8``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import powerlaw_graph
from repro.kernels.gustavson_spmm.gustavson_spmm import \
    spmm_dedup_chunks_q8 as jax_spmm_q8
from repro.kernels.spgemm_pad.spgemm_pad import \
    spgemm_hashpad_q8 as jax_hashpad_q8
from repro.sparse import backend as jsb
from repro.sparse import graph as jgraph
from repro.sparse import plan as jplan
from repro.sparse import quantize as jq
from repro.sparse import spgemm as jsp
from repro_torch.kernels.gustavson_spmm import (auto_d_tile,
                                                spmm_dedup_chunks_q8,
                                                spmm_dedup_chunks_q8_plain)
from repro_torch.kernels.spgemm_pad import (spgemm_hashpad_q8,
                                            spgemm_hashpad_q8_compact_plain,
                                            spgemm_hashpad_q8_plain)
from repro_torch.sparse import backend as tsb
from repro_torch.sparse import graph as tgraph
from repro_torch.sparse import plan as tplan
from repro_torch.sparse import quantize as tq
from repro_torch.sparse import spgemm as tsp
from repro_torch.sparse.spgemm import numeric as tnum
from spgemm_cells import with_dead_lane_cells

TOL = 1e-6          # same int8 operands, same fold: only f32 rounding left
STEP_TOL = 1e-5     # a whole quantized serving step (two layers)
CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _graph(n=150, e=1200, seed=0, n_invalid=0):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    s[:3], r[:3] = 5, 9                   # duplicate edges share a cell
    r[3:60] = 11                          # a hub: several chunks per block
    w = rng.normal(size=e).astype(np.float32)
    valid = np.ones(e, bool)
    valid[rng.choice(e, n_invalid, replace=False)] = False
    return s, r, w, valid, rng


def _plans(s, r, n_rows, **kw):
    tp = tplan.make_plan(s, r, n_rows, backends=("dense", "cuda_q8"),
                         device=CPU, **kw)
    jp = jplan.make_plan(s, r, n_rows, backends=("dense", "pallas_q8"), **kw)
    return tp, jp


def _assert_q8_tiles_equal(tp, jp):
    for f in ("ell_a_q8", "ell_a_scale"):
        a, b = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width_cap", [128, 8])
def test_make_plan_q8_tiles_bitwise_equal_reference(width_cap):
    s, r, w, valid, _ = _graph(n_invalid=40)
    tp, jp = _plans(s, r, 151, edge_weight=w, edge_valid=valid,
                    width_cap=width_cap)
    _assert_q8_tiles_equal(tp, jp)
    assert np.array_equal(tp.ell_a.numpy(), np.asarray(jp.ell_a))
    assert tp.ell_d_tile is None and jp.ell_d_tile is None
    if width_cap == 8:
        assert tp.ell_u_cols.shape[0] > tp.n_blocks          # hub splits


def test_plan_with_values_requantizes_like_reference(monkeypatch):
    s, r, _, _, rng = _graph()
    tp, jp = _plans(s, r, 151, width_cap=8)
    w2 = rng.normal(size=s.size).astype(np.float32)
    v2 = rng.random(s.size) > 0.3
    jq_ = jplan.plan_with_values(jp, jnp.asarray(w2), jnp.asarray(v2))

    def refuse(*_a, **_k):
        raise AssertionError("read back to the host")
    for name in ("item", "cpu", "tolist", "numpy", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    tq_ = tplan.plan_with_values(tp, _t(w2), _t(v2))
    monkeypatch.undo()
    _assert_q8_tiles_equal(tq_, jq_)
    assert tq_.ell_t_a is None
    # a plan without int8 tiles stays without them
    plain = tplan.make_plan(s, r, 151, backends=("cuda",), device=CPU)
    assert tplan.plan_with_values(plain, _t(w2)).ell_a_q8 is None


# ---------------------------------------------------------------------------
# B4: spmm_dedup_chunks_q8
# ---------------------------------------------------------------------------

def _b4_args(tp, x, q_tile):
    xq, xs = tq.quantize_feature_tiles(torch.from_numpy(x), q_tile)
    return (tp.ell_u_cols, tp.ell_remaining, tp.ell_block_ptr, tp.ell_a_q8,
            tp.ell_a_scale, xq, xs)


@pytest.mark.parametrize("width_cap,d", [(128, 16), (128, 7), (8, 16),
                                         (8, 600), (128, 600)])
def test_b4_plain_matches_reference_kernel(width_cap, d):
    s, r, w, valid, rng = _graph(n_invalid=10)
    tp, jp = _plans(s, r, 151, edge_weight=w, edge_valid=valid,
                    width_cap=width_cap)
    x = rng.normal(size=(151, d)).astype(np.float32)
    qt = auto_d_tile(d)
    args = _b4_args(tp, x, qt)
    got = spmm_dedup_chunks_q8_plain(*args, block_rows=8, q_tile=qt)
    want = jax_spmm_q8(jp.ell_u_cols, jp.ell_remaining, jp.ell_out_block,
                       jp.ell_first, jp.ell_a_q8, jp.ell_a_scale,
                       jnp.asarray(args[5].numpy()),
                       jnp.asarray(args[6].numpy()), block_rows=8,
                       n_blocks=jp.n_blocks, d_tile=qt, interpret=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    # the wrapper on CPU tensors is the plain version
    before = spmm_dedup_chunks_q8.launches
    assert torch.equal(spmm_dedup_chunks_q8(*args, block_rows=8), got)
    assert spmm_dedup_chunks_q8.launches == before


def test_b4_plain_never_reads_dead_lanes():
    s, r, w, _, rng = _graph()
    tp, _ = _plans(s, r, 151, edge_weight=w, width_cap=8)
    x = rng.normal(size=(151, 16)).astype(np.float32)
    u, rem, ptr, a, sa, xq, xs = _b4_args(tp, x, 16)
    want = spmm_dedup_chunks_q8_plain(u, rem, ptr, a, sa, xq, xs,
                                      block_rows=8, q_tile=16)
    dead = torch.arange(u.shape[1])[None, :] >= rem[:, None]
    xq = torch.cat([xq, torch.full((1, 16), 127, dtype=torch.int8)])
    u = torch.where(dead, 151, u).to(torch.int32)
    a = torch.where(dead.repeat_interleave(8, 0), -127, a).to(torch.int8)
    got = spmm_dedup_chunks_q8_plain(u, rem, ptr, a, sa, xq, xs,
                                     block_rows=8, q_tile=16)
    assert bool(dead.any()) and torch.equal(got, want)


@pytest.mark.parametrize("bad", ["f32_a", "f32_x", "scale_count",
                                 "scale_dtype", "device"])
def test_b4_wrapper_raises(bad):
    s, r, w, _, rng = _graph()
    tp, _ = _plans(s, r, 151, edge_weight=w)
    args = list(_b4_args(tp, rng.normal(size=(151, 16)).astype(np.float32),
                         16))
    err = TypeError
    if bad == "f32_a":
        args[3] = args[3].float()
    elif bad == "f32_x":
        args[5] = args[5].float()
    elif bad == "scale_count":
        args[6] = torch.ones(2)
        err = ValueError
    elif bad == "scale_dtype":
        args[4] = args[4].double()
    else:
        args[0] = args[0].to("meta")
        err = ValueError
    with pytest.raises(err):
        spmm_dedup_chunks_q8(*args, block_rows=8)


# ---------------------------------------------------------------------------
# the cuda_q8 aggregation executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width_cap,d", [(128, 16), (8, 7), (8, 600)])
@pytest.mark.parametrize("given_vals", [False, True])
def test_cuda_q8_aggregate_matches_pallas_q8(width_cap, d, given_vals):
    s, r, w, valid, rng = _graph(n_invalid=15, seed=d)
    tp, jp = _plans(s, r, 151, edge_weight=w, edge_valid=valid,
                    width_cap=width_cap)
    x = rng.normal(size=(151, d)).astype(np.float32)
    vals = rng.normal(size=s.size).astype(np.float32) if given_vals else None
    got = tsb.aggregate(tp, None if vals is None else _t(vals), _t(x),
                        backend="cuda_q8")
    want = jsb.aggregate(jp, None if vals is None else jnp.asarray(vals),
                         jnp.asarray(x), backend="pallas_q8")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    # and within the scale-derived bound of the f32 result
    dense = tsb.aggregate(tp, None if vals is None else _t(vals), _t(x),
                          backend="dense")
    if vals is None:
        _, xs = tq.quantize_feature_tiles(_t(x), auto_d_tile(d))
        bound = tq.aggregate_q8_bound(tp.ell_remaining, tp.ell_out_block,
                                      tp.n_blocks, tp.ell_a_scale, xs)
        assert tq.q8_gate(float((got - dense).abs().max()), bound)


def test_cuda_q8_resident_features_equal_in_call_bitwise():
    s, r, w, _, rng = _graph(seed=7)
    tp, jp = _plans(s, r, 151, edge_weight=w, width_cap=8)
    x = rng.normal(size=(151, 32)).astype(np.float32)
    qf = tq.quantize_features(_t(x), tp.ell_d_tile or auto_d_tile(32))
    in_call = tsb.aggregate(tp, None, _t(x), backend="cuda_q8")
    resident = tsb.aggregate(tp, None, qf, backend="cuda_q8")
    assert torch.equal(in_call, resident)
    jqf = jq.quantize_features(jnp.asarray(x), 32)
    want = jsb.aggregate(jp, None, jqf, backend="pallas_q8")
    np.testing.assert_allclose(resident.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_cuda_q8_guards():
    s, r, w, _, rng = _graph()
    tp, _ = _plans(s, r, 151, edge_weight=w)
    x = torch.from_numpy(rng.normal(size=(151, 32)).astype(np.float32))
    bad = tq.QuantizedFeatures(q8=torch.zeros((151, 32), dtype=torch.int8),
                               scale=torch.ones(99))
    with pytest.raises(ValueError, match="feature-tile"):
        tsb.aggregate(tp, None, bad, backend="cuda_q8")
    short = tq.QuantizedFeatures(q8=torch.zeros((150, 32),
                                                dtype=torch.int8),
                                 scale=torch.ones(1))
    with pytest.raises(ValueError, match="n_rows=151"):
        tsb.aggregate(tp, None, short, backend="cuda_q8")
    with pytest.raises(NotImplementedError, match="inference-only"):
        tsb.aggregate(tp, None, x.clone().requires_grad_(),
                      backend="cuda_q8")
    with pytest.raises(NotImplementedError):
        tsb.aggregate(tp, torch.ones(s.size, requires_grad=True), x,
                      backend="cuda_q8")
    with torch.no_grad():
        y = tsb.aggregate(tp, None, x.clone().requires_grad_(),
                          backend="cuda_q8")
    assert not y.requires_grad
    coo_only = tplan.edge_plan(torch.from_numpy(s), torch.from_numpy(r), 151)
    with pytest.raises(tplan.BackendPlanError):
        tsb.aggregate(coo_only, None, x, backend="cuda_q8")
    # a plan packed for `cuda` only quantizes its f32 tiles per call
    cuda_only = tplan.make_plan(s, r, 151, edge_weight=w, device=CPU,
                                backends=("cuda",))
    assert torch.equal(tsb.aggregate(cuda_only, None, x, backend="cuda_q8"),
                       tsb.aggregate(tp, None, x, backend="cuda_q8"))
    assert tsb.accumulate(tp, torch.ones(s.size, 2),
                          backend="cuda_q8").shape == (151, 2)


# ---------------------------------------------------------------------------
# serving: one bucket step, then a whole server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    from repro.configs import gcn_cora as jcfgs
    from repro.models.gnn import gcn as jgcn
    from repro_torch.configs import gcn_cora as tcfgs
    from repro_torch.convert import gcn_params_from_jax
    from repro_torch.sparse.graph import coo_to_csr
    s, r = powerlaw_graph(300, 1500, seed=7)
    indptr, indices, _ = coo_to_csr(s, r, 300)
    jcfg = jcfgs.reduced()
    x = np.random.default_rng(8).normal(size=(300, jcfg.d_in)).astype(
        np.float32)
    jparams = jgcn.init_params(jax.random.key(0), jcfg)
    tparams = gcn_params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device=CPU)
    return dict(indptr=indptr, indices=indices, x=x, jcfg=jcfg,
                tcfg=tcfgs.reduced(), jparams=jparams, tparams=tparams,
                seeds=np.random.default_rng(9).integers(0, 300, 24))


@pytest.mark.parametrize("bucket", [1, 16])
def test_q8_infer_step_matches_reference(world, bucket):
    from repro.serve import compute as jcompute
    from repro_torch.serve import compute as tcompute
    from repro_torch.serve.buckets import build_bucket_structure, stack_trees
    from repro_torch.sparse import sampler as tsampler
    fanouts = (3, 2)
    k = max(bucket - 1, 1)
    trees = tsampler.sample_forest(world["indptr"], world["indices"],
                                   world["seeds"][:k], fanouts, key=3)
    node_ids, hop_valid = stack_trees(trees, bucket, fanouts)
    struct = build_bucket_structure(bucket, fanouts, with_loops=True)
    jstore = jcompute.FeatureStore.build(300, x=world["x"])
    tstore = tcompute.FeatureStore.build(300, world["x"], device=CPU)
    want = np.asarray(jcompute.build_infer_step(
        "gcn", world["jcfg"], jstore, struct, backend="pallas_q8")(
        world["jparams"], node_ids, hop_valid))
    got = tcompute.build_infer_step("gcn", world["tcfg"], tstore, struct,
                                    backend="cuda_q8")(
        world["tparams"], node_ids, hop_valid)
    assert got.shape == (bucket, world["tcfg"].n_classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=STEP_TOL)


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_q8_server_settles_once_without_rebuilds(world, sampler):
    from repro_torch.launch.gnn_serve import parity_tol
    from repro_torch.serve import compute as tcompute
    from repro_torch.serve import engine as tengine
    store = tcompute.FeatureStore.build(300, world["x"], device=CPU)
    with tengine.GNNServer("gcn", world["tcfg"], world["tparams"],
                           world["indptr"], world["indices"], store,
                           fanouts=(3, 2), backend="cuda_q8",
                           sampler=sampler, max_batch_seeds=4, seed=5,
                           device=CPU) as server:
        server.warmup()
        builds = server.steps.builds
        reqs = [server.submit([int(s)]) for s in world["seeds"]]
        server.drain()
        assert server.steps.builds == builds
        assert all(r.n_settles == 1 and r.error is None for r in reqs)
        ref = np.concatenate([tengine.offline_replay(server, r)
                              for r in reqs])
    got = np.concatenate([r.result for r in reqs])
    assert got.shape == (len(reqs), world["tcfg"].n_classes)
    assert np.isfinite(got).all()
    assert float(np.abs(got - ref).max()) <= parity_tol("cuda_q8")
    assert parity_tol("cuda_q8") == tq.Q8_E2E_TOL
    assert parity_tol("cuda") == 1e-5


# ---------------------------------------------------------------------------
# SpGEMM: the plan bake, B5, the executor, Â² and coarsening
# ---------------------------------------------------------------------------

def _spgemm_case(width_cap=128, n=96, e=600, seed=1):
    rng = np.random.default_rng(seed)
    s, r = powerlaw_graph(n, e, seed=seed)
    s, r = s.copy(), r.copy()
    s[:4], r[:4] = 3, 7        # B entry (7, 3) four times: one slab cell
    w = rng.normal(size=s.size).astype(np.float32)
    kw = dict(a_vals=w, b_vals=w, width_cap=width_cap)
    tp = tsp.make_spgemm_plan(r, s, n, r, s, n, device=CPU,
                              executors=("reference", "cuda_q8"), **kw)
    jp = jsp.make_spgemm_plan(r, s, n, r, s, n,
                              executors=("reference", "pallas_q8"), **kw)
    return tp, jp, rng


@pytest.mark.parametrize("width_cap", [128, 8])
def test_spgemm_plan_q8_fields_bitwise_equal_reference(width_cap):
    tp, jp, _ = _spgemm_case(width_cap)
    if width_cap == 8:
        assert tp.n_chunks > tp.n_blocks
    for f in ("ell_a_q8", "ell_a_scale", "slab_q8", "slab_scale", "ell_a",
              "slab_row", "slab_col"):
        # the dense int8 slab: the port's int8 cells scattered into it
        a = (tnum.hashed_slab_q8(tp) if f == "slab_q8"
             else getattr(tp, f)).numpy()
        b = np.asarray(getattr(jp, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    # one int8 value per cell: the (7, 3) entries share one
    assert tp.cell_q8.shape == (tp.n_cells,) and tp.n_cells < tp.pp_dedup


def _b5_args(tp, a_q8=None, cells=None):
    cells = (tp.cell_ptr, tp.cell_lane, tp.cell_bucket,
             tp.cell_q8) if cells is None else cells
    return (tp.ell_remaining, tp.ell_block_ptr,
            tp.ell_a_q8 if a_q8 is None else a_q8, tp.ell_a_scale, *cells,
            tp.slab_scale, tp.c_indptr, tp.out_bucket)


@pytest.mark.parametrize("width_cap", [128, 8])
def test_b5_plain_matches_reference_kernel(width_cap):
    tp, jp, _ = _spgemm_case(width_cap, seed=2)
    kw = dict(block_rows=8, pad_width=tp.pad_width)
    slab_q8 = tnum.hashed_slab_q8(tp)
    dense_args = (tp.ell_remaining, tp.ell_block_ptr, tp.ell_a_q8,
                  tp.ell_a_scale, slab_q8, tp.slab_scale)
    dense = spgemm_hashpad_q8_plain(*dense_args, **kw)
    want = jax_hashpad_q8(jp.ell_out_block, jp.ell_first, jp.ell_evict,
                          jp.ell_a_q8, jp.ell_a_scale, jp.slab_q8,
                          jp.slab_scale, n_blocks=jp.n_blocks,
                          interpret=True, **kw)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    # the wrapper on the int8 cells (the compact plain version on the CPU,
    # no launch): the dense plain version gathered, bitwise
    before = spgemm_hashpad_q8.launches
    got = spgemm_hashpad_q8(*_b5_args(tp), **kw)
    assert spgemm_hashpad_q8.launches == before
    gather = (tp.out_row.long(), tp.out_bucket.long())
    assert torch.equal(got, dense[gather])
    assert torch.equal(got, spgemm_hashpad_q8_compact_plain(*_b5_args(tp),
                                                            **kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[gather],
                               rtol=0, atol=TOL)
    # dead slab rows, dead coefficient lanes and cells on dead lanes are
    # never read
    dead = torch.arange(tp.width)[None, :] >= tp.ell_remaining[:, None]
    slab = torch.where(dead.reshape(-1, 1), 127, slab_q8).to(torch.int8)
    a = torch.where(dead.repeat_interleave(8, 0), -127,
                    tp.ell_a_q8).to(torch.int8)
    poisoned = spgemm_hashpad_q8_plain(tp.ell_remaining, tp.ell_block_ptr, a,
                                       tp.ell_a_scale, slab, tp.slab_scale,
                                       **kw)
    assert bool(dead.any()) and torch.equal(poisoned, dense)
    cells = with_dead_lane_cells(tp, tp.cell_q8, 127)
    assert cells[1].numel() > tp.n_cells
    assert torch.equal(spgemm_hashpad_q8(*_b5_args(tp, a, cells), **kw), got)


@pytest.mark.parametrize("bad", ["f32_slab", "scale_shape", "pad_width"])
def test_b5_wrapper_raises(bad):
    tp, _, _ = _spgemm_case()
    args = list(_b5_args(tp))
    kw = dict(block_rows=8, pad_width=tp.pad_width)
    err = TypeError
    if bad == "f32_slab":
        args[7] = args[7].float()                  # the cell values
    elif bad == "scale_shape":
        args[8] = args[8][:-1].contiguous()
        err = ValueError
    else:
        kw["pad_width"] = tp.pad_width * 3         # not a power of two
        err = ValueError
    with pytest.raises(err):
        spgemm_hashpad_q8(*args, **kw)


@pytest.mark.parametrize("width_cap", [128, 8])
@pytest.mark.parametrize("given", [False, True])
def test_cuda_q8_spgemm_matches_pallas_q8(width_cap, given):
    tp, jp, rng = _spgemm_case(width_cap, seed=3)
    av = bv = None
    if given:
        av = rng.normal(size=tp.nnz_a).astype(np.float32)
        bv = rng.normal(size=tp.nnz_b).astype(np.float32)
    got = tsb.spgemm(tp, None if av is None else _t(av),
                     None if bv is None else _t(bv), backend="cuda_q8")
    want = jsb.spgemm(jp, None if av is None else jnp.asarray(av),
                      None if bv is None else jnp.asarray(bv),
                      backend="pallas_q8")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    if not given:
        ref = tsb.spgemm(tp, backend="reference")
        bound = tq.spgemm_q8_bound(tp.width, tp.ell_out_block, tp.n_blocks,
                                   tp.ell_a_scale, tp.slab_scale)
        assert tq.q8_gate(float((got - ref).abs().max()), bound)


def test_cuda_q8_spgemm_rectangular_and_cuda_only_plan():
    rng = np.random.default_rng(11)
    ar, ac = rng.integers(0, 40, 300), rng.integers(0, 64, 300)
    br, bc = rng.integers(0, 64, 250), rng.integers(0, 24, 250)
    av = rng.normal(size=300).astype(np.float32)
    bv = rng.normal(size=250).astype(np.float32)
    kw = dict(a_vals=av, b_vals=bv)
    tp = tsp.make_spgemm_plan(ar, ac, 40, br, bc, 64, 24, device=CPU,
                              executors=("cuda_q8",), **kw)
    jp = jsp.make_spgemm_plan(ar, ac, 40, br, bc, 64, 24,
                              executors=("pallas_q8",), **kw)
    got = tsb.spgemm(tp, backend="cuda_q8")
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jsb.spgemm(jp, backend="pallas_q8")),
        rtol=0, atol=TOL)
    # a plan built for `cuda` only quantizes at call time: the same result
    cuda_only = tsp.make_spgemm_plan(ar, ac, 40, br, bc, 64, 24, device=CPU,
                                     executors=("cuda",), **kw)
    assert cuda_only.cell_q8 is None
    assert torch.equal(tsb.spgemm(cuda_only, backend="cuda_q8"), got)


@pytest.mark.parametrize("swap", ["a", "b"])
def test_cuda_q8_spgemm_one_operand_swapped(swap):
    tp, jp, rng = _spgemm_case(8, seed=4)
    v = rng.normal(size=tp.nnz_a if swap == "a" else tp.nnz_b).astype(
        np.float32)
    targs = (_t(v), None) if swap == "a" else (None, _t(v))
    jargs = (jnp.asarray(v), None) if swap == "a" else (None, jnp.asarray(v))
    got = tsb.spgemm(tp, *targs, backend="cuda_q8")
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jsb.spgemm(jp, *jargs, backend="pallas_q8")),
        rtol=0, atol=TOL)
    # the same int8 cells the bake gives, quantized at call time
    cuda_only = tsp.make_spgemm_plan(
        np.asarray(tp.a_rows), np.asarray(tp.a_cols), tp.n_rows,
        np.asarray(tp.b_rows), np.asarray(tp.b_cols), tp.n_inner,
        a_vals=tp.a_base.numpy(), b_vals=tp.b_base.numpy(), width_cap=8,
        executors=("cuda",), device=CPU)
    assert torch.equal(tsb.spgemm(cuda_only, *targs, backend="cuda_q8"), got)


def _graphs(n=150, e=700, seed=5):
    s, r = powerlaw_graph(n, e, seed=seed)
    w = np.random.default_rng(seed).uniform(0.1, 1.0, s.size).astype(
        np.float32)
    return (tgraph.make_graph(s, r, n, edge_weight=w, device=CPU),
            jgraph.make_graph(s, r, n, edge_weight=w))


def _assert_graphs_equal(tg, jg, tol):
    for f in ("senders", "receivers", "edge_valid"):
        assert np.array_equal(getattr(tg, f).numpy(),
                              np.asarray(getattr(jg, f))), f
    np.testing.assert_allclose(tg.edge_weight.numpy(),
                               np.asarray(jg.edge_weight), rtol=0, atol=tol)


def test_two_hop_and_coarsen_match_pallas_q8():
    tg, jg = _graphs()
    _assert_graphs_equal(tsp.two_hop_graph(tg, backend="cuda_q8"),
                         jsp.two_hop_graph(jg, backend="pallas_q8"), TOL)
    clusters = np.random.default_rng(8).integers(0, 7, 150)
    _assert_graphs_equal(
        tgraph.coarsen_graph(tg, clusters, 7, backend="cuda_q8"),
        jgraph.coarsen_graph(jg, clusters, 7, backend="pallas_q8"), TOL)


def test_gcn_over_q8_two_hop_matches_reference():
    """The slice as a whole: Â² through ``cuda_q8`` SpGEMM, then a small
    GCN over it through ``cuda_q8`` aggregation."""
    from repro.configs import gcn_cora as jcfgs
    from repro.models.gnn import gcn as jgcn
    from repro_torch.configs import gcn_cora as tcfgs
    from repro_torch.convert import gcn_params_from_jax
    from repro_torch.models.gnn import gcn as tgcn
    s, r = powerlaw_graph(200, 900, alpha=1.6, seed=0)
    s2, r2, w = tgraph.sym_norm_weights(s, r, 200)
    tg = tgraph.make_graph(s2, r2, 200, edge_weight=w, device=CPU)
    jg = jgraph.make_graph(s2, r2, 200, edge_weight=w)
    tcfg = dataclasses.replace(tcfgs.reduced(), d_in=32)
    jcfg = dataclasses.replace(jcfgs.reduced(), d_in=32)
    jparams = jgcn.init_params(jax.random.key(0), jcfg)
    tparams = gcn_params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device=CPU)
    x = np.random.default_rng(1).normal(size=(201, 32)).astype(np.float32)
    tg2 = tsp.two_hop_graph(tg, backend="cuda_q8")
    jg2 = jsp.two_hop_graph(jg, backend="pallas_q8")
    _assert_graphs_equal(tg2, jg2, TOL)
    tp = tplan.plan_from_graph(tg2, backends=("cuda_q8",))
    jp = jplan.plan_from_graph(jg2, backends=("pallas_q8",))
    with torch.no_grad():
        got = tgcn.forward(tparams, tcfg, torch.from_numpy(x),
                           backend="cuda_q8", plan=tp)
    want = jgcn.forward(jparams, jcfg, jnp.asarray(x), backend="pallas_q8",
                        plan=jp)
    assert got.shape == (201, tcfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=STEP_TOL)
