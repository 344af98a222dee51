"""The port's plan layer and backend registry against the JAX reference:
``make_plan``/``plan_with_values`` arrays equal, every executor equal to
the reference's ``dense`` and ``pallas`` (≤1e-5), padding dropped."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import backend as jsb
from repro.sparse import plan as jplan
from repro_torch.sparse import backend as tsb
from repro_torch.sparse import plan as tplan

TOL = 1e-5
ELL = ("u_cols", "remaining", "out_block", "first", "a", "slots")


def _graph(n=45, e=260, seed=0, n_invalid=20):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    s[:3], r[:3] = 5, 9                   # duplicate edges share a cell
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    valid = np.ones(e, bool)
    valid[rng.choice(e, n_invalid, replace=False)] = False
    return s, r, w, valid, rng


def _plans(s, r, n_rows, **kw):
    tp = tplan.make_plan(s, r, n_rows, backends=("dense", "chunked", "cuda"),
                         device="cpu", **kw)
    jp = jplan.make_plan(s, r, n_rows, backends=("dense", "chunked",
                                                 "pallas"), **kw)
    return tp, jp


def _assert_plans_equal(tp, jp):
    for f in ("rows", "cols", "valid", "base_vals"):
        assert np.array_equal(getattr(tp, f).numpy(),
                              np.asarray(getattr(jp, f))), f
    for pre in ("ell_", "ell_t_"):
        for f in ELL:
            a = getattr(tp, pre + f).numpy()
            b = np.asarray(getattr(jp, pre + f))
            assert a.shape == b.shape and np.array_equal(a, b), pre + f
    assert (tp.n_blocks, tp.n_t_blocks, tp.block_rows) == \
        (jp.n_blocks, jp.n_t_blocks, jp.block_rows)
    ptr = tp.ell_block_ptr.numpy()
    assert ptr.shape == (tp.n_blocks + 1,) and ptr[-1] == tp.ell_u_cols.shape[0]
    ob = np.asarray(jp.ell_out_block)
    assert np.array_equal(ob[ptr[:-1]], np.arange(tp.n_blocks))


@pytest.mark.parametrize("width_cap", [128, 8])
def test_make_plan_equals_reference(width_cap):
    s, r, w, valid, _ = _graph()
    tp, jp = _plans(s, r, 46, edge_weight=w, edge_valid=valid,
                    width_cap=width_cap)
    _assert_plans_equal(tp, jp)
    # invalid edges carry the out-of-bounds slot (dropped on scatter)
    assert (tp.ell_slots.numpy()[~valid] == tp.ell_a.numel()).all()


def test_make_plan_records_layout_stats():
    from repro_torch.sparse import stats
    stats.reset()
    s, r, w, valid, _ = _graph()
    tp, _ = _plans(s, r, 46, edge_weight=w, edge_valid=valid, width_cap=8)
    snap = stats.kernel_stats().snapshot()
    assert snap["counters"]["plan.dedup_packs"] == 2
    assert snap["series"]["plan.n_chunks"]["max"] == tp.ell_u_cols.shape[0]
    assert snap["series"]["plan.hub_splits"]["max"] == \
        tp.ell_u_cols.shape[0] - tp.n_blocks


def test_plan_with_values_equals_reference():
    s, r, w, _, rng = _graph(n_invalid=0)
    tp, jp = _plans(s, r, 46)
    w2 = rng.normal(size=s.shape[0]).astype(np.float32)
    v2 = rng.random(s.shape[0]) > 0.3
    tq = tplan.plan_with_values(tp, torch.from_numpy(w2),
                                torch.from_numpy(v2))
    jq = jplan.plan_with_values(jp, jnp.asarray(w2), jnp.asarray(v2))
    for f in ("valid", "base_vals", "ell_a"):
        np.testing.assert_allclose(getattr(tq, f).numpy(),
                                   np.asarray(getattr(jq, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    # inference reads only the forward tiles: the transpose tiles are
    # dropped, not left stale, and re-value through their slot map to the
    # reference's
    assert tq.ell_t_a is None
    t_a = tplan.scatter_tiles(tp.ell_t_a, tp.ell_t_slots, tq.base_vals)
    np.testing.assert_allclose(t_a.numpy(), np.asarray(jq.ell_t_a), rtol=0,
                               atol=1e-6, err_msg="ell_t_a")


@pytest.mark.parametrize("backend", ["dense", "chunked", "cuda"])
@pytest.mark.parametrize("traced_vals", [False, True])
def test_aggregate_matches_reference(backend, traced_vals):
    s, r, w, valid, rng = _graph(seed=3)
    tp, jp = _plans(s, r, 46, edge_weight=w, edge_valid=valid, chunk=64)
    x = rng.normal(size=(46, 12)).astype(np.float32)
    vals = rng.normal(size=s.shape[0]).astype(np.float32) \
        if traced_vals else None
    got = tsb.aggregate(tp, None if vals is None else torch.from_numpy(vals),
                        torch.from_numpy(x), backend=backend)
    jv = None if vals is None else jnp.asarray(vals)
    for jb in ("dense", "pallas"):
        want = np.asarray(jsb.aggregate(jp, jv, jnp.asarray(x), backend=jb))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL,
                                   err_msg=jb)


def test_padding_edges_pointing_past_the_rows_drop():
    # COO padding convention: padding lanes point at row n_rows (a ghost
    # row outside the plan); JAX drops them, the port must too
    s, r, w, valid, rng = _graph(seed=4)
    r = r.copy()
    r[~valid] = 46
    tp = tplan.make_plan(s, r, 46, edge_weight=w, edge_valid=valid,
                         backends=("dense", "chunked"), device="cpu")
    jp = jplan.make_plan(s, r, 46, edge_weight=w, edge_valid=valid)
    x = rng.normal(size=(46, 4)).astype(np.float32)
    want = np.asarray(jsb.aggregate(jp, None, jnp.asarray(x)))
    for b in ("dense", "chunked"):
        got = tsb.aggregate(tp, None, torch.from_numpy(x), backend=b)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("backend", ["dense", "chunked", "cuda"])
def test_accumulate_matches_reference(backend):
    s, r, w, valid, rng = _graph(seed=5)
    tp, jp = _plans(s, r, 46, edge_weight=w, edge_valid=valid, chunk=50)
    m = rng.normal(size=(s.shape[0], 3)).astype(np.float32)
    got = tsb.accumulate(tp, torch.from_numpy(m), backend=backend)
    want = np.asarray(jsb.accumulate(jp, jnp.asarray(m)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_guards():
    s, r, w, valid, _ = _graph()
    tp, _ = _plans(s, r, 46, edge_weight=w, edge_valid=valid)
    with pytest.raises(ValueError, match="n_rows=46"):
        tsb.aggregate(tp, None, torch.zeros(45, 4), backend="dense")
    with pytest.raises(ValueError, match="messages"):
        tsb.accumulate(tp, torch.zeros(3, 4))
    with pytest.raises(KeyError):
        tsb.aggregate(tp, None, torch.zeros(46, 4), backend="pallas")
    with pytest.raises(KeyError):
        tplan.make_plan(s, r, 46, backends=("pallas",), device="cpu")
    coo_only = tplan.edge_plan(torch.from_numpy(s), torch.from_numpy(r), 46)
    with pytest.raises(tplan.BackendPlanError):
        tsb.aggregate(coo_only, None, torch.zeros(46, 4), backend="cuda")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s, r, _, _, _ = _graph()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplan.make_plan(s, r, 46)
    from repro_torch.serve.compute import FeatureStore
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FeatureStore.build(4, np.zeros((4, 2), np.float32))
    assert tplan.make_plan(s, r, 46, device="cpu").device.type == "cpu"
