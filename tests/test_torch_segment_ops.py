"""The port's order-fixed sums against the JAX reference, on the CPU:

* ``sparse.segment_ops`` — each op against ``repro.sparse.segment_ops`` on
  the same numpy inputs, with empty segments, −1e30 logits and ids equal to
  ``num_segments``, and their gradients against ``jax.grad``;
* the tile scatter (``sparse.plan.scatter_order``): a plan whose valid
  edges share cells scatters them layer by layer and gives the reference's
  ``plan_with_values`` tiles, bit for bit; a plan without shared cells keeps
  the one ``index_add_``;
* the ``dense``/``chunked`` stages (``core.spgemm``), which gather and
  merge through the segment ops' ordered ``gather`` and ``segment_sum``,
  against the reference; the orders a plan keeps (``AggregationPlan
  .order``), built once and reused by every later call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import backend as jsb
from repro.sparse import plan as jplan
from repro.sparse import segment_ops as jseg
from repro_torch.sparse import backend as tsb
from repro_torch.sparse import plan as tplan
from repro_torch.sparse import segment_ops as tseg

TOL = 1e-6
OPS = ("segment_sum", "segment_max", "segment_mean", "segment_softmax")


def _case(seed, n_seg, e, width):
    """ids with empty segments (1 and the last) and dropped ids
    (== n_seg), data with −1e30 entries (GAT's masked logits)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_seg + 1, e).astype(np.int32)
    ids[ids == 1] = 0
    ids[ids == n_seg - 1] = n_seg
    shape = (e,) if width is None else (e, width)
    x = rng.normal(size=shape).astype(np.float32)
    x[: e // 5] = -1e30
    return ids, x


def _both(a, b):
    """The finite entries equal within TOL, the non-finite ones alike."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    assert np.array_equal(a[~np.isfinite(a)], b[~np.isfinite(b)])
    fin = np.isfinite(a)
    np.testing.assert_allclose(b[fin], a[fin], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("seed,n_seg,e,width", [(0, 7, 40, None),
                                                (1, 12, 90, 3),
                                                (2, 5, 60, 8)])
def test_segment_op_matches_reference(op, seed, n_seg, e, width):
    ids, x = _case(seed, n_seg, e, width)
    if op in ("segment_sum", "segment_mean"):
        x = np.where(x < -1e29, 2.5, x).astype(np.float32)
    want = getattr(jseg, op)(jnp.asarray(x), jnp.asarray(ids), n_seg)
    got = getattr(tseg, op)(torch.from_numpy(x), torch.from_numpy(ids),
                            n_seg)
    _both(want, got.numpy())
    if op == "segment_max":               # empty segments are −inf
        assert np.isneginf(got.numpy()[1]).all()
    if op == "segment_sum":
        assert (got.numpy()[[1, n_seg - 1]] == 0).all()


@pytest.mark.parametrize("op", ("segment_sum", "segment_softmax",
                                "segment_mean"))
def test_segment_op_gradients_match_reference(op):
    ids, x = _case(3, 9, 70, 4)
    x = np.where(x < -1e29, -3.0, x).astype(np.float32)
    c = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    cj = jnp.asarray(c)
    n_out = x.shape[0] if op == "segment_softmax" else 9

    def jloss(v):
        y = getattr(jseg, op)(v, jnp.asarray(ids), 9)
        return (y * cj[:n_out]).sum()
    want = jax.grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = getattr(tseg, op)(xt, torch.from_numpy(ids), 9)
    (got,) = torch.autograd.grad((y * torch.from_numpy(c)[:n_out]).sum(),
                                 xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_gather_backward_adds_repeated_ids():
    """``gather``'s backward sums a repeated id's rows and equals jax's."""
    rng = np.random.default_rng(5)
    data = rng.normal(size=(6, 3)).astype(np.float32)
    ids = np.array([0, 2, 2, 5, 2, 0], np.int64)
    g = rng.normal(size=(6, 3)).astype(np.float32)
    want = jax.grad(lambda d: (d[jnp.asarray(ids)] * g).sum())(
        jnp.asarray(data))
    dt = torch.from_numpy(data).requires_grad_()
    y = tseg.gather(dt, torch.from_numpy(ids))
    (got,) = torch.autograd.grad(y, dt, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_clamps_out_of_range_ids_like_reference():
    """Ids below and above the range read the first and last row, and
    their gradients go there, as JAX's clamping gather and its VJP."""
    rng = np.random.default_rng(8)
    data = rng.normal(size=(5, 2)).astype(np.float32)
    ids = np.array([7, -2, 4, 0, 5, -1, 2, 4], np.int64)
    g = rng.normal(size=(8, 2)).astype(np.float32)
    jd = jnp.asarray(data)
    want_y = jd[jnp.clip(jnp.asarray(ids), 0, 4)]
    want = jax.grad(lambda d: (d[jnp.clip(jnp.asarray(ids), 0, 4)]
                               * g).sum())(jd)
    dt = torch.from_numpy(data).requires_grad_()
    y = tseg.gather(dt, torch.from_numpy(ids))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    (got,) = torch.autograd.grad(y, dt, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_segment_order_layout():
    """The order sorts entries by id, stably, with ids below the range
    first and above it last; each segment's bounds, and the gather's bounds
    with the out-of-range entries joined to the first and last segment."""
    ids = torch.tensor([2, 0, 5, 2, -1, 0, 3, 2])
    o = tseg.segment_order(ids, 4)
    assert o.perm.tolist() == [4, 1, 5, 0, 3, 7, 6, 2]
    assert o.sum_bounds.tolist() == [1, 3, 3, 6, 7]
    assert o.gather_bounds.tolist() == [0, 3, 3, 6, 8]
    assert o.read.tolist() == [2, 0, 3, 2, 0, 0, 3, 2]
    with pytest.raises(ValueError, match="segments"):
        tseg.segment_sum(torch.ones(8), ids, 5, o)


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean",
                                "segment_softmax"])
def test_kept_order_equals_order_per_call(op):
    """An op handed a kept order gives the bits (values and gradient) it
    gives when it builds the order itself."""
    ids, x = _case(9, 11, 80, 3)
    x = np.where(x < -1e29, 1.5, x).astype(np.float32)
    it = torch.from_numpy(ids)
    order = tseg.segment_order(it, 11)
    out = []
    for o in (None, order):
        xt = torch.from_numpy(x).requires_grad_()
        y = getattr(tseg, op)(xt, it, 11, o)
        out.append((y.detach(), torch.autograd.grad(y.sum() + (y * y).sum(),
                                                    xt)[0]))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["dense", "chunked"])
def test_plan_keeps_its_orders(backend, monkeypatch):
    """A plan builds the order of its rows and of its cols once (per wave
    for ``chunked``), and the executors reuse them: a second aggregation
    sorts nothing."""
    s, r, valid, rng = _repeated_graph()
    tp = tplan.make_plan(s, r, 31, edge_valid=valid, device="cpu", chunk=64)
    x = torch.from_numpy(rng.normal(size=(31, 4)).astype(np.float32))
    first = tsb.aggregate(tp, None, x, backend=backend)
    n_orders = len(tp.orders)
    assert n_orders == (2 if backend == "dense" else 2 * 4)
    sorts = []
    real = torch.argsort
    monkeypatch.setattr(torch, "argsort",
                        lambda *a, **k: sorts.append(1) or real(*a, **k))
    again = tsb.aggregate(tplan.plan_with_values(tp), None, x,
                          backend=backend)
    assert sorts == [] and len(tp.orders) == n_orders
    assert torch.equal(first, again)


def test_pad_drop_and_normalize_match_reference():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(10, 4)).astype(np.float32)
    valid = rng.random(10) > 0.4
    counts = np.array([0, 1, 2, 5, 0, 3, 1, 7, 2, 4], np.int32)
    np.testing.assert_array_equal(
        tseg.pad_segment_drop(torch.from_numpy(x),
                              torch.from_numpy(valid)).numpy(),
        np.asarray(jseg.pad_segment_drop(jnp.asarray(x),
                                         jnp.asarray(valid))))
    for power in (1.0, 0.5):
        np.testing.assert_allclose(
            tseg.segment_normalize(torch.from_numpy(x),
                                   torch.from_numpy(counts), power).numpy(),
            np.asarray(jseg.segment_normalize(jnp.asarray(x),
                                              jnp.asarray(counts), power)),
            rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the tile scatter
# ---------------------------------------------------------------------------

def _repeated_graph(n=30, e=200, seed=7, n_invalid=15):
    """Edges whose (sender, receiver) pairs repeat up to four times."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    s[:4], r[:4] = 5, 9                   # one cell, four edges
    s[10:13], r[10:13] = 2, 3             # another, three
    s[20], r[20] = s[21], r[21]           # a pair
    valid = np.ones(e, bool)
    valid[rng.choice(np.arange(30, e), n_invalid, replace=False)] = False
    return s, r, valid, rng


def test_scatter_order_layers():
    """Layer 0 and each later layer give every cell at most one edge, and
    the layers hold each valid edge exactly once, ranked in edge order."""
    slots = np.array([4, 9, 4, 2, 4, 9, 12, 7], np.int64)   # 12: dropped
    first, edges, cells, bounds = tplan.scatter_order(slots, 12)
    assert first.tolist() == [4, 9, 12, 2, 12, 12, 12, 7]
    assert edges.tolist() == [2, 5, 4] and cells.tolist() == [4, 9, 4]
    assert bounds == (2, 3)
    assert tplan.scatter_order(np.array([3, 1, 0, 12, 12]), 12) is None


@pytest.mark.parametrize("width_cap", [128, 8])
def test_repeated_cells_scatter_like_reference(width_cap):
    """A plan whose valid edges share cells: ``plan_with_values``' forward
    tiles equal the reference's bit for bit, and so do the transpose tiles
    scattered in the plan's order against the sequential scatter."""
    s, r, valid, rng = _repeated_graph()
    kw = dict(edge_valid=valid, width_cap=width_cap)
    tp = tplan.make_plan(s, r, 31, backends=("dense", "cuda"), device="cpu",
                         **kw)
    jp = jplan.make_plan(s, r, 31, backends=("dense", "pallas"), **kw)
    assert tp.ell_first_slots is not None and len(tp.ell_dup_bounds) == 3
    assert tp.ell_t_first_slots is not None
    w = rng.normal(size=s.shape[0]).astype(np.float32)
    got = tplan.plan_with_values(tp, torch.from_numpy(w))
    want = jplan.plan_with_values(jp, jnp.asarray(w))
    np.testing.assert_array_equal(got.ell_a.numpy(), np.asarray(want.ell_a))
    seq = torch.zeros(tp.ell_t_a.numel() + 1).index_add_(
        0, tp.ell_t_slots, torch.from_numpy(np.where(valid, w, 0)))
    np.testing.assert_array_equal(
        tplan.transpose_tiles(tp, torch.from_numpy(w)).numpy().ravel(),
        seq[:-1].numpy())


def test_tree_layout_keeps_one_scatter():
    """A serving bucket's tree layout gives each edge its own cell: no
    scatter order is kept, so ``plan_with_values`` stays one
    ``index_add_``."""
    from repro_torch.serve.buckets import build_bucket_structure
    struct = build_bucket_structure(16, (5, 3))
    p = tplan.make_plan(struct.senders, struct.receivers, struct.n_nodes,
                        backends=("cuda",), device="cpu")
    assert p.ell_first_slots is None and p.ell_t_first_slots is None
    assert p.ell_dup_bounds == () and p.ell_t_dup_bounds == ()


def test_repeated_cells_value_gradients_match_reference():
    """Traced edge values through the layered scatter: d(vals) and dX on
    ``cuda`` equal the reference's ``pallas`` VJP (interpret mode)."""
    s, r, valid, rng = _repeated_graph(e=120)
    tp = tplan.make_plan(s, r, 31, edge_valid=valid, backends=("cuda",),
                         device="cpu")
    jp = jplan.make_plan(s, r, 31, edge_valid=valid, backends=("pallas",))
    x = rng.normal(size=(31, 8)).astype(np.float32)
    v = rng.normal(size=s.shape[0]).astype(np.float32)
    c = rng.normal(size=(31, 8)).astype(np.float32)
    gv_j, gx_j = jax.grad(
        lambda vv, xx: (jsb.aggregate(jp, vv, xx, backend="pallas")
                        * c).sum(), argnums=(0, 1))(jnp.asarray(v),
                                                    jnp.asarray(x))
    vt = torch.from_numpy(v).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y = tsb.aggregate(tp, vt, xt, backend="cuda")
    gv, gx = torch.autograd.grad((y * torch.from_numpy(c)).sum(), (vt, xt))
    np.testing.assert_allclose(gv.numpy(), np.asarray(gv_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["dense", "chunked"])
def test_dense_stages_match_reference_with_gradients(backend):
    """The order-fixed ``dense``/``chunked`` stages: forward and both
    gradients equal the reference's ``dense`` executor."""
    s, r, valid, rng = _repeated_graph()
    tp = tplan.make_plan(s, r, 31, edge_valid=valid, device="cpu", chunk=64)
    jp = jplan.make_plan(s, r, 31, edge_valid=valid, chunk=64)
    x = rng.normal(size=(31, 5)).astype(np.float32)
    v = rng.normal(size=s.shape[0]).astype(np.float32)
    c = rng.normal(size=(31, 5)).astype(np.float32)
    want = jsb.aggregate(jp, jnp.asarray(v), jnp.asarray(x), backend="dense")
    gv_j, gx_j = jax.grad(
        lambda vv, xx: (jsb.aggregate(jp, vv, xx, backend="dense")
                        * c).sum(), argnums=(0, 1))(jnp.asarray(v),
                                                    jnp.asarray(x))
    vt = torch.from_numpy(v).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y = tsb.aggregate(tp, vt, xt, backend=backend)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    gv, gx = torch.autograd.grad((y * torch.from_numpy(c)).sum(), (vt, xt))
    np.testing.assert_allclose(gv.numpy(), np.asarray(gv_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), rtol=1e-5,
                               atol=1e-5)


def test_plan_orders_follow_the_plan_tensors():
    """A plan copied with other row and col tensors (another device, as
    ``dataclasses.replace`` makes it) builds its own orders, even though
    it shares the original's order store."""
    import dataclasses
    s, r, valid, rng = _repeated_graph()
    tp = tplan.make_plan(s, r, 31, edge_valid=valid, device="cpu")
    x = torch.from_numpy(rng.normal(size=(31, 4)).astype(np.float32))
    first = tsb.aggregate(tp, None, x, backend="dense")
    copy = dataclasses.replace(tp, rows=tp.rows.clone(),
                               cols=tp.cols.clone())
    assert copy.orders is tp.orders
    assert torch.equal(tsb.aggregate(copy, None, x, backend="dense"), first)
    assert copy.order("rows").perm is not tp.order("rows").perm
    assert len(tp.orders) == 4
