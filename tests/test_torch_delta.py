"""The port's incremental re-pack (``repro_torch.sparse.delta``) against a
cold re-pack and against the reference's ``repro.sparse.delta``, on the
CPU:

* the counterparts of ``tests/test_delta.py``'s nine tests, with the same
  hypothesis budget: after any interleaving of inserts, deletes and
  flushes, the CSR, both dedup-chunk layouts and the whole plan equal a
  cold pack, every field of the port's plan included (``*_block_ptr``,
  the layered tile scatter, ``ell_a_q8``/``ell_a_scale``), and
  ``aggregate`` on all four executors gives the cold plan's bits;
* the port's and the reference's delta states on the same scripted
  interleavings give bitwise-equal CSRs, layouts, chunk stats and flush
  results;
* ``aggregate`` through the incremental plan is ≤1e-5 from the
  reference's incremental plan through ``pallas`` (interpret mode), and
  ``cuda_q8`` is within ``q8_gate`` of ``pallas_q8``;
* ``pallas`` and ``distributed`` have no incremental path here and raise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                                       # pragma: no cover
    from _hypothesis_shim import given, settings, st

from repro.sparse import backend as jsb
from repro.sparse import delta as jdelta
from repro_torch.kernels.gustavson_spmm import auto_d_tile
from repro_torch.sparse import backend as tsb
from repro_torch.sparse import quantize as tq
from repro_torch.sparse.delta import (DELTA_BACKENDS, DeltaGraphError,
                                      DeltaGraphState, chunks_match,
                                      plans_match)
from repro_torch.sparse.graph import coo_to_csr
from repro_torch.sparse.plan import AggregationPlan

N = 24          # node count: small enough that collisions/hubs are common
CPU = "cpu"
ALL = ("dense", "chunked", "cuda", "cuda_q8")
TOL = 1e-5


def _seed_graph(seed, e=64):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N, e)
    r = rng.integers(0, N, e)
    w = rng.normal(size=e).astype(np.float32)
    return s, r, w, rng


def _assert_cold_parity(d: DeltaGraphState, seed=0):
    # CSR bitwise against a cold sort of the compacted canonical arrays,
    # and against the CSR the cold re-pack hands the flush's proof
    indptr, indices = d.csr()
    ci, cc, _ = coo_to_csr(d._s, d._r, d.n_nodes)
    np.testing.assert_array_equal(indptr, ci)
    np.testing.assert_array_equal(indices, cc)
    cold_fwd, cold_tr, cold_csr = d.cold_repack()
    for a, b in zip((indptr, indices), cold_csr):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # chunk layouts bitwise against a cold pack
    for inc, cold in zip(d.repack(), (cold_fwd, cold_tr)):
        ok, detail = chunks_match(inc, cold, tol=0.0)
        assert ok, detail
    # the whole plan, every field, bitwise
    pa = d.plan(backends=ALL, device=CPU)
    pb = d.cold_plan(backends=ALL, device=CPU)
    ok, detail = plans_match(pa, pb, tol=0.0)
    assert ok, detail
    names = {f.name for f in dataclasses.fields(AggregationPlan)} - {"orders"}
    assert {k.removesuffix("_dev") for k in detail} == names
    # aggregate through every executor gives the cold plan's bits
    rng = np.random.default_rng(seed + 999)
    x = torch.from_numpy(rng.normal(size=(pa.n_rows, 8)).astype(np.float32))
    for be in ALL:
        assert torch.equal(tsb.aggregate(pa, None, x, backend=be),
                           tsb.aggregate(pb, None, x, backend=be)), be
    # the stats the plan records agree with make_plan's view
    stats = d.chunk_stats()
    assert stats["n_chunks"] == cold_fwd.u_cols.shape[0]
    assert stats["chunk_width"] == cold_fwd.u_cols.shape[1]


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000),
       st.lists(st.sampled_from(["ins", "del", "flush"]),
                min_size=4, max_size=40))
def test_random_interleaving_matches_cold_pack(seed, script):
    s, r, w, rng = _seed_graph(seed)
    d = DeltaGraphState(s, r, N, weights=w)
    for op in script:
        if op == "ins":
            d.insert_edge(int(rng.integers(0, N)), int(rng.integers(0, N)),
                          float(rng.normal()))
        elif op == "del" and d.n_edges + d.pending > 1:
            k = int(rng.integers(0, d._s.size))
            try:
                d.delete_edge(int(d._s[k]), int(d._r[k]))
            except DeltaGraphError:
                pass          # every copy already booked for deletion
        else:
            d.flush()
    d.flush()
    _assert_cold_parity(d, seed)


def test_empty_delta_flush_is_identity():
    s, r, w, _ = _seed_graph(3)
    d = DeltaGraphState(s, r, N, weights=w)
    before = d.csr()
    res = d.flush()                       # nothing buffered
    assert (res.inserted, res.deleted, res.dirty_blocks) == (0, 0, 0)
    assert res.epoch == 1
    after = d.csr()
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])
    _assert_cold_parity(d)


def test_delete_all_edges_of_a_row():
    s, r, w, _ = _seed_graph(5, e=48)
    d = DeltaGraphState(s, r, N, weights=w)
    row = int(r[0])                        # receiver row = CSR row
    for k in np.nonzero(r == row)[0]:
        d.delete_edge(int(s[k]), int(r[k]))
    d.flush()
    indptr, _ = d.csr()
    assert indptr[row + 1] - indptr[row] == 0
    _assert_cold_parity(d)


def test_delete_every_edge_then_rebuild():
    s, r, w, rng = _seed_graph(7, e=20)
    d = DeltaGraphState(s, r, N, weights=w)
    for k in range(s.size):
        d.delete_edge(int(s[k]), int(r[k]))
    d.flush()
    assert d.n_edges == 0
    _assert_cold_parity(d)
    for _ in range(16):
        d.insert_edge(int(rng.integers(0, N)), int(rng.integers(0, N)))
    d.flush()
    assert d.n_edges == 16
    _assert_cold_parity(d)


def test_delete_absent_edge_raises_and_leaves_state_clean():
    d = DeltaGraphState(np.array([0, 1]), np.array([1, 2]), 4)
    with pytest.raises(DeltaGraphError):
        d.delete_edge(3, 3)
    d.delete_edge(0, 1)
    with pytest.raises(DeltaGraphError):
        d.delete_edge(0, 1)                # only copy already booked
    assert d.pending == 1
    d.flush()
    assert d.n_edges == 1
    _assert_cold_parity(d)


def test_insert_cancelled_by_delete_before_flush():
    d = DeltaGraphState(np.array([0]), np.array([1]), 4)
    d.insert_edge(2, 3)
    d.delete_edge(2, 3)                    # cancels the pending insert
    assert d.pending == 0
    d.flush()
    assert d.n_edges == 1
    _assert_cold_parity(d)


def test_out_of_range_mutations_rejected():
    d = DeltaGraphState(np.array([0]), np.array([1]), 4)
    with pytest.raises(DeltaGraphError):
        d.insert_edge(4, 0)
    with pytest.raises(DeltaGraphError):
        d.insert_edge(0, -1)


@pytest.mark.parametrize("backend", ["distributed", "pallas", "pallas_q8"])
def test_backend_without_delta_path_raises(backend):
    s, r, w, _ = _seed_graph(11)
    d = DeltaGraphState(s, r, N, weights=w)
    with pytest.raises(DeltaGraphError) as ei:
        d.plan(backends=("dense", backend), device=CPU)
    assert str(DELTA_BACKENDS) in str(ei.value)


def test_incremental_beats_cold_on_sparse_deltas():
    """Sanity (not the speed gate — chip_smoke.py's phase 19 records it):
    a small delta on a big graph re-chunks only the dirty blocks."""
    rng = np.random.default_rng(0)
    n, e = 4096, 60_000
    d = DeltaGraphState(rng.integers(0, n, e), rng.integers(0, n, e), n)
    for _ in range(32):
        d.insert_edge(int(rng.integers(0, n)), int(rng.integers(0, n)))
    res = d.flush()
    assert res.dirty_blocks < res.clean_blocks


# ---------------------------------------------------------------------------
# Against the reference's delta state
# ---------------------------------------------------------------------------

def _scripted_pair(seed, n_ops=60, n=N, e=64, width_cap=128):
    """The port's and the reference's states driven by one script; each
    flush result compared as it comes."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    td = DeltaGraphState(s, r, n, weights=w, width_cap=width_cap)
    jd = jdelta.DeltaGraphState(s, r, n, weights=w, width_cap=width_cap)
    for _ in range(n_ops):
        op = rng.choice(["ins", "ins", "del", "flush"])
        if op == "ins":
            a, b, v = (int(rng.integers(0, n)), int(rng.integers(0, n)),
                       float(rng.normal()))
            td.insert_edge(a, b, v)
            jd.insert_edge(a, b, v)
        elif op == "del" and td.n_edges:
            k = int(rng.integers(0, td._s.size))
            a, b = int(td._s[k]), int(td._r[k])
            got = want = None
            try:
                td.delete_edge(a, b)
            except DeltaGraphError as exc:
                got = type(exc)
            try:
                jd.delete_edge(a, b)
            except jdelta.DeltaGraphError as exc:
                want = type(exc)
            assert (got is None) == (want is None)
        else:
            assert (dataclasses.asdict(td.flush())
                    == dataclasses.asdict(jd.flush()))
        assert td.pending == jd.pending
    assert dataclasses.asdict(td.flush()) == dataclasses.asdict(jd.flush())
    return td, jd


@pytest.mark.parametrize("seed,width_cap", [(0, 128), (1, 8), (2, 4)])
def test_layouts_bitwise_equal_reference(seed, width_cap):
    td, jd = _scripted_pair(seed, width_cap=width_cap)
    for a, b in zip(td.csr(), jd.csr()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for inc in (lambda d: d.repack(), lambda d: d.cold_repack()[:2]):
        for a, b in zip(inc(td), inc(jd)):
            for f in ("u_cols", "remaining", "out_block", "first", "slots",
                      "a"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert td.chunk_stats() == jd.chunk_stats()
    assert (td.n_edges, td.epoch) == (jd.n_edges, jd.epoch)


@pytest.mark.parametrize("seed,width_cap,d", [(3, 128, 16), (4, 8, 32)])
def test_aggregate_through_incremental_plan_equals_reference(seed,
                                                             width_cap, d):
    td, jd = _scripted_pair(seed, n=40, e=150, width_cap=width_cap)
    tp = td.plan(backends=ALL, device=CPU)
    ok, detail = plans_match(tp, td.cold_plan(backends=ALL, device=CPU),
                             tol=0.0)
    assert ok, detail
    jp = jd.plan(backends=("dense", "chunked", "pallas", "pallas_q8"))
    x = np.random.default_rng(seed).normal(size=(tp.n_rows, d)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    want = np.asarray(jsb.aggregate(jp, None, jnp.asarray(x),
                                    backend="pallas"))
    for be in ("dense", "chunked", "cuda"):
        got = tsb.aggregate(tp, None, xt, backend=be).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    got = tsb.aggregate(tp, None, xt, backend="cuda_q8")
    want_q8 = np.asarray(jsb.aggregate(jp, None, jnp.asarray(x),
                                       backend="pallas_q8"))
    _, xs = tq.quantize_feature_tiles(xt, auto_d_tile(d))
    bound = tq.aggregate_q8_bound(tp.ell_remaining, tp.ell_out_block,
                                  tp.n_blocks, tp.ell_a_scale, xs)
    assert tq.q8_gate(float(np.abs(got.numpy() - want_q8).max()), bound)
    np.testing.assert_allclose(got.numpy(), want_q8, rtol=0, atol=TOL)
    for f in ("ell_a_q8", "ell_a_scale"):
        assert np.array_equal(getattr(tp, f).numpy(),
                              np.asarray(getattr(jp, f))), f


def test_plans_match_sees_a_drift_in_the_port_fields():
    """A plan whose tile scatter layers, block ranges or int8 tiles drift
    fails ``plans_match`` even with every reference field equal."""
    td, _ = _scripted_pair(5, n=40, e=150, width_cap=4)
    pa = td.plan(backends=ALL, device=CPU)
    pb = td.cold_plan(backends=ALL, device=CPU)
    assert pa.ell_dup_edges is not None       # duplicates share cells
    for f, bad in (("ell_block_ptr", pb.ell_block_ptr.flip(0)),
                   ("ell_dup_edges", pb.ell_dup_edges.flip(0)),
                   ("ell_dup_bounds", pb.ell_dup_bounds[::-1] + (0,)),
                   ("ell_a_q8", pb.ell_a_q8 + 1)):
        ok, detail = plans_match(pa, dataclasses.replace(pb, **{f: bad}))
        assert not ok and detail[f] is False, f
    ok, detail = plans_match(pa, dataclasses.replace(
        pb, ell_a_scale=pb.ell_a_scale * 1.5))
    assert not ok and detail["ell_a_scale_dev"] > 0
