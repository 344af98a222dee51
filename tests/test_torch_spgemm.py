"""The port's SpGEMM engine against the JAX reference on the CPU: the
symbolic phase and every ``SpgemmPlan`` array bitwise equal, the
``spgemm_hashpad`` plain version against the reference's Pallas kernel
(interpret mode) and its oracle (≤1e-5), every executor against the
reference's ``dense`` and ``pallas`` (≤1e-4), Â² / coarsening, the caches,
and a small GCN over Â² (≤1e-4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eviction as jev
from repro.core import spgemm as jcore
from repro.data.synthetic import powerlaw_graph
from repro.kernels.spgemm_pad.ref import spgemm_hashpad_ref
from repro.kernels.spgemm_pad.spgemm_pad import \
    spgemm_hashpad as jax_hashpad
from repro.models.gnn import gcn as jgcn
from repro.sparse import backend as jsb
from repro.sparse import graph as jgraph
from repro.sparse import plan as jplan
from repro.sparse import spgemm as jsp
from repro_torch.convert import gcn_params_from_jax
from repro_torch.core import eviction as tev
from repro_torch.core import spgemm as tcore
from repro_torch.kernels.spgemm_pad import (spgemm_hashpad,
                                            spgemm_hashpad_compact_plain,
                                            spgemm_hashpad_plain,
                                            spgemm_hashpad_q8,
                                            spgemm_hashpad_q8_compact_plain,
                                            spgemm_hashpad_q8_plain)
from repro_torch.models.gnn import gcn as tgcn
from repro_torch.sparse import backend as tsb
from repro_torch.sparse import graph as tgraph
from repro_torch.sparse import plan as tplan
from repro_torch.sparse import spgemm as tsp
from repro_torch.sparse.spgemm import numeric as tnum
from spgemm_cells import drop_block_chunks, with_dead_lane_cells

KERNEL_TOL = 1e-5
EXEC_TOL = 1e-4
CPU = "cpu"


def _coo(rng, n_rows, n_cols, e):
    return (rng.integers(0, n_rows, e), rng.integers(0, n_cols, e),
            rng.normal(size=e).astype(np.float32))


def _case(name):
    """(a_rows, a_cols, n_rows, b_rows, b_cols, n_inner, n_cols, av, bv)."""
    rng = np.random.default_rng(len(name))
    if name == "powerlaw":
        s, r = powerlaw_graph(160, 900, seed=9)
        av = rng.normal(size=s.size).astype(np.float32)
        bv = rng.normal(size=s.size).astype(np.float32)
        return r, s, 160, r, s, 160, 160, av, bv
    if name == "rectangular":
        ar, ac, av = _coo(rng, 24, 50, 90)
        br, bc, bv = _coo(rng, 50, 9, 70)
        return ar, ac, 24, br, bc, 50, 9, av, bv
    if name == "empty_rows":
        ar = np.array([2, 2, 5, 5, 5, 13], np.int64)
        ac = np.array([0, 1, 1, 4, 4, 2], np.int64)   # a duplicate entry
        av = rng.normal(size=6).astype(np.float32)
        return ar, ac, 17, ar, ac, 17, 17, av, av
    raise KeyError(name)


CASES = ("powerlaw", "rectangular", "empty_rows")


def _plans(name, **kw):
    ar, ac, n, br, bc, m, k, av, bv = _case(name)
    jp = jsp.make_spgemm_plan(ar, ac, n, br, bc, m, k, a_vals=av, b_vals=bv,
                              executors=("dense", "reference", "pallas",
                                         "pallas_q8"),
                              chunk=64, **kw)
    tp = tsp.make_spgemm_plan(ar, ac, n, br, bc, m, k, a_vals=av, b_vals=bv,
                              chunk=64, device=CPU, **kw)
    return tp, jp


# ---------------------------------------------------------------------------
# symbolic phase and plan layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_width", [8, 64, 4096])
def test_hash_bucket_and_block_gammas_equal_reference(pad_width):
    rng = np.random.default_rng(pad_width)
    cols = rng.integers(0, 1 << 20, 300)
    gam = np.array([1, 3, 0x9E3779B1, 2 ** 31 - 1], np.uint32)
    for g in gam:
        assert np.array_equal(tsp.hash_bucket(cols, g, pad_width),
                              jsp.hash_bucket(cols, g, pad_width))
    per = rng.choice(gam, cols.size)
    assert np.array_equal(tsp.hash_bucket(cols, per, pad_width),
                          jsp.hash_bucket(cols, per, pad_width))
    s, r = powerlaw_graph(120, 700, seed=3)
    sym = jsp.symbolic(r, s, 120, r, s, 120)
    for seed in (0, 5):
        got = tsp.find_block_gammas(sym.c_indptr, sym.c_col, 120, 8,
                                    pad_width, seed=seed)
        want = jsp.find_block_gammas(sym.c_indptr, sym.c_col, 120, 8,
                                     pad_width, seed=seed)
        assert got[1:] == want[1:]
        assert (got[0] is None) == (want[0] is None)
        if got[0] is not None:
            assert np.array_equal(got[0], want[0])


@pytest.mark.parametrize("name", CASES)
def test_symbolic_equals_reference(name):
    ar, ac, n, br, bc, m, k, _, _ = _case(name)
    got = tsp.symbolic(ar, ac, n, br, bc, m, k)
    want = jsp.symbolic(ar, ac, n, br, bc, m, k)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert got.bloat_pct == want.bloat_pct
    assert got.pp_interim == tev.interim_pp_count(
        np.asarray(ac), np.bincount(br, minlength=m))


# the port's own plan fields: live-lane counts, chunk ranges, B's cells
PORT_FIELDS = ("ell_remaining", "ell_block_ptr", "n_cells", "cell_ptr",
               "cell_lane", "cell_bucket", "cell_val", "cell_src",
               "cell_src_ptr", "cell_q8")


@pytest.mark.parametrize("name", CASES)
def test_make_spgemm_plan_bitwise_equal(name):
    tp, jp = _plans(name)
    # the reference's dense int8 slab, from the port's int8 cells
    slab_q8 = np.asarray(jp.slab_q8)
    got_q8 = tnum.hashed_slab_q8(tp).numpy()
    assert got_q8.dtype == slab_q8.dtype and np.array_equal(got_q8, slab_q8)
    n_tensors = 1
    for f in dataclasses.fields(tp):
        a = getattr(tp, f.name)
        if f.name in PORT_FIELDS:
            continue
        b = getattr(jp, f.name)
        if isinstance(a, torch.Tensor):
            b = np.asarray(b)
            assert a.device.type == "cpu"
            assert a.numpy().dtype == b.dtype, f.name
            assert a.shape == b.shape and np.array_equal(a.numpy(), b), \
                f.name
            n_tensors += 1
        else:
            assert a == b, f.name
    assert n_tensors == 28                    # 4 of them the int8 bake
    assert tp.peak_live_pp == jp.peak_live_pp
    assert tp.bloat_pct == jp.bloat_pct
    # the two arrays the reference drops: the packer's live-lane counts and
    # each block's chunk range, derived from the first-chunk flags
    ob = np.asarray(jp.ell_out_block)
    ptr = tp.ell_block_ptr.numpy()
    assert ptr.shape == (tp.n_blocks + 1,) and ptr[-1] == tp.n_chunks
    assert np.array_equal(ob[ptr[:-1]], np.arange(tp.n_blocks))
    ar, ac, n, _, _, m, _, av, _ = _case(name)
    ch = jgraph.pack_dedup_chunks(ar, ac, av, n, m)
    assert np.array_equal(tp.ell_remaining.numpy(), ch.remaining)


def test_pad_growth_and_reseed_match_reference():
    """Stride-2¹⁶ columns force reseeds; a tight pad forces growth."""
    ar = np.zeros(16, np.int64)
    ac = np.arange(16, dtype=np.int64)
    br = np.arange(16, dtype=np.int64)
    bc = np.arange(16, dtype=np.int64) << 16
    kw = dict(pad_slack=1.0, max_reseeds=2)
    tp = tsp.make_spgemm_plan(ar, ac, 4, br, bc, 16, 16 << 16, device=CPU,
                              **kw)
    jp = jsp.make_spgemm_plan(ar, ac, 4, br, bc, 16, 16 << 16, **kw)
    assert (tp.pad_width, tp.pad_growths, tp.reseeds, tp.collisions) == \
        (jp.pad_width, jp.pad_growths, jp.reseeds, jp.collisions)
    assert np.array_equal(tp.gammas.numpy(), np.asarray(jp.gammas))
    assert np.array_equal(tp.out_bucket.numpy(), np.asarray(jp.out_bucket))
    with pytest.raises(ValueError, match="no injective bucket map"):
        tsp.make_spgemm_plan(ar, ac, 4, br, bc, 16, 16 << 16, device=CPU,
                             max_pad_width=8, **kw)


@pytest.mark.parametrize("seed,pad_width", [(0, 64), (7, 128), (11, 256)])
def test_hash_dedup_row_nnz_equals_reference(seed, pad_width):
    rng = np.random.default_rng(seed)
    ar, ac, _ = _coo(rng, 24, 24, 120)
    br, bc, _ = _coo(rng, 24, 24, 120)
    sym = jsp.symbolic(ar, ac, 24, br, bc, 24)
    pp_row = sym.c_row[sym.pp_slot]
    pp_col = sym.c_col[sym.pp_slot]
    got = tsp.hash_dedup_row_nnz(pp_row, pp_col, 24, pad_width, seed=seed)
    want = jsp.hash_dedup_row_nnz(pp_row, pp_col, 24, pad_width, seed=seed)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    np.testing.assert_array_equal(got[0], sym.row_nnz)
    with pytest.raises(ValueError, match="overflows"):
        tsp.hash_dedup_row_nnz(np.zeros(70, np.int64),
                               np.arange(70, dtype=np.int64), 1, 64)


def test_eviction_helpers_equal_reference():
    rng = np.random.default_rng(4)
    ar, ac, _ = _coo(rng, 30, 20, 90)
    br, bc, _ = _coo(rng, 20, 25, 80)
    assert tev.output_nnz(ar, ac, br, bc, 30, 25) == \
        jev.output_nnz(ar, ac, br, bc, 30, 25)
    deg = np.bincount(br, minlength=20)
    assert tcore.interim_partial_products(ac, deg) == \
        jcore.interim_partial_products(ac, deg)
    assert tev.bloat_percent(100, 50) == jev.bloat_percent(100, 50) == 100.0
    assert tev.bloat_percent(7, 0) == jev.bloat_percent(7, 0)
    rows = rng.integers(0, 12, (5, 16))
    pp = rng.normal(size=(5, 16, 3)).astype(np.float32)
    got = tev.rolling_accumulate(
        lambda w: (torch.from_numpy(pp[w]), torch.from_numpy(rows[w])),
        5, 12, 3)
    want = jev.rolling_accumulate(
        lambda w: (jnp.asarray(pp)[w], jnp.asarray(rows)[w]), 5, 12, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel and its oracle
# ---------------------------------------------------------------------------

def _cells_args(tp, a=None, cell_val=None):
    return (tp.ell_remaining, tp.ell_block_ptr, tp.ell_a if a is None else a,
            tp.cell_ptr, tp.cell_lane, tp.cell_bucket,
            tp.cell_val if cell_val is None else cell_val, tp.c_indptr,
            tp.out_bucket)


def _gather(tp, pad):
    return pad[tp.out_row.long(), tp.out_bucket.long()]


@pytest.mark.parametrize("name,width_cap", [("powerlaw", 128),
                                            ("powerlaw", 8),
                                            ("rectangular", 128),
                                            ("empty_rows", 128)])
def test_hashpad_plain_matches_reference_kernel_and_oracle(name, width_cap):
    tp, jp = _plans(name, width_cap=width_cap)
    if width_cap == 8:
        assert tp.n_chunks > tp.n_blocks            # several chunks a block
    rng = np.random.default_rng(tp.n_chunks)
    bv = torch.from_numpy(rng.normal(size=tp.nnz_b).astype(np.float32))
    slab = tnum.hashed_slab(tp, bv)
    a = tp.ell_a.numpy()
    kw = dict(block_rows=tp.block_rows, pad_width=tp.pad_width)
    dense = spgemm_hashpad_plain(tp.ell_remaining, tp.ell_block_ptr,
                                 tp.ell_a, slab, **kw)
    assert dense.shape == (tp.n_blocks * tp.block_rows, tp.pad_width)
    # the wrapper on B's compact cells: C's values, the compact plain
    # version's, and the dense plain version's gathered (≤1e-5: the dense
    # version sums through bmm, in another order)
    args = _cells_args(tp, cell_val=tnum.cell_values(tp, bv))
    got = spgemm_hashpad(*args, **kw)
    assert got.shape == (tp.nnz_out,)
    assert torch.equal(got, spgemm_hashpad_compact_plain(*args, **kw))
    np.testing.assert_allclose(got.numpy(), _gather(tp, dense).numpy(),
                               rtol=0, atol=KERNEL_TOL)
    jkw = dict(block_rows=tp.block_rows, n_blocks=tp.n_blocks,
               pad_width=tp.pad_width)
    kern = jax_hashpad(jp.ell_out_block, jp.ell_first, jp.ell_evict,
                       jnp.asarray(a), jnp.asarray(slab.numpy()),
                       interpret=True, h_tile=min(tp.pad_width, 128), **jkw)
    oracle = spgemm_hashpad_ref(jp.ell_out_block, jnp.asarray(a),
                                jnp.asarray(slab.numpy()), tp.block_rows,
                                tp.n_blocks, tp.pad_width)
    for want in (kern, oracle):
        np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=0,
                                   atol=KERNEL_TOL)
        np.testing.assert_allclose(
            got.numpy(), _gather(tp, torch.from_numpy(np.array(want))),
            rtol=0, atol=KERNEL_TOL)


def test_hashpad_plain_never_reads_dead_lanes():
    tp, _ = _plans("powerlaw")
    kw = dict(block_rows=8, pad_width=tp.pad_width)
    lane = torch.arange(tp.width)
    dead = lane[None, :] >= tp.ell_remaining[:, None]
    assert bool(dead.any())
    a = torch.where(dead.repeat_interleave(8, 0), float("nan"), tp.ell_a)
    # the wrapper on compact cells: dead coefficient lanes and cells on
    # dead lanes are never read
    want = spgemm_hashpad(*_cells_args(tp), **kw)
    ptr, c_lane, c_bucket, c_val = with_dead_lane_cells(tp, tp.cell_val,
                                                        float("nan"))
    assert c_lane.numel() > tp.n_cells
    got = spgemm_hashpad(tp.ell_remaining, tp.ell_block_ptr, a, ptr, c_lane,
                         c_bucket, c_val, tp.c_indptr, tp.out_bucket, **kw)
    assert torch.equal(got, want)
    # the dense-slab oracle: dead slab rows are never read either
    slab = tnum.hashed_slab(tp)
    clean = spgemm_hashpad_plain(tp.ell_remaining, tp.ell_block_ptr,
                                 tp.ell_a, slab, **kw)
    poisoned = slab.clone()
    poisoned[dead.reshape(-1)] = float("nan")
    assert torch.equal(spgemm_hashpad_plain(tp.ell_remaining,
                                            tp.ell_block_ptr, a, poisoned,
                                            **kw), clean)


@pytest.mark.parametrize("bad", ["dtype", "shape", "pad", "ptr", "contig"])
def test_hashpad_wrapper_raises(bad):
    tp, _ = _plans("powerlaw")
    args = dict(zip(("remaining", "block_ptr", "a", "cell_ptr", "cell_lane",
                     "cell_bucket", "cell_val", "c_indptr", "out_bucket"),
                    _cells_args(tp)))
    kw = dict(block_rows=8, pad_width=tp.pad_width)
    err = ValueError
    if bad == "dtype":
        args["cell_val"], err = tp.cell_val.double(), TypeError
    elif bad == "shape":
        args["cell_val"] = tp.cell_val[:-1]
    elif bad == "pad":
        kw["pad_width"] = tp.pad_width + 8
    elif bad == "ptr":
        args["block_ptr"] = torch.zeros(tp.n_chunks + 2, dtype=torch.int32)
    else:
        args["a"] = torch.zeros(tp.width, tp.n_chunks * 8).t()
    with pytest.raises(err):
        spgemm_hashpad(**args, **kw)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_hashpad_wrapper_narrower_pad_width_gives_nan(dtype):
    """A pad width below the plan's: C's entries whose bucket no longer
    fits come out NaN and the rest as at the plan's width, bitwise (their
    columns get the same cells in the same order) — never a value from
    nowhere."""
    tp, _ = _plans("powerlaw")
    if dtype == "f32":
        fn, args = spgemm_hashpad, _cells_args(tp)
    else:
        fn = spgemm_hashpad_q8
        args = (tp.ell_remaining, tp.ell_block_ptr, tp.ell_a_q8,
                tp.ell_a_scale, tp.cell_ptr, tp.cell_lane, tp.cell_bucket,
                tp.cell_q8, tp.slab_scale, tp.c_indptr, tp.out_bucket)
    full = fn(*args, block_rows=8, pad_width=tp.pad_width)
    half = tp.pad_width // 2
    got = fn(*args, block_rows=8, pad_width=half)
    out = tp.out_bucket >= half
    assert bool(out.any()) and bool((~out).any())
    assert bool(torch.isnan(got[out]).all())
    assert torch.equal(got[~out], full[~out])


# ---------------------------------------------------------------------------
# B's compact cells and the compact plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("width_cap", [128, 8])
def test_compact_cells_scatter_to_the_reference_slab(name, width_cap):
    tp, jp = _plans(name, width_cap=width_cap)
    _, _, _, _, _, _, _, _, bv = _case(name)
    # the cells, scattered, are the reference's slab scatter map np.add.at'd
    # in entry order (duplicate B entries included), bitwise
    want = np.zeros((tp.n_chunks * tp.width, tp.pad_width), np.float32)
    np.add.at(want, (np.asarray(jp.slab_row), np.asarray(jp.slab_col)),
              bv[np.asarray(jp.slab_src)])
    chunk = np.repeat(np.arange(tp.n_chunks), np.diff(tp.cell_ptr.numpy()))
    row = chunk * tp.width + tp.cell_lane.numpy()
    got = np.zeros_like(want)
    got[row, tp.cell_bucket.numpy()] = tp.cell_val.numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, tnum.hashed_slab(tp).numpy())
    assert tp.n_cells == np.count_nonzero(
        np.bincount(row * tp.pad_width + tp.cell_bucket.numpy()))
    # each chunk's cells ordered by (bucket, lane), on live lanes
    key = (chunk * tp.pad_width + tp.cell_bucket.numpy()) * tp.width \
        + tp.cell_lane.numpy()
    assert np.all(np.diff(key) > 0)
    assert np.all(tp.cell_lane.numpy() < tp.ell_remaining.numpy()[chunk])
    # cell_src holds every slab entry once, grouped by cell in entry order
    src_ptr = tp.cell_src_ptr.numpy()
    assert src_ptr[0] == 0 and src_ptr[-1] == tp.pp_dedup
    assert np.array_equal(np.sort(tp.cell_src.numpy()),
                          np.sort(np.asarray(jp.slab_src)))
    # swapped B values: the cells of hashed_slab, bitwise
    b2 = torch.from_numpy(np.random.default_rng(3).normal(
        size=tp.nnz_b).astype(np.float32))
    assert torch.equal(tnum.cell_values(tp, b2),
                       tnum.hashed_slab(tp, b2)[row, tp.cell_bucket.long()])


@pytest.mark.parametrize("name", ["powerlaw", "rectangular", "empty_rows",
                                  "empty_block"])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_compact_plain_equals_dense_plain_gathered(name, dtype):
    """The compact plain versions against the dense-slab plain versions
    gathered through out_row / out_bucket: f32 within 1e-6 (the dense one
    sums through bmm), int8 bitwise (exact integer sums, the same fold)."""
    case = "powerlaw" if name == "empty_block" else name
    tp, _ = _plans(case, width_cap=8)
    kw = dict(block_rows=8, pad_width=tp.pad_width)
    if dtype == "f32":
        tiles, vals, scales = tp.ell_a, tp.cell_val, ()
        slab = tnum.hashed_slab(tp)
    else:
        tiles, vals = tp.ell_a_q8, tp.cell_q8
        scales = (tp.ell_a_scale, tp.slab_scale)
        slab = tnum.hashed_slab_q8(tp)
    b = tp.n_blocks // 2
    if name == "empty_block":
        rem, bp, tiles_, *rest = drop_block_chunks(tp, b, tiles, vals,
                                                   scales)
        scales_ = tuple(rest[:len(scales)])
        cells = tuple(rest[len(scales):])
        keep = torch.ones(tp.n_chunks, dtype=torch.bool)
        keep[int(tp.ell_block_ptr[b]):int(tp.ell_block_ptr[b + 1])] = False
        slab = slab.reshape(tp.n_chunks, -1)[keep].reshape(-1, tp.pad_width)
        assert int(bp[b]) == int(bp[b + 1])
    else:
        rem, bp, tiles_, scales_ = (tp.ell_remaining, tp.ell_block_ptr,
                                    tiles, scales)
        cells = (tp.cell_ptr, tp.cell_lane, tp.cell_bucket, vals)
    out = (tp.c_indptr, tp.out_bucket)
    if dtype == "f32":
        got = spgemm_hashpad_compact_plain(rem, bp, tiles_, *cells, *out,
                                           **kw)
        dense = spgemm_hashpad_plain(rem, bp, tiles_, slab, **kw)
        np.testing.assert_allclose(got.numpy(), _gather(tp, dense).numpy(),
                                   rtol=0, atol=1e-6)
    else:
        got = spgemm_hashpad_q8_compact_plain(
            rem, bp, tiles_, scales_[0], *cells[:3], cells[3], scales_[1],
            *out, **kw)
        dense = spgemm_hashpad_q8_plain(rem, bp, tiles_, scales_[0], slab,
                                        scales_[1], **kw)
        assert torch.equal(got, _gather(tp, dense))
    if name == "empty_block":
        lo, hi = (int(tp.c_indptr[min(8 * i, tp.n_rows)]) for i in (b, b + 1))
        assert hi > lo and not bool(got[lo:hi].any())


def test_no_executor_builds_the_dense_slab(monkeypatch):
    tp, _ = _plans("empty_rows")
    rng = np.random.default_rng(2)
    av = torch.from_numpy(rng.normal(size=tp.nnz_a).astype(np.float32))
    bv = torch.from_numpy(rng.normal(size=tp.nnz_b).astype(np.float32))
    calls = [(backend, a2, b2) for backend in ("cuda", "cuda_q8")
             for a2, b2 in ((None, None), (av, bv), (None, bv), (av, None))]
    want = [tsb.spgemm(tp, a2, b2, backend=backend)
            for backend, a2, b2 in calls]

    def refuse(*_a, **_k):
        raise AssertionError("an executor built the dense hashed slab")
    monkeypatch.setattr(tnum, "hashed_slab", refuse)
    monkeypatch.setattr(tnum, "hashed_slab_q8", refuse)
    for (backend, a2, b2), w in zip(calls, want):
        got = tsb.spgemm(tp, a2, b2, backend=backend)
        assert got.shape == (tp.nnz_out,) and torch.equal(got, w)


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------

def _dense_of(rows, cols, vals, n_rows, n_cols):
    d = np.zeros((n_rows, n_cols), np.float32)
    np.add.at(d, (rows, cols), vals)
    return d


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("backend", ["dense", "reference", "cuda"])
def test_executor_matches_reference(name, backend):
    tp, jp = _plans(name)
    ar, ac, n, br, bc, m, k, av, bv = _case(name)
    for over in (None, "a", "b", "ab"):
        rng = np.random.default_rng(len(str(over)))
        a2 = rng.normal(size=av.size).astype(np.float32) if (
            over and "a" in over) else None
        b2 = rng.normal(size=bv.size).astype(np.float32) if (
            over and "b" in over) else None

        def tv(v):
            return None if v is None else torch.from_numpy(v)

        def jv(v):
            return None if v is None else jnp.asarray(v)

        got = tsb.spgemm(tp, tv(a2), tv(b2), backend=backend)
        assert got.shape == (tp.nnz_out,) and got.dtype == torch.float32
        for jbackend in ("dense", "pallas"):
            want = jsb.spgemm(jp, jv(a2), jv(b2), backend=jbackend)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=EXEC_TOL)
        dense_c = _dense_of(ar, ac, av if a2 is None else a2, n, m) @ \
            _dense_of(br, bc, bv if b2 is None else b2, m, k)
        full = np.zeros_like(dense_c)
        full[tp.c_row.numpy(), tp.c_col.numpy()] = got.numpy()
        np.testing.assert_allclose(full, dense_c, rtol=0, atol=EXEC_TOL)


@pytest.mark.parametrize("backend", ["dense", "reference", "cuda"])
def test_all_zero_and_empty_products(backend):
    plan0 = tsp.make_spgemm_plan(np.array([0, 1]), np.array([2, 3]), 4,
                                 np.array([0, 1]), np.array([0, 1]), 4, 4,
                                 device=CPU)
    assert plan0.nnz_out == 0
    assert tsb.spgemm(plan0, backend=backend).shape == (0,)
    empty = np.array([], np.int64)
    plan_e = tsp.make_spgemm_plan(empty, empty, 6, empty, empty, 6, 6,
                                  device=CPU)
    assert plan_e.nnz_out == 0 and plan_e.pp_interim == 0
    assert tsb.spgemm(plan_e, backend=backend).shape == (0,)


def test_registry_lazy_layouts_and_dense_guard():
    with pytest.raises(KeyError, match="unknown spgemm backend"):
        tsb.get_spgemm_backend("pallas")
    assert set(tsb.ALL_SPGEMM_BACKENDS) <= set(tsb.SPGEMM_BACKENDS)
    rng = np.random.default_rng(6)
    ar, ac, av = _coo(rng, 16, 16, 40)
    one = tsp.make_spgemm_plan(np.array([0]), np.array([0]), 2,
                               np.array([0]), np.array([0]), 2, 2,
                               device=CPU)
    with pytest.raises(ValueError, match="a_vals"):
        tsb.spgemm(one, torch.ones(5))
    ref_only = tsp.make_spgemm_plan(ar, ac, 16, ar, ac, 16, 16, a_vals=av,
                                    b_vals=av, executors=("reference",),
                                    device=CPU)
    assert ref_only.ell_a is None and ref_only.pad_width == 0
    with pytest.raises(ValueError, match="'cuda' layout"):
        tsb.spgemm(ref_only, backend="cuda")
    cuda_only = tsp.make_spgemm_plan(ar, ac, 16, ar, ac, 16, 16, a_vals=av,
                                     b_vals=av, executors=("cuda",),
                                     device=CPU)
    assert cuda_only.pp_a is None and cuda_only.ell_block_ptr is not None
    with pytest.raises(ValueError, match="'reference' layout"):
        tsb.spgemm(cuda_only, backend="reference")
    with pytest.raises(KeyError, match="unknown spgemm executor"):
        tsp.make_spgemm_plan(ar, ac, 16, ar, ac, 16, 16, executors=("nope",),
                             device=CPU)
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="sparse-output engine"):
        tcore.spgemm_via_dense(z, z, torch.ones(1), 1, z, z, torch.ones(1),
                               4097, 4096)
    with pytest.raises(ValueError, match="sparse-output engine"):
        jcore.spgemm_via_dense(jnp.zeros(1, jnp.int32), jnp.zeros(
            1, jnp.int32), jnp.ones(1), 1, jnp.zeros(1, jnp.int32),
            jnp.zeros(1, jnp.int32), jnp.ones(1), 4097, 4096)


# ---------------------------------------------------------------------------
# Â² two-hop graphs and coarsening
# ---------------------------------------------------------------------------

def _graphs(n=150, e=700, seed=5, weighted=False):
    s, r = powerlaw_graph(n, e, seed=seed)
    w = (np.random.default_rng(seed).uniform(0.1, 1.0, s.size).astype(
        np.float32) if weighted else None)
    return (tgraph.make_graph(s, r, n, edge_weight=w, device=CPU),
            jgraph.make_graph(s, r, n, edge_weight=w))


def _assert_graphs_equal(tg, jg, tol):
    assert tg.n_nodes == jg.n_nodes
    for f in ("senders", "receivers", "edge_valid"):
        assert np.array_equal(getattr(tg, f).numpy(),
                              np.asarray(getattr(jg, f))), f
    np.testing.assert_allclose(tg.edge_weight.numpy(),
                               np.asarray(jg.edge_weight), rtol=0, atol=tol)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("backend", ["dense", "reference", "cuda"])
def test_two_hop_graph_matches_reference(backend, weighted):
    tg, jg = _graphs(weighted=weighted)
    g2 = tsp.two_hop_graph(tg, backend=backend)
    assert g2.senders.device.type == "cpu"
    _assert_graphs_equal(g2, jsp.two_hop_graph(jg, backend="reference"),
                         KERNEL_TOL)


@pytest.mark.parametrize("backend", ["dense", "reference", "cuda"])
def test_coarsen_graph_matches_reference(backend):
    tg, jg = _graphs(120, 500, seed=8, weighted=True)
    clusters = np.random.default_rng(8).integers(0, 7, 120)
    gc = tgraph.coarsen_graph(tg, clusters, 7, backend=backend)
    _assert_graphs_equal(gc, jgraph.coarsen_graph(jg, clusters, 7,
                                                  backend="reference"),
                         EXEC_TOL)


def test_make_graph_pads_like_reference():
    s, r = powerlaw_graph(40, 90, seed=1)
    w = np.linspace(0.1, 1, s.size).astype(np.float32)
    for kw in ({}, {"edge_weight": w}):
        _tg = tgraph.make_graph(s, r, 40, pad_multiple=64, device=CPU, **kw)
        _jg = jgraph.make_graph(s, r, 40, pad_multiple=64, **kw)
        for f in ("senders", "receivers", "edge_valid", "edge_weight"):
            a, b = getattr(_tg, f), getattr(_jg, f)
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a.numpy(), np.asarray(b)), f
    x = np.arange(5)
    assert np.array_equal(tgraph.pad_to(x, 8, -1), jgraph.pad_to(x, 8, -1))


def test_caches_hit_on_the_same_graph():
    tsp.two_hop_cache_clear()
    tplan.plan_cache_clear()
    tg, _ = _graphs(80, 300, seed=2)
    g2 = tsp.cached_two_hop_graph(tg, backend="reference")
    assert tsp.cached_two_hop_graph(tg, backend="reference") is g2
    assert tsp.cached_two_hop_graph(tg, backend="cuda") is not g2
    other = tg._replace(senders=tg.senders.clone())
    assert tsp.cached_two_hop_graph(other, backend="reference") is not g2
    p = tplan.cached_plan_from_graph(g2, backends=("cuda",))
    assert tplan.cached_plan_from_graph(g2, backends=("cuda",)) is p
    assert tplan.cached_plan_from_graph(g2, backends=("dense",)) is not p
    assert tplan.plan_cache_info() == {"hits": 1, "misses": 2, "size": 2}
    assert p.device.type == "cpu" and p.n_rows == 81
    tplan.plan_cache_clear()
    tsp.two_hop_cache_clear()
    assert tplan.plan_cache_info() == {"hits": 0, "misses": 0, "size": 0}


def test_plan_from_graph_equals_reference():
    tg, jg = _graphs(60, 250, seed=3, weighted=True)
    tp = tplan.plan_from_graph(tg, backends=("dense", "cuda"))
    jp = jplan.plan_from_graph(jg, backends=("dense", "pallas"))
    for f in ("rows", "cols", "valid", "base_vals", "ell_u_cols", "ell_a",
              "ell_remaining", "ell_out_block"):
        assert np.array_equal(getattr(tp, f).numpy(),
                              np.asarray(getattr(jp, f))), f
    assert tp.n_rows == jp.n_rows == 61


# ---------------------------------------------------------------------------
# the slice as a whole: a small GCN over Â²
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_gcn_over_two_hop_matches_reference(backend):
    from repro.configs import gcn_cora as jcfgs
    from repro_torch.configs import gcn_cora as tcfgs
    s, r = powerlaw_graph(200, 900, alpha=1.6, seed=0)
    s2, r2, w = tgraph.sym_norm_weights(s, r, 200)
    tg = tgraph.make_graph(s2, r2, 200, edge_weight=w, device=CPU)
    jg = jgraph.make_graph(s2, r2, 200, edge_weight=w)
    tcfg = dataclasses.replace(tcfgs.reduced(), d_in=32)
    jcfg = dataclasses.replace(jcfgs.reduced(), d_in=32)
    assert tcfg.n_layers == jcfg.n_layers == 2
    jparams = jgcn.init_params(jax.random.key(0), jcfg)
    tparams = gcn_params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device=CPU)
    x = np.random.default_rng(1).normal(size=(201, 32)).astype(np.float32)
    tg2 = tsp.two_hop_graph(tg, backend="cuda")
    jg2 = jsp.two_hop_graph(jg, backend="reference")
    tp = tplan.plan_from_graph(tg2, backends=("cuda",))
    jp = jplan.plan_from_graph(jg2, backends=("dense",))
    with torch.no_grad():
        got = tgcn.forward(tparams, tcfg, torch.from_numpy(x),
                           backend=backend, plan=tp)
    want = jgcn.forward(jparams, jcfg, jnp.asarray(x), backend="dense",
                        plan=jp)
    assert got.shape == (201, tcfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=EXEC_TOL)
