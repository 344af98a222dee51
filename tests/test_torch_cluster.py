"""The port's replicated cluster tier (``repro_torch.serve.cluster``,
``compute.build_lane_infer_step``) against the reference's, on the CPU:

* ``DRHMRouter`` makes the reference router's decisions (``lane_of``,
  ``route_many``, ``maybe_reseed``, ``rebalance``, ``info``) on the same
  seeds and queue-depth sequences;
* the lane step of gcn, gat, sage and gin on ``dense``, ``chunked``,
  ``cuda`` and ``cuda_q8`` (plain versions) is ≤1e-5 from the reference's
  vmapped ``build_lane_infer_step`` (``pallas``/``pallas_q8`` in interpret
  mode) on the same lane-stacked inputs;
* the lane-stacked plan's aggregation is bitwise the single-lane plan's,
  lane by lane, on ``cuda`` and ``cuda_q8`` (int8 quantizes each lane
  alone);
* a port ``ClusterServer(device="cpu")`` serves within 1e-5 of the
  reference's ``ClusterServer`` on the same world and request stream;
* the counterparts of ``tests/test_cluster_serving.py``'s router and
  replicated cases; ``mode="sharded"`` and ``placement="mesh"`` without a
  device a lane raise ``ValueError`` naming the devices (their parity is
  ``tests/test_torch_cluster_sharded.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.launch import gnn_serve as jlaunch
from repro.serve import cluster as jcluster
from repro.serve import compute as jcompute
from repro_torch import convert
from repro_torch.core import drhm
from repro_torch.launch import gnn_serve as tlaunch
from repro_torch.launch.gnn_serve import build_world
from repro_torch.models.gnn import gat as tgat
from repro_torch.models.gnn import gcn as tgcn
from repro_torch.models.gnn import gin as tgin
from repro_torch.models.gnn import sage as tsage
from repro_torch.serve import ClusterServer, DRHMRouter, utilization_spread
from repro_torch.serve import compute as tcompute
from repro_torch.serve.buckets import build_bucket_structure, stack_trees
from repro_torch.sparse import backend as sb
from repro_torch.sparse import sampler as tsampler
from repro_torch.sparse.plan import plan_with_values

CPU = "cpu"
TOL = 1e-5
N_LANES = 8
REF_BACKEND = {"dense": "dense", "chunked": "chunked", "cuda": "pallas",
               "cuda_q8": "pallas_q8"}
PORT = {"gcn": (tgcn, convert.gcn_params_from_jax),
        "gat": (tgat, convert.gat_params_from_jax),
        "gin": (tgin, convert.gin_params_from_jax),
        "sage": (tsage, convert.sage_params_from_jax)}


def _port_cfg(arch, jcfg):
    cls = getattr(PORT[arch][0], type(jcfg).__name__)
    return cls(**{f: getattr(jcfg, f) for f in cls.__dataclass_fields__})


def _worlds(arch, n_nodes, n_edges, d_in, seed=0, bias=0.0):
    """The reference launcher's world and the same world in the port (the
    reference's parameters carried across, the same features); ``bias``
    is added to every bias, which the initializers leave at zero."""
    jcfg, jparams, indptr, indices, jstore = jlaunch.build_world(
        arch, n_nodes, n_edges, d_in, seed=seed)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + bias if path[-1].key.startswith("b") else a,
        jparams)
    tparams = PORT[arch][1](jax.tree.map(np.asarray, jparams), device=CPU)
    x = np.asarray(jstore.x)[:-1]
    tstore = tcompute.FeatureStore.build(n_nodes, x, device=CPU)
    return (jcfg, jparams, jstore), (_port_cfg(arch, jcfg), tparams,
                                     tstore), indptr, indices


# ---------------------------------------------------------------------------
# DRHMRouter against the reference's
# ---------------------------------------------------------------------------

def _same_router(a, b):
    assert a.info() == b.info()
    assert np.array_equal(a.lane_map(), b.lane_map())
    assert np.array_equal(a.active_lanes, b.active_lanes)
    assert (a.gamma, a.n_bins, a.n_active) == (b.gamma, b.n_bins, b.n_active)


@pytest.mark.parametrize("n_lanes,n_bins,seed", [(4, 1024, 0), (8, 1024, 5),
                                                 (3, 1000, 2), (5, 7, 9)])
def test_router_decisions_equal_reference(n_lanes, n_bins, seed):
    rng = np.random.default_rng(seed)
    tr = DRHMRouter(n_lanes, n_bins=n_bins, seed=seed)
    jr = jcluster.DRHMRouter(n_lanes, n_bins=n_bins, seed=seed)
    _same_router(tr, jr)
    seeds = rng.integers(0, 10 ** 6, 512)
    for step in range(40):
        assert [tr.lane_of([s]) for s in seeds[:64]] == \
            [jr.lane_of([s]) for s in seeds[:64]]
        assert tr.bin_of([seeds[step]]) == jr.bin_of([seeds[step]])
        assert tr.route(seeds[step]) == jr.route(seeds[step])
        first = seeds.astype(np.uint64)
        assert np.array_equal(tr.route_many(first), jr.route_many(first))
        # skewed, uniform and empty depth sequences
        kind = step % 4
        if kind == 0:
            depths = rng.poisson(6.0, n_lanes) + 1
        elif kind == 1:
            depths = np.zeros(n_lanes)
            depths[int(rng.integers(0, n_lanes))] = rng.integers(20, 200)
        elif kind == 2:
            depths = rng.integers(0, 3, n_lanes)
        else:
            depths = rng.integers(0, 60, n_lanes).astype(float)
        assert tr.maybe_reseed(depths) == jr.maybe_reseed(depths)
        if step % 7 == 3 and n_lanes > 1:
            k = int(rng.integers(1, n_lanes + 1))
            active = sorted(rng.choice(n_lanes, k, replace=False).tolist())
            tr.rebalance(active)
            jr.rebalance(active)
        if step % 11 == 5:
            tr.reseed()
            jr.reseed()
        if step % 13 == 8:
            tr.bump_epoch()
            jr.bump_epoch()
        _same_router(tr, jr)


def test_router_errors_and_spread_equal_reference():
    for bad in ([], [0, 9]):
        with pytest.raises(ValueError) as te:
            DRHMRouter(4).rebalance(bad)
        with pytest.raises(ValueError) as je:
            jcluster.DRHMRouter(4).rebalance(bad)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError):
        DRHMRouter(0)
    rng = np.random.default_rng(3)
    for _ in range(20):
        c = rng.integers(0, 50, 6)
        assert utilization_spread(c) == jcluster.utilization_spread(c)


# ---------------------------------------------------------------------------
# The lane step against the reference's vmapped step
# ---------------------------------------------------------------------------

def _lane_inputs(indptr, indices, bucket, fanouts, n_lanes, loops, seed):
    """(node_ids (L, n), hop_valid (L, E)): lane 0 a full bucket, lane 1 a
    partial one, the last lane empty (a lane with no batch this round)."""
    rng = np.random.default_rng(seed)
    n = indptr.shape[0] - 1
    struct = build_bucket_structure(bucket, fanouts, with_loops=loops)
    node_ids = np.full((n_lanes, struct.n_nodes), -1, np.int64)
    hop_valid = np.zeros((n_lanes, struct.n_hop_edges), bool)
    for lane in range(n_lanes - 1):
        k = bucket if lane == 0 else max(bucket - 1, 1)
        trees = tsampler.sample_forest(indptr, indices,
                                       rng.integers(0, n, k), fanouts,
                                       key=seed + lane)
        node_ids[lane], hop_valid[lane] = stack_trees(trees, bucket, fanouts)
    return node_ids, hop_valid


LANE_CASES = [(a, b) for a in ("gcn", "gat", "sage", "gin")
              for b in REF_BACKEND]


@pytest.mark.parametrize("arch,backend", LANE_CASES)
def test_lane_step_matches_reference_vmapped_step(arch, backend):
    fanouts, bucket, n_lanes = (2, 2), 2, 3
    # nonzero biases make the rows that pad each lane to whole blocks
    # nonzero after a layer: they must not move a lane's int8 scales
    (jcfg, jparams, jstore), (tcfg, tparams, tstore), indptr, indices = \
        _worlds(arch, 96, 384, 6, bias=0.25)
    loops = arch == "gcn"
    struct = build_bucket_structure(bucket, fanouts, with_loops=loops)
    node_ids, hop_valid = _lane_inputs(indptr, indices, bucket, fanouts,
                                       n_lanes, loops, seed=4)
    jstep = jcompute.build_lane_infer_step(arch, jcfg, struct,
                                           backend=REF_BACKEND[backend])
    want = np.asarray(jstep(jparams,
                            jcompute.build_fetch_step(jstore)(node_ids),
                            node_ids, hop_valid))
    tstep = tcompute.build_lane_infer_step(arch, tcfg, struct,
                                           backend=backend)
    x = tcompute.build_fetch_step(tstore)(node_ids)
    assert x.shape == (n_lanes, struct.n_nodes, 6)
    got = tstep(tparams, x, node_ids, hop_valid)
    assert got.shape == want.shape == (n_lanes, bucket, tcfg.n_classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("backend", ["cuda", "cuda_q8"])
@pytest.mark.parametrize("bucket", [1, 2, 16])
def test_stacked_aggregation_is_bitwise_the_single_lane_plan(backend,
                                                            bucket):
    """Lanes aligned to whole output blocks: the stack's dedup chunks are
    the single-lane plan's repeated, and each lane's aggregation (int8:
    with its own feature scales) equals the single-lane plan's bit for
    bit."""
    n_lanes, d = 4, 16
    struct = build_bucket_structure(bucket, (5, 3), with_loops=True)
    p1 = tcompute.bucket_plan(struct, backend, True, torch.device(CPU))
    pl = tcompute.bucket_plan(struct, backend, True, torch.device(CPU),
                              n_lanes)
    n, rows = struct.n_nodes, pl.lane_rows
    assert rows % 8 == 0 and rows - n < 8 and pl.lanes == n_lanes
    assert torch.equal(pl.ell_remaining, p1.ell_remaining.repeat(n_lanes))
    assert torch.equal(pl.ell_a, p1.ell_a.repeat(n_lanes, 1))
    rng = np.random.default_rng(bucket)
    ws = [torch.from_numpy(rng.uniform(0.1, 1, struct.n_edges).astype(
        np.float32)) for _ in range(n_lanes)]
    vs = [torch.from_numpy(rng.random(struct.n_edges) < 0.8)
          for _ in range(n_lanes)]
    # lanes of very different magnitudes: one shared int8 scale would
    # round the small lanes away
    xs = [torch.from_numpy((rng.normal(size=(n, d)) * 10.0 ** lane).astype(
        np.float32)) for lane in range(n_lanes)]
    x = torch.zeros(n_lanes * rows, d)
    for lane in range(n_lanes):
        x[lane * rows:lane * rows + n] = xs[lane]
    y = sb.aggregate(plan_with_values(pl, edge_weight=torch.cat(ws),
                                      edge_valid=torch.cat(vs)),
                     None, x, backend=backend)
    for lane in range(n_lanes):
        y1 = sb.aggregate(plan_with_values(p1, edge_weight=ws[lane],
                                           edge_valid=vs[lane]),
                          None, xs[lane], backend=backend)
        assert torch.equal(y[lane * rows:lane * rows + n], y1[:n]), lane


def test_lane_plan_validation_and_cache():
    """One cache holds every lane count, keyed by it: a stack is built
    once, and one lane is the bucket's own plan."""
    struct = build_bucket_structure(4, (2, 2), with_loops=True)
    dev = torch.device(CPU)
    a = tcompute.bucket_plan(struct, "cuda", True, dev, 3)
    before = tcompute.bucket_plan_cache_info()
    assert tcompute.bucket_plan(struct, "cuda", True, dev, 3) is a
    assert tcompute.bucket_plan_cache_info()["hits"] == before["hits"] + 1
    one = tcompute.bucket_plan(struct, "cuda", True, dev, 1)
    assert one is tcompute.bucket_plan(struct, "cuda", True, dev)
    assert one.lanes == 1 and one.n_rows == struct.n_nodes
    assert a.lanes == 3 and a.n_rows == 3 * a.lane_rows
    from repro_torch.sparse.plan import make_plan
    with pytest.raises(ValueError, match="crosses"):
        make_plan(np.array([0, 9]), np.array([1, 2]), 16, lanes=2,
                  lane_rows=8, device=CPU)
    with pytest.raises(ValueError, match="tile"):
        make_plan(np.array([0]), np.array([1]), 18, lanes=2, lane_rows=9,
                  device=CPU)


def test_lane_scaled_b4_plain_equals_per_lane_calls():
    """The int8 kernel's plain version with a row of feature scales a
    lane equals one call a lane with that lane's scales, bitwise."""
    from repro_torch.kernels.gustavson_spmm import (spmm_dedup_chunks_q8,
                                                    spmm_dedup_chunks_q8_plain)
    from repro_torch.sparse.quantize import quantize_feature_tiles
    struct = build_bucket_structure(2, (5, 3), with_loops=True)
    dev = torch.device(CPU)
    n_lanes, d = 4, 7
    pl = tcompute.bucket_plan(struct, "cuda_q8", True, dev, n_lanes)
    p1 = tcompute.bucket_plan(struct, "cuda_q8", True, dev)
    rows, n = pl.lane_rows, struct.n_nodes
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(n_lanes * rows, d)).astype(np.float32))
    x_q8, x_scale = quantize_feature_tiles(x, d, n_lanes, rows, n)
    assert x_scale.shape == (n_lanes, 1)
    args = (pl.ell_u_cols, pl.ell_remaining, pl.ell_block_ptr, pl.ell_a_q8,
            pl.ell_a_scale, x_q8, x_scale)
    y = spmm_dedup_chunks_q8(*args, block_rows=8, q_tile=d)
    assert torch.equal(y, spmm_dedup_chunks_q8_plain(*args, block_rows=8,
                                                     q_tile=d))
    for lane in range(n_lanes):
        xl = x[lane * rows:lane * rows + n]
        q, s = quantize_feature_tiles(xl, d)
        assert torch.equal(s, x_scale[lane])
        assert torch.equal(q, x_q8[lane * rows:lane * rows + n])
        y1 = spmm_dedup_chunks_q8(p1.ell_u_cols, p1.ell_remaining,
                                  p1.ell_block_ptr, p1.ell_a_q8,
                                  p1.ell_a_scale, q, s, block_rows=8,
                                  q_tile=d)
        assert torch.equal(y[lane * rows:lane * rows + n], y1[:n])
    # the lanes are read off the scales: rows that do not split the
    # blocks into equal runs raise, and so does one row of scales for a
    # plan of several lanes on the resident path
    odd = torch.cat([x_scale, x_scale[:1]])
    assert pl.n_blocks % odd.shape[0]
    with pytest.raises(ValueError, match="equal runs"):
        spmm_dedup_chunks_q8(*args[:-1], odd, block_rows=8, q_tile=d)
    from repro_torch.sparse.quantize import quantize_features
    with torch.no_grad(), pytest.raises(ValueError, match="lane by lane"):
        sb.aggregate(pl, None, quantize_features(x, d), backend="cuda_q8")


def test_placements_and_modes_beyond_stacked_raise_naming_a7():
    """Sharded mode and mesh placement (ROADMAP A7, ported) need a device a
    lane: without them they raise ``ValueError`` naming the devices, as the
    reference does with fewer devices than lanes."""
    struct = build_bucket_structure(2, (2, 2), with_loops=True)
    cfg = tgcn.GCNConfig(d_in=4, n_classes=3)
    with pytest.raises(ValueError, match="devices"):
        tcompute.build_lane_infer_step("gcn", cfg, struct, placement="mesh")
    with pytest.raises(ValueError, match="placement"):
        tcompute.build_lane_infer_step("gcn", cfg, struct,
                                       placement="ring")
    cfg, params, indptr, indices, store = build_world(64, 256, 4, 0, CPU)
    for kw in (dict(mode="sharded"), dict(placement="mesh"),
               dict(mode="sharded", placement="mesh")):
        with pytest.raises(ValueError, match="devices"):
            ClusterServer("gcn", cfg, params, indptr, indices, store,
                          device=CPU, **kw)
    with pytest.raises(ValueError, match="devices"):
        tlaunch.main(["--device", "cpu", "--replicas", "2", "--shard",
                      "--requests", "4", "--nodes", "64", "--edges", "256"])


# ---------------------------------------------------------------------------
# A port cluster against the reference cluster
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,backend", [("gcn", "dense"), ("gcn", "cuda"),
                                          ("sage", "dense")])
def test_cluster_serves_like_the_reference_cluster(arch, backend):
    (jcfg, jparams, jstore), (tcfg, tparams, tstore), indptr, indices = \
        _worlds(arch, 256, 1024, 8)
    rng = np.random.default_rng(5)
    stream = [rng.integers(0, 256, 1 + i % 3) for i in range(40)]
    kw = dict(n_lanes=4, fanouts=(2, 2), seed=0, max_batch_seeds=4)
    results = []
    for srv in (jcluster.ClusterServer(arch, jcfg, jparams, indptr, indices,
                                       jstore, backend="dense", **kw),
                ClusterServer(arch, tcfg, tparams, indptr, indices, tstore,
                              backend=backend, device=CPU, **kw)):
        with srv:
            srv.warmup()
            reqs = srv.submit_many(stream)
            srv.drain(timeout=120)
            assert all(r.n_settles == 1 and r.error is None for r in reqs)
            results.append(({r.rid: r.result for r in reqs},
                            [r.lane for r in reqs],
                            srv.lane_stats()["submitted"]))
    (jres, jlanes, jsub), (tres, tlanes, tsub) = results
    assert tlanes == jlanes and tsub == jsub      # the same routing
    assert sorted(tres) == sorted(jres)
    for rid in jres:
        assert tres[rid].shape == jres[rid].shape
        np.testing.assert_allclose(tres[rid], jres[rid], rtol=0, atol=TOL)


def test_launcher_cluster_run_exits_zero():
    assert tlaunch.main(["--device", "cpu", "--replicas", "4",
                         "--requests", "48", "--nodes", "256", "--edges",
                         "1024", "--d-in", "8"]) == 0


# ---------------------------------------------------------------------------
# The counterparts of tests/test_cluster_serving.py (router, replicated)
# ---------------------------------------------------------------------------

def test_router_map_is_exact_balance_bijection():
    r = DRHMRouter(N_LANES, n_bins=1024, seed=3)
    for _ in range(5):
        counts = np.bincount(r.lane_map(), minlength=N_LANES)
        assert (counts == r.n_bins // N_LANES).all(), counts
        r.reseed()


def test_reseed_changes_the_map():
    r = DRHMRouter(N_LANES, n_bins=1024, seed=0)
    before = r.lane_map()
    gamma_before = r.gamma
    r.reseed()
    assert r.gamma != gamma_before
    assert (before != r.lane_map()).mean() > 0.5


def test_route_gamma_is_odd_and_epoch_dependent():
    gs = {drhm.route_gamma(7, k) for k in range(32)}
    assert len(gs) == 32
    assert all(g % 2 == 1 for g in gs)


def test_routing_deterministic_and_in_range():
    r = DRHMRouter(N_LANES, seed=1)
    lanes = [r.lane_of([i]) for i in range(256)]
    assert lanes == [r.lane_of([i]) for i in range(256)]
    assert all(0 <= ln < N_LANES for ln in lanes)


def test_uniform_traffic_does_not_reseed():
    r = DRHMRouter(N_LANES, seed=0)
    depths = np.random.default_rng(0).poisson(6.0, N_LANES) + 1
    assert not r.maybe_reseed(depths)
    assert r.reseeds == 0


def test_skewed_depths_trigger_reseed_and_rebalance():
    r = DRHMRouter(N_LANES, n_bins=1024, seed=5)
    hot = [i for i in range(4096) if r.lane_of([i]) == 0]
    assert len(hot) > 300
    pre = np.bincount([r.lane_of([s]) for s in hot], minlength=N_LANES)
    assert utilization_spread(pre) == pytest.approx(N_LANES)
    assert r.maybe_reseed(pre.astype(float))
    post = np.bincount([r.lane_of([s]) for s in hot], minlength=N_LANES)
    assert post.sum() == len(hot)
    assert utilization_spread(post) <= 1.5, post


def test_rebalance_preserves_exact_balance_for_every_subset():
    r = DRHMRouter(N_LANES, n_bins=1024, seed=11)
    rng = np.random.default_rng(0)
    for n_active in list(range(1, N_LANES + 1)) * 3:
        active = sorted(rng.choice(N_LANES, n_active, replace=False)
                        .tolist())
        r.rebalance(active)
        counts = np.bincount(r.lane_map(), minlength=N_LANES)
        assert (counts[active] == r.n_bins // n_active).all(), counts
        inactive = [i for i in range(N_LANES) if i not in active]
        assert (counts[inactive] == 0).all(), counts
        lanes = r.route_many(np.arange(512, dtype=np.uint64))
        assert set(np.unique(lanes)) <= set(active)


def test_rebalance_bumps_epoch_and_noops_on_same_set():
    r = DRHMRouter(4, n_bins=256, seed=2)
    e0 = r.epoch
    r.rebalance([0, 2, 3])
    assert r.epoch == e0 + 1 and r.rebalances == 1
    r.rebalance([3, 2, 0])
    assert r.epoch == e0 + 1 and r.rebalances == 1
    r.rebalance([0, 1, 2, 3])
    assert r.epoch == e0 + 2
    with pytest.raises(ValueError, match="at least one"):
        r.rebalance([])
    with pytest.raises(ValueError, match="out of range"):
        r.rebalance([0, 9])


def test_reseed_respects_the_active_set():
    r = DRHMRouter(N_LANES, n_bins=1024, seed=4)
    r.rebalance([0, 3, 5, 6])
    before = r.lane_map()
    r.reseed()
    after = r.lane_map()
    assert (before != after).mean() > 0.5
    counts = np.bincount(after, minlength=N_LANES)
    assert (counts[[0, 3, 5, 6]] == r.n_bins // 4).all()
    assert counts[[1, 2, 4, 7]].sum() == 0
    depths = np.zeros(N_LANES)
    depths[1] = 1000.0
    depths[[0, 3, 5, 6]] = 5.0
    assert not r.maybe_reseed(depths)


def test_in_flight_requests_drain_on_the_old_map():
    cfg, params, indptr, indices, store = build_world(256, 1024, 8, 0, CPU,
                                                      "sage")
    srv = ClusterServer("sage", cfg, params, indptr, indices, store,
                        n_lanes=4, fanouts=(2, 2), backend="dense", seed=0,
                        device=CPU)
    with srv:
        reqs = srv.submit_many([[i % 256] for i in range(16)])
        lanes_at_submit = [r.lane for r in reqs]
        srv.router.reseed()
        srv.drain(timeout=120)
        assert [r.lane for r in reqs] == lanes_at_submit
        served = np.asarray(srv.lane_stats()["served"])
        assert (served == np.bincount(lanes_at_submit, minlength=4)).all()


@pytest.mark.parametrize("arch", ["gcn", "sage", "gat"])
@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_replicated_parity_vs_offline_replay(arch, backend):
    cfg, params, indptr, indices, store = build_world(512, 2048, 16, 0, CPU,
                                                      arch)
    srv = ClusterServer(arch, cfg, params, indptr, indices, store,
                        n_lanes=4, fanouts=(3, 2), backend=backend, seed=0,
                        max_batch_seeds=4, device=CPU)
    with srv:
        srv.warmup()
        reqs = srv.submit_many(
            [np.random.default_rng(i).integers(0, 512, 1 + i % 4)
             for i in range(24)])
        srv.drain(timeout=120)
        for r in reqs:
            ref = srv.offline_replay(r)
            assert r.result.shape == ref.shape
            np.testing.assert_allclose(r.result, ref, atol=1e-5)


def test_zero_steady_state_recompiles():
    cfg, params, indptr, indices, store = build_world(512, 2048, 16, 0, CPU)
    srv = ClusterServer("gcn", cfg, params, indptr, indices, store,
                        n_lanes=4, fanouts=(3, 2), backend="cuda", seed=0,
                        max_batch_seeds=4, device=CPU)
    with srv:
        srv.warmup()
        for r in srv.submit_many([[i % 512] for i in range(32)]):
            r.wait(120)
        builds = srv.steps.builds
        plans = tcompute.bucket_plan_cache_info()["builds"]
        for r in srv.submit_many([[(7 * i) % 512] for i in range(32)]):
            r.wait(120)
        assert srv.steps.builds == builds
        assert tcompute.bucket_plan_cache_info()["builds"] == plans


def test_cluster_rejects_bad_requests_and_archs():
    cfg, params, indptr, indices, store = build_world(128, 512, 8, 0, CPU)
    with pytest.raises(ValueError, match="single-device only"):
        ClusterServer("schnet", cfg, params, indptr, indices, store,
                      device=CPU)
    srv = ClusterServer("gcn", cfg, params, indptr, indices, store,
                        n_lanes=2, fanouts=(2, 2), backend="dense",
                        device=CPU)
    with srv:
        with pytest.raises(ValueError, match="out of range"):
            srv.submit([999])
        with pytest.raises(ValueError, match="seeds"):
            srv.submit_many([[]])
        with pytest.raises(ValueError, match="class"):
            srv.submit([1], cls="premium")


def test_e2e_reseed_rebalances_skewed_stream():
    """Every seed routed to lane 0 under γ₀: the router reseeds and
    post-reseed routing spreads to ≤1.5× mean."""
    cfg, params, indptr, indices, store = build_world(1024, 4096, 8, 0, CPU,
                                                      "sage")
    srv = ClusterServer("sage", cfg, params, indptr, indices, store,
                        n_lanes=4, fanouts=(2, 2), backend="dense", seed=0,
                        max_batch_seeds=4, reseed_check_every=16,
                        device=CPU)
    probe = DRHMRouter(4, seed=0)
    hot = [i for i in range(1024) if probe.lane_of([i]) == 0]
    rng = np.random.default_rng(1)
    with srv:
        srv.warmup()
        srv.submit_many([[int(rng.choice(hot))] for _ in range(256)])
        srv.drain(timeout=120)
        info = srv.router.info()
        assert info["reseeds"] >= 1
        post = np.sum([np.asarray(c, float)
                       for c in info["routed_per_epoch"][1:]], axis=0)
        assert post.sum() > 64
        assert utilization_spread(post) <= 1.5
        assert srv.stats()["n_served"] == 256


def test_weight_and_graph_plane():
    """``install_params`` keeps versions monotone and stamps results,
    ``apply_graph_update`` swaps the sampler's CSR and epoch, and
    ``update_feature_rows`` patches the resident table (served results and
    replay follow it)."""
    cfg, params, indptr, indices, store = build_world(128, 512, 8, 0, CPU)
    srv = ClusterServer("gcn", cfg, params, indptr, indices, store,
                        n_lanes=2, fanouts=(2, 2), backend="cuda",
                        device=CPU)
    with srv:
        srv.warmup()
        v = srv.install_params({k: {n: t * 2 for n, t in p.items()}
                                for k, p in params.items()})
        assert v == 1 == srv.params_version
        with pytest.raises(ValueError, match="monotone"):
            srv.install_params(params, version=1)
        ep = srv.apply_graph_update(indptr, indices)
        assert ep == 1 and srv._sampler.graph_epoch == 1
        with pytest.raises(ValueError, match="node count"):
            srv.apply_graph_update(indptr[:-1], indices)
        srv.update_feature_rows([3, 5], np.ones((2, 8), np.float32))
        assert torch.equal(srv.store.x[3], torch.ones(8))
        reqs = srv.submit_many([[3], [5], [7]])
        srv.drain(timeout=120)
        for r in reqs:
            assert r.params_version == 1 and r.graph_epoch == 1
            np.testing.assert_allclose(r.result, srv.offline_replay(r),
                                       atol=1e-5)
        assert srv.retired_versions() == []
        with pytest.raises(ValueError, match="out of range"):
            srv.update_feature_rows([999], np.ones((1, 8), np.float32))


def test_step_cache_is_safe_under_concurrent_gets():
    """A cluster's engine thread and its monitor (a lane's shadow warm-up)
    share the step and plan caches: many threads hammering a small LRU
    lose no count and never see a missing entry."""
    import sys
    import threading
    built = []

    def build(key):
        built.append(key)
        return key

    cache = tcompute.StepCache(build, maxsize=3)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for k in rng.integers(0, 6, 2000):
                assert cache.get((int(k),)) == (int(k),)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    info = cache.info()
    assert info["hits"] + info["builds"] == 16 * 2000
    assert info["builds"] == len(built) and info["size"] <= 3
