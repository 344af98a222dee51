"""The port's sharded residency and mesh placement of the serving cluster
(``ClusterServer(mode="sharded")``, ``placement="mesh"``,
``core.distributed.LaneHalo``) against the reference's, on the CPU.

The reference's own sharded and mesh tests need 8 XLA devices, and on jax
0.9.0 they fail: ``jax.make_mesh`` builds ``Explicit`` axes by default,
which its lane mesh's gathers reject (ROADMAP C4).  One subprocess runs
the reference's clusters on 8 emulated devices with ``jax.make_mesh``
giving ``Auto`` axes (the older default) and saves each request's result;
the port serves the same worlds in one process on 8 lanes over a repeated
CPU device list (``devices=["cpu"] * 8``).  Held, as in
``tests/test_cluster_serving.py`` and ``tests/test_live_mutation.py``:
sharded bitwise replicated (gcn, sage, gat), mesh bitwise stacked, both
≤1e-5 from the reference's sharded and mesh clusters, offline-replay
parity, the ``devices`` error, the launcher's ``--shard --placement
mesh``, and on sharded residency a hot-swap and a graph flush with no
request lost and rows re-homed in place at ``perm[row]``.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint import store as ckpt_store
from repro_torch.launch import gnn_serve as tlaunch
from repro_torch.launch.gnn_serve import build_world, perturbed
from repro_torch.models.gnn import gat as tgat
from repro_torch.models.gnn import gcn as tgcn
from repro_torch.models.gnn import sage as tsage
from repro_torch.serve import ClusterServer
from repro_torch.serve import compute as tcompute
from repro_torch.serve.live import GraphStream, hot_swap

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
N_LANES = 8
ARCHS = ("gcn", "sage", "gat")
LANES = [CPU] * N_LANES

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from jax.sharding import AxisType
_make_mesh = jax.make_mesh
jax.make_mesh = lambda shape, names, **kw: _make_mesh(
    shape, names, axis_types=(AxisType.Auto,) * len(names), **kw)
from repro.launch.gnn_serve import build_world
from repro.serve import ClusterServer
out = {}
rng = np.random.default_rng(3)
trace = [rng.integers(0, 512, 2) for _ in range(48)]
runs = [(a, "sharded", "stacked") for a in ("gcn", "sage", "gat")]
runs.append(("gcn", "replicated", "mesh"))
for arch, mode, placement in runs:
    cfg, params, indptr, indices, store = build_world(arch, 512, 2048, 16,
                                                      seed=0)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[f"{arch}/p/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    out[f"{arch}/x"] = np.asarray(store.x)[:-1]
    srv = ClusterServer(arch, cfg, params, indptr, indices, store,
                        n_lanes=8, mode=mode, placement=placement,
                        fanouts=(3, 2), backend="dense", seed=0,
                        max_batch_seeds=4)
    with srv:
        srv.warmup()
        reqs = srv.submit_many(trace)
        srv.drain()
        out[f"{arch}/{mode}/{placement}"] = np.concatenate(
            [r.result for r in reqs])
np.savez(sys.argv[1], **out)
"""

PORT_CFG = {"gcn": (tgcn.GCNConfig, convert.gcn_params_from_jax),
            "sage": (tsage.SAGEConfig, convert.sage_params_from_jax),
            "gat": (tgat.GATConfig, convert.gat_params_from_jax)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    proc = subprocess.run(
        [sys.executable, "-c", REF, str(path)], capture_output=True,
        text=True, timeout=600,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.path.expanduser("~"),
             "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def _trace(n_nodes, n=48, k=2, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n_nodes, k) for _ in range(n)]


def _world(ref, arch):
    """The reference's world in the port: its parameters and features,
    the same graph."""
    from repro_torch.data import synthetic as syn
    from repro_torch.sparse.graph import coo_to_csr
    s, r = syn.powerlaw_graph(512, 2048, seed=0)
    indptr, indices, _ = coo_to_csr(s, r, 512)
    tree = {}
    pre = f"{arch}/p/"
    for k, v in ref.items():
        if k.startswith(pre):
            node = tree
            *head, last = k[len(pre):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    cls, conv = PORT_CFG[arch]
    cfg = cls(d_in=16, n_classes=8)
    params = conv(tree, device=CPU)
    store = tcompute.FeatureStore.build(512, ref[f"{arch}/x"], device=CPU)
    return cfg, params, indptr, indices, store


def _serve(world, arch, trace=None, **kw):
    cfg, params, indptr, indices, store = world
    kw.setdefault("backend", "dense")
    srv = ClusterServer(arch, cfg, params, indptr, indices, store,
                        n_lanes=N_LANES, fanouts=(3, 2), seed=0,
                        max_batch_seeds=4, device=CPU, **kw)
    with srv:
        srv.warmup()
        reqs = srv.submit_many(trace or _trace(512))
        srv.drain()
        assert all(r.n_settles == 1 and r.error is None for r in reqs)
        return np.concatenate([r.result for r in reqs]), srv, reqs


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_bitwise_matches_replicated(ref, arch):
    world = _world(ref, arch)
    rep, _, _ = _serve(world, arch)
    sh, srv, _ = _serve(world, arch, mode="sharded", devices=LANES)
    assert srv.shard_plan is not None and srv.mode == "sharded"
    assert np.array_equal(sh, rep)
    np.testing.assert_allclose(sh, ref[f"{arch}/sharded/stacked"],
                               atol=1e-5, rtol=0)


def test_mesh_placement_bitwise_matches_stacked(ref):
    world = _world(ref, "gcn")
    stacked, _, _ = _serve(world, "gcn")
    mesh, _, _ = _serve(world, "gcn", placement="mesh", devices=LANES)
    both, _, _ = _serve(world, "gcn", mode="sharded", placement="mesh",
                        devices=LANES)
    assert np.array_equal(mesh, stacked)
    assert np.array_equal(both, stacked)
    np.testing.assert_allclose(mesh, ref["gcn/replicated/mesh"], atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_sharded_parity_vs_offline_replay(ref, backend):
    cfg, params, indptr, indices, store = _world(ref, "gcn")
    srv = ClusterServer("gcn", cfg, params, indptr, indices, store,
                        n_lanes=N_LANES, mode="sharded", placement="mesh",
                        devices=LANES, fanouts=(3, 2), backend=backend,
                        seed=0, max_batch_seeds=4, device=CPU)
    with srv:
        srv.warmup([1, 2])
        reqs = srv.submit_many(_trace(512, n=24))
        srv.drain()
        for r in reqs:
            np.testing.assert_allclose(r.result, srv.offline_replay(r),
                                       atol=1e-5, rtol=0)


@pytest.mark.parametrize("backend", ["cuda", "cuda_q8"])
def test_kernel_executors_sharded_mesh_bitwise_replicated_stacked(ref,
                                                                  backend):
    """On the kernels' executors too (their plain versions here), sharded
    residency on mesh-placed lanes gives the replicated stacked round's
    bits: int8 quantizes each lane alone in both."""
    world = _world(ref, "gcn")
    trace = _trace(512, n=24)
    rep, _, _ = _serve(world, "gcn", trace, backend=backend)
    got, _, _ = _serve(world, "gcn", trace, backend=backend,
                       mode="sharded", placement="mesh", devices=LANES)
    assert np.array_equal(got, rep)


def test_sharded_requires_devices():
    cfg, params, indptr, indices, store = build_world(128, 512, 8, 0, CPU)
    for kw in (dict(mode="sharded"), dict(placement="mesh")):
        with pytest.raises(ValueError, match="devices"):
            ClusterServer("gcn", cfg, params, indptr, indices, store,
                          n_lanes=N_LANES, device=CPU, **kw)
    with pytest.raises(ValueError, match="devices"):
        ClusterServer("gcn", cfg, params, indptr, indices, store,
                      n_lanes=N_LANES, mode="sharded", devices=[CPU] * 3,
                      device=CPU)


def test_sharded_cluster_launcher():
    """The counterpart of ``test_sharded_cluster_subprocess``: the
    launcher's sharded, mesh-placed cluster serves with replay parity."""
    assert tlaunch.main(["--device", "cpu", "--replicas", "4", "--shard",
                         "--placement", "mesh", "--lane-devices",
                         "cpu,cpu,cpu,cpu", "--requests", "32", "--nodes",
                         "256", "--edges", "1024", "--d-in", "8"]) == 0


def test_sharded_swap_and_mutation():
    """The full drill on sharded residency: a hot-swap and a graph flush
    on 8 mesh-placed lanes, with offline-replay parity after both."""
    cfg, params, indptr, indices, store = build_world(256, 2048, 16, 0, CPU)
    srv = ClusterServer("gcn", cfg, params, indptr, indices, store,
                        n_lanes=N_LANES, mode="sharded", placement="mesh",
                        devices=LANES, seed=0, device=CPU)
    rng = np.random.default_rng(4)

    def load(n=24):
        return srv.submit_many([rng.integers(0, 256, size=2)
                                for _ in range(n)])
    try:
        srv.warmup([1, 2])
        reqs = load()
        with tempfile.TemporaryDirectory() as d:
            ckpt_store.save(d, 1, perturbed(params, 2))
            rep = hot_swap(srv, d, drain_timeout=60.0)
        assert rep.drained_old and srv.params_version == 1
        gs = GraphStream(srv, max_pending=512, parity_every=1)
        for _ in range(24):
            gs.insert(int(rng.integers(0, 256)), int(rng.integers(0, 256)))
        frep = gs.flush()
        assert frep.parity_ok is True
        reqs += load()
        srv.drain()
        for r in reqs:
            assert r.n_settles == 1 and r.error is None
        np.testing.assert_allclose(srv.offline_replay(reqs[-1]),
                                   reqs[-1].result, atol=1e-5)
    finally:
        srv.close()


def test_sharded_feature_rehome_scatters_in_place():
    """Delta feature rows land at perm[row] in the resident sharded table
    — no re-shard — and the served result reflects the new rows."""
    cfg, params, indptr, indices, store = build_world(256, 2048, 16, 0, CPU)
    srv = ClusterServer("gcn", cfg, params, indptr, indices, store,
                        n_lanes=N_LANES, mode="sharded", placement="mesh",
                        devices=LANES, seed=0, device=CPU)
    rng = np.random.default_rng(5)
    try:
        srv.warmup([1])
        shards = [s.data_ptr() for s in srv._halo.shards]
        rows = np.arange(0, 32, dtype=np.int64)
        new = rng.normal(size=(rows.size, 16)).astype(np.float32)
        srv.update_feature_rows(rows, new)
        assert [s.data_ptr() for s in srv._halo.shards] == shards
        x_perm = torch.cat([t.cpu() for t in srv._halo.shards]).numpy()
        np.testing.assert_array_equal(x_perm[srv.shard_plan.perm[rows]], new)
        req = srv.submit(np.array([3, 5]))
        req.wait(30)
        np.testing.assert_allclose(srv.offline_replay(req), req.result,
                                   atol=1e-5)
    finally:
        srv.close()


def test_halo_is_bitwise_the_replicated_fetch():
    cfg, params, indptr, indices, store = build_world(300, 1200, 12, 1, CPU)
    from repro_torch.core.distributed import LaneHalo
    from repro_torch.sparse.plan import plan_feature_sharding
    plan = plan_feature_sharding(301, 4)
    halo = LaneHalo(store.x, plan, [CPU] * 4, n_ghost_slot=300)
    ids = np.random.default_rng(0).integers(-1, 300, (4, 57))
    got = torch.stack(halo.gather(ids))
    want = tcompute.build_fetch_step(store)(ids)
    assert torch.equal(got, want)
    assert all(s.shape[0] == plan.rows_per_lane for s in halo.shards)
