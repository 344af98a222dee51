"""The port's GCN serving slice against the JAX reference: the model
forward, the per-bucket inference step, whole servers on the same requests,
offline parity, zero rebuilds after warm-up, and device-sampled node tables
equal to the host sampler's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # deterministic fallback; requirements-dev.txt has the real one
    from _hypothesis_shim import given, settings, st

from repro.configs import gcn_cora as jcfgs
from repro.models.gnn import gcn as jgcn
from repro.serve import compute as jcompute
from repro.serve import engine as jengine
from repro.sparse import plan as jplan
from repro.sparse import sampler as jsampler
from repro_torch.configs import gcn_cora as tcfgs
from repro_torch.convert import gcn_params_from_jax
from repro_torch.data.synthetic import powerlaw_graph
from repro_torch.models.gnn import gcn as tgcn
from repro_torch.serve import compute as tcompute
from repro_torch.serve import engine as tengine
from repro_torch.serve.buckets import build_bucket_structure, stack_trees
from repro_torch.serve.device_sampler import sample_forest_device
from repro_torch.sparse import plan as tplan
from repro_torch.sparse import sampler as tsampler
from repro_torch.sparse.graph import coo_to_csr, sym_norm_weights

TOL = 1e-5
N, E = 300, 1500
FANOUTS = (3, 2)
N_REQ = 40


@pytest.fixture(scope="module")
def world():
    s, r = powerlaw_graph(N, E, seed=7)
    indptr, indices, _ = coo_to_csr(s, r, N)
    jcfg = jcfgs.reduced()
    x = np.random.default_rng(8).normal(size=(N, jcfg.d_in)).astype(
        np.float32)
    jparams = jgcn.init_params(jax.random.key(0), jcfg)
    tparams = gcn_params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    seeds = np.random.default_rng(9).integers(0, N, N_REQ)
    return dict(s=s, r=r, indptr=indptr, indices=indices, x=x, jcfg=jcfg,
                tcfg=tcfgs.reduced(), jparams=jparams, tparams=tparams,
                seeds=seeds)


def test_configs_carry_reference_numbers():
    for a, b in ((tcfgs.FULL, jcfgs.FULL), (tcfgs.reduced(), jcfgs.reduced())):
        for f in ("name", "n_layers", "d_in", "d_hidden", "n_classes",
                  "param_dtype"):
            assert getattr(a, f) == getattr(b, f), f


def test_init_params_shapes_and_converter_guards():
    p = tgcn.init_params(tcfgs.FULL, torch.Generator().manual_seed(0),
                         device="cpu")
    assert p["layer0"]["w"].shape == (1433, 16)
    assert p["layer1"]["b"].shape == (7,)
    with pytest.raises(ValueError):
        gcn_params_from_jax({"layer0": {"w": np.zeros((3, 2))}},
                            device="cpu")
    with pytest.raises(ValueError):
        gcn_params_from_jax({"layer0": {"w": np.zeros((3, 2)),
                                        "b": np.zeros(3)}}, device="cpu")


@pytest.mark.parametrize("backend", ["dense", "chunked", "cuda"])
def test_gcn_forward_matches_reference(world, backend):
    s2, r2, w = sym_norm_weights(world["s"], world["r"], N)
    x = np.concatenate([world["x"], np.zeros((1, world["x"].shape[1]),
                                             np.float32)])
    tp = tplan.make_plan(s2, r2, N + 1, edge_weight=w, device="cpu",
                         backends=("dense", "chunked", "cuda"))
    jp = jplan.make_plan(s2, r2, N + 1, edge_weight=w,
                         backends=("dense", "pallas"))
    got = tgcn.forward(world["tparams"], world["tcfg"], torch.from_numpy(x),
                       backend=backend, plan=tp)
    for jb in ("dense", "pallas"):
        want = jgcn.forward(world["jparams"], world["jcfg"], jnp.asarray(x),
                            backend=jb, plan=jp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL, err_msg=jb)
    if backend != "cuda":                  # the inline COO plan path
        inline = tgcn.forward(world["tparams"], world["tcfg"],
                              torch.from_numpy(x), torch.from_numpy(s2),
                              torch.from_numpy(r2), torch.from_numpy(w),
                              backend=backend)
        np.testing.assert_allclose(inline.numpy(), got.numpy(), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("bucket", [1, 4, 16])
def test_infer_step_matches_reference(world, bucket):
    k = max(bucket - 1, 1)                   # leave padding lanes
    trees = tsampler.sample_forest(world["indptr"], world["indices"],
                                   world["seeds"][:k], FANOUTS, key=3)
    node_ids, hop_valid = stack_trees(trees, bucket, FANOUTS)
    struct = build_bucket_structure(bucket, FANOUTS, with_loops=True)
    jstore = jcompute.FeatureStore.build(N, x=world["x"])
    tstore = tcompute.FeatureStore.build(N, world["x"], device="cpu")
    want = np.asarray(jcompute.build_infer_step(
        "gcn", world["jcfg"], jstore, struct, backend="dense")(
        world["jparams"], node_ids, hop_valid))
    for b in ("dense", "cuda"):
        got = tcompute.build_infer_step("gcn", world["tcfg"], tstore, struct,
                                        backend=b)(world["tparams"], node_ids,
                                                   hop_valid)
        assert got.shape == (bucket, world["tcfg"].n_classes)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL,
                                   err_msg=b)


def test_unported_archs_raise(world):
    """The reference's guard: a geometric arch over a store without
    species or positions raises."""
    tstore = tcompute.FeatureStore.build(N, world["x"], device="cpu")
    struct = build_bucket_structure(1, FANOUTS, with_loops=True)
    with pytest.raises(ValueError, match="species/pos"):
        tcompute.build_infer_step("schnet", world["tcfg"], tstore, struct)


@pytest.fixture(scope="module")
def reference_results(world):
    """The JAX server on ``dense``: results by request id."""
    store = jcompute.FeatureStore.build(N, x=world["x"])
    with jengine.GNNServer("gcn", world["jcfg"], world["jparams"],
                           world["indptr"], world["indices"], store,
                           fanouts=FANOUTS, backend="dense",
                           max_batch_seeds=4, seed=5) as server:
        server.warmup()
        reqs = [server.submit([int(s)]) for s in world["seeds"]]
        server.drain()
    return {r.rid: r.result for r in reqs}


@pytest.mark.parametrize("sampler", ["host", "device"])
@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_server_matches_reference_server(world, reference_results, backend,
                                         sampler):
    store = tcompute.FeatureStore.build(N, world["x"], device="cpu")
    with tengine.GNNServer("gcn", world["tcfg"], world["tparams"],
                           world["indptr"], world["indices"], store,
                           fanouts=FANOUTS, backend=backend, sampler=sampler,
                           max_batch_seeds=4, seed=5,
                           device="cpu") as server:
        server.warmup()
        builds = server.steps.builds
        reqs = [server.submit([int(s)]) for s in world["seeds"]]
        server.drain()
        assert server.steps.builds == builds          # zero rebuilds
        assert all(r.n_settles == 1 and r.error is None for r in reqs)
        for r in reqs:
            np.testing.assert_allclose(r.result, reference_results[r.rid],
                                       rtol=0, atol=TOL)
        ref = np.concatenate([tengine.offline_replay(server, r)
                              for r in reqs[:12]])
        got = np.concatenate([r.result for r in reqs[:12]])
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
        assert server.stats()["n_served"] == N_REQ


def test_server_rejects_bad_requests_and_device_mismatch(world):
    store = tcompute.FeatureStore.build(N, world["x"], device="cpu")
    with pytest.raises(ValueError, match="sampler"):
        tengine.GNNServer("gcn", world["tcfg"], world["tparams"],
                          world["indptr"], world["indices"], store,
                          sampler="gpu", device="cpu")
    with tengine.GNNServer("gcn", world["tcfg"], world["tparams"],
                           world["indptr"], world["indices"], store,
                           fanouts=FANOUTS, max_batch_seeds=4,
                           device="cpu") as server:
        with pytest.raises(ValueError):
            server.submit([N])
        with pytest.raises(ValueError):
            server.submit(np.arange(5))


def _isolated_graph():
    # node 0 and the last node have no in-edges (the end-of-CSR corner)
    s = np.array([1, 2, 3, 3, 4, 5, 5, 5])
    r = np.array([2, 1, 1, 4, 3, 3, 4, 1])
    indptr, indices, _ = coo_to_csr(s, r, 7)
    return indptr, indices


@given(st.integers(1, 12), st.lists(st.integers(1, 4), min_size=1,
                                    max_size=3), st.integers(0, 400))
@settings(max_examples=12, deadline=None)
def test_device_sampler_equals_host_sampler(b, fanouts, key):
    rng = np.random.default_rng(key)
    if key % 3 == 0:
        indptr, indices = _isolated_graph()
        seeds = rng.integers(0, 7, b)
    else:
        s, r = powerlaw_graph(120, 700, seed=key)
        indptr, indices, _ = coo_to_csr(s, r, 120)
        seeds = rng.integers(0, 120, b)
    tks = rng.integers(0, 2 ** 62, b).astype(np.uint64) << np.uint64(1)
    host = jsampler.sample_forest(indptr, indices, seeds, fanouts, key=key,
                                  tree_keys=tks)
    port_host = tsampler.sample_forest(indptr, indices, seeds, fanouts,
                                       key=key, tree_keys=tks)
    dev = sample_forest_device(indptr, indices, seeds, fanouts, key=key,
                               tree_keys=tks, device="cpu")
    for h, ph, d in zip(host, port_host, dev):
        assert np.array_equal(h.node_ids, ph.node_ids)
        assert np.array_equal(h.node_ids, d.node_ids)
        for hv, pv, dv in zip(h.hop_valid, ph.hop_valid, d.hop_valid):
            assert np.array_equal(hv, pv) and np.array_equal(hv, dv)
