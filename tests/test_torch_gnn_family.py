"""GAT, GIN and GraphSAGE in the port against the JAX reference, on the CPU
(the kernels' plain versions; the reference's ``pallas``/``pallas_q8`` in
interpret mode at 100–250 edges):

* each model's loss and every parameter gradient on ``dense``,
  ``chunked``, ``cuda`` and ``cuda_q8`` against the reference's ``dense``,
  ``chunked``, ``pallas`` and ``pallas_q8`` on the reference's parameters,
  and each executor against the port's own ``dense``; GIN over Â²
  anchored on the reference's ``dense`` (ROADMAP C3);
* the serving step of each arch against the reference's
  ``build_infer_step(..., jit=False)``;
* ten training steps of ``gat-cora`` (``launch/train``'s setup) and of gin
  (``build_gnn_step``, also over Â²) against the reference's;
* the launchers with ``--device cpu``, the configs, the registry and the
  converters' checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import gat as jgat
from repro.models.gnn import gin as jgin
from repro.models.gnn import sage as jsage
from repro.optim import adamw as jadamw
from repro.serve import compute as jcompute
from repro.sparse import plan as jplan
from repro_torch import convert, tree
from repro_torch.models.gnn import gat as tgat
from repro_torch.models.gnn import gin as tgin
from repro_torch.models.gnn import sage as tsage
from repro_torch.optim import adamw
from repro_torch.serve import compute as tcompute
from repro_torch.serve.buckets import build_bucket_structure, stack_trees
from repro_torch.sparse import plan as tplan
from repro_torch.sparse import sampler as tsampler

CPU = "cpu"
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5       # as tests/test_torch_train.py
EXECUTOR_TOL = 1e-4                     # an executor against dense
SERVE_TOL = 1e-5
TRAJ_TOL = 1e-4
REF_BACKEND = {"dense": "dense", "chunked": "chunked", "cuda": "pallas",
               "cuda_q8": "pallas_q8"}
BACKENDS = tuple(REF_BACKEND)

ARCHS = {
    "gat": (jgat, tgat, jgat.GATConfig(d_in=6, d_hidden=4, n_heads=2,
                                       n_classes=3),
            convert.gat_params_from_jax),
    "gin": (jgin, tgin, jgin.GINConfig(d_in=6, d_hidden=8, n_classes=3,
                                       n_layers=2),
            convert.gin_params_from_jax),
    "sage": (jsage, tsage, jsage.SAGEConfig(d_in=6, d_hidden=8,
                                            n_classes=3),
             convert.sage_params_from_jax),
}


def _port_cfg(tmod, jcfg):
    cls = getattr(tmod, type(jcfg).__name__)
    return cls(**{f: getattr(jcfg, f) for f in cls.__dataclass_fields__})


def _graph(n=30, e=150, seed=0, n_invalid=10):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    s[:3], r[:3] = 5, 9                   # repeated edges share a cell
    valid = np.ones(e, bool)
    valid[rng.choice(e, n_invalid, replace=False)] = False
    return s, r, valid, rng


def _plans(s, r, n_rows, backend, **kw):
    extra = () if backend in ("dense", "chunked") else (backend,)
    jextra = () if backend in ("dense", "chunked") else (
        REF_BACKEND[backend],)
    tp = tplan.make_plan(s, r, n_rows, backends=("dense", "chunked") + extra,
                         device=CPU, **kw)
    jp = jplan.make_plan(s, r, n_rows, backends=("dense", "chunked")
                         + jextra, **kw)
    return tp, jp


def _loss_and_grads(arch, backend, tp, jp, x, labels, mask, gid, glab,
                    ref_backend=None):
    """(reference loss, reference gradients, {port executor: (loss,
    gradients)}) on the reference's parameters, for ``backend`` and the
    port's ``dense``."""
    jm, tm, jcfg, conv = ARCHS[arch]
    tcfg = _port_cfg(tm, jcfg)
    params = jm.init_params(jax.random.key(1), jcfg)
    tparams = conv(jax.tree.map(np.asarray, params), device=CPU)
    jb = ref_backend or REF_BACKEND[backend]
    if arch == "gin":
        def jl(p):
            return jm.loss_fn(p, jcfg, jnp.asarray(x), None, None, None,
                              jnp.asarray(gid), len(glab), jnp.asarray(glab),
                              backend=jb, plan=jp)

        def tl(p, b):
            return tm.loss_fn(p, tcfg, torch.from_numpy(x), None, None, None,
                              torch.from_numpy(gid), len(glab),
                              torch.from_numpy(glab), backend=b, plan=tp)
    else:
        def jl(p):
            return jm.loss_fn(p, jcfg, jnp.asarray(x), None, None, None,
                              jnp.asarray(labels), jnp.asarray(mask),
                              backend=jb, plan=jp)

        def tl(p, b):
            return tm.loss_fn(p, tcfg, torch.from_numpy(x), None, None, None,
                              torch.from_numpy(labels),
                              torch.from_numpy(mask), backend=b, plan=tp)
    lj, gj = jax.value_and_grad(jl)(params)
    out = {}
    for b in ("dense", backend):
        leaves, structure = tree.flatten(tparams)
        live = [t.clone().requires_grad_() for t in leaves]
        lt = tl(tree.unflatten(structure, live), b)
        out[b] = (lt.item(), torch.autograd.grad(lt, live,
                                                 materialize_grads=True))
    return float(lj), jax.tree.leaves(gj), out


def _data(n, rng, d=6, n_graphs=3):
    x = rng.normal(size=(n + 1, d)).astype(np.float32)
    labels = rng.integers(0, 3, n + 1).astype(np.int32)
    mask = np.arange(n + 1) < 20
    gid = (np.arange(n + 1) * n_graphs // (n + 1)).astype(np.int32)
    gid[-1] = n_graphs                      # the ghost row: dropped
    glab = np.arange(n_graphs, dtype=np.int32) % 3
    return x, labels, mask, gid, glab


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_gradients_match_reference(arch, backend):
    """Loss and every parameter gradient against the reference executor of
    the same kind (interpret-mode Pallas for ``cuda``/``cuda_q8``), and the
    executor against the port's ``dense``."""
    n = 30
    s, r, valid, rng = _graph(n)
    tp, jp = _plans(s, r, n + 1, backend, edge_valid=valid)
    lj, gj, out = _loss_and_grads(arch, backend, tp, jp, *_data(n, rng))
    lt, gt = out[backend]
    np.testing.assert_allclose(lt, lj, rtol=GRAD_RTOL)
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    if backend != "cuda_q8":
        ld, gd = out["dense"]
        assert abs(lt - ld) <= EXECUTOR_TOL
        for a, b in zip(gd, gt):
            assert float((a - b).abs().max()) <= EXECUTOR_TOL * max(
                1.0, float(a.abs().max()))


@pytest.mark.parametrize("backend", ["dense", "chunked", "cuda"])
def test_gin_over_two_hop_matches_reference_dense(backend):
    """GIN over Â² (each package builds Â² with its own SpGEMM engine, the
    same edges): loss and gradients on the port's executor against the
    reference's ``dense`` executor on its Â²."""
    from repro.sparse.graph import make_graph as jmake_graph
    from repro.sparse.spgemm import two_hop_graph as jtwo_hop
    from repro_torch.sparse.graph import make_graph
    from repro_torch.sparse.spgemm import two_hop_graph
    n = 30
    s, r, _, rng = _graph(n, e=80)
    g2j = jtwo_hop(jmake_graph(s, r, n))
    g2t = two_hop_graph(make_graph(s, r, n, device=CPU))
    for f in ("senders", "receivers", "edge_valid"):
        np.testing.assert_array_equal(getattr(g2t, f).numpy(),
                                      np.asarray(getattr(g2j, f)))
    jp = jplan.make_plan(np.asarray(g2j.senders), np.asarray(g2j.receivers),
                         n + 1, edge_weight=np.asarray(g2j.edge_weight),
                         edge_valid=np.asarray(g2j.edge_valid))
    tp = tplan.plan_from_graph(g2t, backends=("dense", "chunked", "cuda"))
    lj, gj, out = _loss_and_grads("gin", backend, tp, jp, *_data(n, rng),
                                  ref_backend="dense")
    lt, gt = out[backend]
    np.testing.assert_allclose(lt, lj, rtol=GRAD_RTOL)
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

N_SERVE, E_SERVE = 200, 900
FANOUTS = (3, 2)


@pytest.fixture(scope="module")
def serve_world():
    from repro_torch.data.synthetic import powerlaw_graph
    from repro_torch.sparse.graph import coo_to_csr
    s, r = powerlaw_graph(N_SERVE, E_SERVE, seed=3)
    indptr, indices, _ = coo_to_csr(s, r, N_SERVE)
    x = np.random.default_rng(4).normal(size=(N_SERVE, 6)).astype(
        np.float32)
    seeds = np.random.default_rng(5).integers(0, N_SERVE, 8)
    return indptr, indices, x, seeds


@pytest.mark.parametrize("backend", ["dense", "cuda", "cuda_q8"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_infer_step_matches_reference(serve_world, arch, backend):
    """A bucket-8 step with a padding lane, on the reference's parameters,
    against the reference's unjitted step on the executor of the same
    kind; the bucket structure has no self loops."""
    indptr, indices, x, seeds = serve_world
    jm, tm, jcfg, conv = ARCHS[arch]
    trees = tsampler.sample_forest(indptr, indices, seeds[:7], FANOUTS,
                                   key=3)
    node_ids, hop_valid = stack_trees(trees, 8, FANOUTS)
    struct = build_bucket_structure(8, FANOUTS, with_loops=False)
    params = jm.init_params(jax.random.key(2), jcfg)
    want = np.asarray(jcompute.build_infer_step(
        arch, jcfg, jcompute.FeatureStore.build(N_SERVE, x=x), struct,
        backend=REF_BACKEND[backend], jit=False)(
        params, jnp.asarray(node_ids), jnp.asarray(hop_valid)))
    got = tcompute.build_infer_step(
        arch, _port_cfg(tm, jcfg),
        tcompute.FeatureStore.build(N_SERVE, x, device=CPU), struct,
        backend=backend)(conv(jax.tree.map(np.asarray, params), device=CPU),
                         node_ids, hop_valid)
    assert got.shape == (8, jcfg.n_classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SERVE_TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_server_matches_offline_replay(serve_world, arch):
    """A whole server per arch with the device sampler: every request
    settles once, no rebuild after warm-up, results equal offline replay,
    and the buckets are built without self loops."""
    from repro_torch.serve import GNNServer, offline_replay
    indptr, indices, x, _ = serve_world
    _, tm, jcfg, _ = ARCHS[arch]
    cfg = _port_cfg(tm, jcfg)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    store = tcompute.FeatureStore.build(N_SERVE, x, device=CPU)
    with GNNServer(arch, cfg, params, indptr, indices, store,
                   fanouts=FANOUTS, backend="cuda", sampler="device",
                   max_batch_seeds=8, device=CPU) as server:
        server.warmup()
        builds = server.steps.builds
        reqs = [server.submit([int(s)]) for s in range(0, N_SERVE, 9)]
        server.drain()
        assert server.steps.builds == builds
        assert not server._struct(8).with_loops
        for r in reqs:
            assert r.n_settles == 1 and r.error is None
            np.testing.assert_allclose(r.result, offline_replay(server, r),
                                       rtol=0, atol=SERVE_TOL)


# ---------------------------------------------------------------------------
# training trajectories
# ---------------------------------------------------------------------------

def _run_both(jstep, jparams, jbatch, tstep, tparams, tbatch, n_steps=10):
    js, ts = jadamw.init_state(jparams), adamw.init_state(tparams)
    jstep = jax.jit(jstep)
    for i in range(n_steps):
        jparams, js, jm = jstep(jparams, js, jbatch)
        tparams, ts, tm = tstep(tparams, ts, tbatch)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TRAJ_TOL, i
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            TRAJ_TOL * max(1.0, float(jm["grad_norm"])), i
    for a, b in zip(jax.tree.leaves(jparams), tree.leaves(tparams)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=TRAJ_TOL)


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_gat_cora_trajectory_matches_reference(backend):
    """Ten steps of gat-cora (the reduced config: 2 heads of 4, d_in 1433)
    on the Cora-scale graph: the port's ``launch/train`` setup on the
    reference's parameters against ``repro.launch.train``'s on ``dense``,
    loss ≤1e-4 a step."""
    from repro.configs import registry as jreg
    from repro.launch import train as jtrain
    from repro_torch.configs import registry as treg
    from repro_torch.launch import train as ttrain
    jp, jstep, jb = jtrain._gnn_setup("gat-cora", jreg.get_config(
        "gat-cora", reduced=True), 0, False, backend="dense")
    _, tstep, tb = ttrain._gnn_setup("gat-cora", treg.get_config(
        "gat-cora", reduced=True), 0, backend=backend, device=CPU)
    tp = convert.gat_params_from_jax(jax.tree.map(np.asarray, jp),
                                     device=CPU)
    tbatch = next(tb)
    assert "edge_weight" not in tbatch
    _run_both(jstep, jp, next(jb), tstep, tp, tbatch)


def _gin_batches(n_mol=6, seed=0):
    """A molecule batch (the reference's ``molecule_batch`` structure) with
    seeded features and graph labels, for both packages."""
    from repro.data.synthetic import molecule_batch as jmolecules
    from repro_torch.data.synthetic import molecule_batch
    got = molecule_batch(n_mol, n_nodes=10, n_edges=20, seed=seed)
    want = jmolecules(n_mol, n_nodes=10, n_edges=20, seed=seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    _, _, snd, rcv, _, _ = got
    offs = (np.arange(n_mol) * 10)[:, None]
    s, r = (snd + offs).ravel(), (rcv + offs).ravel()
    n = n_mol * 10
    rng = np.random.default_rng(seed + 1)
    x = np.concatenate([rng.normal(size=(n, 6)), np.zeros((1, 6))]).astype(
        np.float32)
    gid = np.append(np.repeat(np.arange(n_mol), 10), n_mol).astype(np.int32)
    labels = rng.integers(0, 3, n_mol).astype(np.int32)
    return s, r, n, x, gid, labels


@pytest.mark.parametrize("backend,two_hop", [("dense", False),
                                             ("cuda", False),
                                             ("cuda_q8", False),
                                             ("dense", True),
                                             ("cuda", True),
                                             ("cuda_q8", True)])
def test_gin_trajectory_matches_reference(backend, two_hop):
    """Ten steps of gin through ``build_gnn_step`` (AdamW at lr 1e-3) on a
    molecule batch against the reference's on ``dense`` (``pallas_q8`` for
    ``cuda_q8``, in interpret mode), loss ≤1e-4 a step; over Â² anchored on
    the reference's ``dense`` (``pallas_q8`` over its f32 Â² for
    ``cuda_q8``, whose Â² is f32 too)."""
    from repro.launch import steps as jsteps
    from repro.sparse.graph import make_graph as jmake_graph
    from repro_torch.launch import steps as tsteps
    from repro_torch.sparse.graph import make_graph
    s, r, n, x, gid, labels = _gin_batches()
    jcfg = jgin.GINConfig(d_in=6, d_hidden=8, n_classes=3, n_layers=2,
                          two_hop=two_hop)
    ref = "pallas_q8" if backend == "cuda_q8" else "dense"
    jg = jmake_graph(s, r, n)
    tg = make_graph(s, r, n, device=CPU)
    jstep = jsteps.build_gnn_step("gin", jcfg, None, {"n_graphs": 6},
                                  jadamw.AdamWConfig(lr=1e-3), backend=ref,
                                  graph=jg)
    tstep = tsteps.build_gnn_step("gin", _port_cfg(tgin, jcfg),
                                  adamw.AdamWConfig(lr=1e-3),
                                  backend=backend, graph=tg, n_graphs=6)
    jp = jgin.init_params(jax.random.key(0), jcfg)
    jbatch = {"x": jnp.asarray(x), "senders": jg.senders,
              "receivers": jg.receivers, "edge_valid": jg.edge_valid,
              "graph_ids": jnp.asarray(gid), "labels": jnp.asarray(labels)}
    tbatch = {"x": torch.from_numpy(x), "senders": tg.senders,
              "receivers": tg.receivers, "edge_valid": tg.edge_valid,
              "graph_ids": torch.from_numpy(gid),
              "labels": torch.from_numpy(labels)}
    _run_both(jstep, jp, jbatch, tstep,
              convert.gin_params_from_jax(jax.tree.map(np.asarray, jp),
                                          device=CPU), tbatch)


# ---------------------------------------------------------------------------
# launchers, configs, registry, converters, guards
# ---------------------------------------------------------------------------

def test_train_cli_gat(tmp_path, capsys):
    from repro_torch.checkpoint import store
    from repro_torch.launch import train as ttrain
    argv = ["--arch", "gat-cora", "--backend", "cuda", "--steps", "4",
            "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    assert ttrain.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[train] 4 steps in") and "retries=0" in line
    assert store.committed_steps(tmp_path) == [2, 4]
    with pytest.raises(ValueError, match="two_hop"):
        ttrain.main(["--arch", "gat-cora", "--two-hop", "--steps", "1",
                     "--device", "cpu"])


@pytest.mark.parametrize("arch", ["gat", "sage", "gin"])
def test_gnn_serve_cli(arch, capsys):
    from repro_torch.launch import gnn_serve
    assert gnn_serve.main(["--arch", arch, "--device", "cpu", "--sampler",
                           "device", "--requests", "24", "--nodes", "300",
                           "--edges", "1200", "--d-in", "8"]) == 0
    out = capsys.readouterr().out
    assert f"[gnn-serve] {arch}/cuda/device on cpu" in out
    assert "(OK)" in out and "recompiles(post-warmup)=0" in out


def test_configs_and_registry():
    from repro.configs import gat_cora as jcfgs
    from repro_torch.configs import gat_cora as tcfgs
    from repro_torch.configs import registry
    for a, b in ((tcfgs.FULL, jcfgs.FULL), (tcfgs.reduced(),
                                            jcfgs.reduced())):
        assert dataclass_items(a) == dataclass_items(b)
    for cls in (tgin.GINConfig, tsage.SAGEConfig):
        ref = {tgin.GINConfig: jgin.GINConfig,
               tsage.SAGEConfig: jsage.SAGEConfig}[cls]
        assert dataclass_items(cls()) == dataclass_items(ref())
    assert registry.entry("gat-cora").family == "gnn"
    assert registry.entry("gat-cora").module == "repro_torch.configs.gat_cora"
    assert registry.get_config("gat-cora") == tcfgs.FULL
    # the geometric archs resolve, and so do the LM archs (A8)
    for arch in ("schnet", "dimenet"):
        assert registry.entry(arch).gnn_kind == "geom"
    assert registry.entry("qwen3-0.6b").family == "lm"
    assert registry.get_config("qwen3-0.6b").n_layers == 28
    assert not registry.NOT_PORTED


def dataclass_items(cfg):
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__
            if k != "dp_axes"}


def test_init_params_shapes():
    from repro_torch.configs.gat_cora import FULL
    p = tgat.init_params(FULL, torch.Generator().manual_seed(0), CPU)
    assert p["layer0"]["w"].shape == (1433, 8, 8)
    assert p["layer0"]["a_src"].shape == (8, 8)
    assert p["layer1"]["w"].shape == (64, 1, 7)
    assert p["layer1"]["b"].shape == (7,)
    g = tgin.init_params(tgin.GINConfig(), torch.Generator().manual_seed(0),
                         CPU)
    assert g["layer0"]["eps"].shape == () and g["layer2"]["mlp"][
        "w1"].shape == (64, 4)
    s = tsage.init_params(tsage.SAGEConfig(),
                          torch.Generator().manual_seed(0), CPU)
    assert s["layer0"]["w_nbr"].shape == (602, 64)
    assert s["layer1"]["w_self"].shape == (64, 41)


def test_converters_check_shapes():
    gat = jax.tree.map(np.asarray, jgat.init_params(
        jax.random.key(0), ARCHS["gat"][2]))
    convert.gat_params_from_jax(gat, device=CPU)
    bad = {k: dict(v) for k, v in gat.items()}
    bad["layer0"]["w"] = bad["layer0"]["w"].reshape(6, -1)
    with pytest.raises(ValueError, match="heads"):
        convert.gat_params_from_jax(bad, device=CPU)
    bad = {k: dict(v) for k, v in gat.items()}
    bad["layer1"]["a_src"] = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError, match="a_src"):
        convert.gat_params_from_jax(bad, device=CPU)
    bad = {k: dict(v) for k, v in gat.items()}
    bad["layer1"]["w"] = np.zeros((5, 1, 3), np.float32)
    with pytest.raises(ValueError, match="inputs"):
        convert.gat_params_from_jax(bad, device=CPU)
    gin = jax.tree.map(np.asarray, jgin.init_params(
        jax.random.key(0), ARCHS["gin"][2]))
    convert.gin_params_from_jax(gin, device=CPU)
    bad = {k: dict(v) for k, v in gin.items()}
    bad["layer0"]["eps"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="eps"):
        convert.gin_params_from_jax(bad, device=CPU)
    with pytest.raises(ValueError, match="keys"):
        convert.gin_params_from_jax({"layer0": {"mlp": gin["layer0"]["mlp"]}},
                                    device=CPU)
    sage = jax.tree.map(np.asarray, jsage.init_params(
        jax.random.key(0), ARCHS["sage"][2]))
    convert.sage_params_from_jax(sage, device=CPU)
    bad = {k: dict(v) for k, v in sage.items()}
    bad["layer0"]["b"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="layer0"):
        convert.sage_params_from_jax(bad, device=CPU)
    with pytest.raises(ValueError, match="layers"):
        convert.sage_params_from_jax({"layer1": sage["layer1"]}, device=CPU)


def test_build_gnn_step_guards():
    from repro_torch.configs.gat_cora import FULL
    from repro_torch.launch.steps import build_gnn_step
    from repro_torch.sparse.graph import make_graph
    s, r, _, _ = _graph(n_invalid=0)
    g = make_graph(s, r, 30, device=CPU)
    with pytest.raises(ValueError, match="two_hop"):
        build_gnn_step("gat-cora", FULL, graph=g, two_hop=True)
    from repro_torch.configs import dimenet, schnet
    for arch, cfg in (("schnet", schnet.reduced()),
                      ("dimenet", dimenet.reduced())):
        assert callable(build_gnn_step(arch, cfg, graph=g, n_graphs=2))
    with pytest.raises(KeyError):
        build_gnn_step("unknown", FULL, graph=g)
    assert callable(build_gnn_step("gin", tgin.GINConfig(), graph=g,
                                   backend="cuda", n_graphs=2))
