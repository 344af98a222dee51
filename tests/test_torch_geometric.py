"""SchNet and DimeNet in the port against the JAX reference, on the CPU
(the kernels' plain versions; the reference's ``pallas``/``pallas_q8`` in
interpret mode):

* ``build_triplets`` and the RBF centres, bitwise; the basis functions,
  ``shifted_softplus`` and the norms ≤1e-6 (the angular basis plus the
  term its θ's one-ulp difference from XLA's ``acos`` carries);
* each model's forward on ``dense``, ``chunked``, ``cuda`` and ``cuda_q8``
  against the reference's executor of the same kind (≤1e-5), its loss
  (≤1e-4) and every parameter gradient (rtol 1e-3, atol 1e-4) on the
  reference's parameters at ``reduced()`` on a few molecules; DimeNet over
  Â² against the reference's ``dense`` anchor (ROADMAP C3);
* the serving steps against the reference's ``build_infer_step(...,
  jit=False)``, padding lanes kept out of the live rows; a server against
  offline replay; ``gnn_serve --arch schnet|dimenet --device cpu``;
* ten training steps of each model through ``build_gnn_step`` against the
  reference's;
* the shapes, configs, registry and the converters' checks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dimenet as jdimenet_cfg
from repro.configs import schnet as jschnet_cfg
from repro.data import synthetic as jsyn
from repro.models.gnn import dimenet as jdimenet
from repro.models.gnn import schnet as jschnet
from repro.serve import compute as jcompute
from repro.sparse import triplets as jtriplets
from repro_torch import convert, tree
from repro_torch.configs import dimenet as tdimenet_cfg
from repro_torch.configs import schnet as tschnet_cfg
from repro_torch.models.gnn import dimenet as tdimenet
from repro_torch.models.gnn import schnet as tschnet
from repro_torch.serve import compute as tcompute
from repro_torch.serve.buckets import build_bucket_structure, stack_trees
from repro_torch.sparse import sampler as tsampler
from repro_torch.sparse import triplets as ttriplets

CPU = "cpu"
FWD_TOL = 1e-5
LOSS_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
BASIS_TOL = 1e-6
SERVE_TOL = 1e-5
TRAJ_TOL = 1e-4
REF_BACKEND = {"dense": "dense", "chunked": "chunked", "cuda": "pallas",
               "cuda_q8": "pallas_q8"}
BACKENDS = tuple(REF_BACKEND)
# arch → (reference module, port module, reference reduced config, port
# reduced config, converter)
MODELS = {
    "schnet": (jschnet, tschnet, jschnet_cfg.reduced(),
               tschnet_cfg.reduced(), convert.schnet_params_from_jax),
    "dimenet": (jdimenet, tdimenet, jdimenet_cfg.reduced(),
                tdimenet_cfg.reduced(), convert.dimenet_params_from_jax),
}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _molecules(batch=3, n=10, e=24, seed=0, k_cap=8):
    """A few molecules flattened into one graph (the reference's test
    helper), with DimeNet's triplets: a dict of numpy arrays."""
    species, pos, sd, rc, val, tgt = jsyn.molecule_batch(batch, n, e,
                                                         seed=seed)
    offs = (np.arange(batch) * n)[:, None]
    s, r = (sd + offs).reshape(-1), (rc + offs).reshape(-1)
    t_in, t_out, t_valid = jtriplets.build_triplets(s, r, k_cap)
    return dict(species=species.reshape(-1), pos=pos.reshape(-1, 3),
                senders=s, receivers=r, edge_valid=val.reshape(-1),
                t_in=t_in, t_out=t_out, t_valid=t_valid,
                graph_ids=np.repeat(np.arange(batch), n).astype(np.int32),
                targets=tgt, n_graphs=batch)


def _args(arch, mol, cast):
    keys = (("species", "pos", "senders", "receivers", "edge_valid")
            + (("t_in", "t_out", "t_valid") if arch == "dimenet" else ())
            + ("graph_ids",))
    return [cast(mol[k]) for k in keys] + [mol["n_graphs"]]


def _params(arch, seed=0):
    jm, _, jcfg, _, conv = MODELS[arch]
    jp = jm.init_params(jax.random.key(seed), jcfg)
    return jp, conv(jax.tree.map(np.asarray, jp), device=CPU)


@pytest.fixture(scope="module")
def mol():
    return _molecules()


# ---------------------------------------------------------------------------
# triplets, basis functions, shared blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["molecules", "random", "hub", "empty",
                                  "cap1"])
def test_build_triplets_bitwise(case):
    rng = np.random.default_rng(7)
    k = 8
    if case == "molecules":
        m = _molecules(batch=8, n=30, e=64, seed=3)
        s, r = m["senders"], m["receivers"]
    elif case in ("random", "cap1"):
        s = rng.integers(0, 40, 300).astype(np.int32)
        r = rng.integers(0, 40, 300).astype(np.int32)
        k = 1 if case == "cap1" else 3
    elif case == "hub":                       # a node with 60 in-edges,
        s = np.r_[rng.integers(1, 60, 60), np.zeros(20, int)]   # self loops
        r = np.r_[np.zeros(60, int), rng.integers(0, 60, 20)]
    else:
        s = r = np.zeros(0, np.int32)
    want = jtriplets.build_triplets(s, r, k)
    got = ttriplets.build_triplets(s, r, k)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,cutoff", [(300, 10.0), (16, 10.0), (8, 10.0),
                                      (6, 5.0), (50, 5.0), (7, 3.7)])
def test_rbf_centres_bitwise(n, cutoff):
    want = np.asarray(jnp.linspace(0.0, cutoff, n, dtype=jnp.float32))
    got = tschnet._centers(n, cutoff, torch.device(CPU)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_basis_functions_match_reference():
    """≤1e-6 each, but the angular basis: its θ = arccos(cos θ) differs
    from XLA's by one f32 ulp in ~20% of inputs (XLA computes it through
    its own atan2), and cos(lθ) carries that ulp times l, times the radial
    factor.  So θ is held to one ulp at π, and the angular basis to the
    bar of the others (rtol and atol 1e-6) plus that term."""
    rng = np.random.default_rng(1)
    d = rng.uniform(0.0, 12.0, 500).astype(np.float32)
    d[:3] = (0.0, 5.0, 10.0)
    cosang = rng.uniform(-1.0, 1.0, 500).astype(np.float32)
    cosang[:2] = (1.0, -1.0)
    jcfg, tcfg = jdimenet_cfg.FULL, tdimenet_cfg.FULL
    pairs = [
        (jschnet.rbf_expand(jnp.asarray(d), 300, 10.0),
         tschnet.rbf_expand(_t(d), 300, 10.0)),
        (jschnet.cosine_cutoff(jnp.asarray(d), 10.0),
         tschnet.cosine_cutoff(_t(d), 10.0)),
        (jdimenet.envelope(jnp.asarray(d / 5.0), 6),
         tdimenet.envelope(_t(d / 5.0), 6)),
        (jdimenet.radial_basis(jnp.asarray(d), jcfg),
         tdimenet.radial_basis(_t(d), tcfg)),
    ]
    for i, (want, got) in enumerate(pairs):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32, i
        np.testing.assert_allclose(got.numpy(), want, rtol=BASIS_TOL,
                                   atol=BASIS_TOL, err_msg=str(i))
    clip = np.clip(cosang, -1.0 + 1e-6, 1.0 - 1e-6)
    ulp = float(np.spacing(np.float32(np.pi)))
    theta = torch.arccos(_t(clip)).numpy()
    assert np.abs(theta - np.asarray(jnp.arccos(jnp.asarray(clip)))).max() \
        <= ulp
    want = np.asarray(jdimenet.angular_basis(jnp.asarray(d),
                                             jnp.asarray(cosang), jcfg))
    got = tdimenet.angular_basis(_t(d), _t(cosang), tcfg).numpy()
    rad = np.abs(np.asarray(jdimenet.radial_basis(jnp.asarray(d), jcfg)))
    l = np.arange(jcfg.n_spherical, dtype=np.float32)
    bound = BASIS_TOL * (1.0 + np.abs(want)) + (
        l[None, :, None] * ulp * rad[:, None, :]).reshape(got.shape)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= bound).all()


def test_common_blocks_match_reference():
    from repro.models import common as jcommon
    from repro_torch.models import common as tcommon
    rng = np.random.default_rng(2)
    x = rng.normal(scale=8.0, size=(40, 16)).astype(np.float32)
    g, b = (rng.normal(size=16).astype(np.float32) for _ in range(2))
    for want, got in (
            (jcommon.shifted_softplus(jnp.asarray(x)),
             tcommon.shifted_softplus(_t(x))),
            (jcommon.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(b)),
             tcommon.layer_norm(_t(x), _t(g), _t(b))),
            (jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g)),
             tcommon.rms_norm(_t(x), _t(g)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=BASIS_TOL, atol=BASIS_TOL)
    for arch in MODELS:
        jp, tp = _params(arch)
        assert tcommon.count_params(tp) == jcommon.count_params(jp)


def test_kept_order_and_take():
    """``kept_order`` builds one order per id tensor and keeps it; ``take``
    equals indexing, and its backward adds a repeated id's rows in that
    order (the CPU's sequential sum); without a gradient it builds none."""
    from repro_torch.sparse import segment_ops
    ids = torch.tensor([2, 0, 2, 1, 2])
    first = segment_ops.kept_order(ids, 3)
    assert segment_ops.kept_order(ids, 3) is first
    assert segment_ops.kept_order(ids.clone(), 3) is not first
    table = torch.randn(3, 4, requires_grad=True)
    out = segment_ops.take(table, ids)
    assert torch.equal(out, table.detach()[ids])
    g = torch.randn(5, 4)
    (grad,) = torch.autograd.grad(out, table, g)
    want = torch.zeros(3, 4)
    for i, r in enumerate(ids.tolist()):
        want[r] += g[i]
    assert torch.equal(grad, want)
    with torch.no_grad():
        kept = len(segment_ops._KEPT)
        assert torch.equal(segment_ops.take(table, ids.clone()),
                           table.detach()[ids])
        assert len(segment_ops._KEPT) == kept


# ---------------------------------------------------------------------------
# models against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", sorted(MODELS))
def test_forward_matches_reference(mol, arch, backend):
    jm, tm, jcfg, tcfg, _ = MODELS[arch]
    jp, tp = _params(arch)
    want = np.asarray(jm.forward(jp, jcfg, *_args(arch, mol, jnp.asarray),
                                 backend=REF_BACKEND[backend]))
    with torch.no_grad():
        got = tm.forward(tp, tcfg, *_args(arch, mol, _t), backend=backend)
    assert got.shape == (mol["n_graphs"],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_TOL)


def _port_loss_grads(arch, tp, loss):
    leaves, structure = tree.flatten(tp)
    live = [t.clone().requires_grad_() for t in leaves]
    lt = loss(tree.unflatten(structure, live))
    return lt.item(), torch.autograd.grad(lt, live, materialize_grads=True)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", sorted(MODELS))
def test_loss_and_grads_match_reference(mol, arch, backend):
    """The loss and every parameter gradient on the reference's
    parameters, each executor against the reference's of the same kind."""
    jm, tm, jcfg, tcfg, _ = MODELS[arch]
    jp, tp = _params(arch, seed=1)
    lj, gj = jax.value_and_grad(lambda p: jm.loss_fn(
        p, jcfg, *_args(arch, mol, jnp.asarray), jnp.asarray(mol["targets"]),
        backend=REF_BACKEND[backend]))(jp)
    lt, gt = _port_loss_grads(arch, tp, lambda p: tm.loss_fn(
        p, tcfg, *_args(arch, mol, _t), _t(mol["targets"]),
        backend=backend))
    assert abs(lt - float(lj)) <= LOSS_TOL
    gj = jax.tree.leaves(gj)
    assert len(gj) == len(gt)
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_dimenet_blocks_checkpointed_equal_plain(mol):
    """The per-block checkpoint changes no bit of the loss or gradients."""
    _, tp = _params("dimenet", seed=2)
    cfg = tdimenet_cfg.reduced()

    def loss(p):
        return tdimenet.loss_fn(p, cfg, *_args("dimenet", mol, _t),
                                _t(mol["targets"]), backend="chunked")
    lt, gt = _port_loss_grads("dimenet", tp, loss)
    real = tdimenet.checkpoint
    tdimenet.checkpoint = lambda f, *a, **_: f(*a)
    try:
        lp, gp = _port_loss_grads("dimenet", tp, loss)
    finally:
        tdimenet.checkpoint = real
    assert lt == lp and all(torch.equal(a, b) for a, b in zip(gt, gp))


def test_triplet_plan_spreads_padding_and_keeps_bits():
    """``build_triplet_plan`` re-points the padding slots (id 0 in the
    reference's arrays) over the edges: no segment of its ordered sums
    holds more than a slot per edge's K, and the loss and every gradient
    are bitwise those of the reference's inline layout."""
    from repro_torch.sparse.plan import edge_plan
    mol = _molecules(batch=4, n=30, e=64, seed=5)
    t_in, t_out, t_valid = (_t(mol[k]) for k in ("t_in", "t_out",
                                                 "t_valid"))
    e = mol["senders"].shape[0]
    assert int((~t_valid).sum()) > e            # most slots are padding
    spread = tdimenet.build_triplet_plan(t_in, t_out, t_valid, e)
    assert torch.equal(spread.valid, t_valid)
    for ids in (spread.rows, spread.cols):
        assert int(torch.bincount(ids, minlength=e).max()) <= 2 * 8
    inline = edge_plan(t_in, t_out, e, edge_valid=t_valid)
    _, tp = _params("dimenet", seed=4)
    cfg = tdimenet_cfg.reduced()
    out = [_port_loss_grads("dimenet", tp, lambda p, pt=pt: tdimenet.loss_fn(
        p, cfg, *_args("dimenet", mol, _t), _t(mol["targets"]),
        backend="chunked", triplet_plan=pt)) for pt in (spread, inline)]
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# ---------------------------------------------------------------------------
# training steps: a molecule batch as a padded graph
# ---------------------------------------------------------------------------

def _train_batch(arch, mol, pkg):
    """(graph, batch, triplet plan) for ``pkg`` ("jax" or "torch"): the
    molecules as one padded graph with a ghost row (species 0, graph id
    n_graphs: dropped) and, for dimenet, the triplets of the padded edges."""
    n = mol["species"].shape[0]
    if pkg == "jax":
        from repro.sparse.graph import make_graph
        g = make_graph(mol["senders"], mol["receivers"], n, pad_multiple=8)
        cast = jnp.asarray
        s, r = np.asarray(g.senders), np.asarray(g.receivers)
    else:
        from repro_torch.sparse.graph import make_graph
        g = make_graph(mol["senders"], mol["receivers"], n, pad_multiple=8,
                       device=CPU)
        cast = _t
        s, r = g.senders.numpy(), g.receivers.numpy()
    gid = np.append(mol["graph_ids"], mol["n_graphs"]).astype(np.int32)
    batch = {"species": cast(np.append(mol["species"], 0).astype(np.int32)),
             "pos": cast(np.vstack([mol["pos"], np.zeros((1, 3),
                                                         np.float32)])),
             "senders": g.senders, "receivers": g.receivers,
             "edge_valid": g.edge_valid, "graph_ids": cast(gid),
             "targets": cast(mol["targets"])}
    pt = None
    if arch == "dimenet":
        t_in, t_out, t_valid = jtriplets.build_triplets(s, r, 8)
        batch.update(t_in=cast(t_in), t_out=cast(t_out),
                     t_valid=cast(t_valid))
        if pkg == "torch":
            pt = tdimenet.build_triplet_plan(batch["t_in"], batch["t_out"],
                                             batch["t_valid"], s.shape[0])
    return g, batch, pt


def _steps(arch, mol, backend, n_steps, two_hop=False, jax_side=False):
    """Losses of ``n_steps`` AdamW steps from the reference's parameters,
    through the reference's or the port's ``build_gnn_step``."""
    jm, _, jcfg, tcfg, conv = MODELS[arch]
    jp = jm.init_params(jax.random.key(3), jcfg)
    if jax_side:
        from repro.launch import steps as jsteps
        from repro.optim import adamw as jadamw
        g, batch, _ = _train_batch(arch, mol, "jax")
        step = jax.jit(jsteps.build_gnn_step(
            arch, jcfg, None, {"n_graphs": mol["n_graphs"]},
            jadamw.AdamWConfig(lr=1e-3), backend=REF_BACKEND[backend],
            graph=g, two_hop=two_hop))
        p, opt = jp, jadamw.init_state(jp)
    else:
        from repro_torch.launch.steps import build_gnn_step
        from repro_torch.optim import adamw
        g, batch, pt = _train_batch(arch, mol, "torch")
        step = build_gnn_step(arch, tcfg, adamw.AdamWConfig(lr=1e-3),
                              backend=backend, graph=g, two_hop=two_hop,
                              n_graphs=mol["n_graphs"], triplet_plan=pt)
        p = conv(jax.tree.map(np.asarray, jp), device=CPU)
        opt = adamw.init_state(p)
    losses = []
    for _ in range(n_steps):
        p, opt, m = step(p, opt, batch)
        losses.append(float(m["loss"]))
    return losses, p


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_trajectory_matches_reference(mol, arch):
    """Ten AdamW steps through ``build_gnn_step``, the port on ``cuda``
    against the reference on ``pallas`` (both accumulate on the chunked
    schedule) and the port's ``dense``."""
    want, _ = _steps(arch, mol, "cuda", 10, jax_side=True)
    got, _ = _steps(arch, mol, "cuda", 10)
    dense, _ = _steps(arch, mol, "dense", 10)
    assert want[-1] < want[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAJ_TOL)
    np.testing.assert_allclose(dense, got, rtol=0, atol=TRAJ_TOL)


@pytest.mark.parametrize("backend", ["dense", "cuda", "cuda_q8"])
def test_dimenet_two_hop_matches_reference_dense(mol, backend):
    """DimeNet with its Â² output stage through ``build_gnn_step`` (each
    package builds Â² with its own SpGEMM engine): three steps' losses on
    the port's executor against the reference's ``dense`` anchor, relative
    to the loss past 1 (Â²'s path counts take the loss to ~500, where one
    f32 ulp is 6e-5), as phase 14 of ``chip_smoke.py`` holds GIN over Â²;
    int8 within ``Q8_E2E_TOL`` so; and the stage changes the loss."""
    from repro_torch.sparse.quantize import Q8_E2E_TOL
    want, _ = _steps("dimenet", mol, "dense", 3, two_hop=True,
                     jax_side=True)
    got, _ = _steps("dimenet", mol, backend, 3, two_hop=True)
    one_hop, _ = _steps("dimenet", mol, backend, 1)
    tol = Q8_E2E_TOL if backend == "cuda_q8" else TRAJ_TOL
    for a, b in zip(got, want):
        assert abs(a - b) <= tol * max(1.0, abs(b)), (got, want)
    assert abs(one_hop[0] - got[0]) > 1.0


def test_build_gnn_step_guards_and_plans(mol):
    from repro_torch.launch.steps import build_gnn_step
    g, batch, pt = _train_batch("dimenet", mol, "torch")
    with pytest.raises(ValueError, match="graph="):
        build_gnn_step("dimenet", tdimenet_cfg.reduced(), two_hop=True)
    with pytest.raises(ValueError, match="two_hop"):
        build_gnn_step("schnet", tschnet_cfg.reduced(), graph=g,
                       two_hop=True)
    # the config's flag builds the stage as the argument does
    cfg = dataclasses.replace(tdimenet_cfg.reduced(), two_hop=True)
    from repro_torch.optim import adamw
    _, p = _params("dimenet")
    losses = [float(build_gnn_step("dimenet", c, graph=g, n_graphs=3,
                                   triplet_plan=pt, two_hop=a)(
        p, adamw.init_state(p), batch)[2]["loss"])
        for c, a in ((cfg, None), (tdimenet_cfg.reduced(), True),
                     (tdimenet_cfg.reduced(), None))]
    assert losses[0] == losses[1] != losses[2]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

N_SERVE, E_SERVE = 200, 900
FANOUTS = (3, 2)
SERVE_CFGS = {
    "schnet": (jschnet.SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=8),
               tschnet.SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=8)),
    "dimenet": (jdimenet.DimeNetConfig(n_blocks=1, d_hidden=8, n_bilinear=2,
                                       n_spherical=3),
                tdimenet.DimeNetConfig(n_blocks=1, d_hidden=8, n_bilinear=2,
                                       n_spherical=3)),
}


@pytest.fixture(scope="module")
def serve_world():
    from repro_torch.data.synthetic import powerlaw_graph
    from repro_torch.launch.gnn_serve import geometry
    from repro_torch.sparse.graph import coo_to_csr
    s, r = powerlaw_graph(N_SERVE, E_SERVE, seed=3)
    indptr, indices, _ = coo_to_csr(s, r, N_SERVE)
    species, pos = geometry(np.random.default_rng(4), N_SERVE)
    seeds = np.random.default_rng(5).integers(0, N_SERVE, 8)
    return indptr, indices, species, pos, seeds


def _serve_params(arch):
    jm, _, _, _, conv = MODELS[arch]
    jcfg, tcfg = SERVE_CFGS[arch]
    jp = jm.init_params(jax.random.key(2), jcfg)
    return jcfg, tcfg, jp, conv(jax.tree.map(np.asarray, jp), device=CPU)


def test_bucket_triplets_match_reference():
    from repro.serve.buckets import build_bucket_structure as jbuild
    for n_seeds, fanouts in ((1, (5, 3)), (16, (5, 3)), (4, (2, 2, 2)),
                             (2, (4,))):
        want = jbuild(n_seeds, fanouts)
        got = build_bucket_structure(n_seeds, fanouts)
        for f in ("t_in", "t_out", "senders", "receivers"):
            w, g = getattr(want, f), getattr(got, f)
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got.n_triplets == want.n_triplets


@pytest.mark.parametrize("backend", ["dense", "cuda", "cuda_q8"])
@pytest.mark.parametrize("arch", sorted(MODELS))
def test_infer_step_matches_reference(serve_world, arch, backend):
    """A bucket-8 step with a padding lane against the reference's
    unjitted step; each live row equals the same tree served alone in a
    bucket of one (the padding lane reaches no live row)."""
    indptr, indices, species, pos, seeds = serve_world
    jcfg, tcfg, jp, tp = _serve_params(arch)
    trees = tsampler.sample_forest(indptr, indices, seeds[:7], FANOUTS,
                                   key=3)
    node_ids, hop_valid = stack_trees(trees, 8, FANOUTS)
    struct = build_bucket_structure(8, FANOUTS)
    jstore = jcompute.FeatureStore.build(N_SERVE, species=species, pos=pos)
    want = np.asarray(jcompute.build_infer_step(
        arch, jcfg, jstore, struct, backend=REF_BACKEND[backend],
        jit=False)(jp, jnp.asarray(node_ids), jnp.asarray(hop_valid)))
    tstore = tcompute.FeatureStore.build(N_SERVE, device=CPU,
                                         species=species, pos=pos)
    got = tcompute.build_infer_step(arch, tcfg, tstore, struct,
                                    backend=backend)(tp, node_ids, hop_valid)
    assert got.shape == (8, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SERVE_TOL)
    one = tcompute.build_infer_step(arch, tcfg, tstore,
                                    build_bucket_structure(1, FANOUTS),
                                    backend=backend)
    alone = np.concatenate([one(tp, *stack_trees([t], 1, FANOUTS)).numpy()
                            for t in trees])
    np.testing.assert_allclose(got.numpy()[:7], alone, rtol=0,
                               atol=SERVE_TOL)


def test_feature_store_matches_reference(serve_world):
    _, _, species, pos, _ = serve_world
    jstore = jcompute.FeatureStore.build(N_SERVE, species=species, pos=pos)
    tstore = tcompute.FeatureStore.build(N_SERVE, device=CPU,
                                         species=species, pos=pos)
    assert tstore.x is None and tstore.device == torch.device(CPU)
    np.testing.assert_array_equal(tstore.species.numpy(),
                                  np.asarray(jstore.species))
    np.testing.assert_array_equal(tstore.pos.numpy(), np.asarray(jstore.pos))
    with pytest.raises(ValueError, match="rows"):
        tcompute.FeatureStore.build(N_SERVE, device=CPU, species=species[:5],
                                    pos=pos)
    with pytest.raises(ValueError, match="FeatureStore.x"):
        tcompute.build_infer_step("gcn", None, tstore,
                                  build_bucket_structure(1, FANOUTS,
                                                         with_loops=True))


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_server_matches_offline_replay(serve_world, arch):
    """A whole server per arch with the device sampler on ``cuda``: every
    request settles once, no rebuild after warm-up, no dedup-chunk layout
    packed for a geometric bucket, results equal offline replay."""
    from repro_torch.serve import GNNServer, offline_replay
    indptr, indices, species, pos, _ = serve_world
    _, tcfg, _, tp = _serve_params(arch)
    store = tcompute.FeatureStore.build(N_SERVE, device=CPU, species=species,
                                        pos=pos)
    with GNNServer(arch, tcfg, tp, indptr, indices, store,
                   fanouts=FANOUTS, backend="cuda", sampler="device",
                   max_batch_seeds=8, device=CPU) as server:
        server.warmup()
        builds = server.steps.builds
        reqs = [server.submit([int(s)]) for s in range(0, N_SERVE, 9)]
        server.drain()
        assert server.steps.builds == builds
        struct = server._struct(8)
        assert not struct.with_loops
        assert not tcompute.bucket_plan(struct, "cuda", False,
                                        torch.device(CPU)).has("ell")
        for r in reqs:
            assert r.n_settles == 1 and r.error is None
            assert r.result.shape == (1, 1)
            np.testing.assert_allclose(r.result, offline_replay(server, r),
                                       rtol=0, atol=SERVE_TOL)


@pytest.mark.parametrize("arch,backend,sampler",
                         [("schnet", "cuda", "host"),
                          ("dimenet", "cuda_q8", "device")])
def test_gnn_serve_cli(capsys, arch, backend, sampler):
    from repro_torch.launch import gnn_serve
    assert gnn_serve.parity_tol(backend, arch) == SERVE_TOL
    assert gnn_serve.main(["--arch", arch, "--backend", backend,
                           "--sampler", sampler, "--device", CPU,
                           "--requests", "24", "--nodes", "300", "--edges",
                           "1200"]) == 0
    out = capsys.readouterr().out
    assert f"{arch}/{backend}/{sampler}" in out and "(OK)" in out


def test_gnn_serve_world_matches_reference():
    """``build_world``'s configs and draws are the reference's: the store's
    species and positions come after the features from one generator."""
    from repro.launch import gnn_serve as jgnn_serve
    from repro_torch.launch import gnn_serve
    for arch in MODELS:
        jcfg, _, jip, jix, jstore = jgnn_serve.build_world(arch, 120, 400,
                                                           8, seed=4)
        tcfg, _, tip, tix, tstore = gnn_serve.build_world(120, 400, 8, 4,
                                                          CPU, arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        np.testing.assert_array_equal(tip, jip)
        np.testing.assert_array_equal(tix, jix)
        np.testing.assert_array_equal(tstore.species.numpy(),
                                      np.asarray(jstore.species))
        np.testing.assert_array_equal(tstore.pos.numpy(),
                                      np.asarray(jstore.pos))


# ---------------------------------------------------------------------------
# shapes, configs, registry, converters
# ---------------------------------------------------------------------------

def test_shapes_configs_and_registry_match_reference():
    from repro.configs import registry as jregistry
    from repro.configs import shapes as jshapes
    from repro_torch.configs import registry, shapes
    assert shapes.pad_to_multiple(2049) == jshapes.pad_to_multiple(2049)
    for name, shape in jshapes.GNN_SHAPES.items():
        got = shapes.GNN_SHAPES[name]
        assert dataclasses.asdict(got) == dataclasses.asdict(shape)
        assert (got.n_nodes_pad, got.n_edges_pad) == (shape.n_nodes_pad,
                                                      shape.n_edges_pad)
        assert shapes.minibatch_node_budget(got) == \
            jshapes.minibatch_node_budget(shape)
        assert shapes.minibatch_edge_budget(got) == \
            jshapes.minibatch_edge_budget(shape)
    for arch, (jcfg_mod, tcfg_mod) in {
            "schnet": (jschnet_cfg, tschnet_cfg),
            "dimenet": (jdimenet_cfg, tdimenet_cfg)}.items():
        for a, b in ((tcfg_mod.FULL, jcfg_mod.FULL),
                     (tcfg_mod.reduced(), jcfg_mod.reduced())):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        e = registry.entry(arch)
        assert (e.family, e.gnn_kind) == ("gnn", "geom")
        assert e.gnn_kind == jregistry.ARCHS[arch].gnn_kind
        assert registry.get_config(arch) == tcfg_mod.FULL
    for arch in ("gcn-cora", "gat-cora"):
        assert registry.entry(arch).gnn_kind == "conv"


def test_converters_check_shapes():
    for arch in MODELS:
        jp, tp = _params(arch)
        assert [tuple(t.shape) for t in tree.leaves(tp)] == [
            np.shape(a) for a in jax.tree.leaves(jp)]
    s = jax.tree.map(np.asarray, jschnet.init_params(
        jax.random.key(0), jschnet_cfg.reduced()))
    bad = dict(s, int0=dict(s["int0"], w_in=np.zeros((3, 3), np.float32)))
    with pytest.raises(ValueError, match="w_in"):
        convert.schnet_params_from_jax(bad, device=CPU)
    with pytest.raises(ValueError, match="keys"):
        convert.schnet_params_from_jax({k: v for k, v in s.items()
                                        if k != "atomwise"}, device=CPU)
    bad = dict(s, int1=dict(s["int1"], filter={
        k: v[:, :3] if k == "w1" else v
        for k, v in s["int1"]["filter"].items()}))
    with pytest.raises(ValueError, match="filter"):
        convert.schnet_params_from_jax(bad, device=CPU)
    d = jax.tree.map(np.asarray, jdimenet.init_params(
        jax.random.key(0), jdimenet_cfg.reduced()))
    bad = dict(d, blocks=dict(d["blocks"], w_bilinear=d["blocks"][
        "w_bilinear"][:, :2]))
    with pytest.raises(ValueError, match="w_bilinear"):
        convert.dimenet_params_from_jax(bad, device=CPU)
    bad = dict(d, blocks={k: v for k, v in d["blocks"].items()
                          if k != "rbf_out"})
    with pytest.raises(ValueError, match="keys"):
        convert.dimenet_params_from_jax(bad, device=CPU)
    bad = dict(d, edge_embed={"w0": d["edge_embed"]["w0"][:5],
                              "b0": d["edge_embed"]["b0"]})
    with pytest.raises(ValueError, match="edge_embed"):
        convert.dimenet_params_from_jax(bad, device=CPU)


def test_init_params_shapes_match_reference():
    """The port's own initializer gives the reference's tree: same keys,
    shapes and dtypes (the draws differ by generator)."""
    for arch, (jm, tm, jcfg, tcfg, _) in MODELS.items():
        for jc, tc in ((jcfg, tcfg), (
                jdimenet_cfg.FULL if arch == "dimenet" else jschnet_cfg.FULL,
                tdimenet_cfg.FULL if arch == "dimenet" else
                tschnet_cfg.FULL)):
            want = jax.eval_shape(lambda k, c=jc: jm.init_params(k, c),
                                  jax.random.key(0))
            got = tm.init_params(tc, torch.Generator().manual_seed(0), CPU)
            leaves, structure = tree.flatten(got)
            assert [tuple(t.shape) for t in leaves] == [
                w.shape for w in jax.tree.leaves(want)]
            assert all(t.dtype == torch.float32 for t in leaves)
