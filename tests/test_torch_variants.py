"""The port's DRHM-sharded GCN training step (``repro_torch.launch.
variants``) against the reference's, on the CPU — the counterpart of
``tests/test_variants.py``.

The reference's own test fails on jax 0.9.0: ``jax.make_mesh`` builds
``Explicit`` axes by default, and under them the step's
``with_sharding_constraint(h, P(dp, None))`` is an assertion that an
unsharded input fails (ROADMAP C4).  Here one subprocess runs the
reference's local ``gcn.loss_fn`` and its ``build_gcn_drhm_step`` (all-gather
and ring) on an ``Auto`` ``(4, 2)`` mesh of 8 emulated devices; one world
of 8 gloo ranks runs the port's step on the same graph, parameters and
batch.  Held: the step's loss equal to the reference's local loss and to
the port's local GCN loss ≤1e-4, its gradient norm to the reference
step's, parameters after one AdamW step to the reference step's, three
steps finite, every rank equal to rank 0, and the elastic half: a
checkpoint written by rank 0 of the 8-rank world restores onto one
device, each leaf equal.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import spmd

ROOT = Path(__file__).resolve().parent.parent

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.core import distributed
from repro.core.compat import use_mesh
from repro.launch import variants
from repro.models.gnn import gcn
from repro.optim import adamw
from repro.sparse.graph import sym_norm_weights
out = {}
rng = np.random.default_rng(0)
n, e, d_in, n_cls = 60, 300, 12, 4
s = rng.integers(0, n, e); r = rng.integers(0, n, e)
s2, r2, w = sym_norm_weights(s, r, n, add_self_loops=False)
x = rng.normal(size=(n, d_in)).astype(np.float32)
y = rng.integers(0, n_cls, n).astype(np.int32)
mask = np.zeros(n, bool); mask[:30] = True
cfg = gcn.GCNConfig(n_layers=2, d_in=d_in, d_hidden=8, n_classes=n_cls)
params = gcn.init_params(jax.random.key(0), cfg)
out.update(x=x, y=y, mask=mask, s2=s2, r2=r2, w=w)
for i in range(2):
    out[f"p_w{i}"] = np.asarray(params[f"layer{i}"]["w"])
    out[f"p_b{i}"] = np.asarray(params[f"layer{i}"]["b"])
out["ref_loss"] = np.float32(gcn.loss_fn(
    params, cfg, jnp.asarray(x), jnp.asarray(s2), jnp.asarray(r2),
    jnp.asarray(w), jnp.ones(len(s2), bool), jnp.asarray(y),
    jnp.asarray(mask)))
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
for ring in (False, True):
    tag = "ring" if ring else "ag"
    plan = distributed.plan_distributed_spmm(r2, s2, w, n, n_shards=4,
                                             ring=ring)
    xp = distributed.permute_features(x, plan)
    yp = np.zeros(plan.n_pad, np.int32); yp[plan.perm[:n]] = y
    mp = np.zeros(plan.n_pad, bool); mp[plan.perm[:n]] = mask
    batch = {"x_perm": xp, "labels_perm": yp, "mask_perm": mp}
    if ring:
        batch.update(ring_rows=plan.ring_rows, ring_cols=plan.ring_cols,
                     ring_vals=plan.ring_vals)
    else:
        batch.update(rows_local=plan.rows_local, cols_perm=plan.cols_perm,
                     vals=plan.vals)
    for k, v in batch.items():
        out[f"{tag}_{k}"] = v
    out[f"{tag}_n_pad"] = np.int64(plan.n_pad)
    step = variants.build_gcn_drhm_step(cfg, mesh, plan.n_pad, ring=ring,
                                        opt_cfg=adamw.AdamWConfig(lr=1e-2))
    with use_mesh(mesh):
        new_p, _, metrics = jax.jit(step)(
            params, adamw.init_state(params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    out[f"{tag}_loss"] = np.float32(metrics["loss"])
    out[f"{tag}_gnorm"] = np.float32(metrics["grad_norm"])
    for i in range(2):
        out[f"{tag}_new_w{i}"] = np.asarray(new_p[f"layer{i}"]["w"])
        out[f"{tag}_new_b{i}"] = np.asarray(new_p[f"layer{i}"]["b"])
from repro.configs import shapes as S
shape = S.GNNShape(name="t", kind="fullgraph", n_nodes=50_000,
                   n_edges=400_000, d_feat=16, n_classes=4)
for ring in (False, True):
    specs, n_pad = variants.gcn_drhm_specs(shape, 4, ring)
    tag = "ring" if ring else "ag"
    out[f"spec_{tag}_n_pad"] = np.int64(n_pad)
    for k, v in specs.items():
        out[f"spec_{tag}_{k}"] = np.asarray(v.shape)
np.savez(sys.argv[1], **out)
"""


def run_reference(script: str, path: Path) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", script, str(path)], capture_output=True,
        text=True, timeout=600,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.path.expanduser("~"),
             "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def _params(ref, pre="p_"):
    return {f"layer{i}": {"w": torch.from_numpy(ref[f"{pre}w{i}"]).clone(),
                          "b": torch.from_numpy(ref[f"{pre}b{i}"]).clone()}
            for i in range(2)}


def port_world(rank, mesh, ref, ckpt_dir):
    from repro_torch.checkpoint import store
    from repro_torch.launch import variants
    from repro_torch.models.gnn import gcn
    from repro_torch.optim import adamw
    t = torch.from_numpy
    cfg = gcn.GCNConfig(n_layers=2, d_in=12, d_hidden=8, n_classes=4)
    out = {"local_loss": float(gcn.loss_fn(
        _params(ref), cfg, t(ref["x"]), t(ref["s2"]), t(ref["r2"]),
        t(ref["w"]), torch.ones(len(ref["s2"]), dtype=torch.bool),
        t(ref["y"]), t(ref["mask"])))}
    for tag, ring in (("ag", False), ("ring", True)):
        keys = (("ring_rows", "ring_cols", "ring_vals") if ring else
                ("rows_local", "cols_perm", "vals"))
        batch = {k: t(ref[f"{tag}_{k}"])
                 for k in ("x_perm", "labels_perm", "mask_perm") + keys}
        step = variants.build_gcn_drhm_step(
            cfg, mesh, int(ref[f"{tag}_n_pad"]), ring=ring,
            opt_cfg=adamw.AdamWConfig(lr=1e-2))
        params = _params(ref)
        opt = adamw.init_state(params)
        losses = []
        for i in range(3):
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            if i == 0:
                out[f"{tag}_gnorm"] = float(m["grad_norm"])
                out[f"{tag}_new"] = {k: {n: v.numpy().copy()
                                         for n, v in p.items()}
                                     for k, p in params.items()}
                if rank == 0 and not ring:
                    store.save(ckpt_dir, 1, (params, opt))
        out[f"{tag}_losses"] = losses
        out[f"{tag}_finite"] = all(bool(torch.isfinite(v).all())
                                   for p in params.values()
                                   for v in p.values())
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    ref = run_reference(REF, tmp_path_factory.mktemp("ref") / "ref.npz")
    ckpt = tmp_path_factory.mktemp("ckpt")
    ranks = spmd.spawn(port_world, 8, mesh_shape=(4, 2),
                       mesh_names=("data", "model"), args=(ref, str(ckpt)))
    return ref, ranks, ckpt


@pytest.mark.parametrize("tag", ["ag", "ring"])
def test_drhm_step_loss_equals_local_gcn(both, tag):
    ref, ranks, _ = both
    got = ranks[0][f"{tag}_losses"][0]
    assert abs(got - float(ref["ref_loss"])) < 1e-4
    assert abs(got - ranks[0]["local_loss"]) < 1e-4
    assert abs(got - float(ref[f"{tag}_loss"])) < 1e-4


@pytest.mark.parametrize("tag", ["ag", "ring"])
def test_drhm_step_update_matches_reference_step(both, tag):
    ref, ranks, _ = both
    got = ranks[0]
    assert abs(got[f"{tag}_gnorm"] - float(ref[f"{tag}_gnorm"])) <= \
        1e-5 * float(ref[f"{tag}_gnorm"])
    for i in range(2):
        np.testing.assert_allclose(got[f"{tag}_new"][f"layer{i}"]["w"],
                                   ref[f"{tag}_new_w{i}"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[f"{tag}_new"][f"layer{i}"]["b"],
                                   ref[f"{tag}_new_b{i}"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("tag", ["ag", "ring"])
def test_three_steps_finite_and_ranks_agree(both, tag):
    _, ranks, _ = both
    assert ranks[0][f"{tag}_finite"]
    assert ranks[0][f"{tag}_losses"][2] < ranks[0][f"{tag}_losses"][0]
    for r in ranks[1:]:
        assert r[f"{tag}_losses"] == ranks[0][f"{tag}_losses"]


def test_elastic_restore_onto_one_device(both):
    """A checkpoint written under the 8-rank mesh restores onto one
    device."""
    from repro_torch.checkpoint import store
    from repro_torch.optim import adamw
    ref, ranks, ckpt = both
    like_p = _params(ref)
    (rp, _), _ = store.restore(ckpt, 1, (like_p, adamw.init_state(like_p)))
    for k, p in ranks[0]["ag_new"].items():
        for name, v in p.items():
            assert rp[k][name].device.type == "cpu"
            np.testing.assert_array_equal(rp[k][name].numpy(), v)


def test_specs_and_pspecs_match_reference_layout(both):
    from repro_torch.configs import shapes as S
    from repro_torch.launch import variants
    ref, _, _ = both
    shape = S.GNNShape(name="t", kind="fullgraph", n_nodes=50_000,
                       n_edges=400_000, d_feat=16, n_classes=4)
    for ring in (False, True):
        specs, n_pad = variants.gcn_drhm_specs(shape, 4, ring)
        tag = "ring" if ring else "ag"
        assert n_pad == int(ref[f"spec_{tag}_n_pad"])
        for k, v in specs.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(ref[f"spec_{tag}_{k}"])
        ps = variants.gcn_drhm_input_pspecs(specs, _MeshNames())
        assert ps["x_perm"] == (("data",), None)
        assert ps["labels_perm"] == (("data",),)
        if ring:
            assert ps["ring_rows"] == (("data",), None, None)


class _MeshNames:
    mesh_dim_names = ("data", "model")
