"""The port's distributed executor (``repro_torch.core.distributed``,
``compressed_psum``, the plan's ``dist_*`` section and the ``distributed``
backend) against the reference's, on the CPU.

One subprocess runs the reference on 8 emulated XLA devices
(``--xla_force_host_platform_device_count=8``, a ``(4, 2)`` ``("data",
"model")`` mesh, the bodies of ``tests/test_distributed.py`` and of
``tests/test_backends.py``'s ``DIST_SCRIPT``) and saves its outputs; one
world of 8 gloo ranks (``launch.spmd.spawn``, the same ``(4, 2)`` mesh)
runs the port on the same numpy inputs.  Held: the plan's arrays and
``plan_feature_sharding``'s permutation bitwise; the all-gather and ring
SpMMs ≤1e-4 and their gradients ≤1e-3; ``compressed_psum`` ≤0.05 relative
to a plain psum; the backend's aggregate, accumulate, gradient and GCN
forward; the halo gather bitwise; and every rank's result equal to rank
0's.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as D
from repro_torch.launch import spmd

ROOT = Path(__file__).resolve().parent.parent

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import distributed
from repro.core.compat import shard_map, use_mesh
from repro.optim.compression import compressed_psum
from repro.sparse.plan import plan_feature_sharding
out = {}
inputs = dict(np.load(sys.argv[2]))

# --- tests/test_distributed.py's body ---
rng = np.random.default_rng(1)
n, e, d = 96, 700, 32
rows = rng.integers(0, n, e); cols = rng.integers(0, n, e)
vals = rng.normal(size=e).astype(np.float32)
x = rng.normal(size=(n, d)).astype(np.float32)
mesh = jax.make_mesh((4, 2), ("data", "model"))
plan = distributed.plan_distributed_spmm(rows, cols, vals, n, n_shards=4,
                                         ring=True)
for k in ("rows_local", "cols_perm", "vals", "perm", "inv_perm",
          "ring_rows", "ring_cols", "ring_vals", "slots"):
    out["plan_" + k] = getattr(plan, k)
xp = distributed.permute_features(x, plan)
f = distributed.make_allgather_spmm(mesh, plan)
g = distributed.make_ring_spmm(mesh, plan)
ag = (jnp.asarray(plan.rows_local), jnp.asarray(plan.cols_perm),
      jnp.asarray(plan.vals))
rg = (jnp.asarray(plan.ring_rows), jnp.asarray(plan.ring_cols),
      jnp.asarray(plan.ring_vals))
with use_mesh(mesh):
    out["y_ag"] = np.asarray(f(jnp.asarray(xp), *ag))
    out["y_ring"] = np.asarray(g(jnp.asarray(xp), *rg))
    out["g_ag"] = np.asarray(jax.grad(
        lambda z: jnp.sum(f(z, *ag) ** 2))(jnp.asarray(xp)))
    out["g_ring"] = np.asarray(jax.grad(
        lambda z: jnp.sum(g(z, *rg) ** 2))(jnp.asarray(xp)))
z = rng.normal(size=(8, 64)).astype(np.float32)
sm_ps = shard_map(lambda v: jax.lax.psum(v, "data"), mesh=mesh,
                  in_specs=P("data"), out_specs=P())
sm_cps = shard_map(lambda v: compressed_psum(v, "data"), mesh=mesh,
                   in_specs=P("data"), out_specs=P())
with use_mesh(mesh):
    out["psum"] = np.asarray(sm_ps(jnp.asarray(z)))
    out["cpsum"] = np.asarray(sm_cps(jnp.asarray(z)))
# the halo gather of the sharded cluster, on a 4-lane mesh
fs = plan_feature_sharding(n + 1, 4)
out["fs_perm"], out["fs_inv_perm"] = fs.perm, fs.inv_perm
table = np.concatenate([x, np.zeros((1, d), np.float32)])
ids = inputs["halo_ids"]
lane_mesh = jax.make_mesh((4,), ("lane",))
halo = distributed.make_halo_gather(lane_mesh, n_ghost_slot=n,
                                    data_axis="lane")
with use_mesh(lane_mesh):
    out["halo"] = np.asarray(halo(jnp.asarray(fs.permute_table(table)),
                                  jnp.asarray(fs.perm.astype(np.int32)),
                                  jnp.asarray(ids)))

# --- tests/test_backends.py's DIST_SCRIPT ---
from repro.models.gnn import gcn
from repro.sparse import backend as sb
from repro.sparse.plan import make_plan
from repro.sparse.graph import sym_norm_weights
rng = np.random.default_rng(2)
n, e, d = 96, 600, 16
s = rng.integers(0, n, e); r = rng.integers(0, n, e)
valid = np.ones(e, bool); valid[550:] = False
w = rng.normal(size=e).astype(np.float32)
xb = rng.normal(size=(n, d)).astype(np.float32)
# jax 0.9.0's make_mesh gives Explicit axes by default, under which the
# reference's shard_map gathers raise (ROADMAP C4); its executor runs on
# an Auto mesh, as older jax built by default
from jax.sharding import AxisType
auto = jax.make_mesh((8,), ("data",), axis_types=(AxisType.Auto,))
bplan = make_plan(s, r, n, edge_weight=w, edge_valid=valid,
                  backends=("dense", "distributed"), mesh=auto)
out["b_n_shards"] = np.int64(bplan.n_shards)
for k in ("dist_rows_local", "dist_cols_perm", "dist_vals", "dist_slots",
          "dist_perm", "dist_inv_perm"):
    out["b_" + k] = np.asarray(getattr(bplan, k))
X = jnp.asarray(xb)
msgs = inputs["b_msgs"]
cfg = gcn.GCNConfig(d_in=d, d_hidden=8, n_classes=4, n_layers=2)
s2, r2, w2 = sym_norm_weights(s, r, n)
plan2 = make_plan(s2, r2, n + 1, edge_weight=w2,
                  backends=("dense", "distributed"), mesh=auto)
params = {f"layer{i}": {"w": jnp.asarray(inputs[f"p_w{i}"]),
                        "b": jnp.asarray(inputs[f"p_b{i}"])}
          for i in range(2)}
xf = inputs["f_x"]
# DIST_SCRIPT holds `distributed` against `dense`: both are kept
for name in ("dense", "distributed"):
    try:
        loss = jax.jit(lambda v, xx: jnp.sum(
            sb.aggregate(bplan, v, xx, backend=name) ** 2))
        res = {
            "b_agg": sb.aggregate(bplan, None, X, backend=name),
            "b_grad": jax.grad(loss, argnums=1)(jnp.asarray(w), X),
            "b_grad_v": jax.grad(loss, argnums=0)(jnp.asarray(w), X),
            "b_acc": sb.accumulate(bplan, jnp.asarray(msgs), backend=name),
            "f_out": gcn.forward(params, cfg, jnp.asarray(xf),
                                 backend=name, plan=plan2)}
    except Exception as exc:
        raise SystemExit(f"reference {name}: {type(exc).__name__}: {exc}")
    for k, v in res.items():
        out[f"{k}_{name}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


def _inputs(path) -> dict:
    """What both sides take beyond the seeded graphs: the halo's node ids,
    the accumulate's messages, GCN parameters (N(0, 1/fan_in) weights,
    small biases) and the forward's features, saved to ``path``."""
    rng = np.random.default_rng(11)
    out = {"halo_ids": rng.integers(-1, 96, (4, 10)),
           "b_msgs": rng.normal(size=(600, 16)).astype(np.float32),
           "f_x": rng.normal(size=(97, 16)).astype(np.float32)}
    for i, (a, b) in enumerate(((16, 8), (8, 4))):
        out[f"p_w{i}"] = (rng.normal(size=(a, b)) / a ** 0.5).astype(
            np.float32)
        out[f"p_b{i}"] = (0.1 * rng.normal(size=b)).astype(np.float32)
    np.savez(path, **out)
    return out


def port_world(rank, mesh, ref):
    """Every rank runs the port on the reference's inputs; returns its
    outputs as numpy arrays."""
    from repro_torch.models.gnn import gcn
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse.graph import sym_norm_weights
    from repro_torch.sparse.plan import make_plan, plan_feature_sharding
    t = torch.from_numpy
    out = {}
    rng = np.random.default_rng(1)
    n, e, d = 96, 700, 32
    rows = rng.integers(0, n, e)
    cols = rng.integers(0, n, e)
    vals = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    plan = D.plan_distributed_spmm(rows, cols, vals, n, n_shards=4,
                                   ring=True)
    for k in ("rows_local", "cols_perm", "vals", "perm", "inv_perm",
              "ring_rows", "ring_cols", "ring_vals", "slots"):
        out["plan_" + k] = getattr(plan, k)
    xp = t(D.permute_features(x, plan))
    f = D.make_allgather_spmm(mesh, plan)
    g = D.make_ring_spmm(mesh, plan)
    ag = (t(plan.rows_local), t(plan.cols_perm), t(plan.vals))
    rg = (t(plan.ring_rows), t(plan.ring_cols), t(plan.ring_vals))
    out["y_ag"] = f(xp, *ag).numpy()
    out["y_ring"] = g(xp, *rg).numpy()
    for name, fn, a in (("g_ag", f, ag), ("g_ring", g, rg)):
        z = xp.clone().requires_grad_()
        (fn(z, *a) ** 2).sum().backward()
        out[name] = z.grad.numpy()
    zz = t(rng.normal(size=(8, 64)).astype(np.float32))
    out["psum"] = D.shard_map(lambda v: D.psum(v, "data"), mesh,
                              in_specs=[("data",)], out_specs=())(zz).numpy()
    out["cpsum"] = D.shard_map(lambda v: compressed_psum(v, "data"), mesh,
                               in_specs=[("data",)], out_specs=())(zz).numpy()
    # the halo gather over the 4 ranks of the data axis
    fs = plan_feature_sharding(n + 1, 4)
    out["fs_perm"], out["fs_inv_perm"] = fs.perm, fs.inv_perm
    table = np.concatenate([x, np.zeros((1, d), np.float32)])
    halo = D.make_halo_gather(mesh, n_ghost_slot=n, data_axis="data")
    out["halo"] = halo(t(fs.permute_table(table)),
                       t(fs.perm.astype(np.int64)),
                       t(ref["halo_ids"])).numpy()

    # the backend, on a one-axis mesh over the world's 8 ranks
    rng = np.random.default_rng(2)
    n, e, d = 96, 600, 16
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    valid = np.ones(e, bool)
    valid[550:] = False
    w = rng.normal(size=e).astype(np.float32)
    xb = t(rng.normal(size=(n, d)).astype(np.float32))
    bplan = make_plan(s, r, n, edge_weight=w, edge_valid=valid,
                      backends=("dense", "distributed"), device="cpu")
    out["b_n_shards"] = np.int64(bplan.n_shards)
    for k in ("dist_rows_local", "dist_cols_perm", "dist_vals",
              "dist_slots", "dist_perm", "dist_inv_perm"):
        out["b_" + k] = getattr(bplan, k).numpy()
    out["b_agg"] = sb.aggregate(bplan, None, xb,
                                backend="distributed").numpy()
    xg = xb.clone().requires_grad_()
    vg = t(w).requires_grad_()
    (sb.aggregate(bplan, vg, xg, backend="distributed") ** 2).sum(
        ).backward()
    out["b_grad"], out["b_grad_v"] = xg.grad.numpy(), vg.grad.numpy()
    out["b_acc"] = sb.accumulate(bplan, t(ref["b_msgs"]),
                                 backend="distributed").numpy()
    cfg = gcn.GCNConfig(d_in=d, d_hidden=8, n_classes=4, n_layers=2)
    s2, r2, w2 = sym_norm_weights(s, r, n)
    plan2 = make_plan(s2, r2, n + 1, edge_weight=w2,
                      backends=("dense", "distributed"), device="cpu")
    params = {f"layer{i}": {"w": t(ref[f"p_w{i}"]), "b": t(ref[f"p_b{i}"])}
              for i in range(2)}
    out["f_out"] = gcn.forward(params, cfg, t(ref["f_x"]),
                               backend="distributed", plan=plan2).numpy()
    out["transport"] = D.transport(mesh, "cpu")
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's subprocess and the port's world, side by side."""
    d = tmp_path_factory.mktemp("ref")
    inputs = _inputs(d / "inputs.npz")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF, str(d / "ref.npz"),
         str(d / "inputs.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.path.expanduser("~"),
             "JAX_PLATFORMS": "cpu"})
    try:
        ranks = spmd.spawn(port_world, 8, mesh_shape=(4, 2),
                           mesh_names=("data", "model"), args=(inputs,))
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    with np.load(d / "ref.npz") as z:
        return dict(z), ranks


PLAN_KEYS = ["rows_local", "cols_perm", "vals", "perm", "inv_perm",
             "ring_rows", "ring_cols", "ring_vals", "slots"]


@pytest.mark.parametrize("key", PLAN_KEYS)
def test_plan_arrays_bitwise(both, key):
    ref, ranks = both
    got = ranks[0]["plan_" + key]
    assert got.dtype == ref["plan_" + key].dtype
    np.testing.assert_array_equal(got, ref["plan_" + key])


def test_feature_sharding_permutation_bitwise(both):
    ref, ranks = both
    np.testing.assert_array_equal(ranks[0]["fs_perm"], ref["fs_perm"])
    np.testing.assert_array_equal(ranks[0]["fs_inv_perm"],
                                  ref["fs_inv_perm"])


@pytest.mark.parametrize("key", ["y_ag", "y_ring"])
def test_spmm_matches_reference(both, key):
    ref, ranks = both
    np.testing.assert_allclose(ranks[0][key], ref[key], atol=1e-4, rtol=0)
    np.testing.assert_allclose(ranks[0]["y_ag"], ranks[0]["y_ring"],
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("key", ["g_ag", "g_ring"])
def test_spmm_gradients_match_reference(both, key):
    ref, ranks = both
    np.testing.assert_allclose(ranks[0][key], ref[key], atol=1e-3, rtol=0)
    assert np.abs(ranks[0]["g_ag"] - ranks[0]["g_ring"]).max() < 1e-3


def test_compressed_psum_within_int8_tolerance(both):
    ref, ranks = both
    a, b = ranks[0]["psum"], ranks[0]["cpsum"]
    np.testing.assert_allclose(a, ref["psum"], atol=1e-5, rtol=0)
    assert np.abs(a - b).max() / (np.abs(a).max() + 1e-9) < 0.05
    np.testing.assert_allclose(b, ref["cpsum"], atol=1e-5, rtol=0)


def test_halo_gather_bitwise(both):
    ref, ranks = both
    np.testing.assert_array_equal(ranks[0]["halo"], ref["halo"])


@pytest.mark.parametrize("key", ["dist_rows_local", "dist_cols_perm",
                                 "dist_vals", "dist_slots", "dist_perm",
                                 "dist_inv_perm"])
def test_backend_plan_section_equals_reference(both, key):
    ref, ranks = both
    assert int(ranks[0]["b_n_shards"]) == int(ref["b_n_shards"]) == 8
    np.testing.assert_array_equal(ranks[0]["b_" + key],
                                  ref["b_" + key].astype(
                                      ranks[0]["b_" + key].dtype))


@pytest.mark.parametrize("key,tol", [("b_agg", 1e-4), ("b_acc", 1e-4),
                                     ("b_grad", 1e-3), ("b_grad_v", 1e-3),
                                     ("f_out", 1e-4)])
def test_backend_matches_reference(both, key, tol):
    """DIST_SCRIPT's bars against the reference's ``distributed`` and
    ``dense`` executors."""
    ref, ranks = both
    for name in ("dense", "distributed"):
        np.testing.assert_allclose(ranks[0][key], ref[f"{key}_{name}"],
                                   atol=tol, rtol=0)


def test_every_rank_holds_the_global_result(both):
    _, ranks = both
    assert ranks[0]["transport"] == "gloo"
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(r[k], v, err_msg=k)


def test_backend_without_a_process_group_raises():
    from repro_torch.sparse.plan import make_plan
    with pytest.raises(ValueError, match="process group"):
        make_plan(np.array([0]), np.array([1]), 3,
                  backends=("distributed",), device="cpu")


def test_distributed_has_no_delta_path():
    from repro_torch.sparse.delta import DeltaGraphError, DeltaGraphState
    d = DeltaGraphState(np.array([0, 1]), np.array([1, 2]), 4)
    with pytest.raises(DeltaGraphError):
        d.plan(backends=("dense", "distributed"))
