"""The LM's sharding constraints (``_psc`` under ``cfg.dp_axes``/
``cfg.tp_axis``) and ``moe_mlp_sharded`` in the port against the
reference's, on the CPU.

One subprocess runs the reference on an ``Auto`` ``(4, 2)`` ``("data",
"model")`` mesh of 8 emulated XLA devices (jax 0.9.0's default
``Explicit`` axes turn its constraints into assertions, ROADMAP C4): for
the reduced qwen3 (dense), grok (4 experts: expert-parallel over the 2
tp ranks), grok with 3 experts (the hidden-sharded ``psum`` path) and
llama4 (every other layer MoE), the forward and loss with ``dp_axes =
("data",)``, ``tp_axis = "model"`` under ``use_mesh``, the same without
them (one device), and ``moe_mlp_sharded`` on its own with the gradient
of Σy² in x.  One world of 8 gloo ranks on the same mesh runs the port on
the same parameters (seeded numpy at the initializer's scales, through
``convert.lm_params_from_jax``), global-view tensors under
``core.distributed.use_mesh``; the two run side by side.  Held: the
sharded forward and ``moe_mlp_sharded`` ≤1e-4 of the reference's, the loss
≤1e-5 relative, x's gradient ≤1e-3; the dense model's sharded forward
equal to its one-device forward ≤1e-5 (a constraint moves no value); and
every rank equal to rank 0.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import spmd

ROOT = Path(__file__).resolve().parent.parent
CASES = ["qwen3", "grok", "grok3", "llama4"]

REF = r"""
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import registry
from repro.core.compat import use_mesh
from repro.models.lm import transformer as T
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
CASES = {"qwen3": ("qwen3-0.6b", {}), "grok": ("grok-1-314b", {}),
         "grok3": ("grok-1-314b", {"n_experts": 3}),
         "llama4": ("llama4-maverick-400b-a17b", {})}
out = {}
inputs = dict(np.load(sys.argv[2]))
for name, (arch, changes) in CASES.items():
    cfg = dataclasses.replace(registry.get_config(arch, reduced=True),
                              **changes)
    shard = dataclasses.replace(cfg, dp_axes=("data",), tp_axis="model")
    # the test's parameters, in init_params' tree
    like = jax.eval_shape(lambda k: T.init_params(k, cfg), jax.random.key(0))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(inputs[f"{name}/p/" + "/".join(
            k.key for k in path)]), like)
    t = jnp.asarray(inputs[f"{name}/tokens"])
    out[f"{name}/one"] = np.asarray(jax.jit(
        lambda p, t: T.forward(p, cfg, t))(params, t))
    with use_mesh(mesh):
        out[f"{name}/sharded"] = np.asarray(jax.jit(
            lambda p, t: T.forward(p, shard, t))(params, t))
        out[f"{name}/loss"] = np.float32(jax.jit(
            lambda p, t: T.loss_fn(p, shard, t))(params, t))
    if cfg.n_experts:
        mlp = params["sub%d" % (len(cfg.layer_pattern) - 1)]["mlp"]
        mlp = jax.tree.map(lambda a: a[0], mlp)
        x = inputs[f"{name}/moe_x"]
        cap = T.moe_capacity(cfg, 64)
        f = jax.jit(lambda xx: T.moe_mlp_sharded(mlp, shard, xx, cap))
        with use_mesh(mesh):
            out[f"{name}/moe_y"] = np.asarray(f(jnp.asarray(x)))
            out[f"{name}/moe_g"] = np.asarray(jax.grad(
                lambda xx: jnp.sum(f(xx) ** 2))(jnp.asarray(x)))
np.savez(sys.argv[1], **out)
"""


def _inputs(path) -> dict:
    """Seeded parameters (the initializer's scales: N(0, 1/fan_in)
    projections, unit norms, 0.02 embeddings), tokens and MoE inputs for
    both sides, saved to ``path``."""
    from repro_torch.models.lm import transformer as T

    def paths(node, pre=()):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from paths(v, pre + (k,))
            else:
                yield pre + (k,), v
    rng = np.random.default_rng(0)
    out = {}
    for name in CASES:
        cfg = _cfgs(name)
        for key, leaf in paths(T.param_specs(cfg)):
            shape = tuple(leaf.shape)
            k = "/".join(key)
            if k.endswith("norm") or k.endswith(("ln1", "ln2")):
                a = 1.0 + 0.1 * rng.normal(size=shape)
            else:
                fan = shape[-2] if len(shape) >= 2 else shape[-1]
                scale = 0.02 if k in ("embed", "unembed") else fan ** -0.5
                a = scale * rng.normal(size=shape)
            out[f"{name}/p/{k}"] = a.astype(np.float32)
        out[f"{name}/tokens"] = rng.integers(0, cfg.vocab, (4, 16)).astype(
            np.int32)
        out[f"{name}/moe_x"] = rng.normal(size=(4, 16, cfg.d_model)).astype(
            np.float32)
    np.savez(path, **out)
    return out


def _tree(ref, pre):
    tree = {}
    for k, v in ref.items():
        if k.startswith(pre):
            node = tree
            *head, last = k[len(pre):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    return tree


def _cfgs(name, dp=False):
    from repro_torch.configs import registry
    arch, changes = {"qwen3": ("qwen3-0.6b", {}),
                     "grok": ("grok-1-314b", {}),
                     "grok3": ("grok-1-314b", {"n_experts": 3}),
                     "llama4": ("llama4-maverick-400b-a17b", {})}[name]
    cfg = dataclasses.replace(registry.get_config(arch, reduced=True),
                              **changes)
    if dp:
        cfg = dataclasses.replace(cfg, dp_axes=("data",), tp_axis="model")
    return cfg


def port_world(rank, mesh, ref):
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.core import distributed as D
    from repro_torch.models.lm import transformer as T
    out = {}
    for name in CASES:
        cfg, shard = _cfgs(name), _cfgs(name, dp=True)
        params = lm_params_from_jax(_tree(ref, f"{name}/p/"), "cpu")
        toks = torch.from_numpy(ref[f"{name}/tokens"])
        with torch.no_grad():
            out[f"{name}/one"] = T.forward(params, cfg, toks).numpy()
            with D.use_mesh(mesh):
                out[f"{name}/sharded"] = T.forward(params, shard,
                                                   toks).numpy()
                out[f"{name}/loss"] = float(T.loss_fn(params, shard, toks))
        if cfg.n_experts:
            sub = params["sub%d" % (len(cfg.layer_pattern) - 1)]["mlp"]
            mlp = {k: v[0] for k, v in sub.items()}
            x = torch.from_numpy(ref[f"{name}/moe_x"]).requires_grad_()
            with D.use_mesh(mesh):
                y = T.moe_mlp_sharded(mlp, shard, x,
                                      T.moe_capacity(cfg, 64))
                (y ** 2).sum().backward()
            out[f"{name}/moe_y"] = y.detach().numpy()
            out[f"{name}/moe_g"] = x.grad.numpy()
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's subprocess and the port's world run side by side on
    the same inputs."""
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
        ref = dict(z)
    return ref, ranks


@pytest.mark.parametrize("name", CASES)
def test_dp_axes_forward_matches_reference(both, name):
    ref, ranks = both
    got = ranks[0]
    np.testing.assert_allclose(got[f"{name}/sharded"], ref[f"{name}/sharded"],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[f"{name}/one"], ref[f"{name}/one"],
                               atol=1e-4, rtol=0)
    assert abs(got[f"{name}/loss"] - float(ref[f"{name}/loss"])) <= \
        1e-5 * abs(float(ref[f"{name}/loss"]))


def test_dense_constraints_move_no_value(both):
    _, ranks = both
    np.testing.assert_allclose(ranks[0]["qwen3/sharded"],
                               ranks[0]["qwen3/one"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["grok", "grok3", "llama4"])
def test_moe_mlp_sharded_matches_reference(both, name):
    ref, ranks = both
    got = ranks[0]
    np.testing.assert_allclose(got[f"{name}/moe_y"], ref[f"{name}/moe_y"],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[f"{name}/moe_g"], ref[f"{name}/moe_g"],
                               atol=1e-3, rtol=0)


def test_every_rank_holds_the_global_result(both):
    _, ranks = both
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(np.asarray(r[k]), np.asarray(v),
                                          err_msg=k)


def test_moe_mlp_sharded_needs_a_mesh():
    from repro_torch.models.lm import transformer as T
    cfg = _cfgs("grok", dp=True)
    with pytest.raises(ValueError, match="mesh"):
        T.moe_mlp_sharded({}, cfg, torch.zeros((1, 4, cfg.d_model)), 8)
