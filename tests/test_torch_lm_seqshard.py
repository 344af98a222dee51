"""The port's batch-1 decode on a KV cache whose sequence is split over
several mesh axes (long_500k's layout: ``lm_input_pspecs`` puts the
cache's sequence over every axis), against the one-device decode and the
reference's, on the CPU.

A world of 4 gloo ranks on a ``(2, 2)`` ``("data", "model")`` mesh runs
``decode_step`` of the reduced qwen3 (GQA, g = 2) and the reduced gemma
(g = 1) with the sharding config of the dry run (``dp_axes = ("data",)``,
``tp_axis = "model"``) on a 64-position cache placed as a ``DTensor``
with its sequence over ``("data", "model")``: 16 positions a rank.  Three
cache indices: 5 (the ranks past the first hold only masked positions),
16 (the first position of the second rank's shard) and 63 (the last).
Three placements:

* ``replicated``: plain tensors, so the first layer's new k, v rows are
  computed as on one device;
* ``sharded``: the dry run's parameter placements
  (``sharding.param_pspecs``) and its input placements, so every product
  runs through DTensor;
* ``one_axis``: plain parameters, the cache's sequence over ``"model"``
  alone and its batch whole (the other layout the sequence-sharded decode
  takes: 32 positions a rank, replicated over ``"data"``).

Held for each: the logits ≤1e-5 of the one-device ``decode_step`` and of
the reference's (a subprocess, on the same seeded parameters and cache
through ``convert.lm_params_from_jax``); the cache, gathered, bitwise the
one-device cache at every position but ``cache_index``, and there ≤1e-5
of it.  The written row is bitwise only where its inputs are: the first
layer's with plain parameters.  A later layer's row comes from a hidden
state that passed through an attention whose partial sums are joined
across ranks, in another order than on one device.

Every rank's results equal rank 0's.
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
CASES = {"qwen3": "qwen3-0.6b", "gemma": "gemma-7b"}
S_MAX = 64
INDICES = (5, 16, 63)
PLACEMENTS = ("replicated", "sharded", "one_axis")

REF = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import registry
from repro.models.lm import transformer as T
CASES = {"qwen3": "qwen3-0.6b", "gemma": "gemma-7b"}
inputs = dict(np.load(sys.argv[2]))
out = {}
for name, arch in CASES.items():
    cfg = registry.get_config(arch, reduced=True)
    like = jax.eval_shape(lambda k: T.init_params(k, cfg), jax.random.key(0))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(inputs[f"{name}/p/" + "/".join(
            k.key for k in path)]), like)
    cache = {f"sub{i}": {n: jnp.asarray(inputs[f"{name}/c/sub{i}/{n}"])
                         for n in ("k", "v")}
             for i in range(len(cfg.layer_pattern))}
    step = jax.jit(T.decode_step, static_argnums=1)
    for ci in map(int, sys.argv[3:]):
        logits, _ = step(params, cfg, jnp.asarray(inputs[f"{name}/tokens"]),
                         cache, jnp.int32(ci))
        out[f"{name}/{ci}"] = np.asarray(logits)
np.savez(sys.argv[1], **out)
"""


def _cfg(name, sharded=False):
    from repro_torch.configs import registry
    cfg = registry.get_config(CASES[name], reduced=True)
    if sharded:
        cfg = dataclasses.replace(cfg, dp_axes=("data",), tp_axis="model")
    return cfg


def _inputs(path) -> dict:
    """Seeded parameters (the initializer's scales), a token and a filled
    cache for both sides, saved to ``path``."""
    from repro_torch.models.lm import transformer as T
    rng = np.random.default_rng(0)
    out = {}
    for name in CASES:
        cfg = _cfg(name)
        specs = T.param_specs(cfg)
        for key, leaf in _paths(specs):
            shape = tuple(leaf.shape)
            if key.endswith(("norm", "ln1", "ln2")):
                a = 1.0 + 0.1 * rng.normal(size=shape)
            else:
                scale = 0.02 if key == "embed" else shape[-2] ** -0.5
                a = scale * rng.normal(size=shape)
            out[f"{name}/p/{key}"] = a.astype(np.float32)
        for key, leaf in _paths(T.cache_specs(cfg, 1, S_MAX)):
            out[f"{name}/c/{key}"] = rng.normal(
                size=tuple(leaf.shape)).astype(np.float32)
        out[f"{name}/tokens"] = rng.integers(0, cfg.vocab, (1, 1)).astype(
            np.int32)
    np.savez(path, **out)
    return out


def _paths(node, pre=()):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _paths(v, pre + (k,))
        else:
            yield "/".join(pre + (k,)), v


def _tree(flat, pre, leaf=np.asarray):
    """The ``pre``-prefixed entries of ``flat`` as a nested dict."""
    out = {}
    for k, v in flat.items():
        if k.startswith(pre):
            node = out
            *head, last = k[len(pre):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = leaf(np.array(v))
    return out


def _flat(cache) -> dict:
    return {k: getattr(v, "full_tensor", lambda v=v: v)().numpy()
            for k, v in _paths(cache)}


def port_world(rank, mesh, inputs):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.shapes import LMShape
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.launch import sharding as S
    from repro_torch.models.lm import transformer as T
    shape = LMShape("long", "decode", S_MAX, 1)
    out = {}
    for name, arch in CASES.items():
        cfg, shard = _cfg(name), _cfg(name, sharded=True)
        params = lm_params_from_jax(_tree(inputs, f"{name}/p/"), "cpu")
        tok = torch.from_numpy(inputs[f"{name}/tokens"])
        for ci in INDICES:
            with torch.no_grad():
                one, cache = T.decode_step(
                    params, cfg, tok,
                    _tree(inputs, f"{name}/c/", torch.from_numpy), ci)
            out[f"{name}/{ci}/one"] = one.numpy()
            out[f"{name}/{ci}/one_cache"] = _flat(cache)
            for how in PLACEMENTS:
                cache = _tree(inputs, f"{name}/c/", torch.from_numpy)
                spec = S.lm_input_pspecs(shape, {"cache": cache}, mesh)
                p, t, c = params, tok, torch.tensor(ci)
                if how == "one_axis":
                    spec["cache"] = {sub: {n: S.PSpec(None, None, "model",
                                                      None, None)
                                           for n in kv}
                                     for sub, kv in cache.items()}
                cache = S.distribute(cache, spec["cache"], mesh)
                if how == "sharded":
                    p = S.distribute(params, S.param_pspecs(arch, params,
                                                            mesh), mesh)
                    t = S.distribute(tok, spec["tokens"], mesh)
                    c = S.distribute(c, spec["cache_index"], mesh)
                with torch.no_grad(), implicit_replication():
                    logits, cache = T.decode_step(p, shard, t, cache, c)
                out[f"{name}/{ci}/{how}"] = getattr(
                    logits, "full_tensor", lambda: logits)().numpy()
                out[f"{name}/{ci}/{how}_cache"] = _flat(cache)
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's subprocess and the port's world run side by side on
    the same inputs."""
    d = tmp_path_factory.mktemp("ref")
    inputs = _inputs(d / "inputs.npz")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF, str(d / "ref.npz"),
         str(d / "inputs.npz"), *map(str, INDICES)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.path.expanduser("~"), "JAX_PLATFORMS": "cpu"})
    try:
        ranks = spmd.spawn(port_world, 4, mesh_shape=(2, 2),
                           mesh_names=("data", "model"), args=(inputs,))
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    with np.load(d / "ref.npz") as z:
        ref = dict(z)
    return ref, ranks


@pytest.mark.parametrize("how", PLACEMENTS)
@pytest.mark.parametrize("ci", INDICES)
@pytest.mark.parametrize("name", CASES)
def test_seq_sharded_decode_logits(both, name, ci, how):
    ref, ranks = both
    got = ranks[0][f"{name}/{ci}/{how}"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ranks[0][f"{name}/{ci}/one"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got, ref[f"{name}/{ci}"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("how", PLACEMENTS)
@pytest.mark.parametrize("ci", INDICES)
@pytest.mark.parametrize("name", CASES)
def test_seq_sharded_decode_cache(both, name, ci, how):
    _, ranks = both
    got = ranks[0][f"{name}/{ci}/{how}_cache"]
    want = ranks[0][f"{name}/{ci}/one_cache"]
    assert got.keys() == want.keys()
    for k in want:
        # (n_super, 1, S_max, KV, hd): every position but the written one
        # bitwise, on every rank's shard
        assert np.array_equal(np.delete(got[k], ci, axis=2),
                              np.delete(want[k], ci, axis=2)), k
        np.testing.assert_allclose(got[k][:, :, ci], want[k][:, :, ci],
                                   rtol=0, atol=1e-5)
        if how != "sharded":
            # the first layer's k, v rows come from the same products
            assert np.array_equal(got[k][0, :, ci], want[k][0, :, ci]), k


def test_every_rank_agrees(both):
    _, ranks = both
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if isinstance(v, dict):
                for kk in v:
                    assert np.array_equal(r[k][kk], v[kk]), (k, kk)
            else:
                assert np.array_equal(r[k], v), k
