"""The port's sharded decode on a KV cache whose sequence is split over
mesh axes, against the one-device decode and the reference's, on the CPU.

A world of 4 gloo ranks on a ``(2, 2)`` ``("data", "model")`` mesh runs
``decode_step`` with the sharding config of the dry run (``dp_axes =
("data",)``, ``tp_axis = "model"``) on a 64-position cache placed as a
``DTensor``.  Cases (``CASES``):

* batch 1, long_500k's layout (``lm_input_pspecs`` puts the cache's
  sequence over every axis: 16 positions a rank), for the reduced qwen3
  (GQA, g = 2), gemma (g = 1), grok-1 (4 experts, top-2: the MoE's
  hidden dim split over tp), llama4 (8 experts, top-1, MoE every other
  layer) and llama4 with 16 experts (``dataclasses.replace``, here and in
  the reference: the experts over tp, ``e % 16 == 0``);
* batch 2, decode_32k's layout, for the reduced grok-1: the batch over
  ``"data"``, the sequence over ``"model"`` (32 positions a rank).

Three cache indices: 5 (the ranks past the first hold only masked
positions), 16 (the first position of the second rank's shard) and 63
(the last).  Placements:

* ``replicated``: plain parameters and tokens, so the first layer's new
  k, v rows are computed as on one device;
* ``sharded``: the dry run's parameter placements
  (``sharding.param_pspecs``) and its input placements, so every product
  runs through DTensor;
* ``one_axis`` (batch 1): plain parameters, the cache's sequence over
  ``"model"`` alone and its batch whole (the other layout the
  sequence-sharded decode takes: 32 positions a rank, replicated over
  ``"data"``).

Held for each: the logits ≤1e-5 of the one-device ``decode_step`` and,
where JAX is installed, of the reference's (a subprocess, on the same
seeded parameters and cache through ``convert.lm_params_from_jax``); the
cache, gathered, bitwise the one-device cache at every position but
``cache_index``, and there ≤1e-5 of it.  The written row is bitwise only
where its inputs are: the first layer's with plain parameters.  A later
layer's row comes from a hidden state that passed through an attention
whose partial sums are joined across ranks, in another order than on one
device.

Every rank's results equal rank 0's.  The port's half imports no JAX:
the file runs on a machine without it, where the reference's tests skip.

The port joins the MoE slots (E, C, D) over dp before they flatten for
the combine; the reference's ``moe_mlp``, compiled by GSPMD on 4 host
devices with the dry run's parameter placements, does the same: its HLO
all-gathers C at that reshape (``HLO``).
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import spmd

ROOT = Path(__file__).resolve().parent.parent
# name: (arch, config changes, batch)
CASES = {"qwen3": ("qwen3-0.6b", {}, 1), "gemma": ("gemma-7b", {}, 1),
         "grok": ("grok-1-314b", {}, 1),
         "llama4": ("llama4-maverick-400b-a17b", {}, 1),
         "llama4_e16": ("llama4-maverick-400b-a17b", {"n_experts": 16}, 1),
         "grok_b2": ("grok-1-314b", {}, 2)}
S_MAX = 64
INDICES = (5, 16, 63)
PLACEMENTS = {1: ("replicated", "sharded", "one_axis"),
              2: ("replicated", "sharded")}
RUNS = [(name, ci, how) for name, (_, _, b) in CASES.items()
        for ci in INDICES for how in PLACEMENTS[b]]

REF = r"""
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import registry
from repro.models.lm import transformer as T
inputs = dict(np.load(sys.argv[2]))
out = {}
for name, (arch, changes, _) in json.loads(sys.argv[3]).items():
    cfg = dataclasses.replace(registry.get_config(arch, reduced=True),
                              **changes)
    like = jax.eval_shape(lambda k: T.init_params(k, cfg), jax.random.key(0))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(inputs[f"{name}/p/" + "/".join(
            k.key for k in path)]), like)
    cache = {f"sub{i}": {n: jnp.asarray(inputs[f"{name}/c/sub{i}/{n}"])
                         for n in ("k", "v")}
             for i in range(len(cfg.layer_pattern))}
    step = jax.jit(T.decode_step, static_argnums=1)
    for ci in map(int, sys.argv[4:]):
        logits, _ = step(params, cfg, jnp.asarray(inputs[f"{name}/tokens"]),
                         cache, jnp.int32(ci))
        out[f"{name}/{ci}"] = np.asarray(logits)
np.savez(sys.argv[1], **out)
"""


# the reference's moe_mlp at batch 8 on a (2, 2) mesh, compiled by GSPMD:
# each all-gather's shape, dim and op name
HLO = r"""
import dataclasses, json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.launch import sharding as S
from repro.models.lm import transformer as T
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for name, (arch, changes, _) in json.loads(sys.argv[1]).items():
    cfg = dataclasses.replace(registry.get_config(arch, reduced=True),
                              dp_axes=("data",), tp_axis="model", **changes)
    params = jax.eval_shape(lambda k: T.init_params(k, cfg),
                            jax.random.key(0))
    named = S.to_named(S.param_pspecs(arch, params, mesh), mesh)
    sub = next(k for k in params if k.startswith("sub")
               and "router" in params[k].get("mlp", {}))
    p = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype),
                     params[sub]["mlp"])
    ps = jax.tree.map(lambda n: NamedSharding(mesh, P(*n.spec[1:])),
                      named[sub]["mlp"])
    x = jax.ShapeDtypeStruct((8, 1, cfg.d_model), cfg.adt)
    cap = T.moe_capacity(cfg, 8)
    with jax.set_mesh(mesh):
        hlo = jax.jit(lambda p, x: T.moe_mlp(p, cfg, x, cap), in_shardings=(
            ps, NamedSharding(mesh, P("data", None, None)))).lower(
                p, x).compile().as_text()
    gathers = re.findall(r'= \w+\[([\d,]*)\]\S* all-gather\(.*?dimensions='
                         r'\{(\d+)\}.*?op_name="([^"]*)"', hlo)
    out[name] = dict(e=cfg.n_experts, c=cap, d=cfg.d_model,
                     gathers=[([int(n) for n in s.split(",")], int(dim), op)
                              for s, dim, op in gathers])
print(json.dumps(out))
"""
MOE = {n: CASES[n] for n in ("grok", "llama4_e16")}


def _cfg(name, sharded=False):
    from repro_torch.configs import registry
    arch, changes, _ = CASES[name]
    cfg = dataclasses.replace(registry.get_config(arch, reduced=True),
                              **changes)
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
        batch = CASES[name][2]
        for key, leaf in _paths(T.cache_specs(cfg, batch, S_MAX)):
            out[f"{name}/c/{key}"] = rng.normal(
                size=tuple(leaf.shape)).astype(np.float32)
        out[f"{name}/tokens"] = rng.integers(0, cfg.vocab,
                                             (batch, 1)).astype(np.int32)
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


def _input_pspecs(cache, batch, how, mesh):
    """The dry run's input placements of a batch-1 decode
    (``lm_input_pspecs``: the cache's sequence over every axis), the
    ``one_axis`` cache (its sequence over ``"model"``), or decode_32k's
    layout at batch 2 (the batch over ``"data"``, the sequence over
    ``"model"``: ``lm_input_pspecs``' rule from batch 8)."""
    from repro_torch.configs.shapes import LMShape
    from repro_torch.launch import sharding as S
    if batch == 1 and how != "one_axis":
        return S.lm_input_pspecs(LMShape("long", "decode", S_MAX, 1),
                                 {"cache": cache}, mesh)
    seq = S.PSpec(None, None if batch == 1 else "data", "model", None, None)
    return {"tokens": S.PSpec(None if batch == 1 else "data", None),
            "cache": {sub: {n: seq for n in kv} for sub, kv in cache.items()},
            "cache_index": S.PSpec()}


def port_world(rank, mesh, inputs):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.launch import sharding as S
    from repro_torch.models.lm import transformer as T
    out = {}
    for name, (arch, _, batch) in CASES.items():
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
            for how in PLACEMENTS[batch]:
                cache = _tree(inputs, f"{name}/c/", torch.from_numpy)
                spec = _input_pspecs(cache, batch, how, mesh)
                p, t, c = params, tok, torch.tensor(ci)
                cache = S.distribute(cache, spec["cache"], mesh)
                if how == "sharded":
                    p = S.distribute(params, S.param_pspecs(arch, params,
                                                            mesh), mesh)
                    t = S.distribute(tok, spec["tokens"], mesh)
                    c = S.distribute(c, spec["cache_index"], mesh)
                try:
                    with torch.no_grad(), implicit_replication():
                        logits, cache = T.decode_step(p, shard, t, cache, c)
                    out[f"{name}/{ci}/{how}"] = getattr(
                        logits, "full_tensor", lambda: logits)().numpy()
                    out[f"{name}/{ci}/{how}_cache"] = _flat(cache)
                except Exception as e:  # noqa: BLE001 — this case's failure
                    # (a sharding rule's, the same on every rank)
                    out[f"{name}/{ci}/{how}_error"] = \
                        f"{type(e).__name__}: {e}"[:3000]
    return out


def _got(ranks, key):
    """Rank 0's result ``key``, after a check that its case ran."""
    assert f"{key}_error" not in ranks[0], ranks[0][f"{key}_error"]
    return ranks[0][key]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("seqshard")
    return d, _inputs(d / "inputs.npz")


@pytest.fixture(scope="module")
def ref_proc(inputs):
    """The reference's subprocess, started before the port's world so the
    two run side by side; ``None`` where JAX is not installed."""
    d, _ = inputs
    if importlib.util.find_spec("jax") is None:
        yield None
        return
    proc = subprocess.Popen(
        [sys.executable, "-c", REF, str(d / "ref.npz"),
         str(d / "inputs.npz"), json.dumps(CASES), *map(str, INDICES)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.path.expanduser("~"), "JAX_PLATFORMS": "cpu"})
    try:
        yield proc
    finally:
        proc.kill()


@pytest.fixture(scope="module")
def ranks(inputs, ref_proc):
    return spmd.spawn(port_world, 4, mesh_shape=(2, 2),
                      mesh_names=("data", "model"), args=(inputs[1],))


@pytest.fixture(scope="module")
def ref(inputs, ref_proc):
    pytest.importorskip("jax")
    _, err = ref_proc.communicate(timeout=600)
    assert ref_proc.returncode == 0, err[-3000:]
    with np.load(inputs[0] / "ref.npz") as z:
        return dict(z)


@pytest.mark.parametrize("name,ci,how", RUNS)
def test_seq_sharded_decode_logits(ranks, name, ci, how):
    got = _got(ranks, f"{name}/{ci}/{how}")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ranks[0][f"{name}/{ci}/one"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("name,ci,how", RUNS)
def test_seq_sharded_decode_logits_match_reference(ranks, ref, name, ci,
                                                   how):
    np.testing.assert_allclose(_got(ranks, f"{name}/{ci}/{how}"),
                               ref[f"{name}/{ci}"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,ci,how", RUNS)
def test_seq_sharded_decode_cache(ranks, name, ci, how):
    _got(ranks, f"{name}/{ci}/{how}")
    got = ranks[0][f"{name}/{ci}/{how}_cache"]
    want = ranks[0][f"{name}/{ci}/one_cache"]
    assert got.keys() == want.keys()
    for k in want:
        # (n_super, B, S_max, KV, hd): every position but the written one
        # bitwise, on every rank's shard
        assert np.array_equal(np.delete(got[k], ci, axis=2),
                              np.delete(want[k], ci, axis=2)), k
        np.testing.assert_allclose(got[k][:, :, ci], want[k][:, :, ci],
                                   rtol=0, atol=1e-5)
        if how != "sharded" and k.startswith("sub0/"):
            # the first layer's k, v rows come from the same products (a
            # later sub-layer of the first super-layer is a later layer)
            assert np.array_equal(got[k][0, :, ci], want[k][0, :, ci]), k


def test_every_rank_agrees(ranks):
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if isinstance(v, dict):
                for kk in v:
                    assert np.array_equal(r[k][kk], v[kk]), (k, kk)
            else:
                assert np.array_equal(r[k], v), k


@pytest.fixture(scope="module")
def ref_hlo():
    pytest.importorskip("jax")
    res = subprocess.run(
        [sys.executable, "-c", HLO, json.dumps(MOE)], capture_output=True,
        text=True, timeout=600,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.path.expanduser("~"), "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", MOE)
def test_reference_gathers_moe_slots_before_the_combine(ref_hlo, name):
    """GSPMD joins the slots' C over dp where they flatten into (E·C, D)
    (grok: the experts whole; llama4 with 16 experts: over tp, 2 a
    rank), as the port's ``moe_mlp`` does on DTensors."""
    h = ref_hlo[name]
    e_loc = h["e"] // 2 if h["e"] % 16 == 0 else h["e"]
    assert [[e_loc, h["c"], h["d"]], 1] in [
        [shape, dim] for shape, dim, op in h["gathers"]
        if op.endswith("/reshape")], h
