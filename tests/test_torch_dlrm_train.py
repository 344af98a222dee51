"""DLRM training in the port against ``repro`` on the same numpy inputs, on
the CPU (B6's plain version):

* the trainable lookup (``kernels/embedding_bag/ops.lookup``): its table
  gradient against ``jax.grad`` of the reference's ``loss_fn``, repeated
  ids added in order, wrapped negative ids, dropped out-of-range ids, and
  the serving path left without the Function;
* ``build_recsys_step("train")`` one step against the reference's, and ten
  steps of the launcher's setup against the reference launcher's loop
  (``TRAJ_TOL``);
* ``launch/train --arch dlrm-rm2 --device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_rm2 as ref_cfgs
from repro.configs.shapes import RECSYS_SHAPES as REF_SHAPES
from repro.launch import steps as ref_steps
from repro.models.recsys import dlrm as ref_dlrm
from repro.optim import adamw as ref_adamw
from repro_torch import tree
from repro_torch.configs import dlrm_rm2
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.convert import dlrm_params_from_jax
from repro_torch.data.synthetic import dlrm_batch
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag import ops
from repro_torch.launch.steps import build_recsys_step
from repro_torch.models.recsys import dlrm
from repro_torch.optim import adamw

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TRAJ_TOL = 1e-4


def _cut(cfg, cap=1000):
    return dataclasses.replace(cfg, vocab_sizes=tuple(
        min(v, cap) for v in cfg.vocab_sizes))


CASES = {"reduced": (ref_cfgs.reduced(), dlrm_rm2.reduced()),
         "rm2_widths": (_cut(ref_cfgs.FULL), _cut(dlrm_rm2.FULL))}


def _batch(cfg, b, seed=3, multi_hot=1):
    d, ids, y = dlrm_batch(b, cfg.n_dense, cfg.vocab_sizes,
                           multi_hot=multi_hot, seed=seed)
    return d, ids, y


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_gradients_match_reference(case):
    """Every parameter's gradient (the whole table's among them) against
    ``jax.grad`` of the reference's ``loss_fn`` on its parameters."""
    ref_cfg, cfg = CASES[case]
    params = ref_dlrm.init_params(jax.random.key(0), ref_cfg)
    d, ids, y = _batch(cfg, 64, multi_hot=2)
    loss_j, grads_j = jax.value_and_grad(ref_dlrm.loss_fn)(
        params, ref_cfg, jnp.asarray(d), jnp.asarray(ids), jnp.asarray(y))
    tparams = dlrm_params_from_jax(jax.tree.map(np.asarray, params),
                                   device="cpu")
    leaves, structure = tree.flatten(tparams)
    live = [t.requires_grad_() for t in leaves]
    loss_t = dlrm.loss_fn(tree.unflatten(structure, live), cfg,
                          torch.from_numpy(d), torch.from_numpy(ids),
                          torch.from_numpy(y))
    grads_t = torch.autograd.grad(loss_t, live)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=GRAD_RTOL)
    for gj, gt in zip(jax.tree.leaves(grads_j), grads_t):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_table_grad_adds_repeated_ids_in_order():
    """Repeated ids add their bags' cotangents in id order (the sequential
    scatter's bits); negative ids wrap; ids outside [-V, V) get none."""
    v, d = 6, 3
    ids = torch.tensor([[[2, 2]], [[5, -1]], [[2, 9]], [[-7, 0]]],
                       dtype=torch.int32)                 # (4, 1, 2)
    g = torch.tensor([[[1e8, 1.0, 2.0]], [[3.0, 4.0, 5.0]],
                      [[-1e8, 6.0, 7.0]], [[8.0, 9.0, 10.0]]])
    got = ops.table_grad(ids, g, v)
    want = torch.zeros(v, d)
    for b in range(4):
        for m in range(2):
            i = int(ids[b, 0, m])
            i = i + v if i < 0 else i
            if 0 <= i < v:
                want[i] += g[b, 0]
    assert torch.equal(got, want)
    assert float(got[2, 0]) == 1e8 and float(got[5, 1]) == 4.0 + 4.0


def test_lookup_function_only_when_trained():
    """Serving (no gradient asked for) calls B6 directly; a table that
    needs a gradient goes through the Function, whose forward is B6."""
    table = torch.randn(40, 8, generator=torch.Generator().manual_seed(0))
    ids = torch.randint(-40, 40, (8, 3, 2), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))
    plain = ops.lookup(ids, table)
    assert plain.grad_fn is None
    with torch.no_grad():
        assert torch.equal(ops.lookup(ids, table.requires_grad_()), plain)
    out = ops.lookup(ids, table)
    assert "LookupGrad" in type(out.grad_fn.next_functions[0][0]).__name__
    assert torch.equal(out.detach(), plain)
    (gt,) = torch.autograd.grad(out.sum(), table)
    assert torch.equal(gt, ops.table_grad(ids, torch.ones(8, 3, 8), 40))
    before = embedding_bag.launches
    ops.lookup(ids, table)
    assert embedding_bag.launches == before    # plain versions do not count


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_reference(case):
    """One step of ``build_recsys_step("train")``: loss, gradient norm and
    every updated parameter against the reference's step."""
    ref_cfg, cfg = CASES[case]
    params = ref_dlrm.init_params(jax.random.key(1), ref_cfg)
    d, ids, y = _batch(cfg, 32)
    opt = ref_adamw.AdamWConfig(lr=1e-3)
    jstep = ref_steps.build_recsys_step(ref_cfg, REF_SHAPES["train_batch"],
                                        opt)
    jp, _, jm = jax.jit(jstep)(params, ref_adamw.init_state(params),
                               {"dense": jnp.asarray(d),
                                "sparse_ids": jnp.asarray(ids),
                                "labels": jnp.asarray(y)})
    tparams = dlrm_params_from_jax(jax.tree.map(np.asarray, params),
                                   device="cpu")
    tstep = build_recsys_step(cfg, RECSYS_SHAPES["train_batch"],
                              adamw.AdamWConfig(lr=1e-3))
    tp, ts, tm = tstep(tparams, adamw.init_state(tparams),
                       {"dense": torch.from_numpy(d),
                        "sparse_ids": torch.from_numpy(ids),
                        "labels": torch.from_numpy(y)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TRAJ_TOL
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= TRAJ_TOL
    assert int(ts.step) == 1
    for a, b in zip(jax.tree.leaves(jp), tree.leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=TRAJ_TOL)


def test_launcher_trajectory_matches_reference():
    """Ten steps of the launcher's dlrm-rm2 setup (reduced config, batch 8,
    AdamW lr 1e-3, ``dlrm_batch(seed=i)``) on the reference's parameters
    against the reference launcher's step on the same batches."""
    from repro.data import synthetic as ref_syn
    from repro_torch.launch import train as ttrain
    ref_cfg = ref_cfgs.reduced()
    jparams = ref_dlrm.init_params(jax.random.key(0), ref_cfg)
    jstep = jax.jit(ref_steps.build_recsys_step(
        ref_cfg, REF_SHAPES["train_batch"], ref_adamw.AdamWConfig(lr=1e-3)))
    _, tstep, tb = ttrain._recsys_setup("dlrm-rm2", 0, 8, device="cpu")
    tparams = dlrm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    js, ts = ref_adamw.init_state(jparams), adamw.init_state(tparams)
    for i in range(10):
        d, ids, y = ref_syn.dlrm_batch(8, ref_cfg.n_dense,
                                       ref_cfg.vocab_sizes, seed=i)
        jparams, js, jm = jstep(jparams, js, {
            "dense": jnp.asarray(d), "sparse_ids": jnp.asarray(ids),
            "labels": jnp.asarray(y)})
        batch = next(tb)
        assert np.array_equal(batch["sparse_ids"].numpy(), ids)
        tparams, ts, tm = tstep(tparams, ts, batch)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TRAJ_TOL, i
    for a, b in zip(jax.tree.leaves(jparams), tree.leaves(tparams)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=TRAJ_TOL)


def test_train_cli_dlrm(tmp_path, capsys):
    from repro_torch.checkpoint import store
    from repro_torch.launch import train as ttrain
    argv = ["--arch", "dlrm-rm2", "--batch", "16", "--steps", "4",
            "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    assert ttrain.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[train] 4 steps in") and "retries=0" in line
    assert store.committed_steps(tmp_path) == [2, 4]
