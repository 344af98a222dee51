"""GCN training in the port against the JAX reference, on the CPU (the
kernels' plain versions):

* the ``cuda``/``cuda_q8`` autograd Functions against autograd through the
  ``dense`` executor, and gcn's gradients against the reference's
  ``pallas``/``pallas_q8`` custom VJPs (Pallas in interpret mode, ≤ 250
  edges);
* ``adamw.apply_updates`` against the reference's on the same trees;
* ``checkpoint.store``: the reference's store cases, and steps written by
  one package restored by the other;
* ``train.loop.run``: resume, rollback, abort, stragglers;
* ten steps of ``launch.train``'s gcn-cora setup against
  ``repro.launch.train``'s (the reference's parameters carried across),
  per executor and over Â².
"""
import inspect
import json
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.optim import adamw as jadamw
from repro.sparse import backend as jsb
from repro.sparse import plan as jplan
from repro_torch import convert
from repro_torch import tree
from repro_torch.checkpoint import store
from repro_torch.optim import adamw
from repro_torch.sparse import backend as tsb
from repro_torch.sparse import plan as tplan
from repro_torch.sparse import quantize as tq
from repro_torch.train import loop as train_loop

CPU = "cpu"
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5      # Function vs autograd / reference
ADAMW_TOL = 1e-6                        # optimizer arithmetic vs reference
TRAJ_TOL = 1e-4                         # loss per step vs the reference


def _graph(n=40, e=250, seed=9, n_invalid=30, hub=True):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    if hub:                       # a hub row split across chunks
        r[: e // 3] = 3
    s[:3], r[:3] = 5, 9           # duplicate edges share a cell
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    valid = np.ones(e, bool)
    valid[rng.choice(e, n_invalid, replace=False)] = False
    return s, r, w, valid, rng


def _tplan(s, r, n, **kw):
    return tplan.make_plan(s, r, n, backends=("dense", "chunked", "cuda",
                                              "cuda_q8"), device=CPU,
                           width_cap=16, **kw)


def _grads(plan, vals, x, backend, loss):
    v = vals.clone().requires_grad_()
    xx = x.clone().requires_grad_()
    y = tsb.aggregate(plan, v, xx, backend=backend)
    gv, gx = torch.autograd.grad(loss(y), (v, xx))
    return y.detach(), gv, gx


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ("cuda", "cuda_q8"))
def test_function_matches_dense_autograd(backend):
    """Gradients for BOTH ``vals`` and ``x`` equal autograd through
    ``dense``; the backward runs B1, not a segment reduction.  The int8
    forward differs from f32, so its straight-through gradient is held to
    dense on a loss linear in y (the cotangent does not see the forward)."""
    from repro_torch.kernels.gustavson_spmm import ops
    n, d = 40, 12
    s, r, w, valid, rng = _graph(n)
    plan = _tplan(s, r, n, edge_valid=valid)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    vals = torch.from_numpy(w)
    c = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    if backend == "cuda":
        def loss(y):
            return (y ** 2).mean() + y[:, 0].sum()
    else:
        def loss(y):
            return (y * c).sum()
    _, gv_d, gx_d = _grads(plan, vals, x, "dense", loss)
    _, gv, gx = _grads(plan, vals, x, backend, loss)
    np.testing.assert_allclose(gv.numpy(), gv_d.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(gx.numpy(), gx_d.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    assert (gv.numpy()[~valid] == 0).all()       # padding edges: no grad
    src = inspect.getsource(ops._backward)
    for banned in ("index_add", "segment", "scatter", "torch.sparse"):
        assert banned not in src, banned
    assert "spmm_dedup_chunks(" in src


def test_function_backward_pieces():
    """dX is B1 on the transpose layout cut to x's rows; dA has the tile
    shape with zero dead lanes; ``a_t`` and the layout get no gradient,
    and x is saved only when dA is wanted."""
    from repro_torch.kernels.gustavson_spmm import spmm_dedup_chunks
    from repro_torch.kernels.gustavson_spmm.ops import spmm_dedup_grad
    n, d = 40, 6
    s, r, w, valid, rng = _graph(n)
    p = _tplan(s, r, n, edge_weight=w, edge_valid=valid)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    a = p.ell_a.clone().requires_grad_()
    a_t = p.ell_t_a.clone().requires_grad_()
    xx = x.clone().requires_grad_()
    y = spmm_dedup_grad(p.ell_u_cols, p.ell_remaining, p.ell_block_ptr,
                        p.ell_out_block, a, p.ell_t_u_cols,
                        p.ell_t_remaining, p.ell_t_block_ptr, a_t, xx,
                        block_rows=p.block_rows)
    dy = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(
        np.float32))
    da, dx, da_t = torch.autograd.grad(y, (a, xx, a_t), dy,
                                       allow_unused=True)
    assert da_t is None
    want_dx = spmm_dedup_chunks(p.ell_t_u_cols, p.ell_t_remaining,
                                p.ell_t_block_ptr, p.ell_t_a, dy,
                                block_rows=p.block_rows)[:n]
    assert torch.equal(dx, want_dx)
    assert da.shape == p.ell_a.shape
    width = p.ell_u_cols.shape[1]
    dead = (torch.arange(width)[None, :]
            >= p.ell_remaining[:, None].long())
    dead = dead.repeat_interleave(p.block_rows, 0)
    assert (da[dead] == 0).all() and (da[~dead] != 0).any()
    # no dA wanted: nothing but the transpose layout is kept
    y2 = spmm_dedup_grad(p.ell_u_cols, p.ell_remaining, p.ell_block_ptr,
                         p.ell_out_block, p.ell_a, p.ell_t_u_cols,
                         p.ell_t_remaining, p.ell_t_block_ptr, p.ell_t_a,
                         xx, block_rows=p.block_rows)
    assert y2.grad_fn.saved_tensors == ()
    assert torch.equal(torch.autograd.grad(y2, xx, dy)[0], want_dx)


@pytest.mark.parametrize("backend", ("cuda", "cuda_q8"))
def test_function_skipped_without_gradients(backend, monkeypatch):
    """Where nothing asks for a gradient (``no_grad``, or inputs that need
    none) the executors launch their kernel without ``Function.apply``:
    the same values, no autograd node, and the transpose tiles not built."""
    from repro_torch.kernels.gustavson_spmm import ops
    n, d = 40, 8
    s, r, w, valid, rng = _graph(n)
    p = _tplan(s, r, n, edge_weight=w, edge_valid=valid)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    xx = x.clone().requires_grad_()
    with_grad = tsb.aggregate(p, None, xx, backend=backend)
    assert with_grad.grad_fn is not None

    def refuse(*_):
        raise AssertionError("Function.apply or transpose tiles on a path "
                             "that needs no gradient")
    for fn in (ops._SpmmDedup, ops._SpmmDedupQ8):
        monkeypatch.setattr(fn, "apply", refuse)
    monkeypatch.setattr(tsb, "transpose_tiles", refuse)
    plain = tsb.aggregate(p, None, x, backend=backend)
    with torch.no_grad():
        no_grad = tsb.aggregate(p, torch.from_numpy(w).requires_grad_(),
                                xx, backend=backend)
    for y in (plain, no_grad):
        assert y.grad_fn is None and torch.equal(y, with_grad.detach())


def test_gradient_through_revalued_plan():
    """``plan_with_values`` drops ``ell_t_a``; a backward through that plan
    re-values the transpose tiles from ``ell_t_slots`` (never stale)."""
    n, d = 40, 8
    s, r, w, _, rng = _graph(n, n_invalid=0)
    base = _tplan(s, r, n)
    v2 = rng.random(s.shape[0]) > 0.3
    pv = tplan.plan_with_values(base, torch.from_numpy(w),
                                torch.from_numpy(v2))
    assert pv.ell_t_a is None
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    grads = {}
    for backend in ("dense", "cuda", "cuda_q8"):
        xx = x.clone().requires_grad_()
        y = tsb.aggregate(pv, None, xx, backend=backend)
        grads[backend] = torch.autograd.grad(y.sum(), xx)[0]
    for backend in ("cuda", "cuda_q8"):
        np.testing.assert_allclose(grads[backend].numpy(),
                                   grads["dense"].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    jp = jplan.plan_with_values(
        jplan.make_plan(s, r, n, backends=("dense", "pallas"), width_cap=16),
        jnp.asarray(w), jnp.asarray(v2))
    np.testing.assert_allclose(tplan.transpose_tiles(pv).numpy(),
                               np.asarray(jp.ell_t_a), rtol=0, atol=1e-6)


def test_transpose_block_ptr():
    s, r, w, valid, _ = _graph()
    p = _tplan(s, r, 40, edge_weight=w, edge_valid=valid)
    jp = jplan.make_plan(s, r, 40, edge_weight=w, edge_valid=valid,
                         backends=("pallas",), width_cap=16)
    assert np.array_equal(
        p.ell_t_block_ptr.numpy(),
        tplan.block_ptr_from_first(np.asarray(jp.ell_t_first),
                                   jp.n_t_blocks))


def test_resident_quantized_features_refuse_gradients():
    """The resident int8 feature path has no f32 x to differentiate: a
    gradient request through it raises (inference-only, as the
    reference's); under no_grad it serves."""
    n, d = 40, 8
    s, r, w, _, rng = _graph(n, n_invalid=0)
    p = _tplan(s, r, n, edge_weight=w)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    qf = tq.quantize_features(x, d)
    vals = torch.from_numpy(w).requires_grad_()
    with pytest.raises(NotImplementedError, match="inference-only"):
        tsb.aggregate(p, vals, qf, backend="cuda_q8")
    with torch.no_grad():
        y = tsb.aggregate(p, vals, qf, backend="cuda_q8")
    assert not y.requires_grad
    assert torch.equal(y, tsb.aggregate(p, None, qf, backend="cuda_q8"))


@pytest.mark.parametrize("ref_backend,backend",
                         [("pallas", "cuda"), ("pallas_q8", "cuda_q8")])
def test_gcn_gradients_match_reference(ref_backend, backend):
    """gcn's loss and every parameter gradient through the port's executor
    equal the reference's custom VJP (Pallas in interpret mode), on the
    reference's parameters."""
    from repro.models.gnn import gcn as jgcn
    from repro_torch.models.gnn import gcn as tgcn
    n, e = 30, 100
    rng = np.random.default_rng(4)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    cfg = jgcn.GCNConfig(d_in=6, d_hidden=4, n_classes=3, n_layers=2)
    tcfg = tgcn.GCNConfig(d_in=6, d_hidden=4, n_classes=3, n_layers=2)
    x = rng.normal(size=(n + 1, 6)).astype(np.float32)
    labels = rng.integers(0, 3, n + 1).astype(np.int32)
    mask = np.arange(n + 1) < 20
    jp = jplan.make_plan(s, r, n + 1, edge_weight=w,
                         backends=("dense", ref_backend))
    tp = tplan.make_plan(s, r, n + 1, edge_weight=w,
                         backends=("dense", backend), device=CPU)
    params = jgcn.init_params(jax.random.key(1), cfg)
    loss_j, grads_j = jax.value_and_grad(jgcn.loss_fn)(
        params, cfg, jnp.asarray(x), None, None, None, None,
        jnp.asarray(labels), jnp.asarray(mask), backend=ref_backend,
        plan=jp)
    tparams = convert.gcn_params_from_jax(jax.tree.map(np.asarray, params),
                                          device=CPU)
    leaves, structure = tree.flatten(tparams)
    live = [t.requires_grad_() for t in leaves]
    loss_t = tgcn.loss_fn(tree.unflatten(structure, live), tcfg,
                          torch.from_numpy(x), None, None, None, None,
                          torch.from_numpy(labels), torch.from_numpy(mask),
                          backend=backend, plan=tp)
    grads_t = torch.autograd.grad(loss_t, live)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=GRAD_RTOL)
    for gj, gt in zip(jax.tree.leaves(grads_j), grads_t):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _np_params(rng):
    return {"layer0": {"w": rng.normal(size=(7, 5)).astype(np.float32),
                       "b": rng.normal(size=5).astype(np.float32)},
            "layer1": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                       "b": rng.normal(size=3).astype(np.float32)}}


@pytest.mark.parametrize("weight_decay,grad_scale", [(0.0, 3.0), (0.1, 3.0),
                                                      (0.1, 0.01)])
def test_adamw_matches_reference(weight_decay, grad_scale):
    """Six steps on the same numpy trees: parameters, m, v and the
    gradient norm equal the reference's (≤1e-6), with clipping active
    (‖g‖ ≫ 1) and not (‖g‖ < 1)."""
    rng = np.random.default_rng(0)
    p_np = _np_params(rng)
    jcfg = jadamw.AdamWConfig(lr=1e-2, weight_decay=weight_decay)
    tcfg = adamw.AdamWConfig(lr=1e-2, weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = jax.tree.map(torch.from_numpy, p_np)
    js, ts = jadamw.init_state(jp), adamw.init_state(tp)
    for _ in range(6):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape)
                                    * grad_scale).astype(np.float32), p_np)
        jp, js, jn = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                          js, jcfg)
        tp, ts, tn = adamw.apply_updates(tp, jax.tree.map(torch.from_numpy,
                                                          g), ts, tcfg)
        assert (float(jn) > 1.0) == (grad_scale > 1)
        np.testing.assert_allclose(float(tn), float(jn), rtol=ADAMW_TOL)
        for a, b in zip(jax.tree.leaves((jp, js.m, js.v)),
                        tree.leaves((tp, ts.m, ts.v))):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=ADAMW_TOL, atol=ADAMW_TOL)
    assert int(ts.step) == int(js.step) == 6
    assert ts.step.dtype == torch.int32
    assert all(t.dtype == torch.float32 for t in tree.leaves((ts.m, ts.v)))


def test_adamw_has_no_torch_optim():
    src = inspect.getsource(adamw)
    assert "torch.optim" not in src.replace("torch.optim.AdamW``", "")


# ---------------------------------------------------------------------------
# checkpoint store (the cases of tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(8, 4)).astype(
                np.float32)),
            "b": {"c": torch.from_numpy(rng.integers(0, 10, 5).astype(
                np.int32))}}


def _equal_trees(t1, t2):
    l1, s1 = tree.flatten(t1)
    l2, s2 = tree.flatten(t2)
    assert s1 == s2
    for a, b in zip(l1, l2):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    store.save(tmp_path, 3, t, metadata={"loss": 1.5})
    like = {"a": torch.empty(8, 4), "b": {"c": torch.empty(5,
                                                           dtype=torch.int32)}}
    out, meta = store.restore(tmp_path, 3, like)
    assert meta["loss"] == 1.5
    _equal_trees(out, t)
    man = json.loads((tmp_path / "step_000003" / "manifest.json")
                     .read_text())
    assert man["n_leaves"] == 2 and man["leaves"][0]["shape"] == [8, 4]


def test_checkpoint_torn_ignored(tmp_path):
    store.save(tmp_path, 1, _tree())
    step2 = tmp_path / "step_000002"
    step2.mkdir()
    (step2 / "manifest.json").write_text(json.dumps({"step": 2}))
    assert store.latest_step(tmp_path) == 1


def test_checkpoint_async_and_gc(tmp_path):
    ck = store.AsyncCheckpointer(tmp_path)
    for s in (1, 2, 3, 4):
        ck.save_async(s, _tree(s))
    ck.wait()
    assert store.committed_steps(tmp_path) == [1, 2, 3, 4]
    store.gc_keep_last(tmp_path, keep=2)
    assert store.committed_steps(tmp_path) == [3, 4]


def test_checkpoint_restore_takes_like_dtype(tmp_path):
    """Restore places each leaf in the dtype (and on the device) of its
    ``like_tree`` leaf, whatever wrote it (the port's elastic restore)."""
    t = _tree()
    store.save(tmp_path, 7, t)
    like = {"a": torch.empty(8, 4, dtype=torch.float64),
            "b": {"c": torch.empty(5, dtype=torch.int64)}}
    out, _ = store.restore(tmp_path, 7, like)
    assert out["a"].dtype == torch.float64 and out["a"].device.type == CPU
    np.testing.assert_array_equal(out["a"].numpy(), t["a"].double().numpy())
    assert out["b"]["c"].dtype == torch.int64


def test_checkpoint_uncommitted_step_raises_typed(tmp_path):
    step2 = tmp_path / "step_000002"
    step2.mkdir()
    (step2 / "manifest.json").write_text(json.dumps({"step": 2}))
    with pytest.raises(store.CheckpointError, match="COMMIT"):
        store.restore(tmp_path, 2, _tree())


def test_checkpoint_shape_mismatch_raises_typed(tmp_path):
    t = _tree()
    store.save(tmp_path, 1, t)
    bad_like = {"a": torch.empty(3, 3), "b": {"c": torch.empty(3, 3)}}
    with pytest.raises(store.CheckpointError, match="shape mismatch"):
        store.restore(tmp_path, 1, bad_like)
    shutil.copytree(tmp_path / "step_000001", tmp_path / "step_000009")
    man = json.loads((tmp_path / "step_000009" / "manifest.json").read_text())
    man["n_leaves"] = 99
    (tmp_path / "step_000009" / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(store.CheckpointError, match="incomplete"):
        store.validate_step(tmp_path, 9)


def test_checkpoint_missing_leaf_file_raises_typed(tmp_path):
    store.save(tmp_path, 4, _tree())
    (tmp_path / "step_000004" / "leaf_00000.npy").unlink()
    with pytest.raises(store.CheckpointError, match="missing leaf"):
        store.validate_step(tmp_path, 4)


def test_checkpoint_gc_never_deletes_inflight_async_save(tmp_path,
                                                         monkeypatch):
    """A slow in-flight save is shielded from deletion and counted toward
    the newest-``keep`` window."""
    for s in (1, 2, 3):
        store.save(tmp_path, s, _tree(s))
    gate = threading.Event()
    orig_save = store.save

    def slow_save(ckpt_dir, step, t, metadata=None):
        gate.wait(10.0)
        return orig_save(ckpt_dir, step, t, metadata)

    ck = store.AsyncCheckpointer(tmp_path)
    monkeypatch.setattr(store, "save", slow_save)
    try:
        ck.save_async(9, _tree(9))
        assert store.inflight_steps(tmp_path) == [9]
        store.gc_keep_last(tmp_path, keep=2)
        assert store.committed_steps(tmp_path) == [3]
    finally:
        gate.set()
        ck.wait()
    assert store.committed_steps(tmp_path) == [3, 9]
    assert store.inflight_steps(tmp_path) == []
    store.gc_keep_last(tmp_path, keep=1)
    assert store.committed_steps(tmp_path) == [9]


def test_checkpoint_crosses_packages(tmp_path):
    """A (params, AdamW state) step written by the reference restores into
    the port leaf for leaf, and one written by the port into the
    reference."""
    rng = np.random.default_rng(3)
    p_np = _np_params(rng)
    jp = jax.tree.map(jnp.asarray, p_np)
    js = jadamw.init_state(jp)
    g = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape)
                                           .astype(np.float32)), p_np)
    jp, js, _ = jadamw.apply_updates(jp, g, js, jadamw.AdamWConfig())
    jstore.save(tmp_path / "ref", 25, (jp, js), metadata={"loss": 0.5})
    tp = jax.tree.map(lambda a: torch.zeros(a.shape), p_np)
    like = (tp, adamw.init_state(tp))
    (rp, rs), meta = store.restore(tmp_path / "ref", 25, like)
    assert meta["loss"] == 0.5 and int(rs.step) == 1
    for a, b in zip(jax.tree.leaves((jp, js.m, js.v)),
                    tree.leaves((rp, rs.m, rs.v))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    store.save(tmp_path / "port", 26, (rp, rs))
    (bp, bs), _ = jstore.restore(tmp_path / "port", 26, (jp, js))
    assert int(bs.step) == 1
    for a, b in zip(jax.tree.leaves((bp, bs)), jax.tree.leaves((jp, js))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------

def _gcn_job(ckpt_dir, n_steps, backend="cuda", **kw):
    from repro_torch.configs import registry
    from repro_torch.launch.train import _gnn_setup
    cfg = registry.get_config("gcn-cora")
    params, step, batches = _gnn_setup("gcn-cora", cfg, 0,
                                       backend=backend, device=CPU)
    state = train_loop.TrainState(params=params,
                                  opt_state=adamw.init_state(params))
    loop_cfg = train_loop.TrainLoopConfig(
        n_steps=n_steps, ckpt_every=5, ckpt_dir=str(ckpt_dir),
        log_every=1000, **kw)
    return state, step, batches, loop_cfg


def _quiet(*_):
    pass


def test_loop_trains_and_resumes(tmp_path):
    """30 steps halve the loss; a fresh state on the same directory resumes
    at the committed step and re-runs only the rest, bitwise as one run."""
    state, step, batches, cfg = _gcn_job(tmp_path / "a", 30)
    whole, hist = train_loop.run(state, step, batches, cfg, log=_quiet)
    assert whole.step == 30 and hist["loss"][-1] < 0.5 * hist["loss"][0]
    ckpt = tmp_path / "b"
    state, step, batches, cfg = _gcn_job(ckpt, 10)
    state, _ = train_loop.run(state, step, batches, cfg, log=_quiet)
    assert store.committed_steps(ckpt) == [5, 10]
    state2, step2, batches2, cfg2 = _gcn_job(ckpt, 30)
    logs = []
    state2, hist2 = train_loop.run(state2, step2, batches2, cfg2,
                                   log=logs.append)
    assert state2.step == 30 and len(hist2["loss"]) == 20
    assert any("resumed from committed step 10" in m for m in logs)
    assert hist2["loss"] == hist["loss"][10:]
    _equal_trees(state2.params, whole.params)
    _equal_trees(state2.opt_state, whole.opt_state)
    assert store.committed_steps(ckpt) == [20, 25, 30]   # keep_ckpts = 3


def test_loop_failure_rolls_back(tmp_path):
    state, step, batches, cfg = _gcn_job(tmp_path / "c", 15)
    boom = {"armed": True}

    def injector(s):
        if s == 8 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    logs = []
    state, hist = train_loop.run(state, step, batches, cfg,
                                 fail_injector=injector, log=logs.append)
    assert state.step == 15 and hist["retries"] == 1
    assert any("rolled back to step 5" in m for m in logs)
    assert len(hist["loss"]) == 18         # steps 6-8 ran twice
    ref_state, ref_step, ref_batches, ref_cfg = _gcn_job(tmp_path / "c2", 15)
    _, ref_hist = train_loop.run(ref_state, ref_step, ref_batches, ref_cfg,
                                 log=_quiet)
    assert hist["loss"][-1] == ref_hist["loss"][-1]


def test_loop_aborts_after_max_retries(tmp_path):
    state, step, batches, cfg = _gcn_job(tmp_path / "d", 10, max_retries=2)
    calls = []

    def always_fail(s):
        calls.append(s)
        raise RuntimeError("dead node")

    with pytest.raises(RuntimeError, match="aborting after 2"):
        train_loop.run(state, step, batches, cfg, fail_injector=always_fail,
                       log=_quiet)
    assert len(calls) == 3


def test_loop_default_ckpt_dir_is_fresh():
    """Without ``ckpt_dir`` each run checkpoints into a new temporary
    directory, so a second run starts at step 0 instead of resuming the
    first's steps."""
    dirs = []
    for _ in range(2):
        state, step, batches, cfg = _gcn_job(None, 5)
        cfg.ckpt_dir = None
        state, hist = train_loop.run(state, step, batches, cfg, log=_quiet)
        assert state.step == 5 and len(hist["loss"]) == 5
        assert store.committed_steps(cfg.ckpt_dir) == [5]
        dirs.append(cfg.ckpt_dir)
    assert dirs[0] != dirs[1]
    assert train_loop.TrainLoopConfig().ckpt_dir is None
    for d in dirs:
        shutil.rmtree(d)


def test_loop_counts_stragglers(tmp_path, monkeypatch):
    """A step slower than ``straggler_factor`` × the EWMA is counted and
    reported to the hook (a fake clock makes step 4 slow)."""
    ticks = iter([0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 13.0, 13.0, 14.0])
    monkeypatch.setattr(train_loop.time, "perf_counter", lambda: next(ticks))

    def step_fn(p, o, b):
        return p, o, {"loss": torch.tensor(1.0)}

    seen = []
    state = train_loop.TrainState(params={"w": torch.zeros(1)},
                                  opt_state=(torch.zeros(1),))
    cfg = train_loop.TrainLoopConfig(n_steps=5, ckpt_every=100,
                                     ckpt_dir=str(tmp_path), log_every=100)
    state, hist = train_loop.run(
        state, step_fn, iter(lambda: None, 1), cfg, log=_quiet,
        on_straggler=lambda s, dt, ewma: seen.append((s, dt, ewma)))
    assert hist["stragglers"] == 1 and seen == [(4, 10.0, 1.0)]
    assert hist["step_s"] == [1.0, 1.0, 1.0, 10.0, 1.0]


# ---------------------------------------------------------------------------
# launch/train against repro.launch.train
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,two_hop", [("dense", False),
                                             ("chunked", False),
                                             ("cuda", False),
                                             ("dense", True),
                                             ("cuda", True)])
def test_train_trajectory_matches_reference(backend, two_hop):
    """Ten steps of gcn-cora at full width on the Cora-scale graph: the
    port's setup on the reference's parameters against
    ``repro.launch.train``'s (the reference's ``dense``; its ``pallas``
    in interpret mode is too slow at 10,556 edges), loss ≤1e-4 a step."""
    from repro.configs import registry as jreg
    from repro.launch import train as jtrain
    from repro_torch.configs import registry as treg
    from repro_torch.launch import train as ttrain
    jp, jstep, jb = jtrain._gnn_setup("gcn-cora", jreg.get_config(
        "gcn-cora"), 0, True, backend="dense", two_hop=two_hop)
    _, tstep, tb = ttrain._gnn_setup("gcn-cora", treg.get_config(
        "gcn-cora"), 0, backend=backend, two_hop=two_hop, device=CPU)
    tp = convert.gcn_params_from_jax(jax.tree.map(np.asarray, jp),
                                     device=CPU)
    js, ts = jadamw.init_state(jp), adamw.init_state(tp)
    jstep = jax.jit(jstep)
    jbatch, tbatch = next(jb), next(tb)
    for i in range(10):
        jp, js, jm = jstep(jp, js, jbatch)
        tp, ts, tm = tstep(tp, ts, tbatch)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TRAJ_TOL, i
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            TRAJ_TOL * max(1.0, float(jm["grad_norm"])), i
    for a, b in zip(jax.tree.leaves(jp), tree.leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=TRAJ_TOL)


def test_train_cli(tmp_path, capsys, monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.launch import train as ttrain
    argv = ["--arch", "gcn-cora", "--full-gnn", "--backend", "cuda_q8",
            "--steps", "4", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    assert ttrain.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[train] 4 steps in") and "retries=0" in line
    assert store.committed_steps(tmp_path) == [2, 4]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--full-gnn", "--steps", "1"])
    # the LM preset and archs set up (A8); schnet is still not trained here
    for arch in (ttrain.LM100M, registry.get_config("qwen3-0.6b",
                                                    reduced=True)):
        params, _, batches = ttrain._lm_setup(arch, 1, 8, 0, "cpu")
        assert tuple(next(batches)["tokens"].shape) == (1, 8)
        assert params["embed"].shape == (arch.vocab, arch.d_model)
    with pytest.raises(NotImplementedError, match="Cora-scale graph"):
        ttrain.main(["--arch", "schnet", "--device", "cpu"])


def test_build_gnn_step_guards():
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.launch.steps import build_gnn_step, resolve_gnn_plan
    with pytest.raises(ValueError, match="graph="):
        build_gnn_step("gcn-cora", FULL, two_hop=True)
    s, r, w, _, _ = _graph(n_invalid=0)
    from repro_torch.sparse.graph import make_graph
    g = make_graph(s, r, 40, w, device=CPU)
    with pytest.raises(ValueError, match="not plan="):
        build_gnn_step("gcn-cora", FULL, graph=g,
                       plan=_tplan(s, r, 41), two_hop=True)
    from repro_torch.configs import schnet
    assert callable(build_gnn_step("schnet", schnet.reduced(), graph=g))
    assert not resolve_gnn_plan(g, "dense").has("ell")
    assert resolve_gnn_plan(g, "dense") is resolve_gnn_plan(g, "chunked")
    assert resolve_gnn_plan(g, "cuda").has("ell")
    assert resolve_gnn_plan(g, "cuda") is resolve_gnn_plan(g, "cuda")
