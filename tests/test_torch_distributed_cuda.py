"""The distributed executor and the sharded, mesh-placed cluster on the
card.

Marked ``gpu``: each test skips without a CUDA device.  On a machine with
one, run ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_distributed_cuda.py``.  This file imports no JAX.

* the ``distributed`` backend on one NCCL rank against ``dense`` (≤1e-4,
  the gradient in x ≤1e-3);
* ``build_gcn_drhm_step`` (all-gather and ring) on 2 gloo ranks sharing
  the card: the loss equal to the local GCN loss (≤1e-4), three steps
  finite;
* a 4-lane cluster with every lane on the card: sharded residency bitwise
  replicated and mesh placement bitwise stacked on ``cuda`` and
  ``cuda_q8``, with B1 (B4) launched.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

N = 200


@pytest.fixture(autouse=True)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _graph(seed=0):
    from repro_torch.data.synthetic import powerlaw_graph
    from repro_torch.sparse.graph import sym_norm_weights
    s, r = powerlaw_graph(N, 1200, seed=seed)
    return sym_norm_weights(s, r, N)


def test_distributed_backend_on_one_nccl_rank():
    import torch.distributed as dist
    from repro_torch.launch import spmd
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse.plan import make_plan
    dev = torch.device("cuda", 0)
    s, r, w = _graph()
    with tempfile.TemporaryDirectory() as d:
        spmd.init_world(0, 1, os.path.join(d, "store"), "nccl")
        try:
            mesh = spmd.world_mesh((1,), ("data",), "cuda")
            plan = make_plan(s, r, N + 1, edge_weight=w,
                             backends=("dense", "distributed"), mesh=mesh,
                             device=dev)
            x = torch.randn((N + 1, 64), generator=torch.Generator(
                ).manual_seed(0)).to(dev)
            grads = []
            for name in ("distributed", "dense"):
                xg = x.clone().requires_grad_()
                y = sb.aggregate(plan, None, xg, backend=name)
                (y ** 2).sum().backward()
                grads.append((y.detach(), xg.grad))
            assert float((grads[0][0] - grads[1][0]).abs().max()) <= 1e-4
            assert float((grads[0][1] - grads[1][1]).abs().max()) <= 1e-3
        finally:
            dist.destroy_process_group()


def drhm_ranks(rank, mesh):
    from repro_torch.core import distributed as D
    from repro_torch.launch import variants
    from repro_torch.models.gnn import gcn
    from repro_torch.optim import adamw
    dev = torch.device("cuda", 0)
    s, r, w = _graph(1)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, 32)).astype(np.float32)
    y = rng.integers(0, 4, N).astype(np.int32)
    mask = rng.random(N) < 0.5
    cfg = gcn.GCNConfig(n_layers=2, d_in=32, d_hidden=16, n_classes=4)
    params = gcn.init_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    local = float(gcn.loss_fn(params, cfg, t(x), t(s), t(r), t(w),
                              torch.ones(len(s), dtype=torch.bool,
                                         device=dev), t(y), t(mask)))
    out = {"local": local}
    for ring in (False, True):
        plan = D.plan_distributed_spmm(r, s, w, N, n_shards=2, ring=ring)
        yp = np.zeros(plan.n_pad, np.int32)
        yp[plan.perm[:N]] = y
        mp = np.zeros(plan.n_pad, bool)
        mp[plan.perm[:N]] = mask
        batch = {"x_perm": t(D.permute_features(x, plan)),
                 "labels_perm": t(yp), "mask_perm": t(mp)}
        keys = (("ring_rows", "ring_cols", "ring_vals") if ring
                else ("rows_local", "cols_perm", "vals"))
        batch.update({k: t(getattr(plan, k)) for k in keys})
        step = variants.build_gcn_drhm_step(cfg, mesh, plan.n_pad, ring)
        p, o = params, adamw.init_state(params)
        losses = []
        for _ in range(3):
            p, o, m = step(p, o, batch)
            losses.append(float(m["loss"]))
        out[ring] = (losses, all(bool(torch.isfinite(v).all())
                                 for q in p.values() for v in q.values()),
                     D.transport(mesh, dev))
    return out


def test_drhm_step_on_two_ranks_sharing_the_card():
    from repro_torch.launch import spmd
    ranks = spmd.spawn(drhm_ranks, 2, device_type="cuda")
    for got in ranks:
        for ring in (False, True):
            losses, finite, transport = got[ring]
            assert transport == "gloo via host"
            assert abs(losses[0] - got["local"]) <= 1e-4
            assert finite


@pytest.mark.parametrize("backend", ["cuda", "cuda_q8"])
def test_sharded_mesh_cluster_bitwise_on_the_card(backend):
    from repro_torch.kernels.gustavson_spmm import (spmm_dedup_chunks,
                                                    spmm_dedup_chunks_q8)
    from repro_torch.launch.gnn_serve import build_world
    from repro_torch.serve import ClusterServer
    dev = torch.device("cuda", 0)
    cfg, params, indptr, indices, store = build_world(512, 2048, 32, 0, dev)
    trace = [np.random.default_rng(i).integers(0, 512, 2)
             for i in range(48)]
    out = {}
    for mode, placement in (("replicated", "stacked"), ("sharded", "mesh")):
        kw = {} if mode == "replicated" else {"devices": [dev] * 4}
        srv = ClusterServer("gcn", cfg, params, indptr, indices, store,
                            n_lanes=4, mode=mode, placement=placement,
                            fanouts=(3, 2), backend=backend,
                            max_batch_seeds=4, seed=0, device=dev, **kw)
        with srv:
            srv.warmup()
            spmm_dedup_chunks.launches = 0
            spmm_dedup_chunks_q8.launches = 0
            reqs = srv.submit_many(trace)
            srv.drain()
            out[mode] = np.concatenate([q.result for q in reqs])
            launched = (spmm_dedup_chunks_q8 if backend == "cuda_q8"
                        else spmm_dedup_chunks).launches
            assert launched > 0
    assert np.array_equal(out["sharded"], out["replicated"])
