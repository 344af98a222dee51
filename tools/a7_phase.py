#!/usr/bin/env python3
"""A7 on one GPU: ``chip_smoke.py``'s phase 22, or alone.

    python3 tools/a7_phase.py

(a) the ``distributed`` backend on one NCCL rank (a ``FileStore``
    rendezvous in a temporary directory): gcn-cora at full width (d_in
    1433) on the Cora-scale graph, ``aggregate``, ``accumulate``, the
    gradient in x and the forward against ``dense`` (≤1e-4, the gradient
    ≤1e-3), timed beside ``dense``;
(b) the same at 4 gloo ranks sharing the card (``launch.spmd.spawn``,
    every rank on ``cuda:0``; NCCL refuses two ranks on one device), then
    the all-gather and ring SpMMs at phase 6's Pubmed-scale stand-in
    (19,717 nodes, 88,648 edges) with D = 602 against the single-device
    product (≤1e-4), against each other and each run to run (bitwise);
(c) ``launch.variants.build_gcn_drhm_step``, all-gather and ring, at 4
    ranks on the card: the loss equal to the local GCN loss (≤1e-4), then
    three steps with finite parameters;
(d) the cluster at 4 lanes on the card (``devices=[cuda:0] * 4``), gcn at
    full width on ``cuda`` and ``cuda_q8``: sharded bitwise replicated,
    mesh placement bitwise stacked, offline replay (≤1e-5,
    ``Q8_E2E_TOL`` for int8), B1 and B4 counted, the halo gather timed
    beside the replicated fetch, then a hot-swap and a graph flush on
    sharded residency with every request settled;
(e) ``spmm_blocked_ell`` against its plain version at phase 2's bucket-16
    and Cora-scale shapes, B1 counted.

Every world prints its transport (``nccl``, ``gloo``, ``gloo via host``);
the times of the 4-rank world are of 4 ranks on one card, whose
collectives go through the host, not NVLink.  Alone, it builds B1/B4's
library, prints the card's name and power limit first, and exits
non-zero when there is no GPU or a check fails.
"""
from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_RANKS = 4
PUBMED = (19717, 88648, 602)
A7_REQUESTS = 256
A7_REPLAY = 32
FOUR_ON_ONE = ("4 ranks on one card; collectives through the host, not "
               "NVLink")


def _check(ok, what):
    if not ok:
        raise RuntimeError(what)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _ms(fn, reps: int = 5, per: int = 3) -> float:
    """Median wall ms of ``fn`` (synchronized), ``per`` calls a sample."""
    for _ in range(2):
        fn()
    _sync()
    samples = []
    for _ in range(reps):
        t = time.perf_counter()
        for _ in range(per):
            fn()
        _sync()
        samples.append((time.perf_counter() - t) * 1e3 / per)
    return statistics.median(samples)


def _cora(dev):
    """Cora's stand-in, sym-normed with self loops, its features with the
    ghost row, labels and a seeded 10% label mask."""
    from repro_torch.data.synthetic import cora_like
    from repro_torch.sparse.graph import sym_norm_weights
    s, r, x, y, _ = cora_like(seed=0)
    s2, r2, w2 = sym_norm_weights(s, r, 2708)
    mask = np.random.default_rng(7).random(2708) < 0.1
    return s2, r2, w2, x, y, mask


def backend_checks(mesh, dev, params_np) -> dict:
    """(a)/(b): the ``distributed`` backend against ``dense`` on gcn-cora
    at full width; every rank of ``mesh`` calls it with the whole x."""
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.core import distributed as D
    from repro_torch.models.gnn import gcn
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse.plan import make_plan
    s2, r2, w2, x, _, _ = _cora(dev)
    n_rows = 2709
    plan = make_plan(s2, r2, n_rows, edge_weight=w2,
                     backends=("dense", "distributed"), mesh=mesh,
                     device=dev)
    xt = torch.from_numpy(np.concatenate(
        [x, np.zeros((1, x.shape[1]), np.float32)])).to(dev)
    out = dict(transport=D.transport(mesh, dev), n_shards=plan.n_shards,
               rows_per_shard=plan.rows_per_shard,
               edges_per_shard=plan.edges_per_shard)
    with torch.no_grad():
        y_dist = sb.aggregate(plan, None, xt, backend="distributed")
        y_dense = sb.aggregate(plan, None, xt, backend="dense")
        out["aggregate_err"] = float((y_dist - y_dense).abs().max())
        msgs = torch.from_numpy(np.random.default_rng(3).normal(
            size=(s2.shape[0], 16)).astype(np.float32)).to(dev)
        out["accumulate_err"] = float(
            (sb.accumulate(plan, msgs, backend="distributed")
             - sb.accumulate(plan, msgs, backend="dense")).abs().max())
    grads = []
    for name in ("distributed", "dense"):
        xg = xt.clone().requires_grad_()
        (sb.aggregate(plan, None, xg, backend=name) ** 2).sum().backward()
        grads.append(xg.grad)
    out["grad_err"] = float((grads[0] - grads[1]).abs().max())
    params = {k: {n: torch.from_numpy(v).to(dev) for n, v in p.items()}
              for k, p in params_np.items()}
    with torch.no_grad():
        f = [gcn.forward(params, FULL, xt, backend=b, plan=plan)
             for b in ("distributed", "dense")]
        out["forward_err"] = float((f[0] - f[1]).abs().max())
        out["distributed_ms"] = _ms(lambda: sb.aggregate(
            plan, None, xt, backend="distributed"))
        out["dense_ms"] = _ms(lambda: sb.aggregate(plan, None, xt,
                                                   backend="dense"))
    return out


def spmm_checks(mesh, dev) -> dict:
    """(b): the all-gather and ring SpMMs at the Pubmed-scale stand-in."""
    from repro_torch.core import distributed as D
    from repro_torch.data.synthetic import powerlaw_graph
    from repro_torch.sparse.segment_ops import segment_sum
    n, e, d = PUBMED
    s, r = powerlaw_graph(n, e + 2000, alpha=1.6, seed=0)
    rows, cols = r[:e], s[:e]
    vals = np.random.default_rng(2).normal(size=e).astype(np.float32)
    x = np.random.default_rng(5).normal(size=(n, d)).astype(np.float32)
    plan = D.plan_distributed_spmm(rows, cols, vals, n,
                                   n_shards=D.axis_size(mesh, "data"),
                                   ring=True)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    xp = t(D.permute_features(x, plan))
    ag = D.make_allgather_spmm(mesh, plan, model_axis=None)
    ring = D.make_ring_spmm(mesh, plan, model_axis=None)
    ag_in = (t(plan.rows_local), t(plan.cols_perm), t(plan.vals))
    ring_in = (t(plan.ring_rows), t(plan.ring_cols), t(plan.ring_vals))
    xd, r_t, c_t, v_t = t(x), t(rows.astype(np.int64)), \
        t(cols.astype(np.int64)), t(vals)
    with torch.no_grad():
        y_one = segment_sum(xd.index_select(0, c_t) * v_t[:, None], r_t, n)
        perm = t(plan.perm[:n].astype(np.int64))
        outs = {}
        for name, fn, args in (("allgather", ag, ag_in),
                               ("ring", ring, ring_in)):
            y1 = fn(xp, *args)
            y2 = fn(xp, *args)
            outs[name] = dict(
                err_vs_one_device=float(
                    (y1.index_select(0, perm) - y_one).abs().max()),
                run_to_run_bitwise=bool(torch.equal(y1, y2)),
                ms=_ms(lambda: fn(xp, *args)))
            outs[name + "_y"] = y1
        outs["allgather_vs_ring"] = float(
            (outs.pop("allgather_y") - outs.pop("ring_y")).abs().max())
    outs.update(transport=D.transport(mesh, dev), n=n, e=e, d=d,
                e_blk=plan.e_blk, edges_per_shard=plan.edges_per_shard)
    return outs


def step_checks(mesh, dev, params_np) -> dict:
    """(c): the DRHM-sharded GCN step against the local GCN loss."""
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.core import distributed as D
    from repro_torch.launch import variants
    from repro_torch.models.gnn import gcn
    from repro_torch.optim import adamw
    s2, r2, w2, x, y, mask = _cora(dev)
    n = 2708

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def params():
        return {k: {m: t(v) for m, v in p.items()}
                for k, p in params_np.items()}
    with torch.no_grad():
        local = float(gcn.loss_fn(params(), FULL, t(x), t(s2), t(r2), t(w2),
                                  torch.ones(len(s2), dtype=torch.bool,
                                             device=dev), t(y), t(mask)))
    out = dict(local_loss=local)
    for ring in (False, True):
        plan = D.plan_distributed_spmm(r2, s2, w2, n,
                                       n_shards=D.axis_size(mesh, "data"),
                                       ring=ring)
        yp = np.zeros(plan.n_pad, np.int32)
        yp[plan.perm[:n]] = y
        mp = np.zeros(plan.n_pad, bool)
        mp[plan.perm[:n]] = mask
        batch = {"x_perm": t(D.permute_features(x, plan)),
                 "labels_perm": t(yp), "mask_perm": t(mp)}
        if ring:
            batch.update(ring_rows=t(plan.ring_rows),
                         ring_cols=t(plan.ring_cols),
                         ring_vals=t(plan.ring_vals))
        else:
            batch.update(rows_local=t(plan.rows_local),
                         cols_perm=t(plan.cols_perm), vals=t(plan.vals))
        step = variants.build_gcn_drhm_step(
            FULL, mesh, plan.n_pad, ring=ring,
            opt_cfg=adamw.AdamWConfig(lr=1e-2))
        p, o = params(), adamw.init_state(params())
        losses, times = [], []
        for _ in range(3):
            _sync()
            t0 = time.perf_counter()
            p, o, m = step(p, o, batch)
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        out["ring" if ring else "allgather"] = dict(
            losses=losses, loss_err=abs(losses[0] - local),
            finite=all(bool(torch.isfinite(v).all()) for q in p.values()
                       for v in q.values()),
            step_ms=statistics.median(times))
    return out


def world_ranks(rank, mesh, params_np, device):
    """Every rank of the 4-rank gloo world on the one card (``device``):
    (b) and (c)."""
    dev = torch.device(device)
    return dict(backend=backend_checks(mesh, dev, params_np),
                spmm=spmm_checks(mesh, dev),
                step=step_checks(mesh, dev, params_np))


def one_rank_nccl(dev, params_np) -> dict:
    """(a): a world of one NCCL rank in this process (gloo where ``dev``
    is the host, a rehearsal), destroyed after."""
    import torch.distributed as dist
    from repro_torch.launch import spmd
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as d:
        spmd.init_world(0, 1, os.path.join(d, "store"), backend)
        try:
            mesh = spmd.world_mesh((1,), ("data",),
                                   "cuda" if backend == "nccl" else "cpu")
            return backend_checks(mesh, dev, params_np)
        finally:
            dist.destroy_process_group()


def _tol_checks(name, rec):
    _check(rec["aggregate_err"] <= 1e-4, f"{name} aggregate {rec}")
    _check(rec["accumulate_err"] <= 1e-4, f"{name} accumulate {rec}")
    _check(rec["grad_err"] <= 1e-3, f"{name} gradient {rec}")
    _check(rec["forward_err"] <= 1e-4, f"{name} forward {rec}")


def cluster_checks(dev, cfg, params, indptr, indices, store) -> dict:
    """(d): the cluster at 4 lanes on the card, sharded and mesh-placed."""
    from repro_torch.kernels.gustavson_spmm import (spmm_dedup_chunks,
                                                    spmm_dedup_chunks_q8)
    from repro_torch.serve import ClusterServer
    from repro_torch.sparse.quantize import Q8_E2E_TOL
    seeds = np.random.default_rng(22).integers(0, 2708, A7_REQUESTS)
    lanes = [dev] * N_RANKS
    out = {"launches": {"spmm_dedup_chunks": 0, "spmm_dedup_chunks_q8": 0}}
    for backend in ("cuda", "cuda_q8"):
        res, rec = {}, {}
        for mode, placement in (("replicated", "stacked"),
                                ("sharded", "stacked"),
                                ("sharded", "mesh")):
            kw = {} if mode == "replicated" else dict(devices=lanes)
            srv = ClusterServer("gcn", cfg, params, indptr, indices, store,
                                n_lanes=N_RANKS, mode=mode,
                                placement=placement, fanouts=(5, 3),
                                backend=backend, max_batch_seeds=16, seed=0,
                                device=dev, **kw)
            with srv:
                srv.warmup()
                _sync()
                spmm_dedup_chunks.launches = 0
                spmm_dedup_chunks_q8.launches = 0
                t0 = time.perf_counter()
                reqs = srv.submit_many([np.array([s]) for s in seeds])
                srv.drain()
                wall = time.perf_counter() - t0
                b1 = spmm_dedup_chunks.launches
                b4 = spmm_dedup_chunks_q8.launches
                _check(all(r.n_settles == 1 and r.error is None
                           for r in reqs), f"{backend} {mode}/{placement}: "
                                           "a request unsettled or failed")
                res[(mode, placement)] = np.concatenate(
                    [r.result for r in reqs])
                tol = Q8_E2E_TOL if backend == "cuda_q8" else 1e-5
                err = max(float(np.abs(srv.offline_replay(r)
                                       - r.result).max())
                          for r in reqs[:A7_REPLAY])
                _check(err <= tol, f"{backend} {mode}/{placement}: replay "
                                   f"{err} > {tol}")
                ids = np.random.default_rng(1).integers(
                    -1, 2708, (N_RANKS, srv._struct(16).n_nodes))
                rec[f"{mode}/{placement}"] = dict(
                    req_per_s=len(reqs) / wall,
                    rounds=srv.stats()["n_rounds"], replay_err=err,
                    b1_launches=b1, b4_launches=b4,
                    fetch_ms=_ms(lambda: srv._gather(ids)))
                if mode == "sharded":
                    out["launches"]["spmm_dedup_chunks"] += b1
                    out["launches"]["spmm_dedup_chunks_q8"] += b4
                    want = "spmm_dedup_chunks_q8" if backend == "cuda_q8" \
                        else "spmm_dedup_chunks"
                    _check((b4 if backend == "cuda_q8" else b1) > 0,
                           f"{backend} {mode}/{placement}: {want} never "
                           "launched")
        base = res[("replicated", "stacked")]
        _check(np.array_equal(res[("sharded", "stacked")], base),
               f"{backend}: sharded is not bitwise replicated")
        _check(np.array_equal(res[("sharded", "mesh")], base),
               f"{backend}: mesh placement is not bitwise stacked")
        out[backend] = rec
    out["live"] = live_checks(dev, cfg, params, indptr, indices, store)
    return out


def live_checks(dev, cfg, params, indptr, indices, store) -> dict:
    """A hot-swap and a graph flush on sharded, mesh-placed residency."""
    from repro_torch.checkpoint import store as ckpt_store
    from repro_torch.launch.gnn_serve import perturbed
    from repro_torch.serve import ClusterServer
    from repro_torch.serve.live import GraphStream, hot_swap
    rng = np.random.default_rng(8)
    srv = ClusterServer("gcn", cfg, params, indptr, indices, store,
                        n_lanes=N_RANKS, mode="sharded", placement="mesh",
                        devices=[dev] * N_RANKS, fanouts=(5, 3),
                        backend="cuda", max_batch_seeds=16, seed=0,
                        device=dev)

    def load(k=96):
        return srv.submit_many([rng.integers(0, 2708, 1) for _ in range(k)])
    with srv:
        srv.warmup([1, 2, 4, 8, 16])
        reqs = load()
        with tempfile.TemporaryDirectory() as d:
            ckpt_store.save(d, 1, perturbed(params, 1))
            swap = hot_swap(srv, d, drain_timeout=60.0)
        reqs += load()
        gs = GraphStream(srv, max_pending=4096, parity_every=1)
        for _ in range(48):
            gs.insert(int(rng.integers(0, 2708)), int(rng.integers(0, 2708)))
        flush = gs.flush()
        reqs += load()
        srv.drain()
        lost = sum(1 for r in reqs if r.n_settles != 1 or r.error is not None)
        _check(lost == 0, f"live on sharded residency: {lost} requests lost")
        _check(swap.drained_old and srv.params_version == 1,
               f"swap on sharded residency: {swap}")
        _check(flush.parity_ok is True, f"flush on sharded residency: "
                                        f"{flush}")
        err = float(np.abs(srv.offline_replay(reqs[-1])
                           - reqs[-1].result).max())
        _check(err <= 1e-5, f"replay after the swap and flush: {err}")
        return dict(requests=len(reqs), lost=lost,
                    blackout_ms=swap.blackout_ms, replay_err=err)


def blocked_ell_checks(dev) -> dict:
    """(e): ``spmm_blocked_ell`` at phase 2's bucket-16 (D = 16) and
    Cora-scale (D = 16 and 1433) shapes against its plain version."""
    from repro_torch.kernels.gustavson_spmm import (spmm_blocked_ell,
                                                    spmm_dedup_chunks)
    from repro_torch.serve.buckets import build_bucket_structure
    from repro_torch.sparse.graph import pack_blocked_ell
    rng = np.random.default_rng(9)
    st = build_bucket_structure(16, (5, 3), with_loops=True)
    s2, r2, w2, _, _, _ = _cora(dev)
    cases = [("bucket16", st.receivers, st.senders,
              rng.normal(size=st.n_edges).astype(np.float32), st.n_nodes,
              16)]
    cases += [("cora_full", r2, s2, w2, 2709, d) for d in (16, 1433)]
    out = []
    spmm_dedup_chunks.launches = 0
    for name, rows, cols, vals, n, d in cases:
        ell = pack_blocked_ell(np.asarray(rows), np.asarray(cols),
                               np.asarray(vals), n, n, block_rows=8)
        x = rng.normal(size=(n, d)).astype(np.float32)
        before = spmm_dedup_chunks.launches
        y = spmm_blocked_ell(ell.cols, ell.row_local, ell.vals,
                             ell.remaining, torch.from_numpy(x).to(dev))
        launched = spmm_dedup_chunks.launches - before
        plain = spmm_blocked_ell(ell.cols, ell.row_local, ell.vals,
                                 ell.remaining, torch.from_numpy(x))
        err = float((y.cpu() - plain).abs().max())
        _check(launched == 1, f"blocked_ell {name}: {launched} B1 launches")
        _check(err <= 1e-5 * max(1.0, float(plain.abs().max())),
               f"blocked_ell {name} D={d}: {err}")
        out.append(dict(shape=f"{name} D={d}", max_abs_err=err,
                        ms_with_repack=_ms(lambda: spmm_blocked_ell(
                            ell.cols, ell.row_local, ell.vals,
                            ell.remaining, torch.from_numpy(x).to(dev)))))
    return dict(cases=out, launches=len(cases))


def phase_a7(dev, params, indptr, indices, store) -> dict:
    """Phase 22: (a)-(e) above; the dry run's record is phase 21's."""
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.launch import spmd
    params_np = {k: {m: v.cpu().numpy() for m, v in p.items()}
                 for k, p in params.items()}
    out = {}
    t = time.perf_counter()
    out["one_nccl_rank"] = one_rank_nccl(dev, params_np)
    _tol_checks("one NCCL rank", out["one_nccl_rank"])
    print(f"[chip-smoke] a7 transport: {out['one_nccl_rank']['transport']}"
          f" (1 rank)", flush=True)
    t_spawn = time.perf_counter()
    ranks = spmd.spawn(world_ranks, N_RANKS, backend="gloo",
                       device_type=dev.type, mesh_names=("data",),
                       args=(params_np, str(dev)), threads=2)
    four = ranks[0]
    out["four_ranks_s"] = time.perf_counter() - t_spawn
    out["four_ranks"] = dict(label=FOUR_ON_ONE, **four)
    print(f"[chip-smoke] a7 transport: {four['backend']['transport']} "
          f"({N_RANKS} ranks on one card)", flush=True)
    _tol_checks("4 gloo ranks", four["backend"])
    for name in ("allgather", "ring"):
        rec = four["spmm"][name]
        _check(rec["err_vs_one_device"] <= 1e-4, f"{name} spmm {rec}")
        _check(rec["run_to_run_bitwise"], f"{name} spmm not bitwise "
                                          "run to run")
        st = four["step"][name]
        _check(st["loss_err"] <= 1e-4 and st["finite"],
               f"gcn_drhm {name} step {st}")
    _check(four["spmm"]["allgather_vs_ring"] <= 1e-4,
           f"allgather vs ring {four['spmm']['allgather_vs_ring']}")
    for r in ranks[1:]:
        _check(r["step"]["allgather"]["losses"]
               == four["step"]["allgather"]["losses"],
               "the ranks' losses differ")
    t_cluster = time.perf_counter()
    out["cluster"] = cluster_checks(dev, FULL, params, indptr, indices,
                                    store)
    out["cluster_s"] = time.perf_counter() - t_cluster
    out["blocked_ell"] = blocked_ell_checks(dev)
    out["launches"] = dict(out["cluster"]["launches"])
    out["launches"]["spmm_dedup_chunks"] += out["blocked_ell"]["launches"]
    out["phase_s"] = time.perf_counter() - t
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("a7_phase: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.data.synthetic import cora_like
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, gustavson_spmm
    from repro_torch.models.gnn import gcn
    from repro_torch.serve import FeatureStore
    from repro_torch.sparse.graph import coo_to_csr
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0],
          flush=True)
    secs = build.build([gustavson_spmm.LIBRARY])
    dev = resolve_device("cuda")
    s, r, x, _, _ = cora_like(seed=0)
    params = gcn.init_params(FULL, torch.Generator().manual_seed(0),
                             device=dev)
    indptr, indices, _ = coo_to_csr(s, r, 2708)
    store = FeatureStore.build(2708, x, device=dev)
    out = phase_a7(dev, params, indptr, indices, store)
    print(json.dumps(out, default=float), flush=True)
    print(f"a7_phase built {secs:.1f} s, phase {out['phase_s']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
