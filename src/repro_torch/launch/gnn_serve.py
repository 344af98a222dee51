"""GNN inference serving driver, single lane — port of the single-lane path
of ``repro.launch.gnn_serve``.

  PYTHONPATH=src python -m repro_torch.launch.gnn_serve --backend cuda \\
      --sampler device --requests 100 --max-batch 16 --fanouts 5,3
  PYTHONPATH=src python -m repro_torch.launch.gnn_serve --arch sage ...
  PYTHONPATH=src python -m repro_torch.launch.gnn_serve --arch dimenet ...

Serves one arch (``--arch gcn|gat|sage|gin|schnet|dimenet``).  Stands up
a ``GNNServer`` over a synthetic power-law resident graph (node features
for the conv family; species and positions for the geometric one), fires
a seeded request trace at it, drains, and reports throughput, latency
percentiles and the rebuild counter — then replays every request offline
(one at a time, trees re-sampled on the host) and checks parity: ≤1e-5,
or ``Q8_E2E_TOL`` for the conv family under ``--backend cuda_q8``, where
each bucket quantizes with its own chunk scales, so a bucket-16 step and
its bucket-1 replay round differently (the reference's own anchor for
quantized serving); the geometric family accumulates in f32 on every
executor.  Exits 1 when parity fails or a request is left unsettled.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.models.gnn import dimenet, gat, gcn, gin, sage, schnet
from repro_torch.serve import FeatureStore, GNNServer, offline_replay
from repro_torch.serve.compute import GEOM_ARCHS
from repro_torch.sparse.graph import coo_to_csr
from repro_torch.sparse.plan import ALL_BACKENDS
from repro_torch.sparse.quantize import Q8_E2E_TOL

PARITY_TOL = 1e-5


def parity_tol(backend: str, arch: str = "gcn") -> float:
    """Served-vs-replay bar: int8 steps round per bucket (the geometric
    family runs no int8 aggregation)."""
    if backend == "cuda_q8" and arch not in GEOM_ARCHS:
        return Q8_E2E_TOL
    return PARITY_TOL


# --arch → (model module, its config class)
MODELS = {"gcn": (gcn, gcn.GCNConfig), "gat": (gat, gat.GATConfig),
          "sage": (sage, sage.SAGEConfig), "gin": (gin, gin.GINConfig),
          "schnet": (schnet, schnet.SchNetConfig),
          "dimenet": (dimenet, dimenet.DimeNetConfig)}


def geometry(rng: np.random.Generator, n_nodes: int):
    """(species, pos) of ``n_nodes`` atoms as ``build_world`` draws them:
    species in [1, 9), positions ~ N(0, 2²) per axis."""
    species = rng.integers(1, 9, n_nodes).astype(np.int32)
    pos = rng.normal(scale=2.0, size=(n_nodes, 3)).astype(np.float32)
    return species, pos


def build_world(n_nodes: int, n_edges: int, d_in: int, seed: int = 0,
                device=None, arch: str = "gcn"):
    """(cfg, params, indptr, indices, store) on a synthetic resident graph:
    the conv archs' default config at ``d_in`` features and 8 classes; the
    reference's explicit small schnet and dimenet configs, which read
    species and positions drawn after the features (the reference's
    draw order)."""
    s, r = syn.powerlaw_graph(n_nodes, n_edges, seed=seed)
    indptr, indices, _ = coo_to_csr(s, r, n_nodes)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(n_nodes, d_in)).astype(np.float32)
    mod, config = MODELS[arch]
    if arch == "schnet":
        cfg = config(n_interactions=2, d_hidden=32, n_rbf=16)
    elif arch == "dimenet":
        cfg = config(n_blocks=1, d_hidden=16, n_bilinear=2, n_spherical=3)
    else:
        cfg = config(d_in=d_in, n_classes=8)
    params = mod.init_params(cfg, torch.Generator().manual_seed(seed),
                             device=device)
    if arch in GEOM_ARCHS:
        species, pos = geometry(rng, n_nodes)
        store = FeatureStore.build(n_nodes, device=device, species=species,
                                   pos=pos)
    else:
        store = FeatureStore.build(n_nodes, x, device=device)
    return cfg, params, indptr, indices, store


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gcn", choices=list(MODELS))
    ap.add_argument("--backend", default="cuda", choices=list(ALL_BACKENDS))
    ap.add_argument("--sampler", default="host", choices=["host", "device"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--nodes", type=int, default=2048)
    ap.add_argument("--edges", type=int, default=8192)
    ap.add_argument("--d-in", type=int, default=32)
    ap.add_argument("--fanouts", default="5,3")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    fanouts = tuple(int(f) for f in args.fanouts.split(","))
    cfg, params, indptr, indices, store = build_world(
        args.nodes, args.edges, args.d_in, args.seed, device, args.arch)
    seeds = np.random.default_rng(args.seed + 2).integers(0, args.nodes,
                                                          args.requests)
    server = GNNServer(args.arch, cfg, params, indptr, indices, store,
                       fanouts=fanouts, backend=args.backend,
                       sampler=args.sampler, max_batch_seeds=args.max_batch,
                       seed=args.seed, device=device)
    with server:
        server.warmup()
        warm_builds = server.steps.builds
        server.reset_stats()
        t0 = time.perf_counter()
        reqs = [server.submit([s]) for s in seeds]
        server.drain()
        dt = time.perf_counter() - t0
        st = server.stats()
        print(f"[gnn-serve] {args.arch}/{args.backend}/{args.sampler} on "
              f"{device}: {args.requests} requests in {dt:.2f}s "
              f"({args.requests / dt:.1f} req/s)  "
              f"p50={st['p50_ms']:.1f}ms p95={st['p95_ms']:.1f}ms "
              f"p99={st['p99_ms']:.1f}ms  "
              f"batches={st['n_batches']} buckets={st['bucket_counts']} "
              f"recompiles(post-warmup)={server.steps.builds - warm_builds}")
        unsettled = [r.rid for r in reqs if r.n_settles != 1]
        failed = [r.rid for r in reqs if r.error is not None]
        if unsettled or failed:
            print(f"[gnn-serve] FAIL: unsettled={unsettled} failed={failed}")
            return 1
        t0 = time.perf_counter()
        ref = np.concatenate([offline_replay(server, r) for r in reqs])
        dt_off = time.perf_counter() - t0
        got = np.concatenate([r.result for r in reqs])
        dev = float(np.abs(got - ref).max())
        ok = dev <= parity_tol(args.backend, args.arch)
        print(f"[gnn-serve] offline replay: {dt_off:.2f}s "
              f"({args.requests / dt_off:.1f} req/s), parity max|Δ| "
              f"{dev:.2e} ({'OK' if ok else 'FAIL'})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
