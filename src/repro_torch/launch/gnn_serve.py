"""GNN inference serving driver — port of ``repro.launch.gnn_serve``
(single lane, and the cluster tier).

  PYTHONPATH=src python -m repro_torch.launch.gnn_serve --backend cuda \\
      --sampler device --requests 100 --max-batch 16 --fanouts 5,3
  PYTHONPATH=src python -m repro_torch.launch.gnn_serve --arch sage ...
  PYTHONPATH=src python -m repro_torch.launch.gnn_serve --arch dimenet ...

  # scale-out: 4 replica lanes with DRHM request routing, each round one
  # lane-stacked dispatch
  PYTHONPATH=src python -m repro_torch.launch.gnn_serve --replicas 4 \\
      [--chaos-kill-lane 1 --chaos-round 3] [--slo] [--metrics-port 0]

  # live mutation mid-burst: 3 weight hot-swaps from perturbed
  # checkpoints and 256 streamed edge inserts, each flush parity-proven
  PYTHONPATH=src python -m repro_torch.launch.gnn_serve --replicas 4 \\
      --swap-versions 3 --mutate-edges 256

With ``--replicas`` > 1 it stands up a ``ClusterServer`` (the conv
family, host sampling, as the reference's cluster does), fires the trace
as one bulk ``submit_many``, and reports per-lane utilization, reseeds and
the control plane's counts; it exits 1 on a delivery violation, on a
request lost under ``--chaos-kill-lane``, or when replay parity fails.
``--swap-versions``/``--mutate-edges`` split the burst around the live
mutation plane (``serve.live``): hot-swaps from perturbed checkpoints
and a streamed edge insert stream, each flush proven against a cold
re-pack; it exits 1 when a flush fails parity or an old version does not
drain, and replays only requests settled on the live version and the
last graph epoch.
``--shard`` shards the resident feature table over the lanes (DRHM row
residency with a halo gather) and ``--placement mesh`` runs each lane's
step on a device of its own: by default one lane a visible card (fewer
cards than lanes is an error); ``--lane-devices cuda:0,cuda:0,...`` names
them, a device may repeat (several lanes on one card).

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

from repro_torch import tree
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.models.gnn import dimenet, gat, gcn, gin, sage, schnet
from repro_torch.serve import (ClusterServer, FeatureStore, GNNServer,
                               offline_replay)
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


def perturbed(params, k: int):
    """``params`` with every float leaf scaled by 1 + 0.01·k (integer
    leaves as they are): checkpoint ``k`` of the hot-swap drill."""
    leaves, structure = tree.flatten(params)
    return tree.unflatten(structure, [
        a * (1.0 + 0.01 * k) if torch.is_tensor(a) and a.is_floating_point()
        else a for a in leaves])


def _run_live_mutation(server, params, args):
    """Drive the live-mutation plane mid-burst: ``--swap-versions``
    hot-swaps from perturbed checkpoints (saved to ``--ckpt-dir`` or a
    temporary directory) interleaved with a ``--mutate-edges`` insert
    stream, each flush parity-proven before install.

    A smoke test of the plane, as the reference's launcher is: the first
    half of the burst usually settles before a flip, so a swap mostly
    finds nothing in flight, reports a NaN blackout and waits out
    ``hot_swap``'s ``wait_for_dispatch``, and the printed req/s counts
    those waits.  ``chip_smoke.py``'s phase 19 drill submits each cycle's
    traffic before its swap and is the under-traffic measurement."""
    import contextlib
    import tempfile

    from repro_torch.checkpoint import store as ckpt_store
    from repro_torch.serve import GraphStream, hot_swap
    rng = np.random.default_rng(args.seed + 7)
    swaps, stream = [], None
    with contextlib.ExitStack() as stack:
        ckpt_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory())
        for k in range(1, args.swap_versions + 1):
            ckpt_store.save(ckpt_dir, k, perturbed(params, k), {"cycle": k})
        if args.mutate_edges:
            stream = GraphStream(server,
                                 max_pending=args.mutation_flush_every,
                                 parity_every=1)
        cycles = max(args.swap_versions, 1 if args.mutate_edges else 0)
        per_cycle = -(-args.mutate_edges // cycles) if cycles else 0
        for k in range(1, cycles + 1):
            if k <= args.swap_versions:
                swaps.append(hot_swap(server, ckpt_dir, step=k))
            for _ in range(min(per_cycle,
                               args.mutate_edges - (k - 1) * per_cycle)):
                stream.insert(int(rng.integers(0, args.nodes)),
                              int(rng.integers(0, args.nodes)))
            if stream is not None and stream.pending:
                stream.flush()
    return swaps, (stream.flushes if stream else [])


def live_replayable(reqs, server, flushes) -> list:
    """The settled requests offline replay can reproduce: served on the
    live weight version and, after a graph flush, sampled on the last
    graph epoch (``offline_replay`` re-samples on the current graph, so a
    request sampled before a flush would be replayed on another
    adjacency)."""
    epoch = flushes[-1].epoch if flushes else None
    return [r for r in reqs if r.error is None
            and r.params_version in (None, server.params_version)
            and (epoch is None or r.graph_epoch == epoch)]


def run_cluster(args, device, fanouts, cfg, params, indptr, indices,
                store) -> int:
    """The scale-out path: N replica lanes, DRHM-routed, under the
    supervised control plane."""
    rng = np.random.default_rng(args.seed + 2)
    traces = [rng.integers(0, args.nodes, max(args.seeds_per_request, 1))
              for _ in range(args.requests)]
    mode = "sharded" if args.shard else "replicated"
    chaos = None
    if args.chaos_kill_lane is not None:
        from repro_torch.serve import ChaosInjector, LaneFault
        chaos = ChaosInjector(seed=args.seed, lane_faults=[
            LaneFault(lane=args.chaos_kill_lane, at_round=args.chaos_round)])
    server = ClusterServer(args.arch, cfg, params, indptr, indices, store,
                           n_lanes=args.replicas, mode=mode,
                           placement=args.placement, fanouts=fanouts,
                           backend=args.backend,
                           max_batch_seeds=args.max_batch,
                           max_wait_ms=args.max_wait_ms,
                           n_workers=args.workers, seed=args.seed,
                           chaos=chaos,
                           telemetry_jsonl=args.telemetry_jsonl,
                           stall_timeout=args.stall_timeout,
                           restart_after=args.restart_after,
                           shed_queue_hwm=args.shed_hwm,
                           scale_min_lanes=args.scale_min_lanes,
                           slo=True if args.slo else None,
                           metrics_port=args.metrics_port,
                           devices=(args.lane_devices.split(",")
                                    if args.lane_devices else None),
                           device=device)
    with server:
        if args.metrics_port is not None:
            print(f"[gnn-serve] metrics exposition at "
                  f"{server._metrics_server.url}")
        server.warmup()
        warm_builds = server.steps.builds
        server.reset_stats()
        t0 = time.perf_counter()
        # live mutation splits the burst around its window: traffic is in
        # flight at every flip, and some requests settle on the last
        # version and epoch (the replay check below reads those)
        live = bool(args.swap_versions or args.mutate_edges)
        half = len(traces) // 2 if live else len(traces)
        reqs = server.submit_many(traces[:half], deadline_ms=args.deadline_ms,
                                  cls=args.request_class)
        swaps, flushes = (_run_live_mutation(server, params, args) if live
                          else ([], []))
        reqs += server.submit_many(traces[half:],
                                   deadline_ms=args.deadline_ms,
                                   cls=args.request_class)
        server.drain()
        dt = time.perf_counter() - t0
        st = server.stats()
        ls = server.lane_stats()
        print(f"[gnn-serve] {args.arch}/{args.backend} {mode} "
              f"x{args.replicas} ({args.placement}) on {device}: "
              f"{args.requests} requests in {dt:.2f}s "
              f"({args.requests / dt:.1f} req/s)  "
              f"p50={st['p50_ms']:.1f}ms p99={st['p99_ms']:.1f}ms  "
              f"rounds={st['n_rounds']} reseeds={st['reseeds']} "
              f"recompiles(post-warmup)={server.steps.builds - warm_builds}")
        print(f"[gnn-serve] per-lane served={ls['served']} "
              f"spread={ls['served_spread']:.2f}x mean "
              f"states={ls['states']}")
        if swaps or flushes:
            bl = [w.blackout_ms for w in swaps
                  if w.blackout_ms == w.blackout_ms]        # drop NaN
            ins = sum(f.inserted for f in flushes)
            dels = sum(f.deleted for f in flushes)
            parity = all(f.parity_ok for f in flushes)
            drained = server.retired_versions() == []
            print(f"[gnn-serve] live mutation: {len(swaps)} swap(s) -> "
                  f"v{server.params_version}"
                  + (f" blackout_max={max(bl):.1f}ms" if bl else "")
                  + f"  graph +{ins}/-{dels} over {len(flushes)} "
                    f"flush(es) parity={'OK' if parity else 'FAIL'} "
                    f"drained={'OK' if drained else 'FAIL'}")
            if not parity or not drained:
                return 1
        if (st["failed"] or st["timeouts"] or st["lane_deaths"]
                or chaos is not None):
            print(f"[gnn-serve] control plane: deaths={st['lane_deaths']} "
                  f"restores={st['lane_restores']} "
                  f"reroutes={st['reroutes']} retries={st['retries']} "
                  f"timeouts={st['timeouts']} shed={st['shed']} "
                  f"failed={st['failed']}")
        if args.slo:
            for cls, c in st.get("classes", {}).items():
                print(f"[gnn-serve] slo {cls:<12} n={c['n']:<6} "
                      f"viol={c['violations']:<6} "
                      f"burn(fast/slow)={c['burn_fast']:.2f}/"
                      f"{c['burn_slow']:.2f} p99={c['p99_ms']:.1f}ms"
                      + ("  SHED" if c["shed"] else ""))
        served_once = sum(1 for r in reqs
                          if r.n_settles == 1 and r.error is None)
        settled = sum(1 for r in reqs if r.done)
        if settled != len(reqs):
            print(f"[gnn-serve] DELIVERY VIOLATION: "
                  f"{len(reqs) - settled} request(s) never settled")
            return 1
        if chaos is not None and served_once != len(reqs):
            print(f"[gnn-serve] chaos run lost "
                  f"{len(reqs) - served_once} request(s)")
            return 1
        if not args.skip_offline:
            sub = live_replayable(reqs, server, flushes)[:32]
            if not sub:
                print("[gnn-serve] offline replay skipped (no request "
                      "settled on the live version/epoch)")
            else:
                ref = np.concatenate([server.offline_replay(r)
                                      for r in sub])
                got = np.concatenate([r.result for r in sub])
                dev = float(np.abs(got - ref).max())
                tol = parity_tol(args.backend, args.arch)
                print(f"[gnn-serve] offline replay parity max|Δ| {dev:.2e} "
                      f"({'OK' if dev <= tol else 'FAIL'}, {len(sub)} "
                      f"live-version request(s))")
                if dev > tol:
                    return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gcn", choices=list(MODELS))
    ap.add_argument("--backend", default="cuda",
                    choices=[b for b in ALL_BACKENDS if b != "distributed"])
    ap.add_argument("--sampler", default="host", choices=["host", "device"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--nodes", type=int, default=2048)
    ap.add_argument("--edges", type=int, default=8192)
    ap.add_argument("--d-in", type=int, default=32)
    ap.add_argument("--fanouts", default="5,3")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-offline", action="store_true")
    # scale-out tier — the cluster path only
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving lanes; >1 stands up the DRHM-routed "
                         "cluster tier (conv archs, host sampler)")
    ap.add_argument("--shard", action="store_true",
                    help="shard the resident feature table over the lanes "
                         "(DRHM row residency, a halo gather a round)")
    ap.add_argument("--placement", default="stacked",
                    choices=["stacked", "mesh"],
                    help="lane compute placement: one lane-stacked "
                         "dispatch a round (stacked), or each lane's step "
                         "on its own device (mesh)")
    ap.add_argument("--lane-devices", default=None, metavar="DEVS",
                    help="comma-separated device a lane for --shard / "
                         "--placement mesh (a device may repeat); default "
                         "one lane a visible card")
    ap.add_argument("--seeds-per-request", type=int, default=1)
    ap.add_argument("--telemetry-jsonl", default=None, metavar="PATH",
                    help="append per-lane telemetry samples/events as JSON "
                         "lines (the flight recorder)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; queued requests past it "
                         "fail typed (DeadlineExceeded)")
    ap.add_argument("--stall-timeout", type=float, default=1.0,
                    help="seconds of stale lane heartbeat (with queued "
                         "work) before the supervisor declares it dead")
    ap.add_argument("--restart-after", type=float, default=2.0,
                    help="seconds after a lane death before the supervisor "
                         "restarts it through a shadow warm-up")
    ap.add_argument("--shed-hwm", type=float, default=None,
                    help="total queued requests beyond which sustained "
                         "growth sheds new submissions (typed Overloaded)")
    ap.add_argument("--scale-min-lanes", type=int, default=None,
                    help="enable telemetry-driven elastic lane parking "
                         "down to this floor")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve the /metrics exposition from a background "
                         "HTTP thread on this port (0 = ephemeral)")
    ap.add_argument("--slo", action="store_true",
                    help="per-class SLO burn-rate shedding (best_effort "
                         "sheds before batch, interactive never)")
    ap.add_argument("--request-class", default="interactive",
                    choices=["interactive", "batch", "best_effort"],
                    help="request class the generated traffic carries")
    ap.add_argument("--chaos-kill-lane", type=int, default=None,
                    metavar="LANE",
                    help="chaos: kill this lane mid-stream; the run then "
                         "requires zero lost requests")
    ap.add_argument("--chaos-round", type=int, default=3,
                    help="dispatch round the --chaos-kill-lane fault "
                         "triggers at")
    ap.add_argument("--swap-versions", type=int, default=0, metavar="N",
                    help="live mutation (cluster path): hot-swap N "
                         "perturbed weight versions mid-burst through the "
                         "checkpoint store, printing the blackout and "
                         "requiring old versions to drain")
    ap.add_argument("--ckpt-dir", default=None, metavar="PATH",
                    help="checkpoint directory --swap-versions writes to "
                         "and swaps from (default: a temporary directory)")
    ap.add_argument("--mutate-edges", type=int, default=0, metavar="N",
                    help="live mutation (cluster path): stream N random "
                         "edge inserts mid-burst, each flush proven "
                         "against a cold re-pack")
    ap.add_argument("--mutation-flush-every", type=int, default=64,
                    metavar="N",
                    help="bounded-staleness window: the mutation stream "
                         "flushes every N buffered edges")
    args = ap.parse_args(argv)
    if (args.replicas > 1 or args.shard) and args.sampler != "host":
        ap.error("the cluster tier samples on the host (--sampler host)")

    device = resolve_device(args.device)
    fanouts = tuple(int(f) for f in args.fanouts.split(","))
    cfg, params, indptr, indices, store = build_world(
        args.nodes, args.edges, args.d_in, args.seed, device, args.arch)
    if args.replicas > 1 or args.shard:
        return run_cluster(args, device, fanouts, cfg, params, indptr,
                           indices, store)
    seeds = np.random.default_rng(args.seed + 2).integers(0, args.nodes,
                                                          args.requests)
    server = GNNServer(args.arch, cfg, params, indptr, indices, store,
                       fanouts=fanouts, backend=args.backend,
                       sampler=args.sampler, max_batch_seeds=args.max_batch,
                       max_wait_ms=args.max_wait_ms, n_workers=args.workers,
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
