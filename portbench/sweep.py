"""Find a serving cell's knee: the highest offered rate the program sustains
(not run by the benchmark's own runs).

    python3 portbench/sweep.py --workload <name> --rates 1000,2000,... \
        [--seconds 8] [--seed 1]

One server is set up as the cell sets it up; then each rate runs one open
window of the cell's traffic at that rate.  A rate is sustained when the
requests of the window's last quarter wait no longer than those of its
first (no growing backlog) and every request settles.  Prints one JSON line
a rate.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from pbcore import env  # noqa: E402

env.one_thread_pools()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    env.pin_caches(ROOT)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from pbcore.spec import load_cell
    cell = load_cell(args.workload, ROOT)
    drv = cell.driver()
    cfg, dev = cell.config, torch.device("cuda")
    n = cfg["graph"]["nodes"]
    indptr, indices = drv.graph(cfg, dev)
    x, params = drv.inputs(cfg, args.seed, dev)
    server = drv.program(cfg, indptr, indices, x, params, False, 0, dev)
    server.warmup(buckets=drv.ladder(cfg, cell.traffic))
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = dict(cell.traffic, rate_per_s=rate)
        due, nodes = drv.schedule(traffic, args.seconds, args.seed, n)
        server.reset_stats()
        with drv.prompt_generator():
            off = drv.offer(server, due, nodes, args.seconds, set())
            off.settle(off.t0 + args.seconds + 30.0, server.clock)
        lat = off.latencies * 1e3
        q = len(lat) // 4
        first, last = np.median(lat[:q]), np.median(lat[-q:])
        done = off.t_done[np.isfinite(off.t_done)]
        span = done.max() - off.t0 if done.size else math.inf
        served = np.isfinite(off.t_done)
        stats = server.stats()
        print(json.dumps({
            "rate_per_s": rate, "requests": len(lat),
            "completed_per_s": int(served.sum()) / span,
            "seeds_per_s": sum(len(s) for s, ok in zip(nodes, served)
                               if ok) / span,
            "p50_ms": float(np.median(lat)),
            "p95_ms": drv.p95(lat / 1e3) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)),
            "first_quarter_p50_ms": float(first),
            "last_quarter_p50_ms": float(last),
            "sustained": bool(served.all() and last <= 2.0 * max(first, 1.0)),
            "batches": stats["n_batches"],
            "buckets": stats["bucket_counts"]}), flush=True)
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
