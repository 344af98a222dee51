#!/usr/bin/env python3
"""Serving readings of checkouts of the port, in turns on one GPU.

    python3 tools/serving_ab.py [--host-only] ROOT [ROOT ...]

Each ROOT is a checkout of this repo (``.`` for this one).  Each runs in a
process of its own, one after another in the order given (``A B B A`` to
compare two checkouts on one card), and drives that checkout's
``chip_smoke.phase_serve``: the host-sampled ``cuda``, the device-sampled
``cuda`` and the device-sampled ``cuda_q8`` serving runs of
``chip_smoke.py``'s phases 4, 5 and 8, on gcn-cora at full width with
parameters from seed 0 and the same 256 requests.  Every check of those
phases holds.  After the card's name and power limit, each run prints one
line ``serving_ab {json}``: the root, the run, requests a second, p50/p99,
and the traced bucket-16 step (wall ms, device ms, device operations) of
the host-input body and of the device-sampled fused step.  Then, as
steadier host readings, one ``serving_ab_host {json}`` line per backend
(``cuda``, ``cuda_q8``): the host-input bucket-16 step's wall ms a step,
median and least over ``BLOCKS`` blocks of ``BLOCK_STEPS`` steps (a sync
after each block), and the host µs of one ``sparse.backend.aggregate``
call on the Cora-scale graph at D = 16, median and least over blocks of
``BLOCK_CALLS`` calls (``--host-only``: these lines alone).  Exits
non-zero when there is no GPU or any run failed.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

RUNS = (("host", "cuda"), ("device", "cuda"), ("device", "cuda_q8"))
STEP_KEYS = ("step_wall_ms", "device_ms_per_step", "device_ops_per_step")
BLOCKS, BLOCK_STEPS, BLOCK_CALLS = 30, 20, 200


def block_ms(fn, n: int) -> list:
    """Host ms per call of ``fn`` over ``BLOCKS`` blocks of ``n`` calls,
    each block ended by a device sync."""
    import time
    import torch
    out = []
    for _ in range(BLOCKS + 1):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / n)
    return out[1:]                      # the first block warms up


def host_readings(c, dev, params, indptr, indices, store, seeds, s, r, x):
    import statistics
    import torch
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.serve import GNNServer
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse.plan import make_plan
    plan = make_plan(s, r, 2708, backends=("cuda", "cuda_q8"), device=dev)
    h = torch.from_numpy(x[:, :16].copy()).to(dev)
    for backend in ("cuda", "cuda_q8"):
        with GNNServer("gcn", FULL, params, indptr, indices, store,
                       fanouts=(5, 3), backend=backend, sampler="host",
                       max_batch_seeds=16, device=dev) as server:
            server.warmup()
            step, node_ids, hop_valid = c.host_input_step(server, seeds)
            steps = block_ms(lambda: step(server.params, node_ids,
                                          hop_valid), BLOCK_STEPS)
        calls = block_ms(lambda: sb.aggregate(plan, None, h,
                                              backend=backend), BLOCK_CALLS)
        yield dict(backend=backend,
                   step_wall_ms_median=statistics.median(steps),
                   step_wall_ms_min=min(steps),
                   aggregate_host_us_median=statistics.median(calls) * 1e3,
                   aggregate_host_us_min=min(calls) * 1e3)


def child(root: pathlib.Path, host_only: bool) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serving_ab: no GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as c
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.data.synthetic import cora_like
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, forest_sampler, gustavson_spmm
    from repro_torch.models.gnn import gcn
    from repro_torch.serve import FeatureStore
    from repro_torch.sparse.graph import coo_to_csr

    dev = resolve_device("cuda")
    build.build([gustavson_spmm.LIBRARY, forest_sampler.LIBRARY,
                 forest_sampler.FOREST_LIBRARY])
    s, r, x, _, _ = cora_like(seed=0)
    params = gcn.init_params(FULL, torch.Generator().manual_seed(0),
                             device=dev)
    indptr, indices, _ = coo_to_csr(s, r, 2708)
    store = FeatureStore.build(2708, x, device=dev)
    seeds = np.random.default_rng(2).integers(0, 2708, c.N_REQUESTS)
    for mode, backend in () if host_only else RUNS:
        rec = c.phase_serve(dev, mode, params, indptr, indices, store,
                            seeds, backend=backend)
        out = dict(root=str(root), sampler=mode, backend=backend,
                   req_per_s=rec["req_per_s"], p50_ms=rec["p50_ms"],
                   p99_ms=rec["p99_ms"])
        out.update({f"body_{k}": rec[k] for k in STEP_KEYS if k in rec})
        fused = rec.get("device_step", {})
        out.update({f"fused_{k}": fused[k] for k in STEP_KEYS if k in fused})
        print("serving_ab " + json.dumps(out), flush=True)
    for rec in host_readings(c, dev, params, indptr, indices, store, seeds,
                             s, r, x):
        print("serving_ab_host " + json.dumps(dict(root=str(root), **rec)),
              flush=True)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        return child(pathlib.Path(argv[-1]).resolve(), len(argv) == 3)
    flags = [a for a in argv if a == "--host-only"]
    argv = [a for a in argv if a != "--host-only"]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    rc = 0
    for root in argv:
        rc |= subprocess.run([sys.executable, __file__, "--child", *flags,
                              root], timeout=900).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
