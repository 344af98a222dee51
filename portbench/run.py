"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic, limits,
driver and metric readers are found by name (``pbcore.spec``).  With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read under ``torch.profiler``.  The
last line of standard output is the result as one JSON object; the lines
before it say what set-up spent and what the program counted, and the last
lines of standard error give each number compared for ``correct`` beside
its limit.

Exits non-zero, printing no result, where no CUDA card (or fewer than the
cell asks for) is present, and where JAX, Flax or the JAX package ``repro``
was loaded in the process.
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

from pbcore import env  # noqa: E402  (first: it notes the start)

env.one_thread_pools()


def _finite(x):
    """JSON without NaN or infinity: a non-finite number becomes null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def result(cell, run, trace: bool, device: dict) -> dict:
    """The result line's object for ``run``."""
    from pbcore.spec import read_metrics
    metrics = read_metrics(cell, cell.per_layer if trace else cell.end_to_end,
                           run)
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed,
           "metrics": {k: v for k, v in metrics.items()
                       if math.isfinite(v["value"])},
           "device": dict(device, memory_peak_bytes=run.memory_peak_bytes)}
    if trace and run.trace is not None:
        out["device"].update(busy_s=run.trace.busy_s,
                             window_s=run.trace.window_s)
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = run.checks
    return _finite(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    env.pin_caches(ROOT)
    from pbcore.spec import load_cell
    cell = load_cell(args.workload, ROOT)
    chips = int(cell.workload["chips"])

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.reset_peak_memory_stats()
    run = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips}
    return emit(cell, run, bool(args.trace), device)


def emit(cell, run, trace: bool, device: dict) -> int:
    """Build the result (the metric readers and the trace's breakdown run
    here), then look for the JAX side as the last step before anything is
    printed: where it was loaded, exit 3 with no result."""
    line = result(cell, run, trace, device)
    notes = "notes " + json.dumps(_finite(run.notes), default=str)
    bad = env.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded in the run: {bad}", file=sys.stderr)
        return 3
    print(notes)
    for name, c in run.checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
