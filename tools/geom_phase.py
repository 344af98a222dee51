#!/usr/bin/env python3
"""SchNet and DimeNet on one GPU: ``chip_smoke.py``'s phase 16 alone.

    python3 tools/geom_phase.py            # serving and training, checked
    python3 tools/geom_phase.py --trace    # + DimeNet's costliest kernels

Builds the four kernel libraries phase 16 runs (B1/B4, B3's two, B2/B5)
and drives ``chip_smoke.phase_geom_serve`` and ``phase_geom_train`` on the
card: every check of the phase holds, and its ``serve``/``geom train``
lines are printed as the whole script prints them.  ``--trace`` then
traces one warm DimeNet training step on ``dense`` and on ``chunked``
(``chip_smoke.trace_steps`` over 5 steps) and prints its 25 costliest
device kernels.  Prints the card's name and power limit first; exits
non-zero when there is no GPU or a check fails.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("geom_phase: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as c
    from repro_torch.device import resolve_device
    from repro_torch.kernels import (build, forest_sampler, gustavson_spmm,
                                     spgemm_pad)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    secs = build.build([gustavson_spmm.LIBRARY, forest_sampler.LIBRARY,
                        forest_sampler.FOREST_LIBRARY, spgemm_pad.LIBRARY])
    dev = resolve_device("cuda")
    seeds = np.random.default_rng(2).integers(0, 2708, c.N_REQUESTS)
    t0 = time.perf_counter()
    c.phase_geom_serve(dev, seeds)
    t1 = time.perf_counter()
    geom = c.phase_geom_train(dev)
    t2 = time.perf_counter()
    print(f"geom_phase built {secs:.1f} s, served {t1 - t0:.1f} s, trained "
          f"{t2 - t1:.1f} s; launches {json.dumps(geom['launches'])}")
    if "--trace" in argv:
        from repro_torch.optim import adamw
        for backend in ("dense", "chunked"):
            params, step, batches = c.geom_setup("dimenet", dev, backend)
            opt, batch = adamw.init_state(params), next(batches)
            rec = c.trace_steps(
                lambda: float(step(params, opt, batch)[2]["loss"]), 5,
                "segment_reduce", top=25)
            print(f"geom_phase trace dimenet {backend} {json.dumps(rec)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
