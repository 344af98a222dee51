#!/usr/bin/env python3
"""Live mutation on one GPU: ``chip_smoke.py``'s phase 19 alone.

    python3 tools/live_phase.py

Builds the kernel library phase 19 runs (B1/B4) and the forest sampler's
(the cluster counts it at 0), then drives ``chip_smoke.phase_live`` on the
card: ``DeltaGraphState`` over Cora's graph, the 4,096-node delta_repack
world and the Pubmed-scale graph, each epoch's incremental plan equal to
the cold plan on every field and B1/B4 on it bitwise the cold plan's
call; gcn-cora at full width on the mutated graph; the mutation drill
(hot swaps and a graph stream under traffic) on ``cuda`` and ``cuda_q8``
with its abort paths, feature rows and NeuraScope, every check as the
whole script makes it.  Prints the card's name and power limit first;
exits non-zero when there is no GPU or a check fails.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("live_phase: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    warnings.filterwarnings("ignore", message="Sparse")   # beta CSR notes
    import numpy as np

    import chip_smoke as c
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.data.synthetic import cora_like
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, forest_sampler, gustavson_spmm
    from repro_torch.models.gnn import gcn
    from repro_torch.serve import FeatureStore
    from repro_torch.sparse.graph import coo_to_csr
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    secs = build.build([gustavson_spmm.LIBRARY, forest_sampler.LIBRARY,
                        forest_sampler.FOREST_LIBRARY])
    dev = resolve_device("cuda")
    s, r, x, _, _ = cora_like(seed=0)
    params = gcn.init_params(FULL, torch.Generator().manual_seed(0),
                             device=dev)
    x_table = np.concatenate([x, np.zeros((1, x.shape[1]), np.float32)])
    indptr, indices, _ = coo_to_csr(s, r, 2708)
    store = FeatureStore.build(2708, x, device=dev)
    t0 = time.perf_counter()
    out = c.phase_live(dev, params, indptr, indices, store, x_table)
    print(f"live_phase built {secs:.1f} s, phase 19 "
          f"{time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(out['launches'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
