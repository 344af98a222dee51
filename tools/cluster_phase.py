#!/usr/bin/env python3
"""The replicated cluster tier on one GPU: ``chip_smoke.py``'s phase 18
alone.

    python3 tools/cluster_phase.py

Builds the kernel library phase 18 runs (B1/B4) and the forest sampler's
(the single-lane server of the readings counts it), then drives
``chip_smoke.phase_cluster`` on the card: the lane-stacked B1 and
lane-scaled B4 against their single-lane calls and plain versions, the
4-lane clusters serving gcn-cora (``cuda``, ``cuda_q8``) and gat-cora
(``cuda``) on the Cora-scale graph, the reseed, kill and SLO drills and the
readings, every check as the whole script makes it.  Prints the card's
name and power limit first; exits non-zero when there is no GPU or a check
fails.
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
        print("cluster_phase: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    warnings.filterwarnings("ignore", message="Sparse")   # beta CSR notes
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
    indptr, indices, _ = coo_to_csr(s, r, 2708)
    store = FeatureStore.build(2708, x, device=dev)
    t0 = time.perf_counter()
    out = c.phase_cluster(dev, params, indptr, indices, store)
    print(f"cluster_phase built {secs:.1f} s, phase 18 "
          f"{time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(out['launches'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
