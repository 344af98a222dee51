"""Paper Table 1 workload set: (nodes, edges, paper's bloat %) per graph
(copy of ``repro.neurasim.datasets``).

The SNAP/SuiteSparse matrices aren't bundled offline, so each is synthesized
as a power-law graph at the exact node/edge counts; the benchmark reports our
measured bloat next to the paper's (structure-dependent, so the comparison is
a sanity band, not an equality).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.data.synthetic import powerlaw_graph

# name: (node_count, edge_count, paper_bloat_percent)
TABLE1: Dict[str, Tuple[int, int, float]] = {
    "2cubes_sphere": (101492, 1647264, 205.87),
    "ca-CondMat": (23133, 186936, 75.23),
    "cit-Patents": (3774768, 16518948, 19.32),
    "email-Enron": (36692, 367662, 68.90),
    "filter3D": (106437, 2707179, 326.34),
    "mario002": (389874, 2101242, 99.43),
    "p2p-Gnutella31": (62586, 147892, 10.21),
    "poisson3Da": (13514, 352762, 297.92),
    "scircuit": (170998, 958936, 66.13),
    "web-Google": (916428, 5105039, 104.27),
    "amazon0312": (400727, 3200440, 97.21),
    "cage12": (130228, 2032536, 127.23),
    "cop20k_A": (121192, 2624331, 327.07),
    "facebook": (4039, 60050, 2872.80),
    "m133-b3": (200200, 800800, 26.93),
    "offshore": (259789, 4242673, 205.45),
    "patents_main": (240547, 560943, 14.18),
    "roadNet-CA": (1971281, 5533214, 35.75),
    "webbase-1M": (1000005, 3105536, 36.02),
    "wiki-Vote": (8297, 103689, 148.09),
}

# fast subset for CI-speed benchmarks (< ~1M nnz each)
FAST_SET = ("ca-CondMat", "email-Enron", "p2p-Gnutella31", "poisson3Da",
            "facebook", "wiki-Vote", "scircuit", "m133-b3")


def synth(name: str, seed: int = 0):
    n, e, _ = TABLE1[name]
    s, r = powerlaw_graph(n, e, alpha=2.1, seed=seed)
    return s.astype(np.int64), r.astype(np.int64), n
