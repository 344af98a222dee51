"""Host-side directional-triplet builder for DimeNet (port of
``repro.sparse.triplets``).

For every edge e_out = (j → i) the triplets are the incoming edges e_in =
(k → j) with k ≠ i (the paper's angle set), in edge order, at most
``max_in_per_edge`` of them, so the triplet count is the static T = E · K.
The reference loops over the edges in Python; this builds the same arrays
with one vectorized pass over the (edge, candidate) pairs.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def build_triplets(senders: np.ndarray, receivers: np.ndarray,
                   max_in_per_edge: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (t_in, t_out, valid), each (E * K,): bitwise the
    reference's.

    t_in[t]  = index of edge (k → j);  t_out[t] = index of edge (j → i).
    Padding lanes have valid=False and indices 0.
    """
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    e = senders.shape[0]
    k_cap = max_in_per_edge
    t_in = np.zeros((e, k_cap), np.int32)
    t_out = np.zeros((e, k_cap), np.int32)
    valid = np.zeros((e, k_cap), bool)
    if e and k_cap:
        # incoming-edge lists per node j (edges whose receiver is j), in
        # edge order
        order = np.argsort(receivers, kind="stable")
        n = int(max(senders.max(), receivers.max())) + 1
        ptr = np.searchsorted(receivers[order], np.arange(n + 1))
        # one pair (edge eo, candidate c) per in-edge of eo's sender
        counts = (ptr[1:] - ptr[:-1])[senders]
        eo = np.repeat(np.arange(e), counts)
        start = np.repeat(np.cumsum(counts) - counts, counts)
        cand = order[ptr[senders[eo]] + np.arange(eo.size) - start]
        keep = senders[cand] != receivers[eo]          # exclude k == i
        # rank of each kept candidate among its edge's kept ones
        kept = np.concatenate([[0], np.cumsum(keep)])
        rank = kept[1:] - 1 - kept[start]
        sel = keep & (rank < k_cap)
        t_in[eo[sel], rank[sel]] = cand[sel]
        t_out[eo[sel], rank[sel]] = eo[sel]
        valid[eo[sel], rank[sel]] = True
    return t_in.reshape(-1), t_out.reshape(-1), valid.reshape(-1)
