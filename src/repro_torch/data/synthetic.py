"""Deterministic synthetic graphs (numpy copy of ``repro.data.synthetic``).

Real datasets are not bundled; the generators match the statistics of the
assigned shapes — power-law degree graphs at exact node/edge counts.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def powerlaw_graph(n_nodes: int, n_edges: int, alpha: float = 2.1,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """COO (senders, receivers) with power-law out-degree, no self loops."""
    rng = np.random.default_rng(seed)
    # node attachment weights ~ Zipf
    w = (np.arange(1, n_nodes + 1, dtype=np.float64)) ** (-alpha / 2.0)
    w /= w.sum()
    senders = rng.choice(n_nodes, size=n_edges, p=w).astype(np.int64)
    receivers = rng.integers(0, n_nodes, size=n_edges).astype(np.int64)
    mask = senders != receivers
    senders, receivers = senders[mask], receivers[mask]
    return senders, receivers


def cora_like(seed: int = 0):
    """Shape-exact stand-in for Cora: 2708 nodes, 10556 edges, 1433 feats, 7 classes."""
    n, e, d, c = 2708, 10556, 1433, 7
    s, r = powerlaw_graph(n, e + 600, alpha=1.6, seed=seed)
    s, r = s[:e], r[:e]
    rng = np.random.default_rng(seed + 1)
    x = (rng.random((n, d)) < 0.015).astype(np.float32)   # sparse bag-of-words
    y = rng.integers(0, c, size=n).astype(np.int32)
    return s, r, x, y, c
