"""Deterministic synthetic data (numpy copy of ``repro.data.synthetic``).

Real datasets are not bundled; the generators match the statistics of the
assigned shapes — power-law degree graphs at exact node/edge counts,
molecule batches with 3-D coordinates, LM token streams and DLRM batches
over the configured vocabularies.
"""
from __future__ import annotations

from typing import Sequence, Tuple

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


def molecule_batch(batch: int, n_nodes: int = 30, n_edges: int = 64,
                   n_species: int = 9, seed: int = 0):
    """Batched small molecules: positions in a box, radius-graph-ish edges.

    Returns (species (B,N) int, pos (B,N,3) f32, senders (B,E), receivers
    (B,E), edge_valid (B,E), targets (B,) f32); within a molecule no edge
    is a self loop."""
    rng = np.random.default_rng(seed)
    species = rng.integers(1, n_species, size=(batch, n_nodes)).astype(
        np.int32)
    pos = rng.normal(scale=2.0, size=(batch, n_nodes, 3)).astype(np.float32)
    senders = rng.integers(0, n_nodes, size=(batch, n_edges)).astype(
        np.int32)
    offs = rng.integers(1, n_nodes, size=(batch, n_edges)).astype(np.int32)
    receivers = ((senders + offs) % n_nodes).astype(np.int32)
    valid = np.ones((batch, n_edges), dtype=bool)
    targets = rng.normal(size=(batch,)).astype(np.float32)
    return species, pos, senders, receivers, valid, targets


def token_batch(batch: int, seq_len: int, vocab: int, seed: int = 0):
    """(batch, seq_len) int32 token ids drawn uniformly from the
    vocabulary."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(batch, seq_len), dtype=np.int64)
    return tokens.astype(np.int32)


class TokenStream:
    """Deterministic infinite LM batch iterator (data-pipeline stand-in):
    batch i is ``token_batch(..., seed=seed + i)``."""

    def __init__(self, batch: int, seq_len: int, vocab: int, seed: int = 0):
        self.batch, self.seq_len, self.vocab = batch, seq_len, vocab
        self.seed, self.step = seed, 0

    def __iter__(self):
        return self

    def __next__(self):
        t = token_batch(self.batch, self.seq_len, self.vocab,
                        seed=self.seed + self.step)
        self.step += 1
        return t


def dlrm_batch(batch: int, n_dense: int, vocab_sizes: Sequence[int],
               multi_hot: int = 1, seed: int = 0):
    """(dense (B,13) f32, sparse ids (B, F, multi_hot) int32, labels (B,)
    f32)."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
    ids = np.stack(
        [rng.integers(0, v, size=(batch, multi_hot)) for v in vocab_sizes],
        axis=1,
    ).astype(np.int32)
    labels = (rng.random(batch) < 0.5).astype(np.float32)
    return dense, ids, labels
