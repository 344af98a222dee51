"""Fanout samplers (numpy copy of ``repro.sparse.sampler``): the
counter-based forest sampler for serving and the rng-driven
``sample_subgraph``.

Host-side data-pipeline work.  Emits fixed-shape padded subgraph tables so
each shape bucket has one static structure.  The draw for (tree, hop, lane)
is ``mix64(key ⊕ tree_key·C₁ ⊕ hop·C₂ ⊕ lane·C₃) mod deg`` — a pure
function of the tree's identity, so grouped sampling equals per-request
sampling, and the device sampler (``serve.device_sampler``) reproduces it
draw for draw.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    """Fixed-shape k-hop sampled subgraph.

    node_ids: (n_nodes_pad,) global ids of all nodes in the block (seeds
              first), padding = -1 → mapped to a ghost feature row.
    hops: per hop h, (senders_local, receivers_local, valid) index arrays of
          *static* length B·Πf — senders/receivers index into node_ids.
    n_seeds: static seed count.
    """

    node_ids: np.ndarray
    hop_senders: List[np.ndarray]
    hop_receivers: List[np.ndarray]
    hop_valid: List[np.ndarray]
    n_seeds: int


def budget(n_seeds: int, fanouts: Sequence[int]) -> List[int]:
    """Static per-hop edge budgets: [B·f1, B·f1·f2, ...]."""
    out, cur = [], n_seeds
    for f in fanouts:
        cur *= f
        out.append(cur)
    return out


def node_budget(n_seeds: int, fanouts: Sequence[int]) -> int:
    """Static node-table size: seeds + all sampled endpoints."""
    return n_seeds + sum(budget(n_seeds, fanouts))


def hop_slots(n_seeds: int, fanouts: Sequence[int]):
    """Per-hop ``(senders, receivers)`` slot arrays of the breadth-major
    tree layout — pure arithmetic in ``(n_seeds, fanouts)``, shared by
    every sampled batch of the same shape.  Receivers are the frontier
    slots repeated ``f`` times; senders are the freshly appended slots.
    """
    out = []
    base, next_base, nf = 0, n_seeds, n_seeds
    for f in fanouts:
        recv = np.repeat(base + np.arange(nf, dtype=np.int64), f)
        send = next_base + np.arange(nf * f, dtype=np.int64)
        out.append((send.astype(np.int32), recv.astype(np.int32)))
        base = next_base
        next_base += nf * f
        nf *= f
    return out


def sample_subgraph(indptr: np.ndarray, indices: np.ndarray,
                    seeds: np.ndarray, fanouts: Sequence[int],
                    rng: np.random.Generator) -> SampledSubgraph:
    """Uniform with-replacement fanout sampling from a numpy ``rng``
    (fixed shapes, padded): the reference's ``sample_subgraph``, draw for
    draw.  ``indptr``/``indices``: CSR of the (reverse) adjacency —
    ``indices[j]`` lists the in-neighbors whose messages node j
    aggregates."""
    n_seeds = seeds.shape[0]
    frontier = seeds.astype(np.int64)
    table = [seeds.astype(np.int64)]
    hop_s, hop_r, hop_v = [], [], []
    slots = hop_slots(n_seeds, fanouts)
    live = np.ones(n_seeds, bool)               # frontier-lane validity
    for f in fanouts:
        nf = frontier.shape[0]
        deg = indptr[frontier + 1] - indptr[frontier]
        has_nbr = deg > 0
        # a fanout larger than the degree repeats neighbors
        r = rng.integers(0, np.maximum(deg, 1)[:, None], size=(nf, f))
        if indices.size:
            # zero-degree nodes draw a clipped dummy index (masked below):
            # an isolated node's slice may start at the end of `indices`
            gather = np.minimum(indptr[frontier][:, None] + r,
                                indices.size - 1)
            nbr = indices[gather]
        else:                                   # edgeless graph: all invalid
            nbr = np.zeros((nf, f), dtype=np.int64)
        # valid iff the frontier node has neighbors and its lane is live
        valid = (has_nbr & live)[:, None] & np.ones((nf, f), bool)
        nbr = np.where(valid, nbr, -1)
        send, recv = slots[len(hop_s)]
        table.append(nbr.reshape(-1))
        hop_s.append(send)
        hop_r.append(recv)
        hop_v.append(valid.reshape(-1))
        frontier = np.where(valid, nbr, 0).reshape(-1)
        live = valid.reshape(-1)
    return SampledSubgraph(node_ids=np.concatenate(table), hop_senders=hop_s,
                           hop_receivers=hop_r, hop_valid=hop_v,
                           n_seeds=n_seeds)


_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)
_K_TREE = np.uint64(0xD1B54A32D192ED03)
_K_HOP = np.uint64(0x8CB92BA72F3D8DD7)
_K_LANE = np.uint64(0x2545F4914F6CDD1D)


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (uint64, wrapping)."""
    with np.errstate(over="ignore"):      # wrap-around is the hash
        z = (z + _SM_GAMMA)
        z = (z ^ (z >> np.uint64(30))) * _SM_M1
        z = (z ^ (z >> np.uint64(27))) * _SM_M2
        return z ^ (z >> np.uint64(31))


def sample_forest(indptr: np.ndarray, indices: np.ndarray,
                  seeds: np.ndarray, fanouts: Sequence[int],
                  key: int = 0,
                  tree_keys: np.ndarray = None) -> List[SampledSubgraph]:
    """Many single-seed trees, one vectorized pass, counter-based draws.

    Zero-degree frontier nodes draw a clipped dummy index and their edges
    are invalid; children of an invalid lane are invalid too.
    """
    seeds = np.atleast_1d(np.asarray(seeds, np.int64))
    n_trees = seeds.shape[0]
    fanouts = tuple(int(f) for f in fanouts)
    if tree_keys is None:
        tree_keys = np.arange(n_trees, dtype=np.uint64)
    tree_keys = np.asarray(tree_keys, np.uint64)
    key_c = _mix64(np.uint64(int(key) % (1 << 64)))

    frontier = seeds.reshape(n_trees, 1)        # (T, lanes)
    live = np.ones((n_trees, 1), bool)
    levels = [seeds.copy()]                     # stacked breadth-major
    valid_hops = []
    lanes = 1
    for h, f in enumerate(fanouts):
        deg = indptr[frontier + 1] - indptr[frontier]       # (T, lanes)
        has_nbr = deg > 0
        lane_idx = np.arange(lanes * f, dtype=np.uint64)
        with np.errstate(over="ignore"):  # wrapping counter arithmetic
            z = (key_c ^ (tree_keys[:, None] * _K_TREE)
                 ^ (np.uint64(h + 1) * _K_HOP)
                 ^ (lane_idx[None, :] * _K_LANE))
        draws = _mix64(z).reshape(n_trees, lanes, f)
        r = (draws % np.maximum(deg, 1)[:, :, None].astype(np.uint64)
             ).astype(np.int64)                              # (T, lanes, f)
        if indices.size:
            gather = np.minimum(indptr[frontier][:, :, None] + r,
                                indices.size - 1)
            nbr = indices[gather].astype(np.int64)           # (T, lanes, f)
        else:
            nbr = np.zeros((n_trees, lanes, f), np.int64)
        valid = (has_nbr & live)[:, :, None] & np.ones(
            (n_trees, lanes, f), bool)
        nbr = np.where(valid, nbr, -1)
        levels.append(nbr.reshape(-1))
        valid_hops.append(valid.reshape(n_trees, -1))
        frontier = np.where(valid, nbr, 0).reshape(n_trees, lanes * f)
        live = valid.reshape(n_trees, lanes * f)
        lanes *= f

    # split back into per-tree SampledSubgraphs; every tree's node table is
    # a row view of one stacked (T, nodes) concatenation
    tmpl = hop_slots(1, fanouts)
    tmpl_s = [s for s, _ in tmpl]
    tmpl_r = [r for _, r in tmpl]
    sizes = [1] + budget(1, fanouts)            # per-tree level sizes
    nodes_all = np.concatenate(
        [levels[lv].reshape(n_trees, s) for lv, s in enumerate(sizes)],
        axis=1)                                  # (T, nodes_per_tree)
    return [SampledSubgraph(
        node_ids=nodes_all[t], hop_senders=tmpl_s, hop_receivers=tmpl_r,
        hop_valid=[valid_hops[h][t] for h in range(len(fanouts))],
        n_seeds=1) for t in range(n_trees)]
