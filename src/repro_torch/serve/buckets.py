"""Shape buckets: static subgraph structure shared by every request (numpy
copy of ``repro.serve.buckets``).

The sampler's sender/receiver slots are pure arithmetic in ``(n_seeds,
fanouts)``, so all requests rounded into the same power-of-two seed bucket
share one static structure: one step, one host aggregation plan, zero
rebuilds after warm-up.  ``stack_trees`` splices per-request trees into the
bucket's breadth-major layout (seeds occupy slots ``0..k-1``).  GCN's
self-loop edges (``A + I``) are appended after the hop edges.

DimeNet's triplet indices come with the structure: the trees make every
sampled node's in-edges consecutive, so ``(t_in, t_out)`` are again arange
arithmetic; only ``t_valid = valid[t_in] & valid[t_out]`` depends on the
request.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.sparse import sampler


def bucket_for(n_seeds: int, max_seeds: int) -> int:
    """Smallest power-of-two bucket holding ``n_seeds`` (capped)."""
    if n_seeds <= 0:
        raise ValueError(f"n_seeds must be positive, got {n_seeds}")
    if n_seeds > max_seeds:
        raise ValueError(f"{n_seeds} seeds exceed the bucket cap {max_seeds}")
    b = 1
    while b < n_seeds:
        b *= 2
    return min(b, max_seeds)


def all_buckets(max_seeds: int) -> Tuple[int, ...]:
    """The bounded bucket ladder: 1, 2, 4, … max_seeds."""
    out, b = [], 1
    while b < max_seeds:
        out.append(b)
        b *= 2
    return tuple(out) + (max_seeds,)


@dataclasses.dataclass(frozen=True)
class BucketStructure:
    """Static structure of a ``(n_seeds, fanouts)`` bucket (host numpy)."""

    n_seeds: int
    fanouts: Tuple[int, ...]
    n_nodes: int               # node_budget(n_seeds, fanouts)
    senders: np.ndarray        # (E,) int32 — hop edges [+ self loops]
    receivers: np.ndarray      # (E,) int32
    n_hop_edges: int           # hop edges come first; loops (if any) after
    with_loops: bool
    t_in: np.ndarray           # (T,) int32 — triplet in-edge (into hop list)
    t_out: np.ndarray          # (T,) int32 — triplet out-edge

    @property
    def n_edges(self) -> int:
        return int(self.senders.shape[0])

    @property
    def n_triplets(self) -> int:
        return int(self.t_in.shape[0])


def build_bucket_structure(n_seeds: int, fanouts: Sequence[int],
                           with_loops: bool = False) -> BucketStructure:
    """Reproduce the sampler's slot arithmetic at batch size ``n_seeds``."""
    fanouts = tuple(int(f) for f in fanouts)
    if not fanouts or any(f <= 0 for f in fanouts):
        raise ValueError(f"fanouts must be positive, got {fanouts}")
    n_nodes = sampler.node_budget(n_seeds, fanouts)
    slots = sampler.hop_slots(n_seeds, fanouts)
    senders = np.concatenate([s for s, _ in slots])
    receivers = np.concatenate([r for _, r in slots])
    n_hop = senders.shape[0]
    if with_loops:
        loops = np.arange(n_nodes, dtype=np.int32)
        senders = np.concatenate([senders, loops])
        receivers = np.concatenate([receivers, loops])
    # triplets: hop-(h+1) edge (k→j) feeds hop-h edge (j→i); node j's
    # in-edges are the f_{h+2} consecutive hop-(h+1) edges of its slot
    budgets = sampler.budget(n_seeds, fanouts)
    offsets = np.concatenate([[0], np.cumsum(budgets)])
    t_in_parts, t_out_parts = [], []
    for h in range(len(fanouts) - 1):
        e_h, f_next = budgets[h], fanouts[h + 1]
        t_out_parts.append(
            offsets[h] + np.repeat(np.arange(e_h, dtype=np.int64), f_next))
        t_in_parts.append(
            offsets[h + 1] + np.arange(budgets[h + 1], dtype=np.int64))
    t_in = (np.concatenate(t_in_parts).astype(np.int32) if t_in_parts
            else np.zeros(0, np.int32))
    t_out = (np.concatenate(t_out_parts).astype(np.int32) if t_out_parts
             else np.zeros(0, np.int32))
    return BucketStructure(n_seeds=n_seeds, fanouts=fanouts, n_nodes=n_nodes,
                           senders=senders, receivers=receivers,
                           n_hop_edges=n_hop, with_loops=with_loops,
                           t_in=t_in, t_out=t_out)


def stack_trees(trees: List, n_seeds: int,
                fanouts: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Splice ``k ≤ n_seeds`` single-seed trees into the bucket layout.

    Returns ``(node_ids (n_nodes,), hop_valid (n_hop_edges,))``.  Tree
    ``t``'s level-ℓ nodes land at ``level_offset(ℓ) + t·level_size(ℓ)``;
    padding lanes get ``node_ids = -1`` and invalid edges.
    """
    fanouts = tuple(int(f) for f in fanouts)
    k = len(trees)
    if k > n_seeds:
        raise ValueError(f"{k} trees exceed bucket capacity {n_seeds}")
    tree_levels = [1] + sampler.budget(1, fanouts)      # per-tree level sizes
    node_ids = np.full(sampler.node_budget(n_seeds, fanouts), -1, np.int64)
    hop_valid = np.zeros(sum(sampler.budget(n_seeds, fanouts)), bool)
    # a bucket level block viewed as (n_seeds, size) rows is tree-major, so
    # every level lands in one 2-D assignment
    all_nodes = np.stack([t.node_ids for t in trees])   # (k, tree_nodes)
    node_off = 0
    tree_off = 0
    for size in tree_levels:
        block = node_ids[node_off:node_off + size * n_seeds]
        block.reshape(n_seeds, size)[:k] = \
            all_nodes[:, tree_off:tree_off + size]
        node_off += size * n_seeds
        tree_off += size
    edge_off = 0
    for h in range(len(fanouts)):
        size = tree_levels[h + 1]                       # edges per tree, hop h
        block = hop_valid[edge_off:edge_off + size * n_seeds]
        block.reshape(n_seeds, size)[:k] = \
            np.stack([t.hop_valid[h] for t in trees])
        edge_off += size * n_seeds
    return node_ids, hop_valid
