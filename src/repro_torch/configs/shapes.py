"""Input shapes of the ported workloads (copy of
``repro.configs.shapes``: one shape set per architecture family).

Padded sizes are multiples of 2048, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def pad_to_multiple(x: int, m: int = 2048) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# LM shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    batch: int


LM_SHAPES = {
    "train_4k": LMShape("train_4k", "train", 4096, 256),
    "prefill_32k": LMShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": LMShape("decode_32k", "decode", 32768, 128),
    # one-token decode against a 500k cache — linear in S
    "long_500k": LMShape("long_500k", "decode", 524288, 1),
}


# ---------------------------------------------------------------------------
# GNN shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str                      # "fullgraph" | "minibatch" | "molecule"
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int
    batch: int = 1                 # molecules per batch / seed nodes
    fanout: Tuple[int, ...] = ()
    triplet_cap: int = 8           # DimeNet max triplets per edge

    @property
    def n_nodes_pad(self) -> int:
        return pad_to_multiple(self.n_nodes + 1)   # +1 ghost row

    @property
    def n_edges_pad(self) -> int:
        return pad_to_multiple(self.n_edges)


GNN_SHAPES = {
    "full_graph_sm": GNNShape("full_graph_sm", "fullgraph",
                              n_nodes=2708, n_edges=10556, d_feat=1433,
                              n_classes=7, triplet_cap=8),
    "minibatch_lg": GNNShape("minibatch_lg", "minibatch",
                             n_nodes=232965, n_edges=114615892, d_feat=602,
                             n_classes=41, batch=1024, fanout=(15, 10),
                             triplet_cap=2),
    "ogb_products": GNNShape("ogb_products", "fullgraph",
                             n_nodes=2449029, n_edges=61859140, d_feat=100,
                             n_classes=47, triplet_cap=2),
    "molecule": GNNShape("molecule", "molecule",
                         n_nodes=30, n_edges=64, d_feat=64, n_classes=4,
                         batch=128, triplet_cap=8),
}


def minibatch_node_budget(shape: GNNShape) -> int:
    n, cur = shape.batch, shape.batch
    for f in shape.fanout:
        cur *= f
        n += cur
    return n


def minibatch_edge_budget(shape: GNNShape) -> int:
    n, cur = 0, shape.batch
    for f in shape.fanout:
        cur *= f
        n += cur
    return n


# ---------------------------------------------------------------------------
# RecSys shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecSysShape:
    name: str
    kind: str            # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES = {
    "train_batch": RecSysShape("train_batch", "train", 65536),
    "serve_p99": RecSysShape("serve_p99", "serve", 512),
    "serve_bulk": RecSysShape("serve_bulk", "serve", 262144),
    "retrieval_cand": RecSysShape("retrieval_cand", "retrieval", 1,
                                  n_candidates=1_000_000),
}
