"""Input shapes of the ported workloads (the RecSys part of
``repro.configs.shapes``)."""
from __future__ import annotations

import dataclasses


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
