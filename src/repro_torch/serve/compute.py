"""Compute plane: one inference step per (arch, bucket, backend).

Port of the single-device part of ``repro.serve.compute``.  Each step takes
the bucket's per-request data — ``node_ids`` (global ids, ``-1`` on padding
lanes) and ``hop_valid`` — gathers features from the resident device store
(padding lanes read the zero ghost row), re-values the bucket's static host
plan (``plan_with_values``), runs the model forward through the backend
registry, and returns the seed rows (slots ``0..n_seeds-1``).

PyTorch runs eagerly, so a "build" is the host plan packing plus the
closure; ``StepCache.builds`` still counts cache misses, and steady-state
serving must hold it constant after warm-up.

The conv family is ported: ``gcn`` (sym-normed, self loops) and the
unweighted ``sage``, ``gin`` and ``gat``, whose edge validity flows in
through ``plan_with_values``; the geometric archs raise ``KeyError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve.buckets import BucketStructure
from repro_torch.sparse.plan import make_plan, plan_with_values

PORTED_ARCHS = ("gcn", "gat", "sage", "gin")
REFERENCE_ARCHS = ("gcn", "gat", "sage", "gin", "schnet", "dimenet")


def _arch_key(arch_id: str) -> str:
    for a in REFERENCE_ARCHS:
        if arch_id == a or arch_id.startswith(a + "-"):
            if a not in PORTED_ARCHS:
                raise KeyError(f"serving arch {a!r} is not ported yet; "
                               f"ported: {PORTED_ARCHS}")
            return a
    raise KeyError(f"unservable arch {arch_id!r}; servable: "
                   f"{REFERENCE_ARCHS}")


@dataclasses.dataclass(frozen=True)
class FeatureStore:
    """Resident per-node features on one device, ghost row (zeros) last.
    Lookups use ``row_index(node_ids)`` so padding lanes (``node_id ==
    -1``) read the ghost row."""

    n_nodes: int
    x: torch.Tensor                   # (n_nodes+1, d) f32

    @staticmethod
    def build(n_nodes: int, x: np.ndarray,
              device: DeviceLike = None) -> "FeatureStore":
        dev = resolve_device(device)
        x = np.asarray(x, np.float32)
        if x.shape[0] != n_nodes:
            raise ValueError(f"x has {x.shape[0]} rows for {n_nodes} nodes")
        table = np.concatenate([x, np.zeros((1,) + x.shape[1:], x.dtype)])
        return FeatureStore(n_nodes=n_nodes,
                            x=torch.from_numpy(table).to(dev))

    @property
    def device(self) -> torch.device:
        return self.x.device

    def row_index(self, node_ids: torch.Tensor) -> torch.Tensor:
        return torch.where(node_ids >= 0, node_ids, self.n_nodes)


# ---------------------------------------------------------------------------
# Step/plan cache — bounded LRU with the rebuild counter tests assert on
# ---------------------------------------------------------------------------

class StepCache:
    """LRU over built artifacts keyed by tuple (bucket steps, bucket plans).
    ``builds`` counts cache misses — each is a host plan pack, i.e. a
    rebuild in serving terms."""

    def __init__(self, builder: Callable, maxsize: int = 16):
        self._builder = builder
        self.maxsize = maxsize
        self._cache: Dict[tuple, Callable] = {}
        self.builds = 0
        self.hits = 0

    def get(self, key: tuple):
        if key in self._cache:
            self.hits += 1
            fn = self._cache.pop(key)
            self._cache[key] = fn
            return fn
        self.builds += 1
        fn = self._builder(key)
        self._cache[key] = fn
        while len(self._cache) > self.maxsize:
            self._cache.pop(next(iter(self._cache)))
        return fn

    def info(self) -> dict:
        return {"builds": self.builds, "hits": self.hits,
                "size": len(self._cache)}


# ---------------------------------------------------------------------------
# Bucket plans — one host packing per (structure, backend, device)
# ---------------------------------------------------------------------------

def _build_bucket_plan(key: tuple):
    from repro_torch.serve.buckets import build_bucket_structure
    n_seeds, fanouts, with_loops, backend, device = key
    struct = build_bucket_structure(n_seeds, fanouts, with_loops=with_loops)
    backends = ["dense", "chunked"]
    if backend in ("cuda", "cuda_q8"):
        backends.append(backend)
    return make_plan(struct.senders, struct.receivers, struct.n_nodes,
                     backends=tuple(backends), device=device)


_BUCKET_PLANS = StepCache(_build_bucket_plan, maxsize=32)


def bucket_plan(struct: BucketStructure, backend: str,
                device: torch.device):
    """Host aggregation plan for a bucket's static edge structure on
    ``device``, all edges valid (per-request validity flows in via
    ``plan_with_values``)."""
    return _BUCKET_PLANS.get((struct.n_seeds, struct.fanouts,
                              struct.with_loops, backend, device))


# ---------------------------------------------------------------------------
# Inference steps
# ---------------------------------------------------------------------------

def build_infer_step(arch_id: str, cfg, store: FeatureStore,
                     struct: BucketStructure,
                     backend: str = "dense") -> Callable:
    """``step(params, node_ids, hop_valid) -> (n_seeds, d_out)`` for one
    bucket on the store's device.  ``node_ids``/``hop_valid`` may be numpy
    arrays or tensors; everything else (structure, plan, store) is closed
    over."""
    arch = _arch_key(arch_id)          # raises for archs not ported yet
    if arch == "gcn" and not struct.with_loops:
        raise ValueError("gcn serving needs with_loops=True structure "
                         "(A + I normalization)")
    dev = store.device
    n = struct.n_nodes
    k = struct.n_seeds
    plan0 = bucket_plan(struct, backend, dev)

    def edge_validity(node_ids, hop_valid):
        if struct.with_loops:
            return torch.cat([hop_valid, node_ids >= 0])
        return hop_valid

    if arch == "gcn":
        from repro_torch.models.gnn import gcn as m
        senders = torch.from_numpy(struct.senders.astype(np.int64)).to(dev)
        receivers = torch.from_numpy(
            struct.receivers.astype(np.int64)).to(dev)

        def weighted(ev):
            # symmetric normalization on the sampled subgraph: in-degree
            # over valid edges, self loops included
            deg = torch.zeros(n, device=dev).index_add_(
                0, receivers, ev.to(torch.float32))
            dinv = torch.rsqrt(deg.clamp_min(1.0))
            return plan_with_values(plan0,
                                    edge_weight=dinv[senders]
                                    * dinv[receivers], edge_valid=ev)
    else:
        # the unweighted conv family: one shared closure, the model module
        # is the only thing that differs (validity flows in as plan values)
        import importlib
        m = importlib.import_module(f"repro_torch.models.gnn.{arch}")

        def weighted(ev):
            return plan_with_values(plan0, edge_valid=ev)

    def step(params, node_ids, hop_valid):
        node_ids = torch.as_tensor(node_ids, device=dev)
        hop_valid = torch.as_tensor(hop_valid, device=dev)
        with torch.no_grad():
            x = store.x.index_select(0, store.row_index(node_ids))
            pl = weighted(edge_validity(node_ids, hop_valid))
            return m.forward(params, cfg, x, backend=backend, plan=pl)[:k]

    return step
