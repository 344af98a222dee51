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

All six GNNs serve through here.  The conv family (``gcn`` sym-normed with
self loops; the unweighted ``sage``, ``gin`` and ``gat``, whose edge
validity flows in through ``plan_with_values``) returns per-seed logits;
the geometric family (``schnet``, ``dimenet``) reads species and
positions from the store and returns per-seed atomwise energies: its
graph readout runs with ``graph_ids = arange(n)``, so the readout
degenerates to per-node outputs and the seed rows are well-defined
without a molecule boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, host_to_device, resolve_device
from repro_torch.serve.buckets import BucketStructure
from repro_torch.sparse.plan import edge_plan, make_plan, plan_with_values

CONV_ARCHS = ("gcn", "gat", "sage", "gin")
GEOM_ARCHS = ("schnet", "dimenet")
PORTED_ARCHS = CONV_ARCHS + GEOM_ARCHS


def _arch_key(arch_id: str) -> str:
    for a in PORTED_ARCHS:
        if arch_id == a or arch_id.startswith(a + "-"):
            return a
    raise KeyError(f"unservable arch {arch_id!r}; servable: "
                   f"{PORTED_ARCHS}")


@dataclasses.dataclass(frozen=True)
class FeatureStore:
    """Resident per-node features on one device, ghost row (zeros) last.

    ``x`` feeds the conv family; ``species``/``pos`` feed the geometric
    family.  Lookups use ``row_index(node_ids)`` so padding lanes
    (``node_id == -1``) read the ghost row."""

    n_nodes: int
    x: Optional[torch.Tensor] = None          # (n_nodes+1, d) f32
    species: Optional[torch.Tensor] = None    # (n_nodes+1,) int64
    pos: Optional[torch.Tensor] = None        # (n_nodes+1, 3) f32

    @staticmethod
    def build(n_nodes: int, x: Optional[np.ndarray] = None,
              device: DeviceLike = None,
              species: Optional[np.ndarray] = None,
              pos: Optional[np.ndarray] = None) -> "FeatureStore":
        dev = resolve_device(device)

        def ghost(name, a, dtype):
            if a is None:
                return None
            a = np.asarray(a, dtype)
            if a.shape[0] != n_nodes:
                raise ValueError(f"{name} has {a.shape[0]} rows for "
                                 f"{n_nodes} nodes")
            table = np.concatenate([a, np.zeros((1,) + a.shape[1:], dtype)])
            return torch.from_numpy(table).to(dev)
        if x is None and species is None and pos is None:
            raise ValueError("a feature store needs x, or species and pos")
        return FeatureStore(n_nodes=n_nodes, x=ghost("x", x, np.float32),
                            species=ghost("species", species, np.int64),
                            pos=ghost("pos", pos, np.float32))

    @property
    def device(self) -> torch.device:
        return next(t for t in (self.x, self.species, self.pos)
                    if t is not None).device

    def to(self, device: DeviceLike) -> "FeatureStore":
        """The same store with every table copied to ``device``."""
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in ("x", "species", "pos")
            if getattr(self, k) is not None})

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
    n_seeds, fanouts, with_loops, backend, need_ell, device = key
    struct = build_bucket_structure(n_seeds, fanouts, with_loops=with_loops)
    backends = ["dense", "chunked"]
    if backend in ("cuda", "cuda_q8") and need_ell:
        backends.append(backend)
    return make_plan(struct.senders, struct.receivers, struct.n_nodes,
                     backends=tuple(backends), device=device)


_BUCKET_PLANS = StepCache(_build_bucket_plan, maxsize=32)


def bucket_plan(struct: BucketStructure, backend: str, need_ell: bool,
                device: torch.device):
    """Host aggregation plan for a bucket's static edge structure on
    ``device``, all edges valid (per-request validity flows in via
    ``plan_with_values``).  ``need_ell``: the arch aggregates scalar edge
    values through ``aggregate``, which on ``cuda``/``cuda_q8`` reads the
    dedup-chunk layout; the geometric family only ``accumulate``s vector
    messages (the chunked schedule on every executor), so its plans hold
    the COO section alone."""
    return _BUCKET_PLANS.get((struct.n_seeds, struct.fanouts,
                              struct.with_loops, backend, bool(need_ell),
                              device))


def bucket_plan_cache_info() -> dict:
    """Process-wide bucket-plan cache counters (builds/hits/size)."""
    return _BUCKET_PLANS.info()


# ---------------------------------------------------------------------------
# Inference steps
# ---------------------------------------------------------------------------

def build_infer_step(arch_id: str, cfg, store: FeatureStore,
                     struct: BucketStructure,
                     backend: str = "dense") -> Callable:
    """``step(params, node_ids, hop_valid) -> (n_seeds, d_out)`` for one
    bucket on the store's device (``d_out`` = 1 for the geometric
    family's energies).  ``node_ids``/``hop_valid`` may be numpy arrays or
    tensors; everything else (structure, plans, store) is closed over."""
    arch = _arch_key(arch_id)
    if arch == "gcn" and not struct.with_loops:
        raise ValueError("gcn serving needs with_loops=True structure "
                         "(A + I normalization)")
    if arch in CONV_ARCHS and store.x is None:
        raise ValueError(f"{arch} serving needs FeatureStore.x")
    if arch in GEOM_ARCHS and (store.species is None or store.pos is None):
        raise ValueError(f"{arch} serving needs FeatureStore.species/pos")
    dev = store.device
    n = struct.n_nodes
    k = struct.n_seeds
    plan0 = bucket_plan(struct, backend, arch in CONV_ARCHS, dev)

    def edge_validity(node_ids, hop_valid):
        if struct.with_loops:
            return torch.cat([hop_valid, node_ids >= 0])
        return hop_valid

    def t(a):
        return torch.from_numpy(a.astype(np.int64)).to(dev)

    if arch == "gcn":
        from repro_torch.models.gnn import gcn as m
        senders, receivers = t(struct.senders), t(struct.receivers)

        def forward(params, node_ids, ev):
            x = store.x.index_select(0, store.row_index(node_ids))
            # symmetric normalization on the sampled subgraph: in-degree
            # over valid edges, self loops included
            deg = torch.zeros(n, device=dev).index_add_(
                0, receivers, ev.to(torch.float32))
            dinv = torch.rsqrt(deg.clamp_min(1.0))
            pl = plan_with_values(plan0, edge_weight=dinv[senders]
                                  * dinv[receivers], edge_valid=ev)
            return m.forward(params, cfg, x, backend=backend, plan=pl)[:k]
    elif arch in CONV_ARCHS:
        # the unweighted conv family: one shared closure, the model module
        # is the only thing that differs (validity flows in as plan values)
        import importlib
        m = importlib.import_module(f"repro_torch.models.gnn.{arch}")

        def forward(params, node_ids, ev):
            x = store.x.index_select(0, store.row_index(node_ids))
            pl = plan_with_values(plan0, edge_valid=ev)
            return m.forward(params, cfg, x, backend=backend, plan=pl)[:k]
    else:
        import importlib
        m = importlib.import_module(f"repro_torch.models.gnn.{arch}")
        graph_ids = torch.arange(n, device=dev)
        # dimenet's triplet plan, all triplets valid: per request only its
        # validity changes (the reference builds the same COO plan inline
        # each step; kept here, its sums' orders are built once)
        t_in, t_out = t(struct.t_in), t(struct.t_out)
        pt0 = edge_plan(t_in, t_out, struct.n_edges)

        def forward(params, node_ids, ev):
            idx = store.row_index(node_ids)
            species = store.species.index_select(0, idx)
            pos = store.pos.index_select(0, idx)
            pl = plan_with_values(plan0, edge_valid=ev)
            if arch == "schnet":
                e = m.forward(params, cfg, species, pos, graph_ids=graph_ids,
                              n_graphs=n, backend=backend, plan=pl)
            else:
                tv = ev.index_select(0, t_in) & ev.index_select(0, t_out)
                e = m.forward(params, cfg, species, pos,
                              graph_ids=graph_ids, n_graphs=n,
                              backend=backend, plan=pl,
                              triplet_plan=plan_with_values(pt0,
                                                            edge_valid=tv))
            return e[:k, None]

    def step(params, node_ids, hop_valid):
        node_ids = host_to_device(node_ids, dev)
        hop_valid = host_to_device(hop_valid, dev)
        with torch.no_grad():
            return forward(params, node_ids,
                           edge_validity(node_ids, hop_valid))

    return step
