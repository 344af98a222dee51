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

The cluster tier's lane step (``build_lane_infer_step``) runs one round
of ``L`` lanes as ONE model forward over a block-diagonal stack of the
bucket plan (``bucket_plan`` with ``n_lanes``): one B1 (``cuda``) or B4
(``cuda_q8``) launch a layer for all lanes; with ``placement="mesh"``
each lane runs on a device of its own, at its place in that stack.

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
import threading
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
        # a cluster's engine thread and its monitor (a lane's shadow
        # warm-up) may ask at once
        self._lock = threading.RLock()

    def get(self, key: tuple):
        with self._lock:
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

def lane_rows_for(n_nodes: int, n_lanes: int, block_rows: int = 8) -> int:
    """Rows a lane takes in a stack of ``n_lanes``: its ``n_nodes`` rounded
    up to whole output blocks, so every block (and every chunk of the
    dedup layout) lies in one lane; one lane takes ``n_nodes``."""
    if n_lanes == 1:
        return n_nodes
    return -(-n_nodes // block_rows) * block_rows


def _build_bucket_plan(key: tuple):
    from repro_torch.serve.buckets import build_bucket_structure
    n_seeds, fanouts, with_loops, backend, need_ell, n_lanes, device = key
    struct = build_bucket_structure(n_seeds, fanouts, with_loops=with_loops)
    backends = ["dense", "chunked"]
    if backend in ("cuda", "cuda_q8") and need_ell:
        backends.append(backend)
    rows = lane_rows_for(struct.n_nodes, n_lanes)
    off = np.repeat(np.arange(n_lanes, dtype=np.int64) * rows,
                    struct.n_edges)
    return make_plan(np.tile(struct.senders, n_lanes) + off,
                     np.tile(struct.receivers, n_lanes) + off,
                     n_lanes * rows, backends=tuple(backends),
                     lanes=n_lanes, lane_rows=rows,
                     lane_nodes=struct.n_nodes, device=device)


_BUCKET_PLANS = StepCache(_build_bucket_plan, maxsize=64)


def bucket_plan(struct: BucketStructure, backend: str, need_ell: bool,
                device: torch.device, n_lanes: int = 1):
    """Host aggregation plan for a bucket's static edge structure on
    ``device``, all edges valid (per-request validity flows in via
    ``plan_with_values``).  ``need_ell``: the arch aggregates scalar edge
    values through ``aggregate``, which on ``cuda``/``cuda_q8`` reads the
    dedup-chunk layout; the geometric family only ``accumulate``s vector
    messages (the chunked schedule on every executor), so its plans hold
    the COO section alone.

    ``n_lanes`` > 1 stacks the bucket block-diagonally for a cluster
    round: lane l's nodes sit at rows ``[l·lane_rows, l·lane_rows + n)``
    (``lane_rows_for``), its edges are the bucket's shifted by
    ``l·lane_rows``, edge order lane by lane.  With the lanes aligned to
    whole output blocks, each lane's dedup chunks are the single-lane
    plan's, shifted, so each lane's aggregation is the single-lane plan's
    bit for bit (and int8 quantizes lane by lane, with the plan's
    ``lanes``).  One cache for every lane count, keyed by it."""
    return _BUCKET_PLANS.get((struct.n_seeds, struct.fanouts,
                              struct.with_loops, backend, bool(need_ell),
                              int(n_lanes), device))


def bucket_plan_cache_info() -> dict:
    """Process-wide bucket-plan cache counters (builds/hits/size)."""
    return _BUCKET_PLANS.info()


def dispatch_annotation(label: str):
    """Opt-in ``torch.profiler`` annotation around a lane dispatch: a
    context manager that names the dispatch window in a profiler trace.
    Never on by default: the annotation itself costs a record per
    round."""
    return torch.profiler.record_function(label)


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
    if arch in CONV_ARCHS and store.x is None:
        raise ValueError(f"{arch} serving needs FeatureStore.x")
    if arch in GEOM_ARCHS and (store.species is None or store.pos is None):
        raise ValueError(f"{arch} serving needs FeatureStore.species/pos")
    dev = store.device
    n = struct.n_nodes
    k = struct.n_seeds

    if arch in CONV_ARCHS:
        # one lane of the cluster's round: fetch, then the lane body
        body = _lane_body(arch_id, cfg, struct, backend)
        fetch = build_fetch_step(store)

        def step(params, node_ids, hop_valid):
            node_ids = host_to_device(node_ids, dev)[None]
            hop_valid = host_to_device(hop_valid, dev)[None]
            return body(params, fetch(node_ids), node_ids, hop_valid)[0]
        return step

    plan0 = bucket_plan(struct, backend, False, dev)

    def edge_validity(node_ids, hop_valid):
        if struct.with_loops:
            return torch.cat([hop_valid, node_ids >= 0])
        return hop_valid

    def t(a):
        return torch.from_numpy(a.astype(np.int64)).to(dev)

    # the geometric family
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


# ---------------------------------------------------------------------------
# Cluster steps — lane-stacked variants for the scale-out tier
# ---------------------------------------------------------------------------
#
# The cluster splits feature *fetch* from the model *step*: the fetch
# gathers every lane's rows off the resident table, the step runs the
# lanes' round.  The reference maps one lane's body over the lanes
# (``jax.vmap``) into one dispatch; the port's kernels take no batch axis,
# so a round is one forward over the block-diagonal stack of the lanes'
# bucket plans instead, which launches each aggregation kernel once for
# all lanes.

def _lane_body(arch_id: str, cfg, struct: BucketStructure,
               backend: str) -> Callable:
    """``body(params, x, node_ids, hop_valid) -> (L, k, d_out)`` — one
    round of ``L`` lanes with features already fetched: ``x (L, n, d)``,
    ``node_ids (L, n)``, ``hop_valid (L, E)`` (numpy or tensors).  Conv
    family only: the geometric family's species/pos stores stay
    single-lane, as in the reference."""
    arch = _arch_key(arch_id)
    if arch not in CONV_ARCHS:
        raise ValueError(f"cluster serving covers the conv family "
                         f"{CONV_ARCHS}; {arch!r} is single-device only")
    if arch == "gcn" and not struct.with_loops:
        raise ValueError("gcn serving needs with_loops=True structure "
                         "(A + I normalization)")
    import importlib
    m = importlib.import_module(f"repro_torch.models.gnn.{arch}")
    n = struct.n_nodes
    k = struct.n_seeds

    def body(params, x, node_ids, hop_valid):
        dev = x.device
        node_ids = host_to_device(node_ids, dev)
        hop_valid = host_to_device(hop_valid, dev)
        n_lanes = node_ids.shape[0]
        plan0 = bucket_plan(struct, backend, True, dev, n_lanes)
        rows = plan0.lane_rows or n
        if struct.with_loops:
            ev = torch.cat([hop_valid, node_ids >= 0], dim=1)
        else:
            ev = hop_valid
        ev = ev.reshape(-1)
        if rows != n:               # each lane padded to whole blocks
            x = torch.nn.functional.pad(x, (0, 0, 0, rows - n))
        xs = x.reshape(n_lanes * rows, x.shape[-1])
        with torch.no_grad():
            if arch == "gcn":
                # symmetric normalization on each lane's sampled subgraph:
                # in-degree over valid edges, self loops included
                deg = torch.zeros(n_lanes * rows, device=dev).index_add_(
                    0, plan0.rows, ev.to(torch.float32))
                dinv = torch.rsqrt(deg.clamp_min(1.0))
                pl = plan_with_values(
                    plan0, edge_weight=dinv[plan0.cols] * dinv[plan0.rows],
                    edge_valid=ev)
            else:
                pl = plan_with_values(plan0, edge_valid=ev)
            out = m.forward(params, cfg, xs, backend=backend, plan=pl)
        return out.reshape(n_lanes, rows, -1)[:, :k]

    return body


def build_lane_infer_step(arch_id: str, cfg, struct: BucketStructure,
                          backend: str = "dense", *,
                          placement: str = "stacked",
                          devices=None, out_device=None) -> Callable:
    """``step(params, x, node_ids, hop_valid) -> (L, k, d_out)`` over
    lane-stacked inputs ``x (L, n, d)`` / ``node_ids (L, n)`` /
    ``hop_valid (L, E)``.

    ``placement="stacked"`` runs the lanes as ONE forward over the
    block-diagonal stack of their bucket plans (``bucket_plan`` with
    ``n_lanes``, built on first use per lane count) on ``x``'s device:
    per-dispatch overhead is paid once per round, not once per lane.

    ``placement="mesh"`` runs lane i's step on ``devices[i]`` (one lane a
    device, the reference's ``shard_map`` over a ``('lane',)`` mesh): lane
    i's features (``x[i]``, or the i-th tensor of a list that the sharded
    residency's halo left on each lane's device) and inputs go to its
    device, and the parameters are copied there once a parameter set.  A
    lane computes at its place in the round's stacked shapes, the other
    lanes' rows empty (``-1`` ids, no valid edge, zero features), on the
    stacked plan: each operation then runs the kernel the stacked round
    runs (a GEMM's algorithm depends on its shape, and on the card a
    smaller one sums in another order), and lanes never mix, so lane i's
    rows come out bitwise the stacked round's.  The price is the round's
    stacked work on every lane's device.  The lanes' outputs come back to
    ``out_device`` (``devices[0]`` by default)."""
    body = _lane_body(arch_id, cfg, struct, backend)
    if placement == "stacked":
        return body
    if placement != "mesh":
        raise ValueError(f"unknown placement {placement!r}; "
                         "have ('stacked', 'mesh')")
    if not devices:
        raise ValueError("placement='mesh' needs the lanes' devices")
    devices = [torch.device(d) for d in devices]
    out_device = torch.device(out_device or devices[0])
    copies: Dict[torch.device, tuple] = {}

    def params_on(params, dev):
        got = copies.get(dev)
        if got is None or got[0] is not params:
            from repro_torch import tree
            got = copies[dev] = (params, tree.map_leaves(
                lambda t: t.to(dev), params))
        return got[1]

    def step(params, x, node_ids, hop_valid):
        node_ids = torch.as_tensor(node_ids)
        hop_valid = torch.as_tensor(hop_valid)
        n_lanes = len(devices)
        outs = []
        for lane, dev in enumerate(devices):
            xl = x[lane].to(dev, non_blocking=True)
            xs = xl.new_zeros((n_lanes,) + tuple(xl.shape))
            xs[lane] = xl
            ids = torch.full_like(node_ids, -1)
            ids[lane] = node_ids[lane]
            hv = torch.zeros_like(hop_valid)
            hv[lane] = hop_valid[lane]
            outs.append(body(params_on(params, dev), xs, ids,
                             hv)[lane:lane + 1])
        return torch.cat([o.to(out_device) for o in outs])
    return step


def build_fetch_step(store: FeatureStore) -> Callable:
    """Replicated-residency feature fetch: ``(node_ids (L, n)) -> x (L, n,
    d)`` straight off the resident table on the store's device (ghost row
    for padding lanes).  The sharded-residency counterpart is
    ``core.distributed.LaneHalo`` — the same rows, another transport,
    bitwise the same batch."""
    dev = store.device

    def fetch(node_ids):
        node_ids = host_to_device(node_ids, dev)
        rows = store.row_index(node_ids).reshape(-1)
        return store.x.index_select(0, rows).reshape(
            node_ids.shape + (store.x.shape[1],))
    return fetch
