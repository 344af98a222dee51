"""Host-side aggregation plans — one layout precomputation per graph.

Port of ``repro.sparse.plan``.  For a fixed graph the plan precomputes,
once, every layout the backend registry (``repro_torch.sparse.backend``)
dispatches to, as tensors on one device:

* padded COO (``rows``/``cols``/``base_vals``/``valid``) — the ``dense``
  and ``chunked`` executors;
* the operand-deduplicated chunk layout (``ell_*``, via
  ``pack_dedup_chunks``) — the ``cuda`` Gustavson kernel — and its
  transpose (``ell_t_*``), packed exactly as the reference packs them, for
  the backward of training (dX = Aᵀ·dY).  ``ell_block_ptr`` and
  ``ell_t_block_ptr`` hold each output block's chunk range, which the
  CUDA kernel walks.  Per-edge ``ell_slots``/``ell_t_slots`` let edge
  values be scatter-added into the coefficient tiles on device, in a fixed
  order where two edges share a cell (``scatter_order``);
* the forward tiles quantized to int8 with one scale per chunk
  (``ell_a_q8``/``ell_a_scale``, ``sparse.quantize``) — the ``cuda_q8``
  kernel's operands, baked when ``backends`` names ``cuda_q8``;
* the DRHM shard section (``dist_*``, via ``core.distributed.
  plan_distributed_spmm``) — the ``distributed`` executor over the
  plan's ``mesh`` (a ``DeviceMesh`` with a ``data`` axis), with scatter
  slots for per-edge values.

``plan_feature_sharding`` is the serving cluster's sharded residency: a
DRHM row permutation of a resident feature table over its lanes.

``plan_from_graph`` builds a plan for a padded ``Graph``;
``cached_plan_from_graph`` keeps the last few behind an LRU keyed on the
graph's tensor identity.

Conventions as in the reference: ``rows`` are receivers, ``cols`` senders;
``n_rows`` is the padded node count including the ghost row; padding edges
carry ``valid == False`` and contribute nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

ALL_BACKENDS = ("dense", "chunked", "cuda", "cuda_q8", "distributed")


class BackendPlanError(ValueError):
    """A backend was asked to run on a plan missing its layout section."""


@dataclasses.dataclass(frozen=True)
class AggregationPlan:
    """Precomputed per-graph layouts for every registered executor."""

    n_rows: int                      # padded node count incl. ghost row
    chunk: int = 8192                # rolling-eviction wave size
    block_rows: int = 8              # output-block rows (cuda layout)
    n_blocks: int = 0                # forward output blocks
    n_t_blocks: int = 0              # transpose output blocks
    ell_d_tile: Optional[int] = None  # int8 feature scale tile (None → auto)
    # serving lanes stacked block-diagonally (``serve.compute.bucket_plan``
    # with ``n_lanes``): lane l owns rows [l·lane_rows, (l+1)·lane_rows),
    # its nodes the first ``lane_nodes`` of them, and no edge crosses
    # lanes.  ``cuda_q8`` quantizes x lane by lane (one row of feature
    # scales a lane).  Defaults: one lane over every row.
    lanes: int = 1
    lane_rows: Optional[int] = None   # None → n_rows
    lane_nodes: Optional[int] = None  # None → lane_rows
    n_shards: int = 0
    rows_per_shard: int = 0
    edges_per_shard: int = 0
    mesh: Optional[object] = None     # DeviceMesh for `distributed`

    # --- COO section (always present) ---
    rows: Optional[torch.Tensor] = None       # (E,) int64 — receivers
    cols: Optional[torch.Tensor] = None       # (E,) int64 — senders
    valid: Optional[torch.Tensor] = None      # (E,) bool
    base_vals: Optional[torch.Tensor] = None  # (E,) f32 — weight·valid

    # --- dedup-chunk section (`cuda`; see graph.pack_dedup_chunks) ---
    ell_u_cols: Optional[torch.Tensor] = None     # (n_chunks, width) int32
    ell_remaining: Optional[torch.Tensor] = None  # (n_chunks,) int32
    ell_out_block: Optional[torch.Tensor] = None  # (n_chunks,) int32
    ell_first: Optional[torch.Tensor] = None      # (n_chunks,) int32
    ell_a: Optional[torch.Tensor] = None          # (n_chunks·BR, width) f32
    ell_slots: Optional[torch.Tensor] = None      # (E,) int64; OOB ⇒ dropped
    ell_block_ptr: Optional[torch.Tensor] = None  # (n_blocks+1,) int32
    # transpose mirror — the backward's layout (dX = Aᵀ·dY through B1)
    ell_t_u_cols: Optional[torch.Tensor] = None
    ell_t_remaining: Optional[torch.Tensor] = None
    ell_t_out_block: Optional[torch.Tensor] = None
    ell_t_first: Optional[torch.Tensor] = None
    ell_t_a: Optional[torch.Tensor] = None
    ell_t_slots: Optional[torch.Tensor] = None
    ell_t_block_ptr: Optional[torch.Tensor] = None  # (n_t_blocks+1,) int32
    # the order of the tile scatters where valid edges share a cell
    # (``scatter_order``; all None where every valid edge has its own)
    ell_first_slots: Optional[torch.Tensor] = None  # (E,) int64
    ell_dup_edges: Optional[torch.Tensor] = None    # (M,) int64
    ell_dup_slots: Optional[torch.Tensor] = None    # (M,) int64
    ell_dup_bounds: tuple = ()                      # layer ends in dup_*
    ell_t_first_slots: Optional[torch.Tensor] = None
    ell_t_dup_edges: Optional[torch.Tensor] = None
    ell_t_dup_slots: Optional[torch.Tensor] = None
    ell_t_dup_bounds: tuple = ()
    # int8 forward tiles (`cuda_q8`): per-chunk symmetric scales, baked at
    # plan time from the f32 tiles and re-quantized by plan_with_values
    ell_a_q8: Optional[torch.Tensor] = None       # (n_chunks·BR, width) int8
    ell_a_scale: Optional[torch.Tensor] = None    # (n_chunks,) f32
    # --- DRHM shard section (`distributed`) ---
    dist_rows_local: Optional[torch.Tensor] = None  # (S·e_per,) int64
    dist_cols_perm: Optional[torch.Tensor] = None   # (S·e_per,) int64
    dist_vals: Optional[torch.Tensor] = None        # (S·e_per,) f32
    dist_slots: Optional[torch.Tensor] = None       # (E,) int64; OOB: dropped
    dist_perm: Optional[torch.Tensor] = None        # (n_pad,) row → slot
    dist_inv_perm: Optional[torch.Tensor] = None    # (n_pad,) slot → row
    # the SegmentOrders of ``rows``/``cols`` (``order``), built on first
    # use and keyed by the id tensor: plans re-valued by
    # ``plan_with_values`` (same rows and cols) share them
    orders: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def has(self, section: str) -> bool:
        if section == "ell":
            return self.ell_u_cols is not None
        if section == "dist":
            return self.dist_rows_local is not None and self.mesh is not None
        return self.rows is not None

    def require(self, section: str, backend: str) -> None:
        if not self.has(section):
            raise BackendPlanError(
                f"backend {backend!r} needs the {section!r} plan section; "
                f"build the plan with make_plan(..., backends=({backend!r},"
                f" ...)) — inline edge_plan() covers only dense/chunked")

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @property
    def dist_n_pad(self) -> int:
        return self.n_shards * self.rows_per_shard

    def order(self, axis: str, lo: int = 0, hi: Optional[int] = None):
        """The ``segment_ops.SegmentOrder`` of ``rows`` or ``cols`` (edges
        ``lo:hi``) over the plan's ``n_rows`` rows: built with one sort on
        the plan's device the first time it is asked for, then kept, so
        the ``dense``/``chunked`` executors and GAT's score stage add in a
        fixed order without a sort per call."""
        ids = getattr(self, axis)
        key = (axis, lo, hi, self.n_rows, id(ids))
        got = self.orders.get(key)
        if got is None or got[0] is not ids:
            from repro_torch.sparse.segment_ops import segment_order
            got = self.orders[key] = (ids, segment_order(ids[lo:hi],
                                                         self.n_rows))
        return got[1]


def block_ptr_from_first(first: np.ndarray, n_blocks: int) -> np.ndarray:
    """Per-output-block chunk offsets ``(n_blocks+1,)`` from the ``first``
    flags: every block owns ≥ 1 consecutive chunk, the first one flagged."""
    starts = np.flatnonzero(np.asarray(first))
    if starts.size != n_blocks:
        raise ValueError(f"{starts.size} first-chunk flags for {n_blocks} "
                         "output blocks")
    return np.append(starts, first.shape[0]).astype(np.int32)


def scatter_order(slots: np.ndarray, n_cells: int):
    """The fixed order in which edge values that share a tile cell add up.

    ``slots`` maps each edge to its cell (``n_cells``: dropped).  Returns
    ``None`` when no two live slots share a cell: one ``index_add_`` then
    adds each value once onto zero, exact in any order.  Otherwise the
    edges split into layers by their occurrence rank among their cell's
    edges, in edge order: ``first`` (every edge's slot, later occurrences
    sent to the dropped cell) holds layer 0, and layers 1, 2, … are the
    slices ``edges[bounds[k-1]:bounds[k]]`` with their slots ``cells``.
    No two slots of a layer share a cell, so the layers added one after
    another give every cell ``((0 + v₁) + v₂) + …`` in edge order — the
    sequential scatter's bits, on any device."""
    slots = np.asarray(slots, np.int64)
    live = np.flatnonzero(slots < n_cells)
    order = live[np.argsort(slots[live], kind="stable")]
    cell = slots[order]
    new = np.r_[True, cell[1:] != cell[:-1]]
    pos = np.arange(cell.size)
    rank = pos - np.maximum.accumulate(np.where(new, pos, 0))
    if not rank.any():
        return None
    later = rank > 0
    first = slots.copy()
    first[order[later]] = n_cells
    o = np.lexsort((order[later], rank[later]))
    edges = order[later][o]
    bounds = np.cumsum(np.bincount(rank[later][o] - 1))
    return first, edges, slots[edges], tuple(int(b) for b in bounds)


def _values(valid: torch.Tensor, edge_weight) -> torch.Tensor:
    if edge_weight is None:
        return valid.to(torch.float32)
    w = torch.as_tensor(edge_weight, device=valid.device)
    return torch.where(valid, w, 0.0).to(torch.float32)


def edge_plan(senders, receivers, n_rows: int, edge_weight=None,
              edge_valid=None, chunk: int = 8192) -> AggregationPlan:
    """COO-only plan built from edge tensors on their own device — what
    models build inline when no host plan was given.  Supports the
    ``dense`` and ``chunked`` executors."""
    senders = torch.as_tensor(senders)
    receivers = torch.as_tensor(receivers, device=senders.device)
    valid = (torch.ones(senders.shape, dtype=torch.bool,
                        device=senders.device) if edge_valid is None
             else torch.as_tensor(edge_valid, device=senders.device))
    return AggregationPlan(n_rows=int(n_rows), chunk=chunk,
                           rows=receivers.to(torch.int64),
                           cols=senders.to(torch.int64), valid=valid,
                           base_vals=_values(valid, edge_weight))


def ell_sections(fwd, tr, n_edges: int, vidx: np.ndarray,
                 backends: Sequence[str], d_tile: Optional[int],
                 dev: torch.device) -> dict:
    """The plan's dedup-chunk fields from the packed forward and transpose
    layouts (``graph.DedupChunks`` over the valid edges ``vidx`` of
    ``n_edges``), on ``dev``: the chunk tables, each output block's chunk
    range, the per-edge slots (the dropped cell for invalid edges), the
    order of the tile scatters and, when ``backends`` names ``cuda_q8``,
    the baked int8 forward tiles.  ``make_plan`` and the incremental
    ``sparse.delta.DeltaGraphState.plan`` both build them here."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    kw = dict(block_rows=fwd.block_rows, n_blocks=fwd.n_blocks,
              n_t_blocks=tr.n_blocks, ell_d_tile=d_tile,
              ell_block_ptr=t(block_ptr_from_first(fwd.first, fwd.n_blocks)),
              ell_t_block_ptr=t(block_ptr_from_first(tr.first,
                                                     tr.n_blocks)))
    for pre, ch in (("ell_", fwd), ("ell_t_", tr)):
        slots = np.full(n_edges, ch.a.size, np.int64)
        slots[vidx] = ch.slots
        kw.update({pre + "u_cols": t(ch.u_cols),
                   pre + "remaining": t(ch.remaining),
                   pre + "out_block": t(ch.out_block),
                   pre + "first": t(ch.first),
                   pre + "a": t(ch.a),
                   pre + "slots": t(slots)})
        dup = scatter_order(slots, ch.a.size)
        if dup is not None:
            kw.update({pre + "first_slots": t(dup[0]),
                       pre + "dup_edges": t(dup[1]),
                       pre + "dup_slots": t(dup[2]),
                       pre + "dup_bounds": dup[3]})
    if "cuda_q8" in backends:
        # bake the int8 tiles for the default-values path; given edge
        # values re-quantize (plan_with_values / the executor)
        from repro_torch.sparse.quantize import (quantize_chunk_tiles,
                                                 record_q8_stats)
        a_q8, a_scale = quantize_chunk_tiles(kw["ell_a"],
                                             fwd.u_cols.shape[0])
        record_q8_stats(a_scale)
        kw.update(ell_a_q8=a_q8, ell_a_scale=a_scale)
    return kw


def make_plan(senders: np.ndarray, receivers: np.ndarray, n_rows: int,
              edge_weight: Optional[np.ndarray] = None,
              edge_valid: Optional[np.ndarray] = None, *,
              backends: Sequence[str] = ("dense", "chunked"),
              chunk: int = 8192, block_rows: int = 8, width_cap: int = 128,
              width_multiple: int = 16, d_tile: Optional[int] = None,
              lanes: int = 1, lane_rows: Optional[int] = None,
              lane_nodes: Optional[int] = None, mesh=None,
              device: DeviceLike = None) -> AggregationPlan:
    """Host-side plan: precompute every layout in ``backends`` once and
    place it on ``device`` (default ``cuda``).

    Only valid edges enter the dedup-chunk layouts; invalid (padding)
    edges get an out-of-bounds scatter slot, so values on padding lanes are
    dropped by construction.  ``d_tile`` is the int8 feature scale tile
    of ``cuda_q8`` (``None``: ``auto_d_tile(D)`` per call).  ``lanes`` >
    1 declares a block-diagonal stack of serving lanes (the plan's
    ``lanes``/``lane_rows``/``lane_nodes``): ``n_rows`` must be ``lanes ·
    lane_rows``, ``lane_rows`` a multiple of ``block_rows`` (so every
    output block lies in one lane) and no edge may cross lanes.

    ``distributed`` shards the valid edges over the ``data`` axis of
    ``mesh`` (default: a one-axis mesh over every rank of the initialized
    process group; without one it raises).
    """
    for b in backends:
        if b not in ALL_BACKENDS:
            raise KeyError(f"unknown backend {b!r}; have {ALL_BACKENDS}")
    dev = resolve_device(device)
    s = np.asarray(senders, np.int32)
    r = np.asarray(receivers, np.int32)
    if lanes > 1:
        lane_rows = int(lane_rows)
        lane_nodes = lane_rows if lane_nodes is None else int(lane_nodes)
        if (lanes * lane_rows != int(n_rows) or lane_rows % block_rows
                or not 0 < lane_nodes <= lane_rows):
            raise ValueError(
                f"{lanes} lanes of {lane_rows} rows ({lane_nodes} nodes "
                f"each) do not tile {n_rows} rows in blocks of "
                f"{block_rows}")
        if (s.astype(np.int64) // lane_rows
                != r.astype(np.int64) // lane_rows).any():
            raise ValueError("an edge crosses serving lanes")
    e = s.shape[0]
    valid = (np.ones(e, bool) if edge_valid is None
             else np.asarray(edge_valid, bool))
    w = (np.ones(e, np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32))
    base = np.where(valid, w, 0.0).astype(np.float32)
    vidx = np.nonzero(valid)[0]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    kw = dict(n_rows=int(n_rows), chunk=chunk,
              rows=t(r.astype(np.int64)), cols=t(s.astype(np.int64)),
              valid=t(valid), base_vals=t(base))
    if lanes > 1:
        kw.update(lanes=int(lanes), lane_rows=lane_rows,
                  lane_nodes=lane_nodes)

    if "cuda" in backends or "cuda_q8" in backends:
        from repro_torch.sparse.graph import pack_dedup_chunks
        from repro_torch.sparse.stats import record_count, record_value
        pack_kw = dict(block_rows=block_rows, width_cap=width_cap,
                       width_multiple=width_multiple)
        # forward (A) and transpose (Aᵀ): the matrix is square over the
        # padded node space, so the transpose is the same packer with the
        # sender/receiver roles swapped
        fwd = pack_dedup_chunks(r[vidx], s[vidx], base[vidx], int(n_rows),
                                int(n_rows), **pack_kw)
        tr = pack_dedup_chunks(s[vidx], r[vidx], base[vidx], int(n_rows),
                               int(n_rows), **pack_kw)
        record_count("plan.dedup_packs", 2)
        record_value("plan.chunk_width", fwd.u_cols.shape[1])
        record_value("plan.n_chunks", fwd.u_cols.shape[0])
        record_value("plan.hub_splits",
                     int(fwd.u_cols.shape[0] - np.unique(fwd.out_block).size))
        kw.update(ell_sections(fwd, tr, e, vidx, backends, d_tile, dev))

    if "distributed" in backends:
        from repro_torch.core.distributed import plan_distributed_spmm
        if mesh is None:
            mesh = _world_data_mesh()
        n_shards = int(mesh.size(list(mesh.mesh_dim_names).index("data")))
        dp = plan_distributed_spmm(r[vidx], s[vidx], base[vidx], int(n_rows),
                                   n_shards=n_shards)
        slots = np.full(e, dp.n_shards * dp.edges_per_shard, np.int64)
        slots[vidx] = dp.slots
        kw.update(mesh=mesh, n_shards=dp.n_shards,
                  rows_per_shard=dp.rows_per_shard,
                  edges_per_shard=dp.edges_per_shard,
                  dist_rows_local=t(dp.rows_local.astype(np.int64)),
                  dist_cols_perm=t(dp.cols_perm.astype(np.int64)),
                  dist_vals=t(dp.vals), dist_slots=t(slots),
                  dist_perm=t(dp.perm.astype(np.int64)),
                  dist_inv_perm=t(dp.inv_perm.astype(np.int64)))
    return AggregationPlan(**kw)


def _world_data_mesh():
    """A one-axis ``("data",)`` mesh over every rank of the initialized
    process group (the reference's default mesh over every device)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise ValueError(
            "the distributed backend shards over the ranks of a process "
            "group: initialize one (torch.distributed.init_process_group) "
            "or pass make_plan(..., mesh=) a DeviceMesh with a 'data' axis")
    from torch.distributed.device_mesh import init_device_mesh
    backend = str(dist.get_backend())
    return init_device_mesh("cuda" if backend == "nccl" else "cpu",
                            (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def _scatter(shape, dtype, slots: torch.Tensor, vals: torch.Tensor,
             order=None) -> torch.Tensor:
    n = shape[0] * shape[1]
    flat = vals.new_zeros(n + 1, dtype=dtype)
    v = vals.to(dtype)
    if order is None:
        flat.index_add_(0, slots.clamp(0, n), v)
        return flat[:n].reshape(shape)
    # cells shared by several edges: layer by layer (see scatter_order),
    # so no index_add_ ever adds twice into one kept cell
    first, edges, cells, bounds = order
    flat.index_add_(0, first, v)
    lo = 0
    for hi in bounds:
        flat.index_add_(0, cells[lo:hi], v.index_select(0, edges[lo:hi]))
        lo = hi
    return flat[:n].reshape(shape)


def _order(plan: "AggregationPlan", pre: str):
    first = getattr(plan, pre + "first_slots")
    if first is None:
        return None
    return (first, getattr(plan, pre + "dup_edges"),
            getattr(plan, pre + "dup_slots"), getattr(plan, pre + "dup_bounds"))


def scatter_tiles(a_base: torch.Tensor, slots: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Coefficient tiles of ``a_base``'s shape holding ``vals``
    scatter-added at ``slots``.

    Duplicate edges share a cell, so the values add — by atomics on CUDA,
    in no fixed order (``forward_tiles`` adds them in edge order).
    Out-of-bounds slots (padding edges) land in one trash cell past the
    end, which is cut off: JAX's ``mode="drop"`` without a scatter that
    faults."""
    return _scatter(a_base.shape, a_base.dtype, slots, vals)


def forward_tiles(plan: "AggregationPlan",
                  vals: torch.Tensor) -> torch.Tensor:
    """The forward coefficient tiles for per-edge ``vals``, scattered
    through ``ell_slots`` in the plan's fixed order (``scatter_order``):
    bitwise the CPU's sequential scatter on any device.  Gradients reach
    ``vals`` through the scatter."""
    return _scatter(plan.ell_a.shape, plan.ell_a.dtype, plan.ell_slots, vals,
                    _order(plan, "ell_"))


def transpose_tiles(plan: "AggregationPlan",
                    vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The transpose coefficient tiles for per-edge ``vals`` (default: the
    plan's ``base_vals``), the operand of the backward's dX = Aᵀ·dY.

    The plan's own ``ell_t_a`` serves the default values; otherwise (given
    values, or a plan whose ``ell_t_a`` ``plan_with_values`` dropped) the
    tiles are scattered from ``ell_t_slots`` in the plan's fixed order, so
    a backward never reads missing or stale tiles.  They carry no
    gradient: edge values reach the gradient through the forward tiles
    alone."""
    if vals is None and plan.ell_t_a is not None:
        return plan.ell_t_a
    v = plan.base_vals if vals is None else vals
    shape = (plan.ell_t_u_cols.shape[0] * plan.block_rows,
             plan.ell_t_u_cols.shape[1])
    return _scatter(shape, torch.float32, plan.ell_t_slots, v.detach(),
                    _order(plan, "ell_t_"))


def plan_with_values(plan: AggregationPlan, edge_weight=None,
                     edge_valid=None) -> AggregationPlan:
    """Re-value a static-structure plan on its device.

    Shape-bucketed serving builds one host plan per bucket (every request's
    sender/receiver indices are identical) and swaps in only the per-edge
    weights/validity per request: the COO ``base_vals`` and the forward
    coefficient tiles (scatter-added through the slot maps) are rebuilt;
    every layout index stays the host-packed data.  The plan must have been
    built with all edges valid, so its slot maps cover every edge.

    Inference reads only the forward tiles, so the transpose tiles are not
    re-valued: ``ell_t_a`` is dropped (``None``) rather than left holding
    the old values.  A backward pass re-values them from ``ell_t_slots``
    (``transpose_tiles``).  A plan that carries int8 tiles gets them
    re-quantized from the new forward tiles, on the device, with no read
    back to the host.  Edges that share a cell add in edge order
    (``scatter_order``); a plan whose valid edges each own a cell, as a
    serving bucket's tree layout does, scatters in one ``index_add_``.
    """
    valid = plan.valid if edge_valid is None else edge_valid
    base = _values(valid, edge_weight)
    kw = dict(valid=valid, base_vals=base)
    if plan.ell_u_cols is not None:
        kw.update(ell_a=forward_tiles(plan, base), ell_t_a=None)
        if plan.ell_a_q8 is not None:
            from repro_torch.sparse.quantize import quantize_chunk_tiles
            kw["ell_a_q8"], kw["ell_a_scale"] = quantize_chunk_tiles(
                kw["ell_a"], plan.ell_u_cols.shape[0])
    if plan.dist_rows_local is not None:
        kw["dist_vals"] = dist_values(plan, base)
    return dataclasses.replace(plan, **kw)


def dist_values(plan: AggregationPlan, vals: torch.Tensor) -> torch.Tensor:
    """Per-edge ``vals`` placed at their owner-grouped slots of the
    ``dist_*`` layout (padding lanes and invalid edges 0).  Every slot
    takes at most one edge, so the placement is exact in any order;
    gradients reach ``vals`` through it."""
    n = plan.dist_rows_local.shape[0]
    flat = vals.new_zeros((n + 1,) + vals.shape[1:])
    flat = flat.index_copy(0, plan.dist_slots.clamp(0, n), vals)
    return flat[:n]


# ---------------------------------------------------------------------------
# Feature-shard plan — the serving cluster's sharded-residency layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FeatureShardPlan:
    """DRHM row-sharded residency for a resident feature table (serving
    cluster): lane ``i`` of ``n_lanes`` owns permuted row slots ``[i·R,
    (i+1)·R)``.  The DRHM permutation is a bijection, so every lane holds
    exactly ``R = n_pad / n_lanes`` rows, whichever nodes are popular.

    ``perm`` maps a padded row id (ghost row included, id ``n_rows-1``) to
    its permuted slot; the halo gather uses it to translate a sampled
    subgraph's node ids into slots of the sharded table."""

    n_rows: int                  # padded row count incl. ghost row
    n_lanes: int
    n_pad: int                   # permuted slot count (n_lanes-divisible)
    gamma: int
    perm: np.ndarray             # (n_pad,) row id -> permuted slot
    inv_perm: np.ndarray         # (n_pad,) permuted slot -> row id

    @property
    def rows_per_lane(self) -> int:
        return self.n_pad // self.n_lanes

    def owner_of(self, row_ids: np.ndarray) -> np.ndarray:
        return self.perm[row_ids] // self.rows_per_lane

    def permute_table(self, table: np.ndarray) -> np.ndarray:
        """A host feature table (ghost row last) in permuted slot order;
        pad slots (beyond ``n_rows``) are zero, like the ghost row."""
        out = np.zeros((self.n_pad,) + table.shape[1:], table.dtype)
        out[self.perm[:table.shape[0]]] = table
        return out


def plan_feature_sharding(n_rows: int, n_lanes: int,
                          gamma: int = 0x9E3779B1) -> FeatureShardPlan:
    """DRHM shard plan for a resident feature table of ``n_rows`` rows
    (ghost row included) over ``n_lanes`` serving lanes."""
    from repro_torch.core import drhm
    sp = drhm.plan_row_sharding(n_rows, n_lanes, gamma)
    return FeatureShardPlan(n_rows=n_rows, n_lanes=n_lanes, n_pad=sp.n_pad,
                            gamma=sp.gamma, perm=sp.perm,
                            inv_perm=sp.inv_perm)


def plan_from_graph(g, *, n_rows: Optional[int] = None,
                    **kwargs) -> AggregationPlan:
    """Plan for a padded ``Graph``.  ``n_rows`` defaults to ``n_nodes + 1``
    (the ghost-row convention: features carry one extra padding row); the
    plan lands on the graph's device unless ``device=`` says otherwise."""
    n = int(n_rows) if n_rows is not None else g.n_nodes + 1
    kwargs.setdefault("device", g.senders.device)
    return make_plan(g.senders.cpu().numpy(), g.receivers.cpu().numpy(), n,
                     edge_weight=(None if g.edge_weight is None
                                  else g.edge_weight.cpu().numpy()),
                     edge_valid=g.edge_valid.cpu().numpy(), **kwargs)


# ---------------------------------------------------------------------------
# Plan cache — repeated step builds on a static graph re-pack nothing
# ---------------------------------------------------------------------------

PLAN_CACHE_MAXSIZE = 8

# key → (graph, plan); insertion order = LRU order.  The entry keeps a strong
# reference to the keying graph so the id()s in the key cannot be recycled
# while the entry lives; lookups re-verify identity with `is`.
_PLAN_CACHE: "dict[tuple, tuple]" = {}
_PLAN_CACHE_STATS = {"hits": 0, "misses": 0}


def _freeze_kwargs(kwargs):
    def _freeze(v):
        if isinstance(v, (list, tuple)):
            return tuple(_freeze(x) for x in v)
        return v
    return tuple(sorted((k, _freeze(v)) for k, v in kwargs.items()))


def _graph_key(g, n_rows, kwargs):
    ids = tuple(None if a is None else id(a)
                for a in (g.senders, g.receivers, g.edge_weight,
                          g.edge_valid))
    return ids + (g.n_nodes, n_rows, _freeze_kwargs(kwargs))


def _same_graph(a, b) -> bool:
    return (a.senders is b.senders and a.receivers is b.receivers
            and a.edge_weight is b.edge_weight
            and a.edge_valid is b.edge_valid)


def cached_plan_from_graph(g, *, n_rows: Optional[int] = None,
                           maxsize: int = None, **kwargs) -> AggregationPlan:
    """``plan_from_graph`` with an LRU cache keyed on graph identity (the
    exact tensor objects), backend set, and layout parameters: a static
    graph pays the host-side packing once, not once per step build."""
    maxsize = PLAN_CACHE_MAXSIZE if maxsize is None else maxsize
    key = _graph_key(g, n_rows, kwargs)
    entry = _PLAN_CACHE.get(key)
    if entry is not None and _same_graph(entry[0], g):
        _PLAN_CACHE_STATS["hits"] += 1
        del _PLAN_CACHE[key]            # refresh LRU position
        _PLAN_CACHE[key] = entry
        return entry[1]
    _PLAN_CACHE_STATS["misses"] += 1
    plan = plan_from_graph(g, n_rows=n_rows, **kwargs)
    _PLAN_CACHE[key] = (g, plan)
    while len(_PLAN_CACHE) > max(int(maxsize), 0):
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    return plan


def plan_cache_info() -> dict:
    return dict(_PLAN_CACHE_STATS, size=len(_PLAN_CACHE))


def plan_cache_clear() -> None:
    _PLAN_CACHE.clear()
    _PLAN_CACHE_STATS.update(hits=0, misses=0)
