"""Graph container and host-side format conversions (port of
``repro.sparse.graph``).

The device-side graph is a padded COO edge list (``Graph``, torch tensors on
one device).  Host-side: CSR for the neighbor sampler, GCN symmetric
normalization, and the operand-deduplicated chunk packer the Gustavson
kernel runs on (and the older per-lane ``BlockedELL`` layout, which
``kernels.gustavson_spmm.spmm_blocked_ell`` re-packs into dedup chunks).
The packers must give arrays bitwise equal to the reference's, so they
are copied, not rewritten.  ``coarsen_graph`` runs two
rectangular SpGEMMs through the engine in ``repro_torch.sparse.spgemm``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class Graph(NamedTuple):
    """Padded device-side COO graph.

    senders/receivers: (E_pad,) int32.  Padding edges have both set to
    ``n_nodes`` (a ghost row) and ``edge_valid == False``.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    n_nodes: int                              # number of real nodes
    edge_valid: torch.Tensor                  # (E_pad,) bool
    edge_weight: Optional[torch.Tensor] = None  # (E_pad,) f32 or None


def pad_to(x: np.ndarray, size: int, fill) -> np.ndarray:
    if x.shape[0] == size:
        return x
    pad = np.full((size - x.shape[0],) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_graph(senders: np.ndarray, receivers: np.ndarray, n_nodes: int,
               edge_weight: Optional[np.ndarray] = None,
               pad_multiple: int = 128,
               device: DeviceLike = None) -> Graph:
    """Build a padded Graph from raw COO arrays (host-side) on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    e = senders.shape[0]
    e_pad = round_up(max(e, 1), pad_multiple)
    valid = np.zeros((e_pad,), dtype=bool)
    valid[:e] = True
    s = pad_to(senders.astype(np.int32), e_pad, n_nodes)
    r = pad_to(receivers.astype(np.int32), e_pad, n_nodes)
    w = None
    if edge_weight is not None:
        w = pad_to(edge_weight.astype(np.float32), e_pad, 0.0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return Graph(senders=t(s), receivers=t(r), n_nodes=int(n_nodes),
                 edge_valid=t(valid),
                 edge_weight=None if w is None else t(w))


def graph_coo(g: Graph):
    """Host numpy (senders, receivers, weights | None) of the valid edges."""
    valid = g.edge_valid.cpu().numpy()
    s = g.senders.cpu().numpy()[valid]
    r = g.receivers.cpu().numpy()[valid]
    w = (None if g.edge_weight is None
         else g.edge_weight.cpu().numpy()[valid])
    return s, r, w


def coo_to_csr(senders: np.ndarray, receivers: np.ndarray, n_nodes: int):
    """Host-side CSR build (rows = receivers — aggregation viewpoint)."""
    order = np.argsort(receivers, kind="stable")
    s_sorted = senders[order]
    r_sorted = receivers[order]
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(indptr, r_sorted + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, s_sorted.astype(np.int32), order


def coarsen_graph(g: Graph, clusters: np.ndarray, n_clusters: int,
                  backend: str = "reference",
                  pad_multiple: int = 128) -> Graph:
    """Coarse graph  A_c = Pᵀ A P  via two rectangular SpGEMMs.

    ``clusters[i]`` assigns node i to one of ``n_clusters`` super-nodes; P
    is the (n × n_c) one-hot assignment matrix, so ``A_c[a, b]`` sums the
    weight of every original edge from cluster b into cluster a.  Structure
    comes from the symbolic phase; the second product's B-values are the
    first product's device-computed outputs.  Plans and the result live on
    ``g``'s device.
    """
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse.spgemm import make_spgemm_plan
    dev = g.senders.device
    clusters = np.asarray(clusters, np.int64)
    s, r, w = graph_coo(g)
    if w is None:
        w = np.ones(s.size, np.float32)
    n = int(g.n_nodes)
    nodes = np.arange(n, dtype=np.int64)
    # M = A @ P  (n × n_c): A[r, s] = w, P[i, clusters[i]] = 1
    plan_m = make_spgemm_plan(r, s, n, nodes, clusters, n, n_clusters,
                              a_vals=w, executors=(backend,), device=dev)
    m_vals = sb.spgemm(plan_m, backend=backend)
    # A_c = Pᵀ @ M  (n_c × n_c): Pᵀ[clusters[i], i] = 1; M's structure is
    # host-known from the first plan, its values flow in per call
    plan_c = make_spgemm_plan(clusters, nodes, n_clusters,
                              plan_m.c_row.cpu().numpy(),
                              plan_m.c_col.cpu().numpy(), n, n_clusters,
                              executors=(backend,), device=dev)
    c_vals = sb.spgemm(plan_c, None, m_vals, backend=backend)
    return make_graph(plan_c.c_col.cpu().numpy().astype(np.int32),
                      plan_c.c_row.cpu().numpy().astype(np.int32),
                      int(n_clusters),
                      edge_weight=c_vals.cpu().numpy().astype(np.float32),
                      pad_multiple=pad_multiple, device=dev)


def sym_norm_weights(senders: np.ndarray, receivers: np.ndarray, n_nodes: int,
                     add_self_loops: bool = True):
    """GCN symmetric normalization  D^-1/2 (A+I) D^-1/2  — host-side."""
    if add_self_loops:
        loops = np.arange(n_nodes, dtype=senders.dtype)
        senders = np.concatenate([senders, loops])
        receivers = np.concatenate([receivers, loops])
    deg = np.zeros(n_nodes, dtype=np.float64)
    np.add.at(deg, receivers, 1.0)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    w = dinv[senders] * dinv[receivers]
    return senders, receivers, w.astype(np.float32)



@dataclasses.dataclass(frozen=True)
class BlockedELL:
    """Blocked-ELL packing of a sparse matrix: rows grouped into blocks of
    ``block_rows``; each block stores a padded nnz list (cols, vals, local
    row within the block) of length ``nnz_pad`` (the max nnz over blocks,
    rounded to ``nnz_multiple``).  ``remaining`` is each block's real nnz
    count (its rolling-eviction counter)."""

    cols: np.ndarray       # (n_blocks, nnz_pad) int32 — column per edge
    row_local: np.ndarray  # (n_blocks, nnz_pad) int32 — row within block
    vals: np.ndarray       # (n_blocks, nnz_pad) float32 (0 for padding)
    remaining: np.ndarray  # (n_blocks,) int32 — eviction counters
    n_rows: int
    n_cols: int
    block_rows: int
    # slot of input edge i in the flattened (n_blocks * nnz_pad) layout
    slots: Optional[np.ndarray] = None  # (E,) int32

    @property
    def n_blocks(self) -> int:
        return self.cols.shape[0]

    @property
    def nnz_pad(self) -> int:
        return self.cols.shape[1]


def pack_blocked_ell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                     n_rows: int, n_cols: int, block_rows: int = 8,
                     nnz_multiple: int = 128) -> BlockedELL:
    """Pack COO (rows, cols, vals) into ``BlockedELL`` (host-side, once)."""
    n_blocks = round_up(n_rows, block_rows) // block_rows
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    blk = rows // block_rows
    counts = np.zeros(n_blocks, dtype=np.int64)
    np.add.at(counts, blk, 1)
    nnz_pad = int(round_up(max(int(counts.max(initial=1)), 1), nnz_multiple))
    out_cols = np.zeros((n_blocks, nnz_pad), dtype=np.int32)
    out_rloc = np.zeros((n_blocks, nnz_pad), dtype=np.int32)
    out_vals = np.zeros((n_blocks, nnz_pad), dtype=np.float32)
    starts = np.zeros(n_blocks + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slots = np.zeros(rows.shape[0], dtype=np.int32)
    for b in range(n_blocks):
        lo, hi = starts[b], starts[b + 1]
        k = hi - lo
        out_cols[b, :k] = cols[lo:hi]
        out_rloc[b, :k] = rows[lo:hi] - b * block_rows
        out_vals[b, :k] = vals[lo:hi]
        slots[order[lo:hi]] = b * nnz_pad + np.arange(k, dtype=np.int32)
    return BlockedELL(
        cols=out_cols, row_local=out_rloc, vals=out_vals,
        remaining=counts.astype(np.int32), n_rows=n_rows, n_cols=n_cols,
        block_rows=block_rows, slots=slots,
    )


@dataclasses.dataclass(frozen=True)
class DedupChunks:
    """Operand-deduplicated chunked blocked-ELL for the Gustavson kernel.

    Rows are grouped into output blocks of ``block_rows``; each block's nnz
    are **deduplicated by source row** (one landing-buffer lane per distinct
    operand) and split into **chunks** of at most ``width`` distinct
    operands, so one hub row never inflates every block's padding.  A chunk
    carries:

    * ``u_cols[k]``   — the distinct source-row ids (padded with 0);
    * ``a[k·BR:(k+1)·BR]`` — a dense ``(block_rows, width)`` coefficient tile:
      ``a[r, u] = Σ vals`` over the chunk's nnz with local row ``r`` and
      operand ``u``;
    * ``remaining[k]`` — the rolling-eviction counter (# real operands);
    * ``out_block[k]`` — which output block the chunk folds into; chunks of
      one block are consecutive, ``first[k]`` marks the first.  Every output
      block owns ≥ 1 chunk, so even empty blocks evict a (zero) tile.

    ``slots[i]`` maps input edge *i* to its cell in the flattened ``a`` so
    edge values can be scatter-added into the coefficient tiles on device;
    excluded edges get an out-of-bounds slot.
    """

    u_cols: np.ndarray     # (n_chunks, width) int32 — distinct operand rows
    a: np.ndarray          # (n_chunks·block_rows, width) f32 — coeff tiles
    remaining: np.ndarray  # (n_chunks,) int32 — eviction counters
    out_block: np.ndarray  # (n_chunks,) int32 — destination output block
    first: np.ndarray      # (n_chunks,) int32 — 1 ⇔ first chunk of its block
    n_rows: int
    n_cols: int
    block_rows: int
    slots: Optional[np.ndarray] = None  # (E,) int32 into a.reshape(-1)

    @property
    def n_chunks(self) -> int:
        return self.u_cols.shape[0]

    @property
    def width(self) -> int:
        return self.u_cols.shape[1]

    @property
    def n_blocks(self) -> int:
        return round_up(self.n_rows, self.block_rows) // self.block_rows


def chunk_block_edges(b: int, idx: np.ndarray, rows: np.ndarray,
                      cols: np.ndarray, block_rows: int,
                      width_cap: int) -> list:
    """Dedup + chunk one output block's edge set (host-side).

    ``idx`` indexes the canonical edge arrays, already restricted to rows
    of block ``b`` in canonical (stable row-sorted) order.  Returns the
    block's chunk tuples ``(block, u_ids, edge_idx, rloc, uidx)`` — at
    least one (possibly empty) chunk, so empty blocks still evict a zero
    tile.
    """
    if idx.size == 0:
        return [(b, np.empty(0, np.int64), idx,
                 np.empty(0, np.int64), np.empty(0, np.int64))]
    u_ids, uinv = np.unique(cols[idx], return_inverse=True)
    chunks = []
    for lo in range(0, u_ids.size, width_cap):
        hi = min(lo + width_cap, u_ids.size)
        sel = (uinv >= lo) & (uinv < hi)
        chunks.append((b, u_ids[lo:hi], idx[sel],
                       rows[idx[sel]] - b * block_rows, uinv[sel] - lo))
    return chunks


def assemble_dedup_chunks(per_block: list, vals: np.ndarray, n_edges: int,
                          n_rows: int, n_cols: int, block_rows: int,
                          width_multiple: int = 16) -> DedupChunks:
    """Assemble per-block chunk tuples (from :func:`chunk_block_edges`)
    into the flat DedupChunks arrays.  ``width`` adapts to the graph: the
    max distinct-operand count over chunks, rounded to ``width_multiple``.
    """
    width = int(round_up(max(1, max((c[1].size for chunks in per_block
                                     for c in chunks), default=1)),
                         width_multiple))
    n_chunks = sum(len(c) for c in per_block)
    u_cols = np.zeros((n_chunks, width), np.int32)
    a = np.zeros((n_chunks * block_rows, width), np.float32)
    remaining = np.zeros(n_chunks, np.int32)
    out_block = np.zeros(n_chunks, np.int32)
    first = np.zeros(n_chunks, np.int32)
    slots = np.full(n_edges, n_chunks * block_rows * width,
                    np.int32)  # OOB default
    k = 0
    for chunks in per_block:
        for i, (b, u_ids, idx, rloc, uidx) in enumerate(chunks):
            u_cols[k, :u_ids.size] = u_ids
            remaining[k] = u_ids.size
            out_block[k] = b
            first[k] = int(i == 0)
            cell = (k * block_rows + rloc) * width + uidx
            np.add.at(a.reshape(-1), cell, vals[idx])
            slots[idx] = cell
            k += 1
    return DedupChunks(u_cols=u_cols, a=a, remaining=remaining,
                       out_block=out_block, first=first, n_rows=n_rows,
                       n_cols=n_cols, block_rows=block_rows, slots=slots)


def pack_dedup_chunks(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                      n_rows: int, n_cols: int, block_rows: int = 8,
                      width_cap: int = 128,
                      width_multiple: int = 16) -> DedupChunks:
    """Pack COO into DedupChunks (host-side, once per graph)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    e = rows.shape[0]
    n_blocks = round_up(n_rows, block_rows) // block_rows
    order = np.argsort(rows, kind="stable")
    blk_sorted = rows[order] // block_rows

    # per block: dedup operands, split into runs of ≤ width_cap distinct
    starts = np.zeros(n_blocks + 1, np.int64)
    np.add.at(starts, blk_sorted + 1, 1)
    starts = np.cumsum(starts)
    per_block = [chunk_block_edges(b, order[starts[b]:starts[b + 1]],
                                   rows, cols, block_rows, width_cap)
                 for b in range(n_blocks)]
    return assemble_dedup_chunks(per_block, vals, e, n_rows, n_cols,
                                 block_rows, width_multiple)
