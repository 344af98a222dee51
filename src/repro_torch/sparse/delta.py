"""Incremental plan re-packing for streaming graph mutation (port of
``repro.sparse.delta``).

A cold ``plan_from_graph`` re-pack is O(E log E) host work plus a Python
loop over output blocks (``graph.pack_dedup_chunks``): too slow to sit on
a mutation stream.  ``DeltaGraphState`` keeps every layout the plan layer
packs up to date **incrementally**:

* **CSR**, both orientations (receiver-sorted for the serving sampler and
  the forward dedup-chunk layout, sender-sorted for the transpose layout),
  edited with vectorized ``np.insert``/``np.delete`` at end-of-row
  positions.  Canonical edge order is "original order minus deletes,
  inserts appended", so the incremental CSR is bitwise ``coo_to_csr`` over
  the compacted edge arrays.
* **Dedup-chunk layouts**, by re-chunking only the *dirty* output blocks
  (blocks that lost or gained an edge) through the cold packer's chunking
  rule, then reassembling the flat arrays with vectorized numpy.  Clean
  blocks reuse their cached operand tables.

The host numpy is the reference's, copied as it is: its bits are the
contract.  ``plan()`` hands the re-packed layouts to
``plan.ell_sections``, the function ``make_plan`` uses, so the plan's own
fields (``ell_block_ptr``, the layered tile scatter, the int8 bake) come
out of one code path; ``plans_match`` holds every field of two plans,
those the reference's plan lacks included.

Parity contract (``tests/test_torch_delta.py``; ``chip_smoke.py`` phase
19 on the card): after any interleaving of inserts, deletes and flushes,
``plan()`` equals a cold ``plan_from_graph`` over the compacted edge
arrays field for field, the coefficient tiles included (per-cell
accumulation order is block-major canonical in both packers), so B1 and
B4 give the same bits on either plan.

The bounded-staleness policy (when a flush must happen) lives with the
serving stream in ``repro_torch.serve.live``; this module is the
mechanism.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sparse.graph import (DedupChunks, Graph, make_graph, pad_to,
                                      round_up)
from repro_torch.sparse.stats import record_count, record_value

DELTA_BACKENDS = ("dense", "chunked", "cuda", "cuda_q8")
# the plan layer's packing constants, which the cold plan uses too: rows per
# output block (B1/B4's tile height), chunk-width rounding, edge padding
BLOCK_ROWS = 8
WIDTH_MULTIPLE = 16
PAD_MULTIPLE = 128


class DeltaGraphError(ValueError):
    """A mutation the delta state cannot apply (unknown edge, bad ids) or a
    plan section it cannot maintain incrementally."""


class _LayoutState:
    """One orientation's incrementally-maintained CSR + dedup-chunk state.

    ``rows`` is the blocked/accumulating side (receivers for the forward
    layout, senders for the transpose), ``cols`` the operand side.  All
    per-position arrays are kept in CSR (block-major canonical) order and
    edited with the same ``np.delete``/``np.insert`` so they never drift
    from ``order``.
    """

    def __init__(self, rows: np.ndarray, cols: np.ndarray, n_rows: int,
                 block_rows: int, width_cap: int):
        self.n_rows = int(n_rows)
        self.n_cols = int(n_rows)          # square over the padded node space
        self.block_rows = int(block_rows)
        self.width_cap = int(width_cap)
        self.n_blocks = round_up(self.n_rows, self.block_rows) \
            // self.block_rows
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        self.order = np.argsort(rows, kind="stable")     # csr pos → canonical
        self.sorted_cols = cols[self.order].astype(np.int32)
        indptr = np.zeros(self.n_rows + 1, np.int64)
        np.add.at(indptr, rows + 1, 1)
        self.indptr = np.cumsum(indptr)
        # global per-block operand dedup, vectorized: unique (block, col)
        # pairs in block-major order reproduce each block's np.unique
        blk_e = rows[self.order] // self.block_rows
        comb = blk_e * np.int64(self.n_cols) + self.sorted_cols
        uc, uinv = np.unique(comb, return_inverse=True)
        self.u_all = (uc % self.n_cols).astype(np.int32)
        counts_u = np.bincount(uc // self.n_cols, minlength=self.n_blocks)
        self.u_ptr = np.zeros(self.n_blocks + 1, np.int64)
        np.cumsum(counts_u, out=self.u_ptr[1:])
        local = uinv - self.u_ptr[blk_e]
        self.uidx = local % self.width_cap          # operand slot in chunk
        self.chunk_in_block = local // self.width_cap

    # -- mutation ------------------------------------------------------------
    def apply(self, del_can: np.ndarray, del_rows: np.ndarray,
              ins_rows: np.ndarray, ins_cols: np.ndarray,
              e_old: int) -> int:
        """Apply one flushed batch.  ``del_can`` are sorted canonical edge
        indices (into the pre-flush arrays); inserts are appended in order.
        Returns the number of dirty blocks re-chunked."""
        if del_can.size:
            mark = np.zeros(e_old, bool)
            mark[del_can] = True
            del_pos = np.nonzero(mark[self.order])[0]
            self.order = np.delete(self.order, del_pos)
            self.order -= np.searchsorted(del_can, self.order)
            self.sorted_cols = np.delete(self.sorted_cols, del_pos)
            self.uidx = np.delete(self.uidx, del_pos)
            self.chunk_in_block = np.delete(self.chunk_in_block, del_pos)
            delta = np.zeros(self.n_rows + 1, np.int64)
            np.subtract.at(delta, del_rows + 1, 1)
            self.indptr = self.indptr + np.cumsum(delta)
        if ins_rows.size:
            # canonical ids follow buffer order (inserts append), but the
            # CSR edit must place them row-major: two inserts into different
            # rows can share one numeric end-of-row position when the rows
            # between them are empty, and np.insert breaks that tie by list
            # order — so sort by row (stable: same-row inserts keep buffer
            # order, matching canonical order within the row)
            by_row = np.argsort(ins_rows, kind="stable")
            pos = self.indptr[ins_rows[by_row] + 1]  # end-of-row, post-del
            new_ids = (e_old - del_can.size) + np.arange(ins_rows.size)
            self.order = np.insert(self.order, pos, new_ids[by_row])
            ins_cols = ins_cols[by_row]
            self.sorted_cols = np.insert(self.sorted_cols, pos,
                                         ins_cols.astype(np.int32))
            self.uidx = np.insert(self.uidx, pos, 0)
            self.chunk_in_block = np.insert(self.chunk_in_block, pos, 0)
            delta = np.zeros(self.n_rows + 1, np.int64)
            np.add.at(delta, ins_rows + 1, 1)
            self.indptr = self.indptr + np.cumsum(delta)
        touched = np.concatenate([del_rows, ins_rows])
        if touched.size == 0:
            return 0
        dirty = np.unique(touched // self.block_rows)
        self._rechunk(dirty)
        return int(dirty.size)

    def _rechunk(self, dirty: np.ndarray) -> None:
        """Re-dedup + re-chunk the dirty blocks through the cold packer's
        chunking rule (chunk j of a block covers unique-operand ranks
        ``[j·cap, (j+1)·cap)``), splicing their operand tables into
        ``u_all`` while every clean block's cache is reused untouched."""
        br, cap = self.block_rows, self.width_cap
        old_ptr = self.u_ptr
        counts = np.diff(old_ptr).copy()
        # one global unique over all dirty blocks' (block, col) pairs —
        # block-major sorted, so it reproduces each block's own np.unique
        lo_e = self.indptr[dirty * br]
        hi_e = self.indptr[np.minimum((dirty + 1) * br, self.n_rows)]
        sizes = hi_e - lo_e
        pos = (np.repeat(lo_e - np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                         sizes) + np.arange(int(sizes.sum())))
        blk_d = np.repeat(dirty, sizes)
        comb = blk_d * np.int64(self.n_cols) + self.sorted_cols[pos]
        uc, uinv = np.unique(comb, return_inverse=True)
        blk_of_u = uc // self.n_cols
        j_of_u = np.searchsorted(dirty, blk_of_u)
        counts_d = np.bincount(j_of_u, minlength=dirty.size)
        ptr_d = np.zeros(dirty.size + 1, np.int64)
        np.cumsum(counts_d, out=ptr_d[1:])
        local = uinv - ptr_d[np.searchsorted(dirty, blk_d)]
        self.uidx[pos] = local % cap
        self.chunk_in_block[pos] = local // cap
        u_new = (uc % self.n_cols).astype(np.int32)
        pieces: List[np.ndarray] = []
        prev_u = 0
        for j, b in enumerate(dirty.tolist()):
            pieces.append(self.u_all[prev_u:old_ptr[b]])
            pieces.append(u_new[ptr_d[j]:ptr_d[j + 1]])
            prev_u = int(old_ptr[b + 1])
            counts[b] = counts_d[j]
        pieces.append(self.u_all[prev_u:])
        self.u_all = np.concatenate(pieces)
        self.u_ptr = np.zeros(self.n_blocks + 1, np.int64)
        np.cumsum(counts, out=self.u_ptr[1:])

    # -- assembly ------------------------------------------------------------
    def chunk_layout(self) -> Tuple[np.ndarray, int]:
        """(chunks-per-block, total chunks) from the cached operand counts
        — every block owns ≥ 1 chunk, even empty ones."""
        counts_u = np.diff(self.u_ptr)
        nch = np.maximum(1, -(-counts_u // self.width_cap))
        return nch, int(nch.sum())

    def assemble(self, vals: np.ndarray,
                 width_multiple: int = 16) -> DedupChunks:
        """Materialize the flat DedupChunks arrays — all vectorized; no
        python loop over blocks.  Bitwise-matches ``pack_dedup_chunks``
        over the canonical edge arrays (per-cell accumulation order is
        block-major canonical in both)."""
        br, cap = self.block_rows, self.width_cap
        counts_u = np.diff(self.u_ptr)
        nch, n_chunks = self.chunk_layout()
        width = int(round_up(max(1, min(int(counts_u.max(initial=0)), cap)),
                             width_multiple))
        chunk_start = np.zeros(self.n_blocks + 1, np.int64)
        np.cumsum(nch, out=chunk_start[1:])
        blk_of_u = np.repeat(np.arange(self.n_blocks), counts_u)
        local_u = np.arange(self.u_all.size) - self.u_ptr[blk_of_u]
        u_gchunk = chunk_start[blk_of_u] + local_u // cap
        u_cols = np.zeros((n_chunks, width), np.int32)
        u_cols[u_gchunk, local_u % cap] = self.u_all
        remaining = np.bincount(u_gchunk,
                                minlength=n_chunks).astype(np.int32)
        out_block = np.repeat(np.arange(self.n_blocks, dtype=np.int32), nch)
        first = np.zeros(n_chunks, np.int32)
        first[chunk_start[:-1]] = 1
        rows_per_pos = np.repeat(np.arange(self.n_rows, dtype=np.int64),
                                 np.diff(self.indptr))
        blk_e = rows_per_pos // br
        gchunk_e = chunk_start[blk_e] + self.chunk_in_block
        cell = ((gchunk_e * br + (rows_per_pos - blk_e * br)) * width
                + self.uidx)
        a = np.zeros(n_chunks * br * width, np.float32)
        np.add.at(a, cell, np.asarray(vals, np.float32)[self.order])
        slots = np.full(self.order.size, n_chunks * br * width, np.int32)
        slots[self.order] = cell
        return DedupChunks(u_cols=u_cols, a=a.reshape(n_chunks * br, width),
                           remaining=remaining, out_block=out_block,
                           first=first, n_rows=self.n_rows,
                           n_cols=self.n_cols, block_rows=br, slots=slots)


@dataclasses.dataclass
class FlushResult:
    """What one flush did — surfaced to telemetry and the mutation bench."""

    epoch: int
    inserted: int
    deleted: int
    dirty_blocks: int          # across both layout orientations
    clean_blocks: int
    n_edges: int


class DeltaGraphState:
    """The mutable resident graph: canonical edge arrays + incrementally
    maintained CSRs and dedup-chunk layouts, with buffered edge mutations
    applied in epoch batches by :meth:`flush`.

    Canonical order is *original edges minus deletes, inserts appended* —
    exactly what a cold re-pack of the compacted arrays would see, which is
    what makes the incremental layouts bitwise-comparable to
    ``plan_from_graph`` at every epoch boundary.
    """

    def __init__(self, senders: np.ndarray, receivers: np.ndarray,
                 n_nodes: int, weights: Optional[np.ndarray] = None, *,
                 width_cap: int = 128):
        self.n_nodes = int(n_nodes)
        self.n_rows = self.n_nodes + 1            # ghost-row convention
        self.block_rows = BLOCK_ROWS
        self.width_cap = int(width_cap)
        self.width_multiple = WIDTH_MULTIPLE
        self._s = np.asarray(senders, np.int64).copy()
        self._r = np.asarray(receivers, np.int64).copy()
        if np.any((self._s < 0) | (self._s >= self.n_nodes) |
                  (self._r < 0) | (self._r >= self.n_nodes)):
            raise DeltaGraphError("edge endpoints out of range")
        self._w = (np.ones(self._s.size, np.float32) if weights is None
                   else np.asarray(weights, np.float32).copy())
        if self._w.shape != self._s.shape:
            raise DeltaGraphError("weights shape mismatch")
        # forward layout: rows = receivers (the aggregation viewpoint, and
        # the serving sampler's CSR); transpose layout: rows = senders
        self._fwd = _LayoutState(self._r, self._s, self.n_rows,
                                 self.block_rows, self.width_cap)
        self._tr = _LayoutState(self._s, self._r, self.n_rows,
                                self.block_rows, self.width_cap)
        self.epoch = 0
        self._pend_ins: List[Tuple[int, int, float]] = []
        self._pend_del: List[Tuple[int, int]] = []

    # -- buffered mutations --------------------------------------------------
    @property
    def n_edges(self) -> int:
        return int(self._s.size)

    @property
    def pending(self) -> int:
        return len(self._pend_ins) + len(self._pend_del)

    def insert_edge(self, sender: int, receiver: int,
                    weight: float = 1.0) -> None:
        s, r = int(sender), int(receiver)
        if not (0 <= s < self.n_nodes and 0 <= r < self.n_nodes):
            raise DeltaGraphError(f"edge ({s}, {r}) out of range")
        self._pend_ins.append((s, r, float(weight)))

    def delete_edge(self, sender: int, receiver: int) -> None:
        """Delete one ``(sender, receiver)`` edge.  A pending insert of the
        same pair is cancelled instead; otherwise the *last* matching
        canonical edge is removed at the next flush.  Raises if no such
        edge exists in the post-buffer graph."""
        s, r = int(sender), int(receiver)
        for i in range(len(self._pend_ins) - 1, -1, -1):
            if self._pend_ins[i][0] == s and self._pend_ins[i][1] == r:
                del self._pend_ins[i]
                return
        have = int(np.count_nonzero((self._s == s) & (self._r == r)))
        booked = sum(1 for d in self._pend_del if d == (s, r))
        if booked >= have:
            raise DeltaGraphError(f"edge ({s}, {r}) not present")
        self._pend_del.append((s, r))

    # -- epoch boundary ------------------------------------------------------
    def flush(self) -> FlushResult:
        """Apply the buffered batch: compact canonical arrays, delta-update
        both CSRs and both dedup-chunk layouts, bump the epoch."""
        ins = self._pend_ins
        dels = self._pend_del
        self._pend_ins, self._pend_del = [], []
        e_old = self._s.size
        # resolve deletes to canonical indices (last matching occurrence)
        del_idx: List[int] = []
        taken = set()
        for s, r in dels:
            cand = np.nonzero((self._s == s) & (self._r == r))[0]
            hit = next((int(i) for i in cand[::-1] if int(i) not in taken),
                       None)
            if hit is None:        # unreachable via delete_edge's booking
                raise DeltaGraphError(f"edge ({s}, {r}) not present")
            taken.add(hit)
            del_idx.append(hit)
        del_can = np.sort(np.asarray(del_idx, np.int64))
        ins_s = np.asarray([i[0] for i in ins], np.int64)
        ins_r = np.asarray([i[1] for i in ins], np.int64)
        ins_w = np.asarray([i[2] for i in ins], np.float32)
        dirty = self._fwd.apply(del_can, self._r[del_can], ins_r, ins_s,
                                e_old)
        dirty += self._tr.apply(del_can, self._s[del_can], ins_s, ins_r,
                                e_old)
        keep = np.ones(e_old, bool)
        keep[del_can] = False
        self._s = np.concatenate([self._s[keep], ins_s])
        self._r = np.concatenate([self._r[keep], ins_r])
        self._w = np.concatenate([self._w[keep], ins_w])
        self.epoch += 1
        record_count("delta.flushes", 1)
        record_count("delta.edges_inserted", ins_s.size)
        record_count("delta.edges_deleted", del_can.size)
        record_count("delta.dirty_blocks", dirty)
        total_blocks = self._fwd.n_blocks + self._tr.n_blocks
        record_value("delta.clean_block_frac",
                     1.0 - dirty / max(1, total_blocks))
        return FlushResult(epoch=self.epoch, inserted=int(ins_s.size),
                           deleted=int(del_can.size), dirty_blocks=dirty,
                           clean_blocks=total_blocks - dirty,
                           n_edges=self.n_edges)

    # -- views ---------------------------------------------------------------
    def csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """Serving CSR (receiver-sorted), same convention as
        ``coo_to_csr(senders, receivers, n_nodes)`` — bitwise identical to
        a cold build over the canonical arrays."""
        return (self._fwd.indptr[:self.n_nodes + 1].copy(),
                self._fwd.sorted_cols.copy())

    def graph(self, device: DeviceLike = None) -> Graph:
        """The compacted canonical graph as a padded ``Graph`` on
        ``device`` (default ``cuda``): the cold re-pack's input at this
        epoch."""
        return make_graph(self._s.astype(np.int32),
                          self._r.astype(np.int32), self.n_nodes,
                          edge_weight=self._w, pad_multiple=PAD_MULTIPLE,
                          device=device)

    def chunk_stats(self) -> dict:
        """Forward-layout chunk stats, matching what ``make_plan`` records
        (``plan.n_chunks`` / ``plan.chunk_width`` / ``plan.hub_splits``)."""
        counts_u = np.diff(self._fwd.u_ptr)
        _, n_chunks = self._fwd.chunk_layout()
        width = int(round_up(max(1, min(int(counts_u.max(initial=0)),
                                        self.width_cap)),
                             self.width_multiple))
        return {"n_chunks": n_chunks, "chunk_width": width,
                "hub_splits": n_chunks - self._fwd.n_blocks,
                "n_edges": self.n_edges, "epoch": self.epoch}

    def repack(self) -> Tuple[DedupChunks, DedupChunks]:
        """Host-side incremental re-pack at the current epoch: the forward
        and transpose DedupChunks layouts, assembled from cached clean
        blocks and the re-chunked dirty ones (the incremental side of
        ``delta_repack_speedup``; the upload to the device is the same
        either way and left out of both)."""
        return (self._fwd.assemble(self._w, self.width_multiple),
                self._tr.assemble(self._w, self.width_multiple))

    def cold_repack(self) -> Tuple[DedupChunks, DedupChunks,
                                   Tuple[np.ndarray, np.ndarray]]:
        """A cold re-pack of the canonical arrays, host-side: the forward
        and transpose DedupChunks layouts and the serving CSR
        ``(indptr, indices)``.  The baseline the incremental path is
        measured against, and its parity reference: ``csr()`` must equal
        the third item bitwise, the order of each row's senders included
        (it decides which neighbours the sampler draws)."""
        from repro_torch.sparse.graph import coo_to_csr, pack_dedup_chunks
        indptr, indices, _ = coo_to_csr(self._s, self._r, self.n_nodes)
        kw = dict(block_rows=self.block_rows, width_cap=self.width_cap,
                  width_multiple=self.width_multiple)
        fwd = pack_dedup_chunks(self._r, self._s, self._w, self.n_rows,
                                self.n_rows, **kw)
        tr = pack_dedup_chunks(self._s, self._r, self._w, self.n_rows,
                               self.n_rows, **kw)
        return fwd, tr, (indptr, indices)

    def plan(self, *, backends: Sequence[str] = ("dense", "chunked",
                                                 "cuda"),
             device: DeviceLike = None):
        """The incremental ``AggregationPlan`` at this epoch on ``device``
        (default ``cuda``): equal field for field to
        ``plan_from_graph(self.graph(), backends=...)`` without re-packing
        clean blocks.  Backends outside ``DELTA_BACKENDS`` have no delta
        path and raise."""
        from repro_torch.sparse.plan import AggregationPlan, ell_sections
        for b in backends:
            if b not in DELTA_BACKENDS:
                raise DeltaGraphError(
                    f"backend {b!r} has no incremental re-pack; build a "
                    f"cold plan via plan_from_graph (have {DELTA_BACKENDS})")
        dev = resolve_device(device)
        e = self.n_edges
        e_pad = round_up(max(e, 1), PAD_MULTIPLE)
        s_p = pad_to(self._s.astype(np.int32), e_pad, self.n_nodes)
        r_p = pad_to(self._r.astype(np.int32), e_pad, self.n_nodes)
        valid = np.zeros(e_pad, bool)
        valid[:e] = True
        base = np.zeros(e_pad, np.float32)
        base[:e] = self._w

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        kw = dict(n_rows=self.n_rows,
                  rows=t(r_p.astype(np.int64)), cols=t(s_p.astype(np.int64)),
                  valid=t(valid), base_vals=t(base))
        if "cuda" in backends or "cuda_q8" in backends:
            fwd, tr = self.repack()
            record_count("delta.incremental_repacks", 2)
            kw.update(ell_sections(fwd, tr, e_pad, np.arange(e), backends,
                                   None, dev))
        return AggregationPlan(**kw)

    def cold_plan(self, *, backends: Sequence[str] = ("dense", "chunked",
                                                      "cuda"),
                  device: DeviceLike = None):
        """The cold re-pack reference: ``plan_from_graph`` over the
        compacted canonical arrays with this state's chunking (what the
        incremental plan must equal at every epoch boundary)."""
        from repro_torch.sparse.plan import plan_from_graph
        return plan_from_graph(self.graph(device=device), backends=backends,
                               block_rows=self.block_rows,
                               width_cap=self.width_cap,
                               width_multiple=self.width_multiple)


def plans_match(pa, pb, *, tol: float = 1e-5) -> Tuple[bool, dict]:
    """Parity between two plans over the same graph, on every field of
    ``AggregationPlan``: integer and bool tensors (COO ids, chunk tables,
    block ranges, slot maps, the tile scatter's layers, the int8 tiles)
    and the plain fields bitwise; float tensors (``base_vals``, the f32
    tiles, the chunk scales) within ``tol`` (``tol=0``: bitwise), their
    deviation in ``detail[<field>_dev]``."""
    detail: dict = {}
    ok = True
    for f in (f.name for f in dataclasses.fields(pa) if f.name != "orders"):
        a, b = getattr(pa, f), getattr(pb, f)
        if not isinstance(a, torch.Tensor) and not isinstance(b,
                                                              torch.Tensor):
            detail[f] = bool(a == b)
        elif (a is None or b is None or a.shape != b.shape
              or a.dtype != b.dtype):
            detail[f] = False
        elif a.is_floating_point():
            b = b.to(a.device)
            dev = float((a - b).abs().max()) if a.numel() else 0.0
            detail[f + "_dev"] = dev
            ok = ok and dev <= tol
            continue
        else:
            detail[f] = bool(torch.equal(a, b.to(a.device)))
        ok = ok and detail[f]
    return ok, detail


def chunks_match(ca, cb, *, tol: float = 1e-5) -> Tuple[bool, dict]:
    """Host-side ``DedupChunks`` parity (the cheap epoch-boundary check the
    serving graph stream runs before installing a mutated layout): chunk
    tables and slot maps bitwise, coefficient tiles within ``tol``."""
    detail: dict = {}
    ok = True
    for f in ("u_cols", "remaining", "out_block", "first", "slots"):
        a, b = np.asarray(getattr(ca, f)), np.asarray(getattr(cb, f))
        same = a.shape == b.shape and bool(np.array_equal(a, b))
        detail[f] = same
        ok = ok and same
    a, b = np.asarray(ca.a), np.asarray(cb.a)
    dev = (float(np.max(np.abs(a - b)))
           if a.shape == b.shape and a.size else
           (0.0 if a.shape == b.shape else float("inf")))
    detail["a_dev"] = dev
    ok = ok and dev <= tol
    detail["n_blocks"] = ca.n_blocks == cb.n_blocks
    return ok and detail["n_blocks"], detail
