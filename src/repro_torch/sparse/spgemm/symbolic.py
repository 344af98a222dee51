"""SpGEMM symbolic phase — output structure, interim-pp maps, hash-pad
layout (host-side numpy, once per matrix pair).  Port of
``repro.sparse.spgemm.symbolic``.

The output C = A@B of sparse×sparse SpGEMM is itself sparse and its
structure is data-dependent, so the work splits as production SpGEMM
libraries split it:

* **symbolic phase** (this module) — one vectorized CSR walk expands every
  Gustavson partial product ``(a_nnz e, b_nnz f)`` and merges them into the
  exact output structure: CSR layout of C, the pp → output-slot map the
  reference executor folds over, and the bloat statistics (paper Eq. 1).
  ``hash_dedup_row_nnz`` discovers the same per-row counts the way the
  HashPad does (linear-probe insertion into a bounded pad) and reports the
  probe counts the analytic path cannot see.
* **hash-pad layout** — the numeric kernel (``kernels/spgemm_pad``)
  accumulates partial products into a ``(block_rows, pad_width)`` pad per
  output row block; bucket = the high bits of ``col · γ_b``.  The symbolic
  phase searches γ_b per block — reseeding until the bucket map is
  injective on every row's output column set — so the kernel needs no tag
  match; if some block cannot be seeded at the current ``pad_width``, the
  pad grows ×2 and the search restarts.

The host part is copied from the reference so that every plan array is
bitwise equal to its own: the same ``default_rng(seed + growths)`` γ draws
and the same pad growth.  ``make_spgemm_plan`` packages it all — plus the
A-side dedup-chunk coefficient tiles, the B-side hashed slab scatter map
and that slab's nonzero cells (``compact_cells``), which is what the
kernels read — into a ``SpgemmPlan`` of tensors on one device; for
``cuda_q8`` it also bakes A's tiles and B's cells as int8 with one scale
per chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.eviction import bloat_percent
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sparse.stats import record_count, record_value

__all__ = ["SpgemmSymbolic", "SpgemmPlan", "symbolic", "make_spgemm_plan",
           "hash_bucket", "hash_dedup_row_nnz", "find_block_gammas",
           "compact_cells", "ALL_SPGEMM_EXECUTORS"]

MAX_PP_INT32 = (1 << 31) - 1


# ---------------------------------------------------------------------------
# Hash-pad bucket map (full-width DRHM-style multiplicative hash)
# ---------------------------------------------------------------------------

def hash_bucket(cols: np.ndarray, gamma, pad_width: int) -> np.ndarray:
    """Bucket of each output column: high bits of ``col · γ  mod 2³²``.

    An odd γ is bijective mod 2³², leaving truncation to
    ``log2(pad_width)`` bits as the only collision source, which the
    per-block reseed search removes.  ``pad_width`` must be a power of two.
    """
    g = np.asarray(gamma, dtype=np.uint64)      # scalar or per-element γ
    prod = (cols.astype(np.uint64) * g) & np.uint64(0xFFFFFFFF)
    shift = 32 - int(pad_width).bit_length() + 1
    return (prod >> np.uint64(shift)).astype(np.int64)


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def _odd_gammas(rng: np.random.Generator, k: int) -> np.ndarray:
    return (rng.integers(1, 2 ** 30, size=k, dtype=np.int64) * 2 + 1).astype(
        np.uint32)


def find_block_gammas(c_indptr: np.ndarray, c_cols: np.ndarray, n_rows: int,
                      block_rows: int, pad_width: int, max_reseeds: int = 8,
                      seed: int = 0
                      ) -> Tuple[Optional[np.ndarray], int, int]:
    """Per-block γ such that buckets are injective on every row's column set.

    Returns (gammas | None, reseeds, collisions): ``None`` means some block
    failed after ``max_reseeds`` draws — the caller grows the pad.  Rows of
    one block share a γ (the pad tile is evicted per block).
    """
    n_blocks = max(1, -(-n_rows // block_rows))
    rng = np.random.default_rng(seed)
    gammas = np.zeros(n_blocks, np.uint32)
    reseeds = 0
    collisions = 0
    for b in range(n_blocks):
        lo, hi = b * block_rows, min((b + 1) * block_rows, n_rows)
        sets = [c_cols[c_indptr[i]:c_indptr[i + 1]] for i in range(lo, hi)
                if c_indptr[i + 1] - c_indptr[i] > 1]
        found = False
        for g in _odd_gammas(rng, max_reseeds):
            coll = 0
            for s in sets:
                coll += s.size - np.unique(hash_bucket(s, g, pad_width)).size
            if coll == 0:
                gammas[b] = g
                found = True
                break
            reseeds += 1
            collisions += coll
        if not found:
            return None, reseeds, collisions
    return gammas, reseeds, collisions


def hash_dedup_row_nnz(pp_row: np.ndarray, pp_col: np.ndarray, n_rows: int,
                       pad_width: int, seed: int = 0):
    """Per-row output nnz discovered the HashPad way: linear-probe insertion
    of each partial product's column tag into a ``pad_width`` table, one
    fresh γ per row.  Exact — dedup by tag equality, probing past occupied
    mismatching lines — and it measures collision behaviour.

    Returns (row_nnz, stats) with stats = {"probes", "occupancy_peak"}.
    O(pp) python — small/medium workloads only.
    """
    assert pad_width == _next_pow2(pad_width)
    order = np.argsort(pp_row, kind="stable")
    rows_s, cols_s = pp_row[order], pp_col[order]
    starts = np.searchsorted(rows_s, np.arange(n_rows + 1))
    gammas = _odd_gammas(np.random.default_rng(seed), n_rows)
    row_nnz = np.zeros(n_rows, np.int64)
    probes = 0
    occupancy_peak = 0
    for i in range(n_rows):
        cols_i = cols_s[starts[i]:starts[i + 1]]
        if cols_i.size == 0:
            continue
        keys = np.full(pad_width, -1, np.int64)
        buckets = hash_bucket(cols_i, gammas[i], pad_width)
        placed = 0
        for col, b in zip(cols_i.tolist(), buckets.tolist()):
            steps = 0
            while keys[b] not in (-1, col):        # occupied by another tag
                probes += 1
                steps += 1
                if steps >= pad_width:             # every line holds another
                    raise ValueError(              # distinct tag ⇒ overflow
                        f"row {i} overflows the {pad_width}-line pad")
                b = (b + 1) % pad_width
            if keys[b] == -1:
                keys[b] = col
                placed += 1
        row_nnz[i] = placed
        occupancy_peak = max(occupancy_peak, placed)
    record_count("hashpad.rows", int(n_rows))
    record_count("hashpad.probes", int(probes))
    record_value("hashpad.occupancy_peak", occupancy_peak / pad_width)
    return row_nnz, {"probes": probes, "occupancy_peak": occupancy_peak}


# ---------------------------------------------------------------------------
# Merge-based symbolic phase (the exact structure the numeric phases fill)
# ---------------------------------------------------------------------------

def _b_csr(b_rows: np.ndarray, b_cols: np.ndarray, n_inner: int):
    """CSR view of B: (order, cols_sorted, deg, indptr) — the one layout
    both the pp expansion and the slab scatter walk over (stable sort, so
    the two consumers index identical positions)."""
    order = np.argsort(b_rows, kind="stable")
    deg = np.bincount(b_rows, minlength=n_inner)
    indptr = np.zeros(n_inner + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    return order, b_cols[order], deg, indptr


def _expand_b_rows(keys: np.ndarray, deg: np.ndarray, indptr: np.ndarray):
    """Positions (into the CSR order) of every nnz of B rows ``keys``,
    concatenated — the vectorized Gustavson expansion.  → (pos, lens,
    total)."""
    lens = deg[keys]
    total = int(lens.sum())
    starts = np.repeat(indptr[keys], lens)
    offs = np.arange(total, dtype=np.int64) \
        - np.repeat(np.cumsum(lens) - lens, lens)
    return starts + offs, lens, total


@dataclasses.dataclass(frozen=True)
class SpgemmSymbolic:
    """Host-side symbolic result for C = A@B (all numpy)."""

    n_rows: int             # rows of A and C
    n_inner: int            # cols of A == rows of B
    n_cols: int             # cols of B and C
    nnz_a: int
    nnz_b: int
    c_indptr: np.ndarray    # (n_rows+1,) int64 — CSR row pointers of C
    c_row: np.ndarray       # (nnz_out,) row-major sorted
    c_col: np.ndarray       # (nnz_out,)
    pp_a: np.ndarray        # (pp_interim,) index into A's nnz per pp
    pp_b: np.ndarray        # (pp_interim,) index into B's nnz per pp
    pp_slot: np.ndarray     # (pp_interim,) output slot each pp folds into
    # B's CSR view (the expansion walked it once; consumers reuse it)
    b_order: Optional[np.ndarray] = None
    b_cols_sorted: Optional[np.ndarray] = None
    b_deg: Optional[np.ndarray] = None
    b_indptr: Optional[np.ndarray] = None

    @property
    def nnz_out(self) -> int:
        return self.c_row.size

    @property
    def pp_interim(self) -> int:
        return self.pp_a.size

    @property
    def row_nnz(self) -> np.ndarray:
        return np.diff(self.c_indptr)

    @property
    def bloat_pct(self) -> float:
        return bloat_percent(self.pp_interim, self.nnz_out)


def symbolic(a_rows: np.ndarray, a_cols: np.ndarray, n_rows: int,
             b_rows: np.ndarray, b_cols: np.ndarray, n_inner: int,
             n_cols: Optional[int] = None) -> SpgemmSymbolic:
    """Exact Gustavson symbolic phase: one vectorized CSR walk.

    Expands every partial product ``A[i,k]·B[k,j]`` (Eq. 1's numerator) and
    merges by output coordinate; ``pp_a``/``pp_b``/``pp_slot`` are what
    the reference executor folds over in rolling-eviction waves.
    """
    a_rows = np.asarray(a_rows, np.int64)
    a_cols = np.asarray(a_cols, np.int64)
    b_rows = np.asarray(b_rows, np.int64)
    b_cols = np.asarray(b_cols, np.int64)
    n_cols = int(n_cols) if n_cols is not None else int(n_inner)
    if a_rows.size and int(a_rows.max()) >= n_rows:
        raise ValueError("a_rows exceed n_rows")
    if a_cols.size and int(a_cols.max()) >= n_inner:
        raise ValueError("a_cols exceed the inner dimension")
    if b_rows.size and int(b_rows.max()) >= n_inner:
        raise ValueError("b_rows exceed the inner dimension")
    if b_cols.size and int(b_cols.max()) >= n_cols:
        raise ValueError("b_cols exceed n_cols")

    b_order, b_cols_sorted, deg_b, b_indptr = _b_csr(b_rows, b_cols, n_inner)
    b_pos, lens, total = _expand_b_rows(a_cols, deg_b, b_indptr)
    if total > MAX_PP_INT32:
        raise ValueError(f"{total} interim partial products overflow int32 "
                         "slot maps; shard the matrix first")
    pp_a = np.repeat(np.arange(a_rows.size, dtype=np.int64), lens)
    pp_b = b_order[b_pos]
    pp_row = a_rows[pp_a]
    pp_col = b_cols_sorted[b_pos]

    keys = pp_row * np.int64(n_cols) + pp_col
    uniq, pp_slot = np.unique(keys, return_inverse=True)
    c_row = (uniq // n_cols).astype(np.int64)
    c_col = (uniq % n_cols).astype(np.int64)
    c_indptr = np.searchsorted(c_row, np.arange(n_rows + 1))
    return SpgemmSymbolic(
        n_rows=int(n_rows), n_inner=int(n_inner), n_cols=n_cols,
        nnz_a=int(a_rows.size), nnz_b=int(b_rows.size),
        c_indptr=c_indptr, c_row=c_row, c_col=c_col,
        pp_a=pp_a, pp_b=pp_b, pp_slot=pp_slot.astype(np.int64),
        b_order=b_order, b_cols_sorted=b_cols_sorted, b_deg=deg_b,
        b_indptr=b_indptr)


# ---------------------------------------------------------------------------
# SpgemmPlan — the device-side package
# ---------------------------------------------------------------------------

T = Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Precomputed layouts for every SpGEMM executor (see numeric.py), as
    tensors on one device.  Structure is baked at plan time; values
    (``a_vals``/``b_vals``) may be swapped per call — ``None`` uses the
    baked ``a_base``/``b_base``.  Array dtypes are the reference's.
    """

    # --- layout sizes ---
    n_rows: int
    n_inner: int
    n_cols: int
    nnz_a: int
    nnz_b: int
    nnz_out: int
    pp_interim: int          # Eq.-1 interim partial products (exact)
    pp_dedup: int            # slab entries after operand dedup (≤ pp_interim)
    pad_width: int           # hash-pad lanes per output row (power of two)
    block_rows: int
    n_blocks: int
    n_chunks: int
    width: int               # distinct operands per chunk (A-side layout)
    chunk: int               # reference executor's rolling-eviction wave
    n_waves: int
    reseeds: int             # γ draws burned by the injectivity search
    collisions: int          # bucket collisions seen during the search
    pad_growths: int         # ×2 pad expansions before every block seeded
    n_cells: int             # B's compact cells (≤ pp_dedup; 0 without cuda)

    # --- COO inputs (structure; values are the *_base defaults) ---
    a_rows: T = None     # (nnz_a,) int32
    a_cols: T = None     # (nnz_a,) int32
    a_base: T = None     # (nnz_a,) f32
    b_rows: T = None     # (nnz_b,) int32
    b_cols: T = None     # (nnz_b,) int32
    b_base: T = None     # (nnz_b,) f32

    # --- symbolic output structure ---
    c_indptr: T = None   # (n_rows+1,) int32
    c_row: T = None      # (nnz_out,) int32
    c_col: T = None      # (nnz_out,) int32

    # --- reference executor: pp maps, padded to a chunk multiple ---
    pp_a: T = None       # (n_waves·chunk,) int32
    pp_b: T = None       # (n_waves·chunk,) int32
    pp_slot: T = None    # (n_waves·chunk,) int32; pad ⇒ ghost slot nnz_out

    # --- cuda executor: A coefficient tiles + hashed B slab + gather ---
    # (slab_* is the reference's scatter map of the dense hashed slab; the
    # kernels read its nonzero cells, cell_*, and gather C through
    # c_indptr and out_bucket)
    ell_u_cols: T = None     # (n_chunks, width) int32
    ell_a: T = None          # (n_chunks·block_rows, width) f32
    ell_out_block: T = None  # (n_chunks,) int32
    ell_first: T = None      # (n_chunks,) int32
    ell_evict: T = None      # (n_chunks,) int32 — row completion
    ell_slots: T = None      # (nnz_a,) int32 into ell_a flat
    ell_remaining: T = None  # (n_chunks,) int32 — live lanes per chunk
    ell_block_ptr: T = None  # (n_blocks+1,) int32 — chunk range per block
    slab_row: T = None       # (pp_dedup,) int32 — slab lane
    slab_col: T = None       # (pp_dedup,) int32 — pad bucket
    slab_src: T = None       # (pp_dedup,) int32 into b vals
    out_row: T = None        # (nnz_out,) int32 into c_pad rows
    out_bucket: T = None     # (nnz_out,) int32 into pad lanes
    gammas: T = None         # (n_blocks,) uint32 — per-block γ

    # --- B's compact cells: the hashed slab's distinct (lane, bucket) ----
    # chunk by chunk, each chunk's cells ordered by (bucket, lane), so a
    # run of equal buckets is one pad column's work for the chunk
    cell_ptr: T = None       # (n_chunks+1,) int32 — chunk k's cells
    cell_lane: T = None      # (n_cells,) int32 — lane u within the chunk
    cell_bucket: T = None    # (n_cells,) int32 — pad bucket
    cell_val: T = None       # (n_cells,) f32 — b_base summed per cell
    cell_src: T = None       # (pp_dedup,) int32 — slab_src grouped by cell
    cell_src_ptr: T = None   # (n_cells+1,) int32 — each cell's cell_src

    # --- cuda_q8 executor: baked int8 A tiles + quantized B cells ---
    # (the default-values path then quantizes nothing at run time)
    ell_a_q8: T = None       # (n_chunks·block_rows, width) int8
    ell_a_scale: T = None    # (n_chunks,) f32
    cell_q8: T = None        # (n_cells,) int8 — cell_val quantized
    slab_scale: T = None     # (n_chunks,) f32 — per chunk, as the dense slab

    @property
    def bloat_pct(self) -> float:
        return bloat_percent(self.pp_interim, self.nnz_out)

    @property
    def peak_live_pp(self) -> dict:
        """Live interim partial products per schedule: ``barrier`` holds
        the whole bloat, ``rolling`` one wave, ``hashpad`` one resident pad
        tile + one landing slab tile."""
        return {
            "barrier": self.pp_interim,
            "rolling": min(self.chunk, self.pp_interim),
            "hashpad": (self.block_rows + self.width) * self.pad_width,
        }

    @property
    def device(self) -> torch.device:
        return self.c_indptr.device


# ---------------------------------------------------------------------------
# Plan builder
# ---------------------------------------------------------------------------

ALL_SPGEMM_EXECUTORS = ("dense", "reference", "cuda", "cuda_q8")


def make_spgemm_plan(a_rows: np.ndarray, a_cols: np.ndarray, n_rows: int,
                     b_rows: np.ndarray, b_cols: np.ndarray, n_inner: int,
                     n_cols: Optional[int] = None, *,
                     a_vals: Optional[np.ndarray] = None,
                     b_vals: Optional[np.ndarray] = None,
                     executors: Sequence[str] = ALL_SPGEMM_EXECUTORS,
                     block_rows: int = 8, width_cap: int = 128,
                     width_multiple: int = 16, chunk: int = 8192,
                     pad_slack: float = 2.0, max_reseeds: int = 8,
                     max_pad_width: int = 1 << 16, seed: int = 0,
                     device: DeviceLike = None) -> SpgemmPlan:
    """Symbolic phase + the requested numeric layouts, packaged once on
    ``device`` (default ``cuda``).

    A is (n_rows × n_inner), B is (n_inner × n_cols), both COO; ``*_vals``
    default to implicit 1.0.  Builds the exact output CSR structure (always
    — the ``dense`` oracle needs nothing more), plus, per ``executors``:

    * ``reference`` — the chunk-padded pp → slot wave maps (O(pp_interim)
      memory — the Table-1 bloat itself);
    * ``cuda`` — the hash-pad layout: A packed into dedup-chunk coefficient
      tiles (with each chunk's live-lane count and each block's chunk
      range, which the kernel walks), per-block γ found by reseeded search,
      B's rows hashed into a per-chunk slab scatter map, that slab's
      nonzero cells (``compact_cells``) with the plan's B values summed
      into them, and the pad → C gather;
    * ``cuda_q8`` — the same layout, plus the A tiles and B's cells
      quantized to int8 with one scale per chunk (``_bake_q8``).
    """
    for ex in executors:
        if ex not in ALL_SPGEMM_EXECUTORS:
            raise KeyError(f"unknown spgemm executor {ex!r}; have "
                           f"{ALL_SPGEMM_EXECUTORS}")
    dev = resolve_device(device)

    def t(x, dtype=None):
        x = np.asarray(x) if dtype is None else np.asarray(x, dtype)
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def i32(x):
        return t(x, np.int32)

    a_rows = np.asarray(a_rows, np.int64)
    a_cols = np.asarray(a_cols, np.int64)
    b_rows = np.asarray(b_rows, np.int64)
    b_cols = np.asarray(b_cols, np.int64)
    av = (np.ones(a_rows.size, np.float32) if a_vals is None
          else np.asarray(a_vals, np.float32))
    bv = (np.ones(b_rows.size, np.float32) if b_vals is None
          else np.asarray(b_vals, np.float32))
    sym = symbolic(a_rows, a_cols, n_rows, b_rows, b_cols, n_inner, n_cols)
    pp = sym.pp_interim
    kw = dict(
        n_rows=sym.n_rows, n_inner=sym.n_inner, n_cols=sym.n_cols,
        nnz_a=sym.nnz_a, nnz_b=sym.nnz_b, nnz_out=sym.nnz_out,
        pp_interim=pp,
        a_rows=i32(a_rows), a_cols=i32(a_cols), a_base=t(av),
        b_rows=i32(b_rows), b_cols=i32(b_cols), b_base=t(bv),
        c_indptr=i32(sym.c_indptr), c_row=i32(sym.c_row),
        c_col=i32(sym.c_col),
        pp_dedup=0, pad_width=0, block_rows=int(block_rows), n_blocks=0,
        n_chunks=0, width=0, chunk=max(1, min(int(chunk), max(pp, 1))),
        n_waves=0, reseeds=0, collisions=0, pad_growths=0, n_cells=0)

    if "reference" in executors:
        # pp → slot maps padded to a wave multiple (ghost slot for padding)
        chunk_eff = kw["chunk"]
        n_waves = -(-pp // chunk_eff) if pp else 0
        pp_pad = n_waves * chunk_eff
        pp_a = np.zeros(pp_pad, np.int64)
        pp_b = np.zeros(pp_pad, np.int64)
        pp_slot = np.full(pp_pad, sym.nnz_out, np.int64)
        pp_a[:pp], pp_b[:pp], pp_slot[:pp] = sym.pp_a, sym.pp_b, sym.pp_slot
        kw.update(n_waves=int(n_waves), pp_a=i32(pp_a), pp_b=i32(pp_b),
                  pp_slot=i32(pp_slot))

    if "cuda" in executors or "cuda_q8" in executors:
        # --- A coefficient tiles (the SpMM path's packer) -----------------
        from repro_torch.sparse.graph import pack_dedup_chunks
        from repro_torch.sparse.plan import block_ptr_from_first
        ch = pack_dedup_chunks(a_rows, a_cols, av, int(n_rows),
                               int(n_inner), block_rows=block_rows,
                               width_cap=width_cap,
                               width_multiple=width_multiple)
        n_chunks, width = ch.u_cols.shape
        evict = np.ones(n_chunks, np.int32)
        evict[:-1] = (ch.out_block[1:] != ch.out_block[:-1]).astype(np.int32)

        # --- per-block γ: reseed until injective, grow the pad on failure -
        max_row = int(sym.row_nnz.max(initial=0))
        pad_width = _next_pow2(max(int(max_row * pad_slack), 8))
        growths = 0
        reseeds = 0      # accumulated across pad growths — the full search
        collisions = 0
        while True:
            gammas, att_reseeds, att_collisions = find_block_gammas(
                sym.c_indptr, sym.c_col, int(n_rows), block_rows, pad_width,
                max_reseeds=max_reseeds, seed=seed + growths)
            reseeds += att_reseeds
            collisions += att_collisions
            if gammas is not None:
                break
            pad_width *= 2
            growths += 1
            if pad_width > max_pad_width:
                raise ValueError(
                    f"no injective bucket map below pad_width="
                    f"{max_pad_width}; raise max_pad_width or shard the "
                    "rows")

        # --- hashed B slab: one scatter map entry per dedup'd pp ----------
        lane_live = np.arange(width)[None, :] < ch.remaining[:, None]
        lane_flat = (np.arange(n_chunks)[:, None] * width
                     + np.arange(width)[None, :])[lane_live]
        ks = ch.u_cols[lane_live].astype(np.int64)      # B row per lane
        g_lane = np.repeat(gammas[ch.out_block], ch.remaining)
        b_pos, lens, total = _expand_b_rows(ks, sym.b_deg, sym.b_indptr)
        slab_src = sym.b_order[b_pos]
        slab_row = np.repeat(lane_flat, lens)
        slab_col = hash_bucket(sym.b_cols_sorted[b_pos],
                               np.repeat(g_lane, lens), pad_width)

        # --- B's compact cells: B values summed per cell in entry order ----
        cells, entry_cell = compact_cells(slab_row, slab_col, slab_src,
                                          int(n_chunks), int(width),
                                          int(pad_width))
        cell_val = np.zeros(cells["cell_lane"].size, np.float32)
        np.add.at(cell_val, entry_cell, bv[slab_src])

        # --- pad → C gather -----------------------------------------------
        out_bucket = hash_bucket(sym.c_col,
                                 gammas[sym.c_row // block_rows], pad_width)
        record_count("spgemm.plans")
        record_count("spgemm.reseeds", reseeds)
        record_count("spgemm.collisions", collisions)
        record_count("spgemm.pad_growths", growths)
        record_value("spgemm.pad_width", pad_width)
        record_value("spgemm.pad_occupancy", max_row / pad_width)
        record_value("spgemm.bloat_pct", sym.bloat_pct)
        record_value("spgemm.chunk_width", width)
        kw.update(
            pp_dedup=int(total), pad_width=int(pad_width),
            n_blocks=int(ch.n_blocks), n_chunks=int(n_chunks),
            width=int(width), reseeds=int(reseeds),
            collisions=int(collisions), pad_growths=int(growths),
            ell_u_cols=t(ch.u_cols), ell_a=t(ch.a),
            ell_out_block=t(ch.out_block), ell_first=t(ch.first),
            ell_evict=t(evict), ell_slots=t(ch.slots),
            ell_remaining=t(ch.remaining),
            ell_block_ptr=t(block_ptr_from_first(ch.first, ch.n_blocks)),
            slab_row=i32(slab_row), slab_col=i32(slab_col),
            slab_src=i32(slab_src),
            out_row=i32(sym.c_row), out_bucket=i32(out_bucket),
            gammas=t(gammas), n_cells=int(cell_val.size),
            cell_val=t(cell_val), **{k: i32(v) for k, v in cells.items()})
        if "cuda_q8" in executors:
            kw.update(_bake_q8(kw["ell_a"], kw["cell_val"], kw["cell_ptr"],
                               int(n_chunks)))

    return SpgemmPlan(**kw)


def compact_cells(slab_row: np.ndarray, slab_col: np.ndarray,
                  slab_src: np.ndarray, n_chunks: int, width: int,
                  pad_width: int) -> Tuple[dict, np.ndarray]:
    """The hashed B slab as its nonzero cells, in the layout the kernels
    walk.  A cell is one distinct (slab row, bucket) of the scatter map
    ``slab_row``/``slab_col``/``slab_src``; entries that share one
    (duplicate B entries) are one cell whose value is their sum.

    Returns ``(fields, entry_cell)``: ``fields`` holds the plan's
    ``cell_ptr`` (n_chunks+1,), ``cell_lane``, ``cell_bucket`` (n_cells,),
    ``cell_src`` (pp_dedup,) and ``cell_src_ptr`` (n_cells+1,), with chunk
    k's cells at ``cell_ptr[k] .. cell_ptr[k+1]`` ordered by (bucket,
    lane) and cell c's B entries at ``cell_src[cell_src_ptr[c] ..
    cell_src_ptr[c+1]]`` in entry order; ``entry_cell`` maps each scatter
    map entry to its cell."""
    row = np.asarray(slab_row, np.int64)
    chunk = row // width
    key = (chunk * pad_width + np.asarray(slab_col, np.int64)) * width \
        + (row - chunk * width)
    order = np.argsort(key, kind="stable")     # entry order within a cell
    skey = key[order]
    new = np.ones(skey.size, bool)
    new[1:] = skey[1:] != skey[:-1]
    starts = np.flatnonzero(new)
    ukey = skey[starts]
    entry_cell = np.empty(key.size, np.int64)
    entry_cell[order] = np.cumsum(new) - 1
    fields = dict(
        cell_ptr=np.searchsorted(ukey // (pad_width * width),
                                 np.arange(n_chunks + 1)),
        cell_lane=ukey % width, cell_bucket=(ukey // width) % pad_width,
        cell_src=np.asarray(slab_src)[order],
        cell_src_ptr=np.append(starts, key.size))
    return fields, entry_cell


def _bake_q8(ell_a: torch.Tensor, cell_val: torch.Tensor,
             cell_ptr: torch.Tensor, n_chunks: int) -> dict:
    """int8 A tiles and B cells, bitwise equal to the reference's bake (a
    host ``np.add.at`` into the dense f32 slab, then
    ``quantize_chunk_tiles``) at every cell, without a dense slab.

    ``cell_val`` already sums the entries that share a cell in entry order,
    as ``np.add.at`` sums them; a chunk's scale is the max over its cells,
    which is the dense tile's max, and every other slab entry is zero.
    ``numeric.hashed_slab_q8`` scatters the int8 cells into the dense
    layout."""
    from repro_torch.sparse.quantize import (quantize_chunk_entries,
                                             quantize_chunk_tiles,
                                             record_q8_stats)
    a_q8, a_scale = quantize_chunk_tiles(ell_a, n_chunks)
    cell_q8, slab_scale = quantize_chunk_entries(
        cell_val, cell_chunk(cell_ptr, cell_val.numel()), n_chunks)
    record_q8_stats(a_scale)
    record_q8_stats(slab_scale)
    return dict(ell_a_q8=a_q8, ell_a_scale=a_scale, cell_q8=cell_q8,
                slab_scale=slab_scale)


def cell_chunk(cell_ptr: torch.Tensor, n_cells: int) -> torch.Tensor:
    """The chunk of each compact cell, on ``cell_ptr``'s device."""
    n_chunks = cell_ptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(n_chunks, device=cell_ptr.device),
        (cell_ptr[1:] - cell_ptr[:-1]).to(torch.int64), output_size=n_cells)
