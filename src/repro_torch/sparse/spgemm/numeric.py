"""SpGEMM numeric phase — four interchangeable executors over one plan.
Port of ``repro.sparse.spgemm.numeric``.

The symbolic phase (``sparse.spgemm.symbolic``) froze the output structure;
the numeric phase fills ``c_vals`` (one float per output nonzero, in the
plan's row-major CSR order).  Executors, registered in
``repro_torch.sparse.backend``:

* ``dense``     — tiny-size oracle: densify B (size-guarded
                  ``core.spgemm.spgemm_via_dense``), gather the structural
                  entries.  The parity baseline, never a production path;
* ``reference`` — rolling eviction: the pp → slot maps fold in fixed-size
                  waves through ``core.eviction.rolling_accumulate`` (paper
                  C3 — the live interim set is one wave, not the bloat);
* ``cuda``      — the hash-pad kernel (``kernels/spgemm_pad``), the
                  counterpart of the reference's ``pallas``: A's dedup-chunk
                  coefficient tiles × the hashed B slab, folded into a pad
                  held in registers, evicted at the block's last chunk;
* ``cuda_q8``   — the int8 hash-pad kernel on the same layout, the
                  counterpart of ``pallas_q8``: both operands int8 with one
                  scale per chunk.  With the plan's values it reads the
                  int8 slab baked at plan time and builds no slab at all.

Values may be swapped per call (``a_vals``/``b_vals``; ``None`` uses the
baked defaults) — structure is plan state, values are data.  That split is
what makes the Â² workloads cheap: ``two_hop_graph`` runs SpGEMM once per
graph, then every step is plain SpMM on the Â² plan.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import spgemm as core_spgemm
from repro_torch.core.eviction import rolling_accumulate
from repro_torch.sparse.backend import SpgemmBackend, register_spgemm_backend
from repro_torch.sparse.plan import scatter_tiles
from repro_torch.sparse.spgemm.symbolic import SpgemmPlan, make_spgemm_plan
from repro_torch.sparse.stats import record_value

__all__ = ["hashed_slab", "spgemm_to_coo", "two_hop_graph",
           "cached_two_hop_graph", "two_hop_cache_clear"]


def _vals(plan: SpgemmPlan, vals, base: torch.Tensor) -> torch.Tensor:
    if vals is None:
        return base
    return torch.as_tensor(vals, device=plan.device).to(torch.float32)


def _require_layout(plan: SpgemmPlan, field: str, executor: str) -> None:
    if getattr(plan, field) is None:
        raise ValueError(
            f"plan lacks the {executor!r} layout; build it with "
            f"make_spgemm_plan(..., executors=({executor!r}, ...))")


# ---------------------------------------------------------------------------
# dense — size-guarded densify-B oracle (tests/benchmarks only)
# ---------------------------------------------------------------------------

def _dense_spgemm(plan: SpgemmPlan, a_vals, b_vals) -> torch.Tensor:
    c = core_spgemm.spgemm_via_dense(
        plan.a_rows, plan.a_cols, _vals(plan, a_vals, plan.a_base),
        plan.n_rows, plan.b_rows, plan.b_cols,
        _vals(plan, b_vals, plan.b_base), plan.n_inner, plan.n_cols)
    return c[plan.c_row.long(), plan.c_col.long()]


# ---------------------------------------------------------------------------
# reference — rolling-eviction waves over the pp → slot maps (paper C3)
# ---------------------------------------------------------------------------

def _reference_spgemm(plan: SpgemmPlan, a_vals, b_vals) -> torch.Tensor:
    av = _vals(plan, a_vals, plan.a_base)
    bv = _vals(plan, b_vals, plan.b_base)
    if plan.pp_interim:
        _require_layout(plan, "pp_a", "reference")
    if plan.n_waves == 0:
        return torch.zeros((plan.nnz_out,), dtype=torch.float32,
                           device=plan.device)
    pa = plan.pp_a.reshape(plan.n_waves, plan.chunk)
    pb = plan.pp_b.reshape(plan.n_waves, plan.chunk)
    ps = plan.pp_slot.reshape(plan.n_waves, plan.chunk)

    def produce(w):
        pp = av[pa[w].long()] * bv[pb[w].long()]
        return pp[:, None], ps[w]

    # one ghost slot: padding pps fold into row nnz_out and are dropped
    acc = rolling_accumulate(produce, plan.n_waves, plan.nnz_out + 1, 1,
                             device=plan.device)
    return acc[: plan.nnz_out, 0]


# ---------------------------------------------------------------------------
# cuda — hash-pad kernel on the dedup-chunk + hashed-slab layout
# ---------------------------------------------------------------------------

def hashed_slab(plan: SpgemmPlan, b_vals=None) -> torch.Tensor:
    """The dense hashed B slab ``(n_chunks·width, pad_width)``: lane u of
    chunk k holds B row ``u_cols[k, u]``, each value at its output column's
    bucket.  Entries that share a cell (duplicate B entries) add."""
    _require_layout(plan, "slab_row", "cuda")
    bv = _vals(plan, b_vals, plan.b_base)
    slab = torch.zeros((plan.n_chunks * plan.width, plan.pad_width),
                       dtype=torch.float32, device=plan.device)
    slab.index_put_((plan.slab_row.long(), plan.slab_col.long()),
                    bv[plan.slab_src.long()], accumulate=True)
    return slab


def _cuda_spgemm(plan: SpgemmPlan, a_vals, b_vals) -> torch.Tensor:
    from repro_torch.kernels.spgemm_pad import spgemm_hashpad
    _require_layout(plan, "ell_a", "cuda")
    # A values given: scatter-add through the packer's slot map (duplicate
    # A entries share a cell), the SpMM path's coefficient scatter
    a_tiles = plan.ell_a if a_vals is None else scatter_tiles(
        plan.ell_a, plan.ell_slots, _vals(plan, a_vals, plan.a_base))
    c_pad = spgemm_hashpad(plan.ell_remaining, plan.ell_block_ptr, a_tiles,
                           hashed_slab(plan, b_vals),
                           block_rows=plan.block_rows,
                           pad_width=plan.pad_width)
    return c_pad[plan.out_row.long(), plan.out_bucket.long()]


def _cuda_q8_spgemm(plan: SpgemmPlan, a_vals, b_vals) -> torch.Tensor:
    from repro_torch.kernels.spgemm_pad import spgemm_hashpad_q8
    from repro_torch.sparse.quantize import quantize_chunk_tiles
    _require_layout(plan, "ell_a", "cuda_q8")
    if a_vals is None and plan.ell_a_q8 is not None:
        a_q8, a_scale = plan.ell_a_q8, plan.ell_a_scale
    else:
        a_tiles = plan.ell_a if a_vals is None else scatter_tiles(
            plan.ell_a, plan.ell_slots, _vals(plan, a_vals, plan.a_base))
        a_q8, a_scale = quantize_chunk_tiles(a_tiles, plan.n_chunks)
    if b_vals is None and plan.slab_q8 is not None:
        # the baked int8 slab: no scatter at run time, where the f32
        # executor rebuilds its slab on every call
        slab_q8, slab_scale = plan.slab_q8, plan.slab_scale
    else:
        slab_q8, slab_scale = quantize_chunk_tiles(hashed_slab(plan, b_vals),
                                                   plan.n_chunks)
    c_pad = spgemm_hashpad_q8(plan.ell_remaining, plan.ell_block_ptr, a_q8,
                              a_scale, slab_q8, slab_scale,
                              block_rows=plan.block_rows,
                              pad_width=plan.pad_width)
    return c_pad[plan.out_row.long(), plan.out_bucket.long()]


register_spgemm_backend(SpgemmBackend("dense", _dense_spgemm))
register_spgemm_backend(SpgemmBackend("reference", _reference_spgemm))
register_spgemm_backend(SpgemmBackend("cuda", _cuda_spgemm))
register_spgemm_backend(SpgemmBackend("cuda_q8", _cuda_q8_spgemm))


# ---------------------------------------------------------------------------
# Workloads the engine opens: Â² two-hop graphs (+ coarsening in sparse.graph)
# ---------------------------------------------------------------------------

def spgemm_to_coo(plan: SpgemmPlan, c_vals: torch.Tensor):
    """(rows, cols, vals) of C in the plan's row-major order."""
    return plan.c_row, plan.c_col, c_vals


def two_hop_graph(g, *, backend: str = "reference",
                  drop_self_loops: bool = True, pad_multiple: int = 128,
                  **plan_kwargs):
    """Â² as a Graph on ``g``'s device: one SpGEMM per graph, then every
    step is SpMM.

    Edge (j → i) of the result means a 2-path j → k → i exists in ``g``;
    its weight is the path-count (or the path-weight product sum when ``g``
    is weighted).  ``drop_self_loops`` removes the diagonal (closed 2-paths
    i → k → i).  The wall seconds of the three phases — host symbolic,
    numeric (executor plus the copy of C's values to the host), re-pack
    into a Graph — are recorded as ``two_hop.{symbolic,numeric,repack}_s``.
    """
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse.graph import graph_coo, make_graph
    dev = g.senders.device
    s, r, w = graph_coo(g)
    n = int(g.n_nodes)
    t0 = time.perf_counter()
    # aggregation viewpoint everywhere in the repo: A[receiver, sender];
    # only the executor actually running needs its layout built
    plan = make_spgemm_plan(r, s, n, r, s, n, a_vals=w, b_vals=w,
                            executors=(backend,), device=dev, **plan_kwargs)
    t1 = time.perf_counter()
    c_vals = sb.spgemm(plan, backend=backend).cpu().numpy()
    t2 = time.perf_counter()
    cr = plan.c_row.cpu().numpy()
    cc = plan.c_col.cpu().numpy()
    if drop_self_loops:
        keep = cr != cc
        cr, cc, c_vals = cr[keep], cc[keep], c_vals[keep]
    # rows are receivers ⇒ Graph(senders=c_col, receivers=c_row)
    g2 = make_graph(cc.astype(np.int32), cr.astype(np.int32), n,
                    edge_weight=c_vals.astype(np.float32),
                    pad_multiple=pad_multiple, device=dev)
    t3 = time.perf_counter()
    record_value("two_hop.symbolic_s", t1 - t0)
    record_value("two_hop.numeric_s", t2 - t1)
    record_value("two_hop.repack_s", t3 - t2)
    return g2


# -- two-hop cache: one SpGEMM per static graph, not one per step build ----

TWO_HOP_CACHE_MAXSIZE = 8

_TWO_HOP_CACHE: "dict[tuple, tuple]" = {}


def _graph_key(g, kwargs):
    ids = tuple(None if a is None else id(a)
                for a in (g.senders, g.receivers, g.edge_weight,
                          g.edge_valid))
    return ids + (g.n_nodes, tuple(sorted(kwargs.items())))


def _same_graph(a, b) -> bool:
    return (a.senders is b.senders and a.receivers is b.receivers
            and a.edge_weight is b.edge_weight
            and a.edge_valid is b.edge_valid)


def cached_two_hop_graph(g, **kwargs):
    """``two_hop_graph`` behind an LRU cache keyed on the graph's tensor
    identity — the SpGEMM (symbolic + numeric) runs once per static
    graph."""
    key = _graph_key(g, kwargs)
    entry = _TWO_HOP_CACHE.get(key)
    if entry is not None and _same_graph(entry[0], g):
        del _TWO_HOP_CACHE[key]
        _TWO_HOP_CACHE[key] = entry
        return entry[1]
    g2 = two_hop_graph(g, **kwargs)
    _TWO_HOP_CACHE[key] = (g, g2)
    while len(_TWO_HOP_CACHE) > TWO_HOP_CACHE_MAXSIZE:
        _TWO_HOP_CACHE.pop(next(iter(_TWO_HOP_CACHE)))
    return g2


def two_hop_cache_clear() -> None:
    _TWO_HOP_CACHE.clear()
