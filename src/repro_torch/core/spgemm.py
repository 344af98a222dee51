"""Decoupled Gustavson SpMM — the paper's C1, in PyTorch.

    multiply_stage :  pp[e]  = A_val[e] * X[A_col[e], :]        (gather-bound)
    accumulate     :  Y[r]   = segment_sum(pp, A_row, n_rows)   (scatter-bound)

These are the bodies of the ``dense`` and ``chunked`` executors;
``spmm``/``spmm_masked`` are the decoupled SpMM as one call (over a padded
edge list for the masked one), ``spmm_chunked`` its rolling-eviction
variant, and ``spgemm_via_dense`` the sparse×sparse tiny-size oracle.  As
JAX's ``segment_sum``, the merge drops row ids outside ``[0, n_rows)``
(the padding-edge convention: padding lanes point at row ``n_rows``).

Both stages are order-fixed on the card as on the CPU, forward and
backward: they gather and merge through ``sparse.segment_ops``' ordered
``gather`` and ``segment_sum`` (on CUDA, ``index_select``'s backward and
``index_add_`` would add a repeated row by atomics, in no fixed order).
``order``/``order_of`` hand them the orders an ``AggregationPlan`` keeps;
without them each call sorts its ids.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.sparse.segment_ops import SegmentOrder, gather, segment_sum

# ``AggregationPlan.order``: (axis, lo, hi) → the SegmentOrder of
# rows/cols[lo:hi]
OrderOf = Optional[Callable[[str, int, int], SegmentOrder]]


def multiply_stage(cols: torch.Tensor, vals: Optional[torch.Tensor],
                   x: torch.Tensor,
                   order: Optional[SegmentOrder] = None) -> torch.Tensor:
    """Partial products for every nnz: pp[e] = vals[e] * x[cols[e]]."""
    pp = gather(x, cols, order)
    if vals is not None:
        pp = pp * vals.to(pp.dtype).reshape((-1,) + (1,) * (pp.ndim - 1))
    return pp


def accumulate_stage(pp: torch.Tensor, rows: torch.Tensor, n_rows: int,
                     order: Optional[SegmentOrder] = None) -> torch.Tensor:
    """Merge partial products by destination row; rows outside
    ``[0, n_rows)`` drop."""
    return segment_sum(pp, rows, n_rows, order)


def spmm(rows: torch.Tensor, cols: torch.Tensor,
         vals: Optional[torch.Tensor], x: torch.Tensor,
         n_rows: int) -> torch.Tensor:
    """Y = A @ X with A as COO (rows, cols, vals): the multiply stage, then
    the accumulate stage.  Padding edges point at row ``n_rows`` and drop."""
    return accumulate_stage(multiply_stage(cols, vals, x), rows, n_rows)


def spmm_masked(rows: torch.Tensor, cols: torch.Tensor,
                vals: Optional[torch.Tensor], x: torch.Tensor, n_rows: int,
                valid: torch.Tensor) -> torch.Tensor:
    """SpMM over a padded edge list: lanes where ``valid`` is false
    contribute nothing."""
    pp = multiply_stage(cols, vals, x)
    pp = pp.masked_fill(~valid.bool().reshape((-1,) + (1,) * (pp.ndim - 1)),
                        0)
    return accumulate_stage(pp, rows, n_rows)


def _chunk_bounds(e: int, chunk: int):
    chunk = max(1, min(chunk, e))
    return range(0, e, chunk), chunk


def _wave_orders(order_of: OrderOf, lo: int, hi: int):
    if order_of is None:
        return None, None
    return order_of("rows", lo, hi), order_of("cols", lo, hi)


def spmm_chunked(rows: torch.Tensor, cols: torch.Tensor,
                 vals: Optional[torch.Tensor], x: torch.Tensor, n_rows: int,
                 chunk: int = 8192, order_of: OrderOf = None) -> torch.Tensor:
    """Rolling-eviction SpMM (paper C3): edges are processed in
    ``chunk``-sized waves, and each wave's partial products are folded into
    the output at once, so peak interim memory is O(chunk · D)."""
    acc = x.new_zeros((n_rows,) + x.shape[1:])
    e = rows.shape[0]
    starts, chunk = _chunk_bounds(e, chunk)
    for lo in starts:
        hi = min(lo + chunk, e)
        r_order, c_order = _wave_orders(order_of, lo, hi)
        v = None if vals is None else vals[lo:hi]
        pp = multiply_stage(cols[lo:hi], v, x, c_order)
        acc = acc + accumulate_stage(pp, rows[lo:hi], n_rows, r_order)
    return acc


def segment_sum_chunked(rows: torch.Tensor, messages: torch.Tensor,
                        n_rows: int, chunk: int = 8192,
                        order_of: OrderOf = None) -> torch.Tensor:
    """Accumulate-only rolling eviction: fold precomputed per-edge messages
    into their destination rows in ``chunk``-sized waves."""
    acc = messages.new_zeros((n_rows,) + messages.shape[1:])
    e = rows.shape[0]
    starts, chunk = _chunk_bounds(e, chunk)
    for lo in starts:
        hi = min(lo + chunk, e)
        r_order, _ = _wave_orders(order_of, lo, hi)
        acc = acc + accumulate_stage(messages[lo:hi], rows[lo:hi], n_rows,
                                     r_order)
    return acc


# ---------------------------------------------------------------------------
# SpGEMM (sparse × sparse) — tiny-size oracle only
# ---------------------------------------------------------------------------

# densified-B cells above which the oracle refuses to run: the production
# sparse-output path is repro_torch.sparse.spgemm (symbolic + numeric)
MAX_DENSE_ORACLE_ELEMENTS = 1 << 24


def spgemm_via_dense(a_rows, a_cols, a_vals, n, b_rows, b_cols, b_vals, m, k,
                     max_dense_elements: int = MAX_DENSE_ORACLE_ELEMENTS):
    """Tiny-size test oracle for C = A@B with A (n×m), B (m×k) as COO
    tensors on one device → dense (n, k) f32.

    Densifies B — O(m·k) memory — so it is size-guarded: anything above
    ``max_dense_elements`` cells must go through the sparse-output engine
    (``repro_torch.sparse.spgemm``), which this oracle exists to verify.
    """
    if m * k > max_dense_elements:
        raise ValueError(
            f"spgemm_via_dense would materialize {m}×{k} = {m * k} cells "
            f"(> {max_dense_elements}); use the sparse-output engine "
            "(repro_torch.sparse.spgemm) instead")
    b_dense = torch.zeros((m, k), dtype=torch.float32, device=b_vals.device)
    b_dense.index_put_((b_rows.long(), b_cols.long()),
                       b_vals.to(torch.float32), accumulate=True)
    return spmm(a_rows.long(), a_cols.long(), a_vals, b_dense, n)


def interim_partial_products(a_cols, b_row_nnz) -> int:
    """Paper Eq.-1 interim-pp count (host-side, exact); the canonical
    implementation is ``repro_torch.core.eviction.interim_pp_count``."""
    from repro_torch.core.eviction import interim_pp_count
    return interim_pp_count(np.asarray(a_cols), np.asarray(b_row_nnz))
