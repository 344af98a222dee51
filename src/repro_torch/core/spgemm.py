"""Decoupled Gustavson SpMM — the paper's C1, in PyTorch.

    multiply_stage :  pp[e]  = A_val[e] * X[A_col[e], :]        (gather-bound)
    accumulate     :  Y[r]   = segment_sum(pp, A_row, n_rows)   (scatter-bound)

These are the bodies of the ``dense`` and ``chunked`` executors;
``spgemm_via_dense`` is the sparse×sparse tiny-size oracle.  JAX's
``segment_sum`` drops segment ids ≥ ``n_rows``; ``index_add_`` would fault
on them, so the sums go into one extra trash row that is cut off at the end
(the padding-edge convention: padding lanes point at row ``n_rows``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def multiply_stage(cols: torch.Tensor, vals: Optional[torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
    """Partial products for every nnz: pp[e] = vals[e] * x[cols[e]]."""
    pp = x.index_select(0, cols)
    if vals is not None:
        pp = pp * vals.to(pp.dtype).reshape((-1,) + (1,) * (pp.ndim - 1))
    return pp


def accumulate_stage(pp: torch.Tensor, rows: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """Merge partial products by destination row; rows ≥ n_rows drop."""
    out = pp.new_zeros((n_rows + 1,) + pp.shape[1:])
    out.index_add_(0, rows.clamp(0, n_rows), pp)
    return out[:n_rows]


def _chunk_bounds(e: int, chunk: int):
    chunk = max(1, min(chunk, e))
    return range(0, e, chunk), chunk


def spmm_chunked(rows: torch.Tensor, cols: torch.Tensor,
                 vals: Optional[torch.Tensor], x: torch.Tensor, n_rows: int,
                 chunk: int = 8192) -> torch.Tensor:
    """Rolling-eviction SpMM (paper C3): edges are processed in
    ``chunk``-sized waves, and each wave's partial products are folded into
    the output at once, so peak interim memory is O(chunk · D)."""
    acc = x.new_zeros((n_rows,) + x.shape[1:])
    starts, chunk = _chunk_bounds(rows.shape[0], chunk)
    for lo in starts:
        v = None if vals is None else vals[lo:lo + chunk]
        pp = multiply_stage(cols[lo:lo + chunk], v, x)
        acc = acc + accumulate_stage(pp, rows[lo:lo + chunk], n_rows)
    return acc


def segment_sum_chunked(rows: torch.Tensor, messages: torch.Tensor,
                        n_rows: int, chunk: int = 8192) -> torch.Tensor:
    """Accumulate-only rolling eviction: fold precomputed per-edge messages
    into their destination rows in ``chunk``-sized waves."""
    acc = messages.new_zeros((n_rows,) + messages.shape[1:])
    starts, chunk = _chunk_bounds(rows.shape[0], chunk)
    for lo in starts:
        acc = acc + accumulate_stage(messages[lo:lo + chunk],
                                     rows[lo:lo + chunk], n_rows)
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
    pp = multiply_stage(a_cols.long(), a_vals, b_dense)
    return accumulate_stage(pp, a_rows.long(), n)


def interim_partial_products(a_cols, b_row_nnz) -> int:
    """Paper Eq.-1 interim-pp count (host-side, exact); the canonical
    implementation is ``repro_torch.core.eviction.interim_pp_count``."""
    from repro_torch.core.eviction import interim_pp_count
    return interim_pp_count(np.asarray(a_cols), np.asarray(b_row_nnz))
