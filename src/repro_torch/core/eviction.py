"""Rolling eviction (paper C3) as a generic accumulation schedule — port of
``repro.core.eviction``.

On the ASIC a hash-line is evicted the moment its completion counter reaches
zero, bounding HashPad occupancy.  Here partial products are folded into
the output in fixed-size waves, so the live interim set is one wave, not
the whole bloat (paper Table 1).  The reference's ``lax.scan`` becomes a
Python loop over waves; ``index_add_`` takes ``segment_sum``'s place.
``bloat_percent`` implements paper Eq. (1).
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def rolling_accumulate(produce: Callable[[int], Tuple[torch.Tensor,
                                                      torch.Tensor]],
                       n_waves: int, n_rows: int, width: int,
                       dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """acc = Σ_w segment_sum(produce(w)) with one wave live at a time.

    produce(w) -> (pp: (chunk, width), rows: (chunk,)); every row id must
    be < ``n_rows`` (``index_add_`` faults where ``segment_sum`` dropped).
    """
    acc = torch.zeros((n_rows, width), dtype=dtype, device=device)
    for w in range(n_waves):
        pp, rows = produce(w)
        acc.index_add_(0, rows, pp.to(dtype))
    return acc


def interim_pp_count(a_cols: np.ndarray, b_row_nnz: np.ndarray) -> int:
    """# interim partial products of Gustavson A@B (host-side, exact)."""
    return int(b_row_nnz[a_cols].sum())


def output_nnz(a_rows: np.ndarray, a_cols: np.ndarray,
               b_rows: np.ndarray, b_cols: np.ndarray, n: int, k: int) -> int:
    """nnz of C = A@B computed exactly via per-row merges on CSR-ified
    inputs (host-side)."""
    a_order = np.argsort(a_rows, kind="stable")
    ar, ac = a_rows[a_order], a_cols[a_order]
    b_order = np.argsort(b_rows, kind="stable")
    br, bc = b_rows[b_order], b_cols[b_order]
    a_ptr = np.searchsorted(ar, np.arange(n + 1))
    m = int(br.max(initial=-1)) + 1 if br.size else 0
    b_ptr = np.searchsorted(br, np.arange(m + 1))
    total = 0
    for i in range(n):
        cols_i = ac[a_ptr[i]:a_ptr[i + 1]]
        cols_i = cols_i[cols_i < m]
        if cols_i.size == 0:
            continue
        segs = [bc[b_ptr[j]:b_ptr[j + 1]] for j in cols_i]
        total += np.unique(np.concatenate(segs)).size
    return total


def bloat_percent(pp_interim: int, nnz_out: int) -> float:
    """Paper Eq. (1): (pp_interim − nnz_out) / nnz_out × 100."""
    return (pp_interim - nnz_out) / max(nnz_out, 1) * 100.0
