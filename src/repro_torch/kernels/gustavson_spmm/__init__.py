"""Gustavson SpMM kernels, f32 and int8 (port of
``repro.kernels.gustavson_spmm``)."""
from repro_torch.kernels.gustavson_spmm.gustavson_spmm import (
    LIBRARY, auto_d_tile, lane_layout, spmm_blocked_ell, spmm_dedup_chunks,
    spmm_dedup_chunks_plain, spmm_dedup_chunks_q8, spmm_dedup_chunks_q8_plain)

__all__ = ["LIBRARY", "auto_d_tile", "lane_layout", "spmm_blocked_ell",
           "spmm_dedup_chunks",
           "spmm_dedup_chunks_plain", "spmm_dedup_chunks_q8",
           "spmm_dedup_chunks_q8_plain"]
