"""Gustavson SpMM kernel (port of ``repro.kernels.gustavson_spmm``)."""
from repro_torch.kernels.gustavson_spmm.gustavson_spmm import (
    LIBRARY, spmm_dedup_chunks, spmm_dedup_chunks_plain)

__all__ = ["LIBRARY", "spmm_dedup_chunks", "spmm_dedup_chunks_plain"]
