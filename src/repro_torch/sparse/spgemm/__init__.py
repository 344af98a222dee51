"""Sparse×sparse SpGEMM engine: symbolic + numeric phases (port of
``repro.sparse.spgemm``).

``make_spgemm_plan`` (symbolic: exact output structure, pp maps, hash-pad
layout) + ``repro_torch.sparse.backend.spgemm`` (numeric: dense-oracle /
reference / cuda executors) + the Â² workload helpers.
"""
from repro_torch.sparse.spgemm.symbolic import (ALL_SPGEMM_EXECUTORS,
                                                SpgemmPlan, SpgemmSymbolic,
                                                find_block_gammas,
                                                hash_bucket,
                                                hash_dedup_row_nnz,
                                                make_spgemm_plan, symbolic)
from repro_torch.sparse.spgemm.numeric import (cached_two_hop_graph,
                                               spgemm_to_coo,
                                               two_hop_cache_clear,
                                               two_hop_graph)

__all__ = ["ALL_SPGEMM_EXECUTORS", "SpgemmPlan", "SpgemmSymbolic",
           "symbolic", "make_spgemm_plan", "hash_bucket",
           "hash_dedup_row_nnz", "find_block_gammas", "spgemm_to_coo",
           "two_hop_graph", "cached_two_hop_graph", "two_hop_cache_clear"]
