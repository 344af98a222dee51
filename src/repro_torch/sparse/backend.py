"""Unified sparse-backend engine — one aggregation API, five executors.

Port of ``repro.sparse.backend``.  Every sparse aggregation goes through

    aggregate(plan, vals, x) -> y          # y[r] = Σ_e vals[e]·x[cols[e]]
    accumulate(plan, messages) -> y        # y[r] = Σ_e messages[e]

dispatched over a registry of interchangeable executors:

* ``dense``   — one-shot gather + ordered segment sum (baseline);
* ``chunked`` — rolling-eviction waves (paper C3);
* ``cuda``    — the hand-written Gustavson kernel on the dedup-chunk layout
                (``kernels/gustavson_spmm``), the counterpart of the
                reference's ``pallas``.  It trains: its autograd Function
                (``kernels/gustavson_spmm/ops.spmm_dedup_grad``) runs the
                same kernel on the transpose layout for dX;
* ``cuda_q8`` — the int8 Gustavson kernel (``spmm_dedup_chunks_q8``) on
                the same layout, the counterpart of ``pallas_q8``: int8
                coefficient tiles (one scale per chunk) and int8 features
                (one scale per feature tile).  ``x`` may be f32 (quantized
                on each call; straight-through gradients, the f32 backward
                of ``cuda``) or ``sparse.quantize.QuantizedFeatures``
                (quantized once, the resident path, inference only);
* ``distributed`` — DRHM row ownership + the all-gather schedule over the
                plan's ``DeviceMesh`` (``core.distributed``, paper C1+C2):
                every rank calls it with the whole x and gets the whole y;
                it trains (gradients in x and in ``vals``).

``vals`` may be ``None`` (use the plan's edge weights) or an (E,) tensor;
either way padding lanes contribute nothing.

The SpGEMM registry (sparse × sparse, sparse output) sits beside it:
``spgemm(plan, a_vals, b_vals, backend)`` over the executors of
``repro_torch.sparse.spgemm`` (``dense``, ``reference``, ``cuda``,
``cuda_q8``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import spgemm as core_spgemm
from repro_torch.sparse.plan import (ALL_BACKENDS, AggregationPlan,
                                     BackendPlanError, forward_tiles,
                                     transpose_tiles)

__all__ = ["Backend", "BACKENDS", "ALL_BACKENDS", "BackendPlanError",
           "register_backend", "get_backend", "aggregate", "accumulate",
           "SpgemmBackend", "SPGEMM_BACKENDS", "ALL_SPGEMM_BACKENDS",
           "register_spgemm_backend", "get_spgemm_backend", "spgemm"]


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered executor: full decoupled SpMM + accumulate-only entry."""

    name: str
    aggregate: Callable[[AggregationPlan, Optional[torch.Tensor],
                         torch.Tensor], torch.Tensor]
    accumulate: Callable[[AggregationPlan, torch.Tensor], torch.Tensor]


BACKENDS: Dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    BACKENDS[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown sparse backend {name!r}; registered: "
                       f"{sorted(BACKENDS)}") from None


def aggregate(plan: AggregationPlan, vals: Optional[torch.Tensor],
              x: torch.Tensor, backend: str = "dense") -> torch.Tensor:
    """y[r] = Σ_{e: rows[e]=r} vals[e] · x[cols[e]] on the named executor.

    ``x`` may be a ``sparse.quantize.QuantizedFeatures`` (resident int8
    rows) on the ``cuda_q8`` executor."""
    n_x = x.q8.shape[0] if hasattr(x, "q8") else x.shape[0]
    if n_x != plan.n_rows:
        # a plan for another node count would gather the wrong rows (or,
        # past the end, fault on the device) — catch it here
        raise ValueError(
            f"x has {n_x} rows but the plan was built for "
            f"n_rows={plan.n_rows} (padded node count incl. ghost row)")
    return get_backend(backend).aggregate(plan, vals, x)


def accumulate(plan: AggregationPlan, messages: torch.Tensor,
               backend: str = "dense") -> torch.Tensor:
    """y[r] = Σ_{e: rows[e]=r} messages[e] on the named executor."""
    if messages.shape[0] != plan.rows.shape[0]:
        raise ValueError(
            f"messages has {messages.shape[0]} entries but the plan holds "
            f"{plan.rows.shape[0]} (padded) edges")
    return get_backend(backend).accumulate(plan, messages)


# ---------------------------------------------------------------------------
# SpGEMM registry (sparse × sparse, sparse output)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpgemmBackend:
    """A registered SpGEMM executor: (plan, a_vals, b_vals) → c_vals."""

    name: str
    spgemm: Callable


SPGEMM_BACKENDS: Dict[str, SpgemmBackend] = {}
ALL_SPGEMM_BACKENDS = ("dense", "reference", "cuda", "cuda_q8")


def register_spgemm_backend(backend: SpgemmBackend) -> SpgemmBackend:
    SPGEMM_BACKENDS[backend.name] = backend
    return backend


def get_spgemm_backend(name: str) -> SpgemmBackend:
    if name not in SPGEMM_BACKENDS:
        # executors live in the spgemm subsystem; importing it registers
        # them (kept lazy — backend.py must not depend on the kernels)
        import repro_torch.sparse.spgemm.numeric  # noqa: F401
    try:
        return SPGEMM_BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown spgemm backend {name!r}; registered: "
                       f"{sorted(SPGEMM_BACKENDS)}") from None


def spgemm(plan, a_vals: Optional[torch.Tensor] = None,
           b_vals: Optional[torch.Tensor] = None,
           backend: str = "reference") -> torch.Tensor:
    """c_vals of C = A@B on the plan's symbolic structure (row-major CSR
    order — ``plan.c_row``/``plan.c_col``).  ``a_vals``/``b_vals`` override
    the plan's baked values; ``None`` uses them (structure is plan state,
    values are data)."""
    for nm, v, nnz in (("a_vals", a_vals, plan.nnz_a),
                       ("b_vals", b_vals, plan.nnz_b)):
        if v is not None and v.shape[0] != nnz:
            raise ValueError(f"{nm} has {v.shape[0]} entries but the plan "
                             f"holds {nnz} nonzeros")
    return get_spgemm_backend(backend).spgemm(plan, a_vals, b_vals)


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _edge_vals(plan: AggregationPlan, vals: Optional[torch.Tensor],
               dtype) -> torch.Tensor:
    """Per-edge scalars with the padding contract enforced."""
    if vals is None:
        return plan.base_vals.to(dtype)
    return torch.where(plan.valid, vals, 0).to(dtype)


def _mask_messages(plan: AggregationPlan,
                   messages: torch.Tensor) -> torch.Tensor:
    shape = (-1,) + (1,) * (messages.ndim - 1)
    return torch.where(plan.valid.reshape(shape), messages, 0)


# ---------------------------------------------------------------------------
# dense — one-shot gather + segment-sum
# ---------------------------------------------------------------------------

def _dense_aggregate(plan, vals, x):
    pp = core_spgemm.multiply_stage(plan.cols, _edge_vals(plan, vals,
                                                          x.dtype), x,
                                    plan.order("cols"))
    return core_spgemm.accumulate_stage(pp, plan.rows, plan.n_rows,
                                        plan.order("rows"))


def _dense_accumulate(plan, messages):
    return core_spgemm.accumulate_stage(_mask_messages(plan, messages),
                                        plan.rows, plan.n_rows,
                                        plan.order("rows"))


register_backend(Backend("dense", _dense_aggregate, _dense_accumulate))


# ---------------------------------------------------------------------------
# chunked — rolling-eviction waves (paper C3)
# ---------------------------------------------------------------------------

def _chunked_aggregate(plan, vals, x):
    v = _edge_vals(plan, vals, x.dtype)
    return core_spgemm.spmm_chunked(plan.rows, plan.cols, v, x, plan.n_rows,
                                    chunk=plan.chunk, order_of=plan.order)


def _chunked_accumulate(plan, messages):
    return core_spgemm.segment_sum_chunked(plan.rows,
                                           _mask_messages(plan, messages),
                                           plan.n_rows, chunk=plan.chunk,
                                           order_of=plan.order)


register_backend(Backend("chunked", _chunked_aggregate, _chunked_accumulate))


# ---------------------------------------------------------------------------
# cuda — the hand-written Gustavson kernel (plain version on CPU tensors)
# ---------------------------------------------------------------------------

def _wants_grad(vals, x) -> bool:
    return torch.is_grad_enabled() and (
        getattr(x, "requires_grad", False)
        or (vals is not None and vals.requires_grad))


def _forward_tiles(plan, vals):
    """The forward coefficient tiles: the plan's, or ``vals`` scattered
    through the slot map in the plan's fixed order (the scatter carries dA
    back to ``vals``)."""
    if vals is None:
        return plan.ell_a
    return forward_tiles(plan, _edge_vals(plan, vals, torch.float32))


def _transpose_operands(plan, vals, x):
    """The backward's layout (``None`` tiles when no gradient is asked for:
    inference never builds or reads them)."""
    a_t = None
    if _wants_grad(vals, x):
        a_t = transpose_tiles(plan, None if vals is None else _edge_vals(
            plan, vals, torch.float32))
    return plan.ell_t_u_cols, plan.ell_t_remaining, plan.ell_t_block_ptr, a_t


def _cuda_aggregate(plan, vals, x):
    from repro_torch.kernels.gustavson_spmm.ops import spmm_dedup_grad
    plan.require("ell", "cuda")
    y = spmm_dedup_grad(plan.ell_u_cols, plan.ell_remaining,
                        plan.ell_block_ptr, plan.ell_out_block,
                        _forward_tiles(plan, vals),
                        *_transpose_operands(plan, vals, x), x.contiguous(),
                        block_rows=plan.block_rows)
    return y[: plan.n_rows]


def _cuda_accumulate(plan, messages):
    # The kernel's multiply stage is scalar-per-nnz; vector-valued messages
    # use the chunked rolling-eviction schedule instead.
    return _chunked_accumulate(plan, messages)


register_backend(Backend("cuda", _cuda_aggregate, _cuda_accumulate))


# ---------------------------------------------------------------------------
# cuda_q8 — the int8 Gustavson kernel (plain version on CPU tensors)
# ---------------------------------------------------------------------------

def _cuda_q8_aggregate(plan, vals, x):
    from repro_torch.kernels.gustavson_spmm import (auto_d_tile,
                                                    spmm_dedup_chunks_q8)
    from repro_torch.kernels.gustavson_spmm.ops import spmm_dedup_grad_q8
    from repro_torch.sparse.quantize import (QuantizedFeatures,
                                             quantize_chunk_tiles)
    plan.require("ell", "cuda_q8")
    a = _forward_tiles(plan, vals)
    if vals is None and plan.ell_a_q8 is not None:
        a_q8, a_scale = plan.ell_a_q8, plan.ell_a_scale
    else:
        # given values, or a plan built for `cuda` only: quantize the f32
        # tiles here, on the device (no gradient: straight-through)
        a_q8, a_scale = quantize_chunk_tiles(a.detach(),
                                             plan.ell_u_cols.shape[0])
    dt = plan.ell_d_tile
    if isinstance(x, QuantizedFeatures):
        # the resident path: features quantized once, no f32 x to
        # differentiate, so it is inference-only (as the reference's)
        if _wants_grad(vals, None):
            raise NotImplementedError(
                "the resident QuantizedFeatures path of cuda_q8 is "
                "inference-only: it has no f32 features to differentiate; "
                "pass f32 x to train through cuda_q8 (straight-through), or "
                "run under torch.no_grad()")
        dt = dt or auto_d_tile(x.q8.shape[1])
        d_tiles = -(-x.q8.shape[1] // dt)
        if x.scale.shape[-1] != d_tiles:
            raise ValueError(
                f"QuantizedFeatures carries {x.scale.shape[-1]} feature-tile "
                f"scales but the plan's kernel uses d_tile={dt} "
                f"({d_tiles} tiles) — re-quantize with the plan's d_tile")
        if x.scale.shape[:-1] != ((plan.lanes,) if plan.lanes > 1 else ()):
            raise ValueError(
                f"QuantizedFeatures carries scales of shape "
                f"{tuple(x.scale.shape)} for a plan of {plan.lanes} lanes — "
                "quantize lane by lane (quantize_feature_tiles' lanes)")
        y = spmm_dedup_chunks_q8(
            plan.ell_u_cols, plan.ell_remaining, plan.ell_block_ptr, a_q8,
            a_scale, x.q8.contiguous(), x.scale, block_rows=plan.block_rows,
            q_tile=dt)
        return y[: plan.n_rows]
    # X quantizes per feature tile inside the op, with the kernel's tile,
    # lane by lane on a plan of stacked serving lanes
    y = spmm_dedup_grad_q8(plan.ell_u_cols, plan.ell_remaining,
                           plan.ell_block_ptr, plan.ell_out_block, a,
                           *_transpose_operands(plan, vals, x),
                           x.contiguous(), a_q8=a_q8, a_scale=a_scale,
                           block_rows=plan.block_rows, q_tile=dt,
                           lanes=(plan.lanes, plan.lane_rows,
                                  plan.lane_nodes))
    return y[: plan.n_rows]


register_backend(Backend("cuda_q8", _cuda_q8_aggregate, _cuda_accumulate))


# ---------------------------------------------------------------------------
# distributed — DRHM row ownership + all-gather SPMD schedule (paper C1+C2)
# ---------------------------------------------------------------------------

def _dist_edge_vals(plan, vals):
    from repro_torch.sparse.plan import dist_values
    if vals is None:
        return plan.dist_vals
    return dist_values(plan, torch.where(plan.valid, vals, 0).to(
        torch.float32))


def _dist_permute_in(plan, x):
    pad = plan.dist_n_pad - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    return x.index_select(0, plan.dist_inv_perm)


def _dist_permute_out(plan, y_perm, dtype):
    return y_perm.index_select(0, plan.dist_perm[: plan.n_rows]).to(dtype)


def _distributed_aggregate(plan, vals, x):
    from repro_torch.core import distributed
    plan.require("dist", "distributed")
    v = _dist_edge_vals(plan, vals)
    x_perm = _dist_permute_in(plan, x.to(torch.float32))
    fn = distributed.make_allgather_spmm_dims(plan.mesh, plan.rows_per_shard,
                                              data_axis="data",
                                              model_axis=None)
    y_perm = fn(x_perm, plan.dist_rows_local, plan.dist_cols_perm, v)
    return _dist_permute_out(plan, y_perm, x.dtype)


def _distributed_accumulate(plan, messages):
    from repro_torch.core import distributed
    from repro_torch.sparse.plan import dist_values
    plan.require("dist", "distributed")
    m = _mask_messages(plan, messages).to(torch.float32)
    m_dist = dist_values(plan, m)
    fn = distributed.make_owner_accumulate(plan.mesh, plan.rows_per_shard,
                                           data_axis="data")
    y_perm = fn(m_dist, plan.dist_rows_local)
    return _dist_permute_out(plan, y_perm, messages.dtype)


register_backend(Backend("distributed", _distributed_aggregate,
                         _distributed_accumulate))
