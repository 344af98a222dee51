"""Differentiable wrappers of the Gustavson SpMM kernels (port of
``repro.kernels.gustavson_spmm.ops``).

``spmm_dedup_grad`` makes B1 (``spmm_dedup_chunks``) a training path: the
forward runs B1 on the forward dedup-chunk layout, and the backward runs
**B1 again** on the transpose layout (dX = Aᵀ·dY), with no segment
reduction, scatter or library sparse product anywhere.  The coefficient-
tile cotangent dA comes from the operand gather the forward performs:
dA[k] = dY_block(k) · landing(k)ᵀ.  Gradients for edge values reach the
tiles through the scatter that builds them (``sparse.plan.scatter_tiles``),
outside this op.

``spmm_dedup_grad_q8`` is the straight-through int8 path: the forward
quantizes X per feature tile and runs B4 (``spmm_dedup_chunks_q8``); the
backward is the f32 backward above, unchanged — dX through B1 in f32 on
the transpose layout, dA from the f32 operand gather — so only the
incoming cotangent, which saw the quantized forward value, carries
quantization error.  The int8 tiles and scales get no gradient.

The transpose tiles ``a_t`` never get a gradient either (the reference's
zero cotangent): they do not enter the forward value, and a traced
``vals`` reaches the forward tiles alone, so it is counted once.

Where neither ``a`` nor ``x`` needs a gradient (serving, ``no_grad``), both
wrappers launch their kernel directly, without ``Function.apply`` and its
autograd bookkeeping on the host.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gustavson_spmm.gustavson_spmm import (
    auto_d_tile, spmm_dedup_chunks, spmm_dedup_chunks_q8)


def _save(ctx, want_da: bool, want_dx: bool, u_cols, remaining, out_block,
          transpose, x, block_rows: int) -> None:
    """Keep what the backward reads: the transpose layout for dX, and the
    forward operands (x among them) only when ``a`` needs a gradient."""
    ctx.want_da, ctx.want_dx = want_da, want_dx
    ctx.block_rows = block_rows
    ctx.n_x = x.shape[0]
    ctx.x_dtype = x.dtype
    ctx.transpose = transpose
    if want_da:
        ctx.save_for_backward(u_cols, remaining, out_block, x)


def _backward(ctx, grad_y: torch.Tensor):
    """(dA, dX) of y = A·x on the dedup-chunk layout, as the reference's
    ``_ad_bwd``: dX by B1 on the transpose layout (a bf16 cotangent runs
    the bf16 kernel) in ``x.dtype``, dA in f32 from the f32 gather.  dA's
    lanes ``u ≥ remaining[k]`` are zero."""
    br = ctx.block_rows
    dy = grad_y.contiguous()
    da = dx = None
    if ctx.want_dx:
        t_u_cols, t_remaining, t_block_ptr, a_t = ctx.transpose
        dx = spmm_dedup_chunks(t_u_cols, t_remaining, t_block_ptr, a_t, dy,
                               block_rows=br)[: ctx.n_x].to(ctx.x_dtype)
    if ctx.want_da:
        u_cols, remaining, out_block, x = ctx.saved_tensors
        n_chunks, width = u_cols.shape
        d = x.shape[1]
        lane = torch.arange(width, device=u_cols.device)
        live = lane[None, :] < remaining[:, None].to(torch.int64)
        idx = torch.where(live, u_cols.to(torch.int64), 0)
        land = x.to(torch.float32).index_select(0, idx.reshape(-1))
        land = torch.where(live[:, :, None],
                           land.reshape(n_chunks, width, d), 0.0)
        dyb = dy.to(torch.float32).reshape(-1, br, d).index_select(
            0, out_block.to(torch.int64))
        da = torch.bmm(dyb, land.transpose(1, 2)).reshape(n_chunks * br,
                                                          width)
    return da, dx


class _SpmmDedup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u_cols, remaining, block_ptr, out_block, a, t_u_cols,
                t_remaining, t_block_ptr, a_t, x, block_rows):
        need = ctx.needs_input_grad
        _save(ctx, need[4], need[9], u_cols, remaining, out_block,
              (t_u_cols, t_remaining, t_block_ptr, a_t), x, block_rows)
        return spmm_dedup_chunks(u_cols, remaining, block_ptr, a, x,
                                 block_rows=block_rows)

    @staticmethod
    def backward(ctx, grad_y):
        da, dx = _backward(ctx, grad_y)
        return None, None, None, None, da, None, None, None, None, dx, None


class _SpmmDedupQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u_cols, remaining, block_ptr, out_block, a, a_q8,
                a_scale, t_u_cols, t_remaining, t_block_ptr, a_t, x,
                block_rows, q_tile, lanes):
        need = ctx.needs_input_grad
        _save(ctx, need[4], need[11], u_cols, remaining, out_block,
              (t_u_cols, t_remaining, t_block_ptr, a_t), x, block_rows)
        return _q8_forward(u_cols, remaining, block_ptr, a_q8, a_scale, x,
                           block_rows, q_tile, lanes)

    @staticmethod
    def backward(ctx, grad_y):
        da, dx = _backward(ctx, grad_y)
        return (None, None, None, None, da, None, None, None, None, None,
                None, dx, None, None, None)


def _q8_forward(u_cols, remaining, block_ptr, a_q8, a_scale, x, block_rows,
                q_tile, lanes):
    """X quantized per feature tile (per serving lane: ``lanes`` is
    ``(lanes, lane_rows, lane_nodes)``), then B4, in ``x.dtype``."""
    from repro_torch.sparse.quantize import quantize_feature_tiles
    n_lanes, lane_rows, lane_nodes = lanes
    x_q8, x_scale = quantize_feature_tiles(x, q_tile, n_lanes, lane_rows,
                                           lane_nodes)
    return spmm_dedup_chunks_q8(
        u_cols, remaining, block_ptr, a_q8, a_scale, x_q8, x_scale,
        block_rows=block_rows, q_tile=q_tile).to(x.dtype)


def _wants_grad(a, x) -> bool:
    return torch.is_grad_enabled() and (a.requires_grad or x.requires_grad)


def spmm_dedup_grad(u_cols, remaining, block_ptr, out_block, a, t_u_cols,
                    t_remaining, t_block_ptr, a_t, x, *,
                    block_rows: int) -> torch.Tensor:
    """Differentiable y = A·x → ``(n_blocks·block_rows, D)``: gradients
    flow to ``a`` (and through its scatter to edge values) and to ``x``.

    The forward layout is ``u_cols``/``remaining``/``block_ptr`` with the
    per-chunk output block ``out_block`` (dA's gather); the transpose
    layout ``t_*``/``a_t`` is what the backward runs B1 on.  ``a_t`` may be
    ``None`` when ``x`` needs no gradient."""
    if not _wants_grad(a, x):
        return spmm_dedup_chunks(u_cols, remaining, block_ptr, a, x,
                                 block_rows=block_rows)
    return _SpmmDedup.apply(u_cols, remaining, block_ptr, out_block, a,
                            t_u_cols, t_remaining, t_block_ptr, a_t, x,
                            block_rows)


def spmm_dedup_grad_q8(u_cols, remaining, block_ptr, out_block, a, t_u_cols,
                       t_remaining, t_block_ptr, a_t, x, *, a_q8, a_scale,
                       block_rows: int, q_tile: Optional[int] = None,
                       lanes: tuple = (1, None, None)) -> torch.Tensor:
    """Differentiable int8 y ≈ A·x (straight-through gradients), returned
    in ``x.dtype`` as the reference's ``y.astype(x.dtype)``.

    ``a_q8``/``a_scale`` are the int8 forward tiles (baked at plan time,
    or quantized from ``a`` by the caller); X quantizes here per feature
    tile of ``q_tile`` columns (default ``auto_d_tile(D)``, the kernel's
    own scale tile), and lane by lane where ``lanes`` = ``(lanes,
    lane_rows, lane_nodes)`` (an ``AggregationPlan``'s) holds several
    serving lanes."""
    q_tile = auto_d_tile(x.shape[1]) if q_tile is None else int(q_tile)
    if not _wants_grad(a, x):
        return _q8_forward(u_cols, remaining, block_ptr, a_q8, a_scale, x,
                           block_rows, q_tile, lanes)
    return _SpmmDedupQ8.apply(u_cols, remaining, block_ptr, out_block, a,
                              a_q8, a_scale, t_u_cols, t_remaining,
                              t_block_ptr, a_t, x, block_rows, q_tile,
                              lanes)
