"""Public wrapper for the EmbeddingBag kernel (port of
``repro.kernels.embedding_bag.ops``), trainable.

Where the table needs a gradient, the lookup runs as ``_LookupGrad``: its
forward is B6 (its plain version on CPU tensors), and its backward is the
reference's VJP of ``jnp.take`` and the bag sum — each id's row of the
dense ``(V, D)`` table gradient receives its bag's cotangent, the
cotangents of a repeated id added in a fixed order
(``sparse.segment_ops.segment_sum``: sorted by id, then added in bag order;
an ``index_add_`` would add them by atomics on CUDA).  An id outside
``[-V, V)`` (a NaN row forward) gets no gradient, as ``jnp.take``'s fill
mode drops it.  ``repro`` has no B6 backward kernel, so neither does the
port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.embedding_bag import (
    embedding_bag, embedding_bag_plain)
from repro_torch.sparse.segment_ops import segment_sum


def table_grad(ids: torch.Tensor, grad_bags: torch.Tensor,
               n_rows: int) -> torch.Tensor:
    """The table's gradient ``(n_rows, D)`` from the bags' cotangents
    ``grad_bags`` (B, F, D) for ids (B, F, M): order-fixed on any device."""
    b, f, m = ids.shape
    d = grad_bags.shape[-1]
    i = ids.to(torch.int64).reshape(-1)
    i = torch.where(i < 0, i + n_rows, i)     # still out of range: dropped
    g = grad_bags.to(torch.float32)[:, :, None, :].expand(b, f, m, d)
    return segment_sum(g.reshape(-1, d), i, n_rows)


class _LookupGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, table, batch_tile):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return embedding_bag(ids, table, batch_tile=batch_tile)

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        b, f, _ = ids.shape
        grad = table_grad(ids, grad_out.reshape(b, f, -1), ctx.n_rows)
        return None, grad, None


def lookup(ids: torch.Tensor, table: torch.Tensor, batch_tile: int = 8,
           use_kernel: bool = True) -> torch.Tensor:
    """ids (B, F, M) → (B, F, D).  ``use_kernel=False`` asks for the plain
    version, as the reference's ``use_kernel=False`` asks for its oracle;
    a table that needs a gradient gets one through ``_LookupGrad``."""
    b, f, _ = ids.shape
    if not use_kernel:
        out = embedding_bag_plain(ids, table)
    elif torch.is_grad_enabled() and table.requires_grad:
        out = _LookupGrad.apply(ids, table, batch_tile)
    else:
        out = embedding_bag(ids, table, batch_tile=batch_tile)
    return out.reshape(b, f, -1)
