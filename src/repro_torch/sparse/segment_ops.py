"""Segment reductions over an explicit edge list — port of
``repro.sparse.segment_ops``.

Conventions as in the reference (``jax.ops.segment_*``): ``segment_ids``
index ``num_segments`` segments, and an id outside ``[0, num_segments)``
(padding entries carry ``num_segments``) is dropped from every reduction;
a gather by such an id reads the nearest segment, as JAX's gathers clamp.

Every float sum here is order-fixed on the card as well as on the CPU, in
the forward and in the backward, so a training run repeats bit for bit
(``index_add_`` on CUDA adds a repeated id by atomics, in no fixed order):

* a ``SegmentOrder`` holds the entries sorted by segment (a stable sort, so
  entry order within a segment) and each segment's bounds in that order.
  ``segment_order`` builds one with a sort on the ids' device; callers whose
  ids are static keep it (``AggregationPlan.order``), so their sums sort
  nothing per call;
* a sum reads the entries in that order and adds each segment's run one
  after another (``torch.segment_reduce`` on 2-D data: one sequential loop
  per output element on either device, bitwise equal across devices);
  ``kept_order`` keeps the order of an id tensor that is passed again (a
  static batch's species, graph ids or triplet indices);
* ``gather`` reads rows by id, and its backward is that ordered sum (with
  no gradient to carry, it is one ``index_select``);
* ``segment_max`` is ``scatter_reduce("amax")``: a maximum does not depend
  on the order it is taken in.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SegmentOrder:
    """The fixed order in which entries with ids add up into ``n``
    segments.  ``perm`` lists the entries stably sorted by id, ids below
    the range first and above it last; segment s holds
    ``perm[sum_bounds[s]:sum_bounds[s + 1]]``.  ``gather_bounds`` is the
    same with the out-of-range entries joined to segment 0 and n − 1, the
    rows a clamped gather reads (``read``)."""

    n: int
    read: torch.Tensor           # (E,) int64: ids clamped into [0, n)
    perm: torch.Tensor           # (E,) int64
    sum_bounds: torch.Tensor     # (n + 1,) int64
    gather_bounds: torch.Tensor  # (n + 1,) int64


def segment_order(segment_ids: torch.Tensor, n: int) -> SegmentOrder:
    """The ``SegmentOrder`` of ``segment_ids`` over ``n`` segments, built
    on the ids' device with one stable sort."""
    ids = segment_ids.to(torch.int64)
    key = ids.clamp(-1, n) + 1             # 0: below range, n + 1: above
    perm = torch.argsort(key, stable=True)
    # a count of static length (``bincount``'s grows with the largest id,
    # which a shape-only trace cannot know); integer adds, exact
    ends = key.new_zeros(n + 2).scatter_add(0, key, torch.ones_like(key))
    ends = ends.cumsum(0)
    sum_bounds = ends[:n + 1]
    edge = ends.new_full((1,), ids.shape[0])
    gather_bounds = torch.cat([ends.new_zeros(1), ends[1:n], edge])
    return SegmentOrder(n=n, read=ids.clamp(0, n - 1), perm=perm,
                        sum_bounds=sum_bounds, gather_bounds=gather_bounds)


# (id(ids), n) → (ids, order); the entry holds the id tensor so its id()
# cannot be reused while the entry lives
_KEPT: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
KEPT_ORDERS_MAXSIZE = 32


def kept_order(segment_ids: torch.Tensor, n: int) -> SegmentOrder:
    """``segment_order(segment_ids, n)``, built once per id tensor: passed
    the same tensor object again (a static batch's ids, step after step),
    it returns the order it built then, so no call sorts.  The last
    ``KEPT_ORDERS_MAXSIZE`` orders are kept."""
    key = (id(segment_ids), n)
    got = _KEPT.get(key)
    if got is not None and got[0] is segment_ids:
        _KEPT.move_to_end(key)
        return got[1]
    order = segment_order(segment_ids, n)
    _KEPT[key] = (segment_ids, order)
    while len(_KEPT) > KEPT_ORDERS_MAXSIZE:
        _KEPT.popitem(last=False)
    return order


def _ordered_sum(data: torch.Tensor, order: SegmentOrder,
                 bounds: torch.Tensor) -> torch.Tensor:
    """Each segment's entries of ``data`` added one after another in
    ``order``; differentiable (the backward gathers, and the sorting
    gather's backward adds each row once).  bf16 and f16 data are added in
    f32 and the sums rounded back once (``segment_reduce`` on CUDA takes
    neither type)."""
    flat = data[:, None] if data.ndim == 1 else data.flatten(1)
    if flat.dtype in (torch.bfloat16, torch.float16):
        flat = flat.float()
    out = torch.segment_reduce(flat.index_select(0, order.perm), "sum",
                               offsets=bounds, axis=0)
    return out.reshape((order.n,) + tuple(data.shape[1:])).to(data.dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, order):
        ctx.order = order
        return data.index_select(0, order.read)

    @staticmethod
    def backward(ctx, grad):
        order = ctx.order
        return _ordered_sum(grad, order, order.gather_bounds), None


def _order(segment_ids, num_segments, order) -> SegmentOrder:
    if order is None:
        return segment_order(segment_ids, num_segments)
    if order.n != num_segments:
        raise ValueError(f"the order is over {order.n} segments, not "
                         f"{num_segments}")
    return order


def gather(data: torch.Tensor, ids: torch.Tensor,
           order: Optional[SegmentOrder] = None) -> torch.Tensor:
    """``data[ids]`` along the first axis, ids clamped into range; the
    backward adds a repeated id's rows in a fixed order (``order``: the
    ids' order over ``data``'s rows, built here if not given and a
    gradient is to flow)."""
    if order is None and not (torch.is_grad_enabled()
                              and data.requires_grad):
        n = data.shape[0]
        return data.index_select(0, ids.to(torch.int64).clamp(0, n - 1))
    return _Gather.apply(data, _order(ids, data.shape[0], order))


def take(data: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``data[ids]`` whose backward, where a gradient flows, adds a
    repeated id's rows in the ids' kept order (``kept_order``): a table
    lookup by a static batch's ids (an embedding by species)."""
    if torch.is_grad_enabled() and data.requires_grad:
        return gather(data, ids, kept_order(ids, data.shape[0]))
    return gather(data, ids)


def _col(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape((-1,) + (1,) * (ndim - 1))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                order: Optional[SegmentOrder] = None) -> torch.Tensor:
    """Σ of ``data``'s rows per segment; empty segments are 0."""
    order = _order(segment_ids, num_segments, order)
    return _ordered_sum(data, order, order.sum_bounds)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max of ``data``'s rows per segment; empty segments are −inf."""
    ids = segment_ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]),
                        float("-inf"))
    index = _col(ids, data.ndim).expand_as(data)
    out = out.scatter_reduce(0, index, data, "amax", include_self=True)
    return out[:num_segments]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 order: Optional[SegmentOrder] = None) -> torch.Tensor:
    order = _order(segment_ids, num_segments, order)
    tot = segment_sum(data, segment_ids, num_segments, order)
    cnt = segment_sum(data.new_ones(data.shape[:1]), segment_ids,
                      num_segments, order)
    return tot / _col(torch.clamp(cnt, min=1), data.ndim)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    order: Optional[SegmentOrder] = None) -> torch.Tensor:
    """Numerically stable softmax over variable-length segments (GAT's edge
    softmax): an empty segment's max is made finite before the gather, and
    the denominator is at least 1e-30."""
    order = _order(segment_ids, num_segments, order)
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    expd = torch.exp(logits - gather(seg_max, segment_ids, order))
    denom = torch.clamp(segment_sum(expd, segment_ids, num_segments, order),
                        min=1e-30)
    return expd / gather(denom, segment_ids, order)


def pad_segment_drop(data: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Zero out padding lanes so they contribute nothing to a later sum."""
    return torch.where(_col(valid, data.ndim), data, 0)


def segment_normalize(x: torch.Tensor, seg_counts: torch.Tensor,
                      power: float = 1.0) -> torch.Tensor:
    """Divide row i by count_i**power (GCN-style degree normalization)."""
    scale = torch.where(seg_counts > 0, seg_counts.to(x.dtype) ** power,
                        torch.ones((), dtype=x.dtype, device=x.device))
    return x / _col(scale, x.ndim)
