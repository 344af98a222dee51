"""Pod-scale decoupled SpMM — DRHM row ownership + two-stage dataflow (C1+C2)
with an optional ring-pipelined rolling-eviction schedule (C3) (port of
``repro.core.distributed``).

Layouts (planned host-side, once per graph, bitwise the reference's):

* node features X are stored in DRHM-permuted row order and sharded over
  the ``data`` axis (and their feature columns over ``model``): rank (i, j)
  holds row slots [i·R, (i+1)·R) of the permuted order and feature block j.
  The permutation is a bijection, so every rank owns exactly R rows;
* edges are grouped by the owner of their destination row and padded to
  equal per-owner counts; the destination index is localized to the
  owner's slot space.

Dataflow per step (``allgather``, the paper's): (1) all-gather the X row
shards along ``data``, (2) gather·scale → partial products, (3) an ordered
segment sum into the owned row block: no partial product crosses the
network.  ``ring``: the X blocks travel round the ``data`` ring one hop a
block (rank i sends to i + 1), and each hop folds the edges whose sources
lie in the block it holds; the hop order is the reference's, so the sum
order is fixed.

**The SPMD transport.**  The counterpart of a ``shard_map`` over a jax
``Mesh`` is one rank a process over a ``DeviceMesh``: ``shard_map`` here
takes global-view arguments (every rank holds the whole array, or a
``DTensor``), hands each rank its block by the reference's
``PartitionSpec``s (tuples here: one entry a dim, ``None``, an axis name
or a tuple of names), runs the body on the blocks, and gathers the
results back to the global view.  Inside a body the collectives name mesh
axes, as jax's do: ``all_gather``, ``psum``, ``pmax``, ``all_to_all``,
``ppermute_next`` and ``axis_index``.  Gradients are those of the global
function (the reference's shard_map transpose): a block's gradient is
summed over the axes its argument is replicated on, and an output
replicated over an axis gives each replica its share.

Every collective runs on the world's own backend.  A ``gloo`` world whose
ranks keep their tensors on a card (several ranks sharing one card, where
NCCL refuses two ranks on one device) copies each collective's operands
to pinned host buffers and back, on every call: on torch 2.11 gloo sends
no CUDA tensor (a send/recv fails or hangs), and a world of ranks whose
functional collectives ran on CUDA tensors hung, though gloo's direct
all-gather, all-reduce, reduce-scatter and all-to-all of one do run
(``tools/gloo_cuda_probe.py``).  ``transport`` names the choice, which
the world's layout fixes (``nccl``, ``gloo``, ``gloo via host``).  Local
stages use ``index_select`` and the ordered ``segment_ops.segment_sum``:
no ``index_add_`` by atomics.

``LaneHalo`` is the one-process halo of the serving cluster: lane i's
shard of the permuted table lives on ``devices[i]``, and a round copies
the shards' rows onto each lane's device (the all-gather's rows) and
gathers that lane's subgraph from them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import drhm
from repro_torch.sparse.graph import round_up
from repro_torch.sparse.segment_ops import segment_sum


# ---------------------------------------------------------------------------
# Host-side planning (bitwise the reference's)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistSpmmPlan:
    """Device-ready, DRHM-balanced edge partition for a fixed graph."""

    n_shards: int
    rows_per_shard: int          # R — row slots per data shard (padded)
    edges_per_shard: int         # equal per-shard edge count (padded)
    # all-gather layout: flat (n_shards * edges_per_shard,) — shard i owns
    # slice i
    rows_local: np.ndarray       # destination slot within owner shard
    cols_perm: np.ndarray        # source row in *permuted* global order
    vals: np.ndarray             # edge weights (0 ⇒ padding lane)
    perm: np.ndarray             # global row id -> permuted slot
    inv_perm: np.ndarray
    # ring layout: (n_shards, n_shards, e_blk) [owner, src_block, lane]
    ring_rows: Optional[np.ndarray] = None   # dest slot within owner
    ring_cols: Optional[np.ndarray] = None   # source slot within src block
    ring_vals: Optional[np.ndarray] = None
    # slot of input edge i in the flat (n_shards * edges_per_shard) layout
    slots: Optional[np.ndarray] = None       # (E,) int32

    @property
    def n_pad(self) -> int:
        return self.n_shards * self.rows_per_shard

    @property
    def e_blk(self) -> int:
        return 0 if self.ring_rows is None else self.ring_rows.shape[2]


def plan_distributed_spmm(rows: np.ndarray, cols: np.ndarray,
                          vals: Optional[np.ndarray], n_nodes: int,
                          n_shards: int, gamma: int = 0x9E3779B1,
                          ring: bool = False,
                          edge_pad_multiple: int = 8) -> DistSpmmPlan:
    """Group edges by the DRHM owner of their destination row (and by
    source block for the ring schedule), localize indices, pad to equal
    counts."""
    shard_plan = drhm.plan_row_sharding(n_nodes, n_shards, gamma)
    perm, n_pad = shard_plan.perm, shard_plan.n_pad
    r_per = n_pad // n_shards

    dest_slot = perm[rows]
    src_slot = perm[cols]
    owner = dest_slot // r_per
    src_block = src_slot // r_per
    v = (np.ones(rows.shape[0], np.float32) if vals is None
         else vals.astype(np.float32))

    order = np.argsort(owner, kind="stable")
    d_s, s_s, v_s, o_s = dest_slot[order], src_slot[order], v[order], \
        owner[order]

    counts = np.bincount(o_s, minlength=n_shards)
    e_per = int(round_up(max(int(counts.max(initial=1)), 1),
                         edge_pad_multiple))
    rows_l = np.zeros((n_shards, e_per), np.int32)
    cols_p = np.zeros((n_shards, e_per), np.int32)
    vals_p = np.zeros((n_shards, e_per), np.float32)
    starts = np.zeros(n_shards + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slots = np.zeros(rows.shape[0], np.int32)
    for s in range(n_shards):
        lo, hi = starts[s], starts[s + 1]
        k = hi - lo
        rows_l[s, :k] = d_s[lo:hi] % r_per
        cols_p[s, :k] = s_s[lo:hi]
        vals_p[s, :k] = v_s[lo:hi]
        slots[order[lo:hi]] = s * e_per + np.arange(k, dtype=np.int32)

    ring_rows = ring_cols = ring_vals = None
    if ring:
        cell = owner * n_shards + src_block
        corder = np.argsort(cell, kind="stable")
        d_c, s_c, v_c = dest_slot[corder], src_slot[corder], v[corder]
        cell_counts = np.bincount(cell[corder], minlength=n_shards * n_shards)
        e_blk = int(round_up(max(int(cell_counts.max(initial=1)), 1),
                             edge_pad_multiple))
        ring_rows = np.zeros((n_shards, n_shards, e_blk), np.int32)
        ring_cols = np.zeros((n_shards, n_shards, e_blk), np.int32)
        ring_vals = np.zeros((n_shards, n_shards, e_blk), np.float32)
        cstarts = np.zeros(n_shards * n_shards + 1, np.int64)
        np.cumsum(cell_counts, out=cstarts[1:])
        for c in range(n_shards * n_shards):
            lo, hi = cstarts[c], cstarts[c + 1]
            k = hi - lo
            ow, sb = divmod(c, n_shards)
            ring_rows[ow, sb, :k] = d_c[lo:hi] % r_per
            ring_cols[ow, sb, :k] = s_c[lo:hi] % r_per
            ring_vals[ow, sb, :k] = v_c[lo:hi]

    return DistSpmmPlan(
        n_shards=n_shards, rows_per_shard=r_per, edges_per_shard=e_per,
        rows_local=rows_l.reshape(-1), cols_perm=cols_p.reshape(-1),
        vals=vals_p.reshape(-1), perm=perm, inv_perm=shard_plan.inv_perm,
        ring_rows=ring_rows, ring_cols=ring_cols, ring_vals=ring_vals,
        slots=slots,
    )


def permute_features(x: np.ndarray, plan: DistSpmmPlan) -> np.ndarray:
    """Host-side: lay out node features in DRHM-permuted order (padded)."""
    n, d = x.shape
    out = np.zeros((plan.n_pad, d), x.dtype)
    out[plan.perm[:n]] = x
    return out


def unpermute_features(xp: np.ndarray, plan: DistSpmmPlan, n_nodes: int):
    return xp[plan.perm[:n_nodes]]


# ---------------------------------------------------------------------------
# Mesh axes, groups and the transport
# ---------------------------------------------------------------------------

def axis_tuple(entry) -> tuple:
    """A spec entry as a tuple of axis names (``None`` → ``()``)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,) if entry else ()
    return tuple(entry)


_SUBMESHES: dict = {}


def axis_mesh(mesh, axes):
    """The 1-D ``DeviceMesh`` over ``axes`` of ``mesh`` (several axes
    flattened in their order, the first the slowest): the group a
    collective over those axes runs on.  Every rank builds it in the same
    order (SPMD), so the flatten's group creation stays collective.  It
    is built outside every dispatch mode (the dry run's fake tensors and
    its count): the flatten's rank table is real data."""
    from torch.utils._python_dispatch import _disable_current_modes
    axes = axis_tuple(axes)
    if tuple(mesh.mesh_dim_names) == axes:
        if len(axes) == 1:
            return mesh
    key = (id(mesh), axes)
    got = _SUBMESHES.get(key)
    if got is None or got[0] is not mesh:
        with _disable_current_modes():
            sub = mesh[axes[0]] if len(axes) == 1 else \
                mesh[axes]._flatten()
        got = _SUBMESHES[key] = (mesh, sub)
    return got[1]


def axis_size(mesh, axes) -> int:
    n = 1
    names = list(mesh.mesh_dim_names)
    for a in axis_tuple(axes):
        n *= mesh.size(names.index(a))
    return n


def axis_coord(mesh, axes) -> int:
    """This rank's index along ``axes`` (row-major, the first axis the
    slowest — jax's order for a tuple of axes)."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx = 0
    for a in axis_tuple(axes):
        d = names.index(a)
        idx = idx * mesh.size(d) + coord[d]
    return idx


def transport(mesh, device) -> str:
    """How this world's collectives move a tensor on ``device``: ``nccl``;
    ``gloo`` (host tensors); ``gloo via host`` (a gloo world whose ranks
    keep their tensors on a card: every collective's operands are copied
    to pinned host buffers and back)."""
    backend = dist.get_backend(mesh.get_group(0) if mesh.ndim > 1
                               else mesh.get_group())
    if str(backend) == "nccl":
        return "nccl"
    if torch.device(device).type == "cuda":
        return "gloo via host"
    return str(backend)


class _ToHost(torch.autograd.Function):
    """A copy into a pinned host buffer; the gradient goes back to the
    device."""

    @staticmethod
    def forward(ctx, x):
        ctx.device = x.device
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        return buf

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.device)


class _ToDevice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, device):
        return x.to(device)

    @staticmethod
    def backward(ctx, g):
        return _ToHost.apply(g), None


def _staged(fn, x: torch.Tensor, mesh):
    """``fn(x)`` on the host where the world stages collectives there."""
    if x.device.type == "cuda" and transport(mesh, x.device) != "nccl":
        return _ToDevice.apply(fn(_ToHost.apply(x)), x.device)
    return fn(x)


# --- the axis environment of a shard_map body ------------------------------

_ENV = threading.local()


def current_mesh():
    """The mesh of the ``shard_map`` body (or ``use_mesh`` block) this
    thread is in, or ``None``."""
    return getattr(_ENV, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh (the reference's ``use_mesh``): the
    axis names that collectives and ``moe_mlp_sharded`` read resolve
    against it."""
    old = getattr(_ENV, "mesh", None)
    _ENV.mesh = mesh
    try:
        yield mesh
    finally:
        _ENV.mesh = old


def _mesh(mesh=None):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("a collective over a mesh axis needs a mesh: run "
                         "it inside shard_map or distributed.use_mesh(...)")
    return mesh


def axis_index(axes, mesh=None) -> int:
    """``jax.lax.axis_index``: this rank's index along ``axes``."""
    return axis_coord(_mesh(mesh), axes)


def all_gather(x: torch.Tensor, axes, dim: int = 0,
               mesh=None) -> torch.Tensor:
    """``jax.lax.all_gather(..., tiled=True)`` along ``dim``: the blocks of
    the ranks along ``axes``, in their order.  Its gradient is the
    reduce-scatter of the gathered gradient (a sum)."""
    import torch.distributed._functional_collectives as fc
    mesh = _mesh(mesh)
    if not axis_tuple(axes):
        return x
    group = axis_mesh(mesh, axes)
    # torch 2.13 renamed it; the older name warns there
    gather = getattr(fc, "all_gather_single_autograd", None) or \
        fc.all_gather_tensor_autograd
    return _staged(lambda t: gather(t.contiguous(), dim, group), x, mesh)


def _all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    from torch.distributed._functional_collectives import all_reduce
    group = axis_mesh(mesh, axes)
    return _staged(lambda t: all_reduce(t.contiguous(), "sum", group), x,
                   mesh)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.psum`` over ``axes``; its gradient is a psum too, the
    reference's transpose."""
    mesh = _mesh(mesh)
    if not axis_tuple(axes):
        return x
    return _Psum.apply(x, mesh, axis_tuple(axes))


def pmax(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.pmax`` over ``axes``, forward only (no gradient)."""
    from torch.distributed._functional_collectives import all_reduce
    mesh = _mesh(mesh)
    if not axis_tuple(axes):
        return x
    group = axis_mesh(mesh, axes)
    return _staged(lambda t: all_reduce(t.contiguous(), "max", group), x,
                   mesh)


def all_to_all(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """Split ``x``'s first dim into equal blocks, block j to rank j along
    ``axis``; the result holds rank i's block at position i.  Its gradient
    is the reverse exchange."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd)
    mesh = _mesh(mesh)
    group = axis_mesh(mesh, axis)
    return _staged(lambda t: all_to_all_single_autograd(
        t.contiguous(), None, None, group), x, mesh)


def _shift(x: torch.Tensor, mesh, axes, step: int) -> torch.Tensor:
    """Rank i along ``axes`` sends ``x`` to rank i + step and receives
    from rank i − step (modulo the axis size)."""
    n = axis_size(mesh, axes)
    if n == 1 or step % n == 0:
        return x
    sub = axis_mesh(mesh, axes)
    group = sub.get_group()
    me = axis_coord(mesh, axes)

    def hop(t):
        t = t.contiguous()
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t,
                          dist.get_global_rank(group, (me + step) % n),
                          group),
               dist.P2POp(dist.irecv, out,
                          dist.get_global_rank(group, (me - step) % n),
                          group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out
    if x.device.type == "cuda" and transport(mesh, x.device) != "nccl":
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        return hop(buf).to(x.device)
    return hop(x)


class _PermuteNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _shift(x, mesh, axes, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axes, -1), None, None


def ppermute_next(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.ppermute`` with the pairs (i, i + 1 mod n) along
    ``axes``: one send and one receive a rank; its gradient travels the
    other way round the ring."""
    return _PermuteNext.apply(x, _mesh(mesh), axis_tuple(axes))


# ---------------------------------------------------------------------------
# shard_map — global-view arguments, one block a rank
# ---------------------------------------------------------------------------

def _spec_axes(spec) -> tuple:
    return tuple(a for e in (spec or ()) for a in axis_tuple(e))


def _blocks(mesh, spec, shape):
    """(dim, start, size) of this rank's block of a ``shape`` array."""
    out = []
    for d, entry in enumerate(spec or ()):
        axes = axis_tuple(entry)
        if not axes:
            continue
        n = axis_size(mesh, axes)
        if shape[d] % n:
            raise ValueError(f"dim {d} of size {shape[d]} does not split "
                             f"evenly over {axes} ({n} ranks)")
        size = shape[d] // n
        out.append((d, axis_coord(mesh, axes) * size, size))
    return out


def _unmentioned(mesh, spec) -> tuple:
    named = set(_spec_axes(spec))
    return tuple(a for a in mesh.mesh_dim_names if a not in named)


class _ShardIn(torch.autograd.Function):
    """A global array → this rank's block.  Gradient: the block's summed
    over the axes the argument is replicated on, then gathered back to the
    global view."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        for d, lo, size in _blocks(mesh, spec, x.shape):
            x = x.narrow(d, lo, size)
        return x.contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, spec = ctx.mesh, ctx.spec
        rep = _unmentioned(mesh, spec)
        with torch.no_grad():
            if rep:
                g = _all_reduce(g, mesh, rep)
            for d, entry in enumerate(spec or ()):
                if axis_tuple(entry):
                    g = all_gather(g, entry, d, mesh)
        return g, None, None


class _ShardOut(torch.autograd.Function):
    """This rank's block → the global array (gathered along the spec's
    axes).  Gradient: this rank's block of it, shared among the replicas
    along the axes the output is replicated on."""

    @staticmethod
    def forward(ctx, y, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        with torch.no_grad():
            for d, entry in enumerate(spec or ()):
                if axis_tuple(entry):
                    y = all_gather(y, entry, d, mesh)
        return y

    @staticmethod
    def backward(ctx, g):
        mesh, spec = ctx.mesh, ctx.spec
        for d, lo, size in _blocks(mesh, spec, g.shape):
            g = g.narrow(d, lo, size)
        rep = axis_size(mesh, _unmentioned(mesh, spec))
        g = g.contiguous()
        return (g / rep if rep > 1 else g), None, None


def _placements(mesh, spec, ndim):
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for d, entry in enumerate(spec or ()):
        for a in axis_tuple(entry):
            out[names.index(a)] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The counterpart of ``jax.sharding.NamedSharding(mesh, P(*spec))``:
    a ``DeviceMesh`` and a spec (one entry a dim: ``None``, an axis name or
    a tuple of names).  A tree leaf, not a container, so a tree of them
    matches a tree of tensors (``checkpoint.store.restore``'s
    ``shardings``)."""

    mesh: object
    spec: tuple = ()

    def placements(self, ndim: int) -> list:
        """DTensor placements of the spec on the mesh."""
        return _placements(self.mesh, self.spec, ndim)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _shard_in(x, mesh, spec):
    if spec is None or not isinstance(x, torch.Tensor):
        return x.to_local() if _is_dtensor(x) else x
    if _is_dtensor(x):
        return x.redistribute(mesh, _placements(mesh, spec, x.ndim)
                              ).to_local()
    return _ShardIn.apply(x, mesh, tuple(spec))


def _shard_out(y, mesh, spec, as_dtensor: bool):
    if as_dtensor:
        from torch.distributed.tensor import DTensor
        shape = list(y.shape)
        for d, entry in enumerate(spec or ()):
            shape[d] *= axis_size(mesh, entry)
        return DTensor.from_local(y, mesh, _placements(mesh, spec, y.ndim),
                                  shape=torch.Size(shape),
                                  stride=_contiguous_strides(shape))
    return _ShardOut.apply(y, mesh, tuple(spec or ()))


def _contiguous_strides(shape):
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    return tuple(reversed(strides))


def constrain(x, spec):
    """``jax.lax.with_sharding_constraint(x, P(*spec))``: a ``DTensor`` is
    redistributed to the spec's placements on its own mesh; a plain tensor
    (one device, or a rank's global view) passes as it is — a constraint
    moves data, never values."""
    if not _is_dtensor(x):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, _placements(mesh, spec, x.ndim))


def shard_map(fn, mesh, in_specs: Sequence, out_specs):
    """The reference's ``shard_map(fn, mesh, in_specs, out_specs)``.

    Each argument is a global-view tensor (the same on every rank) or a
    ``DTensor`` on ``mesh``; each rank runs ``fn`` on its blocks, with
    ``mesh`` as the ambient mesh of the collectives, and the blocks of the
    result come back as the global view (a ``DTensor`` where any argument
    was one).  A spec is a tuple with an entry a dim (``None``, an axis
    name or a tuple of names); an argument whose spec is ``None`` passes
    as it is."""
    multi = isinstance(out_specs, list)

    def run(*args):
        as_dt = any(_is_dtensor(a) for a in args)
        local = [_shard_in(a, mesh, s) for a, s in zip(args, in_specs)]
        with use_mesh(mesh):
            out = fn(*local)
        if multi:
            return [_shard_out(o, mesh, s, as_dt)
                    for o, s in zip(out, out_specs)]
        return _shard_out(out, mesh, out_specs, as_dt)
    return run


# ---------------------------------------------------------------------------
# Device-side SpMM factories
# ---------------------------------------------------------------------------

def _i64(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64)


def make_allgather_spmm(mesh, plan: DistSpmmPlan, data_axis="data",
                        model_axis="model"):
    return make_allgather_spmm_dims(mesh, plan.rows_per_shard, data_axis,
                                    model_axis)


def make_allgather_spmm_dims(mesh, rows_per_shard: int, data_axis="data",
                             model_axis="model"):
    """Paper-faithful distributed decoupled SpMM (shape-only factory).

    Returned fn: (x_perm, rows_local, cols_perm, vals) -> y
    x_perm: (n_pad, D) P(data, model); edge arrays (n_shards*e_per,)
    P(data); y: (n_pad, D) P(data, model).  ``data_axis`` may be a tuple
    of mesh axes; ``model_axis`` may be None (features replicated)."""
    r_per = rows_per_shard

    def local_fn(x_loc, rows_l, cols_p, vals):
        # stage 0: operand fetch; 1: partial products of this rank's
        # edges; 2: an ordered fold into its R owned rows
        x_full = all_gather(x_loc, data_axis, 0)
        pp = x_full.index_select(0, _i64(cols_p)) * vals[:, None].to(
            x_full.dtype)
        return segment_sum(pp, _i64(rows_l), r_per)

    return shard_map(
        local_fn, mesh,
        in_specs=((data_axis, model_axis), (data_axis,), (data_axis,),
                  (data_axis,)),
        out_specs=(data_axis, model_axis))


def make_halo_gather(mesh, n_ghost_slot: int, data_axis="data"):
    """Halo exchange for sharded serving over SPMD ranks: each rank holds a
    DRHM-permuted row shard of the resident feature table and one sampled
    subgraph's node ids; boundary rows arrive through the all-gather the
    distributed SpMM uses, then each rank gathers exactly its subgraph's
    rows.  The gather is a pure row copy, so sharded residency is bitwise
    replicated residency.  (One process with a device a lane:
    ``LaneHalo``.)

    Returned fn: ``(x_perm, perm, node_ids) -> x_batch``
    x_perm: (n_pad, D) P(lane); perm: (n_rows,) replicated; node_ids:
    (L, n) P(lane), ``-1`` ⇒ the ghost slot; x_batch: (L, n, D)."""

    def local_fn(x_loc, perm, node_ids):
        x_full = all_gather(x_loc, data_axis, 0)
        ridx = torch.where(node_ids[0] >= 0, node_ids[0], n_ghost_slot)
        slots = _i64(perm).index_select(0, _i64(ridx))
        return x_full.index_select(0, slots)[None]

    return shard_map(local_fn, mesh,
                     in_specs=((data_axis,), None, (data_axis,)),
                     out_specs=(data_axis,))


def make_owner_accumulate(mesh, rows_per_shard: int, data_axis="data"):
    """Accumulate-only distributed stage: per-edge messages are already
    formed and grouped by the DRHM owner of their destination row, so each
    rank folds its slice locally — no partial product crosses the
    network.

    Returned fn: (messages, rows_local) -> y_perm
    messages: (n_shards*e_per, D) P(data); rows_local: P(data);
    y_perm: (n_pad, D) P(data)."""
    r_per = rows_per_shard

    def local_fn(m_loc, rows_l):
        return segment_sum(m_loc, _i64(rows_l), r_per)

    return shard_map(local_fn, mesh, in_specs=((data_axis,), (data_axis,)),
                     out_specs=(data_axis,))


def make_ring_spmm(mesh, plan: DistSpmmPlan, data_axis="data",
                   model_axis="model"):
    if plan.ring_rows is None:
        raise ValueError("plan must be built with ring=True")
    return make_ring_spmm_dims(mesh, plan.rows_per_shard, plan.n_shards,
                               data_axis, model_axis)


def make_ring_spmm_dims(mesh, rows_per_shard: int, n_shards: int,
                        data_axis="data", model_axis="model"):
    """Ring-pipelined rolling-eviction SpMM.

    Returned fn: (x_perm, ring_rows, ring_cols, ring_vals) -> y
    x_perm: (n_pad, D) P(data, model); ring arrays (n_sh, n_sh, e_blk)
    with dim0 sharded P(data); y: (n_pad, D) P(data, model)."""
    r_per, n_sh = rows_per_shard, n_shards

    def local_fn(x_loc, r_rows, r_cols, r_vals):
        # at hop t this rank holds block (me − t) mod n, folds that
        # block's edges into its rows, then passes the block on to rank
        # me + 1: the reference's hop and sum order
        r_rows, r_cols, r_vals = r_rows[0], r_cols[0], r_vals[0]
        me = axis_index(data_axis)
        acc = x_loc.new_zeros((r_per, x_loc.shape[1]))
        blk = x_loc
        for t in range(n_sh):
            src = (me - t) % n_sh
            pp = blk.index_select(0, _i64(r_cols[src])) \
                * r_vals[src][:, None].to(blk.dtype)
            acc = acc + segment_sum(pp, _i64(r_rows[src]), r_per)
            blk = ppermute_next(blk, data_axis)
        return acc

    ring = (data_axis, None, None)
    return shard_map(local_fn, mesh,
                     in_specs=((data_axis, model_axis), ring, ring, ring),
                     out_specs=(data_axis, model_axis))


# ---------------------------------------------------------------------------
# The serving cluster's one-process halo (a device a lane)
# ---------------------------------------------------------------------------

class LaneHalo:
    """DRHM row-sharded residency of a feature table over lanes in one
    process: lane i's shard (rows ``[i·R, (i+1)·R)`` of the permuted
    table) lives on ``devices[i]``.  ``gather(node_ids)`` copies every
    shard's rows onto each lane's device — the rows the all-gather of
    ``make_halo_gather`` moves — and gathers that lane's subgraph from
    them: row copies alone, so the batch is bitwise the replicated
    fetch's.  ``update(row_ids, rows)`` writes rows in place at
    ``perm[row]`` in their owner's shard, with no re-shard."""

    def __init__(self, table: torch.Tensor, shard_plan,
                 devices: Sequence[torch.device], n_ghost_slot: int):
        self.plan = shard_plan
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != shard_plan.n_lanes:
            raise ValueError(f"{len(self.devices)} devices for "
                             f"{shard_plan.n_lanes} lanes")
        self.n_ghost_slot = int(n_ghost_slot)
        perm = torch.from_numpy(shard_plan.perm.astype(np.int64))
        x_perm = shard_plan.permute_table(table.cpu().numpy())
        r = shard_plan.rows_per_lane
        self.shards = [torch.from_numpy(x_perm[i * r:(i + 1) * r]).to(dev)
                       for i, dev in enumerate(self.devices)]
        self._perm = {}
        for dev in self.devices:
            if dev not in self._perm:
                self._perm[dev] = perm.to(dev)

    def gather(self, node_ids) -> list:
        """Lane i's features ``(n, d)`` on ``devices[i]`` for ``node_ids
        (L, n)`` (``-1`` ⇒ the ghost row)."""
        node_ids = torch.as_tensor(node_ids)
        out = []
        full_on = {}
        for lane, dev in enumerate(self.devices):
            full = full_on.get(dev)
            if full is None:
                full = full_on[dev] = torch.cat(
                    [s.to(dev, non_blocking=True) for s in self.shards])
            ids = node_ids[lane].to(dev, non_blocking=True)
            ridx = torch.where(ids >= 0, ids, self.n_ghost_slot)
            out.append(full.index_select(
                0, self._perm[dev].index_select(0, ridx)))
        return out

    def update(self, row_ids: np.ndarray, rows: np.ndarray) -> None:
        slots = self.plan.perm[np.asarray(row_ids, np.int64)]
        r = self.plan.rows_per_lane
        for lane in np.unique(slots // r):
            sel = slots // r == lane
            shard = self.shards[int(lane)]
            shard[torch.from_numpy(slots[sel] % r).to(shard.device)] = \
                torch.from_numpy(np.ascontiguousarray(rows[sel])).to(
                    shard.device, shard.dtype)
