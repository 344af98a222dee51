"""Per-device operation, byte and collective counts of one step (the
port's counterpart of ``repro.launch.hlo_costs``).

The reference re-walks XLA's partitioned HLO text (``corrected_costs``,
``hlo_costs.py:342``), costs each computation and multiplies while-loop
bodies by their trip counts.  A torch program has no HLO: ``OpCosts`` is
a ``TorchDispatchMode`` that sees every aten operation a step runs, as it
runs, on the tensors one device holds:

* flops — ``torch.utils.flop_counter``'s registry: 2·|out|·|contracted|
  for ``mm``/``addmm``/``bmm``/``baddbmm`` and the same for SDPA and
  convolutions; elementwise work is not counted, as the reference counts
  dots alone;
* bytes — operand + output bytes of every operation that is not a view
  or free (allocation without a write, metadata, collective waits), the
  reference's count without its fusion boundaries: eager torch has none;
* collectives — wire bytes by kind (``analysis.wire_bytes``) of each
  functional collective, from its output's bytes and its group's size.

Eager torch runs a loop's body once an iteration, so what the reference
corrects by trip counts is counted here by construction.

Under DTensor the mode counts what one device runs: it lets an operation
on DTensors go to DTensor's dispatch and counts the operations that
dispatch runs on the local shards, and it skips DTensor's sharding
propagation (which runs each new operation once at global shapes to
learn its output's metadata).  Under ``FakeTensorMode`` nothing is
computed or allocated and the counts are the same.

Not counted: the hand-written kernels the port launches through
``ctypes`` (B1–B8 on the card are not aten operations); count a step
that runs them on the CPU, where their plain versions run, or use the
``dense`` executor and the blocked attention, as the dry run does.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.analysis import COLLECTIVES, wire_bytes

# operations that allocate without writing, read metadata or wait
_FREE = frozenset({
    "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::detach", "aten::alias", "aten::lift_fresh", "prim::device",
    "aten::_local_scalar_dense", "aten::sym_size", "aten::sym_stride",
    "aten::sym_numel", "aten::sym_storage_offset", "aten::is_same_size",
    "_c10d_functional::wait_tensor",
})

# functional collective → the reference's collective kind
_COLLECTIVE_KINDS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_reduce_coalesced_": "all-reduce",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_c10d_functional::broadcast": "collective-permute",
    "_c10d_functional::broadcast_": "collective-permute",
    "_dtensor::shard_dim_alltoall": "all-to-all",
}


# DTensor's sharding propagation: strategy and cost search, and the run of
# each new operation at global shapes for its output's metadata
PROPAGATION = ("propagate_op_sharding_non_cached",
               "_propagate_tensor_meta_non_cached")


def tensor_bytes(t) -> int:
    """Bytes of a tensor's elements (the counterpart of the reference's
    ``_shape_bytes`` of an HLO shape string); a tuple or list sums its
    tensors, anything else is 0."""
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (tuple, list)):
        return sum(tensor_bytes(x) for x in t)
    return 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _group_size(args) -> int:
    """The size of the group a functional collective names: its last
    string argument (a reduce op comes before it)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in args if isinstance(a, str)]
    if not names:
        return 1
    return dist.get_world_size(_resolve_process_group(names[-1]))


class OpCosts(TorchDispatchMode):
    """Counts while active (``with OpCosts() as c: step(...)``):
    ``flops`` (and ``flops_by_op``: operation → flops), ``bytes``,
    ``collectives`` (kind → wire bytes),
    ``collective_counts``, ``n_ops``, and ``peak_live_bytes``: the most
    bytes that tensors made inside the window held at once (a tensor is
    live until it is freed; views add nothing)."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.flops_by_op: Dict[str, float] = {}
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.collective_counts: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._propagating = 0

    # -- DTensor's sharding propagation runs outside the count ---------
    @contextlib.contextmanager
    def _skip_propagation(self):
        try:
            from torch.distributed.tensor._sharding_prop import (
                ShardingPropagator)
        except ImportError:
            yield
            return
        mode = self
        saved = {}

        def wrap(orig):
            def wrapped(prop, *a, **k):
                mode._propagating += 1
                try:
                    return orig(prop, *a, **k)
                finally:
                    mode._propagating -= 1
            return wrapped
        for name in PROPAGATION:
            orig = getattr(ShardingPropagator, name, None)
            if orig is not None:
                saved[name] = orig
                setattr(ShardingPropagator, name, wrap(orig))
        try:
            yield
        finally:
            for name, orig in saved.items():
                setattr(ShardingPropagator, name, orig)

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._skip_propagation())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def _freed(self, nbytes: int):
        self.live_bytes -= nbytes

    def _track(self, out):
        for t in _tensors(out):
            if t._is_view():
                continue
            nbytes = tensor_bytes(t)
            self.live_bytes += nbytes
            self.peak_live_bytes = max(self.peak_live_bytes,
                                       self.live_bytes)
            weakref.finalize(t, self._freed, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented           # DTensor runs the local ops
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        self.n_ops += 1
        name = func._schema.name
        kind = _COLLECTIVE_KINDS.get(name)
        if kind is not None:
            g = _group_size(list(args) + list(kwargs.values()))
            self.collectives[kind] += wire_bytes(kind, tensor_bytes(out), g)
            self.collective_counts[kind] += 1
        if name in _FREE or func.is_view:
            return out
        in_b = sum(tensor_bytes(t) for t in _tensors((args, kwargs)))
        self.bytes += in_b + tensor_bytes(out)
        flop = self._flop_registry.get(func._overloadpacket)
        if flop is not None:
            f = float(flop(*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + f
        if not func._schema.is_mutable:
            self._track(out)
        return out


def step_costs(fn: Callable, *args, **kwargs
               ) -> Tuple[float, float, Dict[str, float]]:
    """(flops, bytes, collective wire bytes by kind) of ``fn(*args,
    **kwargs)``, per device."""
    with OpCosts() as c:
        fn(*args, **kwargs)
    return c.flops, c.bytes, dict(c.collectives)
