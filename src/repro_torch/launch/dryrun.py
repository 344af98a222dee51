"""Multi-pod dry run (port of ``repro.launch.dryrun``): every (architecture
× input shape) cell traced once on a fake world of 256 ranks (16×16) or
512 (2×16×16), one JSON record a cell.

    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
        --mesh pod --out /tmp/dryrun

The reference compiles each cell for 512 emulated XLA CPU devices and
reads XLA's memory and cost analyses.  Here one process plays rank 0 of a
``fake`` process group (``mesh.fake_world``: collectives move nothing).
``lower_cell``:

1. builds the parameters (and the AdamW state where the step takes one)
   and the inputs from their ``meta`` specs as fake tensors
   (``FakeTensorMode``: no storage, no numbers);
2. places them as DTensors by the sharding rules (``launch/sharding``);
3. runs the step once under ``op_costs.OpCosts``: per-device flops,
   bytes, collective wire bytes and the peak bytes live while tracing;
4. records the memory fields of the reference that have a meaning here
   (argument bytes from the local shard shapes, output bytes, the peak
   as ``temp_size_in_bytes``), ``flops.model_flops`` and the H100
   roofline (``launch/analysis``).

A sharding failure, an operation that needs data (``.item()``,
``nonzero``), or any other error makes the cell's record ``ok: false``
with the error, and the sweep goes on, as the reference's does.  An
operation DTensor has no sharding rule for runs replicated (its inputs
gathered, its output whole on every rank), the fallback GSPMD takes for
an operation it cannot split; the record's ``notes`` name such
operations, and its ``flops_by_op`` says where the flops went.  A strided
shard's size is computed on plain CPU tensors (fake ones cannot be read
back); DTensor's search for the cheapest redistribution of such shards
can run for minutes an operation, so ``main`` records a cell still
tracing after ``CELL_LIMIT_S`` as failed.  ``unsharded_costs`` counts a
cell's step on one device that holds all of it: each traced cell's
per-device flops lie between that count ÷ the devices and that count.
Cells trace with the reference's activation constraints: an LM config
takes ``dp_axes`` (the mesh's axes but ``model``) and ``tp_axis="model"``
(its MoE layers then run ``moe_mlp_sharded``), a GNN config ``dp_axes``.
Steps run the ``dense`` executor and the blocked attention (no
hand-written kernel on the path).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import re
import signal
import time
import traceback
import warnings
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch import analysis, flops as flops_mod, sharding, steps
from repro_torch.launch import mesh as M
from repro_torch.launch.op_costs import OpCosts, tensor_bytes
from repro_torch.optim import adamw

MAX_FALLBACKS = 16
# ``main`` records a cell still tracing after this many seconds as failed:
# DTensor's search over strided shards can run for minutes an operation
CELL_LIMIT_S = 1200


def param_tree_for(arch_id: str, cfg):
    """The arch's parameter tree as ``meta`` tensors."""
    fam = registry.ARCHS[arch_id].family
    if fam == "lm":
        from repro_torch.models.lm import transformer as T
        return T.param_specs(cfg)
    if fam == "gnn":
        if arch_id.startswith("gcn"):
            from repro_torch.models.gnn import gcn as m
        elif arch_id.startswith("gat"):
            from repro_torch.models.gnn import gat as m
        elif arch_id == "schnet":
            from repro_torch.models.gnn import schnet as m
        else:
            from repro_torch.models.gnn import dimenet as m
    else:
        from repro_torch.models.recsys import dlrm as m
    return tree.eval_shape(m.init_params, cfg, torch.Generator(), "cpu")


# ---------------------------------------------------------------------------
# Operations without a DTensor sharding rule run replicated
# ---------------------------------------------------------------------------

_REPLICATED: dict = {}          # op → whether the current cell used it
_GATHER_RULE: list = []         # [True] once ``_gather_rule`` registered


def _replicate_rule(op):
    """Register an all-replicated sharding rule for ``op``."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.experimental import register_sharding
    n_out = len(op._schema.returns)

    def rule(*args, **kwargs):
        _REPLICATED[op] = True
        ins = [Replicate() if isinstance(a, DTensorSpec) else None
               for a in args]
        ins += [Replicate() for a in kwargs.values()
                if isinstance(a, DTensorSpec)]
        return [([Replicate()] * n_out, ins)]
    register_sharding(op)(rule)
    _REPLICATED[op] = False


def _gather_rule():
    """``aten.gather`` split along any dim but the gathered one (input and
    index alike), or replicated.  It replaces DTensor's own rule, whose
    vocab-parallel mask does not survive the ``[:, 0]`` that follows the
    LM loss's gather (DTensor indexes the mask with the gather's rank)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.gather.default)
    def rule(x, dim, index, sparse_grad=False):
        dim = dim % len(x.shape)
        out = [([Replicate()], [Replicate(), None, Replicate(), None])]
        for d in range(len(x.shape)):
            if d != dim:
                out.append(([Shard(d)], [Shard(d), None, Shard(d), None]))
        return out


def _missing_rule(exc: BaseException):
    """The operation a DTensor error says has no sharding rule, if any."""
    while exc is not None:
        if isinstance(exc, NotImplementedError):
            m = re.search(r"Operator (\S+) does not have a sharding",
                          str(exc))
            if m:
                ns, name, overload = m.group(1).split(".")
                return getattr(getattr(getattr(torch.ops, ns), name),
                               overload)
        exc = exc.__cause__
    return None


@contextlib.contextmanager
def _strided_sizes_on_host():
    """DTensor sizes a strided shard (a dim split over two mesh dims once
    a reshape has merged them) by splitting an ``arange`` and reading it
    back (``tolist``), which fake tensors cannot give.  The sizes depend
    on shapes alone: compute them on plain CPU tensors, outside every
    dispatch mode (fake tensors, the count)."""
    try:
        from torch.distributed.tensor.placement_types import _StridedShard
        from torch.utils._python_dispatch import _disable_current_modes
    except ImportError:
        yield
        return
    orig = _StridedShard.__dict__.get("local_shard_size_and_offset")
    if orig is None:
        yield
        return

    def sized(self, *args, **kwargs):
        with _disable_current_modes():
            return orig(self, *args, **kwargs)
    _StridedShard.local_shard_size_and_offset = sized
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


class _MasksEqual(TorchDispatchMode):
    """DTensor checks with ``torch.equal`` that a vocab-sharded gather's
    mask, materialized again, holds the same data; fake tensors hold none,
    so the dry run takes two masks of one shape and dtype as equal."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.equal.default:
            a, b = args
            return a.shape == b.shape and a.dtype == b.dtype
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _fake(specs):
    """Fake tensors of the ``meta`` specs' shapes and dtypes (call under
    ``FakeTensorMode``)."""
    return tree.map_leaves(
        lambda t: torch.empty(t.shape, dtype=t.dtype), specs)


def _local_bytes(t) -> int:
    return sum(tensor_bytes(getattr(x, "_local_tensor", x))
               for x in tree.leaves(t) if isinstance(x, torch.Tensor))


def _trace(step, arch_id, shape, specs, params_meta, mesh):
    """Place and run one step on the fake world's mesh → (OpCosts,
    argument bytes, output bytes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    p_pspec = sharding.param_pspecs(arch_id, params_meta, mesh)
    in_pspec = sharding.input_pspecs(arch_id, shape, specs, mesh)
    with FakeTensorMode(), implicit_replication():
        params = sharding.distribute(_fake(params_meta), p_pspec, mesh)
        inputs = sharding.distribute(_fake(specs), in_pspec, mesh)
        args = (params,)
        if steps.needs_optimizer(arch_id, shape):
            opt_meta = tree.eval_shape(adamw.init_state, params_meta)
            opt = sharding.distribute(_fake(opt_meta),
                                      sharding.opt_state_pspecs(p_pspec),
                                      mesh)
            args = (params, opt)
        arg_bytes = _local_bytes(args) + _local_bytes(inputs)
        with _strided_sizes_on_host(), _MasksEqual(), OpCosts() as costs:
            out = step(*args, inputs)
        return costs, arg_bytes, _local_bytes(out)


def _cell(arch_id, shape_name, reduced, shape, mesh_shape=None):
    """(shape, config, input specs, statics, step, parameter specs) of a
    cell; on ``mesh_shape`` the config carries the reference's sharding
    constraints."""
    shape = shape or registry.shapes_for(arch_id)[shape_name]
    cfg = registry.get_config(arch_id, reduced=reduced, shape=shape)
    specs, statics = registry.specs_for(arch_id, cfg, shape)
    if mesh_shape is not None:
        # the reference's constraints: batch axes = every axis but model
        dp = tuple(a for a in mesh_shape.axis_names if a != "model")
        if registry.ARCHS[arch_id].family == "lm":
            cfg = dataclasses.replace(cfg, dp_axes=dp, tp_axis="model")
        elif hasattr(cfg, "dp_axes"):
            cfg = dataclasses.replace(cfg, dp_axes=dp)
    step = steps.build_step(arch_id, cfg, shape, statics)
    return shape, cfg, specs, statics, step, param_tree_for(arch_id, cfg)


def unsharded_costs(arch_id: str, shape_name: str, reduced: bool = False,
                    shape=None) -> OpCosts:
    """The cell's step counted on one device that holds all of it (fake
    tensors at the global shapes, no mesh).  A traced cell's per-device
    flops lie between this count ÷ the number of devices (every
    operation split) and this count (every operation replicated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape, _, specs, _, step, params_meta = _cell(arch_id, shape_name,
                                                  reduced, shape)
    args = [params_meta]
    if steps.needs_optimizer(arch_id, shape):
        args.append(tree.eval_shape(adamw.init_state, params_meta))
    with FakeTensorMode():
        fake = [_fake(a) for a in args + [specs]]
        with OpCosts() as costs:
            step(*fake)
    return costs


def lower_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
               mesh_shape: M.MeshShape = None, reduced: bool = False,
               shape=None) -> dict:
    """Trace one cell on a fake world → its record.  ``mesh_shape``
    replaces the production mesh (tests run (2, 2) and (2, 2, 2));
    ``reduced`` takes the arch's reduced config and ``shape`` a shape
    object in place of the registry's ``shape_name``."""
    ms = mesh_shape or M.production_mesh_shape(multi_pod)
    name = M.mesh_name(ms)
    shape, cfg, specs, statics, step, params_meta = _cell(
        arch_id, shape_name, reduced, shape, ms)
    notes = []
    if not _GATHER_RULE:
        _gather_rule()
        _GATHER_RULE.append(True)
    for op in _REPLICATED:
        _REPLICATED[op] = False
    t0 = time.perf_counter()
    with M.fake_world(ms.size):
        mesh = M.make_mesh(ms.sizes, ms.axis_names)
        for _ in range(MAX_FALLBACKS):
            try:
                costs, arg_bytes, out_bytes = _trace(
                    step, arch_id, shape, specs, params_meta, mesh)
                break
            except Exception as e:  # noqa: BLE001 — retry with a rule
                op = _missing_rule(e)
                if op is None or op in _REPLICATED:
                    raise
                _replicate_rule(op)
        else:
            raise RuntimeError(f"more than {MAX_FALLBACKS} operations "
                               "without a sharding rule")
    trace_s = time.perf_counter() - t0
    used = sorted(str(op) for op, hit in _REPLICATED.items() if hit)
    if used:
        notes.append("replicated (no DTensor sharding rule): "
                     + ", ".join(used))
    mf = flops_mod.model_flops(arch_id, shape, statics, cfg=cfg)
    mem_rec = {"argument_size_in_bytes": arg_bytes,
               "output_size_in_bytes": out_bytes,
               "temp_size_in_bytes": costs.peak_live_bytes,
               "generated_code_size_in_bytes": None,
               "alias_size_in_bytes": None}
    roof = analysis.make_roofline(
        arch_id, shape_name, name, ms.size, costs.flops, costs.bytes,
        sum(costs.collectives.values()), mf,
        mem_per_device=float(arg_bytes + costs.peak_live_bytes),
        notes="; ".join(notes))
    return {
        "arch": arch_id, "shape": shape_name, "mesh": name, "ok": True,
        "trace_s": trace_s, "n_ops": costs.n_ops,
        "flops_by_op": costs.flops_by_op,
        "memory_analysis": mem_rec,
        "collectives": analysis.collective_stats(
            costs.collectives, costs.collective_counts).to_json(),
        "roofline": roof.to_json(),
        "notes": notes,
    }


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Raise ``TimeoutError`` in the main thread after ``seconds``."""
    def expired(signum, frame):
        raise TimeoutError(f"still tracing after {seconds} s")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def failed_record(arch_id, shape_name, mesh_name, e: BaseException) -> dict:
    return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
            "ok": False, "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    # DTensor warns of implicit replication and suboptimal redistributions
    # op by op; the records say what ran replicated
    warnings.filterwarnings("ignore", category=UserWarning)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    cells = [(a, s) for a, s in registry.all_cells()
             if args.arch in ("all", a) and args.shape in ("all", s)]
    n_fail = 0
    for arch_id, shape_name in cells:
        for multi_pod in meshes:
            mesh_name = M.mesh_name(M.production_mesh_shape(multi_pod))
            fname = out_dir / f"{arch_id}__{shape_name}__{mesh_name}.json"
            if args.skip_existing and fname.exists():
                print(f"[skip] {fname.name}")
                continue
            print(f"[dryrun] {arch_id} × {shape_name} × {mesh_name} ...",
                  flush=True)
            try:
                with _time_limit(CELL_LIMIT_S):
                    rec = lower_cell(arch_id, shape_name, multi_pod)
                roof = rec["roofline"]
                print(f"  ok: traced {rec['trace_s']:.1f}s  "
                      f"flops/dev {roof['flops']:.3e}  "
                      f"coll {roof['coll_bytes']:.3e}B  "
                      f"bottleneck {roof['bottleneck']}", flush=True)
            except Exception as e:  # noqa: BLE001 — record and continue
                n_fail += 1
                rec = failed_record(arch_id, shape_name, mesh_name, e)
                print(f"  FAIL: {type(e).__name__}: {str(e)[:300]}",
                      flush=True)
            fname.write_text(json.dumps(rec, indent=1))
    print(f"done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
