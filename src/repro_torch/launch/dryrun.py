"""Multi-pod dry run (port of ``repro.launch.dryrun``): every (architecture
× input shape) cell traced once on a fake world of 256 ranks (16×16) or
512 (2×16×16), one JSON record a cell.

    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
        --mesh pod --out /tmp/dryrun
    python -m repro_torch.launch.dryrun --jobs 6 --bound --out DIR
    python -m repro_torch.launch.dryrun --cells ARCH:SHAPE:pod,... --out DIR
    python -m repro_torch.launch.dryrun --compare A/sweep.json B/sweep.json

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
operations, and its ``flops_by_op`` says where the flops went; so do
the operations a model ran whole on every rank itself for want of a rule
(``core.distributed.ran_whole``).  An operation whose rule takes no input
with a dim split over several mesh axes (torch 2.11's ``index_select``,
and ``index`` on a batch over ``("pod", "data")``) runs replicated the
same way, and the notes say so.  Every such rule holds for its cell
only: the next cell in the process starts from DTensor's own rules.  A strided
shard's size is computed on plain CPU tensors (fake ones cannot be read
back); DTensor's search for the cheapest redistribution of such shards
can run for minutes an operation, so ``main`` records a cell still
tracing after ``CELL_LIMIT_S`` as failed.  ``unsharded_costs`` counts a
cell's step on one device that holds all of it: each traced cell's
per-device flops lie between that count ÷ the devices and that count.

``main`` traces each cell in a process of its own (a fake process group
is process-wide), ``--jobs`` at a time, niced and on one thread each:
the LM decode cells first, then the prefill and the train cells (5–15
min each: the longest first, as they set the sweep's wall time), then
the others.  It writes each
cell's record, its log and ``sweep.json``: the torch version, the card
where ``nvidia-smi`` answers, and a row a cell (``ok``, flops and
collective bytes a device, the notes; for a failed cell the operation
DTensor names, the last frame in ``repro_torch`` and the error's first
line).  With ``--bound`` each (arch, shape) is also counted unsharded, in
a process of its own (a prefill or train shape's counts before its
cells, the others last), and each row says where its flops a device lie
in [unsharded ÷ devices, unsharded] (``replication``: 1 split
perfectly, the number of devices replicated; ``held``).  A cell still
running ``--deadline-s`` after the start is killed, one not started by
then is not run.  ``--compare`` prints two sweeps' rows side by side and
fails when a cell traced in the first and not in the second.
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
import os
import re
import signal
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core import distributed as D
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
_SPLIT: set = set()             # of those, the ops whose own rule refused
_GATHER_RULE: list = []         # [True] once ``_gather_rule`` registered
# the propagator's tables of rules, by the names torch 2.11 and 2.13 use
_TABLES = ("op_to_rules", "op_strategy_funcs",
           "op_single_dim_strategy_funcs", "op_to_schema_info",
           "op_to_schema_info_for_single_dim_strategy")


def _replicate_rule(op):
    """Register an all-replicated sharding rule for ``op``: a placement a
    tensor argument, one a tensor of a list argument (``index``'s
    indices).  An own rule over single mesh dims, which torch 2.13 would
    take before it, is set aside (``_own_rules_back`` puts it back)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.experimental import register_sharding
    n_out = len(op._schema.returns)

    def rule(*args, **kwargs):
        _REPLICATED[op] = True
        ins = []
        for a in args:
            if isinstance(a, (list, tuple)):
                ins += [Replicate() for t in a if isinstance(t, DTensorSpec)]
            else:
                ins.append(Replicate() if isinstance(a, DTensorSpec)
                           else None)
        ins += [Replicate() for a in kwargs.values()
                if isinstance(a, DTensorSpec)]
        return [([Replicate()] * n_out, ins)]
    register_sharding(op)(rule)
    getattr(DTensor._op_dispatcher.sharding_propagator,
            "op_single_dim_strategy_funcs", {}).pop(op, None)
    _REPLICATED[op] = False


@contextlib.contextmanager
def _own_rules_back():
    """On leaving, DTensor's rules of the operations that the block ran
    replicated (``_REPLICATED``) as they were on entering, and the
    propagator's caches emptied: each cell starts from DTensor's own
    rules, whatever the cells before it in the process needed (a rule
    that refused only a dim split over several mesh axes serves the next
    cell again, and an op that had no rule gets DTensor's own handling
    again)."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    saved = {n: dict(getattr(prop, n)) for n in _TABLES
             if isinstance(getattr(prop, n, None), dict)}
    try:
        yield
    finally:
        for op in _REPLICATED:
            for n, table in saved.items():
                live = getattr(prop, n)
                if op in table:
                    live[op] = table[op]
                else:
                    live.pop(op, None)
        if _REPLICATED:
            _REPLICATED.clear()
            _SPLIT.clear()
            prop.propagate_op_sharding.cache_clear()
            clear = getattr(torch._C,
                            "_clear_DTensor_sharding_propagator_cache", None)
            if clear is not None:
                clear()


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
    """(the operation a DTensor error says has no sharding rule for its
    inputs, whether DTensor has a rule for it that takes no input whose
    dim is split over several mesh axes: torch 2.11's ``index_select``
    and ``index``, "does not support things like hybrid sharding"), or
    (None, False)."""
    while exc is not None:
        m, split = None, False
        if isinstance(exc, NotImplementedError):
            m = re.search(r"Operator (\S+) does not have a sharding",
                          str(exc))
        elif isinstance(exc, RuntimeError) and "hybrid sharding" in str(exc):
            m = re.search(r"Sharding propagation failed on op "
                          r"(aten\.\w+\.\w+)\(", str(exc))
            split = True
        if m:
            ns, name, overload = m.group(1).split(".")
            return getattr(getattr(getattr(torch.ops, ns), name),
                           overload), split
        exc = exc.__cause__
    return None, False


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
    D.RAN_WHOLE.clear()
    t0 = time.perf_counter()
    with M.fake_world(ms.size), _own_rules_back():
        mesh = M.make_mesh(ms.sizes, ms.axis_names)
        for _ in range(MAX_FALLBACKS):
            try:
                costs, arg_bytes, out_bytes = _trace(
                    step, arch_id, shape, specs, params_meta, mesh)
                break
            except Exception as e:  # noqa: BLE001 — retry with a rule
                op, split = _missing_rule(e)
                if op is None or op in _REPLICATED:
                    raise
                _replicate_rule(op)
                if split:
                    _SPLIT.add(str(op))
        else:
            raise RuntimeError(f"more than {MAX_FALLBACKS} operations "
                               "without a sharding rule")
        used = {str(op) for op, hit in _REPLICATED.items() if hit}
        split_ops = sorted(used & _SPLIT)
    trace_s = time.perf_counter() - t0
    none_ops = sorted(used.difference(split_ops) | D.RAN_WHOLE)
    for why, ops in (
            ("no DTensor sharding rule", none_ops),
            ("no DTensor rule for a dim split over several mesh axes",
             split_ops)):
        if ops:
            notes.append(f"replicated ({why}): " + ", ".join(ops))
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


MESH_OF = {"pod": False, "multipod": True}
_DECODE = ("decode_32k", "long_500k")
_HEAVY = ("prefill_32k", "train_4k")        # the longest first


def _record_name(arch_id, shape_name, multi_pod: bool) -> str:
    mesh_name = M.mesh_name(M.production_mesh_shape(multi_pod))
    return f"{arch_id}__{shape_name}__{mesh_name}"


def sweep_order(cells, meshes):
    """The (arch, shape, mesh) to trace, in the sweep's order: the LM
    decode cells, the prefill then the train cells, then the others."""
    decode = [(a, s, m) for m in meshes for a, s in cells if s in _DECODE]
    heavy = [(a, s, m) for h in _HEAVY for m in meshes for a, s in cells
             if s == h]
    other = [(a, s, m) for m in meshes for a, s in cells
             if s not in _DECODE + _HEAVY]
    return decode + heavy + other


def _failing_op(rec: dict):
    """The operation a failed record's error names, the last frame in
    ``repro_torch`` it passed, and the error's first line."""
    tb = rec.get("traceback", "")
    m = re.search(r"Sharding propagation failed (?:for|on op) "
                  r"(aten\.[\w.]+)", tb)
    frames = re.findall(r'File "[^"]*/(repro_torch/[^"]+)", line (\d+), '
                        r'in (\w+)\n\s+(.+)', tb)
    where = None
    if frames:
        f, line, fn, code = frames[-1]
        where = f"{f}:{line} {fn}: {code.strip()}"
    return (m.group(1) if m else None), where, \
        rec.get("error", "").split("\n")[0][:400]


def _row(out_dir: Path, arch_id, shape_name, mesh: str, status: str):
    name = _record_name(arch_id, shape_name, MESH_OF[mesh])
    r = dict(arch=arch_id, shape=shape_name, mesh=name.split("__")[-1],
             ok=False, status=status)
    path = out_dir / f"{name}.json"
    if status != "done" or not path.exists():
        return r
    rec = json.loads(path.read_text())
    r["ok"] = rec["ok"]
    if not rec["ok"]:
        r["op"], r["where"], r["error"] = _failing_op(rec)
        return r
    roof = rec["roofline"]
    r.update(trace_s=rec["trace_s"], flops=roof["flops"],
             coll_bytes=roof["coll_bytes"], n_devices=roof["n_devices"],
             notes=rec["notes"])
    one = out_dir / f"unsharded__{arch_id}__{shape_name}.json"
    if one.exists():
        n, u = roof["n_devices"], json.loads(one.read_text())["flops"]
        r.update(unsharded=u, replication=roof["flops"] * n / u,
                 held=u / n <= roof["flops"] <= u)
    return r


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def _sweep(todo, out_dir: Path, jobs: int, bound: bool,
           deadline_s) -> int:
    """Each cell of ``todo`` traced in a process of its own (this module
    with ``--in-process``), ``jobs`` at a time, niced, one thread each;
    with ``bound`` each (arch, shape)'s unsharded count too, a prefill or
    train shape's before its first cell, the others' last →
    ``sweep.json``.  Exit 1 when a cell failed or left its bound."""
    src = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep
           .join([src] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    queue, counted = [], set()
    for c in todo:
        if bound and c[1] in _HEAVY and c[1] not in counted:
            counted.add(c[1])
            queue += [("unsharded", p) for p in dict.fromkeys(
                o[:2] for o in todo if o[1] == c[1])]
        queue.append(("cell", c))
    if bound:
        queue += [("unsharded", p) for p in dict.fromkeys(
            c[:2] for c in todo if c[1] not in counted)]
    t0 = time.perf_counter()
    running, status = [], {}
    while queue or running:
        late = deadline_s is not None and \
            time.perf_counter() - t0 > deadline_s
        for job, proc, log in list(running):
            if proc.poll() is None and late:
                proc.kill()
                proc.wait()
                status[job] = "killed at the deadline"
            if proc.poll() is not None:
                running.remove((job, proc, log))
                log.close()
                status.setdefault(job, "done")
                print(f"[{time.perf_counter() - t0:7.1f} s] "
                      f"{' × '.join(job[1])} {job[0]}: {status[job]}",
                      flush=True)
        while queue and len(running) < jobs and not late:
            job = queue.pop(0)
            kind, c = job
            name = (_record_name(c[0], c[1], MESH_OF[c[2]])
                    if kind == "cell" else f"unsharded__{c[0]}__{c[1]}")
            args = ["--cells", ":".join(c), "--out", str(out_dir),
                    "--in-process"] + (["--unsharded"]
                                       if kind == "unsharded" else [])
            log = open(out_dir / f"{name}.log", "w")
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                stdout=log, stderr=subprocess.STDOUT, env=env,
                preexec_fn=lambda: os.nice(10))
            running.append((job, proc, log))
        if late:
            status.update({job: "not run" for job in queue})
            queue = []
        time.sleep(0.2)
    rows = [_row(out_dir, *c, status[("cell", c)]) for c in todo]
    summary = dict(torch=torch.__version__, card=_card(),
                   seconds=time.perf_counter() - t0,
                   traced=sum(r["ok"] for r in rows),
                   held=sum(bool(r.get("held")) for r in rows),
                   cells=len(rows), rows=rows)
    (out_dir / "sweep.json").write_text(json.dumps(summary, indent=1))
    print(f"torch {summary['torch']}, {summary['card']}: "
          f"{summary['traced']} of {len(rows)} cells trace in "
          f"{summary['seconds']:.1f} s" + (
              f", {summary['held']} within [unsharded ÷ devices, "
              "unsharded]" if bound else ""))
    bad = 0
    for r in rows:
        if not r["ok"]:
            print(f"  FAIL {r['arch']} × {r['shape']} × {r['mesh']}: "
                  f"{r['status']}, {r.get('op')} at {r.get('where')}: "
                  f"{r.get('error', '')[:200]}")
        elif bound and not r.get("held"):
            print(f"  OUT {r['arch']} × {r['shape']} × {r['mesh']}: "
                  f"{r['flops']:.6e} flops a device, unsharded "
                  f"{r.get('unsharded')}")
        bad += not r["ok"] or (bound and not r.get("held"))
    return 1 if bad else 0


def _in_process(cells, out_dir: Path, unsharded: bool) -> int:
    """Trace (or with ``unsharded`` count on one device) each cell here,
    one after the other, and write its record."""
    n_fail = 0
    for c in cells:
        arch_id, shape_name = c[:2]
        if unsharded:
            (out_dir / f"unsharded__{arch_id}__{shape_name}.json").write_text(
                json.dumps({"flops": unsharded_costs(arch_id,
                                                     shape_name).flops}))
            continue
        multi_pod = MESH_OF[c[2]]
        name = _record_name(arch_id, shape_name, multi_pod)
        print(f"[dryrun] {name.replace('__', ' × ')} ...", flush=True)
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
            rec = failed_record(arch_id, shape_name, name.split("__")[-1], e)
            print(f"  FAIL: {type(e).__name__}: {str(e)[:300]}", flush=True)
        (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=1))
    return 1 if n_fail else 0


def compare(a_path, b_path) -> int:
    """Two sweeps' rows side by side (flops a device, or FAIL; "equal"
    where flops, collective bytes and notes all are); 1 when a cell
    traced in the first and not in the second."""
    a, b = (json.loads(Path(p).read_text()) for p in (a_path, b_path))
    key = lambda r: (r["arch"], r["shape"], r["mesh"])  # noqa: E731
    rb = {key(r): r for r in b["rows"]}
    print(f"A: torch {a['torch']}, {a['card']}\n"
          f"B: torch {b['torch']}, {b['card']}")
    lost = n_equal = 0
    for r in a["rows"]:
        o = rb.get(key(r))
        fa = f"{r['flops']:.6e}" if r["ok"] else "FAIL"
        fb = ("not swept" if o is None else
              f"{o['flops']:.6e}" if o["ok"] else "FAIL")
        same = (o is not None and r["ok"] and o["ok"] and
                (r["flops"], r["coll_bytes"], r["notes"])
                == (o["flops"], o["coll_bytes"], o["notes"]))
        n_equal += same
        lost += bool(r["ok"] and (o is None or not o["ok"]))
        print(f"{' × '.join(key(r))}: {fa} / {fb}"
              f"{' (equal)' if same else ''}")
    print(f"{n_equal} of {len(a['rows'])} cells equal; {lost} traced in A "
          "and not in B")
    return 1 if lost else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--cells", help="ARCH:SHAPE:pod|multipod,... in place "
                    "of --arch, --shape and --mesh")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at a time, each in its own process")
    ap.add_argument("--bound", action="store_true",
                    help="also count each (arch, shape) on one device")
    ap.add_argument("--deadline-s", type=float)
    ap.add_argument("--compare", nargs=2, metavar="SWEEP_JSON")
    ap.add_argument("--in-process", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--unsharded", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    # DTensor warns of implicit replication and suboptimal redistributions
    # op by op; the records say what ran replicated
    warnings.filterwarnings("ignore", category=UserWarning)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)

    out_dir = Path(args.out).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.cells:
        todo = [tuple(c.split(":")) for c in args.cells.split(",")]
    else:
        meshes = {"pod": ["pod"], "multipod": ["multipod"],
                  "both": ["pod", "multipod"]}[args.mesh]
        todo = sweep_order(
            [(a, s) for a, s in registry.all_cells()
             if args.arch in ("all", a) and args.shape in ("all", s)],
            meshes)
    if args.in_process:
        return _in_process(todo, out_dir, args.unsharded)
    if args.skip_existing:
        todo = [c for c in todo if not (
            out_dir / f"{_record_name(c[0], c[1], MESH_OF[c[2]])}.json")
            .exists()]
    return _sweep(todo, out_dir, args.jobs, args.bound, args.deadline_s)


if __name__ == "__main__":
    raise SystemExit(main())
