"""``launch.dryrun.lower_cell`` on the reduced configs on (2, 2) and
(2, 2, 2) fake worlds, one process a call (the fake process group is
process-wide), for ``tests/test_torch_launch_tools.py``.  Imports no JAX,
so it also runs on a machine without it:

    PYTHONPATH=src python tests/lower_cells.py "[6, 7, 8, 9]"
    PYTHONPATH=src python tests/lower_cells.py "[0, 1]" matmul
    PYTHONPATH=src python tests/lower_cells.py "[2, 3]" rules

Prints one JSON object: each case's record beside its bound (``one``: the
unsharded count; ``n``: the devices) and its argument bytes beside those
its pspecs give (``want``); with ``matmul`` also an evenly divided
product's count; with ``rules``, last (it changes DTensor's rule of
``index_select`` for the rest of the process), the gcn case on (2, 2),
on (2, 2, 2), where ``index_select`` refuses an input split over
("pod", "data") as torch 2.11's rule does (emulated where the installed
one takes it) and runs replicated, and on (2, 2) again, whether
DTensor's own rule was back after that, and whether
``core.distributed.flattens_split`` says what a DTensor flatten does."""
import json
import sys
import warnings

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree
from repro_torch.configs import registry as R
from repro_torch.configs.shapes import GNNShape, LMShape, RecSysShape
from repro_torch.launch import dryrun, mesh as M, sharding as S, steps
from repro_torch.launch.op_costs import OpCosts
from repro_torch.optim import adamw

MESHES = [M.MeshShape((2, 2), ("data", "model")),
          M.MeshShape((2, 2, 2), ("pod", "data", "model"))]
# the LM cells on the 3-D world are left out: DTensor's sharding search
# over their strided shards runs for minutes an operation
CASES = [("qwen3-0.6b", LMShape("train", "train", 32, 4), MESHES[:1]),
         ("qwen3-0.6b", LMShape("decode", "decode", 32, 4), MESHES[:1]),
         ("gcn-cora", GNNShape("g", "fullgraph", n_nodes=60, n_edges=256,
                               d_feat=32, n_classes=4), MESHES),
         ("dlrm-rm2", RecSysShape("t", "train", 64), MESHES),
         # long_500k's layout: batch 1, the cache's sequence over every axis
         ("qwen3-0.6b", LMShape("long", "decode", 64, 1), MESHES[:1]),
         ("gemma-7b", LMShape("long", "decode", 64, 1), MESHES[:1]),
         # the MoE decodes: long_500k's layout, and decode_32k's (batch 8:
         # the batch over dp, the cache's sequence over model)
         ("grok-1-314b", LMShape("long", "decode", 64, 1), MESHES[:1]),
         ("llama4-maverick-400b-a17b", LMShape("long", "decode", 64, 1),
          MESHES[:1]),
         ("grok-1-314b", LMShape("decode", "decode", 64, 8), MESHES[:1]),
         ("llama4-maverick-400b-a17b", LMShape("decode", "decode", 64, 8),
          MESHES[:1])]


def local_bytes(t, spec, ms):
    shape = list(t.shape)
    for d, entry in enumerate(spec):
        for a in S.entry_axes(entry):
            g = M.axis_sizes(ms)[a]
            shape[d] = -(-shape[d] // g)
    n = 1
    for s in shape:
        n *= s
    return n * t.element_size()


def lower(cases, matmul: bool) -> dict:
    out = []
    for arch, shape, meshes in [CASES[i] for i in cases]:
        cfg = R.get_config(arch, reduced=True, shape=shape)
        specs, statics = R.specs_for(arch, cfg, shape)
        params = dryrun.param_tree_for(arch, cfg)
        args = [params]
        if steps.needs_optimizer(arch, shape):
            args.append(tree.eval_shape(adamw.init_state, params))
        one = dryrun.unsharded_costs(arch, None, reduced=True, shape=shape)
        for ms in meshes:
            rec = dryrun.lower_cell(arch, None, mesh_shape=ms, reduced=True,
                                    shape=shape)
            p_spec = S.param_pspecs(arch, params, ms)
            pairs = [(params, p_spec), (specs, S.input_pspecs(arch, shape,
                                                              specs, ms))]
            if len(args) == 2:
                pairs.append((args[1], S.opt_state_pspecs(p_spec)))
            want = 0
            for t, sp in pairs:
                want += sum(local_bytes(l, s, ms) for l, s in
                            zip(tree.leaves(t), S.spec_leaves(sp)))
            out.append(dict(
                arch=arch, kind=shape.kind, mesh=rec["mesh"], ok=rec["ok"],
                n=ms.size,
                arg=rec["memory_analysis"]["argument_size_in_bytes"],
                want=want, flops=rec["roofline"]["flops"], one=one.flops,
                coll=rec["roofline"]["coll_bytes"],
                model=rec["roofline"]["model_flops"], notes=rec["notes"]))
    if not matmul:
        return dict(cells=out)
    # an evenly divided product: each device counts the global flops ÷ 16
    from torch.distributed.tensor import distribute_tensor
    with M.fake_world(16):
        mesh = M.make_mesh((4, 4), ("data", "model"))
        with FakeTensorMode():
            w = distribute_tensor(torch.empty(512, 128), mesh, S.to_placements(
                S.PSpec(None, "model"), mesh))
            a = distribute_tensor(torch.empty(256, 512), mesh, S.to_placements(
                S.PSpec("data", None), mesh))
            with OpCosts() as mm:
                a @ w
    return dict(cells=out, matmul=mm.flops,
                matmul_global=2 * 256 * 512 * 128)


def _as_torch_211(op):
    """Make DTensor's own rule of ``op`` refuse, as torch 2.11's
    ``index_select`` does, an input with a dim split over several mesh
    axes; a rule registered in its place is left alone → the own rule's
    entries in the propagator's tables."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._sharding_prop import LocalLRUCache
    prop = DTensor._op_dispatcher.sharding_propagator
    own = {n: getattr(prop, n).get(op) for n in dryrun._TABLES
           if isinstance(getattr(prop, n, None), dict)}
    plain = prop.propagate_op_sharding_non_cached

    def propagate(schema):
        if schema.op is op and all(getattr(prop, n).get(op) is f
                                   for n, f in own.items()):
            for spec in schema.args_spec:
                dims = [p.dim for p in spec.placements if p.is_shard()]
                if len(dims) != len(set(dims)):
                    raise RuntimeError(
                        f"Sharding propagation failed on op {schema}.\n"
                        "Error: DTensor operator implementation does not "
                        "support things like hybrid sharding strategies yet")
        return plain(schema)
    prop.propagate_op_sharding_non_cached = propagate
    prop.propagate_op_sharding = LocalLRUCache(propagate)
    getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
            lambda: None)()
    return own


def rules() -> dict:
    """The gcn case on (2, 2), (2, 2, 2) and (2, 2) again in one process
    (after the cells ``lower`` ran there): the second takes
    ``index_select`` replicated, the third DTensor's own rule again, and
    each (2, 2) record is the one the case gave first."""
    from torch.distributed.tensor import DTensor
    op = torch.ops.aten.index_select.default
    prop = DTensor._op_dispatcher.sharding_propagator
    own = _as_torch_211(op)
    arch, shape, _ = CASES[2]
    recs = []
    for ms in (MESHES[0], MESHES[1], MESHES[0]):
        rec = dryrun.lower_cell(arch, None, mesh_shape=ms, reduced=True,
                                shape=shape)
        recs.append(dict(mesh=rec["mesh"], flops=rec["roofline"]["flops"],
                         coll=rec["roofline"]["coll_bytes"],
                         notes=rec["notes"]))
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.core import distributed as D
    with M.fake_world(8):
        mesh = M.make_mesh((2, 2, 2), ("pod", "data", "model"))
        says = D.flattens_split(mesh)
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(4, 8, 3), mesh,
                                  [Shard(0), Shard(1), Replicate()])
            try:
                x.reshape(32, 3)
                does = True
            except Exception:  # noqa: BLE001 — 2.11's refusal
                does = False
    return dict(recs=recs, own_back=all(getattr(prop, n).get(op) is f
                                        for n, f in own.items()),
                flattens_split=says, flattens=does)


if __name__ == "__main__":
    warnings.filterwarnings("ignore")
    out = lower(json.loads(sys.argv[1]), "matmul" in sys.argv[2:])
    if "rules" in sys.argv[2:]:
        out["rules"] = rules()
    print(json.dumps(out))
