"""The port's launch tools (``repro_torch.launch.{flops, analysis,
op_costs, mesh, sharding, dryrun}``, the registry's cells and specs, the
transformer's ``param_specs``/``cache_specs``, ``steps.build_step``)
against the reference's on the CPU: the 40 cells, their input specs,
statics, ``needs_optimizer`` and ``model_flops``; parameter trees and LM
caches; every parameter and input ``PSpec`` against the reference's
``PartitionSpec`` on both production meshes; the divisibility contract
of ``test_sharding_rules.py``; ``op_costs`` against ``hlo_costs`` on a
matmul and on loops; the roofline; and ``lower_cell`` on (2, 2) and
(2, 2, 2) fake worlds in a subprocess (the fake process group is
process-wide), a batch-1 decode on long_500k's layout (the cache's
sequence over every axis) among its cells."""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as JR
from repro.launch import flops as JF
from repro.launch import hlo_costs
from repro.launch import sharding as JS
from repro.launch import steps as JSteps
from repro_torch import tree
from repro_torch.configs import registry as R
from repro_torch.launch import analysis, dryrun, flops as F, op_costs
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.launch import steps
from repro_torch.models.lm import transformer as T

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = list(JR.all_cells())
LM_ARCHS = [a for a in sorted(R.ARCHS) if R.ARCHS[a].family == "lm"]


class FakeMesh:
    """The reference test's mesh stand-in (axis names and sizes)."""

    def __init__(self, multi_pod):
        self.axis_names = (("pod", "data", "model") if multi_pod
                           else ("data", "model"))
        self.shape = dict(zip(self.axis_names,
                              (2, 16, 16) if multi_pod else (16, 16)))


def _jdtype(x):
    return str(x.dtype)


def _tdtype(t):
    return str(t.dtype).replace("torch.", "")


def _same_tree(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), tree.leaves(ttree)
    assert len(jl) == len(tl)
    for x, y in zip(jl, tl):
        assert tuple(x.shape) == tuple(y.shape)
        assert _jdtype(x) == _tdtype(y)
        assert y.device.type == "meta"


def _j_param_tree(arch_id, cfg):
    """The reference dry run's ``param_tree_for`` (its module sets
    XLA_FLAGS at import, so it is not imported here)."""
    fam = JR.ARCHS[arch_id].family
    if fam == "lm":
        from repro.models.lm import transformer as JT
        return JT.param_specs(cfg)
    from repro.models.gnn import dimenet, gat, gcn, schnet
    from repro.models.recsys import dlrm
    m = {"gcn-cora": gcn, "gat-cora": gat, "schnet": schnet,
         "dimenet": dimenet, "dlrm-rm2": dlrm}[arch_id]
    return jax.eval_shape(lambda k: m.init_params(k, cfg),
                          jax.random.key(0))


def test_all_cells_in_order():
    assert list(R.all_cells()) == CELLS
    assert len(CELLS) == 40


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_specs_statics_optimizer_flops(arch, shape):
    j_specs, j_statics = JR.input_specs(arch, shape)
    t_specs, t_statics = R.input_specs(arch, shape)
    assert t_statics == j_statics
    _same_tree(j_specs, t_specs)
    jshape = JR.shapes_for(arch)[shape]
    tshape = R.shapes_for(arch)[shape]
    assert steps.needs_optimizer(arch, tshape) == \
        JSteps.needs_optimizer(arch, jshape)
    assert F.model_flops(arch, shape, t_statics) == \
        JF.model_flops(arch, shape, j_statics)
    assert F.model_flops(arch, tshape, t_statics) == \
        JF.model_flops(arch, shape, j_statics)


@pytest.mark.parametrize("arch", sorted(R.ARCHS))
def test_param_tree_for(arch):
    shape = next(iter(R.shapes_for(arch).values()))
    cfg = R.get_config(arch, shape=shape)
    jcfg = JR.get_config(arch, shape=JR.shapes_for(arch)[shape.name])
    _same_tree(_j_param_tree(arch, jcfg), dryrun.param_tree_for(arch, cfg))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_and_cache_specs(arch):
    from repro.models.lm import transformer as JT
    cfg, jcfg = R.get_config(arch), JR.get_config(arch)
    _same_tree(JT.param_specs(jcfg), T.param_specs(cfg))
    for dtype, jd in ((None, None), (torch.float32, jnp.float32)):
        _same_tree(JT.cache_specs(jcfg, 3, 40, dtype=jd),
                   T.cache_specs(cfg, 3, 40, dtype=dtype))


def _norm(entry):
    """A spec entry with one-axis tuples written as the axis."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _same_specs(jspecs, tspecs):
    jl = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    tl = S.spec_leaves(tspecs)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert isinstance(t, S.PSpec)
        assert [_norm(e) for e in j] == [_norm(e) for e in t]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(R.ARCHS))
def test_pspecs_equal_reference(arch, multi_pod):
    jmesh = FakeMesh(multi_pod)
    tmesh = M.production_mesh_shape(multi_pod)
    for shape_name in R.shapes_for(arch):
        shape = R.shapes_for(arch)[shape_name]
        jshape = JR.shapes_for(arch)[shape_name]
        cfg = R.get_config(arch, shape=shape)
        jcfg = JR.get_config(arch, shape=jshape)
        params = dryrun.param_tree_for(arch, cfg)
        jparams = _j_param_tree(arch, jcfg)
        _same_specs(JS.param_pspecs(arch, jparams, jmesh),
                    S.param_pspecs(arch, params, tmesh))
        jspecs, _ = JR.input_specs(arch, shape_name)
        specs, _ = R.input_specs(arch, shape_name)
        _same_specs(JS.input_pspecs(arch, jshape, jspecs, jmesh),
                    S.input_pspecs(arch, shape, specs, tmesh))
        p_pspec = S.param_pspecs(arch, params, tmesh)
        _same_specs(JS.opt_state_pspecs(
            JS.param_pspecs(arch, jparams, jmesh)),
            S.opt_state_pspecs(p_pspec))


def _axis_size(mesh, entry):
    n = 1
    for a in S.entry_axes(entry):
        n *= M.axis_sizes(mesh)[a]
    return n


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(R.ARCHS))
def test_param_and_input_shardings_divide(arch, multi_pod):
    """Counterpart of ``test_sharding_rules.py``: every argument sharding
    divides its dimension on both production meshes."""
    mesh = M.production_mesh_shape(multi_pod)
    for shape_name, shape in R.shapes_for(arch).items():
        cfg = R.get_config(arch, shape=shape)
        specs, _ = R.input_specs(arch, shape_name)
        params = dryrun.param_tree_for(arch, cfg)
        for t, ps in ((params, S.param_pspecs(arch, params, mesh)),
                      (specs, S.input_pspecs(arch, shape, specs, mesh))):
            leaves, spl = tree.leaves(t), S.spec_leaves(ps)
            assert len(leaves) == len(spl)
            for leaf, spec in zip(leaves, spl):
                for dim, entry in enumerate(spec):
                    assert leaf.shape[dim] % _axis_size(mesh, entry) == 0, \
                        (arch, shape_name, leaf.shape, spec)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = M.production_mesh_shape(True)
    assert S.to_placements(S.PSpec(("pod", "data"), "model"), mesh) == \
        (Shard(0), Shard(0), Shard(1))
    assert S.to_placements(S.PSpec(None, None, ("pod", "data", "model")),
                           mesh) == (Shard(2), Shard(2), Shard(2))
    assert S.to_placements(S.PSpec(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        S.to_placements(S.PSpec(("data", "pod")), mesh)
    with pytest.raises(ValueError):
        S.to_placements(S.PSpec("model", "model"), mesh)


def test_make_production_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="256 ranks"):
        M.make_production_mesh()
    assert M.dp_axes(M.production_mesh_shape(True)) == ("pod", "data")
    assert M.all_axes(M.production_mesh_shape()) == ("data", "model")


# --- op_costs against hlo_costs -------------------------------------------

def _hlo(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def test_matmul_flops_equal_hlo_costs():
    a = jax.ShapeDtypeStruct((64, 256), jnp.float32)
    b = jax.ShapeDtypeStruct((256, 32), jnp.float32)
    jflops, _, _ = hlo_costs.corrected_costs(_hlo(lambda a, b: a @ b, a, b))
    flops, byts, coll = op_costs.step_costs(
        lambda a, b: a @ b, torch.zeros(64, 256), torch.zeros(256, 32))
    assert flops == jflops == 2 * 64 * 256 * 32
    assert byts == 4 * (64 * 256 + 256 * 32 + 64 * 32)
    assert sum(coll.values()) == 0
    with op_costs.OpCosts() as c:
        torch.zeros(64, 256) @ torch.zeros(256, 32) + 1.0
        torch.bmm(torch.zeros(3, 4, 5), torch.zeros(3, 5, 6))
    assert c.flops_by_op == {"aten::mm": flops, "aten::bmm": 2 * 3 * 4 * 5 * 6}


@pytest.mark.parametrize("iters", [10, 40])
def test_loop_flops_equal_scan(iters):
    n = 128
    x = jax.ShapeDtypeStruct((n, n), jnp.float32)

    def jfn(x, w):
        def body(c, _):
            return c @ w, None
        out, _ = jax.lax.scan(body, x, None, length=iters)
        return out
    jflops, _, _ = hlo_costs.corrected_costs(_hlo(jfn, x, x))

    def fn(c, w):
        for _ in range(iters):
            c = c @ w
        return c
    flops, _, _ = op_costs.step_costs(fn, torch.zeros(n, n),
                                      torch.zeros(n, n))
    assert flops == jflops == 2.0 * n ** 3 * iters


def test_bytes_scale_with_loop_length():
    def make(iters):
        def fn(c):
            for _ in range(iters):
                c = torch.tanh(c) * 1.0001
            return c
        return fn
    x = torch.zeros(256, 256)
    _, b10, _ = op_costs.step_costs(make(10), x)
    _, b40, _ = op_costs.step_costs(make(40), x)
    assert 2.5 < b40 / b10 < 4.5


def test_tensor_bytes():
    assert op_costs.tensor_bytes(torch.zeros(4, 8)) == 128
    assert op_costs.tensor_bytes(torch.zeros(10, dtype=torch.bfloat16)) == 20
    assert op_costs.tensor_bytes((torch.zeros(2, 2),
                                  torch.zeros(3, dtype=torch.int32))) == 28
    assert op_costs.tensor_bytes(torch.zeros(7, dtype=torch.bool)) == 7


def test_fake_count_equals_real_count():
    from torch._subclasses.fake_tensor import FakeTensorMode
    w = torch.randn(32, 16)

    def fn(x, w):
        return torch.relu(x @ w).sum()
    real = op_costs.step_costs(fn, torch.randn(8, 32), w)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = op_costs.step_costs(fn, torch.empty(8, 32), w)
    assert real == fake


def test_roofline_terms():
    r = analysis.make_roofline("a", "s", "16x16", 256, flops=989e12,
                               byts=3.35e12 * 2, coll_bytes=50e9 * 0.5,
                               model_flops=256 * 989e12 / 2)
    assert r.compute_s == 1.0 and r.memory_s == 2.0
    assert r.collective_s == 0.5 and r.bottleneck == "memory"
    assert r.useful_ratio == 0.5
    assert analysis.wire_bytes("all-gather", 16, 4) == 12
    assert analysis.wire_bytes("reduce-scatter", 16, 4) == 48
    assert analysis.wire_bytes("all-reduce", 16, 4) == 24
    assert analysis.wire_bytes("all-to-all", 16, 4) == 12
    assert analysis.wire_bytes("collective-permute", 16, 4) == 16
    assert analysis.wire_bytes("all-reduce", 16, 1) == 0


# --- lower_cell on fake worlds (tests/lower_cells.py) ----------------------

# fake tensors compute nothing: one thread leaves the cores to the other
# test workers
_ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def lowered():
    # the LM cases (and the matmul) in one process, the others (then the
    # rule check) in a second, the batch-1 decodes in a third, the MoE
    # decodes in a fourth
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "lower_cells.py"), *args],
        cwd=ROOT, env=_ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
        for args in (("[0, 1]", "matmul"), ("[2, 3]", "rules"), ("[4, 5]",),
                     ("[6, 7, 8, 9]",))]
    out = {}
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-4000:]
        got = json.loads(stdout.strip().splitlines()[-1])
        out["cells"] = out.get("cells", []) + got.pop("cells")
        out.update(got)
    return out


def test_sharded_matmul_counts_one_devices_share(lowered):
    assert lowered["matmul"] == lowered["matmul_global"] / 16


@pytest.mark.parametrize("i", range(12))
def test_lower_cell_on_fake_worlds(lowered, i):
    rec = lowered["cells"][i]
    assert rec["ok"], rec
    assert rec["mesh"] in ("2x2", "2x2x2")
    # argument bytes: the sum of the local shards' bytes
    assert rec["arg"] == rec["want"], rec
    # each device runs at least its share of the unsharded step's flops
    # and at most the whole of it
    assert rec["one"] / rec["n"] <= rec["flops"] <= rec["one"], rec
    assert rec["model"] > 0


@pytest.mark.parametrize("i", (6, 7))
def test_batch1_decode_replicates_no_operation(lowered, i):
    """The batch-1 decodes attend on each rank's slice of the cache's
    sequence: no operation runs replicated on the whole cache."""
    rec = lowered["cells"][i]
    assert (rec["arch"], rec["kind"]) in (("qwen3-0.6b", "decode"),
                                          ("gemma-7b", "decode"))
    assert rec["notes"] == [], rec


def test_missing_rule_reads_both_dtensor_errors():
    """An operation without a rule, and one whose rule takes no input with
    a dim split over several mesh axes (torch 2.11's message), run
    replicated; any other error is the cell's."""
    none = NotImplementedError("Operator aten.segment_reduce.default does "
                               "not have a sharding strategy registered.")
    split = RuntimeError(
        "Sharding propagation failed on op aten.index_select.default(Spec("
        "f32[4096, 16](S(0)[0]S(0)[1]R)), 0, Spec(i64[12288](S(0)[0]S(0)[1]"
        "R))) on DeviceMesh(...).\nError: Tensor dim 0 is already sharded "
        "on mesh dim 0, DTensor operator implementation does not support "
        "things like hybrid sharding strategies yet (i.e. [Shard(0), "
        "Shard(0)])")
    wrapped = RuntimeError("outer")
    wrapped.__cause__ = split
    assert dryrun._missing_rule(none) == (
        torch.ops.aten.segment_reduce.default, False)
    assert dryrun._missing_rule(wrapped) == (
        torch.ops.aten.index_select.default, True)
    assert dryrun._missing_rule(RuntimeError(
        "Attempted to flatten multiple dimensions")) == (None, False)


def test_split_rule_holds_for_its_cell_only(lowered):
    """A cell whose ``index_select`` refused ids over ("pod", "data") runs
    it replicated, with its note; a later cell in the process traces with
    DTensor's own rules again, as it did first, whatever rules the cells
    between needed."""
    first, split, again = lowered["rules"]["recs"]
    assert (split["mesh"], first["mesh"]) == ("2x2x2", "2x2")
    assert ("replicated (no DTensor rule for a dim split over several mesh "
            "axes): aten.index_select.default") in split["notes"]
    assert again == first
    # the gcn case's (2, 2) record, traced before the dlrm cells and the
    # (2, 2, 2) ones ran in the process
    alone = next(c for c in lowered["cells"]
                 if (c["arch"], c["mesh"]) == ("gcn-cora", "2x2"))
    assert first == {k: alone[k] for k in ("mesh", "flops", "coll", "notes")}
    assert lowered["rules"]["own_back"]


def test_flattens_split_reads_dtensor(lowered):
    """``core.distributed.flattens_split`` says whether this torch's DTensor
    flattens two dims whose second is split, as a real flatten does."""
    rules = lowered["rules"]
    assert rules["flattens_split"] is rules["flattens"]


def test_dryrun_main_records_a_cell(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "dlrm-rm2", "--shape", "serve_p99", "--mesh", "pod", "--out",
         str(tmp_path)], cwd=ROOT,
        env=_ENV,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    rec = json.loads((tmp_path / "dlrm-rm2__serve_p99__16x16.json")
                     .read_text())
    assert rec["ok"] and rec["roofline"]["n_devices"] == 256
    assert rec["roofline"]["flops"] > 0
    assert not torch.distributed.is_initialized()
