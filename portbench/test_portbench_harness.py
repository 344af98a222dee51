"""CPU tests of the benchmark's harness: the yardstick's arithmetic on
hand-counted shapes, the trace reduction, the precision of the control,
finding parts by name, and the import guard."""
import ast
import hashlib
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from pbcore import env, peaks, spec, trace, work  # noqa: E402
from pbref.precision import round_tf32  # noqa: E402


def test_spmm_work_counts_each_byte_once():
    # 10 entries, 4 rows read, 3 written, 8 wide: 2·10·8 operations;
    # 10·(4 + 4) bytes of values and columns, (4 + 3)·8·4 of rows
    assert work.spmm_work(10, 4, 3, 8) == (160, 80 + 224)


def test_roofline_takes_the_larger_bound():
    t_bytes = work.roofline_s(1.0, 3.35e12, "float32")
    assert t_bytes == pytest.approx(1.0)
    t_ops = work.roofline_s(67e12 * 2, 1.0, "float32")
    assert t_ops == pytest.approx(2.0)
    with pytest.raises(KeyError):
        peaks.flops_peak("float64")


def test_gcn_train_step_by_hand():
    # n 5 nodes, 7 entries, dims 3 -> 4 -> 2
    flops, calls = work.gcn_train_step(5, 7, [3, 4, 2])
    layer0 = 2 * (2 * 5 * 3 * 4) + 2 * (2 * 7 * 4)   # hW, dW; Â· twice
    layer1 = 3 * (2 * 5 * 4 * 2) + 2 * (2 * 7 * 2)   # hW, dW, dH; Â·
    assert flops == layer0 + layer1
    assert calls == [(7, 5, 5, 4)] * 2 + [(7, 5, 5, 2)] * 2


def test_sampled_tree_work_by_hand():
    # fanouts (2, 3), dims 4 -> 5 -> 6: levels of 1, 2, 6 nodes
    flops, calls = work.sampled_tree_work([2, 3], [4, 5, 6])
    # layer 0 at levels 0 and 1 (3 rows): two products 3x4x5; children
    # 2 (of the seed) and 6 (of level 1) at width 4
    layer0 = 2 * (2 * 3 * 4 * 5) + 2 * 2 * 4 + 2 * 6 * 4
    # layer 1 at the seed: two products 1x5x6; 2 children at width 5
    layer1 = 2 * (2 * 1 * 5 * 6) + 2 * 2 * 5
    assert flops == layer0 + layer1
    assert calls == [(2, 2, 1, 4), (6, 6, 2, 4), (2, 2, 1, 5)]
    with pytest.raises(ValueError):
        work.sampled_tree_work([2], [4, 5, 6])


def test_spmm_roofline_sums_calls_bounded_alone():
    calls = [((10, 4, 3, 8), 2), ((5, 5, 5, 1), 3)]
    want = (2 * work.roofline_s(*work.spmm_work(10, 4, 3, 8), "float32")
            + 3 * work.roofline_s(*work.spmm_work(5, 5, 5, 1), "float32"))
    assert work.spmm_roofline_s(calls, "float32") == pytest.approx(want)


def test_trace_reduction_unions_and_labels_gaps():
    device = [("k1", 10.0, 20.0), ("k2", 15.0, 30.0), ("k1", 50.0, 60.0),
              ("k3", 95.0, 130.0)]
    host = [("outer", 0.0, 100.0), ("aten::item", 32.0, 48.0)]
    tr = trace.reduce_events(device, host, (0.0, 100.0))
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(35e-6)   # 10-30, 50-60, 95-100
    assert tr.device_s["k1"] == pytest.approx(20e-6)
    assert tr.device_s["k3"] == pytest.approx(5e-6)   # clipped
    assert sum(tr.idle_by_host.values()) == pytest.approx(65e-6)
    # the gap 30-50 lies under aten::item, the innermost host operation
    assert tr.idle_by_host["host: aten::item"] == pytest.approx(20e-6)
    assert tr.kernel_s(["k1", "k3"]) == pytest.approx(25e-6)
    b = tr.breakdown(top=2)
    assert [n for n, _ in b["device_ops"]] == ["k1", "k2"]
    assert len(b["idle_gaps"]) <= 2


def test_profiled_window_on_the_cpu():
    with trace.Profiled(torch.device("cpu")) as p:
        torch.ones(64).sum()
    assert p.result is not None and p.result.window_s > 0
    assert p.result.busy_s == 0.0


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -1.0 - 2 ** -12, 3.0e-20], dtype=torch.float32)
    got = round_tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2 ** -10
    assert got[2] == 1.0                      # a tie rounds to even
    assert got[3] == 1.0 + 2 ** -9            # a tie rounds to even
    assert got[4] == -1.0
    bits = got.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())


def _digest(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_config_traffic_and_metric_take_only_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "portbench")
    b = tmp_path / "portbench"
    cfg = json.loads((b / "configs" / "gcn-arxiv.json").read_text())
    cfg["name"] = "gcn-other"
    (b / "configs" / "gcn-other.json").write_text(json.dumps(cfg))
    (b / "traffic" / "train_other.json").write_text(json.dumps(
        {"driver": "gnn_train_full"}))
    (b / "limits" / "gcn-other.train_other.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1.0}}))
    (b / "metrics" / "steps_run.other.py").write_text(
        "def read(run):\n    return run.host['steps']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gcn-other", "source": "x",
                             "file": "portbench/configs/gcn-other.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "gcn-other.train_other",
                               "config": "gcn-other",
                               "traffic": "train_other", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "steps_run.other", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "training step",
                               "moves": "train_step_ms",
                               "workloads": ["gcn-other.train_other"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("gcn-other.train_other", tmp_path)
    assert cell.config["name"] == "gcn-other"
    assert cell.driver().__name__.endswith("gnn_train_full")
    assert [m["name"] for m in cell.per_layer] == ["steps_run.other"]
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]

    class FakeRun:
        host = {"steps": 7}
    got = spec.read_metrics(cell, cell.per_layer, FakeRun())
    assert got == {"steps_run.other": {"value": 7.0, "unit": "1"}}
    after = _digest(b)
    assert {k: v for k, v in after.items() if k in before} == before
    # the committed cells still load as they did
    old = spec.load_cell("gcn-arxiv.train_full", tmp_path)
    assert [m["name"] for m in old.end_to_end] == ["setup_s",
                                                   "train_step_ms"]


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    cell = spec.load_cell("sage-reddit.serve_steady", ROOT)

    class Untraced:
        trace = None
        work = {}
        spans = {}
    assert spec.read_metrics(cell, cell.per_layer, Untraced()) == {}


def test_benchmark_file_names_every_part():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        assert set(cell.limits["limits"])
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(cell.reader(m["name"]), "read")
    for m in bench["per_layer"]:
        assert any(e["name"] == m["moves"] for e in bench["end_to_end"])


def test_forbidden_loaded_compares_whole_top_level_names():
    names = ["repro_torch", "repro_torch.serve", "jaxtyping", "numpy"]
    assert env.forbidden_loaded(names) == []
    assert env.forbidden_loaded(names + ["repro.serve"]) == ["repro"]
    assert env.forbidden_loaded(["jax._src", "flax"]) == ["flax", "jax"]


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_reads_the_jax_harness(path):
    assert not set(_imports(path)) & set(env.FORBIDDEN)
    assert "benchmarks" not in set(_imports(path))
    needle = "benchmarks" + "/"      # spelt so that this file passes too
    assert needle not in path.read_text()


_PROBE = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.path[:0] = [{bench!r}, {src!r}]
from pbcore import env, spec
for w in ("gcn-arxiv.train_full", "sage-reddit.serve_steady"):
    cell = spec.load_cell(w)
    cell.driver()
    for m in cell.end_to_end + cell.per_layer:
        cell.reader(m["name"])
import pbref.gcn_train, pbref.sage_serve
import repro_torch.launch.steps, repro_torch.serve.engine
import repro_torch.models.gnn.gcn, repro_torch.models.gnn.sage
import repro_torch.serve.device_sampler, repro_torch.sparse.graph
print(env.forbidden_loaded())
"""


def test_the_run_path_loads_no_jax_or_repro():
    code = _PROBE.format(bench=str(BENCH), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"),
                          "--workload", "gcn-arxiv.train_full", "--seed",
                          "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_graph_stand_ins_are_fixed_and_exact():
    from pbcore import graphs
    s, r = np.asarray([0, 1, 2]), np.asarray([1, 0, 0])
    ss, rr = graphs.symmetrize(torch.as_tensor(s), torch.as_tensor(r), 3)
    assert sorted(zip(ss.tolist(), rr.tolist())) == [(0, 1), (0, 2), (1, 0),
                                                     (2, 0)]
    a = graphs.powerlaw_exact(500, 2000, 1.5, 7)
    b = graphs.powerlaw_exact(500, 2000, 1.5, 7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    keys = a[0] * 500 + a[1]
    assert keys.numel() == 2000 and torch.unique(keys).numel() == 2000
    assert not bool((a[0] == a[1]).any())
    indptr, indices = graphs.powerlaw_csr_device(300, 4000, 0.8, 3, "cpu")
    assert int(indptr[-1]) == 4000 and indices.shape == (4000,)
    rows = torch.repeat_interleave(torch.arange(300), torch.diff(indptr))
    assert not bool((rows == indices).any())
