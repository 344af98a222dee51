"""CPU tests of both cells at a tiny size: each driver's whole run with the
program against the reference (the port's kernels run their plain versions
on the CPU), the result line's keys, the control failing the committed
limits, and each fault a cell can have, planted in the program, turning
``correct`` false.  The harness's look for a card is skipped: the drivers
are called on the CPU directly."""
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

from pbcore import spec  # noqa: E402

TRAIN, SERVE = "gcn-arxiv.train_full", "sage-reddit.serve_steady"
SEED = 3_000_000_019          # past 32 signed bits: --seed may be that large


def _tiny(tmp_path: pathlib.Path) -> pathlib.Path:
    """A checkout of the benchmark whose configurations keep their shapes
    but hold a few hundred nodes, and whose traffic checks every request;
    the limits are the committed ones."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "portbench"

    def edit(rel, graph=None, **kw):
        d = json.loads((b / rel).read_text())
        d.update(kw)
        if graph:
            d["graph"].update(graph)
        (b / rel).write_text(json.dumps(d))
    edit("configs/gcn-arxiv.json", graph={"nodes": 300, "edges": 1500},
         train_nodes=150, in_channels=8, hidden_channels=16,
         out_channels=5)
    edit("configs/sage-reddit.json", graph={"nodes": 400, "edges": 4000},
         in_channels=12, hidden_channels=16, out_channels=5, fanouts=[4, 3],
         batch_size=64)
    edit("traffic/serve_steady.json", rate_per_s=150, seeds_min=16,
         seeds_max=16, check_requests=1000, settle_wait_s=30)
    return tmp_path


def _run(root, workload, seconds=0.4, trace=False):
    cell = spec.load_cell(workload, root)
    return cell, cell.driver().run(cell, SEED, seconds, trace, device="cpu")


def _result_line(cell, run, trace):
    path = BENCH / "run.py"
    s = importlib.util.spec_from_file_location("portbench_run_main", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.result(cell, run, trace, {"platform": "cpu", "kind": "cpu",
                                         "count": 1})


@pytest.mark.parametrize("workload", [TRAIN, SERVE])
def test_cell_matches_the_reference_at_a_tiny_size(tmp_path, workload):
    cell, run = _run(_tiny(tmp_path), workload)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    line = _result_line(cell, run, trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert json.loads(json.dumps(line)) == line
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_a_traced_run_reports_its_window_and_breakdown(tmp_path):
    cell, run = _run(_tiny(tmp_path), TRAIN, trace=True)
    line = _result_line(cell, run, trace=True)
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device ran: the per-layer metrics that read it find nothing
    assert "b1_roofline.train" not in line["metrics"]


def test_the_control_fails_the_training_limits(tmp_path):
    root = _tiny(tmp_path)
    cell = spec.load_cell(TRAIN, root)
    drv = cell.driver()
    cfg, dev = cell.config, torch.device("cpu")
    s, r = drv.graph(cfg, dev)
    x, labels, mask, params = drv.inputs(cfg, SEED, dev)
    p0 = drv.flat(params)
    want = drv.reference(cfg, s, r, x, labels, mask, p0)
    got = drv.reference(cfg, s, r, x, labels, mask, p0, "tf32")
    gaps = drv.compare(cfg, got, want, p0)
    lim = cell.limits["limits"]
    assert any(gaps[k] > lim[k] for k in lim), gaps


def test_the_control_fails_the_serving_limit(tmp_path):
    from pbref import sage_serve as ref
    root = _tiny(tmp_path)
    cell = spec.load_cell(SERVE, root)
    drv = cell.driver()
    cfg, dev = cell.config, torch.device("cpu")
    indptr, indices = drv.graph(cfg, dev)
    x, params = drv.inputs(cfg, SEED, dev)
    due, seeds = drv.schedule(cell.traffic, 1.0, SEED, cfg["graph"]["nodes"])
    asked = list(enumerate(seeds))
    args = (indptr, indices, x, drv.flat(params), tuple(cfg["fanouts"]),
            cfg["sampler_key"], asked)
    want = ref.answers(*args)
    got = ref.answers(*args, precision="tf32")
    gap = drv.serve_gap([g.numpy() for g in got], want)
    assert gap > cell.limits["limits"]["serve_gap"], gap


def _wrap_train_step(monkeypatch, fault):
    from repro_torch.launch import steps
    build = steps.build_gnn_step

    def broken(*a, **kw):
        step = build(*a, **kw)
        calls = [0]

        def faulty(p, o, b):
            calls[0] += 1
            if fault == "altered_in_window" and calls[0] <= 3:
                return step(p, o, b)     # the first steps stay sound
            if fault == "half_batch":
                on = torch.nonzero(b["label_mask"]).flatten()
                m = b["label_mask"].clone()
                m[on[1::2]] = False
                return step(p, o, dict(b, label_mask=m))
            if fault in ("altered", "altered_in_window"):
                on = torch.nonzero(b["label_mask"]).flatten()[::100]
                y = b["labels"].clone()
                y[on] = (y[on] + 1) % 5
                return step(p, o, dict(b, labels=y))
            _, _, m = step(p, o, b)
            return p, o, m                       # state left unchanged
        return faulty
    monkeypatch.setattr(steps, "build_gnn_step", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "altered", "altered_in_window"])
def test_a_training_fault_turns_correct_false(tmp_path, monkeypatch, fault):
    _wrap_train_step(monkeypatch, fault)
    _, run = _run(_tiny(tmp_path), TRAIN, seconds=0.2)
    assert not run.correct, run.checks
    if fault == "altered_in_window":   # caught by the window's own step
        failing = {k for k, c in run.checks.items()
                   if not c["value"] <= c["limit"]}
        assert failing and failing <= {"window_loss_gap",
                                       "window_step_gap"}, run.checks


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_a_serving_fault_turns_correct_false(tmp_path, monkeypatch, fault):
    from repro_torch.models.gnn import sage
    from repro_torch.serve import engine
    if fault == "half_batch":
        pack = engine.GNNServer._device_batch

        def half(self, batch, bucket):
            trees = pack(self, batch, bucket)
            live = trees[2].nonzero()[0]
            trees[2, live[len(live) // 2:]] = 0    # half the seeds dropped
            return trees
        monkeypatch.setattr(engine.GNNServer, "_device_batch", half)
    else:
        forward = sage.forward

        def altered(*a, **kw):
            out = forward(*a, **kw)
            return torch.cat([out[:1] + 1.0, out[1:]])
        monkeypatch.setattr(sage, "forward", altered)
    _, run = _run(_tiny(tmp_path), SERVE)
    assert not run.correct, run.checks


_EMIT = """
import importlib.util, pathlib, sys
bench = pathlib.Path({bench!r})
sys.path[:0] = [str(bench), {src!r}]
from pbcore import spec
cell = spec.load_cell({workload!r}, bench.parent)
run = cell.driver().run(cell, {seed!r}, 0.2, False, device="cpu")
s = importlib.util.spec_from_file_location("portbench_run_main",
                                           bench / "run.py")
mod = importlib.util.module_from_spec(s)
s.loader.exec_module(mod)
sys.exit(mod.emit(cell, run, False,
                  {{"platform": "cpu", "kind": "cpu", "count": 1}}))
"""


@pytest.mark.parametrize("reader_loads", [None, "repro", "jax"])
def test_a_reader_that_loads_the_jax_side_gets_no_result(tmp_path,
                                                         reader_loads):
    """The guard runs after the readers: a reader that loads a forbidden
    module (faked in ``sys.modules``) leaves the run without a result."""
    root = _tiny(tmp_path)
    if reader_loads:
        reader = root / "portbench" / "metrics" / "train_step_ms.py"
        reader.write_text(reader.read_text() + f"""

_read = read


def read(run):
    import sys
    import types
    sys.modules[{reader_loads!r}] = types.ModuleType({reader_loads!r})
    return _read(run)
""")
    code = _EMIT.format(bench=str(root / "portbench"), src=str(ROOT / "src"),
                        workload=TRAIN, seed=SEED)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    if reader_loads:
        assert out.returncode == 3, out.stderr
        assert out.stdout.strip() == ""
        assert reader_loads in out.stderr
    else:
        assert out.returncode == 0, out.stderr
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is True
        assert "train_step_ms" in line["metrics"]


@pytest.mark.parametrize("law,lo,hi", [("fixed", 16, 16),
                                       ("log_uniform", 2, 16)])
def test_a_traffic_file_alone_sets_the_request_sizes(tmp_path, law, lo, hi):
    """A mix is data: the one generator reads its law, and every seed
    replays the same sizes and due times, drawing only the nodes."""
    cell = spec.load_cell(SERVE, _tiny(tmp_path))
    drv = cell.driver()
    traffic = dict(cell.traffic, seeds_law=law, seeds_min=lo, seeds_max=hi)
    due, a = drv.schedule(traffic, 2.0, SEED, 400)
    due2, b = drv.schedule(traffic, 2.0, SEED + 1, 400)
    sizes = [len(s) for s in a]
    assert len(a) == round(traffic["rate_per_s"] * 2.0)
    assert min(sizes) >= lo and max(sizes) <= hi
    assert sizes == [len(s) for s in b] and (due == due2).all()
    assert due[0] == 0.0 and due[-1] < 2.0
    assert any((x != y).any() for x, y in zip(a, b))
    with pytest.raises(ValueError):
        drv.schedule(dict(traffic, seeds_law="fixed", seeds_min=lo - 1),
                     2.0, SEED, 400)
