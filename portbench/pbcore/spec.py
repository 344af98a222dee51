"""Finding a cell's parts by name.

``BENCHMARK.json`` names cells, configurations, traffic mixes and metrics;
each part lives in a file of its own under the benchmark's folder, found
by its name alone, so a later change adds a cell, a configuration, a
traffic mix or a metric by adding files and entries, never by editing a
file that is there:

* ``configs/<config>.json`` (the entry's ``file``): the model and its
  graph, with ``source``, ``reduced``, ``assumed`` and ``departures``;
* ``traffic/<traffic>.json``: the traffic's parameters, among them the
  ``driver`` that runs it;
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct`` in that cell, with the readings it was set from;
* ``drivers/<driver>.py``: ``run(cell) -> Run`` (set-up, window, check);
* ``metrics/<metric>.py``: ``read(run) -> float | None``, one file a
  metric, end-to-end and per-layer alike.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Dict, List, Optional

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _load(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


def _module(path: pathlib.Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell as a run sees it."""

    name: str
    root: pathlib.Path
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def bench(self) -> pathlib.Path:
        return self.root / "portbench"

    def driver(self) -> ModuleType:
        name = self.traffic["driver"]
        return _module(self.bench / "drivers" / f"{name}.py",
                       f"portbench_driver_{name}")

    def reader(self, metric: str) -> ModuleType:
        return _module(self.bench / "metrics" / f"{metric}.py",
                       f"portbench_metric_{metric}")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Optional[pathlib.Path] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    root = pathlib.Path(root or ROOT)
    spec = _load(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r}; have {sorted(by_name)}")
    w = by_name[workload]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / "portbench"
    return Cell(
        name=workload, root=root, workload=w,
        config=_load(root / cfg["file"]),
        traffic=_load(bench / "traffic" / f"{w['traffic']}.json"),
        limits=_load(bench / "limits" / f"{workload}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)])


def read_metrics(cell: Cell, metrics: List[dict], run) -> Dict[str, dict]:
    """Each metric's reader on ``run``; a reader that finds nothing to read
    returns ``None`` and its metric is left out."""
    out = {}
    for m in metrics:
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
