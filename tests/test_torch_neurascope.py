"""The port's NeuraScope (``repro_torch.launch.neurascope``) against the
reference's, on one flight recorder written by a port
``ClusterServer(device="cpu", tracing=True, telemetry_jsonl=...)`` across
a hot swap and a graph flush:

* ``load_flight`` gives the same records and meta in both;
* ``render_html`` gives equal strings, ``summarize`` equal stdout and
  ``check`` equal results (0 findings);
* a recorder with a span removed and one with a wrong
  ``schema_version`` fail ``--check`` in both;
* ``tail_panels`` follows a growing file (a partial last line waits for
  the next frame), and ``scrape_panels`` reads the port's metrics server
  as the reference's does.
"""
import contextlib
import io
import json

import numpy as np
import pytest

from repro.launch import neurascope as jscope
from repro_torch.checkpoint import store as ckpt_store
from repro_torch.launch import neurascope as tscope
from repro_torch.launch.gnn_serve import build_world, perturbed
from repro_torch.launch.metrics_server import MetricsServer
from repro_torch.serve import ClusterServer, GraphStream, hot_swap

CPU = "cpu"
N_NODES = 256


@pytest.fixture(scope="module")
def flight(tmp_path_factory):
    """A flight recorder spanning a swap and a flush, and the lanes the
    server's /metrics showed while it served."""
    d = tmp_path_factory.mktemp("scope")
    path = str(d / "flight.jsonl")
    cfg, params, indptr, indices, store = build_world(N_NODES, 1024, 8, 0,
                                                      CPU)
    ckpt_store.save(d / "ckpt", 1, perturbed(params, 1))
    rng = np.random.default_rng(0)
    with ClusterServer("gcn", cfg, params, indptr, indices, store,
                       n_lanes=2, seed=0, tracing=True, metrics_port=0,
                       telemetry_jsonl=path, telemetry_interval=0.01,
                       device=CPU) as srv:
        srv.warmup([1, 2])
        srv.submit_many([[int(s)] for s in rng.integers(0, N_NODES, 32)])
        hot_swap(srv, d / "ckpt", step=1, wait_for_dispatch=1.0)
        gs = GraphStream(srv, parity_every=1)
        for _ in range(8):
            gs.insert(int(rng.integers(0, N_NODES)),
                      int(rng.integers(0, N_NODES)))
        gs.flush()
        srv.submit_many([[int(s)] for s in rng.integers(0, N_NODES, 32)])
        srv.drain()
        panels = tscope.scrape_panels(srv._metrics_server.url)
    return path, panels


def _run(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def test_load_render_summary_check_equal_reference(flight):
    path, _ = flight
    trecs, tmeta = tscope.load_flight(path)
    jrecs, jmeta = jscope.load_flight(path)
    assert trecs == jrecs and tmeta == jmeta
    assert trecs["trace"] and trecs["sample"]
    events = [e["event"] for e in trecs["event"]]
    for ev in ("params_swap", "hot_swap", "graph_flush", "graph_update"):
        assert ev in events, ev
    assert tscope.render_html(trecs, tmeta, []) == \
        jscope.render_html(jrecs, jmeta, [])
    assert _run(tscope.summarize, trecs, tmeta) == \
        _run(jscope.summarize, jrecs, jmeta)
    tc, jc = _run(tscope.check, trecs, tmeta), _run(jscope.check, jrecs,
                                                      jmeta)
    assert tc == jc and tc[0] == 0
    assert tscope.main([path, "--summary", "--check"]) == 0


def test_main_writes_the_same_html(flight, tmp_path):
    path, _ = flight
    outs = []
    for mod in (tscope, jscope):
        out = tmp_path / f"{mod.__name__}.html"
        rc, text = _run(mod.main, [path, "--bench", "--out", str(out)])
        assert rc == 0 and "wrote" in text
        outs.append(out.read_text())
    assert outs[0] == outs[1] and outs[0].startswith("<!doctype html>")


def _broken(path, tmp_path, name, edit):
    recs = [json.loads(line) for line in open(path) if line.strip()]
    edit(recs)
    out = tmp_path / name
    out.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return str(out)


def _drop_span(recs):
    trace = next(r for r in recs if r.get("kind") == "trace"
                 and len(r["spans"]) > 2)
    del trace["spans"][-1]                 # the terminal span


def _wrong_version(recs):
    recs[0]["schema_version"] = 99


@pytest.mark.parametrize("edit", [_drop_span, _wrong_version])
def test_malformed_recorder_fails_check_in_both(flight, tmp_path, edit):
    bad = _broken(flight[0], tmp_path, f"{edit.__name__}.jsonl", edit)
    t = _run(tscope.main, [bad, "--check"])
    j = _run(jscope.main, [bad, "--check"])
    assert t[0] == j[0] == 1
    assert t[1] == j[1] and "FAIL neurascope" in t[1]


def test_tail_panels_follows_a_growing_file(flight, tmp_path):
    lines = [line for line in open(flight[0]) if line.strip()]
    grow = tmp_path / "grow.jsonl"
    half = len(lines) // 2
    grow.write_text("".join(lines[:half]) + lines[half][:10])  # partial
    ts, js = {}, {}
    assert tscope.tail_panels(str(grow), ts) == \
        jscope.tail_panels(str(grow), js)
    offset = ts["offset"]
    assert offset == len("".join(lines[:half]).encode())
    with open(grow, "a") as f:
        f.write(lines[half][10:] + "".join(lines[half + 1:]))
    tp, jp = tscope.tail_panels(str(grow), ts), jscope.tail_panels(
        str(grow), js)
    assert tp == jp and ts["offset"] == grow.stat().st_size > offset
    assert sorted(tp["lanes"]) == ["0", "1"]
    assert tp["counters"]["event.graph_flush"] == 1.0
    history_t, history_j = {}, {}
    assert tscope.render_frame(tp, history_t, "grow", 1) == \
        jscope.render_frame(jp, history_j, "grow", 1)


def _exposition():
    from repro_torch.serve.metrics import MetricsRegistry
    reg = MetricsRegistry()
    h = reg.histogram("request_latency_seconds", "latency by class")
    for i, v in enumerate((0.001, 0.004, 0.02, 0.3)):
        h.observe(v, **{"class": "interactive" if i % 2 else "batch"})
    reg.gauge("lane", "lane fields").set(3.0, lane="0", field="queue_depth")
    reg.gauge("slo_burn_rate", "burn").set(1.5, window="fast",
                                           **{"class": "batch"})
    reg.counter("kernel_total", "kernel counters").inc(7, name="plan.x")
    return reg.render()


def test_scrape_panels_equal_reference(flight):
    _, live = flight                 # scraped from the serving cluster
    assert sorted(live["lanes"]) == ["0", "1"]
    assert live["counters"]
    text = _exposition()             # one fixed exposition for both
    srv = MetricsServer(lambda: text)
    try:
        panels = tscope.scrape_panels(srv.url)
        assert panels == jscope.scrape_panels(srv.url)
        assert panels["lanes"] == {"0": {"queue_depth": 3.0}}
        assert "p99_ms" in panels["classes"]["batch"]
        assert (_run(lambda: tscope.live(srv.url, interval=0, frames=2))
                == _run(lambda: jscope.live(srv.url, interval=0,
                                            frames=2)))
    finally:
        srv.close()
