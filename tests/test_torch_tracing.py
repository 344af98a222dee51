"""The port's request tracing (``repro_torch.serve.tracing``) against the
reference's: the same records, stats and ``verify_trace`` findings for the
same calls, and the engine's span trees — exactly one well-formed tree per
accepted request, ``sample, queue_wait, bucket_pack, dispatch, settle`` on
the happy path, ``error`` on a deadline, a ``retry`` span on a transient
step fault, nothing at all with tracing off."""
import json
import os

import numpy as np
import pytest
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # deterministic fallback; requirements-dev.txt has the real one
    from _hypothesis_shim import given, settings, st

from repro.serve import tracing as jtr
from repro.serve import telemetry as jtel
from repro_torch.launch.gnn_serve import build_world
from repro_torch.serve import ChaosInjector, GNNServer, offline_replay
from repro_torch.serve import tracing as ttr
from repro_torch.serve.telemetry import TelemetryHub, percentiles_ms
from repro_torch.serve.tracing import (SCHEMA_VERSION, Tracer, verify_trace,
                                       verify_traces)

HAPPY = ["sample", "queue_wait", "bucket_pack", "dispatch", "settle"]


@pytest.fixture(scope="module")
def world():
    return build_world(256, 1024, 8, seed=0, device="cpu", arch="sage")


def _server(world, **kw):
    cfg, params, indptr, indices, store = world
    kw.setdefault("fanouts", (2, 2))
    kw.setdefault("backend", "dense")
    kw.setdefault("max_batch_seeds", 4)
    return GNNServer("sage", cfg, params, indptr, indices, store,
                     device="cpu", **kw)


def assert_one_tree_per_request(tracer, reqs):
    """Exactly one well-formed trace per accepted request, its terminal
    agreeing with the request's settled state, nothing left open."""
    recs = tracer.traces()
    assert verify_traces(recs) == []
    by_id = {r["trace"]: r for r in recs if r["trace"] is not None}
    assert set(by_id) >= {r.rid for r in reqs}
    for req in reqs:
        assert req.n_settles == 1
        terminal = by_id[req.rid]["spans"][-1]["name"]
        assert terminal == ("settle" if req.error is None else "error")
    assert tracer.stats()["open"] == 0
    return by_id


# ---------------------------------------------------------------------------
# Tracer against the reference's, call for call
# ---------------------------------------------------------------------------

def test_constants_equal_the_reference():
    assert ttr.SCHEMA_VERSION == jtr.SCHEMA_VERSION
    assert ttr.TERMINAL_SPANS == jtr.TERMINAL_SPANS
    assert ttr.STAGE_ORDER == jtr.STAGE_ORDER


def _drive(mod):
    """One script of span/extend/settle/settle_many/point calls on a
    virtual clock, through ``mod.Tracer`` with a sink; what comes out."""
    t = [10.0]
    flushed = []
    tr = mod.Tracer(capacity=5, clock=lambda: t[0], t0=10.0,
                    sink=flushed.append)
    for i in range(9):
        t[0] += 0.25
        tr.span(i, "sample", t[0] - 0.2, t[0], {"mode": "device"})
        tr.extend(i, (("queue_wait", t[0], t[0] + 0.1, None),
                      ("bucket_pack", t[0] + 0.1, t[0] + 0.2,
                       {"bucket": 4, "round": i})))
        if i % 3 == 0:
            tr.settle(i, "error", t[0] + 0.3, t[0] + 0.3,
                      {"error": "DeadlineExceeded"})
    tr.settle_many([(i, "settle", 20.0, 20.0, None) for i in range(9)])
    tr.span(1, "retry", 21.0, 21.0)            # late: dropped
    tr.point("shed", {"n": 2})
    return tr.traces(), flushed, tr.stats(), tr.open_traces()


def test_tracer_records_equal_the_reference():
    assert _drive(ttr) == _drive(jtr)


def test_tracer_records_and_ring_bound():
    tr = Tracer(capacity=4, clock=lambda: 0.0, t0=0.0)
    for i in range(10):
        tr.span(i, "sample", 0.0, 1.0, {"lane": 0})
        tr.settle(i, "settle", 1.0, 1.0)
    recs = tr.traces()
    assert [r["trace"] for r in recs] == [6, 7, 8, 9]
    assert verify_traces(recs) == []
    stats = tr.stats()
    assert stats["traces"] == 10 and stats["spans"] == 20
    assert stats["open"] == 0
    assert recs[0]["kind"] == "trace"
    assert recs[0]["schema_version"] == SCHEMA_VERSION
    assert recs[0]["spans"][0] == {"name": "sample", "t0": 0.0, "t1": 1.0,
                                   "lane": 0}


def test_tracer_drops_late_spans_after_settlement():
    tr = Tracer(capacity=8, clock=lambda: 0.0, t0=0.0)
    tr.span(1, "sample", 0.0, 1.0)
    tr.settle(1, "settle", 1.0, 1.0)
    tr.span(1, "retry", 2.0, 2.0)                # raced straggler
    tr.settle(1, "error", 2.0, 2.0)              # raced duplicate terminal
    recs = tr.traces()
    assert len(recs) == 1 and len(recs[0]["spans"]) == 2
    assert tr.stats()["dropped"] == 2 and tr.stats()["open"] == 0


def _malformed():
    ok = {"kind": "trace", "schema_version": SCHEMA_VERSION, "trace": 1,
          "spans": [{"name": "sample", "t0": 0.0, "t1": 1.0},
                    {"name": "settle", "t0": 1.0, "t1": 1.0}]}
    shed = {"kind": "trace", "schema_version": SCHEMA_VERSION,
            "trace": None, "spans": [{"name": "shed", "t0": 0.0, "t1": 0.0}]}
    return [
        ok,
        dict(ok, spans=[{"name": "sample", "t0": 0.0, "t1": 1.0}]),
        dict(ok, spans=ok["spans"] + [{"name": "error", "t0": 1.0,
                                       "t1": 1.0}]),
        dict(ok, spans=list(reversed(ok["spans"]))),
        dict(ok, spans=[{"name": "sample", "t0": 2.0, "t1": 1.0},
                        ok["spans"][1]]),
        dict(ok, spans=[{"name": "sample", "t0": "0", "t1": None},
                        ok["spans"][1]]),
        dict(ok, spans=[{"t0": 0.0, "t1": 1.0}, ok["spans"][1]]),
        dict(ok, schema_version=SCHEMA_VERSION + 1),
        dict(ok, spans=[]),
        {"kind": "trace", "trace": 7},
        shed,
    ]


@pytest.mark.parametrize("i", range(len(_malformed())))
def test_verify_trace_same_findings_as_reference(i):
    rec = _malformed()[i]
    got = verify_trace(rec)
    assert got == jtr.verify_trace(rec)
    assert (got == []) == (i in (0, 10))


def test_verify_traces_duplicates_as_reference():
    ok, shed = _malformed()[0], _malformed()[10]
    for recs in ([ok, dict(ok)], [shed, dict(shed)], _malformed()):
        assert verify_traces(recs) == jtr.verify_traces(recs)
    assert any("duplicate" in p for p in verify_traces([ok, dict(ok)]))
    assert verify_traces([shed, dict(shed)]) == []


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=49), min_size=1,
                max_size=60))
def test_tracer_random_interleavings_as_reference(ids):
    """Arbitrary span/settle interleavings over reused ids: every flushed
    record is well-formed, one per id, and the same as the reference's."""
    def run(mod):
        flushed = []
        tr = mod.Tracer(capacity=128, clock=lambda: 0.0, t0=0.0,
                        sink=flushed.append)
        settled = set()
        for i, trace in enumerate(ids):
            if trace in settled:
                tr.span(trace, "retry", float(i), float(i))   # dropped
                continue
            tr.span(trace, "sample", float(i), float(i) + 0.5)
            if i % 3 != 0:
                tr.settle(trace, "settle" if i % 2 else "error",
                          float(i) + 0.5, float(i) + 0.5)
                settled.add(trace)
        for trace in list(tr.open_traces()):
            tr.settle(trace, "error", 99.0, 99.0, {"error": "DrainTimeout"})
        return flushed, tr.stats()
    flushed, stats = run(ttr)
    assert (flushed, stats) == run(jtr)
    assert verify_traces(flushed) == []
    assert {r["trace"] for r in flushed} == set(ids)
    assert stats["open"] == 0


def test_flight_recorder_schema_and_rotation(tmp_path):
    path = str(tmp_path / "flight.jsonl")
    t = [0.0]
    hub = TelemetryHub(2, jsonl_path=path, jsonl_max_bytes=2048,
                       clock=lambda: t[0])
    tracer = Tracer(capacity=64, clock=lambda: t[0], t0=hub.t0,
                    sink=hub.emit)
    for i in range(40):
        t[0] += 0.01
        hub.event("tick", i=i)
        tracer.span(i, "sample", t[0], t[0])
        tracer.settle(i, "settle", t[0], t[0])
    hub.stop()
    assert hub.jsonl_rotations >= 1
    recs = []
    for p in (path + ".1", path):
        with open(p) as f:
            recs += [json.loads(line) for line in f]
    assert all(r["schema_version"] == SCHEMA_VERSION for r in recs)
    assert {r["kind"] for r in recs} == {"event", "trace"}
    assert verify_traces([r for r in recs if r["kind"] == "trace"]) == []
    assert os.path.getsize(path) + os.path.getsize(path + ".1") \
        <= 2 * 2048 + 512


@pytest.mark.parametrize("n", [0, 1, 7, 100])
def test_percentiles_ms_equals_the_reference(n):
    lat = np.random.default_rng(n).exponential(0.01, n)
    assert percentiles_ms(lat) == jtel.percentiles_ms(lat)


# ---------------------------------------------------------------------------
# The engine's span trees
# ---------------------------------------------------------------------------

def test_tracing_disabled_allocates_nothing(world):
    with _server(world) as srv:
        assert srv.tracer is None
        reqs = [srv.submit([i % 256]) for i in range(8)]
        srv.drain(timeout=120)
        assert all(r.error is None for r in reqs)
        assert "tracing" not in srv.stats()


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_engine_happy_path_span_trees(world, sampler):
    with _server(world, tracing=True, sampler=sampler) as srv:
        reqs = [srv.submit([i % 256]) for i in range(16)]
        srv.drain(timeout=120)
        by_id = assert_one_tree_per_request(srv.tracer, reqs)
        for rec in by_id.values():
            spans = rec["spans"]
            assert [s["name"] for s in spans] == HAPPY
            assert all(a["t1"] <= b["t0"] + 1e-9
                       for a, b in zip(spans, spans[1:]))
        assert (by_id[0]["spans"][0].get("mode") == "device") == (
            sampler == "device")
        stats = srv.stats()["tracing"]
        assert stats["traces"] == 16 and stats["dropped"] == 0


def test_engine_deadline_expiry_yields_error_terminal(world):
    with _server(world, tracing=True, max_wait_ms=40.0) as srv:
        req = srv.submit([3], deadline_ms=0.01)
        req.wait_done(120)
        srv.drain(timeout=120)
        assert req.error is not None
        by_id = assert_one_tree_per_request(srv.tracer, [req])
        assert by_id[req.rid]["spans"][-1]["error"] == "DeadlineExceeded"


@settings(max_examples=4, deadline=None)
@given(st.integers(min_value=1, max_value=24))
def test_engine_property_every_accepted_request_traced(n_requests):
    world = build_world(256, 1024, 8, seed=0, device="cpu", arch="sage")
    with _server(world, tracing=True) as srv:
        reqs = [srv.submit([(7 * i) % 256]) for i in range(n_requests)]
        srv.drain(timeout=120)
        assert_one_tree_per_request(srv.tracer, reqs)


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_engine_retry_spans_and_replay(world, sampler):
    """A transient step fault on round 1: its requests carry a ``retry``
    span, then serve on the next round with the same trees (replay equal
    within 1e-5)."""
    chaos = ChaosInjector(step_fault_rounds=(1,))
    with _server(world, tracing=True, sampler=sampler, chaos=chaos,
                 max_retries=1) as srv:
        reqs = [srv.submit([i % 256]) for i in range(12)]
        srv.drain(timeout=120)
        by_id = assert_one_tree_per_request(srv.tracer, reqs)
        retried = [r for r in reqs if r.attempts]
        assert retried and chaos.injected["step"] == 1
        for r in reqs:
            names = [s["name"] for s in by_id[r.rid]["spans"]]
            assert ("retry" in names) == bool(r.attempts)
            assert r.error is None
            np.testing.assert_allclose(offline_replay(srv, r), r.result,
                                       rtol=0, atol=1e-5)


def test_server_stats_keys_equal_the_reference(world):
    """``stats()`` with tracing and a metrics port: the reference's keys,
    ``bucket_hits`` and ``plan_cache`` included."""
    from repro.launch.gnn_serve import build_world as jworld
    from repro.serve import GNNServer as JServer
    cfg, params, indptr, indices, store = jworld("sage", 256, 1024, 8)
    with JServer("sage", cfg, params, indptr, indices, store,
                 fanouts=(2, 2), max_batch_seeds=4, tracing=True,
                 metrics_port=0) as ref:
        ref.submit([1]).wait(120)
        want = ref.stats()
    with _server(world, tracing=True, metrics_port=0) as srv:
        srv.submit([1]).wait(120)
        got = srv.stats()
    assert set(got) == set(want)
    for key in ("tracing", "plan_cache", "step_cache", "batcher"):
        assert set(got[key]) == set(want[key]), key
    # one request, one batch, into a cold bucket
    for key in ("n_served", "n_batches", "bucket_hits", "bucket_counts"):
        assert got[key] == want[key], key
    assert got["metrics_url"].startswith("http://127.0.0.1:")
