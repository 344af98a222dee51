"""The port's cluster control plane on ``device="cpu"``: the counterparts of
the reference's cluster cases in ``tests/test_chaos.py`` (lane kills,
restarts, stalls, sampler and step faults, deadlines, shedding,
drain/close, elastic parking), ``tests/test_tracing.py`` (one span tree
per accepted request through kills, retries and sheds) and
``tests/test_metrics.py::test_cluster_slo_sheds_best_effort_before_
interactive``.

The contract: an accepted request settles exactly once — a result XOR a
typed ``serve.errors`` error — whichever lane dies, worker throws or step
faults; every accepted request has exactly one complete span tree.  Every
``drain``/``close`` is bounded by a timeout."""
import threading
import time
import urllib.request

import numpy as np
import pytest
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # deterministic fallback; requirements-dev.txt has the real one
    from _hypothesis_shim import given, settings, st

from repro_torch.launch.gnn_serve import build_world
from repro_torch.serve import (ChaosInjector, ClusterServer,
                               InjectedSamplerFault, LaneFault, Overloaded)
from repro_torch.serve.errors import (DeadlineExceeded, DrainTimeout,
                                      RetriesExhausted, SamplerError,
                                      ServerClosed)
from repro_torch.serve.metrics import (bucket_index,
                                       histogram_counts_from_samples,
                                       parse_exposition,
                                       quantile_from_counts)
from repro_torch.serve.slo import ClassSLO
from repro_torch.serve.tracing import TERMINAL_SPANS, verify_traces

N = 4                                     # lanes in every cluster test
CPU = "cpu"


def _world(arch="sage", n_nodes=256, seed=0):
    return build_world(n_nodes, 4 * n_nodes, 8, seed, CPU, arch)


def _cluster(world, chaos=None, **kw):
    cfg, params, indptr, indices, store = world
    kw.setdefault("n_lanes", N)
    kw.setdefault("fanouts", (2, 2))
    kw.setdefault("backend", "dense")
    kw.setdefault("seed", 0)
    kw.setdefault("max_batch_seeds", 4)
    kw.setdefault("telemetry_interval", 0.02)
    return ClusterServer("sage", cfg, params, indptr, indices, store,
                         chaos=chaos, device=CPU, **kw)


def _assert_exactly_once(reqs, expect_error=None):
    for r in reqs:
        assert r.done, f"request {r.rid} never settled"
        assert r.n_settles == 1, f"request {r.rid} settled {r.n_settles}×"
        if expect_error is None:
            assert r.error is None, f"request {r.rid} failed: {r.error!r}"
            assert r.result is not None
        else:
            assert isinstance(r.error, expect_error), \
                f"request {r.rid}: {r.error!r}"
            assert r.result is None


def _assert_one_tree_per_request(tracer, reqs):
    recs = tracer.traces()
    assert verify_traces(recs) == []
    by_id = {r["trace"]: r for r in recs if r["trace"] is not None}
    rids = {r.rid for r in reqs}
    assert set(by_id) >= rids, \
        f"missing traces for rids {sorted(rids - set(by_id))[:5]}"
    for req in reqs:
        terminal = by_id[req.rid]["spans"][-1]["name"]
        assert req.n_settles == 1
        assert terminal == ("settle" if req.error is None else "error"), \
            f"rid {req.rid}: terminal {terminal}, error {req.error!r}"
    assert tracer.stats()["open"] == 0


def _all_lanes_wedged():
    return ChaosInjector(seed=0, lane_faults=[LaneFault(lane=i)
                                              for i in range(N)])


# ---------------------------------------------------------------------------
# Lane failure: supervision, rebalance, exactly-once re-route, restart
# ---------------------------------------------------------------------------

def test_lane_kill_mid_stream_every_request_exactly_once():
    chaos = ChaosInjector(lane_faults=[LaneFault(lane=1, at_round=3)])
    srv = _cluster(_world(), chaos=chaos, stall_timeout=0.15,
                   auto_restart=False)
    with srv:
        srv.warmup()
        reqs = srv.submit_many([[i % 256] for i in range(192)])
        srv.drain(timeout=120)
        _assert_exactly_once(reqs)
        assert chaos.injected["kill"] == 1
        st_ = srv.stats()
        assert st_["lane_deaths"] == 1
        assert st_["n_served"] == len(reqs)
        assert srv.router.n_active == N - 1
        assert 1 not in srv.router.active_lanes
        assert srv.lane_states()[1] == "dead"
        assert st_["reroutes"] > 0
        assert all(r.reroutes <= 1 for r in reqs)   # never bounced twice
        rerouted = [r for r in reqs if r.reroutes == 1]
        assert len(rerouted) == st_["reroutes"]
        assert all(r.lane != 1 for r in rerouted)
        for r in rerouted[:4]:
            np.testing.assert_allclose(r.result, srv.offline_replay(r),
                                       atol=1e-5)


def test_killed_lane_restarts_and_rejoins():
    chaos = ChaosInjector(lane_faults=[LaneFault(lane=2, at_round=2)])
    srv = _cluster(_world(), chaos=chaos, stall_timeout=0.15,
                   restart_after=0.2, auto_restart=True)
    with srv:
        srv.warmup()
        first = srv.submit_many([[i % 256] for i in range(128)])
        srv.drain(timeout=120)
        _assert_exactly_once(first)
        deadline = time.monotonic() + 30
        while srv.router.n_active < N and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.router.n_active == N, srv.lane_states()
        assert srv.lane_states() == ["active"] * N
        second = srv.submit_many([[(3 * i) % 256] for i in range(64)])
        srv.drain(timeout=120)
        _assert_exactly_once(second)
        st_ = srv.stats()
        assert st_["lane_deaths"] == 1 and st_["lane_restores"] == 1
        assert st_["n_served"] == len(first) + len(second)
        ev = srv.telemetry.event_counts()
        assert ev["lane_warming"] == 1 and ev["rebalance"] >= 2


def test_step_build_under_traffic_kills_no_lane():
    """A round that builds its step (no warm-up) stalls every lane alike:
    a build longer than ``stall_timeout`` declares no lane dead."""
    srv = _cluster(_world(), stall_timeout=0.1)
    build = srv._build_step

    def slow_build(key):
        time.sleep(0.4)
        return build(key)
    srv.steps._builder = slow_build
    with srv:
        reqs = srv.submit_many([[i % 256] for i in range(64)])
        srv.drain(timeout=120)
        _assert_exactly_once(reqs)
        st_ = srv.stats()
        assert st_["lane_deaths"] == 0 and st_["reroutes"] == 0
        assert srv.telemetry.event_counts()["recompile"] >= 1


def test_stall_shorter_than_timeout_is_tolerated():
    chaos = ChaosInjector(lane_faults=[LaneFault(lane=0, at_round=1,
                                                 kind="stall",
                                                 duration=0.1)])
    srv = _cluster(_world(), chaos=chaos, stall_timeout=2.0)
    with srv:
        srv.warmup()
        reqs = srv.submit_many([[i % 256] for i in range(96)])
        srv.drain(timeout=120)
        _assert_exactly_once(reqs)
        st_ = srv.stats()
        assert st_["lane_deaths"] == 0 and st_["reroutes"] == 0
        assert srv.router.n_active == N


# ---------------------------------------------------------------------------
# Sampler and step faults
# ---------------------------------------------------------------------------

def test_cluster_sampler_fault_fails_only_that_request():
    chaos = ChaosInjector(sampler_fault_rids=(5,))
    srv = _cluster(_world(), chaos=chaos)
    with srv:
        srv.warmup()
        reqs = srv.submit_many([[i % 256] for i in range(16)])
        srv.drain(timeout=120)
        bad = [r for r in reqs if r.rid == 5]
        good = [r for r in reqs if r.rid != 5]
        _assert_exactly_once(bad, expect_error=SamplerError)
        _assert_exactly_once(good)
        assert bad[0].error.rid == 5
        assert isinstance(bad[0].error.__cause__, InjectedSamplerFault)
        more = srv.submit_many([[i % 256] for i in range(16)])
        srv.drain(timeout=120)
        _assert_exactly_once(more)
        assert srv.stats()["failed"] == 1


def test_transient_step_fault_retried_and_served():
    chaos = ChaosInjector(step_fault_rounds=(1,))
    srv = _cluster(_world(), chaos=chaos, max_retries=1)
    with srv:
        srv.warmup()
        reqs = srv.submit_many([[i % 256] for i in range(48)])
        srv.drain(timeout=120)
        _assert_exactly_once(reqs)
        st_ = srv.stats()
        assert chaos.injected["step"] >= 1
        assert st_["retries"] > 0 and st_["failed"] == 0
        for r in [r for r in reqs if r.attempts][:4]:
            np.testing.assert_allclose(r.result, srv.offline_replay(r),
                                       atol=1e-5)


def test_every_step_faulting_exhausts_retries_typed():
    chaos = ChaosInjector(p_step_fault=1.0)
    srv = _cluster(_world(), chaos=chaos, max_retries=1)
    with srv:
        reqs = srv.submit_many([[i % 256] for i in range(16)])
        srv.drain(timeout=120)
        _assert_exactly_once(reqs, expect_error=RetriesExhausted)
        assert all(r.attempts == 2 for r in reqs)   # 1 try + 1 retry


# ---------------------------------------------------------------------------
# Deadlines, shedding, drain/close, elastic parking
# ---------------------------------------------------------------------------

def test_deadline_exceeded_is_typed_and_reaped():
    srv = _cluster(_world(), chaos=_all_lanes_wedged(), stall_timeout=60)
    with srv:
        reqs = srv.submit_many([[i % 256] for i in range(24)],
                               deadline_ms=100)
        srv.drain(timeout=60)
        _assert_exactly_once(reqs, expect_error=DeadlineExceeded)
        assert all(isinstance(r.error, TimeoutError) for r in reqs)
        assert srv.stats()["timeouts"] == len(reqs)


def test_sustained_overload_sheds_at_submit():
    srv = _cluster(_world(), chaos=_all_lanes_wedged(), stall_timeout=60,
                   shed_queue_hwm=8, shed_sustain_ticks=1)
    accepted = srv.submit_many([[i % 256] for i in range(32)])
    deadline = time.monotonic() + 10
    while not srv._shedding and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(Overloaded) as ei:
        srv.submit([0])
    assert ei.value.retry_after_s > 0 and ei.value.cls is None
    with pytest.raises(Overloaded):
        srv.submit_many([[1], [2]])
    assert srv.stats()["shed"] >= 3
    srv.close(timeout=60)                  # shutdown flush serves the backlog
    _assert_exactly_once(accepted)


def test_drain_timeout_fails_stragglers_typed_then_close_is_safe():
    srv = _cluster(_world(), chaos=_all_lanes_wedged(), stall_timeout=60)
    reqs = srv.submit_many([[i % 256] for i in range(8)])
    with pytest.raises(DrainTimeout) as ei:
        srv.drain(timeout=0.3)
    assert ei.value.n_pending == len(reqs)
    assert sorted(ei.value.rids) == sorted(r.rid for r in reqs)
    _assert_exactly_once(reqs, expect_error=DrainTimeout)
    srv.close(timeout=60)  # flush serves the already-failed stragglers: no-op
    srv.close(timeout=60)  # idempotent
    _assert_exactly_once(reqs, expect_error=DrainTimeout)


def test_close_times_out_over_wedged_engine_and_fails_pending():
    srv = _cluster(_world(), stall_timeout=60)
    wedge = threading.Event()              # never set: the daemon thread
    srv._gather = lambda node_ids: wedge.wait()    # stays parked until exit
    reqs = srv.submit_many([[i % 256] for i in range(4)])
    t0 = time.monotonic()
    srv.close(timeout=0.5)
    assert time.monotonic() - t0 < 5.0
    _assert_exactly_once(reqs, expect_error=ServerClosed)
    srv.close(timeout=0.5)                 # idempotent over the wedge too
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit([0])


def test_elastic_parks_idle_lanes_and_unparks_under_load():
    chaos = ChaosInjector(lane_faults=[
        LaneFault(lane=0, at_round=1, kind="stall", duration=0.6),
        LaneFault(lane=1, at_round=1, kind="stall", duration=0.6)])
    srv = _cluster(_world(), chaos=chaos, stall_timeout=30,
                   scale_min_lanes=2, scale_down_depth=0.5,
                   scale_up_depth=1.0, scale_sustain_ticks=2)
    with srv:
        srv.warmup()
        deadline = time.monotonic() + 30
        while (srv.lane_states().count("parked") < N - 2
               and time.monotonic() < deadline):
            time.sleep(0.02)               # idle: scale down to the floor
        assert srv.lane_states().count("parked") == N - 2
        assert srv.router.n_active == 2
        reqs = srv.submit_many([[i % 256] for i in range(64)])
        srv.drain(timeout=120)             # stalls elapse; burst drains
        _assert_exactly_once(reqs)
        ev = srv.telemetry.event_counts()
        assert ev.get("scale_down", 0) >= 2
        assert ev.get("scale_up", 0) >= 1  # load pulled a lane back in


# ---------------------------------------------------------------------------
# Span trees: happy path, kills, retries, sheds
# ---------------------------------------------------------------------------

def test_tracing_disabled_allocates_nothing():
    srv = _cluster(_world(), tracing=False)
    with srv:
        assert srv.tracer is None
        for r in srv.submit_many([[i % 256] for i in range(8)]):
            r.wait(120)
        assert "tracing" not in srv.stats()


def test_cluster_happy_path_has_route_span():
    srv = _cluster(_world(), tracing=True)
    with srv:
        reqs = srv.submit_many([[i % 256] for i in range(16)])
        one = srv.submit([7])
        srv.drain(timeout=120)
        _assert_one_tree_per_request(srv.tracer, reqs + [one])
        for rec in srv.tracer.traces():
            names = [s["name"] for s in rec["spans"]]
            assert names == ["route", "sample", "queue_wait", "bucket_pack",
                             "dispatch", "settle"], names
        ts = srv.stats()["tracing"]
        assert ts["traces"] == 17 and ts["dropped"] == 0


@pytest.mark.parametrize("on", [True, False])
def test_profile_annotations_name_each_dispatch_round(on):
    """``profile_annotations=True`` puts one ``record_function`` range a
    round around its dispatch, named by the bucket, on the engine thread;
    off (the default) there is none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=every_thread) as prof:
        srv = _cluster(_world(), profile_annotations=on)
        with srv:
            reqs = srv.submit_many([[i % 256] for i in range(32)])
            srv.drain(timeout=120)
            _assert_exactly_once(reqs)
            rounds = srv.stats()["n_rounds"]
    names = [e.name for e in prof.events()
             if e.name.startswith("neurachip:dispatch_round:b")]
    assert rounds > 0
    assert len(names) == (rounds if on else 0), (rounds, names)
    assert {n.rsplit(":b", 1)[1] for n in names} <= {"1", "2", "4"}


def test_cluster_lane_kill_traces_reroutes():
    chaos = ChaosInjector(seed=0, lane_faults=[LaneFault(lane=1, at_round=2)])
    srv = _cluster(_world(), chaos=chaos, stall_timeout=0.15,
                   restart_after=0.4, tracing=True)
    with srv:
        srv.warmup()
        reqs = srv.submit_many([[i % 256] for i in range(64)])
        srv.drain(timeout=120)
        _assert_one_tree_per_request(srv.tracer, reqs)
        assert srv.stats()["reroutes"] >= 1
        rerouted = [r for r in srv.tracer.traces()
                    if any(s["name"] == "reroute" for s in r["spans"])]
        assert rerouted, "lane kill produced no reroute spans"
        for rec in rerouted:
            hop = next(s for s in rec["spans"] if s["name"] == "reroute")
            assert hop["from"] != hop["to"]


def test_cluster_transient_step_fault_traces_retry():
    chaos = ChaosInjector(seed=0, step_fault_rounds=(1,))
    srv = _cluster(_world(), chaos=chaos, max_retries=1, tracing=True)
    with srv:
        srv.warmup()
        reqs = srv.submit_many([[i % 256] for i in range(16)])
        srv.drain(timeout=120)
        _assert_one_tree_per_request(srv.tracer, reqs)
        retried = [r for r in srv.tracer.traces()
                   if any(s["name"] == "retry" for s in r["spans"])]
        assert retried, "injected step fault produced no retry spans"
        for rec in retried:
            assert rec["spans"][-1]["name"] in TERMINAL_SPANS


def test_cluster_shed_emits_point_traces_and_close_settles_backlog():
    srv = _cluster(_world(), chaos=_all_lanes_wedged(), stall_timeout=60.0,
                   shed_queue_hwm=8, shed_sustain_ticks=1, tracing=True)
    accepted = srv.submit_many([[i % 256] for i in range(24)])
    deadline = time.monotonic() + 30
    while not srv._shedding and time.monotonic() < deadline:
        time.sleep(0.01)
    shed = 0
    for i in range(16):
        try:
            accepted.append(srv.submit([i % 256]))
        except Overloaded:
            shed += 1
    srv.close(timeout=60)              # flush serves the wedged backlog
    assert shed >= 1
    recs = srv.tracer.traces()
    assert verify_traces(recs) == []
    shed_recs = [r for r in recs if r["trace"] is None]
    assert len(shed_recs) == shed
    assert all(r["spans"][0]["name"] == "shed" for r in shed_recs)
    _assert_one_tree_per_request(srv.tracer, accepted)


def test_cluster_deadline_and_forced_close_trace_error_terminals():
    srv = _cluster(_world(), chaos=_all_lanes_wedged(), stall_timeout=60,
                   tracing=True)
    with srv:
        reqs = srv.submit_many([[i % 256] for i in range(6)],
                               deadline_ms=50)
        srv.drain(timeout=60)
        _assert_one_tree_per_request(srv.tracer, reqs)
        errs = {rec["spans"][-1]["error"] for rec in srv.tracer.traces()}
        assert errs == {"DeadlineExceeded"}


@settings(max_examples=4, deadline=None)
@given(st.integers(min_value=1, max_value=24), st.integers(0, 3))
def test_cluster_property_every_accepted_request_traced(n_requests, kill):
    """Any burst, with or without a lane killed mid-stream: one tree per
    accepted request."""
    chaos = (ChaosInjector(lane_faults=[LaneFault(lane=kill, at_round=1)])
             if kill else None)
    srv = _cluster(_world(), chaos=chaos, stall_timeout=0.1,
                   auto_restart=False, tracing=True)
    with srv:
        reqs = srv.submit_many([[(7 * i) % 256] for i in range(n_requests)])
        srv.drain(timeout=120)
        _assert_exactly_once(reqs)
        _assert_one_tree_per_request(srv.tracer, reqs)


# ---------------------------------------------------------------------------
# Metrics and SLO shedding, end to end
# ---------------------------------------------------------------------------

def test_cluster_slo_sheds_best_effort_before_interactive():
    """Unreachable latency targets drive the burn over threshold: the
    admission arm rejects best_effort with a typed, class-carrying
    ``Overloaded`` while interactive keeps flowing, and the scraped
    exposition agrees with ``stats()['classes']`` (p99 within one
    bucket)."""
    cfg, params, indptr, indices, store = build_world(256, 1024, 8, 0, CPU)
    slos = [ClassSLO("interactive", 1.0, 0.01),
            ClassSLO("batch", 1.0, 0.05),
            ClassSLO("best_effort", 1.0, 0.20)]
    srv = ClusterServer("gcn", cfg, params, indptr, indices, store,
                        n_lanes=2, fanouts=(2, 2), backend="cuda", seed=0,
                        telemetry_interval=0.02, slo=slos,
                        slo_fast_window=5.0, slo_slow_window=30.0,
                        slo_sustain_ticks=1, slo_recover_ticks=10**6,
                        metrics_port=0, device=CPU)
    rng = np.random.default_rng(1)
    shed = {"interactive": 0, "best_effort": 0}
    int_after_shed = 0
    with srv:
        srv.warmup()
        for _ in range(40):
            pend = []
            for cls in ("interactive", "best_effort"):
                try:
                    pend.append(srv.submit(rng.integers(0, 256, 2),
                                           cls=cls))
                    if cls == "interactive" and shed["best_effort"]:
                        int_after_shed += 1
                except Overloaded as e:
                    assert e.cls == cls
                    shed[cls] += 1
            for r in pend:
                r.wait_done(timeout=60)
            if shed["best_effort"] >= 3 and int_after_shed >= 3:
                break
        st_classes = srv.stats()["classes"]
        with urllib.request.urlopen(srv.stats()["metrics_url"],
                                    timeout=10) as resp:
            fams = parse_exposition(resp.read().decode())
        events = [e for e in srv.telemetry.events
                  if e.get("event") == "shed_class" and e.get("on")]
    assert shed["best_effort"] >= 3 and shed["interactive"] == 0
    assert int_after_shed >= 3
    assert events and events[0]["cls"] == "best_effort"
    assert st_classes["best_effort"]["shed"]
    assert not st_classes["interactive"]["shed"]
    hist = fams["neurachip_request_latency_seconds"]["samples"]
    for cls, s in st_classes.items():
        if not s["n"]:
            continue
        counts = histogram_counts_from_samples(hist, {"class": cls})
        scraped = quantile_from_counts(counts, 0.99)
        assert abs(scraped - bucket_index(s["p99_ms"] / 1e3)) <= 1
    shed_fams = fams["neurachip_requests_total"]["samples"]
    assert any(lab.get("outcome") == "shed"
               and lab.get("class") == "best_effort" and v >= 3
               for _, lab, v, _ in shed_fams)


def test_wedged_lanes_under_slo_shed_best_effort_before_interactive():
    """Every lane stalled after the first round while interactive traffic
    queues: its latencies blow the 50 ms target, the default SLOs shed best_effort (typed, with
    its class), interactive is still admitted, and everything accepted
    settles once the stall ends."""
    stall = ChaosInjector(lane_faults=[
        LaneFault(lane=i, at_round=1, kind="stall", duration=0.4)
        for i in range(N)])
    srv = _cluster(_world(), chaos=stall, stall_timeout=60, slo=True,
                   slo_sustain_ticks=1)
    with srv:
        srv.warmup()
        accepted = srv.submit_many([[i % 256] for i in range(32)])
        deadline = time.monotonic() + 30
        while (not srv.slo.should_shed("best_effort")
               and time.monotonic() < deadline):
            time.sleep(0.01)
        with pytest.raises(Overloaded) as ei:
            srv.submit([1], cls="best_effort")
        assert ei.value.cls == "best_effort"
        accepted.append(srv.submit([2], cls="interactive"))
        srv.drain(timeout=120)
        _assert_exactly_once(accepted)
        assert not srv.slo.should_shed("interactive")
        ev = [e for e in srv.telemetry.events
              if e.get("event") == "shed_class" and e.get("on")]
        assert ev[0]["cls"] == "best_effort"
