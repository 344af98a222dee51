"""The port's metrics plane (``repro_torch.serve.metrics``,
``launch.metrics_server``) against the reference's: the same bucket
scheme and ``bucket_index`` over the whole range, the same ``render()``
text for the same observations, the same ``parse_exposition`` and
``histogram_counts_from_samples`` results, the same hub and kernel-stats
feeds; then the HTTP endpoint and a served ``GNNServer`` whose scraped
exposition agrees with its own counts."""
import math
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # deterministic fallback; requirements-dev.txt has the real one
    from _hypothesis_shim import given, settings, st

from repro.serve import metrics as jm
from repro.serve import telemetry as jtel
from repro.sparse import plan as jplan
from repro.sparse import stats as jstats
from repro_torch.launch import metrics_server
from repro_torch.launch.gnn_serve import build_world
from repro_torch.serve import GNNServer
from repro_torch.serve import metrics as tm
from repro_torch.serve import telemetry as ttel
from repro_torch.serve.metrics import (MetricsRegistry,
                                       histogram_counts_from_samples,
                                       parse_exposition)
from repro_torch.sparse import plan as tplan
from repro_torch.sparse import stats as tstats

# latencies as integer microseconds, 1 µs .. ~16 s — the whole ladder
lat_us = st.integers(min_value=1, max_value=16_000_000)


def test_bucket_scheme_equals_the_reference():
    assert (tm.HIST_MIN, tm.HIST_GROWTH, tm.N_BUCKETS) == \
        (jm.HIST_MIN, jm.HIST_GROWTH, jm.N_BUCKETS)
    assert tm.BUCKET_UPPERS == jm.BUCKET_UPPERS
    for i in range(tm.N_BUCKETS + 1):
        assert tm.bucket_upper(i) == jm.bucket_upper(i)
        assert tm.bucket_lower(i) == jm.bucket_lower(i)


def test_bucket_index_equals_the_reference_over_the_whole_range():
    """Every bound and its float neighbours (where both round a value a
    hair above a bound into the bucket below it), and a log grid from 1e-7
    s past the +Inf bucket's start."""
    for mod in (tm, jm):                             # both refuse +inf
        with pytest.raises(OverflowError):
            mod.bucket_index(math.inf)
    edges = [0.0, -1.0, 1e300]
    for b in tm.BUCKET_UPPERS:
        edges += [b, math.nextafter(b, 0.0), math.nextafter(b, math.inf)]
    for v in edges:
        assert tm.bucket_index(v) == jm.bucket_index(v), v
    for v in np.logspace(-7, 4, 20_000):
        i = tm.bucket_index(float(v))
        assert i == jm.bucket_index(float(v)), v
        assert tm.bucket_lower(i) < v <= tm.bucket_upper(i)


@settings(max_examples=200, deadline=None)
@given(lat_us)
def test_bucket_index_contains_its_value(us):
    v = us / 1e6
    i = tm.bucket_index(v)
    assert i == jm.bucket_index(v)
    assert tm.bucket_lower(i) < v <= tm.bucket_upper(i)


def test_quantile_from_counts_equals_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(50):
        counts = [int(c) for c in rng.integers(0, 3, tm.N_BUCKETS + 1)]
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert tm.quantile_from_counts(counts, q) == \
                jm.quantile_from_counts(counts, q)
    assert tm.quantile_from_counts([0] * (tm.N_BUCKETS + 1), 0.9) == -1


def _everything(mod, us_list=(90, 300, 300, 5000, 250_000)):
    """One registry of each instrument kind, observed the same way."""
    reg = mod.MetricsRegistry()
    reg.counter("requests_total", "served requests").inc(
        7, outcome="served", **{"class": "interactive"})
    reg.counter("requests_total").inc(2, outcome="served",
                                      **{"class": "batch"})
    reg.counter("telemetry_total").set_total(12, lane="0", counter="served")
    reg.gauge("queue", "batcher depth").set(3.5, lane="0")
    reg.gauge("queue").set(-0.25, lane="1", field='quote"and\\slash')
    h = reg.histogram("request_latency_seconds", "e2e latency")
    for us in us_list:
        h.observe(us / 1e6, exemplar=f"rid-{us}", **{"class": "interactive"})
    h.observe(1e9)                                   # the +Inf bucket
    return reg


def test_render_text_equals_the_reference():
    text = _everything(tm).render()
    assert text == _everything(jm).render()
    assert parse_exposition(text) == jm.parse_exposition(text)


@settings(max_examples=30, deadline=None)
@given(st.lists(lat_us, min_size=1, max_size=60))
def test_histogram_render_and_parse_equal_the_reference(us_list):
    """render → parse → rebuilt non-cumulative counts: the same text as
    the reference's, and the counts of the original buckets."""
    regs = []
    for mod in (tm, jm):
        reg = mod.MetricsRegistry()
        h = reg.histogram("request_latency_seconds")
        for us in us_list:
            h.observe(us / 1e6, exemplar=str(us), **{"class": "batch"})
        regs.append((reg, h))
    text = regs[0][0].render()
    assert text == regs[1][0].render()
    fams = parse_exposition(text)
    assert fams == jm.parse_exposition(text)
    samples = fams["neurachip_request_latency_seconds"]["samples"]
    counts = histogram_counts_from_samples(samples, {"class": "batch"})
    assert counts == jm.histogram_counts_from_samples(samples,
                                                      {"class": "batch"})
    assert counts == regs[0][1].labeled(**{"class": "batch"}).counts


def test_counter_and_family_guards():
    reg = MetricsRegistry()
    c = reg.counter("events_total")
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        reg.gauge("events_total")


def test_connect_hub_feeds_the_same_exposition():
    out = []
    for tel, mod in ((ttel, tm), (jtel, jm)):
        t = {"now": 0.0}
        hub = tel.TelemetryHub(2, clock=lambda: t["now"])
        reg = mod.MetricsRegistry()
        reg.connect_hub(hub)
        hub.register_probe("queue_depth", lambda: [3, 7])
        hub.count("served", 0, 4)
        hub.observe_latency(1, 0.002)
        t["now"] = 0.5
        hub.sample()
        hub.count("served", 0, 2)
        hub.sample()
        out.append(reg.render())
    assert out[0] == out[1]
    fams = parse_exposition(out[0])
    served = [v for _, lab, v, _ in fams["neurachip_telemetry_total"]["samples"]
              if lab == {"lane": "0", "counter": "served"}]
    assert served == [6]


def test_connect_kernel_stats_feeds_the_same_exposition():
    """The plan builders' counters and series and the plan cache's hit
    rate, pulled at render time, from the same recorded values."""
    out = []
    for st_mod, plan_mod, mod in ((tstats, tplan, tm), (jstats, jplan, jm)):
        st_mod.reset()
        plan_mod.plan_cache_clear()
        for k in range(5):
            st_mod.record_count("plan.dedup_packs")
            st_mod.record_value("plan.n_chunks", 10 * k + 3)
        reg = mod.MetricsRegistry()
        reg.connect_kernel_stats()
        out.append(reg.render())
        st_mod.reset()
    assert out[0] == out[1]
    assert 'neurachip_kernel_total{name="plan.dedup_packs"} 5' in out[0]


def test_render_is_thread_safe_under_concurrent_observes():
    reg = MetricsRegistry()
    h = reg.histogram("request_latency_seconds")
    stop = threading.Event()

    def pound():
        k = 0
        while not stop.is_set():
            h.observe((k % 1000 + 1) / 1e4, **{"class": "batch"})
            k += 1

    thread = threading.Thread(target=pound)
    thread.start()
    try:
        for _ in range(20):
            samples = parse_exposition(reg.render())[
                "neurachip_request_latency_seconds"]["samples"]
            counts = histogram_counts_from_samples(samples,
                                                   {"class": "batch"})
            cnt = [v for n, _, v, _ in samples if n.endswith("_count")]
            assert sum(counts) == int(cnt[0])
    finally:
        stop.set()
        thread.join()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        assert resp.status == 200
        return resp.read()


def test_metrics_server_serves_render_and_healthz():
    srv = metrics_server.MetricsServer(_everything(tm).render, port=0)
    try:
        assert srv.port > 0 and srv.host == "127.0.0.1"
        fams = parse_exposition(_get(srv.url).decode())
        assert "neurachip_requests_total" in fams
        assert [e for _, _, _, e in
                fams["neurachip_request_latency_seconds"]["samples"] if e]
        assert _get(srv.url.rsplit("/", 1)[0] + "/healthz") == b"ok\n"
        with pytest.raises(urllib.error.HTTPError):
            _get(srv.url.rsplit("/", 1)[0] + "/nope")
    finally:
        srv.close()


def test_metrics_server_smoke_self_test():
    assert metrics_server.main(["--smoke"]) == 0


def _served(fams):
    req = [v for _, lab, v, _ in fams["neurachip_requests_total"]["samples"]
           if lab == {"outcome": "served"}]
    cnt = [v for n, _, v, _ in
           fams["neurachip_request_latency_seconds"]["samples"]
           if n.endswith("_count")]
    return req, cnt


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_engine_exposition_agrees_with_its_counts(sampler):
    cfg, params, indptr, indices, store = build_world(
        256, 1024, 8, seed=0, device="cpu", arch="sage")
    srv = GNNServer("sage", cfg, params, indptr, indices, store,
                    fanouts=(2, 2), backend="dense", sampler=sampler,
                    max_batch_seeds=4, metrics_port=0, device="cpu")
    with srv:
        assert srv.tracer is None
        url = srv.stats()["metrics_url"]
        reqs = [srv.submit([i % 256]) for i in range(24)]
        parse_exposition(_get(url).decode())         # mid-traffic scrape
        srv.drain(timeout=120)
        fams = parse_exposition(_get(url).decode())
        n = srv.stats()["n_served"]
        assert n == len(reqs)
        assert _served(fams) == ([n], [n])
        gauges = {lab.get("field") or lab.get("cache")
                  for _, lab, _, _ in fams["neurachip_queue"]["samples"]
                  + fams["neurachip_cache_hit_rate"]["samples"]}
        assert gauges >= {"depth", "depth_seeds", "step", "bucket", "plan"}
        ex = {e[0] for _, _, _, e in
              fams["neurachip_request_latency_seconds"]["samples"] if e}
        assert ex <= {str(r.rid) for r in reqs}
    with pytest.raises(urllib.error.URLError):
        _get(url)                                    # closed with the server
