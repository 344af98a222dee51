"""The port's ``TelemetryHub`` against the reference's on a virtual clock:
the same samples, totals, events and flight-recorder lines for the same
calls, its rotation, monitor thread and reset; and the helpers the metrics
feed reads: ``sparse.stats.stats()``, ``serve.compute.
bucket_plan_cache_info`` and ``sparse.sampler.sample_subgraph`` (the same
arrays as the reference's for the same numpy rng)."""
import json
import threading

import numpy as np
import pytest

from repro.serve import compute as jcompute
from repro.serve import telemetry as jtel
from repro.sparse import sampler as jsampler
from repro.sparse import stats as jstats
from repro_torch.data.synthetic import powerlaw_graph
from repro_torch.serve import compute as tcompute
from repro_torch.serve import telemetry as ttel
from repro_torch.serve.telemetry import COUNTERS, TelemetryHub
from repro_torch.sparse import sampler as tsampler
from repro_torch.sparse import stats as tstats
from repro_torch.sparse.graph import coo_to_csr


def _hub(mod=ttel, n_lanes=4, **kw):
    t = {"now": 0.0}
    kw.setdefault("clock", lambda: t["now"])
    return mod.TelemetryHub(n_lanes, **kw), t


def _script(mod, tmp_path=None):
    """Counters, latencies, probes, events and samples, the same calls on
    ``mod``'s hub; everything it reports."""
    path = None if tmp_path is None else str(tmp_path / f"{mod.__name__}.jsonl")
    hub, t = _hub(mod, n_lanes=3, window=8, jsonl_path=path)
    hub.register_probe("queue_depth", lambda: [3, 7, 1])
    hub.register_probe("short", lambda: [2.5])     # fewer lanes than the hub
    seen = []
    hub.add_tick(seen.append)
    rng = np.random.default_rng(1)
    for k in range(30):
        t["now"] = 0.1 * k
        lane = k % 3
        hub.count("submitted", lane)
        hub.count("batches", lane)
        hub.count("seeds_dispatched", lane, int(rng.integers(1, 16)))
        hub.observe_latency(lane, float(rng.exponential(0.01)))
        if k % 7 == 0:
            hub.event("lane_dead", lane=lane, reason="stalled")
        if k % 5 == 0:
            hub.sample()
    hub.stop()
    lines = None
    if path is not None:
        with open(path) as f:
            lines = [json.loads(line) for line in f]
    return (list(hub.samples), seen, hub.totals(), hub.event_counts(),
            list(hub.events), hub.merged_percentiles(), lines)


def test_counters_equal_the_reference():
    assert COUNTERS == jtel.COUNTERS


def test_hub_samples_equal_the_reference(tmp_path):
    got = _script(ttel, tmp_path)
    assert got == _script(jtel, tmp_path)
    samples, seen, totals, events, _, _, lines = got
    assert seen == samples and len(samples) == 6
    assert samples[-1]["lanes"][1]["short"] == 0.0
    assert totals["submitted"] == 30 and set(totals) == set(COUNTERS)
    assert events == {"lane_dead": 5}
    assert [r["kind"] for r in lines].count("sample") == 6


def test_sample_reads_probes_and_computes_occupancy():
    hub, t = _hub(n_lanes=2)
    hub.register_probe("queue_depth", lambda: [3, 7])
    hub.count("batches", 0, 2)
    hub.count("seeds_dispatched", 0, 6)
    t["now"] = 1.5
    s = hub.sample()
    assert s["kind"] == "sample" and s["t"] == 1.5
    assert [ln["queue_depth"] for ln in s["lanes"]] == [3.0, 7.0]
    assert s["lanes"][0]["occupancy"] == 3.0 and s["lanes"][1]["occupancy"] == 0
    assert hub.samples[-1] is s


def test_jsonl_rotation_keeps_n_generations(tmp_path):
    path = tmp_path / "telemetry.jsonl"
    hub, _ = _hub(n_lanes=2, jsonl_path=str(path), jsonl_max_bytes=200,
                  jsonl_max_files=3)
    for k in range(60):
        hub.event("tick", k=k)
    hub.stop()
    assert hub.jsonl_rotations >= 5
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "telemetry.jsonl", "telemetry.jsonl.1", "telemetry.jsonl.2",
        "telemetry.jsonl.3"]

    def ks(name):
        return [json.loads(ln)["k"]
                for ln in (tmp_path / name).read_text().splitlines()]
    stream = sum((ks(n) for n in ("telemetry.jsonl.3", "telemetry.jsonl.2",
                                  "telemetry.jsonl.1", "telemetry.jsonl")),
                 [])
    assert stream == list(range(stream[0], 60))


def test_monitor_thread_samples_and_stops_cleanly():
    hub = TelemetryHub(2, interval=0.01)
    fired = threading.Event()
    hub.add_tick(lambda s: fired.set())
    hub.start()
    hub.start()                            # idempotent
    assert fired.wait(5.0)
    hub.stop()
    n = len(hub.samples)
    hub.stop()                             # idempotent
    assert n >= 1 and len(hub.samples) == n


def test_probe_exception_does_not_kill_the_monitor():
    hub = TelemetryHub(2, interval=0.01)
    hub.register_probe("bad", lambda: 1 / 0)
    ok = threading.Event()
    hub.add_tick(lambda s: ok.set())
    hub.start()
    try:
        assert not ok.wait(0.1)
        hub._probes.clear()
        assert ok.wait(5.0)
    finally:
        hub.stop()


def test_reset_zeros_counters_but_keeps_history():
    hub, _ = _hub()
    hub.count("served", 0, 9)
    hub.observe_latency(0, 0.01)
    hub.event("reseed")
    hub.sample()
    hub.reset()
    assert hub.totals()["served"] == 0
    assert hub.merged_percentiles()["p50_ms"] == 0.0
    assert len(hub.events) == 1 and len(hub.samples) == 1
    with pytest.raises(ValueError, match="n_lanes"):
        TelemetryHub(0)


# ---------------------------------------------------------------------------
# What the metrics feed reads
# ---------------------------------------------------------------------------

def _record(mod):
    mod.reset()
    for k in range(300):                   # past the 256-entry reservoir
        mod.record_count("plan.dedup_packs")
        mod.record_value("plan.n_chunks", (37 * k) % 101)
    mod.record_value("q8.scale_max", 0.5)
    mod.record_value("dropped", "not a number")
    snap = mod.kernel_stats().snapshot()
    mod.reset()
    return snap


def test_kernel_stats_snapshot_equals_the_reference():
    assert _record(tstats) == _record(jstats)


def test_stats_keys_equal_the_reference():
    got, want = tstats.stats(), jstats.stats()
    assert set(got) == set(want) == {"counters", "series", "plan_cache"}
    assert set(got["plan_cache"]) == set(want["plan_cache"])
    assert set(tstats.stats(include_caches=False)) == {"counters", "series"}


def test_bucket_plan_cache_info_keys_equal_the_reference():
    assert set(tcompute.bucket_plan_cache_info()) == \
        set(jcompute.bucket_plan_cache_info())


def _graphs():
    s, r = powerlaw_graph(300, 1500, seed=3)
    indptr, indices, _ = coo_to_csr(s, r, 300)
    yield indptr, indices
    keep = r % 4 != 0                      # every fourth row empty
    indptr, indices, _ = coo_to_csr(s[keep], r[keep], 300)
    yield indptr, indices
    yield np.zeros(301, np.int64), np.zeros(0, np.int64)    # no edges


@pytest.mark.parametrize("fanouts", [(5, 3), (2, 2, 2), (15,)])
def test_sample_subgraph_equals_the_reference(fanouts):
    for g, (indptr, indices) in enumerate(_graphs()):
        seeds = np.random.default_rng(g).integers(0, 300, 17)
        got = tsampler.sample_subgraph(indptr, indices, seeds, fanouts,
                                       np.random.default_rng(40 + g))
        want = jsampler.sample_subgraph(indptr, indices, seeds, fanouts,
                                        np.random.default_rng(40 + g))
        assert got.n_seeds == want.n_seeds == 17
        assert np.array_equal(got.node_ids, want.node_ids)
        for f in ("hop_senders", "hop_receivers", "hop_valid"):
            a, b = getattr(got, f), getattr(want, f)
            assert len(a) == len(b) == len(fanouts)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y), f
        if g == 2:
            assert not np.concatenate(got.hop_valid).any()
