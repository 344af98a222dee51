"""The port's per-class SLO burn-rate engine (``repro_torch.serve.slo``)
against the reference's ``repro.serve.slo``: the same observe/tick
sequences on a virtual clock give the same burn rates, the same shed
transitions and the same ``summary()``; then the counterparts of the
reference's engine tests (``tests/test_metrics.py``'s SLO section)."""
import numpy as np
import pytest
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # deterministic fallback; requirements-dev.txt has the real one
    from _hypothesis_shim import given, settings, st

from repro.serve import slo as jslo
from repro_torch.serve import slo as tslo
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.slo import (CLASSES, DEFAULT_SLOS, SHED_ORDER,
                                   ClassSLO, SLOEngine)


def _pair(**kw):
    """The port's and the reference's engine on one virtual clock."""
    t = {"now": 0.0}
    out = []
    for mod in (tslo, jslo):
        k = dict(kw)
        k.setdefault("clock", lambda: t["now"])
        k.setdefault("slos", [mod.ClassSLO("interactive", 10.0, 0.01),
                              mod.ClassSLO("batch", 10.0, 0.05),
                              mod.ClassSLO("best_effort", 10.0, 0.20)])
        out.append(mod.SLOEngine(**k))
    return out[0], out[1], t


def _drive(engines, t, script):
    """``script``: per tick, (dt, [(cls, seconds), ...]); every engine gets
    the same observations and ticks; returns each one's events."""
    events = [[] for _ in engines]
    for dt, obs in script:
        for cls, sec in obs:
            for e in engines:
                e.observe(cls, sec)
        t["now"] += dt
        for i, e in enumerate(engines):
            events[i].append(e.tick())
    return events


def _script(seed, n_ticks=60):
    rng = np.random.default_rng(seed)
    script = []
    for i in range(n_ticks):
        hot = (i // 12) % 2 == 0            # alternate burning and quiet
        obs = []
        for _ in range(int(rng.integers(0, 12))):
            cls = CLASSES[int(rng.integers(0, 3))]
            sec = (float(rng.uniform(0.011, 0.5)) if hot and rng.random() < 0.6
                   else float(rng.uniform(0.0001, 0.009)))
            obs.append((cls, sec))
        script.append((float(rng.uniform(0.05, 0.6)), obs))
    return script


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kw", [dict(), dict(sustain_ticks=1,
                                             recover_ticks=2),
                                dict(fast_window=0.5, slow_window=2.0,
                                     burn_threshold=4.0)])
def test_engine_equals_reference_on_the_same_stream(seed, kw):
    te, je, t = _pair(**kw)
    got, want = _drive([te, je], t, _script(seed))
    assert got == want
    assert te.summary() == je.summary()
    assert te.shed_classes == je.shed_classes
    assert te.ticks == je.ticks
    for c in CLASSES:
        assert te.should_shed(c) == je.should_shed(c)


def test_engine_equals_reference_through_a_full_shed_and_recovery():
    te, je, t = _pair(sustain_ticks=2, recover_ticks=3)
    burn = [(0.1, [(c, 0.5) for c in CLASSES for _ in range(10)])] * 6
    quiet = [(2.0, [])] * 12
    got, want = _drive([te, je], t, burn + quiet)
    flat = [e for evs in got for e in evs]
    assert [(e["cls"], e["on"]) for e in flat] == [
        ("best_effort", True), ("batch", True), ("batch", False),
        ("best_effort", False)]
    assert got == want
    assert te.summary() == je.summary()


def test_constants_equal_reference():
    assert tslo.CLASSES == jslo.CLASSES
    assert tslo.SHED_ORDER == jslo.SHED_ORDER
    assert [(s.name, s.target_ms, s.budget) for s in tslo.DEFAULT_SLOS] == \
        [(s.name, s.target_ms, s.budget) for s in jslo.DEFAULT_SLOS]


# ---------------------------------------------------------------------------
# the counterparts of the reference's engine tests
# ---------------------------------------------------------------------------

def _engine(**kw):
    t = {"now": 0.0}
    kw.setdefault("clock", lambda: t["now"])
    kw.setdefault("slos", [ClassSLO("interactive", 10.0, 0.01),
                           ClassSLO("batch", 10.0, 0.05),
                           ClassSLO("best_effort", 10.0, 0.20)])
    kw.setdefault("fast_window", 1.0)
    kw.setdefault("slow_window", 5.0)
    kw.setdefault("sustain_ticks", 2)
    kw.setdefault("recover_ticks", 3)
    return SLOEngine(**kw), t


def _burn_all(eng, t, seconds, n=10):
    for c in CLASSES:
        for _ in range(n):
            eng.observe(c, seconds)


def test_burn_rate_is_violation_fraction_over_budget():
    eng, t = _engine()
    for _ in range(8):
        eng.observe("batch", 0.001)        # under the 10 ms target
    for _ in range(2):
        eng.observe("batch", 0.5)          # over
    t["now"] = 0.5
    eng.tick()
    s = eng.summary()["batch"]
    # 2/10 violations over budget 0.05 → burn 4.0 on both windows
    assert s["burn_fast"] == pytest.approx(4.0)
    assert s["burn_slow"] == pytest.approx(4.0)
    assert s["n"] == 10 and s["violations"] == 2


def test_quiet_class_has_zero_burn():
    eng, t = _engine()
    t["now"] = 1.0
    eng.tick()
    assert all(s["burn_fast"] == 0.0 for s in eng.summary().values())


def test_shed_order_best_effort_first_then_batch_never_interactive():
    eng, t = _engine(sustain_ticks=2)
    evs = []
    for k in range(1, 7):
        _burn_all(eng, t, 0.5)             # everything violates
        t["now"] = 0.1 * k
        evs += eng.tick()
    assert [(e["cls"], e["on"]) for e in evs] == [
        ("best_effort", True), ("batch", True)]
    assert eng.shed_classes == frozenset(SHED_ORDER)
    assert not eng.should_shed("interactive")
    assert eng.should_shed("best_effort") and eng.should_shed("batch")
    for e in evs:
        assert e["burn_fast"] > eng.burn_threshold


def test_transient_spike_does_not_shed():
    """One hot tick under sustain_ticks=2 then quiet — no shed event."""
    eng, t = _engine(sustain_ticks=2)
    _burn_all(eng, t, 0.5)
    t["now"] = 0.1
    assert eng.tick() == []
    for k in range(2, 6):
        t["now"] = k * 1.0
        assert eng.tick() == []
    assert eng.shed_classes == frozenset()


def test_recovery_unsheds_in_reverse_after_quiet_ticks():
    eng, t = _engine(sustain_ticks=1, recover_ticks=2)
    _burn_all(eng, t, 0.5)
    t["now"] = 0.1
    eng.tick()                             # sheds best_effort
    t["now"] = 0.2
    eng.tick()                             # escalates to batch
    assert eng.shed_classes == frozenset(SHED_ORDER)
    evs = []
    for k in range(1, 10):
        t["now"] = 10.0 + k                # windows empty: cool ticks
        evs += eng.tick()
        if not eng.shed_classes:
            break
    assert [(e["cls"], e["on"]) for e in evs] == [
        ("batch", False), ("best_effort", False)]


def test_engine_writes_burn_and_shed_gauges():
    reg = MetricsRegistry()
    eng, t = _engine(registry=reg, sustain_ticks=1)
    _burn_all(eng, t, 0.5)
    t["now"] = 0.1
    eng.tick()
    g = reg.gauge("slo_burn_rate")
    s = eng.summary()
    for c in CLASSES:
        assert g.value(**{"class": c, "window": "fast"}) == pytest.approx(
            s[c]["burn_fast"])
    assert reg.gauge("slo_shed").value(**{"class": "best_effort"}) == 1.0
    assert reg.gauge("slo_shed").value(**{"class": "interactive"}) == 0.0
    hist = reg.histogram("request_latency_seconds")
    assert hist.labeled(**{"class": "interactive"}).count == 10


def test_default_slos_cover_every_class_and_validate():
    assert tuple(s.name for s in DEFAULT_SLOS) == CLASSES
    with pytest.raises(ValueError):
        ClassSLO("premium", 10.0, 0.01)
    with pytest.raises(ValueError):
        ClassSLO("batch", 10.0, 0.0)
    with pytest.raises(ValueError):
        SLOEngine(slos=[ClassSLO("batch", 10.0, 0.1)])


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 2), st.integers(1, 200_000),
                          st.integers(0, 3)), min_size=1, max_size=60))
def test_property_engine_equals_reference(events):
    """Any interleaving of observations (µs latencies) and ticks gives the
    reference's transitions and summary."""
    te, je, t = _pair(sustain_ticks=1, recover_ticks=2)
    for cls_i, us, ticks in events:
        for e in (te, je):
            e.observe(CLASSES[cls_i], us / 1e6)
        for _ in range(ticks):
            t["now"] += 0.3
            assert te.tick() == je.tick()
    assert te.summary() == je.summary()
