"""Per-request-class SLOs with multi-window burn-rate shedding (port of
``repro.serve.slo``, pure host code).

Every request carries a class (``interactive`` /
``batch`` / ``best_effort``); each class has a latency objective
(``target_ms``) and an **error budget** — the fraction of requests allowed
over target.  The engine watches the served-latency stream and computes,
per class, the **burn rate** over two trailing windows:

    burn(w) = (violations in w / requests in w) / budget

``burn == 1`` means the class spends its budget exactly as provisioned;
``burn == 10`` means ten times too fast.  The multi-window rule (the SRE
workbook's fast+slow pairing) fires only when **both** windows are over
``burn_threshold``: the slow window proves the burn is sustained, the fast
window proves it is still happening — so a transient spike does not shed
and a recovered incident stops shedding promptly.

When the rule holds for ``sustain_ticks`` monitor ticks the engine sheds
the *lowest* class first (``SHED_ORDER``: best_effort, then batch); it
never sheds ``interactive`` — for interactive traffic the cluster's
queue-HWM backstop remains the only shedder.  Recovery walks the same
order backwards (batch restored before best_effort) after
``recover_ticks`` quiet ticks, mirroring the shed-arm hysteresis in
``cluster.py``.

The engine is driven from ``TelemetryHub`` ticks (one ``tick()`` per
monitor sample) and is deterministic given a clock — tests drive it with a
virtual clock exactly like the hub's.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.telemetry import percentiles_ms

__all__ = ["CLASSES", "SHED_ORDER", "DEFAULT_SLOS", "ClassSLO", "SLOEngine"]

CLASSES = ("interactive", "batch", "best_effort")
# Shed precedence — lowest class first; interactive is never SLO-shed.
SHED_ORDER = ("best_effort", "batch")


@dataclasses.dataclass(frozen=True)
class ClassSLO:
    """One class's objective: latency target + allowed violation fraction."""
    name: str
    target_ms: float
    budget: float          # fraction of requests allowed over target (0, 1]

    def __post_init__(self):
        if self.name not in CLASSES:
            raise ValueError(f"unknown request class {self.name!r}; "
                             f"expected one of {CLASSES}")
        if not (0.0 < self.budget <= 1.0):
            raise ValueError(f"budget must be in (0, 1], got {self.budget}")


DEFAULT_SLOS: Tuple[ClassSLO, ...] = (
    ClassSLO("interactive", target_ms=50.0, budget=0.01),
    ClassSLO("batch", target_ms=250.0, budget=0.05),
    ClassSLO("best_effort", target_ms=1000.0, budget=0.20),
)


class SLOEngine:
    """Burn-rate tracker + shed-precedence state machine.

    ``observe`` is hot-path (one lock, O(1)); ``tick`` runs on the
    telemetry monitor cadence and returns the shed-set transitions so the
    caller can emit ``shed_class`` telemetry events.
    """

    def __init__(self, slos: Sequence[ClassSLO] = DEFAULT_SLOS, *,
                 fast_window: float = 1.0, slow_window: float = 5.0,
                 burn_threshold: float = 2.0, sustain_ticks: int = 2,
                 recover_ticks: int = 4, latency_window: int = 4096,
                 history: int = 4096, registry=None,
                 clock: Callable[[], float] = time.monotonic):
        self.slos: Dict[str, ClassSLO] = {s.name: s for s in slos}
        missing = [c for c in CLASSES if c not in self.slos]
        if missing:
            raise ValueError(f"SLO set missing classes {missing}")
        self.fast_window = float(fast_window)
        self.slow_window = float(slow_window)
        self.burn_threshold = float(burn_threshold)
        self.sustain_ticks = max(int(sustain_ticks), 1)
        self.recover_ticks = max(int(recover_ticks), 1)
        self.clock = clock
        self._lock = threading.Lock()
        self._n: Dict[str, int] = {c: 0 for c in CLASSES}
        self._over: Dict[str, int] = {c: 0 for c in CLASSES}
        self._latencies: Dict[str, collections.deque] = {
            c: collections.deque(maxlen=latency_window) for c in CLASSES}
        # (t, {cls: (n, over)}) — cumulative snapshots; a windowed burn is a
        # difference of two snapshots, so the ring never needs resampling.
        self._snaps: "collections.deque" = collections.deque(maxlen=history)
        self._burn: Dict[str, Dict[str, float]] = {
            c: {"fast": 0.0, "slow": 0.0} for c in CLASSES}
        self._shed: List[str] = []          # prefix of SHED_ORDER, in order
        self._hot_ticks = 0
        self._cool_ticks = 0
        self.ticks = 0
        self._registry = registry
        self._hist = self._burn_g = self._shed_g = None
        if registry is not None:
            self._hist = registry.histogram(
                "request_latency_seconds",
                "end-to-end request latency by class")
            self._burn_g = registry.gauge(
                "slo_burn_rate", "windowed violation rate / error budget")
            self._shed_g = registry.gauge(
                "slo_shed", "1 while the class is being SLO-shed")

    # -- hot path -----------------------------------------------------------
    def observe(self, cls: str, seconds: float,
                exemplar: Optional[str] = None) -> None:
        slo = self.slos[cls]
        with self._lock:
            self._n[cls] += 1
            if seconds * 1e3 > slo.target_ms:
                self._over[cls] += 1
            self._latencies[cls].append(seconds)
        if self._hist is not None:
            self._hist.observe(seconds, exemplar=exemplar, **{"class": cls})

    # -- monitor cadence ----------------------------------------------------
    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One control-plane step.  Returns shed-set transitions:
        ``[{"cls": ..., "on": bool, "burn_fast": ..., "burn_slow": ...}]``."""
        t = self.clock() if now is None else now
        with self._lock:
            self.ticks += 1
            snap = (t, {c: (self._n[c], self._over[c]) for c in CLASSES})
            self._snaps.append(snap)
            for c in CLASSES:
                self._burn[c]["fast"] = self._burn_locked(c, t,
                                                          self.fast_window)
                self._burn[c]["slow"] = self._burn_locked(c, t,
                                                          self.slow_window)
            hot = any(
                self._burn[c]["fast"] > self.burn_threshold
                and self._burn[c]["slow"] > self.burn_threshold
                for c in CLASSES if c not in self._shed)
            events: List[dict] = []
            if hot:
                self._hot_ticks += 1
                self._cool_ticks = 0
                if (self._hot_ticks >= self.sustain_ticks
                        and len(self._shed) < len(SHED_ORDER)):
                    cls = SHED_ORDER[len(self._shed)]
                    self._shed.append(cls)
                    self._hot_ticks = 0   # escalation needs a fresh sustain
                    events.append(self._transition(cls, True))
            else:
                self._cool_ticks += 1
                self._hot_ticks = 0
                if self._cool_ticks >= self.recover_ticks and self._shed:
                    cls = self._shed.pop()
                    self._cool_ticks = 0
                    events.append(self._transition(cls, False))
        if self._burn_g is not None:
            for c in CLASSES:
                self._burn_g.set(self._burn[c]["fast"],
                                 **{"class": c, "window": "fast"})
                self._burn_g.set(self._burn[c]["slow"],
                                 **{"class": c, "window": "slow"})
                self._shed_g.set(1.0 if c in self._shed else 0.0,
                                 **{"class": c})
        return events

    def _transition(self, cls: str, on: bool) -> dict:
        return {"cls": cls, "on": on,
                "burn_fast": self._burn[cls]["fast"],
                "burn_slow": self._burn[cls]["slow"]}

    def _burn_locked(self, cls: str, now: float, window: float) -> float:
        """Violation fraction over the trailing window, over budget."""
        n_now, over_now = self._n[cls], self._over[cls]
        n_then, over_then = 0, 0   # engine younger than the window: all-time
        cutoff = now - window
        for t, per_cls in reversed(self._snaps):
            if t <= cutoff:        # newest snapshot at-or-before the cutoff
                n_then, over_then = per_cls[cls]
                break
        dn = n_now - n_then
        if dn <= 0:
            return 0.0
        frac = (over_now - over_then) / dn
        return frac / self.slos[cls].budget

    # -- read side ----------------------------------------------------------
    @property
    def shed_classes(self) -> frozenset:
        with self._lock:
            return frozenset(self._shed)

    def should_shed(self, cls: str) -> bool:
        with self._lock:
            return cls in self._shed

    def summary(self) -> Dict[str, dict]:
        """Exact per-class terminal summary (the scrape-match reference):
        exact percentiles over the bounded window + the burn values as of
        the last tick — the same numbers the gauges exported."""
        with self._lock:
            out: Dict[str, dict] = {}
            for c in CLASSES:
                slo = self.slos[c]
                out[c] = {"n": self._n[c], "violations": self._over[c],
                          "target_ms": slo.target_ms, "budget": slo.budget,
                          "burn_fast": self._burn[c]["fast"],
                          "burn_slow": self._burn[c]["slow"],
                          "shed": c in self._shed,
                          **percentiles_ms(list(self._latencies[c]))}
            return out
