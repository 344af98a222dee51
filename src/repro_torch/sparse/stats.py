"""Plan-layout counter registry (stdlib copy of the part of
``repro.sparse.stats`` that ``make_plan`` records into).

``record_count`` bumps an integer; ``record_value`` folds a value into a
series summary (n/sum/min/max).  Recording happens once per plan build,
never per step; ``kernel_stats().snapshot()`` is the read side.
"""
from __future__ import annotations

import threading
from typing import Dict

__all__ = ["KernelStats", "kernel_stats", "record_count", "record_value",
           "reset"]


class KernelStats:
    """Thread-safe counters + value-series summaries."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._series: Dict[str, dict] = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def observe(self, name: str, value) -> None:
        v = float(value)
        with self._lock:
            s = self._series.setdefault(name, {"n": 0, "sum": 0.0, "min": v,
                                               "max": v})
            s["n"] += 1
            s["sum"] += v
            s["min"] = min(s["min"], v)
            s["max"] = max(s["max"], v)

    def snapshot(self) -> dict:
        """{"counters": {...}, "series": {name: {n, sum, min, max}}}."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "series": {k: dict(s) for k, s in self._series.items()}}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._series.clear()


_STATS = KernelStats()


def kernel_stats() -> KernelStats:
    return _STATS


def record_count(name: str, n: int = 1) -> None:
    _STATS.count(name, n)


def record_value(name: str, value) -> None:
    _STATS.observe(name, value)


def reset() -> None:
    _STATS.reset()
