"""Compute-plane counter registry (stdlib copy of ``repro.sparse.stats``).

Plan builders record into one process-global registry: ``plan.*`` (the
dedup-chunk layout's shape from ``make_plan``), ``q8.*`` (per-chunk
quantization scales), ``spgemm.*`` and ``two_hop.*`` (the SpGEMM plan's
hash-pad search and the Â² build's phases).  ``record_count`` bumps an
integer; ``record_value`` folds a value into a series (exact n/sum/min/max
and a bounded ring reservoir for the percentiles).  Recording happens once
per plan build, never per step.

``stats()`` is the one-call export (the metrics plane's kernel feed): the
counter/series snapshot plus the plan-cache mirror.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = ["KernelStats", "kernel_stats", "record_count", "record_value",
           "stats", "reset"]

RESERVOIR_CAP = 256


class KernelStats:
    """Thread-safe counters + bounded value series.

    ``count`` bumps an integer; ``observe`` appends to a fixed-size ring
    reservoir (index ``n % cap`` once full — deterministic, no RNG) while
    tracking exact n/sum/min/max, so summaries are exact for the moments
    and approximate only for the percentiles of long series.
    """

    def __init__(self, reservoir_cap: int = RESERVOIR_CAP):
        self.reservoir_cap = max(int(reservoir_cap), 1)
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._series: Dict[str, dict] = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def observe(self, name: str, value) -> None:
        try:
            v = float(value)
        except Exception:            # not a scalar: dropped
            return
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = {"n": 0, "sum": 0.0, "min": v, "max": v, "sample": []}
                self._series[name] = s
            s["n"] += 1
            s["sum"] += v
            s["min"] = min(s["min"], v)
            s["max"] = max(s["max"], v)
            sample: List[float] = s["sample"]
            if len(sample) < self.reservoir_cap:
                sample.append(v)
            else:
                sample[s["n"] % self.reservoir_cap] = v

    # -- read side ----------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def series_summary(self, name: str) -> Optional[dict]:
        with self._lock:
            s = self._series.get(name)
            return None if s is None else self._summarize(s)

    @staticmethod
    def _summarize(s: dict) -> dict:
        sample = sorted(s["sample"])

        def q(p: float) -> float:
            if not sample:
                return 0.0
            i = min(int(p * (len(sample) - 1) + 0.5), len(sample) - 1)
            return sample[i]
        return {"n": s["n"], "sum": s["sum"], "min": s["min"],
                "max": s["max"], "mean": s["sum"] / max(s["n"], 1),
                "p50": q(0.50), "p95": q(0.95),
                "sample": list(s["sample"])}

    def snapshot(self) -> dict:
        """{"counters": {...}, "series": {name: summary}}."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "series": {k: self._summarize(s)
                               for k, s in self._series.items()}}

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


def stats(include_caches: bool = True) -> dict:
    """The registry snapshot and, with ``include_caches``, the plan cache's
    counters (``sparse.plan.plan_cache_info``) as ``plan_cache``.  The
    import is lazy: ``sparse.plan`` records here."""
    snap = _STATS.snapshot()
    if include_caches:
        from repro_torch.sparse.plan import plan_cache_info
        snap["plan_cache"] = plan_cache_info()
    return snap


def reset() -> None:
    _STATS.reset()
