"""Latency percentiles (copy of ``repro.serve.telemetry.percentiles_ms``)."""
from __future__ import annotations

from typing import Dict

import numpy as np


def percentiles_ms(seconds) -> Dict[str, float]:
    """p50/p95/p99 of latencies given in seconds, linear-interpolated
    ``np.percentile``, reported in milliseconds (0.0 on empty)."""
    arr = np.asarray(seconds, np.float64)
    if arr.size == 0:
        return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}
    return {f"p{q}_ms": float(np.percentile(arr, q) * 1e3)
            for q in (50, 95, 99)}
