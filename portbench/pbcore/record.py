"""What a driver hands back from one run, for the metric readers and the
result line."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from pbcore.trace import DeviceTrace


@dataclasses.dataclass
class Run:
    """One run of a cell.

    ``host``: host-clock readings (``setup_s``, ``window_s``, ...);
    ``work``: work counted from shapes over the window; ``spans``: the
    program's spans and counters read in the window; ``trace``: the
    reduced device trace of a ``--trace 1`` run; ``checks``: each number
    compared for ``correct`` with its limit; ``notes``: what is printed on
    an earlier line (set-up's pieces, the program's counters, the
    generator's lateness)."""

    attempted: int
    failed: int
    checks: Dict[str, dict]
    host: Dict[str, float]
    work: Dict[str, object] = dataclasses.field(default_factory=dict)
    spans: Dict[str, object] = dataclasses.field(default_factory=dict)
    trace: Optional[DeviceTrace] = None
    memory_peak_bytes: int = 0
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.checks.values())


def check(value: float, limit: float) -> dict:
    """A number compared for ``correct`` beside its limit (a NaN fails)."""
    v = float(value)
    return {"value": v if math.isfinite(v) else float("inf"),
            "limit": float(limit)}
