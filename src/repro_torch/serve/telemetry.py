"""Serving telemetry: counters, events and a sampled time-series (copy of
``repro.serve.telemetry``).

``TelemetryHub`` keeps three kinds of records, all cheap on the hot path:

* **counters** — per-lane ``int64`` arrays (``COUNTERS``).  Writers update
  them under the lock they already hold for the same bookkeeping, so the
  hub adds no hot-path synchronization; the sampler reads them lock-free
  (a torn read skews one sample by one count).
* **events** — discrete control-plane transitions, timestamped and kept in
  a bounded deque.
* **samples** — the monitor thread wakes every ``interval`` seconds, reads
  every registered probe, rolls p50/p99 over per-lane latency windows,
  snapshots the counters, and hands the sample to registered ``tick``
  callbacks.

With ``jsonl_path`` set, every event and sample is also appended as one
JSON line — the flight recorder.  Every record carries ``schema_version``
(shared with the tracing records that flush through the same writer) and
the file is size-bounded: past ``jsonl_max_bytes`` the generations shift
(``<path>.k`` → ``<path>.k+1``, live file → ``<path>.1``) and the oldest
beyond ``jsonl_max_files`` archives is dropped, so a run holds at most
``(1 + jsonl_max_files) × jsonl_max_bytes`` on disk.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.tracing import SCHEMA_VERSION

COUNTERS = ("submitted", "served", "failed", "shed", "timeouts", "retries",
            "reroutes", "sampler_faults", "batches", "seeds_dispatched")


def percentiles_ms(seconds) -> Dict[str, float]:
    """p50/p95/p99 of latencies given in seconds, linear-interpolated
    ``np.percentile``, reported in milliseconds (0.0 on empty).  One home,
    shared by the hub and ``GNNServer.stats()``."""
    arr = np.asarray(seconds, np.float64)
    if arr.size == 0:
        return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}
    return {f"p{q}_ms": float(np.percentile(arr, q) * 1e3)
            for q in (50, 95, 99)}


def _percentile(window, q: float) -> float:
    if not window:
        return 0.0
    return float(np.percentile(np.asarray(window, np.float64), q))


class TelemetryHub:
    """Per-lane counters + events + monitor-sampled time-series."""

    def __init__(self, n_lanes: int, *, interval: float = 0.05,
                 jsonl_path: Optional[str] = None, window: int = 1024,
                 history: int = 4096,
                 jsonl_max_bytes: int = 64 * 1024 * 1024,
                 jsonl_max_files: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        if n_lanes <= 0:
            raise ValueError(f"n_lanes must be positive, got {n_lanes}")
        self.n_lanes = int(n_lanes)
        self.interval = float(interval)
        self.clock = clock
        self.t0 = clock()
        self.counters: Dict[str, np.ndarray] = {
            name: np.zeros(self.n_lanes, np.int64) for name in COUNTERS}
        self.lane_latencies: List[collections.deque] = [
            collections.deque(maxlen=window) for _ in range(self.n_lanes)]
        self.events: "collections.deque[dict]" = collections.deque(
            maxlen=history)
        self.samples: "collections.deque[dict]" = collections.deque(
            maxlen=history)
        self._probes: Dict[str, Callable[[], Sequence[float]]] = {}
        self._ticks: List[Callable[[dict], None]] = []
        self._emit_lock = threading.Lock()
        self.jsonl_path = jsonl_path
        self.jsonl_max_bytes = max(int(jsonl_max_bytes), 1)
        self.jsonl_max_files = max(int(jsonl_max_files), 1)
        self.jsonl_rotations = 0
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._jsonl_bytes = (os.path.getsize(jsonl_path)
                             if jsonl_path and os.path.exists(jsonl_path)
                             else 0)
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None

    # -- hot-path instrumentation (writers hold their own locks) ------------
    def count(self, name: str, lane: int = 0, n: int = 1):
        self.counters[name][lane] += n

    def observe_latency(self, lane: int, seconds: float):
        self.lane_latencies[lane].append(seconds)

    def event(self, kind: str, **fields):
        rec = {"kind": "event", "schema_version": SCHEMA_VERSION,
               "event": kind, "t": self.clock() - self.t0, **fields}
        self.events.append(rec)
        self._emit(rec)

    # -- monitor plumbing ---------------------------------------------------
    def register_probe(self, name: str, fn: Callable[[], Sequence[float]]):
        """``fn() -> per-lane sequence`` read by the monitor every tick."""
        self._probes[name] = fn

    def add_tick(self, fn: Callable[[dict], None]):
        """Called with each fresh sample (supervision/shedding hooks)."""
        self._ticks.append(fn)

    def start(self):
        if self._monitor is not None:
            return
        self._monitor = threading.Thread(target=self._run, daemon=True,
                                         name="serve-telemetry-monitor")
        self._monitor.start()

    def stop(self):
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=max(1.0, 10 * self.interval))
            self._monitor = None
        if self._jsonl is not None:
            with self._emit_lock:
                self._jsonl.close()
                self._jsonl = None

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — a probe racing shutdown must
                pass           # not kill the monitor (telemetry, not truth)

    def sample(self) -> dict:
        """One tick: probes + counter snapshot + rolling percentiles."""
        lanes = []
        probed = {name: list(np.asarray(fn(), np.float64))
                  for name, fn in self._probes.items()}
        for lane in range(self.n_lanes):
            entry = {name: float(vals[lane]) if lane < len(vals) else 0.0
                     for name, vals in probed.items()}
            entry["p50_ms"] = _percentile(self.lane_latencies[lane], 50) * 1e3
            entry["p99_ms"] = _percentile(self.lane_latencies[lane], 99) * 1e3
            batches = int(self.counters["batches"][lane])
            entry["occupancy"] = (
                float(self.counters["seeds_dispatched"][lane]) / batches
                if batches else 0.0)
            lanes.append(entry)
        rec = {"kind": "sample", "schema_version": SCHEMA_VERSION,
               "t": self.clock() - self.t0, "lanes": lanes,
               "counters": {k: v.tolist() for k, v in self.counters.items()}}
        self.samples.append(rec)
        self._emit(rec)
        for fn in list(self._ticks):
            fn(rec)
        return rec

    def emit(self, rec: dict):
        """Append one foreign record to the flight recorder — the tracing
        sink (completed span trees flush through the same writer, same
        lock, same rotation, same ``schema_version``)."""
        self._emit(rec)

    def _emit(self, rec: dict):
        if self._jsonl is None:
            return
        line = json.dumps(rec) + "\n"
        with self._emit_lock:
            if self._jsonl is None:
                return
            self._jsonl.write(line)
            self._jsonl.flush()
            self._jsonl_bytes += len(line)
            if self._jsonl_bytes >= self.jsonl_max_bytes:
                # bounded N-generation rotation: shift every archive one
                # generation older (dropping the one past jsonl_max_files),
                # then the live file becomes <path>.1
                self._jsonl.close()
                oldest = f"{self.jsonl_path}.{self.jsonl_max_files}"
                if os.path.exists(oldest):
                    os.remove(oldest)
                for k in range(self.jsonl_max_files - 1, 0, -1):
                    gen = f"{self.jsonl_path}.{k}"
                    if os.path.exists(gen):
                        os.replace(gen, f"{self.jsonl_path}.{k + 1}")
                os.replace(self.jsonl_path, self.jsonl_path + ".1")
                self._jsonl = open(self.jsonl_path, "a")
                self._jsonl_bytes = 0
                self.jsonl_rotations += 1

    # -- derived aggregates (what stats()/lane_stats() now read) ------------
    def totals(self) -> Dict[str, int]:
        return {k: int(v.sum()) for k, v in self.counters.items()}

    def merged_percentiles(self) -> Dict[str, float]:
        merged: List[float] = []
        for dq in self.lane_latencies:
            merged.extend(dq)
        return percentiles_ms(merged)

    def event_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = collections.Counter()
        for e in self.events:
            out[e["event"]] += 1
        return dict(out)

    def reset(self):
        """Zero the counters and windows (benchmark warm-up boundary).
        Events and samples are history, not rate state — they stay."""
        for v in self.counters.values():
            v[:] = 0
        for dq in self.lane_latencies:
            dq.clear()
