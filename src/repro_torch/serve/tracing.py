"""Request tracing: per-request span trees (copy of ``repro.serve.tracing``).

One trace per accepted request, identified by the request id — the same
integer its tree keys derive from (``default_tree_keys(rid, n)``), so a
trace, its sampled trees and its offline replay share one name.  Spans are
**completed intervals**: the engine emits a span once both endpoints are
known, appended to a per-trace list, and the *terminal* span (``settle``
XOR ``error``, gated on ``ServeRequest.finish``/``fail`` returning
``True``) moves the finished tree into a bounded ring buffer — and, when a
sink is attached, flushes it as one ``{"kind": "trace", ...}`` record (the
``TelemetryHub`` JSONL flight recorder's ``emit``), under the same
``schema_version``.

Tracing is **off by default**: an engine built without it holds ``tracer =
None`` and its hot loops carry one ``is None`` test per stage.  Enabled, a
span is one tuple append (no dict until flush).

The span tree is two-level: the request is the implicit root and every
span is its child, ordered by emission.  Exactly-once settlement makes
exactly-one-terminal structural: duplicate terminals are impossible (first
transition wins) and late non-terminal spans from a raced retry or drain
are dropped against the recently-closed set instead of reopening a flushed
trace.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional

# versions every flight-recorder record (events, samples, traces): bump on
# any breaking change to record shape so a reader can refuse mismatches
SCHEMA_VERSION = 1

# exactly one of these ends a trace; "shed" is the whole trace for a
# submission rejected at admission (it never gains a request id)
TERMINAL_SPANS = ("settle", "error", "shed")

# the canonical request lifecycle, in pipeline order (the waterfall's row
# order; retry/reroute interleave wherever the failover machinery fired)
STAGE_ORDER = ("submit", "route", "sample", "queue_wait", "bucket_pack",
               "dispatch", "retry", "reroute", "settle", "error", "shed")


class Tracer:
    """Thread-safe completed-span recorder with a bounded trace ring.

    ``span`` appends a ``(name, t0, t1, attrs)`` tuple to the trace's open
    list; ``settle`` appends the terminal span, moves the finished tree
    into the ring buffer, and flushes it through ``sink`` (one JSON-ready
    dict per trace).  Times are absolute monotonic-clock values at emit and
    ``t0``-relative in flushed records, so trace spans land on the same
    axis as the TelemetryHub's event/sample timestamps.
    """

    def __init__(self, *, capacity: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 t0: Optional[float] = None,
                 sink: Optional[Callable[[dict], None]] = None):
        self.clock = clock
        self.t0 = clock() if t0 is None else float(t0)
        self.capacity = max(int(capacity), 1)
        self.sink = sink
        self._open: Dict[int, list] = {}
        self._done: "collections.deque" = collections.deque(
            maxlen=self.capacity)
        # recently-closed ids: a late span from a raced retry/drain must be
        # dropped, not reopen a flushed trace (bounded like the ring)
        self._closed: "collections.deque" = collections.deque()
        self._closed_set: set = set()
        self._lock = threading.Lock()          # completion path only
        self.n_spans = 0
        self.n_traces = 0
        self.n_dropped = 0                     # late spans against closed ids

    # -- hot path (engines guard every call with ``tracer is not None``) ----
    def span(self, trace: int, name: str, t0: float, t1: float,
             attrs: Optional[dict] = None):
        """Record one completed interval on ``trace``.  Lock-free append:
        per-trace lists are only ever appended to, and completion swaps the
        whole list out under the lock."""
        if trace in self._closed_set:
            self.n_dropped += 1
            return
        spans = self._open.get(trace)
        if spans is None:
            spans = self._open.setdefault(trace, [])
        spans.append((name, t0, t1, attrs))
        self.n_spans += 1

    def extend(self, trace: int, spans) -> None:
        """Append several completed ``(name, t0, t1, attrs)`` tuples in one
        call — the dispatch loop emits three stages per request, and one
        closed-set check + one dict lookup per *request* (not per span)
        keeps the traced hot loop inside the ≤5% budget."""
        if trace in self._closed_set:
            self.n_dropped += len(spans)
            return
        lst = self._open.get(trace)
        if lst is None:
            lst = self._open.setdefault(trace, [])
        lst.extend(spans)
        self.n_spans += len(spans)

    def settle(self, trace: int, name: str, t0: float, t1: float,
               attrs: Optional[dict] = None):
        """Record the terminal span and complete the trace.  Callers gate
        this on ``ServeRequest.finish``/``fail`` returning ``True``, which
        makes a duplicate terminal structurally impossible."""
        with self._lock:
            if trace in self._closed_set:
                self.n_dropped += 1
                return
            spans = self._open.pop(trace, [])
            spans.append((name, t0, t1, attrs))
            self.n_spans += 1
            self._complete(trace, spans)

    def settle_many(self, items) -> None:
        """Settle a whole dispatch round under one lock acquisition —
        ``items`` is an iterable of ``(trace, name, t0, t1, attrs)``."""
        with self._lock:
            for trace, name, t0, t1, attrs in items:
                if trace in self._closed_set:
                    self.n_dropped += 1
                    continue
                spans = self._open.pop(trace, [])
                spans.append((name, t0, t1, attrs))
                self.n_spans += 1
                self._complete(trace, spans)

    def point(self, name: str, attrs: Optional[dict] = None):
        """A complete single-span trace for work rejected before it has an
        identity — an admission-shed submission has no rid, but the flight
        recorder should still carry one terminal record for it."""
        now = self.clock()
        with self._lock:
            self._complete(None, [(name, now, now, attrs)])

    def _complete(self, trace: Optional[int], spans: list):
        self.n_traces += 1
        self._done.append((trace, spans))
        if trace is not None:
            self._closed.append(trace)
            self._closed_set.add(trace)
            while len(self._closed) > self.capacity:
                self._closed_set.discard(self._closed.popleft())
        if self.sink is not None:
            self.sink(self.record(trace, spans))

    # -- flush / inspection --------------------------------------------------
    def record(self, trace: Optional[int], spans: list) -> dict:
        """Materialize one trace as the flight-recorder dict (`t0`-relative
        times, one span dict per tuple) — built only at completion, never
        on the span hot path."""
        base = self.t0
        out = []
        for name, a, b, attrs in spans:
            s = {"name": name, "t0": a - base, "t1": b - base}
            if attrs:
                s.update(attrs)
            out.append(s)
        return {"kind": "trace", "schema_version": SCHEMA_VERSION,
                "trace": trace, "spans": out}

    def traces(self) -> List[dict]:
        """Every completed trace still in the ring, oldest first."""
        with self._lock:
            snap = list(self._done)
        return [self.record(t, s) for t, s in snap]

    def open_traces(self) -> List[int]:
        return list(self._open)

    def stats(self) -> dict:
        return {"traces": self.n_traces, "spans": self.n_spans,
                "open": len(self._open), "dropped": self.n_dropped,
                "capacity": self.capacity}


# ---------------------------------------------------------------------------
# Completeness verification — one home for the tests and the chip run
# ---------------------------------------------------------------------------

def verify_trace(rec: dict) -> List[str]:
    """Problems with one ``{"kind": "trace"}`` record; empty list = a
    complete, well-formed span tree (exactly one terminal span, last; every
    span a forward interval under the versioned schema)."""
    probs: List[str] = []
    trace = rec.get("trace")
    label = f"trace {trace}"
    if rec.get("schema_version") != SCHEMA_VERSION:
        probs.append(f"{label}: schema_version "
                     f"{rec.get('schema_version')!r} != {SCHEMA_VERSION}")
    spans = rec.get("spans")
    if not spans:
        return probs + [f"{label}: no spans"]
    terminals = [s for s in spans if s.get("name") in TERMINAL_SPANS]
    if len(terminals) != 1:
        probs.append(f"{label}: {len(terminals)} terminal spans "
                     f"({[s.get('name') for s in terminals]}), want exactly 1")
    elif spans[-1].get("name") not in TERMINAL_SPANS:
        probs.append(f"{label}: terminal span is not last "
                     f"(last is {spans[-1].get('name')!r})")
    for s in spans:
        name = s.get("name")
        if not isinstance(name, str):
            probs.append(f"{label}: span without a name: {s!r}")
            continue
        t0, t1 = s.get("t0"), s.get("t1")
        if not (isinstance(t0, (int, float)) and isinstance(t1, (int, float))
                and t1 >= t0):
            probs.append(f"{label}: span {name!r} has a malformed interval "
                         f"t0={t0!r} t1={t1!r}")
    return probs


def verify_traces(records) -> List[str]:
    """Problems across a set of trace records: per-trace completeness plus
    no duplicated trace ids (a duplicate means a settled request's tree was
    flushed twice — the exactly-once contract leaking into observability)."""
    probs: List[str] = []
    seen: set = set()
    for rec in records:
        probs.extend(verify_trace(rec))
        trace = rec.get("trace")
        if trace is not None:
            if trace in seen:
                probs.append(f"trace {trace}: duplicate trace record")
            seen.add(trace)
    return probs
