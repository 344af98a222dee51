"""Online metrics plane: streaming instruments + Prometheus-style exposition
(copy of ``repro.serve.metrics``).

Three instrument families, one registry:

* **LatencyHistogram** — log-bucketed with **fixed, shared bucket bounds**
  (``HIST_MIN`` × ``HIST_GROWTH``^i), so merging histograms is an
  element-wise count add and any quantile read off the merged counts is
  exact to one bucket: the true order statistic lies inside the reported
  bucket's ``(lower, upper]``.  Buckets carry **exemplars** — the trace id
  of the last request that landed there — linking a latency mode to its
  span tree (``serve.tracing``).
* **Gauge** — last-write-wins labeled floats, refreshed from
  ``TelemetryHub`` ticks or pull callbacks evaluated at render time.
* **Counter** — monotonic within a process (``inc`` rejects negatives);
  ``set_total`` mirrors an external monotonic total, where a decrease is
  treated like a Prometheus counter reset.

``MetricsRegistry.render()`` emits the Prometheus/OpenMetrics text format
(``_bucket{le=...}`` + ``_sum`` + ``_count``, ``# TYPE``/``# HELP``,
``# {trace_id=...}`` exemplars); ``parse_exposition`` round-trips it.  A
render reads host bookkeeping only (each family snapshots its series under
its lock), so a scrape on the HTTP thread never touches the device.

Hot-path budget: one ``is None`` test at each call site when metrics are
off, one small lock + O(1) array math when on.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "HIST_MIN", "HIST_GROWTH", "N_BUCKETS", "BUCKET_UPPERS",
    "bucket_index", "bucket_upper", "bucket_lower", "quantile_from_counts",
    "LatencyHistogram", "MetricsRegistry",
    "render_labels", "parse_exposition", "histogram_counts_from_samples",
]

# ---------------------------------------------------------------------------
# Shared bucket scheme — every histogram in the process uses these bounds
# ---------------------------------------------------------------------------

HIST_MIN = 1e-4            # 0.1 ms: first bucket is (0, 0.1ms]
HIST_GROWTH = math.sqrt(2.0)   # ~41% per bucket → "within one bucket" is tight
N_BUCKETS = 48             # covers 0.1 ms .. ~1.2e3 s, then +Inf

BUCKET_UPPERS: Tuple[float, ...] = tuple(
    HIST_MIN * HIST_GROWTH ** i for i in range(N_BUCKETS))
_LOG_GROWTH = math.log(HIST_GROWTH)


def bucket_index(seconds: float) -> int:
    """Index of the bucket whose ``(lower, upper]`` contains ``seconds``.
    Index ``N_BUCKETS`` is the +Inf overflow bucket."""
    if seconds <= HIST_MIN:
        return 0
    i = int(math.ceil(math.log(seconds / HIST_MIN) / _LOG_GROWTH - 1e-12))
    return min(i, N_BUCKETS)


def bucket_upper(i: int) -> float:
    return BUCKET_UPPERS[i] if i < N_BUCKETS else math.inf


def bucket_lower(i: int) -> float:
    return 0.0 if i <= 0 else BUCKET_UPPERS[i - 1]


def quantile_from_counts(counts: Sequence[int], q: float) -> int:
    """Bucket index holding the q-quantile order statistic
    (rank ``ceil(q*n)``, clamped to [1, n]) — -1 on an empty histogram.
    Comparisons between a histogram quantile and an exact percentile are
    made on bucket indices (|Δindex| ≤ 1 ⇔ "within one bucket width")."""
    total = int(sum(counts))
    if total == 0:
        return -1
    rank = min(max(int(math.ceil(q * total)), 1), total)
    cum = 0
    for i, c in enumerate(counts):
        cum += int(c)
        if cum >= rank:
            return i
    return len(counts) - 1


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------

class LatencyHistogram:
    """One labeled series: bucket counts + sum/count + per-bucket exemplar."""

    __slots__ = ("counts", "sum", "count", "exemplars")

    def __init__(self):
        self.counts = [0] * (N_BUCKETS + 1)
        self.sum = 0.0
        self.count = 0
        self.exemplars: Dict[int, Tuple[str, float]] = {}

    def observe(self, seconds: float, exemplar: Optional[str] = None) -> None:
        i = bucket_index(seconds)
        self.counts[i] += 1
        self.sum += seconds
        self.count += 1
        if exemplar is not None:
            self.exemplars[i] = (str(exemplar), seconds)

    def merge(self, other: "LatencyHistogram") -> None:
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        self.exemplars.update(other.exemplars)

    def copy(self) -> "LatencyHistogram":
        out = LatencyHistogram()
        out.counts = list(self.counts)
        out.sum = self.sum
        out.count = self.count
        out.exemplars = dict(self.exemplars)
        return out

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile (0.0 if empty)."""
        i = quantile_from_counts(self.counts, q)
        return 0.0 if i < 0 else bucket_upper(i)

    def quantile_bounds(self, q: float) -> Tuple[float, float]:
        """The ``(lower, upper]`` interval guaranteed to contain the true
        q-quantile order statistic of everything observed."""
        i = quantile_from_counts(self.counts, q)
        return (0.0, 0.0) if i < 0 else (bucket_lower(i), bucket_upper(i))


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def render_labels(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)          # shortest round-trip — le bounds must re-parse
                            # to the exact float64 bucket bound


class _Family:
    """One metric family: a name, a type, and labeled series under a lock."""

    def __init__(self, name: str, kind: str, help_: str):
        self.name = name
        self.kind = kind
        self.help = help_
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, object] = {}

    # counter / gauge -------------------------------------------------------
    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + n

    def set_total(self, value: float, **labels) -> None:
        """Mirror an external monotonic total (counter reset ⇒ lower value,
        accepted — same semantics as a scraped process restart)."""
        with self._lock:
            self._series[_label_key(labels)] = value

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    # histogram -------------------------------------------------------------
    def observe(self, seconds: float, exemplar: Optional[str] = None,
                **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            h = self._series.get(key)
            if h is None:
                h = self._series[key] = LatencyHistogram()
            h.observe(seconds, exemplar)

    def labeled(self, **labels):
        """The raw series object for one label set (None if absent)."""
        with self._lock:
            return self._series.get(_label_key(labels))

    def merged(self) -> LatencyHistogram:
        """Element-wise merge of every labeled histogram in the family."""
        out = LatencyHistogram()
        with self._lock:
            for h in self._series.values():
                out.merge(h)
        return out

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0))

    def snapshot(self) -> Dict[LabelKey, object]:
        # deep-copy histogram series under the lock: render walks counts
        # + count OUTSIDE any lock, and a live series mutating mid-walk
        # would break the buckets-sum-to-_count exposition invariant
        # (gauge/counter series are plain floats — already values)
        with self._lock:
            return {k: (h.copy() if isinstance(h, LatencyHistogram) else h)
                    for k, h in self._series.items()}


class MetricsRegistry:
    """Process registry: lookup-or-create families, hub/kernel feeds, render.

    ``register_pull`` callbacks run at render time (and on explicit
    ``pull()``) — the cheap way to expose state that already lives
    elsewhere (kernel counters, cache infos) without a feeder thread.
    """

    def __init__(self, namespace: str = "neurachip"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self._pulls: List[Callable[[], None]] = []

    # -- family accessors ---------------------------------------------------
    def _family(self, name: str, kind: str, help_: str) -> _Family:
        full = f"{self.namespace}_{name}" if self.namespace else name
        with self._lock:
            fam = self._families.get(full)
            if fam is None:
                fam = self._families[full] = _Family(full, kind, help_)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {full} already registered as {fam.kind}")
            return fam

    def counter(self, name: str, help_: str = "") -> _Family:
        return self._family(name, "counter", help_)

    def gauge(self, name: str, help_: str = "") -> _Family:
        return self._family(name, "gauge", help_)

    def histogram(self, name: str, help_: str = "") -> _Family:
        return self._family(name, "histogram", help_)

    def register_pull(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._pulls.append(fn)

    # -- feeds --------------------------------------------------------------
    def connect_hub(self, hub) -> None:
        """Subscribe to ``TelemetryHub`` ticks: every monitor sample refreshes
        per-lane gauges and mirrors the hub's monotonic counter totals."""
        lane_g = self.gauge("lane", "per-lane probe/rollup from telemetry ticks")
        lane_c = self.counter("telemetry_total", "per-lane telemetry counters")

        def tick(sample: dict) -> None:
            for lane, entry in enumerate(sample.get("lanes", ())):
                for field, v in entry.items():
                    lane_g.set(float(v), lane=str(lane), field=field)
            for cname, vals in sample.get("counters", {}).items():
                for lane, v in enumerate(vals):
                    lane_c.set_total(int(v), lane=str(lane), counter=cname)

        hub.add_tick(tick)

    def connect_kernel_stats(self) -> None:
        """Pull ``repro_torch.sparse.stats.stats()`` at render time: the
        plan builders' counters, series summaries, and the plan-cache hit
        rate — host bookkeeping only, no device tensor is read."""
        kc = self.counter("kernel_total", "sparse kernel counters")
        ks = self.gauge("kernel_series", "sparse kernel series summaries")
        cache = self.gauge("cache_hit_rate", "host plan/step cache hit rates")

        def pull() -> None:
            from repro_torch.sparse.stats import stats as kernel_snapshot
            snap = kernel_snapshot()
            for name, v in snap.get("counters", {}).items():
                kc.set_total(int(v), name=name)
            for name, s in snap.get("series", {}).items():
                for stat in ("mean", "max", "p50", "p95"):
                    ks.set(float(s.get(stat, 0.0)), name=name, stat=stat)
            pc = snap.get("plan_cache")
            if pc:
                tries = int(pc.get("hits", 0)) + int(pc.get("misses", 0))
                cache.set(pc.get("hits", 0) / tries if tries else 0.0,
                          cache="plan")

        self.register_pull(pull)

    def pull(self) -> None:
        for fn in list(self._pulls):
            try:
                fn()
            except Exception:  # noqa: BLE001 — metrics, not truth
                pass

    # -- exposition ---------------------------------------------------------
    def render(self) -> str:
        self.pull()
        out: List[str] = []
        with self._lock:
            families = list(self._families.values())
        for fam in sorted(families, key=lambda f: f.name):
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for key, series in sorted(fam.snapshot().items()):
                if fam.kind == "histogram":
                    self._render_hist(out, fam.name, key, series)
                else:
                    out.append(f"{fam.name}{render_labels(key)} "
                               f"{_fmt(float(series))}")
        return "\n".join(out) + "\n"

    @staticmethod
    def _render_hist(out: List[str], name: str, key: LabelKey,
                     h: LatencyHistogram) -> None:
        cum = 0
        for i, c in enumerate(h.counts):
            cum += c
            le = f'le="{_fmt(bucket_upper(i))}"'
            line = f"{name}_bucket{render_labels(key, le)} {cum}"
            ex = h.exemplars.get(i)
            if ex is not None:
                line += f' # {{trace_id="{_escape(ex[0])}"}} {_fmt(ex[1])}'
            out.append(line)
        out.append(f"{name}_sum{render_labels(key)} {_fmt(h.sum)}")
        out.append(f"{name}_count{render_labels(key)} {h.count}")


# ---------------------------------------------------------------------------
# Parsing — the other half of the round trip
# ---------------------------------------------------------------------------

def _parse_labels(body: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i = 0
    while i < len(body):
        eq = body.index("=", i)
        name = body[i:eq].strip().lstrip(",").strip()
        assert body[eq + 1] == '"', f"unquoted label value in {body!r}"
        j = eq + 2
        val: List[str] = []
        while body[j] != '"':
            if body[j] == "\\":
                nxt = body[j + 1]
                val.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
            else:
                val.append(body[j])
                j += 1
        labels[name] = "".join(val)
        i = j + 1
    return labels


def parse_exposition(text: str) -> Dict[str, dict]:
    """Parse Prometheus text exposition into
    ``{family: {"type": str, "help": str, "samples": [(name, labels, value,
    exemplar)]}}`` — sample ``name`` keeps the ``_bucket``/``_sum``/
    ``_count`` suffix.  Understands the exemplar syntax ``render`` emits."""
    fams: Dict[str, dict] = {}

    def fam_for(sample_name: str) -> dict:
        base = sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            if sample_name.endswith(suffix) and sample_name[: -len(suffix)] in fams:
                base = sample_name[: -len(suffix)]
                break
        return fams.setdefault(base, {"type": "untyped", "help": "",
                                      "samples": []})

    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            fams.setdefault(name, {"type": "untyped", "help": "",
                                   "samples": []})["type"] = kind
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            name = parts[2]
            fams.setdefault(name, {"type": "untyped", "help": "",
                                   "samples": []})["help"] = (
                parts[3] if len(parts) > 3 else "")
            continue
        if line.startswith("#"):
            continue
        exemplar = None
        if " # " in line:
            line, _, ex_part = line.partition(" # ")
            ex_part = ex_part.strip()
            if ex_part.startswith("{"):
                ex_labels = _parse_labels(ex_part[1:ex_part.index("}")])
                ex_val = float(ex_part[ex_part.index("}") + 1:].strip() or 0)
                exemplar = (ex_labels.get("trace_id", ""), ex_val)
        if "{" in line:
            name = line[: line.index("{")]
            body = line[line.index("{") + 1: line.rindex("}")]
            labels = _parse_labels(body) if body else {}
            value = float(line[line.rindex("}") + 1:].strip())
        else:
            name, val_s = line.split(None, 1)
            labels, value = {}, float(val_s)
        fam_for(name)["samples"].append((name, labels, value, exemplar))
    return fams


def histogram_counts_from_samples(samples, match: Dict[str, str]) -> List[int]:
    """Rebuild per-bucket (non-cumulative) counts for the histogram series
    whose labels are a superset of ``match`` — how a p99 is read off a
    scraped exposition."""
    by_le: Dict[float, float] = {}
    for name, labels, value, _ex in samples:
        if not name.endswith("_bucket"):
            continue
        if any(labels.get(k) != v for k, v in match.items()):
            continue
        le = labels.get("le", "")
        if le == "+Inf":
            by_le[math.inf] = value
        else:
            # snap to the nearest shared bound — tolerant of any formatting
            f = float(le)
            i = min(range(N_BUCKETS), key=lambda j: abs(BUCKET_UPPERS[j] - f))
            by_le[BUCKET_UPPERS[i]] = value
    cum = [by_le.get(bucket_upper(i), 0.0) for i in range(N_BUCKETS + 1)]
    counts = [int(cum[0])] + [int(cum[i] - cum[i - 1])
                              for i in range(1, len(cum))]
    return counts
