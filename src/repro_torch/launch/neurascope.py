"""NeuraScope — the performance visualizer over the serving flight
recorder (port of ``repro.launch.neurascope``).

  # render a self-contained HTML report from a flight recorder
  PYTHONPATH=src python -m repro_torch.launch.neurascope flight.jsonl \\
      --out artifacts/neurascope.html

  # terminal summary + schema/span-tree validation (exit != 0 on a
  # malformed recorder)
  PYTHONPATH=src python -m repro_torch.launch.neurascope flight.jsonl \\
      --summary --check

  # live dashboard: auto-refreshing terminal panels (per-lane heat, SLO
  # burn rate, kernel-counter sparklines) off a /metrics endpoint or a
  # growing flight-recorder JSONL
  PYTHONPATH=src python -m repro_torch.launch.neurascope \\
      http://127.0.0.1:9100/metrics --live

Data sources, one report:

* the **flight recorder** JSONL (``serve.telemetry.TelemetryHub`` and
  ``serve.tracing.Tracer`` records, one versioned schema) — span
  waterfalls for the slowest request traces, per-lane queue-depth and
  in-flight timelines, the event log (hot swaps, graph flushes, lane
  deaths);
* optionally, ``--bench`` JSON files carrying a ``kernel_stats`` snapshot
  and a ``trajectory`` history, drawn as histograms and sparklines.  The
  port has no benchmark file of its own yet, so none is read unless
  named (the ``BENCH_*.json`` files at the repo root are the JAX
  package's numbers).

The HTML is self-contained (inline SVG and CSS, no external assets, no
JS).  ``--check`` runs ``tracing.verify_traces`` and the schema-version
check over every record and exits nonzero on any finding.  Host Python
only: it reads files and one HTTP endpoint, and touches no device.
"""
from __future__ import annotations

import argparse
import html as html_mod
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from repro_torch.serve.tracing import SCHEMA_VERSION, verify_traces

DEFAULT_OUT = os.path.join("artifacts", "neurascope.html")
WATERFALL_TRACES = 12            # slowest traces rendered
STAGE_COLORS = {
    "submit": "#9aa0a6", "route": "#8ab4f8", "sample": "#81c995",
    "queue_wait": "#fdd663", "bucket_pack": "#ff8bcb",
    "dispatch": "#c58af9", "retry": "#f28b82", "reroute": "#fcad70",
    "settle": "#34a853", "error": "#ea4335", "shed": "#b31412",
}
_FALLBACK_COLOR = "#d2d4d7"


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def _generations(path: str) -> List[str]:
    """Rotation siblings oldest-first: ``<path>.N`` … ``<path>.1``, then
    the live file — the hub's bounded N-generation rotation order."""
    gens = []
    k = 1
    while os.path.exists(f"{path}.{k}"):
        gens.append(f"{path}.{k}")
        k += 1
    return list(reversed(gens)) + [path]


def load_flight(path: str) -> Tuple[Dict[str, list], dict]:
    """Parse a flight-recorder JSONL (rotated generations first, oldest to
    newest, so the timeline is in order).  Returns ``(records_by_kind,
    meta)``; unknown kinds are counted, not dropped errors — the schema is
    append-only."""
    recs: Dict[str, list] = {"event": [], "sample": [], "trace": []}
    meta = {"files": [], "bad_lines": 0, "other_kinds": 0,
            "version_errors": []}
    for p in _generations(path):
        if not os.path.exists(p):
            continue
        meta["files"].append(p)
        with open(p) as f:
            for lineno, line in enumerate(f, 1):
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    meta["bad_lines"] += 1
                    continue
                v = rec.get("schema_version")
                if v != SCHEMA_VERSION:
                    meta["version_errors"].append(
                        f"{os.path.basename(p)}:{lineno}: schema_version "
                        f"{v!r} != {SCHEMA_VERSION}")
                kind = rec.get("kind")
                if kind in recs:
                    recs[kind].append(rec)
                else:
                    meta["other_kinds"] += 1
    return recs, meta


def load_benches(paths: List[str]) -> List[Tuple[str, dict]]:
    out = []
    for p in paths:
        try:
            with open(p) as f:
                out.append((os.path.basename(p), json.load(f)))
        except (OSError, ValueError) as e:
            print(f"neurascope: skipping {p}: {e}", file=sys.stderr)
    return out


# ---------------------------------------------------------------------------
# Trace shaping
# ---------------------------------------------------------------------------

def trace_bounds(rec: dict) -> Tuple[float, float]:
    spans = rec["spans"]
    return (min(s["t0"] for s in spans), max(s["t1"] for s in spans))


def trace_duration(rec: dict) -> float:
    t0, t1 = trace_bounds(rec)
    return t1 - t0


def slowest_traces(traces: List[dict], k: int) -> List[dict]:
    return sorted(traces, key=trace_duration, reverse=True)[:k]


def stage_totals(traces: List[dict]) -> Dict[str, float]:
    """Aggregate seconds per span name across traces (the where-did-the-
    time-go table)."""
    tot: Dict[str, float] = {}
    for rec in traces:
        for s in rec["spans"]:
            tot[s["name"]] = tot.get(s["name"], 0.0) + (s["t1"] - s["t0"])
    return dict(sorted(tot.items(), key=lambda kv: -kv[1]))


# ---------------------------------------------------------------------------
# SVG primitives (no deps, no JS — archives cleanly)
# ---------------------------------------------------------------------------

def _esc(s) -> str:
    return html_mod.escape(str(s))


def _svg(w: int, h: int, body: str) -> str:
    return (f'<svg viewBox="0 0 {w} {h}" width="{w}" height="{h}" '
            f'xmlns="http://www.w3.org/2000/svg">{body}</svg>')


def svg_waterfall(traces: List[dict], width: int = 860,
                  row_h: int = 18) -> str:
    """Span waterfall: one row per trace, spans as colored bars on a shared
    time axis spanning the selected traces' window."""
    if not traces:
        return "<p>(no traces)</p>"
    lo = min(trace_bounds(t)[0] for t in traces)
    hi = max(trace_bounds(t)[1] for t in traces)
    span = max(hi - lo, 1e-9)
    label_w, pad = 150, 4
    plot_w = width - label_w - pad
    h = row_h * len(traces) + 24

    def x(t: float) -> float:
        return label_w + plot_w * (t - lo) / span

    parts = []
    for i, rec in enumerate(traces):
        y = 18 + i * row_h
        dur_ms = trace_duration(rec) * 1e3
        parts.append(
            f'<text x="2" y="{y + row_h - 6}" font-size="11" '
            f'fill="#333">#{_esc(rec.get("trace"))} '
            f'{dur_ms:.1f}ms</text>')
        for s in rec["spans"]:
            x0, x1 = x(s["t0"]), x(s["t1"])
            w = max(x1 - x0, 1.0)
            c = STAGE_COLORS.get(s["name"], _FALLBACK_COLOR)
            tip = (f'{s["name"]} {(s["t1"] - s["t0"]) * 1e3:.2f}ms '
                   + " ".join(f"{k}={v}" for k, v in s.items()
                              if k not in ("name", "t0", "t1")))
            parts.append(
                f'<rect x="{x0:.1f}" y="{y}" width="{w:.1f}" '
                f'height="{row_h - 4}" fill="{c}">'
                f'<title>{_esc(tip)}</title></rect>')
    # axis labels
    parts.append(f'<text x="{label_w}" y="12" font-size="10" fill="#777">'
                 f'{lo:.3f}s</text>')
    parts.append(f'<text x="{width - 50}" y="12" font-size="10" '
                 f'fill="#777">{hi:.3f}s</text>')
    return _svg(width, h, "".join(parts))


def svg_lane_timeline(samples: List[dict], field: str, width: int = 860,
                      height: int = 120) -> str:
    """Per-lane polylines of one probe field over sample time."""
    pts: Dict[int, List[Tuple[float, float]]] = {}
    for rec in samples:
        t = rec.get("t", 0.0)
        for lane, entry in enumerate(rec.get("lanes", [])):
            pts.setdefault(lane, []).append((t, float(entry.get(field, 0.0))))
    if not pts or all(len(v) < 2 for v in pts.values()):
        return f"<p>(not enough samples for {_esc(field)})</p>"
    lo = min(p[0][0] for p in pts.values() if p)
    hi = max(p[-1][0] for p in pts.values() if p)
    vmax = max((v for p in pts.values() for _, v in p), default=1.0)
    span, vmax = max(hi - lo, 1e-9), max(vmax, 1e-9)
    pad_l, pad_b = 36, 16
    pw, ph = width - pad_l - 6, height - pad_b - 6
    parts = [f'<text x="2" y="12" font-size="10" fill="#777">'
             f'{vmax:.0f}</text>',
             f'<text x="2" y="{height - pad_b}" font-size="10" '
             f'fill="#777">0</text>',
             f'<line x1="{pad_l}" y1="{6 + ph}" x2="{width - 6}" '
             f'y2="{6 + ph}" stroke="#ccc"/>']
    palette = ["#4285f4", "#ea4335", "#fbbc04", "#34a853", "#ff6d01",
               "#46bdc6", "#7baaf7", "#f07b72"]
    for lane in sorted(pts):
        poly = " ".join(
            f"{pad_l + pw * (t - lo) / span:.1f},"
            f"{6 + ph - ph * v / vmax:.1f}" for t, v in pts[lane])
        c = palette[lane % len(palette)]
        parts.append(f'<polyline points="{poly}" fill="none" '
                     f'stroke="{c}" stroke-width="1.5">'
                     f'<title>lane {lane}</title></polyline>')
    return _svg(width, height, "".join(parts))


def svg_histogram(values: List[float], width: int = 400, height: int = 110,
                  bins: int = 16) -> str:
    if not values:
        return "<p>(no samples)</p>"
    lo, hi = min(values), max(values)
    span = max(hi - lo, 1e-12)
    counts = [0] * bins
    for v in values:
        counts[min(int((v - lo) / span * bins), bins - 1)] += 1
    cmax = max(counts)
    pad_b = 16
    bw = (width - 8) / bins
    ph = height - pad_b - 6
    parts = []
    for i, c in enumerate(counts):
        bh = ph * c / max(cmax, 1)
        parts.append(
            f'<rect x="{4 + i * bw:.1f}" y="{6 + ph - bh:.1f}" '
            f'width="{bw - 1:.1f}" height="{bh:.1f}" fill="#8ab4f8">'
            f'<title>[{lo + span * i / bins:.3g}, '
            f'{lo + span * (i + 1) / bins:.3g}): {c}</title></rect>')
    parts.append(f'<text x="4" y="{height - 4}" font-size="10" '
                 f'fill="#777">{lo:.3g}</text>')
    parts.append(f'<text x="{width - 60}" y="{height - 4}" font-size="10" '
                 f'fill="#777">{hi:.3g}</text>')
    return _svg(width, height, "".join(parts))


def svg_sparkline(values: List[float], width: int = 180,
                  height: int = 36) -> str:
    if len(values) < 2:
        return f'<span style="color:#777">{values and values[0]}</span>'
    lo, hi = min(values), max(values)
    span = max(hi - lo, 1e-12)
    n = len(values)
    poly = " ".join(
        f"{4 + (width - 8) * i / (n - 1):.1f},"
        f"{4 + (height - 8) * (1 - (v - lo) / span):.1f}"
        for i, v in enumerate(values))
    return _svg(width, height,
                f'<polyline points="{poly}" fill="none" stroke="#4285f4" '
                f'stroke-width="1.5"/>')


# ---------------------------------------------------------------------------
# Report assembly
# ---------------------------------------------------------------------------

def _section(title: str, body: str) -> str:
    return f"<section><h2>{_esc(title)}</h2>{body}</section>"


def _legend() -> str:
    chips = "".join(
        f'<span class="chip"><span class="sw" '
        f'style="background:{c}"></span>{_esc(n)}</span>'
        for n, c in STAGE_COLORS.items())
    return f'<div class="legend">{chips}</div>'


def render_html(recs: Dict[str, list], meta: dict,
                benches: List[Tuple[str, dict]]) -> str:
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>NeuraScope</title><style>"
        "body{font-family:system-ui,sans-serif;margin:24px;color:#202124}"
        "h1{font-size:22px}h2{font-size:16px;border-bottom:1px solid #ddd;"
        "padding-bottom:4px}section{margin-bottom:28px}"
        "table{border-collapse:collapse;font-size:12px}"
        "td,th{border:1px solid #ddd;padding:3px 8px;text-align:right}"
        "th{background:#f1f3f4}td:first-child,th:first-child"
        "{text-align:left}"
        ".chip{display:inline-block;margin-right:10px;font-size:11px}"
        ".sw{display:inline-block;width:10px;height:10px;margin-right:3px;"
        "border-radius:2px}"
        ".grid{display:flex;flex-wrap:wrap;gap:16px}"
        ".cell{font-size:11px;color:#555}"
        "</style></head><body><h1>NeuraScope</h1>",
        f"<p class='cell'>flight recorder: {_esc(', '.join(meta['files']))}"
        f" — {len(recs['trace'])} traces, {len(recs['sample'])} samples, "
        f"{len(recs['event'])} events; schema v{SCHEMA_VERSION}</p>",
    ]

    # --- span waterfall ----------------------------------------------------
    traces = recs["trace"]
    if traces:
        slow = slowest_traces(traces, WATERFALL_TRACES)
        parts.append(_section(
            f"Slowest {len(slow)} request traces (of {len(traces)})",
            _legend() + svg_waterfall(slow)))
        tot = stage_totals(traces)
        rows = "".join(f"<tr><td>{_esc(n)}</td><td>{v * 1e3:.1f}</td></tr>"
                       for n, v in tot.items())
        parts.append(_section(
            "Aggregate time per stage (all traces)",
            f"<table><tr><th>stage</th><th>ms total</th></tr>{rows}"
            f"</table>"))
    else:
        parts.append(_section("Request traces",
                              "<p>(recorder holds no trace records — run "
                              "the server with tracing=True)</p>"))

    # --- lane timelines ------------------------------------------------------
    if recs["sample"]:
        for field, label in (("queue_depth", "Queue depth per lane"),
                             ("inflight", "In-flight batches per lane"),
                             ("occupancy", "Batch occupancy per lane")):
            parts.append(_section(
                label, svg_lane_timeline(recs["sample"], field)))

    # --- event log -----------------------------------------------------------
    if recs["event"]:
        rows = "".join(
            f"<tr><td>{e.get('t', 0.0):.3f}</td>"
            f"<td>{_esc(e.get('event'))}</td>"
            f"<td>{_esc({k: v for k, v in e.items() if k not in ('kind', 'schema_version', 't', 'event')})}</td></tr>"
            for e in recs["event"][:200])
        parts.append(_section(
            f"Control-plane events ({len(recs['event'])})",
            f"<table><tr><th>t (s)</th><th>event</th><th>fields</th></tr>"
            f"{rows}</table>"))

    # --- kernel stats + trajectory from bench JSONs --------------------------
    for name, data in benches:
        ks = data.get("kernel_stats")
        if isinstance(ks, dict) and (ks.get("counters")
                                     or ks.get("series")):
            body = []
            if ks.get("counters"):
                rows = "".join(
                    f"<tr><td>{_esc(k)}</td><td>{v}</td></tr>"
                    for k, v in sorted(ks["counters"].items()))
                body.append(f"<table><tr><th>counter</th><th>n</th></tr>"
                            f"{rows}</table>")
            hists = []
            for k, s in sorted((ks.get("series") or {}).items()):
                sample = s.get("sample") or []
                hists.append(
                    f"<div><div class='cell'>{_esc(k)} "
                    f"(n={s.get('n')}, mean={s.get('mean', 0):.3g}, "
                    f"max={s.get('max', 0):.3g})</div>"
                    f"{svg_histogram([float(v) for v in sample])}</div>")
            if hists:
                body.append(f"<div class='grid'>{''.join(hists)}</div>")
            parts.append(_section(f"Compute-plane counters — {name}",
                                  "".join(body)))
        traj = data.get("trajectory")
        if isinstance(traj, list) and len(traj) >= 2:
            series: Dict[str, List[float]] = {}
            for snap in traj:
                for cell, metrics in (snap.get("metrics") or {}).items():
                    for mk, mv in metrics.items():
                        if isinstance(mv, bool) or not isinstance(
                                mv, (int, float)):
                            continue
                        series.setdefault(f"{cell} · {mk}",
                                          []).append(float(mv))
            cells = "".join(
                f"<div><div class='cell'>{_esc(k)} "
                f"(latest {v[-1]:.3g})</div>{svg_sparkline(v)}</div>"
                for k, v in sorted(series.items()) if len(v) >= 2)
            if cells:
                parts.append(_section(
                    f"Trajectory — {name} ({len(traj)} snapshots)",
                    f"<div class='grid'>{cells}</div>"))

    parts.append("</body></html>")
    return "".join(parts)


# ---------------------------------------------------------------------------
# Terminal modes
# ---------------------------------------------------------------------------

def summarize(recs: Dict[str, list], meta: dict) -> None:
    traces, samples, events = recs["trace"], recs["sample"], recs["event"]
    print(f"neurascope: {', '.join(meta['files']) or '(no files)'}")
    print(f"  records: {len(traces)} traces, {len(samples)} samples, "
          f"{len(events)} events "
          f"({meta['other_kinds']} other, {meta['bad_lines']} bad lines)")
    if traces:
        durs = sorted(trace_duration(t) for t in traces)
        p = lambda q: durs[min(int(q * (len(durs) - 1)), len(durs) - 1)]
        print(f"  trace latency: p50 {p(0.5) * 1e3:.1f}ms  "
              f"p95 {p(0.95) * 1e3:.1f}ms  p99 {p(0.99) * 1e3:.1f}ms  "
              f"max {durs[-1] * 1e3:.1f}ms")
        for n, v in list(stage_totals(traces).items())[:8]:
            print(f"    stage {n:12s} {v * 1e3:10.1f} ms total")
        terms: Dict[str, int] = {}
        for t in traces:
            terms[t["spans"][-1]["name"]] = \
                terms.get(t["spans"][-1]["name"], 0) + 1
        print(f"  terminals: "
              + "  ".join(f"{k}={v}" for k, v in sorted(terms.items())))
    if events:
        kinds: Dict[str, int] = {}
        for e in events:
            kinds[e.get("event", "?")] = kinds.get(e.get("event", "?"), 0) + 1
        print("  events: "
              + "  ".join(f"{k}={v}" for k, v in sorted(kinds.items())))


def check(recs: Dict[str, list], meta: dict) -> int:
    """Validate the recorder: schema versions + every trace a well-formed
    span tree (exactly one terminal, forward intervals, no duplicates)."""
    errors = list(meta["version_errors"])
    errors += verify_traces(recs["trace"])
    if not any(recs.values()):
        errors.append("flight recorder holds no records at all")
    for e in errors[:50]:
        print(f"FAIL neurascope: {e}")
    if not errors:
        n = sum(len(v) for v in recs.values())
        print(f"neurascope check OK: {n} records, "
              f"{len(recs['trace'])} well-formed span trees, "
              f"schema v{SCHEMA_VERSION}")
    return len(errors)


# ---------------------------------------------------------------------------
# Live dashboard (--live): auto-refreshing terminal panels
# ---------------------------------------------------------------------------

SPARK = "▁▂▃▄▅▆▇█"
HISTORY = 32                     # sparkline window (frames)


def spark(values: List[float], width: int = HISTORY) -> str:
    vals = list(values)[-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = max(hi - lo, 1e-12)
    return "".join(SPARK[min(int((v - lo) / span * len(SPARK)),
                             len(SPARK) - 1)] for v in vals)


def heat_bar(frac: float, width: int = 20) -> str:
    frac = min(max(frac, 0.0), 1.0)
    full = int(round(frac * width))
    return "█" * full + "·" * (width - full)


def scrape_panels(url: str) -> dict:
    """One scrape of a /metrics endpoint → panel-ready numbers."""
    import urllib.request

    from repro_torch.serve.metrics import (bucket_upper,
                                           histogram_counts_from_samples,
                                           parse_exposition,
                                           quantile_from_counts)
    with urllib.request.urlopen(url, timeout=10) as resp:
        fams = parse_exposition(resp.read().decode())

    def samples(name):
        return fams.get(name, {}).get("samples", [])

    lanes: Dict[str, Dict[str, float]] = {}
    for _n, labels, v, _ex in samples("neurachip_lane"):
        lanes.setdefault(labels.get("lane", "?"),
                         {})[labels.get("field", "?")] = v
    classes: Dict[str, Dict[str, float]] = {}
    for _n, labels, v, _ex in samples("neurachip_slo_burn_rate"):
        classes.setdefault(labels.get("class", "?"),
                           {})[f"burn_{labels.get('window')}"] = v
    for _n, labels, v, _ex in samples("neurachip_slo_shed"):
        classes.setdefault(labels.get("class", "?"), {})["shed"] = v
    hist = samples("neurachip_request_latency_seconds")
    for cls in list(classes) or ["default"]:
        match = {"class": cls} if classes else {}
        counts = histogram_counts_from_samples(hist, match)
        if sum(counts):
            i = quantile_from_counts(counts, 0.99)
            classes.setdefault(cls, {})["p99_ms"] = bucket_upper(i) * 1e3
            classes[cls]["n"] = float(sum(counts))
    counters: Dict[str, float] = {}
    for _n, labels, v, _ex in samples("neurachip_kernel_total"):
        counters[labels.get("name", "?")] = v
    for _n, labels, v, _ex in samples("neurachip_requests_total"):
        counters[f"requests.{labels.get('class', '')}."
                 f"{labels.get('outcome', '')}"] = v
    return {"lanes": lanes, "classes": classes, "counters": counters}


def tail_panels(path: str, state: dict) -> dict:
    """Incremental flight-recorder tail → the same panel structure (burn
    rates are endpoint-only; the JSONL source shows lanes + events)."""
    events = state.setdefault("events", {})
    offset = state.get("offset", 0)
    if os.path.exists(path):
        with open(path) as f:
            f.seek(0, 2)
            end = f.tell()
            if end < offset:          # rotated under us: start over
                offset = 0
            f.seek(offset)
            for line in f:
                if not line.endswith("\n"):
                    break             # partial write: re-read next frame
                offset += len(line.encode())
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("kind") == "sample":
                    state["sample"] = rec
                elif rec.get("kind") == "event":
                    ev = rec.get("event", "?")
                    events[ev] = events.get(ev, 0) + 1
    state["offset"] = offset
    lanes: Dict[str, Dict[str, float]] = {}
    sample = state.get("sample")
    if sample:
        for lane, entry in enumerate(sample.get("lanes", [])):
            lanes[str(lane)] = {k: float(v) for k, v in entry.items()}
        for cname, vals in (sample.get("counters") or {}).items():
            for lane, v in enumerate(vals):
                lanes.setdefault(str(lane), {})[cname] = float(v)
    return {"lanes": lanes, "classes": {},
            "counters": {f"event.{k}": float(v) for k, v in events.items()}}


def render_frame(panels: dict, history: Dict[str, List[float]],
                 source: str, frame: int) -> str:
    out = [f"NeuraScope live — {source}  (frame {frame})", ""]
    lanes = panels["lanes"]
    if lanes:
        depth_max = max((l.get("queue_depth", 0.0) for l in lanes.values()),
                        default=0.0) or 1.0
        out.append("  lane  queue")
        for lane in sorted(lanes, key=lambda s: int(s) if s.isdigit() else 0):
            l = lanes[lane]
            d = l.get("queue_depth", 0.0)
            out.append(f"  {lane:>4}  {heat_bar(d / depth_max)} "
                       f"depth={d:5.0f} inflight={l.get('inflight', 0):4.0f} "
                       f"p99={l.get('p99_ms', 0):7.1f}ms "
                       f"occ={l.get('occupancy', 0):5.2f}")
        out.append("")
    classes = panels["classes"]
    if classes:
        out.append("  class        burn(fast)  burn(slow)  p99       shed")
        for cls in sorted(classes):
            c = classes[cls]
            key = f"burn.{cls}"
            history.setdefault(key, []).append(c.get("burn_fast", 0.0))
            out.append(
                f"  {cls:<12} {c.get('burn_fast', 0.0):9.2f}x "
                f"{c.get('burn_slow', 0.0):10.2f}x "
                f"{c.get('p99_ms', 0.0):7.1f}ms "
                f"{'  SHED' if c.get('shed') else '    ok'}  "
                f"{spark(history[key])}")
        out.append("")
    counters = panels["counters"]
    if counters:
        out.append("  counter sparklines (per-frame deltas)")
        shown = 0
        for name in sorted(counters):
            key = f"ctr.{name}"
            hist = history.setdefault(key, [])
            prev = history.get(f"_abs.{key}", [0.0])[-1]
            history[f"_abs.{key}"] = [counters[name]]
            hist.append(max(counters[name] - prev, 0.0))
            if len(history[f"_abs.{key}"]) and shown < 12:
                out.append(f"  {name:<36.36} {counters[name]:12.0f} "
                           f"{spark(hist)}")
                shown += 1
    return "\n".join(out) + "\n"


def live(source: str, *, interval: float, frames: int) -> int:
    """Auto-refreshing dashboard: scrape a /metrics URL or tail a JSONL.
    ``frames=0`` runs until interrupted; a finite count is the CI mode."""
    import time as _time
    is_url = source.startswith("http://") or source.startswith("https://")
    history: Dict[str, List[float]] = {}
    tail_state: dict = {}
    frame = 0
    try:
        while True:
            frame += 1
            try:
                panels = (scrape_panels(source) if is_url
                          else tail_panels(source, tail_state))
                body = render_frame(panels, history, source, frame)
            except Exception as e:  # noqa: BLE001 — endpoint racing shutdown
                body = (f"NeuraScope live — {source}  (frame {frame})\n"
                        f"  (unreachable: {e})\n")
            if frames == 0:
                sys.stdout.write("\x1b[2J\x1b[H")    # clear + home
            sys.stdout.write(body)
            sys.stdout.flush()
            if frames and frame >= frames:
                return 0
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="NeuraScope: flight-recorder + trajectory visualizer")
    ap.add_argument("flight", help="telemetry/tracing JSONL flight recorder "
                                   "(or, with --live, a /metrics URL)")
    ap.add_argument("--bench", nargs="*", default=[], metavar="JSON",
                    help="bench JSON files for kernel stats + trajectory "
                         "(default: none)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"HTML report path (default {DEFAULT_OUT})")
    ap.add_argument("--summary", action="store_true",
                    help="print a terminal summary instead of writing HTML")
    ap.add_argument("--check", action="store_true",
                    help="validate schema + span trees; exit nonzero on "
                         "any malformed record")
    ap.add_argument("--live", action="store_true",
                    help="auto-refreshing terminal dashboard off a /metrics "
                         "endpoint URL or a growing flight-recorder JSONL")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="--live refresh period in seconds (default 1.0)")
    ap.add_argument("--frames", type=int, default=0,
                    help="--live frame budget; 0 = run until interrupted "
                         "(finite counts are the CI smoke mode)")
    args = ap.parse_args(argv)

    if args.live:
        return live(args.flight, interval=args.interval, frames=args.frames)

    recs, meta = load_flight(args.flight)
    if not meta["files"]:
        print(f"neurascope: {args.flight} not found", file=sys.stderr)
        return 2

    rc = 0
    if args.check:
        rc = 1 if check(recs, meta) else 0
    if args.summary:
        summarize(recs, meta)
    if args.summary or args.check:
        return rc

    doc = render_html(recs, meta, load_benches(args.bench))
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        f.write(doc)
    print(f"neurascope: wrote {args.out} "
          f"({len(doc)} bytes, {len(recs['trace'])} traces)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
