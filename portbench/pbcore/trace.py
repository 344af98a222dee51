"""One traced window under ``torch.profiler``, reduced to what the per-layer
metrics read: the device's busy time (the union of its operations'
intervals), device seconds by operation name, and the idle gaps labelled
by the host operation running in them.

The profiler's kernel records and ``key_averages`` are what ``chip_smoke.py``
read on the card (``trace_steps``); this copy adds the intervals.  The
window is marked by a ``record_function`` span of its own, so its bounds
share the trace's clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

WINDOW_SPAN = "portbench.window"
N_LABELLED_GAPS = 256


@dataclasses.dataclass
class DeviceTrace:
    """The reduced trace of one window."""

    window_s: float
    busy_s: float
    device_s: Dict[str, float]        # device seconds by operation name
    idle_by_host: Dict[str, float]    # idle seconds by host operation

    def kernel_s(self, patterns: Sequence[str]) -> float:
        """Device seconds of every operation whose name holds one of
        ``patterns``."""
        return sum(s for name, s in self.device_s.items()
                   if any(p in name for p in patterns))

    def breakdown(self, top: int = 10) -> dict:
        """The costliest device operations and the longest idle stretches
        by what the host did in them, ``top`` of each."""
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:96], s] for n, s in ops],
                "idle_gaps": [[n[:96], s] for n, s in gaps]}


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted intervals of an (n, 2) array of [start, end]."""
    if iv.size == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.r_[True, iv[1:, 0] > ends[:-1]]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    stops = ends[np.r_[idx[1:] - 1, len(iv) - 1]]
    return np.stack([starts, stops], axis=1)


def reduce_events(device: List[Tuple[str, float, float]],
                  host: List[Tuple[str, float, float]],
                  window: Tuple[float, float]) -> DeviceTrace:
    """Reduce ``(name, start_us, end_us)`` records of device and host
    operations inside ``window`` (start_us, end_us)."""
    w0, w1 = window
    device_s: Dict[str, float] = {}
    iv = []
    for name, t0, t1 in device:
        a, b = max(t0, w0), min(t1, w1)
        if b <= a:
            continue
        device_s[name] = device_s.get(name, 0.0) + (b - a) * 1e-6
        iv.append((a, b))
    merged = _union(np.asarray(iv, np.float64).reshape(-1, 2))
    busy_us = float((merged[:, 1] - merged[:, 0]).sum())
    # idle stretches: before the first operation, between, after the last
    edges = np.concatenate([[w0], merged.reshape(-1), [w1]])
    gaps = edges.reshape(-1, 2)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    idle: Dict[str, float] = {}
    if len(gaps):
        order = np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")
        longest = gaps[order[:N_LABELLED_GAPS]]
        rest = gaps[order[N_LABELLED_GAPS:]]
        names = [n for n, _, _ in host]
        hs = np.asarray([(a, b) for _, a, b in host],
                        np.float64).reshape(-1, 2)
        span = hs[:, 1] - hs[:, 0]
        for g0, g1 in longest:
            mid = 0.5 * (g0 + g1)
            inside = np.flatnonzero((hs[:, 0] <= mid) & (hs[:, 1] >= mid))
            label = ("host: python between operations" if inside.size == 0
                     else "host: " + names[inside[np.argmin(span[inside])]])
            idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-6
        if len(rest):
            idle["shorter gaps"] = float((rest[:, 1] - rest[:, 0]).sum()
                                         * 1e-6)
    return DeviceTrace(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                       device_s=device_s, idle_by_host=idle)


class Profiled:
    """``with Profiled(device) as p: ...`` traces the block on the card;
    ``p.result`` is its ``DeviceTrace`` once the block has ended.  The block
    has to leave the device idle (end in a synchronize) for its work to
    lie inside the window."""

    def __init__(self, device):
        self.device = device
        self.result: Optional[DeviceTrace] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.result = self._reduce()
        return False

    def _reduce(self) -> DeviceTrace:
        from torch.autograd import DeviceType
        device, host, window = [], [], None
        for e in self._prof.events():
            tr = e.time_range
            if e.name == WINDOW_SPAN:
                # the span shows on the device's timeline too, as a user
                # annotation: it is the window, not an operation
                if e.device_type != DeviceType.CUDA:
                    window = (tr.start, tr.end)
            elif e.device_type == DeviceType.CUDA:
                device.append((e.name, tr.start, tr.end))
            else:
                host.append((e.name, tr.start, tr.end))
        if window is None:
            raise RuntimeError("the profiler recorded no window span")
        return reduce_events(device, host, window)


@contextlib.contextmanager
def maybe_profiled(on: bool, device):
    """``Profiled`` when ``on``, else a block that records nothing."""
    if not on:
        yield None
        return
    with Profiled(device) as p:
        yield p
