"""Deterministic, seed-driven fault injection for the serving tier (copy
of ``repro.serve.chaos``).

* **deterministic** — faults trigger on counters the serving stack already
  owns (dispatch round numbers, request ids), not on wall-clock dice, so a
  chaos test fails reproducibly or not at all.  Probabilistic modes hash
  ``(seed, site, counter)`` through splitmix64 (``sparse.sampler._mix64``,
  bitwise the reference's ``mix64``).
* **zero happy-path cost** — the engine consults the injector only through
  ``if self.chaos is not None`` guards.

Fault vocabulary:

* ``kill``  — a lane goes silent mid-stream and stays silent until the
  supervisor declares it dead (``on_lane_dead`` spends the fault).
* ``stall`` — a lane goes silent for ``duration`` seconds, then recovers.
* ``sampler`` — a data-plane worker exception on given request ids (the
  ``SamplerPool`` isolation path's trigger).
* ``step`` — a transient device-step failure on given dispatch rounds (the
  retry path's trigger).

The single-lane engine consults ``step_fault`` and ``sampler_hook``; the
lane faults wait for the cluster tier.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.sparse.sampler import _mix64 as mix64


class InjectedSamplerFault(RuntimeError):
    """Raised inside a sampler worker by the chaos hook."""

    def __init__(self, rid: int):
        super().__init__(f"chaos: injected sampler fault for request {rid}")
        self.rid = rid


@dataclasses.dataclass
class LaneFault:
    """One scripted lane fault: ``lane`` goes silent once the engine has
    dispatched ``at_round`` rounds; ``kind`` is ``"kill"`` (silent until
    the supervisor acknowledges the death) or ``"stall"`` (silent for
    ``duration`` wall seconds, then self-recovers)."""

    lane: int
    at_round: int = 0
    kind: str = "kill"
    duration: float = math.inf

    def __post_init__(self):
        if self.kind not in ("kill", "stall"):
            raise ValueError(f"unknown lane-fault kind {self.kind!r}")


def _hash_p(seed: int, site: int, counter: int, p: float) -> bool:
    if p <= 0.0:
        return False
    z = ((seed & 0xFFFFFFFF) * 0x9E37_79B9
         ^ (site << 40) ^ (counter & 0xFF_FFFF_FFFF))
    h = mix64(np.uint64(z & 0xFFFF_FFFF_FFFF_FFFF))
    return float(h) / float(1 << 64) < p


class ChaosInjector:
    """Scripted + hash-probabilistic fault schedule for one server."""

    def __init__(self, seed: int = 0, *,
                 lane_faults: Sequence[LaneFault] = (),
                 step_fault_rounds: Sequence[int] = (),
                 p_step_fault: float = 0.0,
                 sampler_fault_rids: Sequence[int] = (),
                 p_sampler_fault: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        self.seed = int(seed)
        self.clock = clock
        self._lock = threading.Lock()
        self._lane_faults: List[LaneFault] = list(lane_faults)
        self._triggered_at: Dict[int, float] = {}   # fault idx → wall time
        self._spent: set = set()                    # fault idx acknowledged
        self.step_fault_rounds = set(int(r) for r in step_fault_rounds)
        self.p_step_fault = float(p_step_fault)
        self.sampler_fault_rids = set(int(r) for r in sampler_fault_rids)
        self.p_sampler_fault = float(p_sampler_fault)
        # what actually fired
        self.injected: Dict[str, int] = {"kill": 0, "stall": 0,
                                         "step": 0, "sampler": 0}

    # -- lane faults (engine consults when assembling a round) --------------
    def blocked(self, lane: int, round_no: int) -> bool:
        """True while ``lane`` is wedged — the engine must not dispatch it
        (the lane looks exactly like a hung device stream)."""
        now = self.clock()
        with self._lock:
            for i, f in enumerate(self._lane_faults):
                if f.lane != lane or i in self._spent:
                    continue
                if round_no < f.at_round and i not in self._triggered_at:
                    continue
                if i not in self._triggered_at:
                    self._triggered_at[i] = now
                    self.injected[f.kind] += 1
                if f.kind == "kill":
                    return True
                if now - self._triggered_at[i] < f.duration:
                    return True
                self._spent.add(i)           # stall elapsed: self-recovered
        return False

    def on_lane_dead(self, lane: int):
        """Supervisor acknowledged the death: the crash is spent (the lane
        that restarts is a fresh process, not the wedged one)."""
        with self._lock:
            for i, f in enumerate(self._lane_faults):
                if f.lane == lane and i in self._triggered_at:
                    self._spent.add(i)

    # -- transient device-step faults ---------------------------------------
    def step_fault(self, round_no: int) -> bool:
        fire = (round_no in self.step_fault_rounds
                or _hash_p(self.seed, 1, round_no, self.p_step_fault))
        if fire:
            with self._lock:
                self.injected["step"] += 1
        return fire

    # -- sampler-worker faults (SamplerPool fault hook) ---------------------
    def sampler_hook(self, req) -> None:
        """Passed as ``SamplerPool(fault_hook=...)``; raises inside the
        worker for scheduled request ids — the isolation path must fail
        exactly that request and keep the worker alive."""
        if (req.rid in self.sampler_fault_rids
                or _hash_p(self.seed, 2, req.rid, self.p_sampler_fault)):
            with self._lock:
                self.injected["sampler"] += 1
            raise InjectedSamplerFault(req.rid)

    def triggered_wall_times(self) -> Dict[int, float]:
        """Fault index → wall time (injector clock) the fault first fired:
        the t=0 for detection and recovery measurements."""
        with self._lock:
            return dict(self._triggered_at)

    def info(self) -> dict:
        with self._lock:
            return {"seed": self.seed, "injected": dict(self.injected),
                    "lane_faults": [dataclasses.asdict(f)
                                    for f in self._lane_faults]}
