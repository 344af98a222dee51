"""Scheduler primitives (copy of ``repro.serve.scheduler``): greedy FIFO
packing for the dynamic batcher, and the slot pools that bound what each
serving lane holds in flight."""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple


def pack_fifo(pending: Sequence, capacity: int,
              size_of: Callable = lambda _r: 1,
              skip_ahead: bool = True) -> Tuple[List, List, int]:
    """Greedy FIFO packing: ``(taken, remaining, used)``.

    Requests are taken in arrival order while they fit in ``capacity``.
    With ``skip_ahead`` (the default), a request that does not fit is left
    in place and later, smaller requests may still fill the gap — it stays
    at the front for the next batch, so it is never starved either.
    ``skip_ahead=False`` is strict FIFO: taking stops at the first misfit.
    """
    taken: List = []
    remaining: List = []
    used = 0
    for i, req in enumerate(pending):
        size = size_of(req)
        if used + size <= capacity:
            taken.append(req)
            used += size
            if used >= capacity:
                # sizes are positive, so nothing later can fit — stop
                # scanning (a deep backlog costs O(taken) per batch)
                remaining.extend(pending[i + 1:])
                break
        else:
            remaining.append(req)
            if not skip_ahead:
                remaining.extend(pending[i + 1:])
                break
    return taken, remaining, used


class SlotPool:
    """Fixed pool of serving lanes; ``acquire`` binds a request id to a free
    slot, ``release`` frees it immediately for the next waiter.

    The slot bookkeeping of a continuous batcher: bucket lanes and decode
    lanes share it.
    """

    def __init__(self, n_slots: int):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        self._rids: List[Optional[object]] = [None] * n_slots

    @property
    def n_slots(self) -> int:
        return len(self._rids)

    @property
    def free_count(self) -> int:
        return sum(1 for r in self._rids if r is None)

    def acquire(self, rid) -> Optional[int]:
        """Bind ``rid`` to the lowest free slot; ``None`` when full."""
        for i, r in enumerate(self._rids):
            if r is None:
                self._rids[i] = rid
                return i
        return None

    def release(self, slot: int):
        """Free ``slot`` and return the rid it carried."""
        rid = self._rids[slot]
        if rid is None:
            raise ValueError(f"slot {slot} is already free")
        self._rids[slot] = None
        return rid

    def rid_of(self, slot: int):
        return self._rids[slot]

    def live(self) -> List[Tuple[int, object]]:
        """(slot, rid) pairs of occupied lanes, slot-ordered."""
        return [(i, r) for i, r in enumerate(self._rids) if r is not None]


class LaneSlotPools:
    """One ``SlotPool`` per serving lane — a cluster tier's in-flight
    bookkeeping.

    Each lane may have at most ``slots_per_lane`` batches in flight (the
    double-buffer depth); a lane whose pool is full is skipped when the
    engine assembles the next round — per-lane backpressure instead of a
    global stall.  ``depths()`` doubles as the router's load signal.
    """

    def __init__(self, n_lanes: int, slots_per_lane: int):
        if n_lanes <= 0:
            raise ValueError(f"n_lanes must be positive, got {n_lanes}")
        self.pools = [SlotPool(slots_per_lane) for _ in range(n_lanes)]

    @property
    def n_lanes(self) -> int:
        return len(self.pools)

    def can_dispatch(self, lane: int) -> bool:
        return self.pools[lane].free_count > 0

    def idle(self, lane: int) -> bool:
        """True when the lane has *nothing* in flight — the supervision
        heartbeat's idle-is-healthy test (a lane holding slots past the
        stall timeout is a wedged device stream, not an idle lane)."""
        p = self.pools[lane]
        return p.free_count == p.n_slots

    def acquire(self, lane: int, tag) -> int:
        slot = self.pools[lane].acquire(tag)
        if slot is None:
            raise RuntimeError(f"lane {lane} has no free in-flight slot")
        return slot

    def release(self, lane: int, slot: int):
        return self.pools[lane].release(slot)

    def depths(self) -> List[int]:
        """In-flight batch count per lane."""
        return [p.n_slots - p.free_count for p in self.pools]
