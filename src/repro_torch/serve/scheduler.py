"""Greedy FIFO packing for the dynamic batcher (copy of
``repro.serve.scheduler.pack_fifo``)."""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple


def pack_fifo(pending: Sequence, capacity: int,
              size_of: Callable = lambda _r: 1) -> Tuple[List, List, int]:
    """Greedy skip-ahead FIFO packing: ``(taken, remaining, used)``.

    Requests are taken in arrival order while they fit in ``capacity``.  A
    request that does not fit is left in place and later, smaller requests
    may still fill the gap — it stays at the front for the next batch, so
    it is never starved either.
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
    return taken, remaining, used
