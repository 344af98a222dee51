"""Request plane: host-side dynamic batcher for GNN inference (numpy copy
of the single-lane part of ``repro.serve.batcher``).

Seed-node requests coalesce into minibatches under two triggers:

* **size** — pending seed count reaches ``max_seeds`` (a full bucket);
* **deadline** — the oldest pending request has waited ``max_wait``
  seconds (a lone request never waits for a full batch).

Packing is skip-ahead FIFO (``scheduler.pack_fifo``).  The batcher is pure
host logic with an injectable ``clock``; one lock + condition make it safe
for the sampler workers and the engine thread.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.serve.scheduler import pack_fifo


@dataclasses.dataclass
class ServeRequest:
    """One inference request: return logits for ``seeds``.

    Delivery is exactly-once: ``finish``/``fail`` are first-transition-wins
    under the settle lock, so a request ends with a result XOR a typed
    error — never both, never twice.
    """

    rid: int
    seeds: np.ndarray                 # (k,) int64 seed node ids
    t_submit: float = 0.0             # clock time at submit
    t_ready: float = 0.0              # sampling finished, joined the queue
    t_done: float = 0.0               # result materialized
    deadline: Optional[float] = None  # absolute clock time; None = none
    lane: Optional[int] = None        # serving lane (cluster routing)
    cls: str = "interactive"          # request class (serve.slo): SLO
    #                                   objective + shed precedence
    attempts: int = 0                 # dispatch attempts (transient retries)
    reroutes: int = 0                 # lane re-assignments (failover)
    trees: Optional[list] = None      # per-seed SampledSubgraph (host plane)
    tkm: Optional[np.ndarray] = None  # (k,) int64 tree-key counter terms
    #                                   (device sampling plane)
    result: Optional[np.ndarray] = None  # (k, d_out) seed outputs
    error: Optional[BaseException] = None
    params_version: Optional[int] = None  # weight version the dispatch ran
    #                                   on (cluster)
    graph_epoch: Optional[int] = None  # resident-graph epoch sampled on
    n_settles: int = 0                # terminal transitions taken (≤1)
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    _settle_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    @property
    def n_seeds(self) -> int:
        return int(np.asarray(self.seeds).shape[0])

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline

    def finish(self, result: np.ndarray, t_done: float) -> bool:
        """Deliver the result; ``False`` if the request already settled."""
        with self._settle_lock:
            if self._event.is_set():
                return False
            self.result = result
            self.t_done = t_done
            self.n_settles += 1
            self._event.set()
            return True

    def fail(self, exc: BaseException, t_done: float) -> bool:
        """Mark the request failed — ``wait`` re-raises instead of hanging.
        First-transition-wins like ``finish``."""
        with self._settle_lock:
            if self._event.is_set():
                return False
            self.error = exc
            self.t_done = t_done
            self.n_settles += 1
            self._event.set()
            return True

    def wait_done(self, timeout: Optional[float] = None) -> bool:
        """Block until settled (result OR error) without raising."""
        return self._event.wait(timeout)

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not served in {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


class DynamicBatcher:
    """Deadline- or size-triggered batch former over a FIFO of requests."""

    def __init__(self, max_seeds: int, max_wait: float,
                 clock: Callable[[], float] = time.monotonic):
        if max_seeds <= 0:
            raise ValueError(f"max_seeds must be positive, got {max_seeds}")
        self.max_seeds = max_seeds
        self.max_wait = float(max_wait)
        self.clock = clock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[ServeRequest] = []
        self._pending_seeds = 0           # running sum — O(1) ripeness check
        self._pending_deadlined = 0       # how many pending carry a deadline
        self.n_submitted = 0
        self.n_batches = 0
        self.n_expired = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    def submit(self, req: ServeRequest):
        """Enqueue a sampled request (called by the data plane)."""
        if req.n_seeds > self.max_seeds:
            raise ValueError(
                f"request {req.rid} carries {req.n_seeds} seeds but the "
                f"batcher's bucket capacity is {self.max_seeds}")
        # t_ready re-stamps on every (re-)enqueue, so a retried request's
        # queue_wait span measures its current wait, not the first
        req.t_ready = self.clock()
        with self._cond:
            self._pending.append(req)
            self._pending_seeds += req.n_seeds
            self._pending_deadlined += int(req.deadline is not None)
            self.n_submitted += 1
            self._cond.notify()

    def reap_expired(self, now: float) -> List[ServeRequest]:
        """Remove and return every pending request whose deadline passed.
        O(1) when no pending request carries a deadline."""
        with self._lock:
            if self._pending_deadlined == 0:
                return []
            expired = [r for r in self._pending if r.expired(now)]
            if not expired:
                return []
            self._pending = [r for r in self._pending if not r.expired(now)]
            self._pending_seeds -= sum(r.n_seeds for r in expired)
            self._pending_deadlined -= sum(int(r.deadline is not None)
                                           for r in expired)
            self.n_expired += len(expired)
            return expired

    # -- trigger logic (lock held) ------------------------------------------
    def _ripe(self, now: float) -> bool:
        if not self._pending:
            return False
        if self._pending_seeds >= self.max_seeds:
            return True                                   # size trigger
        return now - self._pending[0].t_ready >= self.max_wait  # deadline

    def _take(self) -> List[ServeRequest]:
        taken, self._pending, used = pack_fifo(
            self._pending, self.max_seeds, size_of=lambda r: r.n_seeds)
        self._pending_seeds -= used
        self._pending_deadlined -= sum(int(r.deadline is not None)
                                       for r in taken)
        self.n_batches += 1
        return taken

    # -- consumers ----------------------------------------------------------
    def poll(self) -> Optional[List[ServeRequest]]:
        """Non-blocking: a batch if a trigger has fired, else ``None``."""
        with self._lock:
            if self._ripe(self.clock()):
                return self._take()
            return None

    def take(self, timeout: Optional[float] = None
             ) -> Optional[List[ServeRequest]]:
        """Block until a trigger fires (or ``timeout``); the engine loop's
        entry point.  Returns ``None`` on timeout with nothing ripe."""
        deadline = None if timeout is None else self.clock() + timeout
        with self._cond:
            while True:
                now = self.clock()
                if self._ripe(now):
                    return self._take()
                waits = []
                if self._pending:
                    waits.append(
                        self._pending[0].t_ready + self.max_wait - now)
                if deadline is not None:
                    if now >= deadline and not waits:
                        return None
                    waits.append(deadline - now)
                if not waits:
                    self._cond.wait()
                    continue
                wait = max(min(waits), 0.0)
                if wait == 0.0 and deadline is not None and now >= deadline:
                    return None
                self._cond.wait(timeout=wait if wait > 0 else 1e-4)

    def flush(self) -> List[List[ServeRequest]]:
        """Drain everything pending into batches (shutdown path)."""
        out = []
        with self._lock:
            while self._pending:
                out.append(self._take())
        return out

    def info(self) -> dict:
        """Queue counters as one observable."""
        with self._lock:
            return {"submitted": self.n_submitted,
                    "batches": self.n_batches,
                    "expired": self.n_expired,
                    "depth": len(self._pending),
                    "depth_seeds": self._pending_seeds}
