"""Typed failure vocabulary of the serving engine (stdlib copy of
``repro.serve.errors`` without the live-mutation errors).

Every way a request can fail is a distinct exception type carrying the
request id; all extend ``ServeError`` (a ``RuntimeError``), and the
timeout-shaped ones also extend ``TimeoutError``.  A submitted request is
either finished once or failed once with exactly one of these errors.
"""
from __future__ import annotations

from typing import Optional, Sequence


class ServeError(RuntimeError):
    """Base of every typed serving failure; ``rid`` is the request id
    (``None`` for server-scoped failures such as ``DrainTimeout``)."""

    def __init__(self, msg: str, *, rid: Optional[int] = None):
        super().__init__(msg)
        self.rid = rid


class SamplerError(ServeError):
    """The data plane failed to sample this request's fanout trees; the
    worker exception is chained as ``__cause__``."""

    def __init__(self, rid: int, cause: BaseException):
        super().__init__(f"request {rid}: sampling failed ({cause!r})",
                         rid=rid)
        self.__cause__ = cause


class DeadlineExceeded(ServeError, TimeoutError):
    """The request's own deadline passed while it was still queued."""

    def __init__(self, rid: int, deadline: float, now: float):
        super().__init__(f"request {rid}: deadline exceeded "
                         f"({now - deadline:+.3f}s past)", rid=rid)
        self.deadline = deadline


class DrainTimeout(ServeError, TimeoutError):
    """``drain(timeout=...)`` gave up with requests still unserved; the
    stragglers are failed with this error."""

    def __init__(self, n_pending: int, timeout: float,
                 rids: Sequence[int] = ()):
        super().__init__(f"{n_pending} request(s) still pending after "
                         f"{timeout:g}s drain")
        self.n_pending = int(n_pending)
        self.rids = list(rids)


class TransientStepError(ServeError):
    """A device step failed in a retryable way (injected by chaos; on real
    hardware a preempted or failed device stream).  The engine retries the
    affected requests before giving up."""

    def __init__(self, round_no: int):
        super().__init__(f"transient device-step failure at round {round_no}")
        self.round_no = round_no


class RetriesExhausted(ServeError):
    """The request hit transient faults on every allowed attempt."""

    def __init__(self, rid: int, attempts: int, cause: BaseException):
        super().__init__(f"request {rid}: {attempts} attempt(s) all hit "
                         f"transient faults", rid=rid)
        self.attempts = attempts
        self.__cause__ = cause


class Overloaded(ServeError):
    """Load shed at submit: the server is protecting its tail latency.
    ``retry_after_s`` is the backpressure signal; ``cls`` names the request
    class that was refused (``None`` for a class-blind shed)."""

    def __init__(self, depth: float, retry_after_s: float,
                 cls: Optional[str] = None):
        super().__init__(
            f"overloaded (queue depth {depth:.0f}"
            + (f", class {cls} shed" if cls else "")
            + f"); retry after {retry_after_s:.3f}s")
        self.depth = depth
        self.retry_after_s = retry_after_s
        self.cls = cls


class LaneFailure(ServeError):
    """A serving lane died (crash or stalled heartbeat) and this request
    could not be re-routed to a surviving lane."""

    def __init__(self, rid: Optional[int], lane: int, reason: str):
        super().__init__(f"lane {lane} failed ({reason})", rid=rid)
        self.lane = lane
        self.reason = reason


class ServerClosed(ServeError):
    """The server shut down (possibly force-closed over a wedged engine)
    with this request still unserved."""

    def __init__(self, rid: Optional[int] = None):
        super().__init__("server closed with request still pending", rid=rid)
