"""Typed failure vocabulary of the serving engine (stdlib copy of the
single-lane part of ``repro.serve.errors``).

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


class ServerClosed(ServeError):
    """The server shut down (possibly force-closed over a wedged engine)
    with this request still unserved."""

    def __init__(self, rid: Optional[int] = None):
        super().__init__("server closed with request still pending", rid=rid)
