"""Shared pytest plumbing.

Per-test hard timeout, dependency-free: set ``PYTEST_PER_TEST_TIMEOUT``
(seconds) and every test body runs under a ``signal.alarm`` that raises
``TimeoutError`` when it fires.  The CI chaos leg sets this so a wedged
lane/supervisor interaction fails the leg with a stack trace instead of
hanging the job until the runner's global kill.  Unset (the default, and
all local runs) the hook is a no-op.  POSIX-only (``signal.alarm``) and
main-thread-only — exactly the CI environment; anywhere else it disables
itself rather than misfire.
"""
import os
import signal
import threading

import pytest

_TIMEOUT = float(os.environ.get("PYTEST_PER_TEST_TIMEOUT", "0") or 0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; the test skips without one")


def _usable() -> bool:
    return (_TIMEOUT > 0 and hasattr(signal, "SIGALRM")
            and threading.current_thread() is threading.main_thread())


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    if not _usable():
        yield
        return

    def _fire(signum, frame):
        raise TimeoutError(
            f"{item.nodeid} exceeded the per-test timeout "
            f"({_TIMEOUT:g}s via PYTEST_PER_TEST_TIMEOUT)")

    old = signal.signal(signal.SIGALRM, _fire)
    signal.setitimer(signal.ITIMER_REAL, _TIMEOUT)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
