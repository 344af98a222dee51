"""What several metric readers compute alike.  Each metric keeps its own
file under ``metrics/``, which picks one of these and, where it reads
kernels, names them; each returns ``None`` where the run holds nothing for
it to read."""
from __future__ import annotations

from typing import Optional, Sequence

from pbcore.peaks import flops_peak
from pbcore.work import spmm_roofline_s


def b1_roofline_pct(run, kernels: Sequence[str]) -> Optional[float]:
    """The least time the card could take for the window's aggregations,
    counted from their shapes, over the device time of ``kernels``."""
    if run.trace is None or not run.work.get("b1_calls"):
        return None
    spent = run.trace.kernel_s(kernels)
    if spent <= 0:
        return None
    return (100.0 * spmm_roofline_s(run.work["b1_calls"],
                                    run.work["precision"]) / spent)


def idle_pct(run) -> Optional[float]:
    """The share of the traced window in which no operation ran on the
    device."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu_pct(run) -> Optional[float]:
    """The model operations counted from shapes over the traced window's
    wall time, as a share of the card's peak in the precision the work
    runs in."""
    if run.trace is None or not run.work.get("model_flops"):
        return None
    return (100.0 * run.work["model_flops"]
            / (run.trace.window_s * flops_peak(run.work["precision"])))


def busy_ms_per_step(run) -> Optional[float]:
    """Device busy time (the union of its operations' intervals) in the
    traced window over the steps run in it."""
    if run.trace is None or not run.work.get("steps"):
        return None
    return run.trace.busy_s * 1e3 / run.work["steps"]
