"""sampler_ms.serve: device time of the device sampler's kernel (B3, found
in the trace by the names below) over the bucket steps of the traced
window."""

KERNELS = ("forest_sample_kernel",)


def read(run):
    if run.trace is None or not run.work.get("steps"):
        return None
    spent = run.trace.kernel_s(KERNELS)
    if spent <= 0:
        return None
    return spent * 1e3 / run.work["steps"]
