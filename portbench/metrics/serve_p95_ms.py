"""serve_p95_ms: nearest-rank 95th percentile of every request due in the
window, each timed from when it was due; a request that never settled is
infinitely late."""


def read(run):
    return run.host["p95_s"] * 1e3
