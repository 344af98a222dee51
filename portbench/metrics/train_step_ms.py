"""train_step_ms: the window's wall time over the steps it completed; the
window ends in a synchronize."""


def read(run):
    return run.host["window_s"] * 1e3 / run.host["steps"]
