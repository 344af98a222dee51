"""step_device_ms.serve: device busy time in the traced window over the
bucket steps dispatched in it."""
from pbcore.readers import busy_ms_per_step


def read(run):
    return busy_ms_per_step(run)
