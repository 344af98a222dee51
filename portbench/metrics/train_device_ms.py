"""train_device_ms: device busy time (the union of its operations'
intervals) in the traced window over the steps run in it."""
from pbcore.readers import busy_ms_per_step


def read(run):
    return busy_ms_per_step(run)
