"""device_idle_pct.train: the share of the traced window in which no
operation ran on the device."""
from pbcore.readers import idle_pct


def read(run):
    return idle_pct(run)
