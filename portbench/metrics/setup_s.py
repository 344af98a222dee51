"""setup_s: process start to the first timed step, host clock."""


def read(run):
    return run.host["setup_s"]
