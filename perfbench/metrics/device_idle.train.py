"""device_idle.train: as device_idle.serve, in a training cell."""

from perfbench.lib.readers import device_idle


def read(run):
    return device_idle(run, "train")
