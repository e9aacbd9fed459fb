"""device_idle.serve: the share of the traced slice in which no operation
ran on the device (1 - the union of the profiler's device intervals)."""

from perfbench.lib.readers import device_idle


def read(run):
    return device_idle(run, "serve")
