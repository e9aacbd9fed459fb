"""optimizer_ms: device ms of the kernels launched inside the optimizer's
step (Optimizer.step# in the profiler's trace), a step."""

from perfbench.lib.readers import optimizer_ms


def read(run):
    return optimizer_ms(run)
