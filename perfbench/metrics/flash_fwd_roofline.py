"""flash_fwd_roofline: the forward flash kernel's least time (operations
at 989 TFLOP/s or bytes at 3.35 TB/s, counted at the model's head dim)
over its device time, every call in the traced slice."""

from perfbench.lib.readers import flash_roofline


def read(run):
    return flash_roofline(run, "flash_fwd", "fwd")
