"""flash_dq_roofline: flash_bwd_dq's least time over its device time."""

from perfbench.lib.readers import flash_roofline


def read(run):
    return flash_roofline(run, "flash_bwd_dq", "bwd_dq")
