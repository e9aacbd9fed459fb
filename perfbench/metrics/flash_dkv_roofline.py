"""flash_dkv_roofline: flash_bwd_dkv's least time over its device time."""

from perfbench.lib.readers import flash_roofline


def read(run):
    return flash_roofline(run, "flash_bwd_dkv", "bwd_dkv")
