"""moe_load_ratio.serve: the routes the most loaded expert took over the
mean expert's, in each expert layer, averaged over the layers and the
pods; from the program's own count on the device (``DecodeServer.
expert_load``: every route since the model was built, set-up's warm-up
included), read once the window has closed. None where the program
keeps no such count."""

from perfbench.lib.moe import load_ratio


def read(run):
    return load_ratio(run)
