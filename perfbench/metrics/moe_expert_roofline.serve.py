"""moe_expert_roofline.serve: the routed experts' grouped products' least
time over their device time in the traced slice, in %. The least time
is the family's (``expert_bound_s``: the products' bytes at 3.35 TB/s
against their operations at 989 TFLOP/s) for every expert layer's call
of the pods' spans in the slice, each span's share by its overlap: an
admit's calls take its prompt's tokens, a decode burst's its live
lanes, once a step; the experts a call touches are expected from the
pod's own count of each expert's routes (``DecodeServer.expert_load``)."""

from perfbench.lib.moe import expert_least_s, expert_ops


def read(run):
    ops = expert_ops(run)
    least = expert_least_s(run)
    if not ops or not least:
        return None
    return 100.0 * least / sum(d.end - d.start for d in ops)
