"""moe_expert_share.serve: the routed experts' grouped products' share of
the device's busy time in the traced slice, in % (the kernels the
configuration's family names, ``expert_kernel``; None for a family
without routed experts)."""

from perfbench.lib.moe import expert_ops


def read(run):
    ops = expert_ops(run)
    if not ops:
        return None
    busy = run.trace.busy_s()
    return 100.0 * sum(d.end - d.start for d in ops) / busy if busy else None
