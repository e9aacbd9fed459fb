"""prefill_launch_ms_per_ktok: host ms launching a prompt's prefill: each
``serve.admit`` span less its ``serve.sync`` child (the wait for the
device), over thousands of prompt tokens admitted, in the window (outside the
traced slice)."""

from perfbench.lib.program import self_ms


def read(run):
    return self_ms(run, "serve", "server", "serve.admit", "serve.sync",
                   "tokens", 1e-3)
