"""decode_launch_ms: host ms launching a decode step: each
``serve.burst`` span less its ``serve.sync`` children (the wait for the
device), over the decode steps the bursts ran, in the window (outside
the traced slice, where the profiler slows each launch)."""

from perfbench.lib.program import self_ms


def read(run):
    return self_ms(run, "serve", "server", "serve.burst", "serve.sync",
                   "steps")
