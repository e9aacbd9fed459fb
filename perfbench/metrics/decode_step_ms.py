"""decode_step_ms: host wall inside DecodeServer.step_burst over the
decode steps it ran, in the window."""

from perfbench.lib.readers import spans


def read(run):
    bursts = spans(run, "serve", "decode")
    steps = sum(s[2] for s in bursts)
    if not steps:
        return None
    return 1e3 * sum(s[1] - s[0] for s in bursts) / steps
