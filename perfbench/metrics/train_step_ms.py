"""train_step_ms: host wall of a pod's training step (forward, backward,
Adam and the gate's drain) over its steps, in the window."""

from perfbench.lib.readers import spans


def read(run):
    steps = spans(run, "train", "train_step")
    if not steps:
        return None
    return 1e3 * sum(s[1] - s[0] for s in steps) / len(steps)
