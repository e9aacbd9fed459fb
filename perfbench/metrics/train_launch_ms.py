"""train_launch_ms: mean host ms of a training step's call (the
``train.step`` span: forward, backward and Adam launched, the loss not
synced), in the window outside the traced slice."""

from perfbench.lib.program import in_run, mean_ms


def read(run):
    return mean_ms(in_run(run, "train", "step", "train.step"))
