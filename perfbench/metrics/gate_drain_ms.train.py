"""gate_drain_ms.train: mean host ms of a trainer pod's drain inside its
token hold (the ``gate.drain`` span: the wait for the step's work on the
pod's stream), a hold, in the window outside the traced slice."""

from perfbench.lib.program import in_run, mean_ms


def read(run):
    return mean_ms(in_run(run, "train", "gate", "gate.drain"))
