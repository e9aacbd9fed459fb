"""gate_wait_ms.train: mean host ms a trainer's token hold spends in
SharedChipGate.begin, over the window's holds."""

from perfbench.lib.readers import gate_wait_ms


def read(run):
    return gate_wait_ms(run, "train")
