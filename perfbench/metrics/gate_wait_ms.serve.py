"""gate_wait_ms.serve: mean host ms a serving pod's token hold spends in
SharedChipGate.begin (the arbiter's grant), over the window's holds."""

from perfbench.lib.readers import gate_wait_ms


def read(run):
    return gate_wait_ms(run, "serve")
