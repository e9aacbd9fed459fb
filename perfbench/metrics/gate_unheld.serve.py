"""gate_unheld.serve: the share of the window, in %, in which no
decode pod held a token (no ``gate.hold`` span open), read from the
program's own spans over the whole window less the traced slice: the
steady counterpart of device_idle_unheld.serve, which samples only the
3-s slice."""

from perfbench.lib.program import unheld


def read(run):
    return unheld(run, "serve")
