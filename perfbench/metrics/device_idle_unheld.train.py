"""device_idle_unheld.train: the share of the traced slice in which no
operation ran on the device and no pod held a token (no ``gate.hold``
span open): the part of device_idle.train that is the sharing layer's."""

from perfbench.lib.program import idle_unheld


def read(run):
    return idle_unheld(run, "train")
