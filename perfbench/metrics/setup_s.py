"""setup_s: seconds from the process's start until the pods are ready
(weights drawn, shapes warmed, graphs captured, first steps taken)."""


def read(run):
    return run.setup_s
