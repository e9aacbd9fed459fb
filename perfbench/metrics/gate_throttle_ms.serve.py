"""gate_throttle_ms.serve: mean ms of a serving pod's token acquires that
tpu-schd held it past its limit (the arbiter's own account, the
``throttled_ms`` of each ``gate.acquire`` span), over every acquire that
started in the window, the traced slice included: the acquires whose
wait gate_wait_ms.serve times, of which this is a part."""

from perfbench.lib.program import in_run, mean_field


def read(run):
    return mean_field(in_run(run, "serve", "gate", "gate.acquire",
                             slice_too=True),
                      "throttled_ms")
