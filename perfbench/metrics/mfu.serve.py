"""mfu.serve: the operations of every prompt token admitted and every
token decoded and delivered in the traced slice, as the configuration's
family counts them (``forward_flops``; the dense family: 2 per parameter
of the products and token, and attention over the live context), over
the slice x 989 TFLOP/s."""

from perfbench.lib.readers import mfu, traced_flops


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    spec, forward_flops = run.spec, run.family.forward_flops
    prefill = traced_flops(run, "admit",
                           lambda span: forward_flops(spec, 0, span[2]))
    decode = traced_flops(run, "decode", lambda span: sum(
        forward_flops(spec, first, n) for first, n in span[3]))
    if prefill is None:
        return None
    return mfu(prefill + decode, run)
