"""mfu.train: the operations of the tokens trained in the traced slice,
three times the forward's as the configuration's family counts it
(``forward_flops``; the dense family: 6 per parameter of the products
and token, and attention's forward and backward at 12 per visible pair
and head dim), over the slice x 989 TFLOP/s."""

from perfbench.lib.readers import mfu, traced_flops


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    t = run.traffic
    step = 3.0 * t["rows"] * run.family.forward_flops(run.spec, 0,
                                                      t["seq_len"])
    return mfu(traced_flops(run, "train_step", lambda span: step), run)
