"""train_tokens_per_s: rows x sequence length x optimizer steps that all
pods completed in the window, over the window."""

from perfbench.lib.readers import in_window


def read(run):
    if run.kind != "train":
        return None
    steps = sum(1 for p in run.pods for _, t1, *_ in p.spans.get(
        "train_step", []) if in_window(run, t1))
    tokens = steps * run.traffic["rows"] * run.traffic["seq_len"]
    return tokens / (run.window[1] - run.window[0])
