"""decode_tokens_per_s: every token delivered to a client by all pods in
the window (first tokens included), over the window."""

from perfbench.lib.readers import in_window


def read(run):
    if run.kind != "serve":
        return None
    tokens = sum(n for p in run.pods for r in p.requests
                 for t, n in r.deliveries if in_window(run, t))
    return tokens / (run.window[1] - run.window[0])
