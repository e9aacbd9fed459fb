"""prefill_ms_per_ktok: host wall inside DecodeServer.admit (the prompt's
prefill and its first token) over thousands of prompt tokens admitted,
in the window."""

from perfbench.lib.readers import spans


def read(run):
    admits = spans(run, "serve", "admit")
    tokens = sum(s[2] for s in admits)
    if not tokens:
        return None
    return 1e3 * sum(s[1] - s[0] for s in admits) / (tokens / 1e3)
