"""ttft_p95_ms: 95th percentile, over every request due in the window, of
its first token's time minus its scheduled arrival (open loop); a
request without a first token at the window's end counts the time it
has waited until then."""

from perfbench.lib.readers import in_window, percentile


def read(run):
    if run.kind != "serve":
        return None
    end = run.window[1]
    waits = [min(r.first, end) - r.due for p in run.pods for r in p.requests
             if in_window(run, r.due)]
    value = percentile(waits, 95)
    return None if value is None else 1e3 * value
