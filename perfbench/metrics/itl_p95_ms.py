"""itl_p95_ms: 95th percentile, over every token delivered to a client in
the window after its request's first, of the gap it rode in: the time
since that request's previous delivery over the tokens delivered (a
burst of n tokens gives n tokens that gap / n each)."""

from perfbench.lib.readers import in_window, percentile


def read(run):
    if run.kind != "serve":
        return None
    gaps = []
    for p in run.pods:
        for r in p.requests:
            for (t0, _), (t1, n) in zip(r.deliveries, r.deliveries[1:]):
                if n and in_window(run, t1):
                    gaps.extend([(t1 - t0) / n] * n)
    value = percentile(gaps, 95)
    return None if value is None else 1e3 * value
