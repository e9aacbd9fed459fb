"""What the expert layer's readers (``metrics/moe_*.serve.py``) share.
The family says which device operations are the routed experts'
products (``expert_kernel``) and what one expert layer's call costs at
least (``expert_bound_s``); the program counts the routes each expert
took (``DecodeServer.expert_load``). A family without them, or a
program without the count, gives the readers nothing to read."""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional

from .readers import traced_flops


def expert_ops(run) -> List:
    """The routed experts' device operations in the traced slice."""
    if run.kind != "serve" or run.trace is None:
        return []
    is_expert = getattr(run.family, "expert_kernel", None)
    if is_expert is None:
        return []
    return [d for d in run.trace.device if is_expert(d.name)
            and 0.0 <= d.start < run.trace.window_s]


def loads(pod) -> Optional[List[List[int]]]:
    """The pod's routes by expert layer and expert, or None."""
    read = getattr(getattr(pod, "server", None), "expert_load", None)
    return read() if read is not None else None


def expert_least_s(run) -> Optional[float]:
    """Least seconds of every expert layer's call in the traced slice:
    an admit's calls over its prompt's tokens, a decode burst's over its
    live lanes once a step; the experts a call touches expected from the
    pod's own routes (each expert's share of them)."""
    if run.trace is None:
        return None
    bound = getattr(run.family, "expert_bound_s", None)
    if bound is None:
        return None
    spec, total = run.spec, 0.0
    for pod in run.pods:
        counted = loads(pod)
        if not counted:
            return None
        shares = [[spec.top_k * n / sum(layer) for n in layer]
                  for layer in counted if sum(layer)]
        memo = {}

        def call(tokens):
            if tokens not in memo:
                memo[tokens] = sum(bound(spec, tokens, q) for q in shares)
            return memo[tokens]

        view = SimpleNamespace(trace=run.trace, pods=[pod])
        total += traced_flops(view, "admit", lambda s: call(s[2]))
        total += traced_flops(view, "decode",
                              lambda s: s[2] * call(len(s[3])))
    return total


def load_ratio(run) -> Optional[float]:
    """Max over mean routes of the experts, each layer; the mean over
    layers and pods."""
    if run.kind != "serve":
        return None
    ratios = []
    for pod in run.pods:
        for layer in loads(pod) or []:
            mean = sum(layer) / len(layer) if layer else 0
            if mean > 0:
                ratios.append(max(layer) / mean)
    return sum(ratios) / len(ratios) if ratios else None
