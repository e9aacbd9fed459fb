"""The one traffic generator: a traffic file's parameters and a seed in,
each pod's requests or training rows out.

Serving (``"kind": "serve"``): an open loop per pod, Poisson arrivals.
The pod's requests over the run's horizon (the pre-roll and the window)
are a fixed set drawn by quantiles: n = ceil(rate x horizon)
inter-arrival gaps at the quantiles (i + 1/2) / n of the exponential,
and n prompt and n output lengths at the same quantiles of their
lognormal, clipped. Each list is dealt into blocks of ``block_s``
seconds' worth of requests so that every block holds the whole
distribution, and the seed shuffles each block (``_spread``) and draws
the token ids: every seed sends the same sizes and the same gaps, in the
same blocks, in another order. The seed changes which request meets
which, not how much work a stretch of the run holds.
A request is due at its arrival time, measured from the moment the pods
are ready; whatever happens to it is timed from then.

Training (``"kind": "train"``): rows of ``seq_len + 1`` uniform ids a
step, drawn on the device from a generator per pod (``train_batches``).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Dict, List

import numpy as np

from .weights import derive_seed


@dataclass
class Request:
    pod: int
    index: int
    due_s: float                 # from the pods' start
    prompt: List[int]
    out_len: int
    # filled by the pod that serves it (perf_counter seconds)
    due: float = 0.0
    deliveries: List = field(default_factory=list)   # (time, n tokens)
    tokens: List[int] = field(default_factory=list)
    done: float = math.inf

    @property
    def first(self) -> float:
        return self.deliveries[0][0] if self.deliveries else math.inf


def _quantiles(n: int) -> List[float]:
    return [(i + 0.5) / n for i in range(n)]


def _gap(q: float, rate: float) -> float:
    """The q-quantile of a Poisson process's inter-arrival gap."""
    return -math.log1p(-q) / rate


def _length(q: float, spec: Dict) -> int:
    """The q-quantile of a clipped lognormal length."""
    value = spec["median"] * math.exp(spec["sigma"] * NormalDist().inv_cdf(q))
    return int(min(spec["max"], max(spec["min"], round(value))))


def _spread(ranked: List, per_block: int, rng: random.Random) -> List:
    """``ranked`` (ascending) in blocks of ``per_block`` consecutive
    requests: rank r goes to block r mod blocks, serpentine, so every
    block holds values from the whole distribution, then each block is
    shuffled by the seed. The seed reorders requests inside a block and
    never moves work between blocks."""
    blocks = math.ceil(len(ranked) / per_block)
    out: List[List] = [[] for _ in range(blocks)]
    for r, value in enumerate(ranked):
        group, j = divmod(r, blocks)
        out[j if group % 2 == 0 else blocks - 1 - j].append(value)
    for block in out:
        rng.shuffle(block)
    return [v for block in out for v in block]


def requests(traffic: Dict, seed: int, pod: int,
             horizon_s: float) -> List[Request]:
    """Pod ``pod``'s requests over ``horizon_s`` seconds, by due time."""
    arrivals = traffic["arrivals"]
    rate = float(arrivals["rate_per_pod"])
    n = max(1, math.ceil(rate * horizon_s))
    qs = _quantiles(n)
    rng = random.Random(derive_seed(seed, pod, "traffic"))
    per_block = max(1, round(rate * float(arrivals.get("block_s", horizon_s))))
    gaps = _spread([_gap(q, rate) for q in qs], per_block, rng)
    prompts = _spread([_length(q, traffic["prompt_tokens"]) for q in qs],
                      per_block, rng)
    outputs = _spread([_length(q, traffic["output_tokens"]) for q in qs],
                      per_block, rng)
    ids = traffic["token_ids"]
    draw = np.random.default_rng(derive_seed(seed, pod, "ids"))
    out, due = [], 0.0
    for i in range(n):
        due += gaps[i]
        prompt = draw.integers(ids["low"], ids["high"], prompts[i]).tolist()
        out.append(Request(pod, i, due, prompt, outputs[i]))
    return out


def train_batches(traffic: Dict, seed: int, pod: int, device):
    """An endless stream of [rows, seq_len + 1] id batches on ``device``,
    the same for the same seed and pod."""
    import torch

    from .weights import generator

    g = generator(device, seed, pod, "rows")
    ids = traffic["token_ids"]
    shape = (traffic["rows"], traffic["seq_len"] + 1)
    while True:
        yield torch.randint(ids["low"], ids["high"], shape, generator=g,
                            device=device)


def horizon(traffic: Dict, seconds: float) -> float:
    return traffic.get("preroll_s", 0.0) + seconds

