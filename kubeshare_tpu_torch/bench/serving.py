"""Serving bench: BASELINE config 5 on one CUDA device (port of
``bench_serving.py``): KV-cache Llama decode, 4 co-located 0.25-device
pods against whole-device allocation.

    python -m kubeshare_tpu_torch.bench.serving [--int8]

prints one JSON line. Each pod has its own weights (``torch.Generator``
seed 7 + i) and serves 8 sequences with its own greedy decode step on a
scalar cache (``PodDecode``), captured as a CUDA graph where the
reference jits ``make_decode``. Serving is request-gapped: bursts of
decode steps separated by an idle wait of 2.5 x the burst (the arrival
gaps fractional sharing monetises). A burst is at least 16 tokens and
4 ms of decode, at most ``max_seq_len - 2`` tokens, calibrated once on
pod 0; the cache's length goes back to 0 at every burst, so a phase
never runs past ``max_seq_len``. Every burst ends with a host fetch of
its tokens (``runtime/hook.py::fetch_drain``: tokens stream to
clients), inside the token hold when gated.

Three phases a round, each ``PHASE_SECONDS`` long: solo (one pod:
whole-device allocation runs the pods one at a time, so its aggregate
is one pod's), ungated (the four at once) and gated (the four under a
live ``tpu-schd``, ``ConfigEntry(f"serve/pod-{i}", 1.0, 0.25, 0)``
each). The round reported is the median by gated / solo. Each pod is a
thread with its own CUDA stream (``bench/headline.py``'s pods).

``run(quant=True)`` (``--int8``) serves weight-only int8 pods
(``models/quant.py``), where the reference reads
``KUBESHARE_BENCH_QUANT=1``: decode re-reads every weight each token.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..models.graph import Replay, restoring
from ..models.llama import (
    Llama, LlamaConfig, init_kv_cache, init_llama, llama_apply_cached,
)
from ..models.quant import quantize_llama
from ..runtime.hook import fetch_drain
from ..utils.device import DeviceLike, resolve_device
from .arbiter import p99
from .headline import (
    BUSY_METHOD, Pod, busy_shares, card_line, log, median_round, run_rounds,
    step_seconds,
)

PODS = 4
FRACTION = 0.25             # each pod's tpu-schd request
BATCH = 8                   # concurrent sequences per pod
TOKENS_PER_BURST = 16       # floor; raised to >= MIN_BURST_MS
MIN_BURST_MS = 4.0
STALL_FACTOR = 2.5          # request-arrival gap = 2.5 x device burst
CALIBRATION_STEPS = TOKENS_PER_BURST * 4
PHASE_SECONDS = 6.0
ROUNDS = 3
SEED = 7

CFG = LlamaConfig(
    vocab=2048, dim=256, layers=4, num_heads=8, num_kv_heads=4,
    mlp_dim=512, max_seq_len=512,
)


class PodDecode:
    """One pod's decode: greedy, ``BATCH`` sequences on a scalar cache
    (``bench_serving.make_decode``'s jitted step). ``decode()`` is one
    step, eager: it feeds ``tokens``, writes their successors back into
    them and returns the step's [BATCH, vocab] logits. ``step()`` runs
    it, captured as a CUDA graph at its first call and replayed on a
    CUDA model (``models/graph.py``), and returns ``tokens``; ``logits``
    holds the last step's logits."""

    def __init__(self, model: Llama):
        self.model = model
        self.cache = cache = init_kv_cache(model.cfg, BATCH,
                                           device=model.device)
        self.tokens = tokens = torch.zeros(BATCH, dtype=torch.int64,
                                           device=model.device)

        def decode() -> torch.Tensor:
            logits, _ = llama_apply_cached(model, tokens[:, None], cache)
            tokens.copy_(torch.argmax(logits[:, -1], dim=-1))
            return logits[:, -1]

        self.decode = decode
        # the warm-up's K/V write lands at the cache's length, where the
        # first replay writes before anything reads it
        self._decode_step = Replay(
            decode, restoring(decode, [cache["length"], tokens]),
            graphed=model.device.type == "cuda")

    @property
    def logits(self) -> Optional[torch.Tensor]:
        return self._decode_step.output

    def step(self) -> torch.Tensor:
        self._decode_step()
        return self.tokens

    def rewind(self) -> None:
        """Back to an empty cache; the tokens carry on (the reference's
        per-burst ``cache = dict(cache, length=base_len)``)."""
        self.cache["length"].fill_(0)

    def restart(self) -> None:
        """An empty cache and zero tokens: a new stream."""
        self.rewind()
        self.tokens.zero_()


def make_pods(quant: bool, device: torch.device
              ) -> Tuple[List[Pod], List[PodDecode]]:
    """``PODS`` pods and their decodes, pod i's weights from ``Generator`` seed ``SEED +
    i`` (int8 with ``quant``), each on a CUDA stream of its own on the
    card. Each pod's first step runs on its stream: that captures its
    graph there, before any pod's thread starts."""
    team, decodes = [], []
    for i in range(PODS):
        model = init_llama(CFG, generator=torch.Generator(
            device=device).manual_seed(SEED + i), device=device)
        decode = PodDecode(quantize_llama(model) if quant else model)
        pod = Pod(f"serve/pod-{i}", decode.step, (),
                  torch.cuda.Stream(device) if device.type == "cuda"
                  else None, drain=fetch_drain, rewind=decode.rewind)
        step_seconds(pod, 1)
        team.append(pod)
        decodes.append(decode)
    return team, decodes


def calibrate(pod: Pod, decode: PodDecode) -> float:
    """Seconds a decode step: the median of 3 runs of
    ``CALIBRATION_STEPS`` steps from an empty cache, each ending in a
    host fetch."""
    samples = []
    for _ in range(3):
        decode.restart()
        samples.append(step_seconds(pod, CALIBRATION_STEPS))
    return sorted(samples)[1]


def run(quant: bool = False, phase_seconds: float = PHASE_SECONDS,
        rounds: int = ROUNDS, device: DeviceLike = None) -> Dict:
    """The serving bench (module docstring); returns its result doc."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    team, decodes = make_pods(quant, device)
    step_s = calibrate(team[0], decodes[0])
    burst = max(TOKENS_PER_BURST, int(MIN_BURST_MS / 1e3 / step_s + 0.5))
    burst = min(burst, CFG.max_seq_len - 2)
    stall_s = STALL_FACTOR * burst * step_s
    log(f"decode step {step_s * 1e6:.0f} us x {BATCH} seqs; burst {burst} "
        f"tokens; arrival gap {stall_s * 1e3:.2f} ms "
        f"(duty {1 / (1 + STALL_FACTOR):.0%})"
        + (" [weight-only int8]" if quant else ""))

    def restart_all() -> None:      # every stream starts anew
        for decode in decodes:
            decode.restart()

    results, usage = run_rounds(
        team, "serve-chip", FRACTION, rounds, phase_seconds,
        lambda: (step_s, burst, stall_s), BATCH, unit="tokens/s",
        before_phase=restart_all)

    mid = median_round(results)
    gated = mid["gated"]
    pod_p99s = [p99(lat) * 1e3 for lat in gated["latencies"] if lat]
    per_pod_vs_solo = [n * BATCH / gated["elapsed"]
                       / mid["solo"]["samples_per_s"]
                       for n in gated["steps"]]
    return {
        "metric": "aggregate decode tokens/sec, 4 co-located 0.25-device "
                  "KV-cache Llama pods vs whole-device allocation"
                  + (" (weight-only int8)" if quant else ""),
        "weights": "int8" if quant else CFG.dtype,
        "value": gated["samples_per_s"],
        "unit": "tokens/sec",
        "vs_baseline": mid["ratio"],
        "ungated_value": mid["ungated"]["samples_per_s"],
        "isolation_overhead": max(0.0, 1.0 - mid["gated_vs_ungated"]),
        "isolation_overhead_worst_round": max(
            max(0.0, 1.0 - r["gated_vs_ungated"]) for r in results),
        "per_pod_vs_solo_min": min(per_pod_vs_solo),
        "per_pod_vs_solo_max": max(per_pod_vs_solo),
        "p99_token_latency_ms_min": min(pod_p99s),
        "p99_token_latency_ms_max": max(pod_p99s),
        "isolated": True,
        "decode_step_ms": 1e3 * step_s,
        "burst": burst,
        "stall_ms": 1e3 * stall_s,
        "busy_share": busy_shares(mid),
        "busy_share_method": BUSY_METHOD if cuda else None,
        "solo_value": mid["solo"]["samples_per_s"],
        "rounds": len(results),
        "phase_s": phase_seconds,
        "tokens_acquired": {p.name: p.gate.tokens_acquired for p in team},
        "arbiter_window_usage_ms": usage,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "card": card_line() if cuda else None,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--int8", action="store_true",
                        help="weight-only int8 pods (models/quant.py)")
    args = parser.parse_args(argv)
    print(json.dumps(run(quant=args.int8)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
