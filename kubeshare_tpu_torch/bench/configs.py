"""BASELINE config 3 and the continuous-batching bench on one CUDA
device (port of ``bench_configs.py``'s ``run_lstm_gang`` and
``run_contbatch``).

    python -m kubeshare_tpu_torch.bench.configs {lstm|contbatch}

prints one JSON line. ``resnet`` (BASELINE config 4) stops: its dp=8
half needs the parallel slice (ROADMAP Queue 1 item 5).

``lstm``, config 3 (the reference's gang-scheduled LSTM job: headcount
5, threshold 0.2): five co-located 0.2-device LSTM training pods
(``LstmConfig()``: vocab 8192, dim 256, hidden 512, 2 layers; a fixed
batch of 32 x 33 tokens, Adam at lr 1e-3, the step a CUDA graph of
``make_train_step(cuda_graph=True)``) against whole-device allocation.
The 0.2 fraction is the duty: the stall is 4 x the burst, a burst at
least 4 steps and 4 ms, so five pods subscribe the card exactly. All
five threads start behind one barrier (the gang's all-or-nothing
start), and each gated pod holds tokens of a live ``tpu-schd``
(``ConfigEntry(f"gang/pod-{i}", 1.0, 0.2, 0)``). Phases and rounds as
in ``bench/headline.py``; every burst ends with a host fetch of the
loss.

``contbatch``: an 8-slot ``DecodeServer`` (its decode step a CUDA
graph) on the serving bench's Llama, prompt buckets 16 and 64, 160 new
tokens a tenant, under Poisson prompt arrivals at 0.9 of the pool's
capacity (a tenant lives ``max_new`` decode steps), prompts of 4-60
tokens from ``random.Random(9)``. It reports tokens/s over the measured
elapsed time, admissions, rejections, the decode step, mean slot
occupancy and the time to first token (admission's prefill, eager, and
the first sample). Open loop: arrivals come on their schedule whatever
the server does.

``small=True`` runs the reference's CPU sizes (``bench_configs._SMALL``)
for the tests.
"""

from __future__ import annotations

import json
import random
import sys
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ..models.common import cross_entropy_loss
from ..models.llama import LlamaConfig, init_llama
from ..models.lstm import Lstm, LstmConfig, init_lstm, lstm_apply
from ..models.serving import DecodeServer
from ..models.train import make_train_step
from ..runtime.hook import fetch_drain
from ..utils.device import DeviceLike, resolve_device
from .arbiter import p99
from .headline import (
    BUSY_METHOD, Pod, busy_shares, card_line, log, median_round, run_rounds,
    step_seconds,
)
from .serving import CFG as SERVING_CFG

PHASE_SECONDS = 5.0
ROUNDS = 3
MIN_BURST_MS = 4.0

# config 3 (the reference's test/job1.yaml: headcount 5, threshold 0.2)
GANG_PODS = 5
GANG_FRACTION = 0.2
GANG_BURST_STEPS = 4        # floor; raised to >= MIN_BURST_MS
LSTM_BATCH = 32
LSTM_SEQ = 32
LR = 1e-3

CONTBATCH_SLOTS = 8
PROMPT_BUCKETS = (16, 64)
MAX_NEW = 160
OFFERED_LOAD = 0.9          # of the pool's capacity
ARRIVAL_SEED = 9
LLAMA_SEED = 7

# the reference's CPU sizes (bench_configs._SMALL)
SMALL_LSTM = LstmConfig(vocab=1024, dim=64, hidden=128, layers=1)
SMALL_LSTM_BATCH = 8
SMALL_LSTM_SEQ = 16
SMALL_LLAMA = LlamaConfig(vocab=512, dim=128, layers=2, num_heads=4,
                          num_kv_heads=2, mlp_dim=256, max_seq_len=128)
SMALL_MAX_NEW = 48


def _result_line(cuda: bool, device: torch.device) -> Dict:
    return {"device": torch.cuda.get_device_name(device) if cuda else "cpu",
            "card": card_line() if cuda else None}


# ---- config 3: the LSTM gang -----------------------------------------


def lstm_loss(model: Lstm, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token loss of a [B, T + 1] batch, as ``_make_lstm_step``'s."""
    return cross_entropy_loss(lstm_apply(model, tokens[:, :-1]),
                              tokens[:, 1:])


def make_lstm_step(model: Lstm) -> Callable[[torch.Tensor], torch.Tensor]:
    """A gang pod's training step ``step(tokens) -> loss``: Adam at
    ``LR``, the whole step a CUDA graph on the card."""
    _, step = make_train_step(lstm_loss, model, LR, cuda_graph=True)
    return step


def lstm_pod(seed: int, device: torch.device, small: bool = False
             ) -> Tuple[Lstm, torch.Tensor]:
    """Pod ``seed``'s model and its fixed batch of tokens, both drawn
    from ``torch.Generator`` seed ``seed``."""
    cfg, batch, seq = ((SMALL_LSTM, SMALL_LSTM_BATCH, SMALL_LSTM_SEQ)
                       if small else (LstmConfig(), LSTM_BATCH, LSTM_SEQ))
    gen = torch.Generator(device=device).manual_seed(seed)
    model = init_lstm(cfg, generator=gen, device=device)
    tokens = torch.randint(0, cfg.vocab, (batch, seq + 1), generator=gen,
                           device=device)
    return model, tokens


def run_lstm_gang(phase_seconds: float = PHASE_SECONDS, rounds: int = ROUNDS,
                  device: DeviceLike = None, small: bool = False) -> Dict:
    """BASELINE config 3 (module docstring); returns its result doc."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    team: List[Pod] = []
    for i in range(GANG_PODS):
        model, tokens = lstm_pod(i, device, small)
        step = make_lstm_step(model)
        pod = Pod(f"gang/pod-{i}", step, (tokens,),
                  torch.cuda.Stream(device) if cuda else None,
                  drain=fetch_drain)
        step_seconds(pod, 1)        # on the card: captures the graph
        if cuda:
            pod.inputs = step.inputs
        team.append(pod)
    batch = team[0].inputs[0].shape[0]
    step_s = sorted(step_seconds(team[0], 8) for _ in range(3))[1]
    burst = max(GANG_BURST_STEPS, int(MIN_BURST_MS / 1e3 / step_s + 0.5))
    # duty cycle == the 0.2 fractional request: stall = 4 x device time
    stall_s = (1.0 - GANG_FRACTION) / GANG_FRACTION * burst * step_s
    log(f"train step {step_s * 1e6:.0f} us x batch {batch}; burst {burst} "
        f"steps; stall {stall_s * 1e3:.2f} ms (duty {GANG_FRACTION:.0%})")

    results, usage = run_rounds(
        team, "gang-chip", GANG_FRACTION, rounds, phase_seconds,
        lambda: (step_s, burst, stall_s), batch, barrier=True)

    mid = median_round(results)
    pod_p99s = [p99(lat) * 1e3 for lat in mid["gated"]["latencies"] if lat]
    return {
        "metric": "aggregate train samples/sec, 5 co-located 0.2-device "
                  "LSTM gang pods vs whole-device allocation "
                  "(BASELINE config 3)",
        "value": mid["gated"]["samples_per_s"],
        "unit": "samples/sec",
        "vs_baseline": mid["ratio"],
        "ungated_value": mid["ungated"]["samples_per_s"],
        "isolation_overhead": max(0.0, 1.0 - mid["gated_vs_ungated"]),
        "isolation_overhead_worst_round": max(
            max(0.0, 1.0 - r["gated_vs_ungated"]) for r in results),
        "p99_step_latency_ms_min": min(pod_p99s),
        "p99_step_latency_ms_max": max(pod_p99s),
        "gang": {"headcount": GANG_PODS, "threshold": GANG_FRACTION},
        "rounds": len(results),
        "isolated": True,
        "train_step_ms": 1e3 * step_s,
        "burst": burst,
        "stall_ms": 1e3 * stall_s,
        "busy_share": busy_shares(mid),
        "busy_share_method": BUSY_METHOD if cuda else None,
        "solo_value": mid["solo"]["samples_per_s"],
        "phase_s": phase_seconds,
        "tokens_acquired": {p.name: p.gate.tokens_acquired for p in team},
        "arbiter_window_usage_ms": usage,
        "final_loss": [float(fetch_drain(p.step(*p.inputs))) for p in team],
        **_result_line(cuda, device),
    }


# ---- continuous batching ---------------------------------------------


def poisson_arrivals(rng: random.Random, vocab: int,
                     mean_gap: float) -> Iterator[Tuple[List[int], float]]:
    """Endless ``(prompt, gap)``: a prompt of 4-60 tokens in [2, vocab),
    then the exponential wait to the next arrival (drawn in the
    reference's order)."""
    while True:
        prompt = [rng.randrange(2, vocab)
                  for _ in range(rng.randint(4, 60))]
        yield prompt, rng.expovariate(1.0 / mean_gap)


def serve(server: DecodeServer,
          arrivals: Iterator[Tuple[Sequence[int], float]], seconds: float,
          clock: Callable[[], float] = time.perf_counter,
          sleep: Callable[[float], None] = time.sleep) -> Dict:
    """The bench's loop for ``seconds`` of ``clock``: admit every prompt
    whose arrival time has come (a full pool rejects it), then decode
    one step if a slot is active, else wait for the next arrival (at
    most 10 ms). Returns the counts, the time to each admission's first
    token and the occupancy at each step."""
    vocab = server.cfg.vocab
    tokens = admissions = rejected = out_of_vocab = 0
    ttft: List[float] = []
    occupancy: List[int] = []
    t_start = clock()
    deadline = t_start + seconds
    next_arrival = t_start
    while clock() < deadline:
        now = clock()
        while now >= next_arrival:
            prompt, gap = next(arrivals)
            t0 = clock()
            admitted = server.admit(prompt)
            if admitted is not None:
                ttft.append(clock() - t0)
                admissions += 1
                tokens += 1          # the admission's first token
                out_of_vocab += not 0 <= admitted[1] < vocab
            else:
                rejected += 1
            next_arrival += gap
        if any(server.active):
            occupancy.append(server.slots - server.free_slots())
            out = server.step()
            tokens += len(out)
            out_of_vocab += sum(not 0 <= t < vocab for t in out.values())
        else:
            sleep(max(0.0, min(next_arrival - now, 0.01)))
    # measured, not nominal: the last iteration runs past the deadline
    return {"tokens": tokens, "admissions": admissions, "rejected": rejected,
            "tokens_out_of_vocab": out_of_vocab, "ttft_s": ttft,
            "occupancy": occupancy, "elapsed_s": clock() - t_start}


def contbatch_server(model, small: bool = False) -> DecodeServer:
    """The bench's pool: 8 slots, buckets 16 and 64, ``MAX_NEW`` tokens
    a tenant (``SMALL_MAX_NEW`` at the CPU sizes)."""
    return DecodeServer(model, slots=CONTBATCH_SLOTS,
                        prompt_buckets=PROMPT_BUCKETS,
                        max_new=SMALL_MAX_NEW if small else MAX_NEW)


def run_contbatch(phase_seconds: float = PHASE_SECONDS, rounds: int = ROUNDS,
                  device: DeviceLike = None, small: bool = False) -> Dict:
    """The continuous-batching bench (module docstring), for
    ``phase_seconds * rounds`` seconds; returns its result doc."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    cfg = SMALL_LLAMA if small else SERVING_CFG
    model = init_llama(cfg, generator=torch.Generator(
        device=device).manual_seed(LLAMA_SEED), device=device)
    server = contbatch_server(model, small)
    slots = server.slots
    rng = random.Random(ARRIVAL_SEED)
    # every bucket's prefill (the small one FIRST: the pool must not be
    # full before both have run) and the decode step (captured on the
    # card), then the step timed on a full pool
    server.admit(list(range(2, 10)))
    for _ in range(slots - 1):
        server.admit(list(range(2, 40)))
    server.step()
    t0 = time.perf_counter()
    for _ in range(8):
        server.step()
    step_s = (time.perf_counter() - t0) / 8
    for slot in range(slots):
        if server.active[slot]:
            server.retire(slot)
    # a tenant lives ~max_new decode steps: arrivals at OFFERED_LOAD x
    # slots concurrent keep the pool busy without unbounded rejection
    lifetime = server.max_new * step_s
    mean_gap = lifetime / (slots * OFFERED_LOAD)
    log(f"decode step {step_s * 1e3:.2f} ms (full pool); tenant lifetime "
        f"~{lifetime * 1e3:.0f} ms; arrival gap {mean_gap * 1e3:.1f} ms")
    served = serve(server, poisson_arrivals(rng, cfg.vocab, mean_gap),
                phase_seconds * rounds)
    ttft = sorted(served["ttft_s"])
    doc = {
        "metric": "continuous-batching decode tokens/sec, 8-slot "
                  "DecodeServer under Poisson prompt arrivals "
                  "(staggered admissions mid-generation, one decode graph)",
        "value": served["tokens"] / served["elapsed_s"],
        "unit": "tokens/sec",
        "vs_baseline": 1.0,
        "admissions": served["admissions"],
        "rejected": served["rejected"],
        "decode_step_ms": 1e3 * step_s,
        "mean_slot_occupancy": (sum(served["occupancy"])
                                / max(1, len(served["occupancy"]))),
        "ttft_ms_p50": 1e3 * ttft[len(ttft) // 2] if ttft else None,
        "ttft_ms_p99": 1e3 * p99(ttft) if ttft else None,
        "slots": slots,
        "tokens": served["tokens"],
        "tokens_out_of_vocab": served["tokens_out_of_vocab"],
        "elapsed_s": served["elapsed_s"],
        "mean_arrival_gap_ms": 1e3 * mean_gap,
        **_result_line(cuda, device),
    }
    log(f"contbatch: {doc['value']:,.0f} tokens/s, {doc['admissions']} "
        f"admissions, occupancy {doc['mean_slot_occupancy']:.2f}/{slots}")
    return doc


def main(argv: Optional[Sequence[str]] = None) -> int:
    which = (list(argv) if argv is not None else sys.argv[1:]) or ["lstm"]
    if which[0] == "lstm":
        print(json.dumps(run_lstm_gang()), flush=True)
    elif which[0] == "contbatch":
        print(json.dumps(run_contbatch()), flush=True)
    elif which[0] == "resnet":
        raise SystemExit(
            "resnet (BASELINE config 4) needs the dp=8 data-parallel path, "
            "which is not ported yet (ROADMAP Queue 1 item 5)")
    else:
        print(f"usage: python -m kubeshare_tpu_torch.bench.configs "
              f"{{lstm|contbatch}} (got {which[0]!r})", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
