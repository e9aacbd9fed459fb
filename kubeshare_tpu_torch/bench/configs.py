"""BASELINE configs 3 and 4 and the continuous-batching bench on one
CUDA device (port of ``bench_configs.py``'s ``run_lstm_gang``,
``run_resnet_dp`` and ``run_contbatch``).

    python -m kubeshare_tpu_torch.bench.configs {lstm|resnet|contbatch|gang-gate}

prints one JSON line. ``gang-gate`` runs a 4-member gang of MNIST pods
of the workload CLI on the card, ungated and then each member gated
before one ``tpu-schd`` of 2 lease slots (``run_gang_gate``).

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

``resnet``, config 4 (the reference's 8 x 1.0-device data-parallel
ResNet job): the unit pod, ResNet-18 (``ResNetConfig(num_classes=10)``)
at batch 32 on CIFAR-size images, exclusive, Adam at lr 1e-3, its step
a CUDA graph on the card, back-to-back steps in chunks of 4 that end in
a host fetch of the loss: samples/s per card (median round) and the p99
of a chunk's step time. Then the dp = 8 overhead leg: 8 rank processes
on the one card (``parallel/launch.py``; ranks that share a card run on
gloo), each at batch 32 of one global batch of 256 through
``parallel.make_sharded_train_step`` (AdamW), against the same global
batch through the same step in one process. Both legs start from the
same weights and data, so their first-step losses must agree; the
overhead is the dp = 8 step time over the one-process step time, less
one. Where the reference ran its dp leg on an 8-device host mesh (one
chip on its box), this one shares the card among 8 processes, the
fractional gang's case.

``small=True`` runs the reference's CPU sizes (``bench_configs._SMALL``)
for the tests.
"""

from __future__ import annotations

import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.common import cross_entropy_loss
from ..models.llama import LlamaConfig, init_llama
from ..models.lstm import Lstm, LstmConfig, init_lstm, lstm_apply
from ..models.resnet import ResNet, ResNetConfig, init_resnet, resnet_apply
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

# config 4 (the reference's test/distribute DP jobs: 8 whole-device
# pods at batch 32 each)
DP_PODS = 8
RESNET_BATCH = 32
RESNET_SEED = 4
DP_STEPS = 5                # timed steps of each dp leg, after one

# the reference's CPU sizes (bench_configs._SMALL)
SMALL_LSTM = LstmConfig(vocab=1024, dim=64, hidden=128, layers=1)
SMALL_LSTM_BATCH = 8
SMALL_LSTM_SEQ = 16
SMALL_LLAMA = LlamaConfig(vocab=512, dim=128, layers=2, num_heads=4,
                          num_kv_heads=2, mlp_dim=256, max_seq_len=128)
SMALL_MAX_NEW = 48
SMALL_RESNET = ResNetConfig(num_classes=10, stage_sizes=(1, 1, 1, 1),
                            width=16)
SMALL_RESNET_BATCH = 4


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


# ---- config 4: data-parallel ResNet ---------------------------------


def resnet_loss(model: ResNet, images: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of the float32 logits, as the reference's."""
    return F.cross_entropy(resnet_apply(model, images).float(), labels)


def resnet_data(small: bool, rows: int, device: torch.device):
    """(model, images [rows, 3, 32, 32], labels [rows]) from
    ``RESNET_SEED``: ResNet-18 for 10 classes, or the small one."""
    cfg = SMALL_RESNET if small else ResNetConfig(num_classes=10)
    gen = torch.Generator(device=device).manual_seed(RESNET_SEED)
    model = init_resnet(cfg, generator=gen, device=device)
    images = torch.randn(rows, 3, 32, 32, generator=gen, device=device)
    labels = torch.randint(0, 10, (rows,), generator=gen, device=device)
    return model, images, labels


def _dp_leg(joined, small: bool, batch: int, steps: int,
            device: Optional[torch.device] = None) -> Dict:
    """One rank of a dp leg (or the whole one-process leg with
    ``joined=None``): the global batch of ``batch`` rows a rank, one
    first step, then ``steps`` steps timed on the host clock (each ends
    in the world's all-reduce, so the slowest rank sets the time).
    ``device`` is the one-process leg's."""
    from ..parallel import MeshPlan, comm, make_mesh, make_sharded_train_step

    world = 1 if joined is None else joined.world
    device = device if joined is None else joined.device
    model, images, labels = resnet_data(small, batch * world, device)
    mesh = make_mesh(MeshPlan(dp=world))
    step, model, _ = make_sharded_train_step(resnet_loss, model, mesh,
                                             learning_rate=LR, fsdp=False)
    first = float(step(images, labels))
    comm.reset_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(images, labels)
    last = float(loss)
    step_s = (time.perf_counter() - t0) / steps
    return {"first_loss": first, "last_loss": last, "step_ms": 1e3 * step_s,
            "comm": comm.stats(),
            "backend": None if joined is None else joined.backend,
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None)}


def run_resnet_dp(phase_seconds: float = PHASE_SECONDS, rounds: int = ROUNDS,
                  device: DeviceLike = None, small: bool = False,
                  dp_steps: int = DP_STEPS) -> Dict:
    """BASELINE config 4 (module docstring); returns its result doc."""
    from ..parallel.launch import run_world

    device = resolve_device(device)
    cuda = device.type == "cuda"
    batch = SMALL_RESNET_BATCH if small else RESNET_BATCH
    model, images, labels = resnet_data(small, batch, device)
    _, step = make_train_step(resnet_loss, model, LR, cuda_graph=cuda)
    fetch_drain(step(images, labels))       # on the card: the capture
    # the unit pod is EXCLUSIVE (request 1.0): back-to-back steps, no
    # gap, no arbiter: samples/s per card and p99
    rates, lats = [], []
    for r in range(rounds):
        deadline = time.perf_counter() + phase_seconds
        steps = 0
        t_start = time.perf_counter()
        while time.perf_counter() < deadline:
            t0 = time.perf_counter()
            for _ in range(4):
                loss = step(images, labels)
            fetch_drain(loss)
            lats.append((time.perf_counter() - t0) / 4)
            steps += 4
        rates.append(steps * batch / (time.perf_counter() - t_start))
        log(f"round {r}: {rates[-1]:,.0f} samples/s per card")
    per_card = sorted(rates)[len(rates) // 2]
    del model, step, images, labels

    log(f"dp={DP_PODS} overhead leg: {DP_PODS} ranks on the card against "
        "one process at the same global batch")
    single = _dp_leg(None, small, batch * DP_PODS, dp_steps, device)
    ranks = run_world(_dp_leg, DP_PODS, args=(small, batch, dp_steps),
                      timeout=600, device_type=device.type)
    dp = ranks[0]
    rel = abs(dp["first_loss"] - single["first_loss"]) / max(
        1e-9, abs(single["first_loss"]))
    doc = {
        "metric": "per-device ResNet-18 train samples/sec, the unit pod "
                  "of the 8 x 1.0-device DP job (BASELINE config 4); "
                  "whole-device pods are exclusive so there is no "
                  "co-location leg",
        "value": per_card,
        "unit": "samples/sec",
        "vs_baseline": 1.0,
        "p99_step_latency_ms": 1e3 * p99(lats),
        "dp_pods": DP_PODS,
        "rounds": rounds,
        "phase_s": phase_seconds,
        "dp8_step_ms": dp["step_ms"],
        "single_process_step_ms": single["step_ms"],
        "dp8_overhead": dp["step_ms"] / single["step_ms"] - 1.0,
        "dp8_first_loss": dp["first_loss"],
        "single_first_loss": single["first_loss"],
        "dp8_vs_single_loss_rel_err": rel,
        "dp8_last_loss": [r["last_loss"] for r in ranks],
        "dp8_backend": dp["backend"],
        "dp8_comm": dp["comm"],
        "dp8_peak_bytes_per_rank": [r["peak_bytes"] for r in ranks],
        **_result_line(cuda, device),
    }
    log(f"resnet: {per_card:,.0f} samples/s per card; dp8 step "
        f"{dp['step_ms']:.1f} ms against {single['step_ms']:.1f} ms in one "
        f"process ({dp['backend']})")
    return doc


# ---- a gang of workload CLI processes on one card --------------------


GANG_LOG = re.compile(r"rank (\d+)/(\d+) \((\w+), ([\w:]+)\)")
GANG_STEP_LOG = re.compile(r"step (\d+): (at the gate|stepping)")


def _member_report(out: str, err: str) -> Dict:
    """What one member's output says: its JSON line (None without one),
    the backend and device it joined with (None before joining), the
    step its log last reached and whether it was at the gate or inside
    the step there (None when it logged no step), and its last log
    line."""
    lines = out.strip().splitlines()
    try:
        doc = json.loads(lines[-1]) if lines else None
    except ValueError:
        doc = None
    match = GANG_LOG.search(err)
    steps = GANG_STEP_LOG.findall(err)
    log_lines = [line for line in err.splitlines() if line.strip()]
    return {"doc": doc, "joined": list(match.group(3, 4)) if match else None,
            "last_step": ({"step": int(steps[-1][0]), "where": steps[-1][1]}
                          if steps else None),
            "last_log": log_lines[-1][-300:] if log_lines else None}


def run_cli_gang(argv: Sequence[str], members: int = 2,
                 timeout: float = 300.0,
                 pod_ports: Optional[Sequence[int]] = None) -> Dict:
    """Run ``python -m kubeshare_tpu_torch.cmd.workload *argv`` as a
    ``members``-process gang on this host (the gang env: a coordinator
    at a free ``127.0.0.1`` port, the process count and each member's
    id); member i talks to the pod manager on ``pod_ports[i]`` when
    given (its gate), else runs ungated. Returns the outcome ("exit
    codes [...]" or "no end within <timeout> s", when every member is
    killed), the seconds, and for each member what its output says
    (``_member_report``; killed members' too), with the JSON lines
    (``docs``) and the joins (``joined``) apart. Pass ``--level 2`` in
    ``argv`` for the per-step lines."""
    from ..constants import (
        ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_POD_MANAGER_PORT,
        ENV_POD_NAME, ENV_PROCESS_ID,
    )
    from .arbiter import free_port

    coordinator = f"127.0.0.1:{free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for i in range(members):
        env = {k: v for k, v in os.environ.items()
               if k not in (ENV_POD_MANAGER_PORT, ENV_POD_NAME)}
        env.update({ENV_COORDINATOR: coordinator,
                    ENV_NUM_PROCESSES: str(members),
                    ENV_PROCESS_ID: str(i)})
        if pod_ports is not None:
            env[ENV_POD_MANAGER_PORT] = str(pod_ports[i])
            env[ENV_POD_NAME] = f"gang/member-{i}"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeshare_tpu_torch.cmd.workload",
             *argv], cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    t0 = time.perf_counter()
    outs: List[Optional[Tuple[str, str]]] = [None] * members
    outcome = None
    try:
        for i, proc in enumerate(procs):
            left = max(0.1, timeout - (time.perf_counter() - t0))
            outs[i] = proc.communicate(timeout=left)
    except subprocess.TimeoutExpired:
        outcome = f"no end within {timeout} s"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        # a killed member's output up to its end (communicate keeps what
        # an earlier, timed-out call read)
        for i, proc in enumerate(procs):
            if outs[i] is None:
                outs[i] = proc.communicate()
    seconds = time.perf_counter() - t0
    reports = [_member_report(out, err) for out, err in outs]
    return {"outcome": outcome or
            f"exit codes {[proc.returncode for proc in procs]}",
            "ok": outcome is None and all(p.returncode == 0 for p in procs),
            "seconds": seconds, "members": reports,
            "docs": [r["doc"] for r in reports],
            "joined": [r["joined"] for r in reports],
            "stderr_tail": [err[-600:] for _, err in outs
                            if err and "Traceback" in err]}


def run_gang_gate(members: int = 4, slots: int = 2,
                  argv: Sequence[str] = ("--model", "mnist", "--steps", "50",
                                         "--level", "2"),
                  timeout: float = 60.0) -> Dict:
    """A multi-pod gang on one card, each member a fractional pod
    (request ``1 / members``) with its own ``tpu-pmgr`` before one live
    ``tpu-schd`` of ``slots`` lease slots, against the same gang
    ungated. A member holds its lease while its step waits in the
    gradient all-reduce for the others, so with fewer slots than
    members the gang can wait on itself: the outcome says whether it
    ended within ``timeout`` seconds, and each member's report where
    its log stopped (``run_cli_gang``). ``lease_holders`` are the
    members last seen inside a step, which they enter only with a
    lease (the arbiter's STAT reports window usage, not holders);
    ``window_usage_ms`` is each pod's usage at the arbiter after the
    gated run."""
    from ..nodeconfig.files import ConfigEntry
    from ..runtime.client import TokenClient
    from .arbiter import (
        free_port, start_arbiter, start_pod_manager, stop_arbiter,
    )

    pods = [f"gang/member-{i}" for i in range(members)]
    out = {"members": members, "slots": slots, "argv": list(argv),
           "ungated": run_cli_gang(argv, members, timeout)}
    arbiter_port = free_port()
    ports = [free_port() for _ in pods]
    with tempfile.TemporaryDirectory() as base:
        procs = [start_arbiter(base, "card",
                               [ConfigEntry(pod, 1.0, 1.0 / members, 0)
                                for pod in pods], arbiter_port,
                               slots=slots)]
        try:
            for pod, port in zip(pods, ports):
                procs.append(start_pod_manager(pod, port, arbiter_port))
            out["gated"] = run_cli_gang(argv, members, timeout, ports)
            out["lease_holders"] = [
                pod for pod, member in zip(pods, out["gated"]["members"])
                if (member["last_step"] or {}).get("where") == "stepping"]
            with TokenClient("127.0.0.1", arbiter_port) as client:
                out["window_usage_ms"] = {
                    s.pod: s.window_usage_ms for s in client.stats()}
        finally:
            for proc in procs:
                stop_arbiter(proc)
    return out


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
        print(json.dumps(run_resnet_dp()), flush=True)
    elif which[0] == "gang-gate":
        print(json.dumps(run_gang_gate()), flush=True)
    else:
        print(f"usage: python -m kubeshare_tpu_torch.bench.configs "
              f"{{lstm|resnet|contbatch|gang-gate}} (got {which[0]!r})",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
