"""Drive kubeshare_tpu_torch's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failed check raises, so the script exits
nonzero and prints no result:

1. device: the card, torch/CUDA versions, the kernels' build (nvcc, at
   first use, from csrc/ in this checkout, both libraries at once).
2. kernel: the CUDA flash-attention forward against its plain PyTorch
   version on the card, out and lse, at the Llama-3-8B shape, at edge
   shapes and at head dim 32 (the workload CLI's Llama step, entry()'s
   forward, a ragged window); at the 8B shape and the two head-dim-32
   ones the kernel and SDPA timed in turns over several rounds.
3. forward: ``llama_apply`` at Llama-3-8B width (all 32 layers, random
   weights from the seed) on 2048 tokens; the flash kernel must launch
   once per layer; logits against the plain-attention forward.
4. serving: ``DecodeServer`` (8 slots, its decode step a CUDA graph)
   answers 12 prompts, with retirement and re-admission; prefill logits
   against ``llama_apply``; the same script on an eager server
   (``cuda_graph=False``) must give the same tokens, and both ms a step
   are printed; a slot's logits against a solo decode, eager and graphed.
5. sharing: two tenants' decode servers (graphed) under ``ChipExecutor``.
6. backward kernels: dq and dk/dv against their plain version on the
   card at phase 2's shapes (some with an lse cotangent), bit-identical
   on a second launch; at phase 2's timed shapes dq, dk/dv and SDPA's
   backward timed in turns; then at six shapes around it all three kernels
   against their bounds, and one whole ``flash_backward`` (delta' and
   both kernels) in turns with SDPA's backward.
7. training: ``llama_loss`` under ``make_train_step`` (Adam) at
   Llama-3-8B width, 4 layers, on [1, 2049] tokens: gradients against
   plain attention, kernel launches per step (also with remat, and at
   the ragged T = 2047), the vocab-chunked loss and lm-head gradient
   against the dense ones, five steps on one batch whose loss must
   fall.
8. a trainer and a server share the card under ``ChipExecutor``.
9. workloads: ``cmd/workload.main`` trains mnist, cifar, resnet, vgg,
   lstm and llama (head dim 32; also with ``--window 64`` and
   ``--remat``) at the CLI's defaults (batch 256, llama T = 255); the
   loss must be finite and fall (the lstm's uniform random tokens put it
   at its floor, ln 8192, from the first step: there it must stay), and
   each llama step must launch the three flash kernels once per layer
   (the forward twice with ``--remat``). A step breakdown of each.
   ResNet's logits on the card against the same weights on the CPU; a
   checkpointed run stopped and resumed against an uninterrupted one; a
   run under ``install_gate`` and a live ``tpu-schd`` must acquire
   tokens.
10. drain: two threads on two streams; one queues ~50 ms of sleep, the
    other's gate drain must return in well under that.
11. headline: ``bench/headline.py`` at its published sizes (8 MNIST
    pods, batch 1024, 3 rounds of 6 s phases) under a live
    ``tpu-schd``; every pod must acquire tokens.
12. entry: ``entry.entry()`` (the reference's flagship Llama, head dim
    32) on the card: the forward kernel launches once per layer and the
    logits agree with the same model's plain-attention forward.
13. kernel benches: ``bench/kernels.py`` at the reference's sizes with
    fewer rounds (BENCH_CUT), each function's seconds.
14. serving bench: ``bench/serving.py`` (BASELINE config 5: 4 graphed
    decode pods under a live ``tpu-schd``), bf16 and int8, one round of
    shorter phases (POD_BENCH_CUT); every pod must acquire tokens. Where
    a pod's decode step goes, graphed and eager.
15. contbatch: ``bench/configs.py``'s continuous-batching bench (Poisson
    arrivals into a graphed 8-slot server), shorter; admissions > 0 and
    every token in the vocabulary.
16. lstm gang: ``bench/configs.py`` (BASELINE config 3: 5 graphed LSTM
    training pods behind one barrier under ``tpu-schd``), one round of
    shorter phases; every pod must acquire tokens, the losses finite.
    Where a pod's step goes, graphed and eager.
17. node: the node side of a shared card (``bench/node.py``). The CUDA
    interposer built with g++, and once more against the real
    ``<cuda.h>`` (its ``static_assert``s); the NVML inventory (row 0's
    uuid is torch's, its memory NVML's total and within 1 % of torch's,
    the collector's ``/metrics`` scraped back); then ``NodeConfigDaemon``
    -> ``NodeLauncher`` (``tpu-schd`` + a ``tpu-pmgr`` per pod) -> two
    unmodified PyTorch pods under the interposer (Llama head dim 32
    eager, the MNIST graph): both must acquire tokens and be charged
    memory, ``pod-b`` must get ``torch.cuda.OutOfMemoryError`` past its
    6 GiB cap and carry on, the interposer must count the flash kernels
    (>= 4 launches) and ``cuGraphLaunch``, and the launcher's ``/metrics``
    must show both pods. Then one pod alone without the interposer, under
    it passing through, and gated: step ms, printed, not enforced.

Then each phase's seconds, the ``{"kernels": [...]}`` line, and as the
last line ``{"ok": true, "device": {...}}``. Needs one CUDA device, and
g++ for ``tpu-schd``, ``tpu-pmgr`` and the interposer (each is built
when missing).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# Published peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 on the
# tensor cores, float32 on the CUDA cores, and the HBM3 rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Tolerances of the kernel against its plain version on the same card.
# float32: both accumulate exact products in float32 and differ only in
# summation order. bf16: P is rounded to bf16 before the PV product and
# the output to bf16 at the end; a summation-order difference can flip
# either rounding by one bf16 ulp (7.8e-3 for |out| < 2), so out is held
# to 2e-2 (about 2.5 ulps); lse is float32 in both.
TOL = {"float32": {"out": 1e-5, "lse": 1e-5},
       "bfloat16": {"out": 2e-2, "lse": 1e-4}}
# The backward kernels against their plain version, on each of dq, dk and
# dv: max abs difference over that gradient's max abs. float32: exact
# float32 products summed in another order (and ex2-free expf), a few
# float32 ulps of the largest entry. bf16: P and dS are rounded to bf16
# before their products and the gradients at the end; a summation-order
# difference in S or dP can flip one of those roundings by one bf16 ulp
# (2^-8 relative), so 2e-2 is about five ulps of the largest entry.
BWD_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Training at 8B width (bf16 activations, float32 master weights): each
# gradient tensor with the flash kernels against the same step through
# plain attention, max abs difference over its max abs; the two paths
# round attention differently, as for the logits.
GRAD_REL_TOL = 5e-2
# The vocab-chunked loss against the dense loss on the same weights: the
# dense path rounds each logit to bf16 (2^-9 relative, errors of either
# sign) before the float32 softmax, the chunked path keeps them float32;
# averaged over 2048 rows that moves a loss of ~ln(vocab) by ~1e-6 of
# its value. 1e-5 leaves room for that and fails a tile counted twice
# (the clamped last tile's 2816 overlap columns add ~1.8e-3).
CHUNKED_REL_TOL = 1e-5
# The lm head's gradient from the chunked loss against the dense one,
# max abs difference over its max abs: P = exp(logit - logz) moves by up
# to ~2^-8 relative where the dense logit was rounded to bf16, and both
# round the gradient to bf16 at the end (2^-9).
CHUNKED_GRAD_REL_TOL = 2e-2
# Logits of the 8B forward (bf16 weights and activations) with the flash
# kernel against plain attention, and of a cached prefill against
# llama_apply: max abs difference over the max abs logit. The two paths
# round attention differently (the flash kernel normalises after the PV
# product, the plain path before casting P), a bf16 ulp per element
# (2^-8 relative) that 32 layers carry into the logits.
LOGIT_REL_TOL = 5e-2
# ResNet-18's logits on the card against the same weights on the CPU, max
# abs difference over the max abs: bf16 products in another order on
# each side, the tolerance tests/test_torch_vision.py holds the port to
# against the reference.
RESNET_REL_TOL = 5e-2
# A checkpointed, stopped and resumed MNIST run against an uninterrupted
# one, the final bf16 loss: the same batches and steps, but cuDNN's
# backward may sum in another order between runs; a bf16 loss of ~2.3
# has an ulp of 2^-6 = 0.0156 (0.7 %), so 2e-2 is about three ulps.
RESUME_REL_TOL = 2e-2
# Steps of each workload in phase 9, at the CLI's defaults otherwise.
WORKLOAD_STEPS = 30
# Phase 13 runs bench/kernels.py at the reference's sizes with fewer
# rounds (the reference's in the comments) to stay within ~90 s; the
# gate's A/B keeps its 8 rounds of 4 steps.
BENCH_CUT = {"flash_rounds": 3,   # 6
             "xent_rounds": 2,    # 4
             "swa_rounds": 2,     # 4
             "mfu_steps": 4}      # 2 windows of 6
# Phases 14-16 run bench/serving.py and bench/configs.py at the
# reference's sizes with one round of shorter phases (the reference's in
# the comments), about a minute together.
POD_BENCH_CUT = {"serving_phase_s": 3.0,   # 6, 3 rounds
                 "contbatch_s": 6.0,       # 15 (3 rounds of 5)
                 "gang_phase_s": 3.0}      # 5, 3 rounds
# ~50 ms of sleep on the card at the H100's 1.98 GHz boost (phase 10),
# and the most the other stream's drain may take.
DRAIN_SLEEP_CYCLES = 100_000_000
DRAIN_MAX_MS = 10.0


def visible_pairs(t_q: int, t_k: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    if not causal:
        return t_q * t_k
    total = 0
    for i in range(t_q):
        pos = i + t_k - t_q
        total += min(pos + 1, window) if window > 0 else pos + 1
    return total


# Per flash kernel: (operations per visible pair and head dim, tensors of
# q's size read and written, tensors of k's size read and written,
# float32 rows [B, H, Tq] read and written). fwd: Q K^T and P V; reads
# q, k, v; writes out and lse. bwd_dq: Q K^T, dO V^T, dS K; reads q, dO,
# k, v, lse, delta'; writes dq. bwd_dkv: Q K^T, dO V^T, P^T dO, dS^T Q;
# reads the same; writes dk and dv.
FLASH_WORK = {"fwd": (4, 2, 2, 1), "bwd_dq": (6, 3, 2, 2),
              "bwd_dkv": (8, 2, 4, 2)}


def flash_bound_ms(shape, dtype_name: str, causal: bool, window: int,
                   kind: str = "fwd"):
    """Least time for one flash kernel of ``kind`` (FLASH_WORK) on an
    H100: each input read once and each output written once at the HBM
    rate, against its products' operations at the peak rate of the input
    type."""
    batch, heads, kv_heads, t_q, t_k, head_dim = shape
    per_pair, q_like, k_like, rows = FLASH_WORK[kind]
    elem = 2 if dtype_name == "bfloat16" else 4
    n_bytes = elem * head_dim * (q_like * batch * heads * t_q
                                 + k_like * batch * kv_heads * t_k)
    n_bytes += 4 * rows * batch * heads * t_q
    ops = per_pair * batch * heads * head_dim * visible_pairs(
        t_q, t_k, causal, window)
    t_bytes, t_ops = n_bytes / PEAK_BYTES, ops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import dataclasses
    import importlib

    import numpy as np
    import torch.nn.functional as F

    from kubeshare_tpu_torch.models.llama import (
        init_kv_cache, init_llama, llama3_8b, llama_apply,
        llama_apply_cached, llama_loss, prefill_slot,
    )
    from kubeshare_tpu_torch.models.serving import DecodeServer
    from kubeshare_tpu_torch.bench import configs as pod_configs
    from kubeshare_tpu_torch.bench import kernels as bench_kernels
    from kubeshare_tpu_torch.bench import serving as pod_serving
    from kubeshare_tpu_torch.models.train import make_train_step
    from kubeshare_tpu_torch.ops import _build
    from kubeshare_tpu_torch.ops.attention import (
        LAUNCHES, flash_attention_reference, flash_backward,
        flash_backward_reference, flash_forward,
    )
    from kubeshare_tpu_torch.runtime.executor import ChipExecutor
    from kubeshare_tpu_torch.utils.device import resolve_device

    # the module, not the ``attention`` function its package re-exports
    attn = importlib.import_module("kubeshare_tpu_torch.ops.attention")
    device = resolve_device(None)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    phase_started = {}

    def mark(name: str) -> None:
        phase_started[name] = time.perf_counter()

    # ---- 1. device -----------------------------------------------------
    mark("1_device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    libraries = ("flash_fwd", "flash_bwd")
    with ThreadPoolExecutor(len(libraries)) as pool:   # one nvcc each
        list(pool.map(_build.build, libraries))
    for name in libraries:
        _build.load(name)
    build_s = time.perf_counter() - t0
    # registers and spills of each kernel instance, from nvcc -Xptxas -v
    ptxas = {name: [line.split(":", 1)[-1].strip()
                    for line in _build.BUILD_LOG.get(name, "").splitlines()
                    if any(w in line
                           for w in ("entry function", "Used", "spill"))]
             for name in libraries}
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "ptxas": ptxas})

    def cuda_ms(fn, reps: int, warmup: int = 3, batches: int = 3) -> float:
        """Device ms per call of ``fn``: CUDA events around ``reps`` calls
        launched back to back, over the count; the median of ``batches``
        such runs (``bench_kernels.time_ms``). A sleep queued ahead of the
        start event keeps the card busy while the host queues the calls,
        so the card runs them with no gap and the host's time per call
        (the wrapper's checks, allocations and ctypes call; about 0.08
        ms, more than a forward launch takes on the card) is not
        counted."""
        for _ in range(warmup):
            fn()
        return statistics.median(bench_kernels.time_ms(fn, device, reps)
                                 for _ in range(batches))

    def interleaved_ms(calls: dict, rounds: int = 7,
                       reps: int = 20) -> dict:
        """Median ms per call of each of ``calls``, timed in turns:
        ``rounds`` rounds of ``reps`` back-to-back calls each, so a drift
        of the card's clock within the call reaches all."""
        times = bench_kernels.interleaved_ms(calls, device, rounds, reps)
        return {name: statistics.median(t) for name, t in times.items()}

    def wall_ms(fn, reps: int) -> float:
        """Host ms per call of ``fn``: ``reps`` calls that end in a sync
        of the card, after one call that is not timed."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    def device_breakdown(fn, wall_ms: float) -> dict:
        """Kernel time of one call of ``fn`` under torch.profiler, its
        share of ``wall_ms`` (the same work timed without the profiler)
        and the kernels that took most of it."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # device time of kernels only: a user annotation (as
        # Optimizer.step's) spans kernels already counted
        kernels = [(e.key, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        kernel_ms = sum(ms for _, ms in kernels)
        top = sorted(kernels, key=lambda kv: -kv[1])[:5]
        return {"kernel_ms": kernel_ms, "busy_share": kernel_ms / wall_ms,
                "top": [[name[:90], ms] for name, ms in top]}

    def sdpa_backward(q, k, v, do, causal, window=0):
        """A call of SDPA's backward alone (dq, dk and dv of one forward
        kept for it), the yardstick of the backward kernels. A window is
        an explicit mask: SDPA has no window of its own."""
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        mask = None
        if window:
            t_q, t_k = q.shape[2], k.shape[2]
            pos = torch.arange(t_q, device=q.device)[:, None] + t_k - t_q
            key = torch.arange(t_k, device=q.device)[None, :]
            mask = (key <= pos) & (key > pos - window)
        out = F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        return lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                           retain_graph=True)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    # ---- 2. kernel against its plain version ---------------------------
    mark("2_kernel")
    # (B, H, Hkv, Tq, Tk, D), dtype, causal, window. The first is the
    # shape llama3_8b gives the kernel at T=2048; the last two are
    # ragged (no tile divides T), as llama_loss's T = seq_len - 1 is.
    main_case = ((1, 32, 8, 2048, 2048, 128), "bfloat16", True, 0)
    # head dim 32: the workload CLI's Llama step (batch 256, 8 heads, 4 kv
    # heads, T = seq_len - 1 = 255) and entry()'s forward ([2, 128])
    cli_case = ((256, 8, 4, 255, 255, 32), "bfloat16", True, 0)
    entry_case = ((2, 8, 4, 128, 128, 32), "bfloat16", True, 0)
    # the timed cases and the suffix of their rows' kernel names
    timed = {main_case: "", cli_case: "_d32", entry_case: "_d32_entry"}
    cases = [
        main_case,
        ((1, 32, 8, 2048, 2048, 128), "float32", True, 0),
        ((1, 32, 8, 2048, 2048, 128), "bfloat16", True, 1024),
        ((1, 32, 8, 2048, 2048, 128), "float32", True, 1024),
        ((1, 8, 2, 512, 1536, 128), "bfloat16", False, 0),
        ((1, 8, 2, 512, 1536, 128), "float32", False, 0),
        ((2, 8, 4, 512, 512, 64), "bfloat16", True, 0),
        ((2, 8, 4, 512, 512, 64), "float32", False, 0),
        ((1, 8, 2, 1000, 1000, 128), "float32", True, 100),
        ((1, 8, 2, 333, 777, 128), "bfloat16", False, 0),
        cli_case,
        (cli_case[0], "float32", True, 0),
        entry_case,
        (entry_case[0], "float32", True, 0),
        ((2, 8, 4, 300, 300, 32), "bfloat16", True, 64),
        ((2, 8, 4, 300, 300, 32), "float32", True, 64),
    ]
    fwd_rows = {}
    for shape, dtype_name, causal, window in cases:
        batch, heads, kv_heads, t_q, t_k, head_dim = shape
        dtype = getattr(torch, dtype_name)
        q = randn(batch, heads, t_q, head_dim, dtype=dtype)
        k = randn(batch, kv_heads, t_k, head_dim, dtype=dtype)
        v = randn(batch, kv_heads, t_k, head_dim, dtype=dtype)
        out, lse = flash_forward(q, k, v, causal, None, window)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_reference(q, k, v, causal, None,
                                                     window)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        check(torch.isfinite(out).all().item(), f"non-finite out {shape}")
        tol = TOL[dtype_name]
        row = {"phase": "kernel", "shape": list(shape), "dtype": dtype_name,
               "causal": causal, "window": window, "max_abs_err": err_out,
               "lse_max_abs_err": err_lse, "tol_out": tol["out"],
               "tol_lse": tol["lse"]}
        emit(row)
        check(err_out <= tol["out"] and err_lse <= tol["lse"],
              f"flash kernel disagrees with its plain version: {row}")
        suffix = timed.get((shape, dtype_name, causal, window))
        if suffix is not None:
            bound_ms, bound_by = flash_bound_ms(shape, dtype_name, causal,
                                                window)
            # one timing per call has moved by up to 16 %: the kernel and
            # SDPA take turns instead
            ms = interleaved_ms({
                "kernel": lambda: flash_forward(q, k, v, causal, None,
                                                window),
                "sdpa": lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)})
            kernel_row = {
                "name": "flash_fwd" + suffix, "shape": list(shape),
                "route": "cuda",
                "source": "kubeshare_tpu_torch/ops/csrc/flash_fwd.cu",
                # _flash_kernel
                "replaces": "kubeshare_tpu/ops/attention.py:121",
                "max_abs_err": err_out,
                "ms": ms["kernel"],
                "plain_ms": cuda_ms(lambda: flash_attention_reference(
                    q, k, v, causal, None, window), 5, warmup=1),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": ms["sdpa"],
            }
            emit({"phase": "kernel_timing_fwd", "shape": list(shape),
                  "dtype": dtype_name, **kernel_row,
                  "ms_over_library": ms["kernel"] / ms["sdpa"],
                  "share_of_bound": bound_ms / ms["kernel"],
                  "timing": "median of 7 rounds of 20 back-to-back "
                            "launches queued behind a sleep, in turns "
                            "with SDPA"})
            fwd_rows[suffix] = kernel_row
        del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()

    # ---- 3. forward at Llama-3-8B width ---------------------------------
    mark("3_forward")
    cfg = llama3_8b()
    t0 = time.perf_counter()
    model = init_llama(cfg, generator=gen, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    seq = 2048
    tokens = torch.randint(0, cfg.vocab, (1, seq), generator=gen,
                           device=device)
    with torch.no_grad():
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        logits = llama_apply(model, tokens)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        check(launches["flash_fwd"] == cfg.layers,
              f"flash kernel launched {launches['flash_fwd']} times in a "
              f"{cfg.layers}-layer forward")
        check(tuple(logits.shape) == (1, seq, cfg.vocab)
              and logits.dtype == torch.float32, "logits shape/dtype")
        check(torch.isfinite(logits).all().item(), "non-finite logits")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            llama_apply(model, tokens)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        forward_s = statistics.median(times)
        forward_device = device_breakdown(lambda: llama_apply(model, tokens),
                                          1e3 * forward_s)
        plain = llama_apply(model, tokens, use_flash=False)
        scale = logits.abs().max().item()
        rel = (logits - plain).abs().max().item() / scale
        top1 = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
        del plain
    emit({"phase": "forward", "config": "llama3_8b", "layers": cfg.layers,
          "tokens": seq, "init_s": init_s, "flash_launches": launches,
          "logits_max_abs": scale, "rel_err_vs_plain": rel,
          "rel_tol": LOGIT_REL_TOL, "top1_agreement_vs_plain": top1,
          "forward_ms": 1e3 * forward_s, "tokens_per_s": seq / forward_s,
          "weights_gb": torch.cuda.memory_allocated() / 1e9,
          "device": forward_device})
    check(rel <= LOGIT_REL_TOL, f"flash forward logits off by {rel}")
    del logits
    torch.cuda.empty_cache()

    # ---- 4. serving at full width ---------------------------------------
    mark("4_serving")
    buckets = (32, 128, 512)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(17, 513, 12)]
    prompts[0] = prompts[0][:17]         # both ends of the range
    prompts[1] = rng.integers(0, cfg.vocab, 512).tolist()
    with torch.no_grad():
        server = DecodeServer(model, slots=8, prompt_buckets=buckets)
        probe = init_kv_cache(cfg, 1, per_slot=True, device=device)
        prefill_rel = []
        for prompt in prompts[:8]:
            n = len(prompt)
            bucket = min(b for b in buckets if b >= n)
            padded = torch.tensor([prompt + [0] * (bucket - n)],
                                  device=device)
            pad_logits, probe = prefill_slot(model, padded, probe, 0)
            want = llama_apply(model, torch.tensor([prompt], device=device))
            got = pad_logits[0, n - 1]
            prefill_rel.append((got - want[0, -1]).abs().max().item()
                               / want[0, -1].abs().max().item())
            slot, first = server.admit(prompt)
            check(first == int(got.argmax()),
                  f"slot {slot}: first token {first} is not the argmax of "
                  "its prefill logits")
        check(max(prefill_rel) <= LOGIT_REL_TOL,
              f"prefill logits off by {max(prefill_rel)}")
        del probe, server

        def serve(cuda_graph: bool):
            """Phase 4's script on a fresh server: the 8 prompts, 64
            tokens each in bursts of 16 (timed), 4 retired and 4 others
            admitted, one more burst. Returns every call's result and
            the 64 steps' seconds."""
            server = DecodeServer(model, slots=8, prompt_buckets=buckets,
                                  cuda_graph=cuda_graph)
            firsts = [server.admit(p) for p in prompts[:8]]
            server.step_burst(16)     # the graph's capture, then warm
            for s in range(8):
                server.retire(s)
            check([server.admit(p) for p in prompts[:8]] == firsts,
                  "re-admitted prompts give their first tokens again")
            streams = {s: [] for s in range(8)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(4):
                for s, toks in server.step_burst(16).items():
                    streams[s].extend(toks)
            seconds = time.perf_counter() - t0
            for s in range(4):
                server.retire(s)
            readmitted = [server.admit(p) for p in prompts[8:]]
            return server, (firsts, streams, readmitted,
                            server.step_burst(16)), seconds

        eager_server, eager_run, eager_s = serve(cuda_graph=False)
        del eager_server
        torch.cuda.empty_cache()
        server, graph_run, decode_s = serve(cuda_graph=True)
        check(server.decode_step.graph is not None,
              "the decode step is a CUDA graph")
        firsts, streams, readmitted, after = graph_run
        check(all(len(streams[s]) == 64 for s in range(8)),
              "every slot decodes 64 tokens")
        check(all(0 <= t < cfg.vocab for s in streams for t in streams[s]),
              "token out of vocab")
        check(sorted(r[0] for r in readmitted) == [0, 1, 2, 3],
              "re-admission slots")
        check(sorted(after) == list(range(8))
              and all(len(t) == 16 for t in after.values()),
              "decode after re-admission")
        check(graph_run == eager_run,
              "the graphed server's token streams are the eager server's")
        decode_device = device_breakdown(lambda: server.step_burst(16),
                                         16 * 1e3 * decode_s / 64)
        del server
        torch.cuda.empty_cache()

        # serving.py's invariant: a slot's logits equal a solo decode with
        # a scalar cache, through the eager step and through the graphed
        # one. Printed, not asserted: cuBLAS may pick another algorithm
        # for an 8-row batch than for one row.
        solo = init_kv_cache(cfg, 1, device=device)
        _, solo = llama_apply_cached(
            model, torch.tensor([prompts[5]], device=device), solo)
        alone, _ = llama_apply_cached(
            model, torch.tensor([[7]], device=device), solo)
        del solo
        solo_diff = {}
        for graphed in (False, True):
            server = DecodeServer(model, slots=8, prompt_buckets=buckets,
                                  cuda_graph=graphed)
            for slot in (0, 5):
                prefill_slot(model, torch.tensor([prompts[slot]],
                                                 device=device),
                             server.cache, slot)
                server.active[slot] = True
                server.host_len[slot] = len(prompts[slot])
            server.last_tok[5] = 7
            server.step()
            key = "graph" if graphed else "eager"
            solo_diff[key] = (alone[0, -1]
                              - server.logits[5]).abs().max().item()
            del server
        readmitted = [r[0] for r in readmitted]
    emit({"phase": "serving", "slots": 8, "prompts": len(prompts),
          "prompt_lens": [len(p) for p in prompts],
          "prefill_rel_err_max": max(prefill_rel),
          "rel_tol": LOGIT_REL_TOL,
          "decode_steps": 64, "decode_ms_per_step": 1e3 * decode_s / 64,
          "decode_tokens_per_s": 8 * 64 / decode_s,
          "eager_decode_ms_per_step": 1e3 * eager_s / 64,
          "graph_streams_equal_eager": graph_run == eager_run,
          "decode_device_16_steps": decode_device,
          "readmitted_slots": readmitted,
          "solo_bit_identical": {k: v == 0.0 for k, v in solo_diff.items()},
          "solo_max_abs_diff": solo_diff})
    torch.cuda.empty_cache()

    # ---- 5. two tenants under ChipExecutor ------------------------------
    mark("5_sharing")
    # (grad mode is per thread: the executor's thread runs with it on,
    # harmless since no tensor here requires grad)
    tenants = {"pod-a": 3.0, "pod-b": 1.0}
    servers = {name: DecodeServer(model, slots=4, prompt_buckets=buckets,
                                  seed=i)
               for i, name in enumerate(tenants)}
    for name, server in servers.items():
        for p in prompts[:4]:
            check(server.admit(p) is not None, f"{name}: admit")
    executor = ChipExecutor(tenants)
    try:
        futures = [(name, executor.submit(name, servers[name].step_burst, 8))
                   for _ in range(6) for name in tenants]
        results = [(name, f.result(timeout=600)) for name, f in futures]
    finally:
        executor.close()
    for name, out in results:
        check(sorted(out) == [0, 1, 2, 3]
              and all(len(t) == 8 for t in out.values()),
              f"{name}: burst result {out}")
    check(all(s.decode_step.graph is not None for s in servers.values()),
          "each tenant's decode step is a CUDA graph")
    stats = executor.stats()
    emit({"phase": "sharing", "weights": tenants, "stats": stats})
    check(all(stats[n]["calls"] == 6 for n in tenants), "every call ran")

    del servers, results
    torch.cuda.empty_cache()

    def rel_err(got, want) -> float:
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max().clamp_min(1e-30)).item()

    # ---- 6. backward kernels against their plain version ----------------
    mark("6_backward_kernels")
    # phase 2's cases; an lse cotangent on three of them, as a ring merge
    # would send it
    glse_cases = {2, 4, 9, 14}
    bwd_rows = {}
    for i, (shape, dtype_name, causal, window) in enumerate(cases):
        batch, heads, kv_heads, t_q, t_k, head_dim = shape
        dtype = getattr(torch, dtype_name)
        q = randn(batch, heads, t_q, head_dim, dtype=dtype)
        k = randn(batch, kv_heads, t_k, head_dim, dtype=dtype)
        v = randn(batch, kv_heads, t_k, head_dim, dtype=dtype)
        do = randn(batch, heads, t_q, head_dim, dtype=dtype)
        g_lse = (randn(batch, heads, t_q, 1, dtype=torch.float32)
                 if i in glse_cases else None)
        out, lse = flash_forward(q, k, v, causal, None, window)
        got = flash_backward(q, k, v, out, lse, do, g_lse, causal, None,
                             window)
        again = flash_backward(q, k, v, out, lse, do, g_lse, causal, None,
                               window)
        torch.cuda.synchronize()
        want = flash_backward_reference(q, k, v, out, lse, do, g_lse,
                                        causal, None, window)
        names = ("dq", "dk", "dv")
        rel = {n: rel_err(g, w) for n, g, w in zip(names, got, want)}
        abs_err = {n: (g.float() - w.float()).abs().max().item()
                   for n, g, w in zip(names, got, want)}
        identical = all(torch.equal(a, b) for a, b in zip(got, again))
        tol = BWD_REL_TOL[dtype_name]
        row = {"phase": "backward_kernels", "shape": list(shape),
               "dtype": dtype_name, "causal": causal, "window": window,
               "g_lse": g_lse is not None, "rel_err": rel,
               "max_abs_err": abs_err, "rel_tol": tol,
               "identical_on_repeat": identical}
        emit(row)
        check(all(torch.isfinite(g).all().item() for g in got),
              f"non-finite gradient {shape}")
        check(max(rel.values()) <= tol and identical,
              f"backward kernels disagree with their plain version: {row}")
        suffix = timed.get((shape, dtype_name, causal, window))
        if suffix is not None:
            scale = head_dim ** -0.5
            dq_in = (q, k, v, do, lse, attn._flash_delta(out, do))
            timing_args = (causal, scale, window)
            plain_ms = cuda_ms(lambda: flash_backward_reference(
                q, k, v, out, lse, do, None, causal, None, window), 5,
                warmup=1)
            # one timing per call moves: dq, dk/dv and SDPA's backward
            # (dq, dk and dv together) take turns
            ms = interleaved_ms({
                "flash_bwd_dq": lambda: attn._flash_bwd_dq_cuda(
                    *dq_in, *timing_args),
                "flash_bwd_dkv": lambda: attn._flash_bwd_dkv_cuda(
                    *dq_in, *timing_args),
                "sdpa_bwd": sdpa_backward(q, k, v, do, causal)})
            emit({"phase": "kernel_timing_bwd", "shape": list(shape),
                  "dtype": dtype_name, "ms": ms,
                  "dq_plus_dkv_over_library": (ms["flash_bwd_dq"]
                                               + ms["flash_bwd_dkv"])
                  / ms["sdpa_bwd"],
                  "timing": "median of 7 rounds of 20 back-to-back "
                            "launches queued behind a sleep, in turns"})
            for name, kind, err in (
                    ("flash_bwd_dq", "bwd_dq", abs_err["dq"]),
                    ("flash_bwd_dkv", "bwd_dkv",
                     max(abs_err["dk"], abs_err["dv"]))):
                bound_ms, bound_by = flash_bound_ms(shape, dtype_name,
                                                    causal, window, kind)
                bwd_rows[name + suffix] = {
                    "name": name + suffix, "shape": list(shape),
                    "route": "cuda",
                    "source": "kubeshare_tpu_torch/ops/csrc/flash_bwd.cu",
                    # _flash_bwd_dq_kernel / _flash_bwd_dkv_kernel
                    "replaces": ("kubeshare_tpu/ops/attention.py:300"
                                 if kind == "bwd_dq" else
                                 "kubeshare_tpu/ops/attention.py:348"),
                    "max_abs_err": err,
                    "ms": ms[name],
                    # one plain function computes dq, dk and dv together
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    # SDPA's backward (dq, dk and dv together)
                    "library_ms": ms["sdpa_bwd"],
                }
            del dq_in
        del q, k, v, do, g_lse, out, lse, got, again, want
    torch.cuda.empty_cache()

    # the three kernels' times as the shape moves one thing at a time
    # from the 8B one: the mask (non-causal does twice the causal work;
    # a window about the same work on every key tile), no GQA grouping,
    # the length, the batch. bf16, head dim 128. The whole backward and
    # SDPA's take turns.
    for batch, heads, kv_heads, t, causal, window in (
            (1, 32, 8, 2048, True, 0), (1, 32, 8, 2048, False, 0),
            (1, 32, 8, 2048, True, 1024), (1, 32, 32, 2048, True, 0),
            (1, 32, 8, 4096, True, 0), (4, 32, 8, 2048, True, 0)):
        shape = (batch, heads, kv_heads, t, t, 128)
        q, do = (randn(batch, heads, t, 128, dtype=torch.bfloat16)
                 for _ in range(2))
        k, v = (randn(batch, kv_heads, t, 128, dtype=torch.bfloat16)
                for _ in range(2))
        out, lse = flash_forward(q, k, v, causal, None, window)
        bwd_in = (q, k, v, do, lse, attn._flash_delta(out, do), causal,
                  128 ** -0.5, window)
        ms = {"fwd": cuda_ms(lambda: flash_forward(q, k, v, causal, None,
                                                   window), 20),
              "bwd_dq": cuda_ms(lambda: attn._flash_bwd_dq_cuda(*bwd_in),
                                20),
              "bwd_dkv": cuda_ms(lambda: attn._flash_bwd_dkv_cuda(*bwd_in),
                                 20)}
        bound = {kind: flash_bound_ms(shape, "bfloat16", causal, window,
                                      kind)[0] for kind in ms}
        backward = interleaved_ms({
            "flash_backward": lambda: flash_backward(
                q, k, v, out, lse, do, None, causal, None, window),
            "sdpa_bwd": sdpa_backward(q, k, v, do, causal, window)})
        emit({"phase": "kernel_timing", "shape": list(shape),
              "causal": causal, "window": window, "ms": ms,
              "bound_ms": bound,
              "share_of_bound": {kind: bound[kind] / ms[kind]
                                 for kind in ms},
              "backward_ms": backward,
              "backward_over_sdpa": backward["flash_backward"]
              / backward["sdpa_bwd"]})
        del q, k, v, do, out, lse, bwd_in, backward
    torch.cuda.empty_cache()

    # ---- 7. training at Llama-3-8B width --------------------------------
    mark("7_training")
    # Full width, depth cut to 4 layers: the 32-layer model with float32
    # master weights, gradients and two Adam moments needs 16 bytes per
    # parameter, 128 GB; four layers are 1.92 B parameters, ~31 GB.
    tcfg = dataclasses.replace(cfg, layers=4)
    torch.cuda.reset_peak_memory_stats()
    trainer = init_llama(tcfg, generator=gen, device=device, trainable=True)
    params = [p for p in trainer.parameters() if p.requires_grad]
    names = [n for n, p in trainer.named_parameters() if p.requires_grad]
    # llama_loss trains on tokens[:, :-1]: 2049 tokens give the trunk
    # T = 2048, the shape phase 6 holds the backward kernels at
    batch_tokens = torch.randint(0, tcfg.vocab, (1, 2049), generator=gen,
                                 device=device)

    def grads_of(tokens=batch_tokens, **kwargs):
        loss = llama_loss(trainer, tokens, **kwargs)
        return loss.detach(), torch.autograd.grad(loss, params)

    # (a) the kernels' gradients against plain attention's
    loss_flash, grads_flash = grads_of()
    loss_plain, grads_plain = grads_of(use_flash=False)
    grad_rel = {n: rel_err(a, b)
                for n, a, b in zip(names, grads_flash, grads_plain)}
    worst = max(grad_rel, key=grad_rel.get)
    finite = all(torch.isfinite(g).all().item() for g in grads_flash)
    del grads_flash, grads_plain
    # remat: the forward runs twice per block
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    _, remat_grads = grads_of(remat=True)
    torch.cuda.synchronize()
    remat_launches = dict(LAUNCHES)
    del remat_grads
    # a trainer fed seq_len = 2048 tokens (as cmd/workload.py feeds them)
    # gives the trunk T = 2047, which no tile divides: the kernels run
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    _, ragged_grads = grads_of(batch_tokens[:, :2048])
    torch.cuda.synchronize()
    ragged_launches = dict(LAUNCHES)
    finite = finite and all(torch.isfinite(g).all().item()
                            for g in ragged_grads)
    del ragged_grads
    # (c) the vocab-chunked loss (128256 = 7 * 16384 + 13568: a ragged
    # last tile) and the lm head's gradient against the dense ones

    def head_grad(**kwargs):
        loss = llama_loss(trainer, batch_tokens, **kwargs)
        return loss.item(), torch.autograd.grad(loss, trainer.lm_head)[0]

    loss_dense, head_dense = head_grad()
    loss_chunked, head_chunked = head_grad(vocab_chunk=16384)
    chunked_rel = abs(loss_chunked - loss_dense) / abs(loss_dense)
    chunked_grad_rel = rel_err(head_chunked, head_dense)
    del head_dense, head_chunked
    torch.cuda.empty_cache()

    # (b) and (d): the main path. Counts from 0 around one optimizer
    # step, then four more on the same batch.
    opt, train_step = make_train_step(
        lambda m, t: llama_loss(m, t), trainer, learning_rate=1e-4)
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    losses = [train_step(batch_tokens).item()]
    train_launches = dict(LAUNCHES)
    step_times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(train_step(batch_tokens).item())   # .item() syncs
        step_times.append(time.perf_counter() - t0)
    step_s = statistics.median(step_times)
    train_device = device_breakdown(lambda: train_step(batch_tokens),
                                    1e3 * step_s)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train_row = {
        "phase": "training", "config": "llama3_8b", "layers": tcfg.layers,
        "params": sum(p.numel() for p in params), "tokens": [1, 2049],
        "loss_flash": loss_flash.item(), "loss_plain": loss_plain.item(),
        "grad_rel_err_max": grad_rel[worst], "grad_rel_err_worst": worst,
        "grad_rel_tol": GRAD_REL_TOL, "launches_per_step": train_launches,
        "launches_per_step_remat": remat_launches,
        "launches_per_step_t2047": ragged_launches,
        "loss_dense": loss_dense, "loss_vocab_chunk_16384": loss_chunked,
        "chunked_rel_err": chunked_rel, "chunked_rel_tol": CHUNKED_REL_TOL,
        "chunked_lm_head_grad_rel_err": chunked_grad_rel,
        "chunked_grad_rel_tol": CHUNKED_GRAD_REL_TOL,
        "adam_lr": 1e-4, "losses": losses, "step_ms": 1e3 * step_s,
        "tokens_per_s": 2048 / step_s, "peak_memory_gb": peak_gb,
        "device": train_device}
    emit(train_row)
    check(finite and grad_rel[worst] <= GRAD_REL_TOL,
          f"training gradients off: {worst} {grad_rel[worst]}")
    check(all(train_launches[n] == tcfg.layers for n in LAUNCHES),
          f"kernel launches per training step: {train_launches}")
    check(remat_launches == {"flash_fwd": 2 * tcfg.layers,
                             "flash_bwd_dq": tcfg.layers,
                             "flash_bwd_dkv": tcfg.layers},
          f"kernel launches per remat step: {remat_launches}")
    check(all(ragged_launches[n] == tcfg.layers for n in LAUNCHES),
          f"kernel launches per step at T = 2047: {ragged_launches}")
    check(chunked_rel <= CHUNKED_REL_TOL,
          f"chunked loss {loss_chunked} vs dense {loss_dense}")
    check(chunked_grad_rel <= CHUNKED_GRAD_REL_TOL,
          f"chunked lm head gradient off by {chunked_grad_rel}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"training loss did not fall: {losses}")
    torch.cuda.empty_cache()

    # ---- 8. a trainer and a server share the card ------------------------
    mark("8_train_and_serve")
    # KubeShare's own case: the 4-layer trainer above (~31 GB with Adam)
    # beside a 4-slot server on phase 3's 32-layer model (16 GB of weights,
    # 4.3 GB of cache), each a tenant of one ChipExecutor
    server = DecodeServer(model, slots=4, prompt_buckets=buckets)
    for p in prompts[:4]:
        check(server.admit(p) is not None, "server: admit")
    tenants = {"trainer": 1.0, "server": 1.0}
    executor = ChipExecutor(tenants)
    try:
        futures = [(name, executor.submit(name, fn, arg))
                   for _ in range(3)
                   for name, fn, arg in (("trainer", train_step, batch_tokens),
                                         ("server", server.step_burst, 8))]
        results = [(name, f.result(timeout=600)) for name, f in futures]
    finally:
        executor.close()
    for name, out in results:
        if name == "trainer":
            check(bool(torch.isfinite(out).item()), "trainer: loss")
        else:
            check(sorted(out) == [0, 1, 2, 3]
                  and all(len(t) == 8 for t in out.values()),
                  f"server: burst result {out}")
    check(server.decode_step.graph is not None,
          "the server's step is a CUDA graph")
    stats = executor.stats()
    emit({"phase": "train_and_serve", "weights": tenants, "stats": stats,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(all(stats[n]["calls"] == 3 for n in tenants), "every call ran")
    del (server, executor, futures, results, model, trainer, params, opt,
         train_step, grads_of, head_grad, batch_tokens)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 9. the workloads through the CLI ------------------------------
    mark("9_workloads")
    from kubeshare_tpu_torch.bench.arbiter import (
        free_port, start_arbiter, stop_arbiter,
    )
    from kubeshare_tpu_torch.bench.headline import run_headline
    from kubeshare_tpu_torch.cmd import workload as workload_cmd
    from kubeshare_tpu_torch.models.convert import (
        resnet_from_jax, workload_to_jax,
    )
    from kubeshare_tpu_torch.models.resnet import ResNetConfig, init_resnet
    from kubeshare_tpu_torch.nodeconfig.files import ConfigEntry
    from kubeshare_tpu_torch.runtime import hook
    from kubeshare_tpu_torch.runtime.hook import SharedChipGate

    def workload(*argv: str) -> dict:
        """``cmd/workload.main`` on the card; its JSON line."""
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = workload_cmd.main(list(argv))
        check(rc == 0, f"workload {argv} exited {rc}")
        return json.loads(out.getvalue().strip().splitlines()[-1])

    def zero_launches() -> None:
        for kernel in LAUNCHES:
            LAUNCHES[kernel] = 0

    lstm_floor = math.log(8192)
    bf16_ulp_at_floor = 2.0 ** -4           # bf16 spacing in [8, 16)
    for name in ("mnist", "cifar", "resnet", "vgg", "lstm"):
        first = workload("--model", name, "--steps", "1")
        doc = workload("--model", name, "--steps", str(WORKLOAD_STEPS))
        emit({"phase": "workload", **doc, "first_step_loss":
              first["final_loss"]})
        check(math.isfinite(doc["final_loss"]) and doc["steps"]
              == WORKLOAD_STEPS, f"{name}: {doc}")
        if name == "lstm":
            check(abs(doc["final_loss"] - lstm_floor) <= bf16_ulp_at_floor
                  and doc["final_loss"] <= first["final_loss"]
                  + bf16_ulp_at_floor, f"lstm loss left its floor: {doc}")
        else:
            check(doc["final_loss"] < first["final_loss"],
                  f"{name}: loss did not fall: {first} -> {doc}")
    # llama (head dim 32) at the CLI's defaults: batch 256, --seq-len 256
    # (the trunk's T = 255), 4 layers. The counts run from 0 around each
    # run: the CLI's warm-up forward and backward, then the steps; each
    # runs every kernel once per layer (the forward twice with --remat).
    llama_layers = 4
    llama_runs = {}
    for extra, steps in (((), WORKLOAD_STEPS),
                         (("--window", "64"), WORKLOAD_STEPS),
                         (("--remat",), 2)):
        first = workload("--model", "llama", *extra, "--steps", "1")
        zero_launches()
        doc = workload("--model", "llama", *extra, "--steps", str(steps))
        torch.cuda.synchronize()
        got = dict(LAUNCHES)
        per_fwd_bwd = {"flash_fwd": llama_layers * (2 if extra == ("--remat",)
                                                    else 1),
                       "flash_bwd_dq": llama_layers,
                       "flash_bwd_dkv": llama_layers}
        want = {n: c * (steps + 1) for n, c in per_fwd_bwd.items()}
        label = " ".join(("llama",) + extra)
        llama_runs[label] = got
        emit({"phase": "workload", **doc, "flags": list(extra),
              "first_step_loss": first["final_loss"],
              "flash_launches": got, "flash_launches_want": want})
        check(math.isfinite(doc["final_loss"]) and doc["steps"] == steps
              and doc["final_loss"] < first["final_loss"],
              f"{label}: loss not finite or did not fall: {first} -> {doc}")
        check(got == want, f"{label}: kernel launches {got}, want {want}")

    # where a workload's step spends its time: one Adam step of each at
    # the CLI's defaults, wall time (median of 3) against its kernels
    llama_step_launches = None
    for name in ("mnist", "cifar", "resnet", "vgg", "lstm", "llama"):
        net, loss_fn, batch_at = workload_cmd._build(name, 256, device,
                                                     args.seed)
        _, wl_step = make_train_step(loss_fn, net)
        wl_batch = batch_at(0)
        for _ in range(3):
            wl_step(*wl_batch)
        if name == "llama":      # one step's launches, counted from 0
            zero_launches()
            wl_step(*wl_batch)
            torch.cuda.synchronize()
            llama_step_launches = dict(LAUNCHES)
            check(all(n == llama_layers
                      for n in llama_step_launches.values()),
                  f"llama step launches {llama_step_launches}")
        wl_times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wl_step(*wl_batch)
            torch.cuda.synchronize()
            wl_times.append(time.perf_counter() - t0)
        wl_ms = 1e3 * statistics.median(wl_times)
        emit({"phase": "workload_step", "model": name, "batch": 256,
              "step_ms": wl_ms,
              **({"flash_launches": llama_step_launches}
                 if name == "llama" else {}),
              "device": device_breakdown(lambda: wl_step(*wl_batch), wl_ms)})
        del net, wl_step, wl_batch

    # ResNet-18 (the CLI's config) on the card against the same weights
    # on the CPU
    rcfg = ResNetConfig()
    host_gen = torch.Generator().manual_seed(args.seed)
    tree = workload_to_jax(init_resnet(rcfg, generator=host_gen,
                                       device="cpu"))
    images = torch.randn(8, 3, 32, 32, generator=host_gen)
    with torch.no_grad():
        want = resnet_from_jax(tree, rcfg, device="cpu")(images).float()
        got = resnet_from_jax(tree, rcfg, device=device)(
            images.to(device)).float().cpu()
    resnet_rel = ((got - want).abs().max() / want.abs().max()).item()
    emit({"phase": "workload_resnet_card_vs_cpu", "config": "resnet18",
          "images": [8, 3, 32, 32], "rel_err": resnet_rel,
          "rel_tol": RESNET_REL_TOL})
    check(resnet_rel <= RESNET_REL_TOL, f"resnet on the card off by "
          f"{resnet_rel}")

    # checkpoint: stopped at 12 and resumed to 20, against 20 in one go
    with tempfile.TemporaryDirectory() as ckpt:
        whole = workload("--model", "mnist", "--steps", "20")
        stopped = workload("--model", "mnist", "--steps", "12",
                           "--checkpoint-dir", ckpt, "--checkpoint-every",
                           "8")
        resumed = workload("--model", "mnist", "--steps", "8",
                           "--checkpoint-dir", ckpt)
        last = max(int(n[5:]) for n in os.listdir(ckpt)
                   if n.startswith("step_"))
    resume_rel = (abs(resumed["final_loss"] - whole["final_loss"])
                  / abs(whole["final_loss"]))
    emit({"phase": "workload_resume", "uninterrupted": whole,
          "stopped": stopped, "resumed": resumed, "last_checkpoint": last,
          "loss_rel_err": resume_rel, "rel_tol": RESUME_REL_TOL})
    check(last == 20 and resume_rel <= RESUME_REL_TOL,
          f"resume ended at step {last}, loss off by {resume_rel}")

    # a pod under install_gate and a live tpu-schd
    gate_env = {hook.ENV_POD_MANAGER_PORT: str(free_port()),
                "KUBESHARE_POD_NAME": "smoke/trainer"}
    with tempfile.TemporaryDirectory() as base:
        arbiter = start_arbiter(
            base, "smoke-card",
            [ConfigEntry("smoke/trainer", 1.0, 0.5, 0)],
            int(gate_env[hook.ENV_POD_MANAGER_PORT]))
        saved = {k: os.environ.get(k) for k in gate_env}
        os.environ.update(gate_env)
        try:
            gated = workload("--model", "mnist", "--steps", "20")
        finally:
            stop_arbiter(arbiter)
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    emit({"phase": "workload_gated", **gated})
    check(gated["tokens_acquired"] > 0, f"gated workload: {gated}")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 10. a pod's drain waits for its own stream ---------------------
    mark("10_drain")

    class _Grant:
        def acquire(self, est_ms=0.0):
            return 1e9

        def release(self, used_ms):
            pass

    busy, mine = torch.cuda.Stream(device), torch.cuda.Stream(device)
    x = torch.ones(1 << 20, device=device)
    # load every kernel the pod runs first: loading a kernel's module
    # (CUDA's lazy loading) waits for the whole device
    with torch.cuda.stream(mine):
        hook._block(bool((x * 2 == 2).all()))
        torch.cuda.Event().record()
    torch.cuda.synchronize()
    queued, drain = threading.Event(), {}

    def sleeper():
        with torch.cuda.stream(busy):
            torch.cuda._sleep(DRAIN_SLEEP_CYCLES)
        queued.set()

    def pod():
        queued.wait(5)
        gate = SharedChipGate(_Grant(), fail_open=False)
        with torch.cuda.stream(mine):
            gate.begin()
            y = x * 2
            t0 = time.perf_counter()
            gate.flush(y)
            drain["ms"] = 1e3 * (time.perf_counter() - t0)
            asleep = torch.cuda.Event()
            asleep.record(busy)
            drain["other_stream_busy_after"] = not asleep.query()
            drain["ok"] = bool((y == 2).all().item())

    threads = [threading.Thread(target=sleeper), threading.Thread(target=pod)]
    t_sleep = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    torch.cuda.synchronize()
    sleep_ms = 1e3 * (time.perf_counter() - t_sleep)
    emit({"phase": "drain", **drain,
          "other_stream_sleep_ms_at_least": sleep_ms,
          "limit_ms": DRAIN_MAX_MS})
    check(drain.get("ok") and drain.get("other_stream_busy_after")
          and drain["ms"] < DRAIN_MAX_MS,
          f"a pod's drain waited for another stream: {drain}")

    # ---- 11. the co-location headline -----------------------------------
    mark("11_headline")
    headline = run_headline(device=device)
    emit({"phase": "headline", **headline})
    # the kernels of one eager MNIST step at the headline's size
    from kubeshare_tpu_torch.models.mnist import (
        MnistConfig, init_mnist, make_mnist_train_step,
    )
    mnist_step = make_mnist_train_step(
        init_mnist(MnistConfig(hidden=256), device=device), cuda_graph=False)
    mnist_in = (torch.randn(1024, 1, 28, 28, generator=gen, device=device),
                torch.randint(0, 10, (1024,), generator=gen, device=device))
    for _ in range(3):
        mnist_step(*mnist_in)
    emit({"phase": "headline_step_device", "batch": 1024, "steps": 5,
          "device": device_breakdown(
              lambda: [mnist_step(*mnist_in) for _ in range(5)],
              5 * headline["mnist_step_ms"]["eager"])})
    check(headline["isolated"] and headline["rounds"] == 3
          and all(n > 0 for n in headline["tokens_acquired"].values())
          and len(headline["tokens_acquired"]) == 8
          and all(math.isfinite(headline[k]) and headline[k] > 0
                  for k in ("value", "vs_baseline")),
          f"headline: {headline}")
    del mnist_step, mnist_in
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 12. entry(): the reference's flagship forward ------------------
    mark("12_entry")
    from kubeshare_tpu_torch.entry import entry

    forward, (entry_model, entry_tokens) = entry()
    with torch.no_grad():
        forward(entry_model, entry_tokens)     # loads, the work list
        torch.cuda.synchronize()
        zero_launches()
        entry_logits = forward(entry_model, entry_tokens)
        torch.cuda.synchronize()
        entry_launches = dict(LAUNCHES)
        entry_times = []
        for _ in range(5):
            t0 = time.perf_counter()
            forward(entry_model, entry_tokens)
            torch.cuda.synchronize()
            entry_times.append(time.perf_counter() - t0)
        entry_plain = llama_apply(entry_model, entry_tokens, use_flash=False)
    entry_rel = ((entry_logits - entry_plain).abs().max()
                 / entry_logits.abs().max()).item()
    emit({"phase": "entry", "config": "__graft_entry__.entry()",
          "tokens": list(entry_tokens.shape),
          "head_dim": entry_model.cfg.dim // entry_model.cfg.num_heads,
          "flash_launches": entry_launches,
          "rel_err_vs_plain": entry_rel, "rel_tol": LOGIT_REL_TOL,
          "forward_ms": 1e3 * statistics.median(entry_times)})
    check(tuple(entry_logits.shape) == (2, 128, entry_model.cfg.vocab)
          and torch.isfinite(entry_logits).all().item(), "entry logits")
    check(entry_launches == {"flash_fwd": entry_model.cfg.layers,
                             "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
          f"entry() launches {entry_launches}")
    check(entry_rel <= LOGIT_REL_TOL, f"entry logits off by {entry_rel}")
    del entry_model, entry_logits, entry_plain

    # ---- 13. the kernel benches -----------------------------------------
    mark("13_kernel_benches")
    bench_seconds, bench_docs = {}, {}
    for label, run in (
            ("flash_vs_plain_t4096", lambda: bench_kernels.flash_vs_plain(
                4096, rounds=BENCH_CUT["flash_rounds"])),
            ("flash_vs_plain_t2048", lambda: bench_kernels.flash_vs_plain(
                2048, rounds=BENCH_CUT["flash_rounds"])),
            ("xent_vs_naive_t2048", lambda: bench_kernels.xent_vs_naive(
                2048, rounds=BENCH_CUT["xent_rounds"])),
            ("xent_vs_naive_t4096", lambda: bench_kernels.xent_vs_naive(
                4096, rounds=BENCH_CUT["xent_rounds"])),
            ("flash_swa_speedup", lambda: bench_kernels.flash_swa_speedup(
                rounds=BENCH_CUT["swa_rounds"])),
            ("llama_train_mfu", lambda: bench_kernels.llama_train_mfu(
                steps=BENCH_CUT["mfu_steps"])),
            ("train_gate_overhead", bench_kernels.train_gate_overhead),
            ("flash_longcontext_ab", bench_kernels.flash_longcontext_ab),
            ("xent_oom_ab", bench_kernels.xent_oom_ab)):
        t0 = time.perf_counter()
        bench_docs[label] = run()
        bench_seconds[label] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "kernel_benches", "seconds": bench_seconds,
          "cut": BENCH_CUT})
    for label, doc in bench_docs.items():
        check(all(math.isfinite(x) for x in doc.values()
                  if isinstance(x, float)), f"{label}: {doc}")
    mfu_doc = bench_docs["llama_train_mfu"]
    check(mfu_doc["mfu"] is None or 0 < mfu_doc["mfu"] < 1,
          f"mfu: {mfu_doc}")
    gate_doc = bench_docs["train_gate_overhead"]
    check(gate_doc["tokens_acquired"] == gate_doc["rounds"]
          and 0 < gate_doc["train_gate_calls_ms"]
          < gate_doc["train_gated_step_ms"], f"gate overhead: {gate_doc}")
    check(bench_docs["flash_longcontext_ab"]["flash_trains"]
          and bench_docs["xent_oom_ab"]["fused_trains"], "long A/Bs")
    # where the MFU step's time goes: its kernels under the profiler
    mfu_step, mfu_tokens, _, _ = bench_kernels.build_train_step(
        4, 2048, bench_kernels.MFU_CONFIG, device)
    emit({"phase": "kernel_benches_mfu_step", "batch_x_seq": "4x2048",
          "step_ms": mfu_doc["llama_step_ms"],
          "device": device_breakdown(lambda: mfu_step(mfu_tokens),
                                     mfu_doc["llama_step_ms"])})
    del mfu_step, mfu_tokens

    # ---- 14. the serving bench: BASELINE config 5 ----------------------
    mark("14_serving_bench")
    serve_docs = {}
    for quant in (False, True):
        doc = pod_serving.run(quant=quant,
                              phase_seconds=POD_BENCH_CUT["serving_phase_s"],
                              rounds=1)
        serve_docs[doc["weights"]] = doc
        emit({"phase": "serving_bench", **doc})
        check(len(doc["tokens_acquired"]) == pod_serving.PODS
              and all(n > 0 for n in doc["tokens_acquired"].values())
              and all(math.isfinite(doc[k]) and doc[k] > 0
                      for k in ("value", "vs_baseline", "ungated_value")),
              f"serving bench ({doc['weights']}): {doc}")
        gc.collect()
        torch.cuda.empty_cache()
    # where a pod's decode step goes, graphed and eager: 16 steps from
    # an empty cache, timed on the host clock, then under the profiler
    pod_decode = pod_serving.PodDecode(
        init_llama(pod_serving.CFG, generator=gen, device=device))
    step_ms, breakdown = {}, {}
    for name, fn in (("graph", pod_decode.step),
                     ("eager", pod_decode.decode)):
        def decode_burst(fn=fn):
            pod_decode.restart()
            for _ in range(16):
                fn()
        step_ms[name] = wall_ms(decode_burst, 3) / 16
        breakdown[name] = device_breakdown(decode_burst, 16 * step_ms[name])
    emit({"phase": "serving_bench_step_device", "steps": 16,
          "bench_decode_step_ms": serve_docs["bfloat16"]["decode_step_ms"],
          "step_ms": step_ms, "device": breakdown})
    del pod_decode

    # ---- 15. continuous batching ----------------------------------------
    mark("15_contbatch")
    contbatch = pod_configs.run_contbatch(
        phase_seconds=POD_BENCH_CUT["contbatch_s"], rounds=1)
    emit({"phase": "contbatch", **contbatch})
    check(contbatch["admissions"] > 0
          and contbatch["tokens_out_of_vocab"] == 0
          and contbatch["tokens"] > contbatch["admissions"]
          and math.isfinite(contbatch["value"]) and contbatch["value"] > 0,
          f"contbatch: {contbatch}")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 16. the LSTM gang: BASELINE config 3 ---------------------------
    mark("16_lstm_gang")
    gang = pod_configs.run_lstm_gang(
        phase_seconds=POD_BENCH_CUT["gang_phase_s"], rounds=1)
    emit({"phase": "lstm_gang", **gang})
    check(len(gang["tokens_acquired"]) == pod_configs.GANG_PODS
          and all(n > 0 for n in gang["tokens_acquired"].values())
          and all(math.isfinite(x) for x in gang["final_loss"])
          and all(math.isfinite(gang[k]) and gang[k] > 0
                  for k in ("value", "vs_baseline", "ungated_value")),
          f"lstm gang: {gang}")
    # where a gang pod's step goes, graphed and eager
    lstm_model, lstm_tokens = pod_configs.lstm_pod(0, device)
    lstm_steps = {"graph": pod_configs.make_lstm_step(lstm_model)}
    lstm_model, _ = pod_configs.lstm_pod(1, device)
    lstm_steps["eager"] = make_train_step(pod_configs.lstm_loss, lstm_model,
                                          pod_configs.LR)[1]
    step_ms, breakdown = {}, {}
    for name, lstm_step in lstm_steps.items():
        step_ms[name] = wall_ms(lambda: lstm_step(lstm_tokens), 8)
        breakdown[name] = device_breakdown(
            lambda: lstm_step(lstm_tokens), step_ms[name])
    emit({"phase": "lstm_gang_step_device",
          "bench_train_step_ms": gang["train_step_ms"],
          "step_ms": step_ms, "device": breakdown})
    del lstm_model, lstm_tokens, lstm_steps

    # ---- 17. the node side: inventory, deployed pods, the interposer ----
    mark("17_node")
    from kubeshare_tpu_torch.bench import node as node_bench
    from kubeshare_tpu_torch.metrics.collector import (
        Collector, NvmlChipBackend,
    )
    from kubeshare_tpu_torch.metrics.scrape import scrape_capacity
    from kubeshare_tpu_torch.runtime.native import build_interposer

    # the interposer, and again against the real cuda.h (static_asserts)
    with ThreadPoolExecutor(2) as pool:
        shim_paths = [str(p) for p in pool.map(build_interposer,
                                               (False, True))]
    backend = NvmlChipBackend()
    chips = backend.enumerate()
    mig_mode = backend.mig_mode(0)
    check(len(chips) >= 1, "NVML enumerates no device")
    row = chips[0]
    props = torch.cuda.get_device_properties(0)
    torch_uuid = str(props.uuid)
    if not torch_uuid.startswith("GPU-"):
        torch_uuid = "GPU-" + torch_uuid
    smi_mib = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.total", "--format=csv,noheader,"
         "nounits", "-i", "0"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    collector = Collector("smoke-node", backend)
    server = collector.serve(host="127.0.0.1", port=0)
    try:
        scraped = scrape_capacity(f"http://127.0.0.1:{server.port}/metrics")
    finally:
        server.stop()
    backend.close()
    emit({"phase": "node_inventory", "card": smi, "row": vars(row),
          "rows": len(chips), "mig_mode": mig_mode, "torch_uuid": torch_uuid,
          "torch_total_memory": props.total_memory,
          "nvidia_smi_memory_mib": smi_mib, "interposer": shim_paths})
    check(row.uuid == torch_uuid,
          f"NVML uuid {row.uuid} is not torch's {torch_uuid}")
    check(row.memory >> 20 == smi_mib
          and abs(row.memory - props.total_memory) <= 0.01 * row.memory,
          f"memory {row.memory}: NVML {smi_mib} MiB, torch "
          f"{props.total_memory}")
    check(scraped.get("smoke-node") == chips,
          f"the collector's /metrics gave {scraped}")

    gc.collect()
    torch.cuda.empty_cache()
    node = node_bench.run_node(row.uuid, seconds=0.75,
                               cost_modes=("plain", "interposer"))

    def shim_summary(stats):
        out = {k: v for k, v in stats.items() if k != "functions"}
        out["functions"] = len(stats["functions"])
        out["flash"] = sum(n for name, n in stats["functions"].items()
                           if "flash" in name)
        return out

    pods = node["pods"]
    emit({"phase": "node_pods", "card": smi, "synced": node["synced"],
          "seconds": node["colocated_s"], "arbiter": node["arbiter_peak"],
          "metrics": node["metrics_peak"],
          **{name: {"llama": pod["llama"], "mnist": pod["mnist"],
                    "alloc": pod["alloc"],
                    "interposer": shim_summary(pod["interposer"])}
             for name, pod in pods.items()}})
    check(node["synced"] == {row.uuid: 2},
          f"nodeconfig wrote {node['synced']}")
    for name, pod in pods.items():
        stats, peak = pod["interposer"], node["arbiter_peak"][f"smoke/{name}"]
        check(stats is not None and stats["mode"] == "gated"
              and stats["acquires"] > 0 and stats["releases"] > 0,
              f"{name} was not gated: {stats}")
        check(peak["window_usage_ms"] > 0 and peak["mem_used"] > 0,
              f"{name} was not charged by the arbiter: {peak}")
        check(stats["launch"] + stats["launch_ex"] > 0
              and stats["graph_launch"] > 0,
              f"{name}: no gated kernel or graph launch: {stats}")
        check(shim_summary(stats)["flash"] >= 4,
              f"{name}: the interposer saw no flash kernel: "
              f"{shim_summary(stats)}")
        check(math.isfinite(pod["llama"]["loss"])
              and math.isfinite(pod["mnist"]["loss"])
              and math.isfinite(pod["alloc"]["step_after"]),
              f"{name}: losses {pod['llama']}, {pod['mnist']}, "
              f"{pod['alloc']}")
        check(node["metrics_peak"].get(
                  f"tpu_pod_window_usage_ms/smoke/{name}", 0) > 0,
              f"the launcher's /metrics lacks {name}: {node['metrics_peak']}")
    check(pods["pod-a"]["alloc"]["outcome"] == "ok",
          f"pod-a's uncapped allocation: {pods['pod-a']['alloc']}")
    check(pods["pod-b"]["alloc"]["outcome"].startswith("oom")
          and pods["pod-b"]["interposer"]["mem_denied"] >= 1,
          f"pod-b past its cap: {pods['pod-b']['alloc']}")
    peak_b = node["arbiter_peak"]["smoke/pod-b"]
    check(peak_b["mem_used"] <= node_bench.POD_B_CAP,
          f"pod-b charged past its cap: {peak_b}")
    check(node["metrics_peak"].get("tpu_chip_arbiter_up") == 1.0,
          f"the launcher's /metrics: {node['metrics_peak']}")
    cost = {mode: [{"llama_step_ms": run["llama_step_ms"],
                    "mnist_graph_step_ms": run["mnist_graph_step_ms"],
                    "launch_us": run["launch_us"],
                    **({"acquire_wait_ms": run["interposer"]["acquire_wait_ms"],
                        "drain_wait_ms": run["interposer"]["drain_wait_ms"],
                        "launches": run["interposer"]["launch"]
                        + run["interposer"]["launch_ex"],
                        "graph_launches": run["interposer"]["graph_launch"]}
                       if mode == "interposer" else {})}
                   for run in runs]
            for mode, runs in node["cost"].items()}
    emit({"phase": "node_cost", "card": smi, "pod": "smoke/pod-a alone",
          "limit": 1.0, "window_ms": node["window_ms"], **cost,
          "colocated_steps_per_s": {
              name: {"llama": 1e3 / pod["llama"]["step_ms"],
                     "mnist": 1e3 / pod["mnist"]["step_ms"]}
              for name, pod in pods.items()}})

    mark("end")
    marks = list(phase_started.items())
    emit({"phase": "timing",
          "seconds": {name: t1 - t0 for (name, t0), (_, t1)
                      in zip(marks, marks[1:])},
          "flash_launches": {"entry": entry_launches, **llama_runs,
                             "llama_step": llama_step_launches}})

    # the 8B rows: launches of the 8B forward (phase 3) and of a training
    # step (phase 7); the head-dim-32 rows: of one workload CLI llama step
    fwd_rows[""]["launches"] = launches["flash_fwd"]
    fwd_rows["_d32"]["launches"] = llama_step_launches["flash_fwd"]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        bwd_rows[name]["launches"] = train_launches[name]
        bwd_rows[name + "_d32"]["launches"] = llama_step_launches[name]
    emit({"kernels": [fwd_rows[""], bwd_rows["flash_bwd_dq"],
                      bwd_rows["flash_bwd_dkv"], fwd_rows["_d32"],
                      bwd_rows["flash_bwd_dq_d32"],
                      bwd_rows["flash_bwd_dkv_d32"]]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
