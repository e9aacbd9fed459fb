"""Drive kubeshare_tpu_torch's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failed check raises, so the script exits
nonzero and prints no result:

1. device: the card, torch/CUDA versions, the kernels' build (nvcc, at
   first use, from csrc/ in this checkout, both libraries at once).
2. kernel: the CUDA flash-attention forward against its plain PyTorch
   version on the card, out and lse, bit-identical on a second launch,
   at the Llama-3-8B shape, at edge shapes, at head dim 32 (the workload
   CLI's Llama step, entry()'s forward, a ragged window) and at the
   reference's dry-run head dims: 16 (bf16 and float32, native), 8
   (float32, padded to 16) and 96 (bf16, padded to 128), both at
   (1, 4, 2, 8192, 8192, D) and at the shapes phase 19 (e)'s dry run
   gives the kernels; out held absolutely, and row by row relative to
   its norm where Tk >= 2048; at the 8B shape, the two head-dim-32 ones
   and the four small-head-dim ones at (1, 4, 2, 8192, 8192, D) the
   kernel and SDPA timed in turns over several rounds (the padding
   copies inside the kernel's time).
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
   card at phase 2's shapes (some with an lse cotangent, the padded
   head dim 8 among them), bit-identical on a second launch; at phase
   2's timed shapes dq and dk/dv (on inputs padded once to the native
   head dim), the whole ``flash_backward`` (its padding, delta', both
   kernels and the slices back) and SDPA's backward timed in turns;
   then at six shapes around it all three kernels
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

18. a gang on the card (``parallel/``): four rank processes that share
    the card (spawned after the kernels are built here; the backend rule
    picks gloo), first ring (flash hops) and Ulysses (flash core)
    attention on their shards against plain attention in this process;
    then the sequence-parallel Llama step, sp = 4, at the ~200M config
    of ``bench/kernels.py`` on [1, 32769] tokens (T_local = 8192, the
    vocab-chunked loss, AdamW), ring then Ulysses: the loss and a few
    summed gradients against ``llama_loss`` in this process at the same
    weights and tokens, each rank's step ms, peak memory, bytes and
    seconds through ``comm.py`` and kernel launches per step (every rank
    must launch all three, and its backward must see a non-zero lse
    cotangent); this process' one-process step at the same size beside
    them; the three kernels at the ring's hop shape and the Ulysses core
    shape against their plain versions, timed. Then two 2-process CLI
    gangs at once (``--model resnet`` and ``--model llama``) and
    ``bench/configs.py resnet`` (BASELINE config 4) for one round. Every
    world's backend is printed; a rank that fails or outlives its limit
    fails the phase.
19. the reference's multi-device paths (``__graft_entry__.py``'s dry
    run) at full width, four rank processes on the card, each leg held
    against one process at the same weights and inputs (the one process
    runs first, and its memory is freed before the world starts): (a)
    FSDP x TP training of ``llama3_8b()`` widths at 2 layers on
    ``factorize_devices(4, tp_max=2, fsdp_max=2)`` (fsdp 2 x tp 2),
    tokens [2, 2049], the vocab-chunked loss: step 0's loss and a few
    gradients' blocks, then 3 AdamW steps timed; every rank must launch
    each kernel once a layer and step. (b) the pipeline trunk, 8 layers
    over pp = 4, tokens [4, 2048] in 4 microbatches, remat on: the hidden
    rows and each rank's layers' gradients of ``sum(hidden * g)``
    against ``llama_hidden``; every rank must launch every kernel. (c)
    MoE over ep = 4 (dim 4096, mlp 14336, 4 experts, top 2, capacity
    1.25) on x [2, 2048, 4096] bf16: y, aux, the dropped tokens and the
    gradients of x, the router and each rank's expert. (d)
    ``ElasticTrainer`` 4 -> 2 -> 4 ranks on the workload CLI's Llama,
    then checkpointed through ``models/checkpoint.py``, restored, and
    resumed by a new trainer on 3 ranks with the AdamW state and the
    step count: the 8 losses against one process's same sequence,
    ``generation`` 2. (e) ``entry.dryrun_multichip(4)`` on the card,
    dispatching as the reference's does (the kernels: head dim 16 bf16
    and float32, 8 padded): its tail line, ``crossproc=ok``, and each
    kernel launched on every rank (the counts reset just before it and
    read just after; the cross-process leg's four processes report
    theirs, returned with the ranks' results); phases 2 and 6 hold the
    kernels against their plain versions at the shapes it gives them.
    Each leg's ms, ``comm.stats()`` and peak memory a rank;
    the three kernels at a tp rank's and a pipeline stage's shapes
    against their plain versions, timed.
20. admission to a pod on its card: the port's ``WebhookServer`` on
    localhost mutates a fractional pod's AdmissionReview; the
    interposer is installed into a temporary library directory
    (``runtime/native.py::install_interposer``); a child env is built
    from the patches (the ``/kubeshare/library`` prefix rewritten to
    that directory), the card's NVML uuid as ``TPU_VISIBLE_CHIPS`` and a
    ``tpu-pmgr`` port from a ``NodeLauncher``; an unmodified PyTorch
    child (matmuls and attention) must see one device, that uuid, and
    the interposer must have gated its launches and set
    ``CUDA_VISIBLE_DEVICES``. A second child given a uuid no card has
    must see no device and fail.

Then each phase's seconds, the ``{"kernels": [...]}`` line, and as the
last line ``{"ok": true, "device": {...}}``. Needs one CUDA device, and
g++ for ``tpu-schd``, ``tpu-pmgr`` and the interposer (each is built
when missing).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
import types
from concurrent.futures import ThreadPoolExecutor


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def progress(what: str) -> None:
    """A line on stderr: where a long phase is (stdout stays JSON)."""
    print(f"[{time.strftime('%H:%M:%S')}] {what}", file=sys.stderr,
          flush=True)


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
# to 2e-2 (about 2.5 ulps); lse is float32 in both. Where a row averages
# many keys (Tk >= 2048) |out| shrinks to ~sqrt(e / n) and 2e-2 is as
# large as the values: there each row is also held by its error's norm
# over its own norm, at SP_ROW_REL_TOL.
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


# Phase 18: the sequence-parallel Llama at the ~200M config of
# bench/kernels.py (bench_kernels.py:95-98), sp = 4 ranks on one card,
# T_local = 8192, the vocab chunk of its MFU step, and one step timed
# after an untimed forward and backward. The attention check runs at
# T = 8192 (plain attention in one process holds [1, 16, T, T] float32
# scores).
SP_RANKS = 4
SP_SEQ = 32768
SP_STEPS = 1
SP_ATTENTION = (1, 16, 8, 8192, 64)        # B, H, Hkv, T, D
SP_PROBE = ("final_norm", "layers.0.wq", "layers.5.w_gate", "layers.11.wo")
# The SP loss against llama_loss in one process (bf16 activations; the
# ring merges hops in float32 and sums the vocab-chunked partials in
# another order), relative.
SP_LOSS_REL_TOL = 2e-2
# Outputs at the long shapes of phase 18 (ring and Ulysses attention
# against the kernels' plain version in one process, and the kernels at
# the ring's hop and the Ulysses core shapes): with unit-normal inputs a
# row that averages n keys has entries of ~sqrt(e / n), 0.013-0.018 at
# n = 8192, so an absolute bound is as large as the values. Each output
# row is held instead by its error's norm over its own norm. Both sides
# round P to bf16 before the PV product (2^-9 relative, errors of
# either sign) and the output at the end; the ring also rounds each
# hop's output before the merge. That is ~3e-3 relative a row, a little
# more in the worst of 131072 rows; 1e-2 is 2.5 bf16 ulps (2^-8), and a
# row that loses or mis-weighs a slice of its keys moves by far more.
# The lse (float32 on both sides) is held to phase 2's bound.
SP_ROW_REL_TOL = 1e-2
# CLI gang steps and the resnet bench's phase (seconds, one round).
GANG_STEPS = 10
RESNET_PHASE_S = 2.0


def row_rel_err(got, want) -> float:
    """The largest over rows (the last dim) of ||got - want|| / ||want||."""
    diff = (got.float() - want.float()).norm(dim=-1)
    return (diff / want.float().norm(dim=-1).clamp_min(1e-30)).max().item()


def sp_rank(joined, seed: int) -> dict:
    """One rank of phase 18's world (module docstring): ring and Ulysses
    attention on this rank's shards, then the sp Llama probe and steps
    for each. Returns CPU tensors and numbers."""
    import importlib

    import torch

    from kubeshare_tpu_torch.bench.kernels import MFU_CONFIG, MFU_VOCAB_CHUNK
    from kubeshare_tpu_torch.models.llama import init_llama, make_llama_sp_loss
    from kubeshare_tpu_torch.parallel import (
        MeshPlan, comm, make_mesh, make_sharded_train_step,
        make_ulysses_attention, ring_attention_with_lse,
    )

    attn = importlib.import_module("kubeshare_tpu_torch.ops.attention")
    device, n, rank = joined.device, joined.world, joined.rank
    mesh = make_mesh(MeshPlan(sp=n))
    out = {"backend": joined.backend, "device": str(device),
           "attention": {}}
    batch, heads, kv_heads, t, head_dim = SP_ATTENTION
    gen = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn(batch, heads, t, head_dim, generator=gen,
                         device=device).bfloat16() for _ in range(2))
    k, v = (torch.randn(batch, kv_heads, t, head_dim, generator=gen,
                        device=device).bfloat16() for _ in range(2))
    lo, hi = rank * t // n, (rank + 1) * t // n
    ulysses = make_ulysses_attention(mesh, causal=True, use_flash=True)
    for impl in ("ring", "ulysses"):
        shards = [x[:, :, lo:hi].contiguous().requires_grad_()
                  for x in (q, k, v)]
        lse = None
        if impl == "ring":
            o, lse = ring_attention_with_lse(*shards, mesh.group("sp"),
                                             causal=True, use_flash=True)
        else:
            o = ulysses(*shards)
        grads = torch.autograd.grad(o, shards, do[:, :, lo:hi])
        out["attention"][impl] = [x.detach().cpu() for x in (o, *grads)]
        out["attention"][impl + "_lse"] = (None if lse is None
                                           else lse.detach().cpu())
    del q, k, v, do, shards, o, grads, lse

    cfg = dataclasses.replace(MFU_CONFIG, max_seq_len=SP_SEQ)
    tokens = torch.randint(0, cfg.vocab, (1, SP_SEQ + 1),
                           generator=torch.Generator(device=device)
                           .manual_seed(seed + 1), device=device)
    real_backward = attn.flash_backward
    for impl in ("ring", "ulysses"):
        model = init_llama(cfg, generator=torch.Generator(device=device)
                           .manual_seed(seed), device=device, trainable=True)
        loss_fn = make_llama_sp_loss(cfg, mesh, impl=impl, use_flash=True,
                                     vocab_chunk=MFU_VOCAB_CHUNK)
        step, model, _ = make_sharded_train_step(loss_fn, model, mesh,
                                                 learning_rate=1e-4,
                                                 fsdp=False)
        # the probe: one forward and backward; the lse cotangents the
        # backward kernels see
        seen = {"backward_calls": 0, "with_g_lse": 0, "g_lse_max_abs": 0.0}

        def probe(*args, **kwargs):
            g_lse = args[6] if len(args) > 6 else kwargs.get("g_lse")
            seen["backward_calls"] += 1
            if g_lse is not None:
                seen["with_g_lse"] += 1
                seen["g_lse_max_abs"] = max(seen["g_lse_max_abs"],
                                            g_lse.abs().max().item())
            return real_backward(*args, **kwargs)

        attn.flash_backward = probe
        try:
            loss = loss_fn(model, tokens)
            loss.backward()
        finally:
            attn.flash_backward = real_backward
        world = comm.world()
        named = dict(model.named_parameters())
        probe_loss = float(comm.all_reduce_(loss.detach().float().clone(),
                                            world))
        probe_grads = {name: comm.all_reduce_(
            named[name].grad.float().clone(), world).cpu()
            for name in SP_PROBE}
        model.zero_grad(set_to_none=True)
        del loss
        # the probe warmed the kernels, the allocator and the groups
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        for name in attn.LAUNCHES:
            attn.LAUNCHES[name] = 0
        comm.reset_stats()
        t0 = time.perf_counter()
        for _ in range(SP_STEPS):
            last = step(tokens)
        last = float(last)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / SP_STEPS
        launches = dict(attn.LAUNCHES)
        stats = comm.stats()
        out[impl] = {
            "probe_loss": probe_loss, "probe_grads": probe_grads,
            "probe_backward": seen, "last_loss": last,
            "step_ms": 1e3 * step_s,
            "launches_per_step": {k: v / SP_STEPS
                                  for k, v in launches.items()},
            "launches": launches,
            "comm_per_step": {k: v / SP_STEPS for k, v in stats.items()},
            "peak_bytes": torch.cuda.max_memory_allocated(device),
        }
        del model, step, loss_fn
        gc.collect()
        torch.cuda.empty_cache()
    return out


# Phase 19: the reference's multi-device paths (__graft_entry__.py's
# dry run) at llama3_8b() widths, 4 rank processes on the card, each leg
# against one process at the same weights and inputs. Depth is cut to
# fit the time and four ranks' memory on one card: (a) 2 layers, (b) 8.
MC_RANKS = 4
MC_TP_LAYERS = 2
MC_TP_TOKENS = (2, 2049)
MC_TP_STEPS = 3
MC_TP_PROBE = ("final_norm", "layers.0.wq", "layers.0.wk",
               "layers.1.w_down", "layers.1.mlp_norm")
MC_PP_LAYERS = 8
MC_PP = 4
MC_PP_TOKENS = (4, 2048)
MC_PP_MICROBATCHES = 4
MC_PP_PROBE = ("attn_norm", "wq", "wk", "wo")
MC_MOE = dict(dim=4096, mlp_dim=14336, experts=4, top_k=2,
              capacity_factor=1.25)
MC_MOE_TOKENS = (2, 2048)
# (d): the workload CLI's Llama (cmd/workload.py) on 8 rows of 256
# tokens, AdamW 1e-3, two steps at each membership; then the run is
# checkpointed, restored and resumed on 3 ranks for two steps on the
# first 6 rows (which divide by 3)
MC_ELASTIC_CFG = dict(vocab=2048, dim=256, layers=4, num_heads=8,
                      num_kv_heads=4, mlp_dim=512, max_seq_len=256)
MC_ELASTIC_TOKENS = (8, 256)
MC_ELASTIC_RANKS = ((0, 1, 2, 3), (0, 1), (0, 1, 2, 3))
MC_ELASTIC_ONE = ((0,), (0,), (0,))       # one process: the same steps
MC_ELASTIC_RESUME = (0, 1, 2)
MC_ELASTIC_RESUME_ROWS = 6
MC_ELASTIC_STEPS = 2
MC_LR = 1e-4
# (b) and (c) against one process: outputs by each row's norm (the
# pipeline runs microbatches of 1 where one process runs the batch, so
# cuBLAS may sum in another order; bf16 activations), as phase 18's.
# (c)'s aux is float32 from the same router probabilities: 1e-5. (d)'s
# loss trajectory: the members' gradients summed in float32 in another
# order than one process's, through bf16 products, 6 AdamW steps of
# 1e-3: 5e-3 relative.
MC_AUX_TOL = 1e-5
MC_ELASTIC_REL_TOL = 5e-3


def mc_gen(device, seed: int):
    import torch

    return torch.Generator(device=device).manual_seed(seed)


def mc_tokens(device, seed: int, shape, vocab: int):
    import torch

    return torch.randint(0, vocab, shape, generator=mc_gen(device, seed),
                         device=device)


def mc_configs():
    from kubeshare_tpu_torch.models.llama import LlamaConfig, llama3_8b
    from kubeshare_tpu_torch.models.moe import MoeConfig

    return {"tp": dataclasses.replace(llama3_8b(), layers=MC_TP_LAYERS),
            "pp": dataclasses.replace(llama3_8b(), layers=MC_PP_LAYERS),
            "moe": MoeConfig(**MC_MOE),
            "elastic": LlamaConfig(**MC_ELASTIC_CFG)}


def mc_elastic_batches(device, seed: int):
    """The shared global batches of (d): MC_ELASTIC_STEPS for each
    membership and for the resumed run."""
    return [mc_tokens(device, seed + 10 + i, MC_ELASTIC_TOKENS,
                      MC_ELASTIC_CFG["vocab"])
            for i in range((len(MC_ELASTIC_RANKS) + 1) * MC_ELASTIC_STEPS)]


def mc_reset(device) -> None:
    """Zero the kernel counts and comm's stats, and the peak memory."""
    import importlib

    import torch

    from kubeshare_tpu_torch.parallel import comm

    attn = importlib.import_module("kubeshare_tpu_torch.ops.attention")
    torch.cuda.synchronize()
    for name in attn.LAUNCHES:
        attn.LAUNCHES[name] = 0
    comm.reset_stats()
    torch.cuda.reset_peak_memory_stats(device)


def mc_read(device, seconds: float, runs: int = 1) -> dict:
    """Per-run kernel launches, comm stats, ms, and the peak memory,
    since ``mc_reset``."""
    import importlib

    import torch

    from kubeshare_tpu_torch.parallel import comm

    attn = importlib.import_module("kubeshare_tpu_torch.ops.attention")
    return {"ms": 1e3 * seconds / runs,
            "launches": {k: v / runs for k, v in attn.LAUNCHES.items()},
            "comm": {k: v / runs for k, v in comm.stats().items()},
            "peak_bytes": torch.cuda.max_memory_allocated(device)}


def mc_leg_tp(device, seed: int, mesh) -> dict:
    """(a): the FSDP x TP step on ``mesh`` (one process: a mesh of one).
    Step 0's loss and this rank's blocks of the probe gradients, then
    MC_TP_STEPS AdamW steps timed."""
    import torch

    from kubeshare_tpu_torch.bench.kernels import MFU_VOCAB_CHUNK
    from kubeshare_tpu_torch.models.llama import init_llama, llama_loss
    from kubeshare_tpu_torch.parallel import make_sharded_train_step
    from kubeshare_tpu_torch.parallel.sharding import build_param_specs

    cfg = mc_configs()["tp"]
    model = init_llama(cfg, generator=mc_gen(device, seed), device=device,
                       trainable=True)
    tokens = mc_tokens(device, seed + 2, MC_TP_TOKENS, cfg.vocab)
    step, model, _ = make_sharded_train_step(
        lambda m, t: llama_loss(m, t, vocab_chunk=MFU_VOCAB_CHUNK), model,
        mesh, learning_rate=MC_LR)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    progress(f"rank {mesh.rank}: (a) placed")
    loss0, grads = step.value_and_grad(tokens)
    out = {"loss0": float(loss0),
           "probe": {n: g.float().cpu() for n, g in zip(names, grads)
                     if n in MC_TP_PROBE},
           "mesh": {"shape": mesh.shape, "coords": mesh.coords},
           "specs": {n: s for n, s in build_param_specs(model).items()
                     if n in MC_TP_PROBE}}
    del loss0, grads
    mc_reset(device)
    t0 = time.perf_counter()
    out["losses"] = [float(step(tokens)) for _ in range(MC_TP_STEPS)]
    torch.cuda.synchronize()
    out.update(mc_read(device, time.perf_counter() - t0, MC_TP_STEPS))
    return out


def mc_pp_inputs(device, seed: int):
    """(b)'s model (bf16, no gradients), tokens and output cotangent."""
    import torch

    from kubeshare_tpu_torch.models.llama import init_llama

    cfg = mc_configs()["pp"]
    model = init_llama(cfg, generator=mc_gen(device, seed + 3),
                       device=device)
    tokens = mc_tokens(device, seed + 4, MC_PP_TOKENS, cfg.vocab)
    g = torch.randn(*MC_PP_TOKENS, cfg.dim, generator=mc_gen(
        device, seed + 5), device=device).bfloat16()
    return model, tokens, g


def mc_timed_pass(device, run) -> tuple:
    """``run()`` once for its results, then once more timed."""
    import torch

    first = run()
    mc_reset(device)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return first, mc_read(device, time.perf_counter() - t0)


def mc_leg_pp_one(device, seed: int) -> dict:
    """(b) in one process: ``llama_hidden`` (remat on) and the gradients
    of ``sum(hidden * g)`` for every layer's probe leaves."""
    import torch

    from kubeshare_tpu_torch.models.llama import llama_hidden

    model, tokens, g = mc_pp_inputs(device, seed)
    model.layers.requires_grad_()

    def run():
        model.zero_grad(set_to_none=True)
        hidden = llama_hidden(model, tokens, remat=True)
        (hidden.float() * g.float()).sum().backward()
        return {"hidden": hidden.detach().cpu(),
                "probe": {k: torch.stack([getattr(layer, k).grad
                                          for layer in model.layers]).cpu()
                          for k in MC_PP_PROBE}}

    first, timed = mc_timed_pass(device, run)
    return {**first, **timed}


def mc_leg_pp(device, seed: int, mesh) -> dict:
    """(b) on a pp rank: this rank's block of the stacked layers, the
    pipeline's hidden (rank 0) and the block's probe gradients."""
    from torch import nn

    from kubeshare_tpu_torch.models.llama import (
        llama_pipeline_hidden, llama_stack_layers,
    )
    from kubeshare_tpu_torch.parallel import shard_stacked_params

    model, tokens, g = mc_pp_inputs(device, seed)
    block = shard_stacked_params(llama_stack_layers(model), mesh)
    model.layers = nn.ModuleList()     # this rank keeps its block only
    gc.collect()
    for leaf in block.values():
        leaf.requires_grad_()

    def run():
        for leaf in block.values():
            leaf.grad = None
        hidden = llama_pipeline_hidden(model, tokens, mesh,
                                       MC_PP_MICROBATCHES,
                                       stacked_layers=block, remat=True)
        (hidden.float() * g.float()).sum().backward()
        return {"hidden": hidden.detach().cpu() if mesh.rank == 0 else None,
                "probe": {k: block[k].grad.cpu() for k in MC_PP_PROBE}}

    first, timed = mc_timed_pass(device, run)
    return {"first": block.first, **first, **timed}


def mc_leg_moe(device, seed: int, mesh=None) -> dict:
    """(c): MoE on this rank's experts over ``mesh`` (None: all four in
    one process): y (rank 0), aux, the gradients of ``sum(y * g) + aux``
    for x (rank 0), the router and this rank's experts' w_down, and each
    token's capacity slots (fewer than top_k: a drop)."""
    import torch

    from kubeshare_tpu_torch.models.moe import (
        _dispatch_tensors, init_moe_ffn, moe_capacity, moe_ffn_apply,
        moe_param_spec,
    )
    from kubeshare_tpu_torch.parallel import shard_tensor

    cfg = mc_configs()["moe"]
    params = init_moe_ffn(cfg, mc_gen(device, seed + 6), device)
    if mesh is not None:
        specs = moe_param_spec()
        params = {k: shard_tensor(v, specs[k], mesh)
                  for k, v in params.items()}
    for p in params.values():
        p.requires_grad_()
    gen = mc_gen(device, seed + 7)
    x = torch.randn(*MC_MOE_TOKENS, cfg.dim, generator=gen,
                    device=device).bfloat16().requires_grad_()
    gy = torch.randn(*MC_MOE_TOKENS, cfg.dim, generator=gen,
                     device=device).bfloat16()
    lead = mesh is None or mesh.rank == 0

    def run():
        x.grad = None
        for p in params.values():
            p.grad = None
        y, aux = moe_ffn_apply(params, x, cfg, mesh)
        ((y.float() * gy.float()).sum() + aux).backward()
        return {"y": y.detach().cpu() if lead else None,
                "aux": float(aux.detach()),
                "dx": x.grad.cpu() if lead else None,
                "router_grad": params["router"].grad.float().cpu(),
                "w_down_grad": params["w_down"].grad.bfloat16().cpu()}

    first, timed = mc_timed_pass(device, run)
    with torch.no_grad():
        probs = torch.softmax(x.reshape(-1, cfg.dim).float()
                              @ params["router"].t(), dim=-1)
        capacity = moe_capacity(cfg, probs.shape[0])
        dispatch, _ = _dispatch_tensors(probs, cfg, capacity)
    return {**first, **timed, "capacity": capacity,
            "slots": dispatch.sum(dim=(1, 2)).cpu()}


def mc_leg_elastic(device, seed: int, memberships, resume_ranks,
                   directory: str) -> dict:
    """(d): an ElasticTrainer on the workload CLI's Llama through
    ``memberships`` (resized before each but the first), MC_ELASTIC_STEPS
    steps each on the shared global batches; then the run is saved to
    ``directory`` (by rank 0) and, as after the whole job died, restored
    into a fresh model and resumed by a new trainer over
    ``resume_ranks`` with the AdamW state and the step count, for
    MC_ELASTIC_STEPS steps on the first MC_ELASTIC_RESUME_ROWS rows;
    None where this rank idled."""
    import torch

    from kubeshare_tpu_torch.models.checkpoint import (
        restore_checkpoint, save_checkpoint,
    )
    from kubeshare_tpu_torch.models.llama import init_llama, llama_loss
    from kubeshare_tpu_torch.parallel import ElasticTrainer, comm

    model = init_llama(mc_configs()["elastic"],
                       generator=mc_gen(device, seed + 8), device=device,
                       trainable=True)
    batches = iter(mc_elastic_batches(device, seed))
    mc_reset(device)
    t0 = time.perf_counter()
    trainer = ElasticTrainer(lambda m, t: llama_loss(m, t), model,
                             learning_rate=1e-3, ranks=memberships[0])
    losses = []
    for i, ranks in enumerate(memberships):
        if i:
            trainer.resize(ranks)
        for _ in range(MC_ELASTIC_STEPS):
            loss = trainer.step(next(batches))
            losses.append(None if loss is None else float(loss))
    if trainer.rank == 0:
        save_checkpoint(directory, trainer.steps, trainer.model,
                        trainer.optimizer)
    if comm.world() is not None:
        comm.barrier(comm.world())
    model = init_llama(mc_configs()["elastic"],
                       generator=mc_gen(device, seed + 9), device=device,
                       trainable=True)
    step, _, opt_state = restore_checkpoint(directory, model)
    reborn = ElasticTrainer(lambda m, t: llama_loss(m, t), model,
                            learning_rate=1e-3, ranks=resume_ranks,
                            opt_state=opt_state, steps=step)
    for _ in range(MC_ELASTIC_STEPS):
        loss = reborn.step(next(batches)[:MC_ELASTIC_RESUME_ROWS])
        losses.append(None if loss is None else float(loss))
    torch.cuda.synchronize()
    return {"losses": losses, "generation": trainer.generation,
            "steps": trainer.steps, "dp": trainer.dp,
            "restored_step": step, "resumed_steps": reborn.steps,
            "resumed_dp": reborn.dp,
            **mc_read(device, time.perf_counter() - t0)}


def mc_free() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def multichip_rank(joined, seed: int, directory: str) -> dict:
    """One rank of phase 19's world (module docstring): the FSDP x TP
    step, the pipeline trunk, MoE over ep and the elastic trainer, each
    on this rank's part, each leg's memory freed before the next.
    Returns CPU tensors and numbers."""
    from kubeshare_tpu_torch.parallel import (
        MeshPlan, factorize_devices, make_mesh,
    )

    device = joined.device
    out = {"backend": joined.backend}
    progress(f"rank {joined.rank}: (a) fsdp x tp")
    out["tp"] = mc_leg_tp(device, seed, make_mesh(factorize_devices(
        joined.world, tp_max=2, fsdp_max=2)))
    mc_free()
    progress(f"rank {joined.rank}: (b) pipeline")
    out["pp"] = mc_leg_pp(device, seed, make_mesh(MeshPlan(pp=MC_PP)))
    mc_free()
    progress(f"rank {joined.rank}: (c) moe")
    out["moe"] = mc_leg_moe(device, seed, make_mesh(MeshPlan(ep=MC_RANKS)))
    mc_free()
    progress(f"rank {joined.rank}: (d) elastic")
    out["elastic"] = mc_leg_elastic(device, seed, MC_ELASTIC_RANKS,
                                    MC_ELASTIC_RESUME, directory)
    return out


def multichip_phase(device, seed: int, smi: str) -> dict:
    """Phase 19 but its kernel rows (module docstring): each leg in one
    process first, then the 4-rank world, each leg held against its one
    process, then ``dryrun_multichip(4)``. Returns what the kernel rows
    need: the configs, the tp plan and each rank's documents."""
    import torch

    from kubeshare_tpu_torch import entry as port_entry
    from kubeshare_tpu_torch.bench.kernels import MFU_VOCAB_CHUNK
    from kubeshare_tpu_torch.ops.attention import LAUNCHES
    from kubeshare_tpu_torch.parallel import (
        MeshPlan, factorize_devices, make_mesh, shard_tensor,
    )
    from kubeshare_tpu_torch.parallel.launch import run_world

    def rel_err(got, want) -> float:
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max().clamp_min(1e-30)).item()

    mc_cfgs = mc_configs()
    # one process first, each leg's memory freed before the next and
    # before the world starts
    progress("phase 19: one process")
    mc_one = {"tp": mc_leg_tp(device, seed, make_mesh(MeshPlan()))}
    mc_free()
    mc_one["pp"] = mc_leg_pp_one(device, seed)
    mc_free()
    mc_one["moe"] = mc_leg_moe(device, seed)
    mc_free()
    with tempfile.TemporaryDirectory(prefix="smoke-elastic-") as ckpt:
        mc_one["elastic"] = mc_leg_elastic(device, seed, MC_ELASTIC_ONE,
                                           (0,), ckpt)
    mc_free()
    moe_cfg = mc_cfgs["moe"]
    progress("phase 19: one process done; the world starts")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke-elastic-") as ckpt:
        mc_world = run_world(multichip_rank, MC_RANKS, args=(seed, ckpt),
                             timeout=900, device_type=device.type)
    mc_world_s = time.perf_counter() - t0

    # (a) against one process: step 0's loss, the probe gradients
    # reassembled from each rank's blocks
    one_tp = mc_one["tp"]
    tp_docs = [r["tp"] for r in mc_world]
    tp_plan = factorize_devices(MC_RANKS, tp_max=2, fsdp_max=2)
    grad_rel = {}
    for name in MC_TP_PROBE:
        whole = one_tp["probe"][name]
        # each rank's block against the same block of one process's
        # gradient, over that whole gradient's max abs
        grad_rel[name] = max(
            ((d["probe"][name] - shard_tensor(
                whole, d["specs"][name], types.SimpleNamespace(**d["mesh"])))
             .abs().max() / whole.abs().max()).item() for d in tp_docs)
    tp_loss_rel = max(abs(d["loss0"] - one_tp["loss0"]) / abs(
        one_tp["loss0"]) for d in tp_docs)
    emit({"phase": "multichip_fsdp_tp", "card": smi,
          "config": dataclasses.asdict(mc_cfgs["tp"]),
          "mesh": dataclasses.asdict(tp_plan), "tokens": list(MC_TP_TOKENS),
          "vocab_chunk": MFU_VOCAB_CHUNK, "steps_timed": MC_TP_STEPS,
          "loss0": [d["loss0"] for d in tp_docs],
          "one_process_loss0": one_tp["loss0"], "loss_rel_err": tp_loss_rel,
          "loss_rel_tol": SP_LOSS_REL_TOL, "grad_rel_err": grad_rel,
          "grad_rel_tol": GRAD_REL_TOL,
          "losses": [d["losses"] for d in tp_docs],
          "step_ms": [d["ms"] for d in tp_docs],
          "one_process_step_ms": one_tp["ms"],
          "launches_per_rank_step": [d["launches"] for d in tp_docs],
          "one_process_launches_per_step": one_tp["launches"],
          "comm_per_rank_step": [d["comm"] for d in tp_docs],
          "peak_bytes_per_rank": [d["peak_bytes"] for d in tp_docs],
          "one_process_peak_bytes": one_tp["peak_bytes"],
          "backends": [r["backend"] for r in mc_world],
          "world_seconds": mc_world_s})
    check(tp_loss_rel <= SP_LOSS_REL_TOL
          and max(grad_rel.values()) <= GRAD_REL_TOL,
          f"FSDP x TP against one process: loss {tp_loss_rel}, "
          f"gradients {grad_rel}")
    for r, d in enumerate(tp_docs):
        check(all(math.isfinite(x) for x in d["losses"]),
              f"FSDP x TP rank {r}: losses {d['losses']}")
        check(all(d["launches"][k] == MC_TP_LAYERS for k in LAUNCHES),
              f"FSDP x TP rank {r}: launches a step {d['launches']}, "
              f"want {MC_TP_LAYERS} of each kernel (one a layer)")

    # (b) against one process: hidden rows, each rank's layers' gradients
    one_pp = mc_one["pp"]
    pp_docs = [r["pp"] for r in mc_world]
    pp_row_rel = row_rel_err(pp_docs[0]["hidden"], one_pp["hidden"])
    per = MC_PP_LAYERS // MC_PP
    pp_grad_rel = {k: max(rel_err(d["probe"][k], one_pp["probe"][k][
        d["first"]:d["first"] + per]) for d in pp_docs)
        for k in MC_PP_PROBE}
    emit({"phase": "multichip_pipeline", "card": smi,
          "config": dataclasses.asdict(mc_cfgs["pp"]), "pp": MC_PP,
          "tokens": list(MC_PP_TOKENS),
          "microbatches": MC_PP_MICROBATCHES, "remat": True,
          "hidden_row_rel_err": pp_row_rel, "row_rel_tol": SP_ROW_REL_TOL,
          "grad_rel_err": pp_grad_rel, "grad_rel_tol": GRAD_REL_TOL,
          "pass_ms": [d["ms"] for d in pp_docs],
          "one_process_pass_ms": one_pp["ms"],
          "launches_per_rank_pass": [d["launches"] for d in pp_docs],
          "one_process_launches_per_pass": one_pp["launches"],
          "comm_per_rank_pass": [d["comm"] for d in pp_docs],
          "peak_bytes_per_rank": [d["peak_bytes"] for d in pp_docs],
          "one_process_peak_bytes": one_pp["peak_bytes"]})
    check(pp_row_rel <= SP_ROW_REL_TOL
          and max(pp_grad_rel.values()) <= GRAD_REL_TOL,
          f"the pipeline against one process: rows {pp_row_rel}, "
          f"gradients {pp_grad_rel}")
    for r, d in enumerate(pp_docs):
        check(all(d["launches"][k] > 0 for k in LAUNCHES),
              f"pipeline rank {r} did not launch every kernel: "
              f"{d['launches']}")

    # (c) against one process
    one_moe = mc_one["moe"]
    moe_docs = [r["moe"] for r in mc_world]
    moe_row_rel = row_rel_err(moe_docs[0]["y"], one_moe["y"])
    moe_aux_err = max(abs(d["aux"] - one_moe["aux"]) for d in moe_docs)
    same_slots = all(torch.equal(d["slots"], one_moe["slots"])
                     for d in moe_docs)
    dropped = int((one_moe["slots"] < moe_cfg.top_k).sum())
    moe_grad_rel = {
        "x": rel_err(moe_docs[0]["dx"], one_moe["dx"]),
        "router": max(rel_err(d["router_grad"], one_moe["router_grad"])
                      for d in moe_docs),
        "w_down": max(rel_err(d["w_down_grad"], one_moe["w_down_grad"][
            r:r + 1]) for r, d in enumerate(moe_docs))}
    emit({"phase": "multichip_moe", "card": smi,
          "config": dataclasses.asdict(moe_cfg), "ep": MC_RANKS,
          "x": [*MC_MOE_TOKENS, moe_cfg.dim],
          "capacity": one_moe["capacity"],
          "dropped_assignments": int((moe_cfg.top_k - one_moe["slots"])
                                     .sum()),
          "tokens_with_a_drop": dropped, "same_drops": same_slots,
          "y_row_rel_err": moe_row_rel, "row_rel_tol": SP_ROW_REL_TOL,
          "aux": [d["aux"] for d in moe_docs],
          "one_process_aux": one_moe["aux"], "aux_err": moe_aux_err,
          "aux_tol": MC_AUX_TOL, "grad_rel_err": moe_grad_rel,
          "grad_rel_tol": GRAD_REL_TOL,
          "pass_ms": [d["ms"] for d in moe_docs],
          "one_process_pass_ms": one_moe["ms"],
          "comm_per_rank_pass": [d["comm"] for d in moe_docs],
          "peak_bytes_per_rank": [d["peak_bytes"] for d in moe_docs],
          "one_process_peak_bytes": one_moe["peak_bytes"]})
    check(moe_row_rel <= SP_ROW_REL_TOL and moe_aux_err <= MC_AUX_TOL
          and same_slots and max(moe_grad_rel.values()) <= GRAD_REL_TOL,
          f"MoE over ep against one process: rows {moe_row_rel}, aux "
          f"{moe_aux_err}, same drops {same_slots}, grads {moe_grad_rel}")

    # (d) the elastic trajectory, the checkpoint and the resumed run
    el_docs = [r["elastic"] for r in mc_world]
    one_losses = mc_one["elastic"]["losses"]
    el_rel = max(abs(a - b) / abs(b) for a, b in zip(
        el_docs[0]["losses"], one_losses))
    steps_saved = len(MC_ELASTIC_RANKS) * MC_ELASTIC_STEPS
    emit({"phase": "multichip_elastic", "card": smi,
          "config": MC_ELASTIC_CFG, "tokens": list(MC_ELASTIC_TOKENS),
          "memberships": [list(m) for m in MC_ELASTIC_RANKS],
          "resumed_on": list(MC_ELASTIC_RESUME),
          "resumed_rows": MC_ELASTIC_RESUME_ROWS,
          "restored_step": [d["restored_step"] for d in el_docs],
          "resumed_steps": [d["resumed_steps"] for d in el_docs],
          "resumed_dp": [d["resumed_dp"] for d in el_docs],
          "losses": [d["losses"] for d in el_docs],
          "one_process_losses": one_losses, "loss_rel_err": el_rel,
          "loss_rel_tol": MC_ELASTIC_REL_TOL,
          "generation": [d["generation"] for d in el_docs],
          "steps": [d["steps"] for d in el_docs],
          "run_ms": [d["ms"] for d in el_docs],
          "one_process_run_ms": mc_one["elastic"]["ms"],
          "launches_per_rank": [d["launches"] for d in el_docs],
          "comm_per_rank": [d["comm"] for d in el_docs]})
    check(el_rel <= MC_ELASTIC_REL_TOL
          and len(one_losses) == len(el_docs[0]["losses"])
          == steps_saved + MC_ELASTIC_STEPS
          and all(d["generation"] == 2 for d in el_docs)
          and el_docs[2]["losses"][2:4] == [None, None]
          and el_docs[3]["losses"][steps_saved:] == [None] * MC_ELASTIC_STEPS
          and all(d["restored_step"] == steps_saved for d in el_docs)
          and all(el_docs[r]["resumed_steps"]
                  == steps_saved + MC_ELASTIC_STEPS
                  and el_docs[r]["resumed_dp"] == len(MC_ELASTIC_RESUME)
                  for r in MC_ELASTIC_RESUME),
          f"elastic 4 -> 2 -> 4 -> checkpoint -> 3: {el_docs} against "
          f"{one_losses}")
    for r, d in enumerate(el_docs):
        check(all(d["launches"][k] > 0 for k in LAUNCHES),
              f"elastic rank {r} did not launch every kernel: "
              f"{d['launches']}")

    # (e) the dry run on the card, on the kernels: every count set to 0
    # just before it (each rank process zeroes its own, and so does each
    # cross-process worker) and read just after
    progress("phase 19: dryrun_multichip(4)")
    t0 = time.perf_counter()
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        dry_run = port_entry.dryrun_multichip(MC_RANKS, device=device)
    dry = captured.getvalue().strip().splitlines()
    dry_ranks, crossproc = dry_run["ranks"], dry_run["crossproc_launches"]
    emit({"phase": "multichip_dryrun", "card": smi, "tail": dry[-1],
          "lines": dry[:-1], "seconds": time.perf_counter() - t0,
          "launches_per_rank": [r["launches"] for r in dry_ranks],
          "leg_launches_per_rank": [r["leg_launches"] for r in dry_ranks],
          "crossproc_launches": crossproc})
    check("crossproc=ok" in dry[-1] and "attention=flash kernels" in dry[-1],
          f"dryrun_multichip(4): {dry}")
    for r, d in enumerate(dry_ranks):
        legs = d["leg_launches"]
        check(all(d["launches"][k] > 0 for k in LAUNCHES)
              and all(legs["train"][k] > 0 for k in LAUNCHES)
              and all(legs[leg]["flash_fwd"] > 0
                      for leg in ("sp_attention", "sp_loss", "pipeline")),
              f"dryrun rank {r} did not launch every kernel: {legs}")
    check(len(crossproc) == port_entry.CROSSPROC_PROCESSES
          and all(c[k] > 0 for c in crossproc for k in LAUNCHES),
          f"the dry run's cross-process workers' launches: {crossproc}")

    return {"cfgs": mc_cfgs, "tp_plan": tp_plan, "tp": tp_docs,
            "pp": pp_docs, "dry_ranks": dry_ranks, "crossproc": crossproc}


# Phase 20: an unmodified PyTorch pod program (the interposer's counters
# read through ctypes, as any program may read them): the devices it
# sees, device 0's uuid, and a few matmul and attention steps. It exits 3
# when it sees no device.
ADMITTED_POD = r"""
import ctypes, json, sys
import torch
import torch.nn.functional as F
if not torch.cuda.is_available():
    print(json.dumps({"device_count": torch.cuda.device_count()}))
    sys.exit(3)
gen = torch.Generator(device="cuda").manual_seed(0)
x = torch.randn(4096, 4096, device="cuda", generator=gen) / 64
q = torch.randn(1, 16, 2048, 64, device="cuda", dtype=torch.bfloat16,
                generator=gen)
for _ in range(8):
    x = torch.tanh(x @ x)
    q = F.scaled_dot_product_attention(q, q, q, is_causal=True)
torch.cuda.synchronize()
stats = getattr(ctypes.CDLL(None), "kubeshare_cuda_interposer_stats", None)
if stats is not None:
    stats.restype = ctypes.c_char_p
    stats = json.loads(stats().decode())
print(json.dumps({"device_count": torch.cuda.device_count(),
                  "uuid": str(torch.cuda.get_device_properties(0).uuid),
                  "finite": bool(torch.isfinite(x).all()
                                 and torch.isfinite(q).all()),
                  "interposer": stats}))
"""
# a uuid no card has
NO_CARD_UUID = "GPU-00000000-0000-0000-0000-000000000000"


def json_patch(doc, patches):
    """``doc`` with a JSONPatch of "add" operations applied."""
    for patch in patches:
        check(patch["op"] == "add", f"unexpected patch {patch}")
        parts = [p for p in patch["path"].split("/") if p]
        target = doc
        for key in parts[:-1]:
            target = target[int(key)] if isinstance(target, list) \
                else target[key]
        if parts[-1] == "-":
            target.append(patch["value"])
        else:
            target[parts[-1]] = patch["value"]
    return doc


def admission_phase(uuid: str, smi: str) -> dict:
    """Phase 20 (module docstring): the webhook's patches, the installed
    interposer, the card's uuid as the scheduler's contract and a live
    tpu-pmgr under an unmodified PyTorch child; then a child given a
    uuid no card has."""
    import base64
    import urllib.request

    from kubeshare_tpu_torch.bench import node as node_bench
    from kubeshare_tpu_torch.bench.arbiter import free_port
    from kubeshare_tpu_torch.cluster.labels import (
        LABEL_TPU_LIMIT, LABEL_TPU_REQUEST, SCHEDULER_NAME,
    )
    from kubeshare_tpu_torch.cluster.webhook import WebhookServer
    from kubeshare_tpu_torch.constants import (
        ENV_POD_MANAGER_PORT, ENV_POD_NAME, ENV_VISIBLE_CHIPS, LIBRARY_PATH,
    )
    from kubeshare_tpu_torch.nodeconfig.daemon import NodeConfigDaemon
    from kubeshare_tpu_torch.runtime.launcher import NodeLauncher
    from kubeshare_tpu_torch.runtime.native import install_interposer

    pod = {"metadata": {"name": "admitted", "namespace": "smoke",
                        "labels": {LABEL_TPU_REQUEST: "0.5",
                                   LABEL_TPU_LIMIT: "1.0"}},
           "spec": {"schedulerName": SCHEDULER_NAME,
                    "containers": [{"name": "main", "image": "pod"}]}}
    review = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
              "request": {"uid": "smoke-20", "kind": {"kind": "Pod"},
                          "object": pod}}
    server = WebhookServer(host="127.0.0.1", port=0).start()
    try:
        request = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/mutate",
            data=json.dumps(review).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=10) as resp:
            answer = json.loads(resp.read())["response"]
    finally:
        server.stop()
    check(answer["allowed"] and answer.get("patchType") == "JSONPatch",
          f"the webhook did not patch the pod: {answer}")
    patches = json.loads(base64.b64decode(answer["patch"]))
    admitted = json_patch(pod, patches)
    pod_env = {e["name"]: e["value"]
               for e in admitted["spec"]["containers"][0]["env"]}

    ports = {name: free_port() for name in node_bench.PODS}
    with tempfile.TemporaryDirectory(prefix="smoke-admission-") as tmp:
        library = os.path.join(tmp, "library")
        installed = str(install_interposer(library))
        # the hostPath mount, for a child on this machine: the node's
        # library directory is the temporary one
        rewritten = {k: v.replace(LIBRARY_PATH, library)
                     for k, v in pod_env.items()}
        progress(f"phase 20: {LIBRARY_PATH} rewritten to {library}")
        base = os.path.join(tmp, "node")
        NodeConfigDaemon(node_bench.NODE, base,
                         lambda: node_bench.requirement_samples(
                             uuid, ports)).sync()
        launcher = NodeLauncher(base, [uuid], base_port=free_port(),
                                window_ms=node_bench.WINDOW_MS,
                                lease_slots=node_bench.SLOTS)
        try:
            launcher.start_arbiters()
            node_bench._wait_port(launcher.chips[uuid].port)
            launcher.reconcile()
            node_bench._wait_port(ports["pod-a"])
            clean = {k: v for k, v in os.environ.items()
                     if not k.startswith("KUBESHARE_")
                     and k not in ("LD_PRELOAD", "CUDA_VISIBLE_DEVICES",
                                   ENV_VISIBLE_CHIPS)}
            runs = {}
            for name, chips in (("admitted", uuid), ("no_card",
                                                     NO_CARD_UUID)):
                env = {**clean, **rewritten, ENV_VISIBLE_CHIPS: chips,
                       ENV_POD_MANAGER_PORT: str(ports["pod-a"]),
                       ENV_POD_NAME: "smoke/pod-a"}
                t0 = time.perf_counter()
                proc = subprocess.run([sys.executable, "-c", ADMITTED_POD],
                                      env=env, capture_output=True,
                                      text=True, timeout=300)
                lines = proc.stdout.strip().splitlines()
                runs[name] = {
                    "rc": proc.returncode,
                    "seconds": time.perf_counter() - t0,
                    "doc": json.loads(lines[-1]) if lines else None,
                    "interposer_log": [
                        line for line in proc.stderr.splitlines()
                        if line.startswith("[cuda-interposer]")],
                    "stderr_tail": proc.stderr[-1500:]}
        finally:
            launcher.shutdown()
    good, bogus = runs["admitted"], runs["no_card"]
    doc = good["doc"] or {}
    child_uuid = doc.get("uuid", "")
    if child_uuid and not child_uuid.startswith(("GPU-", "MIG-")):
        child_uuid = "GPU-" + child_uuid
    stats = doc.get("interposer") or {}
    result = {"phase": "admission", "card": smi,
              "patches": patches, "pod_env": pod_env,
              "library_dir_rewritten": {LIBRARY_PATH: library},
              "installed": installed, "contract": uuid,
              "child_uuid": child_uuid,
              "child_device_count": doc.get("device_count"),
              "child_finite": doc.get("finite"),
              "interposer": {k: v for k, v in stats.items()
                             if k != "functions"},
              "interposer_kernels": len(stats.get("functions", {})),
              "interposer_log": good["interposer_log"],
              "admitted_rc": good["rc"], "admitted_s": good["seconds"],
              "no_card_rc": bogus["rc"], "no_card_doc": bogus["doc"],
              "no_card_log": bogus["interposer_log"]}
    emit(result)
    check(pod_env.get("LD_PRELOAD") == LIBRARY_PATH
          + "/libcuda_interposer.so" and os.path.basename(installed)
          == "libcuda_interposer.so",
          f"the webhook's env {pod_env}, installed {installed}")
    check(good["rc"] == 0 and child_uuid == uuid
          and doc.get("device_count") == 1 and doc.get("finite"),
          f"the admitted pod is not on its card: {good}")
    check(stats.get("mode") == "gated" and stats.get("acquires", 0) > 0
          and stats.get("launch", 0) + stats.get("launch_ex", 0) > 0
          and stats.get("visible_devices") == "set"
          and stats.get("visible_chips") == uuid,
          f"the admitted pod's interposer: {stats} {good['stderr_tail']}")
    check(bogus["rc"] != 0 and (bogus["doc"] or {}).get("device_count") == 0,
          f"a pod given {NO_CARD_UUID} still saw a card: {bogus}")
    return result


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
    # the reference's dry-run head dims (16: its bf16 Llama and its
    # float32 ring and Ulysses; 8: its float32 sp loss and pipeline, run
    # padded to 16) and 96 (padded to 128), at one shape long enough to
    # time
    small_d = {((1, 4, 2, 8192, 8192, 16), "bfloat16", True, 0): "_d16",
               ((1, 4, 2, 8192, 8192, 16), "float32", True, 0): "_d16_f32",
               ((1, 4, 2, 8192, 8192, 8), "float32", True, 0): "_d8_f32",
               ((1, 4, 2, 8192, 8192, 96), "bfloat16", True, 0): "_d96"}
    # the shapes phase 19 (e)'s dry run (entry.dryrun_multichip(4):
    # rank-local shards) gives the kernels, and its leg
    dryrun_cases = {
        # the bf16 Llama's train step: batch 2 a fsdp shard, 2 of 4 heads
        # and 1 of 2 kv heads a tp rank, T 16
        ((2, 2, 1, 16, 16, 16), "bfloat16", True, 0): "train",
        # ring attention: each rank's 8-row shard against its own (causal)
        # and an earlier one's (full)
        ((1, 2, 2, 8, 8, 16), "float32", True, 0): "ring",
        ((1, 2, 2, 8, 8, 16), "float32", False, 0): "ring",
        # Ulysses: 1 of 4 heads at the full T 32
        ((1, 1, 1, 32, 32, 16), "float32", True, 0): "ulysses",
        # the sp loss: its ring's hops, and llama_loss it is held to
        ((2, 4, 2, 8, 8, 8), "float32", True, 0): "sp_loss",
        ((2, 4, 2, 8, 8, 8), "float32", False, 0): "sp_loss",
        ((2, 4, 2, 32, 32, 8), "float32", True, 0): "sp_loss",
        # the pipeline: a microbatch of 2 in a stage, and llama_hidden
        ((2, 4, 2, 16, 16, 8), "float32", True, 0): "pipeline",
        ((4, 4, 2, 16, 16, 8), "float32", True, 0): "pipeline",
        # the cross-process step: a dp member's 2 rows, a tp rank's heads
        ((2, 2, 1, 8, 8, 8), "float32", True, 0): "crossproc",
    }
    # the timed cases and the suffix of their rows' kernel names
    timed = {main_case: "", cli_case: "_d32", entry_case: "_d32_entry",
             **small_d}
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
        *small_d,
        ((2, 4, 2, 300, 300, 16), "bfloat16", True, 64),
        ((1, 4, 2, 77, 333, 8), "float32", True, 0),
        ((1, 8, 2, 200, 200, 96), "bfloat16", False, 0),
        *dryrun_cases,
    ]
    fwd_rows = {}
    for shape, dtype_name, causal, window in cases:
        batch, heads, kv_heads, t_q, t_k, head_dim = shape
        dtype = getattr(torch, dtype_name)
        q = randn(batch, heads, t_q, head_dim, dtype=dtype)
        k = randn(batch, kv_heads, t_k, head_dim, dtype=dtype)
        v = randn(batch, kv_heads, t_k, head_dim, dtype=dtype)
        out, lse = flash_forward(q, k, v, causal, None, window)
        again, again_lse = flash_forward(q, k, v, causal, None, window)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_reference(q, k, v, causal, None,
                                                     window)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        # each output row's error over its norm, held where rows average
        # many keys (TOL's comment)
        row_rel = row_rel_err(out, ref_out)
        long_rows = t_k >= 2048
        identical = torch.equal(out, again) and torch.equal(lse, again_lse)
        check(torch.isfinite(out).all().item(), f"non-finite out {shape}")
        tol = TOL[dtype_name]
        case = (shape, dtype_name, causal, window)
        row = {"phase": "kernel", "shape": list(shape), "dtype": dtype_name,
               "causal": causal, "window": window,
               "native_head_dim": attn.native_head_dim(head_dim),
               "dryrun_leg": dryrun_cases.get(case),
               "max_abs_err": err_out, "lse_max_abs_err": err_lse,
               "out_row_rel_err": row_rel,
               "tol_out": tol["out"], "tol_lse": tol["lse"],
               "out_row_rel_tol": SP_ROW_REL_TOL if long_rows else None,
               "identical_on_repeat": identical}
        emit(row)
        check(err_out <= tol["out"] and err_lse <= tol["lse"] and identical
              and (not long_rows or row_rel <= SP_ROW_REL_TOL),
              f"flash kernel disagrees with its plain version: {row}")
        suffix = timed.get(case)
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
        del q, k, v, out, lse, again, again_lse, ref_out, ref_lse
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
    # phase 2's cases; an lse cotangent on some of them (the padded head
    # dim 8 and the dry run's ring hops among them), as a ring merge
    # would send it
    glse_cases = {2, 4, 9, 14} | {
        cases.index(c) for c in (
            ((1, 4, 2, 8192, 8192, 8), "float32", True, 0),
            ((1, 2, 2, 8, 8, 16), "float32", False, 0),
            ((2, 4, 2, 8, 8, 8), "float32", False, 0))}
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
               "dryrun_leg": dryrun_cases.get(
                   (shape, dtype_name, causal, window)),
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
            # each kernel on inputs padded once, here, to the native head
            # dim (the copies outside its time); the whole flash_backward
            # pads q, k, v, out and dO, computes delta', runs both
            # kernels and slices dq, dk and dv back on every call
            native = attn.native_head_dim(head_dim)
            kernel_in = (*attn.pad_head_dim(native, q, k, v, do), lse,
                         attn._flash_delta(out, do), causal,
                         head_dim ** -0.5, window)
            plain_ms = cuda_ms(lambda: flash_backward_reference(
                q, k, v, out, lse, do, None, causal, None, window), 5,
                warmup=1)
            # one timing per call moves: dq, dk/dv, the whole backward
            # and SDPA's backward (dq, dk and dv together) take turns
            ms = interleaved_ms({
                "flash_bwd_dq": lambda: attn._flash_bwd_dq_cuda(*kernel_in),
                "flash_bwd_dkv": lambda: attn._flash_bwd_dkv_cuda(
                    *kernel_in),
                "flash_backward": lambda: flash_backward(
                    q, k, v, out, lse, do, None, causal, None, window),
                "sdpa_bwd": sdpa_backward(q, k, v, do, causal)})
            emit({"phase": "kernel_timing_bwd", "shape": list(shape),
                  "dtype": dtype_name, "native_head_dim": native, "ms": ms,
                  "dq_plus_dkv_over_library": (ms["flash_bwd_dq"]
                                               + ms["flash_bwd_dkv"])
                  / ms["sdpa_bwd"],
                  "flash_backward_over_library": ms["flash_backward"]
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
                    # the whole wrapper: padding, delta', both kernels
                    "flash_backward_ms": ms["flash_backward"],
                    # one plain function computes dq, dk and dv together
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    # SDPA's backward (dq, dk and dv together)
                    "library_ms": ms["sdpa_bwd"],
                }
            del kernel_in
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
    card_uuid = row.uuid     # NVML's uuid of the card (phase 20 too)
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

    # ---- 18. a gang on the card: sequence and data parallelism ---------
    mark("18_gang")
    from kubeshare_tpu_torch.bench.kernels import MFU_CONFIG, MFU_VOCAB_CHUNK
    from kubeshare_tpu_torch.parallel import (
        MeshPlan as SpPlan, make_mesh as sp_mesh, make_sharded_train_step,
    )
    from kubeshare_tpu_torch.parallel.launch import run_world

    gc.collect()
    torch.cuda.empty_cache()
    # this process' one-process reference at the same weights and tokens
    sp_cfg = dataclasses.replace(MFU_CONFIG, max_seq_len=SP_SEQ)
    sp_tokens = torch.randint(0, sp_cfg.vocab, (1, SP_SEQ + 1),
                              generator=torch.Generator(device=device)
                              .manual_seed(args.seed + 1), device=device)
    one = init_llama(sp_cfg, generator=torch.Generator(device=device)
                     .manual_seed(args.seed), device=device, trainable=True)

    def one_loss(m, t):
        return llama_loss(m, t, vocab_chunk=MFU_VOCAB_CHUNK)

    loss = one_loss(one, sp_tokens)
    loss.backward()
    one_named = dict(one.named_parameters())
    one_ref = {"loss": float(loss.detach()),
               "grads": {name: one_named[name].grad.float().cpu()
                         for name in SP_PROBE}}
    one.zero_grad(set_to_none=True)
    del loss
    one_step, one, _ = make_sharded_train_step(
        one_loss, one, sp_mesh(SpPlan()), learning_rate=1e-4, fsdp=False)
    one_step(sp_tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    t0 = time.perf_counter()
    for _ in range(SP_STEPS):
        one_last = one_step(sp_tokens)
    one_last = float(one_last)
    torch.cuda.synchronize()
    one_ms = 1e3 * (time.perf_counter() - t0) / SP_STEPS
    one_launches = {k: v / SP_STEPS for k, v in LAUNCHES.items()}
    one_peak = torch.cuda.max_memory_allocated()
    del one, one_step
    gc.collect()
    torch.cuda.empty_cache()

    # the world: its ranks load the kernels built in phase 1
    t0 = time.perf_counter()
    sp_world = run_world(sp_rank, SP_RANKS, args=(args.seed,), timeout=600,
                         device_type="cuda")
    world_s = time.perf_counter() - t0
    check(all(r["backend"] == "gloo" for r in sp_world)
          or torch.cuda.device_count() >= SP_RANKS,
          f"backends {[r['backend'] for r in sp_world]}")

    # ring and Ulysses attention against plain attention, here
    batch, heads, kv_heads, t, head_dim = SP_ATTENTION
    agen = torch.Generator(device=device).manual_seed(args.seed)
    aq, ado = (torch.randn(batch, heads, t, head_dim, generator=agen,
                           device=device).bfloat16() for _ in range(2))
    ak, av = (torch.randn(batch, kv_heads, t, head_dim, generator=agen,
                          device=device).bfloat16() for _ in range(2))
    ref_out, ref_lse = flash_attention_reference(aq, ak, av, True)
    leaves = [x.detach().requires_grad_() for x in (aq, ak, av)]
    plain = attn.attention(*leaves, causal=True)
    plain_grads = torch.autograd.grad(plain, leaves, ado)
    attention_rows = {}
    for impl in ("ring", "ulysses"):
        got = [torch.cat([r["attention"][impl][i] for r in sp_world],
                         dim=2).to(device) for i in range(4)]
        attention_rows[impl] = {
            "out_row_rel_err": row_rel_err(got[0], ref_out),
            "out_max_abs_err": (got[0].float() - ref_out.float()).abs()
            .max().item(),
            "grad_rel_err": {n: rel_err(g, w) for n, g, w
                             in zip("qkv", got[1:], plain_grads)}}
    ring_lse = torch.cat([r["attention"]["ring_lse"] for r in sp_world],
                         dim=2).to(device)
    attention_rows["ring"]["lse_max_abs_err"] = (
        ring_lse - ref_lse).abs().max().item()
    del (aq, ak, av, ado, leaves, plain, plain_grads, got, ref_out, ref_lse,
         ring_lse)
    torch.cuda.empty_cache()
    emit({"phase": "sp_attention", "card": smi, "shape": list(SP_ATTENTION),
          "ranks": SP_RANKS, "backends": [r["backend"] for r in sp_world],
          "reference": "flash_attention_reference (out, lse); gradients "
                       "of plain attention",
          "out_row_rel_tol": SP_ROW_REL_TOL,
          "lse_tol": TOL["bfloat16"]["lse"], "grad_rel_tol": GRAD_REL_TOL,
          **attention_rows})
    for impl, row in attention_rows.items():
        check(row["out_row_rel_err"] <= SP_ROW_REL_TOL
              and row.get("lse_max_abs_err", 0.0) <= TOL["bfloat16"]["lse"]
              and max(row["grad_rel_err"].values()) <= GRAD_REL_TOL,
              f"{impl} attention against plain attention: {row}")

    sp_rows = {}
    for impl in ("ring", "ulysses"):
        per_rank = [r[impl] for r in sp_world]
        summed = {name: per_rank[0]["probe_grads"][name]
                  for name in SP_PROBE}
        grad_rel = {name: rel_err(summed[name], one_ref["grads"][name])
                    for name in SP_PROBE}
        loss_rel = abs(per_rank[0]["probe_loss"] - one_ref["loss"]) / abs(
            one_ref["loss"])
        step_ms = per_rank[0]["step_ms"]
        sp_rows[impl] = {
            "loss": per_rank[0]["probe_loss"], "one_process_loss":
            one_ref["loss"], "loss_rel_err": loss_rel,
            "grad_rel_err": grad_rel, "step_ms": step_ms,
            "tokens_per_s": SP_SEQ / (step_ms / 1e3),
            "last_loss": [r["last_loss"] for r in per_rank],
            "launches_per_rank_step": [r["launches_per_step"]
                                       for r in per_rank],
            "probe_backward": [r["probe_backward"] for r in per_rank],
            "comm_per_rank_step": [r["comm_per_step"] for r in per_rank],
            "peak_bytes_per_rank": [r["peak_bytes"] for r in per_rank]}
        emit({"phase": "sp_llama", "impl": impl, "card": smi,
              "config": dataclasses.asdict(sp_cfg), "ranks": SP_RANKS,
              "t_local": SP_SEQ // SP_RANKS, "vocab_chunk": MFU_VOCAB_CHUNK,
              "steps_timed": SP_STEPS, "loss_rel_tol": SP_LOSS_REL_TOL,
              **sp_rows[impl], "one_process_step_ms": one_ms,
              "one_process_tokens_per_s": SP_SEQ / (one_ms / 1e3),
              "one_process_launches_per_step": one_launches,
              "one_process_peak_bytes": one_peak,
              "world_seconds": world_s})
        check(loss_rel <= SP_LOSS_REL_TOL
              and max(grad_rel.values()) <= GRAD_REL_TOL,
              f"{impl}: the SP loss against llama_loss: {sp_rows[impl]}")
        check(all(math.isfinite(x) for x in sp_rows[impl]["last_loss"]),
              f"{impl}: non-finite loss")
        for r, row in enumerate(per_rank):
            check(all(row["launches"][k] > 0 for k in LAUNCHES),
                  f"{impl}: rank {r} did not launch every kernel: "
                  f"{row['launches']}")
            if impl == "ring" and r > 0:
                seen = row["probe_backward"]
                check(seen["with_g_lse"] > 0 and seen["g_lse_max_abs"] > 0,
                      f"ring rank {r}: no lse cotangent reached the "
                      f"backward: {seen}")

    def flash_kernel_rows(suffix, shape, causal, launched):
        """The three kernels at ``shape`` (bf16, an lse cotangent) against
        their plain versions, and timed in turns with SDPA; one row of
        the kernels line each, with ``launched`` (by kernel) as its
        launches. Emits a ``sp_kernels`` line."""
        batch, heads, kv_heads, t_q, t_k, head_dim = shape
        q, do = (randn(batch, heads, t_q, head_dim, dtype=torch.bfloat16)
                 for _ in range(2))
        k, v = (randn(batch, kv_heads, t_k, head_dim, dtype=torch.bfloat16)
                for _ in range(2))
        g_lse = randn(batch, heads, t_q, 1, dtype=torch.float32)
        out, lse = flash_forward(q, k, v, causal)
        ref_out, ref_lse = flash_attention_reference(q, k, v, causal)
        fwd_err = (out.float() - ref_out.float()).abs().max().item()
        fwd_row_rel = row_rel_err(out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        got = flash_backward(q, k, v, out, lse, do, g_lse, causal)
        want = flash_backward_reference(q, k, v, out, lse, do, g_lse, causal)
        bwd_abs = {n: (a.float() - b.float()).abs().max().item()
                   for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        bwd_rel = {n: rel_err(a, b)
                   for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        check(fwd_row_rel <= SP_ROW_REL_TOL
              and lse_err <= TOL["bfloat16"]["lse"]
              and max(bwd_rel.values()) <= BWD_REL_TOL["bfloat16"],
              f"kernels at {shape}: out rows {fwd_row_rel}, lse {lse_err}, "
              f"bwd {bwd_rel}")
        scale = head_dim ** -0.5
        bwd_in = (q, k, v, do, lse, attn._flash_delta(out, do, g_lse))
        # SDPA on k and v repeated to q's heads (its flash backend at
        # these lengths; the repeat is outside the timed call)
        kr, vr = attn._repeat_kv(k, v, heads)
        ms = interleaved_ms({
            "flash_fwd": lambda: flash_forward(q, k, v, causal),
            "sdpa": lambda: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=causal),
            "flash_bwd_dq": lambda: attn._flash_bwd_dq_cuda(
                *bwd_in, causal, scale, 0),
            "flash_bwd_dkv": lambda: attn._flash_bwd_dkv_cuda(
                *bwd_in, causal, scale, 0),
            "sdpa_bwd": sdpa_backward(q, kr, vr, do, causal)}, rounds=5)
        # the plain versions ran once above, which warmed them
        plain_fwd_ms = cuda_ms(lambda: flash_attention_reference(
            q, k, v, causal), 1, warmup=0, batches=1)
        plain_bwd_ms = cuda_ms(lambda: flash_backward_reference(
            q, k, v, out, lse, do, g_lse, causal), 1, warmup=0, batches=1)
        rows = []
        for name, kind, err, plain_ms, library in (
                ("flash_fwd", "fwd", fwd_err, plain_fwd_ms, "sdpa"),
                ("flash_bwd_dq", "bwd_dq", bwd_abs["dq"], plain_bwd_ms,
                 "sdpa_bwd"),
                ("flash_bwd_dkv", "bwd_dkv", max(bwd_abs["dk"],
                                                 bwd_abs["dv"]),
                 plain_bwd_ms, "sdpa_bwd")):
            bound_ms, bound_by = flash_bound_ms(shape, "bfloat16", causal,
                                                0, kind)
            rows.append({
                "name": name + suffix, "shape": list(shape),
                "route": "cuda",
                "source": ("kubeshare_tpu_torch/ops/csrc/flash_fwd.cu"
                           if kind == "fwd" else
                           "kubeshare_tpu_torch/ops/csrc/flash_bwd.cu"),
                "replaces": {"fwd": "kubeshare_tpu/ops/attention.py:121",
                             "bwd_dq": "kubeshare_tpu/ops/attention.py:300",
                             "bwd_dkv": "kubeshare_tpu/ops/attention.py:348"
                             }[kind],
                "launches": launched[name],
                "max_abs_err": err, "ms": ms[name], "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": ms[library]})
        emit({"phase": "sp_kernels", "shape": list(shape), "causal": causal,
              "g_lse": True, "fwd_max_abs_err": fwd_err,
              "fwd_row_rel_err": fwd_row_rel, "row_rel_tol": SP_ROW_REL_TOL,
              "lse_max_abs_err": lse_err, "lse_tol": TOL["bfloat16"]["lse"],
              "bwd_rel_err": bwd_rel, "ms": ms,
              "plain_ms": {"fwd": plain_fwd_ms, "bwd": plain_bwd_ms},
              "timing": "median of 5 rounds of 20 back-to-back launches "
                        "queued behind a sleep, in turns with SDPA"})
        del (q, k, v, kr, vr, do, g_lse, out, lse, ref_out, ref_lse, got,
             want, bwd_in)
        torch.cuda.empty_cache()
        return rows

    # the three kernels at the ring's hop shape (an earlier shard: full)
    # and the Ulysses core (the full sequence of a head slice: causal);
    # launches: every rank's in the timed sp = 4 steps
    sp_kernel_rows = []
    t_local = SP_SEQ // SP_RANKS
    hkv_slice = MFU_CONFIG.num_kv_heads // SP_RANKS
    for suffix, shape, causal, impl in (
            ("_ring_hop", (1, MFU_CONFIG.num_heads, MFU_CONFIG.num_kv_heads,
                           t_local, t_local, 64), False, "ring"),
            ("_ulysses", (1, MFU_CONFIG.num_heads // SP_RANKS, hkv_slice,
                          SP_SEQ, SP_SEQ, 64), True, "ulysses")):
        launched = {k: sum(r[impl]["launches"][k] for r in sp_world)
                    for k in LAUNCHES}
        sp_kernel_rows += flash_kernel_rows(suffix, shape, causal, launched)

    # the CLI's gang path: two processes through the gang env, the two
    # gangs at once (their start-up, not the card, takes the time)
    with ThreadPoolExecutor(2) as pool:
        gang_runs = dict(zip(("resnet", "llama"), pool.map(
            lambda name: pod_configs.run_cli_gang(
                ["--model", name, "--steps", str(GANG_STEPS)], 2,
                timeout=300), ("resnet", "llama"))))
    for model_name, run in gang_runs.items():
        emit({"phase": "cli_gang", "model": model_name, "card": smi,
              "outcome": run["outcome"], "seconds": run["seconds"],
              "joined": run["joined"], "docs": run["docs"]})
        check(run["ok"] and all(d and d["processes"] == 2
                                and d["steps"] == GANG_STEPS
                                and math.isfinite(d["final_loss"])
                                for d in run["docs"])
              and run["docs"][0]["final_loss"] == run["docs"][1]["final_loss"],
              f"CLI gang {model_name}: {run}")
    # BASELINE config 4, one round
    resnet_doc = pod_configs.run_resnet_dp(phase_seconds=RESNET_PHASE_S,
                                           rounds=1)
    emit({"phase": "resnet_dp", **resnet_doc})
    check(math.isfinite(resnet_doc["value"]) and resnet_doc["value"] > 0
          and resnet_doc["dp8_vs_single_loss_rel_err"] <= RESNET_REL_TOL
          and all(math.isfinite(x) for x in resnet_doc["dp8_last_loss"]),
          f"resnet dp: {resnet_doc}")
    emit({"phase": "gang_backends",
          "sp_world": [r["backend"] for r in sp_world],
          "cli_gang": {m: run["joined"] for m, run in gang_runs.items()},
          "resnet_dp8": resnet_doc["dp8_backend"]})
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 19. the reference's multi-device paths ------------------------
    mark("19_multichip")
    gc.collect()
    torch.cuda.empty_cache()
    mc = multichip_phase(device, args.seed, smi)
    mc_cfgs, tp_plan, tp_docs, pp_docs = (mc[k] for k in ("cfgs", "tp_plan",
                                                          "tp", "pp"))

    # the three kernels at the shapes a tp rank and a pipeline stage give
    # them; launches: every rank's in the timed steps of (a) and pass of
    # (b)
    hd = mc_cfgs["tp"].dim // mc_cfgs["tp"].num_heads
    t_tp = MC_TP_TOKENS[1] - 1
    mc_kernel_rows = []
    for suffix, shape, docs in (
            ("_tp", (MC_TP_TOKENS[0] // tp_plan.fsdp // tp_plan.dp,
                     mc_cfgs["tp"].num_heads // tp_plan.tp,
                     mc_cfgs["tp"].num_kv_heads // tp_plan.tp, t_tp, t_tp,
                     hd), tp_docs),
            ("_pp", (MC_PP_TOKENS[0] // MC_PP_MICROBATCHES,
                     mc_cfgs["pp"].num_heads, mc_cfgs["pp"].num_kv_heads,
                     MC_PP_TOKENS[1], MC_PP_TOKENS[1], hd), pp_docs)):
        runs = MC_TP_STEPS if suffix == "_tp" else 1
        launched = {k: round(sum(d["launches"][k] for d in docs) * runs)
                    for k in LAUNCHES}
        mc_kernel_rows += flash_kernel_rows(suffix, shape, True, launched)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 20. admission to a pod on its card ----------------------------
    mark("20_admission")
    gc.collect()
    torch.cuda.empty_cache()
    admission_phase(card_uuid, smi)

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
    # the reference's dry-run head dims: launches of phase 19 (e), summed
    # over its ranks (and the cross-process workers). Head dim 16 bf16:
    # its Llama's train step; 16 float32: its ring and Ulysses; 8 float32
    # (padded, the float32 head-dim-16 instances): its sp loss and
    # pipeline, and the cross-process step.
    dry_legs = [r["leg_launches"] for r in mc["dry_ranks"]]

    def dry_sum(legs, kernel, crossproc=False):
        return (sum(d[leg][kernel] for d in dry_legs for leg in legs)
                + (sum(c[kernel] for c in mc["crossproc"])
                   if crossproc else 0))

    fwd_rows["_d16"]["launches"] = dry_sum(("train",), "flash_fwd")
    fwd_rows["_d16_f32"]["launches"] = dry_sum(("sp_attention",),
                                               "flash_fwd")
    fwd_rows["_d8_f32"]["launches"] = dry_sum(("sp_loss", "pipeline"),
                                              "flash_fwd", crossproc=True)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        bwd_rows[name + "_d16"]["launches"] = dry_sum(("train",), name)
        bwd_rows[name + "_d8_f32"]["launches"] = dry_sum((), name,
                                                         crossproc=True)
    small_d_rows = [fwd_rows["_d16"], bwd_rows["flash_bwd_dq_d16"],
                    bwd_rows["flash_bwd_dkv_d16"], fwd_rows["_d16_f32"],
                    fwd_rows["_d8_f32"], bwd_rows["flash_bwd_dq_d8_f32"],
                    bwd_rows["flash_bwd_dkv_d8_f32"]]
    check(all(r["launches"] > 0 for r in small_d_rows),
          f"a dry-run instance was not launched: {small_d_rows}")
    # timed in phases 2 and 6 but called on no main path at this head dim
    # and dtype: 96 (no model of the repo has it) and the float32
    # head-dim-16 backward called natively (the main path runs that
    # instance padded from 8: the _d8_f32 rows)
    off_path = [fwd_rows["_d96"], bwd_rows["flash_bwd_dq_d96"],
                bwd_rows["flash_bwd_dkv_d96"],
                bwd_rows["flash_bwd_dq_d16_f32"],
                bwd_rows["flash_bwd_dkv_d16_f32"]]
    for r in off_path:
        r["launches"] = 0
    emit({"phase": "kernel_timing_off_the_main_path", "rows": off_path})
    emit({"kernels": [fwd_rows[""], bwd_rows["flash_bwd_dq"],
                      bwd_rows["flash_bwd_dkv"], fwd_rows["_d32"],
                      bwd_rows["flash_bwd_dq_d32"],
                      bwd_rows["flash_bwd_dkv_d32"], *small_d_rows,
                      *sp_kernel_rows, *mc_kernel_rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
