"""Drive kubeshare_tpu_torch's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failed check raises, so the script exits
nonzero and prints no result:

1. device: the card, torch/CUDA versions, the kernel build (nvcc, at
   first use, from csrc/ in this checkout).
2. kernel: the CUDA flash-attention forward against its plain PyTorch
   version on the card, out and lse, at the Llama-3-8B shape and at
   edge shapes, with timings.
3. forward: ``llama_apply`` at Llama-3-8B width (all 32 layers, random
   weights from the seed) on 2048 tokens; the flash kernel must launch
   once per layer; logits against the plain-attention forward.
4. serving: ``DecodeServer`` (8 slots) answers 12 prompts, with
   retirement and re-admission; prefill logits against ``llama_apply``.
5. sharing: two tenants' decode servers under ``ChipExecutor``.

Then the ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


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
# Logits of the 8B forward (bf16 weights and activations) with the flash
# kernel against plain attention, and of a cached prefill against
# llama_apply: max abs difference over the max abs logit. The two paths
# round attention differently (the flash kernel normalises after the PV
# product, the plain path before casting P), a bf16 ulp per element
# (2^-8 relative) that 32 layers carry into the logits.
LOGIT_REL_TOL = 5e-2


def visible_pairs(t_q: int, t_k: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    if not causal:
        return t_q * t_k
    total = 0
    for i in range(t_q):
        pos = i + t_k - t_q
        total += min(pos + 1, window) if window > 0 else pos + 1
    return total


def flash_bound_ms(shape, dtype_name: str, causal: bool, window: int):
    """Least time for one flash forward on an H100: each input read
    once and each output written once at the HBM rate, against the
    two products' operations at the peak rate of the input type."""
    batch, heads, kv_heads, t_q, t_k, head_dim = shape
    elem = 2 if dtype_name == "bfloat16" else 4
    n_bytes = elem * head_dim * (2 * batch * heads * t_q
                                 + 2 * batch * kv_heads * t_k)
    n_bytes += 4 * batch * heads * t_q                    # lse
    ops = 4 * batch * heads * head_dim * visible_pairs(t_q, t_k, causal,
                                                      window)
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

    import numpy as np
    import torch.nn.functional as F

    from kubeshare_tpu_torch.models.llama import (
        init_kv_cache, init_llama, llama3_8b, llama_apply,
        llama_apply_cached, prefill_slot,
    )
    from kubeshare_tpu_torch.models.serving import DecodeServer
    from kubeshare_tpu_torch.ops import _build
    from kubeshare_tpu_torch.ops.attention import (
        LAUNCHES, flash_attention_reference, flash_forward,
    )
    from kubeshare_tpu_torch.runtime.executor import ChipExecutor
    from kubeshare_tpu_torch.utils.device import resolve_device

    device = resolve_device(None)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)

    # ---- 1. device -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.load("flash_fwd")
    build_s = time.perf_counter() - t0
    # registers and spills of each kernel instance, from nvcc -Xptxas -v
    ptxas = [line.split(":", 1)[-1].strip()
             for line in _build.BUILD_LOG.get("flash_fwd", "").splitlines()
             if any(w in line for w in ("entry function", "Used", "spill"))]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "ptxas": ptxas})

    def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
        """Median over ``reps`` launches, each timed with CUDA events."""
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_breakdown(fn, wall_ms: float) -> dict:
        """Kernel time of one call of ``fn`` under torch.profiler, its
        share of ``wall_ms`` (the same work timed without the profiler)
        and the kernels that took most of it."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [(e.key, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        kernel_ms = sum(ms for _, ms in kernels)
        top = sorted(kernels, key=lambda kv: -kv[1])[:5]
        return {"kernel_ms": kernel_ms, "busy_share": kernel_ms / wall_ms,
                "top": [[name[:90], ms] for name, ms in top]}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    # ---- 2. kernel against its plain version ---------------------------
    # (B, H, Hkv, Tq, Tk, D), dtype, causal, window. The first is the
    # shape llama3_8b gives the kernel at T=2048; the last two are
    # ragged (no tile divides T) and only the kernel, not mha, takes them.
    main_case = ((1, 32, 8, 2048, 2048, 128), "bfloat16", True, 0)
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
    ]
    kernel_row = None
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
        if (shape, dtype_name, causal, window) == main_case:
            bound_ms, bound_by = flash_bound_ms(shape, dtype_name, causal,
                                                window)
            kernel_row = {
                "name": "flash_fwd", "route": "cuda",
                "source": "kubeshare_tpu_torch/ops/csrc/flash_fwd.cu",
                # _flash_kernel
                "replaces": "kubeshare_tpu/ops/attention.py:121",
                "shape": list(shape), "dtype": dtype_name,
                "max_abs_err": err_out,
                "ms": cuda_ms(lambda: flash_forward(q, k, v, causal, None,
                                                    window), 20),
                "plain_ms": cuda_ms(lambda: flash_attention_reference(
                    q, k, v, causal, None, window), 5, warmup=1),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True), 20),
            }
        del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()

    # ---- 3. forward at Llama-3-8B width ---------------------------------
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
        del probe
        streams = {s: [] for s in range(8)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            for s, toks in server.step_burst(16).items():
                streams[s].extend(toks)
        decode_s = time.perf_counter() - t0
        check(all(len(streams[s]) == 64 for s in range(8)),
              "every slot decodes 64 tokens")
        check(all(0 <= t < cfg.vocab for s in streams for t in streams[s]),
              "token out of vocab")
        for s in range(4):
            server.retire(s)
        readmitted = [server.admit(p)[0] for p in prompts[8:]]
        check(sorted(readmitted) == [0, 1, 2, 3], "re-admission slots")
        after = server.step_burst(16)
        check(sorted(after) == list(range(8))
              and all(len(t) == 16 for t in after.values()),
              "decode after re-admission")
        decode_device = device_breakdown(lambda: server.step_burst(16),
                                         16 * 1e3 * decode_s / 64)
        del server

        # serving.py's invariant: a slot's logits equal a solo decode with
        # a scalar cache. Printed, not asserted: cuBLAS may pick another
        # algorithm for an 8-row batch than for one row.
        vec = init_kv_cache(cfg, 8, per_slot=True, device=device)
        for slot in (0, 5):
            _, vec = prefill_slot(model, torch.tensor([prompts[slot]],
                                                      device=device),
                                  vec, slot)
        step_tok = torch.zeros(8, 1, dtype=torch.int64, device=device)
        step_tok[5, 0] = 7
        batched, _ = llama_apply_cached(model, step_tok, vec)
        del vec
        solo = init_kv_cache(cfg, 1, device=device)
        _, solo = llama_apply_cached(
            model, torch.tensor([prompts[5]], device=device), solo)
        alone, _ = llama_apply_cached(
            model, torch.tensor([[7]], device=device), solo)
        del solo
        solo_diff = (alone[0] - batched[5]).abs().max().item()
    emit({"phase": "serving", "slots": 8, "prompts": len(prompts),
          "prompt_lens": [len(p) for p in prompts],
          "prefill_rel_err_max": max(prefill_rel),
          "rel_tol": LOGIT_REL_TOL,
          "decode_steps": 64, "decode_ms_per_step": 1e3 * decode_s / 64,
          "decode_tokens_per_s": 8 * 64 / decode_s,
          "decode_device_16_steps": decode_device,
          "readmitted_slots": readmitted,
          "solo_bit_identical": solo_diff == 0.0,
          "solo_max_abs_diff": solo_diff})
    torch.cuda.empty_cache()

    # ---- 5. two tenants under ChipExecutor ------------------------------
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
    stats = executor.stats()
    emit({"phase": "sharing", "weights": tenants, "stats": stats})
    check(all(stats[n]["calls"] == 6 for n in tenants), "every call ran")

    kernel_row["launches"] = launches["flash_fwd"]
    emit({"kernels": [kernel_row]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
