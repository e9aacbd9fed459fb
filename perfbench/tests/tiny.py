"""A copy of the benchmark at tiny widths for the CPU tests: the whole
``perfbench`` folder copied into a temporary checkout, a tiny serving
and a tiny training configuration, their traffic and limits added as
files beside the real ones, and a ``BENCHMARK.json`` naming them."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent

TINY = {
    "family": "dense", "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 96,
    "max_position_embeddings": 256, "num_attention_heads": 4,
    "num_hidden_layers": 2, "num_key_value_heads": 2, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "sliding_window": 40,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "vocab_size": 128,
}
ARBITER = {"quota_ms": 300, "min_quota_ms": 20, "window_ms": 10000,
           "slots": 2}
SERVE = {
    "kind": "serve", "pods": 2, "limit": 1.0, "request": 0.5,
    "arbiter": ARBITER,
    "server": {"slots": 4, "prompt_buckets": [16, 32], "quantum": 4},
    "arrivals": {"rate_per_pod": 12.0},
    "prompt_tokens": {"median": 12, "sigma": 0.7,
                      "min": 4, "max": 32},
    "output_tokens": {"median": 6, "sigma": 0.7,
                      "min": 2, "max": 12},
    "token_ids": {"low": 2, "high": 128},
    "preroll_s": 0.3, "trace_s": 0.5,
    "check": {"min_tokens": 40, "max_requests": 6},
}
TRAIN = {
    "kind": "train", "pods": 2, "limit": 1.0, "request": 0.5,
    "arbiter": ARBITER, "rows": 4, "seq_len": 24, "lr": 1e-3,
    "token_ids": {"low": 0, "high": 128}, "trace_s": 0.5,
}
# between what sound bfloat16 runs read at these widths on the CPU
# (served gap 0.0-0.022; loss 0.0007, gradients 0.003, change 0.0016)
# and the float8 control (served gap 0.25; gradients 0.016-0.033, change
# 0.006-0.009) and the faults of test_perfbench_faults.py
LIMITS = {"tiny.serve": {"serve_gap": 0.08},
          "tiny.train": {"loss_gap": 0.01, "grad_gap": 0.008,
                         "change_gap": 0.004}}


def checkout(tmp: Path) -> Path:
    """A temporary checkout holding a copy of ``perfbench`` with the
    tiny configuration, traffic and limits added; returns the path of
    its ``BENCHMARK.json``."""
    home = tmp / "perfbench"
    shutil.copytree(HERE, home, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (home / "configs" / "tiny.json").write_text(json.dumps(TINY))
    train_cfg = dict(TINY, torch_dtype="bfloat16")
    (home / "configs" / "tiny-train.json").write_text(json.dumps(train_cfg))
    (home / "traffic" / "tiny-serve.json").write_text(json.dumps(SERVE))
    (home / "traffic" / "tiny-train.json").write_text(json.dumps(TRAIN))
    for cell, limits in LIMITS.items():
        (home / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    bench["configs"] += [
        {"name": "tiny", "source": "test", "file": "perfbench/configs/tiny.json",
         "reduced": [], "why": "test"},
        {"name": "tiny-train", "source": "test",
         "file": "perfbench/configs/tiny-train.json", "reduced": [],
         "why": "test"}]
    bench["workloads"] += [
        {"name": "tiny.serve", "config": "tiny", "traffic": "tiny-serve",
         "chips": 1, "why": "test"},
        {"name": "tiny.train", "config": "tiny-train",
         "traffic": "tiny-train", "chips": 1, "why": "test"}]
    for group in ("end_to_end", "per_layer"):
        for metric in bench[group]:
            if "workloads" in metric:
                serve = any(w.startswith("mistral") for w in metric["workloads"])
                metric["workloads"].append("tiny.serve" if serve
                                           else "tiny.train")
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def run(bench_path: Path, workload: str, seed: int = 7,
        seconds: float = 1.0, trace: bool = False):
    """One run of a tiny cell on the CPU, the harness's look for a chip
    skipped; returns (result, check lines)."""
    import time

    from perfbench.lib.catalog import Catalog
    from perfbench.lib.harness import run_cell

    return run_cell(Catalog(bench_path), workload, seed, seconds, trace,
                    torch.device("cpu"), time.perf_counter(),
                    log=lambda msg: None)
