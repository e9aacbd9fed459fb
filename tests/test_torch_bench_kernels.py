"""kubeshare_tpu_torch/bench/kernels.py on the CPU at toy sizes (2
layers, dim 64, T 64): each function prints one JSON line and returns the
same dict, with the keys the module's docstring lists, finite numbers,
and no MFU for a card whose peak is not in the table. The gate's A/B runs
under a live ``tpu-schd``, skipped when runtime_native is not built, as
tests/test_torch_headline.py skips. Times from the CPU are host times;
the lines say ``"device": "cpu"``."""

import dataclasses
import json
import math

import pytest

from kubeshare_tpu_torch.bench import arbiter
from kubeshare_tpu_torch.bench import kernels

TOY = dataclasses.replace(kernels.MFU_CONFIG, vocab=256, dim=64, layers=2,
                          num_heads=2, num_kv_heads=1, mlp_dim=128)
ATTN = {"batch": 1, "heads": 2, "kv_heads": 1, "head_dim": 32}


@pytest.fixture
def needs_schd():
    if not arbiter.available():
        pytest.skip("tpu-schd cannot be built here (g++)")


def _line(capsys, doc, bench, keys):
    """The printed line is the returned dict; it has ``keys``, names the
    CPU, and its numbers are finite."""
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == doc
    assert doc["bench"] == bench and doc["device"] == "cpu"
    assert set(keys) <= set(doc), set(keys) - set(doc)
    for key, value in doc.items():
        if isinstance(value, float):
            assert math.isfinite(value), key
    return doc


def test_llama_train_mfu_has_no_mfu_without_a_known_peak(capsys):
    doc = kernels.llama_train_mfu(batch=2, seq=64, steps=2, cfg=TOY,
                                  device="cpu")
    _line(capsys, doc, "llama_train_mfu",
          ["llama_params_millions", "llama_batch_x_seq", "llama_step_ms",
           "llama_tokens_per_sec", "mfu", "peak_tflops"])
    assert doc["mfu"] is None and doc["peak_tflops"] is None
    assert doc["llama_batch_x_seq"] == "2x64" and doc["llama_step_ms"] > 0


def test_peaks_are_looked_up_never_guessed():
    assert kernels.PEAK_BF16_FLOPS == {"NVIDIA H100 80GB HBM3": 989e12}


def test_mfu_model_is_the_references():
    """bench_kernels.py:95-98's ~200M Llama (head dim 64), its chunk and
    optax.adamw's defaults."""
    cfg = kernels.MFU_CONFIG
    assert (cfg.vocab, cfg.dim, cfg.layers, cfg.num_heads, cfg.num_kv_heads,
            cfg.mlp_dim) == (32000, 1024, 12, 16, 8, 2816)
    assert kernels.MFU_VOCAB_CHUNK == 8192
    assert kernels.ADAMW["weight_decay"] == 1e-4


def test_train_gate_overhead_under_a_live_arbiter(capsys, needs_schd):
    doc = kernels.train_gate_overhead(batch=2, seq=64, steps=2, rounds=2,
                                      cfg=TOY, device="cpu")
    _line(capsys, doc, "train_gate_overhead",
          ["train_gate_overhead", "train_gate_overhead_worst",
           "train_ungated_step_ms", "train_gated_step_ms",
           "train_gate_overhead_batch_x_seq", "rounds", "tokens_acquired",
           "train_ungated_spread", "train_gate_calls_ms",
           "train_gate_calls_share"])
    assert doc["tokens_acquired"] == 2          # one hold a gated window
    assert doc["train_gate_overhead"] >= 0.0
    assert doc["train_ungated_spread"] >= 0.0
    assert 0 < doc["train_gate_calls_ms"] < (doc["train_gated_step_ms"]
                                             * 2)
    assert doc["train_gate_calls_share"] > 0


def test_train_gate_overhead_raises_without_its_arbiter(monkeypatch):
    def refuse(*args, **kwargs):
        raise RuntimeError("tpu-schd did not answer")

    monkeypatch.setattr(arbiter, "start_arbiter", refuse)
    with pytest.raises(RuntimeError, match="did not answer"):
        kernels.train_gate_overhead(batch=2, seq=64, steps=1, rounds=1,
                                    cfg=TOY, device="cpu")


def test_flash_vs_plain(capsys):
    doc = kernels.flash_vs_plain(64, rounds=2, device="cpu", **ATTN)
    _line(capsys, doc, "flash_vs_plain",
          ["flash_attn_speedup_t64", "flash_attn_ms_t64",
           "plain_attn_ms_t64", "sdpa_attn_ms_t64",
           "flash_attn_over_sdpa_t64"])
    assert doc["shape"] == [1, 2, 1, 64, 64, 32]


def test_flash_swa_speedup(capsys):
    doc = kernels.flash_swa_speedup(seq=64, window=16, rounds=2,
                                    device="cpu", **ATTN)
    _line(capsys, doc, "flash_swa_speedup",
          ["flash_swa_speedup_t64_w16", "flash_swa_ms_t64_w16",
           "flash_full_ms_t64"])


def test_xent_vs_naive(capsys):
    doc = kernels.xent_vs_naive(64, batch=2, dim=32, vocab=300, rounds=2,
                                device="cpu")
    _line(capsys, doc, "xent_vs_naive",
          ["xent_speedup_t64", "xent_chunked_ms_t64", "xent_dense_ms_t64"])
    assert doc["rows"] == 128


def test_flash_longcontext_ab(capsys):
    doc = kernels.flash_longcontext_ab(seq=64, device="cpu", **ATTN)
    _line(capsys, doc, "flash_longcontext_ab",
          ["ab_seq", "flash_trains", "flash_step_ms", "plain_trains",
           "plain_step_ms"])
    assert doc["flash_trains"] and doc["plain_trains"]


def test_xent_oom_ab(capsys):
    doc = kernels.xent_oom_ab(n=128, dim=32, vocab=300, device="cpu")
    _line(capsys, doc, "xent_oom_ab",
          ["ab_rows", "ab_vocab", "fused_trains", "fused_step_ms",
           "dense_trains", "dense_step_ms"])


def test_an_out_of_memory_plain_side_is_the_datum():
    """Only the plain side's allocation failure is caught; any other
    error propagates."""
    def oom():
        raise kernels.torch.cuda.OutOfMemoryError("CUDA out of memory")

    cpu = kernels.torch.device("cpu")
    doc = kernels._plain_side(oom, cpu, "plain")
    assert doc["plain_trains"] is False
    assert doc["plain_error"].startswith("OutOfMemoryError")

    def broken():
        raise ValueError("a fault, not an allocation failure")

    with pytest.raises(ValueError):
        kernels._plain_side(broken, cpu, "plain")


def test_main_needs_cuda(monkeypatch):
    monkeypatch.setattr(kernels.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernels.main()
