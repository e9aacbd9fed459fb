"""The afmoe family through the whole harness at tiny widths on the CPU:
a sound run of a tiny afmoe serving cell is correct and a served token
altered where it is produced is caught; the family's arithmetic and the
expert layer's readers on hand-made runs."""

import json
from types import SimpleNamespace as NS

import pytest
import torch

from perfbench.families import afmoe
from perfbench.lib import roofline as R
from perfbench.lib.catalog import Catalog
from perfbench.lib.trace import DeviceOp, Trace
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_catalog import REPO

TINY_AFMOE = {
    "family": "afmoe", "hidden_act": "silu", "hidden_size": 32,
    "intermediate_size": 48, "head_dim": 16, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_hidden_layers": 5,
    "num_dense_layers": 1,
    "layer_types": ["sliding_attention"] * 3 + ["full_attention"] + [
        "sliding_attention"],
    "moe_intermediate_size": 24, "num_experts": 8, "num_experts_per_tok": 2,
    "num_shared_experts": 1, "route_norm": True, "route_scale": 2.826,
    "score_func": "sigmoid", "mup_enabled": True, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "sliding_window": 32, "vocab_size": 128,
    "torch_dtype": "float32", "tie_word_embeddings": False,
    "max_model_len": 64,
}
SERVE = dict(tiny.SERVE, output_tokens={"median": 10, "sigma": 0.5,
                                        "min": 6, "max": 24})
# a float32 program against the float32 reference takes the same routes:
# sound runs read float32 rounding (under 1e-4); an altered token reads
# its own gap
LIMIT = {"serve_gap": 1e-3}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    path = tiny.checkout(tmp_path_factory.mktemp("checkout"))
    home = path.parent / "perfbench"
    (home / "configs" / "tiny-afmoe.json").write_text(json.dumps(TINY_AFMOE))
    (home / "traffic" / "tiny-afmoe.json").write_text(json.dumps(SERVE))
    (home / "limits" / "tiny.afmoe.json").write_text(json.dumps(LIMIT))
    bench = json.loads(path.read_text())
    bench["configs"].append({"name": "tiny-afmoe", "source": "test",
                             "file": "perfbench/configs/tiny-afmoe.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.afmoe", "config": "tiny-afmoe",
                               "traffic": "tiny-afmoe", "chips": 1,
                               "why": "test"})
    for group in ("end_to_end", "per_layer"):
        for metric in bench[group]:
            if "trinitymini.reason" in metric.get("workloads", []):
                metric["workloads"].append("tiny.afmoe")
    path.write_text(json.dumps(bench))
    return path


def test_a_sound_run_is_correct(bench):
    for seed in (1, 2_147_483_659):
        result, lines = tiny.run(bench, "tiny.afmoe", seed=seed, seconds=0.8)
        assert result["correct"], lines
        assert result["attempted"] > 0 and result["failed"] == 0
        assert result["info"]["check"]["_tokens"] > 0


def test_an_altered_token_is_caught(bench, monkeypatch):
    from kubeshare_tpu_torch.models import serving

    sample = serving._sample_token

    def altered(logits, *args):
        return (sample(logits, *args) + 1) % logits.shape[-1]

    monkeypatch.setattr(serving, "_sample_token", altered)
    result, lines = tiny.run(bench, "tiny.afmoe", seconds=0.8)
    assert not result["correct"], lines


def test_a_traced_run_reads_the_expert_count(bench):
    """On the CPU no grouped product has a CUTLASS kernel, so the two
    device readers find nothing; the count is the program's own."""
    result, _ = tiny.run(bench, "tiny.afmoe", trace=True, seconds=1.0)
    metrics = result["metrics"]
    assert metrics["moe_load_ratio.serve"]["value"] >= 1.0
    assert "moe_expert_share.serve" not in metrics
    assert "moe_expert_roofline.serve" not in metrics
    assert "decode_step_ms" in metrics and "mfu.serve" in metrics


def test_the_configuration_is_the_catalog_entry_cut_to_16_layers():
    catalog = Catalog(REPO / "BENCHMARK.json")
    cfg = catalog.config("trinity-mini-16l")
    spec = catalog.spec("trinity-mini-16l")
    assert cfg["family"] == "afmoe" and cfg["num_hidden_layers"] == 16
    assert len(cfg["layer_types"]) == 32
    assert spec.windows == (2048, 2048, 2048, 0) * 4
    assert [spec.routed(i) for i in range(16)] == [False] * 2 + [True] * 14
    assert (spec.dim, spec.heads * spec.head_dim, spec.experts, spec.top_k,
            spec.moe_ff, spec.shared_ff, spec.ff, spec.vocab) == (
        2048, 4096, 128, 8, 1024, 1024, 6144, 200192)
    params = sum(torch.Size(shape).numel() for i in range(16)
                 for _, shape, _ in spec.layer_shapes(i))
    params += 2 * spec.vocab * spec.dim + 14 * 128 * 2048
    assert 12.6e9 < params < 12.8e9


def test_operations_count_each_layers_window_and_the_routes():
    spec = afmoe.spec("t", TINY_AFMOE)
    # per token: attention matrices (64 q, 32 k, 32 v, 64 gate rows of 32,
    # o 32 x 64) every layer; a dense 3 x 32 x 48; per routed layer the
    # router 8 x 32, 2 of 8 experts and the shared one (3 x 32 x 24
    # each); the head 128 x 32
    attn = (64 + 32 + 32 + 64) * 32 + 32 * 64
    per_token = (5 * attn + 3 * 32 * 48 + 4 * (8 * 32 + 3 * 3 * 32 * 24)
                 + 128 * 32)
    # positions 40..42: sliding layers see 32 keys, the full one p + 1
    keys = 4 * 32 * 3 + (41 + 42 + 43)
    want = 2.0 * per_token * 3 + 4.0 * 4 * 16 * keys
    assert afmoe.forward_flops(spec, 40, 3) == want
    calls = afmoe.attention_calls(spec, 2, 32)
    assert [c[3] for c in calls] == [32, 32, 32, 0, 32]


def test_the_expert_bound_counts_the_touched_experts():
    catalog = Catalog(REPO / "BENCHMARK.json")
    spec = catalog.spec("trinity-mini-16l")
    ops, n_bytes = afmoe.expert_work(spec, 32)
    assert ops == 2.0 * 3 * 2048 * 1024 * 32 * 8
    touched = 128 * (1 - (1 - 8 / 128) ** 32)
    assert 111 < touched < 112
    assert n_bytes == 2 * (3.0 * 2048 * 1024 * touched
                           + 256 * 3.0 * (2048 + 1024))
    # the weights bound both a decode step at 32 slots and a 2048-token
    # prefill (which touches all 128 experts, ~128 routes each)
    assert afmoe.expert_bound_s(spec, 32) == n_bytes / R.PEAK_BYTES
    assert afmoe.expert_bound_s(spec, 2048) == pytest.approx(
        2 * (3.0 * 2048 * 1024 * 128 + 16384 * 3.0 * 3072) / R.PEAK_BYTES)
    ops, _ = afmoe.expert_work(spec, 2048)
    assert ops / R.PEAK_FLOPS["bfloat16"] < afmoe.expert_bound_s(spec, 2048)


GROUPED = "_ZN7cutlass13device_kernelI...17GroupProblemShapeI..."


def test_the_expert_readers_on_a_hand_made_run():
    """Pod 0 routes evenly over the 128 experts, pod 1 over half of
    them: its calls touch fewer experts' weights, so their least time
    is shorter, and its load ratio is 2."""
    catalog = Catalog(REPO / "BENCHMARK.json")
    spec = catalog.spec("trinity-mini-16l")
    device = [DeviceOp(GROUPED, 0.1 + 0.01 * i, 0.1 + 0.01 * i + 0.002, 0)
              for i in range(10)]
    device += [DeviceOp("nvjet_tst_gemm", 0.5, 0.6, 0)]
    trace = Trace(window_s=3.0, perf0=100.0, device=device)
    even, half = [[10] * 128] * 14, [[20] * 64 + [0] * 64] * 14
    pods = [NS(spans={"admit": [(100.5, 100.7, 1000)],
                      "decode": [(101.0, 101.5, 16, [(1200, 16), (99, 3)])]},
               server=NS(expert_load=lambda: even)),
            NS(spans={"admit": [(102.9, 103.1, 300)], "decode": []},
               server=NS(expert_load=lambda: half))]
    traffic = json.loads((REPO / "perfbench/traffic/reason.json").read_text())
    run = NS(kind="serve", family=catalog.family("trinity-mini-16l"),
             spec=spec, traffic=traffic, pods=pods, trace=trace,
             window=(90.0, 141.0))
    share = catalog.reader("moe_expert_share.serve")(run)
    assert share == pytest.approx(100.0 * 0.02 / (0.02 + 0.1))
    uniform = [8 / 128] * 128
    halved = [16 / 128] * 64 + [0.0] * 64
    least = 14 * (afmoe.expert_bound_s(spec, 1000)
                  + 16 * afmoe.expert_bound_s(spec, 2, uniform)
                  + 0.5 * afmoe.expert_bound_s(spec, 300, halved))
    assert afmoe.expert_bound_s(spec, 300, halved) < afmoe.expert_bound_s(
        spec, 300)
    roof = catalog.reader("moe_expert_roofline.serve")(run)
    assert roof == pytest.approx(100.0 * least / 0.02)
    ratio = catalog.reader("moe_load_ratio.serve")(run)
    assert ratio == pytest.approx(1.5)


def test_the_expert_readers_read_nothing_of_a_dense_run():
    catalog = Catalog(REPO / "BENCHMARK.json")
    trace = Trace(window_s=3.0, perf0=100.0,
                  device=[DeviceOp(GROUPED, 0.1, 0.2, 0)])
    run = NS(kind="serve", family=catalog.family("mistral-7b-v0.1"),
             spec=catalog.spec("mistral-7b-v0.1"),
             traffic=json.loads((REPO / "perfbench/traffic/chat.json")
                                .read_text()),
             pods=[NS(spans={}, server=NS())], trace=trace,
             window=(90.0, 141.0))
    for name in ("moe_expert_share.serve", "moe_expert_roofline.serve",
                 "moe_load_ratio.serve"):
        assert catalog.reader(name)(run) is None
