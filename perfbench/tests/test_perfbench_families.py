"""The dense family is the harness's former fixed model, moved and not
rewritten: the same seed draws the same tensors, bit for bit, and the
same configuration counts the same operations and least times, as the
harness gave them before the family was a file of its own (golden
values, written in from that harness: ``lib/weights.py``'s
``embedding``, ``head`` and ``block``, ``lib/roofline.py``'s
``forward_flops`` and ``flash_bound_s``, and the ``mfu.*`` and
``flash_*_roofline`` readers). The hashes are of torch's CPU generator
(torch 2.13): a torch whose generator draws otherwise changes them."""

import hashlib
import json
from types import SimpleNamespace as NS

import pytest
import torch

from perfbench.families import dense
from perfbench.lib import roofline as R
from perfbench.lib.catalog import Catalog
from perfbench.lib.trace import DeviceOp, Trace
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_catalog import BENCH, REPO

CPU = torch.device("cpu")
NORMS = ("attn_norm", "mlp_norm")
# (dtype, seed, pod) -> sha256[:16] of the embedding, the head, and
# blocks 0 and 1 (their matrices in draw order, then the two norms)
DRAWN = {
    ("float32", 7, 0): ("d19671f675a101da", "63327f66ba1507b3",
                        "70fbf94cc4886792", "6cb076aff31289c3"),
    ("float32", 2_147_483_659, 1): ("a2eb0ca9c5f5a87f", "98b8cdf5ebbcc63c",
                                    "0970725ec13213c3", "4506dd4f0818f8fa"),
    ("bfloat16", 7, 0): ("5377b47ac0598ff6", "ab88643efe9dda3b",
                         "e5e86f202f5087cd", "a440d1cf0bf4b3a3"),
    ("bfloat16", 2_147_483_659, 1): ("ac69f94eb2ac2158", "5fc06bbbb52d5c31",
                                     "e309187d2b7aaf5c", "94e5114639372a00"),
}
# forward_flops at (first, count)
FLOPS = {
    "mistral-7b-v0.1": {
        (0, 1): 14221312000.0, (0, 2048): 30224221732864.0,
        (100, 16): 228442767360.0, (4000, 300): 4908090654720.0,
        (4095, 1): 16368271360.0, (1, 4100): 62715086766080.0},
    "phi-3-mini-4k-8l": {
        (0, 1): 2009038848.0, (0, 2048): 4320569229312.0,
        (100, 16): 32313704448.0, (4000, 300): 663050649600.0,
        (4095, 1): 2210168832.0, (1, 4100): 8856036802560.0},
}
# flash_bound_s at the finetune shape (4 rows of 2048), the model's
# head dim and window
BOUND = {
    "mistral-7b-v0.1": {"fwd": 0.00013903545231142567,
                        "bwd_dq": 0.00020855317846713852,
                        "bwd_dkv": 0.00027807090462285134},
    "phi-3-mini-4k-8l": {"fwd": 0.00010427653953488372,
                         "bwd_dq": 0.00015641480930232558,
                         "bwd_dkv": 0.00020855307906976744},
}
# the readers on the hand-made runs below
READ = {
    "phi-3-mini-4k-8l": {"mfu.train": 6.2471324549202585,
                         "flash_fwd_roofline": 25.218026489693937,
                         "flash_dq_roofline": 25.76850235623164,
                         "flash_dkv_roofline": 25.7314101258197},
    "mistral-7b-v0.1": {"mfu.serve": 1.5087435834902225},
}


def digest(t: torch.Tensor) -> str:
    raw = t.contiguous().view(torch.uint8).numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


@pytest.mark.parametrize("dtype,seed,pod", list(DRAWN))
def test_the_same_seed_draws_the_same_weights(dtype, seed, pod):
    spec = dense.spec("tiny", tiny.TINY)
    d = getattr(torch, dtype)
    embed, head, *blocks = DRAWN[(dtype, seed, pod)]
    assert digest(dense.embedding(spec, seed, pod, d, CPU)) == embed
    assert digest(dense.head(spec, seed, pod, d, CPU)) == head
    for layer, want in enumerate(blocks):
        block = dense.block(spec, seed, pod, layer, d, CPU)
        assert list(block) == [n for n, _, _ in spec.layer_shapes()] + list(
            NORMS)
        assert digest(torch.cat([v.reshape(-1).to(d)
                                 for v in block.values()])) == want


def test_every_configuration_names_a_family_that_exists():
    catalog = Catalog(REPO / "BENCHMARK.json")
    for c in BENCH["configs"]:
        family = json.loads((REPO / c["file"]).read_text())["family"]
        assert (REPO / "perfbench" / "families" / f"{family}.py").is_file()
        assert catalog.family(c["name"]).spec(c["name"], catalog.config(
            c["name"])) == catalog.spec(c["name"])
    assert json.loads((REPO / "perfbench/configs/mistral-7b-v0.1.json")
                      .read_text())["family"] == "dense"


@pytest.mark.parametrize("name", list(FLOPS))
def test_operations_and_least_times_are_unchanged(name):
    catalog = Catalog(REPO / "BENCHMARK.json")
    family, spec = catalog.family(name), catalog.spec(name)
    for (first, count), want in FLOPS[name].items():
        assert family.forward_flops(spec, first, count) == want
    calls = family.attention_calls(spec, 4, 2048)
    assert len(calls) == spec.layers
    for kind, want in BOUND[name].items():
        assert {R.flash_bound_s(*call, kind) for call in calls} == {want}


def _trace() -> Trace:
    device = []
    for i in range(8):
        t = 0.1 + 0.01 * i
        device += [
            DeviceOp("flash_fwd_bf16_kernel", t, t + 0.00041 + 1e-6 * i, 0),
            DeviceOp("flash_bwd_dq_bf16_kernel", t + 0.001,
                     t + 0.0016 + 2e-6 * i, 0),
            DeviceOp("flash_bwd_dkv_bf16_kernel", t + 0.002,
                     t + 0.0028 + 3e-6 * i, 0)]
    return Trace(window_s=3.0, perf0=100.0, device=device)


PODS = {
    "train": [NS(spans={"train_step": [(99.5, 100.3), (100.3, 100.65),
                                       (102.9, 103.4)]}),
              NS(spans={"train_step": [(100.0, 100.35), (100.35, 100.7)]})],
    "serve": [NS(spans={"admit": [(99.9, 100.2, 1000), (101.0, 101.3, 300)],
                        "decode": [(100.2, 100.23, 16, [(1000, 16), (64, 16)]),
                                   (102.95, 103.1, 16,
                                    [(2047, 16), (4100, 9)])]}),
              NS(spans={"admit": [(100.5, 100.7, 2048)], "decode": []})],
}


@pytest.mark.parametrize("name", list(READ))
def test_the_readers_read_what_they_read(name):
    catalog = Catalog(REPO / "BENCHMARK.json")
    kind = "train" if name.startswith("phi") else "serve"
    run = NS(kind=kind, family=catalog.family(name), spec=catalog.spec(name),
             traffic={"rows": 4, "seq_len": 2048}, pods=PODS[kind],
             trace=_trace(), window=(90.0, 141.0))
    for metric, want in READ[name].items():
        assert catalog.reader(metric)(run) == pytest.approx(want, rel=1e-12)
