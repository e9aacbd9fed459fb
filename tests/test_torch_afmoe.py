"""kubeshare_tpu_torch/models/afmoe.py and moe.py's dropless layer
against the benchmark's plain reference (perfbench/reference/
afmoe_ref.py; the JAX package has no afmoe), at tiny widths on seeded
weights drawn by the benchmark's afmoe family; and the dense Llama's
serving unchanged by the per-layer cache."""

import torch
import torch.nn.functional as F

from kubeshare_tpu_torch.models import llama, moe
from kubeshare_tpu_torch.models.afmoe import AfmoeBlock
from kubeshare_tpu_torch.models.serving import DecodeServer
from perfbench.families import afmoe as family
from perfbench.reference import afmoe_ref
from perfbench.reference.common import exact_float32

CPU = torch.device("cpu")
# 5 layers: 1 dense, then experts; 3 sliding to 1 full, then a sliding
# one; 4 heads of 16 on 2 kv heads (64 wide on a 32 hidden)
TINY = {
    "hidden_act": "silu", "hidden_size": 32, "intermediate_size": 48,
    "head_dim": 16, "num_attention_heads": 4, "num_key_value_heads": 2,
    "num_hidden_layers": 5, "num_dense_layers": 1,
    "layer_types": ["sliding_attention"] * 3 + ["full_attention"] +
                   ["sliding_attention"] * 4,
    "moe_intermediate_size": 24, "num_experts": 8, "num_experts_per_tok": 2,
    "num_shared_experts": 1, "route_norm": True, "route_scale": 2.826,
    "score_func": "sigmoid", "mup_enabled": True, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "sliding_window": 6, "vocab_size": 96,
    "torch_dtype": "float32", "tie_word_embeddings": False,
    "max_model_len": 48,
}
SPEC = family.spec("tiny-afmoe", TINY)
# float32 program against the float32 reference: the same routes, so the
# logits agree to float32 rounding through a dozen layers' products
LOGIT_TOL = 2e-4


def reference(seed, prompt_and_served, positions):
    exact_float32()
    return family.reference_logits(
        SPEC, seed, 0, [torch.tensor(prompt_and_served)],
        [torch.tensor(positions)], CPU)[0]


def test_prefill_then_decode_past_the_window_matches_the_reference():
    """Two slots, prompts of 5 and 11 tokens in buckets of 8 and 16 (the
    ring is 6 slots: buckets are capped to it, so the 11-token prompt is
    refused and a 6-token one admitted), then 20 decode steps: the
    sliding layers' rings wrap several times while the full layer's
    cache grows to 26 positions. Every served position's logits equal
    the reference's full forward over prompt + served tokens."""
    model = family.build(SPEC, 11, 0, CPU, trainable=False)
    server = DecodeServer(model, slots=3, prompt_buckets=(4, 6, 8, 16),
                          cuda_graph=False)
    assert server.buckets == (4, 6)
    assert [tuple(k.shape[2:3]) for k in server.cache["k"]] == [
        (6,), (6,), (6,), (48,), (6,)]
    prompts = {0: [5, 9, 13, 2, 77], 1: [20, 31, 42, 53, 64, 75]}
    assert server.admit(list(range(11))) is None
    served, logits = {}, {}
    for want, prompt in prompts.items():
        slot, first = server.admit(prompt)
        assert slot == want
        served[slot], logits[slot] = [first], []
    for step in range(20):
        burst = server.step_burst(4) if step % 5 == 4 else None
        if burst is None:
            for slot, tok in server.step().items():
                logits[slot].append(server.logits[slot].clone())
                served[slot].append(tok)
        else:
            for slot, toks in burst.items():
                served[slot].extend(toks)
                logits[slot].extend([None] * len(toks))
    for slot, prompt in prompts.items():
        seq = prompt + served[slot][:-1]
        first = len(prompt) - 1
        ref = reference(11, seq, list(range(first, first + len(
            served[slot]))))
        assert ref.argmax(-1).tolist() == served[slot]
        for got, want in zip(logits[slot], ref[1:]):
            if got is not None:
                torch.testing.assert_close(got, want, atol=LOGIT_TOL,
                                           rtol=0)
    assert len(prompts[1]) + len(served[1]) > 3 * TINY["sliding_window"]
    # each routed layer counted top-2 routes of the prompts' tokens and of
    # the two live lanes' 32 decode steps, not the padding nor idle slot 2
    load = server.expert_load()
    assert len(load) == 4 and all(len(row) == 8 for row in load)
    steps = len(served[0]) - 1
    assert steps == 32 and len(served[1]) - 1 == steps
    assert [sum(row) for row in load] == [2 * (5 + 6 + 2 * steps)] * 4


def _layer(experts=8, dim=16, width=12, seed=0):
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(*shape, generator=g) * shape[-1] ** -0.5

    return {"router": w(experts, dim), "expert_bias": torch.zeros(experts),
            "experts_gate": w(experts, width, dim),
            "experts_up": w(experts, width, dim),
            "experts_down": w(experts, dim, width),
            "shared_gate": w(width, dim), "shared_up": w(width, dim),
            "shared_down": w(dim, width)}


def _program(w, x, top_k, held=None, scale=1.0, norm=True, load=None):
    ids = torch.arange(w["router"].shape[0]) if held is None else held
    return moe.dropless_moe(
        x, w["router"], w["expert_bias"], w["experts_gate"][ids],
        w["experts_up"][ids], w["experts_down"][ids],
        moe.expert_slots(ids, w["router"].shape[0]), top_k, scale, norm,
        shared=(w["shared_gate"], w["shared_up"], w["shared_down"]),
        load=load)


def _swiglu(h, gate, up, down):
    return F.linear(F.silu(F.linear(h, gate)) * F.linear(h, up), down)


def test_every_token_is_kept_when_all_pick_one_expert():
    """No capacity: 64 tokens all routed to expert 3 (a bias that wins
    every selection) each get expert 3's whole output."""
    w = _layer()
    w["expert_bias"][3] = 100.0
    x = torch.randn(64, 16, generator=torch.Generator().manual_seed(1))
    load = torch.zeros(8, dtype=torch.int64)
    got = _program(w, x, top_k=1, scale=2.0, load=load)
    want = (2.0 * _swiglu(x, w["experts_gate"][3], w["experts_up"][3],
                          w["experts_down"][3])
            + _swiglu(x, w["shared_gate"], w["shared_up"], w["shared_down"]))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert load.tolist() == [0, 0, 0, 64, 0, 0, 0, 0]


def test_the_bias_selects_experts_but_does_not_weight_them():
    """With a bias on expert 5 it is chosen for every token, weighted by
    its unbiased score sigmoid(router x), not by score + bias."""
    w = _layer(seed=2)
    x = torch.randn(10, 16, generator=torch.Generator().manual_seed(3))
    plain = _program(w, x, top_k=1, norm=False)
    w["expert_bias"][5] = 10.0
    biased = _program(w, x, top_k=1, norm=False)
    assert not torch.allclose(plain, biased)
    score = torch.sigmoid(x @ w["router"][5])
    want = (score[:, None] * _swiglu(x, w["experts_gate"][5],
                                     w["experts_up"][5], w["experts_down"][5])
            + _swiglu(x, w["shared_gate"], w["shared_up"], w["shared_down"]))
    torch.testing.assert_close(biased, want, atol=1e-5, rtol=1e-5)
    spec = family.spec("tiny-afmoe", dict(TINY, num_experts_per_tok=1,
                                          route_norm=False, route_scale=1.0))
    torch.testing.assert_close(afmoe_ref.experts(spec, w, x), want,
                               atol=1e-5, rtol=1e-5)


def test_the_shares_of_the_experts_add_up_to_the_whole_layer():
    """Experts split over two ranks (6 and 2, not in order): each
    share's result, the shared expert counted once, adds up to the whole
    layer, the program's and the uncut reference's alike; each share
    agrees with the reference given the same share."""
    w = _layer(seed=4)
    w["expert_bias"] = torch.randn(8, generator=torch.Generator().manual_seed(5)) * 0.1
    x = torch.randn(40, 16, generator=torch.Generator().manual_seed(6))
    shares = [torch.tensor([0, 2, 3, 5, 6, 7]), torch.tensor([4, 1])]
    parts = [_program(w, x, top_k=3, held=ids, scale=2.826) for ids in shares]
    shared = _swiglu(x, w["shared_gate"], w["shared_up"], w["shared_down"])
    whole = _program(w, x, top_k=3, scale=2.826)
    spec = family.spec("tiny-afmoe", dict(TINY, num_experts_per_tok=3))
    uncut = afmoe_ref.experts(spec, w, x)
    torch.testing.assert_close(parts[0] + parts[1] - shared, whole,
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(whole, uncut, atol=1e-5, rtol=1e-5)
    for ids, part in zip(shares, parts):
        mine = {k: (v[ids] if k.startswith("experts_") else v)
                for k, v in w.items()}
        torch.testing.assert_close(
            afmoe_ref.experts(spec, mine, x, held=ids.tolist()), part,
            atol=1e-5, rtol=1e-5)


def test_a_block_refuses_missing_weights_and_a_wrong_share():
    w = _layer()
    attention = {n: torch.ones(4) for n in AfmoeBlock.ATTENTION}
    try:
        AfmoeBlock(**attention, **{k: v for k, v in w.items()
                                   if k != "expert_bias"})
    except ValueError as e:
        assert "expert_bias" in str(e)
    else:
        raise AssertionError("a block without its bias was built")
    try:
        AfmoeBlock(experts=[0, 1], **attention, **w)
    except ValueError as e:
        assert "expert ids" in str(e)
    else:
        raise AssertionError("two ids for eight experts were taken")


# a dense Llama served before the cache became per-layer (golden values
# from the tree before the change): the tokens of 6 steps and an 8-step
# burst, and each step's sum of |logits| of the two slots
LLAMA_FIRST = [(0, 71), (1, 55)]
LLAMA_TOKENS = [[29, 57], [42, 57], [42, 57], [42, 57], [2, 89], [42, 57],
                [[2, 29, 19, 19, 57, 57, 57, 57],
                 [64, 57, 71, 91, 29, 31, 29, 62]]]
LLAMA_SUMS = [[79.8683, 77.2248], [68.0777, 79.5121], [74.4639, 81.226],
              [70.0676, 80.1372], [64.2179, 81.1227], [73.1763, 81.6932],
              [83.2578, 71.3291]]


def test_the_dense_llama_serves_as_before_the_per_layer_cache():
    cfg = llama.LlamaConfig(vocab=96, dim=32, layers=2, num_heads=4,
                            num_kv_heads=2, mlp_dim=48, max_seq_len=64,
                            dtype="float32", window=16, rope_theta=10000.0)
    model = llama.init_llama(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
    server = DecodeServer(model, slots=3, prompt_buckets=(8, 16),
                          cuda_graph=False)
    assert isinstance(server.cache["k"], torch.Tensor)
    assert tuple(server.cache["k"].shape) == (2, 3, 2, 16, 8)
    first = [server.admit([5, 9, 13, 2, 77]),
             server.admit(list(range(20, 31)))]
    assert first == LLAMA_FIRST
    tokens, sums = [], []
    for i in range(7):
        if i < 6:
            out = server.step()
        else:
            out = server.step_burst(8)
        tokens.append([out[0], out[1]])
        sums.append([float(server.logits[s].abs().sum()) for s in (0, 1)])
    assert tokens == LLAMA_TOKENS
    for got, want in zip(sums, LLAMA_SUMS):
        torch.testing.assert_close(torch.tensor(got), torch.tensor(want),
                                   atol=1e-4, rtol=0)


def test_a_mixed_cache_holds_one_buffer_a_kind():
    from kubeshare_tpu_torch.models.afmoe import AfmoeConfig

    cfg = AfmoeConfig(dim=8, layers=5, num_heads=2, num_kv_heads=1,
                      head_dim=4, top_k=2,
                      layer_types=tuple(TINY["layer_types"][:5]), window=6,
                      max_seq_len=20, dtype="float32")
    assert llama.layer_slots(cfg) == (6, 6, 6, 20, 6)
    assert llama.cache_slots(cfg) == 6
    cache = llama.init_kv_cache(cfg, 3, per_slot=True, device="cpu")
    ring = cache["k"][0]
    assert [k.shape[2] for k in cache["k"]] == [6, 6, 6, 20, 6]
    assert all(k.untyped_storage().data_ptr() == ring.untyped_storage(
    ).data_ptr() for i, k in enumerate(cache["k"]) if i != 3)
    assert cache["k"][4].data_ptr() - ring.data_ptr() == (
        3 * ring.numel() * ring.element_size())


def test_the_decode_graphs_warm_up_leaves_the_expert_count_as_it_was():
    """A CUDA graph's capture runs the decode step twice before it
    records it (``graph.restoring``); those runs put back what later
    steps read, the expert count among it, so a capture counts no
    route. Here the warm-up is called as the capture calls it."""
    model = family.build(SPEC, 5, 0, CPU, trainable=False)
    server = DecodeServer(model, slots=2, prompt_buckets=(4,),
                          cuda_graph=False)
    server.admit([5, 9, 13])
    server._load_inputs()
    before = server.expert_load()
    length = server.cache["length"].clone()
    server.decode_step._warmup()
    assert server.expert_load() == before
    assert torch.equal(server.cache["length"], length)
    server.step()
    assert [sum(r) for r in server.expert_load()] == [
        sum(r) + 2 for r in before]
