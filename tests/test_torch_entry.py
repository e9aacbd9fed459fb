"""kubeshare_tpu_torch/entry.py against __graft_entry__.entry().

The reference's parameter tree goes into the port with ``llama_from_jax``
and the entry's tokens (zeros [2, 128]; also random tokens) go through
both forwards. In float32 (the entry's config with ``dtype`` float32 on
both sides) the logits agree within tests/test_torch_llama.py's
LOGIT_TOL, 1e-4. At the entry's own bf16 config they are held to that
file's bf16 bound, 2e-2 of the logits' max abs: the two frameworks round
bf16 at other places (two bf16 ulps of the largest logit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from kubeshare_tpu.models import llama as jllama
from kubeshare_tpu_torch import entry as tentry
from kubeshare_tpu_torch.models.convert import llama_from_jax
from kubeshare_tpu_torch.models.llama import llama_apply
from kubeshare_tpu_torch.ops.attention import LAUNCHES

LOGIT_TOL = 1e-4
BF16_REL_TOL = 2e-2

REF_FORWARD, (REF_PARAMS, REF_TOKENS) = __graft_entry__.entry()
NP_PARAMS = jax.tree.map(np.asarray, REF_PARAMS)
# the config __graft_entry__.entry() closes over
JCFG = jllama.LlamaConfig(vocab=2048, dim=256, layers=4, num_heads=8,
                          num_kv_heads=4, mlp_dim=512, max_seq_len=512)
j_apply = jax.jit(jllama.llama_apply, static_argnames="cfg")


def test_config_and_tokens_are_the_references():
    assert dataclasses.asdict(tentry.ENTRY_CONFIG) == dataclasses.asdict(JCFG)
    assert tentry.ENTRY_TOKENS == tuple(REF_TOKENS.shape)
    assert not np.asarray(REF_TOKENS).any()


def _tokens(kind):
    if kind == "entry":
        return np.asarray(REF_TOKENS, np.int64)
    return np.random.default_rng(0).integers(0, JCFG.vocab, REF_TOKENS.shape,
                                             dtype=np.int64)


@pytest.mark.parametrize("kind", ["entry", "random"])
def test_forward_matches_the_reference_f32(kind):
    jcfg = dataclasses.replace(JCFG, dtype="float32")
    cfg = dataclasses.replace(tentry.ENTRY_CONFIG, dtype="float32")
    toks = _tokens(kind)
    want = j_apply(REF_PARAMS, jnp.asarray(toks, jnp.int32), jcfg)
    model = llama_from_jax(NP_PARAMS, cfg, device="cpu")
    got = llama_apply(model, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 128, 2048)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)


def test_forward_matches_the_reference_entry_bf16():
    """The reference's entry() itself, its bf16 config and zero tokens."""
    want = np.asarray(jax.jit(REF_FORWARD)(REF_PARAMS, REF_TOKENS))
    model = llama_from_jax(NP_PARAMS, tentry.ENTRY_CONFIG, device="cpu")
    got = llama_apply(model, torch.from_numpy(_tokens("entry"))).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= BF16_REL_TOL


def test_entry_on_the_cpu_runs_the_plain_path():
    before = dict(LAUNCHES)
    forward, (model, tokens) = tentry.entry("cpu")
    assert forward is llama_apply
    assert model.cfg == tentry.ENTRY_CONFIG and model.device.type == "cpu"
    assert model.embed.dtype == torch.bfloat16
    assert tokens.shape == (2, 128) and not tokens.any()
    logits = forward(model, tokens)
    assert logits.shape == (2, 128, 2048) and torch.isfinite(logits).all()
    assert LAUNCHES == before           # the CPU runs no kernel
    # seeded: a second entry gives the same weights
    again = tentry.entry("cpu")[1][0]
    assert torch.equal(again.lm_head, model.lm_head)


def test_entry_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tentry.entry()
