"""The MoE FFN of the port on the CPU: kubeshare_tpu_torch/models/moe.py
against kubeshare_tpu/models/moe.py on the same weights
(``models/convert.py::moe_from_jax``), in one process and expert
parallel in one 4-rank gloo world (ep = 4, and ep = 2 x tp = 2), against
the reference's ``moe_ffn_apply`` in one process
(``tests/test_pipeline_moe.py::TestMoe``'s cases).

Tolerances, float32: y, aux and every gradient 1e-5 (abs for y and aux,
of each leaf's max abs for gradients): the two sides sum the same
float32 products in another order. The dispatch and combine tensors,
and so the dropped tokens, must be identical: they come from the same
float32 router probabilities through comparisons and integer counts.
The default bf16 experts: y 2e-2 abs (values of ~1; both sides round
the products' operands to bf16, and sum in another order).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.models import moe as jmoe
from kubeshare_tpu_torch.models import moe as tmoe
from kubeshare_tpu_torch.models.convert import moe_from_jax, moe_to_jax
from kubeshare_tpu_torch.parallel import shard_tensor
from kubeshare_tpu_torch.parallel.launch import run_world

import test_torch_parallel_ranks as ranks

N = 4
TOL = 1e-5
RNG = jax.random.PRNGKey(0)
EP = dict(dim=16, mlp_dim=32, experts=4, top_k=2, dtype="float32")
PLANS = {"ep4": {"ep": 4}, "ep2_tp2": {"ep": 2, "tp": 2}}


def _port(params):
    return moe_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_apply(params, x, cfg):
    return jmoe.moe_ffn_apply(jax.tree.map(jnp.asarray, params),
                              jnp.asarray(x), cfg)


def test_shapes_and_aux_match_the_reference():
    jcfg = jmoe.MoeConfig(dim=32, mlp_dim=64, experts=4, top_k=2)
    cfg = tmoe.MoeConfig(dim=32, mlp_dim=64, experts=4, top_k=2)
    params = jmoe.init_moe_ffn(RNG, jcfg)
    x = _x(3, (2, 8, 32))
    y, aux = tmoe.moe_ffn_apply(_port(params), torch.tensor(x), cfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert np.isfinite(float(aux)) and 0.5 < float(aux) < 4.0
    assert float(y.abs().sum()) > 0
    y_ref, aux_ref = _jax_apply(params, x, jcfg)
    # bf16 experts: each side rounds its products' operands alike
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                               atol=2e-2)
    assert abs(float(aux) - float(aux_ref)) <= TOL


def test_top1_vs_top2_capacity():
    params = _port(jmoe.init_moe_ffn(RNG, jmoe.MoeConfig(
        dim=16, mlp_dim=32, experts=4, top_k=1)))
    x = torch.tensor(_x(4, (1, 16, 16)))
    y1, _ = tmoe.moe_ffn_apply(params, x, tmoe.MoeConfig(
        dim=16, mlp_dim=32, experts=4, top_k=1))
    y2, _ = tmoe.moe_ffn_apply(params, x, tmoe.MoeConfig(
        dim=16, mlp_dim=32, experts=4, top_k=2))
    assert float((y2 - y1).abs().sum()) > 0


def test_zero_capacity_drops_to_passthrough():
    cfg = tmoe.MoeConfig(dim=8, mlp_dim=16, experts=2, top_k=1,
                         capacity_factor=1e-9)
    params = _port(jmoe.init_moe_ffn(RNG, jmoe.MoeConfig(
        dim=8, mlp_dim=16, experts=2, top_k=1, capacity_factor=1e-9)))
    y, _ = tmoe.moe_ffn_apply(params, torch.tensor(_x(5, (1, 4, 8))), cfg)
    per_token = y[0].abs().sum(dim=-1)
    assert int((per_token == 0).sum()) >= 2


@pytest.mark.parametrize("top_k,capacity_factor", [(1, 1.0), (2, 1.25),
                                                   (2, 0.5), (3, 0.75)])
def test_dispatch_and_combine_are_the_references(top_k, capacity_factor):
    """The same slots, the same drops: probabilities from the reference,
    routed by both."""
    jcfg = jmoe.MoeConfig(experts=4, top_k=top_k,
                          capacity_factor=capacity_factor)
    cfg = tmoe.MoeConfig(experts=4, top_k=top_k,
                         capacity_factor=capacity_factor)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(_x(6, (64, 4)) * 3)))
    capacity = tmoe.moe_capacity(cfg, 64)
    assert capacity == max(1, int(capacity_factor * 64 * top_k / 4))
    d_ref, c_ref = jmoe._dispatch_tensors(jnp.asarray(probs), jcfg,
                                          capacity)
    d, c = tmoe._dispatch_tensors(torch.tensor(probs), cfg, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    if capacity_factor < 1:
        assert d.sum() < 64 * top_k      # some tokens were dropped


def _reference_grads(params, x, g, jcfg):
    def loss(p, xx):
        y, aux = jmoe.moe_ffn_apply(p, xx, jcfg)
        return jnp.sum(y * g) + aux

    (y, aux) = _jax_apply(params, x, jcfg)
    dp, dx = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    return (np.asarray(y), float(aux), np.asarray(dx),
            jax.tree.map(np.asarray, dp))


def test_one_process_forward_and_gradients_match_the_reference():
    jcfg = jmoe.MoeConfig(**EP)
    params = jmoe.init_moe_ffn(RNG, jcfg)
    x, g = _x(7, (2, 8, 16)), _x(8, (2, 8, 16))
    y_ref, aux_ref, dx_ref, dp_ref = _reference_grads(params, x, g, jcfg)
    local = {k: v.requires_grad_() for k, v in _port(params).items()}
    xt = torch.tensor(x, requires_grad=True)
    y, aux = tmoe.moe_ffn_apply(local, xt, tmoe.MoeConfig(**EP))
    ((y * torch.tensor(g)).sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=0, atol=TOL)
    assert abs(float(aux.detach()) - aux_ref) <= TOL
    np.testing.assert_allclose(xt.grad.numpy(), dx_ref, rtol=0,
                               atol=TOL * np.abs(dx_ref).max())
    got = moe_to_jax({k: v.grad for k, v in local.items()})
    for k, want in dp_ref.items():
        assert np.abs(got[k] - want).max() <= TOL * np.abs(want).max(), k


@pytest.fixture(scope="module")
def world():
    params = jax.tree.map(np.asarray,
                          jmoe.init_moe_ffn(RNG, jmoe.MoeConfig(**EP)))
    return run_world(ranks.moe_cases, N,
                     args=(params, _x(7, (2, 8, 16)), _x(8, (2, 8, 16)), EP,
                           PLANS),
                     timeout=120, device_type="cpu")


@pytest.mark.parametrize("plan", PLANS)
def test_expert_parallel_matches_single_device(world, plan):
    """Each rank runs its experts (and hidden slice) only; y, aux, the
    gradient of x and each rank's weight blocks' gradients are the
    reference's."""
    jcfg = jmoe.MoeConfig(**EP)
    params = jmoe.init_moe_ffn(RNG, jcfg)
    y_ref, aux_ref, dx_ref, dp_ref = _reference_grads(
        params, _x(7, (2, 8, 16)), _x(8, (2, 8, 16)), jcfg)
    full = moe_from_jax(dp_ref, device="cpu")
    specs = tmoe.moe_param_spec()
    for doc in world:
        got = doc[plan]
        np.testing.assert_allclose(got["y"], y_ref, rtol=0, atol=TOL)
        assert abs(got["aux"] - aux_ref) <= TOL
        np.testing.assert_allclose(got["dx"], dx_ref, rtol=0,
                                   atol=TOL * np.abs(dx_ref).max())
        mesh = types.SimpleNamespace(**got["mesh"])
        want = moe_to_jax({k: shard_tensor(v, specs[k], mesh)
                           for k, v in full.items()})
        for k, w in want.items():
            assert got["grads"][k].shape == w.shape, k
            assert np.abs(got["grads"][k] - w).max() <= (
                TOL * np.abs(w).max()), k
