"""Tensor parallelism and fully sharded weights of the port on the CPU:
``comm.copy_to`` / ``reduce_from`` / ``reduce_scatter``,
``parallel.shard_params`` by the reference's specs, and
``make_sharded_train_step`` over dp x fsdp x tp in one 4-rank gloo
world (kubeshare_tpu_torch/parallel/{comm,sharding,fsdp,train}.py,
models/llama.py), against the reference's ``make_sharded_train_step``
on 4 devices of the virtual CPU mesh (``tests/test_parallel.py::
TestSharding``'s cases, on 4 devices where it has 8).

Tolerances, float32 throughout: the first step's loss 1e-5 abs and each
gradient 1e-5 of its max abs (tp and fsdp sum the same products in
another order: the vocab-parallel normaliser, the row-parallel partial
sums, the reduce-scattered weight gradients); the weights after one
AdamW step 1e-5 abs, as PR 9's dp tests (an update of lr 1e-3 moves a
weight by ~1e-3, so a sign flip of a near-zero gradient would show);
the four-step loss trajectory 1e-5 abs; gradient accumulation against
one pass 1e-5, the reference's own bound. Weights from the reference's
``init_llama``, tokens from ``np.random.default_rng``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.models import llama as jllama
from kubeshare_tpu.parallel import MeshPlan as JMeshPlan
from kubeshare_tpu.parallel import make_mesh as jmake_mesh
from kubeshare_tpu.parallel import make_sharded_train_step as jstep
from kubeshare_tpu_torch.models import llama as tllama
from kubeshare_tpu_torch.models.convert import llama_from_jax
from kubeshare_tpu_torch.parallel import (
    MeshPlan, batch_sharding, make_sharded_train_step, shard_params,
    shard_tensor,
)
from kubeshare_tpu_torch.parallel.launch import run_world
from kubeshare_tpu_torch.parallel.mesh import Mesh
from kubeshare_tpu_torch.parallel.sharding import P, build_param_specs

import test_torch_parallel_ranks as ranks

N = 4
LLAMA = dict(vocab=64, dim=32, layers=2, num_heads=4, num_kv_heads=2,
             mlp_dim=64, max_seq_len=32, dtype="float32")
LOSS_TOL = 1e-5
GRAD_REL_TOL = 1e-5
WEIGHT_TOL = 1e-5

CASES = {
    "fsdp2_tp2": {"plan": {"fsdp": 2, "tp": 2}, "lr": 1e-3, "steps": 1},
    "fsdp2_tp2_vocab_chunk": {"plan": {"fsdp": 2, "tp": 2}, "lr": 1e-3,
                              "steps": 1, "vocab_chunk": 24},
    "dp2_tp2": {"plan": {"dp": 2, "tp": 2}, "lr": 1e-3, "steps": 1,
                "fsdp": False},
    "fsdp4": {"plan": {"fsdp": 4}, "lr": 1e-3, "steps": 1},
    "fsdp2_tp2_accum4": {"plan": {"fsdp": 2, "tp": 2}, "lr": 1e-3,
                         "steps": 1, "accum": 4},
    "learns": {"plan": {"fsdp": 2, "tp": 2}, "lr": 5e-3, "steps": 4},
    "dp2_sp2_fsdp_specs": {"plan": {"dp": 2, "sp": 2}, "lr": 1e-3,
                           "steps": 2, "sp_impl": "ring"},
    "dp2_sp2": {"plan": {"dp": 2, "sp": 2}, "lr": 1e-3, "steps": 2,
                "sp_impl": "ring", "fsdp": False},
}
MATCHED = ("fsdp2_tp2", "fsdp2_tp2_vocab_chunk", "dp2_tp2", "fsdp4")


def _params():
    return jax.tree.map(np.asarray, jllama.init_llama(
        jax.random.PRNGKey(0), jllama.LlamaConfig(**LLAMA)))


def _tokens():
    return np.random.default_rng(5).integers(
        0, LLAMA["vocab"], size=(8, 17)).astype(np.int64)


def _x():
    return np.random.default_rng(6).integers(
        -8, 8, size=(N, 4, 8)).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    return run_world(ranks.fsdp_tp_cases, N,
                     args=(_x(), _params(), LLAMA, _tokens(), CASES),
                     timeout=120, device_type="cpu")


def _port_named(tree) -> dict:
    """A reference tree (weights or gradients) by the port's parameter
    names and layouts."""
    model = llama_from_jax(tree, tllama.LlamaConfig(**LLAMA), device="cpu",
                           trainable=True)
    return {n: p.detach() for n, p in model.named_parameters()}


def _block(full: torch.Tensor, spec, mesh_view) -> np.ndarray:
    mesh = types.SimpleNamespace(**mesh_view)
    return shard_tensor(full, spec, mesh).numpy()


SPECS = {True: build_param_specs(tllama.init_llama(
    tllama.LlamaConfig(**LLAMA), device="cpu"), True)}
SPECS[False] = build_param_specs(tllama.init_llama(
    tllama.LlamaConfig(**LLAMA), device="cpu"), False)


def _mesh(**plan):
    """Rank 0's view of a mesh, for what is checked before any
    collective runs."""
    plan = MeshPlan(**plan)
    return Mesh(plan, 0, {axis: None for axis in plan.axis_names})


# ---- comm --------------------------------------------------------------


def test_copy_to_and_reduce_from_are_megatrons_pair(world):
    """copy_to: identity forward, the gradients summed; reduce_from: the
    sum forward, each rank's own gradient backward (a backward that
    summed would give every rank the sum of all ranks' weights)."""
    x = _x()
    w = [world[r]["comm"]["copy_to"][2] for r in range(N)]
    for r, doc in enumerate(world):
        y, grad, _ = doc["comm"]["copy_to"]
        np.testing.assert_array_equal(y, x[r])
        np.testing.assert_array_equal(grad, sum(w))
        y, grad, wy = doc["comm"]["reduce_from"]
        np.testing.assert_array_equal(y, x.sum(axis=0))
        np.testing.assert_array_equal(grad, wy)
        np.testing.assert_array_equal(wy, w[r])
        np.testing.assert_array_equal(doc["comm"]["bf16_reduce"], x[2])


def test_reduce_scatter_keeps_the_ranks_slice_and_gathers_back(world):
    x = _x()
    total = x.sum(axis=0)
    for r, doc in enumerate(world):
        y, _, _ = doc["comm"]["reduce_scatter_0"]
        np.testing.assert_array_equal(y, total[r:r + 1])
        y, _, _ = doc["comm"]["reduce_scatter_1"]
        np.testing.assert_array_equal(y, total[:, 2 * r:2 * r + 2])
        y, _, _ = doc["comm"]["all_gather_cat_1"]
        np.testing.assert_array_equal(y, np.concatenate(list(x), axis=1))
    for r, doc in enumerate(world):
        _, grad, _ = doc["comm"]["reduce_scatter_0"]
        np.testing.assert_array_equal(grad, np.concatenate(
            [world[j]["comm"]["reduce_scatter_0"][2] for j in range(N)]))
        _, grad, _ = doc["comm"]["reduce_scatter_1"]
        np.testing.assert_array_equal(grad, np.concatenate(
            [world[j]["comm"]["reduce_scatter_1"][2] for j in range(N)],
            axis=1))
        _, grad, _ = doc["comm"]["all_gather_cat_1"]
        np.testing.assert_array_equal(grad, sum(
            world[j]["comm"]["all_gather_cat_1"][2][:, 8 * r:8 * r + 8]
            for j in range(N)))


# ---- placement ---------------------------------------------------------


def test_llama_params_shard(world):
    """Each rank holds its block of every weight by the reference's
    specs (fsdp on the other dim of each tp-split matmul), the norms
    whole, and the layout recorded for the forward."""
    for doc in world:
        case = doc["train"]["fsdp2_tp2"]
        assert case["tp"] == 2
        assert case["fsdp_dims"] == {"wq": 1, "wk": 1, "wv": 1, "wo": 0,
                                     "w_gate": 1, "w_up": 1, "w_down": 0,
                                     "lm_head": 1}
        init = doc["train"]["learns"]
        wq = init["params"]["layers.0.wq"]
        assert wq.shape == (LLAMA["dim"] // 2, LLAMA["dim"] // 2)
        assert init["params"]["layers.0.attn_norm"].shape == (LLAMA["dim"],)
        assert init["params"]["embed"].shape == (LLAMA["vocab"] // 2,
                                                 LLAMA["dim"])
        assert case["mesh"]["shape"]["fsdp"] == 2
        assert case["mesh"]["shape"]["tp"] == 2


# ---- the train step ----------------------------------------------------


def _reference_grads(chunk):
    cfg = jllama.LlamaConfig(**LLAMA)
    tokens = jnp.asarray(_tokens(), jnp.int32)
    loss, grads = jax.value_and_grad(
        lambda p: jllama.llama_loss(p, tokens, cfg, vocab_chunk=chunk))(
        jax.tree.map(jnp.asarray, _params()))
    return float(loss), _port_named(jax.tree.map(np.asarray, grads))


def _reference_steps(plan, lr, steps, fsdp=True, chunk=0):
    cfg = jllama.LlamaConfig(**LLAMA)
    mesh = jmake_mesh(JMeshPlan(**plan), devices=jax.devices()[:N])
    step, params, opt_state = jstep(
        lambda p, b: jllama.llama_loss(p, b, cfg, vocab_chunk=chunk),
        jax.tree.map(jnp.asarray, _params()), mesh, learning_rate=lr,
        fsdp=fsdp)
    tokens = jnp.asarray(_tokens(), jnp.int32)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    return losses, _port_named(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("name", MATCHED)
def test_first_step_loss_and_gradients_match_the_reference(world, name):
    case = CASES[name]
    loss, grads = _reference_grads(case.get("vocab_chunk", 0))
    specs = SPECS[case.get("fsdp", True)]
    for doc in world:
        got = doc["train"][name]
        assert abs(got["loss0"] - loss) <= LOSS_TOL
        for pname, want in grads.items():
            block = _block(want, specs[pname], got["mesh"])
            err = np.abs(got["grads"][pname] - block).max()
            assert err <= GRAD_REL_TOL * np.abs(block).max(), (pname, err)


@pytest.mark.parametrize("name", MATCHED)
def test_one_adamw_step_matches_the_reference(world, name):
    case = CASES[name]
    losses, params = _reference_steps(case["plan"], case["lr"], 1,
                                      case.get("fsdp", True),
                                      case.get("vocab_chunk", 0))
    specs = SPECS[case.get("fsdp", True)]
    for doc in world:
        got = doc["train"][name]
        assert abs(got["losses"][0] - losses[0]) <= LOSS_TOL
        for pname, want in params.items():
            block = _block(want, specs[pname], got["mesh"])
            np.testing.assert_allclose(got["params"][pname], block, rtol=0,
                                       atol=WEIGHT_TOL, err_msg=pname)


def test_sharded_train_step_runs_and_learns(world):
    losses, _ = _reference_steps({"fsdp": 2, "tp": 2}, 5e-3, 4)
    for doc in world:
        got = doc["train"]["learns"]["losses"]
        assert np.isfinite(got).all() and got[-1] < got[0]
        np.testing.assert_allclose(got, losses, rtol=0, atol=LOSS_TOL)


def test_gradient_accumulation_matches_single_pass(world):
    for doc in world:
        one, four = doc["train"]["fsdp2_tp2"], doc["train"][
            "fsdp2_tp2_accum4"]
        assert abs(one["losses"][0] - four["losses"][0]) <= 1e-5
        for pname, want in one["params"].items():
            np.testing.assert_allclose(four["params"][pname], want,
                                       atol=1e-5, rtol=1e-4)
    model = tllama.init_llama(tllama.LlamaConfig(**LLAMA), device="cpu",
                              trainable=True)
    step, _, _ = make_sharded_train_step(
        lambda m, t: tllama.llama_loss(m, t), model,
        _mesh(), accum_steps=3)
    with pytest.raises(ValueError, match="accum"):
        step(torch.tensor(_tokens()))


def test_batch_sharding_spec():
    sharding = batch_sharding(_mesh(dp=2, fsdp=2, tp=2))
    assert sharding.batch_axes == ("dp", "fsdp") and sharding.seq_axis is None


def test_tp1_fsdp1_leaves_the_dp_sp_path_unchanged(world):
    """With the fsdp and tp axes at 1 the reference's fsdp specs split
    nothing: the model stays whole (no layout) and the dp x sp ring
    steps are bit for bit those of the replicated specs."""
    for doc in world:
        a, b = doc["train"]["dp2_sp2_fsdp_specs"], doc["train"]["dp2_sp2"]
        assert a["tp"] is None and b["tp"] is None
        assert a["losses"] == b["losses"]
        for pname, want in b["params"].items():
            np.testing.assert_array_equal(a["params"][pname], want)




def test_layouts_the_forward_cannot_run_are_refused():
    cfg = tllama.LlamaConfig(**LLAMA)
    model = tllama.init_llama(cfg, device="cpu", trainable=True)
    specs = build_param_specs(model)
    swapped = dict(specs, **{"layers.0.wq": P(None, "tp")})
    with pytest.raises(ValueError, match="tensor-parallel layout"):
        shard_params(model, _mesh(tp=2), specs=swapped)
    with pytest.raises(ValueError, match="split over tp and fsdp only"):
        shard_params(model, _mesh(dp=2),
                     specs=dict(specs, **{"embed": P("dp", None)}))
    with pytest.raises(ValueError, match="mesh axes"):
        shard_params(model, _mesh(), specs=dict(specs,
                                                **{"embed": P("xx")}))
    with pytest.raises(ValueError, match="do not split over tp=4"):
        shard_params(model, _mesh(tp=4))
    assert model.shards is None
