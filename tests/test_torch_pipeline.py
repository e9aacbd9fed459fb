"""Pipeline parallelism of the port on the CPU:
kubeshare_tpu_torch/parallel/pipeline.py and
``models.llama.llama_pipeline_hidden`` in one 4-rank gloo world, against
the reference's ``pipeline_apply`` and ``llama_pipeline_hidden`` on 4
devices of the virtual CPU mesh (``tests/test_pipeline_moe.py::
TestPipeline`` and ``::TestLlamaPipeline``'s cases; where the reference
adds dp or tp to fill 8 devices, the world has 4 ranks and the same pp).

Tolerances, float32: outputs 2e-5 (the reference's own, against
sequential application); gradients of the stage blocks 2e-5 of each
leaf's max abs against the reference's gradients; remat on and off
1e-6 (the reference's own; here they are the same bits). Stage weights
from ``jax.random`` as the reference's tests make them; inputs from
``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.models import llama as jllama
from kubeshare_tpu.parallel import MeshPlan as JMeshPlan
from kubeshare_tpu.parallel import make_mesh as jmake_mesh
from kubeshare_tpu.parallel import pipeline as jpipeline
from kubeshare_tpu_torch.parallel import MeshPlan, pipeline_apply
from kubeshare_tpu_torch.parallel.launch import run_world
from kubeshare_tpu_torch.parallel.mesh import Mesh
from kubeshare_tpu_torch.parallel.pipeline import (
    shard_stacked_params, stack_stage_params,
)

import test_torch_parallel_ranks as ranks

N = 4
OUT_TOL = 2e-5
GRAD_REL_TOL = 2e-5
REMAT_TOL = 1e-6
LLAMA = dict(vocab=128, dim=32, layers=8, num_heads=4, num_kv_heads=2,
             mlp_dim=64, max_seq_len=16, dtype="float32")


def _stages(n, dim):
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    return [{"w": np.asarray(jax.random.normal(k, (dim, dim), jnp.float32)
                             / np.sqrt(dim)),
             "b": np.full((dim,), 0.01 * i, np.float32)}
            for i, k in enumerate(keys)]


def _case(stages, dim, batch, mb, plan, seed, grads=False):
    per_stage = _stages(stages, dim)
    x = np.random.default_rng(seed).standard_normal(
        (batch, dim)).astype(np.float32)
    return {"stacked": {k: np.stack([s[k] for s in per_stage])
                        for k in ("w", "b")},
            "x": x, "mb": mb, "plan": plan, "grads": grads}


CASES = {
    "pp4_mb4": _case(4, 16, 16, 4, {"pp": 4}, 1),
    "pp4_mb8": _case(4, 16, 16, 8, {"pp": 4}, 1),
    "grads_pp2": _case(2, 8, 8, 4, {"pp": 2, "dp": 2}, 2, grads=True),
    "circular_mb2": _case(8, 16, 8, 2, {"pp": 2, "dp": 2}, 3),
    "circular_mb4": _case(8, 16, 8, 4, {"pp": 2, "dp": 2}, 3),
    "remat_pp2": _case(4, 8, 8, 4, {"pp": 2, "dp": 2}, 5, grads=True),
}


def _llama():
    cfg = jllama.LlamaConfig(**LLAMA)
    params = jllama.init_llama(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, size=(4, 16)).astype(np.int64)
    g = rng.standard_normal((4, 16, cfg.dim)).astype(np.float32)
    return {"cfg": LLAMA, "params": jax.tree.map(np.asarray, params),
            "stacked": jax.tree.map(np.asarray, jllama.llama_stack_layers(
                params, cfg)),
            "tokens": tokens, "g": g}


@pytest.fixture(scope="module")
def world():
    return run_world(ranks.pipeline_cases, N, args=(CASES, _llama()),
                     timeout=120, device_type="cpu")


def _dense_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _reference(case, grads=False, remat=True):
    mesh = jmake_mesh(JMeshPlan(**case["plan"]), devices=jax.devices()[:N])
    stacked = jax.tree.map(jnp.asarray, case["stacked"])
    x = jnp.asarray(case["x"])

    def run(p):
        return jpipeline.pipeline_apply(_dense_stage, p, x, case["mb"], mesh,
                                        remat=remat)

    if not grads:
        return np.asarray(jax.jit(run)(stacked))
    return jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: jnp.mean(run(p) ** 2)))(stacked))


def _sequential(case):
    y = case["x"]
    for i in range(case["stacked"]["w"].shape[0]):
        y = np.tanh(y @ case["stacked"]["w"][i] + case["stacked"]["b"][i])
    return y


@pytest.mark.parametrize("name", ["pp4_mb4", "pp4_mb8", "circular_mb2",
                                  "circular_mb4"])
def test_matches_sequential_and_the_reference(world, name):
    case = CASES[name]
    want = _reference(case)
    np.testing.assert_allclose(want, _sequential(case), rtol=2e-5,
                               atol=2e-5)
    for doc in world:
        got = doc[name]
        np.testing.assert_allclose(got["y_True"], want, rtol=0, atol=OUT_TOL)
        np.testing.assert_array_equal(got["y_whole_stack"], got["y_True"])


def test_circular_blocks_are_contiguous(world):
    """S=8 stages over pp=2: position i holds stages 4i .. 4i+3, the
    block ``shard_stacked_params`` places and ``pipeline_apply`` runs."""
    for rank, doc in enumerate(world):
        coords = np.argwhere(np.arange(N).reshape(2, 2) == rank)[0]
        assert doc["circular_mb4"]["first"] == 4 * coords[1]
        assert doc["circular_mb4"]["num_stages"] == 8


@pytest.mark.parametrize("name", ["grads_pp2", "remat_pp2"])
def test_grads_match_the_reference(world, name):
    case = CASES[name]
    want = _reference(case, grads=True)
    v = case["stacked"]["w"].shape[0] // case["plan"]["pp"]
    for doc in world:
        got = doc[name]
        assert np.isfinite(got["loss_True"])
        for k, g in got["grads_True"].items():
            ref = want[k][got["first"]:got["first"] + v]
            assert np.isfinite(g).all() and np.abs(g).sum() > 0
            assert np.abs(g - ref).max() <= GRAD_REL_TOL * np.abs(ref).max()


def test_remat_grads_match_unremat(world):
    for doc in world:
        got = doc["remat_pp2"]
        np.testing.assert_array_equal(got["y_True"], got["y_False"])
        for k in got["grads_True"]:
            np.testing.assert_allclose(got["grads_True"][k],
                                       got["grads_False"][k], rtol=REMAT_TOL,
                                       atol=REMAT_TOL)


def _mesh(**plan):
    plan = MeshPlan(**plan)
    return Mesh(plan, 0, {axis: None for axis in plan.axis_names})


def _torch_stages(n, dim):
    return stack_stage_params([{k: torch.tensor(v) for k, v in s.items()}
                               for s in _stages(n, dim)])


def test_indivisible_stage_count_rejected():
    with pytest.raises(ValueError, match="divisible"):
        pipeline_apply(ranks._dense_stage, _torch_stages(3, 8),
                       torch.zeros(8, 8), 4, _mesh(pp=2, dp=2))
    with pytest.raises(ValueError, match="divisible"):
        shard_stacked_params(_torch_stages(3, 8), _mesh(pp=2, dp=2))


def test_batch_divisibility_enforced():
    with pytest.raises(ValueError, match="divisible"):
        pipeline_apply(ranks._dense_stage, _torch_stages(2, 4),
                       torch.zeros(6, 4), 4, _mesh(pp=2, dp=2))


def test_mixed_leading_dims_rejected():
    stacked = dict(_torch_stages(2, 4), extra=torch.zeros(3, 4))
    with pytest.raises(ValueError, match="mixed leading"):
        pipeline_apply(ranks._dense_stage, stacked, torch.zeros(8, 4), 4,
                       _mesh(pp=2, dp=2))


def test_flagship_trunk_matches_sequential(world):
    """The flagship model's blocks through the pipeline: 8 layers chained
    2 a rank over pp=4 equal the reference's sequential trunk (and its
    pipeline), and each rank's gradients of its 2 layers equal the
    reference's for those layers."""
    data = _llama()
    cfg = jllama.LlamaConfig(**LLAMA)
    params = jax.tree.map(jnp.asarray, data["params"])
    tokens = jnp.asarray(data["tokens"], jnp.int32)
    g = jnp.asarray(data["g"])
    ref = np.asarray(jllama.llama_hidden(params, tokens, cfg))
    mesh = jmake_mesh(JMeshPlan(pp=4), devices=jax.devices()[:N])
    stacked = jax.tree.map(jnp.asarray, data["stacked"])
    ref_pp = np.asarray(jax.jit(lambda s: jllama.llama_pipeline_hidden(
        params, tokens, cfg, mesh, 2, stacked_layers=s))(stacked))
    np.testing.assert_allclose(ref_pp, ref, rtol=2e-5, atol=2e-5)

    def seq_loss(layers):
        p = dict(params, **{f"layer{i}": layer
                            for i, layer in enumerate(layers)})
        return jnp.sum(jllama.llama_hidden(p, tokens, cfg) * g)

    layer_grads = jax.grad(seq_loss)(
        [params[f"layer{i}"] for i in range(cfg.layers)])
    want = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *layer_grads)
    for doc in world:
        got = doc["llama"]
        np.testing.assert_allclose(got["hidden"], ref, rtol=OUT_TOL,
                                   atol=OUT_TOL)
        first = got["first"]
        for path, leaf in jax.tree_util.tree_leaves_with_path(got["grads"]):
            ref_leaf = want
            for key in path:
                ref_leaf = ref_leaf[key.key]
            ref_leaf = ref_leaf[first:first + 2]
            assert np.abs(leaf - ref_leaf).max() <= (
                GRAD_REL_TOL * np.abs(ref_leaf).max()), path
