"""kubeshare_tpu_torch/parallel/{mesh,multihost,comm}.py on the CPU,
against kubeshare_tpu/parallel/{mesh,multihost}.py: the mesh plan
arithmetic case for case, the gang env contract on the reference's own
cases, the rank mesh of a 4-rank gloo world laid out as the reference
lays devices on its mesh (and its refusals), the backend rule, and every
collective of comm.py with its gradient against a hand-rolled
expectation (exact: the collectives move and add float32 values; the
sums here are of small integers).

The world is spawned once for the module (``parallel.launch.run_world``,
``file://`` rendezvous under a temporary directory, 120 s limit); its
ranks run ``tests/test_torch_parallel_ranks.py``.
"""

import numpy as np
import pytest

import jax
from kubeshare_tpu.parallel import mesh as jmesh
from kubeshare_tpu.parallel import multihost as jmultihost
from kubeshare_tpu_torch.parallel import mesh as tmesh
from kubeshare_tpu_torch.parallel import multihost as tmultihost
from kubeshare_tpu_torch.parallel.launch import WorldFailed, run_world

import test_torch_parallel_ranks as ranks

N = 4
X_SHAPE = (4, 8)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 96])
@pytest.mark.parametrize("tp_max,fsdp_max", [(8, 8), (2, 8), (4, 2), (1, 1)])
def test_factorize_devices_matches_the_reference(n, tp_max, fsdp_max):
    want = jmesh.factorize_devices(n, tp_max, fsdp_max)
    got = tmesh.factorize_devices(n, tp_max, fsdp_max)
    assert got.shape == want.shape
    assert got.axis_names == want.axis_names
    assert got.total == want.total


ENV_CASES = [
    ({"JAX_COORDINATOR_ADDRESS": "gang-0.svc:8476",
      "KUBESHARE_NUM_PROCESSES": "4", "KUBESHARE_PROCESS_ID": "2"}, ""),
    ({"JAX_COORDINATOR_ADDRESS": "gang-0.svc:8476",
      "KUBESHARE_GROUP_HEADCOUNT": "8", "JOB_COMPLETION_INDEX": "5"}, ""),
    ({"JAX_COORDINATOR_ADDRESS": "gang-0.svc:8476",
      "KUBESHARE_NUM_PROCESSES": "2"}, "dp-resnet-1"),
    ({"JAX_COORDINATOR_ADDRESS": "gang-0.svc:8476",
      "KUBESHARE_NUM_PROCESSES": "2"}, "nonumber"),
    ({}, ""),
    ({"JAX_COORDINATOR_ADDRESS": "x:1", "KUBESHARE_NUM_PROCESSES": "1"}, ""),
    ({"JAX_COORDINATOR_ADDRESS": "x:1", "KUBESHARE_NUM_PROCESSES": "2",
      "KUBESHARE_PROCESS_ID": "7"}, ""),
    ({"JAX_COORDINATOR_ADDRESS": "x:1", "KUBESHARE_NUM_PROCESSES": "two"},
     ""),
    ({"JAX_COORDINATOR_ADDRESS": "x:1", "KUBESHARE_NUM_PROCESSES": "2",
      "KUBESHARE_PROCESS_ID": "one"}, ""),
]


@pytest.mark.parametrize("env,hostname", ENV_CASES)
def test_spec_from_env_matches_the_reference(env, hostname):
    want = jmultihost.spec_from_env(env, hostname=hostname)
    got = tmultihost.spec_from_env(env, hostname=hostname)
    if want is None:
        assert got is None
    else:
        assert (got.coordinator, got.num_processes, got.process_id) == (
            want.coordinator, want.num_processes, want.process_id)


def test_no_gang_initializes_nothing():
    assert tmultihost.maybe_initialize({}) is None


@pytest.mark.parametrize("nodes,device_type,backend", [
    ([("a", 1)] * 4, "cuda", "gloo"),          # four ranks share a card
    ([("a", 4)] * 4, "cuda", "nccl"),
    ([("a", 2), ("a", 2), ("b", 1), ("b", 1)], "cuda", "gloo"),
    ([("a", 1), ("b", 1)], "cuda", "nccl"),
    ([("a", 0)], "cuda", "gloo"),
    ([("a", 8)] * 2, "cpu", "gloo"),
])
def test_backend_rule(nodes, device_type, backend):
    assert tmultihost.choose_backend(nodes, device_type)[0] == backend


def test_mesh_without_a_world_is_one_rank():
    mesh = tmesh.make_mesh(tmesh.MeshPlan())
    assert mesh.size == 1
    assert all(mesh.group(a) is None for a in mesh.axis_names)
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh(tmesh.MeshPlan(dp=2))


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 8, size=(N, *X_SHAPE)).astype(np.float32)
    w = rng.integers(-4, 4, size=(N, *X_SHAPE)).astype(np.float32)
    return x, w


@pytest.fixture(scope="module")
def world():
    x, w = _inputs()
    return run_world(ranks.mesh_and_comm, N, args=(x, w), timeout=120,
                     device_type="cpu")


def test_world_runs_on_gloo_on_the_cpu(world):
    assert [r["backend"] for r in world] == ["gloo"] * N
    assert [r["device"] for r in world] == ["cpu"] * N


def test_mesh_lays_ranks_out_as_the_reference_lays_devices(world):
    plan = jmesh.MeshPlan(dp=2, sp=2)
    ids = np.vectorize(lambda d: d.id)(
        jmesh.make_mesh(plan, devices=jax.devices()[:N]).devices)
    for rank, doc in enumerate(world):
        where = dict(zip(plan.axis_names, np.argwhere(ids == rank)[0]))
        assert doc["coords"] == where
        dp, sp = where["dp"], where["sp"]
        # the members of this rank's sp and dp groups
        assert doc["sp_ranks"] == list(ids[dp, 0, 0, :, 0, 0])
        assert doc["dp_ranks"] == list(ids[:, 0, 0, sp, 0, 0])
        assert doc["sp_group_size"] == 2 and doc["tp_group"] is None
        assert doc["hybrid"] == {"dp": N, "pp": 1, "fsdp": 1, "sp": 1,
                                 "tp": 1, "ep": 1}


def test_mesh_size_mismatches_raise(world):
    with pytest.raises(ValueError, match="devices"):
        jmesh.make_mesh(jmesh.MeshPlan(dp=16))
    for doc in world:
        assert "needs 8 devices, have 4" in doc["too_big"]
        assert "needs 2 devices" in doc["hybrid_bad"]


def test_ppermute_and_its_gradient(world):
    x, w = _inputs()
    for shift in (1, -1, 2):
        for r, doc in enumerate(world):
            y, grad, _ = doc[f"ppermute_{shift}"]
            np.testing.assert_array_equal(y, x[(r - shift) % N])
            # x_r went to rank r + shift, whose weight comes back
            np.testing.assert_array_equal(grad, w[(r + shift) % N])


def test_all_to_all_is_tiled_and_its_gradient_reverses_it(world):
    x, _ = _inputs()
    for r, doc in enumerate(world):
        y, _, _ = doc["all_to_all_0_1"]
        np.testing.assert_array_equal(
            y, np.concatenate([x[i][r:r + 1] for i in range(N)], axis=1))
        y, _, _ = doc["all_to_all_1_0"]
        np.testing.assert_array_equal(
            y, np.concatenate([x[i][:, 2 * r:2 * r + 2] for i in range(N)],
                              axis=0))
    for i, doc in enumerate(world):
        _, grad, _ = doc["all_to_all_0_1"]
        want = np.concatenate([world[r]["all_to_all_0_1"][2][:, 8 * i:8 * i + 8]
                               for r in range(N)], axis=0)
        np.testing.assert_array_equal(grad, want)
        _, grad, _ = doc["all_to_all_1_0"]
        want = np.concatenate([world[r]["all_to_all_1_0"][2][4 * i:4 * i + 4]
                               for r in range(N)], axis=1)
        np.testing.assert_array_equal(grad, want)


def test_all_reduce_and_its_gradient(world):
    x, w = _inputs()
    for doc in world:
        y, grad, _ = doc["all_reduce"]
        np.testing.assert_array_equal(y, x.sum(axis=0))
        np.testing.assert_array_equal(grad, w.sum(axis=0))
        np.testing.assert_array_equal(doc["max"], x.max(axis=0))
        np.testing.assert_array_equal(doc["broadcast_from_2"], x[2])


def test_all_gather_holds_every_shard_and_sums_gradients_at_the_owner(
        world):
    x, _ = _inputs()
    for doc in world:
        y, _, _ = doc["all_gather"]
        assert y.shape == (N, *X_SHAPE)
        np.testing.assert_array_equal(y, x)
    for i, doc in enumerate(world):
        _, grad, _ = doc["all_gather"]
        want = sum(world[r]["all_gather"][2][i] for r in range(N))
        np.testing.assert_array_equal(grad, want)


def test_stats_count_calls_and_bytes_and_stage_nothing_on_the_cpu(world):
    for doc in world:
        stats = doc["stats"]
        # forward and backward of 3 ppermutes, 2 all-to-alls, 1 all-reduce
        # and 1 all-gather (its backward one all-to-all)
        assert stats["calls"] == 2 * 3 + 2 * 2 + 2 + 2
        assert stats["bytes"] > 0 and stats["seconds"] > 0
        assert stats["staged_bytes"] == 0 and stats["drain_seconds"] == 0


def test_a_failing_rank_fails_the_world():
    with pytest.raises(WorldFailed, match="rank one fails"):
        run_world(ranks.fail_on_rank_one, 2, timeout=60, device_type="cpu")


MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.mark.parametrize("fsdp", [True, False])
def test_param_specs_are_the_references_on_transposed_weights(fsdp):
    from kubeshare_tpu.models import llama as jllama
    from kubeshare_tpu.parallel.sharding import build_param_specs as jspecs
    from kubeshare_tpu_torch.models import llama as tllama
    from kubeshare_tpu_torch.parallel import sharding

    sizes = dict(vocab=64, dim=32, layers=2, num_heads=4, num_kv_heads=2,
                 mlp_dim=64)
    want = jspecs(jllama.init_llama(jax.random.PRNGKey(0),
                                    jllama.LlamaConfig(**sizes)), fsdp)
    model = tllama.init_llama(tllama.LlamaConfig(**sizes), device="cpu")
    got = sharding.build_param_specs(model, fsdp)
    assert set(got) == {name for name, _ in model.named_parameters()}
    for name, spec in got.items():
        parts = name.split(".")
        if parts[0] == "layers":
            ref = want[f"layer{parts[1]}"][parts[2]]
            ref = ref["scale"] if parts[2].endswith("norm") else ref
        else:
            ref = want[name]
            ref = ref.get("table", ref.get("scale")) if isinstance(
                ref, dict) else ref
        # [out, in] here, [in, out] in the reference
        flip = parts[-1] in MATRICES or name == "lm_head"
        assert tuple(spec) == (tuple(ref)[::-1] if flip else tuple(ref)), name
    doubled = sharding.apply_specs({"a": 1, "b": 2}, {"a": sharding.P(),
                                                      "b": sharding.P("dp")},
                                   lambda p, s: (p * 2, s))
    assert doubled == {"a": (2, ()), "b": (4, ("dp",))}
