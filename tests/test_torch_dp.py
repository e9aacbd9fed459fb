"""Data-parallel training of the port on the CPU: ``make_sharded_train_step``
(kubeshare_tpu_torch/parallel/train.py) in gloo worlds against the
reference's ``make_sharded_train_step`` on the virtual CPU mesh, the
workload CLI's gang path in two processes, and BASELINE config 4
(``bench/configs.py resnet``) at its CPU sizes.

- dp = 2: three AdamW steps of a float32 Llama on a batch split over
  two ranks, against the reference on 2 devices: every weight within
  1e-5 abs, every step's loss within 1e-5 (the two sides sum the same
  float32 products in another order; three Adam updates of 1e-3 each
  carry that to ~1e-7). ``accum_steps=2`` against one pass, the same
  bound (two microbatches' mean is the batch's mean).
- dp = 2 x sp = 2: the ring SP loss through the same step, against the
  reference's (dp, sp) mesh, the same bounds.
- The CLI gang: two processes joined through the gang env at a
  ``tcp://127.0.0.1`` port, whose collective stop leaves both at one
  step count, and a stopped and resumed gang that ends with the loss of
  an uninterrupted one, bit for bit (the same batches and float32
  arithmetic).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeshare_tpu.models import llama as jllama
from kubeshare_tpu.parallel import MeshPlan as JMeshPlan
from kubeshare_tpu.parallel import make_mesh as jmake_mesh
from kubeshare_tpu.parallel import make_sharded_train_step as jstep
from kubeshare_tpu_torch.bench import configs
from kubeshare_tpu_torch.parallel import MeshPlan, make_mesh
from kubeshare_tpu_torch.parallel import make_sharded_train_step
from kubeshare_tpu_torch.parallel.launch import run_world

import test_torch_parallel_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA = dict(vocab=64, dim=32, layers=2, num_heads=4, num_kv_heads=2,
             mlp_dim=64, max_seq_len=32, dtype="float32")
STEPS = 3
LR = 1e-3
WEIGHT_TOL = 1e-5


def _params():
    return jax.tree.map(np.asarray, jllama.init_llama(
        jax.random.PRNGKey(3), jllama.LlamaConfig(**LLAMA)))


def _tokens(rows=4, length=17):
    return np.random.default_rng(4).integers(
        0, LLAMA["vocab"], size=(rows, length)).astype(np.int64)


def _reference(plan, sp_impl=None):
    cfg = jllama.LlamaConfig(**LLAMA)
    mesh = jmake_mesh(plan, devices=jax.devices()[:plan.total])
    if sp_impl:
        loss_fn = jllama.make_llama_sp_loss(cfg, mesh, impl=sp_impl)
    else:
        def loss_fn(p, t):
            return jllama.llama_loss(p, t, cfg)
    step, params, opt_state = jstep(
        loss_fn, jax.tree.map(jnp.asarray, _params()), mesh,
        learning_rate=LR, fsdp=False,
        batch_spec=NamedSharding(mesh, P("dp", None)))
    tokens = jnp.asarray(_tokens(), jnp.int32)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def _assert_same_training(got, want):
    got_losses, got_params = got
    want_losses, want_params = want
    np.testing.assert_allclose(got_losses, want_losses, rtol=0,
                               atol=WEIGHT_TOL)
    for g, w in zip(jax.tree.leaves(got_params), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(g, w, rtol=0, atol=WEIGHT_TOL)


@pytest.fixture(scope="module")
def dp_world():
    return run_world(ranks.dp_train, 2,
                     args=(_params(), LLAMA, _tokens(), STEPS, LR),
                     timeout=120, device_type="cpu")


def test_dp2_adamw_steps_match_the_reference_on_2_devices(dp_world):
    want = _reference(JMeshPlan(dp=2))
    for rank in dp_world:
        assert rank["backend"] == "gloo"
        _assert_same_training(rank["plain"], want)


def test_accumulation_matches_one_pass(dp_world):
    for rank in dp_world:
        _assert_same_training(rank["accum"], dp_world[0]["plain"])


def test_sp_and_dp_compose_as_in_the_reference():
    world = run_world(ranks.sp_dp_train, 4,
                      args=(_params(), LLAMA, _tokens(length=33), STEPS, LR),
                      timeout=120, device_type="cpu")
    cfg = jllama.LlamaConfig(**LLAMA)
    mesh = jmake_mesh(JMeshPlan(dp=2, sp=2), devices=jax.devices()[:4])
    step, params, opt_state = jstep(
        jllama.make_llama_sp_loss(cfg, mesh, impl="ring"),
        jax.tree.map(jnp.asarray, _params()), mesh, learning_rate=LR,
        fsdp=False, batch_spec=NamedSharding(mesh, P("dp", None)))
    tokens = jnp.asarray(_tokens(length=33), jnp.int32)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    for rank in world:
        _assert_same_training(rank["sp_dp"],
                              (losses, jax.tree.map(np.asarray, params)))


def test_unported_axes_are_refused_and_fsdp_1_is_not():
    """Every axis of the reference's mesh is ported now: only an axis no
    mesh has is refused, and the reference's default fsdp specs on a
    mesh whose fsdp axis is 1 split nothing."""
    import torch

    from kubeshare_tpu_torch.parallel import sharding

    mesh = make_mesh(MeshPlan())
    sharding.check_specs({"w": sharding.P("fsdp", "tp"),
                          "b": sharding.P(("dp", "fsdp"))}, mesh)
    with pytest.raises(ValueError, match="mesh axes"):
        sharding.check_specs({"w": sharding.P("model")}, mesh)
    model = torch.nn.Linear(2, 2)
    step, same, opt = make_sharded_train_step(
        lambda m, x: m(x).pow(2).mean(), model, mesh, fsdp=True)
    assert same is model and isinstance(opt, torch.optim.AdamW)
    assert float(step(torch.ones(4, 2))) > 0


def test_a_weight_layout_is_refused_not_ignored():
    """A layout that splits a weight only a Llama's forward can run
    split is refused, before any collective."""
    import torch

    from kubeshare_tpu_torch.parallel.mesh import Mesh
    from kubeshare_tpu_torch.parallel.sharding import P

    plan = MeshPlan(tp=2)
    mesh = Mesh(plan, 0, {axis: None for axis in plan.axis_names})
    with pytest.raises(ValueError, match="only a Llama"):
        make_sharded_train_step(lambda m, x: m(x).sum(),
                                torch.nn.Linear(2, 2), mesh,
                                param_specs={"weight": P("tp", None),
                                             "bias": P()})


def test_a_killed_members_report_says_where_its_log_stopped():
    from kubeshare_tpu_torch.bench.configs import _member_report

    err = ("2026-01-01 00:00:00 INFO: workload.py:281 rank 1/4 (gloo, "
           "cuda:0) on mesh {'dp': 4}\n"
           "2026-01-01 00:00:01 DEBU: workload.py:363 step 3: at the gate\n"
           "2026-01-01 00:00:01 DEBU: workload.py:365 step 3: stepping "
           "(2 leases taken)\n")
    report = _member_report('{"model": "mn', err)
    assert report["doc"] is None
    assert report["joined"] == ["gloo", "cuda:0"]
    assert report["last_step"] == {"step": 3, "where": "stepping"}
    assert report["last_log"].endswith("step 3: stepping (2 leases taken)")
    assert _member_report('{"steps": 5}\n', "") == {
        "doc": {"steps": 5}, "joined": None, "last_step": None,
        "last_log": None}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gang(*argv, processes=2):
    """Run the workload CLI as a ``processes``-member gang on the CPU;
    each member's JSON line."""
    port = _free_port()
    procs = []
    for pid in range(processes):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("KUBESHARE_")}
        env.update({"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                    "KUBESHARE_NUM_PROCESSES": str(processes),
                    "KUBESHARE_PROCESS_ID": str(pid),
                    "OMP_NUM_THREADS": "1"})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeshare_tpu_torch.cmd.workload",
             "--device", "cpu", *argv],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    docs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err[-2000:]
            docs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return docs


def test_cli_gang_stops_together_and_resumes(tmp_path):
    base = ["--model", "mnist", "--batch", "4"]
    whole = _gang(*base, "--steps", "300")
    assert [d["processes"] for d in whole] == [2, 2]
    assert [d["global_batch"] for d in whole] == [8, 8]
    assert whole[0]["final_loss"] == whole[1]["final_loss"]
    ckpt = str(tmp_path / "ck")
    # a gang stopped by its duration: both members stop at one step,
    # and the checkpoint is written once, at that step
    first = _gang(*base, "--duration", "0.1", "--checkpoint-dir", ckpt,
                  "--checkpoint-every", "1000")
    done = first[0]["steps"]
    assert [d["steps"] for d in first] == [done, done] and 0 < done < 300
    assert sorted(os.listdir(ckpt)) == [f"step_{done:010d}"]
    rest = _gang(*base, "--steps", str(300 - done), "--checkpoint-dir", ckpt)
    assert [d["steps"] for d in rest] == [300 - done] * 2
    assert rest[0]["final_loss"] == whole[0]["final_loss"]
    assert rest[1]["final_loss"] == whole[1]["final_loss"]


def test_resnet_config_4_at_its_cpu_sizes():
    doc = configs.run_resnet_dp(phase_seconds=0.2, rounds=1, device="cpu",
                                small=True, dp_steps=2)
    assert doc["unit"] == "samples/sec" and doc["value"] > 0
    assert doc["dp_pods"] == 8 and doc["dp8_backend"] == "gloo"
    assert doc["p99_step_latency_ms"] > 0
    assert doc["dp8_step_ms"] > 0 and doc["single_process_step_ms"] > 0
    # the same weights and data: the first-step losses agree
    assert doc["dp8_vs_single_loss_rel_err"] < 1e-5
    assert len(set(doc["dp8_last_loss"])) == 1
    assert doc["dp8_comm"]["bytes"] > 0 and doc["device"] == "cpu"
