"""Sequence parallelism of the port on the CPU: ring and Ulysses
attention (kubeshare_tpu_torch/parallel/{ring_attention,ulysses}.py) and
``make_llama_sp_loss`` in a 4-rank gloo world, against the reference's
``make_ring_attention``, ``make_ulysses_attention`` and
``make_llama_sp_loss`` on 4 devices of the virtual CPU mesh, and the
workload CLI's ``--sp``.

The port's flash route runs the kernels' plain versions here (its
tensors are on the CPU); it is held against the reference's dense route,
the same function (the reference's flash hop needs T_local in multiples
of 128 and its Pallas kernel runs interpreted, ~10 s a case on this
CPU; the reference's own tests hold its flash ring against its dense
one). The port's window runs on the dense ring and on both Ulysses
cores; ring + flash + window is refused, as in the reference.

Tolerances, float32 throughout: outputs 1e-5 abs (the two sides sum in
another order); each gradient 1e-4 of its max abs; the SP loss 1e-5 and
its gradient trees 1e-4 of each leaf's max abs (the reference's own SP
tests: 1e-5 on the loss, 2e-4 abs on gradients). Inputs from
``np.random.default_rng`` seeds; weights from the reference's
``init_llama``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeshare_tpu.models import llama as jllama
from kubeshare_tpu.parallel import MeshPlan as JMeshPlan
from kubeshare_tpu.parallel import make_mesh as jmake_mesh
from kubeshare_tpu.parallel.ring_attention import make_ring_attention as jring
from kubeshare_tpu.parallel.ulysses import make_ulysses_attention as julysses
from kubeshare_tpu_torch.cmd import workload
from kubeshare_tpu_torch.parallel import MeshPlan, make_mesh
from kubeshare_tpu_torch.parallel.launch import run_world
from kubeshare_tpu_torch.parallel.ring_attention import make_ring_attention
from kubeshare_tpu_torch.runtime import hook

import test_torch_parallel_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
OUT_TOL = 1e-5
GRAD_REL_TOL = 1e-4


def _case(impl, causal=True, flash=False, heads=4, kv_heads=2, t=64,
          window=0, batch=2, head_dim=16):
    return {"impl": impl, "causal": causal, "flash": flash, "heads": heads,
            "kv_heads": kv_heads, "t": t, "window": window, "batch": batch,
            "head_dim": head_dim}


ATTENTION = {
    "ring_dense_causal_gqa": _case("ring"),
    "ring_dense_full": _case("ring", causal=False, kv_heads=4),
    "ring_dense_window_8": _case("ring", window=8),
    "ring_dense_window_24": _case("ring", window=24),
    "ring_flash_causal_gqa": _case("ring", flash=True),
    "ring_flash_full_ragged": _case("ring", causal=False, flash=True, t=60),
    "ulysses_dense_hkv2": _case("ulysses"),
    "ulysses_dense_hkv4": _case("ulysses", heads=8, kv_heads=4),
    "ulysses_dense_window": _case("ulysses", window=12),
    "ulysses_flash_hkv2": _case("ulysses", flash=True),
    "ulysses_flash_hkv4_full": _case("ulysses", causal=False, flash=True,
                                     heads=8, kv_heads=4),
    "ulysses_flash_window": _case("ulysses", flash=True, window=12),
}

LLAMA = dict(vocab=64, dim=32, layers=2, num_heads=8, num_kv_heads=4,
             mlp_dim=64, max_seq_len=32, dtype="float32")
LOSS = {
    "ring": {"impl": "ring", "flash": False, "vocab_chunk": 0, "window": 0},
    "ring_flash": {"impl": "ring", "flash": True, "vocab_chunk": 0,
                   "window": 0},
    "ulysses": {"impl": "ulysses", "flash": False, "vocab_chunk": 0,
                "window": 0},
    "ring_vocab_chunk": {"impl": "ring", "flash": False, "vocab_chunk": 24,
                         "window": 0},
    "ring_window": {"impl": "ring", "flash": False, "vocab_chunk": 0,
                    "window": 6},
    "ulysses_flash_window": {"impl": "ulysses", "flash": True,
                             "vocab_chunk": 0, "window": 6},
}


def _arrays(seed, case):
    rng = np.random.default_rng(seed)
    b, h, hkv, t, d = (case[k] for k in ("batch", "heads", "kv_heads", "t",
                                         "head_dim"))
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, t, d), (b, hkv, t, d), (b, hkv, t, d),
                          (b, h, t, d))]


ARRAYS = {name: _arrays(i, case) for i, (name, case)
          in enumerate(ATTENTION.items())}


def _jax_params():
    return jax.tree.map(np.asarray, jllama.init_llama(
        jax.random.PRNGKey(11), jllama.LlamaConfig(**LLAMA)))


def _tokens():
    return np.random.default_rng(12).integers(
        0, LLAMA["vocab"], size=(2, 33)).astype(np.int64)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(JMeshPlan(sp=N), devices=jax.devices()[:N])


@pytest.fixture(scope="module")
def world():
    return run_world(ranks.sp_cases, N,
                     args=(ATTENTION, ARRAYS, _jax_params(), LLAMA, _tokens(),
                           LOSS),
                     timeout=120, device_type="cpu")


@pytest.fixture
def attention_world(world):
    return [r["attention"] for r in world]


@pytest.fixture
def loss_world(world):
    return [r["loss"] for r in world]


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", list(ATTENTION))
def test_attention_matches_the_reference_on_4_devices(name, jmesh,
                                                      attention_world):
    case = ATTENTION[name]
    make = jring if case["impl"] == "ring" else julysses
    # the reference's dense route: its flash hop is the same function
    fn = make(jmesh, causal=case["causal"], use_flash=False,
              window=case["window"])

    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(g)

    q, k, v, g = (jnp.asarray(a) for a in ARRAYS[name])
    want_out, want_grads = jax.jit(run)(q, k, v, g)
    got = [np.concatenate([r[name][i] for r in attention_world], axis=2)
           for i in range(4)]
    np.testing.assert_allclose(got[0], np.asarray(want_out), rtol=0,
                               atol=OUT_TOL)
    for what, g_got, g_want in zip("qkv", got[1:], want_grads):
        assert _rel(g_got, np.asarray(g_want)) <= GRAD_REL_TOL, what


def _lse(q, k, causal, window):
    """The rows' log-sum-exp over every visible key, in float64."""
    reps = q.shape[1] // k.shape[1]
    k = np.repeat(k.astype(np.float64), reps, axis=1)
    scores = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k)
    scores *= q.shape[-1] ** -0.5
    if causal:
        pos = np.arange(q.shape[2])
        visible = pos[None, :] <= pos[:, None]
        if window > 0:
            visible &= pos[None, :] > pos[:, None] - window
        scores = np.where(visible, scores, -np.inf)
    top = scores.max(axis=-1, keepdims=True)
    return top + np.log(np.exp(scores - top).sum(axis=-1, keepdims=True))


@pytest.mark.parametrize("name", [n for n, c in ATTENTION.items()
                                  if c["impl"] == "ring"])
def test_ring_lse_is_the_whole_rows_lse(name, attention_world):
    """The merged lse the ring weighs its hops by, against the rows'
    log-sum-exp over the whole sequence (1e-5, float32 against
    float64), and the with-lse route gives the output unchanged."""
    case = ATTENTION[name]
    q, k, _, _ = ARRAYS[name]
    got = np.concatenate([r[name][4] for r in attention_world], axis=2)
    np.testing.assert_allclose(
        got, _lse(q, k, case["causal"], case["window"]), rtol=0, atol=1e-5)
    assert all(r[name][5] for r in attention_world)


def test_ring_flash_window_is_refused_at_build_time():
    mesh = make_mesh(MeshPlan())
    with pytest.raises(ValueError, match="dense"):
        make_ring_attention(mesh, causal=True, use_flash=True, window=8)
    with pytest.raises(ValueError, match="dense"):
        make_ring_attention(mesh, causal=False, window=8)
    assert make_ring_attention(mesh, window=8).window == 8


def _leaves(tree):
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("name", list(LOSS))
def test_sp_loss_and_grads_match_the_reference(name, jmesh, loss_world):
    case = LOSS[name]
    cfg = jllama.LlamaConfig(**{**LLAMA, "window": case["window"]})
    loss_fn = jllama.make_llama_sp_loss(cfg, jmesh, impl=case["impl"],
                                        vocab_chunk=case["vocab_chunk"])
    params = jax.tree.map(jnp.asarray, _jax_params())
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jnp.asarray(_tokens(), jnp.int32))
    # the partials sum to the global mean, their gradients to its
    got_loss = sum(r[name][0] for r in loss_world)
    got_grads = jax.tree.map(lambda *g: sum(g),
                             *[r[name][1] for r in loss_world])
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5,
                               atol=1e-5)
    for got, want in zip(_leaves(got_grads), _leaves(want_grads)):
        assert got.shape == want.shape
        assert _rel(got, np.asarray(want)) <= GRAD_REL_TOL


def test_sp_loss_refuses_an_indivisible_sequence_and_a_foreign_model():
    import torch

    from kubeshare_tpu_torch.models import llama as tllama

    cfg = tllama.LlamaConfig(**LLAMA)
    mesh = make_mesh(MeshPlan())
    loss_fn = tllama.make_llama_sp_loss(cfg, mesh)
    other = tllama.init_llama(tllama.LlamaConfig(**{**LLAMA, "window": 4}),
                              device="cpu", trainable=True)
    with pytest.raises(ValueError, match="config"):
        loss_fn(other, torch.zeros(1, 9, dtype=torch.int64))
    with pytest.raises(ValueError, match="impl"):
        tllama.make_llama_sp_loss(cfg, mesh, impl="tree")


@pytest.fixture
def no_gate_env(monkeypatch):
    monkeypatch.delenv(hook.ENV_POD_MANAGER_PORT, raising=False)
    monkeypatch.delenv(hook.ENV_HBM_LIMIT, raising=False)
    for name in (workload.ENV_COORDINATOR, workload.ENV_NUM_PROCESSES,
                 workload.ENV_GANG_HEADCOUNT):
        monkeypatch.delenv(name, raising=False)


def test_cli_sp_2_trains_the_llama_sequence_sharded():
    """In its own process, under a time limit: the ranks it spawns exit
    with it."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBESHARE_") and k != workload.ENV_COORDINATOR}
    proc = subprocess.run(
        [sys.executable, "-m", "kubeshare_tpu_torch.cmd.workload", "--device",
         "cpu", "--model", "llama", "--sp", "2", "--seq-len", "32", "--batch",
         "2", "--steps", "2", "--seed", "5"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["steps"] == 2 and doc["processes"] == 1
    assert doc["global_batch"] == 2
    assert doc["final_loss"] > 0 and doc["samples_per_s"] > 0


@pytest.mark.parametrize("argv,message", [
    (["--sp", "3"], "must divide over --sp 3"),
    (["--sp", "2", "--prefetch", "2"], "--prefetch is single-process"),
    (["--sp", "2", "--sp-flash", "--window", "4"], "ring \\+ --sp-flash"),
])
def test_cli_sp_refusals(argv, message, no_gate_env):
    with pytest.raises(SystemExit, match=message):
        workload.main(["--device", "cpu", "--model", "llama", "--seq-len",
                       "32", "--steps", "1", *argv])


def test_cli_sp_in_a_gang_is_refused(monkeypatch, no_gate_env):
    monkeypatch.setenv(workload.ENV_COORDINATOR, "127.0.0.1:1")
    monkeypatch.setenv(workload.ENV_NUM_PROCESSES, "2")
    monkeypatch.setenv("KUBESHARE_PROCESS_ID", "0")
    with pytest.raises(SystemExit, match="--sp is single-process"):
        workload.main(["--device", "cpu", "--model", "llama", "--sp", "2",
                       "--seq-len", "32", "--steps", "1"])
