"""The elastic trainer of the port on the CPU:
kubeshare_tpu_torch/parallel/elastic.py in one 4-rank gloo world
against kubeshare_tpu/parallel/elastic.py on the virtual CPU mesh
(``tests/test_parallel.py::TestElasticTrainer``'s cases). The
reference resizes 4 -> 2 -> 8 devices; the world has 4 ranks, so both
sides resize 4 -> 2 -> 4.

The same world also runs ``tests/test_checkpoint.py``'s kill -> resize
-> checkpoint -> restore -> resume sequence (4 members, 3 steps; 2
members, 3 steps; saved through ``models/checkpoint.py``, restored, and
resumed by a new trainer on 3 members with the AdamW state and the step
count, 3 steps on the first 30 rows), on this file's model, against the
reference's trainer and checkpoint on the same sequence.

Tolerance, float32: the loss trajectory 1e-5 abs step for step, and the
weights at the end 1e-5 abs (the members' gradients are summed in
another order than the reference's sharded batch). Weights from
``jax.random`` as the reference's test makes them; data from
``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeshare_tpu.parallel.elastic import ElasticTrainer as JElastic
from kubeshare_tpu_torch.parallel.launch import run_world

import test_torch_parallel_ranks as ranks

N = 4
TOL = 1e-5
LR = 1e-2
RNG = jax.random.PRNGKey(0)


def _weights():
    return (np.asarray(jax.random.normal(RNG, (8, 16), jnp.float32) * 0.1),
            np.asarray(jax.random.normal(RNG, (16, 4), jnp.float32) * 0.1))


def _data(rows, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, 8)).astype(np.float32),
            rng.standard_normal((rows, 4)).astype(np.float32))


def _reference(devices):
    w1, w2 = _weights()

    def loss_fn(params, batch):
        x, y = batch
        pred = jnp.tanh(x @ params["w1"]) @ params["w2"]
        return jnp.mean((pred - y) ** 2)

    return JElastic(loss_fn, {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)},
                    learning_rate=LR, devices=devices)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("elastic_ckpt"))
    return run_world(ranks.elastic_cases, N,
                     args=(*_weights(), *_data(16, 1), *_data(8, 2), LR,
                           *_data(32, 3), directory),
                     timeout=120, device_type="cpu")


def test_scale_down_and_up_preserves_training(world):
    devices = jax.devices()
    trainer = _reference(devices[:4])
    x, y = (jnp.asarray(a) for a in _data(16, 1))
    want = []
    for size in (4, 2, 4):
        if trainer.dp != size:
            trainer.resize(devices[:size])
        want += [float(trainer.step((x, y))) for _ in range(3)]
    assert trainer.generation == 2
    for rank, doc in enumerate(world):
        assert doc["generation"] == [0, 1, 2]
        assert doc["dp"] == [4, 2, 4]
        losses = doc["losses"]
        if rank < 2:
            np.testing.assert_allclose(losses, want, rtol=0, atol=TOL)
            assert doc["steps"] == [3, 6, 9]
        else:
            # out of the set for the middle three steps: it idles, and
            # takes the survivors' state and step count when it rejoins
            assert losses[3:6] == [None] * 3
            np.testing.assert_allclose(losses[:3] + losses[6:],
                                       want[:3] + want[6:], rtol=0,
                                       atol=TOL)
            assert doc["steps"] == [3, 3, 9]
        assert losses[-1] < losses[0]
        params = jax.device_get(trainer.params)
        for name, got in doc["params"].items():
            np.testing.assert_allclose(got, params[name], rtol=0, atol=TOL)


def test_resize_matches_single_device_math(world):
    """Same data, same seeds: a 1-member and a 4-member trainer agree,
    and agree with the reference's."""
    a, b = _reference(jax.devices()[:1]), _reference(jax.devices()[:4])
    x, y = (jnp.asarray(v) for v in _data(8, 2))
    want_a = [float(a.step((x, y))) for _ in range(2)]
    want_b = [float(b.step((x, y))) for _ in range(2)]
    np.testing.assert_allclose(want_a, want_b, rtol=1e-5)
    for rank, doc in enumerate(world):
        np.testing.assert_allclose(doc["four"], want_b, rtol=0, atol=TOL)
        if rank == 0:
            np.testing.assert_allclose(doc["one"], want_a, rtol=0, atol=TOL)
            np.testing.assert_allclose(doc["one"], doc["four"], rtol=1e-5)
        else:
            assert doc["one"] == [None, None]


def test_bad_batch_size_rejected(world):
    for doc in world:
        assert "not divisible by dp=4" in doc["bad_batch"]


def test_kill_resize_checkpoint_restore_resume(world, tmp_path):
    from kubeshare_tpu.models.checkpoint import (
        latest_checkpoint, restore_checkpoint, save_checkpoint,
    )

    devices = jax.devices()
    x, y = (jnp.asarray(a) for a in _data(32, 3))
    trainer = _reference(devices[:4])
    want = [float(trainer.step((x, y))) for _ in range(3)]
    trainer.resize(devices[:2])
    want += [float(trainer.step((x, y))) for _ in range(3)]
    save_checkpoint(str(tmp_path), trainer.steps, trainer.params,
                    trainer.opt_state)
    assert latest_checkpoint(str(tmp_path)) == trainer.steps
    step, params, opt_state = restore_checkpoint(
        str(tmp_path), jax.device_get(trainer.params),
        jax.device_get(trainer.opt_state))
    reborn = JElastic(trainer.loss_fn, params, learning_rate=LR,
                      devices=devices[:3], opt_state=opt_state, steps=step)
    assert reborn.dp == 3 and reborn.steps == step
    want += [float(reborn.step((x[:30], y[:30]))) for _ in range(3)]
    for rank, doc in enumerate(world):
        got = doc["resume"]
        assert got["saved"] == trainer.steps == 6
        assert got["restored_steps"] == step
        assert got["dp"] == [2, 3] and got["generation"] == [1, 0]
        losses = got["losses"]
        if rank == 3:
            # outside both the 2-member and the 3-member sets
            assert losses[3:] == [None] * 6
            np.testing.assert_allclose(losses[:3], want[:3], rtol=0,
                                       atol=TOL)
            continue
        if rank == 2:
            assert losses[3:6] == [None] * 3
            losses = losses[:3] + want[3:6] + losses[6:]
        np.testing.assert_allclose(losses, want, rtol=0, atol=TOL)
        assert got["steps"] == [6 if rank < 2 else 3, reborn.steps]
        assert reborn.steps == 9
    assert want[-1] < want[0]
