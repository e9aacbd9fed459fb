"""kubeshare_tpu_torch/parallel/comm.py on CUDA tensors of two ranks that
share one card: the backend rule picks gloo, every collective stages
through pinned host buffers and comes back on the card, with the values
and gradients a hand-rolled expectation gives (exact: small integers
moved and added in float32).

This test needs an NVIDIA GPU and skips without one. The file imports
neither jax nor the JAX package, so on a GPU machine it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_comm_cuda.py
"""

import numpy as np
import pytest
import torch

from kubeshare_tpu_torch.parallel.launch import run_world

import test_torch_parallel_ranks as ranks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_collectives_of_ranks_sharing_one_card(cuda):
    x = np.random.default_rng(0).integers(-8, 8, size=(2, 4, 8)).astype(
        np.float32)
    world = run_world(ranks.comm_on_card, 2, args=(x,), timeout=120,
                      device_type="cuda")
    shared = torch.cuda.device_count() < 2
    for r, doc in enumerate(world):
        if shared:
            assert doc["backend"] == "gloo"
            assert doc["device"] == "cuda:0"
            assert doc["stats"]["staged_bytes"] > 0
        y, grad, where = doc["ppermute"]
        np.testing.assert_array_equal(y, x[1 - r])
        np.testing.assert_array_equal(grad, np.ones_like(x[r]))
        assert where == "cuda"
        y, grad, where = doc["all_to_all"]
        np.testing.assert_array_equal(
            y, np.concatenate([x[i][2 * r:2 * r + 2] for i in range(2)],
                              axis=1))
        np.testing.assert_array_equal(grad, np.ones_like(x[r]))
        y, grad, where = doc["all_reduce"]
        np.testing.assert_array_equal(y, x.sum(axis=0))
        np.testing.assert_array_equal(grad, 2 * np.ones_like(x[r]))
        y, grad, where = doc["all_gather"]
        np.testing.assert_array_equal(y, x)
        np.testing.assert_array_equal(grad, 2 * np.ones_like(x[r]))
        np.testing.assert_array_equal(doc["broadcast"], x[1])
        assert doc["stats"]["calls"] > 0 and doc["stats"]["bytes"] > 0
