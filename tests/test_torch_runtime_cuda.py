"""The gate's drain, the MNIST step's CUDA graph and the Prefetcher's
staging on the card.

These tests need an NVIDIA GPU and skip without one. The file imports
neither jax nor the JAX package, so on a GPU machine it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_runtime_cuda.py

Tolerances: the graph step against the eager step, each parameter after
four SGD steps, 1e-2 of its max abs update (the same kernels, but
cuDNN may pick other algorithms inside a capture; bf16 products then
round differently by an ulp, 2^-8 relative). Staged batches bit for bit.
"""

import threading
import time

import pytest
import torch

from kubeshare_tpu_torch.models.data import Prefetcher
from kubeshare_tpu_torch.models.mnist import (
    MnistConfig, init_mnist, make_mnist_train_step,
)
from kubeshare_tpu_torch.runtime.hook import SharedChipGate, _block

pytestmark = pytest.mark.cuda

# ~50 ms of GPU clock cycles at the H100's 1.98 GHz boost, longer at a
# lower clock
SLEEP_CYCLES = 100_000_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


class _Client:
    def acquire(self, est_ms=0.0):
        return 1e9

    def release(self, used_ms):
        pass


def test_drain_does_not_wait_for_another_streams_work(cuda):
    """Two pods on two streams: one queues ~50 ms of sleep; the other's
    drain under its gate returns in well under that, while the sleep
    still runs."""
    busy, mine = torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)
    x = torch.ones(1024, device=cuda)
    # load every kernel the pod runs first: loading a kernel's module
    # (CUDA's lazy loading) waits for the whole device
    with torch.cuda.stream(mine):
        _block(bool((x * 2 == 2).all()))
        torch.cuda.Event().record()
    torch.cuda.synchronize(cuda)
    queued = threading.Event()
    drained = {}

    def sleeper():
        with torch.cuda.stream(busy):
            torch.cuda._sleep(SLEEP_CYCLES)
        queued.set()

    def pod():
        queued.wait(5)
        gate = SharedChipGate(_Client(), fail_open=False)
        with torch.cuda.stream(mine):
            gate.begin()
            y = x * 2
            t0 = time.perf_counter()
            gate.flush(y)
            drained["ms"] = 1e3 * (time.perf_counter() - t0)
            sleeping = torch.cuda.Event()
            sleeping.record(busy)
            drained["other_busy"] = not sleeping.query()
            drained["ok"] = bool((y == 2).all())

    threads = [threading.Thread(target=sleeper), threading.Thread(target=pod)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    torch.cuda.synchronize(cuda)
    assert drained["ok"] and drained["other_busy"], drained
    assert drained["ms"] < 10.0, drained


def test_block_waits_for_its_own_stream(cuda):
    s = torch.cuda.Stream(cuda)
    with torch.cuda.stream(s):
        torch.cuda._sleep(SLEEP_CYCLES // 10)
        y = torch.ones(4, device=cuda)
        _block(y)
        done = torch.cuda.Event()
        done.record()
    assert done.query()


def test_mnist_graph_step_matches_eager(cuda):
    cfg = MnistConfig(hidden=64)
    gen = torch.Generator().manual_seed(3)
    images = torch.randn(32, 1, 28, 28, generator=gen).to(cuda)
    labels = torch.randint(0, 10, (32,), generator=gen).to(cuda)
    start = init_mnist(cfg, device="cpu").to(cuda)
    models, losses = [], []
    for graph in (False, True):
        model = init_mnist(cfg, device="cpu").to(cuda)
        step = make_mnist_train_step(model, lr=1e-3, cuda_graph=graph)
        losses.append([step(images, labels).item() for _ in range(4)])
        models.append(model)
        assert hasattr(step, "inputs") == graph
    for (name, e), g, s in zip(models[0].named_parameters(),
                               models[1].parameters(), start.parameters()):
        update = (e - s).abs().max()
        assert (e - g).abs().max() <= 1e-2 * update, name
    assert losses[1][-1] < losses[1][0], losses


def test_prefetcher_stages_host_batches_on_the_card(cuda):
    batches = [(torch.full((256, 8), float(i)), torch.arange(4) + i)
               for i in range(5)]
    got = list(Prefetcher(iter(batches), size=2, device=cuda))
    assert len(got) == 5
    for i, (x, y) in enumerate(got):
        assert x.device == cuda and y.device == cuda
        assert torch.equal(x.cpu(), batches[i][0])
        assert torch.equal(y.cpu(), batches[i][1])
