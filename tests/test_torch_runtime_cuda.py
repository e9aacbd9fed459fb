"""The gate's drain, the CUDA graphs (the MNIST step, the graphed Adam
step, DecodeServer's decode step) and the Prefetcher's staging on the
card.

These tests need an NVIDIA GPU and skip without one. The file imports
neither jax nor the JAX package, so on a GPU machine it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_runtime_cuda.py

Tolerances: the graph step against the eager step, each parameter after
four SGD steps (three Adam steps), 1e-2 of its max abs update (the same
kernels, but cuDNN and cuBLAS may pick other algorithms inside a
capture; bf16 products then round differently by an ulp, 2^-8
relative). The decode servers run a float32 Llama, whose greedy tokens
must agree exactly. Staged batches bit for bit.
"""

import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest
import torch

from kubeshare_tpu_torch.models import llama as tllama
from kubeshare_tpu_torch.models.data import Prefetcher
from kubeshare_tpu_torch.models.mnist import (
    MnistConfig, init_mnist, make_mnist_train_step,
)
from kubeshare_tpu_torch.models.serving import DecodeServer
from kubeshare_tpu_torch.models.train import make_train_step
from kubeshare_tpu_torch.runtime.hook import SharedChipGate, _block

pytestmark = pytest.mark.cuda

# ~50 ms of GPU clock cycles at the H100's 1.98 GHz boost, longer at a
# lower clock
SLEEP_CYCLES = 100_000_000
# a small float32 Llama (head dim 32) for the decode servers and Adam
LLAMA = tllama.LlamaConfig(vocab=256, dim=64, layers=2, num_heads=2,
                           num_kv_heads=1, mlp_dim=128, max_seq_len=128,
                           dtype="float32")


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


def _prompts(n):
    rng = torch.Generator().manual_seed(11)
    return [torch.randint(1, LLAMA.vocab, (int(k),), generator=rng).tolist()
            for k in torch.randint(3, 16, (n,), generator=rng)]


def _serve_script(server, prompts):
    """Staggered admissions (one every 6 steps while a slot is free), a
    retirement at step 20 and auto-retirement at ``max_new``: every
    call's result, over 64 steps."""
    log = []
    for i in range(64):
        if i % 6 == 0 and server.can_admit():
            log.append(server.admit(prompts[i // 6]))
        if i == 20:
            server.retire(1)
            log.append("retired 1")
        log.append(server.step())
    return log


def test_graphed_decode_server_matches_eager(cuda):
    model = tllama.init_llama(LLAMA, device=cuda)
    prompts = _prompts(11)
    logs = []
    for graph in (True, False):
        server = DecodeServer(model, slots=4, prompt_buckets=(8, 16),
                              max_new=20, cuda_graph=graph)
        length = server.cache["length"]
        logs.append(_serve_script(server, prompts))
        assert (server.decode_step.graph is not None) == graph
        assert server.cache["length"] is length
    assert logs[0] == logs[1]
    assert sum(isinstance(x, dict) and len(x) > 0 for x in logs[0]) == 64


def test_graphed_burst_matches_single_steps(cuda):
    model = tllama.init_llama(LLAMA, device=cuda)
    prompts = _prompts(3)
    servers = [DecodeServer(model, slots=4, prompt_buckets=(8, 16))
               for _ in range(2)]
    for server in servers:
        for p in prompts:
            server.admit(p)
        server.step()                      # captures
    burst = servers[0].step_burst(16)
    singles = {}
    for _ in range(16):
        for slot, tok in servers[1].step().items():
            singles.setdefault(slot, []).append(tok)
    assert burst == singles and sorted(burst) == [0, 1, 2]


def test_graphed_sampling_is_seeded_and_stays_in_top_k(cuda):
    model = tllama.init_llama(LLAMA, device=cuda)
    prompts = _prompts(4)
    runs = []
    for _ in range(2):
        server = DecodeServer(model, slots=4, prompt_buckets=(8, 16),
                              temperature=0.9, top_k=5, seed=3)
        stream = [server.admit(p) for p in prompts]
        for _ in range(24):
            out = server.step()
            top = torch.topk(server.logits, 5, dim=-1).indices.tolist()
            assert all(tok in top[slot] for slot, tok in out.items())
            stream.append(out)
        stream.append(server.step_burst(8))
        runs.append(stream)
    assert runs[0] == runs[1]
    drawn = {t for out in runs[0][4:-1] for t in out.values()}
    assert len(drawn) > 5                 # it samples, it is not argmax


def test_graphed_adam_step_matches_eager(cuda):
    tokens = torch.randint(0, LLAMA.vocab, (4, 33),
                           generator=torch.Generator().manual_seed(2)).to(cuda)
    start = tllama.init_llama(LLAMA, device=cuda, trainable=True)
    models, losses = [], []
    for graph in (False, True):
        model = tllama.init_llama(LLAMA, device=cuda, trainable=True)
        opt, step = make_train_step(
            lambda m, t: tllama.llama_loss(m, t, use_flash=False), model,
            1e-3, cuda_graph=graph)
        losses.append([step(tokens).item() for _ in range(3)])
        models.append(model)
        assert hasattr(step, "inputs") == graph
        assert opt.defaults["capturable"] == graph
    for (name, e), g, s in zip(models[0].named_parameters(),
                               models[1].parameters(), start.parameters()):
        update = (e - s).abs().max()
        assert (e - g).abs().max() <= 1e-2 * update, name
    assert losses[1][-1] < losses[1][0], losses
    assert abs(losses[0][0] - losses[1][0]) <= 1e-5 * losses[0][0]


def _concurrent_bursts(decodes, streams, bursts=20, steps=16):
    """Each decode in a thread of its own, on its stream: ``bursts``
    times a restart and ``steps`` steps. Returns each decode's tokens
    after every burst (None for a thread that did not finish within a
    minute)."""
    out = [None] * len(decodes)

    def run(i):
        got = []
        with torch.cuda.stream(streams[i]):
            for _ in range(bursts):
                decodes[i].restart()
                for _ in range(steps):
                    decodes[i].step()
                got.append(decodes[i].tokens.tolist())
        out[i] = got

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(decodes))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    return out


def _int8_pods(device):
    """The int8 serving bench's four pods' decodes (float32 products,
    which cuBLAS may split along K through its workspace)."""
    from kubeshare_tpu_torch.bench.serving import CFG, PodDecode
    from kubeshare_tpu_torch.models.quant import quantize_llama

    return [PodDecode(quantize_llama(tllama.init_llama(
        CFG, generator=torch.Generator(device=device).manual_seed(7 + i),
        device=device))) for i in range(4)]


def _alone_and_together(decodes):
    """Each decode's tokens over one burst alone, then all four's over
    20 bursts at once, each pod on a stream of its own."""
    streams = [torch.cuda.Stream() for _ in decodes]
    alone = [_concurrent_bursts([d], [s], bursts=1)[0][0]
             for d, s in zip(decodes, streams)]
    return alone, _concurrent_bursts(decodes, streams), streams


def test_graphs_replay_at_once_on_their_own_streams(cuda):
    """Four pods' int8 decode graphs replayed at the same time on four
    streams give each pod's tokens as it gives them alone: each graph
    was captured on its pod's stream, and replays there, so none shares
    another's cuBLAS workspace."""
    decodes = _int8_pods(cuda)
    alone, together, streams = _alone_and_together(decodes)
    assert [d._decode_step.stream for d in decodes] == streams
    assert all(got is not None for got in together), "a pod hung"
    for want, got in zip(alone, together):
        assert got == [want] * 20


def one_capture_stream_agrees() -> bool:
    """The capture this port first had: the four int8 pods' graphs all
    captured on ``torch.cuda.graph``'s one default capture stream, each
    replayed on its pod's own. True when, replayed at once, they give
    each pod's tokens alone."""
    from kubeshare_tpu_torch.models.graph import restoring

    decodes = _int8_pods(torch.device("cuda", 0))
    for d in decodes:
        warmup = restoring(d.decode, [d.cache["length"], d.tokens])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warmup()
            warmup()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            d.decode()
        d.step = graph.replay
    alone, together, _ = _alone_and_together(decodes)
    return all(got == [want] * 20 for want, got in zip(alone, together))


def test_one_capture_stream_is_safe_without_cublas_workspace(cuda):
    """Why a graph replays on its capture stream. Captured all on one
    stream and replayed at once on four, the four pods' graphs hang the
    card (the default workspace); in a process whose cuBLAS has no
    workspace (``CUBLAS_WORKSPACE_CONFIG=:0:0``, cuBLASLt's size 0) the
    same capture replays at once and agrees with each pod alone: the
    graphs shared nothing else."""
    root = pathlib.Path(__file__).resolve().parents[1]
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import test_torch_runtime_cuda as t; "
            "sys.exit(0 if t.one_capture_stream_agrees() else 1)")
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":0:0",
           "CUBLASLT_WORKSPACE_SIZE": "0"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
