"""The node side of a shared device, end to end on one CUDA card.

    python -m kubeshare_tpu_torch.bench.node [--seconds S] [--rounds N]
    python -m kubeshare_tpu_torch.bench.node pod [...]

The first form prints one JSON line: a deployed run on the card NVML
enumerates first, the interposer's cost, and a pod under both gates at
once (``run_both_gates``). The second is the pod program the deployed
run starts.

The deployed run is the node plane as a node runs it: requirement
samples -> ``NodeConfigDaemon.sync`` writes ``config/<uuid>`` and
``podmanagerport/<uuid>`` -> ``NodeLauncher`` starts one ``tpu-schd`` for
the card and one ``tpu-pmgr`` per pod -> each pod is a child process
under the CUDA driver-API interposer (``runtime/interposer.py::enable``).
The pod program is an unmodified PyTorch program: it imports the port's
models and never ``install_gate``; the interposer alone leases its
compute tokens and charges its allocations. It trains the workload
CLI's Llama (head dim 32, eager: the three flash kernels through
``cuLaunchKernel``), then replays the MNIST step's CUDA graph
(``cuGraphLaunch``), then, with ``--alloc-bytes``, allocates one tensor
that large and reports whether it got ``torch.cuda.OutOfMemoryError``,
and takes one more MNIST step either way. Its last stdout line is one
JSON object with its step times and the interposer's counters.

Two pods share the card: ``pod-a`` (limit 1.0, request 0.5, no memory
cap) and ``pod-b`` (the same, capped at ``POD_B_CAP``); both allocate
``ALLOC_BYTES``, which only ``pod-a`` may hold. The cost runs ``pod-a``
alone, in turns: without the interposer (``plain``), under it with no
manager port (``passthrough``: the hooks and the lookups only) and gated
through its ``tpu-pmgr`` (``interposer``: the lease and the charges too).
The interposer's counters say how long the gated pod waited for tokens
(``acquire_wait_ms``) and for its drains (``drain_wait_ms``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

GIB = 1 << 30
POD_B_CAP = 6 * GIB
ALLOC_BYTES = 7 * GIB
LLAMA_BATCH = 64
MNIST_BATCH = 1024
LAUNCH_BENCH = 20000
WINDOW_MS = 1000.0
SLOTS = 2
NODE = "node-0"
PODS = {"pod-a": 0, "pod-b": POD_B_CAP}      # name -> memory cap
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---- the pod program ---------------------------------------------------

def _timed(step, steps_min: int, seconds: float):
    """(steps, ms a step, last loss): ``step()`` run for at least
    ``seconds`` and ``steps_min`` steps after two warm-up steps; the
    card is synchronised before the clock starts and stops."""
    import torch

    for _ in range(2):
        loss = step()
    torch.cuda.synchronize()
    steps, t0 = 0, time.perf_counter()
    while steps < steps_min or time.perf_counter() - t0 < seconds:
        loss = step()
        steps += 1
    torch.cuda.synchronize()
    return steps, (time.perf_counter() - t0) * 1e3 / steps, float(loss)


def pod_main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="bench.node pod")
    parser.add_argument("--seconds", type=float, default=1.5,
                        help="at least this long on each workload")
    parser.add_argument("--alloc-bytes", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    from ..cmd.workload import _build
    from ..models.mnist import MnistConfig, init_mnist, make_mnist_train_step
    from ..models.train import make_train_step
    from ..ops.attention import LAUNCHES
    from ..runtime import interposer

    device = torch.device("cuda", 0)
    out: Dict[str, object] = {"pod": os.environ.get("KUBESHARE_POD_NAME", "")}

    # the workload CLI's Llama (dim 256, 8 heads: head dim 32), eager
    model, loss_fn, batch_at = _build("llama", LLAMA_BATCH, device, args.seed)
    _, llama_step = make_train_step(loss_fn, model, learning_rate=1e-3)
    tokens = batch_at(0)
    steps, ms, loss = _timed(lambda: llama_step(*tokens), 3, args.seconds)
    out["llama"] = {"steps": steps, "step_ms": ms, "loss": loss,
                    "batch": LLAMA_BATCH, "flash_launches": dict(LAUNCHES)}

    # the MNIST step as a CUDA graph, replayed
    gen = torch.Generator(device=device).manual_seed(args.seed)
    mnist = init_mnist(MnistConfig(), generator=gen, device=device)
    mnist_step = make_mnist_train_step(mnist)
    images = torch.randn(MNIST_BATCH, 1, 28, 28, generator=gen, device=device)
    labels = torch.randint(0, 10, (MNIST_BATCH,), generator=gen,
                           device=device)
    steps, ms, loss = _timed(lambda: mnist_step(images, labels), 20,
                             args.seconds)
    out["mnist"] = {"steps": steps, "step_ms": ms, "loss": loss,
                    "batch": MNIST_BATCH}

    # host time a launch: one-element adds back to back, the card keeping
    # up (what the interposer adds to each launch shows here whole)
    x = torch.zeros(1, device=device)
    for _ in range(1000):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LAUNCH_BENCH):
        x.add_(1)
    torch.cuda.synchronize()
    out["launch_us"] = (time.perf_counter() - t0) * 1e6 / LAUNCH_BENCH

    if args.alloc_bytes:
        outcome = "ok"
        try:
            block = torch.empty(args.alloc_bytes, dtype=torch.uint8,
                                device=device)
            block.fill_(1)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            outcome = "oom: " + str(e).splitlines()[0]
        # carry on: one more step after the allocation, whatever it gave
        after = float(mnist_step(images, labels))
        torch.cuda.synchronize()
        out["alloc"] = {"bytes": args.alloc_bytes, "outcome": outcome,
                        "step_after": after}
    out["interposer"] = interposer.stats()
    print(json.dumps(out), flush=True)
    return 0


# ---- the node --------------------------------------------------------------

def requirement_samples(uuid: str, ports: Dict[str, int]):
    """The aggregator's ``tpu_requirement`` samples for the two pods
    placed on card ``uuid`` (labels as
    ``kubeshare_tpu/metrics/aggregator.py`` writes them)."""
    from ..metrics.scrape import REQUIREMENT_METRIC
    from ..utils import expfmt

    return [expfmt.Sample(REQUIREMENT_METRIC, {
        "namespace": "smoke", "pod": pod, "node": NODE, "limit": "1.0",
        "request": "0.5", "memory": str(cap), "uuid": uuid,
        "port": str(ports[pod])}, 1.0) for pod, cap in PODS.items()]


def _wait_port(port: int, timeout: float = 10.0) -> None:
    from ..runtime.client import TokenClient

    deadline = time.time() + timeout
    while True:
        try:
            TokenClient("127.0.0.1", port, pod="probe").close()
            return
        except OSError:
            if time.time() > deadline:
                raise RuntimeError(f"nothing answers on port {port}")
            time.sleep(0.05)


def _run_pod(env: Dict[str, str], args: List[str], timeout: float) -> Dict:
    """Run the pod program to its end; its last stdout line."""
    proc = subprocess.run(
        [sys.executable, "-m", "kubeshare_tpu_torch.bench.node", "pod",
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"pod exited with {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    doc["stderr_interposer"] = [line for line in proc.stderr.splitlines()
                                if line.startswith("[cuda-interposer]")]
    return doc


COST_MODES = ("plain", "passthrough", "interposer")


def _pod_env(port: int, pod: str, mode: str = "interposer"
             ) -> Dict[str, str]:
    """A pod's env: ``mode`` is one of ``COST_MODES``."""
    from ..constants import ENV_POD_MANAGER_PORT, ENV_POD_NAME
    from ..runtime import interposer

    env = {k: v for k, v in os.environ.items()
           if k not in (ENV_POD_MANAGER_PORT, "LD_PRELOAD")}
    env[ENV_POD_NAME] = pod
    if mode == "plain":
        return env
    if mode == "interposer":
        env[ENV_POD_MANAGER_PORT] = str(port)
    env = interposer.enable(env)
    if not interposer.enabled(env):
        raise RuntimeError("the interposer or the real libcuda.so.1 is "
                           "missing: no pod can run under the interposer")
    return env


def run_node(uuid: str, seconds: float = 1.5, cost_rounds: int = 1,
             window_ms: float = WINDOW_MS,
             cost_modes: Sequence[str] = COST_MODES,
             timeout: float = 300.0) -> Dict:
    """The deployed run on card ``uuid`` and the cost runs (each round
    runs ``cost_modes``, every other round in reverse); returns what
    they observed (the caller checks it)."""
    from ..bench.arbiter import free_port
    from ..nodeconfig.daemon import NodeConfigDaemon
    from ..ops import _build as kernels
    from ..runtime.client import TokenClient
    from ..runtime.launcher import NodeLauncher
    from ..runtime.native import build_interposer
    from ..utils import expfmt

    # built here, so no pod compiles inside its first lease
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda build: build(), (
            build_interposer, lambda: kernels.build("flash_fwd"),
            lambda: kernels.build("flash_bwd"))))
    ports = {pod: free_port() for pod in PODS}
    result: Dict[str, object] = {"uuid": uuid, "window_ms": window_ms,
                                 "slots": SLOTS}
    with tempfile.TemporaryDirectory() as base:
        daemon = NodeConfigDaemon(NODE, base,
                                  lambda: requirement_samples(uuid, ports))
        result["synced"] = daemon.sync()
        launcher = NodeLauncher(base, [uuid], base_port=free_port(),
                                window_ms=window_ms, lease_slots=SLOTS)
        server = None
        try:
            launcher.start_arbiters()
            arbiter_port = launcher.chips[uuid].port
            _wait_port(arbiter_port)
            launcher.reconcile()
            for port in ports.values():
                _wait_port(port)
            server = launcher.serve_metrics(host="127.0.0.1")
            metrics_url = f"http://127.0.0.1:{server.port}/metrics"

            # two pods at once; the arbiter's state polled meanwhile
            peak: Dict[str, Dict[str, float]] = {
                f"smoke/{pod}": {"window_usage_ms": 0.0, "mem_used": 0,
                                 "mem_cap": 0} for pod in PODS}
            seen_metrics: Dict[str, float] = {}
            done = threading.Event()

            def poll() -> None:
                with TokenClient("127.0.0.1", arbiter_port,
                                 pod="node-bench") as client:
                    while not done.wait(0.1):
                        for stat in client.stats():
                            row = peak.setdefault(stat.pod, {})
                            row["window_usage_ms"] = max(
                                row.get("window_usage_ms", 0.0),
                                stat.window_usage_ms)
                            row["mem_used"] = max(row.get("mem_used", 0),
                                                  stat.mem_used)
                            row["mem_cap"] = stat.mem_cap
                        text = urllib.request.urlopen(
                            metrics_url, timeout=5).read().decode()
                        for s in expfmt.parse(text):
                            key = s.name + (f"/{s.labels['pod']}"
                                            if "pod" in s.labels else "")
                            seen_metrics[key] = max(
                                seen_metrics.get(key, 0.0), s.value)

            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(PODS) + 1) as pool:
                poller = pool.submit(poll)
                futures = {pod: pool.submit(
                    _run_pod, _pod_env(port, f"smoke/{pod}"),
                    ["--seconds", str(seconds), "--alloc-bytes",
                     str(ALLOC_BYTES)], timeout)
                    for pod, port in ports.items()}
                try:
                    pods = {pod: f.result() for pod, f in futures.items()}
                finally:
                    done.set()
                poller.result()
            result["colocated_s"] = time.perf_counter() - t0
            result["pods"] = pods
            result["arbiter_peak"] = peak
            result["metrics_peak"] = seen_metrics

            # the cost: pod-a alone, in turns
            runs: Dict[str, List[Dict]] = {mode: [] for mode in cost_modes}
            for r in range(cost_rounds):
                for mode in cost_modes[::1 if r % 2 == 0 else -1]:
                    doc = _run_pod(_pod_env(ports["pod-a"], "smoke/pod-a",
                                            mode),
                                   ["--seconds", str(seconds)], timeout)
                    runs[mode].append({
                        "llama_step_ms": doc["llama"]["step_ms"],
                        "mnist_graph_step_ms": doc["mnist"]["step_ms"],
                        "launch_us": doc["launch_us"],
                        "interposer": doc["interposer"]})
            result["cost"] = runs
        finally:
            if server is not None:
                server.stop()
            launcher.shutdown()
    return result


def run_both_gates(slots: int, steps: int = 50,
                   timeout: float = 60.0) -> Dict:
    """Both gates in one pod: the workload CLI, which installs the
    Python gate (``runtime/hook.py::install_gate``), run under the
    interposer too, both reading the pod's ``KUBESHARE_POD_MANAGER_PORT``
    and each holding its own connection to the pod's ``tpu-pmgr``, with
    ``slots`` concurrent leases on the arbiter. Reports whether the run
    ended within ``timeout`` seconds, the CLI's own document, and the
    pod's window usage at the arbiter. The reference does not
    coordinate the two gates, and neither does the port."""
    from ..bench.arbiter import (
        free_port, start_arbiter, start_pod_manager, stop_arbiter,
    )
    from ..nodeconfig.files import ConfigEntry
    from ..runtime.client import TokenClient

    pod = "smoke/both-gates"
    arbiter_port, pod_port = free_port(), free_port()
    with tempfile.TemporaryDirectory() as base:
        procs = [start_arbiter(base, "card", [ConfigEntry(pod, 1.0, 0.5, 0)],
                               arbiter_port, base_quota_ms=300,
                               min_quota_ms=20, window_ms=WINDOW_MS,
                               slots=slots)]
        try:
            procs.append(start_pod_manager(pod, pod_port, arbiter_port))
            out: Dict[str, object] = {"slots": slots, "steps": steps}
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [sys.executable, "-m", "kubeshare_tpu_torch.cmd.workload",
                     "--model", "mnist", "--steps", str(steps)],
                    cwd=REPO, env=_pod_env(pod_port, pod),
                    capture_output=True, text=True, timeout=timeout)
                out["outcome"] = f"exit {proc.returncode}"
                lines = proc.stdout.strip().splitlines()
                out["cli"] = json.loads(lines[-1]) if lines else None
            except subprocess.TimeoutExpired:
                out["outcome"] = f"no end within {timeout} s"
            out["seconds"] = time.perf_counter() - t0
            with TokenClient("127.0.0.1", arbiter_port) as client:
                out["window_usage_ms"] = {
                    s.pod: s.window_usage_ms for s in client.stats()}[pod]
        finally:
            for proc in procs:
                stop_arbiter(proc)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["pod"]:
        return pod_main(argv[1:])
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seconds", type=float, default=1.5)
    parser.add_argument("--rounds", type=int, default=2,
                        help="cost rounds, every other one in reverse "
                             "order of COST_MODES")
    parser.add_argument("--window-ms", type=float, default=WINDOW_MS,
                        help="the arbiter's usage window")
    args = parser.parse_args(argv)

    import torch

    from ..metrics.collector import NvmlChipBackend

    if not torch.cuda.is_available():
        raise SystemExit("bench.node needs a CUDA device")
    backend = NvmlChipBackend()
    chips = backend.enumerate()
    backend.close()
    if not chips:
        raise SystemExit("NVML enumerates no device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    doc = run_node(chips[0].uuid, args.seconds, args.rounds, args.window_ms)
    doc["card"] = card
    doc["both_gates"] = [run_both_gates(slots) for slots in (2, 1)]
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
