"""The system under test, set up as a node would run it: a live
``tpu-schd`` and pods, each a thread with its own CUDA stream, its own
weights, its own model server or training step, and its own
``SharedChipGate`` that does not fail open.

Each pod holds a token around each burst of device work (``begin``,
the burst, ``flush``, which drains the pod's stream), as
``kubeshare_tpu_torch/bench/headline.py::run_stream`` does, and records
host spans around its calls into the program (``spans``; marked for the
profiler in a traced run). The loops make no policy of their own:
- a serving pod offers every due request, oldest first, to
  ``DecodeServer.admit`` while a slot is free (a request that finds the
  pool full stays queued), then runs ``step_burst(quantum)``; a request
  is retired once it has its drawn number of tokens (its client stops
  reading: there is no EOS);
- a trainer pod calls its step back to back on fresh rows.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List

import torch

from .traffic import Request, requests, train_batches, horizon
from . import weights as W


def _program():
    """The program's modules, imported when a run starts. The model is
    the family's (``families/<family>.py``)."""
    from kubeshare_tpu_torch.models import serving, train
    from kubeshare_tpu_torch.nodeconfig import files
    from kubeshare_tpu_torch.runtime import client, hook, native
    return serving, train, files, client, hook, native


class Arbiter:
    """A live ``tpu-schd`` on a free port of localhost, over a config file
    with one ``ConfigEntry(pod, limit, request, 0)`` a pod, built with
    ``runtime/native.py::build_binary`` into the checkout's
    ``runtime_native/build/`` when missing."""

    def __init__(self, pods: List[str], traffic: Dict):
        import socket

        *_, files, client, _, native = _program()
        settings = traffic["arbiter"]
        binary = native.build_binary("tpu-schd")
        self._dir = tempfile.TemporaryDirectory(prefix="perfbench-")
        files.write_config_file(self._dir.name, "chip", [
            files.ConfigEntry(p, float(traffic["limit"]),
                              float(traffic["request"]), 0) for p in pods])
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.proc = subprocess.Popen(
            [binary, "-p", os.path.join(self._dir.name, "config"), "-f",
             "chip", "-P", str(self.port), "-q", str(settings["quota_ms"]),
             "-m", str(settings["min_quota_ms"]), "-w",
             str(settings["window_ms"]), "-c", str(settings["slots"]),
             "-H", "127.0.0.1"],
            stderr=subprocess.DEVNULL)
        for _ in range(200):
            try:
                client.TokenClient("127.0.0.1", self.port, pod="probe").close()
                return
            except OSError:
                if self.proc.poll() is not None:
                    break
                time.sleep(0.05)
        self.close()
        raise RuntimeError(f"tpu-schd did not answer on port {self.port}")

    def gate(self, pod: str):
        *_, client, hook, _ = _program()
        return hook.SharedChipGate(
            client.TokenClient("127.0.0.1", self.port, pod=pod),
            fail_open=False)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._dir.cleanup()


class Pause:
    """Parks the pods between two bursts, holding no token, while the
    profiler is switched on or off: CUPTI is not switched while a pod
    launches a CUDA graph (a traced run of the chat cell hung when it
    was). A pod whose loop has ended counts as parked."""

    def __init__(self, pods: int):
        self._cond = threading.Condition()
        self._paused = False
        self._waiting = 0
        self._live = pods

    def point(self) -> None:
        """A pod's loop calls this between bursts."""
        with self._cond:
            if not self._paused:
                return
            self._waiting += 1
            self._cond.notify_all()
            while self._paused:
                self._cond.wait()
            self._waiting -= 1

    def leave(self) -> None:
        """A pod's loop calls this once it has ended."""
        with self._cond:
            self._live -= 1
            self._cond.notify_all()

    @contextlib.contextmanager
    def parked(self, timeout: float = 30.0):
        with self._cond:
            self._paused = True
            if not self._cond.wait_for(
                    lambda: self._waiting >= self._live, timeout):
                self._paused = False
                self._cond.notify_all()
                raise RuntimeError("a pod did not park")
        try:
            yield
        finally:
            with self._cond:
                self._paused = False
                self._cond.notify_all()


class Pod:
    pause: Pause = None

    def __init__(self, index: int, name: str, gate, device, mark: bool):
        self.index = index
        self.name = name
        self.gate = gate
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.spans: Dict[str, List] = {}
        self._mark = mark

    def on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def span(self, name: str, t0: float, t1: float, *extra) -> None:
        self.spans.setdefault(name, []).append((t0, t1, *extra))

    def mark(self, name: str):
        if not self._mark:
            return contextlib.nullcontext()
        return torch.profiler.record_function("perfbench." + name)

    def begin(self) -> None:
        t0 = time.perf_counter()
        with self.mark("gate_wait"):
            self.gate.begin()
        self.span("gate_wait", t0, time.perf_counter())


class ServePod(Pod):
    kind = "serve"

    def __init__(self, index, name, gate, device, family, spec,
                 traffic: Dict, seed: int, seconds: float, mark: bool):
        super().__init__(index, name, gate, device, mark)
        serving = _program()[0]
        self.model = family.build(spec, seed, index, device,
                                  trainable=False)
        srv = traffic["server"]
        self.quantum = int(srv["quantum"])
        self.server = serving.DecodeServer(
            self.model, slots=srv["slots"],
            prompt_buckets=tuple(srv["prompt_buckets"]), temperature=0.0,
            max_new=0, seed=W.derive_seed(seed, index, "sampler"),
            cuda_graph=True)
        self.requests: List[Request] = requests(
            traffic, seed, index, horizon(traffic, seconds))
        self.finished: List[Request] = []

    def warm_up(self) -> None:
        """Every prompt bucket's prefill and the decode step's graph,
        captured on the pod's own stream; the pool is left empty."""
        with self.on_stream():
            for bucket in self.server.buckets:
                self.server.admit([2] * bucket)
            self.server.step_burst(self.quantum)
            for slot in range(self.server.slots):
                if self.server.active[slot]:
                    self.server.retire(slot)

    def loop(self, start: float, stop: float) -> None:
        """Serve the requests due from ``start`` until ``stop``."""
        server, queue, owner = self.server, deque(), {}
        for r in self.requests:
            r.due = start + r.due_s
        pending = deque(self.requests)
        with self.on_stream():
            while True:
                if self.pause is not None:
                    self.pause.point()
                now = time.perf_counter()
                if now >= stop:
                    break
                while pending and pending[0].due <= now:
                    queue.append(pending.popleft())
                if not queue and not owner:
                    wake = min(pending[0].due if pending else stop, stop)
                    time.sleep(min(0.05, max(0.0, wake - now)))
                    continue
                self.begin()
                while queue and server.can_admit():
                    req = queue.popleft()
                    t0 = time.perf_counter()
                    with self.mark("admit"):
                        slot, first = server.admit(req.prompt)
                    t1 = time.perf_counter()
                    self.span("admit", t0, t1, len(req.prompt))
                    req.deliveries.append((t1, 1))
                    req.tokens.append(first)
                    owner[slot] = req
                    self._finish_if_done(slot, req, t1, owner)
                if owner:
                    t0 = time.perf_counter()
                    with self.mark("decode"):
                        out = server.step_burst(self.quantum)
                    t1 = time.perf_counter()
                    ctx = []
                    for slot, toks in out.items():
                        req = owner[slot]
                        take = toks[:req.out_len - len(req.tokens)]
                        ctx.append((len(req.prompt) + len(req.tokens) - 1,
                                    len(take)))
                        req.tokens.extend(take)
                        req.deliveries.append((t1, len(take)))
                        self._finish_if_done(slot, req, t1, owner)
                    self.span("decode", t0, t1, self.quantum, ctx)
                self.gate.flush(server.cache["length"])

    def _finish_if_done(self, slot: int, req: Request, t: float,
                        owner: Dict) -> None:
        if len(req.tokens) >= req.out_len:
            if self.server.active[slot]:
                self.server.retire(slot)
            req.done = t
            self.finished.append(req)
            del owner[slot]

    def free(self) -> None:
        self.server = self.model = None


class TrainPod(Pod):
    kind = "train"

    def __init__(self, index, name, gate, device, family, spec,
                 traffic: Dict, seed: int, seconds: float, mark: bool):
        super().__init__(index, name, gate, device, mark)
        train = _program()[1]
        self.family = family
        self.model = family.build(spec, seed, index, device, trainable=True)
        self.optimizer, self.step = train.make_train_step(
            family.loss(), self.model, learning_rate=float(traffic["lr"]))
        self.batches = train_batches(traffic, seed, index, device)
        self.losses: List[float] = []

    def one_step(self) -> float:
        """One gated step on the next rows; returns its loss."""
        with self.on_stream():
            batch = next(self.batches)
            self.begin()
            t0 = time.perf_counter()
            with self.mark("train_step"):
                loss = self.step(batch)
                self.gate.flush(loss)
            t1 = time.perf_counter()
        self.span("train_step", t0, t1)
        value = loss.item()
        self.losses.append(value)
        return value

    def loop(self, start: float, stop: float) -> None:
        while time.perf_counter() < stop:
            if self.pause is not None:
                self.pause.point()
            self.one_step()

    def leaves(self) -> Dict[str, torch.Tensor]:
        """The trained leaves by the reference's names."""
        return self.family.program_leaves(self.model)

    def free(self) -> None:
        self.model = self.optimizer = self.step = self.batches = None


POD_KINDS = {"serve": ServePod, "train": TrainPod}
