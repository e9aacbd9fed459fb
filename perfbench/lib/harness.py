"""One run of one cell: set-up, the measured window, the metrics, the
check.

Set-up (``setup_s``, from the process's start): the arbiter, each pod's
weights drawn on the device, then the cell's own shapes warmed on each
pod's stream: a serving pod's prompt buckets and its decode graph; a
trainer's first ``CHECK_STEPS`` steps, which are also what the check
compares, every pod at once in threads of its own as in the window.
Then every pod starts at once. A serving cell's requests are
due from that start. The window opens ``preroll_s`` later, once the pods
have reached steady occupancy and the arbiter's sliding window holds no
token hold of set-up, and lasts ``--seconds``. With ``--trace
1`` the profiler records a slice of ``trace_s`` seconds in the middle of
the window. The pods stop at the window's end; what they produced is
then checked against the reference, after the peak memory is read and
the program's state is freed.
"""

from __future__ import annotations

import gc
import math
import threading
import time
from dataclasses import dataclass
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import check, trace as T
from .catalog import Catalog
from .pods import POD_KINDS, Arbiter, Pause
from ..reference.common import exact_float32


@dataclass
class Run:
    """What a metric's reader reads. Times are ``time.perf_counter()``
    seconds; ``window`` is the measured window (w0, w1). ``family`` is
    the configuration's model family (``families/<family>.py``) and
    ``spec`` the model as it describes it."""
    workload: str
    kind: str
    family: ModuleType
    spec: Any
    traffic: Dict
    seconds: float
    setup_s: float
    window: Tuple[float, float]
    pods: List
    trace: Optional[T.Trace]


def _threads(workers) -> Tuple[List[threading.Thread],
                                List[BaseException]]:
    errors: List[BaseException] = []

    def guard(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 (re-raised by caller)
                errors.append(e)
        return run

    threads = [threading.Thread(target=guard(w)) for w in workers]
    for t in threads:
        t.start()
    return threads, errors


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_setup(pods, family, spec, seed: int) -> Dict[int, Dict]:
    """The first ``CHECK_STEPS`` steps of every pod through its own gated
    step, all pods at once, each in a thread of its own as the window
    drives them; the program's readings for the check, by pod."""
    readings = {}

    def first_steps(pod):
        losses = [pod.one_step()]
        first_grad = check.program_first_grads(pod)
        for _ in range(check.CHECK_STEPS - 1):
            losses.append(pod.one_step())
        readings[pod.index] = {
            "losses": losses, "first_grad": first_grad,
            "change": check.change_norms(family, spec, seed, pod.index,
                                         pod.leaves())}

    threads, errors = _threads([(lambda p=p: first_steps(p)) for p in pods])
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return readings


def _profiler(device):
    """A profiler of the device and of every thread's host ops: the pods'
    threads started before it, and by default it records the host ops of
    the thread that starts it only."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=activities, experimental_config=config)


def warm_profiler(device) -> None:
    """Start and stop the profiler once in set-up: its first start loads
    and initialises CUPTI (~7.5 s on an H100), and CUDA calls of the
    running pods wait meanwhile."""
    prof = _profiler(device)
    prof.start()
    _sync(device)
    prof.stop()


def profile_slice(device, start: float, seconds: float, pause: Pause):
    """Sleep until ``start``, then profile ``seconds`` of the running
    pods, switching the profiler on and off while they are parked;
    returns (profiler, perf_counter at the slice's start)."""
    from torch.profiler import record_function

    time.sleep(max(0.0, start - time.perf_counter()))
    prof = _profiler(device)
    with pause.parked():
        _sync(device)
        prof.start()
    with record_function(T.WINDOW_MARK):
        perf0 = time.perf_counter()
        time.sleep(seconds)
    with pause.parked():
        _sync(device)
        prof.stop()
    return prof, perf0


@dataclass
class Session:
    """A run's measured part, before its check."""
    run: Run
    limits: Dict[str, float]
    readings: Dict[int, Dict]     # a trainer's set-up readings, by pod
    chosen: List                  # served requests drawn for the check
    metrics: Dict
    attempted: int
    failed: int
    peak: int
    arbiter: Arbiter

    def close(self) -> None:
        for pod in self.run.pods:
            pod.gate.close()
        self.arbiter.close()


def measure(catalog: Catalog, workload: str, seed: int, seconds: float,
            trace: bool, device: torch.device, started: float,
            log=print) -> Session:
    """Set-up, the window and the metrics; the program's state is freed
    at the end. The caller closes the session."""
    cell = catalog.cell(workload)
    family = catalog.family(cell["config"])
    spec = catalog.spec(cell["config"])
    traffic = catalog.traffic(cell["traffic"])
    limits = catalog.limits(workload)
    kind = traffic["kind"]
    names = [f"{workload}/pod-{i}" for i in range(int(traffic["pods"]))]
    arbiter = Arbiter(names, traffic)
    pods = []
    try:
        for i, name in enumerate(names):
            pods.append(POD_KINDS[kind](i, name, arbiter.gate(name), device,
                                        family, spec, traffic, seed, seconds,
                                        trace))
        if kind == "serve" and (traffic["prompt_tokens"]["max"]
                                > pods[0].server.buckets[-1]):
            raise ValueError("prompts longer than the largest bucket the "
                             "server takes")
        readings = {}
        if kind == "serve":
            for pod in pods:
                pod.warm_up()
        else:
            readings = train_setup(pods, family, spec, seed)
        if trace:
            warm_profiler(device)
        _sync(device)
        setup_s = time.perf_counter() - started
        log(f"set-up {setup_s:.1f} s")

        pause = Pause(len(pods))
        for pod in pods:
            pod.pause = pause
        start = time.perf_counter() + 0.01
        w0 = start + float(traffic.get("preroll_s", 0.0))
        w1 = w0 + seconds
        def serve(pod):
            try:
                pod.loop(start, w1)
            finally:
                pause.leave()

        threads, errors = _threads([(lambda p=p: serve(p)) for p in pods])
        prof = perf0 = None
        try:
            if trace:
                trace_s = min(float(traffic.get("trace_s", 3.0)), seconds)
                prof, perf0 = profile_slice(
                    device, w0 + 0.5 * (seconds - trace_s), trace_s, pause)
        finally:
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        _sync(device)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        run = Run(workload, kind, family, spec, traffic, seconds, setup_s,
                  (w0, w1), pods,
                  T.read(prof, perf0) if prof is not None else None)
        metrics = {}
        for m in catalog.metrics(workload, trace):
            value = catalog.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        attempted, failed = _counts(run)
        chosen = []
        if kind == "serve":
            cfg = traffic["check"]
            chosen = check.sample(pods, seed, int(cfg["min_tokens"]),
                                  int(cfg["max_requests"]))
        for pod in pods:
            pod.free()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    except BaseException:
        for pod in pods:
            pod.gate.close()
        arbiter.close()
        raise
    return Session(run, limits, readings, chosen, metrics, attempted, failed,
                   peak, arbiter)


def compare(session: Session, seed: int, device) -> Dict:
    """The compared numbers of a session (``check``), from the reference
    run now that the program's state is freed."""
    run = session.run
    exact_float32()
    if run.kind == "serve":
        if not session.chosen:
            return {}
        return check.serve_numbers(run.family, run.spec, seed, session.chosen,
                                   device)
    per_pod = [check.train_numbers(
        session.readings[pod.index], check.reference_training(
            run.family, run.spec, run.traffic, seed, pod.index, device))
        for pod in run.pods]
    numbers = {k: max(n[k] for n in per_pod) for k in session.limits}
    numbers["_pods"] = per_pod
    return numbers


def run_cell(catalog: Catalog, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, started: float,
             log=print) -> Tuple[Dict, List[str]]:
    """One run; returns the result's fields and the lines that give each
    compared number beside its limit."""
    session = measure(catalog, workload, seed, seconds, trace, device,
                      started, log)
    try:
        t_check = time.perf_counter()
        numbers = compare(session, seed, device)
        log(f"check {time.perf_counter() - t_check:.1f} s: {numbers}")
    finally:
        session.close()
    run, limits = session.run, session.limits
    correct = check.verdict(numbers, limits) and session.attempted > 0
    result = {
        "correct": correct, "attempted": session.attempted,
        "failed": session.failed, "metrics": session.metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": session.peak},
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["info"] = _info(run, numbers)
    result["checks"] = {name: {"value": numbers.get(name, math.nan),
                               "limit": limit}
                        for name, limit in limits.items()}
    lines = [f"check {name}: {numbers.get(name, math.nan)!r} limit {limit!r}"
             for name, limit in limits.items()]
    return result, lines


def _counts(run: Run) -> Tuple[int, int]:
    """Serving: the requests due in the window (a request that errs
    ends the run, so none fails). Training: the steps that ended in
    the window, and those of them whose loss is not finite."""
    w0, w1 = run.window
    if run.kind == "serve":
        return sum(1 for p in run.pods for r in p.requests
                   if w0 <= r.due < w1), 0
    ended = [(t1, loss) for p in run.pods
             for (t0, t1), loss in zip(p.spans.get("train_step", []),
                                       p.losses) if w0 <= t1 < w1]
    return len(ended), sum(1 for _, loss in ended if not math.isfinite(loss))


def _info(run: Run, numbers: Dict) -> Dict:
    """Context for a reader of the log; the driver ignores it."""
    w0, w1 = run.window
    out = {"setup_s": run.setup_s,
           "check": {k: v for k, v in numbers.items()}}
    if torch.cuda.is_available():
        stats = torch.cuda.memory_stats()
        out["allocator"] = {k: stats.get(k) for k in (
            "num_alloc_retries", "reserved_bytes.all.peak")}

    if run.kind == "serve":
        reqs = [r for p in run.pods for r in p.requests]
        out["due_in_window"] = sum(1 for r in reqs if w0 <= r.due < w1)
        out["finished"] = sum(len(p.finished) for p in run.pods)
        out["waiting_at_end"] = sum(1 for r in reqs
                                    if r.due < w1 and not r.deliveries)
        out["unfinished_at_end"] = sum(1 for r in reqs if r.due < w1
                                       and r.deliveries and r.done > w1)

    else:
        out["steps"] = [len(p.spans.get("train_step", [])) for p in run.pods]
        # where in the window steps were lost: each pod's steps ended, and
        # its seconds waited in the gate, a 10-s part of the window
        parts = [(w0 + 10.0 * k, min(w1, w0 + 10.0 * (k + 1)))
                 for k in range(math.ceil((w1 - w0) / 10.0))]
        out["steps_by_10s"] = [[sum(1 for _, t1, *_ in p.spans.get(
            "train_step", []) if a <= t1 < b) for a, b in parts]
            for p in run.pods]
        out["gate_wait_s_by_10s"] = [[round(sum(t1 - t0 for t0, t1, *_ in
                                                p.spans.get("gate_wait", [])
                                                if a <= t0 < b), 3)
                                      for a, b in parts] for p in run.pods]
    return out
