"""Run a function on every rank of a new ``torch.distributed`` world of
spawned processes (port-only: the reference runs its mesh in one
process, so it has no counterpart).

    results = run_world(fn, world=4, args=(...), device_type="cuda")

Each rank is a ``spawn``ed process that joins the world
(``multihost.init_distributed``: the backend by its one rule, the
device ``cuda:(rank % device_count())``), calls ``fn(joined, *args)``
and sends back what it returns. ``fn`` must be importable by name (a
module-level function) and return something picklable; tensors are
pickled by value. A rank that raises, dies or outlives ``timeout``
fails the whole world: the other ranks are killed and ``WorldFailed``
is raised with the failing rank's traceback. A rank whose parent dies
exits too. Nothing hangs and nothing is left running.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch


class WorldFailed(RuntimeError):
    pass


def _exit_with(parent: int) -> None:
    """Exit this rank as soon as its parent is gone (killed at a time
    limit, say): its peers would wait for it in a collective."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def _rank_main(rank: int, world: int, init_method: str, device_type: str,
               fn: Callable, args: Sequence, results, parent: int) -> None:
    from . import comm
    from .multihost import init_distributed

    threading.Thread(target=_exit_with, args=(parent,), daemon=True).start()
    try:
        if device_type == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        joined = init_distributed(init_method, world, rank, device_type)
        out = fn(joined, *args)
        if device_type == "cuda":
            torch.cuda.synchronize()
        comm.barrier(comm.world())
        comm.destroy()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 - reported to the parent, then exit 1
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_world(fn: Callable, world: int, args: Sequence = (),
              timeout: Optional[float] = 120.0, device_type: str = "cuda",
              init_method: Optional[str] = None) -> List[Any]:
    """``[fn(joined_r, *args) for r in range(world)]``, each on its own
    rank process (module docstring). ``init_method`` defaults to a file
    in a new temporary directory; ``timeout=None`` waits without end
    for live ranks (a rank that dies still fails the world)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="kubeshare-world-")
        init_method = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, name=f"rank-{r}",
                         args=(r, world, init_method, device_type, fn,
                               tuple(args), results, os.getpid()))
             for r in range(world)]
    deadline = None if timeout is None else time.monotonic() + timeout
    done = {}
    try:
        for proc in procs:
            proc.start()
        while len(done) < world:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue_mod.Empty:
                for r, proc in enumerate(procs):
                    if r not in done and proc.exitcode not in (None, 0):
                        raise WorldFailed(
                            f"rank {r} of {world} exited with "
                            f"{proc.exitcode} and no result")
                if deadline is not None and time.monotonic() > deadline:
                    raise WorldFailed(
                        f"ranks {sorted(set(range(world)) - set(done))} of "
                        f"{world} gave no result within {timeout} s")
                continue
            if not ok:
                raise WorldFailed(f"rank {rank} of {world} failed:\n{payload}")
            done[rank] = pickle.loads(payload)
        for proc in procs:
            proc.join(timeout=30)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            if proc.pid is not None:
                proc.join()
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return [done[r] for r in range(world)]
