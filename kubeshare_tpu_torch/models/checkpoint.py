"""Workload checkpoint and resume (port of
``kubeshare_tpu/models/checkpoint.py``, on ``torch.save`` / ``torch.load``
in place of orbax).

A checkpoint is ``<directory>/step_<n:010d>/state.pt`` holding the step,
the model's ``state_dict`` and, when given, the optimizer's. Writes are
atomic: the step directory is written under a temporary name and renamed
into place, so a reader never sees half a checkpoint. After a save the
directory is pruned to the ``keep`` newest. Fractional pods are the
first to be preempted or rescheduled, so every workload saves and
resumes its (model, optimizer, step) with two calls.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from .data import _map_tensors

_STATE = "state.pt"


def _step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def _payload(step: int, model: nn.Module,
             optimizer: Optional[torch.optim.Optimizer]) -> Dict[str, Any]:
    payload: Dict[str, Any] = {"step": step, "params": model.state_dict()}
    if optimizer is not None:
        payload["opt_state"] = optimizer.state_dict()
    return payload


def _write(directory: str, step: int, payload: Dict[str, Any]) -> str:
    os.makedirs(directory, exist_ok=True)
    path = _step_path(directory, step)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp-")
    try:
        torch.save(payload, os.path.join(tmp, _STATE))
        if os.path.isdir(path):             # a rewrite of the same step
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def save_checkpoint(directory: str, step: int, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    keep: int = 3) -> str:
    """Write ``<directory>/step_<n>`` atomically; prune to ``keep``
    newest. Returns the checkpoint path."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    directory = os.path.abspath(directory)
    path = _write(directory, step, _payload(step, model, optimizer))
    _prune(directory, keep)
    return path


def latest_checkpoint(directory: str) -> Optional[int]:
    steps = _list_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(
    directory: str,
    model: Optional[nn.Module] = None,
    optimizer: Optional[torch.optim.Optimizer] = None,
    step: Optional[int] = None,
) -> Optional[Tuple[int, Dict, Optional[Dict]]]:
    """Restore (step, params, opt_state) from ``step`` (default: newest),
    the two states as the ``state_dict``s saved. None if the directory
    holds no checkpoint or the step was pruned or never written. A
    ``model`` and ``optimizer`` given are loaded from them in place (the
    tensors land on the model's device)."""
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_checkpoint(directory)
        if step is None:
            return None
    path = os.path.join(_step_path(directory, step), _STATE)
    if not os.path.isfile(path):
        return None
    location = next(model.parameters()).device if model is not None else "cpu"
    payload = torch.load(path, map_location=location, weights_only=True)
    if model is not None:
        model.load_state_dict(payload["params"])
    opt_state = payload.get("opt_state")
    if optimizer is not None and opt_state is not None:
        optimizer.load_state_dict(opt_state)
    return int(payload["step"]), payload["params"], opt_state


class AsyncCheckpointManager:
    """Non-blocking saves: ``save()`` copies the model's and optimizer's
    state to the host and returns while a background thread writes it,
    so the training loop keeps the card busy instead of stalling on
    checkpoint I/O (and a fractional pod's token hold is not billed for
    idle I/O, runtime/hook.py). A new save first joins the previous one;
    call ``wait()`` (or use as a context manager) before exit so the last
    checkpoint lands."""

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            # keep=0 would make _prune's [:-keep] slice empty and retain
            # every checkpoint
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, model: nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None) -> str:
        """Start a background save of ``step`` (joins any save in flight
        first). The state is copied before this returns, so the caller
        may update the model right after."""
        self.wait()
        payload = _map_tensors(lambda t: t.detach().to("cpu", copy=True),
                               _payload(step, model, optimizer))

        def write():
            try:
                _write(self.directory, step, payload)
                _prune(self.directory, self.keep)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        return _step_path(self.directory, step)

    def wait(self) -> None:
        """Join the save in flight; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def __enter__(self) -> "AsyncCheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.wait()


def _prune(directory: str, keep: int) -> None:
    for stale in sorted(_list_steps(directory))[:-keep]:
        shutil.rmtree(_step_path(directory, stale), ignore_errors=True)


def _list_steps(directory: str) -> List[int]:
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    steps = []
    for name in names:
        if name.startswith("step_"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                continue
    return steps
