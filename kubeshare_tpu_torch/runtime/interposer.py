"""CUDA interposer wiring: run a pod's process under the driver-API shim.

The native half is ``csrc/cuda_interposer.cc``: an ``LD_PRELOAD``
library that forwards the CUDA driver API to the real ``libcuda.so.1``
(env ``KUBESHARE_CUDA_REAL``), gates kernel launches and graph launches
on the pod's compute-token lease and charges every device allocation
against its memory cap, through the pod's ``tpu-pmgr``
(``KUBESHARE_POD_MANAGER_PORT``). It is the counterpart of the JAX
package's PJRT shim (``kubeshare_tpu/runtime/interposer.py``), sitting at
the waist every CUDA framework shares, and the pod needs no change of
its own: nothing in it calls ``install_gate``.

``LD_PRELOAD`` acts only when a program is executed, so :func:`enable`
works on the environment of a child process that is about to start
(``subprocess.Popen(..., env=enable(env))``), never on ``os.environ`` of
a process that is already running.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
from typing import Dict, Mapping, Optional

from ..constants import (
    ENV_CUDA_VISIBLE_DEVICES, INTERPOSER_LIBRARY, LIBRARY_PATH,
)
from ..utils.device import visible_devices_for
from .native import interposer_path

ENV_REAL = "KUBESHARE_CUDA_REAL"
LIBRARY_NAME = "libcuda_interposer"
# where NVIDIA's driver library lies on common distributions
_DRIVER_DIRS = (
    "/usr/lib/x86_64-linux-gnu",
    "/usr/lib64",
    "/usr/lib/aarch64-linux-gnu",
    "/usr/local/nvidia/lib64",
    "/usr/lib/wsl/lib",
)


def find_interposer() -> Optional[str]:
    """The interposer library: the in-repo build of this source (see
    ``runtime/native.py::build_interposer``), then the node's library
    directory. None when neither exists."""
    for candidate in (str(interposer_path()),
                      os.path.join(LIBRARY_PATH, INTERPOSER_LIBRARY)):
        if os.path.exists(candidate):
            return os.path.abspath(candidate)
    return None


def find_real_libcuda(env: Optional[Mapping[str, str]] = None
                      ) -> Optional[str]:
    """The real ``libcuda.so.1`` the interposer forwards to: an existing
    ``KUBESHARE_CUDA_REAL``, else the driver library this process has
    loaded, else the first ``libcuda.so.1`` on ``LD_LIBRARY_PATH``, in
    the usual driver directories or in the loader's cache. None when
    there is none (no driver on this node)."""
    env = os.environ if env is None else env
    explicit = env.get(ENV_REAL, "")
    if explicit and os.path.exists(explicit):
        return explicit
    try:
        with open("/proc/self/maps") as maps:
            for line in maps:
                path = line.split()[-1]
                if os.path.basename(path).startswith("libcuda.so"):
                    return path
    except OSError:
        pass
    dirs = [d for d in env.get("LD_LIBRARY_PATH", "").split(":") if d]
    for directory in (*dirs, *_DRIVER_DIRS):
        candidate = os.path.join(directory, "libcuda.so.1")
        if os.path.exists(candidate):
            return candidate
    try:
        cache = subprocess.run(["ldconfig", "-p"], capture_output=True,
                               text=True, timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    for line in cache.splitlines():
        name, _, path = line.strip().partition(" => ")
        if name.startswith("libcuda.so.1 ") and os.path.exists(path):
            return path
    return None


def enable(env: Optional[Mapping[str, str]] = None,
           interposer: str = "", real_libcuda: str = "") -> Dict[str, str]:
    """The environment a child pod process needs to run under the
    interposer: ``env`` (default ``os.environ``) with the interposer put
    first on ``LD_PRELOAD`` and ``KUBESHARE_CUDA_REAL`` naming the real
    driver. The pod's own ``KUBESHARE_POD_MANAGER_PORT`` (and
    ``KUBESHARE_POD_NAME``, ``KUBESHARE_HBM_SOFT``) must be in ``env``;
    without a manager port the interposer passes every call through.

    The scheduler's device contract (``TPU_VISIBLE_CHIPS``) becomes the
    child's ``CUDA_VISIBLE_DEVICES`` by ``utils/device.py``'s rule, with
    or without the interposer; a ``CUDA_VISIBLE_DEVICES`` that names
    other devices raises.

    Returns a copy of ``env`` without the interposer when either library
    is missing, so a pod without the interposer still runs, without
    driver-level isolation: the caller fails open, as the reference
    does."""
    out = dict(os.environ if env is None else env)
    visible = visible_devices_for(out)
    if visible is not None:
        out[ENV_CUDA_VISIBLE_DEVICES] = visible
    shim = interposer or find_interposer()
    real = real_libcuda or find_real_libcuda(out)
    if not shim or not real or not os.path.exists(shim) \
            or not os.path.exists(real):
        return out
    preload = [p for p in out.get("LD_PRELOAD", "").split(":")
               if p and p != shim]
    out["LD_PRELOAD"] = ":".join([shim, *preload])
    out[ENV_REAL] = real
    return out


def enabled(env: Optional[Mapping[str, str]] = None) -> bool:
    """Whether ``env`` (default ``os.environ``) preloads the interposer."""
    env = os.environ if env is None else env
    return any(os.path.basename(p).startswith(LIBRARY_NAME)
               for p in env.get("LD_PRELOAD", "").split(":"))


def stats() -> Optional[dict]:
    """The interposer's counters in this process (its
    ``kubeshare_cuda_interposer_stats``), or None when it is not
    loaded."""
    fn = getattr(ctypes.CDLL(None), "kubeshare_cuda_interposer_stats", None)
    if fn is None:
        return None
    fn.restype = ctypes.c_char_p
    fn.argtypes = []
    return json.loads(fn().decode())
