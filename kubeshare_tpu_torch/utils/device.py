"""Device selection: the counterpart of ``kubeshare_tpu/utils/platform.py``.

The reference forces a JAX platform through ``jax.config``; here the
choice is an explicit ``torch.device``. ``None`` means the first CUDA
device, and with no CUDA device that is an error: nothing quietly runs
on the CPU. Tests and CPU tools pass ``device="cpu"`` themselves.

The scheduler names a pod's devices by uuid in ``TPU_VISIBLE_CHIPS``
(``constants.ENV_VISIBLE_CHIPS``); libtpu honours it on a TPU. Here
``honour_visible_chips`` maps it onto ``CUDA_VISIBLE_DEVICES`` before
CUDA starts, by one rule (``visible_devices_for``) that the CUDA
interposer and ``runtime/interposer.py::enable`` keep too: the variable
unset or empty takes the contract's list; equal to it, nothing changes;
another value is an error that names both.
"""

from __future__ import annotations

import os
from typing import MutableMapping, Optional, Union

import torch

from ..constants import ENV_CUDA_VISIBLE_DEVICES, ENV_VISIBLE_CHIPS

DeviceLike = Union[str, torch.device, None]


def visible_devices_for(env) -> Optional[str]:
    """The ``CUDA_VISIBLE_DEVICES`` value that ``env`` must be given to
    honour the scheduler's contract: the contract's uuid list when the
    variable is unset or empty, None when there is nothing to set (no
    contract, or the variable already equals it). RuntimeError, naming
    both, when the variable names other devices."""
    chips = env.get(ENV_VISIBLE_CHIPS, "")
    if not chips:
        return None
    current = env.get(ENV_CUDA_VISIBLE_DEVICES, "")
    if not current:
        return chips
    if current == chips:
        return None
    raise RuntimeError(
        f"{ENV_CUDA_VISIBLE_DEVICES}={current!r} disagrees with the "
        f"scheduler's {ENV_VISIBLE_CHIPS}={chips!r}")


def _bare_uuid(uuid: str) -> str:
    uuid = uuid.strip().lower()
    for prefix in ("gpu-", "mig-"):
        if uuid.startswith(prefix):
            return uuid[len(prefix):]
    return uuid


def device_uuid(index: int = 0) -> str:
    """NVML's ``GPU-...`` uuid of CUDA device ``index`` (torch's
    property lacks the prefix). Starts CUDA."""
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    return uuid if uuid.startswith(("GPU-", "MIG-")) else "GPU-" + uuid


def check_visible_chips(env=None) -> None:
    """With CUDA up, device 0 must be one of the contract's devices:
    RuntimeError otherwise (a process that started CUDA before the
    contract was applied sees the whole node)."""
    env = os.environ if env is None else env
    chips = env.get(ENV_VISIBLE_CHIPS, "")
    if not chips:
        return
    uuid = device_uuid(0)
    if _bare_uuid(uuid) not in {_bare_uuid(c) for c in chips.split(",")}:
        raise RuntimeError(
            f"CUDA device 0 is {uuid}, not one of the scheduler's "
            f"{ENV_VISIBLE_CHIPS}={chips!r}: CUDA started before the "
            "contract was applied")


def honour_visible_chips(
        env: Optional[MutableMapping[str, str]] = None) -> Optional[str]:
    """Apply the scheduler's device contract to ``env`` (default
    ``os.environ``) by ``visible_devices_for``'s rule, before CUDA
    starts; once ``torch.cuda`` is up, check device 0 against it
    instead. Returns the contract's list, or None without one."""
    env = os.environ if env is None else env
    want = visible_devices_for(env)
    if env is os.environ and torch.cuda.is_initialized():
        check_visible_chips(env)
    elif want is not None:
        env[ENV_CUDA_VISIBLE_DEVICES] = want
    return env.get(ENV_VISIBLE_CHIPS) or None


def _pin_matmul_precision() -> None:
    # A float32 product stays float32 (no TF32), and a bf16 product
    # accumulates in float32 all the way (no reduced-precision split-K
    # reduction): the reference's preferred_element_type=float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` -> ``cuda:0``, or
    RuntimeError when there is no CUDA device. The scheduler's device
    contract is applied first (``honour_visible_chips``), and a CUDA
    device is checked against it."""
    _pin_matmul_precision()
    honour_visible_chips()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        check_visible_chips()
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda":
        check_visible_chips()
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
