"""Device selection: the counterpart of ``kubeshare_tpu/utils/platform.py``.

The reference forces a JAX platform through ``jax.config``; here the
choice is an explicit ``torch.device``. ``None`` means the first CUDA
device, and with no CUDA device that is an error: nothing quietly runs
on the CPU. Tests and CPU tools pass ``device="cpu"`` themselves.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def _pin_matmul_precision() -> None:
    # A float32 product stays float32 (no TF32), and a bf16 product
    # accumulates in float32 all the way (no reduced-precision split-K
    # reduction): the reference's preferred_element_type=float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` -> ``cuda:0``, or
    RuntimeError when there is no CUDA device."""
    _pin_matmul_precision()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
