"""What every family's plain reference and the check's control share:
float32 products kept exact, and the control's float8 rounding. Imports
only ``torch``."""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def exact_float32() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its absolute max maps to 448), back in float32. Under
    autograd the rounding passes the gradient straight through."""
    with torch.no_grad():
        scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
        rounded = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (rounded - x).detach() if x.requires_grad else rounded
