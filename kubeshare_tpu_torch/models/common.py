"""Shared layer primitives (port of ``kubeshare_tpu/models/common.py``).

Weights are stored in float32 and cast to the compute dtype at apply
time, as in the reference. ``dense`` and ``conv`` compute in bf16 by
default: operands are cast, the product accumulates in float32 and is
rounded to bf16, and the bf16 bias is added in bf16 (a second rounding,
as the reference's ``y + b.astype(dtype)``). Layouts follow PyTorch: a
dense weight is [out, in] (``nn.Linear``), a conv weight OIHW and its
input NCHW; ``models/convert.py`` maps the reference's [in, out] and
HWIO. Norm scales stay float32; RMSNorm and LayerNorm normalise in
float32.

Layers are small ``nn.Module``s holding their parameters under the
reference's leaf names (``Dense.w``/``.b``, ``Conv.w``/``.b``,
``Norm.scale``/``.bias``, ``Embed.table``); a model is a ``Model``, an
``nn.ModuleDict`` keyed like the reference's parameter tree.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike, resolve_device


class Dense(nn.Module):
    """w [out, in], b [out], float32."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class Conv(nn.Module):
    """w [out, in, kh, kw] (OIHW), b [out], float32."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class Norm(nn.Module):
    """scale and bias [dim], float32 (LayerNorm, ResNet's group norm)."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.scale = nn.Parameter(scale)
        self.bias = nn.Parameter(bias)


class Embed(nn.Module):
    """table [vocab, dim], float32."""

    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = nn.Parameter(table)


class Model(nn.ModuleDict):
    """A model's layers keyed like the reference's parameter tree (a
    nested tree is a nested ``nn.ModuleDict``), with its config."""

    def __init__(self, cfg, layers: Mapping[str, nn.Module]):
        super().__init__(layers)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def init_generator(generator: Optional[torch.Generator],
                   device: DeviceLike) -> torch.Generator:
    """The generator a model's init draws from: ``generator`` (which must
    live on ``device``), or seed 0 on ``device``."""
    device = resolve_device(device)
    if generator is None:
        return torch.Generator(device=device).manual_seed(0)
    if torch.device(generator.device) != device:
        raise ValueError(f"generator is on {generator.device}, the model on "
                         f"{device}")
    return generator


def dense_init(in_dim: int, out_dim: int, generator: torch.Generator,
               scale: float = 1.0) -> Dense:
    """N(0, scale^2 / in_dim) weights, zero bias, on the generator's
    device."""
    device = generator.device
    w = torch.randn(out_dim, in_dim, generator=generator, device=device)
    return Dense(w * (scale / math.sqrt(in_dim)),
                 torch.zeros(out_dim, device=device))


def dense(layer: Dense, x: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    y = torch.matmul(x.to(dtype), layer.w.to(dtype).t())
    return y + layer.b.to(dtype)


def conv_init(kh: int, kw: int, in_ch: int, out_ch: int,
              generator: torch.Generator) -> Conv:
    """He-normal weights N(0, 2 / (kh kw in_ch)), zero bias."""
    device = generator.device
    w = torch.randn(out_ch, in_ch, kh, kw, generator=generator,
                    device=device)
    return Conv(w * math.sqrt(2.0 / (kh * kw * in_ch)),
                torch.zeros(out_ch, device=device))


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: the output has
    ceil(size / stride) positions, and the total padding that needs,
    max((out - 1) stride + kernel - size, 0), is split with the larger
    half after (bottom, right). A symmetric ``kernel // 2`` differs
    wherever the total is odd, as at stride 2 on an even size."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: Sequence[int], stride: int,
             value: float = 0.0) -> torch.Tensor:
    """``x`` [N, C, H, W] padded as XLA's ``SAME`` pads it."""
    (top, bottom), (left, right) = (
        same_padding(x.shape[2], kernel[0], stride),
        same_padding(x.shape[3], kernel[1], stride))
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def conv(layer: Conv, x: torch.Tensor, stride: int = 1,
         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """NCHW convolution with XLA's ``SAME`` padding, in ``dtype``."""
    w = layer.w.to(dtype)
    kernel = w.shape[2:]
    x = x.to(dtype)
    (top, bottom), (left, right) = (
        same_padding(x.shape[2], kernel[0], stride),
        same_padding(x.shape[3], kernel[1], stride))
    if top == bottom and left == right:    # no copy: the conv pads
        y = F.conv2d(x, w, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)
    return y + layer.b.to(dtype)[:, None, None]


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2,
             same: bool = False) -> torch.Tensor:
    """Max pool over H and W: ``VALID`` (no padding), or ``SAME`` with
    -inf padding on XLA's sides."""
    if same:
        x = pad_same(x, (window, window), stride, value=-math.inf)
    return F.max_pool2d(x, window, stride)


def layernorm_init(dim: int, device: DeviceLike = None) -> Norm:
    device = resolve_device(device)
    return Norm(torch.ones(dim, device=device),
                torch.zeros(dim, device=device))


def layernorm(layer: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in float32; returns float32."""
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * layer.scale + layer.bias


def rmsnorm_init(dim: int, device: DeviceLike = None) -> torch.Tensor:
    return torch.ones(dim, dtype=torch.float32, device=resolve_device(device))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * rms * scale).to(x.dtype)


def embed_init(vocab: int, dim: int, generator: torch.Generator,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 0.02^2) table drawn in float32 on the generator's device."""
    table = torch.randn(vocab, dim, generator=generator,
                        device=generator.device, dtype=torch.float32)
    return (table * 0.02).to(dtype)


def embed(table: torch.Tensor, ids: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return table.to(dtype)[ids]


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy; logits in float32 for stability."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())
