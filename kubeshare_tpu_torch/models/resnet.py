"""ResNet (port of ``kubeshare_tpu/models/resnet.py``): residual basic or
bottleneck stacks; ``resnet50`` matches the reference workload's model.

Images NCHW [B, 3, H, W]. Convolutions pad as XLA's ``SAME`` does
(``common.conv``): the 7x7/2 stem on 32 x 32 pads (2, 3), not (3, 3),
and the 3x3/2 stem pool pads with -inf on the same sides. The norm is
the reference's batch-statistics-free group norm: float32 out, so the
residual sum is float32 too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike
from .common import (
    Model, Norm, conv, conv_init, dense, dense_init, init_generator,
    max_pool,
)


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)   # resnet18
    width: int = 64
    num_classes: int = 1000
    bottleneck: bool = False


def resnet50() -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 6, 3), bottleneck=True)


class ResNet(Model):
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return resnet_apply(self, images)


def _norm_init(ch: int, device: torch.device) -> Norm:
    return Norm(torch.ones(ch, device=device), torch.zeros(ch, device=device))


def _groups(channels: int, groups: int = 32) -> int:
    """The reference's group count: the largest g <= groups dividing
    the channels."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def _norm(layer: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.group_norm(x.float(), _groups(x.shape[1]), layer.scale,
                        layer.bias, eps)


def _block_init(in_ch: int, out_ch: int, bottleneck: bool,
                gen: torch.Generator) -> nn.ModuleDict:
    device = gen.device
    if bottleneck:
        mid = out_ch // 4
        p: Dict[str, nn.Module] = {
            "conv1": conv_init(1, 1, in_ch, mid, gen),
            "norm1": _norm_init(mid, device),
            "conv2": conv_init(3, 3, mid, mid, gen),
            "norm2": _norm_init(mid, device),
            "conv3": conv_init(1, 1, mid, out_ch, gen),
            "norm3": _norm_init(out_ch, device),
        }
    else:
        p = {
            "conv1": conv_init(3, 3, in_ch, out_ch, gen),
            "norm1": _norm_init(out_ch, device),
            "conv2": conv_init(3, 3, out_ch, out_ch, gen),
            "norm2": _norm_init(out_ch, device),
        }
    if in_ch != out_ch:
        p["proj"] = conv_init(1, 1, in_ch, out_ch, gen)
    return nn.ModuleDict(p)


def _block_apply(block: nn.ModuleDict, x: torch.Tensor, stride: int,
                 bottleneck: bool) -> torch.Tensor:
    shortcut = x
    if "proj" in block:
        shortcut = conv(block["proj"], x, stride=stride)
    if bottleneck:
        y = F.relu(_norm(block["norm1"], conv(block["conv1"], x)))
        y = F.relu(_norm(block["norm2"],
                         conv(block["conv2"], y, stride=stride)))
        y = _norm(block["norm3"], conv(block["conv3"], y))
    else:
        y = F.relu(_norm(block["norm1"],
                         conv(block["conv1"], x, stride=stride)))
        y = _norm(block["norm2"], conv(block["conv2"], y))
        if "proj" not in block and stride != 1:
            shortcut = x[:, :, ::stride, ::stride]
    if shortcut.shape != y.shape:  # stride on shortcut for proj-less case
        shortcut = shortcut[:, :, ::stride, ::stride]
    return F.relu(y + shortcut.to(y.dtype))


def init_resnet(cfg: ResNetConfig = ResNetConfig(),
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> ResNet:
    gen = init_generator(generator, device)
    layers: Dict[str, nn.Module] = {
        "stem": conv_init(7, 7, 3, cfg.width, gen),
        "stem_norm": _norm_init(cfg.width, gen.device),
    }
    mult = 4 if cfg.bottleneck else 1
    in_ch = cfg.width
    for stage, blocks in enumerate(cfg.stage_sizes):
        out_ch = cfg.width * (2 ** stage) * mult
        for block in range(blocks):
            layers[f"s{stage}b{block}"] = _block_init(in_ch, out_ch,
                                                      cfg.bottleneck, gen)
            in_ch = out_ch
    layers["head"] = dense_init(in_ch, cfg.num_classes, gen)
    return ResNet(cfg, layers)


def resnet_apply(model: ResNet, images: torch.Tensor) -> torch.Tensor:
    """images [B, 3, H, W] -> bf16 logits [B, num_classes]."""
    cfg = model.cfg
    x = conv(model["stem"], images, stride=2)
    x = F.relu(_norm(model["stem_norm"], x))
    x = max_pool(x, 3, 2, same=True)
    for stage, blocks in enumerate(cfg.stage_sizes):
        for block in range(blocks):
            stride = 2 if (stage > 0 and block == 0) else 1
            x = _block_apply(model[f"s{stage}b{block}"], x, stride,
                             cfg.bottleneck)
    x = torch.mean(x, dim=(2, 3))
    return dense(model["head"], x)
