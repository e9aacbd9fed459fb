"""CIFAR-10 CNN (port of ``kubeshare_tpu/models/cifar.py``): VGG-style
blocks, the reference's second co-location workload. Images NCHW
[B, 3, 32, 32]; the features flatten in (c, h, w) order
(``models/convert.py`` permutes ``fc``'s rows)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike
from .common import (
    Model, conv, conv_init, dense, dense_init, init_generator, max_pool,
)


@dataclass(frozen=True)
class CifarConfig:
    widths: tuple = (64, 128, 256)
    hidden: int = 256
    num_classes: int = 10
    image_size: int = 32


class Cifar(Model):
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return cifar_apply(self, images)


def init_cifar(cfg: CifarConfig = CifarConfig(),
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Cifar:
    gen = init_generator(generator, device)
    layers: Dict[str, nn.Module] = {}
    in_ch = 3
    for i, width in enumerate(cfg.widths):
        layers[f"block{i}_a"] = conv_init(3, 3, in_ch, width, gen)
        layers[f"block{i}_b"] = conv_init(3, 3, width, width, gen)
        in_ch = width
    spatial = cfg.image_size // (2 ** len(cfg.widths))
    layers["fc"] = dense_init(spatial * spatial * in_ch, cfg.hidden, gen)
    layers["out"] = dense_init(cfg.hidden, cfg.num_classes, gen)
    return Cifar(cfg, layers)


def cifar_apply(model: Cifar, images: torch.Tensor) -> torch.Tensor:
    """images [B, 3, 32, 32] -> bf16 logits [B, 10]."""
    x = images
    for i in range(len(model.cfg.widths)):
        x = F.relu(conv(model[f"block{i}_a"], x))
        x = F.relu(conv(model[f"block{i}_b"], x))
        x = max_pool(x)
    x = x.reshape(x.shape[0], -1)
    x = F.relu(dense(model["fc"], x))
    return dense(model["out"], x)
