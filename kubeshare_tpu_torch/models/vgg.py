"""VGG (port of ``kubeshare_tpu/models/vgg.py``): plain conv stacks with
2x2 max-pool downsampling, batch-norm free as in the reference;
``vgg16`` matches the reference workload's model. Images NCHW
[B, 3, S, S]; the features flatten in (c, h, w) order
(``models/convert.py`` permutes ``fc1``'s rows)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike
from .common import (
    Model, conv, conv_init, dense, dense_init, init_generator, max_pool,
)


@dataclass(frozen=True)
class VggConfig:
    # channels per conv layer; 'M' = 2x2 max pool
    layers: Tuple = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M",
                     512, 512, "M")  # vgg11
    num_classes: int = 1000
    classifier_width: int = 4096
    image_size: int = 224


def vgg16() -> VggConfig:
    return VggConfig(
        layers=(64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                512, 512, 512, "M", 512, 512, 512, "M"),
    )


class Vgg(Model):
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return vgg_apply(self, images)


def init_vgg(cfg: VggConfig = VggConfig(),
             generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Vgg:
    gen = init_generator(generator, device)
    layers: Dict[str, nn.Module] = {}
    in_ch = 3
    for i, c in enumerate(cfg.layers):
        if c == "M":
            continue
        layers[f"conv{i}"] = conv_init(3, 3, in_ch, c, gen)
        in_ch = c
    feat = in_ch * (cfg.image_size // 32) ** 2
    layers["fc1"] = dense_init(feat, cfg.classifier_width, gen)
    layers["fc2"] = dense_init(cfg.classifier_width, cfg.classifier_width,
                               gen)
    layers["head"] = dense_init(cfg.classifier_width, cfg.num_classes, gen)
    return Vgg(cfg, layers)


def vgg_apply(model: Vgg, images: torch.Tensor) -> torch.Tensor:
    """images [B, 3, S, S] (S = cfg.image_size) -> bf16 logits."""
    x = images
    for i, c in enumerate(model.cfg.layers):
        if c == "M":
            x = max_pool(x)
        else:
            x = F.relu(conv(model[f"conv{i}"], x))
    x = x.reshape(x.shape[0], -1)
    x = F.relu(dense(model["fc1"], x))
    x = F.relu(dense(model["fc2"], x))
    return dense(model["head"], x)
