"""MNIST MLP/CNN (port of ``kubeshare_tpu/models/mnist.py``): the
fractional-share workload of the reference's test pods and the model of
the co-location headline (``bench/headline.py``).

Images are NCHW [B, 1, 28, 28] (the reference's are NHWC [B, 28, 28,
1]); the CNN flattens its [B, 64, 7, 7] features in (c, h, w) order, and
``models/convert.py`` permutes ``fc1``'s rows to match.

``make_mnist_train_step`` is plain SGD. On a CUDA model the whole step
(forward, backward and the in-place update) is captured once as a CUDA
graph and replayed as one launch: the counterpart of the reference's
single ``jax.jit`` dispatch. An eager step is about 40 small launches,
and eight pod threads sharing the interpreter lock would spend the
host's time on them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.device import DeviceLike
from .common import (
    Model, conv, conv_init, cross_entropy_loss, dense, dense_init,
    init_generator, max_pool,
)
from .graph import GraphedStep


@dataclass(frozen=True)
class MnistConfig:
    arch: str = "cnn"          # "cnn" | "mlp"
    hidden: int = 128
    num_classes: int = 10
    image_size: int = 28


class Mnist(Model):
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return mnist_apply(self, images)


def init_mnist(cfg: MnistConfig = MnistConfig(),
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Mnist:
    gen = init_generator(generator, device)
    if cfg.arch == "mlp":
        in_dim = cfg.image_size * cfg.image_size
        return Mnist(cfg, {
            "fc1": dense_init(in_dim, cfg.hidden, gen),
            "fc2": dense_init(cfg.hidden, cfg.hidden, gen),
            "out": dense_init(cfg.hidden, cfg.num_classes, gen),
        })
    flat = (cfg.image_size // 4) * (cfg.image_size // 4) * 64
    return Mnist(cfg, {
        "conv1": conv_init(3, 3, 1, 32, gen),
        "conv2": conv_init(3, 3, 32, 64, gen),
        "fc1": dense_init(flat, cfg.hidden, gen),
        "out": dense_init(cfg.hidden, cfg.num_classes, gen),
    })


def mnist_apply(model: Mnist, images: torch.Tensor) -> torch.Tensor:
    """images [B, 1, 28, 28] (either arch) or [B, 784] (mlp) -> bf16
    logits [B, 10]."""
    if model.cfg.arch == "mlp":
        x = images.reshape(images.shape[0], -1)
        x = F.relu(dense(model["fc1"], x))
        x = F.relu(dense(model["fc2"], x))
        return dense(model["out"], x)
    x = max_pool(F.relu(conv(model["conv1"], images)))
    x = max_pool(F.relu(conv(model["conv2"], x)))
    x = x.reshape(x.shape[0], -1)
    x = F.relu(dense(model["fc1"], x))
    return dense(model["out"], x)


def make_mnist_train_step(model: Mnist, lr: float = 1e-3,
                          cuda_graph: bool = True):
    """SGD step ``step(images, labels) -> loss`` that updates ``model``
    in place (p - lr * g, as the reference). On a CUDA model with
    ``cuda_graph`` the first call captures the step as a CUDA graph
    (after a warm-up forward and backward that changes nothing) and
    every call replays it on its capture stream (``models/graph.py``:
    the caller's stream at the first call, unless that is the default
    stream), ordered with the caller's stream. The loss it
    returns is then the graph's output buffer, overwritten by the next
    step, and ``step.inputs`` are its input buffers: a call with them
    copies nothing."""
    params = list(model.parameters())

    def eager(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        loss = cross_entropy_loss(mnist_apply(model, images), labels)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            torch._foreach_mul_(grads, lr)
            torch._foreach_sub_(params, grads)
        return loss.detach()

    if model.device.type != "cuda" or not cuda_graph:
        return eager

    def warmup(images: torch.Tensor, labels: torch.Tensor) -> None:
        # a forward and backward that leave the parameters untouched
        loss = cross_entropy_loss(mnist_apply(model, images), labels)
        torch.autograd.grad(loss, params)

    return GraphedStep(eager, warmup)
