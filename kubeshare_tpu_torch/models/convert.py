"""Weights carried across from and back to the reference.

This module is the one place that knows both layouts. The reference's
parameter trees (``init_llama``, ``quantize_llama``, ``init_mnist`` ...
of ``kubeshare_tpu.models``, their leaves as numpy arrays) store matmul
weights float32 [in, out], int8 ``{"w_q": [in, out], "scale": [out]}``
pairs and conv weights HWIO; the port stores [out, in], ``Int8Weight``
and OIHW. The reference flattens NHWC features in (h, w, c) order and
the port NCHW features in (c, h, w) order, so the first dense layer
after a flatten has its rows permuted. The conversion is exact: bf16
leaves (numpy ``ml_dtypes.bfloat16``) go through float32, which holds
every bf16 value.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from .cifar import Cifar, CifarConfig, init_cifar
from .common import Conv, Dense, Embed, Model, Norm
from .llama import Llama, LlamaBlock, LlamaConfig
from .lstm import Lstm, LstmConfig, init_lstm
from .mnist import Mnist, MnistConfig, init_mnist
from .quant import _LAYER_MATS, Int8Weight, is_quantized
from .resnet import ResNet, ResNetConfig, init_resnet
from .vgg import Vgg, VggConfig, init_vgg


def llama_from_jax(params: Mapping, cfg: LlamaConfig,
                   device: DeviceLike = None,
                   trainable: bool = False) -> Llama:
    """The port's ``Llama`` holding the reference tree's weights: in
    ``cfg.dtype`` for inference, or (``trainable=True``) as float32
    master weights with gradients, as the reference trains them."""
    device = resolve_device(device)
    dtype = torch.float32 if trainable else cfg.torch_dtype

    def tensor(a, dtype=torch.float32):
        # torch.tensor copies: the arrays may be read-only views
        return torch.tensor(np.asarray(a, np.float32), device=device).to(dtype)

    def matrix(w):
        if isinstance(w, Mapping) and "w_q" in w:
            if trainable:
                raise ValueError("int8 weights cannot be trained")
            w_q = torch.tensor(np.asarray(w["w_q"], np.int8).T, device=device)
            return Int8Weight(w_q.contiguous(), tensor(w["scale"]))
        return tensor(np.asarray(w, np.float32).T, dtype).contiguous()

    layers = []
    for i in range(cfg.layers):
        layer = params[f"layer{i}"]
        layers.append(LlamaBlock(
            attn_norm=tensor(layer["attn_norm"]["scale"]),
            mlp_norm=tensor(layer["mlp_norm"]["scale"]),
            **{name: matrix(layer[name]) for name in _LAYER_MATS},
            trainable=trainable,
        ))
    return Llama(cfg, tensor(params["embed"]["table"], dtype), layers,
                 tensor(params["final_norm"]["scale"]),
                 matrix(params["lm_head"]), trainable=trainable)


def llama_to_jax(model: Llama, grads: bool = False) -> Dict:
    """The reference's parameter tree (numpy float32 leaves, matmul
    weights [in, out]) of ``model``'s weights or, with ``grads=True``, of
    their gradients (zeros where a weight has none). Int8 weights come
    back as ``{"w_q", "scale"}`` pairs."""

    def leaf(p) -> np.ndarray:
        t = p.grad if grads else p
        if t is None:
            t = torch.zeros_like(p)
        return t.detach().float().cpu().numpy()

    def matrix(w):
        if is_quantized(w):
            return {"w_q": w.w_q.cpu().numpy().T, "scale": leaf(w.scale)}
        return np.ascontiguousarray(leaf(w).T)

    tree: Dict = {"embed": {"table": leaf(model.embed)}}
    for i, layer in enumerate(model.layers):
        tree[f"layer{i}"] = {
            "attn_norm": {"scale": leaf(layer.attn_norm)},
            "mlp_norm": {"scale": leaf(layer.mlp_norm)},
            **{name: matrix(getattr(layer, name)) for name in _LAYER_MATS},
        }
    tree["final_norm"] = {"scale": leaf(model.final_norm)}
    tree["lm_head"] = matrix(model.lm_head)
    return tree


def stacked_layers_from_jax(stacked: Mapping, device: DeviceLike = None,
                            requires_grad: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """The port's stacked trunk (``llama_stack_layers``: a flat dict of
    leaves [L, ...], matmul weights [L, out, in]) from the reference's
    (``kubeshare_tpu.models.llama.llama_stack_layers``: the layer tree
    with leaves [L, ...], matmul weights [L, in, out]), as float32 leaf
    tensors."""
    device = resolve_device(device)

    def leaf(a, swap):
        a = np.asarray(a, np.float32)
        a = np.ascontiguousarray(a.swapaxes(-1, -2) if swap else a)
        return torch.tensor(a, device=device).requires_grad_(requires_grad)

    return {"attn_norm": leaf(stacked["attn_norm"]["scale"], False),
            "mlp_norm": leaf(stacked["mlp_norm"]["scale"], False),
            **{name: leaf(stacked[name], True) for name in _LAYER_MATS}}


def stacked_layers_to_jax(stacked: Mapping[str, torch.Tensor],
                          grads: bool = False) -> Dict:
    """The reference's stacked layer tree (numpy float32, [L, in, out])
    of the port's stacked leaves or, with ``grads=True``, of their
    gradients (zeros where a leaf has none)."""

    def leaf(t, swap):
        if grads:
            t = t.grad if t.grad is not None else torch.zeros_like(t)
        a = t.detach().float().cpu().numpy()
        return np.ascontiguousarray(a.swapaxes(-1, -2) if swap else a)

    return {"attn_norm": {"scale": leaf(stacked["attn_norm"], False)},
            "mlp_norm": {"scale": leaf(stacked["mlp_norm"], False)},
            **{name: leaf(stacked[name], True) for name in _LAYER_MATS}}


# MoE weights: the reference's router [D, E], w_gate / w_up [E, D, H] and
# w_down [E, H, D]; the port's the same with the last two dims swapped.
_MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")


def moe_from_jax(params: Mapping, device: DeviceLike = None
                 ) -> Dict[str, torch.Tensor]:
    """The port's MoE weights (``models.moe``, float32) from the
    reference tree's."""
    device = resolve_device(device)
    return {name: torch.tensor(np.ascontiguousarray(
                np.asarray(params[name], np.float32).swapaxes(-1, -2)),
                device=device) for name in _MOE_LEAVES}


def moe_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The reference's MoE tree (numpy float32) of the port's weights
    (or of any tensors in their layout, such as their gradients)."""
    return {name: np.ascontiguousarray(
                params[name].detach().float().cpu().numpy().swapaxes(-1, -2))
            for name in _MOE_LEAVES}


# ---- the workload models -------------------------------------------------
#
# ``flat`` names the dense layer that follows a flatten, with the
# (channels, height, width) of the feature map it reads.

Flat = Dict[str, Tuple[int, int, int]]


def _dense_w_from_jax(w: np.ndarray, chw: Optional[Tuple[int, int, int]]):
    if chw is not None:                 # rows (h, w, c) -> (c, h, w)
        c, h, wd = chw
        w = w.reshape(h, wd, c, -1).transpose(2, 0, 1, 3).reshape(
            c * h * wd, -1)
    return w.T


def _dense_w_to_jax(w: np.ndarray, chw: Optional[Tuple[int, int, int]]):
    w = w.T
    if chw is not None:                 # rows (c, h, w) -> (h, w, c)
        c, h, wd = chw
        w = w.reshape(c, h, wd, -1).transpose(1, 2, 0, 3).reshape(
            c * h * wd, -1)
    return w


def _load(module: nn.Module, tree: Mapping, flat: Flat, name: str = "") -> None:
    """Copy the reference tree's leaves into ``module``'s parameters."""

    def put(param: torch.Tensor, array) -> None:
        array = np.ascontiguousarray(np.asarray(array, np.float32))
        if tuple(array.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {array.shape}, port "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.tensor(array))

    if isinstance(module, Dense):
        put(module.w, _dense_w_from_jax(np.asarray(tree["w"], np.float32),
                                        flat.get(name)))
        put(module.b, tree["b"])
    elif isinstance(module, Conv):             # HWIO -> OIHW
        put(module.w, np.asarray(tree["w"], np.float32).transpose(3, 2, 0, 1))
        put(module.b, tree["b"])
    elif isinstance(module, Norm):
        put(module.scale, tree["scale"])
        put(module.bias, tree["bias"])
    elif isinstance(module, Embed):
        put(module.table, tree["table"])
    else:
        if set(tree) != set(module.keys()):
            raise ValueError(f"{name or 'model'}: reference keys "
                             f"{sorted(tree)}, port {sorted(module.keys())}")
        for key, child in module.items():
            _load(child, tree[key], flat, key if not name else f"{name}.{key}")


def _dump(module: nn.Module, flat: Flat, grads: bool,
          name: str = "") -> Dict:
    def leaf(p) -> np.ndarray:
        t = p.grad if grads else p
        if t is None:
            t = torch.zeros_like(p)
        return t.detach().float().cpu().numpy()

    if isinstance(module, Dense):
        return {"w": np.ascontiguousarray(
                    _dense_w_to_jax(leaf(module.w), flat.get(name))),
                "b": leaf(module.b)}
    if isinstance(module, Conv):               # OIHW -> HWIO
        return {"w": np.ascontiguousarray(leaf(module.w).transpose(2, 3, 1, 0)),
                "b": leaf(module.b)}
    if isinstance(module, Norm):
        return {"scale": leaf(module.scale), "bias": leaf(module.bias)}
    if isinstance(module, Embed):
        return {"table": leaf(module.table)}
    return {key: _dump(child, flat, grads,
                       key if not name else f"{name}.{key}")
            for key, child in module.items()}


def _mnist_flat(cfg: MnistConfig) -> Flat:
    side = cfg.image_size // 4
    return {} if cfg.arch == "mlp" else {"fc1": (64, side, side)}


def _cifar_flat(cfg: CifarConfig) -> Flat:
    side = cfg.image_size // (2 ** len(cfg.widths))
    return {"fc": (cfg.widths[-1], side, side)}


def _vgg_flat(cfg: VggConfig) -> Flat:
    channels = [c for c in cfg.layers if c != "M"][-1]
    side = cfg.image_size // 32
    return {"fc1": (channels, side, side)}


_WORKLOADS = {
    Mnist: (init_mnist, _mnist_flat),
    Cifar: (init_cifar, _cifar_flat),
    Vgg: (init_vgg, _vgg_flat),
    ResNet: (init_resnet, lambda cfg: {}),
    Lstm: (init_lstm, lambda cfg: {}),
}


def _from_jax(kind, params: Mapping, cfg, device: DeviceLike) -> Model:
    init, flat = _WORKLOADS[kind]
    model = init(cfg, device=device)
    _load(model, params, flat(cfg))
    return model


def mnist_from_jax(params: Mapping, cfg: MnistConfig = MnistConfig(),
                   device: DeviceLike = None) -> Mnist:
    """The port's ``Mnist`` holding the reference tree's weights."""
    return _from_jax(Mnist, params, cfg, device)


def cifar_from_jax(params: Mapping, cfg: CifarConfig = CifarConfig(),
                   device: DeviceLike = None) -> Cifar:
    return _from_jax(Cifar, params, cfg, device)


def vgg_from_jax(params: Mapping, cfg: VggConfig = VggConfig(),
                 device: DeviceLike = None) -> Vgg:
    return _from_jax(Vgg, params, cfg, device)


def resnet_from_jax(params: Mapping, cfg: ResNetConfig = ResNetConfig(),
                    device: DeviceLike = None) -> ResNet:
    return _from_jax(ResNet, params, cfg, device)


def lstm_from_jax(params: Mapping, cfg: LstmConfig = LstmConfig(),
                  device: DeviceLike = None) -> Lstm:
    return _from_jax(Lstm, params, cfg, device)


def workload_to_jax(model: Model, grads: bool = False) -> Dict:
    """The reference's parameter tree (numpy float32 leaves in its
    layouts) of a workload model's weights or, with ``grads=True``, of
    their gradients (zeros where a weight has none)."""
    _, flat = _WORKLOADS[type(model)]
    return _dump(model, flat(model.cfg), grads)
