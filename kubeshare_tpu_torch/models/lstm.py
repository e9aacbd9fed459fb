"""LSTM language model (port of ``kubeshare_tpu/models/lstm.py``): the
reference's gang-scheduled workload. The reference's ``lax.scan`` over
time is a plain loop here. ``h`` is carried in the embedding's bf16 and
``c`` in float32; the four gates come from one fused dense
[in + hidden -> 4 hidden] in the order i, f, g, o, with +1.0 on the
forget gate."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..utils.device import DeviceLike
from .common import (
    Dense, Embed, Model, dense, dense_init, embed, embed_init, init_generator,
)


@dataclass(frozen=True)
class LstmConfig:
    vocab: int = 8192
    dim: int = 256
    hidden: int = 512
    layers: int = 2


class Lstm(Model):
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return lstm_apply(self, tokens)


def init_lstm(cfg: LstmConfig = LstmConfig(),
              generator: Optional[torch.Generator] = None,
              device: DeviceLike = None) -> Lstm:
    gen = init_generator(generator, device)
    layers = {"embed": Embed(embed_init(cfg.vocab, cfg.dim, gen))}
    in_dim = cfg.dim
    for i in range(cfg.layers):
        layers[f"cell{i}"] = dense_init(in_dim + cfg.hidden, 4 * cfg.hidden,
                                        gen)
        in_dim = cfg.hidden
    layers["out"] = dense_init(cfg.hidden, cfg.vocab, gen)
    return Lstm(cfg, layers)


def _cell_step(cell: Dense, h: torch.Tensor, c: torch.Tensor,
               x: torch.Tensor):
    gates = dense(cell, torch.cat([x, h], dim=-1))
    i, f, g, o = gates.float().chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = (torch.sigmoid(o) * torch.tanh(c)).to(x.dtype)
    return h, c


def lstm_apply(model: Lstm, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] -> bf16 logits [B, T, vocab]."""
    cfg = model.cfg
    batch = tokens.shape[0]
    x = embed(model["embed"].table, tokens).transpose(0, 1)   # [T, B, D]
    for layer in range(cfg.layers):
        cell = model[f"cell{layer}"]
        h = torch.zeros(batch, cfg.hidden, dtype=x.dtype, device=x.device)
        c = torch.zeros(batch, cfg.hidden, dtype=torch.float32,
                        device=x.device)
        outputs = []
        for xt in x:
            h, c = _cell_step(cell, h, c, xt)
            outputs.append(h)
        x = torch.stack(outputs)
    return dense(model["out"], x.transpose(0, 1))             # [B, T, V]
