"""Single-device training utilities (port of
``kubeshare_tpu/models/train.py``).

The reference builds a jitted optax step that takes and returns the
parameter tree. In PyTorch the model holds its parameters:
``make_train_step`` returns the optimizer and a step that updates the
model in place and returns the loss. ``optax.adam(lr)`` becomes
``torch.optim.Adam`` with optax's defaults (betas 0.9 and 0.999,
eps 1e-8).
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .graph import GraphedStep


def accumulated_value_and_grad(loss_fn: Callable, accum_steps: int):
    """``(model, batch) -> (loss, grads)``: the loss ``loss_fn(model,
    *batch)`` and the gradients of the model's trainable parameters (a
    list in ``model.parameters()`` order), with gradient accumulation:
    the batch's leading dims split into ``accum_steps`` microbatches run
    one after another, so activations live one microbatch at a time;
    gradients sum in float32, are scaled by ``1 / accum_steps`` and come
    back in the parameters' dtype. Exact for mean-style losses over
    equal microbatches. ``accum_steps == 1`` is one forward and
    backward."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def run(model: nn.Module, batch: Sequence[torch.Tensor]
            ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        params = [p for p in model.parameters() if p.requires_grad]
        if accum_steps == 1:
            loss = loss_fn(model, *batch)
            return loss.detach(), list(torch.autograd.grad(loss, params))
        micros = [x.reshape(accum_steps, x.shape[0] // accum_steps,
                            *x.shape[1:]) for x in batch]
        loss_sum = torch.zeros((), device=params[0].device)
        grad_sum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        for i in range(accum_steps):
            loss = loss_fn(model, *(m[i] for m in micros))
            grads = torch.autograd.grad(loss, params)
            loss_sum += loss.detach().float()
            for acc, g in zip(grad_sum, grads):
                acc += g.float()
        scale = 1.0 / accum_steps
        return loss_sum * scale, [(g * scale).to(p.dtype)
                                  for g, p in zip(grad_sum, params)]

    return run


def check_accum_batch(batch: Sequence[torch.Tensor], accum_steps: int) -> None:
    """Refuse a batch whose leading dims do not divide into the
    microbatch count."""
    if accum_steps > 1:
        if {x.shape[0] % accum_steps for x in batch} != {0}:
            raise ValueError(
                "batch leading dim must be divisible by "
                f"accum_steps={accum_steps}"
            )


def make_train_step(loss_fn: Callable, model: nn.Module,
                    learning_rate: float = 1e-3,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    accum_steps: int = 1, cuda_graph: bool = False):
    """``(optimizer, step)``: ``step(*batch)`` computes
    ``loss_fn(model, *batch)`` and its gradients (see
    ``accumulated_value_and_grad``), applies one optimizer update to the
    model IN PLACE, and returns the loss (a device scalar, not synced).
    The default optimizer is Adam over the model's trainable
    parameters.

    On a CUDA model with ``cuda_graph`` the whole step (forward,
    backward and the update) is captured at the first call as a CUDA
    graph (``models/graph.py``) and replayed at every call, as
    ``make_mnist_train_step`` does. The optimizer must then be an Adam
    with ``capturable=True`` (the default one is); its state is created
    before the capture, so the first replay is the first update. The
    loss returned is the graph's output buffer, rewritten by the next
    step, and ``step.inputs`` are its input buffers."""
    params = [p for p in model.parameters() if p.requires_grad]
    graphed = cuda_graph and params[0].is_cuda
    opt = optimizer or torch.optim.Adam(params, lr=learning_rate,
                                        betas=(0.9, 0.999), eps=1e-8,
                                        capturable=graphed)
    vg = accumulated_value_and_grad(loss_fn, accum_steps)

    def step(*batch):
        check_accum_batch(batch, accum_steps)
        loss, grads = vg(model, batch)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        for p in params:   # the gradients are not kept between steps
            p.grad = None
        return loss

    if not graphed:
        return opt, step
    if not all(group.get("capturable") for group in opt.param_groups):
        raise ValueError("a graphed step needs Adam(capturable=True)")
    init_adam_state(opt)

    def warmup(*batch):
        # a forward and backward that leave the parameters untouched
        vg(model, batch)

    return opt, GraphedStep(step, warmup)


def init_adam_state(opt: torch.optim.Optimizer) -> None:
    """Create the state an Adam builds at its first update (``step``,
    ``exp_avg``, ``exp_avg_sq`` and, with amsgrad, ``max_exp_avg_sq``, as
    ``torch.optim.Adam._init_group`` makes them with ``capturable``), so
    that a captured update finds it and allocates nothing. The next
    update then does what the first update of a fresh Adam does."""
    if not isinstance(opt, torch.optim.Adam):
        raise ValueError(f"expected an Adam, got {type(opt).__name__}")
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state[p]
            if state:
                continue
            state["step"] = torch.zeros((), dtype=torch.float32,
                                        device=p.device)
            for name in ("exp_avg", "exp_avg_sq") + (
                    ("max_exp_avg_sq",) if group["amsgrad"] else ()):
                state[name] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


def synthetic_batches(generator: torch.Generator, shape: Sequence[int],
                      vocab: Optional[int] = None,
                      count: int = 0) -> Iterator[torch.Tensor]:
    """Deterministic synthetic data (int64 tokens in [0, vocab), or
    float32 normal samples) drawn from ``generator`` on its device;
    ``count == 0`` streams without end."""
    i = 0
    while count == 0 or i < count:
        if vocab is not None:
            yield torch.randint(0, vocab, tuple(shape), generator=generator,
                                device=generator.device)
        else:
            yield torch.randn(*shape, generator=generator,
                              device=generator.device)
        i += 1
