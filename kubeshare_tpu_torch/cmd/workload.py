"""Containerized training workload entrypoint (port of
``kubeshare_tpu/cmd/workload.py``, its single-process path).

    python -m kubeshare_tpu_torch.cmd.workload --model mnist [--device cpu]

Trains a named model (``mnist``, ``cifar``, ``resnet``, ``vgg``,
``lstm`` or ``llama``) on synthetic data under the shared-device gate.
The gate reads the scheduler-injected env (KUBESHARE_POD_MANAGER_PORT /
KUBESHARE_HBM_LIMIT_BYTES) and amortizes token holds across steps; on a
whole-device or dev run it is a no-op. Prints one JSON line of
throughput stats at exit, with the reference's keys.

Differences from the reference:
- ``--device`` (default ``cuda``) takes the place of ``JAX_PLATFORMS``;
  without a CUDA device the command fails unless given ``--device cpu``.
- Images are NCHW. The batch of global step n is drawn from a generator
  seeded with (seed + 1, n), so a resumed run sees the batches an
  uninterrupted run would have seen (the reference restarts its data
  key on resume).
- The warm-up before the timed loop runs one forward and backward and
  discards them: the update is in place here, and a warm-up update
  would be a step the counter never records.
- What needs ``parallel/`` is not ported yet and stops with a
  ``SystemExit`` that says so: ``--sp`` and a multi-process gang env.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Mapping, Optional, Sequence

import torch

from .common import add_common_flags, component_logger

# the gang env (kubeshare_tpu/parallel/multihost.py)
ENV_COORDINATOR = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "KUBESHARE_NUM_PROCESSES"
ENV_GANG_HEADCOUNT = "KUBESHARE_GROUP_HEADCOUNT"

NOT_PORTED = "is not ported yet (kubeshare_tpu/parallel; ROADMAP Queue 1)"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kubeshare-tpu-workload", description=__doc__.split("\n")[0]
    )
    add_common_flags(parser)
    parser.add_argument(
        "--model", default="mnist",
        choices=["mnist", "cifar", "lstm", "resnet", "vgg", "llama"],
    )
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--steps", type=int, default=0,
                        help="step budget (0 = until --duration)")
    parser.add_argument("--duration", type=float, default=0.0,
                        help="wall-clock budget in seconds (0 = until --steps)")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--checkpoint-dir", default="",
                        help="save/resume (model, optimizer, step) here")
    parser.add_argument(
        "--profile-dir", default="",
        help="write a torch.profiler trace of the training loop here "
             "(trace.json: chrome://tracing or ui.perfetto.dev)",
    )
    parser.add_argument("--checkpoint-every", type=int, default=50,
                        help="steps between checkpoints")
    parser.add_argument("--seq-len", type=int, default=256,
                        help="llama sequence length")
    parser.add_argument(
        "--sp", type=int, default=0,
        help="shard the llama sequence over N local devices (not ported "
             "yet; 0 = off)",
    )
    parser.add_argument(
        "--sp-impl", choices=["ring", "ulysses"], default="ring",
        help="sequence-parallel attention strategy",
    )
    parser.add_argument(
        "--sp-flash", action="store_true",
        help="run each SP attention block with the flash kernels",
    )
    parser.add_argument(
        "--remat", action="store_true",
        help="recompute each llama block in the backward: trade FLOPs "
             "for memory on long-context batches",
    )
    parser.add_argument(
        "--window", type=int, default=0,
        help="llama sliding-window attention width (0 = full causal)",
    )
    parser.add_argument(
        "--accum", type=int, default=1,
        help="gradient-accumulation microbatches per optimizer update "
             "(batch must divide)",
    )
    parser.add_argument(
        "--prefetch", type=int, default=0,
        help="stage N batches ahead on a background thread "
             "(models/data.py Prefetcher); single-process only",
    )
    return parser


def gang_size(environ: Optional[Mapping[str, str]] = None) -> int:
    """The process count of the multi-process gang this pod belongs to
    (the reference's ``spec_from_env``: a coordinator and a count of at
    least 2), else 0."""
    env = os.environ if environ is None else environ
    if not env.get(ENV_COORDINATOR, ""):
        return 0
    raw = env.get(ENV_NUM_PROCESSES) or env.get(ENV_GANG_HEADCOUNT) or ""
    try:
        n = int(raw)
    except ValueError:
        return 0
    return n if n >= 2 else 0


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy over integer labels, in the logits'
    dtype, as ``optax.softmax_cross_entropy_with_integer_labels(...)
    .mean()`` computes it."""
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


IMAGE_SHAPES = {"mnist": (1, 28), "cifar": (3, 32), "resnet": (3, 32),
                "vgg": (3, 32)}


def _build(model: str, batch: int, device: torch.device, seed: int,
           seq_len: int = 256, sp: int = 0, sp_impl: str = "ring",
           sp_flash: bool = False, remat: bool = False, window: int = 0):
    """(model, loss_fn, batch_at): the model-specific pieces.
    ``batch_at(n)`` is the batch of global step n."""
    from .. import models as M

    if sp > 0 and model != "llama":
        # refusing beats training unsharded with the flags ignored
        raise SystemExit(f"--sp applies to --model llama, not {model}")
    if remat and model != "llama":
        raise SystemExit(f"--remat applies to --model llama, not {model}")
    if window and model != "llama":
        raise SystemExit(f"--window applies to --model llama, not {model}")
    if window and sp and sp_impl == "ring" and sp_flash:
        raise SystemExit(
            "--window composes with --sp except for ring + --sp-flash "
            "(flash hop bodies lack a query-offset input); drop "
            "--sp-flash or use --sp-impl ulysses"
        )
    if sp > 0:
        raise SystemExit(f"--sp (sequence parallelism) {NOT_PORTED}")

    gen = torch.Generator(device=device).manual_seed(seed)
    data = torch.Generator(device=device)

    def draw(index: int) -> torch.Generator:
        return data.manual_seed(((seed + 1) << 32) + index)

    if model in ("llama", "lstm"):
        if model == "llama":
            cfg = M.LlamaConfig(vocab=2048, dim=256, layers=4, num_heads=8,
                                num_kv_heads=4, mlp_dim=512,
                                max_seq_len=seq_len, window=window)
            net = M.init_llama(cfg, generator=gen, device=device,
                               trainable=True)

            def loss_fn(m, tokens):
                return M.llama_loss(m, tokens, remat=remat)

            length = seq_len
        else:
            cfg = M.LstmConfig()
            net = M.init_lstm(cfg, generator=gen, device=device)

            def loss_fn(m, tokens):
                logits = M.lstm_apply(m, tokens)
                targets = torch.roll(tokens, -1, dims=1)
                return xent(logits[:, :-1], targets[:, :-1])

            length = 64

        def batch_at(index):
            return (torch.randint(0, cfg.vocab, (batch, length),
                                  generator=draw(index), device=device),)

        return net, loss_fn, batch_at

    configs = {
        "mnist": (M.MnistConfig, M.init_mnist, M.mnist_apply, 10),
        "cifar": (M.CifarConfig, M.init_cifar, M.cifar_apply, 10),
        "resnet": (M.ResNetConfig, M.init_resnet, M.resnet_apply, 10),
        # CIFAR-scale VGG (the reference's vgg16 jobs run CIFAR)
        "vgg": (lambda: M.VggConfig(
                    layers=(32, "M", 64, "M", 128, "M", 256, "M", 256, "M"),
                    num_classes=10, classifier_width=256, image_size=32,
                ), M.init_vgg, M.vgg_apply, 10),
    }
    cfg_cls, init, apply, classes = configs[model]
    channels, side = IMAGE_SHAPES[model]
    net = init(cfg_cls(), generator=gen, device=device)

    def loss_fn(m, images, labels):
        return xent(apply(m, images), labels)

    def batch_at(index):
        g = draw(index)
        return (
            torch.randn(batch, channels, side, side, generator=g,
                        device=device),
            torch.randint(0, classes, (batch,), generator=g, device=device),
        )

    return net, loss_fn, batch_at


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    log = component_logger("workload", args)
    if not args.steps and not args.duration:
        args.steps = 100

    from ..runtime.hook import _block, install_gate

    gate = install_gate()     # before any CUDA work: it may cap the allocator

    if gang_size():
        # the reference joins jax.distributed here and trains dp-sharded
        raise SystemExit(f"multi-process gang training {NOT_PORTED}")

    from ..models.train import (
        accumulated_value_and_grad, check_accum_batch, make_train_step,
    )
    from ..utils.device import resolve_device

    device = resolve_device(None if args.device == "cuda" else args.device)
    model, loss_fn, batch_at = _build(
        args.model, args.batch, device, args.seed, args.seq_len, args.sp,
        args.sp_impl, args.sp_flash, args.remat, args.window)
    opt, step = make_train_step(loss_fn, model, learning_rate=args.lr,
                                accum_steps=args.accum)

    start_step = 0
    if args.checkpoint_dir:
        from ..models.checkpoint import restore_checkpoint, save_checkpoint

        restored = restore_checkpoint(args.checkpoint_dir, model, opt)
        if restored is not None:
            start_step = restored[0]
            log.info("resumed from step %d", start_step)

    # warm-up outside the gated loop: one forward and backward on the
    # first batch, discarded, so the model and optimizer enter the loop
    # exactly as initialised or restored
    batch = batch_at(start_step)
    check_accum_batch(batch, args.accum)
    loss, _ = accumulated_value_and_grad(loss_fn, args.accum)(model, batch)
    _block(loss)

    log.info("workload %s batch=%d on %s starting", args.model, args.batch,
             device)
    prof = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    started = time.perf_counter()
    steps_done = 0
    last_saved = -1
    result = None
    feed = None
    if args.prefetch > 0:
        from ..models.data import prefetch_to_device

        def batch_stream(index):
            while True:
                yield batch_at(index)
                index += 1

        # batches are drawn on the device already: the win is the
        # producer running ahead of the consuming steps
        feed = prefetch_to_device(batch_stream(start_step),
                                  size=args.prefetch, transfer=None)
    try:
        while True:
            if args.steps and steps_done >= args.steps:
                break
            if (args.duration
                    and time.perf_counter() - started >= args.duration):
                break
            if feed is not None:
                batch = next(feed)
            else:
                batch = batch_at(start_step + steps_done)
            gate.begin()
            loss = step(*batch)
            result = gate.maybe_release(loss)
            steps_done += 1
            if (
                args.checkpoint_dir
                and steps_done % max(1, args.checkpoint_every) == 0
            ):
                # return the lease BEFORE the drain and the disk write:
                # holding it would starve co-located pods and bill
                # checkpoint I/O as device time
                result = gate.flush(result)
                _block(loss)
                save_checkpoint(args.checkpoint_dir, start_step + steps_done,
                                model, opt)
                last_saved = start_step + steps_done
        gate.flush(result)
        if (
            args.checkpoint_dir
            and steps_done
            and last_saved != start_step + steps_done
        ):
            _block(loss)
            save_checkpoint(args.checkpoint_dir, start_step + steps_done,
                            model, opt)
        _block(loss)    # queued work must not inflate the throughput
        # measured before the feed's teardown: close() is shutdown cost
        elapsed = time.perf_counter() - started
    finally:
        if feed is not None:
            feed.close()
        if prof is not None:
            prof.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(args.profile_dir, "trace.json"))
            log.info("profiler trace written to %s", args.profile_dir)
    gate.close()
    print(json.dumps({
        "model": args.model,
        "steps": steps_done,
        "batch": args.batch,
        "processes": 1,
        "global_batch": args.batch,
        "seconds": round(elapsed, 3),
        "samples_per_s": round(steps_done * args.batch / max(elapsed, 1e-9),
                               1),
        "final_loss": float(loss),
        "tokens_acquired": gate.tokens_acquired,
        "compute_ms": round(gate.compute_ms, 1),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
