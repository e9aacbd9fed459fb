"""Containerized training workload entrypoint (port of
``kubeshare_tpu/cmd/workload.py``).

    python -m kubeshare_tpu_torch.cmd.workload --model mnist [--device cpu]

Trains a named model (``mnist``, ``cifar``, ``resnet``, ``vgg``,
``lstm`` or ``llama``) on synthetic data under the shared-device gate.
The gate reads the scheduler-injected env (KUBESHARE_POD_MANAGER_PORT /
KUBESHARE_HBM_LIMIT_BYTES) and amortizes token holds across steps; on a
whole-device or dev run it is a no-op. Prints one JSON line of
throughput stats at exit, with the reference's keys.

A gang pod (the gang env: ``JAX_COORDINATOR_ADDRESS`` and a process
count of at least 2, ``parallel/multihost.py``) joins the gang's world
before any CUDA work and trains data-parallel: each process draws its
own block of the global batch from (seed, process id), the gradients
are summed over the gang (``parallel/train.py``, AdamW), the duration
stop is a collective decision, the throughput printed is the gang's,
and process 0 writes the checkpoints while the others wait for it.

``--sp N`` (llama) trains one sequence sharded over N ranks: the
reference runs them on N local devices of one process; here N rank
processes are spawned, rank r on ``cuda:(r % device_count())``, ring or
Ulysses attention inside the trunk (``make_llama_sp_loss``), and rank 0
holds the pod's gate around each step and prints the JSON line.

Differences from the reference:
- ``--device`` (default ``cuda``) takes the place of ``JAX_PLATFORMS``;
  without a CUDA device the command fails unless given ``--device cpu``.
- Images are NCHW. The batch of global step n is drawn from a generator
  seeded with (seed + 1, n) and, in a gang, the process id, so a
  resumed run sees the batches an uninterrupted run would have seen
  (the reference restarts its data key on resume).
- The warm-up before the timed loop runs one forward and backward and
  discards them: the update is in place here, and a warm-up update
  would be a step the counter never records.
- A gang's checkpoint is written by process 0 alone (the reference's
  processes each write their shards of one checkpoint).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import torch

from ..constants import (  # noqa: F401 - the gang env, for callers
    ENV_COORDINATOR, ENV_GANG_HEADCOUNT, ENV_NUM_PROCESSES,
)
from .common import add_common_flags, component_logger


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
        help="shard the llama sequence over N ranks, spawned here, ring "
             "or Ulysses attention inside the trunk (0 = off); "
             "single-pod only: in a gang, dp spans the processes",
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


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy over integer labels, in the logits'
    dtype, as ``optax.softmax_cross_entropy_with_integer_labels(...)
    .mean()`` computes it."""
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


IMAGE_SHAPES = {"mnist": (1, 28), "cifar": (3, 32), "resnet": (3, 32),
                "vgg": (3, 32)}


def check_flags(model: str, sp: int = 0, sp_impl: str = "ring",
                sp_flash: bool = False, remat: bool = False,
                window: int = 0, seq_len: int = 256) -> None:
    """The reference's refusals of flags that do not apply."""
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
    if sp > 0 and seq_len % sp:
        raise SystemExit(f"--seq-len {seq_len} must divide over --sp {sp}")


def _build(model: str, batch: int, device: torch.device, seed: int,
           seq_len: int = 256, sp: int = 0, sp_impl: str = "ring",
           sp_flash: bool = False, remat: bool = False, window: int = 0,
           mesh=None, process_id: int = 0):
    """(model, loss_fn, batch_at): the model-specific pieces.
    ``batch_at(n)`` is the batch of global step n (this process' block
    of it in a gang). With ``sp > 0`` the llama loss is
    ``make_llama_sp_loss`` over ``mesh``'s sp group and a batch holds
    ``seq_len + 1`` tokens a row. The flags are ``check_flags``'s to
    refuse, before any rank is spawned."""
    from .. import models as M

    gen = torch.Generator(device=device).manual_seed(seed)
    data = torch.Generator(device=device)

    def draw(index: int) -> torch.Generator:
        # a gang process' own stream; process 0's is the single run's
        return data.manual_seed((process_id << 56) ^ (((seed + 1) << 32)
                                                       + index))

    if model in ("llama", "lstm"):
        if model == "llama":
            cfg = M.LlamaConfig(vocab=2048, dim=256, layers=4, num_heads=8,
                                num_kv_heads=4, mlp_dim=512,
                                max_seq_len=seq_len, window=window)
            net = M.init_llama(cfg, generator=gen, device=device,
                               trainable=True)

            if sp > 0:
                loss_fn = M.make_llama_sp_loss(cfg, mesh, impl=sp_impl,
                                               use_flash=sp_flash,
                                               remat=remat)
                # the loss trains on tokens[:, :-1]: seq_len + 1 tokens
                # shard the trained positions evenly
                length = seq_len + 1
            else:
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


def _collective_stop(stop: bool, elapsed: float, world, device
                     ) -> tuple:
    """(any rank's stop, the largest elapsed time) over the world."""
    from ..parallel import comm

    flags = torch.tensor([1.0 if stop else 0.0, elapsed], device=device)
    comm.all_reduce_(flags, world, op="max")
    return bool(flags[0].item()), float(flags[1].item())


def _train(args: argparse.Namespace, log, gate, device: torch.device,
           joined=None, mesh=None) -> Optional[dict]:
    """Build, restore, warm up and run the training loop; returns the
    result document (None on a rank that does not report). ``joined``
    and ``mesh``: this rank's world (a gang: dp over the processes; an
    sp rank: sp over the ranks); None for a single process."""
    from ..models.train import (
        accumulated_value_and_grad, check_accum_batch, make_train_step,
    )
    from ..parallel import comm
    from ..runtime.hook import _block

    gang = joined is not None and not args.sp
    lead = joined is None or joined.rank == 0
    world_group = comm.world()
    model, loss_fn, batch_at = _build(
        args.model, args.batch, device, args.seed, args.seq_len, args.sp,
        args.sp_impl, args.sp_flash, args.remat, args.window, mesh,
        joined.rank if gang else 0)
    if mesh is None:
        opt, step = make_train_step(loss_fn, model, learning_rate=args.lr,
                                    accum_steps=args.accum)
    else:
        from ..parallel import make_sharded_train_step

        sharded, model, opt = make_sharded_train_step(
            loss_fn, model, mesh, learning_rate=args.lr, fsdp=False,
            accum_steps=args.accum)
        # a gang process draws only its own block; an sp rank takes the
        # whole batch and its loss cuts its shard of the sequence
        step = sharded.local
        log.info("rank %d/%d (%s, %s) on mesh %s", joined.rank,
                 joined.world, joined.backend, device, mesh.shape)

    start_step = 0
    if args.checkpoint_dir:
        from ..models.checkpoint import restore_checkpoint, save_checkpoint

        restored = restore_checkpoint(args.checkpoint_dir, model, opt)
        if restored is not None:
            start_step = restored[0]
            log.info("resumed from step %d", start_step)

        def save(at_step: int) -> None:
            # the lead writes; the others wait until the files are there
            if lead:
                save_checkpoint(args.checkpoint_dir, at_step, model, opt)
            comm.barrier(world_group)

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
    if args.profile_dir and lead:
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
    # in a world the stop is collective, at step indices every rank
    # computes alike from the largest elapsed time: one rank leaving on
    # its own clock would leave the others waiting in the next step
    check_next = 0
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
            stop = bool(args.duration
                        and time.perf_counter() - started >= args.duration)
            if world_group is not None and args.duration:
                if steps_done >= check_next:
                    stop, slowest = _collective_stop(
                        stop, time.perf_counter() - started, world_group,
                        device)
                    # about one check per 0.5 s of steps
                    check_next = steps_done + (1 if steps_done == 0 else max(
                        1, min(64, int(0.5 / max(slowest / steps_done,
                                                 1e-6)))))
                else:
                    stop = False
            if stop:
                break
            if feed is not None:
                batch = next(feed)
            else:
                batch = batch_at(start_step + steps_done)
            if gate.client is not None:
                log.debug("step %d: at the gate", steps_done)
            gate.begin()
            log.debug("step %d: stepping (%d leases taken)", steps_done,
                      gate.tokens_acquired)
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
                save(start_step + steps_done)
                last_saved = start_step + steps_done
        gate.flush(result)
        if (
            args.checkpoint_dir
            and steps_done
            and last_saved != start_step + steps_done
        ):
            _block(loss)
            save(start_step + steps_done)
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
    if not lead and not gang:
        return None
    processes = joined.world if gang else 1
    return {
        "model": args.model,
        "steps": steps_done,
        "batch": args.batch,
        "processes": processes,
        "global_batch": args.batch * processes,
        "seconds": round(elapsed, 3),
        # GLOBAL throughput: in a gang every process trains its block
        # of each step's global batch
        "samples_per_s": round(
            steps_done * args.batch * processes / max(elapsed, 1e-9), 1),
        "final_loss": float(loss),
        "tokens_acquired": gate.tokens_acquired,
        "compute_ms": round(gate.compute_ms, 1),
    }


def _sp_rank(joined, argv: Sequence[str]) -> Optional[dict]:
    """One rank of ``--sp N``: the sp mesh over the spawned world; rank
    0 holds the pod's gate and reports."""
    from ..parallel import MeshPlan, make_mesh
    from ..runtime.hook import SharedChipGate, install_gate

    args = _parse(argv)
    log = component_logger(f"workload-sp{joined.rank}", args)
    gate = install_gate() if joined.rank == 0 else SharedChipGate(None)
    mesh = make_mesh(MeshPlan(sp=joined.world))
    return _train(args, log, gate, joined.device, joined, mesh)


def _parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if not args.steps and not args.duration:
        args.steps = 100
    return args


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parse(argv)
    log = component_logger("workload", args)
    check_flags(args.model, args.sp, args.sp_impl, args.sp_flash,
                args.remat, args.window, args.seq_len)

    from ..parallel.multihost import maybe_initialize, spec_from_env
    from ..runtime.hook import install_gate
    from ..utils.device import resolve_device

    in_gang = spec_from_env() is not None
    if args.prefetch > 0 and (in_gang or args.sp):
        # refused before any rank joins: a gang's or an sp world's step
        # is collective, and the feed would run ahead of it
        raise SystemExit(
            "--prefetch is single-process (the gang and --sp paths step "
            "collectively)")
    if in_gang and args.sp:
        raise SystemExit(
            "--sp is single-process (local sequence sharding); in a "
            "gang, leave it off and let dp span the processes")
    device = resolve_device(None if args.device == "cuda" else args.device)
    if args.sp:
        from ..parallel.launch import run_world

        docs = run_world(_sp_rank, args.sp,
                         args=(list(argv) if argv is not None else None,),
                         timeout=None, device_type=device.type)
        print(json.dumps(docs[0]))
        return 0

    # a gang joins its world before any CUDA work (the webhook injects
    # the headcount, the workload spec the coordinator, the Indexed Job
    # or the hostname the ordinal)
    joined = mesh = None
    gang = maybe_initialize(device_type=device.type)
    if gang is not None:
        from ..parallel import hybrid_mesh

        _, joined = gang
        device = joined.device
        mesh = hybrid_mesh()
    gate = install_gate()     # before CUDA allocations: it may cap them
    doc = _train(args, log, gate, device, joined, mesh)
    print(json.dumps(doc))
    if joined is not None:
        from ..parallel import comm

        comm.destroy()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
