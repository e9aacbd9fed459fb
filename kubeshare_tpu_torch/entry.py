"""The flagship forward and the multi-device dry run (counterparts of
``__graft_entry__.entry()`` and ``__graft_entry__.dryrun_multichip``).

    from kubeshare_tpu_torch.entry import entry, dryrun_multichip
    forward, (model, tokens) = entry()     # on cuda; entry("cpu") on a CPU
    logits = forward(model, tokens)         # [2, 128, 2048] float32
    dryrun_multichip(4)                     # 4 rank processes; or device="cpu"

The reference's own small Llama (vocab 2048, dim 256, 4 layers, 8 heads
and 4 kv heads: head dim 32; mlp 512, max_seq_len 512, bf16) with random
weights from seed 0, and its example batch, zeros [2, 128]. ``forward``
is ``llama_apply``: on the card each layer's attention runs the flash
forward kernel once (``ops/attention.py::mha``). The reference returns a
jittable function and its parameter tree; here the model is an
``nn.Module`` and PyTorch runs eagerly.

``dryrun_multichip(n)`` runs the reference's legs, at its configs and
with its bounds, in a world of n rank processes (one device each, as a
device of the reference's mesh; ranks that share one card run on gloo):
the sharded train step on ``factorize_devices(n, tp_max=2,
fsdp_max=2)`` (dp x fsdp x tp), ring and Ulysses attention over sp = n,
the sequence-parallel Llama loss, the pipeline trunk over pp = 4 with
twice as many layers, and MoE over ep = 4; then the cross-process leg:
4 processes brought up through the gang env (``JAX_COORDINATOR_ADDRESS``,
``KUBESHARE_GROUP_HEADCOUNT``, ``KUBESHARE_PROCESS_ID`` ->
``multihost.maybe_initialize``) train one dp 2 x tp 2 step (a port
process drives one device, where each of the reference's two drove 4).
It prints the reference's tail line, ``crossproc=ok|failed|skipped``
among it, and raises when the cross-process leg failed twice. The
reference's dry-run configs have head dims 16 and 8, which the flash
kernels are not built for; its ``mha`` runs plain attention there on
every backend (flash only from T 128 on tiled shapes), so these legs
pass ``use_flash=False`` and the tail line says so.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import tempfile
from typing import Callable, Tuple

import torch

from .models.llama import Llama, LlamaConfig, init_llama, llama_apply
from .utils.device import DeviceLike, resolve_device

# __graft_entry__.py's config
ENTRY_CONFIG = LlamaConfig(vocab=2048, dim=256, layers=4, num_heads=8,
                           num_kv_heads=4, mlp_dim=512, max_seq_len=512)
ENTRY_TOKENS = (2, 128)


def entry(device: DeviceLike = None) -> Tuple[Callable, Tuple[Llama,
                                                              torch.Tensor]]:
    """``(llama_apply, (model, tokens))`` on ``device`` (default: the
    first CUDA device; no CUDA device raises unless ``device="cpu"``)."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(0)
    model = init_llama(ENTRY_CONFIG, generator=generator, device=device)
    tokens = torch.zeros(ENTRY_TOKENS, dtype=torch.long, device=device)
    return llama_apply, (model, tokens)


# __graft_entry__.dryrun_multichip's configs
DRYRUN_CONFIG = LlamaConfig(vocab=256, dim=64, layers=2, num_heads=4,
                            num_kv_heads=2, mlp_dim=128, max_seq_len=64)
SP_CONFIG = dict(vocab=64, dim=32, layers=1, num_heads=4, num_kv_heads=2,
                 mlp_dim=64, dtype="float32")
PP_CONFIG = dict(vocab=64, dim=32, num_heads=4, num_kv_heads=2, mlp_dim=64,
                 max_seq_len=16, dtype="float32")
CROSSPROC_PROCESSES = 4
ATTENTION_TOL = 5e-3
SP_LOSS_TOL = 1e-4
PIPELINE_TOL = 5e-5


def _gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _max_over_world(value: float, device: torch.device) -> float:
    from .parallel import comm

    t = torch.tensor([value], device=device)
    return float(comm.all_reduce_(t, comm.world(), op="max"))


def _dryrun_rank(joined) -> dict:
    """One rank of ``dryrun_multichip``'s world: every in-process leg."""
    from .models.llama import (
        llama_hidden, llama_loss, llama_pipeline_hidden, llama_stack_layers,
        make_llama_sp_loss,
    )
    from .models.moe import (
        MoeConfig, init_moe_ffn, moe_ffn_apply, moe_param_spec,
    )
    from .ops.attention import attention
    from .parallel import (
        MeshPlan, comm, factorize_devices, make_mesh,
        make_ring_attention, make_sharded_train_step, make_ulysses_attention,
        shard_stacked_params, shard_tensor,
    )

    n, rank, device = joined.world, joined.rank, joined.device
    out = {}
    # the sharded train step: dp x fsdp x tp
    plan = factorize_devices(n, tp_max=2, fsdp_max=2)
    out["plan"] = (plan.dp, plan.fsdp, plan.tp)
    mesh = make_mesh(plan)
    model = init_llama(DRYRUN_CONFIG, generator=_gen(device, 0),
                       device=device, trainable=True)
    step, model, _ = make_sharded_train_step(
        lambda m, b: llama_loss(m, b, use_flash=False), model, mesh,
        learning_rate=1e-3)
    batch = torch.randint(0, DRYRUN_CONFIG.vocab,
                          (2 * plan.dp * plan.fsdp, 17),
                          generator=_gen(device, 1), device=device)
    out["loss"] = float(step(batch))
    if not math.isfinite(out["loss"]):
        raise AssertionError(f"dryrun loss not finite: {out['loss']}")
    del model, step

    # sequence parallel: ring and Ulysses attention over sp = n
    sp_mesh = make_mesh(MeshPlan(sp=n))
    b, h, t, d = 1, 2, 8 * n, 16
    gen = _gen(device, 2)
    q, k, v = (torch.randn(b, h, t, d, generator=gen, device=device)
               for _ in range(3))
    lo, hi = rank * 8, (rank + 1) * 8
    ring = make_ring_attention(sp_mesh, causal=True, use_flash=False)
    with torch.no_grad():
        got = ring(q[:, :, lo:hi], k[:, :, lo:hi], v[:, :, lo:hi])
        want = attention(q, k, v, causal=True)[:, :, lo:hi]
        out["ring_err"] = _max_over_world(
            (got - want).abs().max().item(), device)
        qu = torch.randn(b, n, t, d, generator=_gen(device, 3),
                         device=device)
        uly = make_ulysses_attention(sp_mesh, causal=True, use_flash=False)
        shard = qu[:, :, lo:hi]
        got = uly(shard, shard, shard)
        want = attention(qu, qu, qu, causal=True)[:, :, lo:hi]
        out["ulysses_err"] = _max_over_world(
            (got - want).abs().max().item(), device)
    for name in ("ring_err", "ulysses_err"):
        if not out[name] < ATTENTION_TOL:
            raise AssertionError(f"{name} {out[name]}")

    # the sequence-parallel Llama loss against llama_loss
    sp_cfg = LlamaConfig(max_seq_len=8 * n, **SP_CONFIG)
    sp_model = init_llama(sp_cfg, generator=_gen(device, 7), device=device)
    sp_tokens = torch.randint(0, sp_cfg.vocab, (2, 8 * n + 1),
                              generator=_gen(device, 8), device=device)
    with torch.no_grad():
        partial = make_llama_sp_loss(sp_cfg, sp_mesh, use_flash=False)(
            sp_model, sp_tokens)
        sp_val = float(comm.all_reduce_(partial.float().reshape(1),
                                        comm.world()))
        sp_ref = float(llama_loss(sp_model, sp_tokens, use_flash=False))
    out["sp_err"] = abs(sp_val - sp_ref)
    if not out["sp_err"] < SP_LOSS_TOL:
        raise AssertionError(f"sp llama loss mismatch: {sp_val} vs {sp_ref}")

    # the pipeline trunk: pp = 4 with twice as many layers
    pp = next(s for s in (4, 2, 1) if n % s == 0)
    out["pp"] = pp
    pp_mesh = make_mesh(MeshPlan(pp=pp, dp=n // pp))
    pcfg = LlamaConfig(layers=2 * pp, **PP_CONFIG)
    pmodel = init_llama(pcfg, generator=_gen(device, 3), device=device)
    ptokens = torch.randint(0, pcfg.vocab, (4, 16),
                            generator=_gen(device, 4), device=device)
    with torch.no_grad():
        stacked = shard_stacked_params(llama_stack_layers(pmodel), pp_mesh)
        ypp = llama_pipeline_hidden(pmodel, ptokens, pp_mesh, 2,
                                    use_flash=False, stacked_layers=stacked)
        yref = llama_hidden(pmodel, ptokens, use_flash=False)
    out["pp_err"] = _max_over_world((ypp - yref).abs().max().item(), device)
    if not out["pp_err"] < PIPELINE_TOL:
        raise AssertionError(f"pipeline mismatch: {out['pp_err']}")

    # expert parallel: MoE over ep = 4
    ep = pp
    out["ep"] = ep
    ep_mesh = make_mesh(MeshPlan(ep=ep, dp=n // ep))
    moe_cfg = MoeConfig(dim=16, mlp_dim=32, experts=ep, top_k=2,
                        dtype="float32")
    specs = moe_param_spec()
    moe_params = {name: shard_tensor(w, specs[name], ep_mesh) for name, w
                  in init_moe_ffn(moe_cfg, _gen(device, 5), device).items()}
    xmoe = torch.randn(2, 8, 16, generator=_gen(device, 6), device=device)
    with torch.no_grad():
        _, aux = moe_ffn_apply(moe_params, xmoe, moe_cfg, ep_mesh)
    out["aux"] = float(aux)
    if not math.isfinite(out["aux"]):
        raise AssertionError("moe aux loss not finite")
    return out


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> None:
    """Run the reference's multi-device legs over ``n_devices`` rank
    processes (module docstring) on ``device``'s kind (default CUDA;
    ``device="cpu"`` runs them on the CPU), print the tail line, and
    raise if a leg failed."""
    from .parallel.launch import run_world

    device_type = resolve_device(device).type
    r = run_world(_dryrun_rank, n_devices, device_type=device_type,
                  timeout=600)[0]
    status, xp = _crossproc_status(device_type)
    dp, fsdp, tp = r["plan"]
    print(
        f"dryrun_multichip({n_devices}): mesh dp={dp} fsdp={fsdp} tp={tp} "
        f"loss={r['loss']:.4f}; ring-attention sp={n_devices} "
        f"max_err={r['ring_err']:.2e}; ulysses sp={n_devices} "
        f"max_err={r['ulysses_err']:.2e}; llama-sp-loss sp={n_devices} "
        f"err={r['sp_err']:.2e}; pipeline pp={r['pp']} "
        f"max_err={r['pp_err']:.2e}; moe ep={r['ep']} aux={r['aux']:.3f}; "
        f"use_flash=False (head dims 16 and 8: plain attention, as the "
        f"reference's mha); crossproc={status} "
        f"{CROSSPROC_PROCESSES}-process {xp}", flush=True)
    _enforce_crossproc(status, xp)


def _crossproc_status(device_type: str = "cuda"):
    """Run the cross-process leg with one retry. Returns ``(status,
    detail)``, status the tail's token ``ok`` / ``failed`` /
    ``skipped``. Never raises (KeyboardInterrupt and SystemExit
    excepted): the caller prints the tail first, then
    ``_enforce_crossproc`` turns a failure into an exception."""
    if os.environ.get("KUBESHARE_DRYRUN_CROSSPROC", "1") == "0":
        return "skipped", "skipped by env"
    last = None
    for attempt in (1, 2):
        try:
            return "ok", _crossprocess_leg(device_type)
        except Exception as e:  # noqa: BLE001 - reported in the tail
            last = f"attempt {attempt}: {type(e).__name__}: {e}"
            print(f"crossproc leg failed ({last})"
                  + ("; retrying once" if attempt == 1 else ""), flush=True)
    return "failed", last


def _enforce_crossproc(status: str, detail: str) -> None:
    """After the tail is printed, a failed cross-process leg raises."""
    if status == "failed":
        raise RuntimeError(f"cross-process leg failed after retry: {detail}")


_CROSSPROC_CHILD = r"""
import json, os
import numpy as np
import torch
from kubeshare_tpu_torch.models.llama import LlamaConfig, init_llama, llama_loss
from kubeshare_tpu_torch.parallel import (
    MeshPlan, comm, make_mesh, make_sharded_train_step, maybe_initialize)

got = maybe_initialize(device_type=os.environ["KS_DRYRUN_DEVICE"])
assert got is not None, "gang env missing"
spec, joined = got
world = comm.world()
gathered = comm.all_gather(
    torch.tensor([float(spec.process_id)], device=joined.device), world)
mesh = make_mesh(MeshPlan(dp=2, tp=2))
cfg = LlamaConfig(vocab=64, dim=32, layers=1, num_heads=4, num_kv_heads=2,
                  mlp_dim=64, max_seq_len=16, dtype="float32")
model = init_llama(cfg, generator=torch.Generator(device=joined.device)
                   .manual_seed(0), device=joined.device, trainable=True)
step, model, _ = make_sharded_train_step(
    lambda m, b: llama_loss(m, b, use_flash=False), model, mesh,
    learning_rate=1e-3, fsdp=False)
full = np.random.RandomState(5).randint(0, cfg.vocab, size=(4, 9))
lo = 2 * mesh.coords["dp"]          # this member draws its dp block only
loss = float(step.local(torch.tensor(full[lo:lo + 2], device=joined.device)))
comm.barrier(world)
json.dump({"process_id": spec.process_id, "devices": joined.world,
           "backend": joined.backend,
           "gathered": gathered.cpu().ravel().tolist(),
           "mesh": mesh.shape, "loss": loss},
          open(os.environ["KS_DRYRUN_OUT"], "w"))
comm.destroy()
"""


def _crossprocess_leg(device_type: str) -> str:
    """4 OS processes, one device each: join a world through the gang
    env contract, lay dp 2 x tp 2 over it, run one sharded flagship step
    on a dp-split global batch, and all-gather the process ids. Returns
    the tail's fragment."""
    if os.environ.get("KS_DRYRUN_FORCE_CROSSPROC_FAIL") == "1":
        # test hook: a forced failure cannot yield a clean tail
        raise AssertionError("forced failure (KS_DRYRUN_FORCE_CROSSPROC_FAIL)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, outs = [], []
    with tempfile.TemporaryDirectory(prefix="ksdryrun-") as tmp:
        try:
            for pid in range(CROSSPROC_PROCESSES):
                outs.append(os.path.join(tmp, f"worker{pid}.json"))
                env = {k: v for k, v in os.environ.items()
                       if not k.startswith("KUBESHARE_")}
                env.update({
                    "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                    "KUBESHARE_GROUP_HEADCOUNT": str(CROSSPROC_PROCESSES),
                    "KUBESHARE_PROCESS_ID": str(pid),
                    "KS_DRYRUN_DEVICE": device_type,
                    "KS_DRYRUN_OUT": outs[-1],
                    "OMP_NUM_THREADS": "1",
                    "PYTHONPATH": root + os.pathsep + os.environ.get(
                        "PYTHONPATH", ""),
                })
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _CROSSPROC_CHILD], env=env,
                    cwd=root, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT))
            results = []
            for pid, proc in enumerate(procs):
                try:
                    stdout, _ = proc.communicate(timeout=300)
                except subprocess.TimeoutExpired:
                    raise AssertionError(
                        f"cross-process dryrun worker {pid} timed out")
                if proc.returncode != 0:
                    raise AssertionError(
                        f"cross-process dryrun worker {pid} failed:\n"
                        + stdout.decode(errors="replace")[-2000:])
                with open(outs[pid]) as f:
                    results.append(json.load(f))
        finally:
            # one worker failing must not orphan its peers in a collective
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    ids = [float(i) for i in range(CROSSPROC_PROCESSES)]
    for r in results:
        if (r["devices"] != CROSSPROC_PROCESSES or r["gathered"] != ids
                or r["mesh"]["dp"] != 2 or r["mesh"]["tp"] != 2):
            raise AssertionError(f"cross-process worker: {r}")
    losses = {r["loss"] for r in results}
    if len(losses) != 1 or not math.isfinite(results[0]["loss"]):
        raise AssertionError(f"cross-process losses differ: {results}")
    return (f"dp=2xtp=2 over torch.distributed ({results[0]['backend']}): "
            f"allgather {results[0]['gathered']} "
            f"loss={results[0]['loss']:.4f}")
