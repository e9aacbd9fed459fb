"""Rank functions of the parallel tests (test_torch_parallel.py,
test_torch_sp.py, test_torch_dp.py and test_torch_comm_cuda.py).

``parallel.launch.run_world`` spawns each rank as a new process, which
imports the function it runs by its module's name. They live here, in a
module that imports torch and the port only, so that a rank does not
import jax. Each takes the rank's ``Joined`` and numpy inputs and
returns numpy results; the test files hold them against the reference.
The file holds no test.
"""

import numpy as np
import torch
import torch.distributed as dist

from kubeshare_tpu_torch.models import llama as tllama
from kubeshare_tpu_torch.models.convert import llama_from_jax, llama_to_jax
from kubeshare_tpu_torch.parallel import (
    MeshPlan, comm, hybrid_mesh, make_mesh, make_ring_attention,
    make_sharded_train_step, make_ulysses_attention, ring_attention_with_lse,
)


def _np(t):
    return t.detach().float().cpu().numpy()


def _shard(x: np.ndarray, rank: int, n: int, dim: int = 2) -> np.ndarray:
    size = x.shape[dim] // n
    index = [slice(None)] * x.ndim
    index[dim] = slice(rank * size, (rank + 1) * size)
    return x[tuple(index)]


# ---- mesh and collectives ---------------------------------------------


def mesh_and_comm(joined, x: np.ndarray, w: np.ndarray) -> dict:
    """The mesh of a 4-rank world and every collective of ``comm`` on
    rank-dependent inputs ``x[rank]``, with the gradients of
    ``sum(op(x) * w[rank])``."""
    out = {"backend": joined.backend, "device": str(joined.device)}
    mesh = make_mesh(MeshPlan(dp=2, sp=2))
    out["coords"] = mesh.coords
    for axis in ("sp", "dp"):
        out[f"{axis}_ranks"] = dist.get_process_group_ranks(mesh.group(axis))
    out["sp_group_size"] = comm.group_size(mesh.group("sp"))
    out["tp_group"] = mesh.group("tp")
    for name, make in (("too_big", lambda: make_mesh(MeshPlan(dp=8))),
                       ("hybrid_bad", lambda: hybrid_mesh(MeshPlan(dp=2)))):
        try:
            make()
            out[name] = None
        except ValueError as err:
            out[name] = str(err)
    out["hybrid"] = hybrid_mesh().shape
    group = make_mesh(MeshPlan(sp=4)).group("sp")
    rank = joined.rank
    mine = torch.tensor(x[rank], device=joined.device)
    weight = torch.tensor(w[rank], device=joined.device)
    comm.reset_stats()
    ops = {
        "ppermute_1": lambda t: comm.ppermute(t, group, 1),
        "ppermute_-1": lambda t: comm.ppermute(t, group, -1),
        "ppermute_2": lambda t: comm.ppermute(t, group, 2),
        "all_to_all_0_1": lambda t: comm.all_to_all(t, group, 0, 1),
        "all_to_all_1_0": lambda t: comm.all_to_all(t, group, 1, 0),
        "all_reduce": lambda t: comm.all_reduce(t, group),
        "all_gather": lambda t: comm.all_gather(t, group),
    }
    for name, op in ops.items():
        t = mine.clone().requires_grad_()
        y = op(t)
        wy = weight if y.shape == weight.shape else (
            torch.arange(y.numel(), dtype=y.dtype, device=y.device)
            .reshape(y.shape) * (rank + 1))
        (grad,) = torch.autograd.grad((y * wy).sum(), t)
        out[name] = (_np(y), _np(grad), _np(wy))
    out["stats"] = comm.stats()
    b = mine.clone()
    comm.broadcast_(b, 2, group)
    out["broadcast_from_2"] = _np(b)
    m = mine.clone()
    comm.all_reduce_(m, group, op="max")
    out["max"] = _np(m)
    return out


def fail_on_rank_one(joined):
    if joined.rank == 1:
        raise RuntimeError("rank one fails")
    return joined.rank


# ---- ring and Ulysses attention --------------------------------------


def attention_cases(joined, cases: dict, arrays: dict) -> dict:
    """Each case's output shard and the gradients of
    ``sum(out * g)`` for this rank's shards; for a ring case also the
    rows' lse from ``ring_attention_with_lse``, which must give the
    same output."""
    n, rank = joined.world, joined.rank
    mesh = make_mesh(MeshPlan(sp=n))
    makers = {"ring": make_ring_attention, "ulysses": make_ulysses_attention}
    out = {}
    for name, case in cases.items():
        q, k, v, g = (torch.tensor(_shard(a, rank, n)).requires_grad_()
                      for a in arrays[name])
        fn = makers[case["impl"]](mesh, causal=case["causal"],
                                  use_flash=case["flash"],
                                  window=case["window"])
        o = fn(q, k, v)
        grads = torch.autograd.grad(o, (q, k, v), g.detach())
        out[name] = [_np(o)] + [_np(t) for t in grads]
        if case["impl"] == "ring":
            with torch.no_grad():
                o_lse, lse = ring_attention_with_lse(
                    q, k, v, mesh.group("sp"), case["causal"],
                    case["flash"], case["window"])
            out[name] += [_np(lse), bool(torch.equal(o_lse, o))]
    return out


def sp_loss_cases(joined, params: dict, cfg_kwargs: dict, tokens: np.ndarray,
                  cases: dict) -> dict:
    """Each case's partial loss and gradient tree (the reference's
    layout) of ``make_llama_sp_loss`` on this rank."""
    mesh = make_mesh(MeshPlan(sp=joined.world))
    out = {}
    for name, case in cases.items():
        cfg = tllama.LlamaConfig(**{**cfg_kwargs, "window": case["window"]})
        model = llama_from_jax(params, cfg, device="cpu", trainable=True)
        loss_fn = tllama.make_llama_sp_loss(
            cfg, mesh, impl=case["impl"], use_flash=case["flash"],
            vocab_chunk=case["vocab_chunk"])
        loss = loss_fn(model, torch.tensor(tokens))
        loss.backward()
        out[name] = (float(loss), llama_to_jax(model, grads=True))
    return out


def sp_cases(joined, attention: dict, arrays: dict, params: dict,
             cfg_kwargs: dict, tokens: np.ndarray, losses: dict) -> dict:
    """``attention_cases`` and ``sp_loss_cases`` in one world."""
    return {"attention": attention_cases(joined, attention, arrays),
            "loss": sp_loss_cases(joined, params, cfg_kwargs, tokens,
                                  losses)}


# ---- the train step --------------------------------------------------


def _train(joined, params, cfg_kwargs, tokens, plan, steps, lr, accum=1,
           sp_impl=None):
    cfg = tllama.LlamaConfig(**cfg_kwargs)
    model = llama_from_jax(params, cfg, device="cpu", trainable=True)
    mesh = make_mesh(plan)
    if sp_impl:
        loss_fn = tllama.make_llama_sp_loss(cfg, mesh, impl=sp_impl)
    else:
        def loss_fn(m, t):
            return tllama.llama_loss(m, t)
    step, model, _ = make_sharded_train_step(loss_fn, model, mesh,
                                             learning_rate=lr, fsdp=False,
                                             accum_steps=accum)
    losses = [float(step(torch.tensor(tokens))) for _ in range(steps)]
    return losses, llama_to_jax(model)


def dp_train(joined, params, cfg_kwargs, tokens, steps, lr) -> dict:
    """dp over the world: ``steps`` AdamW steps, and the same with two
    accumulation microbatches."""
    plan = MeshPlan(dp=joined.world)
    return {"plain": _train(joined, params, cfg_kwargs, tokens, plan, steps,
                            lr),
            "accum": _train(joined, params, cfg_kwargs, tokens, plan, steps,
                            lr, accum=2),
            "backend": joined.backend}


def sp_dp_train(joined, params, cfg_kwargs, tokens, steps, lr) -> dict:
    """A dp=2 x sp=2 mesh: ``steps`` AdamW steps of the ring sp loss."""
    return {"sp_dp": _train(joined, params, cfg_kwargs, tokens,
                            MeshPlan(dp=2, sp=2), steps, lr,
                            sp_impl="ring")}


# ---- on the card ------------------------------------------------------


def comm_on_card(joined, x: np.ndarray) -> dict:
    """``comm``'s collectives on CUDA tensors of ranks that share one
    card, their gradients, and what was staged."""
    group = make_mesh(MeshPlan(sp=joined.world)).group("sp")
    t = torch.tensor(x[joined.rank], device=joined.device)
    comm.reset_stats()
    out = {"backend": joined.backend, "device": str(joined.device)}
    for name, op in (("ppermute", lambda a: comm.ppermute(a, group, 1)),
                     ("all_to_all", lambda a: comm.all_to_all(a, group, 0,
                                                               1)),
                     ("all_reduce", lambda a: comm.all_reduce(a, group)),
                     ("all_gather", lambda a: comm.all_gather(a, group))):
        a = t.clone().requires_grad_()
        y = op(a)
        (grad,) = torch.autograd.grad(y.sum(), a)
        out[name] = (_np(y), _np(grad), y.device.type)
    b = t.clone()
    comm.broadcast_(b, 1, group)
    out["broadcast"] = _np(b)
    torch.cuda.synchronize()
    out["stats"] = comm.stats()
    return out
