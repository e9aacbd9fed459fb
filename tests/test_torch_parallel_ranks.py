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


# ---- fsdp x tp --------------------------------------------------------


def tp_comm(joined, x: np.ndarray) -> dict:
    """``comm.copy_to``, ``reduce_from``, ``reduce_scatter`` and
    ``all_gather_cat`` over the world on ``x[rank]``, with the gradients
    of ``sum(op(x) * wy)``, ``wy = arange(y.numel()) * (rank + 1)``."""
    group = comm.world()
    rank = joined.rank
    out = {}
    for name, op in (("copy_to", lambda t: comm.copy_to(t, group)),
                     ("reduce_from", lambda t: comm.reduce_from(t, group)),
                     ("reduce_scatter_0",
                      lambda t: comm.reduce_scatter(t, group, 0)),
                     ("reduce_scatter_1",
                      lambda t: comm.reduce_scatter(t, group, 1)),
                     ("all_gather_cat_1",
                      lambda t: comm.all_gather_cat(t, group, 1))):
        t = torch.tensor(x[rank]).requires_grad_()
        y = op(t)
        wy = torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape) * (
            rank + 1)
        (grad,) = torch.autograd.grad((y * wy).sum(), t)
        out[name] = (_np(y), _np(grad), _np(wy))
    # bf16 through gloo: a reduce of one row and zeros is exact
    b = torch.tensor(x[rank]).bfloat16() * (rank == 2)
    out["bf16_reduce"] = _np(comm.reduce_from(b, group))
    return out


def _mesh_view(mesh) -> dict:
    return {"shape": mesh.shape, "coords": mesh.coords}


def sharded_train(joined, params, cfg_kwargs, tokens, cases) -> dict:
    """Each case: a mesh plan, the loss's vocab chunk, ``accum`` and
    ``fsdp``; the first step's loss and summed gradients
    (``step.value_and_grad``), then ``steps`` AdamW steps' losses and
    the weight blocks, each by parameter name, and the mesh."""
    out = {}
    for name, case in cases.items():
        cfg = tllama.LlamaConfig(**cfg_kwargs)
        model = llama_from_jax(params, cfg, device="cpu", trainable=True)
        mesh = make_mesh(MeshPlan(**case["plan"]))
        chunk = case.get("vocab_chunk", 0)
        sp_impl = case.get("sp_impl")
        if sp_impl:
            loss_fn = tllama.make_llama_sp_loss(cfg, mesh, impl=sp_impl)
        else:
            def loss_fn(m, t, chunk=chunk):
                return tllama.llama_loss(m, t, vocab_chunk=chunk)
        step, model, _ = make_sharded_train_step(
            loss_fn, model, mesh, learning_rate=case["lr"],
            fsdp=case.get("fsdp", True), accum_steps=case.get("accum", 1))
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        batch = torch.tensor(tokens)
        loss0, grads = step.value_and_grad(batch)
        losses = [float(step(batch)) for _ in range(case["steps"])]
        out[name] = {
            "loss0": float(loss0),
            "grads": {n: _np(g) for n, g in zip(names, grads)},
            "losses": losses,
            "params": {n: _np(p) for n, p in model.named_parameters()},
            "mesh": _mesh_view(mesh),
            "tp": None if model.shards is None else model.shards.tp,
            "fsdp_dims": (None if model.shards is None
                          else dict(model.shards.fsdp_dims)),
        }
    return out


def fsdp_tp_cases(joined, x, params, cfg_kwargs, tokens, cases) -> dict:
    """``tp_comm`` and ``sharded_train`` in one world."""
    return {"comm": tp_comm(joined, x),
            "train": sharded_train(joined, params, cfg_kwargs, tokens,
                                   cases)}


# ---- the pipeline -----------------------------------------------------


def _dense_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_cases(joined, cases, llama) -> dict:
    """Each dense case: the pipeline's output over its mesh, and with
    ``grads`` the gradients of ``mean(y ** 2)`` for this rank's stage
    block (remat on and off); then the Llama trunk over pp = 4 and the
    gradients of ``sum(hidden * g)`` for this rank's block of layers."""
    from kubeshare_tpu_torch.models.convert import (
        stacked_layers_from_jax, stacked_layers_to_jax,
    )
    from kubeshare_tpu_torch.parallel import (
        pipeline_apply, shard_stacked_params,
    )

    out = {}
    for name, case in cases.items():
        mesh = make_mesh(MeshPlan(**case["plan"]))
        stacked = {k: torch.tensor(v, requires_grad=True)
                   for k, v in case["stacked"].items()}
        block = shard_stacked_params(stacked, mesh)
        x = torch.tensor(case["x"])
        doc = {"first": block.first, "num_stages": block.num_stages}
        for remat in ((True, False) if case.get("grads") else (True,)):
            y = pipeline_apply(_dense_stage, block, x, case["mb"], mesh,
                               remat=remat)
            doc[f"y_{remat}"] = _np(y)
            if case.get("grads"):
                loss = torch.mean(y ** 2)
                grads = torch.autograd.grad(loss, list(block.values()))
                doc[f"loss_{remat}"] = float(loss)
                doc[f"grads_{remat}"] = {k: _np(g) for k, g
                                         in zip(block, grads)}
        # the whole stack, cut by pipeline_apply itself
        doc["y_whole_stack"] = _np(pipeline_apply(
            _dense_stage, {k: v.detach() for k, v in stacked.items()}, x,
            case["mb"], mesh))
        out[name] = doc
    cfg = tllama.LlamaConfig(**llama["cfg"])
    model = llama_from_jax(llama["params"], cfg, device="cpu")
    mesh = make_mesh(MeshPlan(pp=4))
    block = shard_stacked_params(
        stacked_layers_from_jax(llama["stacked"], device="cpu",
                                requires_grad=True), mesh)
    hidden = tllama.llama_pipeline_hidden(
        model, torch.tensor(llama["tokens"]), mesh, 2, stacked_layers=block)
    (hidden * torch.tensor(llama["g"])).sum().backward()
    out["llama"] = {"hidden": _np(hidden), "first": block.first,
                    "grads": stacked_layers_to_jax(block, grads=True)}
    return out


# ---- MoE --------------------------------------------------------------


def moe_cases(joined, params, x, g, cfg_kwargs, plans) -> dict:
    """For each mesh plan: MoE's y and aux on this rank's experts, and
    the gradients of ``sum(y * g) + aux`` for x and this rank's weight
    blocks (the reference's layout, the blocks the test cuts)."""
    from kubeshare_tpu_torch.models.convert import moe_from_jax, moe_to_jax
    from kubeshare_tpu_torch.models.moe import (
        MoeConfig, moe_ffn_apply, moe_param_spec,
    )
    from kubeshare_tpu_torch.parallel import shard_tensor

    cfg = MoeConfig(**cfg_kwargs)
    out = {}
    for name, plan in plans.items():
        mesh = make_mesh(MeshPlan(**plan))
        specs = moe_param_spec()
        local = {k: shard_tensor(v, specs[k], mesh).requires_grad_()
                 for k, v in moe_from_jax(params, device="cpu").items()}
        xt = torch.tensor(x, requires_grad=True)
        y, aux = moe_ffn_apply(local, xt, cfg, mesh)
        ((y * torch.tensor(g)).sum() + aux).backward()
        out[name] = {"y": _np(y), "aux": float(aux), "dx": _np(xt.grad),
                     "grads": moe_to_jax({k: v.grad
                                          for k, v in local.items()}),
                     "mesh": _mesh_view(mesh)}
    return out


# ---- elastic ----------------------------------------------------------


class TwoLayer(torch.nn.Module):
    """The reference's elastic test model: tanh(x @ w1) @ w2."""

    def __init__(self, w1, w2):
        super().__init__()
        self.w1 = torch.nn.Parameter(torch.tensor(w1))
        self.w2 = torch.nn.Parameter(torch.tensor(w2))


def two_layer_loss(model, x, y):
    pred = torch.tanh(x @ model.w1) @ model.w2
    return torch.mean((pred - y) ** 2)


def elastic_cases(joined, w1, w2, x, y, x8, y8, lr) -> dict:
    """A trainer over the world's 4 ranks: 3 steps, resized to ranks
    [0, 1], 3 steps, back to all 4, 3 steps; then one over rank 0 alone
    and one over all 4 on the same 2 steps; and a batch that does not
    divide."""
    from kubeshare_tpu_torch.parallel import ElasticTrainer

    batch = (torch.tensor(x), torch.tensor(y))
    out = {"losses": [], "generation": [], "dp": [], "steps": []}
    trainer = ElasticTrainer(two_layer_loss, TwoLayer(w1, w2),
                             learning_rate=lr)
    for ranks in (None, [0, 1], [0, 1, 2, 3]):
        if ranks is not None:
            trainer.resize(ranks)
        out["generation"].append(trainer.generation)
        out["dp"].append(trainer.dp)
        for _ in range(3):
            loss = trainer.step(batch)
            out["losses"].append(None if loss is None else float(loss))
        out["steps"].append(trainer.steps)
    out["params"] = {k: _np(v) for k, v in trainer.model.named_parameters()}
    batch8 = (torch.tensor(x8), torch.tensor(y8))
    one = ElasticTrainer(two_layer_loss, TwoLayer(w1, w2),
                         learning_rate=lr, ranks=[0])
    four = ElasticTrainer(two_layer_loss, TwoLayer(w1, w2),
                          learning_rate=lr)
    out["one"], out["four"] = [], []
    for _ in range(2):
        loss = one.step(batch8)
        out["one"].append(None if loss is None else float(loss))
        out["four"].append(float(four.step(batch8)))
    try:
        four.step((batch8[0][:6], batch8[1][:6]))
        out["bad_batch"] = None
    except ValueError as err:
        out["bad_batch"] = str(err)
    return out
