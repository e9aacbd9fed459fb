"""The plain reference agrees with the program's CPU path at tiny widths
(float32, so that only the order of sums differs): the served logits
through the KV cache, decode included and the window rolling, and the
training loss, its gradients and three Adam steps."""

import torch

from perfbench.families import dense
from perfbench.lib import check
from perfbench.reference import common, llama_ref
from perfbench.tests import tiny

SPEC = dense.spec("tiny", dict(tiny.TINY, torch_dtype="float32",
                               sliding_window=12))
CPU = torch.device("cpu")


def test_served_logits_match_the_cached_path():
    from kubeshare_tpu_torch.models.llama import (init_kv_cache,
                                                  llama_apply_cached)

    model = dense.build(SPEC, 11, 0, CPU, trainable=False)
    ids = torch.randint(2, SPEC.vocab, (1, 20), generator=torch.Generator()
                        .manual_seed(3))
    cache = init_kv_cache(model.cfg, 1, device=CPU)
    logits, cache = llama_apply_cached(model, ids[:, :8], cache)
    rows = [logits[0]]
    for t in range(8, 20):   # decode past the 12-position window
        step, cache = llama_apply_cached(model, ids[:, t:t + 1], cache)
        rows.append(step[0])
    program = torch.cat(rows)

    def layer(i):
        return dense.block(SPEC, 11, 0, i, torch.float32, CPU)

    want = llama_ref.logits_at(
        SPEC, dense.embedding(SPEC, 11, 0, torch.float32, CPU), layer,
        dense.final_norm(SPEC, CPU),
        dense.head(SPEC, 11, 0, torch.float32, CPU),
        [ids[0]], [torch.arange(20)])[0]
    assert torch.allclose(program, want, atol=2e-4, rtol=1e-4)


def test_training_matches_the_train_step():
    from kubeshare_tpu_torch.models.llama import llama_loss
    from kubeshare_tpu_torch.models.train import make_train_step

    traffic = dict(tiny.TRAIN, seq_len=20)
    model = dense.build(SPEC, 5, 1, CPU, trainable=True)
    opt, step = make_train_step(llama_loss, model,
                                learning_rate=traffic["lr"])
    batches = check.train_batches(traffic, 5, 1, CPU)
    losses = [step(next(batches)).item()]

    class Pod:
        pass

    pod = Pod()
    pod.optimizer = opt
    pod.leaves = lambda: dense.program_leaves(model)
    first = check.program_first_grads(pod)
    losses += [step(next(batches)).item() for _ in range(2)]
    program = {"losses": losses, "first_grad": first,
               "change": check.change_norms(dense, SPEC, 5, 1,
                                            pod.leaves())}
    ref = check.reference_training(dense, SPEC, traffic, 5, 1, CPU)
    numbers = check.train_numbers(program, ref)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["change_gap"] < 1e-3


def test_window_hides_the_oldest_keys():
    q = torch.randn(2, 6, 4)
    k, v = torch.randn(1, 6, 4), torch.randn(1, 6, 4)
    out = llama_ref.attend(q, k, v, window=2)
    v2 = v.clone()
    v2[:, 0] += 100.0   # position 0 is outside every window from query 2
    out2 = llama_ref.attend(q, k, v2, window=2)
    assert torch.equal(out[:, 2:], out2[:, 2:])
    assert not torch.equal(out[:, :2], out2[:, :2])


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([[1.0, 1.0625, 448.0, -3.3]])
    y = common.fp8(x, -1)
    assert y[0, 0] == 1.0 and y[0, 2] == 448.0
    assert y[0, 1] in (1.0, 1.125)
    assert abs(y[0, 3] + 3.3) <= 3.3 / 8
