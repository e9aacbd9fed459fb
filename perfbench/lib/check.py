"""Whether what the timed path produced is correct: the program's
outputs against the plain reference of the configuration's family
(``families/<family>.py``, over ``perfbench/reference``), which draws
the same seeded weights and inputs again, once the program's state is
freed.

Serving: a sample of the requests the pods finished, drawn from the
seed, the one with the most served tokens always in it. The reference
runs once over each prompt with its served tokens; ``serve_gap`` is the
widest gap by which a served (greedy) token's reference logit lies below
the reference's best at that position.

Training: the first ``CHECK_STEPS`` steps, which set-up drives through
the pods' own gated step on their own rows, all pods at once as in the
window, against the reference's Adam over the same rows. ``loss_gap``: the largest relative gap of a step's loss.
``grad_gap``: the first gradient (``exp_avg / (1 - beta1)`` of the
program's Adam after step 1), ``change_gap``: the change of the
parameters after the last step; each the worst leaf's gap between the
program's norm and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf. Leaves whose reference
gradient is under a thousandth of the median leaf's are left out of
``change_gap`` (Adam moves them by round-off alone).
"""

from __future__ import annotations

import random
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .traffic import train_batches
from . import weights as W

CHECK_STEPS = 3
ADAM_BETA1 = 0.9


def sample(pods, seed: int, min_tokens: int, max_requests: int) -> List:
    """(pod, request) pairs: the finished request with the most served
    tokens, then others in an order drawn from the seed until
    ``min_tokens`` served tokens or ``max_requests`` requests."""
    done = [(p.index, r) for p in pods for r in p.finished]
    if not done:
        return []
    done.sort(key=lambda pr: (pr[0], pr[1].index))
    longest = max(done, key=lambda pr: (len(pr[1].tokens), len(pr[1].prompt)))
    rest = [pr for pr in done if pr is not longest]
    random.Random(W.derive_seed(seed, "check")).shuffle(rest)
    chosen, served = [longest], len(longest[1].tokens)
    for pr in rest:
        if served >= min_tokens or len(chosen) >= max_requests:
            break
        chosen.append(pr)
        served += len(pr[1].tokens)
    return chosen


def reference_logits(family, spec, seed: int, pod: int, reqs, device,
                     quant=None) -> List[torch.Tensor]:
    """The reference's float32 logits at every served position of each
    request of pod ``pod`` (prompt + served tokens, teacher-forced)."""
    seqs, positions = [], []
    for r in reqs:
        ids = r.prompt + r.tokens[:-1]
        seqs.append(torch.tensor(ids, dtype=torch.long, device=device))
        first = len(r.prompt) - 1
        positions.append(torch.arange(first, first + len(r.tokens),
                                      device=device))
    return family.reference_logits(spec, seed, pod, seqs, positions, device,
                                   quant)


def widest_gap(ref: torch.Tensor, tokens: torch.Tensor) -> float:
    """Largest (best reference logit - reference logit of the token)."""
    best = ref.max(dim=-1).values
    got = ref.gather(-1, tokens[:, None])[:, 0]
    return (best - got).max().item()


def serve_numbers(family, spec, seed: int, chosen, device) -> Dict:
    gap, tokens = 0.0, 0
    for pod in sorted({p for p, _ in chosen}):
        reqs = [r for p, r in chosen if p == pod]
        for r, ref in zip(reqs, reference_logits(family, spec, seed, pod,
                                                 reqs, device)):
            served = torch.tensor(r.tokens, dtype=torch.long, device=device)
            gap = max(gap, widest_gap(ref, served))
            tokens += len(r.tokens)
    return {"serve_gap": gap, "_requests": len(chosen), "_tokens": tokens}


def change_norms(family, spec, seed: int, pod: int,
                 leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """||leaf - its initial value|| by leaf name."""
    device = next(iter(leaves.values())).device
    with torch.no_grad():
        return {n: (leaves[n].float() - t0).norm().item()
                for n, t0 in family.initial_leaves(spec, seed, pod, device)}


def program_first_grads(pod) -> Dict[str, float]:
    """The first gradient's norm by leaf, from the program's Adam state
    after one step: exp_avg = (1 - beta1) g."""
    out = {}
    for n, p in pod.leaves().items():
        avg = pod.optimizer.state.get(p, {}).get("exp_avg")
        out[n] = 0.0 if avg is None else (avg.norm() / (1 - ADAM_BETA1)).item()
    return out


def reference_training(family, spec, traffic: Dict, seed: int, pod: int,
                       device, quant=None, rows_used: int = 0) -> Dict:
    """The reference's readings for pod ``pod``: its losses, first
    gradient norms and change norms over ``CHECK_STEPS`` steps."""
    params = dict(family.initial_leaves(spec, seed, pod, device))
    batches = train_batches(traffic, seed, pod, device)
    rows = [next(batches) for _ in range(CHECK_STEPS)]
    out = family.reference_training(spec, params, rows, float(traffic["lr"]),
                                    quant=quant, rows_used=rows_used)
    out["change"] = change_norms(family, spec, seed, pod, params)
    return out


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             keep: Optional[Sequence[str]] = None) -> Tuple[float, str]:
    names = list(keep if keep is not None else want)
    floor = statistics.median(want[n] for n in names)
    worst = max(names, key=lambda n: abs(got[n] - want[n])
                / max(want[n], floor, 1e-30))
    return abs(got[worst] - want[worst]) / max(want[worst], floor,
                                               1e-30), worst


def train_numbers(program: Dict, ref: Dict) -> Dict:
    """The three numbers for one pod."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in
                   zip(program["losses"], ref["losses"]))
    grad_gap, grad_leaf = leaf_gap(program["first_grad"], ref["first_grad"])
    median = statistics.median(ref["first_grad"].values())
    moved = [n for n, g in ref["first_grad"].items() if g >= 1e-3 * median]
    change_gap, change_leaf = leaf_gap(program["change"], ref["change"],
                                       moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "_grad_leaf": grad_leaf,
            "_change_leaf": change_leaf,
            "_left_out": len(ref["first_grad"]) - len(moved)}


def verdict(numbers: Dict, limits: Dict) -> bool:
    """Every compared number finite and within its limit."""
    return all(name in numbers and numbers[name] == numbers[name]
               and numbers[name] <= limit for name, limit in limits.items())
