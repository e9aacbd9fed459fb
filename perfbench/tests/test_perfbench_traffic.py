"""The traffic generator repeats per seed, matches its files, and gives
every seed the same work in another order."""

import json
import math
import random
from pathlib import Path

import pytest
import torch

from perfbench.lib import traffic as TR

HOME = Path(__file__).resolve().parents[1]
SERVE = sorted(p.stem for p in (HOME / "traffic").glob("*.json")
               if json.loads(p.read_text())["kind"] == "serve")
TRAIN = sorted(p.stem for p in (HOME / "traffic").glob("*.json")
               if json.loads(p.read_text())["kind"] == "train")


def load(name):
    return json.loads((HOME / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", SERVE)
def test_serving_traffic_repeats_and_matches_its_file(name):
    traffic = load(name)
    horizon = TR.horizon(traffic, 30.0)
    a = TR.requests(traffic, 2**31 + 17, 0, horizon)
    b = TR.requests(traffic, 2**31 + 17, 0, horizon)
    assert [(r.due_s, r.prompt, r.out_len) for r in a] == [
        (r.due_s, r.prompt, r.out_len) for r in b]
    rate = traffic["arrivals"]["rate_per_pod"]
    assert len(a) == math.ceil(rate * horizon)
    p, o, ids = (traffic["prompt_tokens"], traffic["output_tokens"],
                 traffic["token_ids"])
    for r in a:
        assert p["min"] <= len(r.prompt) <= p["max"]
        assert o["min"] <= r.out_len <= o["max"]
        assert all(ids["low"] <= t < ids["high"] for t in r.prompt)
    assert all(x.due_s < y.due_s for x, y in zip(a, a[1:]))
    lengths = sorted(len(r.prompt) for r in a)
    assert lengths[len(lengths) // 2] == pytest.approx(p["median"], rel=0.05)


@pytest.mark.parametrize("name", SERVE)
def test_seeds_send_the_same_work_in_another_order(name):
    traffic = load(name)
    horizon = TR.horizon(traffic, 30.0)
    a = TR.requests(traffic, 1, 0, horizon)
    b = TR.requests(traffic, 3_000_000_019, 1, horizon)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    assert sorted(r.out_len for r in a) == sorted(r.out_len for r in b)
    assert a[-1].due_s == pytest.approx(b[-1].due_s)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]


@pytest.mark.parametrize("name", TRAIN)
def test_training_rows_repeat_per_seed_and_pod(name):
    traffic = dict(load(name), rows=2, seq_len=16)
    one = TR.train_batches(traffic, 5, 0, "cpu")
    two = TR.train_batches(traffic, 5, 0, "cpu")
    other = TR.train_batches(traffic, 5, 1, "cpu")
    a, b, c = next(one), next(two), next(other)
    assert a.shape == (2, 17) and torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, next(one))
    ids = traffic["token_ids"]
    assert int(a.min()) >= ids["low"] and int(a.max()) < ids["high"]


def test_blocks_hold_the_whole_mix_whatever_the_seed():
    ranked = list(range(74))
    blocks = math.ceil(74 / 12)

    def block_of(rank):      # serpentine: group by group, back and forth
        group, j = divmod(rank, blocks)
        return j if group % 2 == 0 else blocks - 1 - j

    a = TR._spread(ranked, 12, random.Random(1))
    b = TR._spread(ranked, 12, random.Random(2_147_483_701))
    assert a != b and sorted(a) == ranked
    for order in (a, b):
        ids = [block_of(r) for r in order]
        assert ids == sorted(ids)          # the seed never moves work
    for j in range(blocks):                # between blocks; each block
        members = [r for r in ranked if block_of(r) == j]
        assert min(members) < 12 and max(members) >= 62
