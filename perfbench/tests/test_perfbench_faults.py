"""A whole run at tiny widths on the CPU, the harness's look for a chip
skipped: sound, ``correct`` is true; with the timed path broken
underneath, false. One fault a kind the cells can have: a served token
altered where it is produced; a training step that leaves its state
unchanged; half of a training batch left out, the mean taken over the
rest. (No cell spans chips, so there is no exchange to leave out.) The
control, the reference in float8 put in the program's place, fails the
same limits."""

import pytest
import torch

from perfbench.lib import check
from perfbench.reference.common import exact_float32, fp8
from perfbench.tests import tiny


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("workload", ["tiny.serve", "tiny.train"])
def test_sound_runs_are_correct(bench, workload):
    for seed in (1, 2_147_483_659):
        result, lines = tiny.run(bench, workload, seed=seed, seconds=0.6)
        assert result["correct"], lines
        assert list(result)[-1] == "checks"
        assert result["attempted"] > 0 and result["failed"] == 0


def test_the_checked_steps_run_at_once(bench):
    """Set-up drives every trainer's checked steps at once, as the window
    drives the later ones: each pod's first step starts before the other
    pod's last checked step ends (one pod after the other would not)."""
    import time

    from perfbench.lib.catalog import Catalog
    from perfbench.lib.harness import measure

    session = measure(Catalog(bench), "tiny.train", 5, 0.3, False,
                      torch.device("cpu"), time.perf_counter(),
                      log=lambda msg: None)
    session.close()
    steps = [p.spans["train_step"][:check.CHECK_STEPS]
             for p in session.run.pods]
    assert [len(s) for s in steps] == [check.CHECK_STEPS] * 2
    assert steps[0][0][0] < steps[1][-1][1]
    assert steps[1][0][0] < steps[0][-1][1]


def test_an_altered_token_is_caught(bench, monkeypatch):
    from kubeshare_tpu_torch.models import serving

    sample = serving._sample_token

    def altered(logits, *args):
        return (sample(logits, *args) + 1) % logits.shape[-1]

    monkeypatch.setattr(serving, "_sample_token", altered)
    result, lines = tiny.run(bench, "tiny.serve", seconds=0.6)
    assert not result["correct"], lines


def test_a_step_that_leaves_the_state_unchanged_is_caught(bench,
                                                          monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    result, lines = tiny.run(bench, "tiny.train", seconds=0.6)
    assert not result["correct"], lines
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_a_batch_is_caught(bench, monkeypatch):
    from kubeshare_tpu_torch.models import llama

    whole = llama.llama_loss

    def half(model, tokens, **kwargs):
        return whole(model, tokens[: tokens.shape[0] // 2], **kwargs)

    monkeypatch.setattr(llama, "llama_loss", half)
    result, lines = tiny.run(bench, "tiny.train", seconds=0.6)
    assert not result["correct"], lines


def test_the_float8_control_fails_the_limits(bench):
    from perfbench.lib.catalog import Catalog

    catalog = Catalog(bench)
    family = catalog.family("tiny-train")
    spec = catalog.spec("tiny-train")
    traffic = catalog.traffic("tiny-train")
    exact_float32()
    cpu = torch.device("cpu")
    ref = check.reference_training(family, spec, traffic, 3, 0, cpu)
    ctl = check.reference_training(family, spec, traffic, 3, 0, cpu,
                                   quant=fp8)
    numbers = check.train_numbers(ctl, ref)
    assert not check.verdict(numbers, tiny.LIMITS["tiny.train"]), numbers


def test_the_float8_control_fails_the_serving_limit(bench):
    import time

    from perfbench import control
    from perfbench.lib.catalog import Catalog
    from perfbench.lib.harness import measure

    cpu = torch.device("cpu")
    for seed in (4, 3_000_000_021):
        session = measure(Catalog(bench), "tiny.serve", seed, 0.8, False,
                          cpu, time.perf_counter(), log=lambda m: None)
        try:
            exact_float32()
            readings = control.serve_readings(session, seed, cpu)
        finally:
            session.close()
        limit = tiny.LIMITS["tiny.serve"]["serve_gap"]
        assert readings["serve_gap"] <= limit < readings["control_gap"], \
            readings
