"""kubeshare_tpu_torch/cmd/workload.py on the CPU: every model trains and
prints the reference CLI's JSON line (the same keys as
kubeshare_tpu/cmd/workload.py prints), the reference's refusals stand,
a gang env is joined, not ignored (and refused with --sp), a run with no
CUDA device and no ``--device cpu`` fails, and checkpoints resume. A
resumed run ends at the same step and, on the CPU, with the same loss
bit for bit as an uninterrupted one: both see the same batches and the
same float32 arithmetic."""

import json
import os

import pytest
import torch

from kubeshare_tpu.cmd import workload as ref_workload
from kubeshare_tpu_torch.cmd import workload
from kubeshare_tpu_torch.models.checkpoint import latest_checkpoint
from kubeshare_tpu_torch.runtime import hook

KEYS = {"model", "steps", "batch", "processes", "global_batch", "seconds",
        "samples_per_s", "final_loss", "tokens_acquired", "compute_ms"}


@pytest.fixture(autouse=True)
def no_gate_env(monkeypatch):
    monkeypatch.delenv(hook.ENV_POD_MANAGER_PORT, raising=False)
    monkeypatch.delenv(hook.ENV_HBM_LIMIT, raising=False)
    for name in (workload.ENV_COORDINATOR, workload.ENV_NUM_PROCESSES,
                 workload.ENV_GANG_HEADCOUNT):
        monkeypatch.delenv(name, raising=False)


def run(capsys, *argv):
    assert workload.main(["--device", "cpu", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("model",
                         ["mnist", "cifar", "resnet", "vgg", "lstm", "llama"])
def test_every_model_prints_the_reference_line(capsys, model):
    extra = ["--seq-len", "16"] if model == "llama" else []
    doc = run(capsys, "--model", model, "--steps", "2", "--batch", "4",
              *extra)
    assert set(doc) == KEYS
    assert doc["model"] == model and doc["steps"] == 2
    assert doc["batch"] == doc["global_batch"] == 4
    assert doc["processes"] == 1 and doc["tokens_acquired"] == 0
    assert doc["final_loss"] == doc["final_loss"]      # finite, not NaN
    assert doc["samples_per_s"] > 0


@pytest.mark.parametrize("extra", [[], ["--remat"]])
def test_llama_trains_with_a_window(capsys, extra):
    """--model llama --window (sliding-window attention in every layer),
    with and without --remat: a window narrower than the sequence
    changes the loss, and remat gives the same one."""
    base = ["--model", "llama", "--steps", "2", "--batch", "2",
            "--seq-len", "24"]
    doc = run(capsys, *base, "--window", "8", *extra)
    assert set(doc) == KEYS and doc["steps"] == 2
    assert doc["final_loss"] == doc["final_loss"]      # finite, not NaN
    full = run(capsys, *base)
    assert doc["final_loss"] != full["final_loss"]
    if extra:
        assert doc["final_loss"] == run(capsys, *base, "--window",
                                        "8")["final_loss"]


def test_keys_are_the_reference_clis(capsys):
    assert ref_workload.main(["--model", "mnist", "--steps", "1",
                              "--batch", "2"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ref) == KEYS
    assert set(run(capsys, "--steps", "1", "--batch", "2")) == KEYS


@pytest.mark.parametrize("argv,message", [
    (["--model", "mnist", "--remat"], "--remat applies to --model llama"),
    (["--model", "cifar", "--window", "8"], "--window applies"),
    (["--model", "lstm", "--sp", "2"], "--sp applies to --model llama"),
    (["--model", "llama", "--sp", "2", "--window", "4", "--sp-flash"],
     "ring \\+ --sp-flash"),
    (["--model", "llama", "--sp", "3", "--seq-len", "32"],
     "must divide over --sp 3"),
])
def test_refusals(argv, message):
    with pytest.raises(SystemExit, match=message):
        workload.main(["--device", "cpu", "--steps", "1", *argv])


def test_a_gang_env_is_refused_not_ignored(monkeypatch):
    """A gang env is the gang path (tests/test_torch_dp.py runs one): it
    is not ignored, so --sp and --prefetch in a gang are refused, as in
    the reference, before the pod joins its gang."""
    monkeypatch.setenv(workload.ENV_COORDINATOR, "10.0.0.1:1234")
    monkeypatch.setenv(workload.ENV_GANG_HEADCOUNT, "2")
    monkeypatch.setenv("JOB_COMPLETION_INDEX", "1")
    with pytest.raises(SystemExit, match="--sp is single-process"):
        workload.main(["--device", "cpu", "--steps", "1", "--model", "llama",
                       "--sp", "2"])
    with pytest.raises(SystemExit, match="--prefetch is single-process"):
        workload.main(["--device", "cpu", "--steps", "1", "--prefetch", "2"])


def test_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        workload.main(["--steps", "1"])


def test_checkpoint_resume_matches_an_uninterrupted_run(capsys, tmp_path):
    base = ["--model", "mnist", "--batch", "4"]
    whole = run(capsys, *base, "--steps", "10")
    ckpt = str(tmp_path / "ck")
    first = run(capsys, *base, "--steps", "6", "--checkpoint-dir", ckpt,
                "--checkpoint-every", "4")
    assert first["steps"] == 6 and latest_checkpoint(ckpt) == 6
    assert sorted(os.listdir(ckpt)) == ["step_0000000004", "step_0000000006"]
    second = run(capsys, *base, "--steps", "4", "--checkpoint-dir", ckpt,
                 "--checkpoint-every", "100")
    assert latest_checkpoint(ckpt) == 10
    assert second["final_loss"] == whole["final_loss"]


def test_prefetch_feeds_the_same_batches(capsys):
    base = ["--model", "cifar", "--batch", "2", "--steps", "3"]
    assert (run(capsys, *base, "--prefetch", "2")["final_loss"]
            == run(capsys, *base)["final_loss"])


def test_duration_and_profile(capsys, tmp_path):
    doc = run(capsys, "--duration", "0.3", "--batch", "2",
              "--profile-dir", str(tmp_path / "prof"))
    assert doc["steps"] >= 1 and doc["seconds"] >= 0.3
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_accumulation_divides_the_batch(capsys):
    assert run(capsys, "--batch", "4", "--steps", "1",
               "--accum", "2")["steps"] == 1
    with pytest.raises(ValueError, match="accum_steps=3"):
        workload.main(["--device", "cpu", "--batch", "4", "--steps", "1",
                       "--accum", "3"])
