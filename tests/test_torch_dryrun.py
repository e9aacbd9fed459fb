"""The port's multi-device dry run, ``kubeshare_tpu_torch.entry.
dryrun_multichip``, on the CPU: the counterpart cases of
``tests/test_dryrun_contract.py`` (the cross-process leg gets exactly
one retry, the tail always carries ``crossproc=ok|failed|skipped``, and
a forced failure raises after the tail is printed), then the whole run
over 4 CPU rank processes and 4 gang processes, whose tail must carry
the reference's tokens in its order, at the reference's bounds (its
legs raise past them: attention 5e-3, the sp loss 1e-4, the pipeline
5e-5, aux finite).
"""

import math
import re

import pytest

from kubeshare_tpu_torch import entry


class TestCrossprocHonesty:
    def test_double_failure_is_failed_after_exactly_one_retry(
            self, monkeypatch):
        calls = []

        def boom(device_type):
            calls.append(device_type)
            raise OSError("port race")

        monkeypatch.delenv("KUBESHARE_DRYRUN_CROSSPROC", raising=False)
        monkeypatch.setattr(entry, "_crossprocess_leg", boom)
        status, detail = entry._crossproc_status("cpu")
        assert status == "failed"
        assert calls == ["cpu", "cpu"]   # one retry, not zero, not more
        assert "OSError" in detail

    def test_failed_status_raises(self):
        with pytest.raises(RuntimeError, match="cross-process leg failed"):
            entry._enforce_crossproc("failed", "attempt 2: OSError: x")

    def test_transient_failure_recovers_on_retry(self, monkeypatch):
        calls = []

        def flaky(device_type):
            calls.append(1)
            if len(calls) == 1:
                raise OSError("transient")
            return "dp=2xtp=2 over torch.distributed (gloo): allgather"

        monkeypatch.delenv("KUBESHARE_DRYRUN_CROSSPROC", raising=False)
        monkeypatch.setattr(entry, "_crossprocess_leg", flaky)
        status, detail = entry._crossproc_status("cpu")
        assert status == "ok" and len(calls) == 2
        assert "allgather" in detail
        entry._enforce_crossproc(status, detail)   # must not raise

    def test_env_skip_yields_skipped_token_and_no_raise(self, monkeypatch):
        monkeypatch.setenv("KUBESHARE_DRYRUN_CROSSPROC", "0")
        status, detail = entry._crossproc_status("cpu")
        assert status == "skipped"
        entry._enforce_crossproc(status, detail)

    def test_forced_failure_env_hook_reaches_the_real_leg(self, monkeypatch):
        monkeypatch.delenv("KUBESHARE_DRYRUN_CROSSPROC", raising=False)
        monkeypatch.setenv("KS_DRYRUN_FORCE_CROSSPROC_FAIL", "1")
        status, detail = entry._crossproc_status("cpu")
        assert status == "failed" and "forced failure" in detail
        with pytest.raises(RuntimeError):
            entry._enforce_crossproc(status, detail)


TAIL = re.compile(
    r"dryrun_multichip\(4\): mesh dp=1 fsdp=2 tp=2 loss=(?P<loss>\S+); "
    r"ring-attention sp=4 max_err=(?P<ring>\S+); ulysses sp=4 "
    r"max_err=(?P<uly>\S+); llama-sp-loss sp=4 err=(?P<sp>\S+); "
    r"pipeline pp=4 max_err=(?P<pp>\S+); moe ep=4 aux=(?P<aux>\S+); "
    r"use_flash=False \(head dims 16 and 8: plain attention, as the "
    r"reference's mha\); crossproc=ok 4-process dp=2xtp=2 over "
    r"torch.distributed \(gloo\): allgather \[0.0, 1.0, 2.0, 3.0\] "
    r"loss=(?P<xloss>\S+)$")


def test_dryrun_multichip_on_4_cpu_ranks(capsys, monkeypatch):
    monkeypatch.delenv("KUBESHARE_DRYRUN_CROSSPROC", raising=False)
    monkeypatch.delenv("KS_DRYRUN_FORCE_CROSSPROC_FAIL", raising=False)
    entry.dryrun_multichip(4, device="cpu")
    tail = capsys.readouterr().out.strip().splitlines()[-1]
    match = TAIL.match(tail)
    assert match, tail
    assert float(match["ring"]) < 5e-3 and float(match["uly"]) < 5e-3
    assert float(match["sp"]) < 1e-4 and float(match["pp"]) < 5e-5
    assert all(math.isfinite(float(match[k])) for k in ("loss", "aux",
                                                        "xloss"))


def test_dryrun_needs_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(4)
