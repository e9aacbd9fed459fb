"""The port's multi-device dry run, ``kubeshare_tpu_torch.entry.
dryrun_multichip``, on the CPU: the counterpart cases of
``tests/test_dryrun_contract.py`` (the cross-process leg gets exactly
one retry, the tail always carries ``crossproc=ok|failed|skipped``, and
a forced failure raises after the tail is printed), then the whole run
over 4 CPU rank processes and 4 gang processes, whose tail must carry
the reference's tokens in its order, at the reference's bounds (its
legs raise past them: attention 5e-3, the sp loss 1e-4, the pipeline
5e-5, aux finite). Attention dispatches by ``mha``'s default, as the
reference's does: plain attention on the CPU, so no kernel launches.
The same run against the reference's own dry run on 4 virtual CPU
devices (its cross-process leg skipped): the same mesh, pp and ep, and
the loss and aux within 5e-2 relative (both from random weights at
initialisation, drawn by ``jax.random`` on one side and
``torch.Generator`` on the other: near ln(256) and 1).
"""

import contextlib
import io
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
        status, detail, launches = entry._crossproc_status("cpu")
        assert status == "failed" and launches == []
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
            return ("dp=2xtp=2 over torch.distributed (gloo): allgather",
                    [{"flash_fwd": 1}])

        monkeypatch.delenv("KUBESHARE_DRYRUN_CROSSPROC", raising=False)
        monkeypatch.setattr(entry, "_crossprocess_leg", flaky)
        status, detail, launches = entry._crossproc_status("cpu")
        assert status == "ok" and len(calls) == 2
        assert "allgather" in detail and launches == [{"flash_fwd": 1}]
        entry._enforce_crossproc(status, detail)   # must not raise

    def test_env_skip_yields_skipped_token_and_no_raise(self, monkeypatch):
        monkeypatch.setenv("KUBESHARE_DRYRUN_CROSSPROC", "0")
        status, detail, launches = entry._crossproc_status("cpu")
        assert status == "skipped" and launches == []
        entry._enforce_crossproc(status, detail)

    def test_forced_failure_env_hook_reaches_the_real_leg(self, monkeypatch):
        monkeypatch.delenv("KUBESHARE_DRYRUN_CROSSPROC", raising=False)
        monkeypatch.setenv("KS_DRYRUN_FORCE_CROSSPROC_FAIL", "1")
        status, detail, launches = entry._crossproc_status("cpu")
        assert status == "failed" and "forced failure" in detail
        assert launches == []
        with pytest.raises(RuntimeError):
            entry._enforce_crossproc(status, detail)


TAIL = re.compile(
    r"dryrun_multichip\(4\): mesh dp=1 fsdp=2 tp=2 loss=(?P<loss>\S+); "
    r"ring-attention sp=4 max_err=(?P<ring>\S+); ulysses sp=4 "
    r"max_err=(?P<uly>\S+); llama-sp-loss sp=4 err=(?P<sp>\S+); "
    r"pipeline pp=4 max_err=(?P<pp>\S+); moe ep=4 aux=(?P<aux>\S+); "
    r"attention=plain \(cpu\); crossproc=ok 4-process dp=2xtp=2 over "
    r"torch.distributed \(gloo\): allgather \[0.0, 1.0, 2.0, 3.0\] "
    r"loss=(?P<xloss>\S+)$")
REFERENCE_TAIL = re.compile(
    r"dryrun_multichip\(4\): mesh dp=(?P<dp>\d+) fsdp=(?P<fsdp>\d+) "
    r"tp=(?P<tp>\d+) loss=(?P<loss>\S+); ring-attention sp=4 "
    r"max_err=(?P<ring>\S+); ulysses sp=4 max_err=(?P<uly>\S+); "
    r"llama-sp-loss sp=4 err=(?P<sp>\S+); pipeline pp=(?P<pp_size>\d+) "
    r"max_err=(?P<pp>\S+); moe ep=(?P<ep>\d+) aux=(?P<aux>\S+); ")
# loss and aux of two random initialisations, relative
INIT_TOL = 5e-2


@pytest.fixture(scope="module")
def dryrun():
    """One run of ``dryrun_multichip(4, device="cpu")`` with attention
    at its default: (what it returns, the tail line)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("KUBESHARE_DRYRUN_CROSSPROC", raising=False)
        mp.delenv("KS_DRYRUN_FORCE_CROSSPROC_FAIL", raising=False)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            run = entry.dryrun_multichip(4, device="cpu")
    return run, printed.getvalue().strip().splitlines()[-1]


def test_dryrun_multichip_on_4_cpu_ranks(dryrun):
    run, tail = dryrun
    match = TAIL.match(tail)
    assert match, tail
    assert float(match["ring"]) < 5e-3 and float(match["uly"]) < 5e-3
    assert float(match["sp"]) < 1e-4 and float(match["pp"]) < 5e-5
    assert all(math.isfinite(float(match[k])) for k in ("loss", "aux",
                                                        "xloss"))
    # the default on the CPU is plain attention: no rank and no
    # cross-process worker launched a kernel
    assert len(run["ranks"]) == 4
    assert all(not any(r["launches"].values()) for r in run["ranks"])
    assert len(run["crossproc_launches"]) == entry.CROSSPROC_PROCESSES
    assert all(not any(c.values()) for c in run["crossproc_launches"])


def test_dryrun_default_dispatch_matches_the_reference_tail(dryrun,
                                                            monkeypatch):
    import __graft_entry__

    monkeypatch.setenv("KUBESHARE_DRYRUN_CROSSPROC", "0")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        __graft_entry__.dryrun_multichip(4)
    want = REFERENCE_TAIL.match(printed.getvalue().strip().splitlines()[-1])
    got = REFERENCE_TAIL.match(dryrun[1])
    assert want and got, (printed.getvalue(), dryrun[1])
    for key in ("dp", "fsdp", "tp", "pp_size", "ep"):
        assert got[key] == want[key], key
    for key, bound in (("ring", 5e-3), ("uly", 5e-3), ("sp", 1e-4),
                       ("pp", 5e-5)):
        assert float(got[key]) < bound and float(want[key]) < bound, key
    for key in ("loss", "aux"):
        assert math.isclose(float(got[key]), float(want[key]),
                            rel_tol=INIT_TOL), key


def test_dryrun_needs_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(4)
