"""The scheduler's device contract on the card side: a pod sees only the
card it was given.

At bind time the scheduler names a pod's devices by uuid in
``TPU_VISIBLE_CHIPS`` (``kubeshare_tpu/scheduler/constants.py``;
``plugin.py`` writes it). The port maps it onto ``CUDA_VISIBLE_DEVICES``
in three places, by one rule: unset or empty, the variable takes the
contract's list; equal to it, nothing changes; another value is an error
that names both (Python raises; the interposer logs an error line, leaves
the variable and records the conflict in its stats).

- ``utils/device.py`` (``visible_devices_for``, ``honour_visible_chips``,
  which ``resolve_device`` and ``runtime/hook.py::install_gate`` call):
  checked without initialising CUDA;
- ``runtime/interposer.py::enable``, on a child's env;
- the CUDA interposer's constructor, preloaded under the mock
  ``libcuda.so.1`` of ``tests/test_torch_interposer.py``, whose
  ``cuInit`` records ``CUDA_VISIBLE_DEVICES`` as the driver reads it.
"""

import json
import os
import subprocess

import pytest
import torch

from kubeshare_tpu.scheduler import constants as jconstants
from kubeshare_tpu_torch import constants
from kubeshare_tpu_torch.runtime import hook, interposer
from kubeshare_tpu_torch.utils import device as tdevice

from test_torch_interposer import build  # noqa: F401  (the g++ fixture)

UUID = "GPU-5f1f7e3c-0d5b-4c59-9c1e-0a6b7d2e9f10"
OTHER = "GPU-00000000-0000-0000-0000-000000000000"
CHIPS = UUID + ",MIG-1a2b3c4d-0000-0000-0000-000000000001"


def test_the_contract_names_are_the_schedulers():
    assert constants.ENV_VISIBLE_CHIPS == jconstants.ENV_VISIBLE_CHIPS
    assert constants.ENV_VISIBLE_CHIPS == "TPU_VISIBLE_CHIPS"


@pytest.mark.parametrize("current,want", [
    (None, CHIPS),      # unset: the contract's list
    ("", CHIPS),        # empty: the same
    (CHIPS, None),      # equal: nothing to set
])
def test_rule(current, want):
    env = {constants.ENV_VISIBLE_CHIPS: CHIPS}
    if current is not None:
        env["CUDA_VISIBLE_DEVICES"] = current
    assert tdevice.visible_devices_for(env) == want


def test_rule_refuses_other_devices_naming_both():
    env = {constants.ENV_VISIBLE_CHIPS: UUID, "CUDA_VISIBLE_DEVICES": "1"}
    with pytest.raises(RuntimeError, match=f"'1'.*{UUID}"):
        tdevice.visible_devices_for(env)


def test_no_contract_no_change():
    assert tdevice.visible_devices_for({}) is None
    assert tdevice.visible_devices_for({"CUDA_VISIBLE_DEVICES": "3"}) is None
    env = {"CUDA_VISIBLE_DEVICES": "3"}
    assert tdevice.honour_visible_chips(env) is None
    assert env == {"CUDA_VISIBLE_DEVICES": "3"}


@pytest.mark.parametrize("current", [None, "", CHIPS])
def test_enable_writes_the_rule_into_the_childs_env(current, tmp_path):
    env = {constants.ENV_VISIBLE_CHIPS: CHIPS, "PATH": "/usr/bin"}
    if current is not None:
        env["CUDA_VISIBLE_DEVICES"] = current
    # no interposer or driver here: enable fails open on those, and the
    # contract is applied all the same
    out = interposer.enable(env, interposer=str(tmp_path / "missing.so"),
                            real_libcuda=str(tmp_path / "libcuda.so.1"))
    assert out["CUDA_VISIBLE_DEVICES"] == CHIPS
    assert "LD_PRELOAD" not in out
    assert env.get("CUDA_VISIBLE_DEVICES") == current   # a copy


def test_enable_refuses_a_conflicting_env():
    env = {constants.ENV_VISIBLE_CHIPS: UUID, "CUDA_VISIBLE_DEVICES": OTHER}
    with pytest.raises(RuntimeError, match="disagrees"):
        interposer.enable(env)


@pytest.mark.parametrize("current", [None, "", CHIPS])
def test_honour_sets_a_mapping_before_cuda_starts(current):
    env = {constants.ENV_VISIBLE_CHIPS: CHIPS}
    if current is not None:
        env["CUDA_VISIBLE_DEVICES"] = current
    assert tdevice.honour_visible_chips(env) == CHIPS
    assert env["CUDA_VISIBLE_DEVICES"] == CHIPS
    assert not torch.cuda.is_initialized()


def test_honour_refuses_a_conflict():
    env = {constants.ENV_VISIBLE_CHIPS: UUID, "CUDA_VISIBLE_DEVICES": "0"}
    with pytest.raises(RuntimeError, match="disagrees"):
        tdevice.honour_visible_chips(env)
    assert env["CUDA_VISIBLE_DEVICES"] == "0"


def test_resolve_device_and_install_gate_apply_the_contract(monkeypatch):
    """The helpers that pods call apply the contract to the process' own
    env; a CPU device never starts CUDA."""
    monkeypatch.delenv(constants.ENV_POD_MANAGER_PORT, raising=False)
    monkeypatch.delenv(constants.ENV_HBM_LIMIT, raising=False)
    for call in (lambda: tdevice.resolve_device("cpu"),
                 lambda: hook.install_gate()):
        monkeypatch.setenv(constants.ENV_VISIBLE_CHIPS, UUID)
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        call()
        assert os.environ["CUDA_VISIBLE_DEVICES"] == UUID
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", OTHER)
        with pytest.raises(RuntimeError, match="disagrees"):
            call()
    assert not torch.cuda.is_initialized()


def test_with_cuda_up_device_0_is_checked_instead(monkeypatch):
    """Once torch.cuda is up the variable no longer acts: device 0's
    uuid must be one of the contract's (torch gives it without the
    ``GPU-`` prefix)."""
    class Props:
        uuid = UUID[len("GPU-"):]

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: Props)
    monkeypatch.setenv(constants.ENV_VISIBLE_CHIPS, CHIPS)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert tdevice.honour_visible_chips() == CHIPS
    assert "CUDA_VISIBLE_DEVICES" not in os.environ   # too late to set
    monkeypatch.setenv(constants.ENV_VISIBLE_CHIPS, OTHER)
    with pytest.raises(RuntimeError, match="not one of"):
        tdevice.honour_visible_chips()


def _run_preloaded(build, **env):  # noqa: F811
    """The mock application under the interposer, preloaded by hand (not
    through ``enable``, which applies the rule itself): its cuInit line
    and stats, and the interposer's stderr lines."""
    shim, mock, app = build
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("KUBESHARE_")
            and k not in ("CUDA_VISIBLE_DEVICES",
                          constants.ENV_VISIBLE_CHIPS)}
    full.update(env, LD_PRELOAD=shim, KUBESHARE_CUDA_REAL=mock)
    out = subprocess.run([app, "init", "stats"], env=full,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    init, stats = (json.loads(line) for line in out.stdout.splitlines())
    return init, stats["shim"], [line for line in out.stderr.splitlines()
                                 if line.startswith("[cuda-interposer]")]


def test_interposer_sets_the_variable_before_cuinit(build):  # noqa: F811
    init, shim, log = _run_preloaded(build, TPU_VISIBLE_CHIPS=CHIPS)
    assert init == {"init": 0, "visible": CHIPS}
    assert shim["visible_devices"] == "set"
    assert shim["visible_chips"] == CHIPS
    assert any("CUDA_VISIBLE_DEVICES=" + CHIPS in line for line in log)


def test_interposer_keeps_an_equal_value(build):  # noqa: F811
    init, shim, log = _run_preloaded(build, TPU_VISIBLE_CHIPS=UUID,
                                     CUDA_VISIBLE_DEVICES=UUID)
    assert init["visible"] == UUID
    assert shim["visible_devices"] == "kept"
    assert not any("error" in line for line in log)


def test_interposer_logs_a_conflict_and_leaves_it(build):  # noqa: F811
    init, shim, log = _run_preloaded(build, TPU_VISIBLE_CHIPS=UUID,
                                     CUDA_VISIBLE_DEVICES="1")
    assert init["visible"] == "1"
    assert shim["visible_devices"] == "conflict"
    assert any("error" in line and "CUDA_VISIBLE_DEVICES=1" in line
               and UUID in line for line in log)


def test_interposer_without_a_contract_touches_nothing(build):  # noqa: F811
    init, shim, log = _run_preloaded(build)
    assert init["visible"] == "(unset)"
    assert shim["visible_devices"] == "none" and shim["visible_chips"] == ""
    init, _, _ = _run_preloaded(build, CUDA_VISIBLE_DEVICES="2")
    assert init["visible"] == "2"
