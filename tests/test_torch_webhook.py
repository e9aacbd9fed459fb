"""The admission webhook's CUDA twin (``kubeshare_tpu_torch/cluster``)
against the reference's (``kubeshare_tpu/cluster/webhook.py``,
``kubeshare_tpu/scheduler/labels.py``).

- Patches: for a table of manifests (``tests/test_webhook.py``'s cases
  and more), the port's ``review_response`` and the reference's on the
  same AdmissionReview decode to equal patches once the library env is
  mapped: the reference's ``TPU_LIBRARY_PATH`` = its PJRT shim is the
  port's ``LD_PRELOAD`` = the CUDA interposer, in the patches and in a
  container's own env alike.
- Labels: the port's ``parse_pod`` against the reference's over
  ``tests/test_labels.py``'s cases and hypothesis-drawn label dicts: the
  same kind, request, limit, memory, model, priority, gang, tenant and
  estimate, or ``LabelError`` on both.
- The server over localhost HTTP, and ``cmd/webhook.main`` started and
  stopped; the install step (``runtime/native.py::install_interposer``,
  g++ here) and the installed library under the mock driver of
  ``tests/test_torch_interposer.py``; the manifests under
  ``deploy/torch/``.
"""

import base64
import copy
import importlib.util
import json
import os
import pathlib
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kubeshare_tpu.cluster import webhook as jwebhook
from kubeshare_tpu.cluster.api import Pod as JPod
from kubeshare_tpu.scheduler import constants as JC
from kubeshare_tpu.scheduler import labels as jlabels
from kubeshare_tpu_torch import constants
from kubeshare_tpu_torch.bench.arbiter import free_port
from kubeshare_tpu_torch.cluster import labels as tlabels
from kubeshare_tpu_torch.cluster import webhook as twebhook
from kubeshare_tpu_torch.runtime import interposer, native

from test_torch_interposer import build  # noqa: F401  (the g++ fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHARED = {JC.LABEL_TPU_REQUEST: "0.5", JC.LABEL_TPU_LIMIT_ALIASES[1]: "1.0"}
WHOLE = {JC.LABEL_TPU_REQUEST: "2.0", JC.LABEL_TPU_LIMIT_ALIASES[1]: "2.0"}
GANG = {JC.LABEL_GROUP_NAME: "band", JC.LABEL_GROUP_HEADCOUNT: "4",
        JC.LABEL_GROUP_THRESHOLD: "1.0"}


def pod(labels=None, containers=None, volumes=None,
        scheduler=JC.SCHEDULER_NAME):
    manifest = {
        "metadata": {"name": "p1",
                     "labels": SHARED if labels is None else labels},
        "spec": {"schedulerName": scheduler,
                 "containers": containers or [{"name": "main",
                                               "image": "x"}]},
    }
    if volumes is not None:
        manifest["spec"]["volumes"] = volumes
    return manifest


MOUNT = {"name": twebhook.VOLUME_NAME, "mountPath": constants.LIBRARY_PATH,
         "readOnly": True}
VOLUME = {"name": twebhook.VOLUME_NAME,
          "hostPath": {"path": constants.LIBRARY_PATH,
                       "type": "DirectoryOrCreate"}}

MANIFESTS = {
    "fractional": pod(),
    "fractional_limit_alias": pod(labels={
        JC.LABEL_TPU_LIMIT_ALIASES[0]: "1.0", JC.LABEL_TPU_REQUEST: "0.3"}),
    "whole_device": pod(labels={JC.LABEL_TPU_REQUEST: "1.0",
                                JC.LABEL_TPU_LIMIT_ALIASES[1]: "1.0"}),
    "multi_device": pod(labels=WHOLE),
    "regular": pod(labels={}),
    "zero_zero": pod(labels={JC.LABEL_TPU_REQUEST: "0",
                             JC.LABEL_TPU_LIMIT_ALIASES[1]: "0"}),
    "gang_fractional": pod(labels={**SHARED, **GANG}),
    "gang_whole": pod(labels={**WHOLE, **GANG}),
    "gang_no_headcount": pod(labels={**WHOLE,
                                     JC.LABEL_GROUP_NAME: "band"}),
    "gang_no_threshold": pod(labels={**WHOLE, JC.LABEL_GROUP_NAME: "band",
                                     JC.LABEL_GROUP_HEADCOUNT: "4"}),
    "other_scheduler": pod(scheduler="default-scheduler"),
    "no_scheduler": pod(scheduler=None),
    "bad_request_over_limit": pod(labels={
        JC.LABEL_TPU_REQUEST: "0.8", JC.LABEL_TPU_LIMIT_ALIASES[1]: "0.5"}),
    "bad_number": pod(labels={JC.LABEL_TPU_LIMIT_ALIASES[1]: "1e3"}),
    "bad_priority": pod(labels={**SHARED, JC.LABEL_PRIORITY: "101"}),
    "bad_tenant": pod(labels={**SHARED, JC.LABEL_TENANT: "-bad-"}),
    "bad_gang": pod(labels={**SHARED, **GANG,
                            JC.LABEL_GROUP_THRESHOLD: "1.5"}),
    "existing_volumes": pod(volumes=[{"name": "data", "emptyDir": {}}]),
    "existing_library_volume": pod(volumes=[VOLUME]),
    "existing_mounts": pod(containers=[
        {"name": "main", "image": "x",
         "volumeMounts": [{"name": "data", "mountPath": "/data"}]}]),
    "existing_library_mount": pod(containers=[
        {"name": "main", "image": "x", "volumeMounts": [MOUNT]}]),
    "existing_env": pod(containers=[
        {"name": "main", "image": "x",
         "env": [{"name": "FOO", "value": "1"}]}]),
    "existing_library_env": pod(containers=[
        {"name": "main", "image": "x",
         "env": [{"name": constants.ENV_LIBRARY_PATH, "value": "/mine"}]}]),
    "two_containers": pod(containers=[
        {"name": "a", "image": "x"},
        {"name": "b", "image": "y", "env": []}]),
    "own_preload": pod(containers=[
        {"name": "a", "image": "x",
         "env": [{"name": "LD_PRELOAD", "value": "/custom.so"}]},
        {"name": "b", "image": "y"}]),
    "gang_two_containers_own_env": pod(labels={**SHARED, **GANG},
                                       containers=[
        {"name": "a", "image": "x",
         "env": [{"name": constants.ENV_GANG_HEADCOUNT, "value": "9"}]},
        {"name": "b", "image": "y", "volumeMounts": []}]),
}


def review(manifest, kind="Pod"):
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": "u-123",
                        "kind": {"group": "", "version": "v1",
                                 "kind": kind},
                        "object": manifest}}


def as_reference(manifest):
    """The manifest a TPU pod would be: a container's own LD_PRELOAD is
    its own TPU_LIBRARY_PATH."""
    manifest = copy.deepcopy(manifest)
    for container in manifest["spec"].get("containers", []):
        for entry in container.get("env") or []:
            if entry["name"] == "LD_PRELOAD":
                entry["name"] = "TPU_LIBRARY_PATH"
    return manifest


def map_library_env(value):
    """The reference's patches with its shim env as the port's."""
    if isinstance(value, list):
        return [map_library_env(v) for v in value]
    if isinstance(value, dict):
        if value == {"name": "TPU_LIBRARY_PATH",
                     "value": jwebhook.SHIM_PATH}:
            return {"name": "LD_PRELOAD",
                    "value": twebhook.INTERPOSER_PATH}
        return {k: map_library_env(v) for k, v in value.items()}
    return value


def decoded(response):
    body = response["response"]
    if "patch" not in body:
        return None
    assert body["patchType"] == "JSONPatch"
    return json.loads(base64.b64decode(body["patch"]))


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_patches_are_the_references_with_the_interposer(name):
    manifest = MANIFESTS[name]
    got = twebhook.review_response(review(manifest))
    want = jwebhook.review_response(review(as_reference(manifest)))
    assert got["response"]["uid"] == want["response"]["uid"] == "u-123"
    assert got["response"]["allowed"] is want["response"]["allowed"] is True
    assert decoded(got) == map_library_env(decoded(want))
    assert manifest == MANIFESTS[name]   # the input is not mutated


def test_fractional_pod_gets_the_interposer():
    patches = twebhook.mutate_pod(pod(labels={**SHARED, **GANG}))
    env = next(p["value"] for p in patches
               if p["path"] == "/spec/containers/0/env")
    assert {e["name"]: e["value"] for e in env} == {
        constants.ENV_LIBRARY_PATH: constants.LIBRARY_PATH,
        "LD_PRELOAD": "/kubeshare/library/libcuda_interposer.so",
        constants.ENV_GANG_HEADCOUNT: "4"}
    # the path the node's install step writes and enable() looks for
    assert os.path.basename(twebhook.INTERPOSER_PATH) \
        == constants.INTERPOSER_LIBRARY == interposer.LIBRARY_NAME + ".so"
    assert not any("KUBESHARE_CUDA_REAL" in json.dumps(p) for p in patches)


def test_own_preload_is_left_alone():
    patches = twebhook.mutate_pod(MANIFESTS["own_preload"])
    a_env = [p["value"] for p in patches
             if p["path"] == "/spec/containers/0/env/-"]
    assert a_env == [{"name": constants.ENV_LIBRARY_PATH,
                      "value": constants.LIBRARY_PATH}]


def test_non_pod_requests_are_allowed_untouched():
    for mod in (twebhook, jwebhook):
        body = mod.review_response(review(pod(), kind="Deployment"))
        assert body["response"] == {"uid": "u-123", "allowed": True}


def test_the_label_names_are_the_schedulers():
    for name in ("SCHEDULER_NAME", "DOMAIN", "LABEL_GROUP_NAME",
                 "LABEL_GROUP_HEADCOUNT", "LABEL_GROUP_THRESHOLD",
                 "LABEL_PRIORITY", "LABEL_TPU_LIMIT", "LABEL_TPU_REQUEST",
                 "LABEL_TPU_MEMORY", "LABEL_TPU_MODEL", "LABEL_TENANT",
                 "LABEL_RUNTIME_ESTIMATE", "LABEL_TPU_LIMIT_ALIASES"):
        assert getattr(tlabels, name) == getattr(JC, name), name
    assert constants.ENV_GANG_HEADCOUNT == JC.ENV_GROUP_HEADCOUNT
    assert constants.ENV_LIBRARY_PATH == JC.ENV_LIBRARY_PATH
    assert constants.LIBRARY_PATH == JC.LIBRARY_PATH


# ---- parse_pod ----------------------------------------------------------


def parsed(module, pod_cls, labels, namespace="default"):
    """The fields both parsers fill, or the LabelError's text."""
    try:
        req = module.parse_pod(pod_cls(name="p", namespace=namespace,
                                       labels=dict(labels)))
    except module.LabelError as err:
        return ("LabelError", str(err))
    gang = None if req.gang is None else (
        req.gang.name, req.gang.headcount, req.gang.threshold,
        req.gang.min_available)
    return (req.kind.value, req.limit, req.request, req.memory, req.model,
            req.priority, req.is_guarantee, req.chip_count, gang,
            req.tenant, req.est_runtime)


def mk(labels):
    return {JC.DOMAIN + k: str(v) for k, v in labels.items()}


LABEL_CASES = [
    {}, mk({"tpu_limit": 1.0, "tpu_request": 0.5, "tpu_mem": 1 << 30}),
    mk({"tpu_request": 0.5}), mk({"tpu_limit": 0.5, "tpu_request": 1.0}),
    mk({"tpu_limit": 2.0, "tpu_request": 2.0}),
    mk({"tpu_limit": 1.5, "tpu_request": 1.5}),
    mk({"tpu_limit": 3.0, "tpu_request": 2.0}),
    mk({"tpu_limit": 0.0, "tpu_request": 0.0}),
    mk({"tpu_limit": -0.5}), mk({"tpu_limit": "abc"}),
    mk({"tpu_limit": 1.0, "tpu_mem": "lots"}), mk({"tpu_limit": 0.5}),
    mk({"tpu_limit": 0.5, "priority": 80}), mk({"priority": 101}),
    mk({"priority": -2}),
    mk({"group_name": "g", "group_headcount": 5, "group_threshold": 0.2}),
    mk({"group_name": "g", "group_headcount": 3, "group_threshold": 0.5}),
    mk({"group_name": "g"}), mk({"group_name": "g", "group_headcount": 3}),
    mk({"group_name": "g", "group_headcount": 0, "group_threshold": 0.5}),
    mk({"group_name": "g", "group_headcount": 2, "group_threshold": 1.5}),
    mk({"tpu_request_limit": 1.0, "tpu_limit": 0.2, "tpu_request": 0.5}),
    mk({"tpu_limit": 1.0, "tenant": "team-a", "runtime_estimate": 30}),
    mk({"tpu_limit": 1.0, "tenant": "_x"}),
    mk({"tpu_limit": 1.0, "runtime_estimate": "soon"}),
    mk({"tpu_limit": 1.0, "tpu_model": "h100", "tpu_mem": 0}),
    mk({"tpu_mem": 5}), mk({"tpu_limit": "٣"}),
]


@pytest.mark.parametrize("labels", LABEL_CASES, ids=range(len(LABEL_CASES)))
def test_parse_pod_matches_the_reference(labels):
    assert parsed(tlabels, tlabels.Pod, labels) \
        == parsed(jlabels, JPod, labels)


NUMBERS = st.one_of(
    st.sampled_from(["0", "0.5", "1", "1.0", "2", "2.0", "1.5", "3", "-1",
                     "1e3", "nan", "+0.5", "", "abc", " 1", "٣", "100",
                     "101", "0.0000000001"]),
    st.decimals(min_value=0, max_value=4, places=2).map(str))
KEYS = st.sampled_from(["tpu_limit", "tpu_request_limit", "tpu_request",
                        "tpu_mem", "tpu_model", "priority", "group_name",
                        "group_headcount", "group_threshold", "tenant",
                        "runtime_estimate", "other"])


@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.dictionaries(KEYS, st.one_of(NUMBERS,
                                       st.sampled_from(["g", "team-a",
                                                        "-x", "h100"])),
                       max_size=6),
       st.sampled_from(["default", "ns-1"]))
def test_parse_pod_matches_the_reference_on_drawn_labels(raw, namespace):
    labels = {JC.DOMAIN + k: v for k, v in raw.items()}
    assert parsed(tlabels, tlabels.Pod, labels, namespace) \
        == parsed(jlabels, JPod, labels, namespace)


# ---- the server, the daemon, the install step, the manifests -------------


def _post(port, path, body):
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=5) as resp:
        return json.loads(resp.read())


def test_server_mutates_and_answers_health():
    server = twebhook.WebhookServer(host="127.0.0.1", port=0).start()
    try:
        out = _post(server.port, "/mutate",
                    json.dumps(review(pod())).encode())
        assert out["response"]["uid"] == "u-123"
        assert decoded(out) == twebhook.mutate_pod(pod())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/healthz", timeout=5) as r:
            assert r.read() == b"ok"
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(server.port, "/mutate", b"not json")
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(server.port, "/elsewhere", b"{}")
        assert err.value.code == 404
    finally:
        server.stop()


def test_daemon_starts_serves_and_stops_on_sigterm():
    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeshare_tpu_torch.cmd.webhook",
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                out = _post(port, "/mutate",
                            json.dumps(review(pod())).encode())
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() < deadline, "daemon never served"
                time.sleep(0.2)
        assert decoded(out) == twebhook.mutate_pod(pod())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()


def test_install_writes_the_interposer_atomically(tmp_path, build):  # noqa: F811
    shim, mock, app = build
    dest = tmp_path / "library"
    path = native.install_interposer(dest)
    assert path == dest / "libcuda_interposer.so"
    assert sorted(os.listdir(dest)) == ["libcuda_interposer.so"]
    assert path.read_bytes() == native.build_interposer().read_bytes()
    again = native.install_interposer(dest)      # a reinstall replaces it
    assert again == path and sorted(os.listdir(dest)) == [path.name]
    # the installed library loads under the mock driver and counts
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBESHARE_")}
    env.update(LD_PRELOAD=str(path), KUBESHARE_CUDA_REAL=mock)
    out = subprocess.run(
        [app, "launch", "direct", "kernel", "2", "0", "0", "stats"],
        env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    stats = json.loads(out.stdout.splitlines()[-1])
    assert stats["shim"]["mode"] == "passthrough"
    assert stats["shim"]["ungated"] == 2
    assert stats["mock"]["cuLaunchKernel"] == 2


def test_install_command_line(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "kubeshare_tpu_torch.runtime.native",
         "--install", str(tmp_path / "lib")], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path / "lib" /
                                     "libcuda_interposer.so")


def _commands(doc):
    spec = doc.get("spec", {})
    spec = spec.get("template", {}).get("spec", spec)
    for key in ("initContainers", "containers"):
        for container in spec.get(key, []) or []:
            yield container["command"]


@pytest.mark.parametrize("name", ["webhook.yaml", "node-daemon.yaml"])
def test_manifests_run_only_the_ports_entry_points(name):
    docs = [d for d in yaml.safe_load_all(
        (ROOT / "deploy" / "torch" / name).read_text()) if d]
    commands = [c for d in docs for c in _commands(d)]
    assert commands
    for command in commands:
        assert command[:2] == ["python", "-m"], command
        module = command[2]
        assert module.startswith("kubeshare_tpu_torch."), command
        assert importlib.util.find_spec(module) is not None, module
    text = (ROOT / "deploy" / "torch" / name).read_text()
    assert "kubeshare_tpu " not in text and "- kubeshare_tpu\n" not in text


def test_webhook_manifest_points_at_the_daemon():
    docs = {d["kind"]: d for d in yaml.safe_load_all(
        (ROOT / "deploy" / "torch" / "webhook.yaml").read_text()) if d}
    hook = docs["MutatingWebhookConfiguration"]["webhooks"][0]
    assert hook["clientConfig"]["service"]["path"] == "/mutate"
    assert hook["rules"][0]["resources"] == ["pods"]
    command = docs["Deployment"]["spec"]["template"]["spec"][
        "containers"][0]["command"]
    assert command[2] == "kubeshare_tpu_torch.cmd.webhook"
    assert "--port=9443" in command
    daemon = yaml.safe_load(
        (ROOT / "deploy" / "torch" / "node-daemon.yaml").read_text())
    init = daemon["spec"]["template"]["spec"]["initContainers"][0]
    assert init["command"][2:] == ["kubeshare_tpu_torch.runtime.native",
                                   "--install", constants.LIBRARY_PATH]
