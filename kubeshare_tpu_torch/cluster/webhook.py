"""Mutating admission webhook for CUDA nodes (the twin of
``kubeshare_tpu/cluster/webhook.py``).

The reference splits the isolation runtime's injection in two: the
placement-independent pieces at admission (this webhook) and the
placement-dependent ones (device uuid, manager port, memory cap) at bind
time. At admission every fractional shared pod gets

- the ``/kubeshare/library`` hostPath volume, mounted read-only in each
  container;
- ``KUBESHARE_LIBRARY_PATH`` = ``/kubeshare/library``;
- ``LD_PRELOAD`` = ``/kubeshare/library/libcuda_interposer.so``: the
  CUDA driver-API interposer (``runtime/csrc/cuda_interposer.cc``, the
  name ``runtime/interposer.py::find_interposer`` looks for), where the
  reference sets ``TPU_LIBRARY_PATH`` to its PJRT shim. The interposer
  loads the real driver by its soname, ``libcuda.so.1``; the webhook
  cannot know the driver's path on the node, so it sets no
  ``KUBESHARE_CUDA_REAL``.

Every gang member also gets ``KUBESHARE_GROUP_HEADCOUNT``. A name
already in a container's env is left alone: a container's own
``LD_PRELOAD`` wins, as a container's own ``TPU_LIBRARY_PATH`` does in
the reference. Which pods count as fractional or as a gang is the
scheduler's own label parsing (``cluster/labels.py``).

The ``admission.k8s.io/v1`` AdmissionReview protocol with JSONPatch
responses; TLS (which kube-apiserver requires of webhooks) through
``--tls-cert``/``--tls-key``; tests post plain HTTP.
"""

from __future__ import annotations

import base64
import copy
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List

from ..constants import (
    ENV_GANG_HEADCOUNT, ENV_LIBRARY_PATH, INTERPOSER_LIBRARY, LIBRARY_PATH,
)
from .labels import SCHEDULER_NAME, LabelError, Pod, PodKind, parse_pod

VOLUME_NAME = "kubeshare-tpu-library"
INTERPOSER_PATH = LIBRARY_PATH + "/" + INTERPOSER_LIBRARY


def mutate_pod(pod: Dict) -> List[Dict]:
    """The JSONPatch for one pod object ([] if it is not ours): the
    library volume and the interposer env for a fractional shared pod,
    the headcount env for any gang member."""
    meta = pod.get("metadata", {})
    labels = meta.get("labels", {}) or {}
    spec = pod.get("spec", {}) or {}
    if spec.get("schedulerName") != SCHEDULER_NAME:
        return []
    try:
        req = parse_pod(Pod(name="admission", labels=dict(labels)))
    except LabelError:
        return []  # the scheduler rejects it with a real message
    fractional = req.kind == PodKind.SHARED
    inject_env: Dict[str, str] = {}
    if fractional:
        inject_env[ENV_LIBRARY_PATH] = LIBRARY_PATH
        inject_env["LD_PRELOAD"] = INTERPOSER_PATH
    if req.gang is not None:
        inject_env[ENV_GANG_HEADCOUNT] = str(req.gang.headcount)
    if not inject_env:
        return []

    patches: List[Dict] = []
    if fractional:
        volumes = spec.get("volumes") or []
        if not any(v.get("name") == VOLUME_NAME for v in volumes):
            volume = {
                "name": VOLUME_NAME,
                "hostPath": {"path": LIBRARY_PATH,
                             "type": "DirectoryOrCreate"},
            }
            if "volumes" in spec:
                patches.append({"op": "add", "path": "/spec/volumes/-",
                                "value": volume})
            else:
                patches.append({"op": "add", "path": "/spec/volumes",
                                "value": [volume]})

    for i, container in enumerate(spec.get("containers", [])):
        if fractional:
            mounts = container.get("volumeMounts") or []
            if not any(m.get("name") == VOLUME_NAME for m in mounts):
                mount = {"name": VOLUME_NAME, "mountPath": LIBRARY_PATH,
                         "readOnly": True}
                if "volumeMounts" in container:
                    patches.append({
                        "op": "add",
                        "path": f"/spec/containers/{i}/volumeMounts/-",
                        "value": mount,
                    })
                else:
                    patches.append({
                        "op": "add",
                        "path": f"/spec/containers/{i}/volumeMounts",
                        "value": [mount],
                    })
        env = container.get("env") or []
        present = {e.get("name") for e in env}
        additions = [{"name": name, "value": value}
                     for name, value in inject_env.items()
                     if name not in present]
        if not additions:
            continue
        if "env" in container:
            for add in additions:
                patches.append({
                    "op": "add",
                    "path": f"/spec/containers/{i}/env/-",
                    "value": add,
                })
        else:
            patches.append({
                "op": "add",
                "path": f"/spec/containers/{i}/env",
                "value": additions,
            })
    return patches


def review_response(review: Dict) -> Dict:
    """AdmissionReview in -> AdmissionReview out (always allowed: the
    webhook only mutates)."""
    request = review.get("request", {}) or {}
    response: Dict = {"uid": request.get("uid", ""), "allowed": True}
    pod = request.get("object") or {}
    if request.get("kind", {}).get("kind") == "Pod":
        patches = mutate_pod(copy.deepcopy(pod))
        if patches:
            response["patchType"] = "JSONPatch"
            response["patch"] = base64.b64encode(
                json.dumps(patches).encode()
            ).decode()
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": response,
    }


class WebhookServer:
    """An HTTPS (or, for tests, HTTP) server of ``POST /mutate`` and
    ``GET /healthz``."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 tls_cert: str = "", tls_key: str = ""):

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                if self.path.rstrip("/") not in ("", "/mutate"):
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    review = json.loads(self.rfile.read(length) or b"{}")
                    body = json.dumps(review_response(review)).encode()
                except (ValueError, KeyError) as e:
                    self.send_error(400, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                # the Deployment's readinessProbe
                body = b"ok"
                self.send_response(200 if self.path == "/healthz" else 404)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if self.path == "/healthz":
                    self.wfile.write(body)

            def log_message(self, *args):
                del args

        self._server = ThreadingHTTPServer((host, port), Handler)
        if tls_cert and tls_key:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            self._server.socket = ctx.wrap_socket(self._server.socket,
                                                  server_side=True)
        self._thread = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "WebhookServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
