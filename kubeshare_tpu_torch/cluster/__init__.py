"""The control plane's edge to a CUDA node (port of the device-specific
part of ``kubeshare_tpu/cluster``): the admission webhook that wires a
fractional pod to the CUDA interposer, and the label parsing it needs.
The rest of the reference's control plane never touches a device and is
not ported."""

from .labels import LabelError, PodKind, parse_pod
from .webhook import WebhookServer, mutate_pod, review_response

__all__ = ["LabelError", "PodKind", "WebhookServer", "mutate_pod",
           "parse_pod", "review_response"]
