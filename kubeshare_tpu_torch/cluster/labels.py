"""The workload labels the admission webhook reads (a copy of what
``kubeshare_tpu/cluster/webhook.py::mutate_pod`` needs from
``kubeshare_tpu/scheduler/labels.py`` and ``scheduler/constants.py``,
with the same names and semantics).

Pods opt in with ``spec.schedulerName: kubeshare-tpu-scheduler`` and
``sharedtpu/*`` labels. ``parse_pod`` applies the scheduler's admission
matrix:

- no ``sharedtpu/tpu_*`` labels        -> regular pod (not ours to place)
- fractional (limit <= 1.0)            -> 0 <= request <= limit
- multi-device (limit > 1.0)           -> integer, request == limit
- ``tpu_mem`` optional, bytes >= 0
- ``priority`` 0 (or unset) = opportunistic, 1..100 = guarantee
- gang labels: group_name + headcount >= 1 + threshold in (0, 1];
  ``min_available = floor(headcount * threshold + 0.5)``

The label names keep the reference's ``sharedtpu/`` domain: they are the
scheduler's contract, whatever the device.
"""

from __future__ import annotations

import enum
import math
import re
from dataclasses import dataclass, field
from typing import Dict, Optional

SCHEDULER_NAME = "kubeshare-tpu-scheduler"

DOMAIN = "sharedtpu/"

# ---- input labels (set by the user) --------------------------------
LABEL_GROUP_NAME = DOMAIN + "group_name"          # gang name
LABEL_GROUP_HEADCOUNT = DOMAIN + "group_headcount"  # total pods in gang
LABEL_GROUP_THRESHOLD = DOMAIN + "group_threshold"  # min fraction to start
LABEL_PRIORITY = DOMAIN + "priority"              # 1..100 guarantee, 0/unset opportunistic
LABEL_TPU_LIMIT = DOMAIN + "tpu_request_limit"    # burst ceiling (device fraction)
LABEL_TPU_REQUEST = DOMAIN + "tpu_request"        # guaranteed device fraction
LABEL_TPU_MEMORY = DOMAIN + "tpu_mem"             # device memory bytes cap
LABEL_TPU_MODEL = DOMAIN + "tpu_model"            # device generation pin
LABEL_TENANT = DOMAIN + "tenant"                  # quota tenant override
                                                  # (default: namespace)
LABEL_RUNTIME_ESTIMATE = DOMAIN + "runtime_estimate"  # declared expected
                                                  # runtime (seconds)

# compat aliases: accept the short names used in docs/examples too
LABEL_TPU_LIMIT_ALIASES = (LABEL_TPU_LIMIT, DOMAIN + "tpu_limit")

_EPS = 1e-9
# digits with an optional decimal part, ASCII only: "1e3", "nan", "inf"
# and "+0.5" are label errors, and NaN never reaches a comparison
_NUM_RE = re.compile(r"\d+(\.\d+)?", re.ASCII)
# k8s label-value syntax for tenant names
_TENANT_RE = re.compile(
    r"[A-Za-z0-9]([A-Za-z0-9._-]{0,61}[A-Za-z0-9])?", re.ASCII
)


@dataclass
class Pod:
    """The part of a pod the labels are read from (the reference's
    ``cluster/api.py::Pod`` carries much more)."""

    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


class PodKind(enum.Enum):
    REGULAR = "regular"        # no device labels
    SHARED = "shared"          # fractional device (limit <= 1.0)
    MULTI_CHIP = "multi_chip"  # whole devices (limit > 1.0)


class LabelError(ValueError):
    pass


@dataclass
class GangSpec:
    name: str
    headcount: int
    threshold: float

    @property
    def min_available(self) -> int:
        return int(math.floor(self.headcount * self.threshold + 0.5))


@dataclass
class PodRequirements:
    kind: PodKind
    limit: float = 0.0
    request: float = 0.0
    memory: int = 0
    model: str = ""
    priority: int = 0
    gang: Optional[GangSpec] = None
    tenant: str = ""  # the quota tenant (label override or namespace)
    est_runtime: float = 0.0  # declared runtime in seconds; 0 = none

    @property
    def is_guarantee(self) -> bool:
        return self.priority > 0

    @property
    def chip_count(self) -> int:
        """Whole devices of a multi-device pod."""
        return int(round(self.request))


def _parse_float(pod: Pod, label: str, raw: str) -> float:
    if _NUM_RE.fullmatch(raw) is None:
        raise LabelError(f"pod {pod.key}: {label}={raw!r} is not a number")
    value = float(raw)
    if value < 0:
        raise LabelError(f"pod {pod.key}: {label}={raw!r} must be >= 0")
    return value


def parse_priority(pod: Pod) -> int:
    raw = pod.labels.get(LABEL_PRIORITY, "")
    if raw == "":
        return 0  # opportunistic by default
    try:
        p = int(raw)
    except ValueError as e:
        raise LabelError(
            f"pod {pod.key}: priority={raw!r} is not an integer") from e
    if not 0 <= p <= 100:
        raise LabelError(f"pod {pod.key}: priority={p} must be in 0..100")
    return p


def parse_tenant(pod: Pod) -> str:
    """The quota tenant: the ``sharedtpu/tenant`` label, validated, over
    the namespace; an empty or absent label is the namespace."""
    raw = pod.labels.get(LABEL_TENANT, "")
    if not raw:
        return pod.namespace
    if _TENANT_RE.fullmatch(raw) is None:
        raise LabelError(
            f"pod {pod.key}: tenant={raw!r} is not a valid tenant name "
            f"(k8s label-value syntax)"
        )
    return raw


def parse_gang(pod: Pod) -> Optional[GangSpec]:
    name = pod.labels.get(LABEL_GROUP_NAME, "")
    if not name:
        return None
    raw_head = pod.labels.get(LABEL_GROUP_HEADCOUNT, "")
    raw_thresh = pod.labels.get(LABEL_GROUP_THRESHOLD, "")
    if not raw_head or not raw_thresh:
        # incomplete gang labels degrade to a solo pod
        return None
    try:
        headcount = int(raw_head)
        threshold = float(raw_thresh)
    except ValueError as e:
        raise LabelError(
            f"pod {pod.key}: gang labels headcount={raw_head!r} "
            f"threshold={raw_thresh!r} malformed"
        ) from e
    if headcount < 1:
        raise LabelError(
            f"pod {pod.key}: group_headcount={headcount} must be >= 1")
    if not 0 < threshold <= 1.0:
        raise LabelError(
            f"pod {pod.key}: group_threshold={threshold} must be in (0, 1]"
        )
    return GangSpec(name=name, headcount=headcount, threshold=threshold)


def parse_estimate(pod: Pod) -> float:
    """Declared runtime estimate in seconds (0.0 = absent), validated
    like every other numeric label."""
    raw = pod.labels.get(LABEL_RUNTIME_ESTIMATE, "")
    if not raw:
        return 0.0
    return _parse_float(pod, "runtime_estimate", raw)


def parse_pod(pod: Pod) -> PodRequirements:
    """Parse and validate. Raises ``LabelError`` on misconfiguration;
    returns kind=REGULAR for pods with no device labels."""
    priority = parse_priority(pod)
    gang = parse_gang(pod)
    tenant = parse_tenant(pod)
    est_runtime = parse_estimate(pod)

    raw_limit = None
    for label in LABEL_TPU_LIMIT_ALIASES:
        if label in pod.labels:
            raw_limit = pod.labels[label]
            break
    raw_request = pod.labels.get(LABEL_TPU_REQUEST)
    raw_memory = pod.labels.get(LABEL_TPU_MEMORY)

    if raw_limit is None and raw_request is None and raw_memory is None:
        return PodRequirements(
            kind=PodKind.REGULAR, priority=priority, gang=gang,
            tenant=tenant, est_runtime=est_runtime,
        )

    if raw_limit is None:
        raise LabelError(
            f"pod {pod.key}: a TPU pod must set {LABEL_TPU_LIMIT_ALIASES[1]}"
        )
    limit = _parse_float(pod, "tpu_limit", raw_limit)
    request = (
        _parse_float(pod, "tpu_request", raw_request)
        if raw_request is not None
        else 0.0
    )

    if limit == 0.0 and request == 0.0:
        return PodRequirements(
            kind=PodKind.REGULAR, priority=priority, gang=gang,
            tenant=tenant, est_runtime=est_runtime,
        )

    if limit > 1.0 + _EPS:
        # multi-device: integers, request == limit
        if abs(limit - round(limit)) > _EPS:
            raise LabelError(
                f"pod {pod.key}: multi-chip limit={limit} must be an integer"
            )
        if abs(request - limit) > _EPS:
            raise LabelError(
                f"pod {pod.key}: multi-chip pods need request == limit "
                f"(got {request} != {limit})"
            )
        kind = PodKind.MULTI_CHIP
    else:
        if request > limit + _EPS:
            raise LabelError(
                f"pod {pod.key}: request={request} exceeds limit={limit}"
            )
        kind = PodKind.SHARED

    memory = 0
    if raw_memory is not None:
        try:
            memory = int(raw_memory)
        except ValueError as e:
            raise LabelError(
                f"pod {pod.key}: tpu_mem={raw_memory!r} is not an integer"
            ) from e
        if memory < 0:
            raise LabelError(f"pod {pod.key}: tpu_mem={memory} must be >= 0")

    return PodRequirements(
        kind=kind,
        limit=limit,
        request=request,
        memory=memory,
        model=pod.labels.get(LABEL_TPU_MODEL, ""),
        priority=priority,
        gang=gang,
        tenant=tenant,
        est_runtime=est_runtime,
    )
