"""Per-node device-inventory exporter (``tpu_capacity``): a port of
``kubeshare_tpu/metrics/collector.py`` with an NVML backend in place of
``JaxChipBackend``.

Series contract (unchanged, the JAX control plane reads it)::

    tpu_capacity{node, uuid, model, memory, index[, parent]} <timestamp>

One sample per schedulable device; ``memory`` is device memory in bytes
as a label, and the value carries a freshness timestamp.

``NvmlChipBackend`` reads the cards through NVML with ``ctypes`` on the
driver's ``libnvidia-ml.so.1`` (no ``pynvml``). With MIG mode on, each
MIG instance is a row in place of its GPU, ``parent`` naming the GPU:
the branch the reference's NVML collector takes, and the one
``split_subcores`` stands in for on a TPU. Where the library or the
driver is absent it enumerates nothing, so a device-less node serves an
empty inventory.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from ..utils import expfmt
from ..utils.httpserv import MetricServer

CAPACITY_METRIC = "tpu_capacity"
COLLECTOR_PATH = "/kubeshare-tpu-collector"
COLLECTOR_PORT = 9004


@dataclass
class ChipInfo:
    """One schedulable device as the collector reports it (a copy of
    ``kubeshare_tpu/cells/cell.py::ChipInfo``): a whole GPU, or a MIG
    instance (a TensorCore in subcore mode) with ``parent`` naming the
    enclosing device's uuid."""

    uuid: str
    model: str
    memory: int  # device memory, bytes
    index: int = 0
    parent: str = ""


def _normalize_model(device_kind: str) -> str:
    """'NVIDIA H100 80GB HBM3' -> 'nvidia-h100-80gb-hbm3' (spaces to
    dashes, lowercase), as the reference normalises model names."""
    return device_kind.strip().lower().replace(" ", "-")


# TensorCores per TPU generation: the granularity subcore mode splits
# to (kept with split_subcores, whose inventories the scheduler takes)
_CORES_BY_KIND = {
    "tpu v2": 2,
    "tpu v3": 2,
    "tpu v4": 2,
    "tpu v5": 1,
    "tpu v5 lite": 1,
    "tpu v5e": 1,
    "tpu v5p": 2,
    "tpu v6e": 1,
}


def split_subcores(
    chips: Sequence[ChipInfo], cores: int | str = "auto"
) -> List[ChipInfo]:
    """Explode whole-device rows into per-core rows: uuid
    ``<chip>-c<k>``, memory split evenly, ``parent`` pointing back at the
    device. ``cores="auto"`` looks the count up per model and leaves
    single-core models (every GPU) untouched. Rows are re-indexed in
    enumeration order."""
    out: List[ChipInfo] = []
    for chip in chips:
        if isinstance(cores, int):
            n = cores
        else:
            n = _CORES_BY_KIND.get(chip.model.replace("-", " "), 1)
        if n <= 1:
            out.append(chip)
            continue
        for k in range(n):
            out.append(
                ChipInfo(
                    uuid=f"{chip.uuid}-c{k}",
                    model=chip.model,
                    memory=chip.memory // n,
                    parent=chip.uuid,
                )
            )
    for i, chip in enumerate(out):
        chip.index = i
    return out


class SubcoreBackend:
    """Wrap any device backend to enumerate at subcore granularity."""

    def __init__(self, inner, cores: int | str = "auto"):
        self.inner = inner
        self.cores = cores

    def enumerate(self) -> List[ChipInfo]:
        return split_subcores(self.inner.enumerate(), self.cores)


class FakeChipBackend:
    """Deterministic inventory for tests and device-less machines."""

    def __init__(self, chips: Optional[Sequence[ChipInfo]] = None):
        self._chips = list(chips or [])

    def enumerate(self) -> List[ChipInfo]:
        return list(self._chips)

    def set_chips(self, chips: Sequence[ChipInfo]) -> None:
        self._chips = list(chips)


# NVML's return codes and buffer sizes (nvml.h)
NVML_SUCCESS = 0
NVML_DEVICE_MIG_ENABLE = 1
_NVML_BUFFER = 96   # NVML_DEVICE_UUID_V2_BUFFER_SIZE, ..._NAME_V2_...


class _NvmlMemory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


_NVML_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlDeviceGetCount_v2": [ctypes.POINTER(ctypes.c_uint)],
    "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint,
                                      ctypes.POINTER(ctypes.c_void_p)],
    "nvmlDeviceGetUUID": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetName": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetMemoryInfo": [ctypes.c_void_p,
                                ctypes.POINTER(_NvmlMemory)],
    "nvmlDeviceGetMigMode": [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint),
                             ctypes.POINTER(ctypes.c_uint)],
    "nvmlDeviceGetMaxMigDeviceCount": [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_uint)],
    "nvmlDeviceGetMigDeviceHandleByIndex": [
        ctypes.c_void_p, ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)],
}


class NvmlChipBackend:
    """Enumerate the node's NVIDIA GPUs (or their MIG instances) through
    NVML. uuid: NVML's ``GPU-...`` (``MIG-...``) string; model: the
    normalised device name; memory: NVML's total bytes; index: the
    row's place in the enumeration (the GPU's NVML index without MIG).

    NVML is initialised at the first ``enumerate`` and shut down by
    ``close``. A missing library, a failed ``nvmlInit_v2`` or a missing
    entry point gives an empty inventory."""

    def __init__(self, library: str = "libnvidia-ml.so.1"):
        self.library = library
        self._nvml: Optional[ctypes.CDLL] = None

    def _init(self) -> Optional[ctypes.CDLL]:
        if self._nvml is not None:
            return self._nvml
        try:
            lib = ctypes.CDLL(self.library)
            for name, argtypes in _NVML_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        except (OSError, AttributeError):
            return None  # no driver on this node: an empty inventory
        if lib.nvmlInit_v2() != NVML_SUCCESS:
            return None
        self._nvml = lib
        return lib

    def _describe(self, lib: ctypes.CDLL, handle: ctypes.c_void_p
                  ) -> Optional[tuple]:
        """(uuid, model, total memory) of a GPU or MIG handle."""
        uuid = ctypes.create_string_buffer(_NVML_BUFFER)
        name = ctypes.create_string_buffer(_NVML_BUFFER)
        memory = _NvmlMemory()
        if (lib.nvmlDeviceGetUUID(handle, uuid, _NVML_BUFFER) != NVML_SUCCESS
                or lib.nvmlDeviceGetName(handle, name, _NVML_BUFFER)
                != NVML_SUCCESS
                or lib.nvmlDeviceGetMemoryInfo(handle, ctypes.byref(memory))
                != NVML_SUCCESS):
            return None
        return (uuid.value.decode(), _normalize_model(name.value.decode()),
                int(memory.total))

    def _mig_rows(self, lib: ctypes.CDLL, handle: ctypes.c_void_p,
                  parent: str) -> Optional[List[ChipInfo]]:
        """The GPU's MIG instances, or None when MIG mode is off (or
        the GPU cannot say)."""
        current, pending = ctypes.c_uint(), ctypes.c_uint()
        if (lib.nvmlDeviceGetMigMode(handle, ctypes.byref(current),
                                     ctypes.byref(pending)) != NVML_SUCCESS
                or current.value != NVML_DEVICE_MIG_ENABLE):
            return None
        slots = ctypes.c_uint()
        if lib.nvmlDeviceGetMaxMigDeviceCount(
                handle, ctypes.byref(slots)) != NVML_SUCCESS:
            return None
        rows = []
        for j in range(slots.value):
            mig = ctypes.c_void_p()
            # an empty slot answers NVML_ERROR_NOT_FOUND
            if lib.nvmlDeviceGetMigDeviceHandleByIndex(
                    handle, j, ctypes.byref(mig)) != NVML_SUCCESS:
                continue
            row = self._describe(lib, mig)
            if row is not None:
                rows.append(ChipInfo(uuid=row[0], model=row[1],
                                     memory=row[2], parent=parent))
        return rows

    def enumerate(self) -> List[ChipInfo]:
        lib = self._init()
        if lib is None:
            return []
        count = ctypes.c_uint()
        if lib.nvmlDeviceGetCount_v2(ctypes.byref(count)) != NVML_SUCCESS:
            return []
        chips: List[ChipInfo] = []
        for i in range(count.value):
            handle = ctypes.c_void_p()
            if lib.nvmlDeviceGetHandleByIndex_v2(
                    i, ctypes.byref(handle)) != NVML_SUCCESS:
                continue
            row = self._describe(lib, handle)
            if row is None:
                continue
            mig = self._mig_rows(lib, handle, row[0])
            if mig is None:
                chips.append(ChipInfo(uuid=row[0], model=row[1],
                                      memory=row[2]))
            else:
                chips.extend(mig)
        for i, chip in enumerate(chips):
            chip.index = i
        return chips

    def mig_mode(self, index: int = 0) -> Optional[int]:
        """The current MIG mode of GPU ``index`` (0 off, 1 on), or None
        where NVML cannot say."""
        lib = self._init()
        handle = ctypes.c_void_p()
        current, pending = ctypes.c_uint(), ctypes.c_uint()
        if (lib is None
                or lib.nvmlDeviceGetHandleByIndex_v2(
                    index, ctypes.byref(handle)) != NVML_SUCCESS
                or lib.nvmlDeviceGetMigMode(
                    handle, ctypes.byref(current), ctypes.byref(pending))
                != NVML_SUCCESS):
            return None
        return current.value

    def close(self) -> None:
        if self._nvml is not None:
            self._nvml.nvmlShutdown()
            self._nvml = None


class Collector:
    def __init__(
        self,
        node_name: str,
        backend,
        clock: Callable[[], float] = time.time,
    ):
        self.node_name = node_name
        self.backend = backend
        self.clock = clock

    def samples(self) -> List[expfmt.Sample]:
        now = self.clock()
        out = []
        for chip in self.backend.enumerate():
            labels = {
                "node": self.node_name,
                "uuid": chip.uuid,
                "model": chip.model,
                "memory": str(chip.memory),
                "index": str(chip.index),
            }
            if chip.parent:
                labels["parent"] = chip.parent
            out.append(expfmt.Sample(CAPACITY_METRIC, labels, now))
        return out

    def render(self) -> str:
        return expfmt.render(
            self.samples(),
            help_text={CAPACITY_METRIC: "device inventory of this node"},
        )

    def serve(self, host: str = "0.0.0.0", port: int = COLLECTOR_PORT) -> MetricServer:
        server = MetricServer(host=host, port=port)
        server.route(COLLECTOR_PATH, self.render)
        server.route("/metrics", self.render)
        return server.start()
