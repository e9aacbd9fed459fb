"""The node side's env and file contract (a copy of the subset of
``kubeshare_tpu/scheduler/constants.py`` that the port uses, with the
same names and values).

The scheduler injects the ``KUBESHARE_*`` env and ``TPU_VISIBLE_CHIPS``
into every container of a placed pod; the node config daemon writes the per-device files under
``CONFIG_DIR``'s parent; the launcher starts one ``tpu-schd`` per device
on ``CHIP_ARBITER_BASE_PORT + index`` and one ``tpu-pmgr`` per pod on
the port the scheduler picked from ``POD_MANAGER_PORT_START``.
"""

# ---- env injected into every container of a placed pod -------------
# the pod's device uuid list (comma separated) the scheduler names at
# bind time: NVML's GPU-... / MIG-... strings on an NVIDIA node, which
# CUDA_VISIBLE_DEVICES takes as they are (utils/device.py and the CUDA
# interposer map one onto the other, as libtpu honours it on a TPU)
ENV_VISIBLE_CHIPS = "TPU_VISIBLE_CHIPS"
ENV_CUDA_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"
ENV_POD_MANAGER_PORT = "KUBESHARE_POD_MANAGER_PORT"
ENV_POD_NAME = "KUBESHARE_POD_NAME"            # namespace/name
ENV_HBM_LIMIT = "KUBESHARE_HBM_LIMIT_BYTES"
ENV_LIBRARY_PATH = "KUBESHARE_LIBRARY_PATH"

# hostPath of the node's isolation libraries and binaries, the log
# directory and the per-device files
LIBRARY_PATH = "/kubeshare/library"
# the CUDA interposer's file there: the node's install step writes it,
# the admission webhook preloads it into fractional pods
INTERPOSER_LIBRARY = "libcuda_interposer.so"
LOG_DIR = "/kubeshare/log"
CONFIG_DIR = "/kubeshare/scheduler/config"
PORT_DIR = "/kubeshare/scheduler/podmanagerport"

# ---- operating parameters ------------------------------------------
POD_MANAGER_PORT_START = 50050
POD_MANAGER_PORT_COUNT = 512
CHIP_ARBITER_BASE_PORT = 49901

# ---- the gang env (kubeshare_tpu/parallel/multihost.py) --------------
# the coordinator address of a multi-process gang (set in the workload
# spec, e.g. the gang's headless-service DNS of member 0), its process
# count, this process' id, and the gang headcount the admission webhook
# injects from the pod's gang labels. The names are the pod contract.
ENV_COORDINATOR = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "KUBESHARE_NUM_PROCESSES"
ENV_PROCESS_ID = "KUBESHARE_PROCESS_ID"
ENV_GANG_HEADCOUNT = "KUBESHARE_GROUP_HEADCOUNT"
ENV_JOB_COMPLETION_INDEX = "JOB_COMPLETION_INDEX"
