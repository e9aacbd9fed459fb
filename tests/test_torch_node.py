"""The port's node plane against the JAX package's, in one process.

- the config daemon: the same requirement samples give byte-identical
  ``config/`` and ``podmanagerport/`` files, stale-zeroing included, and
  each side reads the other's files;
- the launcher against live ``tpu-schd``/``tpu-pmgr`` (built from
  ``runtime_native/`` when missing): fan-out, reconcile, a killed child
  restarted, per-pod usage over HTTP;
- ``NativeTokenClient`` beside the JAX one on the same arbiter;
- ``NvmlChipBackend`` over a mock ``libnvidia-ml.so.1`` built here with
  g++ (one GPU; the same GPU with MIG on and two instances; a node
  without the library), its rows rendered as the JAX collector renders
  them, and an HGX H100 inventory bound to ``deploy/config/h100-hgx.yaml``
  by the JAX scheduler;
- the port's CLIs take the JAX CLIs' flags.
"""

import ctypes
import os
import pathlib
import socket
import subprocess
import time
import urllib.request

import pytest

from kubeshare_tpu.cells import load_topology
from kubeshare_tpu.cells.cell import ChipInfo as JaxChipInfo
from kubeshare_tpu.cluster.fake import FakeCluster
from kubeshare_tpu.cmd import collector as jax_collector_cmd
from kubeshare_tpu.cmd import launcher as jax_launcher_cmd
from kubeshare_tpu.cmd import nodeconfig as jax_nodeconfig_cmd
from kubeshare_tpu.metrics.collector import Collector as JaxCollector
from kubeshare_tpu.metrics.collector import FakeChipBackend as JaxFakeBackend
from kubeshare_tpu.metrics.scrape import scrape_capacity as jax_scrape_capacity
from kubeshare_tpu.nodeconfig import files as jax_files
from kubeshare_tpu.nodeconfig.daemon import NodeConfigDaemon as JaxDaemon
from kubeshare_tpu.runtime.client import NativeTokenClient as JaxNativeClient
from kubeshare_tpu.scheduler import constants as jax_constants
from kubeshare_tpu.scheduler.plugin import TpuShareScheduler
from kubeshare_tpu.utils import expfmt as jax_expfmt

from kubeshare_tpu_torch import constants
from kubeshare_tpu_torch.cmd import collector as collector_cmd
from kubeshare_tpu_torch.cmd import launcher as launcher_cmd
from kubeshare_tpu_torch.cmd import nodeconfig as nodeconfig_cmd
from kubeshare_tpu_torch.metrics.collector import (
    ChipInfo,
    Collector,
    NvmlChipBackend,
)
from kubeshare_tpu_torch.metrics.scrape import (
    capacity_from_samples,
    scrape_capacity,
)
from kubeshare_tpu_torch.nodeconfig import files
from kubeshare_tpu_torch.nodeconfig.daemon import NodeConfigDaemon
from kubeshare_tpu_torch.runtime.client import NativeTokenClient, TokenClient
from kubeshare_tpu_torch.runtime.launcher import NodeLauncher
from kubeshare_tpu_torch.utils import expfmt

ROOT = pathlib.Path(__file__).resolve().parents[1]
GIB = 1 << 30


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for_port(port, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
            return
        except OSError:
            time.sleep(0.05)
    raise TimeoutError(f"port {port} never came up")


def test_constants_are_the_schedulers():
    for name in ("ENV_POD_MANAGER_PORT", "ENV_POD_NAME", "ENV_HBM_LIMIT",
                 "ENV_LIBRARY_PATH", "LIBRARY_PATH", "LOG_DIR", "CONFIG_DIR",
                 "PORT_DIR", "POD_MANAGER_PORT_START",
                 "POD_MANAGER_PORT_COUNT", "CHIP_ARBITER_BASE_PORT"):
        assert getattr(constants, name) == getattr(jax_constants, name), name


# ---- the config daemon and its files --------------------------------------

def _requirements(sample_cls, pods):
    """tpu_requirement samples as the aggregator writes them:
    (node, namespace, pod, limit, request, memory, uuids, port)."""
    return [sample_cls("tpu_requirement", {
        "node": node, "namespace": ns, "pod": pod, "limit": limit,
        "request": request, "memory": memory, "uuid": uuid, "port": port,
    }, 1.0) for node, ns, pod, limit, request, memory, uuid, port in pods]


PODS = [
    ("n1", "default", "mnist-1", "1.0", "0.5", str(2 * GIB), "gpu-a", "50050"),
    ("n1", "default", "mnist-2", "0.5", "0.25", "0", "gpu-a", "50051"),
    ("n1", "team", "trainer", "1", "0.3", "0", "gpu-b", "50052"),
    ("n1", "team", "gang", "0.4", "0.4", "0", "gpu-a,gpu-b", "50053"),
    ("n1", "default", "whole", "2.0", "2.0", "0", "gpu-c", "50054"),
    ("n1", "default", "broken", "1.0", "0.5", "abc", "gpu-b", "50055"),
    ("n2", "default", "elsewhere", "1.0", "0.5", "0", "gpu-z", "50056"),
]


def _tree(base):
    return {str(p.relative_to(base)): p.read_bytes()
            for p in sorted(pathlib.Path(base).rglob("*")) if p.is_file()}


def test_daemon_files_are_byte_identical(tmp_path):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    pods = list(PODS)
    jax_daemon = JaxDaemon("n1", str(jax_dir), lambda: _requirements(
        jax_expfmt.Sample, pods))
    daemon = NodeConfigDaemon("n1", str(port_dir), lambda: _requirements(
        expfmt.Sample, pods))
    for d in (jax_daemon, daemon):
        d.ensure_chip_files(["gpu-a", "gpu-b", "gpu-idle"])
    assert daemon.sync() == jax_daemon.sync() == {
        "gpu-a": 3, "gpu-b": 2, "gpu-idle": 0}
    first = _tree(port_dir)
    assert first == _tree(jax_dir)
    assert first["config/gpu-a"] == (
        b"3\ndefault/mnist-1 1 0.5 2147483648\ndefault/mnist-2 0.5 0.25 0\n"
        b"team/gang 0.4 0.4 0\n")
    assert first["podmanagerport/gpu-b"] == (
        b"2\nteam/gang 50053\nteam/trainer 50052\n")
    # every pod of gpu-b leaves: its files are zeroed, not deleted
    pods[:] = [p for p in pods if "gpu-b" not in p[6]]
    assert daemon.sync() == jax_daemon.sync()
    assert _tree(port_dir) == _tree(jax_dir)
    assert _tree(port_dir)["config/gpu-b"] == b"0\n"
    assert _tree(port_dir)["podmanagerport/gpu-b"] == b"0\n"


def test_files_round_trip_both_ways(tmp_path):
    config = [files.ConfigEntry("ns/a", 1.0, 0.5, 7), files.ConfigEntry(
        "ns/b", 0.25, 0.125, 0)]
    ports = [files.PortEntry("ns/a", 50050), files.PortEntry("ns/b", 50051)]
    jax_config = [jax_files.ConfigEntry(e.pod, e.limit, e.request, e.memory)
                  for e in config]
    jax_ports = [jax_files.PortEntry(e.pod, e.port) for e in ports]
    port_base, jax_base = str(tmp_path / "port"), str(tmp_path / "jax")
    files.write_config_file(port_base, "u1", config)
    files.write_port_file(port_base, "u1", ports)
    jax_files.write_config_file(jax_base, "u2", jax_config)
    jax_files.write_port_file(jax_base, "u2", jax_ports)
    assert jax_files.read_config_file(
        os.path.join(port_base, "config", "u1")) == jax_config
    assert jax_files.read_port_file(
        os.path.join(port_base, "podmanagerport", "u1")) == jax_ports
    assert files.read_config_file(
        os.path.join(jax_base, "config", "u2")) == config
    assert files.read_port_file(
        os.path.join(jax_base, "podmanagerport", "u2")) == ports
    files.write_config_file(port_base, "u0", [])
    assert files.list_chip_files(port_base) == jax_files.list_chip_files(
        port_base) == ["u0", "u1"]
    assert files.read_config_file(
        os.path.join(port_base, "config", "u0")) == []
    assert files.list_chip_files(str(tmp_path / "none")) == []


# ---- the launcher against live binaries ----------------------------------

@pytest.fixture
def launcher(tmp_path):
    base = str(tmp_path)
    files.write_config_file(base, "gpu-0", [
        files.ConfigEntry("default/x", 1.0, 0.5, 0)])
    node = NodeLauncher(base, ["gpu-0"], base_port=free_port(),
                        base_quota_ms=50, min_quota_ms=5, window_ms=1000)
    try:
        node.start_arbiters()
        wait_for_port(node.chips["gpu-0"].port)
        yield node, base
    finally:
        node.shutdown()


def test_launcher_fans_out_and_reconciles(launcher):
    node, base = launcher
    pod_port = free_port()
    files.write_port_file(base, "gpu-0", [files.PortEntry("default/x",
                                                          pod_port)])
    node.reconcile()
    wait_for_port(pod_port)
    # the pod manager pins the pod's identity whatever the client says
    with TokenClient("127.0.0.1", pod_port, pod="ignored") as c:
        c.acquire()
        c.release(1.0)
        assert {s.pod for s in c.stats()} == {"default/x"}
    # the pod vanishes from the port file: its manager is stopped
    time.sleep(1.1)     # a distinct mtime second for the reconcile diff
    files.write_port_file(base, "gpu-0", [])
    node.reconcile()
    time.sleep(0.2)
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", pod_port), timeout=0.3)
    assert node.chips["gpu-0"].pod_managers == {}


def test_launcher_restarts_dead_children(launcher):
    node, base = launcher
    chip = node.chips["gpu-0"]
    pod_port = free_port()
    files.write_port_file(base, "gpu-0", [files.PortEntry("default/x",
                                                          pod_port)])
    node.reconcile()
    wait_for_port(pod_port)
    old = (chip.scheduler_proc.pid,
           [p.pid for p in chip.pod_managers.values()])
    chip.scheduler_proc.kill()
    chip.scheduler_proc.wait()
    for proc in chip.pod_managers.values():
        proc.kill()
        proc.wait()
    node.reconcile()        # no file change: liveness alone restarts them
    wait_for_port(chip.port)
    wait_for_port(pod_port)
    assert chip.scheduler_proc.pid != old[0]
    assert [p.pid for p in chip.pod_managers.values()] != old[1]
    with TokenClient("127.0.0.1", pod_port) as c:
        assert c.ping()


def test_launcher_usage_metrics_over_http(launcher):
    node, _ = launcher
    chip = node.chips["gpu-0"]
    server = None
    try:
        with TokenClient("127.0.0.1", chip.port, pod="default/x") as c:
            c.acquire()
            c.release(12.5)
            assert c.request_memory(4096)[0]
            server = node.serve_metrics(host="127.0.0.1")
            url = f"http://127.0.0.1:{server.port}/metrics"
            samples = expfmt.parse(
                urllib.request.urlopen(url, timeout=5).read().decode())
        [usage] = expfmt.select(samples, "tpu_pod_window_usage_ms",
                                pod="default/x")
        assert usage.labels["chip"] == "gpu-0" and usage.value >= 12.5
        [used] = expfmt.select(samples, "tpu_pod_hbm_used_bytes",
                               pod="default/x")
        [cap] = expfmt.select(samples, "tpu_pod_hbm_cap_bytes",
                              pod="default/x")
        assert (used.value, cap.value) == (4096, 0)
        [up] = expfmt.select(samples, "tpu_chip_arbiter_up")
        assert up.value == 1
        # a dead arbiter: up 0, no usage rows, the endpoint still serves
        chip.scheduler_proc.kill()
        chip.scheduler_proc.wait()
        samples = expfmt.parse(
            urllib.request.urlopen(url, timeout=5).read().decode())
        assert [s.value for s in samples] == [0.0]
    finally:
        if server is not None:
            server.stop()


def test_native_client_beside_the_jax_one(launcher):
    node, _ = launcher
    port = node.chips["gpu-0"].port
    ours = NativeTokenClient("127.0.0.1", port)   # builds libtpuhook.so
    theirs = JaxNativeClient("127.0.0.1", port)
    try:
        for client in (ours, theirs):
            assert client.acquire() > 0
            client.release(3.0)
            assert client.request_memory(10) == (True, 0, 0)
        with TokenClient("127.0.0.1", port) as c:
            # both connections speak as KUBESHARE_POD_NAME or "-"
            stats = {s.pod: s for s in c.stats()}
        assert set(stats) == {"default/x"}
    finally:
        ours.close()
        theirs.close()
    with pytest.raises(FileNotFoundError):
        NativeTokenClient("127.0.0.1", port, lib_path="/nonexistent.so")


# ---- the NVML inventory over a mock libnvidia-ml.so.1 --------------------

MOCK_NVML = r"""
// A mock NVML: `gpus` GPUs named `name`; with MIG on, GPU 0 holds two
// instances in slots 0 and 2 of 7.
#include <cstdio>
#include <cstring>

struct Dev { int gpu; int slot; };  // slot -1: the GPU itself
static Dev gpus_[8], migs_[8][7];
static int n_gpus = 1, mig_on = 0, inits = 0, shutdowns = 0;
static char name_[96] = "NVIDIA H100 80GB HBM3";
static const unsigned long long kTotal = 85520809984ULL;

extern "C" {
void mock_nvml_configure(int gpus, int mig, const char* name) {
  n_gpus = gpus;
  mig_on = mig;
  std::snprintf(name_, sizeof(name_), "%s", name);
}
int mock_nvml_inits() { return inits; }
int mock_nvml_shutdowns() { return shutdowns; }
int nvmlInit_v2() { ++inits; return 0; }
int nvmlShutdown() { ++shutdowns; return 0; }
int nvmlDeviceGetCount_v2(unsigned* n) { *n = n_gpus; return 0; }
int nvmlDeviceGetHandleByIndex_v2(unsigned i, Dev** h) {
  if (static_cast<int>(i) >= n_gpus) return 2;
  gpus_[i] = {static_cast<int>(i), -1};
  *h = &gpus_[i];
  return 0;
}
int nvmlDeviceGetUUID(Dev* d, char* buf, unsigned len) {
  if (d->slot < 0)
    std::snprintf(buf, len, "GPU-%08d-0000-0000-0000-000000000000", d->gpu);
  else
    std::snprintf(buf, len, "MIG-%08d-0000-0000-0000-00000000000%d", d->gpu,
                  d->slot);
  return 0;
}
int nvmlDeviceGetName(Dev* d, char* buf, unsigned len) {
  if (d->slot < 0) std::snprintf(buf, len, "%s", name_);
  else std::snprintf(buf, len, "%s MIG 3g.40gb", name_);
  return 0;
}
int nvmlDeviceGetMemoryInfo(Dev* d, unsigned long long* mem) {
  mem[0] = d->slot < 0 ? kTotal : 40ULL << 30;  // total, free, used
  mem[1] = mem[0];
  mem[2] = 0;
  return 0;
}
int nvmlDeviceGetMigMode(Dev* d, unsigned* current, unsigned* pending) {
  *current = *pending = (mig_on && d->gpu == 0) ? 1 : 0;
  return 0;
}
int nvmlDeviceGetMaxMigDeviceCount(Dev*, unsigned* n) { *n = 7; return 0; }
int nvmlDeviceGetMigDeviceHandleByIndex(Dev* d, unsigned j, Dev** h) {
  if (j != 0 && j != 2) return 6;  // NVML_ERROR_NOT_FOUND: an empty slot
  migs_[d->gpu][j] = {d->gpu, static_cast<int>(j)};
  *h = &migs_[d->gpu][j];
  return 0;
}
}
"""


@pytest.fixture(scope="module")
def nvml(tmp_path_factory):
    """The mock library's path and a handle to configure it."""
    out = tmp_path_factory.mktemp("nvml")
    (out / "mock_nvml.cc").write_text(MOCK_NVML)
    lib = out / "libnvidia-ml.so.1"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(lib), str(out / "mock_nvml.cc")], check=True,
                   timeout=120)
    handle = ctypes.CDLL(str(lib))
    handle.mock_nvml_configure.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_char_p]
    return str(lib), handle


def _jax_render(chips, node="n1"):
    jax_chips = [JaxChipInfo(c.uuid, c.model, c.memory, c.index, c.parent)
                 for c in chips]
    return JaxCollector(node, JaxFakeBackend(jax_chips),
                        clock=lambda: 5.0).render()


def _samples(text):
    return [(s.name, s.labels, s.value) for s in expfmt.parse(text)]


def test_nvml_backend_one_gpu_then_mig(nvml):
    path, mock = nvml
    mock.mock_nvml_configure(1, 0, b"NVIDIA H100 80GB HBM3")
    backend = NvmlChipBackend(path)
    gpu = "GPU-00000000-0000-0000-0000-000000000000"
    assert backend.enumerate() == [
        ChipInfo(gpu, "nvidia-h100-80gb-hbm3", 85520809984, 0)]
    assert backend.mig_mode(0) == 0
    collector = Collector("n1", backend, clock=lambda: 5.0)
    assert _samples(collector.render()) == _samples(
        _jax_render(backend.enumerate()))

    # MIG on: the instances take the GPU's place, parent = the GPU
    mock.mock_nvml_configure(1, 1, b"NVIDIA H100 80GB HBM3")
    rows = backend.enumerate()
    assert rows == [
        ChipInfo("MIG-00000000-0000-0000-0000-000000000000",
                 "nvidia-h100-80gb-hbm3-mig-3g.40gb", 40 * GIB, 0, gpu),
        ChipInfo("MIG-00000000-0000-0000-0000-000000000002",
                 "nvidia-h100-80gb-hbm3-mig-3g.40gb", 40 * GIB, 1, gpu),
    ]
    assert backend.mig_mode(0) == 1
    text = collector.render()
    assert _samples(text) == _samples(_jax_render(rows))
    assert [s.labels["parent"] for s in expfmt.parse(text)] == [gpu, gpu]
    shutdowns = mock.mock_nvml_shutdowns()
    backend.close()
    assert mock.mock_nvml_shutdowns() == shutdowns + 1
    backend.close()     # a second close does nothing
    assert mock.mock_nvml_shutdowns() == shutdowns + 1


def test_nvml_backend_without_a_driver(tmp_path):
    backend = NvmlChipBackend(str(tmp_path / "libnvidia-ml.so.1"))
    assert backend.enumerate() == []
    assert backend.mig_mode(0) is None
    backend.close()


def test_hgx_inventory_feeds_the_scheduler(nvml):
    """Eight fake-NVML H100s -> the port's collector -> the JAX scrape
    -> the JAX scheduler over deploy/config/h100-hgx.yaml."""
    from kubeshare_tpu.cluster.api import Pod

    path, mock = nvml
    mock.mock_nvml_configure(8, 0, b"NVIDIA H100 80GB HBM3")
    backend = NvmlChipBackend(path)
    rows = backend.enumerate()
    assert [c.index for c in rows] == list(range(8))
    assert {c.model for c in rows} == {"nvidia-h100-80gb-hbm3"}
    topo = load_topology(str(ROOT / "deploy" / "config" / "h100-hgx.yaml"))
    [node] = topo.cells
    server = Collector(node.cell_id, backend).serve(host="127.0.0.1", port=0)
    try:
        url = f"http://127.0.0.1:{server.port}/metrics"
        inventory = jax_scrape_capacity(url)
        assert [c.uuid for c in scrape_capacity(url)[node.cell_id]] == [
            c.uuid for c in inventory[node.cell_id]]
        cluster = FakeCluster()
        cluster.add_node(node.cell_id)
        sched = TpuShareScheduler(
            str(ROOT / "deploy" / "config" / "h100-hgx.yaml"), cluster,
            inventory=lambda name: inventory.get(name, []))
        pods = [cluster.create_pod(Pod(
            name=f"p{i}", namespace="default", labels={
                jax_constants.LABEL_TPU_REQUEST: "0.5",
                jax_constants.LABEL_TPU_LIMIT: "1.0",
                jax_constants.LABEL_TPU_MODEL: "nvidia-h100-80gb-hbm3"},
            scheduler_name=jax_constants.SCHEDULER_NAME)) for i in range(3)]
        for pod in pods:
            assert sched.schedule_one(pod).status == "bound"
            assert pod.annotations[jax_constants.ANNOTATION_CHIP_UUID] in {
                c.uuid for c in rows}
    finally:
        server.stop()
        backend.close()


def test_capacity_samples_skip_malformed_rows():
    samples = expfmt.parse(
        'tpu_capacity{node="n1",uuid="u1",model="m",memory="abc"} 1\n'
        'tpu_capacity{node="n1",uuid="u2",model="m",memory="512",'
        'index="3",parent="g"} 1\n')
    assert capacity_from_samples(samples) == {
        "n1": [ChipInfo("u2", "m", 512, 3, "g")]}


# ---- the CLIs ------------------------------------------------------------

@pytest.mark.parametrize("ours,theirs,argv", [
    (nodeconfig_cmd, jax_nodeconfig_cmd,
     ["--aggregator-url", "http://agg:9005/metrics", "--node-name", "n1",
      "--base-dir", "/tmp/k", "--interval", "2", "--chips", "a,b", "--once",
      "--level", "2", "--log-dir", "/tmp/log"]),
    (collector_cmd, jax_collector_cmd,
     ["--node-name", "n1", "--host", "127.0.0.1", "--port", "0",
      "--fake-chips", "2", "--fake-model", "m", "--subcores", "auto"]),
    (launcher_cmd, jax_launcher_cmd,
     ["--base-dir", "/tmp/k", "--chips", "a,b", "--schd-binary", "s",
      "--pmgr-binary", "p", "--base-port", "40000", "--base-quota-ms", "30",
      "--min-quota-ms", "3", "--window-ms", "1000", "--lease-slots", "1",
      "--poll-interval", "0.1", "--metrics-port", "9100"]),
], ids=["nodeconfig", "collector", "launcher"])
def test_cli_takes_the_jax_flags(ours, theirs, argv):
    assert vars(ours.build_parser().parse_args(argv)) == vars(
        theirs.build_parser().parse_args(argv))
    required = ["--aggregator-url", "u"] if ours is nodeconfig_cmd else []
    assert vars(ours.build_parser().parse_args(required)) == vars(
        theirs.build_parser().parse_args(required))


def test_collector_cli_fake_chips(tmp_path):
    args = collector_cmd.build_parser().parse_args(
        ["--node-name", "n1", "--fake-chips", "2"])
    rows = collector_cmd.make_backend(args).enumerate()
    assert [c.uuid for c in rows] == ["n1-fake-0", "n1-fake-1"]
    assert {c.model for c in rows} == {"tpu-v5e"}


def test_nodeconfig_cli_once(tmp_path):
    """``--once`` scrapes a served requirement endpoint and writes the
    files; an unreachable aggregator writes nothing and returns 1."""
    from kubeshare_tpu_torch.utils.httpserv import MetricServer

    text = expfmt.render(_requirements(expfmt.Sample, PODS))
    server = MetricServer(host="127.0.0.1", port=0)
    server.route("/metrics", lambda: text)
    server.start()
    try:
        rc = nodeconfig_cmd.main([
            "--aggregator-url", f"http://127.0.0.1:{server.port}/metrics",
            "--node-name", "n1", "--base-dir", str(tmp_path / "ok"),
            "--once", "--level", "0"])
    finally:
        server.stop()
    assert rc == 0
    assert files.list_chip_files(str(tmp_path / "ok")) == ["gpu-a", "gpu-b"]
    rc = nodeconfig_cmd.main([
        "--aggregator-url", f"http://127.0.0.1:{free_port()}/metrics",
        "--base-dir", str(tmp_path / "down"), "--once", "--level", "0"])
    assert rc == 1
    assert not (tmp_path / "down").exists()


def test_node_bench_pods_files_and_envs(tmp_path, monkeypatch):
    """``bench/node.py``'s two pods through the config daemon, and the
    env each of its pod modes starts a pod with."""
    from kubeshare_tpu_torch.bench import node as node_bench
    from kubeshare_tpu_torch.runtime import interposer
    from kubeshare_tpu_torch.runtime.native import build_interposer

    ports = {"pod-a": 50100, "pod-b": 50101}
    daemon = NodeConfigDaemon(node_bench.NODE, str(tmp_path), lambda: (
        node_bench.requirement_samples("GPU-x", ports)))
    assert daemon.sync() == {"GPU-x": 2}
    assert files.read_config_file(str(tmp_path / "config" / "GPU-x")) == [
        files.ConfigEntry("smoke/pod-a", 1.0, 0.5, 0),
        files.ConfigEntry("smoke/pod-b", 1.0, 0.5, node_bench.POD_B_CAP)]
    assert files.read_port_file(str(tmp_path / "podmanagerport" / "GPU-x")
                                ) == [files.PortEntry("smoke/pod-a", 50100),
                                      files.PortEntry("smoke/pod-b", 50101)]

    real = tmp_path / "libcuda.so.1"
    real.write_bytes(b"")
    monkeypatch.setenv(interposer.ENV_REAL, str(real))
    monkeypatch.setenv(constants.ENV_POD_MANAGER_PORT, "1")
    monkeypatch.setenv("LD_PRELOAD", "/lib/other.so")
    shim = str(build_interposer())
    envs = {mode: node_bench._pod_env(50100, "smoke/pod-a", mode)
            for mode in node_bench.COST_MODES}
    assert all(env[constants.ENV_POD_NAME] == "smoke/pod-a"
               for env in envs.values())
    assert "LD_PRELOAD" not in envs["plain"]
    assert constants.ENV_POD_MANAGER_PORT not in envs["plain"]
    assert constants.ENV_POD_MANAGER_PORT not in envs["passthrough"]
    assert envs["interposer"][constants.ENV_POD_MANAGER_PORT] == "50100"
    for mode in ("passthrough", "interposer"):
        assert envs[mode]["LD_PRELOAD"] == shim
        assert envs[mode][interposer.ENV_REAL] == str(real)
