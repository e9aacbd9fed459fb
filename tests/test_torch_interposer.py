"""The CUDA driver-API interposer (``runtime/csrc/cuda_interposer.cc``)
over a mock libcuda, under live ``tpu-schd`` + ``tpu-pmgr``.

The interposer is built with g++ (``runtime/native.py``), the mock driver
and a test application here, also with g++. The mock counts every call
and hands out fake pointers; it is loaded through ``KUBESHARE_CUDA_REAL``
and is also the application's ``libcuda.so.1``; its ``cuInit`` records
``CUDA_VISIBLE_DEVICES`` as the driver would read it
(``mock_visible_at_init``). The application reaches
the driver by all three lookup paths the CUDA stack uses: a direct link
(calls bind to the preloaded hooks), ``dlopen`` + ``dlsym`` by name, and
``cuGetProcAddress_v2`` with and without the per-thread flag. Its stream
``0xCA`` is capturing; ``MOCK_KERNEL_MS`` queues that much device work a
launch, so an event recorded behind it is not ready until then.
"""

import json
import os
import subprocess

import pytest

from kubeshare_tpu_torch.bench.arbiter import (
    free_port, start_arbiter, start_pod_manager, stop_arbiter,
)
from kubeshare_tpu_torch.nodeconfig.files import ConfigEntry
from kubeshare_tpu_torch.runtime import interposer, native
from kubeshare_tpu_torch.runtime.client import TokenClient

POD = "ns/app"
CAP = 1 << 20
ALLOCATORS = ("cuMemAlloc_v2", "cuMemAllocPitch_v2", "cuMemAllocManaged",
              "cuMemAllocAsync", "cuMemAllocFromPoolAsync", "cuMemCreate")
KINDS = {"kernel": ("launch", "cuLaunchKernel"),
         "ex": ("launch_ex", "cuLaunchKernelEx"),
         "coop": ("launch_cooperative", "cuLaunchCooperativeKernel"),
         "graph": ("graph_launch", "cuGraphLaunch")}

MOCK_LIBCUDA = r"""
// A mock CUDA driver: counts calls and hands out fake pointers.
#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>

typedef int CUresult;
typedef void* CUstream;
typedef void* CUfunction;
typedef unsigned long long CUdeviceptr;
struct Event { double ready_ms = 0; };
struct LaunchConfig {
  unsigned gx, gy, gz, bx, by, bz, smem;
  CUstream stream;
  void* attrs;
  unsigned nattrs;
};

static std::mutex mu;
static std::map<std::string, long long> counts;
static double busy_until = 0;          // the mock device's queue
static CUdeviceptr next_ptr = 0x100000;
static std::string stats_buf;
static std::string visible_at_init = "(no cuInit)";

static double now_ms() {
  using namespace std::chrono;
  return duration<double, std::milli>(steady_clock::now().time_since_epoch())
      .count();
}
static void bump(const char* what, long long by = 1) {
  std::lock_guard<std::mutex> lock(mu);
  counts[what] += by;
}
// each launch queues MOCK_KERNEL_MS of device work
static void queue_work() {
  const char* ms = std::getenv("MOCK_KERNEL_MS");
  double d = ms ? std::atof(ms) : 0.0;
  std::lock_guard<std::mutex> lock(mu);
  busy_until = std::max(busy_until, now_ms()) + d;
}
static const CUstream kCapturing = reinterpret_cast<CUstream>(0xCA);

extern "C" {

#define LAUNCH(name)                                                     \
  CUresult name(CUfunction, unsigned, unsigned, unsigned, unsigned,       \
                unsigned, unsigned, unsigned, CUstream, void**, void**) { \
    bump(#name); queue_work(); return 0; }
LAUNCH(cuLaunchKernel)
LAUNCH(cuLaunchKernel_ptsz)
#define LAUNCH_EX(name)                                                  \
  CUresult name(const LaunchConfig*, CUfunction, void**, void**) {        \
    bump(#name); queue_work(); return 0; }
LAUNCH_EX(cuLaunchKernelEx)
LAUNCH_EX(cuLaunchKernelEx_ptsz)
#define LAUNCH_COOP(name)                                                \
  CUresult name(CUfunction, unsigned, unsigned, unsigned, unsigned,       \
                unsigned, unsigned, unsigned, CUstream, void**) {         \
    bump(#name); queue_work(); return 0; }
LAUNCH_COOP(cuLaunchCooperativeKernel)
LAUNCH_COOP(cuLaunchCooperativeKernel_ptsz)
CUresult cuGraphLaunch(void*, CUstream) { bump("cuGraphLaunch"); queue_work(); return 0; }
CUresult cuGraphLaunch_ptsz(void*, CUstream) { bump("cuGraphLaunch_ptsz"); queue_work(); return 0; }

static CUresult alloc(const char* name, CUdeviceptr* p, size_t bytes) {
  bump(name);
  bump("alloc_bytes", static_cast<long long>(bytes));
  std::lock_guard<std::mutex> lock(mu);
  *p = next_ptr;
  next_ptr += (bytes + 0xfff) & ~0xfffULL;
  return 0;
}
CUresult cuMemAlloc_v2(CUdeviceptr* p, size_t b) { return alloc("cuMemAlloc_v2", p, b); }
CUresult cuMemAllocPitch_v2(CUdeviceptr* p, size_t* pitch, size_t w, size_t h, unsigned) {
  *pitch = (w + 511) & ~size_t(511);
  return alloc("cuMemAllocPitch_v2", p, *pitch * h);
}
CUresult cuMemAllocManaged(CUdeviceptr* p, size_t b, unsigned) { return alloc("cuMemAllocManaged", p, b); }
CUresult cuMemAllocAsync(CUdeviceptr* p, size_t b, CUstream) { return alloc("cuMemAllocAsync", p, b); }
CUresult cuMemAllocAsync_ptsz(CUdeviceptr* p, size_t b, CUstream) { return alloc("cuMemAllocAsync_ptsz", p, b); }
CUresult cuMemAllocFromPoolAsync(CUdeviceptr* p, size_t b, void*, CUstream) { return alloc("cuMemAllocFromPoolAsync", p, b); }
CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr* p, size_t b, void*, CUstream) { return alloc("cuMemAllocFromPoolAsync_ptsz", p, b); }
CUresult cuMemCreate(unsigned long long* h, size_t b, const void*, unsigned long long) {
  CUdeviceptr p;
  CUresult r = alloc("cuMemCreate", &p, b);
  *h = p;
  return r;
}
// the real driver reads CUDA_VISIBLE_DEVICES here, once a process
CUresult cuInit(unsigned) {
  bump("cuInit");
  const char* v = std::getenv("CUDA_VISIBLE_DEVICES");
  std::lock_guard<std::mutex> lock(mu);
  visible_at_init = v ? v : "(unset)";
  return 0;
}
const char* mock_visible_at_init() {
  std::lock_guard<std::mutex> lock(mu);
  return visible_at_init.c_str();
}
CUresult cuMemFree_v2(CUdeviceptr) { bump("cuMemFree_v2"); return 0; }
CUresult cuMemFreeAsync(CUdeviceptr, CUstream) { bump("cuMemFreeAsync"); return 0; }
CUresult cuMemFreeAsync_ptsz(CUdeviceptr, CUstream) { bump("cuMemFreeAsync_ptsz"); return 0; }
CUresult cuMemRelease(unsigned long long) { bump("cuMemRelease"); return 0; }
CUresult cuStreamDestroy_v2(CUstream) { bump("cuStreamDestroy_v2"); return 0; }
CUresult cuStreamIsCapturing(CUstream s, int* status) {
  bump("cuStreamIsCapturing");
  *status = s == kCapturing ? 1 : 0;
  return 0;
}
CUresult cuStreamQuery(CUstream) {
  bump("cuStreamQuery");
  std::lock_guard<std::mutex> lock(mu);
  return now_ms() >= busy_until ? 0 : 600;
}
CUresult cuEventCreate(Event** ev, unsigned) { bump("cuEventCreate"); *ev = new Event; return 0; }
CUresult cuEventRecord(Event* ev, CUstream) {
  bump("cuEventRecord");
  std::lock_guard<std::mutex> lock(mu);
  ev->ready_ms = busy_until;
  return 0;
}
CUresult cuEventSynchronize(Event* ev) {
  bump("cuEventSynchronize");
  double wait = ev->ready_ms - now_ms();
  if (wait > 0) std::this_thread::sleep_for(std::chrono::microseconds(static_cast<long long>(wait * 1000)));
  return 0;
}
CUresult cuEventDestroy_v2(Event* ev) { bump("cuEventDestroy_v2"); delete ev; return 0; }
CUresult cuFuncGetName(const char** name, CUfunction f) {
  *name = f == reinterpret_cast<CUfunction>(0xF1) ? "flash_fwd_bf16_kernel" : "plain_kernel";
  return 0;
}

CUresult cuGetProcAddress_v2(const char*, void**, int, unsigned long, int*);
CUresult cuGetProcAddress(const char* symbol, void** pfn, int version, unsigned long flags) {
  bump("cuGetProcAddress");
  return cuGetProcAddress_v2(symbol, pfn, version, flags, nullptr);
}

// the driver's answer: the _v2 variant of a versioned entry point and
// the _ptsz variant under the per-thread flag
CUresult cuGetProcAddress_v2(const char* symbol, void** pfn, int, unsigned long flags, int* status) {
  bump("cuGetProcAddress_v2");
  static const std::map<std::string, void*> table = {
#define E(fn) {#fn, reinterpret_cast<void*>(&fn)}
      E(cuLaunchKernel), E(cuLaunchKernel_ptsz), E(cuLaunchKernelEx),
      E(cuLaunchKernelEx_ptsz), E(cuLaunchCooperativeKernel),
      E(cuLaunchCooperativeKernel_ptsz), E(cuGraphLaunch), E(cuGraphLaunch_ptsz),
      E(cuMemAlloc_v2), E(cuMemAllocPitch_v2), E(cuMemAllocManaged),
      E(cuMemAllocAsync), E(cuMemAllocAsync_ptsz), E(cuMemAllocFromPoolAsync),
      E(cuMemAllocFromPoolAsync_ptsz), E(cuMemCreate), E(cuMemFree_v2),
      E(cuMemFreeAsync), E(cuMemFreeAsync_ptsz), E(cuMemRelease),
      E(cuStreamDestroy_v2), E(cuStreamIsCapturing), E(cuGetProcAddress),
      E(cuGetProcAddress_v2),
#undef E
  };
  std::string name = symbol;
  for (const char* v : {"cuMemAlloc", "cuMemAllocPitch", "cuMemFree", "cuStreamDestroy", "cuGetProcAddress"}) {
    if (name == v) name += "_v2";
  }
  if ((flags & 2) && table.count(name + "_ptsz")) name += "_ptsz";
  auto it = table.find(name);
  if (it == table.end()) {
    if (status) *status = 1;
    *pfn = nullptr;
    return 500;
  }
  if (status) *status = 0;
  *pfn = it->second;
  return 0;
}

long long mock_count(const char* name) {
  std::lock_guard<std::mutex> lock(mu);
  auto it = counts.find(name);
  return it == counts.end() ? 0 : it->second;
}

const char* mock_stats() {
  std::lock_guard<std::mutex> lock(mu);
  stats_buf = "{";
  bool first = true;
  for (const auto& kv : counts) {
    if (!first) stats_buf += ", ";
    first = false;
    stats_buf += "\"" + kv.first + "\": " + std::to_string(kv.second);
  }
  stats_buf += "}";
  return stats_buf.c_str();
}

}  // extern "C"
"""

APP = r"""
// A CUDA application for the interposer's tests. It reaches the driver
// three ways: linked directly (calls resolve to the preloaded hooks),
// dlopen + dlsym by name, and cuGetProcAddress_v2 (with and without the
// per-thread flag). Commands come from argv; each prints one JSON line.
#include <dlfcn.h>
#include <unistd.h>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

typedef int CUresult;
typedef void* CUstream;
typedef void* CUfunction;
typedef unsigned long long CUdeviceptr;
struct LaunchConfig {
  unsigned gx, gy, gz, bx, by, bz, smem;
  CUstream stream;
  void* attrs;
  unsigned nattrs;
};
typedef CUresult (*LaunchFn)(CUfunction, unsigned, unsigned, unsigned,
                             unsigned, unsigned, unsigned, unsigned, CUstream,
                             void**, void**);
typedef CUresult (*LaunchExFn)(const LaunchConfig*, CUfunction, void**, void**);
typedef CUresult (*CoopFn)(CUfunction, unsigned, unsigned, unsigned, unsigned,
                           unsigned, unsigned, unsigned, CUstream, void**);
typedef CUresult (*GraphFn)(void*, CUstream);
typedef CUresult (*ProcFn)(const char*, void**, int, unsigned long, int*);

extern "C" {
CUresult cuLaunchKernel(CUfunction, unsigned, unsigned, unsigned, unsigned,
                        unsigned, unsigned, unsigned, CUstream, void**, void**);
CUresult cuLaunchKernelEx(const LaunchConfig*, CUfunction, void**, void**);
CUresult cuLaunchCooperativeKernel(CUfunction, unsigned, unsigned, unsigned,
                                   unsigned, unsigned, unsigned, unsigned,
                                   CUstream, void**);
CUresult cuGraphLaunch(void*, CUstream);
CUresult cuGetProcAddress_v2(const char*, void**, int, unsigned long, int*);
CUresult cuMemAlloc_v2(CUdeviceptr*, size_t);
CUresult cuMemAllocPitch_v2(CUdeviceptr*, size_t*, size_t, size_t, unsigned);
CUresult cuMemAllocManaged(CUdeviceptr*, size_t, unsigned);
CUresult cuMemAllocAsync(CUdeviceptr*, size_t, CUstream);
CUresult cuMemAllocFromPoolAsync(CUdeviceptr*, size_t, void*, CUstream);
CUresult cuMemCreate(unsigned long long*, size_t, const void*, unsigned long long);
CUresult cuMemFree_v2(CUdeviceptr);
CUresult cuMemFreeAsync(CUdeviceptr, CUstream);
CUresult cuMemRelease(unsigned long long);
CUresult cuStreamDestroy_v2(CUstream);
CUresult cuInit(unsigned);
const char* mock_stats();
const char* mock_visible_at_init();
}

static void* lookup(const std::string& via, const char* name) {
  if (via == "dlsym") {
    void* h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? dlsym(h, name) : nullptr;
  }
  void* fn = nullptr;
  unsigned long flags = via == "proc_ptsz" ? 2 : 0;
  if (cuGetProcAddress_v2(name, &fn, 12080, flags, nullptr) != 0) return nullptr;
  return fn;
}

int main(int argc, char** argv) {
  std::vector<std::pair<std::string, unsigned long long>> allocs;
  for (int i = 1; i < argc; ++i) {
    std::string cmd = argv[i];
    if (cmd == "launch") {  // launch <via> <kind> <n> <stream> <function>
      std::string via = argv[++i], kind = argv[++i];
      int n = std::atoi(argv[++i]);
      CUstream s = reinterpret_cast<CUstream>(std::strtoull(argv[++i], nullptr, 0));
      CUfunction f = reinterpret_cast<CUfunction>(std::strtoull(argv[++i], nullptr, 0));
      int rc = 0;
      for (int k = 0; k < n; ++k) {
        if (kind == "kernel") {
          LaunchFn fn = via == "direct" ? &cuLaunchKernel
                                        : reinterpret_cast<LaunchFn>(lookup(via, "cuLaunchKernel"));
          rc |= fn(f, 1, 1, 1, 1, 1, 1, 0, s, nullptr, nullptr);
        } else if (kind == "ex") {
          LaunchExFn fn = via == "direct" ? &cuLaunchKernelEx
                                          : reinterpret_cast<LaunchExFn>(lookup(via, "cuLaunchKernelEx"));
          LaunchConfig c{1, 1, 1, 1, 1, 1, 0, s, nullptr, 0};
          rc |= fn(&c, f, nullptr, nullptr);
        } else if (kind == "coop") {
          CoopFn fn = via == "direct" ? &cuLaunchCooperativeKernel
                                      : reinterpret_cast<CoopFn>(lookup(via, "cuLaunchCooperativeKernel"));
          rc |= fn(f, 1, 1, 1, 1, 1, 1, 0, s, nullptr);
        } else {
          GraphFn fn = via == "direct" ? &cuGraphLaunch
                                       : reinterpret_cast<GraphFn>(lookup(via, "cuGraphLaunch"));
          rc |= fn(reinterpret_cast<void*>(0x6), s);
        }
      }
      std::printf("{\"launch\": \"%s %s\", \"rc\": %d}\n", via.c_str(), kind.c_str(), rc);
    } else if (cmd == "sleep") {
      std::this_thread::sleep_for(std::chrono::milliseconds(std::atoi(argv[++i])));
    } else if (cmd == "alloc") {  // alloc <kind> <bytes> [stream]
      std::string kind = argv[++i];
      size_t bytes = std::strtoull(argv[++i], nullptr, 0);
      CUdeviceptr p = 0;
      size_t pitch = 0;
      unsigned long long h = 0;
      CUresult rc;
      if (kind == "v2") rc = cuMemAlloc_v2(&p, bytes);
      else if (kind == "pitch") rc = cuMemAllocPitch_v2(&p, &pitch, bytes, 1, 4);
      else if (kind == "managed") rc = cuMemAllocManaged(&p, bytes, 1);
      else if (kind == "async") rc = cuMemAllocAsync(&p, bytes, reinterpret_cast<CUstream>(std::strtoull(argv[++i], nullptr, 0)));
      else if (kind == "pool") rc = cuMemAllocFromPoolAsync(&p, bytes, nullptr, nullptr);
      else { rc = cuMemCreate(&h, bytes, nullptr, 0); p = h; }
      allocs.push_back({kind, p});
      std::printf("{\"alloc\": \"%s\", \"rc\": %d, \"id\": %zu}\n", kind.c_str(), rc, allocs.size() - 1);
    } else if (cmd == "free") {  // free <id>
      auto& a = allocs[std::atoi(argv[++i])];
      CUresult rc;
      if (a.first == "async" || a.first == "pool") rc = cuMemFreeAsync(a.second, nullptr);
      else if (a.first == "create") rc = cuMemRelease(a.second);
      else rc = cuMemFree_v2(a.second);
      std::printf("{\"free\": \"%s\", \"rc\": %d}\n", a.first.c_str(), rc);
    } else if (cmd == "free_ptr") {
      CUresult rc = cuMemFree_v2(std::strtoull(argv[++i], nullptr, 0));
      std::printf("{\"free_ptr\": %d}\n", rc);
    } else if (cmd == "destroy") {
      cuStreamDestroy_v2(reinterpret_cast<CUstream>(std::strtoull(argv[++i], nullptr, 0)));
    } else if (cmd == "init") {  // cuInit, then what the driver read
      CUresult rc = cuInit(0);
      std::printf("{\"init\": %d, \"visible\": \"%s\"}\n", rc,
                  mock_visible_at_init());
    } else if (cmd == "stats") {
      typedef const char* (*StatsFn)();
      StatsFn shim = reinterpret_cast<StatsFn>(dlsym(RTLD_DEFAULT, "kubeshare_cuda_interposer_stats"));
      std::printf("{\"shim\": %s, \"mock\": %s}\n", shim ? shim() : "null", mock_stats());
    }
    std::fflush(stdout);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    """(interposer, mock libcuda, application) paths."""
    out = tmp_path_factory.mktemp("cuda")
    (out / "mock_libcuda.cc").write_text(MOCK_LIBCUDA)
    (out / "app.cc").write_text(APP)
    mock = out / "libcuda.so.1"
    # -Bsymbolic: the mock's own table holds its own functions, as a real
    # driver's does, not the preloaded hooks that interpose on them
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wl,-Bsymbolic", "-Wl,-soname,libcuda.so.1", "-o",
                    str(mock), str(out / "mock_libcuda.cc")], check=True,
                   timeout=120)
    app = out / "app"
    subprocess.run(["g++", "-O1", "-std=c++17", "-o", str(app),
                    str(out / "app.cc"), str(mock), f"-Wl,-rpath,{out}",
                    "-ldl"], check=True, timeout=120)
    return str(native.build_interposer()), str(mock), str(app)


@pytest.fixture
def manager(tmp_path):
    """A live tpu-schd (quota 20 ms, window 10 s) with ``POD`` capped at
    ``CAP`` bytes, and that pod's tpu-pmgr: (arbiter port, pod port)."""
    arbiter_port, pod_port = free_port(), free_port()
    procs = [start_arbiter(str(tmp_path), "gpu-0",
                           [ConfigEntry(POD, 1.0, 0.5, CAP)], arbiter_port,
                           window_ms=10000)]
    try:
        procs.append(start_pod_manager(POD, pod_port, arbiter_port))
        yield arbiter_port, pod_port
    finally:
        for proc in procs:
            stop_arbiter(proc)


def run_app(build, *commands, port=None, **env):
    """Run the application under the interposer; (its JSON lines, the
    interposer's stderr lines)."""
    shim, mock, app = build
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("KUBESHARE_")}
    if port is not None:
        full.update(KUBESHARE_POD_MANAGER_PORT=str(port),
                    KUBESHARE_POD_NAME=POD)
    full.update({k: str(v) for k, v in env.items()})
    full = interposer.enable(full, interposer=shim, real_libcuda=mock)
    out = subprocess.run([app, *map(str, commands), "stats"], env=full,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    return lines, [line for line in out.stderr.splitlines()
                   if line.startswith("[cuda-interposer]")]


def stat(arbiter_port):
    with TokenClient("127.0.0.1", arbiter_port) as client:
        return {s.pod: s for s in client.stats()}[POD]


def test_passthrough_without_a_manager_port(build):
    lines, log = run_app(build, "launch", "direct", "kernel", 2, 0, 0,
                         "launch", "dlsym", "ex", 1, 0, 0,
                         "launch", "proc_ptsz", "graph", 1, 0, 0,
                         "alloc", "v2", 4096)
    shim, mock = lines[-1]["shim"], lines[-1]["mock"]
    assert shim["mode"] == "passthrough" and shim["ungated"] == 4
    assert shim["acquires"] == shim["mem_charged"] == 0
    assert shim["launch"] + shim["launch_ex"] + shim["graph_launch"] == 0
    assert (mock["cuLaunchKernel"], mock["cuLaunchKernelEx"],
            mock["cuGraphLaunch_ptsz"], mock["cuMemAlloc_v2"]) == (2, 1, 1, 1)
    assert len(log) == 1 and "passing through" in log[0]


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("via", ["direct", "dlsym", "proc", "proc_ptsz"])
def test_every_lookup_path_reaches_the_gate(build, manager, via, kind):
    arbiter_port, pod_port = manager
    lines, log = run_app(build, "launch", via, kind, 3, "0x10", "0xF1",
                         port=pod_port)
    shim, mock = lines[-1]["shim"], lines[-1]["mock"]
    counter, real = KINDS[kind]
    if via == "proc_ptsz":
        real += "_ptsz"     # the driver hands out the per-thread variant
    assert lines[0]["rc"] == 0
    assert shim["mode"] == "gated" and shim[counter] == 3
    assert mock[real] == 3
    assert shim["acquires"] == 1 and shim["ungated"] == 0
    if via.startswith("proc"):
        assert shim["procaddr_hooks"] == 3   # one lookup a launch
    if via == "dlsym":
        assert shim["dlsym_hooks"] >= 1
    # graph launches carry no function; the rest are named by the driver
    assert shim["functions"] == (
        {} if kind == "graph" else {"flash_fwd_bf16_kernel": 3})
    assert "gated through tpu-pmgr" in log[0]


@pytest.mark.parametrize("kernel_ms", [300, 0])
def test_lease_expiry_drains_before_release(build, manager, kernel_ms):
    """A launch after the 20 ms quota drains the expired lease's streams,
    then releases it with used = last completion - lease start: the
    300 ms of queued work when the stream was busy; when it was idle,
    the last launch's time (at once)."""
    arbiter_port, pod_port = manager
    lines, _ = run_app(build, "launch", "direct", "kernel", 1, "0x10", 0,
                       "sleep", 30,
                       "launch", "dlsym", "kernel", 1, "0x20", 0,
                       port=pod_port, MOCK_KERNEL_MS=kernel_ms)
    shim, mock = lines[-1]["shim"], lines[-1]["mock"]
    assert shim["acquires"] == 2 and shim["releases"] == 1
    assert shim["drained_streams"] == 1     # only 0x10 ran under lease 1
    assert mock["cuStreamQuery"] == 1
    usage = stat(arbiter_port).window_usage_ms
    if kernel_ms:
        assert shim["busy_drains"] == 1
        assert mock["cuEventRecord"] == mock["cuEventSynchronize"] == 1
        assert shim["drain_wait_ms"] > 0.0
        # the work was queued after the lease began: used covers all of it
        assert 299.0 <= usage <= shim["max_used_ms"] + 1.0
    else:
        # an idle stream is not waited for, nor billed past its launch
        assert shim["busy_drains"] == 0
        assert mock.get("cuEventRecord", 0) == 0
        assert usage < 5.0


def test_destroyed_stream_is_not_drained(build, manager):
    _, pod_port = manager
    lines, _ = run_app(build, "launch", "direct", "kernel", 1, "0x10", 0,
                       "launch", "direct", "kernel", 1, "0x20", 0,
                       "destroy", "0x20", "sleep", 30,
                       "launch", "direct", "kernel", 1, "0x10", 0,
                       port=pod_port)
    shim = lines[-1]["shim"]
    assert shim["releases"] == 1 and shim["drained_streams"] == 1


def test_capture_passes_through_uncounted(build, manager):
    arbiter_port, pod_port = manager
    lines, _ = run_app(build, "launch", "direct", "kernel", 3, "0xCA", 0,
                       "launch", "proc", "graph", 1, "0xCA", 0,
                       "alloc", "async", 4096, "0xCA",
                       port=pod_port)
    shim, mock = lines[-1]["shim"], lines[-1]["mock"]
    assert mock["cuLaunchKernel"] == 3 and mock["cuGraphLaunch"] == 1
    assert shim["capture_passthrough"] == 4
    assert shim["launch"] == shim["graph_launch"] == shim["acquires"] == 0
    assert shim["mem_charged"] == 0 and mock["cuMemAllocAsync"] == 1
    assert stat(arbiter_port).mem_used == 0


@pytest.mark.parametrize("kind", ["v2", "pitch", "managed", "async", "pool",
                                  "create"])
def test_memory_is_charged_refunded_and_denied(build, manager, kind):
    arbiter_port, pod_port = manager
    extra = ["0x10"] if kind == "async" else []
    half, more = CAP // 2, 3 * CAP // 4
    lines, log = run_app(build, "alloc", kind, half, *extra,
                         "alloc", kind, more, *extra,
                         "free", 0, "free", 0, "free_ptr", "0x5",
                         port=pod_port)
    assert [line["rc"] for line in lines[:2]] == [0, 2]  # OUT_OF_MEMORY
    shim, mock = lines[-1]["shim"], lines[-1]["mock"]
    # the denied allocation never reached the driver
    assert sum(mock.get(name, 0) for name in ALLOCATORS) == 1
    assert shim["mem_charged"] == half and shim["mem_denied"] == 1
    # a second free and an unknown pointer refund nothing
    assert shim["mem_refunded"] == half
    assert stat(arbiter_port).mem_used == 0
    assert any("denied" in line for line in log)


def test_soft_cap_logs_and_allows(build, manager):
    arbiter_port, pod_port = manager
    lines, log = run_app(build, "alloc", "v2", CAP // 2,
                         "alloc", "v2", 3 * CAP // 4, "free", 1,
                         port=pod_port, KUBESHARE_HBM_SOFT=1)
    assert [line["rc"] for line in lines[:2]] == [0, 0]
    shim, mock = lines[-1]["shim"], lines[-1]["mock"]
    assert mock["cuMemAlloc_v2"] == 2 and shim["mem_soft_denied"] == 1
    # the soft-denied allocation was never charged, so its free refunds 0
    assert shim["mem_charged"] == CAP // 2 and shim["mem_refunded"] == 0
    assert stat(arbiter_port).mem_used == CAP // 2
    assert any("(soft)" in line for line in log)


def test_unreachable_manager_fails_open(build):
    lines, log = run_app(build, "launch", "direct", "kernel", 2, 0, 0,
                         "alloc", "v2", 4096, port=free_port())
    shim, mock = lines[-1]["shim"], lines[-1]["mock"]
    assert shim["mode"] == "passthrough" and shim["ungated"] == 2
    assert mock["cuLaunchKernel"] == 2 and lines[1]["rc"] == 0
    assert "failing open" in log[0]


def test_enable_only_when_both_libraries_exist(tmp_path):
    shim, real = tmp_path / "libcuda_interposer.so", tmp_path / "libcuda.so.1"
    shim.write_bytes(b"")
    real.write_bytes(b"")
    env = {"LD_PRELOAD": "/lib/other.so", "PATH": "/bin"}
    out = interposer.enable(env, interposer=str(shim), real_libcuda=str(real))
    assert out["LD_PRELOAD"] == f"{shim}:/lib/other.so"
    assert out[interposer.ENV_REAL] == str(real)
    assert interposer.enabled(out) and not interposer.enabled(env)
    assert env == {"LD_PRELOAD": "/lib/other.so", "PATH": "/bin"}
    for missing in ({"interposer": str(tmp_path / "none.so"),
                     "real_libcuda": str(real)},
                    {"interposer": str(shim),
                     "real_libcuda": str(tmp_path / "none.so.1")}):
        assert interposer.enable(env, **missing) == env
    # the real driver: KUBESHARE_CUDA_REAL, then LD_LIBRARY_PATH
    assert interposer.find_real_libcuda(
        {interposer.ENV_REAL: str(real)}) == str(real)
    assert interposer.find_real_libcuda(
        {"LD_LIBRARY_PATH": str(tmp_path)}) == str(real)


def test_check_build_needs_cuda_h(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(native, "CUDA_INCLUDE", (str(tmp_path),))
    with pytest.raises(RuntimeError, match="cuda.h not found"):
        native.build_interposer(check_cuda_h=True)
