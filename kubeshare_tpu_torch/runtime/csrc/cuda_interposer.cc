// CUDA driver-API interposer: driver-level isolation for a shared GPU.
//
// The reference isolates fractional pods by LD_PRELOADing a CUDA
// interposer (libgemhook.so.1) under unmodified applications; the JAX
// package rebuilt it at the PJRT waist
// (runtime_native/pjrt_interposer.cc). On a GPU the narrow waist every
// framework goes through is the CUDA driver API again, so this library
// is the counterpart of that shim: LD_PRELOAD it into a pod's process
// (runtime/interposer.py::enable writes the env) and it
//
//   - gates kernel work on a compute-token lease from the pod's
//     tpu-pmgr: cuLaunchKernel, cuLaunchKernelEx,
//     cuLaunchCooperativeKernel, cuGraphLaunch and their _ptsz
//     (per-thread default stream) variants;
//   - charges every device allocation against the pod's memory cap:
//     cuMemAlloc_v2, cuMemAllocPitch_v2, cuMemAllocManaged,
//     cuMemAllocAsync, cuMemAllocFromPoolAsync, cuMemCreate (PyTorch's
//     expandable segments), refunded by cuMemFree_v2, cuMemFreeAsync
//     and cuMemRelease. "MEM +bytes" goes to tpu-pmgr before the real
//     call; DENY returns CUDA_ERROR_OUT_OF_MEMORY without allocating
//     (KUBESHARE_HBM_SOFT=1 logs and allows). A refund is never more
//     than what was charged for that allocation.
//
// How calls reach the hooks. Exporting the cu* symbols covers callers
// that link -lcuda (Triton's launcher). It is not enough: libcudart, and
// the static cudart inside cuBLAS, cuDNN and the port's own kernel
// libraries, dlopen("libcuda.so.1"), take cuGetProcAddress_v2 with a
// handle-scoped dlsym (which never sees an LD_PRELOADed symbol) and then
// take every entry point from it; torch's c10::cuda::DriverAPI dlsyms
// its driver calls by name. So, as HAMi-core does, this library also
//   - wraps cuGetProcAddress and cuGetProcAddress_v2: the real one
//     answers, and an answer that is the real address of a hooked entry
//     point (the driver picks the _v2 and _ptsz variants from the
//     version and flags) is replaced by the hook;
//   - interposes dlsym itself (the real one from dlvsym(RTLD_NEXT,
//     "dlsym", "GLIBC_2.34"), else the older symbol versions): a lookup
//     by a hooked name that the real dlsym resolves gets the hook.
// A forwarding libcuda.so.1 earlier on LD_LIBRARY_PATH would have to
// export and forward the driver's whole API (hundreds of entry points)
// and would follow its versions; the three lookups above are the ones
// the stack uses. Known limit of the dlsym hook: dlsym(RTLD_NEXT, ...)
// resolves relative to this library, not to its caller.
//
// No recursion: the real driver is dlopened once (KUBESHARE_CUDA_REAL,
// default libcuda.so.1) and called only through the pointers resolved
// from that handle with the real dlsym.
//
// Lease semantics match the Python gate (runtime/hook.py) and the PJRT
// shim (pjrt_interposer.cc:236-262, 483-540): the first gated launch
// sends ACQ; the token covers every launch until its quota's wall clock
// runs out; at the next launch after expiry the work launched under the
// lease is drained and "REL <used_ms>" sent, used = last completion -
// lease start. The drain keeps the streams launched into under the
// lease (the legacy stream 0 and CU_STREAM_PER_THREAD included; a
// destroyed stream is dropped), records a real event on each that still
// has work queued (cuStreamQuery) and waits for it: no cuCtxSynchronize,
// which would wait for the whole context. When every stream was already
// idle, the last completion lies between the last gated launch and now:
// the last launch's time is used, a lower bound. A per-thread default stream of
// another thread cannot be named from this one; its work is not
// waited for.
//
// Stream capture: a launch (or cuMemAllocAsync) into a capturing stream
// does not run, and an ACQ or an event record inside a capture would
// break it or deadlock. It passes through ungated and uncounted; the
// cuGraphLaunch that replays the graph is gated instead.
//
// The pod's card: the scheduler names it by NVML uuid in
// TPU_VISIBLE_CHIPS (a comma-separated list; libtpu honours it on a TPU).
// A constructor maps it onto CUDA_VISIBLE_DEVICES when the library is
// loaded, before any cuInit in the process (the driver reads the
// variable there), by utils/device.py's rule: unset or empty, it takes
// the list; equal, it is kept; another value is left as it is, with an
// error line. The stats JSON records the decision.
//
// Env: KUBESHARE_POD_MANAGER_PORT / _IP (default 127.0.0.1) name the
// pod's tpu-pmgr, KUBESHARE_POD_NAME the pod, KUBESHARE_HBM_SOFT=1 soft
// caps. Without a manager port the library passes every call through:
// that is the reference's contract (pjrt_interposer.cc:59-61), not a
// device fallback. A lost token server fails open the same way. One
// line goes to stderr either way, at the first driver call.
//
// Known untracked, as the PJRT shim names its own: the context's own
// memory (created by cuCtxCreate / primary-context retain), module
// images (cuModuleLoad*, cuLibraryLoad*), and memory that graph memory
// nodes own (cuMemAllocAsync inside a capture, cuGraphAddMemAllocNode).
// runtime/hook.py::apply_hbm_env_cap stays the backstop for those.
//
// kubeshare_cuda_interposer_stats() returns the counters as one JSON
// object (the kernels launched under the lease by name, through
// cuFuncGetName where the driver has it).

#include <dlfcn.h>
#include <pthread.h>
#include <stdint.h>
#include <unistd.h>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdarg>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#ifdef KUBESHARE_CHECK_CUDA_H
#include <cuda.h>

#include <cstddef>
#include <type_traits>
// cuda.h names cuGetProcAddress_v2 "cuGetProcAddress"; the v1 entry
// point is hooked under its own name below
#undef cuGetProcAddress
namespace hand {
#include "cuda_decls.h"
}
#else
#include "cuda_decls.h"
#endif

// ---- the driver entry points' types -----------------------------------

#define KS_LAUNCH_ARGS                                                     \
  CUfunction, unsigned int, unsigned int, unsigned int, unsigned int,      \
      unsigned int, unsigned int, unsigned int, CUstream, void**, void**
#define KS_COOP_ARGS                                                       \
  CUfunction, unsigned int, unsigned int, unsigned int, unsigned int,      \
      unsigned int, unsigned int, unsigned int, CUstream, void**

typedef CUresult (*PFN_LaunchKernel)(KS_LAUNCH_ARGS);
typedef CUresult (*PFN_LaunchKernelEx)(const CUlaunchConfig*, CUfunction,
                                       void**, void**);
typedef CUresult (*PFN_LaunchCooperativeKernel)(KS_COOP_ARGS);
typedef CUresult (*PFN_GraphLaunch)(CUgraphExec, CUstream);
typedef CUresult (*PFN_MemAlloc)(CUdeviceptr*, size_t);
typedef CUresult (*PFN_MemAllocPitch)(CUdeviceptr*, size_t*, size_t, size_t,
                                      unsigned int);
typedef CUresult (*PFN_MemAllocManaged)(CUdeviceptr*, size_t, unsigned int);
typedef CUresult (*PFN_MemAllocAsync)(CUdeviceptr*, size_t, CUstream);
typedef CUresult (*PFN_MemAllocFromPoolAsync)(CUdeviceptr*, size_t,
                                              CUmemoryPool, CUstream);
typedef CUresult (*PFN_MemCreate)(CUmemGenericAllocationHandle*, size_t,
                                  const CUmemAllocationProp*,
                                  unsigned long long);
typedef CUresult (*PFN_MemFree)(CUdeviceptr);
typedef CUresult (*PFN_MemFreeAsync)(CUdeviceptr, CUstream);
typedef CUresult (*PFN_MemRelease)(CUmemGenericAllocationHandle);
typedef CUresult (*PFN_StreamDestroy)(CUstream);
typedef CUresult (*PFN_StreamIsCapturing)(CUstream, CUstreamCaptureStatus*);
typedef CUresult (*PFN_StreamQuery)(CUstream);
typedef CUresult (*PFN_EventCreate)(CUevent*, unsigned int);
typedef CUresult (*PFN_EventRecord)(CUevent, CUstream);
typedef CUresult (*PFN_EventSynchronize)(CUevent);
typedef CUresult (*PFN_EventDestroy)(CUevent);
typedef CUresult (*PFN_FuncGetName)(const char**, CUfunction);
typedef CUresult (*PFN_KernelGetName)(const char**, CUkernel);
typedef CUresult (*PFN_GetProcAddress)(const char*, void**, int, cuuint64_t);
typedef CUresult (*PFN_GetProcAddress_v2)(const char*, void**, int,
                                          cuuint64_t,
                                          CUdriverProcAddressQueryResult*);

#ifdef KUBESHARE_CHECK_CUDA_H
#define KS_SAME(fn, pfn)                                                  \
  static_assert(std::is_same<decltype(&::fn), pfn>::value,                \
                "prototype of " #fn " disagrees with cuda.h")
KS_SAME(cuLaunchKernel, PFN_LaunchKernel);
KS_SAME(cuLaunchKernelEx, PFN_LaunchKernelEx);
KS_SAME(cuLaunchCooperativeKernel, PFN_LaunchCooperativeKernel);
KS_SAME(cuGraphLaunch, PFN_GraphLaunch);
KS_SAME(cuMemAlloc_v2, PFN_MemAlloc);
KS_SAME(cuMemAllocPitch_v2, PFN_MemAllocPitch);
KS_SAME(cuMemAllocManaged, PFN_MemAllocManaged);
KS_SAME(cuMemAllocAsync, PFN_MemAllocAsync);
KS_SAME(cuMemAllocFromPoolAsync, PFN_MemAllocFromPoolAsync);
KS_SAME(cuMemCreate, PFN_MemCreate);
KS_SAME(cuMemFree_v2, PFN_MemFree);
KS_SAME(cuMemFreeAsync, PFN_MemFreeAsync);
KS_SAME(cuMemRelease, PFN_MemRelease);
KS_SAME(cuStreamDestroy_v2, PFN_StreamDestroy);
KS_SAME(cuStreamIsCapturing, PFN_StreamIsCapturing);
KS_SAME(cuStreamQuery, PFN_StreamQuery);
KS_SAME(cuEventCreate, PFN_EventCreate);
KS_SAME(cuEventRecord, PFN_EventRecord);
KS_SAME(cuEventSynchronize, PFN_EventSynchronize);
KS_SAME(cuEventDestroy_v2, PFN_EventDestroy);
KS_SAME(cuFuncGetName, PFN_FuncGetName);
KS_SAME(cuKernelGetName, PFN_KernelGetName);
KS_SAME(cuGetProcAddress_v2, PFN_GetProcAddress_v2);
#undef KS_SAME
// the hand-declared types against the real ones
static_assert(sizeof(hand::CUresult) == sizeof(::CUresult), "CUresult");
static_assert(std::is_same<hand::cuuint64_t, ::cuuint64_t>::value,
              "cuuint64_t");
static_assert(std::is_same<hand::CUdeviceptr, ::CUdeviceptr>::value,
              "CUdeviceptr");
static_assert(std::is_same<hand::CUmemGenericAllocationHandle,
                           ::CUmemGenericAllocationHandle>::value,
              "CUmemGenericAllocationHandle");
static_assert(sizeof(hand::CUlaunchConfig) == sizeof(::CUlaunchConfig) &&
                  offsetof(hand::CUlaunchConfig, hStream) ==
                      offsetof(::CUlaunchConfig, hStream) &&
                  offsetof(hand::CUlaunchConfig, numAttrs) ==
                      offsetof(::CUlaunchConfig, numAttrs),
              "CUlaunchConfig layout");
static_assert(sizeof(hand::CUstreamCaptureStatus) ==
                  sizeof(::CUstreamCaptureStatus),
              "CUstreamCaptureStatus");
static_assert(sizeof(hand::CUdriverProcAddressQueryResult) ==
                  sizeof(::CUdriverProcAddressQueryResult),
              "CUdriverProcAddressQueryResult");
#define KS_VALUE(name)                                                    \
  static_assert(static_cast<long long>(hand::name) ==                     \
                    static_cast<long long>(::name),                       \
                "value of " #name)
KS_VALUE(CUDA_SUCCESS);
KS_VALUE(CUDA_ERROR_OUT_OF_MEMORY);
KS_VALUE(CUDA_ERROR_NOT_INITIALIZED);
KS_VALUE(CUDA_ERROR_NOT_FOUND);
KS_VALUE(CUDA_ERROR_NOT_READY);
KS_VALUE(CU_STREAM_CAPTURE_STATUS_NONE);
KS_VALUE(CU_STREAM_CAPTURE_STATUS_ACTIVE);
KS_VALUE(CU_STREAM_CAPTURE_STATUS_INVALIDATED);
KS_VALUE(CU_GET_PROC_ADDRESS_SUCCESS);
KS_VALUE(CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM);
KS_VALUE(CU_EVENT_DISABLE_TIMING);
#undef KS_VALUE
#endif  // KUBESHARE_CHECK_CUDA_H

namespace {

double now_ms() {
  using namespace std::chrono;
  return duration<double, std::milli>(steady_clock::now().time_since_epoch())
      .count();
}

void logf(const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::fprintf(stderr, "[cuda-interposer] ");
  std::vfprintf(stderr, fmt, ap);
  std::fprintf(stderr, "\n");
  va_end(ap);
}

// ---- the token protocol (runtime_native/proto.h's line helpers) -------

bool read_line(int fd, std::string* out) {
  out->clear();
  char c;
  for (;;) {
    ssize_t n = ::recv(fd, &c, 1, 0);
    if (n <= 0) return false;
    if (c == '\n') return true;
    if (c != '\r') out->push_back(c);
    if (out->size() > 4096) return false;
  }
}

bool write_line(int fd, const std::string& line) {
  std::string msg = line + "\n";
  size_t off = 0;
  while (off < msg.size()) {
    ssize_t n = ::send(fd, msg.data() + off, msg.size() - off, MSG_NOSIGNAL);
    if (n <= 0) return false;
    off += static_cast<size_t>(n);
  }
  return true;
}

int tcp_connect(const char* host, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr = ::inet_addr(host);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    return -1;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

// ---- the real dlsym ---------------------------------------------------

typedef void* (*DlsymFn)(void*, const char*);

DlsymFn real_dlsym() {
  static std::atomic<DlsymFn> cached{nullptr};
  DlsymFn fn = cached.load(std::memory_order_acquire);
  if (fn != nullptr) return fn;
  // glibc >= 2.34 keeps dlsym in libc at GLIBC_2.34; older ones in
  // libdl at the architecture's base version
  for (const char* version : {"GLIBC_2.34", "GLIBC_2.2.5", "GLIBC_2.17"}) {
    fn = reinterpret_cast<DlsymFn>(dlvsym(RTLD_NEXT, "dlsym", version));
    if (fn != nullptr) break;
  }
  if (fn == nullptr) {
    logf("cannot find the real dlsym; aborting");
    std::abort();
  }
  cached.store(fn, std::memory_order_release);
  return fn;
}

// ---- the hooked entry points ------------------------------------------

struct HookEntry {
  const char* name;   // the exported symbol, e.g. cuLaunchKernel_ptsz
  void* hook;
  void* real;         // resolved from the real driver at init
};

// filled in after the hooks are defined (bottom of the file)
extern HookEntry g_hooks[];
extern const size_t g_num_hooks;

HookEntry* hook_by_name(const char* symbol) {
  for (size_t i = 0; i < g_num_hooks; ++i) {
    if (std::strcmp(g_hooks[i].name, symbol) == 0) return &g_hooks[i];
  }
  return nullptr;
}

// auxiliary real entry points the hooks call
struct Real {
  PFN_StreamIsCapturing stream_is_capturing = nullptr;
  PFN_StreamQuery stream_query = nullptr;
  PFN_EventCreate event_create = nullptr;
  PFN_EventRecord event_record = nullptr;
  PFN_EventSynchronize event_synchronize = nullptr;
  PFN_EventDestroy event_destroy = nullptr;
  PFN_FuncGetName func_get_name = nullptr;
  PFN_KernelGetName kernel_get_name = nullptr;
};

// Constant-initialised (no constructor runs): the dlsym hook may be
// called before this library's dynamic initialisers have run.
struct Counters {
  std::atomic<unsigned long long> launch{0}, launch_ex{0},
      launch_cooperative{0}, graph_launch{0}, capture_passthrough{0},
      ungated{0}, acquires{0}, releases{0}, drained_streams{0},
      busy_drains{0}, mem_charged{0}, mem_refunded{0}, mem_denied{0},
      mem_soft_denied{0}, procaddr_hooks{0}, dlsym_hooks{0};
} C;

struct State {
  Real real;
  std::string driver_path;
  bool driver_ok = false;
  bool gated = false;  // a token server was configured and reached

  std::mutex mu;  // everything below
  int fd = -1;    // the tpu-pmgr connection (-1: passthrough)
  bool lost_logged = false;
  std::string pod = "-";
  bool hbm_soft = false;

  bool held = false;  // the compute lease
  double lease_start = 0.0;
  double quota_ms = 0.0;
  double last_launch = 0.0;
  std::vector<CUstream> streams;  // launched into under the lease
  double acquire_wait_ms = 0.0;   // time spent in ACQ (waiting for a token)
  double drain_wait_ms = 0.0;     // time spent draining before REL
  double max_used_ms = 0.0;       // the longest use a REL reported

  // bytes the server accepted per allocation: refunds never exceed them
  std::unordered_map<CUdeviceptr, long long> charged;
  std::unordered_map<CUmemGenericAllocationHandle, long long> charged_handles;
  std::unordered_map<CUfunction, unsigned long long> fn_launches;
  std::string stats_json;
};

// Immortal: hooks can run after this library's static destructors
// would have fired (other libraries' exit handlers call the driver).
State& S = *new State;
pthread_once_t g_init_once = PTHREAD_ONCE_INIT;

template <typename F>
F resolve(void* handle, const char* name) {
  return reinterpret_cast<F>(real_dlsym()(handle, name));
}

void init() {
  const char* path = std::getenv("KUBESHARE_CUDA_REAL");
  S.driver_path = path && *path ? path : "libcuda.so.1";
  void* handle = ::dlopen(S.driver_path.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (handle == nullptr) {
    logf("cannot load the real driver %s: %s", S.driver_path.c_str(),
         dlerror());
  } else {
    S.driver_ok = true;
    for (size_t i = 0; i < g_num_hooks; ++i) {
      g_hooks[i].real = real_dlsym()(handle, g_hooks[i].name);
    }
    Real& r = S.real;
    r.stream_is_capturing =
        resolve<PFN_StreamIsCapturing>(handle, "cuStreamIsCapturing");
    r.stream_query = resolve<PFN_StreamQuery>(handle, "cuStreamQuery");
    r.event_create = resolve<PFN_EventCreate>(handle, "cuEventCreate");
    r.event_record = resolve<PFN_EventRecord>(handle, "cuEventRecord");
    r.event_synchronize =
        resolve<PFN_EventSynchronize>(handle, "cuEventSynchronize");
    r.event_destroy = resolve<PFN_EventDestroy>(handle, "cuEventDestroy_v2");
    r.func_get_name = resolve<PFN_FuncGetName>(handle, "cuFuncGetName");
    r.kernel_get_name = resolve<PFN_KernelGetName>(handle, "cuKernelGetName");
  }
  const char* pod = std::getenv("KUBESHARE_POD_NAME");
  S.pod = pod && *pod ? pod : "-";
  const char* port = std::getenv("KUBESHARE_POD_MANAGER_PORT");
  if (!port || !*port || std::atoi(port) == 0) {
    logf("pid %d: no KUBESHARE_POD_MANAGER_PORT, passing through (driver %s)",
         static_cast<int>(::getpid()), S.driver_path.c_str());
    return;
  }
  const char* host = std::getenv("KUBESHARE_POD_MANAGER_IP");
  host = host && *host ? host : "127.0.0.1";
  S.fd = tcp_connect(host, std::atoi(port));
  if (S.fd < 0) {
    logf("pid %d: cannot reach tpu-pmgr at %s:%s, failing open (no "
         "isolation)",
         static_cast<int>(::getpid()), host, port);
    return;
  }
  const char* soft = std::getenv("KUBESHARE_HBM_SOFT");
  S.hbm_soft = soft && *soft && std::strcmp(soft, "0") != 0;
  S.gated = S.driver_ok;
  logf("pid %d: pod %s gated through tpu-pmgr at %s:%s (driver %s%s)",
       static_cast<int>(::getpid()), S.pod.c_str(), host, port,
       S.driver_path.c_str(), S.hbm_soft ? ", soft memory cap" : "");
}

void ensure_init() { pthread_once(&g_init_once, init); }

// The device contract's decision (none, set, kept or conflict) and the
// contract's list. Constant- and zero-initialised: the constructor below
// may run before this library's dynamic initialisers.
const char* g_visible_decision = "none";
char g_visible_chips[1024];

__attribute__((constructor)) void apply_visible_chips() {
  const char* chips = std::getenv("TPU_VISIBLE_CHIPS");
  if (chips == nullptr || *chips == '\0') return;
  std::snprintf(g_visible_chips, sizeof(g_visible_chips), "%s", chips);
  const char* current = std::getenv("CUDA_VISIBLE_DEVICES");
  if (current == nullptr || *current == '\0') {
    ::setenv("CUDA_VISIBLE_DEVICES", chips, 1);
    g_visible_decision = "set";
    logf("pid %d: CUDA_VISIBLE_DEVICES=%s from TPU_VISIBLE_CHIPS",
         static_cast<int>(::getpid()), chips);
  } else if (std::strcmp(current, chips) == 0) {
    g_visible_decision = "kept";
  } else {
    g_visible_decision = "conflict";
    logf("error: pid %d: CUDA_VISIBLE_DEVICES=%s disagrees with the "
         "scheduler's TPU_VISIBLE_CHIPS=%s; left as it is",
         static_cast<int>(::getpid()), current, chips);
  }
}

template <typename F>
F real_of(const char* name) {
  ensure_init();
  HookEntry* h = hook_by_name(name);
  return h ? reinterpret_cast<F>(h->real) : nullptr;
}

// Caller holds S.mu. False when the connection is gone (fail open).
bool roundtrip_locked(const std::string& line, std::string* reply) {
  if (S.fd < 0) return false;
  if (write_line(S.fd, line) && read_line(S.fd, reply)) return true;
  ::close(S.fd);
  S.fd = -1;
  S.held = false;
  if (!S.lost_logged) {
    S.lost_logged = true;
    logf("lost tpu-pmgr; failing open (no isolation)");
  }
  return false;
}

// ---- the lease ----------------------------------------------------------

// Not safe to gate: the stream is capturing (or the driver cannot say,
// in which case the launch fails the same way without us).
bool capturing(CUstream stream) {
  if (S.real.stream_is_capturing == nullptr) return false;
  CUstreamCaptureStatus status = CU_STREAM_CAPTURE_STATUS_NONE;
  CUresult r = S.real.stream_is_capturing(stream, &status);
  return r != CUDA_SUCCESS || status != CU_STREAM_CAPTURE_STATUS_NONE;
}

// Wait for the work launched under the lease; true if any stream still
// had work queued. Caller holds S.mu.
bool drain_locked() {
  Real& r = S.real;
  if (r.stream_query == nullptr || r.event_create == nullptr ||
      r.event_record == nullptr || r.event_synchronize == nullptr) {
    return false;
  }
  bool busy = false;
  CUevent ev = nullptr;
  for (CUstream stream : S.streams) {
    if (capturing(stream)) continue;  // an event record would join it
    C.drained_streams++;
    // an idle stream needs no event (and one recorded now would not be
    // complete yet: the card has not reached it)
    if (r.stream_query(stream) != CUDA_ERROR_NOT_READY) continue;
    if (ev == nullptr &&
        r.event_create(&ev, CU_EVENT_DISABLE_TIMING) != CUDA_SUCCESS) {
      ev = nullptr;
      break;
    }
    if (r.event_record(ev, stream) == CUDA_SUCCESS) {
      r.event_synchronize(ev);
      busy = true;
    }
  }
  if (ev != nullptr && r.event_destroy != nullptr) r.event_destroy(ev);
  if (busy) C.busy_drains++;
  return busy;
}

void release_locked(double used_ms) {
  S.held = false;
  S.streams.clear();
  S.max_used_ms = std::max(S.max_used_ms, used_ms);
  char line[320];
  std::snprintf(line, sizeof(line), "REL %s %.3f", S.pod.c_str(),
                std::max(0.0, used_ms));
  std::string reply;
  if (roundtrip_locked(line, &reply)) C.releases++;
}

void maybe_release_locked() {
  double start = now_ms();
  if (!S.held || start - S.lease_start < S.quota_ms) return;
  bool busy = drain_locked();
  double end = now_ms();
  S.drain_wait_ms += end - start;
  release_locked((busy ? end : S.last_launch) - S.lease_start);
}

void acquire_locked() {
  if (S.held || S.fd < 0) return;
  char line[320];
  std::snprintf(line, sizeof(line), "ACQ %s 0", S.pod.c_str());
  std::string reply;
  double start = now_ms();
  if (!roundtrip_locked(line, &reply)) return;
  double quota = 0.0;
  if (std::sscanf(reply.c_str(), "TOK %lf", &quota) != 1) return;
  S.held = true;
  S.quota_ms = quota;
  S.lease_start = now_ms();
  S.acquire_wait_ms += S.lease_start - start;
  S.last_launch = S.lease_start;
  C.acquires++;
}

enum class Kind { kKernel, kKernelEx, kCooperative, kGraph };

// Everything a gated entry point does before the real call.
void gate(CUstream stream, bool ptsz, Kind kind, CUfunction fn) {
  ensure_init();
  if (!S.gated) {
    C.ungated++;
    return;
  }
  if (stream == nullptr) stream = ptsz ? CU_STREAM_PER_THREAD : CU_STREAM_LEGACY;
  if (capturing(stream)) {
    C.capture_passthrough++;
    return;
  }
  std::lock_guard<std::mutex> lock(S.mu);
  maybe_release_locked();
  acquire_locked();
  if (!S.held) {
    C.ungated++;
    return;
  }
  if (std::find(S.streams.begin(), S.streams.end(), stream) ==
      S.streams.end()) {
    S.streams.push_back(stream);
  }
  S.last_launch = now_ms();
  switch (kind) {
    case Kind::kKernel: C.launch++; break;
    case Kind::kKernelEx: C.launch_ex++; break;
    case Kind::kCooperative: C.launch_cooperative++; break;
    case Kind::kGraph: C.graph_launch++; break;
  }
  if (fn != nullptr) S.fn_launches[fn]++;
}

// ---- memory -------------------------------------------------------------

// Charge `bytes` to the pod. Returns false on a hard denial; *accepted
// is what the server took (0 when passing through or soft-denied).
bool charge(long long bytes, const char* what, long long* accepted) {
  *accepted = 0;
  ensure_init();
  if (!S.gated || bytes <= 0) return true;
  std::lock_guard<std::mutex> lock(S.mu);
  char line[320];
  std::snprintf(line, sizeof(line), "MEM %s %lld", S.pod.c_str(), bytes);
  std::string reply;
  if (!roundtrip_locked(line, &reply)) return true;  // fail open
  if (reply.rfind("OK", 0) == 0) {
    *accepted = bytes;
    C.mem_charged += static_cast<unsigned long long>(bytes);
    return true;
  }
  if (S.hbm_soft) {
    C.mem_soft_denied++;
    logf("memory cap exceeded (soft): pod %s %s +%lld bytes (%s)",
         S.pod.c_str(), what, bytes, reply.c_str());
    return true;
  }
  C.mem_denied++;
  logf("memory cap exceeded: pod %s %s +%lld bytes denied (%s)",
       S.pod.c_str(), what, bytes, reply.c_str());
  return false;
}

void refund(long long bytes) {
  if (bytes <= 0) return;
  std::lock_guard<std::mutex> lock(S.mu);
  char line[320];
  std::snprintf(line, sizeof(line), "MEM %s %lld", S.pod.c_str(), -bytes);
  std::string reply;
  if (roundtrip_locked(line, &reply)) {
    C.mem_refunded += static_cast<unsigned long long>(bytes);
  }
}

void record(CUdeviceptr ptr, long long accepted) {
  if (accepted <= 0) return;
  std::lock_guard<std::mutex> lock(S.mu);
  S.charged[ptr] += accepted;
}

long long take(CUdeviceptr ptr) {
  std::lock_guard<std::mutex> lock(S.mu);
  auto it = S.charged.find(ptr);
  if (it == S.charged.end()) return 0;
  long long bytes = it->second;
  S.charged.erase(it);
  return bytes;
}

// charge, then allocate; refund when the real call fails
template <typename Call>
CUresult charged_alloc(CUdeviceptr* dptr, long long bytes, const char* what,
                       Call call) {
  long long accepted = 0;
  if (!charge(bytes, what, &accepted)) return CUDA_ERROR_OUT_OF_MEMORY;
  CUresult r = call();
  if (r != CUDA_SUCCESS || dptr == nullptr) {
    refund(accepted);
    return r;
  }
  record(*dptr, accepted);
  return r;
}

// take the charge before freeing (the address may be reused the moment
// it is free), and put it back if the free fails
template <typename Call>
CUresult charged_free(CUdeviceptr ptr, Call call) {
  long long bytes = S.gated ? take(ptr) : 0;
  CUresult r = call();
  if (r != CUDA_SUCCESS) {
    record(ptr, bytes);
    return r;
  }
  refund(bytes);
  return r;
}

bool capturing_alloc(CUstream stream, bool ptsz) {
  if (!S.gated) return false;
  if (stream == nullptr) stream = ptsz ? CU_STREAM_PER_THREAD : CU_STREAM_LEGACY;
  return capturing(stream);
}

void json_escape(std::string* out, const char* s) {
  for (; *s; ++s) {
    char c = *s;
    if (c == '"' || c == '\\') {
      out->push_back('\\');
      out->push_back(c);
    } else if (static_cast<unsigned char>(c) < 0x20) {
      out->push_back('?');
    } else {
      out->push_back(c);
    }
  }
}

}  // namespace

// ---- the exported hooks -------------------------------------------------

extern "C" {

#define KS_REAL(type, name)                                               \
  static const type real = real_of<type>(name);                           \
  if (real == nullptr) return CUDA_ERROR_NOT_INITIALIZED

CUresult cuLaunchKernel(CUfunction f, unsigned int gx, unsigned int gy,
                        unsigned int gz, unsigned int bx, unsigned int by,
                        unsigned int bz, unsigned int smem, CUstream stream,
                        void** params, void** extra) {
  KS_REAL(PFN_LaunchKernel, "cuLaunchKernel");
  gate(stream, false, Kind::kKernel, f);
  return real(f, gx, gy, gz, bx, by, bz, smem, stream, params, extra);
}

CUresult cuLaunchKernel_ptsz(CUfunction f, unsigned int gx, unsigned int gy,
                             unsigned int gz, unsigned int bx,
                             unsigned int by, unsigned int bz,
                             unsigned int smem, CUstream stream,
                             void** params, void** extra) {
  KS_REAL(PFN_LaunchKernel, "cuLaunchKernel_ptsz");
  gate(stream, true, Kind::kKernel, f);
  return real(f, gx, gy, gz, bx, by, bz, smem, stream, params, extra);
}

CUresult cuLaunchKernelEx(const CUlaunchConfig* config, CUfunction f,
                          void** params, void** extra) {
  KS_REAL(PFN_LaunchKernelEx, "cuLaunchKernelEx");
  gate(config ? config->hStream : nullptr, false, Kind::kKernelEx, f);
  return real(config, f, params, extra);
}

CUresult cuLaunchKernelEx_ptsz(const CUlaunchConfig* config, CUfunction f,
                               void** params, void** extra) {
  KS_REAL(PFN_LaunchKernelEx, "cuLaunchKernelEx_ptsz");
  gate(config ? config->hStream : nullptr, true, Kind::kKernelEx, f);
  return real(config, f, params, extra);
}

CUresult cuLaunchCooperativeKernel(CUfunction f, unsigned int gx,
                                   unsigned int gy, unsigned int gz,
                                   unsigned int bx, unsigned int by,
                                   unsigned int bz, unsigned int smem,
                                   CUstream stream, void** params) {
  KS_REAL(PFN_LaunchCooperativeKernel, "cuLaunchCooperativeKernel");
  gate(stream, false, Kind::kCooperative, f);
  return real(f, gx, gy, gz, bx, by, bz, smem, stream, params);
}

CUresult cuLaunchCooperativeKernel_ptsz(CUfunction f, unsigned int gx,
                                        unsigned int gy, unsigned int gz,
                                        unsigned int bx, unsigned int by,
                                        unsigned int bz, unsigned int smem,
                                        CUstream stream, void** params) {
  KS_REAL(PFN_LaunchCooperativeKernel, "cuLaunchCooperativeKernel_ptsz");
  gate(stream, true, Kind::kCooperative, f);
  return real(f, gx, gy, gz, bx, by, bz, smem, stream, params);
}

CUresult cuGraphLaunch(CUgraphExec graph, CUstream stream) {
  KS_REAL(PFN_GraphLaunch, "cuGraphLaunch");
  gate(stream, false, Kind::kGraph, nullptr);
  return real(graph, stream);
}

CUresult cuGraphLaunch_ptsz(CUgraphExec graph, CUstream stream) {
  KS_REAL(PFN_GraphLaunch, "cuGraphLaunch_ptsz");
  gate(stream, true, Kind::kGraph, nullptr);
  return real(graph, stream);
}

CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t bytes) {
  KS_REAL(PFN_MemAlloc, "cuMemAlloc_v2");
  return charged_alloc(dptr, static_cast<long long>(bytes), "cuMemAlloc",
                       [&] { return real(dptr, bytes); });
}

CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pitch, size_t width,
                            size_t height, unsigned int element_bytes) {
  KS_REAL(PFN_MemAllocPitch, "cuMemAllocPitch_v2");
  // charged at the unpadded size: the pitch is known only afterwards
  return charged_alloc(
      dptr, static_cast<long long>(width) * static_cast<long long>(height),
      "cuMemAllocPitch",
      [&] { return real(dptr, pitch, width, height, element_bytes); });
}

CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t bytes,
                           unsigned int flags) {
  KS_REAL(PFN_MemAllocManaged, "cuMemAllocManaged");
  return charged_alloc(dptr, static_cast<long long>(bytes),
                       "cuMemAllocManaged",
                       [&] { return real(dptr, bytes, flags); });
}

CUresult cuMemAllocAsync(CUdeviceptr* dptr, size_t bytes, CUstream stream) {
  KS_REAL(PFN_MemAllocAsync, "cuMemAllocAsync");
  if (capturing_alloc(stream, false)) return real(dptr, bytes, stream);
  return charged_alloc(dptr, static_cast<long long>(bytes), "cuMemAllocAsync",
                       [&] { return real(dptr, bytes, stream); });
}

CUresult cuMemAllocAsync_ptsz(CUdeviceptr* dptr, size_t bytes,
                              CUstream stream) {
  KS_REAL(PFN_MemAllocAsync, "cuMemAllocAsync_ptsz");
  if (capturing_alloc(stream, true)) return real(dptr, bytes, stream);
  return charged_alloc(dptr, static_cast<long long>(bytes), "cuMemAllocAsync",
                       [&] { return real(dptr, bytes, stream); });
}

CUresult cuMemAllocFromPoolAsync(CUdeviceptr* dptr, size_t bytes,
                                 CUmemoryPool pool, CUstream stream) {
  KS_REAL(PFN_MemAllocFromPoolAsync, "cuMemAllocFromPoolAsync");
  if (capturing_alloc(stream, false)) return real(dptr, bytes, pool, stream);
  return charged_alloc(dptr, static_cast<long long>(bytes),
                       "cuMemAllocFromPoolAsync",
                       [&] { return real(dptr, bytes, pool, stream); });
}

CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr* dptr, size_t bytes,
                                      CUmemoryPool pool, CUstream stream) {
  KS_REAL(PFN_MemAllocFromPoolAsync, "cuMemAllocFromPoolAsync_ptsz");
  if (capturing_alloc(stream, true)) return real(dptr, bytes, pool, stream);
  return charged_alloc(dptr, static_cast<long long>(bytes),
                       "cuMemAllocFromPoolAsync",
                       [&] { return real(dptr, bytes, pool, stream); });
}

CUresult cuMemCreate(CUmemGenericAllocationHandle* handle, size_t bytes,
                     const CUmemAllocationProp* prop,
                     unsigned long long flags) {
  KS_REAL(PFN_MemCreate, "cuMemCreate");
  long long accepted = 0;
  if (!charge(static_cast<long long>(bytes), "cuMemCreate", &accepted)) {
    return CUDA_ERROR_OUT_OF_MEMORY;
  }
  CUresult r = real(handle, bytes, prop, flags);
  if (r != CUDA_SUCCESS || handle == nullptr) {
    refund(accepted);
    return r;
  }
  if (accepted > 0) {
    std::lock_guard<std::mutex> lock(S.mu);
    S.charged_handles[*handle] += accepted;
  }
  return r;
}

CUresult cuMemFree_v2(CUdeviceptr ptr) {
  KS_REAL(PFN_MemFree, "cuMemFree_v2");
  return charged_free(ptr, [&] { return real(ptr); });
}

CUresult cuMemFreeAsync(CUdeviceptr ptr, CUstream stream) {
  KS_REAL(PFN_MemFreeAsync, "cuMemFreeAsync");
  // inside a capture the free happens when the graph runs: the charge
  // stays (conservative)
  if (capturing_alloc(stream, false)) return real(ptr, stream);
  return charged_free(ptr, [&] { return real(ptr, stream); });
}

CUresult cuMemFreeAsync_ptsz(CUdeviceptr ptr, CUstream stream) {
  KS_REAL(PFN_MemFreeAsync, "cuMemFreeAsync_ptsz");
  if (capturing_alloc(stream, true)) return real(ptr, stream);
  return charged_free(ptr, [&] { return real(ptr, stream); });
}

CUresult cuMemRelease(CUmemGenericAllocationHandle handle) {
  KS_REAL(PFN_MemRelease, "cuMemRelease");
  long long bytes = 0;
  if (S.gated) {
    std::lock_guard<std::mutex> lock(S.mu);
    auto it = S.charged_handles.find(handle);
    if (it != S.charged_handles.end()) {
      bytes = it->second;
      S.charged_handles.erase(it);
    }
  }
  CUresult r = real(handle);
  if (r != CUDA_SUCCESS) {
    if (bytes > 0) {
      std::lock_guard<std::mutex> lock(S.mu);
      S.charged_handles[handle] += bytes;
    }
    return r;
  }
  refund(bytes);
  return r;
}

CUresult cuStreamDestroy_v2(CUstream stream) {
  KS_REAL(PFN_StreamDestroy, "cuStreamDestroy_v2");
  if (S.gated) {
    std::lock_guard<std::mutex> lock(S.mu);
    S.streams.erase(std::remove(S.streams.begin(), S.streams.end(), stream),
                    S.streams.end());
  }
  return real(stream);
}

static void hook_answer(void** pfn) {
  if (pfn == nullptr || *pfn == nullptr) return;
  for (size_t i = 0; i < g_num_hooks; ++i) {
    if (g_hooks[i].real == *pfn) {
      *pfn = g_hooks[i].hook;
      C.procaddr_hooks++;
      return;
    }
  }
}

CUresult cuGetProcAddress(const char* symbol, void** pfn, int version,
                          cuuint64_t flags) {
  KS_REAL(PFN_GetProcAddress, "cuGetProcAddress");
  CUresult r = real(symbol, pfn, version, flags);
  if (r == CUDA_SUCCESS) hook_answer(pfn);
  return r;
}

CUresult cuGetProcAddress_v2(const char* symbol, void** pfn, int version,
                             cuuint64_t flags,
                             CUdriverProcAddressQueryResult* status) {
  KS_REAL(PFN_GetProcAddress_v2, "cuGetProcAddress_v2");
  CUresult r = real(symbol, pfn, version, flags, status);
  if (r == CUDA_SUCCESS) hook_answer(pfn);
  return r;
}

#undef KS_REAL

void* dlsym(void* handle, const char* symbol) {
  void* found = real_dlsym()(handle, symbol);
  if (found != nullptr && symbol[0] == 'c' && symbol[1] == 'u') {
    if (HookEntry* h = hook_by_name(symbol)) {
      C.dlsym_hooks++;
      return h->hook;
    }
  }
  return found;
}

// The counters as one JSON object; the string lives until the next call.
const char* kubeshare_cuda_interposer_stats(void) {
  ensure_init();
  std::lock_guard<std::mutex> lock(S.mu);
  const Counters& c = C;
  const char* mode = !S.gated ? "passthrough" : (S.fd < 0 ? "lost" : "gated");
  char head[1536];
  std::snprintf(
      head, sizeof(head),
      "{\"mode\": \"%s\", \"launch\": %llu, \"launch_ex\": %llu, "
      "\"launch_cooperative\": %llu, \"graph_launch\": %llu, "
      "\"capture_passthrough\": %llu, \"ungated\": %llu, \"acquires\": %llu, "
      "\"releases\": %llu, \"drained_streams\": %llu, \"busy_drains\": %llu, "
      "\"mem_charged\": %llu, \"mem_refunded\": %llu, \"mem_denied\": %llu, "
      "\"mem_soft_denied\": %llu, \"procaddr_hooks\": %llu, "
      "\"dlsym_hooks\": %llu, "
      "\"acquire_wait_ms\": %.3f, \"drain_wait_ms\": %.3f, "
      "\"max_used_ms\": %.3f, ",
      mode, c.launch.load(), c.launch_ex.load(), c.launch_cooperative.load(),
      c.graph_launch.load(), c.capture_passthrough.load(), c.ungated.load(),
      c.acquires.load(), c.releases.load(), c.drained_streams.load(),
      c.busy_drains.load(), c.mem_charged.load(), c.mem_refunded.load(),
      c.mem_denied.load(), c.mem_soft_denied.load(), c.procaddr_hooks.load(),
      c.dlsym_hooks.load(), S.acquire_wait_ms, S.drain_wait_ms,
      S.max_used_ms);
  std::string out = head;
  out += "\"pod\": \"";
  json_escape(&out, S.pod.c_str());
  out += "\", \"visible_devices\": \"";
  out += g_visible_decision;
  out += "\", \"visible_chips\": \"";
  json_escape(&out, g_visible_chips);
  out += "\", \"functions\": {";
  // launches by kernel name (names repeat across CUfunction handles of
  // one kernel in several modules: sum them)
  std::unordered_map<std::string, unsigned long long> by_name;
  for (const auto& entry : S.fn_launches) {
    // cudart 12 launches library kernels by their CUkernel handle
    const char* name = nullptr;
    if ((S.real.func_get_name == nullptr ||
         S.real.func_get_name(&name, entry.first) != CUDA_SUCCESS) &&
        (S.real.kernel_get_name == nullptr ||
         S.real.kernel_get_name(&name, reinterpret_cast<CUkernel>(
                                           entry.first)) != CUDA_SUCCESS)) {
      name = nullptr;
    }
    if (name == nullptr) name = "?";
    by_name[name] += entry.second;
  }
  bool first = true;
  for (const auto& entry : by_name) {
    if (!first) out += ", ";
    first = false;
    out += "\"";
    json_escape(&out, entry.first.c_str());
    out += "\": " + std::to_string(entry.second);
  }
  out += "}}";
  S.stats_json = out;
  return S.stats_json.c_str();
}

}  // extern "C"

namespace {

#define KS_HOOK(name) {#name, reinterpret_cast<void*>(&name), nullptr}

HookEntry g_hooks[] = {
    KS_HOOK(cuLaunchKernel),
    KS_HOOK(cuLaunchKernel_ptsz),
    KS_HOOK(cuLaunchKernelEx),
    KS_HOOK(cuLaunchKernelEx_ptsz),
    KS_HOOK(cuLaunchCooperativeKernel),
    KS_HOOK(cuLaunchCooperativeKernel_ptsz),
    KS_HOOK(cuGraphLaunch),
    KS_HOOK(cuGraphLaunch_ptsz),
    KS_HOOK(cuMemAlloc_v2),
    KS_HOOK(cuMemAllocPitch_v2),
    KS_HOOK(cuMemAllocManaged),
    KS_HOOK(cuMemAllocAsync),
    KS_HOOK(cuMemAllocAsync_ptsz),
    KS_HOOK(cuMemAllocFromPoolAsync),
    KS_HOOK(cuMemAllocFromPoolAsync_ptsz),
    KS_HOOK(cuMemCreate),
    KS_HOOK(cuMemFree_v2),
    KS_HOOK(cuMemFreeAsync),
    KS_HOOK(cuMemFreeAsync_ptsz),
    KS_HOOK(cuMemRelease),
    KS_HOOK(cuStreamDestroy_v2),
    KS_HOOK(cuGetProcAddress),
    KS_HOOK(cuGetProcAddress_v2),
};
const size_t g_num_hooks = sizeof(g_hooks) / sizeof(g_hooks[0]);

#undef KS_HOOK

// A lease still held at exit is returned with the time up to the last
// launch (no driver call here: the driver may be gone). A thread still
// inside a hook keeps the lock; the lease then goes back when the
// connection closes.
__attribute__((destructor)) void release_at_exit() {
  if (!S.gated || !S.mu.try_lock()) return;
  if (S.held) release_locked(S.last_launch - S.lease_start);
  S.mu.unlock();
}

}  // namespace
