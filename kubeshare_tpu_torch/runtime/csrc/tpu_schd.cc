// tpu-schd: per-device token-arbiter daemon, the port's build of
// runtime_native/tpu_schd.cc (same flags, config file and protocol,
// runtime_native/proto.h) over this directory's arbiter.h.
//
// One instance per device (launched by the node launcher, one port
// each starting at 49901). Reads the per-device config file written by
// the node config daemon ("N" + "ns/name limit request memory" lines)
// and re-reads it when its mtime changes. Serves the ACQ/REL/MEM/STAT
// line protocol. Its grant carries the arbiter's account of the wait:
//
//   ACQ <pod> <est_ms>  -> "TOK <quota_ms> <waited_ms> <throttled_ms>"
//
// the ms the ACQ blocked in all, and the part of it with the pod past
// its limit; readers of the reference's "TOK <quota_ms>" take the
// first number and ignore the rest.
//
// Usage: tpu-schd -p <config dir> -f <file (device uuid)> -P <port>
//                 [-q base_quota_ms] [-m min_quota_ms] [-w window_ms]
//                 [-c lease_slots] [-H host]

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <sys/stat.h>
#include <thread>

#include "arbiter.h"
#include "proto.h"

using namespace tpushare;

static std::map<std::string, PodQuota> load_config(const std::string& path) {
  std::map<std::string, PodQuota> quotas;
  std::ifstream in(path);
  if (!in) return quotas;
  int n = 0;
  in >> n;
  for (int i = 0; i < n; ++i) {
    std::string pod;
    PodQuota q;
    if (!(in >> pod >> q.limit >> q.request >> q.mem_cap)) break;
    quotas[pod] = q;
  }
  return quotas;
}

static void watch_config(const std::string& path, TokenArbiter* arbiter,
                         std::atomic<bool>* stop) {
  // Nanosecond mtime + size + inode: two rewrites landing in the same
  // second (os.replace changes the inode) must both be seen, or the
  // arbiter enforces stale quotas indefinitely.
  long long last_sec = -1, last_nsec = -1, last_size = -1, last_ino = -1;
  while (!stop->load()) {
    struct stat st;
    if (::stat(path.c_str(), &st) == 0 &&
        (st.st_mtim.tv_sec != last_sec || st.st_mtim.tv_nsec != last_nsec ||
         st.st_size != last_size ||
         static_cast<long long>(st.st_ino) != last_ino)) {
      last_sec = st.st_mtim.tv_sec;
      last_nsec = st.st_mtim.tv_nsec;
      last_size = st.st_size;
      last_ino = static_cast<long long>(st.st_ino);
      arbiter->set_quotas(load_config(path));
      std::fprintf(stderr, "[tpu-schd] reloaded %s\n", path.c_str());
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(500));
  }
}

static void serve_client(int fd, TokenArbiter* arbiter) {
  std::string line;
  // if this connection dies while holding the lease, release it
  std::string held_pod;
  while (read_line(fd, &line)) {
    std::istringstream in(line);
    std::string cmd;
    in >> cmd;
    if (cmd == "ACQ") {
      std::string pod;
      double est_ms = 0;
      if (!(in >> pod >> est_ms)) {
        if (!write_all(fd, "ERR malformed ACQ")) break;
        continue;
      }
      if (!held_pod.empty()) {
        // one lease per connection: a second ACQ would orphan the first
        if (!write_all(fd, "ERR lease already held")) break;
        continue;
      }
      TokenArbiter::Wait wait;
      double quota = arbiter->acquire(pod, &wait);
      held_pod = pod;
      char buf[96];
      std::snprintf(buf, sizeof(buf), "TOK %.3f %.3f %.3f", quota,
                    wait.waited_ms, wait.throttled_ms);
      if (!write_all(fd, buf)) break;
    } else if (cmd == "REL") {
      std::string pod;
      double used_ms = 0;
      if (!(in >> pod >> used_ms)) {
        if (!write_all(fd, "ERR malformed REL")) break;
        continue;
      }
      if (pod != held_pod) {
        if (!write_all(fd, "ERR not lease holder")) break;
        continue;
      }
      arbiter->release(pod, used_ms);
      held_pod.clear();
      if (!write_all(fd, "OK")) break;
    } else if (cmd == "MEM") {
      std::string pod;
      long long delta = 0, used = 0, cap = 0;
      if (!(in >> pod >> delta)) {
        if (!write_all(fd, "ERR malformed MEM")) break;
        continue;
      }
      bool ok = arbiter->mem(pod, delta, &used, &cap);
      char buf[96];
      std::snprintf(buf, sizeof(buf), "%s %lld %lld", ok ? "OK" : "DENY",
                    used, cap);
      if (!write_all(fd, buf)) break;
    } else if (cmd == "STAT") {
      auto stats = arbiter->stats();
      char head[32];
      std::snprintf(head, sizeof(head), "STAT %zu", stats.size());
      if (!write_all(fd, head)) break;
      bool failed = false;
      for (const auto& s : stats) {
        char buf[256];
        std::snprintf(buf, sizeof(buf), "%s %.3f %lld %lld", s.pod.c_str(),
                      s.window_usage_ms, s.mem_used, s.mem_cap);
        if (!write_all(fd, buf)) { failed = true; break; }
      }
      if (failed) break;
    } else if (cmd == "PING") {
      if (!write_all(fd, "PONG")) break;
    } else {
      if (!write_all(fd, "ERR unknown command")) break;
    }
  }
  if (!held_pod.empty()) arbiter->release(held_pod, 0.0);
  ::close(fd);
}

int main(int argc, char** argv) {
  std::string dir = ".", file, host = "0.0.0.0";
  int port = 49901;
  int slots = 1;
  double base_quota = 300.0, min_quota = 20.0, window = 10000.0;
  for (int i = 1; i < argc - 1; ++i) {
    std::string a = argv[i];
    if (a == "-p") dir = argv[++i];
    else if (a == "-f") file = argv[++i];
    else if (a == "-P") port = std::atoi(argv[++i]);
    else if (a == "-q") base_quota = std::atof(argv[++i]);
    else if (a == "-m") min_quota = std::atof(argv[++i]);
    else if (a == "-w") window = std::atof(argv[++i]);
    else if (a == "-c") slots = std::atoi(argv[++i]);
    else if (a == "-H") host = argv[++i];
  }
  if (file.empty()) {
    std::fprintf(stderr, "usage: tpu-schd -p dir -f chip-uuid -P port "
                         "[-q base] [-m min] [-w window]\n");
    return 2;
  }
  TokenArbiter arbiter(base_quota, min_quota, window, slots);
  // -f is normally a filename under -p (the reference CLI contract);
  // an absolute -f stands alone so operators can point at a full path
  std::string path = file[0] == '/' ? file : dir + "/" + file;
  arbiter.set_quotas(load_config(path));
  std::atomic<bool> stop{false};
  std::thread watcher(watch_config, path, &arbiter, &stop);

  int listener = tcp_listen(host.c_str(), port);
  if (listener < 0) {
    std::fprintf(stderr, "[tpu-schd] cannot listen on %s:%d\n", host.c_str(),
                 port);
    return 1;
  }
  std::fprintf(stderr,
               "[tpu-schd] chip %s serving on %s:%d (q=%g m=%g w=%g c=%d)\n",
               file.c_str(), host.c_str(), port, base_quota, min_quota,
               window, slots);
  for (;;) {
    int fd = ::accept(listener, nullptr, nullptr);
    if (fd < 0) continue;
    std::thread(serve_client, fd, &arbiter).detach();
  }
}
