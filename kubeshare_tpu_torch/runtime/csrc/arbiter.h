// Token arbiter: proportional-share time-slicing of one device. The
// port's copy of runtime_native/arbiter.h, whose acquire also reports
// how long it blocked and why (TokenArbiter::Wait), and whose usage is
// the part of each hold inside the window: a hold that began before the
// window's start is charged only its tail.
//
// Semantics reproduced from the reference's published contract (the
// gem-schd CLI surface: -q base_quota=300ms -m min_quota=20ms
// -w window=10000ms, per-pod "limit request memory" tuples from the
// config file — SURVEY.md §2.5): a client must hold a compute lease to
// dispatch work; lease quotas are sized base_quota, shrinking toward
// min_quota under contention; usage is accounted over a sliding window;
// a pod under request*window is *guaranteed* (served first), a pod past
// limit*window is throttled until the window slides.
//
// Extension over the reference's single token: up to `slots` leases
// may be outstanding at once (default 1 = reference semantics). Kernel
// launches are async and each hold includes a drain round trip, so slots=2 lets one pod's drain latency hide under
// another's compute — work conservation without weakening the window
// accounting that enforces request/limit fairness.
#pragma once

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace tpushare {

struct PodQuota {
  double limit = 1.0;        // burst ceiling, fraction of device time
  double request = 0.0;      // guaranteed fraction of device time
  long long mem_cap = 0;     // HBM bytes, 0 = uncapped
};

class TokenArbiter {
 public:
  TokenArbiter(double base_quota_ms, double min_quota_ms, double window_ms,
               int slots = 1)
      : base_quota_ms_(base_quota_ms),
        min_quota_ms_(min_quota_ms),
        window_ms_(window_ms),
        slots_(slots < 1 ? 1 : slots) {}

  void set_quotas(const std::map<std::string, PodQuota>& quotas) {
    std::lock_guard<std::mutex> lock(mu_);
    quotas_ = quotas;
    cv_.notify_all();
  }

  // How long an acquire blocked, in ms: in all, and the part of it in
  // which the pod was past its burst ceiling (throttled by the window).
  // Both are 0 for a lease granted at once.
  struct Wait {
    double waited_ms = 0.0;
    double throttled_ms = 0.0;
  };

  // Blocks until this pod may hold the compute lease; returns the
  // granted quota in ms, and the wait in `wait` if given.
  double acquire(const std::string& pod, Wait* wait = nullptr) {
    std::unique_lock<std::mutex> lock(mu_);
    double waited = 0.0, throttled = 0.0;
    waiting_.push_back(pod);
    for (;;) {
      const double now = now_ms();
      expire_usage(now);
      const bool under_limit = eligible(pod, now);
      if (active_ < slots_ && under_limit && next_in_line(pod, now)) break;
      cv_.wait_for(lock, std::chrono::milliseconds(5));
      const double slept = now_ms() - now;
      waited += slept;
      if (!under_limit) throttled += slept;
    }
    if (wait != nullptr) {
      wait->waited_ms = waited;
      wait->throttled_ms = throttled;
    }
    auto it = std::find(waiting_.begin(), waiting_.end(), pod);
    if (it != waiting_.end()) waiting_.erase(it);
    ++active_;
    double quota = base_quota_ms_;
    int contenders = static_cast<int>(waiting_.size()) + 1;
    if (contenders > 1) quota = base_quota_ms_ / contenders;
    return std::max(quota, min_quota_ms_);
  }

  void release(const std::string& pod, double used_ms) {
    std::lock_guard<std::mutex> lock(mu_);
    if (active_ > 0) --active_;
    usage_[pod].push_back({now_ms(), std::max(0.0, used_ms)});
    cv_.notify_all();
  }

  // HBM accounting: returns true if the delta fits under the pod's cap.
  // Negative deltas free memory.
  bool mem(const std::string& pod, long long delta, long long* used,
           long long* cap) {
    std::lock_guard<std::mutex> lock(mu_);
    long long& current = mem_used_[pod];
    auto it = quotas_.find(pod);
    long long pod_cap = it == quotas_.end() ? 0 : it->second.mem_cap;
    *cap = pod_cap;
    if (delta > 0 && pod_cap > 0 && current + delta > pod_cap) {
      *used = current;
      return false;
    }
    current = std::max(0LL, current + delta);
    *used = current;
    return true;
  }

  struct Stat {
    std::string pod;
    double window_usage_ms;
    long long mem_used;
    long long mem_cap;
  };

  std::vector<Stat> stats() {
    std::lock_guard<std::mutex> lock(mu_);
    double now = now_ms();
    expire_usage(now);
    std::vector<Stat> out;
    for (const auto& entry : quotas_) {
      const std::string& pod = entry.first;
      out.push_back({pod, window_usage(pod, now),
                     mem_used_.count(pod) ? mem_used_.at(pod) : 0,
                     entry.second.mem_cap});
    }
    return out;
  }

  double window_ms() const { return window_ms_; }

 private:
  // A released hold: the interval [t_ms - used_ms, t_ms].
  struct Usage {
    double t_ms;        // completion time
    double used_ms;
  };

  static double now_ms() {
    using namespace std::chrono;
    return duration<double, std::milli>(
               steady_clock::now().time_since_epoch())
        .count();
  }

  void expire_usage(double now) {
    for (auto& entry : usage_) {
      auto& window = entry.second;
      while (!window.empty() && window.front().t_ms < now - window_ms_) {
        window.pop_front();
      }
    }
  }

  // The part of each hold inside the window that ends at `now`: a hold
  // that began before the window's start is charged only its tail.
  double window_usage(const std::string& pod, double now) const {
    auto it = usage_.find(pod);
    if (it == usage_.end()) return 0.0;
    const double start = now - window_ms_;
    double total = 0.0;
    for (const auto& u : it->second) {
      total += std::max(0.0, std::min(u.used_ms, u.t_ms - start));
    }
    return total;
  }

  PodQuota quota_for(const std::string& pod) const {
    auto it = quotas_.find(pod);
    if (it != quotas_.end()) return it->second;
    // unknown pod (config not propagated yet): fail-safe to a small
    // opportunistic share rather than deadlocking the app — mirrors the
    // reference's files-default-to-0 tolerance of scrape lag
    PodQuota q;
    q.limit = 1.0;
    q.request = 0.0;
    return q;
  }

  // A pod past its burst ceiling must wait for the window to slide.
  bool eligible(const std::string& pod, double now) const {
    PodQuota q = quota_for(pod);
    return window_usage(pod, now) < q.limit * window_ms_;
  }

  // Grant order: under-served guaranteed pods first (lowest
  // usage/request), then lowest absolute usage among burst pods.
  bool next_in_line(const std::string& pod, double now) const {
    if (waiting_.empty()) return true;
    return rank(pod, now) <= best_waiting_rank(pod, now);
  }

  double rank(const std::string& pod, double now) const {
    PodQuota q = quota_for(pod);
    double usage = window_usage(pod, now);
    double guaranteed = q.request * window_ms_;
    if (guaranteed > 0 && usage < guaranteed) {
      return usage / guaranteed - 1.0;  // negative: guaranteed tier
    }
    return usage / window_ms_;          // 0..limit: burst tier
  }

  double best_waiting_rank(const std::string& exclude, double now) const {
    double best = 1e18;
    for (const auto& pod : waiting_) {
      if (pod == exclude) continue;
      if (!eligible(pod, now)) continue;
      best = std::min(best, rank(pod, now));
    }
    return best;
  }

  const double base_quota_ms_;
  const double min_quota_ms_;
  const double window_ms_;
  const int slots_;

  mutable std::mutex mu_;
  std::condition_variable cv_;
  std::map<std::string, PodQuota> quotas_;
  std::map<std::string, std::deque<Usage>> usage_;
  std::map<std::string, long long> mem_used_;
  std::vector<std::string> waiting_;
  int active_ = 0;
};

}  // namespace tpushare
