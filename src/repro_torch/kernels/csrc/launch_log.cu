// The launch log of the kernel-contract checker: every launcher records
// what it launches through famous::record_launch (common.cuh) while the
// log is on, and kernels/lib.py takes the records after each wrapper
// call (repro_torch/analysis/kernel_check.py checks them).  Off by
// default: a launch then pays one relaxed atomic load.
#include <atomic>
#include <mutex>

#include "common.cuh"

namespace famous {

namespace {
constexpr int kLogCap = 64;
std::atomic<int> g_on{0};
std::mutex g_mu;
LaunchRecord g_log[kLogCap];
int g_n = 0, g_dropped = 0;
}  // namespace

bool launch_log_on() { return g_on.load(std::memory_order_relaxed) != 0; }

void log_launch(const LaunchRecord& r) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_n < kLogCap)
    g_log[g_n++] = r;
  else
    ++g_dropped;
}

}  // namespace famous

// Turn the log on (1) or off (0); either way it starts empty.
extern "C" void famous_launch_log(int on) {
  std::lock_guard<std::mutex> lock(famous::g_mu);
  famous::g_n = famous::g_dropped = 0;
  famous::g_on.store(on != 0);
}

// Copy up to cap records into out, empty the log and return the count;
// *dropped: the records the full log could not hold.
extern "C" int famous_launch_log_take(famous::LaunchRecord* out, int cap, int* dropped) {
  std::lock_guard<std::mutex> lock(famous::g_mu);
  const int n = famous::g_n < cap ? famous::g_n : cap;
  for (int i = 0; i < n; ++i) out[i] = famous::g_log[i];
  *dropped = famous::g_dropped + (famous::g_n - n);
  famous::g_n = famous::g_dropped = 0;
  return n;
}
