#include "fault_injection.h"

#include <fcntl.h>
#include <unistd.h>

#include <chrono>
#include <cstdlib>
#include <thread>
#include <vector>

#include "flight_recorder.h"
#include "logging.h"
#include "metrics.h"

namespace hvdtpu {

FaultInjector& GlobalFaultInjector() {
  // Leaked singleton (never destroyed): hook sites on detached threads may
  // run during process teardown, after static destructors would have fired.
  static FaultInjector* injector = new FaultInjector();
  return *injector;
}

namespace {

const char* const kSiteNames[kNumFaultSites] = {
    "rendezvous-accept", "coordinator-recv", "ring-send",  "ring-recv",
    "shm-fence",         "frame-header",     "leader-recv", "super-recv"};

constexpr const char* kValidSites =
    "rendezvous-accept, coordinator-recv, ring-send, ring-recv, shm-fence, "
    "frame-header, leader-recv, super-recv";
constexpr const char* kValidActions =
    "drop, truncate, delay (arg = ms), corrupt-tag, die (arg = optional "
    "flag-file path)";

std::vector<std::string> Split(const std::string& s, char sep) {
  std::vector<std::string> out;
  size_t start = 0;
  while (true) {
    size_t pos = s.find(sep, start);
    if (pos == std::string::npos) {
      out.push_back(s.substr(start));
      return out;
    }
    out.push_back(s.substr(start, pos - start));
    start = pos + 1;
  }
}

bool ParseSite(const std::string& s, FaultSite* out) {
  for (int i = 0; i < kNumFaultSites; ++i) {
    if (s == kSiteNames[i]) {
      *out = static_cast<FaultSite>(i);
      return true;
    }
  }
  return false;
}

// '*' -> -1; else a non-negative decimal integer.
bool ParseStarInt(const std::string& s, int* out) {
  if (s == "*") {
    *out = -1;
    return true;
  }
  if (s.empty()) return false;
  char* end = nullptr;
  long long v = std::strtoll(s.c_str(), &end, 10);
  if (!end || *end != '\0' || v < 0 || v > 1 << 28) return false;
  *out = static_cast<int>(v);
  return true;
}

const char* ActionName(FaultAction a) {
  switch (a) {
    case FaultAction::kNone: return "none";
    case FaultAction::kDrop: return "drop";
    case FaultAction::kTruncate: return "truncate";
    case FaultAction::kDelay: return "delay";
    case FaultAction::kCorruptTag: return "corrupt-tag";
    case FaultAction::kDie: return "die";
  }
  return "?";
}

}  // namespace

const char* FaultSiteName(FaultSite site) {
  if (site < 0 || site >= kNumFaultSites) return "?";
  return kSiteNames[site];
}

std::string ParseFaultSpec(const std::string& spec,
                           std::deque<FaultRule>* rules) {
  for (const std::string& entry : Split(spec, ',')) {
    if (entry.empty()) continue;
    std::vector<std::string> f = Split(entry, ':');
    if (f.size() < 4) {
      return "fault spec entry '" + entry +
             "': expected site:cycle:rank:action[:arg]";
    }
    FaultSite site;
    if (!ParseSite(f[0], &site)) {
      return "fault spec entry '" + entry + "': unknown site '" + f[0] +
             "' (valid sites: " + kValidSites + ")";
    }
    int cycle, rank;
    if (!ParseStarInt(f[1], &cycle)) {
      return "fault spec entry '" + entry + "': cycle '" + f[1] +
             "' must be '*' or a non-negative hit index";
    }
    if (!ParseStarInt(f[2], &rank)) {
      return "fault spec entry '" + entry + "': rank '" + f[2] +
             "' must be '*' or a non-negative rank";
    }
    FaultAction action;
    if (f[3] == "drop") {
      action = FaultAction::kDrop;
    } else if (f[3] == "truncate") {
      action = FaultAction::kTruncate;
    } else if (f[3] == "delay") {
      action = FaultAction::kDelay;
    } else if (f[3] == "corrupt-tag") {
      action = FaultAction::kCorruptTag;
    } else if (f[3] == "die") {
      action = FaultAction::kDie;
    } else {
      return "fault spec entry '" + entry + "': unknown action '" + f[3] +
             "' (valid actions: " + kValidActions + ")";
    }
    // Rejoin fields[4:] on ':' so die's flag-file path may contain colons.
    std::string arg_str;
    for (size_t i = 4; i < f.size(); ++i) {
      if (i > 4) arg_str += ':';
      arg_str += f[i];
    }
    long long arg = 0;
    if (action == FaultAction::kDelay) {
      char* end = nullptr;
      arg = arg_str.empty() ? -1 : std::strtoll(arg_str.c_str(), &end, 10);
      if (arg_str.empty() || !end || *end != '\0' || arg < 0) {
        return "fault spec entry '" + entry +
               "': delay requires a numeric millisecond arg (e.g. "
               "ring-send:*:1:delay:250)";
      }
    } else if (action != FaultAction::kDie && !arg_str.empty()) {
      return "fault spec entry '" + entry + "': action '" + f[3] +
             "' takes no arg";
    }
    if (rules) {
      rules->emplace_back();  // FaultRule holds an atomic: fill in place
      FaultRule& r = rules->back();
      r.site = site;
      r.cycle = cycle;
      r.rank = rank;
      r.action = action;
      r.arg = arg;
      r.arg_str = arg_str;
    }
  }
  return "";
}

std::string InitFaultInjection() {
  FaultInjector& inj = GlobalFaultInjector();
  // Re-init in the same process (post-abort hvd.init) starts from a clean
  // slate so hit indices stay deterministic.  Safe: called from hvd_init
  // before the background/executor threads exist.
  inj.enabled.store(false, std::memory_order_relaxed);
  inj.rules.clear();
  for (auto& site_hits : inj.hits) {
    for (auto& h : site_hits) h.store(0, std::memory_order_relaxed);
  }
  const char* env = std::getenv("HOROVOD_FAULT_INJECT");
  if (!env || !*env) return "";
  std::string err = ParseFaultSpec(env, &inj.rules);
  if (!err.empty()) return err;
  if (!inj.rules.empty()) {
    inj.enabled.store(true, std::memory_order_relaxed);
    HVD_LOG(WARNING) << "fault injection enabled: " << env;
  }
  return "";
}

FaultAction FaultCheck(FaultSite site, int rank, long long* arg) {
  FaultInjector& inj = GlobalFaultInjector();
  int slot = rank;
  if (slot < 0) slot = 0;
  if (slot >= FaultInjector::kMaxTrackedRanks) {
    slot = FaultInjector::kMaxTrackedRanks - 1;
  }
  const int64_t hit =
      inj.hits[site][slot].fetch_add(1, std::memory_order_relaxed);
  for (auto& rule : inj.rules) {
    if (rule.site != site) continue;
    if (rule.rank >= 0 && rule.rank != rank) continue;
    if (rule.action == FaultAction::kNone) continue;
    if (rule.cycle >= 0) {
      if (hit != rule.cycle) continue;
      bool expected = false;
      // relaxed both ways: the once-latch needs only RMW atomicity
      // (exactly one winner); no payload is published through the flag.
      if (!rule.fired.compare_exchange_strong(expected, true,
                                              std::memory_order_relaxed,
                                              std::memory_order_relaxed)) {
        continue;
      }
    }
    if (rule.action == FaultAction::kDie && !rule.arg_str.empty()) {
      // Once-latch: fire only if we can create the flag file.  A respawned
      // elastic worker finds it already present and keeps running.
      int fd = ::open(rule.arg_str.c_str(), O_CREAT | O_EXCL | O_WRONLY,
                      0644);
      if (fd < 0) continue;
      ::close(fd);
    }
    if (MetricsOn()) {
      GlobalMetrics().faults_injected_total.fetch_add(
          1, std::memory_order_relaxed);
    }
    HVD_LOG(WARNING) << "fault injection: " << ActionName(rule.action)
                     << " at " << FaultSiteName(site) << " rank " << rank
                     << " hit " << hit;
    if (FlightOn()) {
      FlightRecord(kFlightFaultTrip, static_cast<int32_t>(site),
                   static_cast<int64_t>(rule.action));
    }
    switch (rule.action) {
      case FaultAction::kDelay:
        std::this_thread::sleep_for(std::chrono::milliseconds(rule.arg));
        return FaultAction::kDelay;
      case FaultAction::kDie:
        // The injected death is the postmortem's whole subject: leave the
        // black box behind before vanishing.
        if (FlightOn()) FlightDumpToFile();
        _exit(137);
      default:
        if (arg) *arg = rule.arg;
        return rule.action;
    }
  }
  return FaultAction::kNone;
}

}  // namespace hvdtpu
