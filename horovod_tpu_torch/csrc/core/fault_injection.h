// Deterministic in-process fault injection for the native control and data
// planes.  The reference project only exercised failure paths from the
// outside (killed workers, mutated discovery files; SURVEY.md §3.5) — this
// plane lets a test drop, truncate, corrupt, delay, or kill at a named
// protocol site on an exact hit index, so every abort path in
// socket_controller.cc is reachable on demand and bit-for-bit repeatable.
//
// Spec (HOROVOD_FAULT_INJECT): comma-separated `site:cycle:rank:action[:arg]`
//   site   = rendezvous-accept | coordinator-recv | ring-send | ring-recv |
//            shm-fence | frame-header | leader-recv | super-recv
//   cycle  = '*' (every matching hit) or a 0-based hit index at that
//            (site, rank) — one-shot, latched once fired
//   rank   = '*' or the acting rank (for coordinator-side sites: the REMOTE
//            peer rank the coordinator is serving)
//   action = drop | truncate | delay (arg = ms) | corrupt-tag |
//            die (arg = optional once-latch flag-file path; if the file
//            already exists the rule is skipped, so a respawned elastic
//            worker does not crash-loop)
//
// Hook sites are guarded by one relaxed bool load (FaultInjectionOn), the
// same zero-cost-when-disabled discipline as MetricsOn() in metrics.h.
#pragma once

#include <atomic>
#include <cstdint>
#include <deque>
#include <string>

namespace hvdtpu {

enum FaultSite : int {
  kFaultRendezvousAccept = 0,
  kFaultCoordinatorRecv = 1,
  kFaultRingSend = 2,
  kFaultRingRecv = 3,
  kFaultShmFence = 4,
  kFaultFrameHeader = 5,
  // v9 leader tree: a host leader receiving a child's CYCLE frame.  The
  // rank field is the REMOTE child rank (mirror of coordinator-recv).
  kFaultLeaderRecv = 6,
  // v12 adaptive depth: a mid-level super-leader receiving a downstream
  // leader's [-3] aggregate frame.  The rank field is the REMOTE child
  // leader rank; the coordinator's own gathers keep coordinator-recv.
  kFaultSuperRecv = 7,
  kNumFaultSites = 8,
};

enum class FaultAction : int {
  kNone = 0,
  kDrop,        // close the site's socket
  kTruncate,    // partial write then close (caller implements the cut)
  kDelay,       // sleep arg ms (handled inside FaultCheck)
  kCorruptTag,  // flip frame-header tag bits (caller implements)
  kDie,         // _exit(137), optionally latched by a flag file
};

struct FaultRule {
  FaultSite site = kFaultRendezvousAccept;
  int cycle = -1;  // -1 = '*': every matching hit; else 0-based hit index
  int rank = -1;   // -1 = '*': any rank
  FaultAction action = FaultAction::kNone;
  long long arg = 0;    // delay: milliseconds
  std::string arg_str;  // die: once-latch flag-file path
  std::atomic<bool> fired{false};
};

struct FaultInjector {
  std::atomic<bool> enabled{false};
  // deque, not vector: FaultRule holds an atomic and cannot be copied or
  // moved, and deque::emplace_back constructs in place without relocation.
  std::deque<FaultRule> rules;
  // Per-(site, rank) hit counters; out-of-range ranks clamp into the edge
  // slots so counting never writes out of bounds.
  static constexpr int kMaxTrackedRanks = 64;
  std::atomic<int64_t> hits[kNumFaultSites][kMaxTrackedRanks] = {};
};

FaultInjector& GlobalFaultInjector();

inline bool FaultInjectionOn() {
  return GlobalFaultInjector().enabled.load(std::memory_order_relaxed);
}

const char* FaultSiteName(FaultSite site);

// Parses `spec` into `rules` (append; may be null for validate-only).
// Returns "" on success or an actionable one-line error naming the bad
// entry and the valid vocabulary.
std::string ParseFaultSpec(const std::string& spec,
                           std::deque<FaultRule>* rules);

// Reads HOROVOD_FAULT_INJECT; empty/unset leaves injection disabled.
// Resets any rules from a previous init in this process (elastic re-init)
// so hit indices stay deterministic.  Returns "" or the parse error.
std::string InitFaultInjection();

// Records a hit at `site` for `rank` and returns the action the caller must
// apply (kNone, kDrop, kTruncate, kCorruptTag).  kDelay sleeps internally
// and kDie exits the process, so callers only need to handle the three
// socket-level actions; `arg` (when non-null) receives the rule's numeric
// argument.  Call only under FaultInjectionOn().
FaultAction FaultCheck(FaultSite site, int rank, long long* arg = nullptr);

}  // namespace hvdtpu
