#include "step_trace.h"

#include <time.h>

#include <algorithm>
#include <cstdio>
#include <mutex>
#include <sstream>
#include <vector>

#include "metrics.h"

namespace hvdtpu {

namespace {

constexpr int kDefaultSlots = 256;
constexpr int kMinSlots = 16;
constexpr int kMaxSlots = 1 << 16;

const char* kPhaseNames[kStepPhases] = {"negotiation_wait", "fusion", "ring",
                                        "fence", "idle"};

struct StepRec {
  int64_t step_id = -1;
  int64_t start_us = 0;
  int64_t end_us = 0;
  int64_t phase_us[kStepPhases] = {0};
  int plane = -1;  // -1 unknown, 0 eager, 1 gspmd
};

// One fleet record per step id on the coordinator.  Keyed by
// step_id % slots with an id check: phase snapshots for step N arrive one
// or more cycles after the coordinator advanced past N, so records stay
// writable until the ring laps them.
struct FleetRec {
  int64_t step_id = -1;
  int64_t phase_us[kStepPhases] = {0};
  std::vector<int64_t> rank_lag_us;
  std::vector<int64_t> rank_neg_us;
  // A rank's trailer repeats the same snapshot every cycle until its next
  // step completes; only the first report per (rank, step) counts.
  std::vector<uint8_t> rank_reported;
  int reported = 0;
  int plane = -1;  // coordinator's plane tag when the record formed
};

struct State {
  int rank = 0;
  int world = 1;
  int slots = kDefaultSlots;
  std::string dump_path;

  // The forming step: lock-free accumulation, swapped out under `mu` once
  // per Advance.
  std::atomic<int64_t> cur_step{0};
  std::atomic<int64_t> cur_phase_us[kStepPhases] = {};
  std::atomic<int64_t> cur_start_us{0};
  // Sticky data-plane tag (StepTraceNotePlane): -1 unknown, 0 eager,
  // 1 gspmd.  Written once per trace, read once per Advance.
  std::atomic<int> cur_plane{-1};

  std::mutex mu;  // guards everything below
  std::vector<StepRec> ring;
  int64_t completed = 0;  // total steps ever closed
  StepRec last;
  std::vector<FleetRec> fleet;
  int64_t fleet_seen = 0;  // fleet records ever touched (dump ordering)
  // Cumulative fleet phase sums (every reported vector, never lapped) —
  // the goodput denominator — and the newest fleet step id reported, for
  // the sentinel's dominant-phase/rank attribution.
  int64_t fleet_phase_cum[kStepPhases] = {0};
  int64_t fleet_last_step = -1;
};

State& S() {
  static State* s = new State();
  return *s;
}

int64_t NowUs() {
  struct timespec ts;
  ::clock_gettime(CLOCK_REALTIME, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000 + ts.tv_nsec / 1000;
}

// Locates (initializing if fresh) the fleet record for `step_id`; null for
// ids the ring has already lapped.  Caller holds s.mu.
FleetRec* FleetFor(State& s, int64_t step_id) {
  if (step_id < 0 || s.fleet.empty()) return nullptr;
  FleetRec& f = s.fleet[static_cast<size_t>(step_id) % s.fleet.size()];
  if (f.step_id == step_id) return &f;
  if (f.step_id > step_id) return nullptr;  // lapped: the report is stale
  f.step_id = step_id;
  std::fill(f.phase_us, f.phase_us + kStepPhases, 0);
  f.rank_lag_us.assign(s.world, 0);
  f.rank_neg_us.assign(s.world, 0);
  f.rank_reported.assign(s.world, 0);
  f.reported = 0;
  f.plane = s.cur_plane.load(std::memory_order_relaxed);
  ++s.fleet_seen;
  return &f;
}

// Dominant phase of a fleet phase vector: argmax excluding idle (a fleet
// of sleeping ranks is "idle", not mysteriously busy).
int DominantPhase(const int64_t* phase_us) {
  int best = -1;
  int64_t best_us = 0;
  for (int p = 0; p < kStepPhases; ++p) {
    if (p == kPhaseIdle) continue;
    if (phase_us[p] > best_us) {
      best_us = phase_us[p];
      best = p;
    }
  }
  return best >= 0 ? best : kPhaseIdle;
}

// Dominant rank: whoever the coordinator waited on — argmax announce lag,
// falling back to argmax per-rank negotiation wait; -1 when nothing
// distinguishes the ranks.
int DominantRank(const FleetRec& f) {
  int best = -1;
  int64_t best_us = 0;
  for (size_t r = 0; r < f.rank_lag_us.size(); ++r) {
    if (f.rank_lag_us[r] > best_us) {
      best_us = f.rank_lag_us[r];
      best = static_cast<int>(r);
    }
  }
  if (best >= 0) return best;
  for (size_t r = 0; r < f.rank_neg_us.size(); ++r) {
    if (f.rank_neg_us[r] > best_us) {
      best_us = f.rank_neg_us[r];
      best = static_cast<int>(r);
    }
  }
  return best;
}

void AppendFleetJson(std::ostringstream& os, const FleetRec& f) {
  os << "{\"step\":" << f.step_id << ",\"phase_us\":[";
  for (int p = 0; p < kStepPhases; ++p) {
    if (p) os << ',';
    os << f.phase_us[p];
  }
  os << "],\"lag_us\":[";
  for (size_t r = 0; r < f.rank_lag_us.size(); ++r) {
    if (r) os << ',';
    os << f.rank_lag_us[r];
  }
  os << "],\"reported\":" << f.reported << ",\"dominant_phase\":\""
     << StepPhaseName(DominantPhase(f.phase_us)) << "\",\"dominant_rank\":"
     << DominantRank(f) << ",\"plane\":" << f.plane << "}";
}

}  // namespace

const char* StepPhaseName(int phase) {
  if (phase < 0 || phase >= kStepPhases) return "?";
  return kPhaseNames[phase];
}

StepTraceGate& GlobalStepTraceGate() {
  static StepTraceGate* g = new StepTraceGate();
  return *g;
}

void InitStepTrace(bool enabled, int slots, const std::string& postmortem_dir,
                   int rank, int world) {
  State& s = S();
  std::lock_guard<std::mutex> l(s.mu);
  if (slots <= 0) slots = kDefaultSlots;
  int p = kMinSlots;
  while (p < slots && p < kMaxSlots) p <<= 1;
  s.rank = rank;
  s.world = world > 0 ? world : 1;
  s.slots = p;
  s.ring.assign(p, StepRec());
  s.fleet.assign(p, FleetRec());
  s.completed = 0;
  s.fleet_seen = 0;
  std::fill(s.fleet_phase_cum, s.fleet_phase_cum + kStepPhases, 0);
  s.fleet_last_step = -1;
  s.last = StepRec();
  s.cur_step.store(0, std::memory_order_relaxed);
  for (auto& a : s.cur_phase_us) a.store(0, std::memory_order_relaxed);
  s.cur_plane.store(-1, std::memory_order_relaxed);
  s.cur_start_us.store(NowUs(), std::memory_order_relaxed);
  std::string dir = postmortem_dir;
  auto pos = dir.find("{rank}");
  if (pos != std::string::npos) dir.replace(pos, 6, std::to_string(rank));
  s.dump_path =
      dir.empty() ? "" : dir + "/steptrace." + std::to_string(rank) + ".json";
  GlobalStepTraceGate().enabled.store(enabled, std::memory_order_relaxed);
}

void StepTraceAddPhaseUs(int phase, int64_t us) {
  if (!StepTraceOn()) return;
  if (phase < 0 || phase >= kStepPhases || us <= 0) return;
  S().cur_phase_us[phase].fetch_add(us, std::memory_order_relaxed);
}

void StepTraceNotePlane(int plane) {
  if (plane < -1 || plane > 1) return;
  S().cur_plane.store(plane, std::memory_order_relaxed);
}

void StepTraceAdvance(int64_t step_id) {
  if (!StepTraceOn()) return;
  State& s = S();
  std::lock_guard<std::mutex> l(s.mu);
  const int64_t cur = s.cur_step.load(std::memory_order_relaxed);
  if (step_id <= cur) return;  // duplicate trailer / stale id
  StepRec rec;
  rec.step_id = cur;
  rec.start_us = s.cur_start_us.load(std::memory_order_relaxed);
  rec.end_us = NowUs();
  for (int p = 0; p < kStepPhases; ++p) {
    // exchange, not load: attribution racing the swap lands on the next
    // step (a few microseconds of drift) instead of being double-counted.
    rec.phase_us[p] = s.cur_phase_us[p].exchange(0, std::memory_order_relaxed);
  }
  rec.plane = s.cur_plane.load(std::memory_order_relaxed);
  if (!s.ring.empty()) {
    s.ring[static_cast<size_t>(s.completed) % s.ring.size()] = rec;
  }
  ++s.completed;
  s.last = rec;
  if (MetricsOn()) {
    // The step-time distribution every rank contributes to the fleet
    // sketch (protocol v11): wall time of the step just closed.
    GlobalMetrics().step_time_us.ObserveUs(rec.end_us - rec.start_us);
  }
  s.cur_step.store(step_id, std::memory_order_relaxed);
  s.cur_start_us.store(rec.end_us, std::memory_order_relaxed);
}

int64_t StepTraceCurrentStep() {
  return S().cur_step.load(std::memory_order_relaxed);
}

bool StepTraceLastCompleted(int64_t* step_id, int64_t* phase_us) {
  State& s = S();
  std::lock_guard<std::mutex> l(s.mu);
  if (s.completed == 0) return false;
  *step_id = s.last.step_id;
  for (int p = 0; p < kStepPhases; ++p) phase_us[p] = s.last.phase_us[p];
  return true;
}

void StepTraceFleetPhases(int rank, int64_t step_id, const int64_t* phase_us) {
  if (!StepTraceOn()) return;
  State& s = S();
  std::lock_guard<std::mutex> l(s.mu);
  if (rank < 0 || rank >= s.world) return;
  FleetRec* f = FleetFor(s, step_id);
  if (f == nullptr || f->rank_reported[rank]) return;
  f->rank_reported[rank] = 1;
  for (int p = 0; p < kStepPhases; ++p) {
    f->phase_us[p] += phase_us[p];
    s.fleet_phase_cum[p] += phase_us[p];
  }
  f->rank_neg_us[rank] += phase_us[kPhaseNegotiation];
  ++f->reported;
  if (step_id > s.fleet_last_step) s.fleet_last_step = step_id;
}

void StepTraceFleetPhaseTotals(int64_t* out) {
  State& s = S();
  std::lock_guard<std::mutex> l(s.mu);
  for (int p = 0; p < kStepPhases; ++p) out[p] = s.fleet_phase_cum[p];
}

bool StepTraceFleetDominant(int64_t* step_id, int* phase, int* rank) {
  State& s = S();
  std::lock_guard<std::mutex> l(s.mu);
  if (s.fleet_last_step < 0 || s.fleet.empty()) return false;
  const FleetRec& f =
      s.fleet[static_cast<size_t>(s.fleet_last_step) % s.fleet.size()];
  if (f.step_id != s.fleet_last_step) return false;  // lapped meanwhile
  *step_id = f.step_id;
  *phase = DominantPhase(f.phase_us);
  *rank = DominantRank(f);
  return true;
}

int StepTraceFleetDominantRecentRank(int window) {
  State& s = S();
  std::lock_guard<std::mutex> l(s.mu);
  if (s.fleet_last_step < 0 || s.fleet.empty() || s.world <= 0) return -1;
  std::vector<int> votes(static_cast<size_t>(s.world), 0);
  const int64_t lo = std::max<int64_t>(0, s.fleet_last_step - window + 1);
  for (int64_t sid = s.fleet_last_step; sid >= lo; --sid) {
    const FleetRec& f = s.fleet[static_cast<size_t>(sid) % s.fleet.size()];
    if (f.step_id != sid) continue;  // lapped
    const int r = DominantRank(f);
    if (r >= 0 && r < s.world) ++votes[static_cast<size_t>(r)];
  }
  int best = -1, best_votes = 0;
  for (int r = 0; r < s.world; ++r) {
    if (votes[static_cast<size_t>(r)] > best_votes) {
      best_votes = votes[static_cast<size_t>(r)];
      best = r;
    }
  }
  return best;
}

void StepTraceFleetLagUs(int rank, int64_t lag_us) {
  if (!StepTraceOn()) return;
  State& s = S();
  std::lock_guard<std::mutex> l(s.mu);
  if (rank < 0 || rank >= s.world || lag_us < 0) return;
  FleetRec* f = FleetFor(s, s.cur_step.load(std::memory_order_relaxed));
  if (f == nullptr) return;
  f->rank_lag_us[rank] += lag_us;
}

std::string StepTraceDumpJson() {
  State& s = S();
  std::lock_guard<std::mutex> l(s.mu);
  std::ostringstream os;
  os << "{\"schema\":\"steptrace-v1\",\"rank\":" << s.rank
     << ",\"world\":" << s.world << ",\"slots\":" << s.slots
     << ",\"completed\":" << s.completed << ",\"phases\":[";
  for (int p = 0; p < kStepPhases; ++p) {
    if (p) os << ',';
    os << '"' << kPhaseNames[p] << '"';
  }
  os << "],\"steps\":[";
  const int64_t n = std::min<int64_t>(s.completed,
                                      static_cast<int64_t>(s.ring.size()));
  bool first = true;
  for (int64_t k = s.completed - n; k < s.completed; ++k) {
    const StepRec& r = s.ring[static_cast<size_t>(k) % s.ring.size()];
    if (!first) os << ',';
    first = false;
    os << '[' << r.step_id << ',' << r.start_us << ',' << r.end_us;
    for (int p = 0; p < kStepPhases; ++p) os << ',' << r.phase_us[p];
    // Trailing plane tag (steptrace-v1 stays the schema: consumers index
    // the phase columns positionally and tolerate extra elements).
    os << ',' << r.plane << ']';
  }
  os << "],\"fleet\":[";
  // Ascending step order: walk the ring sorted by id (ids are sparse in
  // the ring but unique), skipping never-written records.
  std::vector<const FleetRec*> recs;
  for (const auto& f : s.fleet) {
    if (f.step_id >= 0) recs.push_back(&f);
  }
  std::sort(recs.begin(), recs.end(),
            [](const FleetRec* a, const FleetRec* b) {
              return a->step_id < b->step_id;
            });
  for (size_t i = 0; i < recs.size(); ++i) {
    if (i) os << ',';
    AppendFleetJson(os, *recs[i]);
  }
  os << "]}";
  return os.str();
}

void StepTraceDumpToFile() {
  State& s = S();
  std::string path;
  {
    std::lock_guard<std::mutex> l(s.mu);
    path = s.dump_path;
  }
  if (path.empty()) return;
  const std::string json = StepTraceDumpJson();
  const std::string tmp = path + ".tmp";
  FILE* f = std::fopen(tmp.c_str(), "w");
  if (f == nullptr) return;
  std::fwrite(json.data(), 1, json.size(), f);
  std::fputc('\n', f);
  std::fclose(f);
  std::rename(tmp.c_str(), path.c_str());
}

void ResetStepTraceForTest() {
  State& s = S();
  GlobalStepTraceGate().enabled.store(false, std::memory_order_relaxed);
  std::lock_guard<std::mutex> l(s.mu);
  s.ring.clear();
  s.fleet.clear();
  s.completed = 0;
  s.fleet_seen = 0;
  std::fill(s.fleet_phase_cum, s.fleet_phase_cum + kStepPhases, 0);
  s.fleet_last_step = -1;
  s.last = StepRec();
  s.dump_path.clear();
  s.cur_step.store(0, std::memory_order_relaxed);
  for (auto& a : s.cur_phase_us) a.store(0, std::memory_order_relaxed);
  s.cur_plane.store(-1, std::memory_order_relaxed);
}

}  // namespace hvdtpu
