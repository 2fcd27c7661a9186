// Causal step tracing: the fifth observability pillar (docs/observability.md).
//
// Every background-loop cycle that ships real work advances a coordinator-
// assigned step id (carried in the v10 control frames), and the sites the
// flight recorder already instruments attribute their elapsed time to the
// current step's phase vector:
//
//   negotiation_wait  enqueue -> response delivery (the victim-side signal)
//   fusion            coordinator fuse/gate + leader tree aggregation
//   ring              host data-plane ring hops (pipelined exchange steps)
//   fence             socket barriers sequencing the shm plane
//   idle              background-loop sleep
//
// Completed steps land in a per-rank ring; the last completed record
// piggybacks on the next CYCLE frame (protocol v10 trailer) so the
// coordinator can aggregate a fleet view per step — phase sums across
// ranks, per-rank announce lag, and the derived dominant phase / dominant
// rank the live cockpit and tools/critical_path.py report.
//
// Cost discipline (same bar as the flight recorder): when disabled every
// site pays ONE relaxed atomic bool load and a branch.  When enabled a
// site pays a relaxed fetch_add on the current phase vector; only the
// once-per-step Advance takes a lock.  Standalone on purpose (no repo
// deps beyond the standard library) so it joins the selftest builds.
#pragma once

#include <atomic>
#include <cstdint>
#include <string>

namespace hvdtpu {

// Phase indices of a step's breakdown vector.  Order is ABI: the CYCLE
// trailer, the JSON dumps and tools/critical_path.py all index by it.
enum StepPhase : int32_t {
  kPhaseNegotiation = 0,
  kPhaseFusion = 1,
  kPhaseRing = 2,
  kPhaseFence = 3,
  kPhaseIdle = 4,
  kStepPhases = 5,
};

// "negotiation_wait" / "fusion" / "ring" / "fence" / "idle" (or "?" out
// of range) — the names every JSON surface uses.
const char* StepPhaseName(int phase);

struct StepTraceGate {
  std::atomic<bool> enabled{false};
};
StepTraceGate& GlobalStepTraceGate();

// The one check every instrumentation site pays when tracing is off.
inline bool StepTraceOn() {
  return GlobalStepTraceGate().enabled.load(std::memory_order_relaxed);
}

// `slots` rounds up to a power of two (bounded); `postmortem_dir` ("" =
// no file dumps) gets a `{rank}` substitution like the flight recorder's;
// `world` sizes the coordinator's per-rank fleet vectors.
void InitStepTrace(bool enabled, int slots, const std::string& postmortem_dir,
                   int rank, int world);

// Attribute `us` microseconds to `phase` of the step currently forming.
// Callable from any thread (relaxed fetch_add).
void StepTraceAddPhaseUs(int phase, int64_t us);

// Tag the steps being formed with the data plane running them: -1
// unknown, 0 eager, 1 gspmd (compiler-inserted collectives).  Sticky
// until changed — the optimizer notes it once per trace, not per step.
// Closed steps carry the tag as a trailing element of their dump row and
// fleet records inherit the coordinator's current tag, so
// tools/critical_path.py and the cockpit can attribute steps to a plane.
void StepTraceNotePlane(int plane);

// Close the forming step into the ring and start `step_id`.  Workers call
// it when the RESPONSES trailer's step id moves past their own; the
// coordinator when a cycle ships real work.  Ids must be monotonic;
// stale/equal ids are ignored.
void StepTraceAdvance(int64_t step_id);
int64_t StepTraceCurrentStep();

// Snapshot of the most recently completed step for the CYCLE trailer:
// false until a first step completes.  `phase_us` must hold kStepPhases.
bool StepTraceLastCompleted(int64_t* step_id, int64_t* phase_us);

// Coordinator-side fleet aggregation, fed from the CYCLE trailers (phase
// snapshots) and the announce path (per-rank lag, attributed to the step
// the coordinator is currently forming).
void StepTraceFleetPhases(int rank, int64_t step_id, const int64_t* phase_us);
void StepTraceFleetLagUs(int rank, int64_t lag_us);

// Cumulative fleet phase totals since init (every phase vector ever fed
// to StepTraceFleetPhases, summed) — the goodput denominator
// (fleet_telemetry.cc).  `out` must hold kStepPhases; zeros when tracing
// is off or nothing reported yet.
void StepTraceFleetPhaseTotals(int64_t* out);

// Attribution for the sentinel: the dominant phase / rank of the newest
// fleet record any rank has reported into.  False when no fleet data
// arrived (then outputs are untouched).
bool StepTraceFleetDominant(int64_t* step_id, int* phase, int* rank);

// Majority-vote attribution over the newest `window` complete fleet
// records: per-step dominant-rank readings are noisy (an announce lag can
// land on the neighbouring forming step and blame a victim waiting in
// negotiation), so the sentinel votes across a short window instead of
// trusting one step.  -1 when no fleet record carries an attribution.
int StepTraceFleetDominantRecentRank(int window);

// Full dump: {"schema":"steptrace-v1","rank","world","phases",
// "steps":[[step,start_us,end_us,<5 phase us>],...],"fleet":[{...}]}.
// The fleet array is non-empty only where fleet data arrived (rank 0).
std::string StepTraceDumpJson();

// Atomic write-then-rename to <postmortem_dir>/steptrace.<rank>.json; a
// no-op without a postmortem dir.  Not async-signal-safe (takes the ring
// lock) — called at clean shutdown and from abort paths, never from
// signal handlers.
void StepTraceDumpToFile();

void ResetStepTraceForTest();

}  // namespace hvdtpu
