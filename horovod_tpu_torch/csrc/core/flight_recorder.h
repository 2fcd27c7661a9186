// Always-on flight recorder: a lock-free per-thread ring buffer of compact
// binary events recorded at the sites the metrics plane already instruments
// (rendezvous, CYCLE send/recv, negotiation verdicts, ring hops, shm fences,
// leader-tree aggregates, fault-injection trips, abort frames).  The black
// box survives until the moment of death: on abort, fatal init error, or a
// fatal signal each rank dumps its buffer to HOROVOD_POSTMORTEM_DIR, and the
// coordinator merges surviving ranks' last-N-event digests into one
// postmortem.json (socket_controller.cc BroadcastAbortAndFail).
//
// Cost discipline matches metrics.h: every record site is guarded by a
// single relaxed bool load (FlightOn), and a record is a handful of relaxed
// atomic stores into a pre-allocated slot — no locks, no allocation, no
// syscalls beyond the vDSO clock read.  Slots are per-thread so writers
// never contend; the dump path reads the same atomics, so a dump racing a
// crash observes at worst one torn (self-labelled, droppable) event.
#pragma once

#include <atomic>
#include <cstdint>
#include <string>
#include <vector>

namespace hvdtpu {

// Event vocabulary.  Keep in sync with the "types" legend emitted by the
// dump paths (flight_recorder.cc kFlightTypesLegend) and decoded by
// tools/postmortem.py.
enum FlightType : int32_t {
  kFlightCtrlSend = 1,    // a = 0,            b = payload bytes
  kFlightCtrlRecv = 2,    // a = 0,            b = payload bytes
  kFlightRendezvous = 3,  // a = world size,   b = protocol version
  kFlightVerdict = 4,     // a = responses,    b = data-op seq after verdict
  kFlightRingHop = 5,     // a = frame tag,    b = bytes sent
  kFlightWireCodec = 6,   // a = codec id,     b = payload bytes
  kFlightShmFence = 7,    // a = fence tag,    b = 0
  kFlightShmMap = 8,      // a = 0 open/1 grow, b = capacity bytes
  kFlightTreeAgg = 9,     // a = child frames, b = aggregate bytes
  kFlightFaultTrip = 10,  // a = fault site,   b = action
  kFlightAbort = 11,      // a = culprit rank, b = 0 observed / 1 broadcast
  kFlightDigest = 12,     // a = source rank,  b = events carried
  kFlightAutopilot = 13,  // a = action code,  b = target rank
  kFlightMigrate = 14,    // a = phase<<8 | source rank (+1; 0 = none),
                          // b = payload bytes
  kFlightSentinel = 15,   // a = kind<<8 | rank (+1; 0 = fleet-wide),
                          // b = observed value (us or ppm)
  kFlightHloInspect = 16, // a = compiler-inserted collective op count,
                          // b = analytic wire bytes for the trace
};

struct FlightEvent {
  int64_t ts_us = 0;  // CLOCK_REALTIME microseconds (cross-rank comparable)
  uint64_t seq = 0;   // global record order on this rank
  int32_t type = 0;   // FlightType
  int32_t tid = 0;    // recorder thread slot (not the OS tid)
  int32_t a = 0;
  int64_t b = 0;
};

struct FlightRecorderState {
  std::atomic<bool> enabled{false};
};

FlightRecorderState& GlobalFlightRecorder();

// The per-site guard: one relaxed bool load when disabled, mirroring
// MetricsOn() in metrics.h.
inline bool FlightOn() {
  return GlobalFlightRecorder().enabled.load(std::memory_order_relaxed);
}

// Arms the recorder.  `slots` is rounded up to a power of two (default
// 4096); `postmortem_dir` may contain a literal "{rank}" (substituted like
// HOROVOD_METRICS_FILE) and enables crash dumps + fatal-signal handlers
// when non-empty.  Idempotent per init; elastic re-init re-arms in place.
void InitFlightRecorder(bool enabled, int slots,
                        const std::string& postmortem_dir, int rank);

// Records one event into the calling thread's ring.  Call only under
// FlightOn(); silently drops if the thread table (64 slots) is exhausted.
void FlightRecord(int32_t type, int32_t a, int64_t b);

// Last `n` events across all thread rings, oldest first (sorted by seq).
void FlightTail(int n, std::vector<FlightEvent>* out);

// Full buffer as one JSON object (same schema as the crash dump, events
// sorted by seq) — the hvd.flight_record() payload.
std::string FlightDumpJson();

// Async-signal-safe dump of the full buffer to FlightDumpPath() via
// tmp-file + rename (atomic: readers never see a partial file).  No-op
// when no postmortem dir is configured; safe to call from a signal
// handler, an abort path, and concurrently (single-flight latch).
void FlightDumpToFile();

// This rank's crash-dump path ("" when no postmortem dir is configured).
std::string FlightDumpPath();

// The rank-substituted postmortem directory ("" when unset) — where the
// coordinator writes the merged postmortem.json.
std::string FlightPostmortemDir();

// The static event-type legend (a JSON object literal), shared by the dump
// paths and the coordinator's merged postmortem.json.
const char* FlightTypesLegend();

// Events overwritten so far (ring wrapped past unread slots), summed over
// threads.
int64_t FlightDropped();

// Test-only: disarm, free rings, and forget registered threads.  Callers
// must quiesce every recording thread first — a record racing the reset
// would touch a freed ring.
void ResetFlightRecorderForTest();

}  // namespace hvdtpu
