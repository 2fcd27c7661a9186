// Lock-cheap metrics registry for the native core (reference analog:
// horovod/common/timeline instrumentation points + the per-op stats the
// upstream autotuner consumes; SURVEY.md §5).  All counters and histogram
// buckets are relaxed atomics — instrumentation points are a single
// fetch_add on the hot path, and every site is guarded by MetricsOn() so
// a disabled registry costs one relaxed bool load.
#pragma once

#include <atomic>
#include <cstdint>
#include <functional>
#include <map>
#include <mutex>
#include <string>

namespace hvdtpu {

// Fixed power-of-two microsecond buckets.  Bucket 0 holds [0, 1us);
// bucket b (1 <= b < kBuckets-1) holds [2^(b-1), 2^b) us; the last
// bucket is the +Inf overflow.  2^26 us ≈ 67 s upper finite bound.
struct Histogram {
  static constexpr int kNumBuckets = 28;
  std::atomic<int64_t> buckets[kNumBuckets];
  std::atomic<int64_t> count{0};
  std::atomic<int64_t> sum_us{0};

  Histogram() {
    for (auto& b : buckets) b.store(0, std::memory_order_relaxed);
  }

  void ObserveUs(int64_t us) {
    if (us < 0) us = 0;
    int b = 0;
    while (b < kNumBuckets - 1 && us >= (int64_t{1} << b)) ++b;
    buckets[b].fetch_add(1, std::memory_order_relaxed);
    count.fetch_add(1, std::memory_order_relaxed);
    sum_us.fetch_add(us, std::memory_order_relaxed);
  }

  void ObserveSeconds(double s) {
    ObserveUs(static_cast<int64_t>(s * 1e6));
  }

  // Upper bound of the bucket holding the q-quantile (conservative:
  // the true quantile is <= the returned value, within one power of 2).
  int64_t QuantileUs(double q) const;

  void Reset() {
    for (auto& b : buckets) b.store(0, std::memory_order_relaxed);
    count.store(0, std::memory_order_relaxed);
    sum_us.store(0, std::memory_order_relaxed);
  }

  // {"count":N,"sum_us":S,"p50_us":..,"p99_us":..,"buckets":[..]}
  std::string Json() const;
};

struct MetricsRegistry {
  std::atomic<bool> enabled{false};

  // Background-loop cycle occupancy: one tick = one sleep (idle) plus
  // the negotiation work that follows it (busy).
  std::atomic<int64_t> cycle_count{0};
  std::atomic<int64_t> cycle_busy_us{0};
  std::atomic<int64_t> cycle_idle_us{0};

  // Fusion efficiency: tensors and payload bytes per delivered fused
  // response.
  std::atomic<int64_t> responses_total{0};
  std::atomic<int64_t> tensors_fused_total{0};
  std::atomic<int64_t> bytes_fused_total{0};

  // Stall inspector fires (coordinator logs a missing-rank report) and
  // straggler attribution reports emitted.
  std::atomic<int64_t> stall_warnings_total{0};
  std::atomic<int64_t> straggler_reports_total{0};

  // Failure plane: ABORT frames sent/observed and fault-injection rule
  // fires (fault_injection.h).
  std::atomic<int64_t> aborts_total{0};
  std::atomic<int64_t> faults_injected_total{0};

  // Fleet-autopilot decisions recorded on the coordinator's policy
  // channel (evict / scale / readmit), regardless of driver outcome.
  std::atomic<int64_t> autopilot_decisions_total{0};

  // Fleet telemetry plane (protocol v11; fleet_telemetry.h): child/leader
  // sketches merged into the coordinator's fleet view, and anomalies the
  // sentinel emitted.
  std::atomic<int64_t> fleet_sketches_merged_total{0};
  std::atomic<int64_t> sentinel_anomalies_total{0};

  // Device-plane (in-jit / eager-XLA) collective payload accounting,
  // reported by the Python side per quantized dispatch: raw fp32 ring
  // bytes the collective WOULD have moved vs the int8 block-scaled bytes
  // it did move.  Uncompressed device collectives report nothing (XLA
  // moves those bytes without telling us), so the pair measures the
  // codec's ratio, not total device traffic.
  std::atomic<int64_t> device_raw_bytes{0};
  std::atomic<int64_t> device_encoded_bytes{0};

  // GSPMD-plane (compiler-inserted) collective accounting, reported by
  // the Python-side HLO inspector once per inspected trace
  // (ops/hlo_inspect.py): the number of collectives XLA emitted, the
  // analytic raw payload bytes they cover, and the analytic wire bytes a
  // ring schedule moves for them.  A compiled program cannot count at
  // run time, so — like the device_* pair above — these tick per trace,
  // not per step.
  std::atomic<int64_t> gspmd_collectives_total{0};
  std::atomic<int64_t> gspmd_raw_bytes{0};
  std::atomic<int64_t> gspmd_wire_bytes{0};
  std::atomic<int64_t> gspmd_traces_total{0};

  // Control-plane traffic (protocol v9): negotiation frames and payload
  // bytes moved on this rank's ctrl links.  On the coordinator,
  // ctrl_msgs_recv per cycle is the leader-tree acceptance metric —
  // O(ranks) flat vs O(local ranks + hosts) with the tree engaged.
  std::atomic<int64_t> ctrl_msgs_sent{0};
  std::atomic<int64_t> ctrl_msgs_recv{0};
  std::atomic<int64_t> ctrl_bytes_sent{0};
  std::atomic<int64_t> ctrl_bytes_recv{0};

  // Elastic state-migration plane (docs/elastic.md "Zero-downtime
  // migration"): replication refreshes, shard handoffs and their payload
  // bytes, and checkpoint fallbacks taken when peer shards could not
  // cover a loss.
  std::atomic<int64_t> migrate_events_total{0};
  std::atomic<int64_t> migrate_bytes_total{0};
  std::atomic<int64_t> migrate_fallbacks_total{0};

  // Gauges (last-written value, not monotone): the elastic generation
  // this rank most recently joined, so dashboards can correlate
  // migrate/abort counters with re-formations.
  std::atomic<int64_t> elastic_generation{0};
  // Goodput as parts-per-million of fleet wall time spent in the ring
  // phase (fleet_telemetry.cc recomputes it per tick; Prometheus renders
  // it as the hvd_goodput_ratio fraction).
  std::atomic<int64_t> goodput_ratio_ppm{0};

  // Latency distributions.
  Histogram negotiation_wait_us;  // enqueue -> fused response mapped back
  Histogram ring_hop_us;          // one pipelined chunk exchange step
  Histogram shm_fence_us;         // shm/hier dissemination-barrier fences
  Histogram abort_propagation_us;  // coordinator ABORT send -> worker observe
  Histogram step_time_us;          // completed causal-step wall time

  // Per-tenant (process-set) fused-response accounting.  Tenants are a
  // cold, small map (one entry per registered process set), so a plain
  // mutex is fine: the record site runs once per delivered response, not
  // per ring hop, and only when MetricsOn().
  struct TenantStats {
    int64_t responses = 0;
    int64_t tensors = 0;
    int64_t bytes = 0;
    Histogram negotiation_wait_us;
  };

  void RecordTenant(int psid, int64_t tensors, int64_t bytes);
  void RecordTenantWaitUs(int psid, int64_t wait_us);
  // Visit each tenant's negotiation-wait histogram under the tenants
  // lock (the fleet-sketch capture path; Histogram is non-copyable).
  void ForEachTenantWait(
      const std::function<void(int, const Histogram&)>& fn) const;

  void Reset();

  // Full registry as one JSON object.  extra_json, when non-empty, is a
  // pre-rendered fragment (e.g. the coordinator's cluster view) spliced
  // into the object as additional top-level members; it must start with
  // a comma-free `"key":...` sequence.
  std::string DumpJson(int rank, const std::string& extra_json) const;

 private:
  mutable std::mutex tenants_mu_;
  std::map<int, TenantStats> tenants_;
};

MetricsRegistry& GlobalMetrics();

inline bool MetricsOn() {
  return GlobalMetrics().enabled.load(std::memory_order_relaxed);
}

// Elastic-migration phase codes, carried in the type-14 flight event's
// `a` field as phase << 8 | (source_rank + 1).  Keep in sync with
// horovod_tpu/elastic/migrate.py PHASE_* and tools/postmortem.py
// _MIGRATE_PHASES.
enum MigratePhase : int {
  kMigrateReplicate = 1,   // periodic shard refresh onto ring neighbors
  kMigrateManifest = 2,    // post-reformation shard-manifest allgather
  kMigrateTransfer = 3,    // targeted shard transfers to claimants
  kMigrateReassemble = 4,  // per-rank state reassembly from shards
  kMigrateFallback = 5,    // replication could not cover; checkpoint path
};

// Shared note point for the migration plane, callable from the extern-C
// ABI and the in-process selftests alike: bumps the migrate counters
// (under MetricsOn) and records a type-14 flight event (under FlightOn).
// `source_rank` < 0 means "no specific peer".
void NoteMigration(int phase, int64_t bytes, int source_rank);

// Shared note point for the compiled-HLO introspection layer, callable
// from the extern-C ABI before or without hvd_init (the registry is
// process-global): bumps the gspmd_* counters unconditionally (like the
// device_plane byte pair — data_plane_stats() serves them with the
// metrics plane off) and records a type-16 flight event carrying the op
// count and the analytic wire bytes (under FlightOn).
void NoteHloInspect(int64_t ops, int64_t raw_bytes, int64_t wire_bytes);

// JSON string-body escaping shared by the timeline writer, the metrics
// dump, and the error-string paths: quotes, backslashes, and all control
// characters (< 0x20) become legal JSON escapes, so arbitrary tensor
// names cannot corrupt a trace or dump.
std::string JsonEscape(const std::string& s);

}  // namespace hvdtpu
