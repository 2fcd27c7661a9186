// Fleet telemetry plane (protocol v11; docs/observability.md sixth pillar):
// mergeable histogram sketches piggybacked on CYCLE frames, a coordinator-
// side multi-resolution history ring, goodput accounting, and a streaming
// anomaly sentinel.
//
// The metrics registry's power-of-two-bucket histograms are already
// mergeable (bucket counts add), so a "sketch" is nothing more than a
// non-atomic snapshot of those buckets, delta/varint-compressed onto the
// wire.  Workers ship their cumulative sketch on every CYCLE frame; host
// leaders (protocol v9 tree) sum child sketches into the aggregate frame so
// coordinator inbound stays O(hosts); the coordinator keeps the last-known
// sketch per source and sums them into true fleet histograms on demand.
// Because every sketch is cumulative-since-init and sources are replaced
// (never added twice), the fleet sum is bucket-exact equal to an offline
// merge of the per-rank HOROVOD_METRICS_FILE dumps.
//
// Cost discipline matches metrics.h / flight_recorder.h: every emit site is
// gated by one relaxed bool load (FleetTelemetryOn), encoding runs at most
// once per negotiation cycle on buckets already in cache, and the sentinel
// ticks at ~1 Hz on the coordinator only.
#pragma once

#include <atomic>
#include <cstdint>
#include <map>
#include <string>
#include <vector>

#include "metrics.h"

namespace hvdtpu {

// One mergeable histogram: the plain-integer image of metrics.h Histogram
// (same 28 power-of-two microsecond buckets, same [0,1us) bucket 0).
struct HistogramSketch {
  int64_t count = 0;
  int64_t sum_us = 0;
  int64_t buckets[Histogram::kNumBuckets] = {0};

  void Clear();
  // Snapshot-add a live registry histogram (relaxed loads — cumulative
  // counters, so a torn read is at worst one observation late).
  void AddFrom(const Histogram& h);
  void Merge(const HistogramSketch& o);
  // Conservative bucket-upper-bound quantile, mirroring
  // Histogram::QuantileUs so fleet p99s read on the same scale.
  int64_t QuantileUs(double q) const;
  // Same shape as Histogram::Json: {"count","sum_us","p50_us","p99_us",
  // "buckets"} — the Prometheus renderer treats fleet and local
  // histograms identically.
  std::string Json() const;
};

// The full per-source sketch riding a CYCLE frame: the four fleet latency
// families plus per-tenant negotiation wait.
struct FleetSketch {
  HistogramSketch negotiation_wait;
  HistogramSketch ring_hop;
  HistogramSketch step_time;
  HistogramSketch shm_fence;
  std::map<int, HistogramSketch> tenants;  // psid -> negotiation wait

  void Clear();
  void Merge(const FleetSketch& o);
  // Snapshot this process's registry (the worker-side emit path).
  void CaptureLocal();
  // Wire codec (sketch-v1): u8 version, four histograms, varint tenant
  // count + per-tenant psid/histogram.  Histograms are varint(count),
  // varint(sum_us), then 28 buckets delta-coded between consecutive
  // buckets (zigzag varint) — steady-state buckets are heavily
  // front-loaded, so deltas keep the trailer at tens of bytes.
  std::string Encode() const;
  // Replaces contents; false = malformed (caller drops the sketch, never
  // the frame).
  bool Decode(const char* data, size_t len);
  // {"negotiation_wait_us":{...},"ring_hop_us":{...},"step_time_us":{...},
  //  "shm_fence_us":{...},"tenants":{"psid":{...}}}
  std::string Json() const;
};

struct FleetTelemetryGate {
  std::atomic<bool> enabled{true};
};

FleetTelemetryGate& GlobalFleetTelemetry();

inline bool FleetTelemetryOn() {
  return GlobalFleetTelemetry().enabled.load(std::memory_order_relaxed);
}

// Arms the plane from HOROVOD_FLEET_TELEMETRY (default on; sketches only
// ride frames when the metrics plane is also enabled) and resets the
// history/sentinel state.  Reads HOROVOD_SENTINEL_ZSCORE for the
// detection threshold.  Called from hvd_init; elastic re-init re-arms.
void InitFleetTelemetry();

// One coordinator tick (rate-limited internally to ~1 Hz): append a
// history sample from the fleet sketch + the coordinator's data-plane
// byte counters, recompute goodput from the step-trace fleet phase
// totals, and run the sentinel over the new sample.  `wire_bytes` /
// `raw_bytes` are cumulative data-plane totals (wire < raw exactly when
// compression engaged).
void FleetTelemetryTick(const FleetSketch& fleet, int64_t wire_bytes,
                        int64_t raw_bytes);

// Multi-resolution history as one JSON object (fleethistory-v1): tier 0
// holds 1 s samples, tier 1 10 s, tier 2 60 s, each ring-bounded, plus
// the sentinel's anomaly log.  Sample rows are [ts_us, step_p99_us,
// neg_p99_us, goodput_ppm, wire_ratio_ppm, steps].
std::string FleetHistoryJson();

// The sentinel's anomaly log as a JSON array fragment ("[...]"), newest
// last, each {"seq","ts_us","kind","rank","value","baseline","score"}.
// Spliced into PolicyStatusJson so the autopilot sees advisories ahead of
// the consecutive-window eviction rule.
std::string FleetAnomaliesJson();

// Anomalies emitted since init (monotone; mirrors the
// sentinel_anomalies_total counter without requiring MetricsOn).
int64_t FleetAnomalyCount();

// Test-only: disarm and clear history/sentinel state.
void ResetFleetTelemetryForTest();

}  // namespace hvdtpu
