#include "metrics.h"

#include <cstdio>
#include <sstream>

#include "flight_recorder.h"

namespace hvdtpu {

int64_t Histogram::QuantileUs(double q) const {
  int64_t n = count.load(std::memory_order_relaxed);
  if (n <= 0) return 0;
  int64_t target = static_cast<int64_t>(q * n);
  if (target < 1) target = 1;
  if (target > n) target = n;
  int64_t cum = 0;
  for (int b = 0; b < kNumBuckets; ++b) {
    cum += buckets[b].load(std::memory_order_relaxed);
    if (cum >= target) return int64_t{1} << b;
  }
  return int64_t{1} << (kNumBuckets - 1);
}

std::string Histogram::Json() const {
  std::ostringstream os;
  os << "{\"count\":" << count.load(std::memory_order_relaxed)
     << ",\"sum_us\":" << sum_us.load(std::memory_order_relaxed)
     << ",\"p50_us\":" << QuantileUs(0.5)
     << ",\"p99_us\":" << QuantileUs(0.99) << ",\"buckets\":[";
  for (int b = 0; b < kNumBuckets; ++b) {
    if (b) os << ',';
    os << buckets[b].load(std::memory_order_relaxed);
  }
  os << "]}";
  return os.str();
}

void MetricsRegistry::RecordTenant(int psid, int64_t tensors, int64_t bytes) {
  std::lock_guard<std::mutex> l(tenants_mu_);
  TenantStats& t = tenants_[psid];
  t.responses += 1;
  t.tensors += tensors;
  t.bytes += bytes;
}

void MetricsRegistry::RecordTenantWaitUs(int psid, int64_t wait_us) {
  std::lock_guard<std::mutex> l(tenants_mu_);
  tenants_[psid].negotiation_wait_us.ObserveUs(wait_us);
}

void MetricsRegistry::ForEachTenantWait(
    const std::function<void(int, const Histogram&)>& fn) const {
  std::lock_guard<std::mutex> l(tenants_mu_);
  for (const auto& kv : tenants_) fn(kv.first, kv.second.negotiation_wait_us);
}

void MetricsRegistry::Reset() {
  cycle_count.store(0, std::memory_order_relaxed);
  cycle_busy_us.store(0, std::memory_order_relaxed);
  cycle_idle_us.store(0, std::memory_order_relaxed);
  responses_total.store(0, std::memory_order_relaxed);
  tensors_fused_total.store(0, std::memory_order_relaxed);
  bytes_fused_total.store(0, std::memory_order_relaxed);
  stall_warnings_total.store(0, std::memory_order_relaxed);
  straggler_reports_total.store(0, std::memory_order_relaxed);
  aborts_total.store(0, std::memory_order_relaxed);
  faults_injected_total.store(0, std::memory_order_relaxed);
  autopilot_decisions_total.store(0, std::memory_order_relaxed);
  fleet_sketches_merged_total.store(0, std::memory_order_relaxed);
  sentinel_anomalies_total.store(0, std::memory_order_relaxed);
  device_raw_bytes.store(0, std::memory_order_relaxed);
  device_encoded_bytes.store(0, std::memory_order_relaxed);
  gspmd_collectives_total.store(0, std::memory_order_relaxed);
  gspmd_raw_bytes.store(0, std::memory_order_relaxed);
  gspmd_wire_bytes.store(0, std::memory_order_relaxed);
  gspmd_traces_total.store(0, std::memory_order_relaxed);
  ctrl_msgs_sent.store(0, std::memory_order_relaxed);
  ctrl_msgs_recv.store(0, std::memory_order_relaxed);
  ctrl_bytes_sent.store(0, std::memory_order_relaxed);
  ctrl_bytes_recv.store(0, std::memory_order_relaxed);
  migrate_events_total.store(0, std::memory_order_relaxed);
  migrate_bytes_total.store(0, std::memory_order_relaxed);
  migrate_fallbacks_total.store(0, std::memory_order_relaxed);
  elastic_generation.store(0, std::memory_order_relaxed);
  goodput_ratio_ppm.store(0, std::memory_order_relaxed);
  negotiation_wait_us.Reset();
  ring_hop_us.Reset();
  shm_fence_us.Reset();
  abort_propagation_us.Reset();
  step_time_us.Reset();
  {
    std::lock_guard<std::mutex> l(tenants_mu_);
    tenants_.clear();
  }
}

std::string MetricsRegistry::DumpJson(int rank,
                                      const std::string& extra_json) const {
  std::ostringstream os;
  os << "{\"enabled\":"
     << (enabled.load(std::memory_order_relaxed) ? "true" : "false")
     << ",\"rank\":" << rank << ",\"counters\":{"
     << "\"cycle_count\":" << cycle_count.load(std::memory_order_relaxed)
     << ",\"cycle_busy_us\":" << cycle_busy_us.load(std::memory_order_relaxed)
     << ",\"cycle_idle_us\":" << cycle_idle_us.load(std::memory_order_relaxed)
     << ",\"responses_total\":"
     << responses_total.load(std::memory_order_relaxed)
     << ",\"tensors_fused_total\":"
     << tensors_fused_total.load(std::memory_order_relaxed)
     << ",\"bytes_fused_total\":"
     << bytes_fused_total.load(std::memory_order_relaxed)
     << ",\"stall_warnings_total\":"
     << stall_warnings_total.load(std::memory_order_relaxed)
     << ",\"straggler_reports_total\":"
     << straggler_reports_total.load(std::memory_order_relaxed)
     << ",\"aborts_total\":" << aborts_total.load(std::memory_order_relaxed)
     << ",\"faults_injected_total\":"
     << faults_injected_total.load(std::memory_order_relaxed)
     << ",\"autopilot_decisions_total\":"
     << autopilot_decisions_total.load(std::memory_order_relaxed)
     << ",\"fleet_sketches_merged_total\":"
     << fleet_sketches_merged_total.load(std::memory_order_relaxed)
     << ",\"sentinel_anomalies_total\":"
     << sentinel_anomalies_total.load(std::memory_order_relaxed)
     << ",\"device_raw_bytes\":"
     << device_raw_bytes.load(std::memory_order_relaxed)
     << ",\"device_encoded_bytes\":"
     << device_encoded_bytes.load(std::memory_order_relaxed)
     << ",\"gspmd_collectives_total\":"
     << gspmd_collectives_total.load(std::memory_order_relaxed)
     << ",\"gspmd_raw_bytes\":"
     << gspmd_raw_bytes.load(std::memory_order_relaxed)
     << ",\"gspmd_wire_bytes\":"
     << gspmd_wire_bytes.load(std::memory_order_relaxed)
     << ",\"gspmd_traces_total\":"
     << gspmd_traces_total.load(std::memory_order_relaxed)
     << ",\"ctrl_msgs_sent\":"
     << ctrl_msgs_sent.load(std::memory_order_relaxed)
     << ",\"ctrl_msgs_recv\":"
     << ctrl_msgs_recv.load(std::memory_order_relaxed)
     << ",\"ctrl_bytes_sent\":"
     << ctrl_bytes_sent.load(std::memory_order_relaxed)
     << ",\"ctrl_bytes_recv\":"
     << ctrl_bytes_recv.load(std::memory_order_relaxed)
     << ",\"migrate_events_total\":"
     << migrate_events_total.load(std::memory_order_relaxed)
     << ",\"migrate_bytes_total\":"
     << migrate_bytes_total.load(std::memory_order_relaxed)
     << ",\"migrate_fallbacks_total\":"
     << migrate_fallbacks_total.load(std::memory_order_relaxed)
     << "},\"gauges\":{"
     << "\"elastic_generation\":"
     << elastic_generation.load(std::memory_order_relaxed)
     << ",\"goodput_ratio_ppm\":"
     << goodput_ratio_ppm.load(std::memory_order_relaxed)
     << "},\"histograms\":{"
     << "\"negotiation_wait_us\":" << negotiation_wait_us.Json()
     << ",\"ring_hop_us\":" << ring_hop_us.Json()
     << ",\"shm_fence_us\":" << shm_fence_us.Json()
     << ",\"abort_propagation_us\":" << abort_propagation_us.Json()
     << ",\"step_time_us\":" << step_time_us.Json() << "}";
  {
    // Per-tenant (process-set) accounting, keyed by psid.  Rendered even
    // when empty so consumers need no presence check.
    std::lock_guard<std::mutex> l(tenants_mu_);
    os << ",\"tenants\":{";
    bool first = true;
    for (const auto& kv : tenants_) {
      if (!first) os << ',';
      first = false;
      os << "\"" << kv.first << "\":{\"responses\":" << kv.second.responses
         << ",\"tensors\":" << kv.second.tensors
         << ",\"bytes\":" << kv.second.bytes
         << ",\"negotiation_wait_us\":" << kv.second.negotiation_wait_us.Json()
         << "}";
    }
    os << "}";
  }
  if (!extra_json.empty()) os << ',' << extra_json;
  os << "}";
  return os.str();
}

MetricsRegistry& GlobalMetrics() {
  static MetricsRegistry registry;
  return registry;
}

void NoteMigration(int phase, int64_t bytes, int source_rank) {
  if (MetricsOn()) {
    MetricsRegistry& m = GlobalMetrics();
    m.migrate_events_total.fetch_add(1, std::memory_order_relaxed);
    if (bytes > 0)
      m.migrate_bytes_total.fetch_add(bytes, std::memory_order_relaxed);
    if (phase == kMigrateFallback)
      m.migrate_fallbacks_total.fetch_add(1, std::memory_order_relaxed);
  }
  if (FlightOn()) {
    // a = phase << 8 | (source_rank + 1); 0 in the low byte means "no
    // specific peer".  Ranks past 254 saturate rather than bleed into
    // the phase bits.
    int src = source_rank < 0 ? 0 : (source_rank >= 254 ? 255
                                                        : source_rank + 1);
    FlightRecord(kFlightMigrate, (phase << 8) | src, bytes);
  }
}

void NoteHloInspect(int64_t ops, int64_t raw_bytes, int64_t wire_bytes) {
  MetricsRegistry& m = GlobalMetrics();
  m.gspmd_traces_total.fetch_add(1, std::memory_order_relaxed);
  if (ops > 0)
    m.gspmd_collectives_total.fetch_add(ops, std::memory_order_relaxed);
  if (raw_bytes > 0)
    m.gspmd_raw_bytes.fetch_add(raw_bytes, std::memory_order_relaxed);
  if (wire_bytes > 0)
    m.gspmd_wire_bytes.fetch_add(wire_bytes, std::memory_order_relaxed);
  if (FlightOn()) {
    // a = op count (an inspected trace holds a handful of collectives,
    // far under 2^31), b = the trace's analytic wire bytes.
    int32_t a = ops > INT32_MAX ? INT32_MAX : static_cast<int32_t>(ops);
    FlightRecord(kFlightHloInspect, a, wire_bytes);
  }
}

std::string JsonEscape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (char c : s) {
    unsigned char u = static_cast<unsigned char>(c);
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\b': out += "\\b"; break;
      case '\f': out += "\\f"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (u < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", u);
          out += buf;
        } else {
          out.push_back(c);
        }
    }
  }
  return out;
}

}  // namespace hvdtpu
