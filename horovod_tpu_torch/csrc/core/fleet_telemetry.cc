#include "fleet_telemetry.h"

#include <time.h>

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <sstream>

#include "flight_recorder.h"
#include "step_trace.h"

namespace hvdtpu {

namespace {

constexpr uint8_t kSketchVersion = 1;
// Bound a decoded tenant map: a malformed frame must not allocate
// unboundedly.  Real jobs hold a handful of process sets.
constexpr uint64_t kMaxTenants = 4096;

// History tiers: 1 s x 120 (2 min live), 10 s x 120 (20 min), 60 s x 240
// (4 h) — enough span for the sentinel's "when did it start drifting"
// question without unbounded growth.
constexpr int kTierCount = 3;
constexpr int kTierPeriodS[kTierCount] = {1, 10, 60};
constexpr int kTierCap[kTierCount] = {120, 120, 240};

// Sentinel defaults: robust-ish EWMA z-score with a warmup so the first
// noisy samples never fire, and a per-kind cooldown so one sustained
// regression reads as one anomaly, not a sample-rate alarm storm.
constexpr int kSentinelWarmup = 10;
constexpr int kSentinelCooldownTicks = 10;
constexpr double kDefaultZScore = 4.0;
constexpr double kEwmaAlpha = 0.1;
constexpr int kMaxAnomalies = 64;
constexpr int kSentinelDominantWindow = 8;

// Sentinel series kinds (flight type-15 `a` upper byte; mirror in
// tools/postmortem.py _SENTINEL_KINDS).
enum SentinelKind : int {
  kSentinelStepP99 = 1,
  kSentinelGoodput = 2,
  kSentinelWireRatio = 3,
};

const char* SentinelKindName(int kind) {
  switch (kind) {
    case kSentinelStepP99: return "step_p99";
    case kSentinelGoodput: return "goodput";
    case kSentinelWireRatio: return "wire_ratio";
    default: return "?";
  }
}

struct Sample {
  int64_t ts_us = 0;
  int64_t step_p99_us = 0;
  int64_t neg_p99_us = 0;
  int64_t goodput_ppm = 0;
  int64_t wire_ratio_ppm = 0;
  int64_t steps = 0;  // cumulative fleet step_time count
};

struct Anomaly {
  int64_t seq = 0;
  int64_t ts_us = 0;
  int kind = 0;
  int rank = -1;
  int64_t value = 0;
  int64_t baseline = 0;
  double score = 0;
};

// One EWMA mean/variance tracker per watched series.  Warmup samples are
// buffered and the baseline is seeded from their median/MAD, not their
// mean/variance: the first ticks of a job carry cold-start transients
// (first negotiation, compile) orders of magnitude above steady state,
// and folding even two of them into an EWMA variance inflates the
// standard deviation for minutes — long enough to mask a real anomaly
// from a z-score that should read >10 sigma.
struct Ewma {
  double mean = 0;
  double var = 0;
  int n = 0;
  int cooldown = 0;
  double warm_buf[kSentinelWarmup] = {0};

  // Returns the z-score of `x` against the pre-update baseline, then
  // folds `x` in.  0 while warming up.
  double Push(double x) {
    if (n < kSentinelWarmup) {
      warm_buf[n] = x;
      ++n;
      if (n == kSentinelWarmup) SeedFromWarmup();
      if (cooldown > 0) --cooldown;
      return 0;
    }
    double z = 0;
    double sd = std::sqrt(var);
    if (sd > 1e-9) z = (x - mean) / sd;
    double d = x - mean;
    mean += kEwmaAlpha * d;
    var = (1 - kEwmaAlpha) * (var + kEwmaAlpha * d * d);
    ++n;
    if (cooldown > 0) --cooldown;
    return z;
  }

  void SeedFromWarmup() {
    double v[kSentinelWarmup];
    std::copy(warm_buf, warm_buf + kSentinelWarmup, v);
    std::sort(v, v + kSentinelWarmup);
    const double med = (v[kSentinelWarmup / 2] +
                        v[(kSentinelWarmup - 1) / 2]) / 2.0;
    double dev[kSentinelWarmup];
    for (int i = 0; i < kSentinelWarmup; ++i) dev[i] = std::fabs(v[i] - med);
    std::sort(dev, dev + kSentinelWarmup);
    const double mad = (dev[kSentinelWarmup / 2] +
                        dev[(kSentinelWarmup - 1) / 2]) / 2.0;
    mean = med;
    // 1.4826*MAD estimates sigma for a normal core; the relative floor
    // keeps z finite when every warmup sample hashed to one histogram
    // bucket (MAD = 0 exactly), which is the common case for a stable
    // power-of-two p99.
    const double sd = std::max(1.4826 * mad, 0.05 * std::fabs(med) + 1.0);
    var = sd * sd;
  }
};

struct Tier {
  std::vector<Sample> ring;
  int64_t pushed = 0;  // samples ever pushed (ring index = pushed % cap)
};

struct State {
  std::mutex mu;
  Tier tiers[kTierCount];
  int64_t last_tick_us = 0;
  double zscore_threshold = kDefaultZScore;
  Ewma ewma_step_p99;
  Ewma ewma_goodput;
  Ewma ewma_wire_ratio;
  std::vector<Anomaly> anomalies;  // bounded log, newest last
  std::atomic<int64_t> anomaly_seq{0};
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

// -- varint codec ------------------------------------------------------------
// LEB128 unsigned varint + zigzag for the (possibly negative) bucket
// deltas.  socketio.h's Writer/Reader speak fixed-width ints only; the
// sketch section is the one place compactness matters, so the codec lives
// here with the sketch.

void PutVarint(std::string* out, uint64_t v) {
  while (v >= 0x80) {
    out->push_back(static_cast<char>((v & 0x7f) | 0x80));
    v >>= 7;
  }
  out->push_back(static_cast<char>(v));
}

bool GetVarint(const char** p, const char* end, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (*p < end && shift < 64) {
    uint8_t byte = static_cast<uint8_t>(**p);
    ++*p;
    v |= static_cast<uint64_t>(byte & 0x7f) << shift;
    if ((byte & 0x80) == 0) {
      *out = v;
      return true;
    }
    shift += 7;
  }
  return false;
}

uint64_t ZigZag(int64_t v) {
  return (static_cast<uint64_t>(v) << 1) ^ static_cast<uint64_t>(v >> 63);
}

int64_t UnZigZag(uint64_t v) {
  return static_cast<int64_t>(v >> 1) ^ -static_cast<int64_t>(v & 1);
}

void EncodeHist(std::string* out, const HistogramSketch& h) {
  PutVarint(out, static_cast<uint64_t>(h.count));
  PutVarint(out, static_cast<uint64_t>(h.sum_us));
  int64_t prev = 0;
  for (int b = 0; b < Histogram::kNumBuckets; ++b) {
    PutVarint(out, ZigZag(h.buckets[b] - prev));
    prev = h.buckets[b];
  }
}

bool DecodeHist(const char** p, const char* end, HistogramSketch* h) {
  uint64_t v = 0;
  if (!GetVarint(p, end, &v)) return false;
  h->count = static_cast<int64_t>(v);
  if (!GetVarint(p, end, &v)) return false;
  h->sum_us = static_cast<int64_t>(v);
  int64_t prev = 0;
  for (int b = 0; b < Histogram::kNumBuckets; ++b) {
    if (!GetVarint(p, end, &v)) return false;
    prev += UnZigZag(v);
    if (prev < 0) return false;  // bucket counts are nonnegative
    h->buckets[b] = prev;
  }
  return true;
}

void AppendSample(std::ostringstream& os, const Sample& smp) {
  os << '[' << smp.ts_us << ',' << smp.step_p99_us << ',' << smp.neg_p99_us
     << ',' << smp.goodput_ppm << ',' << smp.wire_ratio_ppm << ','
     << smp.steps << ']';
}

void AppendAnomaly(std::ostringstream& os, const Anomaly& a) {
  os << "{\"seq\":" << a.seq << ",\"ts_us\":" << a.ts_us << ",\"kind\":\""
     << SentinelKindName(a.kind) << "\",\"rank\":" << a.rank
     << ",\"value\":" << a.value << ",\"baseline\":" << a.baseline
     << ",\"score\":" << a.score << "}";
}

// Fold tier `t`'s most recent `n` samples into one downsampled sample:
// max for the latency p99s (a spike must survive downsampling), min for
// goodput (the worst window is the interesting one), last for the
// cumulative columns.  Caller holds s.mu.
Sample Downsample(const Tier& tier, int cap, int n) {
  Sample out;
  for (int64_t k = tier.pushed - n; k < tier.pushed; ++k) {
    const Sample& smp = tier.ring[static_cast<size_t>(k % cap)];
    if (out.ts_us == 0) {
      out = smp;
      continue;
    }
    out.ts_us = smp.ts_us;
    out.step_p99_us = std::max(out.step_p99_us, smp.step_p99_us);
    out.neg_p99_us = std::max(out.neg_p99_us, smp.neg_p99_us);
    out.goodput_ppm = std::min(out.goodput_ppm, smp.goodput_ppm);
    out.wire_ratio_ppm = smp.wire_ratio_ppm;
    out.steps = smp.steps;
  }
  return out;
}

void PushTier(State& s, int t, const Sample& smp) {
  Tier& tier = s.tiers[t];
  if (tier.ring.empty()) tier.ring.assign(kTierCap[t], Sample());
  tier.ring[static_cast<size_t>(tier.pushed % kTierCap[t])] = smp;
  ++tier.pushed;
  // Cascade: every period ratio's worth of pushes folds one sample into
  // the next tier (10 x 1 s -> 10 s, 6 x 10 s -> 60 s).
  if (t + 1 < kTierCount) {
    int ratio = kTierPeriodS[t + 1] / kTierPeriodS[t];
    if (tier.pushed % ratio == 0) {
      PushTier(s, t + 1,
               Downsample(tier, kTierCap[t],
                          std::min<int64_t>(ratio, tier.pushed)));
    }
  }
}

// One sentinel check: push `x` into the tracker, emit an anomaly when the
// z-score clears the threshold in the regression direction.  `direction`
// +1 flags increases (latency), -1 decreases (goodput); 0 either way.
// Caller holds s.mu.
void SentinelCheck(State& s, Ewma& ew, int kind, int direction, double x,
                   int rank, int64_t ts_us) {
  int64_t baseline = static_cast<int64_t>(ew.mean);
  bool warm = ew.n >= kSentinelWarmup && ew.cooldown == 0;
  double z = ew.Push(x);
  if (!warm) return;
  bool fired = direction > 0 ? z > s.zscore_threshold
               : direction < 0
                   ? z < -s.zscore_threshold
                   : std::fabs(z) > s.zscore_threshold;
  if (!fired) return;
  ew.cooldown = kSentinelCooldownTicks;
  Anomaly a;
  a.seq = s.anomaly_seq.fetch_add(1, std::memory_order_relaxed) + 1;
  a.ts_us = ts_us;
  a.kind = kind;
  a.rank = rank;
  a.value = static_cast<int64_t>(x);
  a.baseline = baseline;
  a.score = z;
  s.anomalies.push_back(a);
  if (s.anomalies.size() > kMaxAnomalies) {
    s.anomalies.erase(s.anomalies.begin());
  }
  if (MetricsOn()) {
    GlobalMetrics().sentinel_anomalies_total.fetch_add(
        1, std::memory_order_relaxed);
  }
  if (FlightOn()) {
    // a = kind << 8 | (rank + 1); 0 in the low byte means "no rank
    // attribution" (fleet-wide series like goodput).
    int r = rank < 0 ? 0 : (rank >= 254 ? 255 : rank + 1);
    FlightRecord(kFlightSentinel, (kind << 8) | r, a.value);
  }
}

}  // namespace

// -- HistogramSketch ---------------------------------------------------------

void HistogramSketch::Clear() {
  count = 0;
  sum_us = 0;
  std::memset(buckets, 0, sizeof(buckets));
}

void HistogramSketch::AddFrom(const Histogram& h) {
  count += h.count.load(std::memory_order_relaxed);
  sum_us += h.sum_us.load(std::memory_order_relaxed);
  for (int b = 0; b < Histogram::kNumBuckets; ++b) {
    buckets[b] += h.buckets[b].load(std::memory_order_relaxed);
  }
}

void HistogramSketch::Merge(const HistogramSketch& o) {
  count += o.count;
  sum_us += o.sum_us;
  for (int b = 0; b < Histogram::kNumBuckets; ++b) buckets[b] += o.buckets[b];
}

int64_t HistogramSketch::QuantileUs(double q) const {
  if (count <= 0) return 0;
  int64_t target = static_cast<int64_t>(q * count);
  if (target < 1) target = 1;
  if (target > count) target = count;
  int64_t cum = 0;
  for (int b = 0; b < Histogram::kNumBuckets; ++b) {
    cum += buckets[b];
    if (cum >= target) return int64_t{1} << b;
  }
  return int64_t{1} << (Histogram::kNumBuckets - 1);
}

std::string HistogramSketch::Json() const {
  std::ostringstream os;
  os << "{\"count\":" << count << ",\"sum_us\":" << sum_us
     << ",\"p50_us\":" << QuantileUs(0.5) << ",\"p99_us\":" << QuantileUs(0.99)
     << ",\"buckets\":[";
  for (int b = 0; b < Histogram::kNumBuckets; ++b) {
    if (b) os << ',';
    os << buckets[b];
  }
  os << "]}";
  return os.str();
}

// -- FleetSketch -------------------------------------------------------------

void FleetSketch::Clear() {
  negotiation_wait.Clear();
  ring_hop.Clear();
  step_time.Clear();
  shm_fence.Clear();
  tenants.clear();
}

void FleetSketch::Merge(const FleetSketch& o) {
  negotiation_wait.Merge(o.negotiation_wait);
  ring_hop.Merge(o.ring_hop);
  step_time.Merge(o.step_time);
  shm_fence.Merge(o.shm_fence);
  for (const auto& kv : o.tenants) tenants[kv.first].Merge(kv.second);
}

void FleetSketch::CaptureLocal() {
  Clear();
  MetricsRegistry& m = GlobalMetrics();
  negotiation_wait.AddFrom(m.negotiation_wait_us);
  ring_hop.AddFrom(m.ring_hop_us);
  step_time.AddFrom(m.step_time_us);
  shm_fence.AddFrom(m.shm_fence_us);
  m.ForEachTenantWait([this](int psid, const Histogram& h) {
    tenants[psid].AddFrom(h);
  });
}

std::string FleetSketch::Encode() const {
  std::string out;
  out.reserve(64);
  out.push_back(static_cast<char>(kSketchVersion));
  EncodeHist(&out, negotiation_wait);
  EncodeHist(&out, ring_hop);
  EncodeHist(&out, step_time);
  EncodeHist(&out, shm_fence);
  PutVarint(&out, tenants.size());
  for (const auto& kv : tenants) {
    PutVarint(&out, static_cast<uint64_t>(kv.first));
    EncodeHist(&out, kv.second);
  }
  return out;
}

bool FleetSketch::Decode(const char* data, size_t len) {
  Clear();
  if (len < 1 || static_cast<uint8_t>(data[0]) != kSketchVersion) return false;
  const char* p = data + 1;
  const char* end = data + len;
  if (!DecodeHist(&p, end, &negotiation_wait)) return false;
  if (!DecodeHist(&p, end, &ring_hop)) return false;
  if (!DecodeHist(&p, end, &step_time)) return false;
  if (!DecodeHist(&p, end, &shm_fence)) return false;
  uint64_t n = 0;
  if (!GetVarint(&p, end, &n) || n > kMaxTenants) return false;
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t psid = 0;
    if (!GetVarint(&p, end, &psid)) return false;
    if (!DecodeHist(&p, end, &tenants[static_cast<int>(psid)])) return false;
  }
  return p == end;
}

std::string FleetSketch::Json() const {
  std::ostringstream os;
  os << "{\"negotiation_wait_us\":" << negotiation_wait.Json()
     << ",\"ring_hop_us\":" << ring_hop.Json()
     << ",\"step_time_us\":" << step_time.Json()
     << ",\"shm_fence_us\":" << shm_fence.Json() << ",\"tenants\":{";
  bool first = true;
  for (const auto& kv : tenants) {
    if (!first) os << ',';
    first = false;
    os << '"' << kv.first << "\":{\"negotiation_wait_us\":" << kv.second.Json()
       << '}';
  }
  os << "}}";
  return os.str();
}

// -- plane lifecycle / tick --------------------------------------------------

FleetTelemetryGate& GlobalFleetTelemetry() {
  static FleetTelemetryGate* g = new FleetTelemetryGate();
  return *g;
}

void InitFleetTelemetry() {
  State& s = S();
  bool on = true;
  const char* env = std::getenv("HOROVOD_FLEET_TELEMETRY");
  if (env != nullptr) {
    std::string v(env);
    on = !(v == "0" || v == "off" || v == "false");
  }
  {
    std::lock_guard<std::mutex> l(s.mu);
    for (auto& tier : s.tiers) {
      tier.ring.clear();
      tier.pushed = 0;
    }
    s.last_tick_us = 0;
    s.ewma_step_p99 = Ewma();
    s.ewma_goodput = Ewma();
    s.ewma_wire_ratio = Ewma();
    s.anomalies.clear();
    s.zscore_threshold = kDefaultZScore;
    const char* z = std::getenv("HOROVOD_SENTINEL_ZSCORE");
    if (z != nullptr) {
      char* endp = nullptr;
      double parsed = std::strtod(z, &endp);
      if (endp != z && parsed > 0) s.zscore_threshold = parsed;
    }
  }
  GlobalFleetTelemetry().enabled.store(on, std::memory_order_relaxed);
}

void FleetTelemetryTick(const FleetSketch& fleet, int64_t wire_bytes,
                        int64_t raw_bytes) {
  if (!FleetTelemetryOn()) return;
  State& s = S();
  const int64_t now = NowUs();
  std::lock_guard<std::mutex> l(s.mu);
  if (now - s.last_tick_us < 1000000) return;  // ~1 Hz
  s.last_tick_us = now;

  Sample smp;
  smp.ts_us = now;
  smp.step_p99_us = fleet.step_time.QuantileUs(0.99);
  smp.neg_p99_us = fleet.negotiation_wait.QuantileUs(0.99);
  smp.steps = fleet.step_time.count;
  smp.wire_ratio_ppm =
      raw_bytes > 0 ? wire_bytes * 1000000 / raw_bytes : 1000000;

  // Goodput: ring (bytes actually moving) over the fleet's total
  // attributed wall time — negotiation, fusion, fence and idle are all
  // overhead against it (docs/observability.md "Goodput").
  int64_t phases[kStepPhases] = {0};
  StepTraceFleetPhaseTotals(phases);
  int64_t total = 0;
  for (int p = 0; p < kStepPhases; ++p) total += phases[p];
  smp.goodput_ppm = total > 0 ? phases[kPhaseRing] * 1000000 / total : 0;
  if (MetricsOn()) {
    GlobalMetrics().goodput_ratio_ppm.store(smp.goodput_ppm,
                                            std::memory_order_relaxed);
  }

  PushTier(s, 0, smp);

  // The sentinel attributes latency anomalies to the rank the step-trace
  // fleet view blames by majority vote over the newest complete steps
  // (single-step attribution is noisy — an announce lag can land on the
  // neighbouring forming step); fleet-wide series (goodput, wire ratio)
  // carry no rank.
  int dom_rank = StepTraceFleetDominantRecentRank(kSentinelDominantWindow);
  if (smp.steps > 0) {
    SentinelCheck(s, s.ewma_step_p99, kSentinelStepP99, +1,
                  static_cast<double>(smp.step_p99_us), dom_rank, now);
  }
  if (total > 0) {
    SentinelCheck(s, s.ewma_goodput, kSentinelGoodput, -1,
                  static_cast<double>(smp.goodput_ppm), -1, now);
  }
  if (raw_bytes > 0) {
    SentinelCheck(s, s.ewma_wire_ratio, kSentinelWireRatio, 0,
                  static_cast<double>(smp.wire_ratio_ppm), -1, now);
  }
}

std::string FleetHistoryJson() {
  State& s = S();
  std::lock_guard<std::mutex> l(s.mu);
  std::ostringstream os;
  os << "{\"schema\":\"fleethistory-v1\",\"now_us\":" << NowUs()
     << ",\"columns\":[\"ts_us\",\"step_p99_us\",\"neg_p99_us\","
        "\"goodput_ppm\",\"wire_ratio_ppm\",\"steps\"],\"tiers\":[";
  for (int t = 0; t < kTierCount; ++t) {
    if (t) os << ',';
    const Tier& tier = s.tiers[t];
    const int64_t n =
        std::min<int64_t>(tier.pushed, static_cast<int64_t>(kTierCap[t]));
    os << "{\"period_s\":" << kTierPeriodS[t] << ",\"samples\":[";
    bool first = true;
    for (int64_t k = tier.pushed - n; k < tier.pushed; ++k) {
      if (!first) os << ',';
      first = false;
      AppendSample(os, tier.ring[static_cast<size_t>(k % kTierCap[t])]);
    }
    os << "]}";
  }
  os << "],\"anomalies\":";
  bool first = true;
  os << '[';
  for (const auto& a : s.anomalies) {
    if (!first) os << ',';
    first = false;
    AppendAnomaly(os, a);
  }
  os << "]}";
  return os.str();
}

std::string FleetAnomaliesJson() {
  State& s = S();
  std::lock_guard<std::mutex> l(s.mu);
  std::ostringstream os;
  os << '[';
  bool first = true;
  for (const auto& a : s.anomalies) {
    if (!first) os << ',';
    first = false;
    AppendAnomaly(os, a);
  }
  os << ']';
  return os.str();
}

int64_t FleetAnomalyCount() {
  return S().anomaly_seq.load(std::memory_order_relaxed);
}

void ResetFleetTelemetryForTest() {
  State& s = S();
  GlobalFleetTelemetry().enabled.store(false, std::memory_order_relaxed);
  std::lock_guard<std::mutex> l(s.mu);
  for (auto& tier : s.tiers) {
    tier.ring.clear();
    tier.pushed = 0;
  }
  s.last_tick_us = 0;
  s.ewma_step_p99 = Ewma();
  s.ewma_goodput = Ewma();
  s.ewma_wire_ratio = Ewma();
  s.anomalies.clear();
  s.anomaly_seq.store(0, std::memory_order_relaxed);
}

}  // namespace hvdtpu
