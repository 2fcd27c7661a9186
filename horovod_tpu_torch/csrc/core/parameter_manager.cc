#include "parameter_manager.h"

#include <algorithm>
#include <cmath>

#include "common.h"
#include "logging.h"

namespace hvdtpu {

namespace {
constexpr int64_t kMinFusion = 1 << 20;      // 1 MiB
constexpr int64_t kMaxFusion = 512LL << 20;  // 512 MiB
constexpr double kMinCycleMs = 0.2;
constexpr double kMaxCycleMs = 100.0;
// log2 spans of the two knobs (normalize to the unit square).
const double kFusionSpan = std::log2(static_cast<double>(kMaxFusion) /
                                     static_cast<double>(kMinFusion));
const double kCycleSpan = std::log2(kMaxCycleMs / kMinCycleMs);

constexpr double kLengthscale = 0.3;  // RBF, unit-square coordinates
constexpr double kNoise = 1e-2;      // observation noise (normalized scores)
constexpr int kGrid = 24;            // EI candidate grid per axis
constexpr int kMaxTuneSamples = 40;  // GP sample cap (bounds O(n^3) refit)
constexpr int kMaxWindowsSinceBest = 12;  // plateau -> converge

double FusionToX(int64_t fusion) {
  double f = std::min<double>(std::max<double>(fusion, kMinFusion),
                              static_cast<double>(kMaxFusion));
  return std::log2(f / kMinFusion) / kFusionSpan;
}
int64_t XToFusion(double x) {
  double f = std::exp2(x * kFusionSpan) * kMinFusion;
  return std::min(kMaxFusion, std::max<int64_t>(
      kMinFusion, static_cast<int64_t>(f)));
}
double CycleToX(double ms) {
  double c = std::min(std::max(ms, kMinCycleMs), kMaxCycleMs);
  return std::log2(c / kMinCycleMs) / kCycleSpan;
}
double XToCycle(double x) {
  return std::min(kMaxCycleMs,
                  std::max(kMinCycleMs, std::exp2(x * kCycleSpan) *
                                            kMinCycleMs));
}

// Categorical coordinates enter the RBF at half scale: distance 0.5
// between adjacent categories keeps moderate correlation, so each arm
// borrows shape information from the others instead of starting cold.
// The 3-level wire-compression knob maps {none, bf16, int8} to
// {0, 0.5, 1}, so codec aggressiveness is ordinal in the kernel.
constexpr double kCatScale = 0.5;

// x4 <-> WireCodec: the GP works on {0, 0.5, 1}; the data plane wants
// {0, 1, 2}.
constexpr double kWireLevels[3] = {0.0, 0.5, 1.0};
int X4ToWire(double x4) { return x4 < 0.25 ? 0 : (x4 < 0.75 ? 1 : 2); }
double WireToX4(int wire) {
  return kWireLevels[std::min(2, std::max(0, wire))];
}

// x5 <-> device codec: {0, 1/3, 2/3, 1} for {none, int8, int4, int8g} —
// ordinal in codec aggressiveness so adjacent codecs share GP shape.
constexpr double kQdevLevels[4] = {0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0};
int X5ToQdev(double x5) {
  return x5 < 1.0 / 6.0 ? 0 : (x5 < 0.5 ? 1 : (x5 < 5.0 / 6.0 ? 2 : 3));
}
double QdevToX5(int qdev) {
  return kQdevLevels[std::min(3, std::max(0, qdev))];
}

// x6 <-> device-ring schedule: {0, 0.5, 1} for {ring, bidi, torus} —
// ordinal in parallelism (one ICI direction, both, both axes of a torus).
constexpr double kSchedLevels[3] = {0.0, 0.5, 1.0};
int X6ToSched(double x6) { return x6 < 0.25 ? 0 : (x6 < 0.75 ? 1 : 2); }
double SchedToX6(int sched) {
  return kSchedLevels[std::min(2, std::max(0, sched))];
}

// x7 <-> data plane: {0, 1} for {eager explicit, gspmd compiler-inserted}
// — binary like the cache and hierarchical knobs.
constexpr double kPlaneLevels[2] = {0.0, 1.0};
int X7ToPlane(double x7) { return x7 < 0.5 ? 0 : 1; }
double PlaneToX7(int plane) {
  return kPlaneLevels[std::min(1, std::max(0, plane))];
}

double Rbf(double ax, double ay, double az, double aw, double av, double au,
           double at, double as, double bx, double by, double bz, double bw,
           double bv, double bu, double bt, double bs) {
  double dx = ax - bx, dy = ay - by, dz = kCatScale * (az - bz),
         dw = kCatScale * (aw - bw), dv = kCatScale * (av - bv),
         du = kCatScale * (au - bu), dt = kCatScale * (at - bt),
         ds = kCatScale * (as - bs);
  return std::exp(-(dx * dx + dy * dy + dz * dz + dw * dw + dv * dv +
                    du * du + dt * dt + ds * ds) /
                  (2 * kLengthscale * kLengthscale));
}

// Standard normal pdf/cdf for Expected Improvement.
double Phi(double z) { return 0.5 * std::erfc(-z / std::sqrt(2.0)); }
double phi(double z) {
  return std::exp(-0.5 * z * z) / std::sqrt(2.0 * M_PI);
}

}  // namespace

// ---- BayesianOptimizer -----------------------------------------------------

void BayesianOptimizer::AddSample(double x0, double x1, double x2, double x3,
                                  double x4, double x5, double x6, double x7,
                                  double score) {
  xs_.push_back({x0, x1, x2, x3, x4, x5, x6, x7});
  ys_.push_back(score);
  y_max_ = std::max(y_max_, std::abs(score));
  FitGP();
}

void BayesianOptimizer::FitGP() {
  const int n = static_cast<int>(xs_.size());
  if (n == 0) return;
  const double denom = y_max_ > 0 ? y_max_ : 1.0;
  // K = k(X, X) + noise * I  (row-major), then lower Cholesky in place.
  chol_.assign(static_cast<size_t>(n) * n, 0.0);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double k = Rbf(xs_[i].x0, xs_[i].x1, xs_[i].x2, xs_[i].x3, xs_[i].x4,
                     xs_[i].x5, xs_[i].x6, xs_[i].x7, xs_[j].x0, xs_[j].x1,
                     xs_[j].x2, xs_[j].x3, xs_[j].x4, xs_[j].x5, xs_[j].x6,
                     xs_[j].x7);
      if (i == j) k += kNoise;
      chol_[i * n + j] = k;
    }
  }
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double sum = chol_[i * n + j];
      for (int k = 0; k < j; ++k) sum -= chol_[i * n + k] * chol_[j * n + k];
      if (i == j) {
        chol_[i * n + i] = std::sqrt(std::max(sum, 1e-12));
      } else {
        chol_[i * n + j] = sum / chol_[j * n + j];
      }
    }
  }
  // alpha = K^-1 y via two triangular solves.
  alpha_.assign(n, 0.0);
  for (int i = 0; i < n; ++i) {
    double sum = ys_[i] / denom;
    for (int k = 0; k < i; ++k) sum -= chol_[i * n + k] * alpha_[k];
    alpha_[i] = sum / chol_[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double sum = alpha_[i];
    for (int k = i + 1; k < n; ++k) sum -= chol_[k * n + i] * alpha_[k];
    alpha_[i] = sum / chol_[i * n + i];
  }
}

void BayesianOptimizer::Predict(double x0, double x1, double x2, double x3,
                                double x4, double x5, double x6, double x7,
                                double* mean, double* var) const {
  const int n = static_cast<int>(xs_.size());
  if (n == 0) {
    *mean = 0;
    *var = 1;
    return;
  }
  std::vector<double> kstar(n);
  for (int i = 0; i < n; ++i) {
    kstar[i] = Rbf(x0, x1, x2, x3, x4, x5, x6, x7, xs_[i].x0, xs_[i].x1,
                   xs_[i].x2, xs_[i].x3, xs_[i].x4, xs_[i].x5, xs_[i].x6,
                   xs_[i].x7);
  }
  double m = 0;
  for (int i = 0; i < n; ++i) m += kstar[i] * alpha_[i];
  // v = L^-1 k*; var = k(x,x) - v.v
  std::vector<double> v(n);
  for (int i = 0; i < n; ++i) {
    double sum = kstar[i];
    for (int k = 0; k < i; ++k) sum -= chol_[i * n + k] * v[k];
    v[i] = sum / chol_[i * n + i];
  }
  double vv = 0;
  for (int i = 0; i < n; ++i) vv += v[i] * v[i];
  *mean = m;
  *var = std::max(1e-12, 1.0 + kNoise - vv);
}

void BayesianOptimizer::Suggest(double* x0, double* x1, double* x2,
                                double* x3, double* x4, double* x5,
                                double* x6, double* x7) {
  // Seed phase: spread the first probes over the categories before
  // trusting the GP (the reference warms its GP with a fixed design too).
  // When x3/x4/x5/x6/x7 are pinned, their seed columns collapse to 0 so
  // no probe is wasted on a dead arm.  The x5 column walks all four codec
  // levels, the x6 column all three schedules, and the x7 column
  // alternates the two planes.
  static const double kSeeds[][8] = {
      {0.15, 0.15, 0, 0, 0, 0, 0, 0},
      {0.85, 0.15, 1, 1, 1, 1, 1, 1},
      {0.5, 0.5, 0, 1, 0.5, 1.0 / 3.0, 0.5, 1},
      {0.5, 0.5, 1, 0, 1, 2.0 / 3.0, 1, 0},
      {0.15, 0.85, 0, 1, 0.5, 1, 0.5, 1},
      {0.85, 0.85, 1, 0, 0, 2.0 / 3.0, 0, 0}};
  const int n = num_samples();
  if (n < 6) {
    *x0 = kSeeds[n][0];
    *x1 = kSeeds[n][1];
    *x2 = kSeeds[n][2];
    *x3 = tune_x3_ ? kSeeds[n][3] : 0.0;
    *x4 = tune_x4_ ? kSeeds[n][4] : 0.0;
    *x5 = tune_x5_ ? kSeeds[n][5] : 0.0;
    *x6 = tune_x6_ ? kSeeds[n][6] : 0.0;
    *x7 = tune_x7_ ? kSeeds[n][7] : 0.0;
    return;
  }
  const double denom = y_max_ > 0 ? y_max_ : 1.0;
  double best_y = *std::max_element(ys_.begin(), ys_.end()) / denom;
  double best_ei = -1, bx = 0.5, by = 0.5, bz = 1.0, bw = 0.0, bv = 0.0,
         bu = 0.0, bt = 0.0, bs = 0.0;
  const int cat3_max = tune_x3_ ? 1 : 0;
  const int cat4_max = tune_x4_ ? 2 : 0;
  const int cat5_max = tune_x5_ ? 3 : 0;
  const int cat6_max = tune_x6_ ? 2 : 0;
  const int cat7_max = tune_x7_ ? 1 : 0;
  for (int cat7 = 0; cat7 <= cat7_max; ++cat7) {
    for (int cat6 = 0; cat6 <= cat6_max; ++cat6) {
      for (int cat5 = 0; cat5 <= cat5_max; ++cat5) {
        for (int cat4 = 0; cat4 <= cat4_max; ++cat4) {
          for (int cat3 = 0; cat3 <= cat3_max; ++cat3) {
            for (int cat = 0; cat <= 1; ++cat) {
              for (int i = 0; i <= kGrid; ++i) {
                for (int j = 0; j <= kGrid; ++j) {
                  // Deterministic jitter decorrelates the grid across
                  // rounds.
                  rng_ = rng_ * 1664525u + 1013904223u;
                  double jx = ((rng_ >> 16) & 0xFF) / 255.0 - 0.5;
                  rng_ = rng_ * 1664525u + 1013904223u;
                  double jy = ((rng_ >> 16) & 0xFF) / 255.0 - 0.5;
                  double cx =
                      std::min(1.0, std::max(0.0, (i + 0.5 * jx) / kGrid));
                  double cy =
                      std::min(1.0, std::max(0.0, (j + 0.5 * jy) / kGrid));
                  double mean, var;
                  Predict(cx, cy, cat, cat3, kWireLevels[cat4],
                          kQdevLevels[cat5], kSchedLevels[cat6],
                          kPlaneLevels[cat7], &mean, &var);
                  double sd = std::sqrt(var);
                  double z = (mean - best_y - 0.01) / sd;
                  double ei = (mean - best_y - 0.01) * Phi(z) + sd * phi(z);
                  if (ei > best_ei) {
                    best_ei = ei;
                    bx = cx;
                    by = cy;
                    bz = cat;
                    bw = cat3;
                    bv = kWireLevels[cat4];
                    bu = kQdevLevels[cat5];
                    bt = kSchedLevels[cat6];
                    bs = kPlaneLevels[cat7];
                  }
                }
              }
            }
          }
        }
      }
    }
  }
  *x0 = bx;
  *x1 = by;
  *x2 = bz;
  *x3 = bw;
  *x4 = bv;
  *x5 = bu;
  *x6 = bt;
  *x7 = bs;
}

void BayesianOptimizer::Best(double* x0, double* x1, double* x2, double* x3,
                             double* x4, double* x5, double* x6, double* x7,
                             double* score) const {
  if (ys_.empty()) {
    *x0 = *x1 = 0.5;
    *x2 = 1.0;
    *x3 = 0.0;
    *x4 = 0.0;
    *x5 = 0.0;
    *x6 = 0.0;
    *x7 = 0.0;
    *score = 0;
    return;
  }
  size_t i = std::max_element(ys_.begin(), ys_.end()) - ys_.begin();
  *x0 = xs_[i].x0;
  *x1 = xs_[i].x1;
  *x2 = xs_[i].x2;
  *x3 = xs_[i].x3;
  *x4 = xs_[i].x4;
  *x5 = xs_[i].x5;
  *x6 = xs_[i].x6;
  *x7 = xs_[i].x7;
  *score = ys_[i];
}

// ---- ParameterManager ------------------------------------------------------

void ParameterManager::Initialize(int64_t fusion_threshold,
                                  double cycle_time_ms,
                                  const std::string& log_path,
                                  bool hierarchical, bool hier_tunable,
                                  int wire_comp, bool wire_tunable,
                                  int qdev_comp, bool qdev_tunable,
                                  int qdev_sched, bool sched_tunable,
                                  int data_plane, bool plane_tunable) {
  fusion_ = best_fusion_ = fusion_threshold;
  cycle_ms_ = best_cycle_ = cycle_time_ms;
  hier_tunable_ = hier_tunable;
  hier_use_ = best_hier_ = hier_tunable ? hierarchical : false;
  bo_.set_tune_x3(hier_tunable);
  wire_tunable_ = wire_tunable;
  wire_use_ = best_wire_ = wire_tunable ? wire_comp : 0;
  bo_.set_tune_x4(wire_tunable);
  qdev_tunable_ = qdev_tunable;
  qdev_use_ = best_qdev_ =
      qdev_tunable ? std::min(3, std::max(0, qdev_comp)) : 0;
  bo_.set_tune_x5(qdev_tunable);
  sched_tunable_ = sched_tunable;
  qdev_sched_use_ = best_qdev_sched_ =
      sched_tunable ? std::min(2, std::max(0, qdev_sched)) : 0;
  bo_.set_tune_x6(sched_tunable);
  plane_tunable_ = plane_tunable;
  plane_use_ = best_plane_ =
      plane_tunable ? std::min(1, std::max(0, data_plane)) : 0;
  bo_.set_tune_x7(plane_tunable);
  window_start_ = MonotonicSeconds();
  active_ = true;
  if (!log_path.empty()) {
    log_ = std::fopen(log_path.c_str(), "w");
    if (log_) {
      std::fputs(
          "time_s,fusion_bytes,cycle_ms,cache_use,hier,wire_comp,qdev,"
          "sched,plane,score_bytes_per_s\n",
          log_);
    }
  }
}

ParameterManager::~ParameterManager() {
  if (log_) std::fclose(log_);
}

void ParameterManager::RecordBytes(int64_t bytes) { bytes_ += bytes; }

void ParameterManager::Log(double score) {
  if (!log_) return;
  std::fprintf(log_, "%.3f,%lld,%.3f,%d,%d,%d,%d,%d,%d,%.1f\n",
               MonotonicSeconds(), static_cast<long long>(fusion_), cycle_ms_,
               cache_use_ ? 1 : 0, hier_use_ ? 1 : 0, wire_use_, qdev_use_,
               qdev_sched_use_, plane_use_, score);
  std::fflush(log_);
}

void ParameterManager::Score(double score) {
  Log(score);
  if (converged_) return;
  if (warmup_windows_ > 0) {
    // The first window mixes pre-traffic noise; don't teach the GP with it.
    --warmup_windows_;
    return;
  }
  bo_.AddSample(FusionToX(fusion_), CycleToX(cycle_ms_),
                cache_use_ ? 1.0 : 0.0, hier_use_ ? 1.0 : 0.0,
                WireToX4(wire_use_), QdevToX5(qdev_use_),
                SchedToX6(qdev_sched_use_), PlaneToX7(plane_use_), score);
  if (score > best_score_ * 1.02) {
    windows_since_best_ = 0;
  } else {
    ++windows_since_best_;
  }
  if (score > best_score_) {
    best_score_ = score;
    best_fusion_ = fusion_;
    best_cycle_ = cycle_ms_;
    best_cache_ = cache_use_;
    best_hier_ = hier_use_;
    best_wire_ = wire_use_;
    best_qdev_ = qdev_use_;
    best_qdev_sched_ = qdev_sched_use_;
    best_plane_ = plane_use_;
  }
  // Converge (reference: ParameterManager stops tuning once samples stop
  // improving): lock in the best configuration instead of exploring
  // forever — steady-state jobs must not pay EI-exploration throughput,
  // and the GP refit is O(n^3) in the sample count.
  if (bo_.num_samples() >= kMaxTuneSamples ||
      windows_since_best_ >= kMaxWindowsSinceBest) {
    converged_ = true;
    fusion_ = best_fusion_;
    cycle_ms_ = best_cycle_;
    cache_use_ = best_cache_;
    hier_use_ = best_hier_;
    wire_use_ = best_wire_;
    qdev_use_ = best_qdev_;
    qdev_sched_use_ = best_qdev_sched_;
    plane_use_ = best_plane_;
    HVD_LOG(INFO) << "autotune converged: fusion=" << fusion_
                  << " cycle_ms=" << cycle_ms_
                  << " announce_cache=" << (cache_use_ ? 1 : 0)
                  << " hierarchical=" << (hier_use_ ? 1 : 0)
                  << " wire_compression=" << wire_use_
                  << " qdev=" << qdev_use_
                  << " qdev_sched=" << qdev_sched_use_
                  << " plane=" << plane_use_;
    return;
  }
  double x0, x1, x2, x3, x4, x5, x6, x7;
  bo_.Suggest(&x0, &x1, &x2, &x3, &x4, &x5, &x6, &x7);
  fusion_ = XToFusion(x0);
  cycle_ms_ = XToCycle(x1);
  cache_use_ = x2 >= 0.5;
  hier_use_ = hier_tunable_ && x3 >= 0.5;
  wire_use_ = wire_tunable_ ? X4ToWire(x4) : 0;
  qdev_use_ = qdev_tunable_ ? X5ToQdev(x5) : 0;
  qdev_sched_use_ = sched_tunable_ ? X6ToSched(x6) : 0;
  plane_use_ = plane_tunable_ ? X7ToPlane(x7) : 0;
}

bool ParameterManager::Tick(int64_t* fusion_threshold, double* cycle_time_ms) {
  if (!active_) return false;
  double now = MonotonicSeconds();
  if (now - window_start_ < window_s_) return false;
  double score = static_cast<double>(bytes_) / (now - window_start_);
  bytes_ = 0;
  window_start_ = now;
  int64_t old_fusion = fusion_;
  double old_cycle = cycle_ms_;
  bool old_cache = cache_use_;
  bool old_hier = hier_use_;
  int old_wire = wire_use_;
  int old_qdev = qdev_use_;
  int old_sched = qdev_sched_use_;
  int old_plane = plane_use_;
  Score(score);
  *fusion_threshold = fusion_;
  *cycle_time_ms = cycle_ms_;
  // cache_use_/hier_use_/wire_use_/qdev_use_/qdev_sched_use_/plane_use_
  // participate: a categorical-only proposal must still be applied by the
  // caller, or the next window's GP sample would be labeled with a
  // setting that was never in effect.
  return fusion_ != old_fusion || cycle_ms_ != old_cycle ||
         cache_use_ != old_cache || hier_use_ != old_hier ||
         wire_use_ != old_wire || qdev_use_ != old_qdev ||
         qdev_sched_use_ != old_sched || plane_use_ != old_plane;
}

}  // namespace hvdtpu
