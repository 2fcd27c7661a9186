// Online autotuning of fusion threshold and cycle time.
//
// Reference: horovod/common/parameter_manager.h (ParameterManager +
// BayesianOptimization over fusion threshold / cycle time with a Gaussian
// process and Expected Improvement; SURVEY.md §2.1).  This build implements
// the same joint optimization natively: the 2-D knob space is normalized to
// the unit square in log2 scale, a GP with RBF kernel is fit to the scored
// windows (small dense Cholesky — the sample count is the number of 2-second
// windows, so the cost is trivial), and the next configuration maximizes EI
// over a candidate grid.  Score = negotiated tensor bytes per second, logged
// to HOROVOD_AUTOTUNE_LOG exactly as the reference does.
#pragma once

#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>

namespace hvdtpu {

// Gaussian-process regression + Expected Improvement over two continuous
// knobs on the unit square plus six CATEGORICAL knobs (reference:
// ParameterManager also tunes categorical flags like cache/hierarchical
// allreduce — categorical coordinates in the same GP are the cheap
// TPU-native form; x2 = announce-cache {0,1}, x3 = hierarchical allreduce
// {0,1}, x4 = wire compression {0, 0.5, 1} for {none, bf16, int8},
// x5 = device-plane codec {0, 1/3, 2/3, 1} for {none, int8, int4, int8g}
// (ordinal in codec aggressiveness like x4), x6 = device-ring schedule
// {0, 0.5, 1} for {ring, bidi, torus}, x7 = data plane {0, 1} for
// {eager explicit collectives, gspmd compiler-inserted}).
// Exposed for the synthetic-surface self-test (autotune_selftest.cc).
class BayesianOptimizer {
 public:
  // Observations are (x in [0,1]^2, x2/x3/x7 in {0,1}, x4/x6 in {0,0.5,1},
  // x5 in {0,1/3,2/3,1}, score); scores are internally max-normalized so
  // the kernel scales stay dimensionless.
  void AddSample(double x0, double x1, double x2, double x3, double x4,
                 double x5, double x6, double x7, double score);
  // Pre-plane-coordinate form (x7 = 0, the eager plane) — keeps the
  // selftest's historical call sites and any 7-coordinate caller exact.
  void AddSample(double x0, double x1, double x2, double x3, double x4,
                 double x5, double x6, double score) {
    AddSample(x0, x1, x2, x3, x4, x5, x6, 0.0, score);
  }
  // Next point to try: argmax EI over a jittered grid x the categorical
  // levels.  Falls back to latin-square-ish seed points for the first few
  // calls.
  void Suggest(double* x0, double* x1, double* x2, double* x3, double* x4,
               double* x5, double* x6, double* x7);
  void Suggest(double* x0, double* x1, double* x2, double* x3, double* x4,
               double* x5, double* x6) {
    double x7;
    Suggest(x0, x1, x2, x3, x4, x5, x6, &x7);
  }
  // Best observed sample.
  void Best(double* x0, double* x1, double* x2, double* x3, double* x4,
            double* x5, double* x6, double* x7, double* score) const;
  void Best(double* x0, double* x1, double* x2, double* x3, double* x4,
            double* x5, double* x6, double* score) const {
    double x7;
    Best(x0, x1, x2, x3, x4, x5, x6, &x7, score);
  }
  int num_samples() const { return static_cast<int>(xs_.size()); }
  // When the x3 knob cannot take effect (topology not hierarchical), pin
  // it to 0 so the EI search does not waste half its grid on a dead arm.
  void set_tune_x3(bool v) { tune_x3_ = v; }
  // Same pinning rule for x4 (wire compression: no all-cross-host ring).
  void set_tune_x4(bool v) { tune_x4_ = v; }
  // Same pinning rule for x5 (device-plane codec: no usable device plane).
  void set_tune_x5(bool v) { tune_x5_ = v; }
  // Same pinning rule for x6 (device-ring schedule: no device plane, or a
  // member count that admits only the unidirectional ring).
  void set_tune_x6(bool v) { tune_x6_ = v; }
  // Same pinning rule for x7 (data plane: no multi-device mesh, or the
  // quantized device codec owns the traced reduction).  Unlike x3..x6 this
  // knob defaults OFF: the 7-coordinate compatibility overloads record
  // every sample at x7 = 0, so exploring x7 without an 8-coordinate caller
  // would chase predictions no sample can ever confirm.
  void set_tune_x7(bool v) { tune_x7_ = v; }

 private:
  void FitGP();
  void Predict(double x0, double x1, double x2, double x3, double x4,
               double x5, double x6, double x7, double* mean,
               double* var) const;

  struct Pt {
    double x0, x1, x2, x3, x4, x5, x6, x7;
  };
  std::vector<Pt> xs_;
  std::vector<double> ys_;      // raw scores
  std::vector<double> alpha_;   // K^-1 y_norm
  std::vector<double> chol_;    // Cholesky factor of K (row-major lower)
  double y_max_ = 0;
  unsigned rng_ = 0x9e3779b9u;
  bool tune_x3_ = true;
  bool tune_x4_ = true;
  bool tune_x5_ = true;
  bool tune_x6_ = true;
  bool tune_x7_ = false;  // opt-in: see set_tune_x7
};

class ParameterManager {
 public:
  // hierarchical: initial value of the hierarchical-allreduce knob.
  // hier_tunable: whether the data plane can act on it at all (a
  // hierarchical topology exists); when false the knob is pinned off and
  // the GP never explores that arm.  wire_comp / wire_tunable: same pair
  // for the wire-compression codec (0=none, 1=bf16, 2=int8), pinned when
  // no all-cross-host ring exists.  qdev_comp / qdev_tunable: same pair
  // for the device-plane codec (0=none, 1=int8, 2=int4, 3=int8g), pinned
  // when the process has no usable jax device plane.  qdev_sched /
  // sched_tunable: same pair for the device-ring schedule (0=ring,
  // 1=bidi, 2=torus), pinned alongside qdev or when the plane's member
  // count admits only the unidirectional ring.  data_plane /
  // plane_tunable: same pair for the in-jit gradient-exchange plane
  // (0=eager, 1=gspmd), pinned when no multi-device mesh exists or the
  // quantized device codec owns the traced reduction.
  void Initialize(int64_t fusion_threshold, double cycle_time_ms,
                  const std::string& log_path, bool hierarchical = false,
                  bool hier_tunable = false, int wire_comp = 0,
                  bool wire_tunable = false, int qdev_comp = 0,
                  bool qdev_tunable = false, int qdev_sched = 0,
                  bool sched_tunable = false, int data_plane = 0,
                  bool plane_tunable = false);
  ~ParameterManager();

  // Record bytes covered by emitted responses.
  void RecordBytes(int64_t bytes);

  // Called every cycle; returns true when parameters changed.
  bool Tick(int64_t* fusion_threshold, double* cycle_time_ms);

  // Test hook: force a window boundary with an externally supplied score.
  void ScoreWindowForTest(double score) { Score(score); }
  int64_t fusion() const { return fusion_; }
  double cycle_ms() const { return cycle_ms_; }
  double best_score() const { return best_score_; }
  // Categorical knob: should workers announce steady-state tensors via
  // response-cache ids?  (Per-rank safe: announcing full requests never
  // desyncs the deterministic cache-insert order.)
  bool announce_cache() const { return cache_use_; }
  // Categorical knob: hierarchical allreduce (shm-local reduce ->
  // leader-only cross-host ring -> shm-local broadcast).  Coordinator-only:
  // the decision rides in each serialized response, so only the
  // coordinator's copy of this knob matters.
  bool hierarchical() const { return hier_use_; }
  // Categorical knob: wire-compression codec for cross-host ring hops
  // (0=none, 1=bf16, 2=int8 — hvdtpu::WireCodec).  Coordinator-only for
  // the same reason as hierarchical().
  int wire_compression() const { return wire_use_; }
  // Categorical knob: device-plane codec (0=none, 1=int8, 2=int4,
  // 3=int8g — ops/quantize.py's DEVICE_WIRE_CODECS order).  The Python
  // side polls it and flips the in-jit/eager quantized ring on the next
  // trace; per-rank consistent because config (and therefore the tunable
  // bit) is rank-uniform.
  int qdev() const { return qdev_use_; }
  // Categorical knob: device-ring schedule (0=ring, 1=bidi, 2=torus —
  // ops/collectives.py's resolve_device_schedule codomain).  Polled by
  // the Python side together with qdev().
  int qdev_sched() const { return qdev_sched_use_; }
  // Categorical knob: in-jit gradient-exchange plane (0=eager, 1=gspmd —
  // ops/gspmd_plane.py's resolve_plane codomain).  Polled like qdev():
  // per-rank consistent because the tunable bit is rank-uniform, and a
  // flip only takes effect at the next optimizer construction/trace.
  int plane() const { return plane_use_; }

 private:
  void Score(double score);
  void Log(double score);

  bool active_ = false;
  int64_t bytes_ = 0;
  double window_start_ = 0;
  double window_s_ = 2.0;

  int64_t fusion_ = 0;
  double cycle_ms_ = 1.0;
  bool cache_use_ = true;
  bool hier_use_ = false;
  bool hier_tunable_ = false;
  int wire_use_ = 0;
  bool wire_tunable_ = false;
  int qdev_use_ = 0;
  bool qdev_tunable_ = false;
  int qdev_sched_use_ = 0;
  bool sched_tunable_ = false;
  int plane_use_ = 0;
  bool plane_tunable_ = false;
  double best_score_ = -1;
  int64_t best_fusion_ = 0;
  double best_cycle_ = 1.0;
  bool best_cache_ = true;
  bool best_hier_ = false;
  int best_wire_ = 0;
  int best_qdev_ = 0;
  int best_qdev_sched_ = 0;
  int best_plane_ = 0;
  int warmup_windows_ = 1;
  int windows_since_best_ = 0;
  bool converged_ = false;
  BayesianOptimizer bo_;
  FILE* log_ = nullptr;
};

}  // namespace hvdtpu
