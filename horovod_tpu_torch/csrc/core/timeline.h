// Chrome about:tracing timeline (reference: horovod/common/timeline.h —
// Timeline + TimelineWriter with a dedicated writer thread; SURVEY.md §5).
#pragma once

#include <condition_variable>
#include <cstdio>
#include <deque>
#include <mutex>
#include <string>
#include <thread>

namespace hvdtpu {

class Timeline {
 public:
  ~Timeline();
  void Start(const std::string& path, bool mark_cycles);
  void Stop();
  bool enabled() const { return enabled_; }

  // Rank recorded in the CLOCK_SYNC anchor event Start() emits, which
  // tools/merge_timeline.py uses to align per-rank traces (each rank's
  // ts is relative to its own Start; the anchor carries wall-clock us).
  void SetRank(int rank) { rank_ = rank; }

  // Phase events keyed by tensor name (B/E pairs on a per-tensor lane).
  void Begin(const std::string& tensor, const std::string& phase);
  void End(const std::string& tensor, const std::string& phase);
  void Instant(const std::string& name);
  // Instant with a caller-formed JSON object as Chrome-trace "args" (the
  // ABORT marker carries culprit metadata this way).
  void Instant(const std::string& name, const std::string& args_json);
  void MarkCycle();

 private:
  void Emit(std::string json_line);
  void WriterLoop();
  int64_t NowUs() const;

  bool enabled_ = false;
  bool mark_cycles_ = false;
  int rank_ = -1;
  double t0_ = 0.0;
  FILE* file_ = nullptr;
  bool first_event_ = true;
  std::thread writer_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::string> queue_;
  bool shutdown_ = false;
};

}  // namespace hvdtpu
