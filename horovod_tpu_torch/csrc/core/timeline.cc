#include "timeline.h"

#include <chrono>
#include <functional>

#include "common.h"
#include "metrics.h"

namespace hvdtpu {

Timeline::~Timeline() { Stop(); }

void Timeline::Start(const std::string& path, bool mark_cycles) {
  std::lock_guard<std::mutex> l(mu_);
  if (enabled_) return;
  file_ = std::fopen(path.c_str(), "w");
  if (!file_) return;
  std::fputs("[\n", file_);
  first_event_ = true;
  t0_ = MonotonicSeconds();
  mark_cycles_ = mark_cycles;
  shutdown_ = false;
  enabled_ = true;
  // Anchor event: wall clock at trace ts≈0, so merge_timeline.py can put
  // per-rank traces on one axis.  Pushed straight onto the queue — Emit()
  // would re-take mu_.
  int64_t unix_us = std::chrono::duration_cast<std::chrono::microseconds>(
                        std::chrono::system_clock::now().time_since_epoch())
                        .count();
  queue_.push_back("{\"name\":\"CLOCK_SYNC\",\"ph\":\"i\",\"ts\":0,"
                   "\"pid\":0,\"tid\":0,\"s\":\"p\",\"args\":{\"rank\":" +
                   std::to_string(rank_) + ",\"unix_us\":" +
                   std::to_string(unix_us) + "}}");
  writer_ = std::thread([this] { WriterLoop(); });
}

void Timeline::Stop() {
  {
    std::lock_guard<std::mutex> l(mu_);
    if (!enabled_) return;
    shutdown_ = true;
    cv_.notify_all();
  }
  if (writer_.joinable()) writer_.join();
  {
    std::lock_guard<std::mutex> l(mu_);
    if (file_) {
      std::fputs("\n]\n", file_);
      std::fclose(file_);
      file_ = nullptr;
    }
    enabled_ = false;
  }
}

int64_t Timeline::NowUs() const {
  return static_cast<int64_t>((MonotonicSeconds() - t0_) * 1e6);
}

void Timeline::Emit(std::string json_line) {
  std::lock_guard<std::mutex> l(mu_);
  if (!enabled_) return;
  queue_.push_back(std::move(json_line));
  cv_.notify_one();
}

void Timeline::WriterLoop() {
  for (;;) {
    std::deque<std::string> batch;
    {
      std::unique_lock<std::mutex> l(mu_);
      cv_.wait(l, [this] { return shutdown_ || !queue_.empty(); });
      batch.swap(queue_);
      if (batch.empty() && shutdown_) return;
    }
    std::lock_guard<std::mutex> l(mu_);
    if (!file_) return;
    for (auto& ev : batch) {
      if (!first_event_) std::fputs(",\n", file_);
      std::fputs(ev.c_str(), file_);
      first_event_ = false;
    }
    std::fflush(file_);
  }
}

void Timeline::Begin(const std::string& tensor, const std::string& phase) {
  if (!enabled_) return;
  int64_t tid = static_cast<int64_t>(std::hash<std::string>{}(tensor) & 0x7fffffff);
  Emit("{\"name\":\"" + JsonEscape(phase) +
       "\",\"ph\":\"B\",\"ts\":" + std::to_string(NowUs()) +
       ",\"pid\":0,\"tid\":" + std::to_string(tid) +
       ",\"args\":{\"tensor\":\"" + JsonEscape(tensor) + "\"}}");
}

void Timeline::End(const std::string& tensor, const std::string& phase) {
  if (!enabled_) return;
  int64_t tid = static_cast<int64_t>(std::hash<std::string>{}(tensor) & 0x7fffffff);
  Emit("{\"name\":\"" + JsonEscape(phase) +
       "\",\"ph\":\"E\",\"ts\":" + std::to_string(NowUs()) +
       ",\"pid\":0,\"tid\":" + std::to_string(tid) + "}");
}

void Timeline::Instant(const std::string& name) {
  if (!enabled_) return;
  Emit("{\"name\":\"" + JsonEscape(name) +
       "\",\"ph\":\"i\",\"ts\":" + std::to_string(NowUs()) +
       ",\"pid\":0,\"tid\":0,\"s\":\"p\"}");
}

void Timeline::Instant(const std::string& name,
                       const std::string& args_json) {
  if (!enabled_) return;
  if (args_json.empty()) {
    Instant(name);
    return;
  }
  // `args_json` is a complete JSON object literal the caller formed (the
  // ABORT instant carries culprit rank/host for merge_timeline.py).
  Emit("{\"name\":\"" + JsonEscape(name) +
       "\",\"ph\":\"i\",\"ts\":" + std::to_string(NowUs()) +
       ",\"pid\":0,\"tid\":0,\"s\":\"p\",\"args\":" + args_json + "}");
}

void Timeline::MarkCycle() {
  if (mark_cycles_) Instant("CYCLE");
}

}  // namespace hvdtpu
