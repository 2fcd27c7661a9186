// Leveled stderr logging (reference: horovod/common/logging.h LOG macros).
#pragma once

#include <chrono>
#include <cstdio>
#include <ctime>
#include <sstream>
#include <string>

namespace hvdtpu {

enum LogLevel { TRACE = 0, DEBUG = 1, INFO = 2, WARNING = 3, ERROR = 4, FATAL = 5 };

int GetLogLevel();
void SetLogLevel(int level);

class LogMessage {
 public:
  LogMessage(int level, const char* file, int line) : level_(level) {
    stream_ << "[hvd-tpu-core] [" << LevelName(level) << "] ";
    (void)file;
    (void)line;
  }
  ~LogMessage() {
    if (level_ >= GetLogLevel()) {
      stream_ << "\n";
      std::fputs(stream_.str().c_str(), stderr);
      std::fflush(stderr);
    }
  }
  std::ostringstream& stream() { return stream_; }

 private:
  static const char* LevelName(int level) {
    switch (level) {
      case TRACE: return "trace";
      case DEBUG: return "debug";
      case INFO: return "info";
      case WARNING: return "warning";
      case ERROR: return "error";
      default: return "fatal";
    }
  }
  int level_;
  std::ostringstream stream_;
};

#define HVD_LOG(level) ::hvdtpu::LogMessage(::hvdtpu::level, __FILE__, __LINE__).stream()

}  // namespace hvdtpu
