#include "flight_recorder.h"

#include <errno.h>
#include <fcntl.h>
#include <signal.h>
#include <string.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <initializer_list>
#include <mutex>

namespace hvdtpu {

namespace {

constexpr int kMaxFlightThreads = 64;
constexpr int kDefaultSlots = 4096;
constexpr int kMinSlots = 64;
constexpr int kMaxSlots = 1 << 20;
constexpr int kMaxPath = 768;

// Static legend so the dump paths never format strings at crash time.
// Keep in sync with FlightType in flight_recorder.h.
const char kFlightTypesLegend[] =
    "{\"1\":\"ctrl_send\",\"2\":\"ctrl_recv\",\"3\":\"rendezvous\","
    "\"4\":\"verdict\",\"5\":\"ring_hop\",\"6\":\"wire_codec\","
    "\"7\":\"shm_fence\",\"8\":\"shm_map\",\"9\":\"tree_aggregate\","
    "\"10\":\"fault_trip\",\"11\":\"abort\",\"12\":\"digest\","
    "\"13\":\"autopilot\",\"14\":\"migrate\",\"15\":\"sentinel\","
    "\"16\":\"hloinspect\"}";

// One ring slot.  Four atomics (not a raw struct) so a dump racing a
// record is a data-race-free torn read at worst — the consumer sorts by
// seq and tolerates one inconsistent tail event.
struct Slot {
  std::atomic<int64_t> ts_us{0};
  std::atomic<uint64_t> seq{0};
  // type(16) << 48 | tid(16) << 32 | (uint32_t)a
  std::atomic<uint64_t> meta{0};
  std::atomic<int64_t> b{0};
};

struct ThreadRing {
  std::atomic<Slot*> ring{nullptr};
  std::atomic<uint64_t> head{0};  // total events ever recorded here
};

struct State {
  std::atomic<uint64_t> seq{0};
  std::atomic<int> nthreads{0};
  // Bumped by ResetFlightRecorderForTest so threads with a cached slot
  // index re-register instead of touching a freed ring.
  std::atomic<uint32_t> epoch{1};
  std::atomic<uint32_t> mask{kDefaultSlots - 1};
  std::atomic<int> slots{kDefaultSlots};
  std::atomic<int> rank{0};
  ThreadRing threads[kMaxFlightThreads];
  // Fixed buffers: the signal-handler dump may not allocate.
  char dump_path[kMaxPath] = {0};
  char tmp_path[kMaxPath] = {0};
  char postmortem_dir[kMaxPath] = {0};
  char host[128] = {0};
  std::atomic<bool> dumping{false};
  std::mutex init_mu;
  bool handlers_installed = false;
};

State& S() {
  // Never destroyed, and allocated exactly once — at init time: handlers
  // install strictly after the first S() call, so the signal path only
  // ever takes the already-initialized fast path.
  // lint: sigsafe-ok(one-time init allocation precedes handler install)
  static State* s = new State();
  return *s;
}

int64_t NowUs() {
  struct timespec ts;
  ::clock_gettime(CLOCK_REALTIME, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000 + ts.tv_nsec / 1000;
}

// Claims (once per epoch) this thread's ring slot; -1 when the table is
// full.  The ring is allocated here, outside any record hot path.
int ThreadSlot() {
  static thread_local uint32_t cached_epoch = 0;
  static thread_local int cached_idx = -1;
  State& s = S();
  uint32_t ep = s.epoch.load(std::memory_order_acquire);
  if (cached_epoch == ep) return cached_idx;
  int idx = s.nthreads.fetch_add(1, std::memory_order_relaxed);
  if (idx >= kMaxFlightThreads) {
    s.nthreads.store(kMaxFlightThreads, std::memory_order_relaxed);
    cached_epoch = ep;
    cached_idx = -1;
    return -1;
  }
  Slot* ring = new Slot[s.slots.load(std::memory_order_relaxed)];
  s.threads[idx].head.store(0, std::memory_order_relaxed);
  s.threads[idx].ring.store(ring, std::memory_order_release);
  cached_epoch = ep;
  cached_idx = idx;
  return idx;
}

// Buffered fd writer using only async-signal-safe calls (write) and
// hand-rolled integer formatting.
struct SafeWriter {
  int fd = -1;
  char buf[4096];
  size_t len = 0;

  void Flush() {
    size_t off = 0;
    while (off < len) {
      ssize_t w = ::write(fd, buf + off, len - off);
      if (w < 0) {
        if (errno == EINTR) continue;
        break;
      }
      off += static_cast<size_t>(w);
    }
    len = 0;
  }
  void Raw(const char* p, size_t n) {
    while (n > 0) {
      if (len == sizeof(buf)) Flush();
      size_t take = sizeof(buf) - len;
      if (take > n) take = n;
      ::memcpy(buf + len, p, take);
      len += take;
      p += take;
      n -= take;
    }
  }
  void Str(const char* sz) { Raw(sz, ::strlen(sz)); }
  void U64(unsigned long long u) {
    char tmp[24];
    int i = 24;
    if (u == 0) tmp[--i] = '0';
    while (u) {
      tmp[--i] = static_cast<char>('0' + u % 10);
      u /= 10;
    }
    Raw(tmp + i, 24 - i);
  }
  void I64(long long v) {
    if (v < 0) {
      Str("-");
      U64(static_cast<unsigned long long>(-(v + 1)) + 1);
    } else {
      U64(static_cast<unsigned long long>(v));
    }
  }
};

void WriteDumpTo(SafeWriter& w) {
  State& s = S();
  w.Str("{\"rank\":");
  w.I64(s.rank.load(std::memory_order_relaxed));
  w.Str(",\"host\":\"");
  w.Str(s.host);
  w.Str("\",\"slots\":");
  w.I64(s.slots.load(std::memory_order_relaxed));
  w.Str(",\"dropped\":");
  w.I64(FlightDropped());
  w.Str(",\"types\":");
  w.Str(kFlightTypesLegend);
  w.Str(",\"events\":[");
  uint32_t mask = s.mask.load(std::memory_order_relaxed);
  int nt = std::min(s.nthreads.load(std::memory_order_acquire),
                    kMaxFlightThreads);
  bool first = true;
  for (int t = 0; t < nt; ++t) {
    Slot* ring = s.threads[t].ring.load(std::memory_order_acquire);
    if (ring == nullptr) continue;
    uint64_t head = s.threads[t].head.load(std::memory_order_acquire);
    uint64_t n = head;
    if (n > static_cast<uint64_t>(mask) + 1) n = mask + 1;
    for (uint64_t k = head - n; k < head; ++k) {
      Slot& sl = ring[k & mask];
      uint64_t meta = sl.meta.load(std::memory_order_relaxed);
      if (!first) w.Str(",");
      first = false;
      w.Str("[");
      w.I64(sl.ts_us.load(std::memory_order_relaxed));
      w.Str(",");
      w.U64(sl.seq.load(std::memory_order_relaxed));
      w.Str(",");
      w.I64(static_cast<int>(meta >> 48));
      w.Str(",");
      w.I64(static_cast<int>((meta >> 32) & 0xffff));
      w.Str(",");
      w.I64(static_cast<int32_t>(static_cast<uint32_t>(meta & 0xffffffffu)));
      w.Str(",");
      w.I64(sl.b.load(std::memory_order_relaxed));
      w.Str("]");
    }
  }
  w.Str("]}");
}

void FatalSignalHandler(int sig) {
  FlightDumpToFile();
  // SA_RESETHAND restored the default disposition; re-raise so the
  // process still dies with the original signal (and core-dump rules).
  ::raise(sig);
}

void InstallFatalHandlers() {
  State& s = S();
  if (s.handlers_installed) return;
  s.handlers_installed = true;
  struct sigaction sa;
  ::memset(&sa, 0, sizeof(sa));
  sa.sa_handler = FatalSignalHandler;
  sa.sa_flags = SA_RESETHAND | SA_NODEFER;
  ::sigemptyset(&sa.sa_mask);
  for (int sig : {SIGSEGV, SIGBUS, SIGABRT, SIGFPE, SIGILL}) {
    struct sigaction old;
    if (::sigaction(sig, nullptr, &old) != 0) continue;
    // Never trample an existing handler (sanitizer runtimes, embedders,
    // test harnesses): only claim signals at their default disposition.
    if ((old.sa_flags & SA_SIGINFO) == 0 && old.sa_handler == SIG_DFL) {
      ::sigaction(sig, &sa, nullptr);
    }
  }
}

void CollectEvents(std::vector<FlightEvent>* out) {
  State& s = S();
  uint32_t mask = s.mask.load(std::memory_order_relaxed);
  int nt = std::min(s.nthreads.load(std::memory_order_acquire),
                    kMaxFlightThreads);
  for (int t = 0; t < nt; ++t) {
    Slot* ring = s.threads[t].ring.load(std::memory_order_acquire);
    if (ring == nullptr) continue;
    uint64_t head = s.threads[t].head.load(std::memory_order_acquire);
    uint64_t n = head;
    if (n > static_cast<uint64_t>(mask) + 1) n = mask + 1;
    for (uint64_t k = head - n; k < head; ++k) {
      Slot& sl = ring[k & mask];
      uint64_t meta = sl.meta.load(std::memory_order_relaxed);
      FlightEvent ev;
      ev.ts_us = sl.ts_us.load(std::memory_order_relaxed);
      ev.seq = sl.seq.load(std::memory_order_relaxed);
      ev.type = static_cast<int32_t>(meta >> 48);
      ev.tid = static_cast<int32_t>((meta >> 32) & 0xffff);
      ev.a = static_cast<int32_t>(static_cast<uint32_t>(meta & 0xffffffffu));
      ev.b = sl.b.load(std::memory_order_relaxed);
      out->push_back(ev);
    }
  }
  std::sort(out->begin(), out->end(),
            [](const FlightEvent& x, const FlightEvent& y) {
              return x.seq < y.seq;
            });
}

}  // namespace

FlightRecorderState& GlobalFlightRecorder() {
  static FlightRecorderState* st = new FlightRecorderState();
  return *st;
}

void InitFlightRecorder(bool enabled, int slots,
                        const std::string& postmortem_dir, int rank) {
  State& s = S();
  std::lock_guard<std::mutex> l(s.init_mu);
  if (slots <= 0) slots = kDefaultSlots;
  int p = kMinSlots;
  while (p < slots && p < kMaxSlots) p <<= 1;
  s.slots.store(p, std::memory_order_relaxed);
  s.mask.store(static_cast<uint32_t>(p - 1), std::memory_order_relaxed);
  s.rank.store(rank, std::memory_order_relaxed);
  if (::gethostname(s.host, sizeof(s.host) - 1) != 0) {
    ::strncpy(s.host, "unknown", sizeof(s.host) - 1);
  }
  s.host[sizeof(s.host) - 1] = 0;
  for (char* c = s.host; *c; ++c) {
    // The host lands inside a JSON string built at crash time with no
    // escaper — keep it trivially safe.
    if (*c == '"' || *c == '\\' || static_cast<unsigned char>(*c) < 0x20) {
      *c = '_';
    }
  }
  std::string dir = postmortem_dir;
  auto pos = dir.find("{rank}");
  if (pos != std::string::npos) dir.replace(pos, 6, std::to_string(rank));
  s.postmortem_dir[0] = 0;
  s.dump_path[0] = 0;
  s.tmp_path[0] = 0;
  if (!dir.empty()) {
    ::mkdir(dir.c_str(), 0777);  // best-effort; EEXIST is the common case
    std::string path = dir + "/flight." + std::to_string(rank) + ".json";
    std::string tmp = path + ".tmp";
    if (tmp.size() < kMaxPath) {
      ::strncpy(s.postmortem_dir, dir.c_str(), kMaxPath - 1);
      ::strncpy(s.dump_path, path.c_str(), kMaxPath - 1);
      ::strncpy(s.tmp_path, tmp.c_str(), kMaxPath - 1);
    }
  }
  GlobalFlightRecorder().enabled.store(enabled, std::memory_order_relaxed);
  if (enabled && s.dump_path[0] != 0) InstallFatalHandlers();
}

void FlightRecord(int32_t type, int32_t a, int64_t b) {
  State& s = S();
  int idx = ThreadSlot();
  if (idx < 0) return;
  ThreadRing& tr = s.threads[idx];
  Slot* ring = tr.ring.load(std::memory_order_relaxed);
  if (ring == nullptr) return;
  uint64_t h = tr.head.load(std::memory_order_relaxed);
  Slot& sl = ring[h & s.mask.load(std::memory_order_relaxed)];
  uint64_t seq = s.seq.fetch_add(1, std::memory_order_relaxed);
  sl.ts_us.store(NowUs(), std::memory_order_relaxed);
  sl.seq.store(seq, std::memory_order_relaxed);
  sl.meta.store((static_cast<uint64_t>(static_cast<uint16_t>(type)) << 48) |
                    (static_cast<uint64_t>(static_cast<uint16_t>(idx)) << 32) |
                    static_cast<uint32_t>(a),
                std::memory_order_relaxed);
  sl.b.store(b, std::memory_order_relaxed);
  tr.head.store(h + 1, std::memory_order_release);
}

void FlightTail(int n, std::vector<FlightEvent>* out) {
  out->clear();
  if (n <= 0) return;
  std::vector<FlightEvent> all;
  CollectEvents(&all);
  size_t keep = std::min(static_cast<size_t>(n), all.size());
  out->assign(all.end() - keep, all.end());
}

std::string FlightDumpJson() {
  State& s = S();
  std::vector<FlightEvent> all;
  CollectEvents(&all);
  std::string out = "{\"rank\":" +
                    std::to_string(s.rank.load(std::memory_order_relaxed)) +
                    ",\"host\":\"" + s.host + "\",\"slots\":" +
                    std::to_string(s.slots.load(std::memory_order_relaxed)) +
                    ",\"dropped\":" + std::to_string(FlightDropped()) +
                    ",\"types\":" + kFlightTypesLegend + ",\"events\":[";
  bool first = true;
  for (const auto& ev : all) {
    if (!first) out += ",";
    first = false;
    out += "[" + std::to_string(ev.ts_us) + "," + std::to_string(ev.seq) +
           "," + std::to_string(ev.type) + "," + std::to_string(ev.tid) +
           "," + std::to_string(ev.a) + "," + std::to_string(ev.b) + "]";
  }
  out += "]}";
  return out;
}

void FlightDumpToFile() {
  State& s = S();
  if (s.dump_path[0] == 0) return;
  bool expected = false;
  // acquire on the winning latch: the dumper must observe every ring
  // write published (release) by recorder threads before it started;
  // failure needs no ordering (the loser just returns).
  if (!s.dumping.compare_exchange_strong(expected, true,
                                         std::memory_order_acquire,
                                         std::memory_order_relaxed)) {
    return;
  }
  int fd = ::open(s.tmp_path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd >= 0) {
    SafeWriter w;
    w.fd = fd;
    WriteDumpTo(w);
    w.Flush();
    ::close(fd);
    ::rename(s.tmp_path, s.dump_path);
  }
  // release: the completed dump (file rename included) must be visible
  // before the next dumper can win the latch above.
  s.dumping.store(false, std::memory_order_release);
}

std::string FlightDumpPath() { return S().dump_path; }

std::string FlightPostmortemDir() { return S().postmortem_dir; }

const char* FlightTypesLegend() { return kFlightTypesLegend; }

int64_t FlightDropped() {
  State& s = S();
  uint64_t cap = static_cast<uint64_t>(s.mask.load(std::memory_order_relaxed)) + 1;
  int nt = std::min(s.nthreads.load(std::memory_order_acquire),
                    kMaxFlightThreads);
  int64_t dropped = 0;
  for (int t = 0; t < nt; ++t) {
    uint64_t head = s.threads[t].head.load(std::memory_order_relaxed);
    if (head > cap) dropped += static_cast<int64_t>(head - cap);
  }
  return dropped;
}

void ResetFlightRecorderForTest() {
  State& s = S();
  std::lock_guard<std::mutex> l(s.init_mu);
  GlobalFlightRecorder().enabled.store(false, std::memory_order_relaxed);
  // Invalidate every thread's cached slot BEFORE freeing rings; callers
  // guarantee no record is in flight.
  s.epoch.fetch_add(1, std::memory_order_acq_rel);
  int nt = std::min(s.nthreads.load(std::memory_order_acquire),
                    kMaxFlightThreads);
  for (int t = 0; t < nt; ++t) {
    Slot* ring = s.threads[t].ring.exchange(nullptr,
                                            std::memory_order_acq_rel);
    delete[] ring;
    s.threads[t].head.store(0, std::memory_order_relaxed);
  }
  s.nthreads.store(0, std::memory_order_relaxed);
  s.seq.store(0, std::memory_order_relaxed);
  s.dump_path[0] = 0;
  s.tmp_path[0] = 0;
  s.postmortem_dir[0] = 0;
  s.dumping.store(false, std::memory_order_relaxed);
}

}  // namespace hvdtpu
