// Shared-memory data plane for same-host members.
//
// When every member of a process set lives on one host (the common
// single-host multi-worker layout, and every localhost test), moving
// tensor bytes through loopback TCP costs kernel copies on both sides of
// every hop — on a CPU-bound host the ring tops out far below memcpy
// speed.  The reference stack solves this with shm transports (Gloo's shm
// path; NCCL's intra-node shm channels; SURVEY.md §2.8) — this is the
// TPU-native core's equivalent for its host (eager) plane.
//
// One POSIX shm region per process set.  Ops are collective and ordered
// per set (the executor lane serializes them), so the region is a simple
// phase-structured scratch: members write, barrier over the set's
// socket channel, read, barrier.  The trailing barrier makes the next
// op's writes safe.  Growth is collective and deterministic: every member
// computes the same required size, so all agree when to remap.
#pragma once

#include <cstdint>
#include <functional>
#include <string>

#include "common.h"

namespace hvdtpu {

class ShmRegion {
 public:
  // Fixed header for per-member sizes (allgather/alltoall geometry):
  // alltoall needs m*m int64s; 16KB covers m up to 45, far beyond
  // single-host worker counts.
  static constexpr int64_t kHeaderBytes = 16 * 1024;

  ~ShmRegion();

  // Creator (lowest member) unlinks any stale region and creates; the
  // caller must barrier between the creator's Open and the others'.
  Status Open(const std::string& name, bool creator);

  // Ensure capacity for `data_bytes` beyond the header.  `barrier` is a
  // socket barrier over the set; it runs only on the grow path (twice:
  // once so no reader still uses the old mapping, once so nobody maps
  // before the creator's ftruncate).  Every member must call with the
  // same `data_bytes`.
  Status EnsureCapacity(int64_t data_bytes, bool creator,
                        const std::function<Status()>& barrier);

  char* header() { return static_cast<char*>(map_); }
  char* data() { return static_cast<char*>(map_) + kHeaderBytes; }
  bool valid() const { return map_ != nullptr; }

  void Close(bool unlink);

 private:
  std::string name_;
  int fd_ = -1;
  void* map_ = nullptr;
  int64_t cap_ = 0;  // total mapped bytes (header + data)
  bool creator_ = false;  // this process ran the O_CREAT|O_EXCL open
                          // (teardown unlinks on EVERY member — see the
                          // destructor comment in shm_plane.cc)
};

}  // namespace hvdtpu
