// Response cache: steady-state negotiation shortcut.
//
// Reference: horovod/common/response_cache.h (ResponseCache /
// CacheCoordinator; SURVEY.md §2.1).  After a tensor has been negotiated
// once, every rank holds an identical cache entry for its signature; on the
// next submission a rank announces only the entry's integer id (a "cache
// bit") instead of the full request metadata.  Entries are inserted when a
// response is emitted — a globally ordered event — so ids and FIFO eviction
// stay deterministic across ranks without extra synchronisation (the
// reference re-synchronises an LRU order instead; FIFO avoids that round).
#pragma once

#include <cstdint>
#include <deque>
#include <string>
#include <unordered_map>

#include "common.h"

namespace hvdtpu {

class ResponseCache {
 public:
  explicit ResponseCache(int capacity) : capacity_(capacity) {}

  static std::string Signature(const TensorRequest& r);

  // Returns cache id or -1.
  int64_t Lookup(const TensorRequest& r) const;
  bool Get(int64_t id, TensorRequest* out) const;

  // Insert after a response for this request was emitted (deterministic
  // global order).  No-op if already present or capacity is 0.
  void Insert(const TensorRequest& r);
  void Clear();

  int64_t size() const { return static_cast<int64_t>(by_sig_.size()); }

 private:
  int capacity_;
  int64_t next_id_ = 0;
  std::unordered_map<std::string, int64_t> by_sig_;
  std::unordered_map<int64_t, TensorRequest> by_id_;
  std::deque<int64_t> fifo_;  // insertion order for eviction
};

}  // namespace hvdtpu
