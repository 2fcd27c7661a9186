#include "response_cache.h"

#include <sstream>

namespace hvdtpu {

std::string ResponseCache::Signature(const TensorRequest& r) {
  std::ostringstream os;
  // The device bit is deliberately NOT part of the signature: entries are
  // inserted with the coordinator-ANDed bit while lookups use the local
  // capability bit, so including it would permanently miss for any
  // device-capable rank in a host-demoted collective (the steady-state
  // fallback the cache matters most for).  A cache hit replays the STORED
  // negotiated bit; the Python executor tolerates either direction of a
  // stale bit (device_put on a replayed device=1, host materialization on
  // a replayed device=0).
  os << r.name << '|' << static_cast<int>(r.op) << '|'
     << static_cast<int>(r.dtype) << '|' << static_cast<int>(r.reduce_op)
     << '|' << r.process_set_id << '|' << r.root_rank << '|' << r.prescale
     << '|' << r.postscale << '|' << r.group_key << '|'
     << r.group_size << '|';
  for (auto d : r.shape) os << d << ',';
  os << '|';
  for (auto s : r.splits) os << s << ',';
  return os.str();
}

int64_t ResponseCache::Lookup(const TensorRequest& r) const {
  auto it = by_sig_.find(Signature(r));
  return it == by_sig_.end() ? -1 : it->second;
}

bool ResponseCache::Get(int64_t id, TensorRequest* out) const {
  auto it = by_id_.find(id);
  if (it == by_id_.end()) return false;
  *out = it->second;
  return true;
}

void ResponseCache::Insert(const TensorRequest& r) {
  if (capacity_ <= 0) return;
  std::string sig = Signature(r);
  if (by_sig_.count(sig)) return;
  while (static_cast<int>(fifo_.size()) >= capacity_) {
    int64_t victim = fifo_.front();
    fifo_.pop_front();
    auto it = by_id_.find(victim);
    if (it != by_id_.end()) {
      by_sig_.erase(Signature(it->second));
      by_id_.erase(it);
    }
  }
  int64_t id = next_id_++;
  by_sig_[sig] = id;
  by_id_[id] = r;
  fifo_.push_back(id);
}

void ResponseCache::Clear() {
  by_sig_.clear();
  by_id_.clear();
  fifo_.clear();
}

}  // namespace hvdtpu
