// Controller: readiness negotiation + fusion + process sets + data plane.
//
// Reference: horovod/common/controller.h (Controller::ComputeResponseList),
// process_set.h (ProcessSetTable); SURVEY.md §2.1.  Two implementations:
// LocalController (single process — everything is immediately ready) and
// SocketController (rank-0 coordinator over TCP with response-cache
// bit-vectors and a coordinator-rooted host data plane, the Gloo-CPU-path
// analog).  On TPU pods the *device* data plane is XLA-over-ICI (driven from
// Python); the controller's job is to keep hosts in lockstep so every host
// dispatches the same fused XLA program.
#pragma once

#include <algorithm>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

#include "common.h"

namespace hvdtpu {

// Atomic group gating shared by LocalController and the coordinator
// (reference: group_table.cc — GroupTable): members of incomplete groups
// are withheld into `still_held`; everything else lands in `ready` sorted
// so each complete group sits CONTIGUOUSLY at its first member's arrival
// position (so members fuse together and other traffic cannot
// interleave).  `meta(payload)` yields the TensorRequest describing an
// item.  Fast path: with no grouped items in flight this is just the
// arrival-order sort + move the pre-group code did.
template <typename T, typename MetaFn>
void GateAndOrderGroups(std::vector<std::pair<int64_t, T>>&& items,
                        std::vector<std::pair<int64_t, T>>* still_held,
                        std::vector<T>* ready, MetaFn meta) {
  still_held->clear();
  ready->clear();
  bool any_group = false;
  for (const auto& it : items) {
    if (!meta(it.second).group_key.empty()) {
      any_group = true;
      break;
    }
  }
  if (!any_group) {
    std::sort(items.begin(), items.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    for (auto& [ord, t] : items) ready->push_back(std::move(t));
    return;
  }
  std::unordered_map<std::string, std::pair<int32_t, int64_t>> gstate;
  for (const auto& [ord, t] : items) {
    const auto& m = meta(t);
    if (m.group_key.empty()) continue;
    auto it = gstate.emplace(m.group_key, std::make_pair(0, ord)).first;
    it->second.first++;
    it->second.second = std::min(it->second.second, ord);
  }
  std::vector<std::pair<std::pair<int64_t, int64_t>, T>> keyed;
  keyed.reserve(items.size());
  for (auto& [ord, t] : items) {
    const auto& m = meta(t);
    if (m.group_key.empty()) {
      keyed.push_back({{ord, ord}, std::move(t)});
    } else if (gstate[m.group_key].first < m.group_size) {
      still_held->emplace_back(ord, std::move(t));
    } else {
      keyed.push_back({{gstate[m.group_key].second, ord}, std::move(t)});
    }
  }
  std::sort(keyed.begin(), keyed.end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });
  for (auto& [k, t] : keyed) ready->push_back(std::move(t));
}

class ProcessSetTable {
 public:
  void InitGlobal(int world_size);
  int Add(const std::vector<int>& ranks);
  // QoS variant: `weight` orders fused-response scheduling on the
  // coordinator (higher first; the global set is pinned at 1.0).  The
  // plain Add defaults every set to weight 1.0.
  int AddWeighted(const std::vector<int>& ranks, double weight);
  void Remove(int id);
  bool Ranks(int id, std::vector<int>* out) const;
  bool Contains(int id, int rank) const;
  double Weight(int id) const;

 private:
  mutable std::mutex mu_;
  std::map<int, std::vector<int>> sets_;
  std::map<int, double> weights_;
  int next_id_ = 1;
};

// Deterministic fusion: group consecutive ready allreduces that share
// (dtype, process set, reduce op, pre/postscale) into buckets bounded by
// fusion_threshold bytes (reference: fusion_buffer_manager.h + the bucketing
// in Controller::ComputeResponseList).  Identical input order on every rank
// yields byte-identical responses.
std::vector<Response> FuseRequests(const std::vector<TensorRequest>& ready,
                                   int64_t fusion_threshold);

class Controller {
 public:
  explicit Controller(const CoreConfig& cfg) : cfg_(cfg) {}
  virtual ~Controller() = default;

  virtual Status Initialize() = 0;
  virtual void Shutdown() {}
  // Clean-exit notification sent before Shutdown(): workers tell the
  // coordinator they are leaving, the coordinator tells the workers —
  // turning teardown races into expected, quiet events (reference: the
  // DONE/shutdown message in the reference's controller protocol).
  virtual void Farewell() {}

  // One negotiation cycle: feed newly enqueued local requests, receive the
  // globally agreed (identical on all ranks) response list.
  virtual Status ComputeResponses(std::vector<TensorRequest>& new_requests,
                                  std::vector<Response>* out) = 0;

  // Host data plane over fused contiguous buffers.
  virtual Status AllreduceBuffer(void* buf, int64_t count, DataType dtype,
                                 ReduceOp op, int process_set_id) = 0;
  // Reduce-scatter: on return, this rank's slice (slice_counts[my_pos]
  // elements at its offset within buf) is fully reduced; other regions of
  // buf are unspecified.  Default: full allreduce (correct everywhere,
  // 2x the optimal wire bytes — SocketController overrides with a ring
  // phase that moves (m-1)/m of the buffer instead of 2(m-1)/m).
  virtual Status ReduceScatterBuffer(void* buf, int64_t count,
                                     DataType dtype, ReduceOp op,
                                     const std::vector<int64_t>& slice_counts,
                                     int process_set_id) {
    (void)slice_counts;
    return AllreduceBuffer(buf, count, dtype, op, process_set_id);
  }
  virtual Status AllgatherBuffer(const void* in, int64_t nbytes,
                                 int process_set_id, std::string* out,
                                 std::vector<int64_t>* nbytes_per_rank) = 0;
  virtual Status BroadcastBuffer(void* buf, int64_t nbytes, int root_rank,
                                 int process_set_id) = 0;
  virtual Status AlltoallBuffer(const void* in,
                                const std::vector<int64_t>& splits,
                                int64_t row_bytes, int process_set_id,
                                std::string* out,
                                std::vector<int64_t>* recv_splits) = 0;
  virtual Status Barrier(int process_set_id) = 0;

  int rank() const { return cfg_.rank; }
  int size() const { return cfg_.size; }
  ProcessSetTable& process_sets() { return process_sets_; }

  // Per-process-set data channel lifecycle (see SocketController): the
  // default is a no-op — LocalController's data plane is identity and
  // needs no sockets.
  virtual Status EstablishChannel(int psid) { return Status::OK(); }
  virtual void RemoveChannel(int psid) {}

  // Coordinator-side stall report: tensor -> ranks that have not announced
  // it yet (reference: stall_inspector.cc per-rank missing lists).
  virtual std::string StallReport(double older_than_s) { return ""; }

  // Blocks (bounded by the abort-propagation timeout) until this rank has
  // learned why the job is aborting — the coordinator's ABORT broadcast
  // names the culprit rank/host — and returns that reason, or "" if none
  // arrived in time.  Local controller: no peers, nothing to wait for.
  virtual std::string WaitAbortReason() { return ""; }

  // Cumulative negotiation ctrl-channel payload bytes (sent, received) by
  // this rank — the cache bit-vector fast path's measurable effect: cache
  // hits travel as 16-byte (id, handle) pairs instead of full request
  // metadata.  Local controller: zero (no sockets).
  virtual void NegotiationStats(int64_t* sent, int64_t* recv) const {
    *sent = 0;
    *recv = 0;
  }

  // Ctrl-plane traffic counters: frames and payload bytes this rank sent /
  // received on negotiation links (coordinator, leader-tree parent, and —
  // on leaders — child links).  On the coordinator this is the choke-point
  // measurement the v9 leader tree exists to shrink: messages per cycle
  // drop from O(ranks) to O(local ranks + hosts).  Local controller: zero.
  virtual void CtrlPlaneStats(int64_t* msgs_sent, int64_t* msgs_recv,
                              int64_t* bytes_sent, int64_t* bytes_recv) const {
    *msgs_sent = 0;
    *msgs_recv = 0;
    *bytes_sent = 0;
    *bytes_recv = 0;
  }

 protected:
  CoreConfig cfg_;
  ProcessSetTable process_sets_;
};

// Single-process controller: negotiation is trivial, data plane is identity.
class LocalController : public Controller {
 public:
  explicit LocalController(const CoreConfig& cfg) : Controller(cfg) {}
  Status Initialize() override;
  Status ComputeResponses(std::vector<TensorRequest>& new_requests,
                          std::vector<Response>* out) override;
  Status AllreduceBuffer(void*, int64_t, DataType, ReduceOp, int) override {
    return Status::OK();
  }
  Status AllgatherBuffer(const void* in, int64_t nbytes, int,
                         std::string* out,
                         std::vector<int64_t>* nbytes_per_rank) override {
    out->assign(static_cast<const char*>(in), nbytes);
    nbytes_per_rank->assign(1, nbytes);
    return Status::OK();
  }
  Status BroadcastBuffer(void*, int64_t, int, int) override {
    return Status::OK();
  }
  Status AlltoallBuffer(const void* in, const std::vector<int64_t>& splits,
                        int64_t row_bytes, int, std::string* out,
                        std::vector<int64_t>* recv_splits) override {
    int64_t rows = 0;
    for (auto s : splits) rows += s;
    out->assign(static_cast<const char*>(in), rows * row_bytes);
    *recv_splits = splits;
    return Status::OK();
  }
  Status Barrier(int) override { return Status::OK(); }

 private:
  // Grouped requests held until every member of the group has arrived
  // (a grouped enqueue can race the cycle drain mid-call; atomicity must
  // hold at np=1 too — group_table.cc analog).
  std::vector<std::pair<int64_t, TensorRequest>> held_;
  int64_t arrival_ = 0;
};

// Typed elementwise reduction into `acc` (used by the socket data plane).
void ReduceInto(void* acc, const void* contrib, int64_t count, DataType dtype,
                ReduceOp op);

}  // namespace hvdtpu
