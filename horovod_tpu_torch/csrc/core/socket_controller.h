// Multi-process controller: rank-0 coordinator negotiation over TCP plus a
// full-mesh worker data plane running ring/tree algorithms.
//
// Reference analogs (SURVEY.md §2.1, §2.8, §3.2): controller.cc
// Controller::ComputeResponseList (rank-0 request intersection), gloo/
// (MPI-free CPU transport + rendezvous + full-mesh TCP pairs + ring
// collectives), response_cache.cc (bit-vector steady state),
// stall_inspector.cc (per-rank missing lists).
//
// Negotiation protocol (per cycle, lock-step, coordinator-rooted):
//   worker -> coord : CYCLE frame = [n_cached, cached_ids...,
//                                    n_requests, full requests...]
//   coord  -> worker: RESPONSES frame = [n, responses...]
// A tensor becomes ready when every rank of its process set has announced
// it; readiness order is deterministic, so the fused response list is
// byte-identical on every rank — which is what lets the TPU device path
// dispatch one cached fused XLA program per response with no further
// coordination.
//
// Data plane: every pair of ranks holds a TCP connection (established at
// Initialize via a coordinator-brokered address book — the Gloo full-mesh
// analog).  Collectives run *on the calling executor thread* of each
// member, in the globally negotiated order: ring allreduce (reduce-scatter
// + allgather phases, bandwidth-optimal O(bytes) per rank instead of the
// round-1 coordinator star's O(size*bytes) rank-0 ingress), ring
// allgather, binomial-tree broadcast, pairwise alltoall, dissemination
// barrier.  Host arrays only — the TPU path never touches these sockets.
#pragma once

#include <atomic>
#include <condition_variable>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <thread>
#include <utility>
#include <vector>

#include "common.h"
#include "controller.h"
#include "fleet_telemetry.h"
#include "flight_recorder.h"
#include "metrics.h"
#include "response_cache.h"
#include "shm_plane.h"
#include "socketio.h"
#include "wire_codec.h"

namespace hvdtpu {

class SocketController : public Controller {
 public:
  explicit SocketController(const CoreConfig& cfg);
  ~SocketController() override;

  Status Initialize() override;
  void Shutdown() override;
  void Farewell() override;
  // True when the peer ended the session deliberately (clean shutdown).
  bool peer_shutdown() const { return peer_shutdown_; }

  Status ComputeResponses(std::vector<TensorRequest>& new_requests,
                          std::vector<Response>* out) override;

  Status AllreduceBuffer(void* buf, int64_t count, DataType dtype, ReduceOp op,
                         int process_set_id) override;
  Status ReduceScatterBuffer(void* buf, int64_t count, DataType dtype,
                             ReduceOp op,
                             const std::vector<int64_t>& slice_counts,
                             int process_set_id) override;
  Status AllgatherBuffer(const void* in, int64_t nbytes, int process_set_id,
                         std::string* out,
                         std::vector<int64_t>* nbytes_per_rank) override;
  Status BroadcastBuffer(void* buf, int64_t nbytes, int root_rank,
                         int process_set_id) override;
  Status AlltoallBuffer(const void* in, const std::vector<int64_t>& splits,
                        int64_t row_bytes, int process_set_id,
                        std::string* out,
                        std::vector<int64_t>* recv_splits) override;
  Status Barrier(int process_set_id) override;

  std::string StallReport(double older_than_s) override;

  // Abort-reason plumbing (fast-abort propagation, protocol v8): the first
  // ABORT observed (coordinator broadcast or locally detected peer death)
  // latches a reason naming the culprit; WaitAbortReason blocks — bounded
  // by HOROVOD_ABORT_PROPAGATION_TIMEOUT, charged only once across stacked
  // waiters — so an executor whose own exchange failed FIRST still reports
  // the coordinator's culprit attribution instead of a bare socket error.
  std::string WaitAbortReason() override;
  std::string AbortReason();

  // Per-process-set data channels (the NCCL-communicator analog): a
  // dedicated socket mesh among the set's members, so collectives on
  // different process sets can run on CONCURRENT executor lanes without
  // interleaving frames on shared sockets.  Called from add_process_set
  // on every rank (symmetric registration is already the contract);
  // non-members return immediately.
  Status EstablishChannel(int psid) override;
  void RemoveChannel(int psid) override;

  // The executor lane calls this before each data-plane op to tag frames.
  // thread_local: each lane thread tags its own collective's frames.
  void SetCurrentSeq(int64_t seq) { current_seq_ = seq; }

  void NegotiationStats(int64_t* sent, int64_t* recv) const override {
    *sent = ctrl_sent_.load(std::memory_order_relaxed);
    *recv = ctrl_recv_.load(std::memory_order_relaxed);
  }

  // Ctrl-plane frame + byte counters (protocol v9).  On the coordinator the
  // msgs_recv rate per cycle is the leader-tree acceptance metric: flat mode
  // receives size-1 frames per cycle, tree mode local_children + hosts-1.
  void CtrlPlaneStats(int64_t* msgs_sent, int64_t* msgs_recv,
                      int64_t* bytes_sent, int64_t* bytes_recv) const override {
    *msgs_sent = ctrl_msgs_sent_.load(std::memory_order_relaxed);
    *msgs_recv = ctrl_msgs_recv_.load(std::memory_order_relaxed);
    *bytes_sent = ctrl_sent_.load(std::memory_order_relaxed);
    *bytes_recv = ctrl_recv_.load(std::memory_order_relaxed);
  }

  // Autotuned categorical knob: announce steady-state tensors via cache
  // ids (default) or as full requests.  Per-rank safe — inserts stay
  // deterministic either way, so cache ids never diverge across ranks.
  void SetAnnounceCache(bool v) {
    announce_cache_.store(v, std::memory_order_relaxed);
  }

  // Hierarchical allreduce knob (HOROVOD_HIERARCHICAL_ALLREDUCE / the
  // autotuner's second categorical).  Only the COORDINATOR's value feeds
  // the per-response hier bit, so per-rank divergence (autotune runs on
  // every rank) cannot split the plane.
  void SetHierarchical(bool v) {
    hierarchical_.store(v, std::memory_order_relaxed);
  }
  // True when the global process set can run the hierarchical composition
  // (>=2 hosts, >=1 host with co-located ranks, per-host shm agreed up).
  // core_api uses this to decide whether the autotuner should explore the
  // hierarchical coordinate at all.
  bool HierAvailable() { return HierFor(0) != nullptr; }

  // Wire-compression knob (HOROVOD_WIRE_COMPRESSION / the autotuner's
  // third categorical; 0=none, 1=bf16, 2=int8).  Like SetHierarchical,
  // only the COORDINATOR's value feeds the per-response wire_comp field.
  void SetWireCompression(int v) {
    wire_compression_.store(v, std::memory_order_relaxed);
  }
  // True when the global process set has a ring whose every hop crosses
  // hosts (the hier leader ring, or a flat ring with one rank per host
  // and no shm plane) — i.e. compression could ever engage.  core_api
  // uses this to pin the autotune coordinate, same rule as HierAvailable.
  bool WireCompAvailable();

  // Data-plane payload bytes sent, split by whether the destination rank
  // lives on this host (the hierarchical win is the xhost line dropping
  // to ~2N per host).  `raw_*` count the fp32-equivalent payload of the
  // same sends: wire < raw exactly when compression engaged, and
  // raw/wire is the measured compression ratio (docs/compression.md).
  void DataPlaneStats(int64_t* local, int64_t* xhost, int64_t* raw_local,
                      int64_t* raw_xhost) const {
    *local = data_sent_local_.load(std::memory_order_relaxed);
    *xhost = data_sent_xhost_.load(std::memory_order_relaxed);
    *raw_local = data_raw_local_.load(std::memory_order_relaxed);
    *raw_xhost = data_raw_xhost_.load(std::memory_order_relaxed);
  }

  // Coordinator-only JSON fragment for hvd_metrics_dump: the per-rank
  // cluster view built from the snapshots each worker piggybacks on its
  // CYCLE frame (protocol v7), plus the latest straggler attribution
  // report, plus the v11 fleet histogram view.  Workers return "".
  std::string ClusterMetricsJson();

  // Coordinator-only: distinct fleet-sketch sources currently stored (the
  // ctrl soak's tree+sketch arm asserts this equals its direct sources —
  // local children plus aggregate children — proving the tree kept
  // coordinator inbound O(fanout) at any depth).
  int FleetSourceCountForTest();
  // Coordinator-only: total negotiation-wait observations in the live
  // fleet sum (own capture + every stored source).  The in-process soak's
  // merge oracle: all np threads snapshot the SAME global registry, so the
  // fleet sum can never exceed np x the registry's own count unless a
  // subtree sketch was double-merged somewhere up the tree.
  int64_t FleetSumNegCountForTest();

  // Fleet-autopilot policy channel (coordinator only, armed by
  // cfg_.autopilot_port > 0): a driver-facing JSON-lines endpoint serving
  // the live straggler view ({"cmd":"poll"}) and accepting decision
  // records ({"cmd":"decision",...}) that land in the flight recorder,
  // the metrics registry, and — via the hook — the timeline.  The hook
  // is installed once at init (core_api), before the serve thread exists.
  void SetAutopilotDecisionHook(
      std::function<void(int action, int rank, const std::string& detail)>
          hook) {
    autopilot_hook_ = std::move(hook);
  }

 private:
  // Compact per-rank metrics snapshot, piggybacked worker->coordinator on
  // every CYCLE frame (protocol v7) and refreshed for rank 0 locally.
  // All values are cumulative since init; the straggler check differences
  // them per report window.
  struct RankMetricsSnapshot {
    int64_t neg_count = 0;
    int64_t neg_sum_us = 0;
    int64_t neg_p50_us = 0;
    int64_t neg_p99_us = 0;
    int64_t cycle_busy_us = 0;
    int64_t cycle_idle_us = 0;
    int64_t cycle_count = 0;
    double updated_at = 0;
  };
  // Coordinator-side straggler attribution: per-rank announce lag = how
  // long after a tensor's FIRST announcement this rank's own announcement
  // arrived (the rank consistently announcing last IS the straggler —
  // every other rank's negotiation wait measures the victim side, not the
  // culprit).  Checked every metrics_report_s_; ranks whose mean window
  // lag exceeds max(straggler_skew_ x fleet median, straggler_min_us_)
  // are named with host, p50/p99 and the fleet median.
  void RecordAnnounceLag(int rank, double lag_s);
  void MaybeStragglerReport(double now);
  void FillSelfSnapshot(double now);

  // -- fleet-autopilot policy channel (coordinator only) --------------------
  // Accept loop + per-connection JSON-lines service on policy_listener_;
  // runs on its own thread (started by Initialize when armed) so policy
  // polls never touch the negotiation cycle.
  void PolicyServeLoop();
  // {"v":1,"windows":N,"culprits":[...],"report":"...","size":S} under
  // metrics_mu_ — the driver-side engine diffs `windows` to count
  // consecutive flagged report windows per rank.
  std::string PolicyStatusJson();
  // Record one driver decision: flight event (kFlightAutopilot), metrics
  // counter, timeline instant via the hook, and an immediate flight dump
  // so the record survives the eviction teardown that usually follows.
  void RecordAutopilotDecision(int action, int rank,
                               const std::string& detail);

  std::mutex metrics_mu_;  // guards cluster_ + straggler_report_ (the
                           // background thread writes, hvd_metrics_dump
                           // reads from the Python thread)
  std::vector<RankMetricsSnapshot> cluster_;           // coordinator, by rank
  std::vector<std::unique_ptr<Histogram>> announce_lag_;  // coordinator
  // Cumulative (count, sum_us) per rank at the last report, for deltas.
  std::vector<std::pair<int64_t, int64_t>> announce_prev_;
  std::string straggler_report_;
  // Autopilot view of the straggler check (guarded by metrics_mu_ like
  // straggler_report_): total report windows evaluated so far and the
  // ranks flagged in the LAST window.  The driver-side policy engine
  // diffs `straggler_windows_` between polls to count consecutive flagged
  // windows without double-counting a window it already saw.
  int64_t straggler_windows_ = 0;
  std::vector<int> straggler_ranks_;
  double last_metrics_report_ = 0;
  // HOROVOD_METRICS_REPORT_SECONDS / HOROVOD_STRAGGLER_SKEW /
  // HOROVOD_STRAGGLER_MIN_MS (ctor reads the env, like ring_chunk_bytes_).
  double metrics_report_s_ = 30.0;
  double straggler_skew_ = 3.0;
  double straggler_min_us_ = 5000.0;

  // Negotiation ctrl-channel payload byte counters (background thread
  // writes, Python reads — relaxed atomics suffice for monotone counters).
  std::atomic<int64_t> ctrl_sent_{0};
  std::atomic<int64_t> ctrl_recv_{0};
  // Ctrl-channel frame counters (protocol v9): one increment per CYCLE /
  // RESPONSES / aggregate / abort frame moved on a negotiation link.
  std::atomic<int64_t> ctrl_msgs_sent_{0};
  std::atomic<int64_t> ctrl_msgs_recv_{0};
  // Data-plane payload byte counters keyed by destination host locality:
  // `data_sent_*` are bytes on the wire, `data_raw_*` the fp32-equivalent
  // payload (equal unless a compressed ring encoded the send).
  std::atomic<int64_t> data_sent_local_{0};
  std::atomic<int64_t> data_sent_xhost_{0};
  std::atomic<int64_t> data_raw_local_{0};
  std::atomic<int64_t> data_raw_xhost_{0};
  std::atomic<bool> announce_cache_{true};
  std::atomic<bool> hierarchical_{false};
  // Requested wire codec (WireCodec as int); the coordinator demotes
  // per-response where it cannot apply (see UpdateCachesAndSeq).
  std::atomic<int> wire_compression_{0};
  struct Pending {
    TensorRequest meta;
    std::set<int> announced;
    int64_t order = 0;      // arrival order at coordinator (determinism)
    double first_seen = 0;  // stall inspection
  };

  // -- negotiation ----------------------------------------------------------
  Status CoordinatorCycle(std::vector<TensorRequest>& new_requests,
                          std::vector<Response>* out);
  Status WorkerCycle(std::vector<TensorRequest>& new_requests,
                     std::vector<Response>* out);

  // -- leader-tree control plane (protocol v9; n-level since v12) -----------
  // Tree over the agreed host keys: the first rank of each host
  // (first-appearance order over rank order — the same election
  // MaybeSetupHier uses) is that host's leader.  Children exchange CYCLE /
  // RESPONSES frames with their leader; leaders merge child announcements
  // into ONE aggregate frame per host toward their parent and fan the
  // responses (and abort broadcasts) back down verbatim.  Protocol v12
  // generalizes the upper level: when the host-leader count exceeds
  // HOROVOD_CTRL_TREE_FANOUT, consecutive leaders are clustered under
  // mid-level "super-leaders" (the lowest rank of each cluster) that merge
  // their child leaders' [-3] aggregates into one frame upward, recursively,
  // until the coordinator's fan-in is <= fanout.  Rank 0 is always both the
  // coordinator and its own host's leader, so its host's children keep
  // their direct rendezvous ctrl sockets.  The engagement decision AND the
  // fanout/depth knobs are COORDINATOR-AUTHORITATIVE: they ride the
  // rendezvous book, so divergent HOROVOD_CONTROL_TREE* envs cannot split
  // the ring.
  struct CtrlTree {
    bool on = false;
    std::vector<int> leaders;      // per-host leader ranks (ascending)
    int my_leader = -1;            // leader of this rank's host
    std::vector<int> my_children;  // leader only: this host's other ranks
    // v12 adaptive depth.  parent_of maps every non-root LEADER node (host
    // leaders and super-leaders) to the rank its aggregate flows to (0 =
    // straight to the coordinator); identical on all ranks, so subtree
    // membership and ancestor chains are computable anywhere.  Workers'
    // negotiation parent stays my_leader.
    std::map<int, int> parent_of;
    int parent = -1;                // leader only: parent_of[rank]
    std::vector<int> agg_children;  // downstream leader ranks whose [-3]
                                    // aggregates THIS node gathers + merges
    int depth = 2;  // tree levels: coordinator=1, +1 per aggregation layer
  };
  // Engagement rule, pure function of the mode string + agreed host keys
  // (mirrored by runtime.compute_ctrl_tree for the Python-side unit tests):
  // "on" engages with >=2 hosts, "auto" additionally requires size >= 8,
  // single-host jobs always demote to the flat plane.
  static bool DecideCtrlTree(const std::string& mode,
                             const std::vector<std::string>& host_keys);
  // Build tree_ from host_keys_ (after the book agreed) per the decision,
  // clustering host leaders under super-leaders until every node's fan-in
  // is <= ctrl_tree_fanout_ (or exactly ctrl_tree_depth_ levels deep when
  // the override is set).  Pure function of (host_keys_, fanout, depth) so
  // every rank computes the identical topology.
  void ComputeCtrlTree(bool on);
  // All ranks whose aggregation path runs through `rank`: the rank itself,
  // its host's workers when it is a host leader, and recursively every
  // clustered leader below it.  {rank} for a plain worker.
  std::vector<int> SubtreeOf(int rank) const;
  // Coordinator, protocol v12: a departing leader's BYE releases its whole
  // subtree (v9 released only the leader's host).
  void DepartSubtree(int rank);
  // The chain of leader ranks relaying for `rank`, nearest first, stopping
  // before the coordinator: host leader, then each super-leader above it.
  // Empty for rank 0 and for direct children of the coordinator's host.
  std::vector<int> AncestorChain(int rank) const;
  // Establish the child->leader ctrl links: children of non-coordinator
  // hosts dial their leader's data listener with a kCtrlTreePsid HELLO
  // (the mesh pending-stash absorbs arrival skew, like channel HELLOs).
  Status SetupCtrlTreeLinks();
  bool IsTreeLeader() const {
    return tree_.on && tree_.my_leader == cfg_.rank;
  }
  // The ctrl socket toward this rank's negotiation parent: tree_parent_
  // when the parent is a non-coordinator node (a non-host-0 child's leader,
  // or a v12 leader's super-leader), the coordinator link otherwise.
  Socket& UpLink();
  // Leader's link to child `rank` (the coordinator's local children live
  // in ctrl_socks_); null when unknown/closed.
  Socket* TreeChildSock(int rank);
  // One leader negotiation cycle: gather every live child's frame (fault
  // site: leader-recv), merge cached announcements across the host, forward
  // one aggregate frame, fan the response back down, parse own copy.
  Status LeaderCycle(std::vector<TensorRequest>& new_requests,
                     std::vector<Response>* out);
  // The worker CYCLE frame body: cached pairs + full requests + v7 metrics
  // trailer (shared by WorkerCycle and the leader's own sub-frame).
  std::string BuildCycleFrame(const std::vector<TensorRequest>& new_requests);
  // Shared RESPONSES-frame tail parse (n already read, >= 0).
  void ParseResponsesTail(Reader* rd, int32_t n, std::vector<Response>* out);
  // Forward a responses-position frame verbatim to every live child;
  // returns false and names the child when a send fails (cycle path aborts
  // on that; abort/farewell fan-outs are best-effort and ignore it).
  bool FanDownToChildren(const std::string& frame, int* failed_child);
  // Leader failure path: send a FIN upward naming `culprit` (or forward a
  // child's own FIN frame verbatim) and await the coordinator's ABORT.
  Status LeaderFinUp(int culprit, const std::string& why,
                     const std::string* forward_frame);
  // Coordinator parse helpers, shared by the flat per-rank loop and the
  // per-subframe body of a leader aggregate.
  void ParseCachedPairs(int rank, int32_t n_cached, Reader* rd,
                        std::vector<Response>* errors);
  void ParseFullAndMetrics(int rank, int32_t n_full, Reader* rd,
                           std::vector<Response>* errors);
  // Parse a leader's [-3] aggregate frame; false = malformed (caller aborts
  // blaming the leader).
  bool ParseAggregate(int leader, Reader* rd, std::vector<Response>* errors);

  // -- fleet telemetry (protocol v11; fleet_telemetry.h) --------------------
  // Read the length-prefixed sketch section at the reader's cursor and
  // store it as `rank`'s cumulative sketch.  A malformed sketch is dropped
  // (never the frame); an empty section (sender's plane off) is a no-op.
  void ReadFleetSketch(int rank, Reader* rd);
  // Replace a source's last-known cumulative sketch (coordinator side).
  void StoreFleetSource(int rank, FleetSketch&& s);
  // The coordinator's live fleet view: its own registry capture plus every
  // stored source sketch.  Bucket-exact vs an offline merge of per-rank
  // dumps because each source's sketch is cumulative and replaced, never
  // added twice.
  FleetSketch FleetSum();
  // Leader lost its coordinator link: synthesize the ABORT the coordinator
  // can no longer deliver and fan it down so the subtree fails bounded.
  Status LeaderLostCoordinator(const std::string& what);
  // Ctrl-plane accounting: one frame of `bytes` moved on a negotiation
  // link (controller counters + the global metrics registry when enabled).
  void CountCtrlSend(int64_t bytes);
  void CountCtrlRecv(int64_t bytes);

  // Coordinator: last-known cumulative sketch per direct source (a worker
  // rank in flat mode; a local child or a remote leader's host sum in tree
  // mode).  Guarded by fleet_mu_: the background thread replaces entries,
  // hvd_metrics_dump sums them from the Python thread.
  std::mutex fleet_mu_;
  std::map<int, FleetSketch> fleet_sources_;
  // Leader only (background thread): last-known sketch per host member —
  // its own included — summed into the aggregate frame's sketch section.
  // Entries survive a child's BYE (which carries the child's FINAL sketch)
  // so the host sum stays exact after departures.
  std::map<int, FleetSketch> tree_child_sketches_;
  // Sender-side sketch throttles (kFleetEncodeIntervalS): a worker's
  // cycle-frame section and a leader's aggregate host sum each re-encode
  // at most once per interval; in-between frames carry an empty section.
  double fleet_last_encode_ = 0;
  double fleet_leader_last_encode_ = 0;
  // Background thread: the step id of the last step snapshot this rank's
  // cycle frames carried (BuildCycleFrame sends each one once).
  int64_t step_sent_ = -1;
  // Coordinator-side fleet tick limiter (the sum is cheap but per-cycle
  // would still be 1000x more often than the 1 Hz history wants).
  double last_fleet_tick_ = 0;

  CtrlTree tree_;
  // Leader (non-coordinator): accepted child ctrl links, by child rank.
  std::map<int, Socket> tree_child_socks_;
  // Children that sent a clean BYE (leader-side mirror of departed_ranks_).
  std::set<int> tree_departed_children_;
  // The ctrl link to this rank's negotiation parent when that parent is not
  // the coordinator: a non-host-0 child's link to its host leader, or (v12)
  // a leader's link to its super-leader.
  Socket tree_parent_;
  // HOROVOD_CONTROL_TREE (auto|on|off) and HOROVOD_RENDEZVOUS_ACCEPTORS
  // (ctor reads the env; the coordinator's mode decides for everyone).
  std::string control_tree_mode_ = "auto";
  int rendezvous_acceptors_ = 4;
  // HOROVOD_CTRL_TREE_FANOUT (default 32, min 2): the per-node fan-in bound
  // the adaptive-depth pass targets.  HOROVOD_CONTROL_TREE_DEPTH (0 = auto):
  // force the tree to exactly this many levels (2 = the v9 flat-leader
  // shape) regardless of the fanout bound.  Both are coordinator-
  // authoritative — the agreed values ride the v12 rendezvous book.
  int ctrl_tree_fanout_ = 32;
  int ctrl_tree_depth_ = 0;

  // -- fast-abort propagation (protocol v8) ---------------------------------
  // Coordinator: broadcast ABORT(reason, culprit rank/host) on every live
  // ctrl socket (best-effort), latch the reason, and return the ABORTED
  // status every caller of the failed cycle sees.  Idempotent: only the
  // first call broadcasts.
  Status BroadcastAbortAndFail(int culprit_rank, const std::string& why);
  // First-writer-wins reason latch + wakeup for WaitAbortReason.
  void SetAbortReason(const std::string& reason);
  // Entry path when the executor observed a local data-plane failure
  // before the control plane did (aborted_ set, ComputeResponses called):
  // workers send a best-effort failure FIN and await the coordinator's
  // ABORT; the coordinator sweeps ctrl sockets for the culprit and
  // broadcasts.  Both are bounded by abort_timeout_s_.
  Status WorkerAbortHandshake();
  Status CoordinatorAbortSweep();
  // Parse the body of a [-2][kTagAbort]... frame (worker side): latches
  // the reason, observes propagation latency, returns the ABORTED status.
  Status HandleAbortFrame(Reader* rd);
  // -- abort-time forensics (flight recorder; flight_recorder.h) ------------
  // Worker: one [-4][kTagFlightDigest] frame carrying this rank's last-N
  // flight events up `sock` (the coordinator link, or the tree parent for
  // non-host-0 children — leaders forward child digests verbatim).  Sent
  // at most once (digest_sent_), right after a FIN or on ABORT receipt, so
  // forensics rides the existing abort exchange and never delays it.
  void SendFlightDigest(Socket& sock);
  // Coordinator: parse a digest frame body (tag already consumed) into
  // flight_digests_; false = malformed (frame is dropped, never fatal).
  bool StashFlightDigest(Reader* rd);
  // Coordinator: after broadcasting ABORT, poll live ctrl sockets for
  // digest frames until `deadline` (monotonic seconds) or every live rank
  // reported — bounded by the abort-propagation budget.
  void CollectFlightDigests(double deadline);
  // Leader: briefly poll child ctrl links and forward any [-4] digest
  // frames verbatim up the coordinator link (children of non-host-0
  // leaders have no direct path for their digests).  Best-effort and
  // bounded well inside the abort budget.
  void ForwardChildDigests();
  // Coordinator: merge own buffer + collected digests into
  // <postmortem_dir>/postmortem.json naming the culprit and the causal
  // event sequence.  No-op when HOROVOD_POSTMORTEM_DIR is unset.
  void WritePostmortem(int culprit_rank, const std::string& culprit_host,
                       const std::string& why);
  void Announce(int rank, TensorRequest req, std::vector<Response>* errors);
  void UpdateCachesAndSeq(std::vector<Response>* responses);

  // -- data plane (full mesh, caller-thread algorithms) ---------------------
  // Resolve a process set into its sorted member ranks + this rank's index.
  Status Members(int psid, std::vector<int>* members, int* my_idx) const;
  // One collective step: send `frame` to rank `send_to` while receiving a
  // frame from rank `recv_from` (deadlock-free duplex) over the given
  // channel's sockets.
  Status ExchangeStep(std::vector<Socket>& socks, int send_to,
                      const std::string& frame, int recv_from,
                      std::string* in);
  // Chunk-pipelined ring step (Gloo segmented-ring analog): payload flows
  // directly between the user buffer and the wire in `chunk_bytes` pieces,
  // `consume` runs per completed chunk (overlapping reduce with transfer),
  // and `recv_dest` receives the incoming segment in place.  Headers carry
  // the same [seq|tag] as ExchangeStep frames; mismatches abort the job.
  // `raw_len` is the fp32-equivalent payload size for byte accounting
  // (compressed rings send fewer wire bytes than they represent);
  // -1 means raw == wire (the uncompressed default).
  Status ChunkedStep(
      std::vector<Socket>& socks, int send_to, const char* send_base,
      int64_t send_len, int recv_from, int64_t recv_len, char* recv_dest,
      int32_t tag, int64_t chunk_bytes,
      const std::function<void(int64_t off, const char* data, int64_t len)>&
          consume,
      int64_t raw_len = -1);
  // Frame helpers: every data frame is [i64 seq][i32 tag][raw payload];
  // seq/tag mismatches mean the mesh desynced and abort the job.
  // Non-static: the frame-header fault-injection hook needs cfg_.rank.
  void PutFrameHeader(Writer* w, int64_t seq, int32_t tag);
  Status CheckFrameHeader(Reader* rd, int32_t tag, const char* what);

  Status RingAllreduce(std::vector<Socket>& socks, void* buf, int64_t count,
                       DataType dtype, ReduceOp op,
                       const std::vector<int>& members, int idx);
  // Ring allreduce with the payload wire-encoded on every hop (fp32
  // tensors only; docs/compression.md).  Reduce-scatter hops decode each
  // incoming chunk and ACCUMULATE IN FP32 (one quantization of error per
  // hop, never compounding re-quantization of partial sums); the
  // allgather phase encodes each finished segment once at its owner and
  // forwards those bytes verbatim, so every member decodes the identical
  // stream and results stay bit-identical across ranks.
  Status CompressedRingAllreduce(std::vector<Socket>& socks, void* buf,
                                 int64_t count, ReduceOp op,
                                 const std::vector<int>& members, int idx,
                                 WireCodec codec);
  // True when every adjacent hop of the flat ring over `members` crosses
  // hosts (one rank per host), i.e. a flat compressed ring never wastes
  // codec work on a same-host link.
  bool RingAllCrossHost(const std::vector<int>& members) const;
  // Shared pipelined ring reduce phase (m-1 hops, in-flight reduction
  // with partial-element carry): segment boundaries come from `offs`
  // (m+1 element offsets into buf), the schedule runs in `vidx` index
  // space (rank ends owning segment (vidx+1)%m), frames are tagged
  // tag_base+step.  Used by RingAllreduce phase 1 (equal split,
  // vidx=idx) and ReduceScatterBuffer (caller slices, vidx=idx-1).
  Status PipelinedReducePhase(std::vector<Socket>& socks,
                              const std::vector<int>& members, int idx,
                              int vidx, char* base,
                              const std::vector<int64_t>& offs,
                              DataType dtype, ReduceOp op, int32_t tag_base,
                              int64_t chunkb);
  // Build a socket mesh among `members` with HELLOs tagged by `psid`
  // (lower member dials, higher accepts); init uses psid 0 over all ranks.
  Status ConnectMesh(const std::vector<int>& members, int psid,
                     std::vector<Socket>* out);
  // The socket vector for a process set's data ops: the per-set channel
  // if one exists, the global full mesh otherwise.
  std::vector<Socket>& SocksFor(int psid);

  // -- shared-memory plane (same-host members; shm_plane.h) -----------------
  // Dissemination barrier over a channel's sockets with a distinct tag
  // base (the public Barrier() and the shm phase fences share this).
  Status SockBarrier(std::vector<Socket>& socks,
                     const std::vector<int>& members, int idx,
                     int32_t tag_base);
  bool MembersAllLocal(const std::vector<int>& members) const;
  // Open the set's shm region when all members share this host; the
  // open verdict is agreed across members (any failure -> everyone
  // falls back to the TCP ring).
  Status MaybeOpenShm(int psid, const std::vector<int>& members);
  ShmRegion* ShmFor(int psid);
  Status ShmAllreduce(ShmRegion& shm, std::vector<Socket>& socks,
                      const std::vector<int>& members, int idx, void* buf,
                      int64_t count, DataType dtype, ReduceOp op);
  Status ShmBroadcast(ShmRegion& shm, std::vector<Socket>& socks,
                      const std::vector<int>& members, int idx, int root_idx,
                      void* buf, int64_t nbytes);
  Status ShmAllgather(ShmRegion& shm, std::vector<Socket>& socks,
                      const std::vector<int>& members, int idx,
                      const void* in, int64_t nbytes, std::string* out,
                      std::vector<int64_t>* per_rank);
  Status ShmAlltoall(ShmRegion& shm, std::vector<Socket>& socks,
                     const std::vector<int>& members, int idx, const void* in,
                     const std::vector<int64_t>& splits, int64_t row_bytes,
                     std::string* out, std::vector<int64_t>* recv_splits);

  // -- hierarchical allreduce (shm-local reduce -> leader ring -> shm
  //    broadcast; see docs/hierarchical.md) ----------------------------------
  // Per-process-set hierarchical topology, derived from the agreed host
  // keys at Initialize/EstablishChannel time.  `ok` is a whole-set agreed
  // verdict (like the shm plane's): either every member holds a working
  // topology or nobody uses it.
  struct HierTopo {
    std::vector<int> local;    // my host's members (sorted global ranks)
    int local_idx = -1;        // my index in `local`
    std::vector<int> leaders;  // per-host leader ranks (ascending)
    int leader_idx = -1;       // my index in `leaders`, -1 if non-leader
    std::unique_ptr<ShmRegion> shm;  // host subgroup region (null if alone)
  };
  // The rank's agreed per-rank host identity (index i = rank i).  Filled
  // from the rendezvous book so every rank sees the same grouping — the
  // coordinator's mesh_addrs_ view differs from workers' and cannot be
  // used for this.
  static std::string HostKey(int rank, int size);
  // Build (or agree to skip) the hierarchical topology for a set.  Always
  // runs a whole-set handshake when the topology LOOKS applicable so a
  // per-rank failure (shm open, HOROVOD_SHM_DISABLE on one worker) demotes
  // every member together.
  Status MaybeSetupHier(int psid, const std::vector<int>& members);
  HierTopo* HierFor(int psid);
  Status HierAllreduce(HierTopo& topo, std::vector<Socket>& socks, void* buf,
                       int64_t count, DataType dtype, ReduceOp op,
                       WireCodec codec);
  // Record bytes pushed to rank `to` on the data plane (local vs x-host).
  // `raw_bytes` is the fp32-equivalent payload; the 2-arg form means
  // raw == wire (no compression on this send).
  void CountSend(int to, int64_t nbytes) { CountSend(to, nbytes, nbytes); }
  void CountSend(int to, int64_t wire_bytes, int64_t raw_bytes);

  // -- wiring ---------------------------------------------------------------
  bool is_coordinator() const { return cfg_.rank == 0; }

  // HOROVOD_RING_CHUNK_BYTES: ring-hop pipelining granularity (0 = legacy
  // whole-segment frames).  512 KiB measured best on the loopback sweep
  // (128k/256k/512k x socket-buffer sizes); the ctor only overrides this
  // from the env.
  int64_t ring_chunk_bytes_ = 1 << 19;

  // HOROVOD_WIRE_COMPRESSION_MIN_BYTES: responses whose fp32 payload is
  // below this stay raw — codec overhead beats the byte savings on tiny
  // tensors, and the autotuner's fused buckets clear it trivially.
  int64_t wire_comp_floor_ = 1 << 16;

  Listener listener_;       // coordinator: rendezvous/ctrl accept
  Listener data_listener_;  // every rank: mesh peer accept (ephemeral port)
  // Fleet autopilot (coordinator, cfg_.autopilot_port > 0): the driver-
  // facing policy listener and its serve thread.  policy_stop_ is the
  // thread's shutdown latch; the hook forwards decisions to the timeline.
  Listener policy_listener_;
  std::thread policy_thread_;
  std::atomic<bool> policy_stop_{false};
  std::function<void(int, int, const std::string&)> autopilot_hook_;
  // coordinator: per-worker ctrl sockets (index = rank, [0] unused)
  std::vector<Socket> ctrl_socks_;
  // worker: ctrl connection to the coordinator
  Socket coord_ctrl_;
  // full mesh: peer_socks_[r] is the data connection to rank r ([rank] unused)
  std::vector<Socket> peer_socks_;
  // mesh address book from Initialize, kept for later channel dials
  std::vector<std::string> mesh_addrs_;
  std::vector<int> mesh_ports_;
  // agreed per-rank host keys (rendezvous book, protocol v5): the ONLY
  // valid locality signal — mesh_addrs_[0] differs between coordinator
  // ("") and workers (the rendezvous address), so address-based host
  // grouping would diverge across ranks.
  std::vector<std::string> host_keys_;
  // psid -> hierarchical topology (only sets where it is applicable+agreed)
  std::map<int, HierTopo> hier_;
  // Per-seq coordinator plane decisions (the response's hier bit + wire
  // codec), recorded from each cycle's responses and consumed by
  // AllreduceBuffer (lanes are concurrent -> mutex).
  struct PlaneChoice {
    bool hier = false;
    WireCodec wire = WireCodec::kNone;
  };
  std::map<int64_t, PlaneChoice> plane_by_seq_;
  std::mutex hier_mu_;
  // psid -> per-set socket mesh (indexed by GLOBAL rank, like peer_socks_)
  std::map<int, std::vector<Socket>> channel_socks_;
  // psid -> shared-memory region (same-host member sets only)
  std::map<int, std::unique_ptr<ShmRegion>> shm_;
  // HELLOs that arrived for a channel this rank has not started
  // establishing yet (skew between ranks' add_process_set calls):
  // (peer rank, psid) -> accepted socket
  std::map<std::pair<int, int>, Socket> pending_channel_;
  std::mutex channels_mu_;  // guards channel_socks_ map shape
  // Serializes ConnectMesh/EstablishChannel (and Shutdown's pending-stash
  // cleanup): one establishment at a time, so a HELLO stashed for another
  // channel is always found by that channel's later drain pass.  Held
  // across the accept loop — never taken by data ops (SocksFor uses
  // channels_mu_ only), so in-flight collectives are not blocked.
  std::mutex mesh_mu_;

  ResponseCache cache_;
  std::map<std::string, Pending> pending_;  // coordinator only
  // Names recently failed by the coordinator: a straggler announcing one
  // later gets the error immediately instead of waiting forever on ranks
  // that already saw the failure.  Delivery is once per rank — a rank that
  // already received the error and announces the name AGAIN is making a
  // fresh, consistent resubmission (recurring tensor names like per-step
  // gradients) and must proceed normally.  Entries expire by time or once
  // every owed rank has been served; expired entries are swept each cycle.
  struct Tombstone {
    std::string error;
    double expiry = 0;
    std::set<int> owed;  // ranks that have not seen the error yet
  };
  std::map<std::string, Tombstone> error_tombstones_;
  void AddTombstone(const std::string& name, const std::string& error,
                    const std::set<int>& already_informed);
  std::set<int> joined_ranks_;              // hvd.join wildcard (coordinator)
  std::set<int> departed_ranks_;            // clean-exited workers
  int32_t last_joined_ = -1;
  bool peer_shutdown_ = false;
  // -- fast-abort state (protocol v8) --------------------------------------
  // abort_mu_ guards abort_reason_/abort_wait_deadline_; abort_cv_ wakes
  // WaitAbortReason when the reason latches.  The bools are only touched
  // from the single background (negotiation) thread.
  std::mutex abort_mu_;
  std::condition_variable abort_cv_;
  std::string abort_reason_;
  double abort_wait_deadline_ = 0;  // first WaitAbortReason sets it once
  bool fin_sent_ = false;           // worker failure FIN sent (send once)
  bool got_abort_ = false;          // coordinator's ABORT already received
  bool abort_broadcast_done_ = false;  // coordinator broadcast once
  bool digest_sent_ = false;        // flight digest sent upward (send once)
  // Coordinator: per-rank flight digests collected during the abort
  // exchange (background thread only, like the other abort bools).
  std::map<int, std::vector<FlightEvent>> flight_digests_;
  // HOROVOD_ABORT_PROPAGATION_TIMEOUT / HOROVOD_RENDEZVOUS_RETRIES /
  // HOROVOD_RENDEZVOUS_BACKOFF_BASE_MS (ctor reads the env).
  double abort_timeout_s_ = 2.0;
  int rendezvous_retries_ = 30;
  long long rendezvous_backoff_base_ms_ = 50;
  int64_t arrival_counter_ = 0;
  int64_t seq_counter_ = 0;   // global data-op sequence (all ranks agree)
  // seq for the next data op on this lane thread (thread_local so
  // concurrent per-process-set lanes tag their frames independently)
  static thread_local int64_t current_seq_;

  bool initialized_ = false;
  std::atomic<bool> aborted_{false};
};

}  // namespace hvdtpu
