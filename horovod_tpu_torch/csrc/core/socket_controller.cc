#include "socket_controller.h"

#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cerrno>
#include <cstdio>

#include <algorithm>
#include <chrono>
#include <cstdlib>
#include <cstring>
#include <sstream>
#include <thread>
#include <unordered_map>

#include "fault_injection.h"
#include "logging.h"
#include "step_trace.h"

namespace hvdtpu {

namespace {

constexpr double kConnectTimeoutS = 60.0;
// Rendezvous HELLO preamble.  The magic rejects stray/garbage connections;
// the version must be bumped whenever the negotiation wire format changes
// (requests, responses, cache frames) so mixed-build jobs fail with a
// named error instead of desynchronized garbled frames.
constexpr int32_t kProtocolMagic = 0x48565354;  // "HVST"
// v12: adaptive-depth leader tree — the rendezvous book's tree trailer
// grows the coordinator's agreed [i32 fanout][i32 depth] after the v9
// ctrl_tree bit, mid-level super-leaders merge downstream leaders' [-3]
// aggregates into one frame upward, and a departing leader's BYE (direct
// or forwarded as an aggregate rest) releases its whole SUBTREE at the
// coordinator (v9 released only the leader's host).  v11 added the
// fleet-telemetry sketch section — a length-prefixed cumulative
// histogram sketch between the cached pairs and the full requests of every
// CYCLE frame, after the [-3] sentinel of leader aggregates (host-summed),
// and trailing upward BYEs (the rank's FINAL sketch, so fleet histograms
// stay bucket-exact across clean shutdown).  v10 added the step-id trailer
// on RESPONSES + the marker-2 step snapshot on CYCLE frames; v9 the
// leader-tree control plane — the coordinator-authoritative ctrl_tree
// bit trailing the rendezvous book, the [-3] leader aggregate frame in the
// cycle position, and the culprit rank trailing failure FINs (v8 added
// ABORT control frames + the worker failure FIN sentinel, v7 the metrics
// snapshot trailer on worker CYCLE frames, v6 the wire_comp codec byte in
// responses, v5 the host key in the rendezvous HELLO/book + the hier bit
// in responses)
constexpr int32_t kProtocolVersion = 12;
// Mesh-HELLO psid for child->leader ctrl-tree links: negative, so it can
// never collide with a real process-set id (those start at 1) and always
// lands in the pending-channel stash when it races a mesh establishment.
constexpr int32_t kCtrlTreePsid = -7;
// v11: worker/leader sketch sections are THROTTLED to this interval — the
// coordinator only folds sketches at its 1 Hz tick, sketches are cumulative
// (last-known is always a valid snapshot), and encoding 4 series x 28
// buckets per negotiation cycle is pure waste at kHz cycle rates.  Frames
// in between carry an empty section, which ReadFleetSketch ignores,
// preserving the receiver's last-known.  BYE finals bypass the throttle.
constexpr double kFleetEncodeIntervalS = 1.0;

// Frame tags: catch mesh desync (a rank consuming a frame meant for another
// op/step) immediately instead of corrupting buffers.
constexpr int32_t kTagReduceScatter = 0x1000;
constexpr int32_t kTagReduceScatterOp = 0x1800;
constexpr int32_t kTagAllgatherPhase = 0x2000;
constexpr int32_t kTagAllgather = 0x4000;
constexpr int32_t kTagAllgatherSize = 0x4800;
constexpr int32_t kTagBroadcast = 0x5000;
constexpr int32_t kTagBroadcastChain = 0x5800;
constexpr int32_t kTagAlltoall = 0x6000;
constexpr int32_t kTagAlltoallSize = 0x6800;
constexpr int32_t kTagBarrier = 0x7000;
// Shared-memory plane phase fences (shm_plane.h): size exchange, write
// done, segments reduced, read done, region grow, open verdict.
constexpr int32_t kTagShmSize = 0x8000;
constexpr int32_t kTagShmWrite = 0x9000;
constexpr int32_t kTagShmMid = 0xA000;
constexpr int32_t kTagShmRead = 0xB000;
constexpr int32_t kTagShmGrow = 0xC000;
constexpr int32_t kTagShmOpen = 0xD000;
constexpr int32_t kTagShmVerdict = 0xE000;
// Hierarchical allreduce: per-host subgroup phase fences (write done,
// segments reduced, leader ring done, result read back, region grow) plus
// the whole-set open/verdict handshake at topology setup.
constexpr int32_t kTagHierWrite = 0xF000;
constexpr int32_t kTagHierMid = 0xF800;
constexpr int32_t kTagHierDone = 0x10000;
constexpr int32_t kTagHierRead = 0x10800;
constexpr int32_t kTagHierGrow = 0x11000;
constexpr int32_t kTagHierOpen = 0x11800;
constexpr int32_t kTagHierVerdict = 0x12000;
// Compressed-ring phases (wire_codec.h).  Distinct from the raw-ring tags
// so a codec split across ranks — which the coordinator's wire_comp bit
// makes impossible by construction — would still fail fast as a header
// mismatch rather than decode garbage.
constexpr int32_t kTagCompReduceScatter = 0x12800;
constexpr int32_t kTagCompAllgather = 0x13000;
// Fast-abort control frame (protocol v8): rides the ctrl channel in the
// responses position as [-2][kTagAbort][reason][culprit_rank][culprit_host]
// [f64 send wallclock]; the tag double-checks the sentinel parse.
constexpr int32_t kTagAbort = 0x13800;
// Flight-recorder digest (abort-time forensics): rides the ctrl channel in
// the cycle position as [-4][kTagFlightDigest][rank][n]
// [n x (i64 ts_us, i64 seq, i32 type, i32 tid, i32 a, i64 b)].  Best-effort
// and bounded by the abort budget — a dropped digest never delays the abort.
constexpr int32_t kTagFlightDigest = 0x14000;
// Last-N window a digest carries: enough causal context around the collapse
// without bloating the abort exchange (48 bytes/event -> ~6 KiB per rank).
constexpr int kFlightDigestEvents = 128;

// Fleet-autopilot decision action codes, carried in kFlightAutopilot
// events (a = action, b = rank) and on the policy channel's DECISION
// command.  Mirrored by horovod_tpu/runner/autopilot.py and decoded by
// tools/postmortem.py — keep the three in sync.
constexpr int kAutopilotActEvict = 1;
constexpr int kAutopilotActScaleUp = 2;
constexpr int kAutopilotActReadmit = 3;

// Bound on buffered, un-newline-terminated policy-channel input: the
// driver sends short single-line commands, so anything larger is garbage.
constexpr size_t kPolicyMaxLine = 65536;

// Broadcasts at least this large take the pipelined chain instead of the
// binomial tree.  A protocol constant: the algorithm choice must agree on
// every rank, so only nbytes/m and the pipelining-enabled switch may gate
// it — per-rank CHUNK SIZES may differ (the chain is a raw byte stream),
// but HOROVOD_RING_CHUNK_BYTES=0 (pipelining off) selects different wire
// protocols and must be uniform across ranks, as documented in socketio.h.
constexpr int64_t kBroadcastChainBytes = 1 << 20;

// Wall-clock seconds (system_clock): the abort-propagation latency spans
// PROCESSES, so the monotonic clock (per-process epoch) cannot measure it.
double WallSeconds() {
  return std::chrono::duration<double>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

}  // namespace

thread_local int64_t SocketController::current_seq_ = -1;

SocketController::SocketController(const CoreConfig& cfg)
    : Controller(cfg), cache_(cfg.cache_capacity) {
  // HOROVOD_RING_CHUNK_BYTES (0 disables pipelining; clamped to 1 GiB —
  // the u32 chunk-frame length prefix cannot carry more).  Default lives
  // on the member initializer in socket_controller.h.
  if (const char* env = ::getenv("HOROVOD_RING_CHUNK_BYTES")) {
    char* end = nullptr;
    long long v = std::strtoll(env, &end, 10);
    if (end && *end == '\0' && v >= 0) {
      ring_chunk_bytes_ = std::min<long long>(v, 1LL << 30);
    }
  }
  // HOROVOD_WIRE_COMPRESSION_MIN_BYTES: payload floor below which the
  // coordinator demotes the wire codec to none (default 64 KiB).
  if (const char* env = ::getenv("HOROVOD_WIRE_COMPRESSION_MIN_BYTES")) {
    char* end = nullptr;
    long long v = std::strtoll(env, &end, 10);
    if (end && *end == '\0' && v >= 0) wire_comp_floor_ = v;
  }
  // Metrics-plane knobs (coordinator-side straggler attribution).
  if (const char* env = ::getenv("HOROVOD_METRICS_REPORT_SECONDS")) {
    char* end = nullptr;
    double v = std::strtod(env, &end);
    if (end && *end == '\0' && v > 0) metrics_report_s_ = v;
  }
  if (const char* env = ::getenv("HOROVOD_STRAGGLER_SKEW")) {
    char* end = nullptr;
    double v = std::strtod(env, &end);
    if (end && *end == '\0' && v > 1.0) straggler_skew_ = v;
  }
  if (const char* env = ::getenv("HOROVOD_STRAGGLER_MIN_MS")) {
    char* end = nullptr;
    double v = std::strtod(env, &end);
    if (end && *end == '\0' && v >= 0) straggler_min_us_ = v * 1000.0;
  }
  // Fast-abort propagation bound: how long a rank waits for the
  // coordinator's ABORT (culprit attribution) after observing a local
  // failure, before failing with its own less-specific reason.
  if (const char* env = ::getenv("HOROVOD_ABORT_PROPAGATION_TIMEOUT")) {
    char* end = nullptr;
    double v = std::strtod(env, &end);
    if (end && *end == '\0' && v > 0) abort_timeout_s_ = v;
  }
  // Rendezvous retry policy (worker->coordinator connect): attempts and
  // the exponential-backoff base; the overall budget stays bounded by
  // kConnectTimeoutS regardless.
  if (const char* env = ::getenv("HOROVOD_RENDEZVOUS_RETRIES")) {
    char* end = nullptr;
    long long v = std::strtoll(env, &end, 10);
    if (end && *end == '\0' && v > 0) {
      rendezvous_retries_ = static_cast<int>(std::min<long long>(v, 10000));
    }
  }
  if (const char* env = ::getenv("HOROVOD_RENDEZVOUS_BACKOFF_BASE_MS")) {
    char* end = nullptr;
    long long v = std::strtoll(env, &end, 10);
    if (end && *end == '\0' && v >= 0) rendezvous_backoff_base_ms_ = v;
  }
  // Leader-tree control plane (protocol v9).  Only the COORDINATOR's mode
  // matters — its decision rides the rendezvous book — but every rank
  // parses the env for symmetry; unrecognized values behave like "auto".
  if (const char* env = ::getenv("HOROVOD_CONTROL_TREE")) {
    std::string v = env;
    if (v == "auto" || v == "on" || v == "off") {
      control_tree_mode_ = v;
    } else if (!v.empty()) {
      HVD_LOG(WARNING) << "unrecognized HOROVOD_CONTROL_TREE=" << v
                       << " (expected auto|on|off); using auto";
    }
  }
  // v12 adaptive depth.  Fanout: the per-node fan-in bound the clustering
  // pass targets (min 2 — a 1-ary tree is a chain).  Depth: 0 = auto
  // (cluster until the bound holds), else force exactly this many levels
  // (2 = the v9 flat-leader shape).  Coordinator-authoritative, like the
  // mode: the agreed values ride the rendezvous book.
  if (const char* env = ::getenv("HOROVOD_CTRL_TREE_FANOUT")) {
    char* end = nullptr;
    long long v = std::strtoll(env, &end, 10);
    if (end && *end == '\0' && v >= 2) {
      ctrl_tree_fanout_ = static_cast<int>(std::min<long long>(v, 0x800));
    } else if (*env) {
      HVD_LOG(WARNING) << "ignoring HOROVOD_CTRL_TREE_FANOUT=" << env
                       << " (expected an integer >= 2)";
    }
  }
  if (const char* env = ::getenv("HOROVOD_CONTROL_TREE_DEPTH")) {
    std::string v = env;
    if (v == "auto" || v == "0") {
      ctrl_tree_depth_ = 0;
    } else {
      char* end = nullptr;
      long long d = std::strtoll(env, &end, 10);
      if (end && *end == '\0' && d >= 2 && d <= 8) {
        ctrl_tree_depth_ = static_cast<int>(d);
      } else if (!v.empty()) {
        HVD_LOG(WARNING) << "ignoring HOROVOD_CONTROL_TREE_DEPTH=" << v
                         << " (expected auto or an integer in [2, 8])";
      }
    }
  }
  // Rendezvous acceptor shards: N threads accepting HELLOs concurrently on
  // the coordinator's listener, so a thundering herd of np connects drains
  // in parallel instead of through one serial accept loop.
  if (const char* env = ::getenv("HOROVOD_RENDEZVOUS_ACCEPTORS")) {
    char* end = nullptr;
    long long v = std::strtoll(env, &end, 10);
    if (end && *end == '\0' && v > 0) {
      rendezvous_acceptors_ = static_cast<int>(std::min<long long>(v, 64));
    }
  }
  if (is_coordinator()) {
    cluster_.resize(cfg.size);
    announce_prev_.assign(cfg.size, {0, 0});
    announce_lag_.reserve(cfg.size);
    for (int i = 0; i < cfg.size; ++i) {
      announce_lag_.push_back(std::make_unique<Histogram>());
    }
  }
}

SocketController::~SocketController() { Shutdown(); }

Status SocketController::Initialize() {
  // Frame-tag families are spaced 0x800 apart and several data-plane
  // algorithms encode a step/member index into the tag — a mesh of 0x800+
  // members would alias the next family and silently weaken the desync
  // check the tags exist for.
  if (cfg_.size >= 0x800) {
    return Status::Error(
        StatusCode::INVALID_ARGUMENT,
        "socket controller supports at most 2047 ranks (frame-tag step "
        "encoding); shard the job into process sets or hosts");
  }
  process_sets_.InitGlobal(cfg_.size);
  // Every rank owns a mesh listener on an ephemeral port; the coordinator
  // brokers the address book (the Gloo rendezvous-store analog).
  if (!data_listener_.Listen("0.0.0.0", 0)) {
    return Status::Error(StatusCode::PRECONDITION_ERROR,
                         "failed to open mesh data listener");
  }
  peer_socks_.resize(cfg_.size);
  std::vector<std::string> addrs(cfg_.size);
  std::vector<int> ports(cfg_.size, 0);
  std::vector<std::string> hosts(cfg_.size);
  ports[cfg_.rank] = data_listener_.port();
  hosts[cfg_.rank] = HostKey(cfg_.rank, cfg_.size);
  // v9: coordinator-authoritative leader-tree verdict, carried in the book.
  bool ctrl_tree_decision = false;

  if (is_coordinator()) {
    if (!listener_.Listen("0.0.0.0", cfg_.rendezvous_port)) {
      return Status::Error(StatusCode::PRECONDITION_ERROR,
                           "coordinator failed to listen on port " +
                               std::to_string(cfg_.rendezvous_port));
    }
    ctrl_socks_.resize(cfg_.size);
    // Sharded rendezvous (protocol v9): N acceptor threads drain the HELLO
    // herd concurrently off one non-blocking listener.  All book-keeping
    // happens under rv_mu; per-thread fatal findings land in rv_err and
    // stop every shard.  The worker-side exponential backoff (PR 5)
    // absorbs whatever the backlog still drops.
    const int acceptors =
        std::max(1, std::min(rendezvous_acceptors_, cfg_.size - 1));
    std::mutex rv_mu;
    std::string rv_err;
    int rv_needed = cfg_.size - 1;
    const double deadline = MonotonicSeconds() + kConnectTimeoutS;
    auto accept_shard = [&]() {
      while (true) {
        {
          std::lock_guard<std::mutex> l(rv_mu);
          if (rv_needed <= 0 || !rv_err.empty()) return;
        }
        if (MonotonicSeconds() > deadline) return;
        Socket s = listener_.Accept(0.2);
        if (!s.valid()) continue;
        // Bound the HELLO read: a connect-and-stay-silent stray must not
        // block this shard past the rendezvous deadline.
        s.SetRecvTimeout(5.0);
        std::string hello;
        if (!s.RecvFrame(&hello)) {
          HVD_LOG(WARNING) << "dropping silent/broken rendezvous connection "
                           << "from " << s.PeerAddr();
          continue;
        }
        Reader r(hello);
        int32_t magic = r.GetI32();
        if (magic != kProtocolMagic) {
          // Not one of ours (port scanner, stale client, or a pre-v2 build
          // whose HELLO starts with its rank): drop and keep waiting rather
          // than failing the whole rendezvous.
          HVD_LOG(WARNING)
              << "dropping rendezvous connection from " << s.PeerAddr()
              << " with bad protocol magic (stray client, or a worker from "
                 "an older horovod_tpu build)";
          continue;
        }
        int32_t version = r.GetI32();
        if (version != kProtocolVersion) {
          std::lock_guard<std::mutex> l(rv_mu);
          if (rv_err.empty()) {
            rv_err = "protocol version mismatch: coordinator v" +
                     std::to_string(kProtocolVersion) + ", worker v" +
                     std::to_string(version) +
                     " — all ranks must run the same horovod_tpu build";
          }
          return;
        }
        int rank = r.GetI32();
        int data_port = r.GetI32();
        std::string host_key = r.GetString();
        std::lock_guard<std::mutex> l(rv_mu);
        if (!r.ok() || rank <= 0 || rank >= cfg_.size ||
            ctrl_socks_[rank].valid()) {
          if (rv_err.empty()) rv_err = "bad HELLO from worker";
          return;
        }
        if (FaultInjectionOn()) {
          // Site rank = the REMOTE worker being accepted; drop closes its
          // connection so the worker exercises the rendezvous retry/backoff.
          FaultAction fa = FaultCheck(kFaultRendezvousAccept, rank);
          if (fa == FaultAction::kDrop || fa == FaultAction::kTruncate) {
            s.Close();
            continue;
          }
        }
        addrs[rank] = s.PeerAddr();
        ports[rank] = data_port;
        hosts[rank] = host_key;
        s.SetRecvTimeout(0);  // ctrl-channel reads are blocking again
        ctrl_socks_[rank] = std::move(s);
        --rv_needed;
      }
    };
    std::vector<std::thread> shards;
    shards.reserve(acceptors - 1);
    for (int i = 1; i < acceptors; ++i) shards.emplace_back(accept_shard);
    accept_shard();
    for (auto& t : shards) t.join();
    if (!rv_err.empty()) {
      return Status::Error(rv_err.find("mismatch") != std::string::npos
                               ? StatusCode::PRECONDITION_ERROR
                               : StatusCode::INVALID_ARGUMENT,
                           rv_err);
    }
    if (rv_needed > 0) {
      return Status::Error(StatusCode::PRECONDITION_ERROR,
                           "rendezvous timeout waiting for workers");
    }
    // Broadcast the address book over the ctrl channel.  Host keys ride
    // along so every rank sees the SAME host grouping — workers cannot
    // derive it from addresses (their view of rank 0's address differs
    // from the coordinator's own).  v9 appends the coordinator's
    // authoritative ctrl_tree verdict: divergent HOROVOD_CONTROL_TREE
    // envs cannot split the ring into mixed flat/tree halves.
    const bool tree_on = DecideCtrlTree(control_tree_mode_, hosts);
    Writer book;
    for (int rank = 0; rank < cfg_.size; ++rank) {
      book.PutString(addrs[rank]);
      book.PutI32(ports[rank]);
      book.PutString(hosts[rank]);
    }
    book.PutI32(tree_on ? 1 : 0);
    // v12: the agreed fanout/depth ride behind the verdict so divergent
    // HOROVOD_CTRL_TREE_FANOUT / HOROVOD_CONTROL_TREE_DEPTH envs cannot
    // make ranks compute different topologies.
    book.PutI32(ctrl_tree_fanout_);
    book.PutI32(ctrl_tree_depth_);
    for (int rank = 1; rank < cfg_.size; ++rank) {
      ctrl_msgs_sent_.fetch_add(1, std::memory_order_relaxed);
      ctrl_sent_.fetch_add(static_cast<int64_t>(book.data().size()),
                           std::memory_order_relaxed);
      if (!ctrl_socks_[rank].SendFrame(book.data())) {
        return Status::Error(StatusCode::PRECONDITION_ERROR,
                             "failed to send address book to rank " +
                                 std::to_string(rank));
      }
    }
    ctrl_tree_decision = tree_on;
  } else {
    // Rendezvous with exponential backoff + deterministic jitter: refused/
    // dropped connections during startup (coordinator not listening yet,
    // an accept-side injected drop) are RETRYABLE; permission and
    // address-family errors are fatal immediately so a misconfigured job
    // fails in milliseconds, not after the full connect budget.  One
    // attempt spans connect + HELLO + book — a coordinator that accepts
    // and then drops us before the book must also re-enter the loop.
    std::string book;
    bool joined = false;
    const double deadline = MonotonicSeconds() + kConnectTimeoutS;
    long long delay_ms = rendezvous_backoff_base_ms_;
    for (int attempt = 0; attempt < rendezvous_retries_; ++attempt) {
      if (MonotonicSeconds() > deadline) break;
      if (attempt > 0) {
        // Exponential up to ~1 s, minus a deterministic per-rank jitter
        // (up to half the delay) so same-host workers de-collide without
        // non-reproducible randomness.
        long long d = std::min<long long>(delay_ms, 1000);
        if (d > 0) {
          d -= static_cast<long long>(
              (static_cast<unsigned long long>(cfg_.rank) * 2654435761ULL +
               static_cast<unsigned long long>(attempt)) %
              static_cast<unsigned long long>(d / 2 + 1));
          std::this_thread::sleep_for(std::chrono::milliseconds(d));
        }
        delay_ms = std::min<long long>(delay_ms * 2, 1000);
      }
      coord_ctrl_ = Socket();
      if (!coord_ctrl_.ConnectOnce(cfg_.rendezvous_addr,
                                   cfg_.rendezvous_port)) {
        if (!ConnectErrnoRetryable(coord_ctrl_.last_errno())) {
          return Status::Error(
              StatusCode::PRECONDITION_ERROR,
              "worker cannot reach coordinator at " + cfg_.rendezvous_addr +
                  ":" + std::to_string(cfg_.rendezvous_port) + ": " +
                  std::strerror(coord_ctrl_.last_errno()) +
                  " (fatal, not retrying)");
        }
        continue;
      }
      Writer hello;
      hello.PutI32(kProtocolMagic);
      hello.PutI32(kProtocolVersion);
      hello.PutI32(cfg_.rank);
      hello.PutI32(data_listener_.port());
      hello.PutString(hosts[cfg_.rank]);
      if (!coord_ctrl_.SendFrame(hello.data())) continue;
      if (!coord_ctrl_.RecvFrame(&book)) continue;
      joined = true;
      break;
    }
    if (!joined) {
      return Status::Error(
          StatusCode::PRECONDITION_ERROR,
          "worker failed to reach coordinator at " + cfg_.rendezvous_addr +
              ":" + std::to_string(cfg_.rendezvous_port) + " within " +
              std::to_string(rendezvous_retries_) + " attempts / " +
              std::to_string(static_cast<int>(kConnectTimeoutS)) + "s");
    }
    Reader r(book);
    for (int rank = 0; rank < cfg_.size; ++rank) {
      addrs[rank] = r.GetString();
      ports[rank] = r.GetI32();
      hosts[rank] = r.GetString();
    }
    // v9 trailer: the coordinator's ctrl_tree verdict.  The worker's own
    // HOROVOD_CONTROL_TREE is advisory only — obeying the book is what
    // keeps a mixed-env job from splitting into flat and tree halves.
    ctrl_tree_decision = (r.GetI32() == 1) && r.ok();
    // v12 trailer: the agreed fanout/depth — same authority rule.
    const int32_t agreed_fanout = r.GetI32();
    const int32_t agreed_depth = r.GetI32();
    if (r.ok()) {
      ctrl_tree_fanout_ = agreed_fanout;
      ctrl_tree_depth_ = agreed_depth;
    }
    if (!r.ok()) {
      return Status::Error(StatusCode::PRECONDITION_ERROR,
                           "malformed rendezvous address book");
    }
    // Workers reach rank 0 by the address they rendezvoused through.
    addrs[0] = cfg_.rendezvous_addr;
  }

  // Keep the address book: per-process-set channel meshes dial through it
  // later (EstablishChannel).
  mesh_addrs_ = addrs;
  mesh_ports_ = ports;
  host_keys_ = hosts;
  ComputeCtrlTree(ctrl_tree_decision);
  std::vector<int> all_ranks(cfg_.size);
  for (int i = 0; i < cfg_.size; ++i) all_ranks[i] = i;
  if (!cfg_.ctrl_only) {
    // ctrl_only (C++ selftests) skips the O(n^2) data-plane mesh so an
    // in-process np=256 control-plane soak stays within fd/time budgets.
    Status s = ConnectMesh(all_ranks, /*psid=*/0, &peer_socks_);
    if (!s.ok()) return s;
    s = MaybeOpenShm(0, all_ranks);
    if (!s.ok()) return s;
    s = MaybeSetupHier(0, all_ranks);
    if (!s.ok()) return s;
  }
  Status ts = SetupCtrlTreeLinks();
  if (!ts.ok()) return ts;
  hierarchical_.store(cfg_.hierarchical, std::memory_order_relaxed);
  wire_compression_.store(cfg_.wire_compression, std::memory_order_relaxed);
  if (FlightOn()) {
    FlightRecord(kFlightRendezvous, cfg_.size, kProtocolVersion);
  }
  if (is_coordinator() && cfg_.autopilot_port > 0) {
    // Fleet-autopilot policy channel: loopback-only — the driver runs on
    // the coordinator's host, and the channel accepts decision records.
    if (!policy_listener_.Listen("127.0.0.1", cfg_.autopilot_port)) {
      HVD_LOG(WARNING) << "autopilot: failed to open policy listener on "
                          "port "
                       << cfg_.autopilot_port << "; policy channel disabled";
    } else {
      policy_stop_.store(false, std::memory_order_relaxed);
      policy_thread_ = std::thread([this] { PolicyServeLoop(); });
      HVD_LOG(INFO) << "autopilot: policy channel listening on port "
                    << policy_listener_.port();
    }
  }
  initialized_ = true;
  return Status::OK();
}

// ---- leader tree (protocol v9) --------------------------------------------

bool SocketController::DecideCtrlTree(const std::string& mode,
                                      const std::vector<std::string>& hosts) {
  if (mode == "off") return false;
  std::set<std::string> distinct(hosts.begin(), hosts.end());
  if (distinct.size() < 2) return false;  // single host: tree = pure overhead
  if (mode == "on") return true;
  // auto: multi-host AND big enough that per-rank coordinator fan-in is the
  // bottleneck worth an extra hop of latency.
  return hosts.size() >= 8;
}

void SocketController::ComputeCtrlTree(bool on) {
  tree_ = CtrlTree();
  if (!on) return;
  // Group ranks by host key in first-appearance order over rank order —
  // the SAME grouping MaybeSetupHier computes, so the ctrl tree and the
  // hierarchical data plane agree on what "a host" is.
  std::vector<std::vector<int>> groups;
  std::map<std::string, int> group_of;
  for (int r = 0; r < cfg_.size; ++r) {
    auto it = group_of.find(host_keys_[r]);
    if (it == group_of.end()) {
      group_of.emplace(host_keys_[r], static_cast<int>(groups.size()));
      groups.push_back({r});
    } else {
      groups[it->second].push_back(r);
    }
  }
  tree_.on = true;
  for (const auto& g : groups) {
    tree_.leaders.push_back(g[0]);
    if (group_of[host_keys_[cfg_.rank]] ==
        static_cast<int>(tree_.leaders.size()) - 1) {
      tree_.my_leader = g[0];
      if (g[0] == cfg_.rank) {
        tree_.my_children.assign(g.begin() + 1, g.end());
      }
    }
  }
  // v12 adaptive depth: while the coordinator would gather more than
  // `fanout` top-level nodes, partition the non-root top nodes (consecutive,
  // so clusters follow host order) into ceil(n/fanout) balanced clusters
  // and promote each cluster's lowest rank to super-leader.  Every pass
  // adds one aggregation level.  A forced depth d runs exactly d-2 passes
  // (stopping early only when a level has nothing left to cluster), so
  // HOROVOD_CONTROL_TREE_DEPTH=2 pins the v9 shape and =3 always inserts
  // one super-leader layer.  Deterministic and env-agreed, so every rank
  // computes the identical parent_of map.
  const int fanout = std::max(2, ctrl_tree_fanout_);
  std::vector<int> top = tree_.leaders;  // ascending; top[0] == 0
  int levels = 1;                        // aggregation layers so far
  while (true) {
    const int non_root = static_cast<int>(top.size()) - 1;
    const bool grow = (ctrl_tree_depth_ > 0)
                          ? (levels < ctrl_tree_depth_ - 1 && non_root > 1)
                          : (non_root > fanout);
    if (!grow) break;
    const int n_clusters = (non_root + fanout - 1) / fanout;
    std::vector<int> next = {0};
    for (int c = 0; c < n_clusters; ++c) {
      // Balanced split: cluster sizes differ by at most one.
      const int lo = 1 + static_cast<int>(
                             static_cast<int64_t>(c) * non_root / n_clusters);
      const int hi = 1 + static_cast<int>(static_cast<int64_t>(c + 1) *
                                          non_root / n_clusters);
      const int head = top[lo];
      next.push_back(head);
      for (int i = lo + 1; i < hi; ++i) tree_.parent_of[top[i]] = head;
    }
    top.swap(next);
    ++levels;
  }
  for (size_t i = 1; i < top.size(); ++i) tree_.parent_of[top[i]] = 0;
  tree_.depth = levels + 1;
  if (IsTreeLeader() && cfg_.rank != 0) {
    auto it = tree_.parent_of.find(cfg_.rank);
    tree_.parent = it == tree_.parent_of.end() ? 0 : it->second;
  }
  for (const auto& kv : tree_.parent_of) {
    if (kv.second == cfg_.rank && kv.first != cfg_.rank) {
      tree_.agg_children.push_back(kv.first);
    }
  }
  HVD_LOG(INFO) << "rank " << cfg_.rank << ": ctrl tree on, " << groups.size()
                << " hosts, depth " << tree_.depth << ", leader rank "
                << tree_.my_leader
                << (IsTreeLeader()
                        ? ", " + std::to_string(tree_.my_children.size()) +
                              " children, " +
                              std::to_string(tree_.agg_children.size()) +
                              " aggregate children, parent rank " +
                              std::to_string(cfg_.rank == 0 ? -1
                                                            : tree_.parent)
                        : "");
}

std::vector<int> SocketController::SubtreeOf(int rank) const {
  // A rank is in `rank`'s subtree when `rank` appears on its aggregation
  // path: itself -> its host leader -> parent_of chain -> coordinator.
  // O(size * depth); only walked on departure/abort paths, never per cycle.
  std::vector<int> out;
  if (!tree_.on) {
    out.push_back(rank);
    return out;
  }
  for (int r = 0; r < cfg_.size; ++r) {
    int node = r;
    // Hop from a worker to its host leader first (workers never appear in
    // parent_of; their parent is the host's first rank by construction).
    if (std::find(tree_.leaders.begin(), tree_.leaders.end(), node) ==
        tree_.leaders.end()) {
      for (int l : tree_.leaders) {
        if (host_keys_[l] == host_keys_[r]) {
          node = l;
          break;
        }
      }
    }
    bool under = (r == rank);
    int hops = 0;
    while (!under && node != 0 && hops++ <= cfg_.size) {
      if (node == rank) {
        under = true;
        break;
      }
      auto it = tree_.parent_of.find(node);
      node = it == tree_.parent_of.end() ? 0 : it->second;
    }
    if (under || node == rank) out.push_back(r);
  }
  return out;
}

void SocketController::DepartSubtree(int rank) {
  for (int r : SubtreeOf(rank)) departed_ranks_.insert(r);
}

std::vector<int> SocketController::AncestorChain(int rank) const {
  std::vector<int> out;
  if (!tree_.on || rank <= 0 || rank >= cfg_.size) return out;
  int node = rank;
  if (std::find(tree_.leaders.begin(), tree_.leaders.end(), node) ==
      tree_.leaders.end()) {
    for (int l : tree_.leaders) {
      if (host_keys_[l] == host_keys_[rank]) {
        node = l;
        break;
      }
    }
    if (node != rank && node != 0) out.push_back(node);
  }
  int hops = 0;
  while (node != 0 && hops++ <= cfg_.size) {
    auto it = tree_.parent_of.find(node);
    node = it == tree_.parent_of.end() ? 0 : it->second;
    if (node != 0) out.push_back(node);
  }
  return out;
}

Status SocketController::SetupCtrlTreeLinks() {
  if (!tree_.on) return Status::OK();
  if (is_coordinator() || cfg_.rank == tree_.my_leader) {
    // Leaders (and the coordinator, leader of host 0) accept ctrl-tree
    // HELLOs from this host's other ranks — and, v12, from downstream
    // leaders whose aggregates this node merges — on the mesh data
    // listener.  The coordinator's children of BOTH kinds keep their
    // rendezvous ctrl sockets, so it expects none here.
    int needed = static_cast<int>(tree_.my_children.size() +
                                  tree_.agg_children.size());
    if (is_coordinator()) needed = 0;
    auto expected_child = [&](int rank) {
      return std::find(tree_.my_children.begin(), tree_.my_children.end(),
                       rank) != tree_.my_children.end() ||
             std::find(tree_.agg_children.begin(), tree_.agg_children.end(),
                       rank) != tree_.agg_children.end();
    };
    // A child that finished its psid-0 mesh before this leader did may have
    // dialed already — ConnectMesh parked the unknown psid in the channel
    // stash.  Drain it before accepting fresh connections.
    if (needed > 0) {
      std::lock_guard<std::mutex> l(mesh_mu_);
      for (const auto* list : {&tree_.my_children, &tree_.agg_children}) {
        for (int c : *list) {
          auto it = pending_channel_.find({c, kCtrlTreePsid});
          if (it != pending_channel_.end()) {
            tree_child_socks_[c] = std::move(it->second);
            pending_channel_.erase(it);
            --needed;
          }
        }
      }
    }
    double deadline = MonotonicSeconds() + kConnectTimeoutS;
    while (needed > 0) {
      // A child's ctrl-tree HELLO can race a psid-0 mesh dial from the
      // same rank; ConnectMesh stashes unknown psids, and symmetrically we
      // stash a mesh HELLO... except psid-0 mesh setup already completed
      // before this call, so any arriving connection here is either a
      // ctrl-tree HELLO or a later channel dial (stash it).
      Socket s = data_listener_.Accept(1.0);
      if (!s.valid()) {
        if (MonotonicSeconds() > deadline) {
          return Status::Error(StatusCode::PRECONDITION_ERROR,
                               "ctrl-tree rendezvous timeout: leader rank " +
                                   std::to_string(cfg_.rank) + " still " +
                                   std::to_string(needed) + " children short");
        }
        continue;
      }
      s.SetRecvTimeout(5.0);
      std::string hello;
      if (!s.RecvFrame(&hello)) continue;
      Reader r(hello);
      int32_t rank = r.GetI32();
      int32_t psid = r.GetI32();
      if (!r.ok() || rank <= cfg_.rank || rank >= cfg_.size) {
        return Status::Error(StatusCode::INVALID_ARGUMENT,
                             "bad ctrl-tree HELLO at leader rank " +
                                 std::to_string(cfg_.rank));
      }
      s.SetRecvTimeout(0);
      if (psid != kCtrlTreePsid) {
        // A channel-mesh dial arriving early: park it for EstablishChannel.
        std::lock_guard<std::mutex> l(mesh_mu_);
        pending_channel_[{rank, psid}] = std::move(s);
        continue;
      }
      if (!expected_child(static_cast<int>(rank))) {
        return Status::Error(StatusCode::INVALID_ARGUMENT,
                             "ctrl-tree HELLO from rank " +
                                 std::to_string(rank) +
                                 " which is not a child of leader rank " +
                                 std::to_string(cfg_.rank));
      }
      tree_child_socks_[rank] = std::move(s);
      --needed;
    }
    // v12: a leader clustered under a super-leader dials its parent AFTER
    // its own subtree is linked up.  Dials flow strictly child -> lower-
    // ranked parent, so the chain completes bottom-up with no cycles.
    if (is_coordinator() || tree_.parent <= 0) return Status::OK();
  } else if (tree_.my_leader == 0) {
    return Status::OK();  // host-0 child: coord_ctrl_
  }
  // Dial this rank's negotiation parent (the host leader for a worker, the
  // super-leader for a clustered leader) on its mesh listener with a
  // ctrl-tree HELLO.  Child rank > parent rank always holds (the parent is
  // the first rank of its host / cluster), matching the mesh dial direction.
  const int parent = IsTreeLeader() ? tree_.parent : tree_.my_leader;
  Socket s;
  if (!s.Connect(mesh_addrs_[parent], mesh_ports_[parent],
                 kConnectTimeoutS)) {
    return Status::Error(StatusCode::PRECONDITION_ERROR,
                         "ctrl-tree connect to leader rank " +
                             std::to_string(parent) + " failed");
  }
  Writer hello;
  hello.PutI32(cfg_.rank);
  hello.PutI32(kCtrlTreePsid);
  if (!s.SendFrame(hello.data())) {
    return Status::Error(StatusCode::PRECONDITION_ERROR,
                         "ctrl-tree HELLO to leader rank " +
                             std::to_string(parent) + " failed");
  }
  tree_parent_ = std::move(s);
  return Status::OK();
}

Socket& SocketController::UpLink() {
  // The negotiation up-link: a node whose parent is a non-coordinator
  // (a tree child of a non-host-0 leader, or a v12 leader clustered under
  // a super-leader) talks to that parent; everyone else (flat mode, host-0
  // children, top-level leaders) talks straight to the coordinator.
  if (tree_.on && !is_coordinator() && tree_parent_.valid()) {
    return tree_parent_;
  }
  return coord_ctrl_;
}

Socket* SocketController::TreeChildSock(int rank) {
  if (is_coordinator() && tree_.my_leader == 0) {
    // Coordinator's own children live in ctrl_socks_ (rendezvous links).
    if (rank > 0 && rank < static_cast<int>(ctrl_socks_.size()) &&
        ctrl_socks_[rank].valid()) {
      return &ctrl_socks_[rank];
    }
    return nullptr;
  }
  auto it = tree_child_socks_.find(rank);
  if (it == tree_child_socks_.end() || !it->second.valid()) return nullptr;
  return &it->second;
}

Status SocketController::ConnectMesh(const std::vector<int>& members,
                                     int psid, std::vector<Socket>* out) {
  // Deterministic pairing: every member dials all lower members, then
  // accepts one connection from each higher member (their dials queue in
  // the listener backlog meanwhile, so the two phases cannot deadlock).
  // HELLO = [rank, psid]; psid 0 is the global init mesh, >0 a channel.
  std::lock_guard<std::mutex> mesh_lock(mesh_mu_);
  out->clear();
  out->resize(cfg_.size);
  std::set<int> member_set(members.begin(), members.end());
  for (int rank : members) {
    if (rank >= cfg_.rank) continue;
    Socket s;
    if (!s.Connect(mesh_addrs_[rank], mesh_ports_[rank], kConnectTimeoutS)) {
      return Status::Error(StatusCode::PRECONDITION_ERROR,
                           "mesh connect to rank " + std::to_string(rank) +
                               " at " + mesh_addrs_[rank] + ":" +
                               std::to_string(mesh_ports_[rank]) +
                               " (psid " + std::to_string(psid) + ") failed");
    }
    Writer hello;
    hello.PutI32(cfg_.rank);
    hello.PutI32(psid);
    if (!s.SendFrame(hello.data())) {
      return Status::Error(StatusCode::PRECONDITION_ERROR,
                           "mesh HELLO to rank " + std::to_string(rank) +
                               " failed");
    }
    (*out)[rank] = std::move(s);
  }
  int needed = 0;
  for (int rank : members) {
    if (rank <= cfg_.rank) continue;
    // Channel HELLOs may have arrived while this rank was establishing a
    // DIFFERENT channel (add_process_set call skew): drain the stash.
    auto it = pending_channel_.find({rank, psid});
    if (it != pending_channel_.end()) {
      (*out)[rank] = std::move(it->second);
      pending_channel_.erase(it);
    } else {
      ++needed;
    }
  }
  double deadline = MonotonicSeconds() + kConnectTimeoutS;
  while (needed > 0) {
    if (aborted_) {
      return Status::Error(StatusCode::ABORTED,
                           "controller shut down during mesh establishment");
    }
    if (MonotonicSeconds() > deadline) {
      return Status::Error(StatusCode::PRECONDITION_ERROR,
                           "mesh accept timeout on rank " +
                               std::to_string(cfg_.rank) + " (psid " +
                               std::to_string(psid) + ")");
    }
    Socket s = data_listener_.Accept(1.0);
    if (!s.valid()) continue;
    std::string hello;
    if (!s.RecvFrame(&hello)) continue;
    Reader r(hello);
    int rank = r.GetI32();
    int got_psid = r.GetI32();
    if (!r.ok() || rank <= cfg_.rank || rank >= cfg_.size) {
      return Status::Error(StatusCode::INVALID_ARGUMENT,
                           "bad mesh HELLO (claimed rank " +
                               std::to_string(rank) + ")");
    }
    if (got_psid != psid || !member_set.count(rank)) {
      // A dial for a channel this rank has not started establishing yet;
      // stash it for that channel's ConnectMesh.
      pending_channel_[{rank, got_psid}] = std::move(s);
      continue;
    }
    if ((*out)[rank].valid()) {
      return Status::Error(StatusCode::INVALID_ARGUMENT,
                           "duplicate mesh HELLO from rank " +
                               std::to_string(rank));
    }
    (*out)[rank] = std::move(s);
    --needed;
  }
  return Status::OK();
}

Status SocketController::EstablishChannel(int psid) {
  if (psid == 0 || cfg_.size == 1 || !initialized_) return Status::OK();
  std::vector<int> members;
  if (!process_sets_.Ranks(psid, &members)) {
    return Status::Error(StatusCode::INVALID_ARGUMENT,
                         "unknown process set " + std::to_string(psid));
  }
  if (std::find(members.begin(), members.end(), cfg_.rank) == members.end()) {
    return Status::OK();  // non-members hold no channel sockets
  }
  if (members.size() <= 1) return Status::OK();
  std::vector<Socket> socks;
  Status s = ConnectMesh(members, psid, &socks);
  if (!s.ok()) return s;
  {
    std::lock_guard<std::mutex> l(channels_mu_);
    channel_socks_[psid] = std::move(socks);
  }
  s = MaybeOpenShm(psid, members);
  if (!s.ok()) return s;
  return MaybeSetupHier(psid, members);
}

void SocketController::RemoveChannel(int psid) {
  std::lock_guard<std::mutex> l(channels_mu_);
  auto hh = hier_.find(psid);
  if (hh != hier_.end()) {
    if (hh->second.shm) hh->second.shm->Close(hh->second.local_idx == 0);
    hier_.erase(hh);
  }
  auto sh = shm_.find(psid);
  if (sh != shm_.end()) {
    std::vector<int> members;
    bool creator = process_sets_.Ranks(psid, &members) && !members.empty() &&
                   members[0] == cfg_.rank;
    sh->second->Close(creator);
    shm_.erase(sh);
  }
  auto it = channel_socks_.find(psid);
  if (it == channel_socks_.end()) return;
  for (auto& s : it->second) s.Close();
  channel_socks_.erase(it);
}

std::vector<Socket>& SocketController::SocksFor(int psid) {
  if (psid == 0) return peer_socks_;
  std::lock_guard<std::mutex> l(channels_mu_);
  auto it = channel_socks_.find(psid);
  // Map nodes are pointer-stable; a channel is only erased by
  // RemoveChannel, which the contract forbids while ops are in flight.
  return it == channel_socks_.end() ? peer_socks_ : it->second;
}

void SocketController::Farewell() {
  if (!initialized_ || aborted_) return;
  Writer w;
  w.PutI32(-1);  // BYE sentinel in the cycle-frame position
  if (is_coordinator()) {
    // The farewell DOWN to workers stays a bare [-1]: it rides the
    // RESPONSES position, where nothing parses past the sentinel.
    for (int rank = 1; rank < cfg_.size; ++rank) {
      if (ctrl_socks_[rank].valid() && !departed_ranks_.count(rank)) {
        ctrl_socks_[rank].SendFrame(w.data());
      }
    }
    return;
  }
  if (IsTreeLeader()) {
    // Release this host's children first ([-1] in the responses
    // position, same frame the coordinator's farewell would produce), so
    // none of them blocks on a leader that is about to close its links.
    FanDownToChildren(w.data(), nullptr);
  }
  // v11: the BYE UP the gather topology carries this rank's FINAL
  // cumulative sketch — captured here, after the last cycle's response
  // handling observed its waits — so a coordinator still cycling folds in
  // exactly what this rank's own metrics dump is about to record.  A
  // leader ships the whole host's sum: its own fresh capture plus every
  // child's last-known sketch (final, when the child BYEd through it).
  if (MetricsOn() && FleetTelemetryOn()) {
    FleetSketch own;
    own.CaptureLocal();
    if (IsTreeLeader()) {
      tree_child_sketches_[cfg_.rank] = std::move(own);
      FleetSketch host_sum;
      for (const auto& kv : tree_child_sketches_) host_sum.Merge(kv.second);
      w.PutString(host_sum.Encode());
    } else {
      w.PutString(own.Encode());
    }
  } else {
    w.PutString("");
  }
  UpLink().SendFrame(w.data());  // best effort; a leader forwards it up
}

void SocketController::Shutdown() {
  // The policy thread may exist even when Initialize failed later on, so
  // stop it before the initialized_ gate below.
  policy_stop_.store(true, std::memory_order_relaxed);
  if (policy_thread_.joinable()) policy_thread_.join();
  policy_listener_.Close();
  if (!initialized_) return;
  initialized_ = false;
  aborted_ = true;
  {
    // Expire any WaitAbortReason waiters: no ABORT is coming once the
    // sockets close, and teardown must not serve the propagation timeout.
    std::lock_guard<std::mutex> l(abort_mu_);
    abort_wait_deadline_ = -1;
  }
  abort_cv_.notify_all();
  coord_ctrl_.Close();
  tree_parent_.Close();
  for (auto& kv : tree_child_socks_) kv.second.Close();
  for (auto& s : ctrl_socks_) s.Close();
  for (auto& s : peer_socks_) s.Close();
  {
    std::lock_guard<std::mutex> l(channels_mu_);
    for (auto& kv : shm_) {
      std::vector<int> members;
      bool creator = process_sets_.Ranks(kv.first, &members) &&
                     !members.empty() && members[0] == cfg_.rank;
      kv.second->Close(creator);
    }
    shm_.clear();
    for (auto& kv : hier_) {
      if (kv.second.shm) kv.second.shm->Close(kv.second.local_idx == 0);
    }
    hier_.clear();
    for (auto& kv : channel_socks_)
      for (auto& s : kv.second) s.Close();
    channel_socks_.clear();
  }
  {
    // aborted_ is already set, so any in-flight ConnectMesh exits its
    // accept loop promptly and releases mesh_mu_.
    std::lock_guard<std::mutex> l(mesh_mu_);
    for (auto& kv : pending_channel_) kv.second.Close();
    pending_channel_.clear();
  }
  listener_.Close();
  data_listener_.Close();
}

// ---------------------------------------------------------------------------
// Negotiation
// ---------------------------------------------------------------------------

Status SocketController::ComputeResponses(
    std::vector<TensorRequest>& new_requests, std::vector<Response>* out) {
  if (aborted_) {
    // An executor lane observed a data-plane failure before the control
    // plane did.  Workers send a best-effort failure FIN and await the
    // coordinator's ABORT so the error names the culprit; the coordinator
    // sweeps its ctrl sockets for one and broadcasts.  Clean teardown
    // (farewell/Shutdown) keeps the plain fast path.
    if (peer_shutdown_ || !initialized_) {
      return Status::Error(StatusCode::ABORTED, "controller down");
    }
    return is_coordinator() ? CoordinatorAbortSweep()
                            : WorkerAbortHandshake();
  }
  const Status st = is_coordinator() ? CoordinatorCycle(new_requests, out)
                    : IsTreeLeader() ? LeaderCycle(new_requests, out)
                                     : WorkerCycle(new_requests, out);
  if (FlightOn() && st.ok() && !out->empty()) {
    // Negotiation verdict: how many responses this cycle fused, and the
    // data-op seq the plane advanced to (every rank records the same pair).
    FlightRecord(kFlightVerdict, static_cast<int32_t>(out->size()),
                 seq_counter_);
  }
  return st;
}

// ---------------------------------------------------------------------------
// Fast-abort propagation (protocol v8)
// ---------------------------------------------------------------------------

void SocketController::SetAbortReason(const std::string& reason) {
  {
    std::lock_guard<std::mutex> l(abort_mu_);
    if (abort_reason_.empty()) abort_reason_ = reason;
  }
  abort_cv_.notify_all();
}

std::string SocketController::AbortReason() {
  std::lock_guard<std::mutex> l(abort_mu_);
  return abort_reason_;
}

std::string SocketController::WaitAbortReason() {
  std::unique_lock<std::mutex> l(abort_mu_);
  if (!abort_reason_.empty()) return abort_reason_;
  // The wait budget is charged ONCE, at the first waiter: stacked executor
  // lanes blocking here serially must not multiply the propagation bound.
  if (abort_wait_deadline_ == 0) {
    abort_wait_deadline_ = MonotonicSeconds() + abort_timeout_s_;
  }
  while (abort_reason_.empty()) {
    const double left = abort_wait_deadline_ - MonotonicSeconds();
    if (left <= 0) break;
    abort_cv_.wait_for(l, std::chrono::duration<double>(left));
  }
  return abort_reason_;
}

Status SocketController::BroadcastAbortAndFail(int culprit_rank,
                                               const std::string& why) {
  aborted_ = true;
  std::string culprit_host;
  if (culprit_rank >= 0 &&
      culprit_rank < static_cast<int>(host_keys_.size())) {
    culprit_host = host_keys_[culprit_rank];
  }
  std::string msg = "collective aborted: " + why;
  if (culprit_rank >= 0) {
    msg += " (culprit rank " + std::to_string(culprit_rank) + ", host " +
           (culprit_host.empty() ? "?" : culprit_host) + ")";
  }
  if (!abort_broadcast_done_) {
    abort_broadcast_done_ = true;
    Writer w;
    w.PutI32(-2);  // ABORT sentinel in the responses position
    w.PutI32(kTagAbort);
    w.PutString(why);
    w.PutI32(culprit_rank);
    w.PutString(culprit_host);
    w.PutF64(WallSeconds());
    int notified = 0;
    for (int rank = 1; rank < cfg_.size; ++rank) {
      if (rank == culprit_rank || departed_ranks_.count(rank)) continue;
      if (!ctrl_socks_[rank].valid()) continue;
      if (ctrl_socks_[rank].SendFrame(w.data())) ++notified;
    }
    if (MetricsOn()) {
      GlobalMetrics().aborts_total.fetch_add(1, std::memory_order_relaxed);
    }
    HVD_LOG(ERROR) << "broadcast ABORT to " << notified
                   << " survivors: " << msg;
    SetAbortReason(msg);
    if (FlightOn()) {
      FlightRecord(kFlightAbort, culprit_rank, 1);  // b=1: we broadcast it
      // Forensics strictly AFTER the broadcast: survivors are already
      // unblocked, so digest collection spends the abort budget on the
      // coordinator alone and never widens the propagation bound.
      if (!FlightPostmortemDir().empty()) {
        CollectFlightDigests(MonotonicSeconds() + abort_timeout_s_);
        WritePostmortem(culprit_rank, culprit_host, msg);
      }
      FlightDumpToFile();
    }
  }
  return Status::Error(StatusCode::ABORTED, msg);
}

Status SocketController::HandleAbortFrame(Reader* rd) {
  aborted_ = true;
  got_abort_ = true;
  const int32_t tag = rd->GetI32();
  std::string why = rd->GetString();
  const int32_t culprit = rd->GetI32();
  const std::string host = rd->GetString();
  const double sent_ts = rd->GetF64();
  if (!rd->ok() || tag != kTagAbort) {
    const std::string msg = "malformed ABORT frame from coordinator";
    SetAbortReason(msg);
    return Status::Error(StatusCode::ABORTED, msg);
  }
  if (MetricsOn()) {
    auto& m = GlobalMetrics();
    m.aborts_total.fetch_add(1, std::memory_order_relaxed);
    // Cross-process latency: wall clock, clamped (hosts may skew).
    m.abort_propagation_us.ObserveSeconds(
        std::max(0.0, WallSeconds() - sent_ts));
  }
  std::string msg = "aborted by coordinator: " + why;
  if (culprit >= 0) {
    msg += " (culprit rank " + std::to_string(culprit) + ", host " +
           (host.empty() ? "?" : host) + ")";
  }
  SetAbortReason(msg);
  if (FlightOn()) {
    FlightRecord(kFlightAbort, culprit, 0);  // b=0: observed, not broadcast
    // Answer the coordinator's forensics solicitation: last-N digest up
    // the tree (leaders go direct), then relay any child digests, then
    // drop this rank's own black box.  All best-effort — the ABORTED
    // status below is already decided.
    SendFlightDigest(tree_parent_.valid() ? tree_parent_ : coord_ctrl_);
    ForwardChildDigests();
    FlightDumpToFile();
  }
  return Status::Error(StatusCode::ABORTED, msg);
}

Status SocketController::WorkerAbortHandshake() {
  {
    std::lock_guard<std::mutex> l(abort_mu_);
    if (!abort_reason_.empty()) {
      return Status::Error(StatusCode::ABORTED, abort_reason_);
    }
  }
  if (got_abort_ || !coord_ctrl_.valid()) {
    return Status::Error(StatusCode::ABORTED, "controller down");
  }
  if (!fin_sent_) {
    fin_sent_ = true;
    Writer w;
    w.PutI32(-2);  // failure FIN in the cycle-frame position
    w.PutString("rank " + std::to_string(cfg_.rank) +
                " observed a data-plane failure");
    w.PutI32(cfg_.rank);  // v9: explicit culprit so leaders forward losslessly
    // Up the tree AND direct to the coordinator: if this rank's leader is
    // the thing that died, the direct path still attributes the failure.
    if (tree_parent_.valid()) tree_parent_.SendFrame(w.data());
    coord_ctrl_.SendFrame(w.data());  // best effort
    if (FlightOn()) {
      // The digest rides right behind the FIN on the same link: the
      // coordinator's post-broadcast collection drains it from the
      // already-open socket, so the culprit's own last events (the most
      // valuable ones) make the postmortem too.
      SendFlightDigest(tree_parent_.valid() ? tree_parent_ : coord_ctrl_);
    }
  }
  // Drain the ctrl channels toward the coordinator's ABORT, bounded by the
  // propagation timeout.  Stale RESPONSES frames from the cycle in flight
  // when the failure hit are discarded.  The ABORT may arrive direct
  // (coord_ctrl_) or forwarded by this rank's leader (tree_parent_); a
  // leader running this handshake fans every terminal frame down to its
  // children before acting on it, so the subtree never waits out the
  // timeout just because its leader learned first.
  const double deadline = MonotonicSeconds() + abort_timeout_s_;
  while (MonotonicSeconds() < deadline) {
    pollfd pfds[2];
    Socket* socks[2];
    nfds_t npfd = 0;
    if (coord_ctrl_.valid()) {
      pfds[npfd] = pollfd{coord_ctrl_.fd(), POLLIN, 0};
      socks[npfd++] = &coord_ctrl_;
    }
    if (tree_parent_.valid()) {
      pfds[npfd] = pollfd{tree_parent_.fd(), POLLIN, 0};
      socks[npfd++] = &tree_parent_;
    }
    if (npfd == 0) break;
    const int rc = ::poll(pfds, npfd, 200);
    if (rc < 0) {
      if (errno == EINTR) continue;
      break;
    }
    if (rc == 0) continue;
    bool any_dead = false;
    for (nfds_t i = 0; i < npfd; ++i) {
      if (!(pfds[i].revents & (POLLIN | POLLHUP | POLLERR))) continue;
      std::string frame;
      if (!socks[i]->RecvFrame(&frame)) {
        socks[i]->Close();
        // The direct coordinator link dying means no ABORT is coming.
        if (socks[i] == &coord_ctrl_) any_dead = true;
        continue;
      }
      Reader rd(frame);
      const int32_t n = rd.GetI32();
      if (n == -1) {
        FanDownToChildren(frame, nullptr);
        peer_shutdown_ = true;
        const std::string msg = "coordinator shut down the job";
        SetAbortReason(msg);
        return Status::Error(StatusCode::ABORTED, msg);
      }
      if (n == -2) {
        FanDownToChildren(frame, nullptr);
        return HandleAbortFrame(&rd);
      }
    }
    if (any_dead) break;
  }
  const std::string msg =
      "data-plane failure on rank " + std::to_string(cfg_.rank) +
      " (no coordinator ABORT within " + std::to_string(abort_timeout_s_) +
      "s)";
  SetAbortReason(msg);
  // No ABORT ever arrived — the coordinator may be the thing that died.
  // Leave this rank's black box behind anyway.
  if (FlightOn()) FlightDumpToFile();
  return Status::Error(StatusCode::ABORTED, msg);
}

Status SocketController::CoordinatorAbortSweep() {
  {
    std::lock_guard<std::mutex> l(abort_mu_);
    if (!abort_reason_.empty()) {
      return Status::Error(StatusCode::ABORTED, abort_reason_);
    }
  }
  if (abort_broadcast_done_) {
    return Status::Error(StatusCode::ABORTED, "controller down");
  }
  // Find the culprit: poll the live ctrl sockets for a failure FIN or a
  // dead connection, bounded by the propagation timeout.  Normal CYCLE
  // frames from ranks that have not noticed yet are discarded — the job
  // is aborting either way.
  int culprit = -1;
  std::string why;
  const double deadline = MonotonicSeconds() + abort_timeout_s_;
  while (culprit < 0 && MonotonicSeconds() < deadline) {
    std::vector<pollfd> pfds;
    std::vector<int> ranks;
    for (int rank = 1; rank < cfg_.size; ++rank) {
      if (departed_ranks_.count(rank) || !ctrl_socks_[rank].valid()) continue;
      pfds.push_back(pollfd{ctrl_socks_[rank].fd(), POLLIN, 0});
      ranks.push_back(rank);
    }
    if (pfds.empty()) break;
    const int rc = ::poll(pfds.data(), static_cast<nfds_t>(pfds.size()), 200);
    if (rc < 0) {
      if (errno == EINTR) continue;
      break;
    }
    if (rc == 0) continue;
    for (size_t i = 0; i < pfds.size() && culprit < 0; ++i) {
      if (!(pfds[i].revents & (POLLIN | POLLHUP | POLLERR))) continue;
      const int rank = ranks[i];
      std::string frame;
      if (!ctrl_socks_[rank].RecvFrame(&frame)) {
        culprit = rank;
        why = "lost connection to rank " + std::to_string(rank);
        break;
      }
      Reader rd(frame);
      const int32_t n_cached = rd.GetI32();
      if (n_cached == -2) {  // failure FIN
        culprit = rank;
        why = rd.GetString();
        if (!rd.ok() || why.empty()) {
          why = "rank " + std::to_string(rank) + " reported a failure";
        }
        // v9: an explicit culprit trailer — a leader forwarding a child's
        // FIN is the SENDER but not the culprit.
        const int32_t c = rd.GetI32();
        if (rd.ok() && c >= 0 && c < cfg_.size) culprit = c;
        break;
      }
      if (n_cached == -1) departed_ranks_.insert(rank);
      // A digest racing the FIN (another rank noticed an ABORT first, or a
      // leader forwarded a child's): stash it now, before the broadcast.
      if (n_cached == -4) StashFlightDigest(&rd);
      // n_cached == -3 (a leader's aggregate from the cycle in flight) and
      // plain CYCLE frames are equally stale here: discard and keep polling.
    }
  }
  if (culprit < 0) why = "coordinator observed a local failure";
  return BroadcastAbortAndFail(culprit, why);
}

// ---------------------------------------------------------------------------
// Abort-time forensics (flight recorder; flight_recorder.h)
// ---------------------------------------------------------------------------

void SocketController::SendFlightDigest(Socket& sock) {
  if (digest_sent_ || !FlightOn() || !sock.valid()) return;
  digest_sent_ = true;
  std::vector<FlightEvent> tail;
  FlightTail(kFlightDigestEvents, &tail);
  Writer w;
  w.PutI32(-4);  // digest sentinel in the cycle-frame position
  w.PutI32(kTagFlightDigest);
  w.PutI32(cfg_.rank);
  w.PutI32(static_cast<int32_t>(tail.size()));
  for (const auto& ev : tail) {
    w.PutI64(ev.ts_us);
    w.PutI64(static_cast<int64_t>(ev.seq));
    w.PutI32(ev.type);
    w.PutI32(ev.tid);
    w.PutI32(ev.a);
    w.PutI64(ev.b);
  }
  sock.SendFrame(w.data());  // best effort: forensics never block the abort
}

bool SocketController::StashFlightDigest(Reader* rd) {
  const int32_t tag = rd->GetI32();
  const int32_t rank = rd->GetI32();
  const int32_t n = rd->GetI32();
  if (!rd->ok() || tag != kTagFlightDigest || rank < 0 ||
      rank >= cfg_.size || n < 0 || n > kFlightDigestEvents) {
    return false;
  }
  std::vector<FlightEvent> evs;
  evs.reserve(static_cast<size_t>(n));
  for (int32_t i = 0; i < n; ++i) {
    FlightEvent ev;
    ev.ts_us = rd->GetI64();
    ev.seq = static_cast<uint64_t>(rd->GetI64());
    ev.type = rd->GetI32();
    ev.tid = rd->GetI32();
    ev.a = rd->GetI32();
    ev.b = rd->GetI64();
    evs.push_back(ev);
  }
  if (!rd->ok()) return false;
  if (FlightOn()) {
    FlightRecord(kFlightDigest, rank, static_cast<int64_t>(evs.size()));
  }
  flight_digests_[rank] = std::move(evs);
  return true;
}

void SocketController::CollectFlightDigests(double deadline) {
  // Poll until the deadline or every reachable rank has reported.  A
  // rank's digest may arrive on any of its ANCESTORS' sockets (each relay
  // hop lands the forwarded frame on the relaying leader's own rendezvous
  // link — v12 trees relay through super-leaders too), so completion
  // counts ranks reported — never sockets drained — and every ancestor's
  // socket stays in the poll set while any rank below it is still
  // outstanding, even after that ancestor's own digest landed.
  while (MonotonicSeconds() < deadline) {
    std::set<int> poll_ranks;  // socket owners worth polling this round
    int outstanding = 0;
    for (int rank = 1; rank < cfg_.size; ++rank) {
      if (departed_ranks_.count(rank) || flight_digests_.count(rank)) {
        continue;
      }
      bool reachable = false;
      if (ctrl_socks_[rank].valid()) {
        poll_ranks.insert(rank);
        reachable = true;
      }
      // Host-0 children (leader 0 = the coordinator itself) only have
      // their direct sockets; remote ranks may report via any live
      // ancestor (host leader, then each super-leader above it).
      for (int l : AncestorChain(rank)) {
        if (l > 0 && l != rank && ctrl_socks_[l].valid()) {
          poll_ranks.insert(l);
          reachable = true;
        }
      }
      if (reachable) ++outstanding;  // unreachable: don't charge budget
    }
    if (outstanding == 0 || poll_ranks.empty()) return;
    std::vector<pollfd> pfds;
    std::vector<int> ranks;
    for (int rank : poll_ranks) {
      pfds.push_back(pollfd{ctrl_socks_[rank].fd(), POLLIN, 0});
      ranks.push_back(rank);
    }
    const double left = deadline - MonotonicSeconds();
    const int wait_ms =
        std::max(10, std::min(200, static_cast<int>(left * 1000)));
    const int rc =
        ::poll(pfds.data(), static_cast<nfds_t>(pfds.size()), wait_ms);
    if (rc < 0) {
      if (errno == EINTR) continue;
      return;
    }
    if (rc == 0) continue;
    for (size_t i = 0; i < pfds.size(); ++i) {
      if (!(pfds[i].revents & (POLLIN | POLLHUP | POLLERR))) continue;
      const int rank = ranks[i];
      std::string frame;
      if (!ctrl_socks_[rank].RecvFrame(&frame)) {
        // The culprit (or another casualty) died before answering: close
        // so the next poll round stops charging the budget to it.
        ctrl_socks_[rank].Close();
        continue;
      }
      Reader rd(frame);
      const int32_t n = rd.GetI32();
      if (n == -4) {
        StashFlightDigest(&rd);
      } else if (n == -1) {
        departed_ranks_.insert(rank);
      }
      // Anything else (stale CYCLE/aggregate/FIN frames from the dying
      // cycle) is discarded: the broadcast already went out.
    }
  }
}

void SocketController::ForwardChildDigests() {
  // Relay upward on this node's own up-link: a host leader goes direct to
  // the coordinator (or, v12, to its super-leader, which relays again), so
  // every digest eventually lands on a rendezvous socket the coordinator
  // polls.
  Socket& up = UpLink();
  if (tree_child_socks_.empty() || !up.valid()) return;
  // Children received the fanned-down ABORT moments ago and answer within
  // milliseconds; cap the relay window well inside the abort budget so a
  // mute child never delays this leader's own teardown.
  const double deadline =
      MonotonicSeconds() + std::min(0.5, abort_timeout_s_ * 0.25);
  std::set<int> done;
  while (MonotonicSeconds() < deadline) {
    std::vector<pollfd> pfds;
    std::vector<int> ranks;
    for (auto& [rank, sock] : tree_child_socks_) {
      if (done.count(rank) || tree_departed_children_.count(rank)) continue;
      if (!sock.valid()) continue;
      pfds.push_back(pollfd{sock.fd(), POLLIN, 0});
      ranks.push_back(rank);
    }
    if (pfds.empty()) return;
    const int rc = ::poll(pfds.data(), static_cast<nfds_t>(pfds.size()), 50);
    if (rc < 0) {
      if (errno == EINTR) continue;
      return;
    }
    if (rc == 0) continue;
    for (size_t i = 0; i < pfds.size(); ++i) {
      if (!(pfds[i].revents & (POLLIN | POLLHUP | POLLERR))) continue;
      const int rank = ranks[i];
      Socket* cs = TreeChildSock(rank);
      std::string frame;
      if (cs == nullptr || !cs->RecvFrame(&frame)) {
        done.insert(rank);
        continue;
      }
      Reader rd(frame);
      if (rd.GetI32() == -4) {
        up.SendFrame(frame);  // verbatim relay, best effort
        done.insert(rank);
      }
      // Stale frames (the child's in-flight CYCLE, an already-handled FIN)
      // are discarded; keep waiting for its digest until the window ends.
    }
  }
}

void SocketController::WritePostmortem(int culprit_rank,
                                       const std::string& culprit_host,
                                       const std::string& why) {
  const std::string dir = FlightPostmortemDir();
  if (dir.empty()) return;
  // The coordinator's own tail joins the collected digests so rank 0
  // appears in the merged view like everyone else.
  std::vector<FlightEvent> own;
  FlightTail(kFlightDigestEvents, &own);
  std::string out;
  out.reserve(1 << 16);
  out += "{\"schema\":\"hvd-postmortem-v1\"";
  out += ",\"protocol_version\":" + std::to_string(kProtocolVersion);
  out += ",\"world_size\":" + std::to_string(cfg_.size);
  out += ",\"abort_wall_time\":" + std::to_string(WallSeconds());
  out += ",\"culprit_rank\":" + std::to_string(culprit_rank);
  out += ",\"culprit_host\":\"" + JsonEscape(culprit_host) + "\"";
  out += ",\"reason\":\"" + JsonEscape(why) + "\"";
  out += ",\"types\":";
  out += FlightTypesLegend();
  // Per-rank last-seen negotiation state from the v7 metrics snapshots —
  // which cycle each rank had reached when it last reported.
  {
    std::lock_guard<std::mutex> l(metrics_mu_);
    if (!cluster_.empty()) {
      out += ",\"last_seen_cycles\":{";
      bool first = true;
      for (size_t r = 0; r < cluster_.size(); ++r) {
        if (cluster_[r].updated_at == 0) continue;
        if (!first) out += ",";
        first = false;
        out += "\"" + std::to_string(r) +
               "\":" + std::to_string(cluster_[r].cycle_count);
      }
      out += "}";
    }
  }
  out += ",\"ranks\":{";
  auto emit_rank = [&](int rank, const char* source,
                       const std::vector<FlightEvent>& evs, bool first) {
    if (!first) out += ",";
    std::string host =
        rank < static_cast<int>(host_keys_.size()) ? host_keys_[rank] : "";
    out += "\"" + std::to_string(rank) + "\":{\"source\":\"" + source +
           "\",\"host\":\"" + JsonEscape(host) + "\"";
    if (!evs.empty()) {
      out += ",\"last_ts_us\":" + std::to_string(evs.back().ts_us);
      out += ",\"last_seq\":" + std::to_string(evs.back().seq);
    }
    out += ",\"events\":[";
    bool fe = true;
    for (const auto& ev : evs) {
      if (!fe) out += ",";
      fe = false;
      out += "[" + std::to_string(ev.ts_us) + "," + std::to_string(ev.seq) +
             "," + std::to_string(ev.type) + "," + std::to_string(ev.tid) +
             "," + std::to_string(ev.a) + "," + std::to_string(ev.b) + "]";
    }
    out += "]}";
  };
  emit_rank(cfg_.rank, "local", own, true);
  std::vector<int> missing;
  for (int rank = 1; rank < cfg_.size; ++rank) {
    auto it = flight_digests_.find(rank);
    if (it != flight_digests_.end()) {
      emit_rank(rank, "digest", it->second, false);
    } else if (!departed_ranks_.count(rank)) {
      missing.push_back(rank);
    }
  }
  out += "}";
  out += ",\"missing_ranks\":[";
  for (size_t i = 0; i < missing.size(); ++i) {
    if (i) out += ",";
    out += std::to_string(missing[i]);
  }
  out += "]}";
  // tmp + rename: tooling polling the directory never reads a partial
  // bundle (same contract as the per-rank flight dumps).
  const std::string path = dir + "/postmortem.json";
  const std::string tmp = path + ".tmp";
  std::FILE* f = std::fopen(tmp.c_str(), "w");
  if (f == nullptr) return;
  std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  std::rename(tmp.c_str(), path.c_str());
  HVD_LOG(ERROR) << "postmortem bundle written: " << path << " ("
                 << flight_digests_.size() << " digests, "
                 << missing.size() << " missing)";
}

void SocketController::Announce(int rank, TensorRequest req,
                                std::vector<Response>* errors) {
  // A name the coordinator recently failed: a rank still owed that error
  // (it had not announced when the failure was emitted) gets it now
  // instead of forming a pending entry that waits forever on ranks that
  // already moved on.  Ranks that have seen the error and announce the
  // name again are fresh, consistent resubmissions and fall through to
  // the normal path.  This check runs before any join bookkeeping so a
  // dead join round cannot re-register the announcer as joined.
  auto tomb = error_tombstones_.find(req.name);
  if (tomb != error_tombstones_.end() &&
      MonotonicSeconds() < tomb->second.expiry &&
      tomb->second.owed.count(rank)) {
    Response e;
    e.op = req.op;
    e.error = tomb->second.error;
    e.target_rank = rank;  // others may have resubmitted this name
    e.names.push_back(req.name);
    e.metas.push_back(req);
    errors->push_back(std::move(e));
    tomb->second.owed.erase(rank);
    if (tomb->second.owed.empty()) error_tombstones_.erase(tomb);
    return;
  }
  // hvd.join(): mark the rank as contributing zeros to every collective
  // until all ranks have joined (reference: JoinOp / the joined-rank
  // wildcard in ComputeResponseList).  The JOIN request itself still goes
  // through the normal pending table (fixed name => ready when the last
  // rank joins).
  if (req.op == OpType::JOIN) {
    joined_ranks_.insert(rank);
    last_joined_ = rank;
  }
  // Process-set registration happens on each rank's Python thread and may
  // race announcements arriving from faster ranks; an unknown process set
  // is therefore *deferred* (the tensor stays pending until the local
  // registration lands), not an error.  Membership is validated once the
  // set is known, at readiness-check time.
  std::vector<int> members;
  if (process_sets_.Ranks(req.process_set_id, &members) &&
      !std::binary_search(members.begin(), members.end(), rank)) {
    Response e;
    e.op = req.op;
    e.error = "rank " + std::to_string(rank) +
              " is not in process set of tensor " + req.name;
    e.names.push_back(req.name);
    e.metas.push_back(req);
    errors->push_back(std::move(e));
    return;
  }
  auto it = pending_.find(req.name);
  if (it == pending_.end()) {
    Pending p;
    p.meta = req;
    p.order = arrival_counter_++;
    p.first_seen = MonotonicSeconds();
    p.announced.insert(rank);
    pending_.emplace(req.name, std::move(p));
    RecordAnnounceLag(rank, 0.0);  // first announcer defines t=0
    return;
  }
  // Cross-rank consistency validation (reference: ComputeResponseList's
  // error construction for mismatched shapes/dtypes).
  Pending& p = it->second;
  std::string mismatch;
  if (p.meta.op != req.op) {
    mismatch = "operation type";
  } else if (p.meta.dtype != req.dtype) {
    mismatch = "dtype";
  } else if (p.meta.reduce_op != req.reduce_op) {
    mismatch = "reduce op";
  } else if (p.meta.process_set_id != req.process_set_id) {
    mismatch = "process set";
  } else if (p.meta.root_rank != req.root_rank) {
    mismatch = "root rank";
  } else if (p.meta.prescale != req.prescale ||
             p.meta.postscale != req.postscale) {
    mismatch = "scale factors";
  } else if (p.meta.group_key != req.group_key ||
             p.meta.group_size != req.group_size) {
    mismatch = "group membership";
  } else if (req.op == OpType::ALLREDUCE || req.op == OpType::BROADCAST ||
             req.op == OpType::REDUCESCATTER) {
    if (p.meta.shape != req.shape) mismatch = "shape";
  } else if (req.op == OpType::ALLGATHER || req.op == OpType::ALLTOALL) {
    // first dim may differ per rank; trailing dims must match
    if (std::vector<int64_t>(p.meta.shape.begin() +
                                 (p.meta.shape.empty() ? 0 : 1),
                             p.meta.shape.end()) !=
        std::vector<int64_t>(req.shape.begin() + (req.shape.empty() ? 0 : 1),
                             req.shape.end())) {
      mismatch = "trailing shape";
    }
  }
  if (!mismatch.empty()) {
    Response e;
    e.op = req.op;
    e.error = "Mismatched " + mismatch + " for tensor " + req.name +
              " across ranks";
    e.names.push_back(req.name);
    e.metas.push_back(p.meta);
    // The announcing rank receives this error through the cycle broadcast
    // (its handle maps by name) — it is informed, not owed a tombstone.
    std::set<int> informed = p.announced;
    informed.insert(rank);
    AddTombstone(req.name, e.error, informed);
    errors->push_back(std::move(e));
    pending_.erase(it);
    return;
  }
  // Device-plane coherence: the response's plane is the AND of every
  // rank's capability bit — deliberately NOT a mismatch error (a host
  // numpy on one rank simply demotes the collective to the host plane).
  p.meta.device = p.meta.device & req.device;
  if (p.announced.insert(rank).second) {
    // How long after the tensor's first announcement this rank's own
    // arrived: the culprit-side signal the straggler report ranks by.
    RecordAnnounceLag(rank, MonotonicSeconds() - p.first_seen);
  }
}

void SocketController::AddTombstone(const std::string& name,
                                    const std::string& error,
                                    const std::set<int>& already_informed) {
  std::vector<int> members;
  // Owed = process-set members that had not announced when the error was
  // emitted (their announce may still be in flight, or they may be
  // stragglers).  Ranks that announced get the error via their handles.
  auto it = pending_.find(name);
  int psid = it != pending_.end() ? it->second.meta.process_set_id : 0;
  if (!process_sets_.Ranks(psid, &members)) return;
  Tombstone t;
  t.error = error;
  t.expiry = MonotonicSeconds() + 60.0;
  for (int m : members) {
    if (!already_informed.count(m)) t.owed.insert(m);
  }
  if (!t.owed.empty()) error_tombstones_[name] = std::move(t);
}

Status SocketController::CoordinatorCycle(
    std::vector<TensorRequest>& new_requests, std::vector<Response>* out) {
  std::vector<Response> errors;
  // Sweep expired tombstones (bounded memory on long-running jobs).
  for (auto it = error_tombstones_.begin(); it != error_tombstones_.end();) {
    if (MonotonicSeconds() >= it->second.expiry) {
      it = error_tombstones_.erase(it);
    } else {
      ++it;
    }
  }
  // Own announcements first (deterministic: coordinator, then source order).
  for (auto& r : new_requests) Announce(0, std::move(r), &errors);
  // Gather sources.  Flat: every worker.  Tree: this host's children
  // (individual frames) plus the coordinator's aggregate children ([-3]
  // frames) — at depth 2 those are all other hosts' leaders (v9); at v12
  // depth >= 3 only the top-level super-leaders, which keeps coordinator
  // fan-in <= fanout at any host count.
  std::vector<int> sources;
  if (tree_.on) {
    sources = tree_.my_children;
    for (int l : tree_.agg_children) sources.push_back(l);
  } else {
    for (int rank = 1; rank < cfg_.size; ++rank) sources.push_back(rank);
  }
  for (int rank : sources) {
    if (departed_ranks_.count(rank)) continue;
    const bool is_leader_src =
        tree_.on && std::find(tree_.leaders.begin(), tree_.leaders.end(),
                              rank) != tree_.leaders.end();
    if (FaultInjectionOn()) {
      // Site rank = the REMOTE peer whose frame is being gathered; closing
      // its ctrl socket makes the recv below fail like a death.  In tree
      // mode the coordinator doubles as host 0's leader, so its own-host
      // children are leader-recv sites; remote leaders stay
      // coordinator-recv.
      const FaultSite site = (tree_.on && !is_leader_src)
                                 ? kFaultLeaderRecv
                                 : kFaultCoordinatorRecv;
      FaultAction fa = FaultCheck(site, rank);
      if (fa == FaultAction::kDrop || fa == FaultAction::kTruncate) {
        ctrl_socks_[rank].Close();
      }
    }
    std::string frame;
    if (!ctrl_socks_[rank].RecvFrame(&frame)) {
      return BroadcastAbortAndFail(
          rank, "lost connection to rank " + std::to_string(rank));
    }
    CountCtrlRecv(frame.size());
    Reader rd(frame);
    int32_t n_cached = rd.GetI32();
    if (n_cached == -1) {  // BYE: clean exit
      // v11: the BYE carries the sender's FINAL cumulative sketch (a
      // leader's: its whole host's sum).  Stored as the source's last
      // word, it keeps the fleet histograms bucket-exact after departure.
      ReadFleetSketch(rank, &rd);
      departed_ranks_.insert(rank);
      HVD_LOG(INFO) << "rank " << rank << " shut down cleanly";
      if (is_leader_src) {
        // A departing leader severs its subtree: any descendant still
        // running has lost its aggregation path, so the coordinator stops
        // expecting its announcements rather than hanging tensors on a
        // mute branch.  v12: the subtree is the whole branch below the
        // leader (its host, plus every clustered host under it when it
        // was a super-leader), not just its own host.
        for (int r : SubtreeOf(rank)) {
          if (r != rank && departed_ranks_.insert(r).second) {
            HVD_LOG(INFO) << "rank " << r << " departed with its leader "
                          << rank;
          }
        }
      }
      continue;
    }
    if (n_cached == -2) {  // failure FIN: the peer saw a failure first
      std::string why = rd.GetString();
      if (!rd.ok() || why.empty()) {
        why = "rank " + std::to_string(rank) + " reported a failure";
      }
      int culprit = rank;
      // v9: explicit culprit trailer (a leader forwards a child's FIN
      // verbatim — the sender is not the culprit).
      const int32_t c = rd.GetI32();
      if (rd.ok() && c >= 0 && c < cfg_.size) culprit = c;
      return BroadcastAbortAndFail(culprit, why);
    }
    if (n_cached == -3) {  // v9 leader aggregate
      if (!is_leader_src || !ParseAggregate(rank, &rd, &errors)) {
        return BroadcastAbortAndFail(rank,
                                     "malformed aggregate frame from rank " +
                                         std::to_string(rank));
      }
      continue;
    }
    ParseCachedPairs(rank, n_cached, &rd, &errors);
    // v11: the sender's cumulative telemetry sketch rides between the
    // cached pairs and the full requests.
    ReadFleetSketch(rank, &rd);
    ParseFullAndMetrics(rank, rd.GetI32(), &rd, &errors);
  }

  // Fusion phase: everything between the gather and the finished response
  // list — readiness collection, group gating, FuseRequests, QoS ordering,
  // cache/seq bookkeeping.  This is the coordinator's per-cycle "thinking"
  // span the step trace attributes to kPhaseFusion.
  const double fuse_t0 = StepTraceOn() ? MonotonicSeconds() : 0.0;
  // Collect ready tensors in deterministic (arrival-order) sequence.
  // Joined ranks (hvd.join) count as announced for every tensor — they
  // will participate with zero contributions.
  std::vector<std::pair<int64_t, std::string>> ready_names;
  std::vector<std::string> join_rejected;
  for (auto& kv : pending_) {
    std::vector<int> members;
    if (!process_sets_.Ranks(kv.second.meta.process_set_id, &members)) {
      continue;  // set not registered yet on this (coordinator) rank
    }
    bool ready = true;
    bool via_join = false;
    int departed = -1;
    for (int m : members) {
      if (departed_ranks_.count(m)) {
        departed = m;  // a member left: this tensor can never complete
        break;
      }
      if (!kv.second.announced.count(m)) {
        if (kv.second.meta.op != OpType::JOIN && joined_ranks_.count(m)) {
          via_join = true;
          continue;
        }
        ready = false;
        break;
      }
    }
    if (departed >= 0) {
      Response e;
      e.op = kv.second.meta.op;
      e.error = "tensor " + kv.first + " cannot complete: rank " +
                std::to_string(departed) + " has shut down";
      e.names.push_back(kv.first);
      e.metas.push_back(kv.second.meta);
      AddTombstone(kv.first, e.error, kv.second.announced);
      errors.push_back(std::move(e));
      join_rejected.push_back(kv.first);
      if (kv.second.meta.op == OpType::JOIN) {
        // The join round is dead: forget who joined, or stragglers would
        // keep zero-filling for ranks that think they aborted.
        joined_ranks_.clear();
        last_joined_ = -1;
      }
      continue;
    }
    if (!ready) continue;
    if (via_join) {
      // Zero contribution only makes sense for summing allreduces and
      // barriers (reference: Join supports allreduce/barrier; min/max/
      // product and data-bearing gathers have no neutral element here).
      const auto& meta = kv.second.meta;
      bool allowed =
          meta.op == OpType::BARRIER ||
          (meta.op == OpType::ALLREDUCE &&
           (meta.reduce_op == ReduceOp::SUM ||
            meta.reduce_op == ReduceOp::AVERAGE));
      if (!allowed) {
        Response e;
        e.op = meta.op;
        e.error = "tensor " + kv.first +
                  " became ready while some ranks had joined; only "
                  "sum/average allreduce and barrier may proceed after "
                  "hvd.join()";
        e.names.push_back(kv.first);
        e.metas.push_back(meta);
        AddTombstone(kv.first, e.error, kv.second.announced);
        errors.push_back(std::move(e));
        join_rejected.push_back(kv.first);
        continue;
      }
      // A joined rank zero-participates through the HOST plane (it has no
      // local tensor to place on a device); demote the whole collective so
      // every member walks the same ring.
      kv.second.meta.device = 0;
    }
    ready_names.emplace_back(kv.second.order, kv.first);
  }
  for (const auto& name : join_rejected) pending_.erase(name);
  // Atomic group gating (GateAndOrderGroups, group_table.cc analog):
  // members of incomplete groups are withheld — they simply REMAIN in
  // pending_ for a later cycle; complete groups come out contiguous.
  std::vector<std::string> ordered;
  std::vector<std::pair<int64_t, std::string>> withheld;
  GateAndOrderGroups(std::move(ready_names), &withheld, &ordered,
                     [this](const std::string& n) -> const TensorRequest& {
                       return pending_[n].meta;
                     });
  // JOIN completion must come after every via-join collective of the same
  // cycle: once a rank's executor processes the JOIN it stops zero-
  // participating, so a later-ordered via-join response would hang the
  // ring.  The partition is deterministic, so all ranks stay identical.
  std::stable_partition(
      ordered.begin(), ordered.end(), [this](const std::string& n) {
        auto it = pending_.find(n);
        return it != pending_.end() && it->second.meta.op != OpType::JOIN;
      });
  std::vector<TensorRequest> ready;
  ready.reserve(ordered.size());
  for (auto& name : ordered) {
    ready.push_back(pending_[name].meta);
    pending_.erase(name);
  }

  *out = FuseRequests(ready, cfg_.fusion_threshold);
  for (auto& r : *out) {
    if (r.op == OpType::JOIN) {
      // Everyone joined: report the last joiner and reset join state.
      r.last_joined = last_joined_;
      joined_ranks_.clear();
      last_joined_ = -1;
    }
  }
  // QoS tenant scheduling: order this cycle's fused responses by
  // descending process-set weight (stable, so equal-weight traffic —
  // including everything before the first add_process_set(weight=) —
  // keeps its deterministic arrival order).  Running BEFORE seq
  // assignment and the broadcast means every rank executes the same
  // weight-ordered schedule, so a heavy background tenant cannot push a
  // high-weight training set's collectives to the back of the cycle.
  std::stable_sort(out->begin(), out->end(),
                   [this](const Response& a, const Response& b) {
                     return process_sets_.Weight(a.process_set_id) >
                            process_sets_.Weight(b.process_set_id);
                   });
  out->insert(out->begin(), errors.begin(), errors.end());
  UpdateCachesAndSeq(out);
  if (fuse_t0 > 0.0) {
    StepTraceAddPhaseUs(
        kPhaseFusion,
        static_cast<int64_t>((MonotonicSeconds() - fuse_t0) * 1e6));
  }
  if (StepTraceOn()) {
    // A cycle that ships at least one real fused response closes a step.
    // The coordinator advances here; workers follow from the RESPONSES
    // trailer below, so every rank counts the same steps.
    bool step_work = false;
    for (const auto& r : *out) {
      if (r.error.empty() && !r.metas.empty()) {
        step_work = true;
        break;
      }
    }
    if (step_work) {
      StepTraceAdvance(StepTraceCurrentStep() + 1);
      int64_t sid = 0;
      int64_t phases[kStepPhases];
      if (StepTraceLastCompleted(&sid, phases)) {
        // The coordinator's own snapshot joins the fleet view directly —
        // its trailer never crosses a socket.
        StepTraceFleetPhases(0, sid, phases);
      }
    }
  }

  // Broadcast the identical response list down the gather topology: every
  // direct source gets one frame; tree leaders fan their copy out to their
  // children verbatim.  v10: an unconditional step-id trailer follows the
  // responses — the coordinator's current step (-1 when tracing is off) —
  // which workers use to advance their own step rings in lockstep.
  Writer w;
  w.PutI32(static_cast<int32_t>(out->size()));
  for (const auto& r : *out) SerializeResponse(r, &w);
  w.PutI64(StepTraceOn() ? StepTraceCurrentStep() : -1);
  const std::string payload = w.data();
  for (int rank : sources) {
    if (departed_ranks_.count(rank)) continue;
    CountCtrlSend(payload.size());
    if (!ctrl_socks_[rank].SendFrame(payload)) {
      return BroadcastAbortAndFail(rank,
                                   "failed to send responses to rank " +
                                       std::to_string(rank));
    }
  }
  if (MetricsOn()) {
    double now = MonotonicSeconds();
    FillSelfSnapshot(now);
    MaybeStragglerReport(now);
    // v11 fleet tick (~1 Hz): history sample + goodput + the anomaly
    // sentinel, fed the live fleet sum and the coordinator's data-plane
    // byte totals (raw/wire ratio drift is a sentinel series).
    if (FleetTelemetryOn() && now - last_fleet_tick_ >= 1.0) {
      last_fleet_tick_ = now;
      int64_t local = 0, xhost = 0, raw_local = 0, raw_xhost = 0;
      DataPlaneStats(&local, &xhost, &raw_local, &raw_xhost);
      FleetTelemetryTick(FleetSum(), local + xhost, raw_local + raw_xhost);
    }
  }
  return Status::OK();
}

void SocketController::RecordAnnounceLag(int rank, double lag_s) {
  if (StepTraceOn()) {
    // Announce lag is the dominant-rank signal: the coordinator waited
    // this long between the first announcement of a tensor and this
    // rank's, attributed to the step currently forming.
    StepTraceFleetLagUs(rank, static_cast<int64_t>(lag_s * 1e6));
  }
  if (!MetricsOn()) return;
  if (rank < 0 || rank >= static_cast<int>(announce_lag_.size())) return;
  announce_lag_[rank]->ObserveSeconds(lag_s);
}

void SocketController::FillSelfSnapshot(double now) {
  const auto& m = GlobalMetrics();
  RankMetricsSnapshot s;
  s.neg_count = m.negotiation_wait_us.count.load(std::memory_order_relaxed);
  s.neg_sum_us = m.negotiation_wait_us.sum_us.load(std::memory_order_relaxed);
  s.neg_p50_us = m.negotiation_wait_us.QuantileUs(0.5);
  s.neg_p99_us = m.negotiation_wait_us.QuantileUs(0.99);
  s.cycle_busy_us = m.cycle_busy_us.load(std::memory_order_relaxed);
  s.cycle_idle_us = m.cycle_idle_us.load(std::memory_order_relaxed);
  s.cycle_count = m.cycle_count.load(std::memory_order_relaxed);
  s.updated_at = now;
  std::lock_guard<std::mutex> l(metrics_mu_);
  if (!cluster_.empty()) cluster_[0] = s;
}

void SocketController::MaybeStragglerReport(double now) {
  if (cfg_.size < 2 || announce_lag_.empty()) return;
  if (now - last_metrics_report_ < metrics_report_s_) return;
  last_metrics_report_ = now;
  // Mean announce lag per rank over the window since the last report.
  std::vector<double> mean_us(cfg_.size, 0.0);
  std::vector<int64_t> window_count(cfg_.size, 0);
  int64_t any = 0;
  for (int r = 0; r < cfg_.size; ++r) {
    int64_t c = announce_lag_[r]->count.load(std::memory_order_relaxed);
    int64_t s = announce_lag_[r]->sum_us.load(std::memory_order_relaxed);
    int64_t dc = c - announce_prev_[r].first;
    int64_t ds = s - announce_prev_[r].second;
    announce_prev_[r] = {c, s};
    if (dc > 0) mean_us[r] = static_cast<double>(ds) / dc;
    window_count[r] = dc;
    any += dc;
  }
  if (any == 0) return;
  std::vector<double> sorted = mean_us;
  std::sort(sorted.begin(), sorted.end());
  double median = sorted[sorted.size() / 2];
  double threshold = std::max(straggler_skew_ * median, straggler_min_us_);
  std::ostringstream os;
  bool found = false;
  std::vector<int> flagged;
  for (int r = 0; r < cfg_.size; ++r) {
    if (window_count[r] == 0 || mean_us[r] <= threshold) continue;
    if (found) os << "; ";
    found = true;
    flagged.push_back(r);
    const std::string host =
        r < static_cast<int>(host_keys_.size()) ? host_keys_[r] : "?";
    os << "rank " << r << " (host " << host << "): negotiation lag mean="
       << static_cast<int64_t>(mean_us[r] / 1000) << "ms p50="
       << announce_lag_[r]->QuantileUs(0.5) / 1000 << "ms p99="
       << announce_lag_[r]->QuantileUs(0.99) / 1000
       << "ms vs fleet median " << static_cast<int64_t>(median / 1000)
       << "ms";
  }
  std::string report;
  if (found) {
    report = "straggler report: " + os.str();
    GlobalMetrics().straggler_reports_total.fetch_add(
        1, std::memory_order_relaxed);
    HVD_LOG(WARNING) << report;
  }
  // Every evaluated window (flagged or clean) advances the autopilot view:
  // the policy engine diffs `straggler_windows_` between polls, and a
  // clean window resetting straggler_ranks_ is what breaks an eviction
  // streak for a rank that recovered.
  std::lock_guard<std::mutex> l(metrics_mu_);
  ++straggler_windows_;
  straggler_ranks_ = std::move(flagged);
  if (!report.empty()) straggler_report_ = std::move(report);
}

std::string SocketController::ClusterMetricsJson() {
  if (!is_coordinator()) return "";
  std::ostringstream os;
  {
    std::lock_guard<std::mutex> l(metrics_mu_);
    os << "\"cluster\":{";
    for (size_t r = 0; r < cluster_.size(); ++r) {
      const auto& s = cluster_[r];
      if (r) os << ',';
      os << "\"" << r << "\":{\"neg_count\":" << s.neg_count
         << ",\"neg_sum_us\":" << s.neg_sum_us
         << ",\"neg_p50_us\":" << s.neg_p50_us
         << ",\"neg_p99_us\":" << s.neg_p99_us
         << ",\"cycle_busy_us\":" << s.cycle_busy_us
         << ",\"cycle_idle_us\":" << s.cycle_idle_us
         << ",\"cycle_count\":" << s.cycle_count
         << ",\"updated_at\":" << s.updated_at << "}";
    }
    os << "},\"straggler_report\":\"" << JsonEscape(straggler_report_) << "\"";
  }
  // v11: the live fleet view — this registry's capture plus every stored
  // source sketch — so hvd.metrics()["fleet"] and the Prometheus renderer
  // see true fleet histograms, not rank 0's.
  if (MetricsOn() && FleetTelemetryOn()) {
    os << ",\"fleet\":" << FleetSum().Json();
  }
  return os.str();
}

// ---------------------------------------------------------------------------
// Fleet-telemetry sketch plumbing (protocol v11; fleet_telemetry.h)
// ---------------------------------------------------------------------------

void SocketController::ReadFleetSketch(int rank, Reader* rd) {
  const std::string enc = rd->GetString();
  if (!rd->ok() || enc.empty()) return;
  FleetSketch s;
  // A sketch that fails to decode is dropped on its own — never the frame:
  // telemetry must not be able to abort a healthy job.
  if (s.Decode(enc.data(), enc.size())) StoreFleetSource(rank, std::move(s));
}

void SocketController::StoreFleetSource(int rank, FleetSketch&& s) {
  {
    std::lock_guard<std::mutex> l(fleet_mu_);
    fleet_sources_[rank] = std::move(s);
  }
  if (MetricsOn()) {
    GlobalMetrics().fleet_sketches_merged_total.fetch_add(
        1, std::memory_order_relaxed);
  }
}

FleetSketch SocketController::FleetSum() {
  FleetSketch fleet;
  if (MetricsOn() && FleetTelemetryOn()) fleet.CaptureLocal();
  std::lock_guard<std::mutex> l(fleet_mu_);
  for (const auto& kv : fleet_sources_) fleet.Merge(kv.second);
  return fleet;
}

int SocketController::FleetSourceCountForTest() {
  std::lock_guard<std::mutex> l(fleet_mu_);
  return static_cast<int>(fleet_sources_.size());
}

int64_t SocketController::FleetSumNegCountForTest() {
  return FleetSum().negotiation_wait.count;
}

// ---------------------------------------------------------------------------
// Fleet-autopilot policy channel (coordinator only)
// ---------------------------------------------------------------------------

std::string SocketController::PolicyStatusJson() {
  std::ostringstream os;
  std::lock_guard<std::mutex> l(metrics_mu_);
  os << "{\"v\":1,\"windows\":" << straggler_windows_ << ",\"culprits\":[";
  for (size_t i = 0; i < straggler_ranks_.size(); ++i) {
    if (i) os << ',';
    os << straggler_ranks_[i];
  }
  os << "],\"hosts\":[";
  // The coordinator's agreed host key per flagged rank: attribution the
  // driver feeds straight into the elastic blacklist (its own hostfile
  // names may differ from the rendezvous-agreed keys).
  for (size_t i = 0; i < straggler_ranks_.size(); ++i) {
    if (i) os << ',';
    const int r = straggler_ranks_[i];
    const std::string host =
        r >= 0 && r < static_cast<int>(host_keys_.size()) ? host_keys_[r]
                                                          : "";
    os << "\"" << JsonEscape(host) << "\"";
  }
  os << "],\"report\":\"" << JsonEscape(straggler_report_)
     // v11: the sentinel's anomaly log rides the same poll — an ADVISORY
     // signal the driver-side engine journals and may act on ahead of the
     // consecutive-window eviction rule.
     << "\",\"anomalies\":" << FleetAnomaliesJson()
     << ",\"size\":" << cfg_.size << "}";
  return os.str();
}

void SocketController::RecordAutopilotDecision(int action, int rank,
                                               const std::string& detail) {
  const char* name = action == kAutopilotActEvict      ? "evict"
                     : action == kAutopilotActScaleUp  ? "scale_up"
                     : action == kAutopilotActReadmit  ? "readmit"
                                                       : "unknown";
  GlobalMetrics().autopilot_decisions_total.fetch_add(
      1, std::memory_order_relaxed);
  if (FlightOn()) {
    FlightRecord(kFlightAutopilot, action, rank);
    // An eviction decision is usually followed by elastic teardown of this
    // very process: dump now so the record survives into the postmortem
    // bundle regardless of how the generation ends.
    FlightDumpToFile();
  }
  if (autopilot_hook_) autopilot_hook_(action, rank, detail);
  HVD_LOG(WARNING) << "autopilot decision: " << name << " rank=" << rank
                   << (detail.empty() ? "" : " (" + detail + ")");
}

void SocketController::PolicyServeLoop() {
  // One driver connection at a time (the autopilot keeps a single
  // persistent connection; a reconnect simply replaces it).  Commands are
  // newline-terminated text, replies one JSON line each:
  //   POLL                         -> PolicyStatusJson()
  //   DECISION <action> <rank> <detail...> -> {"ok":true}
  Socket client;
  std::string acc;
  while (!policy_stop_.load(std::memory_order_relaxed)) {
    if (!client.valid()) {
      client = policy_listener_.Accept(0.2);
      if (!client.valid()) continue;
      acc.clear();
    }
    struct pollfd p;
    p.fd = client.fd();
    p.events = POLLIN;
    p.revents = 0;
    const int rv = ::poll(&p, 1, 200);
    if (rv < 0 && errno != EINTR) {
      client.Close();
      continue;
    }
    if (rv <= 0) continue;
    char buf[4096];
    const ssize_t n = ::recv(client.fd(), buf, sizeof(buf), 0);
    if (n <= 0) {
      client.Close();
      continue;
    }
    acc.append(buf, static_cast<size_t>(n));
    size_t nl;
    while (client.valid() && (nl = acc.find('\n')) != std::string::npos) {
      std::string line = acc.substr(0, nl);
      acc.erase(0, nl + 1);
      if (!line.empty() && line.back() == '\r') line.pop_back();
      std::string reply;
      if (line == "POLL") {
        reply = PolicyStatusJson();
      } else if (line.rfind("DECISION ", 0) == 0) {
        int action = 0, rank = -1, consumed = 0;
        if (std::sscanf(line.c_str() + 9, "%d %d%n", &action, &rank,
                        &consumed) >= 2 &&
            action >= kAutopilotActEvict && action <= kAutopilotActReadmit) {
          std::string detail = line.substr(9 + consumed);
          if (!detail.empty() && detail.front() == ' ') detail.erase(0, 1);
          RecordAutopilotDecision(action, rank, detail);
          reply = "{\"ok\":true}";
        } else {
          reply = "{\"ok\":false,\"error\":\"malformed DECISION\"}";
        }
      } else {
        reply = "{\"ok\":false,\"error\":\"unknown command\"}";
      }
      reply.push_back('\n');
      if (!client.SendAll(reply.data(), reply.size())) client.Close();
    }
    if (acc.size() > kPolicyMaxLine) client.Close();  // runaway garbage
  }
}

std::string SocketController::BuildCycleFrame(
    const std::vector<TensorRequest>& new_requests) {
  Writer w;
  // Cache hits travel as (id, handle) pairs — the id is the reference's
  // bit-vector fast path; the per-submission handle rides along so a
  // tombstone error delivery can echo the announcing rank's own current
  // submission (not the stale handle stored in the cache by the first
  // announcer of an earlier negotiation).
  std::vector<std::pair<int64_t, int64_t>> cached;
  std::vector<const TensorRequest*> full;
  const bool use_cache = announce_cache_.load(std::memory_order_relaxed);
  for (const auto& r : new_requests) {
    int64_t id = use_cache ? cache_.Lookup(r) : -1;
    if (id >= 0) {
      cached.emplace_back(id, r.handle);
    } else {
      full.push_back(&r);
    }
  }
  w.PutI32(static_cast<int32_t>(cached.size()));
  for (auto& [id, handle] : cached) {
    w.PutI64(id);
    w.PutI64(handle);
  }
  // v11 sketch section: this rank's cumulative telemetry sketch, placed
  // between the cached pairs and the full requests so a leader can peel it
  // off cheaply while the rest of the tail forwards verbatim.  An empty
  // string when the plane (or the registry feeding it) is off — the
  // length prefix keeps the frame shape fixed either way.
  const double sk_now = MonotonicSeconds();
  if (MetricsOn() && FleetTelemetryOn() &&
      sk_now - fleet_last_encode_ >= kFleetEncodeIntervalS) {
    fleet_last_encode_ = sk_now;
    FleetSketch sk;
    sk.CaptureLocal();
    w.PutString(sk.Encode());
  } else {
    w.PutString("");
  }
  w.PutI32(static_cast<int32_t>(full.size()));
  for (const auto* r : full) SerializeRequest(*r, &w);
  // v7 trailer: piggyback this rank's metrics snapshot (cumulative) on
  // the cycle frame it sends anyway — the coordinator's cluster view
  // costs no extra round trips.  v10 extends it: marker 2 carries the
  // same 7 metric i64s (zeros when the registry is off) followed by this
  // rank's last completed step snapshot (step id + kStepPhases phase
  // sums), feeding the coordinator's fleet attribution.  Each snapshot
  // travels once: the coordinator keeps the first report of a (step,
  // rank) and drops repeats, so a cycle with no newer step sends the
  // 4-byte empty marker (metrics off) instead of repeating 116 bytes.
  int64_t st_sid = 0;
  int64_t st_phases[kStepPhases];
  const bool has_step = StepTraceOn() &&
                        StepTraceLastCompleted(&st_sid, st_phases) &&
                        st_sid != step_sent_;
  if (has_step) step_sent_ = st_sid;
  if (MetricsOn() || has_step) {
    w.PutI32(has_step ? 2 : 1);
    if (MetricsOn()) {
      const auto& m = GlobalMetrics();
      w.PutI64(m.negotiation_wait_us.count.load(std::memory_order_relaxed));
      w.PutI64(m.negotiation_wait_us.sum_us.load(std::memory_order_relaxed));
      w.PutI64(m.negotiation_wait_us.QuantileUs(0.5));
      w.PutI64(m.negotiation_wait_us.QuantileUs(0.99));
      w.PutI64(m.cycle_busy_us.load(std::memory_order_relaxed));
      w.PutI64(m.cycle_idle_us.load(std::memory_order_relaxed));
      w.PutI64(m.cycle_count.load(std::memory_order_relaxed));
    } else {
      for (int i = 0; i < 7; ++i) w.PutI64(0);
    }
    if (has_step) {
      w.PutI64(st_sid);
      for (int p = 0; p < kStepPhases; ++p) w.PutI64(st_phases[p]);
    }
  } else {
    w.PutI32(0);
  }
  return std::string(w.data());
}

void SocketController::ParseResponsesTail(Reader* rd, int32_t n,
                                          std::vector<Response>* out) {
  out->clear();
  out->reserve(n);
  for (int32_t i = 0; i < n; ++i) out->push_back(DeserializeResponse(rd));
  // Local seq counter mirrors the coordinator's (sanity only) and caches are
  // updated from the metas carried by each response — identical on all
  // ranks, so cache ids agree without extra synchronisation.
  for (auto& r : *out) {
    if (r.error.empty()) {
      for (const auto& m : r.metas) cache_.Insert(m);
      if (r.seq >= 0) {
        seq_counter_ = r.seq + 1;
        if (r.hier || r.wire_comp != 0) {
          std::lock_guard<std::mutex> l(hier_mu_);
          plane_by_seq_[r.seq] = {r.hier,
                                  static_cast<WireCodec>(r.wire_comp)};
        }
      }
    }
  }
  // v10 step-id trailer: the coordinator's current step after this cycle
  // (-1 when tracing is off there).  Absent on pre-v10 coordinators —
  // tolerated so mixed builds don't tear the frame apart mid-upgrade.
  if (rd->remaining() >= 8) {
    const int64_t sid = rd->GetI64();
    if (rd->ok() && sid > StepTraceCurrentStep() && StepTraceOn()) {
      StepTraceAdvance(sid);
    }
  }
}

Status SocketController::WorkerCycle(std::vector<TensorRequest>& new_requests,
                                     std::vector<Response>* out) {
  const std::string payload = BuildCycleFrame(new_requests);
  Socket& up = UpLink();
  const bool via_leader = (&up == &tree_parent_);
  CountCtrlSend(payload.size());
  if (!up.SendFrame(payload)) {
    aborted_ = true;
    // A dead leader is not a dead job: the coordinator's direct ABORT
    // broadcast still reaches this rank on coord_ctrl_, so run the
    // handshake for real culprit attribution instead of guessing.
    if (via_leader) return WorkerAbortHandshake();
    return Status::Error(StatusCode::ABORTED, "lost coordinator (send)");
  }
  std::string frame;
  if (!up.RecvFrame(&frame)) {
    aborted_ = true;
    if (via_leader) return WorkerAbortHandshake();
    return Status::Error(StatusCode::ABORTED, "lost coordinator (recv)");
  }
  CountCtrlRecv(frame.size());
  Reader rd(frame);
  int32_t n = rd.GetI32();
  if (n == -1) {  // coordinator farewell: the job is ending deliberately
    peer_shutdown_ = true;
    aborted_ = true;
    // Latch the reason so WaitAbortReason callers return immediately
    // instead of burning the propagation timeout at clean teardown.
    SetAbortReason("coordinator shut down the job");
    return Status::Error(StatusCode::ABORTED,
                         "coordinator shut down the job");
  }
  if (n == -2) {  // coordinator ABORT broadcast (protocol v8)
    return HandleAbortFrame(&rd);
  }
  ParseResponsesTail(&rd, n, out);
  return Status::OK();
}

// ---------------------------------------------------------------------------
// Leader tree cycles (protocol v9)
// ---------------------------------------------------------------------------

void SocketController::ParseCachedPairs(int rank, int32_t n_cached, Reader* rd,
                                        std::vector<Response>* errors) {
  for (int32_t i = 0; i < n_cached; ++i) {
    int64_t id = rd->GetI64();
    int64_t handle = rd->GetI64();
    TensorRequest req;
    if (cache_.Get(id, &req)) {
      req.handle = handle;  // the announcer's own current submission
      Announce(rank, std::move(req), errors);
    } else {
      Response e;
      e.error = "response cache divergence: unknown cache id " +
                std::to_string(id) + " from rank " + std::to_string(rank);
      errors->push_back(std::move(e));
    }
  }
}

void SocketController::ParseFullAndMetrics(int rank, int32_t n_full,
                                           Reader* rd,
                                           std::vector<Response>* errors) {
  for (int32_t i = 0; i < n_full; ++i) {
    Announce(rank, DeserializeRequest(rd), errors);
  }
  // v7 trailer: the rank's piggybacked metrics snapshot (cumulative;
  // marker 0 when nothing piggybacks).  v10 marker 2 appends the rank's
  // last completed step snapshot; its metric slots are zero-filled when
  // the sender's registry is off, so cluster_ only stores real ones
  // (cycle_count > 0 — a live registry always counts cycles).
  int32_t has_metrics = rd->GetI32();
  if (has_metrics == 1 || has_metrics == 2) {
    RankMetricsSnapshot s;
    s.neg_count = rd->GetI64();
    s.neg_sum_us = rd->GetI64();
    s.neg_p50_us = rd->GetI64();
    s.neg_p99_us = rd->GetI64();
    s.cycle_busy_us = rd->GetI64();
    s.cycle_idle_us = rd->GetI64();
    s.cycle_count = rd->GetI64();
    s.updated_at = MonotonicSeconds();
    if (s.cycle_count > 0) {
      std::lock_guard<std::mutex> l(metrics_mu_);
      if (rank >= 0 && rank < static_cast<int>(cluster_.size())) {
        cluster_[rank] = s;
      }
    }
  }
  if (has_metrics == 2) {
    const int64_t sid = rd->GetI64();
    int64_t phases[kStepPhases];
    for (int p = 0; p < kStepPhases; ++p) phases[p] = rd->GetI64();
    if (rd->ok() && StepTraceOn()) {
      StepTraceFleetPhases(rank, sid, phases);
    }
  }
}

bool SocketController::ParseAggregate(int leader, Reader* rd,
                                      std::vector<Response>* errors) {
  // v9 aggregate: [n_groups] { [i64 cache_id][i32 k] k x ([i32 rank]
  // [i64 handle]) } [n_rest] { [i32 rank][string rest] } — the leader's
  // host-merged cached announcements, then each member's un-merged frame
  // tail (full requests + metrics trailer), or its whole BYE frame.
  // v11 prepends the leader's host-summed sketch section, stored under the
  // leader's rank so coordinator fleet state stays O(hosts).
  ReadFleetSketch(leader, rd);
  const int32_t n_groups = rd->GetI32();
  if (!rd->ok() || n_groups < 0) return false;
  for (int32_t g = 0; g < n_groups; ++g) {
    const int64_t id = rd->GetI64();
    const int32_t k = rd->GetI32();
    if (!rd->ok() || k < 0) return false;
    TensorRequest cached_req;
    const bool known = cache_.Get(id, &cached_req);
    for (int32_t i = 0; i < k; ++i) {
      const int32_t rank = rd->GetI32();
      const int64_t handle = rd->GetI64();
      if (!rd->ok() || rank < 0 || rank >= cfg_.size) return false;
      if (known) {
        TensorRequest req = cached_req;
        req.handle = handle;
        Announce(rank, std::move(req), errors);
      } else {
        Response e;
        e.error = "response cache divergence: unknown cache id " +
                  std::to_string(id) + " from rank " + std::to_string(rank);
        errors->push_back(std::move(e));
      }
    }
  }
  const int32_t n_rest = rd->GetI32();
  if (!rd->ok() || n_rest < 0) return false;
  for (int32_t i = 0; i < n_rest; ++i) {
    const int32_t rank = rd->GetI32();
    if (!rd->ok() || rank < 0 || rank >= cfg_.size) return false;
    const std::string rest = rd->GetString();
    if (!rd->ok()) return false;
    Reader rr(rest);
    const int32_t first = rr.GetI32();
    if (first == -1) {  // the member's BYE, forwarded by its leader
      // v11: the forwarded BYE's trailing sketch is deliberately SKIPPED —
      // the leader folded the child's final sketch into its own host sum,
      // so reading it here would double-count the host.  v12: when the
      // departing rank is itself a leader (a super-leader forwarded a
      // child leader's BYE), its whole subtree departs with it — those
      // ranks have lost their aggregation path.
      DepartSubtree(rank);
      HVD_LOG(INFO) << "rank " << rank << " shut down cleanly (via leader "
                    << leader << ")";
      continue;
    }
    if (first < 0) return false;
    ParseFullAndMetrics(rank, first, &rr, errors);
    if (!rr.ok()) return false;
  }
  return rd->ok();
}

bool SocketController::FanDownToChildren(const std::string& frame,
                                         int* failed_child) {
  bool ok = true;
  for (auto& [rank, sock] : tree_child_socks_) {
    if (tree_departed_children_.count(rank) || !sock.valid()) continue;
    CountCtrlSend(frame.size());
    if (!sock.SendFrame(frame)) {
      if (failed_child) *failed_child = rank;
      ok = false;
    }
  }
  return ok;
}

Status SocketController::LeaderFinUp(int culprit, const std::string& why,
                                     const std::string* forward_frame) {
  aborted_ = true;
  if (!fin_sent_) {
    fin_sent_ = true;
    // Up the TREE first (v12: a clustered leader's parent is a super-
    // leader whose gather loop relays the FIN hop by hop until it lands
    // on a rendezvous socket the coordinator reads in-cycle), plus a
    // best-effort direct copy so attribution survives a dead ancestor.
    Socket& up = UpLink();
    const std::string* frame = forward_frame;
    Writer w;
    if (frame == nullptr) {
      w.PutI32(-2);  // failure FIN in the cycle-frame position
      w.PutString(why);
      w.PutI32(culprit);
    }
    const std::string& payload = frame != nullptr ? *frame : w.data();
    if (up.valid()) up.SendFrame(payload);  // best effort
    if (&up != &coord_ctrl_ && coord_ctrl_.valid()) {
      coord_ctrl_.SendFrame(payload);
    }
  }
  // Await the coordinator's ABORT (and fan it down to surviving children)
  // so every rank of this subtree reports the same culprit.
  return WorkerAbortHandshake();
}

Status SocketController::LeaderCycle(std::vector<TensorRequest>& new_requests,
                                     std::vector<Response>* out) {
  // An empty member tail is [n_full=0][has_metrics=0]: skip it in the
  // aggregate — idle ranks then cost 12 bytes (rank + empty pair list)
  // instead of a whole frame.
  static const std::string kEmptyTail(8, '\0');
  const std::string own = BuildCycleFrame(new_requests);
  // id -> (rank, handle) announcements merged across this host.  std::map
  // keeps aggregate bytes deterministic.
  std::map<int64_t, std::vector<std::pair<int32_t, int64_t>>> groups;
  std::vector<std::pair<int32_t, std::string>> rests;
  auto merge_frame = [&](int32_t rank, const std::string& frame) -> bool {
    Reader rd(frame);
    const int32_t n_cached = rd.GetI32();
    if (!rd.ok() || n_cached < 0) return false;
    for (int32_t i = 0; i < n_cached; ++i) {
      const int64_t id = rd.GetI64();
      const int64_t handle = rd.GetI64();
      groups[id].emplace_back(rank, handle);
    }
    if (!rd.ok()) return false;
    // v11: peel the member's sketch out of the frame — the leader sums
    // every member's into ONE aggregate sketch so coordinator inbound
    // stays O(hosts) — leaving the rest (full requests + metrics
    // trailer) to forward verbatim, sketch-free.
    const std::string enc = rd.GetString();
    if (!rd.ok()) return false;
    if (!enc.empty()) {
      FleetSketch s;
      if (s.Decode(enc.data(), enc.size())) {
        tree_child_sketches_[rank] = std::move(s);
      }
    }
    std::string rest(rd.cursor(), rd.remaining());
    if (rest != kEmptyTail) rests.emplace_back(rank, std::move(rest));
    return true;
  };
  // v12: a super-leader merges a downstream leader's whole [-3] aggregate
  // — subtree-summed sketch (replaces that child's last-known, keeping the
  // running sum bucket-exact), cached groups unioned by id, rests appended
  // verbatim — into the same `groups`/`rests` its worker children feed.
  auto merge_aggregate = [&](int32_t child, const std::string& frame) -> bool {
    Reader rd(frame);
    if (rd.GetI32() != -3 || !rd.ok()) return false;
    const std::string enc = rd.GetString();
    if (!rd.ok()) return false;
    if (!enc.empty()) {
      FleetSketch s;
      if (s.Decode(enc.data(), enc.size())) {
        tree_child_sketches_[child] = std::move(s);
      }
    }
    const int32_t n_groups = rd.GetI32();
    if (!rd.ok() || n_groups < 0) return false;
    for (int32_t g = 0; g < n_groups; ++g) {
      const int64_t id = rd.GetI64();
      const int32_t k = rd.GetI32();
      if (!rd.ok() || k < 0) return false;
      for (int32_t i = 0; i < k; ++i) {
        const int32_t rank = rd.GetI32();
        const int64_t handle = rd.GetI64();
        if (!rd.ok() || rank < 0 || rank >= cfg_.size) return false;
        groups[id].emplace_back(rank, handle);
      }
    }
    const int32_t n_rest = rd.GetI32();
    if (!rd.ok() || n_rest < 0) return false;
    for (int32_t i = 0; i < n_rest; ++i) {
      const int32_t rank = rd.GetI32();
      if (!rd.ok() || rank < 0 || rank >= cfg_.size) return false;
      std::string rest = rd.GetString();
      if (!rd.ok()) return false;
      rests.emplace_back(rank, std::move(rest));
    }
    return rd.ok();
  };
  merge_frame(cfg_.rank, own);
  int32_t merged_frames = 1;  // own frame
  // Gather this host's workers first, then (v12) downstream leaders'
  // aggregates.  One flat list keeps the failure handling identical: a
  // dead link, BYE, or FIN from either kind takes the same path.
  std::vector<std::pair<int, bool>> gather;  // (child rank, is aggregate)
  for (int c : tree_.my_children) gather.emplace_back(c, false);
  for (int c : tree_.agg_children) gather.emplace_back(c, true);
  for (const auto& [child, is_agg] : gather) {
    if (tree_departed_children_.count(child)) continue;
    Socket* cs = TreeChildSock(child);
    if (cs == nullptr) continue;
    if (FaultInjectionOn()) {
      // Site rank = the REMOTE child whose frame this leader is gathering;
      // closing the link makes the recv below fail like a child death.
      // Worker children are leader-recv sites; downstream leaders' links
      // are the v12 super-recv sites.
      FaultAction fa =
          FaultCheck(is_agg ? kFaultSuperRecv : kFaultLeaderRecv, child);
      if (fa == FaultAction::kDrop || fa == FaultAction::kTruncate) {
        cs->Close();
      }
    }
    std::string frame;
    if (!cs->RecvFrame(&frame)) {
      return LeaderFinUp(child,
                         "leader rank " + std::to_string(cfg_.rank) +
                             " lost connection to rank " +
                             std::to_string(child),
                         nullptr);
    }
    CountCtrlRecv(frame.size());
    Reader rd(frame);
    const int32_t first = rd.GetI32();
    if (first == -1) {  // child BYE: forward the whole frame as its tail
      // v11: keep the child's FINAL sketch so the running sum stays exact
      // after it departs (a leader child's BYE carries its whole subtree's
      // final sum).  The coordinator skips the sketch on the forwarded
      // BYE — this node's aggregate already carries it.
      const std::string enc = rd.GetString();
      if (rd.ok() && !enc.empty()) {
        FleetSketch s;
        if (s.Decode(enc.data(), enc.size())) {
          tree_child_sketches_[child] = std::move(s);
        }
      }
      tree_departed_children_.insert(child);
      rests.emplace_back(child, frame);
      continue;
    }
    if (first == -2) {  // child failure FIN: forward verbatim, abort
      std::string why = rd.GetString();
      int culprit = child;
      const int32_t c = rd.GetI32();
      if (rd.ok() && c >= 0 && c < cfg_.size) culprit = c;
      if (!rd.ok() || why.empty()) {
        why = "rank " + std::to_string(child) + " reported a failure";
      }
      return LeaderFinUp(culprit, why, &frame);
    }
    if (is_agg ? !merge_aggregate(child, frame)
               : !merge_frame(child, frame)) {
      return LeaderFinUp(child,
                         (is_agg ? "malformed aggregate frame from rank "
                                 : "malformed cycle frame from rank ") +
                             std::to_string(child),
                         nullptr);
    }
    ++merged_frames;
  }
  // Tree-aggregate merge: the leader's share of the fusion phase (the
  // coordinator's fuse/gate span is measured in CoordinatorCycle).
  const double agg_t0 = StepTraceOn() ? MonotonicSeconds() : 0.0;
  Writer w;
  w.PutI32(-3);  // leader aggregate sentinel in the cycle-frame position
  // v11: ONE subtree-summed sketch per aggregate — own + every member's
  // last-known (a map entry per member only exists once its frame carried
  // a non-empty section, so an all-off subtree writes an empty string).
  // v12: entries under downstream-leader ranks already hold their whole
  // subtree's sum, and rank keys are disjoint across subtrees, so one flat
  // Merge stays bucket-exact at any depth.
  const double hs_now = MonotonicSeconds();
  if (tree_child_sketches_.empty() ||
      hs_now - fleet_leader_last_encode_ < kFleetEncodeIntervalS) {
    w.PutString("");
  } else {
    fleet_leader_last_encode_ = hs_now;
    FleetSketch subtree_sum;
    for (const auto& kv : tree_child_sketches_) subtree_sum.Merge(kv.second);
    w.PutString(subtree_sum.Encode());
  }
  w.PutI32(static_cast<int32_t>(groups.size()));
  for (const auto& [id, members] : groups) {
    w.PutI64(id);
    w.PutI32(static_cast<int32_t>(members.size()));
    for (const auto& [rank, handle] : members) {
      w.PutI32(rank);
      w.PutI64(handle);
    }
  }
  w.PutI32(static_cast<int32_t>(rests.size()));
  for (const auto& [rank, rest] : rests) {
    w.PutI32(rank);
    w.PutString(rest);
  }
  if (agg_t0 > 0.0) {
    StepTraceAddPhaseUs(
        kPhaseFusion,
        static_cast<int64_t>((MonotonicSeconds() - agg_t0) * 1e6));
  }
  if (FlightOn()) {
    // One aggregate frame per tree node per cycle: how many child frames
    // this leader merged (its own included; downstream leaders' aggregates
    // count as one each) and the bytes pushed upward.
    FlightRecord(kFlightTreeAgg, merged_frames,
                 static_cast<int64_t>(w.data().size()));
  }
  // v12: clustered leaders push to their super-leader, super-leaders (and
  // host 0's fused leader/coordinator path, which never reaches here) to
  // the coordinator.  Losing a super-leader is NOT losing the coordinator:
  // the rendezvous link is still up, so FIN through it and let the
  // coordinator attribute the death; only the top of the chain synthesizes
  // the ABORT itself.
  Socket& up = UpLink();
  CountCtrlSend(w.data().size());
  if (!up.SendFrame(w.data())) {
    if (tree_.parent > 0) {
      return LeaderFinUp(tree_.parent,
                         "leader rank " + std::to_string(cfg_.rank) +
                             " lost its super-leader rank " +
                             std::to_string(tree_.parent) + " (send)",
                         nullptr);
    }
    aborted_ = true;
    return LeaderLostCoordinator("lost coordinator (send)");
  }
  std::string resp;
  if (!up.RecvFrame(&resp)) {
    if (tree_.parent > 0) {
      return LeaderFinUp(tree_.parent,
                         "leader rank " + std::to_string(cfg_.rank) +
                             " lost its super-leader rank " +
                             std::to_string(tree_.parent) + " (recv)",
                         nullptr);
    }
    aborted_ = true;
    return LeaderLostCoordinator("lost coordinator (recv)");
  }
  CountCtrlRecv(resp.size());
  // Fan the coordinator's frame down BEFORE parsing: children unblock in
  // parallel with this rank's own deserialization, and terminal frames
  // (farewell, ABORT) reach the subtree even when this leader errors out.
  int failed_child = -1;
  if (!FanDownToChildren(resp, &failed_child)) {
    return LeaderFinUp(failed_child,
                       "leader rank " + std::to_string(cfg_.rank) +
                           " failed to forward responses to rank " +
                           std::to_string(failed_child),
                       nullptr);
  }
  Reader rd(resp);
  const int32_t n = rd.GetI32();
  if (n == -1) {
    peer_shutdown_ = true;
    aborted_ = true;
    SetAbortReason("coordinator shut down the job");
    return Status::Error(StatusCode::ABORTED,
                         "coordinator shut down the job");
  }
  if (n == -2) return HandleAbortFrame(&rd);
  ParseResponsesTail(&rd, n, out);
  return Status::OK();
}

Status SocketController::LeaderLostCoordinator(const std::string& what) {
  // The subtree's only path to the coordinator is gone: synthesize the
  // ABORT the coordinator can no longer send, so children fail within the
  // propagation bound instead of blocking on a mute leader.
  Writer w;
  w.PutI32(-2);
  w.PutI32(kTagAbort);
  w.PutString("leader rank " + std::to_string(cfg_.rank) +
              " lost the coordinator");
  w.PutI32(-1);        // no culprit rank: the coordinator itself is gone
  w.PutString("");     // culprit host unknown
  w.PutF64(WallSeconds());
  FanDownToChildren(w.data(), nullptr);
  const std::string msg = what;
  SetAbortReason(msg);
  return Status::Error(StatusCode::ABORTED, msg);
}

void SocketController::CountCtrlSend(int64_t bytes) {
  ctrl_msgs_sent_.fetch_add(1, std::memory_order_relaxed);
  ctrl_sent_.fetch_add(bytes, std::memory_order_relaxed);
  if (MetricsOn()) {
    auto& m = GlobalMetrics();
    m.ctrl_msgs_sent.fetch_add(1, std::memory_order_relaxed);
    m.ctrl_bytes_sent.fetch_add(bytes, std::memory_order_relaxed);
  }
  if (FlightOn()) FlightRecord(kFlightCtrlSend, 0, bytes);
}

void SocketController::CountCtrlRecv(int64_t bytes) {
  ctrl_msgs_recv_.fetch_add(1, std::memory_order_relaxed);
  ctrl_recv_.fetch_add(bytes, std::memory_order_relaxed);
  if (MetricsOn()) {
    auto& m = GlobalMetrics();
    m.ctrl_msgs_recv.fetch_add(1, std::memory_order_relaxed);
    m.ctrl_bytes_recv.fetch_add(bytes, std::memory_order_relaxed);
  }
  if (FlightOn()) FlightRecord(kFlightCtrlRecv, 0, bytes);
}

void SocketController::UpdateCachesAndSeq(std::vector<Response>* responses) {
  const bool hier_on = hierarchical_.load(std::memory_order_relaxed);
  const int wire_on = wire_compression_.load(std::memory_order_relaxed);
  for (auto& r : *responses) {
    if (!r.error.empty()) continue;
    bool all_cached = true;
    for (const auto& m : r.metas) {
      if (cache_.Lookup(m) < 0) all_cached = false;
      cache_.Insert(m);
    }
    r.cache_hit = all_cached;
    r.seq = seq_counter_++;
    // Plane decisions (coordinator only, carried in the response).  The
    // device bit follows ResponseToJson's AND — a single host-bound
    // member demotes the whole response to the host plane.
    if (r.op == OpType::ALLREDUCE && !r.metas.empty()) {
      bool device = true;
      int64_t total_bytes = 0;
      for (const auto& m : r.metas) {
        device = device && m.device != 0;
        total_bytes += m.nbytes;
      }
      // Hierarchical: host-plane allreduces on sets whose agreed topology
      // qualifies.
      if (hier_on && !device && HierFor(r.process_set_id) != nullptr) {
        r.hier = true;
      }
      // Wire codec: demoted (left 0) for non-fp32 dtypes, device-plane
      // ops, payloads under the floor, and topologies with any same-host
      // ring hop — hierarchical compresses its leader ring (the shm-local
      // planes stay raw), a flat ring only when every hop crosses hosts.
      if (wire_on != 0 && !device && r.dtype == DataType::FLOAT32 &&
          total_bytes >= wire_comp_floor_) {
        bool applies;
        if (r.hier) {
          applies = true;  // only the cross-host leader ring compresses
        } else {
          // The agreed host keys predict the members' plane choice (shm
          // only opens when all keys match), so this coordinator-side
          // check is a pure function of the rendezvous book.
          std::vector<int> members;
          applies = process_sets_.Ranks(r.process_set_id, &members) &&
                    members.size() >= 2 && RingAllCrossHost(members);
        }
        if (applies) r.wire_comp = wire_on;
      }
    }
    if (r.hier || r.wire_comp != 0) {
      std::lock_guard<std::mutex> l(hier_mu_);
      plane_by_seq_[r.seq] = {r.hier, static_cast<WireCodec>(r.wire_comp)};
    }
  }
}

std::string SocketController::StallReport(double older_than_s) {
  if (!is_coordinator()) return "";
  double now = MonotonicSeconds();
  std::ostringstream os;
  // Per-group ready counts: a grouped tensor announced by every rank can
  // still stall on MISSING group members (submitted nowhere) — report the
  // group shortfall, not an empty rank list.
  std::unordered_map<std::string, int32_t> gcount;
  for (const auto& kv : pending_) {
    if (!kv.second.meta.group_key.empty()) {
      gcount[kv.second.meta.group_key]++;
    }
  }
  for (const auto& kv : pending_) {
    if (now - kv.second.first_seen < older_than_s) continue;
    std::vector<int> members;
    process_sets_.Ranks(kv.second.meta.process_set_id, &members);
    std::vector<int> waiting;
    for (int m : members) {
      if (!kv.second.announced.count(m)) waiting.push_back(m);
    }
    const auto& meta = kv.second.meta;
    if (waiting.empty() && !meta.group_key.empty() &&
        gcount[meta.group_key] < meta.group_size) {
      os << kv.first << " (group " << meta.group_key << " incomplete: "
         << gcount[meta.group_key] << "/" << meta.group_size
         << " members submitted); ";
      continue;
    }
    os << kv.first << " (waiting on ranks:";
    for (int m : waiting) os << " " << m;
    os << "); ";
  }
  return os.str();
}

// ---------------------------------------------------------------------------
// Data plane: full-mesh ring/tree/pairwise algorithms on the caller thread
// ---------------------------------------------------------------------------

Status SocketController::Members(int psid, std::vector<int>* members,
                                 int* my_idx) const {
  if (!process_sets_.Ranks(psid, members)) {
    return Status::Error(StatusCode::INVALID_ARGUMENT,
                         "unknown process set " + std::to_string(psid));
  }
  auto it = std::find(members->begin(), members->end(), cfg_.rank);
  if (it == members->end()) {
    return Status::Error(StatusCode::INVALID_ARGUMENT,
                         "rank " + std::to_string(cfg_.rank) +
                             " not in process set " + std::to_string(psid));
  }
  *my_idx = static_cast<int>(it - members->begin());
  return Status::OK();
}

void SocketController::PutFrameHeader(Writer* w, int64_t seq, int32_t tag) {
  if (FaultInjectionOn() &&
      FaultCheck(kFaultFrameHeader, cfg_.rank) == FaultAction::kCorruptTag) {
    tag ^= 0x5A5A;  // the receiver must fail fast on the header mismatch
  }
  w->PutI64(seq);
  w->PutI32(tag);
}

Status SocketController::CheckFrameHeader(Reader* rd, int32_t tag,
                                          const char* what) {
  int64_t seq = rd->GetI64();
  int32_t got = rd->GetI32();
  if (!rd->ok() || seq != current_seq_ || got != tag) {
    aborted_ = true;
    return Status::Error(StatusCode::ABORTED,
                         std::string("data plane desync in ") + what +
                             ": expected seq " +
                             std::to_string(current_seq_) + " tag " +
                             std::to_string(tag) + ", got seq " +
                             std::to_string(seq) + " tag " +
                             std::to_string(got));
  }
  return Status::OK();
}

Status SocketController::ExchangeStep(std::vector<Socket>& socks, int send_to,
                                      const std::string& frame,
                                      int recv_from, std::string* in) {
  if (aborted_) return Status::Error(StatusCode::ABORTED, "controller down");
  if (FaultInjectionOn()) {
    FaultAction fa = FaultCheck(kFaultRingSend, cfg_.rank);
    if (fa == FaultAction::kDrop) {
      socks[send_to].Close();
    } else if (fa == FaultAction::kTruncate) {
      // Length prefix + half the payload, then cut: the peer sees a
      // mid-frame EOF instead of a clean close.
      uint32_t len = static_cast<uint32_t>(frame.size());
      socks[send_to].SendAll(&len, 4);
      socks[send_to].SendAll(frame.data(), frame.size() / 2);
      socks[send_to].Close();
    }
    fa = FaultCheck(kFaultRingRecv, cfg_.rank);
    if (fa == FaultAction::kDrop || fa == FaultAction::kTruncate) {
      socks[recv_from].Close();
    }
  }
  CountSend(send_to, static_cast<int64_t>(frame.size()));
  if (!DuplexExchange(socks[send_to], frame, socks[recv_from], in,
                      [this] { return aborted_.load(); })) {
    aborted_ = true;
    return Status::Error(StatusCode::ABORTED,
                         "data plane exchange failed (send->" +
                             std::to_string(send_to) + ", recv<-" +
                             std::to_string(recv_from) + ")");
  }
  return Status::OK();
}

Status SocketController::ChunkedStep(
    std::vector<Socket>& socks, int send_to, const char* send_base,
    int64_t send_len, int recv_from, int64_t recv_len, char* recv_dest,
    int32_t tag, int64_t chunk_bytes,
    const std::function<void(int64_t, const char*, int64_t)>& consume,
    int64_t raw_len) {
  if (aborted_) return Status::Error(StatusCode::ABORTED, "controller down");
  Writer w;
  PutFrameHeader(&w, current_seq_, tag);
  const int64_t hdr = static_cast<int64_t>(w.data().size());
  if (FaultInjectionOn()) {
    FaultAction fa = FaultCheck(kFaultRingSend, cfg_.rank);
    if (fa == FaultAction::kDrop) {
      socks[send_to].Close();
    } else if (fa == FaultAction::kTruncate) {
      // Frame a full first chunk but deliver only half its payload, then
      // cut: the peer dies mid-chunk, not at a frame boundary.
      const int64_t cb = chunk_bytes > 0 ? chunk_bytes : (1 << 19);
      const int64_t chunk = std::min<int64_t>(send_len, cb);
      uint32_t flen = static_cast<uint32_t>(hdr + chunk);
      socks[send_to].SendAll(&flen, 4);
      socks[send_to].SendAll(w.data().data(), w.data().size());
      if (chunk > 0) socks[send_to].SendAll(send_base, chunk / 2);
      socks[send_to].Close();
    }
    fa = FaultCheck(kFaultRingRecv, cfg_.rank);
    if (fa == FaultAction::kDrop || fa == FaultAction::kTruncate) {
      socks[recv_from].Close();
    }
  }
  CountSend(send_to, send_len + hdr,
            (raw_len < 0 ? send_len : raw_len) + hdr);
  if (FlightOn()) FlightRecord(kFlightRingHop, tag, send_len + hdr);
  const double hop_t0 =
      (MetricsOn() || StepTraceOn()) ? MonotonicSeconds() : 0.0;
  ChunkExchangeError err;
  if (!ChunkedDuplexExchange(socks[send_to], send_base, send_len,
                             socks[recv_from], recv_len, chunk_bytes,
                             w.data(), recv_dest, consume,
                             [this] { return aborted_.load(); }, &err)) {
    aborted_ = true;
    if (err.kind == ChunkExchangeError::kHeaderMismatch) {
      Reader rd(err.got_header);
      int64_t seq = rd.GetI64();
      int32_t got = rd.GetI32();
      return Status::Error(
          StatusCode::ABORTED,
          "data plane desync in pipelined ring: expected seq " +
              std::to_string(current_seq_) + " tag " + std::to_string(tag) +
              ", got seq " + std::to_string(seq) + " tag " +
              std::to_string(got));
    }
    if (err.kind == ChunkExchangeError::kBadLength) {
      return Status::Error(
          StatusCode::ABORTED,
          "data plane desync in pipelined ring: bad chunk length " +
              std::to_string(err.bad_length) + " (seq " +
              std::to_string(current_seq_) + " tag " + std::to_string(tag) +
              ")");
    }
    return Status::Error(StatusCode::ABORTED,
                         "pipelined ring exchange failed (send->" +
                             std::to_string(send_to) + ", recv<-" +
                             std::to_string(recv_from) + ")");
  }
  if (hop_t0 > 0.0) {
    const double hop_s = MonotonicSeconds() - hop_t0;
    if (MetricsOn()) GlobalMetrics().ring_hop_us.ObserveSeconds(hop_s);
    StepTraceAddPhaseUs(kPhaseRing, static_cast<int64_t>(hop_s * 1e6));
  }
  return Status::OK();
}

Status SocketController::PipelinedReducePhase(
    std::vector<Socket>& socks, const std::vector<int>& members, int idx,
    int vidx, char* base, const std::vector<int64_t>& offs, DataType dtype,
    ReduceOp op, int32_t tag_base, int64_t chunkb) {
  const int m = static_cast<int>(members.size());
  const int item = ItemSize(dtype);
  const int next = members[(idx + 1) % m];
  const int prev = members[(idx - 1 + m) % m];
  std::vector<char> scratch;
  for (int s2 = 0; s2 < m - 1; ++s2) {
    const int send_c = ((vidx - s2) % m + m) % m;
    const int recv_c = ((vidx - s2 - 1) % m + m) % m;
    const int64_t rbytes = (offs[recv_c + 1] - offs[recv_c]) * item;
    if (static_cast<int64_t>(scratch.size()) < rbytes) {
      scratch.resize(static_cast<size_t>(rbytes));
    }
    char* seg = base + offs[recv_c] * item;
    int64_t reduced = 0;
    auto consume = [&](int64_t off, const char* /*data*/, int64_t nb) {
      // Reduce every fully-received element so far; the peer's chunking
      // need not be element-aligned (its HOROVOD_RING_CHUNK_BYTES may
      // differ), so carry any partial element to the next chunk.
      const int64_t avail = (off + nb) / item * item;
      if (avail > reduced) {
        ReduceInto(seg + reduced, scratch.data() + reduced,
                   (avail - reduced) / item, dtype, op);
        reduced = avail;
      }
    };
    Status st = ChunkedStep(socks, next,
                            base + offs[send_c] * item,
                            (offs[send_c + 1] - offs[send_c]) * item, prev,
                            rbytes, scratch.data(), tag_base + s2, chunkb,
                            consume);
    if (!st.ok()) return st;
  }
  return Status::OK();
}

Status SocketController::RingAllreduce(std::vector<Socket>& socks, void* buf,
                                       int64_t count, DataType dtype,
                                       ReduceOp op,
                                       const std::vector<int>& members,
                                       int idx) {
  const int m = static_cast<int>(members.size());
  if (m == 1) return Status::OK();
  char* base = static_cast<char*>(buf);
  const int item = ItemSize(dtype);
  const int64_t chunk = count / m, rem = count % m;
  auto start = [&](int c) { return c * chunk + std::min<int64_t>(c, rem); };
  auto len = [&](int c) { return start(c + 1) - start(c); };
  const int next = members[(idx + 1) % m];
  const int prev = members[(idx - 1 + m) % m];

  if (ring_chunk_bytes_ > 0) {
    // Pipelined (Gloo segmented-ring) path: each hop streams the segment
    // in element-aligned chunks straight from/into the user buffer —
    // no full-segment copies — and reduces each received chunk while the
    // kernel keeps moving later chunks, so compute overlaps the wire.
    const int64_t chunkb =
        std::max<int64_t>(item, ring_chunk_bytes_ / item * item);
    // Phase 1: ring reduce-scatter with in-flight reduction.
    std::vector<int64_t> offs(m + 1, 0);
    for (int c = 0; c < m; ++c) offs[c + 1] = start(c + 1);
    Status st = PipelinedReducePhase(socks, members, idx, idx, base, offs,
                                     dtype, op, kTagReduceScatter, chunkb);
    if (!st.ok()) return st;
    // Phase 2: ring allgather, received straight into place (zero-copy in
    // both directions).
    for (int s = 0; s < m - 1; ++s) {
      const int send_c = ((idx + 1 - s) % m + m) % m;
      const int recv_c = ((idx - s) % m + m) % m;
      Status st = ChunkedStep(socks, next, base + start(send_c) * item,
                              len(send_c) * item, prev, len(recv_c) * item,
                              base + start(recv_c) * item,
                              kTagAllgatherPhase + s, chunkb, nullptr);
      if (!st.ok()) return st;
    }
    return Status::OK();
  }

  // Legacy whole-segment path (HOROVOD_RING_CHUNK_BYTES=0).
  // Phase 1: ring reduce-scatter.  After m-1 steps this rank holds the
  // fully reduced chunk (idx+1)%m.
  for (int s = 0; s < m - 1; ++s) {
    const int send_c = ((idx - s) % m + m) % m;
    const int recv_c = ((idx - s - 1) % m + m) % m;
    Writer w;
    PutFrameHeader(&w, current_seq_, kTagReduceScatter + s);
    w.PutRaw(base + start(send_c) * item, len(send_c) * item);
    std::string in;
    Status st = ExchangeStep(socks, next, w.data(), prev, &in);
    if (!st.ok()) return st;
    Reader rd(in);
    st = CheckFrameHeader(&rd, kTagReduceScatter + s, "ring reduce-scatter");
    if (!st.ok()) return st;
    if (static_cast<int64_t>(rd.remaining()) != len(recv_c) * item) {
      aborted_ = true;
      return Status::Error(StatusCode::ABORTED,
                           "ring reduce-scatter chunk size mismatch");
    }
    ReduceInto(base + start(recv_c) * item, rd.cursor(), len(recv_c), dtype,
               op);
  }
  // Phase 2: ring allgather of the reduced chunks.
  for (int s = 0; s < m - 1; ++s) {
    const int send_c = ((idx + 1 - s) % m + m) % m;
    const int recv_c = ((idx - s) % m + m) % m;
    Writer w;
    PutFrameHeader(&w, current_seq_, kTagAllgatherPhase + s);
    w.PutRaw(base + start(send_c) * item, len(send_c) * item);
    std::string in;
    Status st = ExchangeStep(socks, next, w.data(), prev, &in);
    if (!st.ok()) return st;
    Reader rd(in);
    st = CheckFrameHeader(&rd, kTagAllgatherPhase + s, "ring allgather");
    if (!st.ok()) return st;
    if (static_cast<int64_t>(rd.remaining()) != len(recv_c) * item) {
      aborted_ = true;
      return Status::Error(StatusCode::ABORTED,
                           "ring allgather chunk size mismatch");
    }
    std::memcpy(base + start(recv_c) * item, rd.cursor(), len(recv_c) * item);
  }
  return Status::OK();
}

bool SocketController::RingAllCrossHost(const std::vector<int>& members) const {
  const int m = static_cast<int>(members.size());
  if (m < 2 || host_keys_.empty()) return false;
  for (int i = 0; i < m; ++i) {
    if (host_keys_[members[i]] == host_keys_[members[(i + 1) % m]]) {
      return false;
    }
  }
  return true;
}

bool SocketController::WireCompAvailable() {
  if (HierFor(0) != nullptr) return true;  // leader ring is all-cross-host
  if (ShmFor(0) != nullptr) return false;  // shm plane: no wire at all
  std::vector<int> all(cfg_.size);
  for (int i = 0; i < cfg_.size; ++i) all[i] = i;
  return RingAllCrossHost(all);
}

Status SocketController::CompressedRingAllreduce(
    std::vector<Socket>& socks, void* buf, int64_t count, ReduceOp op,
    const std::vector<int>& members, int idx, WireCodec codec) {
  const int m = static_cast<int>(members.size());
  if (m == 1) return Status::OK();
  if (codec == WireCodec::kNone) {
    return RingAllreduce(socks, buf, count, DataType::FLOAT32, op, members,
                         idx);
  }
  if (FlightOn()) {
    FlightRecord(kFlightWireCodec, static_cast<int32_t>(codec),
                 count * static_cast<int64_t>(sizeof(float)));
  }
  float* base = static_cast<float*>(buf);
  const int64_t chunk = count / m, rem = count % m;
  auto start = [&](int c) { return c * chunk + std::min<int64_t>(c, rem); };
  auto len = [&](int c) { return start(c + 1) - start(c); };
  const int next = members[(idx + 1) % m];
  const int prev = members[(idx - 1 + m) % m];
  // The compressed ring is always chunk-pipelined (the legacy
  // whole-segment path predates it and stays raw); chunk boundaries are
  // byte-level, the decode carry below handles partial int8 blocks.
  const int64_t chunkb =
      ring_chunk_bytes_ > 0 ? ring_chunk_bytes_ : (1 << 19);
  const int64_t maxseg = chunk + (rem > 0 ? 1 : 0);
  std::vector<char> enc_send(
      static_cast<size_t>(WireEncodedBytes(codec, maxseg)));
  std::vector<char> enc_recv(enc_send.size());
  std::vector<float> stage(static_cast<size_t>(maxseg));

  // Phase 1: reduce-scatter.  Every hop re-encodes the CURRENT fp32
  // partial sums (one fresh quantization per hop) and the receiver
  // decodes to fp32 before accumulating — so after m-1 hops each element
  // carries at most (m-1) single-quantization errors, never an error of
  // a quantized partial sum re-quantized.
  for (int s = 0; s < m - 1; ++s) {
    const int send_c = ((idx - s) % m + m) % m;
    const int recv_c = ((idx - s - 1) % m + m) % m;
    const int64_t selems = len(send_c), relems = len(recv_c);
    WireEncode(codec, base + start(send_c), selems, enc_send.data());
    float* seg = base + start(recv_c);
    int64_t decoded = 0;
    auto consume = [&](int64_t off, const char* /*data*/, int64_t nb) {
      // Decode every fully-received element so far (the peer's chunking
      // is byte-, not block-aligned; carry partial blocks forward).
      const int64_t avail = WireDecodableElems(codec, off + nb, relems);
      if (avail > decoded) {
        WireDecodeRange(codec, enc_recv.data(), relems, decoded, avail,
                        stage.data());
        ReduceInto(seg + decoded, stage.data(), avail - decoded,
                   DataType::FLOAT32, op);
        decoded = avail;
      }
    };
    Status st = ChunkedStep(socks, next, enc_send.data(),
                            WireEncodedBytes(codec, selems), prev,
                            WireEncodedBytes(codec, relems), enc_recv.data(),
                            kTagCompReduceScatter + s, chunkb, consume,
                            /*raw_len=*/4 * selems);
    if (!st.ok()) return st;
  }

  // Phase 2: allgather.  The owner of each finished segment encodes it
  // ONCE; every later hop forwards those encoded bytes verbatim and the
  // owner itself decodes its own encoding — so all m members decode the
  // identical stream and the results are bit-identical across ranks
  // (one quantization total in this phase, regardless of ring length).
  const int own_c = (idx + 1) % m;
  WireEncode(codec, base + start(own_c), len(own_c), enc_send.data());
  WireDecodeRange(codec, enc_send.data(), len(own_c), 0, len(own_c), stage.data());
  std::memcpy(base + start(own_c), stage.data(),
              static_cast<size_t>(4 * len(own_c)));
  for (int s = 0; s < m - 1; ++s) {
    const int send_c = ((idx + 1 - s) % m + m) % m;
    const int recv_c = ((idx - s) % m + m) % m;
    const int64_t relems = len(recv_c);
    float* seg = base + start(recv_c);
    int64_t decoded = 0;
    auto consume = [&](int64_t off, const char* /*data*/, int64_t nb) {
      const int64_t avail = WireDecodableElems(codec, off + nb, relems);
      if (avail > decoded) {
        WireDecodeRange(codec, enc_recv.data(), relems, decoded, avail,
                        seg + decoded);
        decoded = avail;
      }
    };
    Status st = ChunkedStep(socks, next, enc_send.data(),
                            WireEncodedBytes(codec, len(send_c)), prev,
                            WireEncodedBytes(codec, relems), enc_recv.data(),
                            kTagCompAllgather + s, chunkb, consume,
                            /*raw_len=*/4 * len(send_c));
    if (!st.ok()) return st;
    // What we just received is exactly what we forward next hop
    // (send_c at step s+1 == recv_c at step s): swap, don't re-encode.
    std::swap(enc_send, enc_recv);
  }
  return Status::OK();
}

Status SocketController::AllreduceBuffer(void* buf, int64_t count,
                                         DataType dtype, ReduceOp op,
                                         int psid) {
  if (aborted_) return Status::Error(StatusCode::ABORTED, "controller down");
  std::vector<int> members;
  int idx;
  Status st = Members(psid, &members, &idx);
  if (!st.ok()) return st;
  if (members.size() > 1) {
    // Plane refinement: engaged only when THIS seq's response carried the
    // coordinator's hier bit / wire codec (recorded in the cycle), so the
    // choice is identical on every member.  Direct calls (seq -1,
    // selftests) and unmarked seqs keep today's behavior.
    PlaneChoice plane;
    {
      std::lock_guard<std::mutex> l(hier_mu_);
      auto it = plane_by_seq_.find(current_seq_);
      if (it != plane_by_seq_.end()) {
        plane = it->second;
        plane_by_seq_.erase(it);
      }
    }
    if (plane.hier) {
      if (HierTopo* topo = HierFor(psid)) {
        return HierAllreduce(*topo, SocksFor(psid), buf, count, dtype, op,
                             plane.wire);
      }
    }
    if (ShmRegion* shm = ShmFor(psid)) {
      return ShmAllreduce(*shm, SocksFor(psid), members, idx, buf, count,
                          dtype, op);
    }
    if (plane.wire != WireCodec::kNone && dtype == DataType::FLOAT32) {
      return CompressedRingAllreduce(SocksFor(psid), buf, count, op, members,
                                     idx, plane.wire);
    }
  }
  return RingAllreduce(SocksFor(psid), buf, count, dtype, op, members, idx);
}

Status SocketController::ReduceScatterBuffer(
    void* buf, int64_t count, DataType dtype, ReduceOp op,
    const std::vector<int64_t>& slice_counts, int psid) {
  if (aborted_) return Status::Error(StatusCode::ABORTED, "controller down");
  std::vector<int> members;
  int idx;
  Status st = Members(psid, &members, &idx);
  if (!st.ok()) return st;
  const int m = static_cast<int>(members.size());
  if (static_cast<int>(slice_counts.size()) != m) {
    return Status::Error(StatusCode::INVALID_ARGUMENT,
                         "reducescatter slice_counts length != set size");
  }
  int64_t total = 0;
  for (int64_t c : slice_counts) total += c;
  if (total != count) {
    return Status::Error(StatusCode::INVALID_ARGUMENT,
                         "reducescatter slice_counts do not sum to count");
  }
  if (m == 1) return Status::OK();
  if (ShmRegion* shm = ShmFor(psid)) {
    // Same-host: the shm allreduce is one region write + segment reduce
    // per member; the caller slices.  (A slice-only shm variant would
    // save only the readback of the other slices.)
    return ShmAllreduce(*shm, SocksFor(psid), members, idx, buf, count,
                        dtype, op);
  }
  // Ring reduce-scatter over the CALLER's slice boundaries (the Horovod
  // row-split rule), phase 1 of the ring allreduce only: each rank moves
  // (m-1)/m of the buffer instead of the allreduce's 2(m-1)/m.  The
  // schedule runs in a shifted index space (vidx = idx-1) so this rank
  // finishes owning ITS slice (the standard ring leaves rank j with
  // chunk j+1).  This op always uses the chunked wire format — it has no
  // legacy framing, so per-rank HOROVOD_RING_CHUNK_BYTES (even 0) stays
  // interoperable.
  char* base = static_cast<char*>(buf);
  const int item = ItemSize(dtype);
  std::vector<int64_t> offs(m + 1, 0);
  for (int c = 0; c < m; ++c) offs[c + 1] = offs[c] + slice_counts[c];
  const int vidx = (idx - 1 + m) % m;
  const int64_t want = ring_chunk_bytes_ > 0 ? ring_chunk_bytes_
                                             : (int64_t{1} << 19);
  const int64_t chunkb = std::max<int64_t>(item, want / item * item);
  return PipelinedReducePhase(SocksFor(psid), members, idx, vidx, base,
                              offs, dtype, op, kTagReduceScatterOp, chunkb);
}

Status SocketController::AllgatherBuffer(const void* in, int64_t nbytes,
                                         int psid, std::string* out,
                                         std::vector<int64_t>* per_rank) {
  if (aborted_) return Status::Error(StatusCode::ABORTED, "controller down");
  std::vector<int> members;
  int idx;
  Status st = Members(psid, &members, &idx);
  if (!st.ok()) return st;
  const int m = static_cast<int>(members.size());
  if (m == 1) {
    out->assign(static_cast<const char*>(in), nbytes);
    per_rank->assign(1, nbytes);
    return Status::OK();
  }
  std::vector<Socket>& socks = SocksFor(psid);
  if (ShmRegion* shm = ShmFor(psid)) {
    return ShmAllgather(*shm, socks, members, idx, in, nbytes, out,
                        per_rank);
  }
  const int next = members[(idx + 1) % m];
  const int prev = members[(idx - 1 + m) % m];

  if (ring_chunk_bytes_ > 0) {
    // Pipelined path: a cheap size ring first (8-byte frames on the same
    // schedule), then m-1 chunk-pipelined hops whose payloads stream
    // straight between the output concatenation's block slots — zero
    // block copies, reduce-free cousin of the pipelined ring allreduce.
    //
    // Tradeoff: the up-front size ring adds m-1 tiny serialized steps vs
    // the legacy in-band path.  The ragged zero-copy layout needs every
    // size before the output can be allocated, a payload-size switch
    // would desync (nbytes legally differs per rank), and for small
    // allgathers the negotiation round trip dominates those 8-byte hops
    // anyway; large ones win back block-sized copies per hop.
    std::vector<int64_t> sizes(m, 0);
    sizes[idx] = nbytes;
    for (int s2 = 0; s2 < m - 1; ++s2) {
      const int send_b = ((idx - s2) % m + m) % m;
      const int recv_b = ((idx - s2 - 1) % m + m) % m;
      Writer w;
      PutFrameHeader(&w, current_seq_, kTagAllgatherSize + s2);
      w.PutI64(sizes[send_b]);
      std::string in_frame;
      st = ExchangeStep(socks, next, w.data(), prev, &in_frame);
      if (!st.ok()) return st;
      Reader rd(in_frame);
      st = CheckFrameHeader(&rd, kTagAllgatherSize + s2, "allgather sizes");
      if (!st.ok()) return st;
      sizes[recv_b] = rd.GetI64();
      if (!rd.ok() || sizes[recv_b] < 0) {
        aborted_ = true;
        return Status::Error(StatusCode::ABORTED,
                             "allgather size ring desync");
      }
    }
    std::vector<int64_t> offs(m + 1, 0);
    for (int b = 0; b < m; ++b) offs[b + 1] = offs[b] + sizes[b];
    out->resize(static_cast<size_t>(offs[m]));
    char* base = out->empty() ? nullptr : &(*out)[0];
    if (nbytes > 0) std::memcpy(base + offs[idx], in, nbytes);
    for (int s2 = 0; s2 < m - 1; ++s2) {
      const int send_b = ((idx - s2) % m + m) % m;
      const int recv_b = ((idx - s2 - 1) % m + m) % m;
      st = ChunkedStep(socks, next, base + offs[send_b], sizes[send_b],
                       prev, sizes[recv_b], base + offs[recv_b],
                       kTagAllgather + s2, ring_chunk_bytes_, nullptr);
      if (!st.ok()) return st;
    }
    per_rank->assign(sizes.begin(), sizes.end());
    return Status::OK();
  }

  // Legacy whole-block path (HOROVOD_RING_CHUNK_BYTES=0): per-rank sizes
  // carried in-band; step s passes block (idx - s) along the ring.
  std::vector<std::string> blocks(m);
  blocks[idx].assign(static_cast<const char*>(in), nbytes);
  for (int s = 0; s < m - 1; ++s) {
    const int send_b = ((idx - s) % m + m) % m;
    const int recv_b = ((idx - s - 1) % m + m) % m;
    Writer w;
    PutFrameHeader(&w, current_seq_, kTagAllgather + s);
    w.PutRaw(blocks[send_b].data(), blocks[send_b].size());
    std::string frame;
    st = ExchangeStep(socks, next, w.data(), prev, &frame);
    if (!st.ok()) return st;
    Reader rd(frame);
    st = CheckFrameHeader(&rd, kTagAllgather + s, "allgather");
    if (!st.ok()) return st;
    blocks[recv_b].assign(rd.cursor(), rd.remaining());
  }
  out->clear();
  per_rank->clear();
  for (int b = 0; b < m; ++b) {
    per_rank->push_back(static_cast<int64_t>(blocks[b].size()));
    out->append(blocks[b]);
  }
  return Status::OK();
}

Status SocketController::BroadcastBuffer(void* buf, int64_t nbytes,
                                         int root_rank, int psid) {
  if (aborted_) return Status::Error(StatusCode::ABORTED, "controller down");
  std::vector<int> members;
  int idx;
  Status st = Members(psid, &members, &idx);
  if (!st.ok()) return st;
  const int m = static_cast<int>(members.size());
  if (m == 1) return Status::OK();
  std::vector<Socket>& socks = SocksFor(psid);
  auto root_it = std::find(members.begin(), members.end(), root_rank);
  if (root_it == members.end()) {
    return Status::Error(StatusCode::INVALID_ARGUMENT,
                         "broadcast root " + std::to_string(root_rank) +
                             " not in process set");
  }
  const int root_idx = static_cast<int>(root_it - members.begin());
  if (ShmRegion* shm = ShmFor(psid)) {
    return ShmBroadcast(*shm, socks, members, idx, root_idx, buf, nbytes);
  }
  const int vrank = (idx - root_idx + m) % m;

  // Large payloads: pipelined chain in vrank order.  Every member sends
  // nbytes exactly once and chunks stream hop to hop through kernel
  // socket buffers, so all hops overlap and wall time approaches one
  // N/B transfer — the binomial tree costs the root N*log2(m) egress
  // and serializes tree levels per whole buffer.  Payloads this large
  // are the broadcast_parameters case this path exists for; small
  // payloads keep the tree's fewer hop latencies.
  if (ring_chunk_bytes_ > 0 && m > 2 && nbytes >= kBroadcastChainBytes) {
    char* base = static_cast<char*>(buf);
    const int src =
        vrank > 0 ? members[(root_idx + vrank - 1) % m] : -1;
    const int nxt = vrank + 1 < m ? members[(root_idx + vrank + 1) % m] : -1;
    Socket* next_sock = nxt >= 0 ? &socks[nxt] : nullptr;
    // Geometry header: [seq|tag|nbytes] hops ahead of the raw chunk
    // stream so a size mismatch aborts before any payload bytes land.
    if (src >= 0) {
      std::string frame;
      if (!socks[src].RecvFrame(&frame)) {
        aborted_ = true;
        // Mirror of the send-side fail-fast: our downstream is blocked in
        // RecvAll with no abort polling; closing its socket propagates the
        // failure down the chain immediately instead of leaving it wedged
        // until job-level teardown.
        if (next_sock) next_sock->Close();
        return Status::Error(StatusCode::ABORTED,
                             "broadcast chain recv from rank " +
                                 std::to_string(src) + " failed");
      }
      Reader rd(frame);
      st = CheckFrameHeader(&rd, kTagBroadcastChain, "broadcast chain");
      if (!st.ok()) {
        // Our upstream is mid-SendAll of the raw stream with no abort
        // polling; closing the socket fails it fast instead of letting it
        // block on full kernel buffers until process teardown.  The
        // downstream is symmetric: it blocks in RecvAll.
        socks[src].Close();
        if (next_sock) next_sock->Close();
        return st;
      }
      int64_t peer_bytes = rd.GetI64();
      if (!rd.ok() || peer_bytes != nbytes) {
        aborted_ = true;
        socks[src].Close();
        if (next_sock) next_sock->Close();
        return Status::Error(StatusCode::ABORTED,
                             "broadcast size mismatch across ranks");
      }
    }
    if (next_sock) {
      Writer w;
      PutFrameHeader(&w, current_seq_, kTagBroadcastChain);
      w.PutI64(nbytes);
      CountSend(nxt, static_cast<int64_t>(w.data().size()) + nbytes);
      if (!next_sock->SendFrame(w.data())) {
        aborted_ = true;
        return Status::Error(StatusCode::ABORTED,
                             "broadcast chain header send failed");
      }
    }
    for (int64_t off = 0; off < nbytes; off += ring_chunk_bytes_) {
      const int64_t n = std::min<int64_t>(ring_chunk_bytes_, nbytes - off);
      if (src >= 0 && !socks[src].RecvAll(base + off, n)) {
        aborted_ = true;
        // Fail the blocked downstream RecvAll fast (see header path).
        if (next_sock) next_sock->Close();
        return Status::Error(StatusCode::ABORTED,
                             "broadcast chain recv from rank " +
                                 std::to_string(src) + " failed");
      }
      if (next_sock && !next_sock->SendAll(base + off, n)) {
        aborted_ = true;
        // Same fail-fast rule as the header paths: our upstream has no
        // abort polling inside SendAll, so cut its stream rather than
        // letting it block on full kernel buffers.
        if (src >= 0) socks[src].Close();
        return Status::Error(StatusCode::ABORTED,
                             "broadcast chain send failed");
      }
    }
    return Status::OK();
  }

  // Binomial tree: log2(m) rounds; parent sends after it has the payload.
  int mask = 1;
  while (mask < m) {
    if (vrank & mask) {
      const int src = members[(root_idx + vrank - mask) % m];
      std::string frame;
      if (!socks[src].RecvFrame(&frame)) {
        aborted_ = true;
        return Status::Error(StatusCode::ABORTED,
                             "broadcast recv from rank " +
                                 std::to_string(src) + " failed");
      }
      Reader rd(frame);
      st = CheckFrameHeader(&rd, kTagBroadcast, "broadcast");
      if (!st.ok()) return st;
      if (static_cast<int64_t>(rd.remaining()) != nbytes) {
        aborted_ = true;
        return Status::Error(StatusCode::ABORTED,
                             "broadcast size mismatch across ranks");
      }
      std::memcpy(buf, rd.cursor(), nbytes);
      break;
    }
    mask <<= 1;
  }
  mask >>= 1;
  while (mask > 0) {
    if (vrank + mask < m) {
      const int dst = members[(root_idx + vrank + mask) % m];
      Writer w;
      PutFrameHeader(&w, current_seq_, kTagBroadcast);
      w.PutRaw(buf, nbytes);
      CountSend(dst, static_cast<int64_t>(w.data().size()));
      if (!socks[dst].SendFrame(w.data())) {
        aborted_ = true;
        return Status::Error(StatusCode::ABORTED,
                             "broadcast send to rank " + std::to_string(dst) +
                                 " failed");
      }
    }
    mask >>= 1;
  }
  return Status::OK();
}

Status SocketController::AlltoallBuffer(const void* in,
                                        const std::vector<int64_t>& splits,
                                        int64_t row_bytes, int psid,
                                        std::string* out,
                                        std::vector<int64_t>* recv_splits) {
  if (aborted_) return Status::Error(StatusCode::ABORTED, "controller down");
  std::vector<int> members;
  int idx;
  Status st = Members(psid, &members, &idx);
  if (!st.ok()) return st;
  const int m = static_cast<int>(members.size());
  if (static_cast<int>(splits.size()) != m) {
    return Status::Error(StatusCode::INVALID_ARGUMENT,
                         "alltoall splits length != process set size");
  }
  std::vector<Socket>& socks = SocksFor(psid);
  if (m > 1) {
    if (ShmRegion* shm = ShmFor(psid)) {
      return ShmAlltoall(*shm, socks, members, idx, in, splits, row_bytes,
                         out, recv_splits);
    }
  }
  const char* base = static_cast<const char*>(in);
  std::vector<int64_t> offs(m + 1, 0);
  for (int j = 0; j < m; ++j) offs[j + 1] = offs[j] + splits[j];

  if (ring_chunk_bytes_ > 0) {
    // Pipelined path (same shape as the pipelined allgather): a pairwise
    // row-count exchange first — the ragged output layout needs every
    // count before it can be allocated — then chunk-pipelined pairwise
    // hops that stream each peer's rows straight into the output
    // concatenation's slot, with zero block copies.
    std::vector<int64_t> rows_from(m, 0);
    rows_from[idx] = splits[idx];
    for (int d = 1; d < m; ++d) {
      const int to_i = (idx + d) % m;
      const int from_i = (idx - d + m) % m;
      Writer w;
      PutFrameHeader(&w, current_seq_, kTagAlltoallSize + d);
      w.PutI64(splits[to_i]);
      std::string frame;
      st = ExchangeStep(socks, members[to_i], w.data(), members[from_i],
                        &frame);
      if (!st.ok()) return st;
      Reader rd(frame);
      st = CheckFrameHeader(&rd, kTagAlltoallSize + d, "alltoall sizes");
      if (!st.ok()) return st;
      rows_from[from_i] = rd.GetI64();
      if (!rd.ok() || rows_from[from_i] < 0) {
        aborted_ = true;
        return Status::Error(StatusCode::ABORTED,
                             "alltoall size exchange desync");
      }
    }
    std::vector<int64_t> roffs(m + 1, 0);
    for (int j = 0; j < m; ++j) roffs[j + 1] = roffs[j] + rows_from[j];
    out->resize(static_cast<size_t>(roffs[m] * row_bytes));
    char* obase = out->empty() ? nullptr : &(*out)[0];
    if (splits[idx] > 0) {
      std::memcpy(obase + roffs[idx] * row_bytes,
                  base + offs[idx] * row_bytes, splits[idx] * row_bytes);
    }
    for (int d = 1; d < m; ++d) {
      const int to_i = (idx + d) % m;
      const int from_i = (idx - d + m) % m;
      st = ChunkedStep(socks, members[to_i], base + offs[to_i] * row_bytes,
                       splits[to_i] * row_bytes, members[from_i],
                       rows_from[from_i] * row_bytes,
                       obase + roffs[from_i] * row_bytes, kTagAlltoall + d,
                       ring_chunk_bytes_, nullptr);
      if (!st.ok()) return st;
    }
    recv_splits->assign(rows_from.begin(), rows_from.end());
    return Status::OK();
  }

  // Legacy whole-block path (HOROVOD_RING_CHUNK_BYTES=0).
  std::vector<std::string> recv_bufs(m);
  std::vector<int64_t> rows_from(m, 0);
  recv_bufs[idx].assign(base + offs[idx] * row_bytes,
                        splits[idx] * row_bytes);
  rows_from[idx] = splits[idx];
  // Pairwise exchange: round d trades with the member d positions away in
  // each direction; the duplex step keeps the cycle deadlock-free.
  for (int d = 1; d < m; ++d) {
    const int to_i = (idx + d) % m;
    const int from_i = (idx - d + m) % m;
    Writer w;
    PutFrameHeader(&w, current_seq_, kTagAlltoall + d);
    w.PutI64(splits[to_i]);
    w.PutRaw(base + offs[to_i] * row_bytes, splits[to_i] * row_bytes);
    std::string frame;
    st = ExchangeStep(socks, members[to_i], w.data(), members[from_i],
                      &frame);
    if (!st.ok()) return st;
    Reader rd(frame);
    st = CheckFrameHeader(&rd, kTagAlltoall + d, "alltoall");
    if (!st.ok()) return st;
    int64_t rows = rd.GetI64();
    if (static_cast<int64_t>(rd.remaining()) != rows * row_bytes) {
      aborted_ = true;
      return Status::Error(StatusCode::ABORTED,
                           "alltoall payload size mismatch");
    }
    recv_bufs[from_i].assign(rd.cursor(), rd.remaining());
    rows_from[from_i] = rows;
  }
  out->clear();
  recv_splits->assign(rows_from.begin(), rows_from.end());
  for (int j = 0; j < m; ++j) out->append(recv_bufs[j]);
  return Status::OK();
}

Status SocketController::Barrier(int psid) {
  if (aborted_) return Status::Error(StatusCode::ABORTED, "controller down");
  std::vector<int> members;
  int idx;
  Status st = Members(psid, &members, &idx);
  if (!st.ok()) return st;
  return SockBarrier(SocksFor(psid), members, idx, kTagBarrier);
}

Status SocketController::SockBarrier(std::vector<Socket>& socks,
                                     const std::vector<int>& members,
                                     int idx, int32_t tag_base) {
  const int m = static_cast<int>(members.size());
  // Fence-wait metric: only the shm/hier phase fences (tag families at or
  // above kTagShmSize) — the public Barrier() is a user-visible collective,
  // not plane bookkeeping.
  const double fence_t0 =
      tag_base >= kTagShmSize && (MetricsOn() || StepTraceOn())
          ? MonotonicSeconds()
          : 0.0;
  if (FlightOn() && tag_base >= kTagShmSize) {
    FlightRecord(kFlightShmFence, tag_base, 0);
  }
  if (FaultInjectionOn()) {
    // shm-fence faults target the FENCE (not a specific peer socket):
    // drop/truncate close the next-neighbor link the first round uses, so
    // the whole fence collapses deterministically.
    FaultAction fa = FaultCheck(kFaultShmFence, cfg_.rank);
    if (fa == FaultAction::kDrop || fa == FaultAction::kTruncate) {
      if (m > 1) socks[members[(idx + 1) % m]].Close();
    }
  }
  // Dissemination barrier: ceil(log2(m)) duplex rounds.
  for (int k = 1; k < m; k <<= 1) {
    const int to = members[(idx + k) % m];
    const int from = members[(idx - k + m) % m];
    Writer w;
    PutFrameHeader(&w, current_seq_, tag_base + k);
    std::string frame;
    Status st = ExchangeStep(socks, to, w.data(), from, &frame);
    if (!st.ok()) return st;
    Reader rd(frame);
    st = CheckFrameHeader(&rd, tag_base + k, "barrier");
    if (!st.ok()) return st;
  }
  if (fence_t0 > 0.0) {
    const double fence_s = MonotonicSeconds() - fence_t0;
    if (MetricsOn()) GlobalMetrics().shm_fence_us.ObserveSeconds(fence_s);
    StepTraceAddPhaseUs(kPhaseFence, static_cast<int64_t>(fence_s * 1e6));
  }
  return Status::OK();
}

// ---------------------------------------------------------------------------
// Shared-memory plane (same-host members; see shm_plane.h)
// ---------------------------------------------------------------------------

bool SocketController::MembersAllLocal(const std::vector<int>& members) const {
  const char* disable = ::getenv("HOROVOD_SHM_DISABLE");
  if (disable && disable[0] == '1') return false;
  // The agreed host keys are the locality signal (identical on every rank,
  // honors the fake-host overrides); the loopback-address test remains as
  // a belt-and-braces check against a spoofed key colliding across real
  // hosts.
  for (int r : members) {
    if (r == cfg_.rank) continue;
    if (host_keys_[r] != host_keys_[cfg_.rank]) return false;
    const std::string& a = mesh_addrs_[r];
    if (a.rfind("127.", 0) != 0 && a != "localhost" && a != "::1") {
      return false;
    }
  }
  return true;
}

Status SocketController::MaybeOpenShm(int psid,
                                      const std::vector<int>& members) {
  const int m = static_cast<int>(members.size());
  if (m <= 1) return Status::OK();
  // The ATTEMPT decision itself must be agreed, not just the open result:
  // per-rank env/address views can diverge (HOROVOD_SHM_DISABLE set on one
  // worker only), and a rank that silently skips the handshake would
  // deadlock the ranks that run it.  So every member always runs the
  // handshake; a non-attempting member simply votes no.
  bool attempt = MembersAllLocal(members) &&
                 static_cast<int64_t>(m) * m * 8 <= ShmRegion::kHeaderBytes;
  auto it = std::find(members.begin(), members.end(), cfg_.rank);
  const int idx = static_cast<int>(it - members.begin());
  const bool creator = idx == 0;
  std::vector<Socket>& socks = SocksFor(psid);
  auto region = std::make_unique<ShmRegion>();
  std::string name =
      "/hvd_" + std::to_string(cfg_.rendezvous_port) + "_" +
      std::to_string(psid);
  Status open_st = Status::OK();
  if (creator && attempt) {
    open_st = region->Open(name, true);
  }
  Status st = SockBarrier(socks, members, idx, kTagShmOpen);
  if (!st.ok()) return st;
  if (!creator && attempt) {
    open_st = region->Open(name, false);
  }
  if (!attempt) {
    open_st = Status::Error(StatusCode::PRECONDITION_ERROR, "not attempted");
  }
  // Agree on the verdict: members send their flag to the set root, which
  // ANDs and broadcasts it back — either everyone uses the region or
  // everyone falls back to the TCP ring (a split plane would deadlock).
  uint8_t ok = open_st.ok() ? 1 : 0;
  if (creator) {
    uint8_t all_ok = ok;
    for (int j = 1; j < m; ++j) {
      std::string frame;
      if (!socks[members[j]].RecvFrame(&frame)) all_ok = 0;
      Reader rd(frame);
      int64_t seq = rd.GetI64();
      int32_t tag = rd.GetI32();
      (void)seq;
      if (!rd.ok() || tag != kTagShmVerdict || rd.remaining() < 1 ||
          rd.cursor()[0] == 0) {
        all_ok = 0;
      }
    }
    for (int j = 1; j < m; ++j) {
      Writer w;
      PutFrameHeader(&w, current_seq_, kTagShmVerdict);
      w.PutRaw(&all_ok, 1);
      if (!socks[members[j]].SendFrame(w.data())) {
        return Status::Error(StatusCode::ABORTED, "shm verdict send failed");
      }
    }
    ok = all_ok;
  } else {
    Writer w;
    PutFrameHeader(&w, current_seq_, kTagShmVerdict);
    w.PutRaw(&ok, 1);
    if (!socks[members[0]].SendFrame(w.data())) {
      return Status::Error(StatusCode::ABORTED, "shm verdict send failed");
    }
    std::string frame;
    if (!socks[members[0]].RecvFrame(&frame)) {
      return Status::Error(StatusCode::ABORTED, "shm verdict recv failed");
    }
    Reader rd(frame);
    rd.GetI64();
    int32_t tag = rd.GetI32();
    ok = (rd.ok() && tag == kTagShmVerdict && rd.remaining() >= 1)
             ? static_cast<uint8_t>(rd.cursor()[0])
             : 0;
  }
  if (!ok) {
    region->Close(creator);
    HVD_LOG(INFO) << "shm plane unavailable for psid " << psid
                  << "; using the TCP ring";
    return Status::OK();
  }
  std::lock_guard<std::mutex> l(channels_mu_);
  shm_[psid] = std::move(region);
  return Status::OK();
}

ShmRegion* SocketController::ShmFor(int psid) {
  std::lock_guard<std::mutex> l(channels_mu_);
  auto it = shm_.find(psid);
  return it == shm_.end() ? nullptr : it->second.get();
}

Status SocketController::ShmAllreduce(ShmRegion& shm,
                                      std::vector<Socket>& socks,
                                      const std::vector<int>& members,
                                      int idx, void* buf, int64_t count,
                                      DataType dtype, ReduceOp op) {
  const int m = static_cast<int>(members.size());
  const int item = ItemSize(dtype);
  const int64_t nbytes = count * item;
  auto grow_barrier = [&] {
    return SockBarrier(socks, members, idx, kTagShmGrow);
  };
  Status st = shm.EnsureCapacity((m + 1) * nbytes, idx == 0, grow_barrier);
  if (!st.ok()) return st;
  char* slots = shm.data();
  char* result = slots + m * nbytes;
  std::memcpy(slots + idx * nbytes, buf, nbytes);
  st = SockBarrier(socks, members, idx, kTagShmWrite);
  if (!st.ok()) return st;
  // Each member reduces segment `idx` across all slots into the result
  // area (same segmentation math as the TCP ring).
  const int64_t chunk = count / m, rem = count % m;
  auto start = [&](int c) { return c * chunk + std::min<int64_t>(c, rem); };
  const int64_t seg_off = start(idx) * item;
  const int64_t seg_len = (start(idx + 1) - start(idx));
  if (seg_len > 0) {
    std::memcpy(result + seg_off, slots + seg_off, seg_len * item);
    for (int j = 1; j < m; ++j) {
      ReduceInto(result + seg_off, slots + j * nbytes + seg_off, seg_len,
                 dtype, op);
    }
  }
  st = SockBarrier(socks, members, idx, kTagShmMid);
  if (!st.ok()) return st;
  std::memcpy(buf, result, nbytes);
  // Trailing fence: the next op's writes must not land while a peer is
  // still reading the result area.
  return SockBarrier(socks, members, idx, kTagShmRead);
}

Status SocketController::ShmBroadcast(ShmRegion& shm,
                                      std::vector<Socket>& socks,
                                      const std::vector<int>& members,
                                      int idx, int root_idx, void* buf,
                                      int64_t nbytes) {
  auto grow_barrier = [&] {
    return SockBarrier(socks, members, idx, kTagShmGrow);
  };
  Status st = shm.EnsureCapacity(nbytes, idx == 0, grow_barrier);
  if (!st.ok()) return st;
  if (idx == root_idx) std::memcpy(shm.data(), buf, nbytes);
  st = SockBarrier(socks, members, idx, kTagShmWrite);
  if (!st.ok()) return st;
  if (idx != root_idx) std::memcpy(buf, shm.data(), nbytes);
  return SockBarrier(socks, members, idx, kTagShmRead);
}

Status SocketController::ShmAllgather(ShmRegion& shm,
                                      std::vector<Socket>& socks,
                                      const std::vector<int>& members,
                                      int idx, const void* in, int64_t nbytes,
                                      std::string* out,
                                      std::vector<int64_t>* per_rank) {
  const int m = static_cast<int>(members.size());
  auto grow_barrier = [&] {
    return SockBarrier(socks, members, idx, kTagShmGrow);
  };
  int64_t* hdr = reinterpret_cast<int64_t*>(shm.header());
  hdr[idx] = nbytes;
  Status st = SockBarrier(socks, members, idx, kTagShmSize);
  if (!st.ok()) return st;
  // Offsets snapshot the header before any growth remaps the region.
  std::vector<int64_t> offs(m + 1, 0);
  for (int j = 0; j < m; ++j) offs[j + 1] = offs[j] + hdr[j];
  st = shm.EnsureCapacity(offs[m], idx == 0, grow_barrier);
  if (!st.ok()) return st;
  std::memcpy(shm.data() + offs[idx], in, nbytes);
  st = SockBarrier(socks, members, idx, kTagShmWrite);
  if (!st.ok()) return st;
  out->clear();
  per_rank->clear();
  out->reserve(offs[m]);
  for (int j = 0; j < m; ++j) {
    per_rank->push_back(offs[j + 1] - offs[j]);
    out->append(shm.data() + offs[j], offs[j + 1] - offs[j]);
  }
  return SockBarrier(socks, members, idx, kTagShmRead);
}

Status SocketController::ShmAlltoall(ShmRegion& shm,
                                     std::vector<Socket>& socks,
                                     const std::vector<int>& members, int idx,
                                     const void* in,
                                     const std::vector<int64_t>& splits,
                                     int64_t row_bytes, std::string* out,
                                     std::vector<int64_t>* recv_splits) {
  const int m = static_cast<int>(members.size());
  auto grow_barrier = [&] {
    return SockBarrier(socks, members, idx, kTagShmGrow);
  };
  int64_t* hdr = reinterpret_cast<int64_t*>(shm.header());
  for (int j = 0; j < m; ++j) hdr[idx * m + j] = splits[j];
  Status st = SockBarrier(socks, members, idx, kTagShmSize);
  if (!st.ok()) return st;
  // Snapshot the geometry BEFORE any growth: EnsureCapacity remaps the
  // region, so the header pointer must not be dereferenced after it.
  std::vector<int64_t> rows(hdr, hdr + m * m);
  // Row-major (src, dst) chunk offsets over the agreed geometry.
  std::vector<int64_t> offs(m * m + 1, 0);
  for (int k = 0; k < m * m; ++k) {
    offs[k + 1] = offs[k] + rows[k] * row_bytes;
  }
  st = shm.EnsureCapacity(offs[m * m], idx == 0, grow_barrier);
  if (!st.ok()) return st;
  const char* base = static_cast<const char*>(in);
  std::vector<int64_t> local_offs(m + 1, 0);
  for (int j = 0; j < m; ++j) local_offs[j + 1] = local_offs[j] + splits[j];
  for (int j = 0; j < m; ++j) {
    std::memcpy(shm.data() + offs[idx * m + j],
                base + local_offs[j] * row_bytes, splits[j] * row_bytes);
  }
  st = SockBarrier(socks, members, idx, kTagShmWrite);
  if (!st.ok()) return st;
  out->clear();
  recv_splits->clear();
  for (int i = 0; i < m; ++i) {
    const int64_t k = i * m + idx;
    recv_splits->push_back(rows[k]);
    out->append(shm.data() + offs[k], rows[k] * row_bytes);
  }
  return SockBarrier(socks, members, idx, kTagShmRead);
}

// ---------------------------------------------------------------------------
// Hierarchical allreduce: shm-local reduce -> leader ring -> shm broadcast
// (reference analog: NCCLHierarchicalAllreduce, SURVEY.md §2.2; the Awan
// et al. intra-node-reduce / inter-node-exchange design)
// ---------------------------------------------------------------------------

std::string SocketController::HostKey(int rank, int size) {
  // Explicit per-rank override first (the reference env name).
  if (const char* env = ::getenv("HOROVOD_HOSTNAME")) {
    if (env[0]) return env;
  }
  // Test hook: HOROVOD_HIER_FAKE_HOSTS=n partitions the job into n blocks
  // of consecutive ranks so one machine can emulate a multi-host topology
  // (mirrors real deployments, where consecutive ranks share a host).
  if (const char* env = ::getenv("HOROVOD_HIER_FAKE_HOSTS")) {
    char* end = nullptr;
    long n = std::strtol(env, &end, 10);
    if (end && *end == '\0' && n > 1 && size > 0) {
      int64_t h = static_cast<int64_t>(rank) * n / size;
      return "fakehost-" + std::to_string(h);
    }
  }
  char buf[256] = {0};
  if (::gethostname(buf, sizeof(buf) - 1) != 0) return "unknown-host";
  return buf;
}

void SocketController::CountSend(int to, int64_t wire_bytes,
                                 int64_t raw_bytes) {
  if (to < 0 || to >= static_cast<int>(host_keys_.size())) return;
  if (host_keys_[to] == host_keys_[cfg_.rank]) {
    data_sent_local_.fetch_add(wire_bytes, std::memory_order_relaxed);
    data_raw_local_.fetch_add(raw_bytes, std::memory_order_relaxed);
  } else {
    data_sent_xhost_.fetch_add(wire_bytes, std::memory_order_relaxed);
    data_raw_xhost_.fetch_add(raw_bytes, std::memory_order_relaxed);
  }
}

Status SocketController::MaybeSetupHier(int psid,
                                        const std::vector<int>& members) {
  const int m = static_cast<int>(members.size());
  if (m <= 1) return Status::OK();
  // Group members by agreed host key, first-appearance order over the
  // sorted member list: identical on every rank, and each group's first
  // member (its leader) ascends with the group index.
  std::vector<std::vector<int>> groups;
  std::map<std::string, int> group_of;
  for (int r : members) {
    auto it = group_of.find(host_keys_[r]);
    if (it == group_of.end()) {
      group_of.emplace(host_keys_[r], static_cast<int>(groups.size()));
      groups.push_back({r});
    } else {
      groups[it->second].push_back(r);
    }
  }
  size_t max_group = 0;
  for (const auto& grp : groups) max_group = std::max(max_group, grp.size());
  // Topology applicability is a pure function of the agreed book, so an
  // agreed skip here cannot desync: the composition only pays off with
  // >=2 hosts and at least one host holding co-located ranks.  The
  // degenerate 1-rank-per-host job never builds a topology and stays on
  // the flat ring by construction.
  if (groups.size() < 2 || max_group < 2) return Status::OK();

  HierTopo topo;
  const int my_group = group_of[host_keys_[cfg_.rank]];
  topo.local = groups[my_group];
  topo.local_idx = static_cast<int>(
      std::find(topo.local.begin(), topo.local.end(), cfg_.rank) -
      topo.local.begin());
  for (const auto& grp : groups) topo.leaders.push_back(grp[0]);
  auto lit = std::find(topo.leaders.begin(), topo.leaders.end(), cfg_.rank);
  topo.leader_idx = lit == topo.leaders.end()
                        ? -1
                        : static_cast<int>(lit - topo.leaders.begin());

  auto mit = std::find(members.begin(), members.end(), cfg_.rank);
  const int idx = static_cast<int>(mit - members.begin());
  std::vector<Socket>& socks = SocksFor(psid);

  // The intra-host phases need the subgroup shm region; per-rank state
  // (HOROVOD_SHM_DISABLE, an shm_open failure) may diverge, so every
  // member always runs the whole-set handshake and a single no vote
  // demotes the entire set back to the flat ring.
  const char* disable = ::getenv("HOROVOD_SHM_DISABLE");
  const bool attempt = !(disable && disable[0] == '1');
  const bool creator = topo.local_idx == 0;
  Status open_st = Status::OK();
  std::string name;
  if (topo.local.size() > 1) {
    topo.shm = std::make_unique<ShmRegion>();
    name = "/hvd_" + std::to_string(cfg_.rendezvous_port) + "_" +
           std::to_string(psid) + "_h" + std::to_string(my_group);
    if (creator && attempt) open_st = topo.shm->Open(name, true);
  }
  Status st = SockBarrier(socks, members, idx, kTagHierOpen);
  if (!st.ok()) return st;
  if (topo.shm && !creator && attempt) open_st = topo.shm->Open(name, false);
  if (topo.shm && !attempt) {
    open_st = Status::Error(StatusCode::PRECONDITION_ERROR, "not attempted");
  }
  // Whole-set agreed verdict through the set root (same shape as the shm
  // plane's): either every member keeps the topology or nobody does.
  uint8_t ok = open_st.ok() ? 1 : 0;
  if (idx == 0) {
    uint8_t all_ok = ok;
    for (int j = 1; j < m; ++j) {
      std::string frame;
      if (!socks[members[j]].RecvFrame(&frame)) all_ok = 0;
      Reader rd(frame);
      rd.GetI64();
      int32_t tag = rd.GetI32();
      if (!rd.ok() || tag != kTagHierVerdict || rd.remaining() < 1 ||
          rd.cursor()[0] == 0) {
        all_ok = 0;
      }
    }
    for (int j = 1; j < m; ++j) {
      Writer w;
      PutFrameHeader(&w, current_seq_, kTagHierVerdict);
      w.PutRaw(&all_ok, 1);
      if (!socks[members[j]].SendFrame(w.data())) {
        return Status::Error(StatusCode::ABORTED, "hier verdict send failed");
      }
    }
    ok = all_ok;
  } else {
    Writer w;
    PutFrameHeader(&w, current_seq_, kTagHierVerdict);
    w.PutRaw(&ok, 1);
    if (!socks[members[0]].SendFrame(w.data())) {
      return Status::Error(StatusCode::ABORTED, "hier verdict send failed");
    }
    std::string frame;
    if (!socks[members[0]].RecvFrame(&frame)) {
      return Status::Error(StatusCode::ABORTED, "hier verdict recv failed");
    }
    Reader rd(frame);
    rd.GetI64();
    int32_t tag = rd.GetI32();
    ok = (rd.ok() && tag == kTagHierVerdict && rd.remaining() >= 1)
             ? static_cast<uint8_t>(rd.cursor()[0])
             : 0;
  }
  if (!ok) {
    if (topo.shm) topo.shm->Close(creator);
    HVD_LOG(INFO) << "hierarchical allreduce unavailable for psid " << psid
                  << "; staying on the flat ring";
    return Status::OK();
  }
  HVD_LOG(INFO) << "hierarchical topology for psid " << psid << ": "
                << groups.size() << " hosts, " << topo.local.size()
                << " local member(s), leader rank " << topo.leaders[my_group];
  std::lock_guard<std::mutex> l(channels_mu_);
  hier_.emplace(psid, std::move(topo));
  return Status::OK();
}

SocketController::HierTopo* SocketController::HierFor(int psid) {
  std::lock_guard<std::mutex> l(channels_mu_);
  auto it = hier_.find(psid);
  return it == hier_.end() ? nullptr : &it->second;
}

Status SocketController::HierAllreduce(HierTopo& topo,
                                       std::vector<Socket>& socks, void* buf,
                                       int64_t count, DataType dtype,
                                       ReduceOp op, WireCodec codec) {
  const int ml = static_cast<int>(topo.local.size());
  const int item = ItemSize(dtype);
  const int64_t nbytes = count * item;
  char* ringbuf = static_cast<char*>(buf);
  if (ml > 1) {
    // Phase 1: shm-local reduce into the region's result area.  Same
    // layout and fences as ShmAllreduce (ml write slots + result), with
    // the segment reduce split across local members.
    ShmRegion& shm = *topo.shm;
    auto grow_barrier = [&] {
      return SockBarrier(socks, topo.local, topo.local_idx, kTagHierGrow);
    };
    Status st = shm.EnsureCapacity((ml + 1) * nbytes, topo.local_idx == 0,
                                   grow_barrier);
    if (!st.ok()) return st;
    char* slots = shm.data();
    char* result = slots + ml * nbytes;
    std::memcpy(slots + topo.local_idx * nbytes, buf, nbytes);
    st = SockBarrier(socks, topo.local, topo.local_idx, kTagHierWrite);
    if (!st.ok()) return st;
    const int64_t chunk = count / ml, rem = count % ml;
    auto start = [&](int c) { return c * chunk + std::min<int64_t>(c, rem); };
    const int64_t seg_off = start(topo.local_idx) * item;
    const int64_t seg_len = start(topo.local_idx + 1) - start(topo.local_idx);
    if (seg_len > 0) {
      std::memcpy(result + seg_off, slots + seg_off, seg_len * item);
      for (int j = 1; j < ml; ++j) {
        ReduceInto(result + seg_off, slots + j * nbytes + seg_off, seg_len,
                   dtype, op);
      }
    }
    st = SockBarrier(socks, topo.local, topo.local_idx, kTagHierMid);
    if (!st.ok()) return st;
    // The leader runs the cross-host ring directly on the shm result area.
    ringbuf = result;
  }
  // Phase 2: leader-only chunk-pipelined ring across hosts.  This is the
  // whole win: each host moves ~2N over the wire instead of every rank's
  // 2(np-1)/np*N.  Non-leaders skip straight to the fence.
  if (topo.leader_idx >= 0) {
    // Every leader-ring hop crosses hosts, so this is where the wire
    // codec engages (the shm-local phases above/below stay raw fp32).
    Status st =
        (codec != WireCodec::kNone && dtype == DataType::FLOAT32)
            ? CompressedRingAllreduce(socks, ringbuf, count, op,
                                      topo.leaders, topo.leader_idx, codec)
            : RingAllreduce(socks, ringbuf, count, dtype, op, topo.leaders,
                            topo.leader_idx);
    if (!st.ok()) return st;
  }
  if (ml > 1) {
    // Phase 3: shm-local broadcast — wait for the leader's ring, then
    // every local member copies the globally reduced result out.
    Status st = SockBarrier(socks, topo.local, topo.local_idx, kTagHierDone);
    if (!st.ok()) return st;
    std::memcpy(buf, topo.shm->data() + ml * nbytes, nbytes);
    // Trailing fence: the next op's slot writes must not land while a
    // peer is still reading the result area.
    return SockBarrier(socks, topo.local, topo.local_idx, kTagHierRead);
  }
  return Status::OK();
}

}  // namespace hvdtpu
