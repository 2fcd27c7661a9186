// C API + background cycle loop: the heart of the native core.
//
// Reference: horovod/common/operations.cc (horovod_init / EnqueueTensor* /
// InitializeHorovodOnce / BackgroundThreadLoop / RunLoopOnce) and
// global_state.h (HorovodGlobalState); SURVEY.md §2.1, §3.1-3.2.
//
// The Python layer (horovod_tpu/_core.py) drives this over ctypes:
//   hvd_enqueue(...)        -> framework thread submits named tensors
//   background thread       -> negotiates + fuses every cycle
//   hvd_pop_response(...)   -> executor thread pops fused responses (JSON)
//   hvd_*_buffer(...)       -> executor runs the host data plane
// Device (TPU) responses are executed in Python as jitted XLA collectives;
// the core guarantees every rank pops byte-identical response lists.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <sstream>
#include <thread>
#include <unordered_map>

#include "common.h"
#include "controller.h"
#include "fault_injection.h"
#include "fleet_telemetry.h"
#include "flight_recorder.h"
#include "logging.h"
#include "metrics.h"
#include "parameter_manager.h"
#include "socket_controller.h"
#include "step_trace.h"
#include "timeline.h"

namespace hvdtpu {

namespace {

int g_log_level = WARNING;

struct GlobalState {
  CoreConfig cfg;
  std::unique_ptr<Controller> controller;

  struct Outstanding {
    int64_t handle;
    double enqueued_at;  // for the stall-shutdown watchdog
  };

  std::mutex queue_mu;
  std::vector<TensorRequest> queue;
  std::unordered_map<std::string, Outstanding> outstanding;  // by name

  std::mutex out_mu;
  std::condition_variable out_cv;
  std::deque<std::string> out_responses;  // JSON lines for Python

  std::thread background;
  std::atomic<bool> shutdown{false};
  std::atomic<bool> background_done{false};
  std::atomic<bool> aborted{false};
  std::atomic<bool> join_inflight{false};

  Timeline timeline;
  ParameterManager params;
  std::atomic<int64_t> fusion_threshold{64LL << 20};
  double cycle_ms = 1.0;
  double last_stall_check = 0.0;
  std::string metrics_path;  // per-rank resolved HOROVOD_METRICS_FILE
  double last_metrics_write = 0.0;

  std::mutex err_mu;
  std::string last_error;
};

GlobalState* g = nullptr;

// Init failures tear down `g` before returning, which would leave
// hvd_last_error() answering "not initialized" — losing the reason
// (e.g. a malformed HOROVOD_FAULT_INJECT parse error) exactly when the
// caller needs it.  Failed-init reasons park here instead.
std::mutex init_err_mu;
std::string init_error;

void SetInitError(const std::string& msg) {
  std::lock_guard<std::mutex> l(init_err_mu);
  init_error = msg;
}

void SetLastError(const std::string& msg) {
  std::lock_guard<std::mutex> l(g->err_mu);
  g->last_error = msg;
}

std::string ResponseToJson(const Response& r) {
  std::ostringstream os;
  os << "{\"op\":" << static_cast<int>(r.op)
     << ",\"dtype\":" << static_cast<int>(r.dtype)
     << ",\"psid\":" << r.process_set_id << ",\"seq\":" << r.seq
     << ",\"cache_hit\":" << (r.cache_hit ? 1 : 0)
     << ",\"last_joined\":" << r.last_joined << ",\"error\":\""
     << JsonEscape(r.error) << "\",\"handles\":[";
  for (size_t i = 0; i < r.handles.size(); ++i) {
    if (i) os << ',';
    os << r.handles[i];
  }
  os << "]";
  // Negotiated data plane: 1 only when EVERY rank announced device
  // capability for every member (the coordinator ANDs the bits), so all
  // ranks dispatch the same cached jitted collective.
  bool device = !r.metas.empty();
  for (const auto& m : r.metas) device = device && m.device != 0;
  os << ",\"device\":" << (device ? 1 : 0);
  // Per-member element counts + reduce op: a joined rank has no local
  // entries yet must still walk the ring with a zero buffer of the right
  // size (hvd.join zero-contribution semantics).
  if (!r.metas.empty()) {
    os << ",\"counts\":[";
    for (size_t i = 0; i < r.metas.size(); ++i) {
      if (i) os << ',';
      os << r.metas[i].nbytes / ItemSize(r.metas[i].dtype);
    }
    os << "]";
  }
  os << "}";
  return os.str();
}

void DeliverResponse(const Response& r) {
  std::lock_guard<std::mutex> l(g->out_mu);
  g->out_responses.push_back(ResponseToJson(r));
  g->out_cv.notify_all();
}

void FailAllOutstanding(const std::string& reason) {
  Response err;
  err.error = reason;
  {
    std::lock_guard<std::mutex> l(g->queue_mu);
    for (auto& kv : g->outstanding) err.handles.push_back(kv.second.handle);
    g->outstanding.clear();
    for (auto& r : g->queue) err.handles.push_back(r.handle);
    g->queue.clear();
  }
  if (!err.handles.empty()) DeliverResponse(err);
}

std::string ControllerMetricsJson() {
  auto* sc = dynamic_cast<SocketController*>(g->controller.get());
  return sc ? sc->ClusterMetricsJson() : std::string();
}

// The registry's ctrl_* counters only accumulate while MetricsOn(), but the
// controller's own counters always run — a dump taken after metrics were
// toggled (or requested with metrics off) would render stale zeros.  Store
// the authoritative controller totals into the registry before rendering.
void SyncCtrlCountersToRegistry() {
  auto* sc = dynamic_cast<SocketController*>(g->controller.get());
  if (sc == nullptr) return;
  int64_t ms = 0, mr = 0, bs = 0, br = 0;
  sc->CtrlPlaneStats(&ms, &mr, &bs, &br);
  auto& m = GlobalMetrics();
  m.ctrl_msgs_sent.store(ms, std::memory_order_relaxed);
  m.ctrl_msgs_recv.store(mr, std::memory_order_relaxed);
  m.ctrl_bytes_sent.store(bs, std::memory_order_relaxed);
  m.ctrl_bytes_recv.store(br, std::memory_order_relaxed);
}

// Atomic (write-then-rename) so a reader never sees a torn snapshot.
void WriteMetricsFile() {
  SyncCtrlCountersToRegistry();
  std::string json =
      GlobalMetrics().DumpJson(g->cfg.rank, ControllerMetricsJson());
  std::string tmp = g->metrics_path + ".tmp";
  FILE* f = std::fopen(tmp.c_str(), "w");
  if (!f) return;
  std::fwrite(json.data(), 1, json.size(), f);
  std::fputc('\n', f);
  std::fclose(f);
  std::rename(tmp.c_str(), g->metrics_path.c_str());
}

void BackgroundLoop() {
  auto& cfg = g->cfg;
  double stall_period = cfg.stall_warn_s > 0 ? cfg.stall_warn_s : 60.0;
  while (!g->shutdown.load()) {
    double sleep_start = MonotonicSeconds();
    std::this_thread::sleep_for(
        std::chrono::microseconds(static_cast<int64_t>(g->cycle_ms * 1000)));
    double work_start = MonotonicSeconds();
    if (MetricsOn()) {
      auto& mreg = GlobalMetrics();
      mreg.cycle_count.fetch_add(1, std::memory_order_relaxed);
      mreg.cycle_idle_us.fetch_add(
          static_cast<int64_t>((work_start - sleep_start) * 1e6),
          std::memory_order_relaxed);
    }
    if (StepTraceOn()) {
      StepTraceAddPhaseUs(
          kPhaseIdle,
          static_cast<int64_t>((work_start - sleep_start) * 1e6));
    }
    g->timeline.MarkCycle();

    std::vector<TensorRequest> newreqs;
    {
      std::lock_guard<std::mutex> l(g->queue_mu);
      newreqs.swap(g->queue);
    }
    if (g->aborted.load()) {
      if (!newreqs.empty()) {
        Response err;
        err.error = "Horovod controller has been aborted";
        for (auto& r : newreqs) err.handles.push_back(r.handle);
        DeliverResponse(err);
      }
      continue;
    }

    std::vector<Response> responses;
    Status s = g->controller->ComputeResponses(newreqs, &responses);
    if (!s.ok()) {
      if (g->shutdown.load()) break;
      g->aborted.store(true);
      SetLastError(s.reason);
      auto* sc = dynamic_cast<SocketController*>(g->controller.get());
      if (sc && sc->peer_shutdown()) {
        // Deliberate peer exit: only noteworthy if work was pending.
        bool pending;
        {
          std::lock_guard<std::mutex> l(g->queue_mu);
          pending = !g->outstanding.empty() || !newreqs.empty();
        }
        if (pending) {
          HVD_LOG(WARNING) << "peer shut down with collectives pending: "
                           << s.reason;
        } else {
          HVD_LOG(INFO) << s.reason;
        }
      } else {
        HVD_LOG(ERROR) << "negotiation failed: " << s.reason;
        // Mark the abort on the trace so a merged multi-rank timeline shows
        // when each survivor learned of the failure; the args carry the
        // culprit attribution for merge_timeline.py / postmortem.py.
        g->timeline.Instant("ABORT",
                            "{\"reason\":\"" + JsonEscape(s.reason) + "\"}");
        // Belt and braces: every socket abort path already dumped, but
        // aborts that never touched the abort machinery (cache divergence,
        // local controller) still leave their black box here.
        if (FlightOn()) FlightDumpToFile();
        if (StepTraceOn()) StepTraceDumpToFile();
      }
      FailAllOutstanding("Horovod negotiation failed: " + s.reason);
      continue;
    }

    int64_t bytes = 0;
    for (auto& r : responses) {
      if (r.target_rank >= 0 && r.target_rank != g->cfg.rank) {
        continue;  // targeted delivery (tombstone error for another rank)
      }
      // Map globally agreed names to this rank's local handles.
      std::lock_guard<std::mutex> l(g->queue_mu);
      for (const auto& name : r.names) {
        auto it = g->outstanding.find(name);
        if (it == g->outstanding.end()) continue;
        if (r.target_rank == g->cfg.rank && !r.error.empty() &&
            !r.metas.empty() &&
            r.metas.front().handle != it->second.handle) {
          // Stale tombstone delivery: the submission it refers to (echoed
          // back by handle in the meta) was already failed by the cycle
          // broadcast; the outstanding entry is a fresh, consistent
          // resubmission that must not absorb the old error.
          continue;
        }
        r.handles.push_back(it->second.handle);
        if (MetricsOn() || StepTraceOn()) {
          // Same span the timeline's NEGOTIATE B/E pair measures, so the
          // registry total and the trace agree.
          const int64_t wait_us = static_cast<int64_t>(
              (MonotonicSeconds() - it->second.enqueued_at) * 1e6);
          if (MetricsOn()) {
            GlobalMetrics().negotiation_wait_us.ObserveUs(wait_us);
            // Per-tenant latency: the same wait attributed to the
            // response's process set, the QoS scheduling signal
            // hvd.metrics() exposes.
            GlobalMetrics().RecordTenantWaitUs(r.process_set_id, wait_us);
          }
          StepTraceAddPhaseUs(kPhaseNegotiation, wait_us);
        }
        g->outstanding.erase(it);
        g->timeline.End(name, "NEGOTIATE");
      }
      for (const auto& m : r.metas) bytes += m.nbytes;
    }
    bool step_work = false;  // did this cycle ship a real fused response?
    for (const auto& r : responses) {
      if (r.target_rank >= 0 && r.target_rank != g->cfg.rank) continue;
      if (!r.error.empty() && r.handles.empty()) {
        if (r.names.empty()) {
          // Errors naming no tensor at all (response-cache divergence)
          // would otherwise vanish: fail the whole job so every blocked
          // synchronize() wakes with the reason.
          g->aborted.store(true);
          SetLastError(r.error);
          HVD_LOG(ERROR) << "negotiation error: " << r.error;
          FailAllOutstanding("Horovod negotiation error: " + r.error);
        }
        // else: a named-tensor error this rank never submitted (e.g. the
        // join guard rejecting another rank's op) — the owning ranks get
        // it on their handles; nothing to do here.
      } else if (!r.handles.empty() || g->join_inflight.load()) {
        // Handle-less non-error responses matter only to a rank with a
        // join in flight: it holds no tensors for the collectives that
        // keep flowing, yet must still walk the ring with zero
        // contributions (the Python executor decides membership).  Without
        // a local join, uninvolved ranks drop them in C++ as before.
        if (r.op == OpType::JOIN && !r.handles.empty()) {
          g->join_inflight.store(false);
        }
        if (MetricsOn() && !r.metas.empty()) {
          auto& mreg = GlobalMetrics();
          int64_t rbytes = 0;
          for (const auto& m : r.metas) rbytes += m.nbytes;
          mreg.responses_total.fetch_add(1, std::memory_order_relaxed);
          mreg.tensors_fused_total.fetch_add(
              static_cast<int64_t>(r.metas.size()), std::memory_order_relaxed);
          mreg.bytes_fused_total.fetch_add(rbytes, std::memory_order_relaxed);
          // The same counters, attributed to the response's process set —
          // the per-tenant baseline the QoS accounting reports against.
          mreg.RecordTenant(r.process_set_id,
                            static_cast<int64_t>(r.metas.size()), rbytes);
        }
        if (r.error.empty() && !r.metas.empty()) step_work = true;
        DeliverResponse(r);
      }
    }
    if (step_work && StepTraceOn() &&
        dynamic_cast<SocketController*>(g->controller.get()) == nullptr) {
      // np=1 (local controller): no coordinator trailer will ever arrive,
      // so close the step here with the same "shipped real work" rule the
      // socket coordinator uses, and feed the fleet view directly so the
      // cockpit's /state breakdown works single-process too.
      StepTraceAdvance(StepTraceCurrentStep() + 1);
      int64_t sid = 0;
      int64_t phases[kStepPhases];
      if (StepTraceLastCompleted(&sid, phases)) {
        StepTraceFleetPhases(0, sid, phases);
      }
    }
    if (bytes > 0) g->params.RecordBytes(bytes);

    int64_t fusion = g->fusion_threshold.load();
    double cycle = g->cycle_ms;
    if (g->params.Tick(&fusion, &cycle)) {
      g->fusion_threshold.store(fusion);
      g->cycle_ms = cycle;
      g->cfg.fusion_threshold = fusion;
      // Categorical knob: worker-side cache announce (safe per rank —
      // inserts stay deterministic either way).
      auto* sc = dynamic_cast<SocketController*>(g->controller.get());
      if (sc) {
        sc->SetAnnounceCache(g->params.announce_cache());
        // Coordinator-only knobs: the hierarchical/wire-codec decisions
        // ride in each serialized response, so applying them on every
        // rank is harmless.
        sc->SetHierarchical(g->params.hierarchical());
        sc->SetWireCompression(g->params.wire_compression());
      }
      HVD_LOG(DEBUG) << "autotune: fusion=" << fusion << " cycle_ms=" << cycle
                     << " announce_cache=" << g->params.announce_cache()
                     << " hierarchical=" << g->params.hierarchical()
                     << " wire_compression=" << g->params.wire_compression()
                     << " qdev=" << g->params.qdev()
                     << " qdev_sched=" << g->params.qdev_sched();
    }

    double now = MonotonicSeconds();
    if (cfg.stall_warn_s > 0 && now - g->last_stall_check > stall_period) {
      g->last_stall_check = now;
      std::string report = g->controller->StallReport(cfg.stall_warn_s);
      if (!report.empty()) {
        if (MetricsOn()) {
          GlobalMetrics().stall_warnings_total.fetch_add(
              1, std::memory_order_relaxed);
        }
        HVD_LOG(WARNING)
            << "Stall detected: tensors submitted on some ranks but not "
               "others: "
            << report;
      }
      int n = 0;
      double oldest_age = 0.0;
      {
        std::lock_guard<std::mutex> l(g->queue_mu);
        for (auto& kv : g->outstanding) {
          ++n;
          oldest_age = std::max(oldest_age, now - kv.second.enqueued_at);
        }
      }
      if (n > 0 && g->cfg.size == 1) {
        HVD_LOG(WARNING) << "Stall: " << n
                         << " tensor(s) pending negotiation locally";
      }
      // Stall-shutdown watchdog (reference: HOROVOD_STALL_SHUTDOWN_TIME_
      // SECONDS aborts the job once a tensor has been stuck this long).
      if (cfg.stall_shutdown_s > 0 && oldest_age > cfg.stall_shutdown_s) {
        g->aborted.store(true);
        std::string msg =
            "stalled for more than " + std::to_string(cfg.stall_shutdown_s) +
            "s waiting for negotiation (one or more ranks never submitted a "
            "matching tensor); shutting down";
        SetLastError(msg);
        HVD_LOG(ERROR) << msg;
        g->timeline.Instant("ABORT",
                            "{\"reason\":\"" + JsonEscape(msg) + "\"}");
        if (FlightOn()) FlightDumpToFile();
        if (StepTraceOn()) StepTraceDumpToFile();
        FailAllOutstanding("Horovod stall shutdown: " + msg);
      }
    }
    if (MetricsOn()) {
      GlobalMetrics().cycle_busy_us.fetch_add(
          static_cast<int64_t>((MonotonicSeconds() - work_start) * 1e6),
          std::memory_order_relaxed);
    }
    if (!g->metrics_path.empty() &&
        MonotonicSeconds() - g->last_metrics_write >= cfg.metrics_interval_s) {
      g->last_metrics_write = MonotonicSeconds();
      WriteMetricsFile();
    }
  }
  g->background_done.store(true);
}

}  // namespace

int GetLogLevel() { return g_log_level; }
void SetLogLevel(int level) { g_log_level = level; }

}  // namespace hvdtpu

using namespace hvdtpu;

extern "C" {

int hvd_init(int rank, int size, int local_rank, int local_size,
             const char* controller, const char* addr, int port,
             double cycle_ms, long long fusion, int cache_cap, int autotune,
             const char* autotune_log, int hierarchical, int wire_compression,
             int qdev_compression, int qdev_schedule,
             int metrics_enabled, const char* metrics_file,
             double metrics_interval_s, const char* timeline_path,
             int timeline_mark_cycles, double stall_warn_s,
             double stall_shutdown_s, int log_level, int flight_enabled,
             int flight_slots, const char* postmortem_dir,
             int autopilot_port, int step_trace_on, int step_trace_slots,
             int data_plane) {
  if (g != nullptr) return -1;
  SetInitError("");  // a fresh attempt must not inherit a stale reason
  g = new GlobalState();
  auto& cfg = g->cfg;
  cfg.rank = rank;
  cfg.size = size;
  cfg.local_rank = local_rank;
  cfg.local_size = local_size;
  cfg.controller = controller ? controller : "auto";
  cfg.rendezvous_addr = addr ? addr : "127.0.0.1";
  cfg.rendezvous_port = port;
  cfg.cycle_time_ms = cycle_ms;
  cfg.fusion_threshold = fusion;
  cfg.cache_capacity = cache_cap;
  cfg.autotune = autotune != 0;
  cfg.autotune_log = autotune_log ? autotune_log : "";
  cfg.hierarchical = hierarchical != 0;
  cfg.wire_compression =
      wire_compression >= 0 && wire_compression <= 4 ? wire_compression : 0;
  // Device-plane codec (0=none, 1=int8, 2=int4, 3=int8g).  -1 means the
  // caller has no device plane at all (no jax mesh): the knob is then
  // pinned for the autotuner, not merely off.
  cfg.qdev_compression =
      qdev_compression >= -1 && qdev_compression <= 3 ? qdev_compression : 0;
  // Device-ring schedule (0=ring, 1=bidi, 2=torus).  -1 pins the autotune
  // arm: no device plane, or a member count that only admits the
  // unidirectional ring.
  cfg.qdev_schedule =
      qdev_schedule >= -1 && qdev_schedule <= 2 ? qdev_schedule : 0;
  // In-jit gradient-exchange plane (0=eager, 1=gspmd).  -1 pins the
  // autotune arm: no multi-device mesh, or the quantized codec owns the
  // traced reduction (the compose-or-demote rule of ops/gspmd_plane.py).
  cfg.data_plane = data_plane >= -1 && data_plane <= 1 ? data_plane : 0;
  cfg.metrics_file = metrics_file ? metrics_file : "";
  cfg.metrics = metrics_enabled != 0 || !cfg.metrics_file.empty();
  cfg.metrics_interval_s = metrics_interval_s > 0 ? metrics_interval_s : 10.0;
  cfg.timeline_path = timeline_path ? timeline_path : "";
  cfg.timeline_mark_cycles = timeline_mark_cycles != 0;
  cfg.stall_warn_s = stall_warn_s;
  cfg.stall_shutdown_s = stall_shutdown_s;
  cfg.autopilot_port = autopilot_port > 0 ? autopilot_port : 0;
  cfg.step_trace = step_trace_on != 0;
  cfg.step_trace_slots = step_trace_slots > 0 ? step_trace_slots : 256;
  SetLogLevel(log_level);
  g->cycle_ms = cycle_ms > 0 ? cycle_ms : 1.0;
  g->fusion_threshold.store(fusion);

  // Fault injection (HOROVOD_FAULT_INJECT) arms before any thread exists so
  // hit counters are deterministic from the first frame.  A malformed spec
  // fails init loudly: silently running a chaos test with zero faults armed
  // would pass for the wrong reason.
  {
    std::string ferr = InitFaultInjection();
    if (!ferr.empty()) {
      SetInitError(ferr);
      HVD_LOG(ERROR) << "init failed: " << ferr;
      delete g;
      g = nullptr;
      return -2;
    }
  }

  // The registry is process-global (instrumentation points sit below the
  // GlobalState), so re-init within one process starts from zero.
  GlobalMetrics().Reset();
  GlobalMetrics().enabled.store(cfg.metrics, std::memory_order_relaxed);
  if (!cfg.metrics_file.empty()) {
    std::string p = cfg.metrics_file;
    auto pos = p.find("{rank}");
    if (pos != std::string::npos) {
      p.replace(pos, 6, std::to_string(cfg.rank));
    } else {
      p += "." + std::to_string(cfg.rank);
    }
    g->metrics_path = p;
  }
  g->timeline.SetRank(cfg.rank);

  // Flight recorder arms BEFORE the controller exists: the rendezvous is
  // the first event worth keeping, and an init failure below still leaves
  // a black box behind.
  InitFlightRecorder(flight_enabled != 0, flight_slots,
                     postmortem_dir ? postmortem_dir : "", cfg.rank);
  // Step tracing arms alongside it (same postmortem dir for the abort-time
  // steptrace.<rank>.json dump) so the first negotiated step is attributed.
  InitStepTrace(cfg.step_trace, cfg.step_trace_slots,
                postmortem_dir ? postmortem_dir : "", cfg.rank, cfg.size);
  // Fleet telemetry (v11) arms with them: HOROVOD_FLEET_TELEMETRY gates
  // the sketch sections, history ring, goodput gauge and the sentinel;
  // elastic re-init re-arms with fresh history/sentinel state.
  InitFleetTelemetry();

  if (cfg.size > 1 || cfg.controller == "socket") {
    g->controller = std::make_unique<SocketController>(cfg);
    // Autopilot decisions accepted on the policy channel land on the
    // timeline as instants (the flight/metrics records happen inside the
    // controller).  Installed before Initialize starts the serve thread.
    static_cast<SocketController*>(g->controller.get())
        ->SetAutopilotDecisionHook(
            [](int action, int rank, const std::string& detail) {
              if (g == nullptr) return;
              g->timeline.Instant(
                  "AUTOPILOT", "{\"action\":" + std::to_string(action) +
                                   ",\"rank\":" + std::to_string(rank) +
                                   ",\"detail\":\"" + JsonEscape(detail) +
                                   "\"}");
            });
  } else {
    g->controller = std::make_unique<LocalController>(cfg);
  }
  Status s = g->controller->Initialize();
  if (!s.ok()) {
    SetInitError(s.reason);
    HVD_LOG(ERROR) << "init failed: " << s.reason;
    // A fatal init error is a postmortem moment too (the rank may have
    // recorded a partial rendezvous before dying).
    if (FlightOn()) FlightDumpToFile();
    GlobalMetrics().enabled.store(false, std::memory_order_relaxed);
    delete g;
    g = nullptr;
    return -2;
  }
  if (!cfg.timeline_path.empty()) {
    g->timeline.Start(cfg.timeline_path, cfg.timeline_mark_cycles);
    // Every rank leaves controller Initialize() through the rendezvous
    // handshake's closing fences within the same instant, so this event
    // is merge_timeline.py's cross-rank alignment anchor.
    g->timeline.Instant("RENDEZVOUS");
  }
  if (cfg.autotune) {
    // The hierarchical knob is tunable only when the wired-up topology can
    // act on it (>= 2 hosts with >= 1 multi-rank host and working shm);
    // otherwise it is pinned off so the GP never explores a dead arm.
    auto* sc = dynamic_cast<SocketController*>(g->controller.get());
    bool hier_tunable = sc != nullptr && sc->HierAvailable();
    // Same pinning rule for the wire codec: tunable only when some ring
    // hop actually crosses hosts (the leader ring, or an all-cross-host
    // flat ring).
    bool wire_tunable = sc != nullptr && sc->WireCompAvailable();
    // Device-plane codec coordinate: tunable only when the Python side
    // reported a usable device plane (qdev >= 0); -1 pins the arm.
    bool qdev_tunable = cfg.qdev_compression >= 0;
    int qdev_comp = cfg.qdev_compression >= 0 ? cfg.qdev_compression : 0;
    // Device-ring schedule coordinate: pinned alongside qdev, and also
    // when the Python side reported only the unidirectional ring is
    // feasible for the plane's member count (-1).
    bool sched_tunable = qdev_tunable && cfg.qdev_schedule >= 0;
    int qdev_sched = cfg.qdev_schedule >= 0 ? cfg.qdev_schedule : 0;
    // Data-plane coordinate: tunable only when the Python side reported a
    // usable gspmd mesh (data_plane >= 0); -1 pins the arm to eager.
    bool plane_tunable = cfg.data_plane >= 0;
    int plane0 = cfg.data_plane >= 0 ? cfg.data_plane : 0;
    g->params.Initialize(fusion, g->cycle_ms, cfg.autotune_log,
                         cfg.hierarchical, hier_tunable,
                         cfg.wire_compression, wire_tunable,
                         qdev_comp, qdev_tunable, qdev_sched, sched_tunable,
                         plane0, plane_tunable);
  }
  g->background = std::thread(BackgroundLoop);
  return 0;
}

int hvd_shutdown() {
  if (g == nullptr) return -1;
  g->shutdown.store(true);
  // Let the background loop finish its current cycle before touching the
  // sockets (every rank replies every cycle, so this is normally bounded
  // by the cycle time), then send the clean-exit notice — teardown stops
  // looking like a peer crash on the other ranks.  If a peer has wedged
  // (alive TCP, no frames), the loop stays blocked in recv: after a grace
  // period force the sockets closed so shutdown always terminates.
  double deadline = MonotonicSeconds() + 2.0;
  while (!g->background_done.load() && MonotonicSeconds() < deadline) {
    std::this_thread::sleep_for(std::chrono::milliseconds(5));
  }
  if (g->background_done.load()) {
    g->controller->Farewell();
    g->controller->Shutdown();
  } else {
    g->controller->Shutdown();  // unblocks the recv; no farewell possible
  }
  if (g->background.joinable()) g->background.join();
  FailAllOutstanding("Horovod has been shut down");
  // Final snapshot so short runs (shorter than the interval) still leave
  // a complete metrics file behind.
  if (!g->metrics_path.empty()) WriteMetricsFile();
  // Same courtesy for the step trace: a clean exit leaves the attribution
  // behind for tools/critical_path.py without requiring an abort.
  if (StepTraceOn()) StepTraceDumpToFile();
  GlobalStepTraceGate().enabled.store(false, std::memory_order_relaxed);
  GlobalMetrics().enabled.store(false, std::memory_order_relaxed);
  g->timeline.Stop();
  {
    std::lock_guard<std::mutex> l(g->out_mu);
    g->out_cv.notify_all();
  }
  delete g;
  g = nullptr;
  return 0;
}

int hvd_is_initialized() { return g != nullptr ? 1 : 0; }
int hvd_rank() { return g ? g->cfg.rank : -1; }
int hvd_size() { return g ? g->cfg.size : -1; }
int hvd_local_rank() { return g ? g->cfg.local_rank : -1; }
int hvd_local_size() { return g ? g->cfg.local_size : -1; }

long long hvd_enqueue(long long handle, const char* name, int op, int dtype,
                      int reduce_op, long long nbytes, const long long* shape,
                      int ndim, int psid, int root_rank, double prescale,
                      double postscale, const long long* splits, int nsplits,
                      int device, const char* group_key, int group_size) {
  if (g == nullptr) return -1;
  TensorRequest r;
  r.handle = handle;
  r.name = name;
  r.op = static_cast<OpType>(op);
  r.dtype = static_cast<DataType>(dtype);
  r.reduce_op = static_cast<ReduceOp>(reduce_op);
  r.nbytes = nbytes;
  r.shape.assign(shape, shape + ndim);
  r.process_set_id = psid;
  r.root_rank = root_rank;
  r.prescale = prescale;
  r.postscale = postscale;
  r.device = device != 0 ? 1 : 0;
  if (group_key && group_key[0]) {
    r.group_key = group_key;
    r.group_size = group_size;
  }
  if (splits && nsplits > 0) r.splits.assign(splits, splits + nsplits);
  r.enqueued_at = MonotonicSeconds();
  if (r.op == OpType::JOIN) g->join_inflight.store(true);
  {
    std::lock_guard<std::mutex> l(g->queue_mu);
    if (g->outstanding.count(r.name)) return -2;  // duplicate in flight
    g->outstanding[r.name] = {handle, r.enqueued_at};
    g->queue.push_back(std::move(r));
  }
  g->timeline.Begin(name, "NEGOTIATE");
  return 0;
}

// Returns: >0 = JSON length written, 0 = timeout, -1 = not initialized,
// -2 = buffer too small (len stored in *needed).
int hvd_pop_response(char* buf, int cap, int timeout_ms) {
  if (g == nullptr) return -1;
  std::unique_lock<std::mutex> l(g->out_mu);
  if (g->out_responses.empty()) {
    g->out_cv.wait_for(l, std::chrono::milliseconds(timeout_ms));
  }
  if (g->out_responses.empty()) return 0;
  const std::string& s = g->out_responses.front();
  if (static_cast<int>(s.size()) + 1 > cap) return -2;
  std::memcpy(buf, s.data(), s.size());
  buf[s.size()] = '\0';
  int n = static_cast<int>(s.size());
  g->out_responses.pop_front();
  return n;
}

static void SetSeq(long long seq) {
  auto* sc = dynamic_cast<SocketController*>(g->controller.get());
  if (sc) sc->SetCurrentSeq(seq);
}

static int StatusToInt(const Status& s) {
  if (s.ok()) return 0;
  std::string reason = s.reason;
  if (s.code == StatusCode::ABORTED) {
    // A data-plane socket failure only says "peer died"; the coordinator's
    // ABORT broadcast (bounded wait) names the culprit rank/host.  Fold it
    // in so the HorovodInternalError the executor raises is actionable.
    std::string why = g->controller->WaitAbortReason();
    if (!why.empty() && reason.find(why) == std::string::npos) {
      reason += " [" + why + "]";
    }
  }
  SetLastError(reason);
  return -static_cast<int>(s.code);
}

int hvd_allreduce_buffer(long long seq, void* buf, long long count, int dtype,
                         int reduce_op, int psid) {
  if (g == nullptr) return -1;
  SetSeq(seq);
  g->timeline.Begin("seq." + std::to_string(seq), "DATA_ALLREDUCE");
  Status s = g->controller->AllreduceBuffer(
      buf, count, static_cast<DataType>(dtype),
      static_cast<ReduceOp>(reduce_op), psid);
  g->timeline.End("seq." + std::to_string(seq), "DATA_ALLREDUCE");
  return StatusToInt(s);
}

int hvd_reducescatter_buffer(long long seq, void* buf, long long count,
                             int dtype, int reduce_op, int psid,
                             const long long* slice_counts, int n_slices) {
  if (g == nullptr) return -1;
  SetSeq(seq);
  std::vector<int64_t> slices(slice_counts, slice_counts + n_slices);
  g->timeline.Begin("seq." + std::to_string(seq), "DATA_REDUCESCATTER");
  Status s = g->controller->ReduceScatterBuffer(
      buf, count, static_cast<DataType>(dtype),
      static_cast<ReduceOp>(reduce_op), slices, psid);
  g->timeline.End("seq." + std::to_string(seq), "DATA_REDUCESCATTER");
  return StatusToInt(s);
}

// Allgather: returns malloc'd buffer in *out (caller frees via hvd_free).
int hvd_allgather_buffer(long long seq, const void* in, long long nbytes,
                         int psid, void** out, long long* out_len,
                         long long* counts, int counts_cap, int* n_counts) {
  if (g == nullptr) return -1;
  SetSeq(seq);
  std::string gathered;
  std::vector<int64_t> per_rank;
  Status s =
      g->controller->AllgatherBuffer(in, nbytes, psid, &gathered, &per_rank);
  if (!s.ok()) return StatusToInt(s);
  if (static_cast<int>(per_rank.size()) > counts_cap) return -3;
  char* mem = static_cast<char*>(std::malloc(gathered.size()));
  std::memcpy(mem, gathered.data(), gathered.size());
  *out = mem;
  *out_len = static_cast<long long>(gathered.size());
  for (size_t i = 0; i < per_rank.size(); ++i) counts[i] = per_rank[i];
  *n_counts = static_cast<int>(per_rank.size());
  return 0;
}

int hvd_broadcast_buffer(long long seq, void* buf, long long nbytes, int root,
                         int psid) {
  if (g == nullptr) return -1;
  SetSeq(seq);
  return StatusToInt(g->controller->BroadcastBuffer(buf, nbytes, root, psid));
}

int hvd_alltoall_buffer(long long seq, const void* in, const long long* splits,
                        int nsplits, long long row_bytes, int psid, void** out,
                        long long* out_len, long long* recv_splits,
                        int* n_recv) {
  if (g == nullptr) return -1;
  SetSeq(seq);
  std::vector<int64_t> sp(splits, splits + nsplits);
  std::string received;
  std::vector<int64_t> rsp;
  Status s = g->controller->AlltoallBuffer(in, sp, row_bytes, psid, &received,
                                           &rsp);
  if (!s.ok()) return StatusToInt(s);
  char* mem = static_cast<char*>(std::malloc(received.size()));
  std::memcpy(mem, received.data(), received.size());
  *out = mem;
  *out_len = static_cast<long long>(received.size());
  for (size_t i = 0; i < rsp.size(); ++i) recv_splits[i] = rsp[i];
  *n_recv = static_cast<int>(rsp.size());
  return 0;
}

int hvd_barrier(long long seq, int psid) {
  if (g == nullptr) return -1;
  SetSeq(seq);
  return StatusToInt(g->controller->Barrier(psid));
}

void hvd_free(void* p) { std::free(p); }

int hvd_add_process_set(const int* ranks, int n) {
  if (g == nullptr) return -1;
  std::vector<int> v(ranks, ranks + n);
  int id = g->controller->process_sets().Add(v);
  // Dedicated data channel (per-set socket mesh) so this set's collectives
  // can run on their own executor lane, concurrent with other sets'.
  Status s = g->controller->EstablishChannel(id);
  if (!s.ok()) {
    // EstablishChannel can fail after the channel sockets were inserted
    // (the shm handshake runs last): close them too.
    g->controller->RemoveChannel(id);
    g->controller->process_sets().Remove(id);
    SetLastError("process set channel establishment failed: " + s.reason);
    return -4;
  }
  return id;
}

// QoS variant: `weight` orders the coordinator's fused-response schedule
// (higher weight first; the global set is pinned at 1.0).  The unweighted
// export above keeps its ABI for older callers.
int hvd_add_process_set2(const int* ranks, int n, double weight) {
  if (g == nullptr) return -1;
  std::vector<int> v(ranks, ranks + n);
  int id = g->controller->process_sets().AddWeighted(v, weight);
  Status s = g->controller->EstablishChannel(id);
  if (!s.ok()) {
    g->controller->RemoveChannel(id);
    g->controller->process_sets().Remove(id);
    SetLastError("process set channel establishment failed: " + s.reason);
    return -4;
  }
  return id;
}

int hvd_remove_process_set(int id) {
  if (g == nullptr) return -1;
  g->controller->RemoveChannel(id);
  g->controller->process_sets().Remove(id);
  return 0;
}

int hvd_process_set_ranks(int id, int* out, int cap) {
  if (g == nullptr) return -1;
  std::vector<int> ranks;
  if (!g->controller->process_sets().Ranks(id, &ranks)) return -2;
  if (static_cast<int>(ranks.size()) > cap) return -3;
  for (size_t i = 0; i < ranks.size(); ++i) out[i] = ranks[i];
  return static_cast<int>(ranks.size());
}

void hvd_negotiation_stats(long long* sent, long long* recv) {
  if (g == nullptr) {
    *sent = *recv = 0;
    return;
  }
  int64_t s = 0, r = 0;
  g->controller->NegotiationStats(&s, &r);
  *sent = s;
  *recv = r;
}

// Ctrl-plane frame + byte counters (protocol v9): on the coordinator,
// msgs_recv per negotiation cycle is the leader-tree acceptance metric —
// O(ranks) flat vs O(local ranks + hosts) with the tree engaged.
void hvd_ctrl_plane_stats(long long* msgs_sent, long long* msgs_recv,
                          long long* bytes_sent, long long* bytes_recv) {
  *msgs_sent = *msgs_recv = *bytes_sent = *bytes_recv = 0;
  if (g == nullptr) return;
  int64_t ms = 0, mr = 0, bs = 0, br = 0;
  g->controller->CtrlPlaneStats(&ms, &mr, &bs, &br);
  *msgs_sent = ms;
  *msgs_recv = mr;
  *bytes_sent = bs;
  *bytes_recv = br;
}

// Data-plane byte accounting split by locality (host plane only): bytes
// sent to ranks sharing this rank's host key vs. bytes crossing hosts.
// Lets tests assert the hierarchical composition actually shrinks
// cross-host traffic instead of trusting the topology log.
void hvd_data_plane_stats(long long* local, long long* xhost) {
  *local = *xhost = 0;
  if (g == nullptr) return;
  auto* sc = dynamic_cast<SocketController*>(g->controller.get());
  if (sc == nullptr) return;
  int64_t l = 0, x = 0, rl = 0, rx = 0;
  sc->DataPlaneStats(&l, &x, &rl, &rx);
  *local = l;
  *xhost = x;
}

// Extended form: `raw_*` are the fp32-equivalent payload bytes of the
// same sends (wire == raw unless a compressed ring encoded them), so
// raw/wire is the measured compression ratio.  The 2-arg export above
// keeps its ABI for older callers.
void hvd_data_plane_stats2(long long* local, long long* xhost,
                           long long* raw_local, long long* raw_xhost) {
  *local = *xhost = *raw_local = *raw_xhost = 0;
  if (g == nullptr) return;
  auto* sc = dynamic_cast<SocketController*>(g->controller.get());
  if (sc == nullptr) return;
  int64_t l = 0, x = 0, rl = 0, rx = 0;
  sc->DataPlaneStats(&l, &x, &rl, &rx);
  *local = l;
  *xhost = x;
  *raw_local = rl;
  *raw_xhost = rx;
}

// Device-plane (in-jit / eager-XLA) quantized-collective byte accounting.
// The Python side calls note() once per quantized dispatch with the raw
// fp32 ring bytes the collective would have moved and the int8-encoded
// bytes it did move; stats() reads both back.  raw/encoded is the
// measured device-codec ratio (uncompressed device collectives report
// nothing — XLA moves those bytes without telling us).
void hvd_device_plane_note(long long raw_bytes, long long encoded_bytes) {
  auto& m = GlobalMetrics();
  if (raw_bytes > 0) {
    m.device_raw_bytes.fetch_add(raw_bytes, std::memory_order_relaxed);
  }
  if (encoded_bytes > 0) {
    m.device_encoded_bytes.fetch_add(encoded_bytes,
                                     std::memory_order_relaxed);
  }
}

void hvd_device_plane_stats(long long* raw_bytes, long long* encoded_bytes) {
  auto& m = GlobalMetrics();
  *raw_bytes = m.device_raw_bytes.load(std::memory_order_relaxed);
  *encoded_bytes = m.device_encoded_bytes.load(std::memory_order_relaxed);
}

// GSPMD-plane (compiler-inserted collective) accounting, reported by the
// Python HLO inspector (ops/hlo_inspect.py) once per inspected trace:
// the number of collectives XLA emitted, their analytic raw payload
// bytes, and the analytic ring wire bytes.  Like the device-plane pair,
// these tick per trace, never per step — a compiled program cannot count
// at run time.  Callable before/without init (the registry is
// process-global); the timeline instant needs a live core.
void hvd_gspmd_plane_note(long long ops, long long raw_bytes,
                          long long wire_bytes) {
  NoteHloInspect(ops, raw_bytes, wire_bytes);
  if (g != nullptr) {
    g->timeline.Instant(
        "HLO_INSPECT", "{\"collectives\":" + std::to_string(ops) +
                           ",\"raw_bytes\":" + std::to_string(raw_bytes) +
                           ",\"wire_bytes\":" + std::to_string(wire_bytes) +
                           "}");
  }
}

void hvd_gspmd_plane_stats(long long* raw_bytes, long long* wire_bytes) {
  auto& m = GlobalMetrics();
  *raw_bytes = m.gspmd_raw_bytes.load(std::memory_order_relaxed);
  *wire_bytes = m.gspmd_wire_bytes.load(std::memory_order_relaxed);
}

// Tags the forming causal steps with the data plane running them
// (0 eager, 1 gspmd, -1 unknown) — noted by the optimizer at trace time,
// stamped into each closing step record and the coordinator's fleet
// records, surfaced by tools/critical_path.py and the cockpit.
void hvd_step_trace_note_plane(int plane) {
  StepTraceNotePlane(plane);
}

// The autotuner's current device-plane codec decision (0=none, 1=int8,
// 2=int4, 3=int8g; -1 = not initialized).  The Python side polls it
// between steps and re-traces with the quantized ring when it flips — the
// device plane's analog of SetWireCompression on the host ring.
int hvd_autotune_qdev() {
  if (g == nullptr) return -1;
  return g->params.qdev();
}

// The autotuner's current device-ring schedule decision (0=ring, 1=bidi,
// 2=torus; -1 = not initialized).  Polled together with
// hvd_autotune_qdev().
int hvd_autotune_qsched() {
  if (g == nullptr) return -1;
  return g->params.qdev_sched();
}

// The autotuner's current data-plane decision (0=eager, 1=gspmd; -1 = not
// initialized).  Polled like hvd_autotune_qdev(): the flip takes effect
// at the next DistributedOptimizer construction/trace, never mid-step.
int hvd_autotune_plane() {
  if (g == nullptr) return -1;
  return g->params.plane();
}

// Full local metrics registry as one JSON object; on the coordinator the
// dump also carries the aggregated cluster view (per-rank piggybacked
// snapshots) and the latest straggler attribution report.
// Returns: >0 = JSON length written, -1 = not initialized, -2 = buffer
// too small (caller grows and retries, same convention as
// hvd_pop_response).
int hvd_metrics_dump(char* buf, int cap) {
  if (g == nullptr) return -1;
  SyncCtrlCountersToRegistry();
  std::string json =
      GlobalMetrics().DumpJson(g->cfg.rank, ControllerMetricsJson());
  if (static_cast<int>(json.size()) + 1 > cap) return -2;
  std::memcpy(buf, json.data(), json.size());
  buf[json.size()] = '\0';
  return static_cast<int>(json.size());
}

// This rank's full flight-recorder buffer as one JSON object (the same
// schema as the crash dumps under HOROVOD_POSTMORTEM_DIR).  Returns:
// >0 = JSON length written, 0 = recorder disabled, -1 = not initialized,
// -2 = buffer too small (caller grows and retries, same convention as
// hvd_metrics_dump).
int hvd_flight_record(char* buf, int cap) {
  if (g == nullptr) return -1;
  if (!FlightOn()) return 0;
  std::string json = FlightDumpJson();
  if (static_cast<int>(json.size()) + 1 > cap) return -2;
  std::memcpy(buf, json.data(), json.size());
  buf[json.size()] = '\0';
  return static_cast<int>(json.size());
}

// Same contract as hvd_flight_record: -1 not initialized, 0 tracing off,
// -2 buffer too small (caller doubles and retries), else JSON length.
int hvd_step_trace(char* buf, int cap) {
  if (g == nullptr) return -1;
  if (!StepTraceOn()) return 0;
  std::string json = StepTraceDumpJson();
  if (static_cast<int>(json.size()) + 1 > cap) return -2;
  std::memcpy(buf, json.data(), json.size());
  buf[json.size()] = '\0';
  return static_cast<int>(json.size());
}

// The coordinator's multi-resolution fleet history + anomaly log
// (fleethistory-v1; fleet_telemetry.h).  Same contract as hvd_step_trace:
// -1 not initialized, 0 plane off, -2 buffer too small (caller doubles
// and retries), else JSON length.
int hvd_fleet_history(char* buf, int cap) {
  if (g == nullptr) return -1;
  if (!FleetTelemetryOn()) return 0;
  std::string json = FleetHistoryJson();
  if (static_cast<int>(json.size()) + 1 > cap) return -2;
  std::memcpy(buf, json.data(), json.size());
  buf[json.size()] = '\0';
  return static_cast<int>(json.size());
}

void hvd_start_timeline(const char* path, int mark_cycles) {
  if (g) g->timeline.Start(path, mark_cycles != 0);
}

void hvd_stop_timeline() {
  if (g) g->timeline.Stop();
}

const char* hvd_last_error() {
  if (g == nullptr) {
    std::lock_guard<std::mutex> l(init_err_mu);
    return init_error.empty() ? "not initialized" : init_error.c_str();
  }
  std::lock_guard<std::mutex> l(g->err_mu);
  return g->last_error.c_str();
}

// Validate a HOROVOD_FAULT_INJECT spec without arming anything: returns ""
// when well-formed, else the same actionable message init would fail with.
// Lets horovodrun --fault-inject reject typos before spawning np workers.
const char* hvd_fault_spec_check(const char* spec) {
  static thread_local std::string err;
  err = ParseFaultSpec(spec ? spec : "", nullptr);
  return err.c_str();
}

// Elastic-migration forensic note (docs/elastic.md "Zero-downtime
// migration"): one call per migration phase on each participating rank.
// Routes through the shared NoteMigration (metrics counters + flight
// type 14) and lands a MIGRATE instant on the host timeline.  A fallback
// phase forces a flight dump like an autopilot decision does — the
// checkpoint path it announces usually follows a generation teardown.
void hvd_migrate_note(int phase, long long bytes, int source_rank) {
  NoteMigration(phase, bytes, source_rank);
  if (g != nullptr) {
    g->timeline.Instant(
        "MIGRATE", "{\"phase\":" + std::to_string(phase) +
                       ",\"bytes\":" + std::to_string(bytes) +
                       ",\"source_rank\":" + std::to_string(source_rank) +
                       "}");
  }
  if (phase == kMigrateFallback && FlightOn() &&
      !FlightPostmortemDir().empty()) {
    FlightDumpToFile();
  }
}

// Publishes the elastic generation this rank joined (from the driver's
// assignment) as a metrics gauge, so scrapes can correlate migrate/abort
// counters with re-formations.  Callable before/without init — the
// registry is process-global.
void hvd_elastic_generation_set(long long generation) {
  GlobalMetrics().elastic_generation.store(generation,
                                           std::memory_order_relaxed);
}

}  // extern "C"
