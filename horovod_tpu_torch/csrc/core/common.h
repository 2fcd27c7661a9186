// Shared types for the native core.
//
// TPU-native re-implementation of the reference core's message/type layer
// (horovod/common/common.h, message.h — DataType, Request/Response types;
// SURVEY.md §2.1).  Enum values are ABI shared with horovod_tpu/wire.py —
// keep them in sync.
#pragma once

#include <cstdint>
#include <map>
#include <string>
#include <vector>

namespace hvdtpu {

enum class OpType : int32_t {
  ALLREDUCE = 0,
  ALLGATHER = 1,
  BROADCAST = 2,
  ALLTOALL = 3,
  REDUCESCATTER = 4,
  BARRIER = 5,
  JOIN = 6,
};

enum class ReduceOp : int32_t {
  AVERAGE = 0,
  SUM = 1,
  MIN = 2,
  MAX = 3,
  PRODUCT = 4,
  ADASUM = 5,
};

enum class DataType : int32_t {
  UINT8 = 0,
  INT8 = 1,
  INT32 = 2,
  INT64 = 3,
  FLOAT16 = 4,
  FLOAT32 = 5,
  FLOAT64 = 6,
  BOOL = 7,
  BFLOAT16 = 8,
  UINT16 = 9,
  INT16 = 10,
};

inline int ItemSize(DataType t) {
  switch (t) {
    case DataType::UINT8:
    case DataType::INT8:
    case DataType::BOOL:
      return 1;
    case DataType::UINT16:
    case DataType::INT16:
    case DataType::FLOAT16:
    case DataType::BFLOAT16:
      return 2;
    case DataType::INT32:
    case DataType::FLOAT32:
      return 4;
    case DataType::INT64:
    case DataType::FLOAT64:
      return 8;
  }
  return 1;
}

enum class StatusCode : int32_t {
  OK = 0,
  UNKNOWN_ERROR = 1,
  PRECONDITION_ERROR = 2,
  ABORTED = 3,
  INVALID_ARGUMENT = 4,
  IN_PROGRESS = 5,
};

struct Status {
  StatusCode code = StatusCode::OK;
  std::string reason;
  bool ok() const { return code == StatusCode::OK; }
  static Status OK() { return Status{}; }
  static Status Error(StatusCode c, std::string r) { return Status{c, std::move(r)}; }
};

// One enqueued collective request (reference: Request in message.h +
// TensorTableEntry in common.h).  The core never owns tensor *data* — the
// data plane moves bytes (socket path) or is an XLA program (device path);
// the core owns *negotiation metadata* only.
struct TensorRequest {
  int64_t handle = 0;          // per-process handle (Python side registry)
  std::string name;            // globally unique key for negotiation
  OpType op = OpType::ALLREDUCE;
  DataType dtype = DataType::FLOAT32;
  ReduceOp reduce_op = ReduceOp::SUM;
  int64_t nbytes = 0;          // payload size (fusion accounting)
  std::vector<int64_t> shape;  // for cross-rank validation
  int32_t process_set_id = 0;
  int32_t root_rank = 0;       // broadcast
  double prescale = 1.0;
  double postscale = 1.0;
  std::vector<int64_t> splits; // alltoall send splits
  // 1 when the submitting rank can execute this tensor on the device data
  // plane (a device-resident jax.Array + a ready rank mesh).  The
  // coordinator ANDs the flag across ranks so every rank deterministically
  // picks the same plane — the analog of the reference's device-id
  // coherence that decides NCCL vs CPU ops (message.h Request::device).
  int32_t device = 0;
  // Atomic grouped negotiation (reference: group_table.cc — GroupTable):
  // tensors sharing a non-empty key become ready all-or-nothing (the
  // coordinator withholds the group until group_size members are ready on
  // every rank) and are emitted contiguously, so they fuse together and
  // never interleave with other traffic.
  std::string group_key;
  int32_t group_size = 0;
  double enqueued_at = 0.0;    // monotonic seconds (stall inspection)
};

// A negotiated unit of work: one tensor or a fused bucket of allreduces
// (reference: Response in message.h).
struct Response {
  OpType op = OpType::ALLREDUCE;
  DataType dtype = DataType::FLOAT32;
  int32_t process_set_id = 0;
  std::vector<std::string> names;    // global agreement keyed by name
  std::vector<TensorRequest> metas;  // full metadata (cache determinism)
  std::vector<int64_t> handles;      // local handles (filled per rank)
  std::string error;                 // non-empty -> deliver failure
  bool cache_hit = false;
  int64_t seq = -1;  // global data-op sequence (tags data-plane frames)
  // Coordinator-decided plane refinement for host-plane allreduces: when
  // set, every member runs the hierarchical composition (shm-local reduce
  // to a per-host leader, leader-only cross-host ring, shm-local
  // broadcast) instead of the flat all-rank ring.  Carried in the
  // serialized response so the choice can never diverge across ranks —
  // a split plane would deadlock the data plane.
  bool hier = false;
  // Coordinator-decided wire codec for the cross-host ring hops of this
  // response (0=none, 1=bf16, 2=int8 — hvd::WireCodec).  Rides the
  // serialized response for the same reason as `hier`: a codec split
  // across ranks would be a framing mismatch on the data plane.  Demoted
  // to 0 for non-fp32 dtypes, device-plane ops, sub-floor payloads, and
  // topologies where any ring hop stays on-host (docs/compression.md).
  int32_t wire_comp = 0;
  int32_t last_joined = -1;  // JOIN responses: the last rank to join
  // When >= 0, only this rank acts on the response (tombstone error
  // deliveries: the name may have been consistently resubmitted by other
  // ranks, whose fresh handles must not absorb the stale error).  The
  // response list stays byte-identical on every rank; handling is what
  // differs, deterministically.
  int32_t target_rank = -1;
};

struct CoreConfig {
  int rank = 0;
  int size = 1;
  int local_rank = 0;
  int local_size = 1;
  std::string controller = "auto";   // local | socket
  std::string rendezvous_addr = "127.0.0.1";
  int rendezvous_port = 0;
  double cycle_time_ms = 1.0;
  int64_t fusion_threshold = 64LL * 1024 * 1024;
  int cache_capacity = 1024;
  bool autotune = false;
  std::string autotune_log;
  // HOROVOD_HIERARCHICAL_ALLREDUCE: compose shm-local reduce + leader-only
  // cross-host ring + shm-local broadcast for sets spanning hosts with
  // co-located ranks.  Only the coordinator's value matters (the decision
  // rides in each response), so per-rank divergence is harmless.
  bool hierarchical = false;
  // HOROVOD_WIRE_COMPRESSION: codec for cross-host ring hops (0=none,
  // 1=bf16, 2=int8, 3=int4, 4=int8g — hvdtpu::WireCodec).
  // Coordinator-authoritative like `hierarchical`.
  int wire_compression = 0;
  // HOROVOD_WIRE_COMPRESSION device= plane: codec for in-jit / eager-XLA
  // device collectives (0=none, 1=int8, 2=int4, 3=int8g; -1 = no device
  // plane, autotune arm pinned).  Enforced on the Python side; stored
  // here so the autotuner's qdev coordinate starts from the configured
  // value.
  int qdev_compression = 0;
  // HOROVOD_DEVICE_SCHEDULE: device-ring schedule (0=ring, 1=bidi,
  // 2=torus; -1 = schedule arm pinned — no device plane or a member count
  // that only admits the unidirectional ring).  Enforced on the Python
  // side like qdev_compression.
  int qdev_schedule = 0;
  // HOROVOD_DATA_PLANE: in-jit gradient-exchange plane (0=eager explicit
  // collectives, 1=gspmd compiler-inserted; -1 = plane arm pinned — no
  // multi-device mesh, or the quantized device codec owns the traced
  // reduction).  Enforced on the Python side (ops/gspmd_plane.py); stored
  // here so the autotuner's plane coordinate starts from the configured
  // value.
  int data_plane = 0;
  // HOROVOD_METRICS / HOROVOD_METRICS_FILE: enable the native metrics
  // registry; when metrics_file is non-empty the background loop writes a
  // JSON snapshot there every metrics_interval_s (a `{rank}` placeholder
  // is substituted, else `.<rank>` is appended — np>1 runs on one host
  // would otherwise clobber a shared path).
  bool metrics = false;
  std::string metrics_file;
  double metrics_interval_s = 10.0;
  std::string timeline_path;
  bool timeline_mark_cycles = false;
  double stall_warn_s = 60.0;
  double stall_shutdown_s = 0.0;
  int log_level = 2;  // 0=trace .. 5=fatal
  // HOROVOD_AUTOPILOT_PORT (driver-internal): when > 0 the coordinator
  // opens a driver-facing policy listener on this port serving the live
  // cluster view (straggler windows, counters) and accepting autopilot
  // decision records.  0 disables — the default, costing nothing.
  int autopilot_port = 0;
  // HOROVOD_STEP_TRACE / HOROVOD_STEP_TRACE_SLOTS: causal step tracing —
  // per-step phase attribution recorded into a per-rank ring (step_trace.h)
  // and aggregated fleet-wide on the coordinator from CYCLE trailers.  On
  // by default (a site pays a relaxed fetch_add); when off, one relaxed
  // bool load per site, same bar as the flight recorder.
  bool step_trace = true;
  int step_trace_slots = 256;
  // C++-selftest-only (never ABI-exposed): skip the O(n^2) data-plane mesh,
  // shm, and hierarchical setup so in-process control-plane soaks can run
  // hundreds of ranks within fd/time budgets.  Data-plane ops are invalid
  // under this flag.
  bool ctrl_only = false;
};

double MonotonicSeconds();

}  // namespace hvdtpu
