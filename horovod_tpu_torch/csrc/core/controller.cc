#include "controller.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <unordered_map>
#include <utility>

#include "logging.h"

namespace hvdtpu {

// ---- ProcessSetTable ------------------------------------------------------

void ProcessSetTable::InitGlobal(int world_size) {
  std::lock_guard<std::mutex> l(mu_);
  std::vector<int> all(world_size);
  for (int i = 0; i < world_size; ++i) all[i] = i;
  sets_[0] = all;
}

int ProcessSetTable::Add(const std::vector<int>& ranks) {
  return AddWeighted(ranks, 1.0);
}

int ProcessSetTable::AddWeighted(const std::vector<int>& ranks,
                                 double weight) {
  std::lock_guard<std::mutex> l(mu_);
  std::vector<int> sorted = ranks;
  std::sort(sorted.begin(), sorted.end());
  sorted.erase(std::unique(sorted.begin(), sorted.end()), sorted.end());
  int id = next_id_++;
  sets_[id] = sorted;
  // Clamp: a zero/negative weight would let the scheduler starve the set
  // outright, which is a deadlock (its members still block on the ring).
  weights_[id] = weight > 0.0 ? weight : 1.0;
  return id;
}

void ProcessSetTable::Remove(int id) {
  if (id == 0) return;
  std::lock_guard<std::mutex> l(mu_);
  sets_.erase(id);
  weights_.erase(id);
}

bool ProcessSetTable::Ranks(int id, std::vector<int>* out) const {
  std::lock_guard<std::mutex> l(mu_);
  auto it = sets_.find(id);
  if (it == sets_.end()) return false;
  *out = it->second;
  return true;
}

bool ProcessSetTable::Contains(int id, int rank) const {
  std::lock_guard<std::mutex> l(mu_);
  auto it = sets_.find(id);
  if (it == sets_.end()) return false;
  return std::binary_search(it->second.begin(), it->second.end(), rank);
}

double ProcessSetTable::Weight(int id) const {
  std::lock_guard<std::mutex> l(mu_);
  auto it = weights_.find(id);
  // Set 0 (the global set) and any pre-weight registration stay at 1.0.
  return it == weights_.end() ? 1.0 : it->second;
}

// ---- Fusion ---------------------------------------------------------------

std::vector<Response> FuseRequests(const std::vector<TensorRequest>& ready,
                                   int64_t fusion_threshold) {
  std::vector<Response> out;
  std::vector<const TensorRequest*> bucket;
  int64_t bucket_bytes = 0;

  auto flush = [&]() {
    if (bucket.empty()) return;
    Response r;
    r.op = bucket.front()->op;
    r.dtype = bucket.front()->dtype;
    r.process_set_id = bucket.front()->process_set_id;
    for (auto* t : bucket) {
      r.names.push_back(t->name);
      r.metas.push_back(*t);
    }
    out.push_back(std::move(r));
    bucket.clear();
    bucket_bytes = 0;
  };

  for (const auto& t : ready) {
    if (t.op == OpType::ALLREDUCE) {
      bool fusable = !bucket.empty() &&
                     bucket.front()->op == OpType::ALLREDUCE &&
                     bucket.front()->dtype == t.dtype &&
                     bucket.front()->process_set_id == t.process_set_id &&
                     bucket.front()->reduce_op == t.reduce_op &&
                     bucket.front()->prescale == t.prescale &&
                     bucket.front()->postscale == t.postscale &&
                     // device buckets stay pure: a fused response executes
                     // on exactly one data plane
                     bucket.front()->device == t.device &&
                     bucket_bytes + t.nbytes <= fusion_threshold;
      if (!fusable) flush();
      bucket.push_back(&t);
      bucket_bytes += t.nbytes;
    } else if (t.op == OpType::ALLGATHER) {
      // Allgathers fuse too (reference: AllgatherOp shares the fusion
      // buffer): the executor packs members length-prefixed, so only the
      // process set has to match.
      bool fusable = !bucket.empty() &&
                     bucket.front()->op == OpType::ALLGATHER &&
                     bucket.front()->process_set_id == t.process_set_id &&
                     bucket_bytes + t.nbytes <= fusion_threshold;
      if (!fusable) flush();
      bucket.push_back(&t);
      bucket_bytes += t.nbytes;
    } else {
      flush();
      Response r;
      r.op = t.op;
      r.dtype = t.dtype;
      r.process_set_id = t.process_set_id;
      r.names.push_back(t.name);
      r.metas.push_back(t);
      out.push_back(std::move(r));
    }
  }
  flush();
  return out;
}

// ---- LocalController ------------------------------------------------------

Status LocalController::Initialize() {
  process_sets_.InitGlobal(1);
  return Status::OK();
}

Status LocalController::ComputeResponses(
    std::vector<TensorRequest>& new_requests, std::vector<Response>* out) {
  // Atomic group gating at np=1: a grouped enqueue can race the cycle
  // drain mid-call, so members may arrive across drains — hold a group
  // until all group_size members are present (GateAndOrderGroups; the
  // SocketController coordinator applies the same rule cross-rank).
  for (auto& r : new_requests) held_.emplace_back(arrival_++, std::move(r));
  std::vector<TensorRequest> ready;
  std::vector<std::pair<int64_t, TensorRequest>> still_held;
  GateAndOrderGroups(
      std::move(held_), &still_held, &ready,
      [](const TensorRequest& r) -> const TensorRequest& { return r; });
  held_ = std::move(still_held);
  *out = FuseRequests(ready, cfg_.fusion_threshold);
  for (auto& r : *out) {
    // Single process: this rank is trivially the last (and only) joiner.
    if (r.op == OpType::JOIN) r.last_joined = 0;
  }
  return Status::OK();
}

// ---- typed reduction ------------------------------------------------------

namespace {

// bfloat16 <-> float conversion for host-side reduction.
inline float Bf16ToF32(uint16_t v) {
  uint32_t bits = static_cast<uint32_t>(v) << 16;
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}
inline uint16_t F32ToBf16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  // round-to-nearest-even like XLA
  uint32_t rounding_bias = ((bits >> 16) & 1) + 0x7FFF;
  return static_cast<uint16_t>((bits + rounding_bias) >> 16);
}
// IEEE fp16 conversion (scalar; host path only).
inline float F16ToF32(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {
      // subnormal
      int shift = 0;
      while (!(mant & 0x400)) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FF;
      bits = sign | ((127 - 15 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}
inline uint16_t F32ToF16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t sign = (bits >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((bits >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = bits & 0x7FFFFFu;
  if (exp >= 31) return static_cast<uint16_t>(sign | 0x7C00u);  // inf/overflow
  if (exp <= 0) {
    if (exp < -10) return static_cast<uint16_t>(sign);
    mant |= 0x800000u;
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half = mant >> shift;
    // round to nearest
    if ((mant >> (shift - 1)) & 1) half += 1;
    return static_cast<uint16_t>(sign | half);
  }
  uint16_t h = static_cast<uint16_t>(sign | (exp << 10) | (mant >> 13));
  if (mant & 0x1000) h += 1;  // round
  return h;
}

template <typename T>
void ReduceTyped(T* acc, const T* c, int64_t n, ReduceOp op) {
  switch (op) {
    case ReduceOp::SUM:
    case ReduceOp::AVERAGE:  // averaging divide happens after the full reduce
    case ReduceOp::ADASUM:
      for (int64_t i = 0; i < n; ++i) acc[i] = static_cast<T>(acc[i] + c[i]);
      break;
    case ReduceOp::MIN:
      for (int64_t i = 0; i < n; ++i) acc[i] = std::min(acc[i], c[i]);
      break;
    case ReduceOp::MAX:
      for (int64_t i = 0; i < n; ++i) acc[i] = std::max(acc[i], c[i]);
      break;
    case ReduceOp::PRODUCT:
      for (int64_t i = 0; i < n; ++i) acc[i] = static_cast<T>(acc[i] * c[i]);
      break;
  }
}

template <typename Cvt16ToF, typename F32To16>
void Reduce16(uint16_t* acc, const uint16_t* c, int64_t n, ReduceOp op,
              Cvt16ToF to_f32, F32To16 to_16) {
  for (int64_t i = 0; i < n; ++i) {
    float a = to_f32(acc[i]);
    float b = to_f32(c[i]);
    float r;
    switch (op) {
      case ReduceOp::MIN: r = std::min(a, b); break;
      case ReduceOp::MAX: r = std::max(a, b); break;
      case ReduceOp::PRODUCT: r = a * b; break;
      default: r = a + b; break;
    }
    acc[i] = to_16(r);
  }
}

void ReduceBool(uint8_t* acc, const uint8_t* c, int64_t n, ReduceOp op) {
  switch (op) {
    case ReduceOp::MIN:
      for (int64_t i = 0; i < n; ++i) acc[i] = acc[i] & c[i];
      break;
    case ReduceOp::PRODUCT:
      for (int64_t i = 0; i < n; ++i) acc[i] = acc[i] & c[i];
      break;
    default:  // SUM/MAX -> logical or
      for (int64_t i = 0; i < n; ++i) acc[i] = acc[i] | c[i];
      break;
  }
}

}  // namespace

void ReduceInto(void* acc, const void* contrib, int64_t count, DataType dtype,
                ReduceOp op) {
  switch (dtype) {
    case DataType::FLOAT32:
      ReduceTyped(static_cast<float*>(acc),
                  static_cast<const float*>(contrib), count, op);
      break;
    case DataType::FLOAT64:
      ReduceTyped(static_cast<double*>(acc),
                  static_cast<const double*>(contrib), count, op);
      break;
    case DataType::INT32:
      ReduceTyped(static_cast<int32_t*>(acc),
                  static_cast<const int32_t*>(contrib), count, op);
      break;
    case DataType::INT64:
      ReduceTyped(static_cast<int64_t*>(acc),
                  static_cast<const int64_t*>(contrib), count, op);
      break;
    case DataType::UINT8:
      ReduceTyped(static_cast<uint8_t*>(acc),
                  static_cast<const uint8_t*>(contrib), count, op);
      break;
    case DataType::INT8:
      ReduceTyped(static_cast<int8_t*>(acc),
                  static_cast<const int8_t*>(contrib), count, op);
      break;
    case DataType::UINT16:
      ReduceTyped(static_cast<uint16_t*>(acc),
                  static_cast<const uint16_t*>(contrib), count, op);
      break;
    case DataType::INT16:
      ReduceTyped(static_cast<int16_t*>(acc),
                  static_cast<const int16_t*>(contrib), count, op);
      break;
    case DataType::BOOL:
      ReduceBool(static_cast<uint8_t*>(acc),
                 static_cast<const uint8_t*>(contrib), count, op);
      break;
    case DataType::FLOAT16:
      Reduce16(static_cast<uint16_t*>(acc),
               static_cast<const uint16_t*>(contrib), count, op, F16ToF32,
               F32ToF16);
      break;
    case DataType::BFLOAT16:
      Reduce16(static_cast<uint16_t*>(acc),
               static_cast<const uint16_t*>(contrib), count, op, Bf16ToF32,
               F32ToBf16);
      break;
  }
}

}  // namespace hvdtpu
