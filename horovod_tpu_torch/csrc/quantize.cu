// Block-scaled wire codecs, encode and decode, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of horovod_tpu/ops/quantize.py:
//   K1 _quant_kernel        int8 codes:  clamp(rint(x * inv), +-127)
//   K2 _quant_kernel_int4   int4 codes:  clamp(rint(x * inv), +-7), here with
//                           the nibble pack of _pack_int4 fused in
//   K3 _dequant_kernel      fp32 scale * code
// Each works on [nblocks, 256] rows (one wire block of 256 elements per row)
// with one fp32 inv or scale per row.  The per-block max, the scales and
// their reciprocals are computed outside, in torch, as the reference computes
// them outside its kernels: correctly rounded fp32 divides, so that every
// rank and the C++ codec (cpp/wire_codec.h) derive the same bits.
//
// What bounds them on this card: memory.  K1 reads 4 bytes and writes 1 per
// element (plus 4 bytes of inv per 256 elements), under one operation per
// byte; K2 writes half a byte, K3 reads 1 and writes 4.  So the design is a
// single streaming pass: one thread per 4 consecutive elements, 16-byte fp32
// loads or stores, 64 threads per wire block and the block's inv or scale
// read once by each thread from L1.  Nothing is staged in shared memory.
//
// Bit-exactness with the reference, which the ring relies on:
//  - x * inv is its own correctly rounded multiply (__fmul_rn cannot be
//    contracted into an fma), then rintf: round half to even, as jnp.round
//    and std::nearbyintf.  No fast math: subnormals are kept.
//  - The clamp is fmaxf(fminf(v, q), -q).  fminf returns its non-NaN operand,
//    so a NaN element of a finite block becomes +q, as std::min(q, v) does in
//    the C++ codec and where(v < q, v, q) in the reference.
//  - inv == 0 marks an all-zero or non-finite block: its codes are 0.
//  - K2 puts element 2i in the low nibble of byte i and 2i+1 in the high one,
//    each as the low 4 bits of the two's-complement code (_pack_int4).
//  - K3 is one fp32 multiply per element.
//
// Every entry point returns cudaGetLastError() (0 on success) and launches on
// the stream it is given.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 4;                            // elements per thread
constexpr int kWireBlock = 256;                    // elements per scale
constexpr int kThreadsPerRow = kWireBlock / kVec;  // 64
constexpr int kThreads = 256;                      // 4 wire blocks per CUDA block

__device__ __forceinline__ int code_of(float x, float inv, float qmax) {
  const float v = rintf(__fmul_rn(x, inv));
  return static_cast<int>(fmaxf(fminf(v, qmax), -qmax));
}

__global__ void quant_int8_kernel(const float4* __restrict__ x,
                                  const float* __restrict__ inv,
                                  char4* __restrict__ q, long long n_vec) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const float s = inv[i / kThreadsPerRow];
  char4 c = make_char4(0, 0, 0, 0);
  if (s > 0.0f) {
    const float4 v = x[i];
    c = make_char4(static_cast<signed char>(code_of(v.x, s, 127.0f)),
                   static_cast<signed char>(code_of(v.y, s, 127.0f)),
                   static_cast<signed char>(code_of(v.z, s, 127.0f)),
                   static_cast<signed char>(code_of(v.w, s, 127.0f)));
  }
  q[i] = c;
}

__device__ __forceinline__ unsigned nibble(float x, float inv) {
  return static_cast<unsigned>(code_of(x, inv, 7.0f)) & 0xFu;
}

// Writes the packed [nblocks, 128] bytes: 4 elements -> 2 bytes per thread.
__global__ void quant_int4_kernel(const float4* __restrict__ x,
                                  const float* __restrict__ inv,
                                  uint16_t* __restrict__ q, long long n_vec) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const float s = inv[i / kThreadsPerRow];
  unsigned packed = 0;
  if (s > 0.0f) {
    const float4 v = x[i];
    const unsigned b0 = nibble(v.x, s) | (nibble(v.y, s) << 4);
    const unsigned b1 = nibble(v.z, s) | (nibble(v.w, s) << 4);
    packed = b0 | (b1 << 8);  // little-endian: b0 at the lower address
  }
  q[i] = static_cast<uint16_t>(packed);
}

__global__ void dequant_kernel(const char4* __restrict__ q,
                               const float* __restrict__ scale,
                               float4* __restrict__ x, long long n_vec) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const float s = scale[i / kThreadsPerRow];
  const char4 c = q[i];
  x[i] = make_float4(__fmul_rn(s, static_cast<float>(c.x)),
                     __fmul_rn(s, static_cast<float>(c.y)),
                     __fmul_rn(s, static_cast<float>(c.z)),
                     __fmul_rn(s, static_cast<float>(c.w)));
}

dim3 grid_of(long long n_vec) {
  return dim3(static_cast<unsigned>((n_vec + kThreads - 1) / kThreads));
}

}  // namespace

// x: fp32 [nblocks, 256], inv: fp32 [nblocks], q: int8 [nblocks, 256]; all
// contiguous, x 16-byte aligned.
extern "C" int hvd_quant_int8(const void* x, const void* inv, void* q,
                              long long nblocks, void* stream) {
  if (nblocks <= 0) return (int)cudaErrorInvalidValue;
  const long long n_vec = nblocks * kThreadsPerRow;
  quant_int8_kernel<<<grid_of(n_vec), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float*>(inv),
      static_cast<char4*>(q), n_vec);
  return (int)cudaGetLastError();
}

// As hvd_quant_int8, with q: packed int4 [nblocks, 128] bytes.
extern "C" int hvd_quant_int4(const void* x, const void* inv, void* q,
                              long long nblocks, void* stream) {
  if (nblocks <= 0) return (int)cudaErrorInvalidValue;
  const long long n_vec = nblocks * kThreadsPerRow;
  quant_int4_kernel<<<grid_of(n_vec), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float*>(inv),
      static_cast<uint16_t*>(q), n_vec);
  return (int)cudaGetLastError();
}

// q: int8 [nblocks, 256], scale: fp32 [nblocks], x: fp32 [nblocks, 256]; all
// contiguous, x 16-byte aligned and q 4-byte aligned.
extern "C" int hvd_dequant(const void* q, const void* scale, void* x,
                           long long nblocks, void* stream) {
  if (nblocks <= 0) return (int)cudaErrorInvalidValue;
  const long long n_vec = nblocks * kThreadsPerRow;
  dequant_kernel<<<grid_of(n_vec), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char4*>(q), static_cast<const float*>(scale),
      static_cast<float4*>(x), n_vec);
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
