// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of horovod_tpu/ops/flash_attention.py:
//   K4 _mha_kernel          (forward: out and row log-sum-exp)
//   K5 _mha_bwd_dq_kernel   (dQ = sum_k dS K, P rebuilt from lse)
//   K6 _mha_bwd_dkv_kernel  (dV = P^T dO, dK = dS^T Q)
//
// What bounds them on this card: the tensor cores.  At the GPT-2-small
// shape (S 1024, head_dim 64) a causal forward does 2*S*S*D FLOP per head
// (two products over the lower triangle) against 4*S*D*2 bytes of
// q/k/v/out, S/4 = 256 FLOP per byte, close to the H100's 295 FLOP/byte
// balance point; the backward does 2.5x the products on 1.75x the bytes.
// So the work is the products, and the [S, S] score matrix, S/D times the
// size of q, must never reach device memory.
//
// How the design answers that (a first, simple design; wgmma, TMA and warp
// specialisation come later):
//  - The TPU grid's sequential innermost dimension, which carried acc/m/l in
//    VMEM scratch across steps, becomes a loop inside one CUDA block; the
//    online-softmax state and the output accumulator live in registers.
//  - Products run on the tensor cores as bf16 mma.sync m16n8k16 with fp32
//    accumulation; all softmax math is fp32, as on the TPU.  The score tile
//    stays in registers: the accumulator fragment of Q K^T is, element for
//    element, the A fragment of P V, so P never touches shared memory.
//  - Causal skipping is the loop bound (stop at the diagonal tile) instead of
//    the TPU's predicated dead tiles; causal forward/dQ blocks run the
//    longest rows first so the tail of the grid is short.
//  - The ragged edge of S is masked inside the kernels (zero-filled loads,
//    -1e30 scores, no stores past S), so the wrapper never pads; padded
//    rows get zero gradient.
//  - lse is written as [B*H, S] fp32: the TPU's 128-lane broadcast of row
//    statistics is a TPU layout rule and is not ported.
//  - The dQ / dK-dV split of the TPU kernels is kept: one block owns a q tile
//    (dQ) or a k tile (dK, dV), so no atomics are needed.
//  - Inputs are read in place from the [B, S, H, D] layout through strides
//    (a view of the fused qkv projection costs no copy); outputs are
//    contiguous [B, S, H, D].
//
// Every entry point returns cudaGetLastError() (0 on success) and launches on
// the stream it is given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;  // rows of every tile: 16 per warp
constexpr int kPad = 8;    // bf16 of padding per shared-memory row (bank spread)

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* out;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* lse;          // [B*H, S]
  const float* delta;  // [B*H, S]
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  int B, H, S;
  float scale;
  int causal;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 that are not neighbours in memory, `lo` in the low half.
__device__ __forceinline__ uint32_t pack2(const bf16* lo, const bf16* hi) {
  const uint32_t a = *reinterpret_cast<const unsigned short*>(lo);
  const uint32_t b = *reinterpret_cast<const unsigned short*>(hi);
  return a | (b << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b on the tensor cores: A 16x16 row-major, B 16x8 column-major,
// C 16x8 fp32.  Fragment layout (lane = 4*g + t):
//   a[0]: A[g][2t..2t+1]    a[1]: A[g+8][2t..2t+1]
//   a[2]: A[g][2t+8..2t+9]  a[3]: A[g+8][2t+8..2t+9]
//   b0:   B[2t..2t+1][g]    b1:   B[2t+8..2t+9][g]
//   c[0..1]: C[g][2t..2t+1] c[2..3]: C[g+8][2t..2t+1]
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment: rows r0..r0+15, columns k0..k0+15 of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int ld, int r0, int k0, int lane) {
  const bf16* p = s + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment with B[k][n] = T[n0 + n][k0 + k] (T row-major): the product
// with T transposed, e.g. Q K^T.
__device__ __forceinline__ void load_bt(uint32_t& b0, uint32_t& b1,
                                        const bf16* s, int ld, int n0, int k0,
                                        int lane) {
  const bf16* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragment with B[k][n] = T[k0 + k][n0 + n] (T row-major), e.g. P V.
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* s, int ld, int k0, int n0,
                                       int lane) {
  const bf16* p = s + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  b0 = pack2(p, p + ld);
  b1 = pack2(p + 8 * ld, p + 9 * ld);
}

// Rows row0..row0+63 of one head ([S, D] at `g` with row stride `ss`) into
// shared memory, zero past S.  16 bytes per thread per step.
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long ss, int row0, int S) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) val = *reinterpret_cast<const uint4*>(g + row * ss + ch * 8);
    *reinterpret_cast<uint4*>(s + r * (D + kPad) + ch * 8) = val;
  }
}

// Rows r (accumulator element e < 2) and r + 8 (e >= 2) of a warp's
// fragments, as (row, column) pairs of its C fragments, stored as bf16.
template <int D>
__device__ __forceinline__ void store_rows(bf16* g, long long ss,
                                           const float (&acc)[D / 8][4],
                                           int row, int S, int lane,
                                           float mul_lo, float mul_hi) {
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    if (row < S)
      *reinterpret_cast<__nv_bfloat162*>(g + row * ss + dt * 8 + col) =
          __floats2bfloat162_rn(acc[dt][0] * mul_lo, acc[dt][1] * mul_lo);
    if (row + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(g + (row + 8) * ss + dt * 8 + col) =
          __floats2bfloat162_rn(acc[dt][2] * mul_hi, acc[dt][3] * mul_hi);
  }
}

// K4: one block per (q tile, b*h), looping over kv tiles.
template <int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = D + kPad;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kRows * LD;
  bf16* sV = sK + kRows * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int n_tiles = (p.S + kRows - 1) / kRows;
  const int m_tile = p.causal ? n_tiles - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int m0 = m_tile * kRows;
  const bf16* q = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* k = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* v = p.v + b * p.v_sb + h * p.v_sh;
  const int row_lo = m0 + warp * 16 + (lane >> 2);
  const int row_hi = row_lo + 8;

  load_tile<D>(sQ, q, p.q_ss, m0, p.S);

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums

  const int kv_end = p.causal ? min(p.S, m0 + kRows) : p.S;
  for (int n0 = 0; n0 < kv_end; n0 += kRows) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sK, k, p.k_ss, n0, p.S);
    load_tile<D>(sV, v, p.v_ss, n0, p.S);
    __syncthreads();

    float s[kRows / 8][4];
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sQ, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        uint32_t b0, b1;
        load_bt(b0, b1, sK, LD, j * 8, kk * 16, lane);
        mma(s[j], a, b0, b1);
      }
    }

    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        const bool live = p.causal ? col <= row : col < p.S;
        const float x = live ? s[j][e] * p.scale : kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha[2] = {__expf(m_run[0] - mx[0]), __expf(m_run[1] - mx[1])};
    m_run[0] = mx[0];
    m_run[1] = mx[1];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - mx[e >> 1]);
        psum[e >> 1] += s[j][e];
      }
    l_run[0] = l_run[0] * alpha[0] + psum[0];
    l_run[1] = l_run[1] * alpha[1] + psum[1];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    // acc += P V, P cast to bf16 (the TPU kernel's p.astype(v.dtype)).
#pragma unroll
    for (int kc = 0; kc < kRows / 16; ++kc) {
      const uint32_t a[4] = {pack_f32(s[2 * kc][0], s[2 * kc][1]),
                             pack_f32(s[2 * kc][2], s[2 * kc][3]),
                             pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b(b0, b1, sV, LD, kc * 16, dt * 8, lane);
        mma(acc[dt], a, b0, b1);
      }
    }
  }

  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = l_run[i];
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  const long long o_ss = (long long)p.H * D;
  bf16* out = p.out + (long long)b * p.S * o_ss + (long long)h * D;
  store_rows<D>(out, o_ss, acc, row_lo, p.S, lane, 1.f / l[0], 1.f / l[1]);
  if (t == 0) {
    float* lse = p.lse + (long long)bh * p.S;
    if (row_lo < p.S) lse[row_lo] = m_run[0] + logf(l[0]);
    if (row_hi < p.S) lse[row_hi] = m_run[1] + logf(l[1]);
  }
}

// K5: one block per (q tile, b*h), looping over kv tiles.
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = D + kPad;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + kRows * LD;
  bf16* sK = sDO + kRows * LD;
  bf16* sV = sK + kRows * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int n_tiles = (p.S + kRows - 1) / kRows;
  const int m_tile = p.causal ? n_tiles - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int m0 = m_tile * kRows;
  const bf16* k = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* v = p.v + b * p.v_sb + h * p.v_sh;
  const int row_lo = m0 + warp * 16 + (lane >> 2);
  const int row_hi = row_lo + 8;
  const int rows[2] = {row_lo, row_hi};

  load_tile<D>(sQ, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, m0, p.S);
  load_tile<D>(sDO, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, m0, p.S);
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < p.S;
    lse[i] = in ? p.lse[(long long)bh * p.S + rows[i]] : 0.f;
    delta[i] = in ? p.delta[(long long)bh * p.S + rows[i]] : 0.f;
  }
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qf[kk], sQ, LD, warp * 16, kk * 16, lane);
    load_a(dof[kk], sDO, LD, warp * 16, kk * 16, lane);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int kv_end = p.causal ? min(p.S, m0 + kRows) : p.S;
  for (int n0 = 0; n0 < kv_end; n0 += kRows) {
    __syncthreads();
    load_tile<D>(sK, k, p.k_ss, n0, p.S);
    load_tile<D>(sV, v, p.v_ss, n0, p.S);
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kRows / 16; ++kc) {  // 16 keys at a time
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t b0, b1;
          load_bt(b0, b1, sK, LD, kc * 16 + jj * 8, kk * 16, lane);
          mma(s[jj], qf[kk], b0, b1);
          load_bt(b0, b1, sV, LD, kc * 16 + jj * 8, kk * 16, lane);
          mma(dp[jj], dof[kk], b0, b1);
        }
      // dS = P o (dP - delta) * scale, with P = exp(S*scale - lse).
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + kc * 16 + jj * 8 + 2 * t + (e & 1);
          const int row = rows[e >> 1];
          const bool live = p.causal ? col <= row : col < p.S;
          const float pr =
              live ? __expf(s[jj][e] * p.scale - lse[e >> 1]) : 0.f;
          s[jj][e] = pr * (dp[jj][e] - delta[e >> 1]) * p.scale;
        }
      const uint32_t a[4] = {pack_f32(s[0][0], s[0][1]), pack_f32(s[0][2], s[0][3]),
                             pack_f32(s[1][0], s[1][1]), pack_f32(s[1][2], s[1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b(b0, b1, sK, LD, kc * 16, dt * 8, lane);
        mma(acc[dt], a, b0, b1);
      }
    }
  }
  const long long o_ss = (long long)p.H * D;
  bf16* dq = p.dq + (long long)b * p.S * o_ss + (long long)h * D;
  store_rows<D>(dq, o_ss, acc, row_lo, p.S, lane, 1.f, 1.f);
}

// K6: one block per (k tile, b*h), looping over q tiles.  Each warp owns
// 16 keys; the products are taken transposed (S^T = K Q^T), so the
// accumulator fragments of P^T and dS^T feed dV and dK directly.
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dkv_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = D + kPad;
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRows * LD;
  bf16* sQ = sV + kRows * LD;
  bf16* sDO = sQ + kRows * LD;
  float* sL = reinterpret_cast<float*>(sDO + kRows * LD);
  float* sDelta = sL + kRows;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int n0 = blockIdx.x * kRows;
  const bf16* q = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* dout = p.dout + b * p.do_sb + h * p.do_sh;
  const int key_lo = n0 + warp * 16 + (lane >> 2);
  const int keys[2] = {key_lo, key_lo + 8};

  load_tile<D>(sK, p.k + b * p.k_sb + h * p.k_sh, p.k_ss, n0, p.S);
  load_tile<D>(sV, p.v + b * p.v_sb + h * p.v_sh, p.v_ss, n0, p.S);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  const int m_begin = p.causal ? n0 : 0;  // earlier queries see none of these keys
  for (int m0 = m_begin; m0 < p.S; m0 += kRows) {
    __syncthreads();
    load_tile<D>(sQ, q, p.q_ss, m0, p.S);
    load_tile<D>(sDO, dout, p.do_ss, m0, p.S);
    if (threadIdx.x < kRows) {
      const int row = m0 + threadIdx.x;
      const bool in = row < p.S;
      sL[threadIdx.x] = in ? p.lse[(long long)bh * p.S + row] : 0.f;
      sDelta[threadIdx.x] = in ? p.delta[(long long)bh * p.S + row] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int qc = 0; qc < kRows / 16; ++qc) {  // 16 queries at a time
      float st[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dpt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, sK, LD, warp * 16, kk * 16, lane);
        load_a(av, sV, LD, warp * 16, kk * 16, lane);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t b0, b1;
          load_bt(b0, b1, sQ, LD, qc * 16 + jj * 8, kk * 16, lane);
          mma(st[jj], ak, b0, b1);
          load_bt(b0, b1, sDO, LD, qc * 16 + jj * 8, kk * 16, lane);
          mma(dpt[jj], av, b0, b1);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qc * 16 + jj * 8 + 2 * t + (e & 1);
          const int qpos = m0 + qi;
          const int key = keys[e >> 1];
          const bool live = qpos < p.S && key < p.S && (!p.causal || key <= qpos);
          const float pr = live ? __expf(st[jj][e] * p.scale - sL[qi]) : 0.f;
          st[jj][e] = pr;
          dpt[jj][e] = pr * (dpt[jj][e] - sDelta[qi]) * p.scale;
        }
      const uint32_t ap[4] = {pack_f32(st[0][0], st[0][1]), pack_f32(st[0][2], st[0][3]),
                              pack_f32(st[1][0], st[1][1]), pack_f32(st[1][2], st[1][3])};
      const uint32_t ads[4] = {pack_f32(dpt[0][0], dpt[0][1]), pack_f32(dpt[0][2], dpt[0][3]),
                               pack_f32(dpt[1][0], dpt[1][1]), pack_f32(dpt[1][2], dpt[1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b(b0, b1, sDO, LD, qc * 16, dt * 8, lane);
        mma(dv[dt], ap, b0, b1);
        load_b(b0, b1, sQ, LD, qc * 16, dt * 8, lane);
        mma(dk[dt], ads, b0, b1);
      }
    }
  }
  const long long o_ss = (long long)p.H * D;
  const long long off = (long long)b * p.S * o_ss + (long long)h * D;
  store_rows<D>(p.dk + off, o_ss, dk, key_lo, p.S, lane, 1.f, 1.f);
  store_rows<D>(p.dv + off, o_ss, dv, key_lo, p.S, lane, 1.f, 1.f);
}

template <typename Kernel>
int launch(Kernel kernel, int n_blocks, const Params& p, size_t smem,
           void* stream) {
  if (p.B * p.H > 65535 || p.S <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_blocks, p.B * p.H), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

size_t tile_bytes(int D) { return (size_t)kRows * (D + kPad) * sizeof(bf16); }

Params make_params(const void* q, const void* k, const void* v,
                   const long long* strides, int B, int H, int S, float scale,
                   int causal) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.do_sb = strides[9]; p.do_ss = strides[10]; p.do_sh = strides[11];
  p.B = B; p.H = H; p.S = S;
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

// strides: 12 int64, (batch, seq, head) element strides of q, k, v and dout
// (dout's are unused by the forward).  Outputs are contiguous [B, S, H, D].
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const long long* strides,
                             int B, int H, int S, int D, float scale,
                             int causal, void* stream) {
  Params p = make_params(q, k, v, strides, B, H, S, scale, causal);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  const int n = (S + kRows - 1) / kRows;
  if (D == 64) return launch(fwd_kernel<64>, n, p, 3 * tile_bytes(64), stream);
  if (D == 128) return launch(fwd_kernel<128>, n, p, 3 * tile_bytes(128), stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq,
                                const long long* strides, int B, int H, int S,
                                int D, float scale, int causal, void* stream) {
  Params p = make_params(q, k, v, strides, B, H, S, scale, causal);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  const int n = (S + kRows - 1) / kRows;
  if (D == 64) return launch(bwd_dq_kernel<64>, n, p, 4 * tile_bytes(64), stream);
  if (D == 128) return launch(bwd_dq_kernel<128>, n, p, 4 * tile_bytes(128), stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const long long* strides, int B, int H,
                                 int S, int D, float scale, int causal,
                                 void* stream) {
  Params p = make_params(q, k, v, strides, B, H, S, scale, causal);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  const int n = (S + kRows - 1) / kRows;
  const size_t stats = 2 * kRows * sizeof(float);
  if (D == 64)
    return launch(bwd_dkv_kernel<64>, n, p, 4 * tile_bytes(64) + stats, stream);
  if (D == 128)
    return launch(bwd_dkv_kernel<128>, n, p, 4 * tile_bytes(128) + stats, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
