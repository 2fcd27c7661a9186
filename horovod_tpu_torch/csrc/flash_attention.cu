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
// Shared by the three kernels:
//  - The TPU grid's sequential innermost dimension, which carried acc/m/l in
//    VMEM scratch across steps, becomes a loop inside one CUDA block; the
//    online-softmax state and the output accumulators live in registers.
//  - Products are bf16 with fp32 accumulation; all softmax math is fp32, as
//    on the TPU.  The score tile stays in registers: the accumulator
//    fragment of the first product is, element for element, the A fragment
//    of the second, so P and dS never touch shared memory.
//  - Causal skipping is the loop bound (stop at, or start from, the
//    diagonal tile) instead of the TPU's predicated dead tiles; causal
//    forward/dQ blocks run the longest rows first so the grid's tail is
//    short.
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
// All three are Hopper kernels (sm90.cuh): tiles arrive by TMA through a
// two-stage ring of mbarriers, issued by one thread two tiles ahead, and a
// warpgroup of 64 rows runs the products on wgmma (scores with both
// operands in shared memory, the second product with P or dS from
// registers and the shared tile read transposed through the descriptor).
// Tensor maps are rank 4 over (D, H, S, B) with the view's own strides, so
// TMA zero-fills rows past S inside each batch, and K4 stores its output
// by TMA, which leaves rows past S unwritten.  K5 also computes the
// backward's row statistic delta = rowsum(dO o O) - dlse from one more
// tile before its key loop, and writes it for K6, which runs after it.
//
// Every entry point returns cudaGetLastError() (0 on success) and launches on
// the stream it is given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

// One warpgroup a block, owning 64 rows (query rows in K4 and K5, keys in
// K6), thread 0 also issuing the loads.  Blocks this small let three (K5:
// four) share an SM at head_dim 64, and their independent progress is what
// overlaps one block's softmax with another's products; two warpgroups in
// one block ran in step and were slower.  There is no producer warp: a
// wgmma kernel's block is counted in whole warpgroups, and ptxas (CUDA
// 12.8) kept the consumers at the launch budget after `setmaxnreg`.
constexpr int kWgThreads = 128;
constexpr int kWgRows = 64;           // rows a block owns
constexpr int kKvRows = 128;          // keys of a K4 kv tile
constexpr int kBox = 128 * 64 * 2;    // bytes of a 128-row, 64-column box
constexpr int kRowBox = 64 * 64 * 2;  // bytes of a 64-row box

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* out;           // written by K4, read by K5
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* lse;          // [B*H, S]
  float* delta;        // [B*H, S], written by K5, read by K6
  const float* dlse;   // [B*H, S], or null: the lse cotangent K5 folds in
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long o_sb, o_ss, o_sh;  // out as K5 reads it
  int B, H, S;
  float scale;
  int causal;
};

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Rows `row` and `row + 8` of a consumer warp's wgmma accumulators (D / 64
// m64n64 blocks), stored as bf16; nothing past S.
template <int D>
__device__ __forceinline__ void store_wg_rows(bf16* g, long long ss,
                                              const float (&acc)[D / 64][32],
                                              int row, int S, int lane) {
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = nb * 64 + j * 8 + col;
      if (row < S)
        *reinterpret_cast<__nv_bfloat162*>(g + row * ss + c) =
            __floats2bfloat162_rn(acc[nb][4 * j], acc[nb][4 * j + 1]);
      if (row + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(g + (row + 8) * ss + c) =
            __floats2bfloat162_rn(acc[nb][4 * j + 2], acc[nb][4 * j + 3]);
    }
}

// The A fragments of a second product from the fp32 accumulator of a first
// one (keys or queries 16 kc .. 16 kc + 15), rounded to bf16.
template <int KC>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[KC][4],
                                           const float (&s)[KC * 8]) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    a[kc][0] = pack_f32(s[8 * kc + 0], s[8 * kc + 1]);
    a[kc][1] = pack_f32(s[8 * kc + 2], s[8 * kc + 3]);
    a[kc][2] = pack_f32(s[8 * kc + 4], s[8 * kc + 5]);
    a[kc][3] = pack_f32(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// S = Q K^T for one warpgroup: 64 query rows by 128 keys, both operands
// K-major in shared memory (issue only; the caller fences and commits).
template <int D>
__device__ __forceinline__ void scores(float (&s)[64],
                                       const unsigned char* q_tile,
                                       const unsigned char* k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk % 4) * 32;
    sm90::wgmma_ss_n128(s, sm90::desc_sw128(q_tile + (kk / 4) * kRowBox + off),
                        sm90::desc_sw128(k_tile + (kk / 4) * kBox + off),
                        kk > 0);
  }
}

// O += P V: P from registers as bf16 A fragments, V read MN-major by the
// descriptor, one m64n64 block per 64 columns (issue only).
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 64][32],
                                   const uint32_t (&pa)[8][4],
                                   const unsigned char* v_tile) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc)
#pragma unroll
    for (int x = 0; x < D / 64; ++x)
      sm90::wgmma_rs_n64_tb(o[x], pa[kc],
                            sm90::desc_sw128(v_tile + x * kBox + kc * 2048),
                            1);
}

// One kv tile of the online softmax for a thread's two rows: the raw
// scores s become P = 2^(s sl2 - m sl2) (one FFMA and one ex2 an element;
// the scale sl2 = scale log2(e) > 0 commutes with the max), the running raw
// max m and partial sum l are updated, and alpha brings the earlier
// accumulator to the new max.  Only a masked tile (kMasked) pays for the
// -1e30 mask.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float sl2, int n0, int row_lo,
                                             int t, int S, int causal) {
  // Four independent partial maxima and sums a row (j % 4): a 32-long
  // chain of dependent instructions a row would leave the SM waiting.
  float mx[2][4], psum[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      mx[i][k] = m[i];
      psum[i][k] = 0.f;
    }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMasked) {
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const int row = row_lo + 8 * (e >> 1);
        if (causal ? col > row : col >= S) s[4 * j + e] = kNegInf;
      }
      mx[e >> 1][j & 3] = fmaxf(mx[e >> 1][j & 3], s[4 * j + e]);
    }
  float neg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float r = fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3]));
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
    alpha[i] = ex2((m[i] - r) * sl2);
    m[i] = r;
    neg[i] = -r * sl2;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, neg[e >> 1]));
      psum[e >> 1][j & 3] += s[4 * j + e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] = l[i] * alpha[i] +
           ((psum[i][0] + psum[i][1]) + (psum[i][2] + psum[i][3]));
}

// softmax_tile for the kv tile at n0 and the q rows from m0, masked only
// where they need it: the ragged last tile and, when causal, the tile on
// the diagonal.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float sl2, const Params& p,
                                             int n0, int m0, int row_lo,
                                             int t) {
  if (n0 + kKvRows > p.S || (p.causal && n0 + kKvRows - 1 > m0))
    softmax_tile<true>(s, m, l, alpha, sl2, n0, row_lo, t, p.S, p.causal);
  else
    softmax_tile<false>(s, m, l, alpha, sl2, n0, row_lo, t, p.S, p.causal);
}

// K4: one block per (64-query tile, b*h), looping over 128-key tiles.
// Shared memory: Q (loaded once), then two stages of K and two of V, each
// D / 64 boxes, each stage with its own full barrier (K and V apart, so
// that S = Q K^T starts before V lands).  Thread 0 issues the loads of
// tile it + 2 into the stages of tile it once __syncthreads shows them
// free.  At head_dim 64 three blocks share an SM (at most 168 registers a
// thread, 73 KB of shared memory each).
template <int D>
__global__ void __launch_bounds__(kWgThreads, D == 64 ? 3 : 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tout, Params p) {
  constexpr int kBoxes = D / 64;
  constexpr int kTile = kBoxes * kBox;  // a kv tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);  // kBoxes boxes of kRowBox
  unsigned char* sK = sQ + kBoxes * kRowBox;  // [2][kTile]
  unsigned char* sV = sK + 2 * kTile;         // [2][kTile]
  __shared__ __align__(8) uint64_t q_full, k_full[2], v_full[2];

  const int n_tiles = (p.S + kWgRows - 1) / kWgRows;
  const int m_tile = p.causal ? n_tiles - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int m0 = m_tile * kWgRows;
  const int kv_end = p.causal ? min(p.S, m0 + kWgRows) : p.S;
  const int n_kv = (kv_end + kKvRows - 1) / kKvRows;
  const bool loader = threadIdx.x == 0;

  auto load = [&](const CUtensorMap* map, uint64_t* bar, unsigned char* dst,
                  int row0, int box) {
    sm90::mbar_arrive_expect_tx(bar, kBoxes * box);
    for (int x = 0; x < kBoxes; ++x)
      sm90::tma_load_4d(dst + x * box, map, bar, x * 64, h, row0, b);
  };
  auto load_kv = [&](int it) {
    const int st = it & 1;
    load(&tk, &k_full[st], sK + st * kTile, it * kKvRows, kBox);
    load(&tv, &v_full[st], sV + st * kTile, it * kKvRows, kBox);
  };
  if (loader) {
    sm90::mbar_init(&q_full, 1);
    for (int st = 0; st < 2; ++st) {
      sm90::mbar_init(&k_full[st], 1);
      sm90::mbar_init(&v_full[st], 1);
    }
    sm90::mbar_fence_init();
    load(&tq, &q_full, sQ, m0, kRowBox);
    for (int it = 0; it < min(n_kv, 2); ++it) load_kv(it);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int r = 16 * warp + (lane >> 2);  // rows r and r + 8 of the tile
  const int row_lo = m0 + r;
  const float sl2 = p.scale * kLog2e;

  float o[kBoxes][32];
#pragma unroll
  for (int x = 0; x < kBoxes; ++x)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[x][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums

  // Per kv tile: S = Q K^T, the online softmax, O += P V.  One block's
  // softmax overlaps the products of the other blocks on the SM.
  sm90::mbar_wait(&q_full, 0);
  for (int it = 0; it < n_kv; ++it) {
    const int st = it & 1;
    const uint32_t ph = (it >> 1) & 1;
    float s[64];
    sm90::mbar_wait(&k_full[st], ph);
    sm90::wgmma_fence();
    scores<D>(s, sQ, sK + st * kTile);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    float alpha[2];
    softmax_tile(s, m_run, l_run, alpha, sl2, p, it * kKvRows, m0, row_lo,
                 t);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[x][4 * j] *= alpha[0];
        o[x][4 * j + 1] *= alpha[0];
        o[x][4 * j + 2] *= alpha[1];
        o[x][4 * j + 3] *= alpha[1];
      }
    uint32_t pa[8][4];
    to_a_frags<8>(pa, s);  // P cast to bf16 (the TPU kernel's p.astype)
    sm90::mbar_wait(&v_full[st], ph);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) sm90::fence_regs(o[x]);
    sm90::wgmma_fence();
    pv<D>(o, pa, sV + st * kTile);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) sm90::fence_regs(o[x]);
    sm90::fence_regs(pa);
    __syncthreads();  // K and V of tile it are free
    if (loader && it + 2 < n_kv) load_kv(it + 2);
  }

  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = l_run[i];
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  // O through shared memory -- the Q tile, free after the last Q K^T,
  // written in the 128-byte swizzle -- and one TMA store a box, which
  // leaves the rows past S unwritten.
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int x = 0; x < kBoxes; ++x)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<__nv_bfloat162*>(
            sQ + x * kRowBox + (r + 8 * i) * 128 + ((j ^ (r & 7)) << 4) +
            4 * t) = __floats2bfloat162_rn(o[x][4 * j + 2 * i] * inv[i],
                                           o[x][4 * j + 2 * i + 1] * inv[i]);
  sm90::fence_proxy_async();
  __syncthreads();
  if (loader) {
    for (int x = 0; x < kBoxes; ++x)
      sm90::tma_store_4d(&tout, sQ + x * kRowBox, x * 64, h, m0, b);
    sm90::tma_store_drain();
  }
  if (t == 0) {
    float* lse = p.lse + (long long)bh * p.S;
    for (int i = 0; i < 2; ++i)
      if (row_lo + 8 * i < p.S)
        lse[row_lo + 8 * i] = m_run[i] * p.scale + logf(l[i]);
  }
}

// The product of a block's 64-row tile with a BQ-row tile, S^T-style:
// s = A B^T over D, both K-major in shared memory (issue only).
template <int D, int BQ>
__device__ __forceinline__ void rows_by_tile(float (&s)[BQ / 2],
                                             const unsigned char* a,
                                             const unsigned char* bt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk % 4) * 32;
    const uint64_t da = sm90::desc_sw128(a + (kk / 4) * kRowBox + off);
    const uint64_t db = sm90::desc_sw128(bt + (kk / 4) * BQ * 128 + off);
    if constexpr (BQ == 64)
      sm90::wgmma_ss_n64(s, da, db, kk > 0);
    else
      sm90::wgmma_ss_n32(s, da, db, kk > 0);
  }
}

// acc (+)= A T, A from registers (BQ / 16 fragments along the tile's rows),
// T a BQ-row tile read MN-major, one m64n64 block per 64 columns.
template <int D, int BQ>
__device__ __forceinline__ void frags_by_tile(float (&acc)[D / 64][32],
                                              const uint32_t (&a)[BQ / 16][4],
                                              const unsigned char* tile) {
#pragma unroll
  for (int kc = 0; kc < BQ / 16; ++kc)
#pragma unroll
    for (int x = 0; x < D / 64; ++x)
      sm90::wgmma_rs_n64_tb(
          acc[x], a[kc],
          sm90::desc_sw128(tile + x * (BQ * 128) + kc * 2048), 1);
}

// P^T = 2^(S^T scale log2(e) - lse log2(e)) for a warpgroup's 64 keys by
// BQ queries (one FFMA and one ex2 an element), zero where masked: queries
// past S and, when causal, keys after the query.
template <bool kMasked, int BQ>
__device__ __forceinline__ void probs_t(float (&s)[BQ / 2], const float* L,
                                        float sl2, int q0, int key_lo, int t,
                                        int S, int causal) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int qi = j * 8 + 2 * t;
    const float nl[2] = {-L[qi] * kLog2e, -L[qi + 1] * kLog2e};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pr = ex2(fmaf(s[4 * j + e], sl2, nl[e & 1]));
      if (kMasked) {
        const int qpos = q0 + qi + (e & 1);
        const int key = key_lo + 8 * (e >> 1);
        if (qpos >= S || (causal && key > qpos)) pr = 0.f;
      }
      s[4 * j + e] = pr;
    }
  }
}

// P = 2^(S scale log2(e) - lse log2(e)) for a warpgroup's 64 query rows by
// the 64 keys from n0 (one FFMA and one ex2 an element), zero where masked:
// keys past S and, when causal, keys after the query.  nl holds
// -lse log2(e) of the thread's two rows.
template <bool kMasked>
__device__ __forceinline__ void probs(float (&s)[32], const float (&nl)[2],
                                      float sl2, int n0, int row_lo, int t,
                                      int S, int causal) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pr = ex2(fmaf(s[4 * j + e], sl2, nl[e >> 1]));
      if (kMasked) {
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const int row = row_lo + 8 * (e >> 1);
        if (causal ? col > row : col >= S) pr = 0.f;
      }
      s[4 * j + e] = pr;
    }
}

// K5: one block per (64-query tile, b*h), looping over 64-key tiles.
// S = Q K^T and dP = dO V^T run on wgmma with both operands in shared
// memory (dP's product still running while P is formed), dS = P o (dP -
// delta) scale stays in registers, and dQ += dS K takes dS as A fragments
// and the same K tile read MN-major: K4's P V with K in V's place.  Before
// the key loop the block computes its rows' delta = rowsum(dO o O) - dlse
// from one more TMA tile (O), keeps it in registers and writes it to
// [B*H, S] for K6.  Shared memory: Q and dO (loaded once), then two stages
// of K and two of V, each stage with its own full barrier (K and V apart,
// so that S starts before V lands); O lands in V's second stage, whose
// tile-1 load waits until delta is in.  Thread 0 issues the loads of tile
// it + 2 into the stages of tile it once __syncthreads shows them free.
// At head_dim 64 four blocks share an SM (at most 128 registers a thread,
// 49 KB of shared memory each), one more than with O in a tile of its
// own, which on an H100 SXM was the faster of the two (PERF.md).
template <int D>
__global__ void __launch_bounds__(kWgThreads, D == 64 ? 4 : 1)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tout, Params p) {
  constexpr int kBoxes = D / 64;
  constexpr int kTile = kBoxes * kRowBox;  // 64 rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sDO = sQ + kTile;
  unsigned char* sK = sDO + kTile;     // [2][kTile]
  unsigned char* sV = sK + 2 * kTile;  // [2][kTile]
  unsigned char* sO = sV + kTile;      // V's second stage until delta is in
  __shared__ __align__(8) uint64_t q_full, k_full[2], v_full[2];

  const int n_tiles = (p.S + kWgRows - 1) / kWgRows;
  const int m_tile = p.causal ? n_tiles - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int m0 = m_tile * kWgRows;
  const int kv_end = p.causal ? min(p.S, m0 + kWgRows) : p.S;
  const int n_kv = (kv_end + kWgRows - 1) / kWgRows;
  const bool loader = threadIdx.x == 0;

  auto load = [&](const CUtensorMap* map, uint64_t* bar, unsigned char* dst,
                  int row0) {
    for (int x = 0; x < kBoxes; ++x)
      sm90::tma_load_4d(dst + x * kRowBox, map, bar, x * 64, h, row0, b);
  };
  auto load_k = [&](int it) {
    const int st = it & 1;
    sm90::mbar_arrive_expect_tx(&k_full[st], kTile);
    load(&tk, &k_full[st], sK + st * kTile, it * kWgRows);
  };
  auto load_v = [&](int it) {
    const int st = it & 1;
    sm90::mbar_arrive_expect_tx(&v_full[st], kTile);
    load(&tv, &v_full[st], sV + st * kTile, it * kWgRows);
  };
  if (loader) {
    sm90::mbar_init(&q_full, 1);
    for (int st = 0; st < 2; ++st) {
      sm90::mbar_init(&k_full[st], 1);
      sm90::mbar_init(&v_full[st], 1);
    }
    sm90::mbar_fence_init();
    sm90::mbar_arrive_expect_tx(&q_full, 3 * kTile);
    load(&tq, &q_full, sQ, m0);
    load(&tdo, &q_full, sDO, m0);
    load(&tout, &q_full, sO, m0);
    load_k(0);
    load_v(0);
    if (n_kv > 1) load_k(1);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int r = 16 * warp + (lane >> 2);  // rows r and r + 8 of the tile
  const int row_lo = m0 + r;
  const float sl2 = p.scale * kLog2e;
  const long long stat = (long long)bh * p.S;
  float nl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    nl[i] = row_lo + 8 * i < p.S ? -p.lse[stat + row_lo + 8 * i] * kLog2e
                                 : 0.f;

  // delta of rows r and r + 8: each thread takes the column pairs of its
  // accumulator fragments (8 j + 2 t, in the 128-byte swizzle), fp32
  // products of the bf16 values, then the row's four threads add up.
  // Rows past S are zeros in both tiles, so their delta is 0.
  sm90::mbar_wait(&q_full, 0);
  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < kBoxes; ++x)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int off = x * kRowBox + (r + 8 * i) * 128 +
                        ((j ^ (r & 7)) << 4) + 4 * t;
        const float2 g = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sDO + off));
        const float2 o = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sO + off));
        delta[i] = fmaf(g.y, o.y, fmaf(g.x, o.x, delta[i]));
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
    const int row = row_lo + 8 * i;
    if (row < p.S) {
      if (p.dlse != nullptr) delta[i] -= p.dlse[stat + row];
      if (t == 0) p.delta[stat + row] = delta[i];
    }
  }
  __syncthreads();  // O is read: its stage takes tile 1's V
  if (loader && n_kv > 1) load_v(1);

  float dq[kBoxes][32];
#pragma unroll
  for (int x = 0; x < kBoxes; ++x)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[x][e] = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int st = it & 1;
    const uint32_t ph = (it >> 1) & 1;
    const int n0 = it * kWgRows;
    const unsigned char* k_t = sK + st * kTile;
    float s[32], dp[32];
    sm90::mbar_wait(&k_full[st], ph);
    sm90::wgmma_fence();
    rows_by_tile<D, 64>(s, sQ, k_t);  // S = Q K^T
    sm90::wgmma_commit();
    sm90::mbar_wait(&v_full[st], ph);
    rows_by_tile<D, 64>(dp, sDO, sV + st * kTile);  // dP = dO V^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(s);
    if (n0 + kWgRows > p.S || (p.causal && n0 + kWgRows - 1 > m0))
      probs<true>(s, nl, sl2, n0, row_lo, t, p.S, p.causal);
    else
      probs<false>(s, nl, sl2, n0, row_lo, t, p.S, p.causal);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
    // dS = P o (dP - delta) * scale, rounded to bf16 (the TPU kernel's
    // ds.astype), then dQ += dS K.
#pragma unroll
    for (int e = 0; e < 32; ++e)
      dp[e] = s[e] * (dp[e] - delta[(e >> 1) & 1]) * p.scale;
    uint32_t da[4][4];
    to_a_frags<4>(da, dp);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) sm90::fence_regs(dq[x]);
    sm90::wgmma_fence();
    frags_by_tile<D, 64>(dq, da, k_t);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) sm90::fence_regs(dq[x]);
    sm90::fence_regs(da);
    __syncthreads();  // K and V of tile it are free
    if (loader && it + 2 < n_kv) {
      load_k(it + 2);
      load_v(it + 2);
    }
  }

  const long long o_ss = (long long)p.H * D;
  store_wg_rows<D>(p.dq + (long long)b * p.S * o_ss + (long long)h * D, o_ss,
                   dq, row_lo, p.S, lane);
}

// K6: one block per (64-key tile, b*h), looping over BQ-query tiles.
// The products are taken transposed (S^T = K Q^T, dP^T = V dO^T), so the
// accumulator fragments of P^T and dS^T are the A fragments of dV += P^T dO
// and dK += dS^T Q, whose B is the same Q or dO tile read MN-major: each
// tile is loaded once and read both ways.  Shared memory: K and V (loaded
// once), then two stages of (Q, dO) with one full barrier each, and two
// stages of the tile's lse and delta, copied by cp.async.  Thread 0 issues
// the TMA loads and all threads the statistics' copies of tile it + 2 once
// __syncthreads shows that tile it is done.  At head_dim 64 three blocks
// share an SM (at most 168 registers a thread, 49 KB of shared memory).
template <int D, int BQ>
__global__ void __launch_bounds__(kWgThreads, D == 64 ? 3 : 1)
    bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, Params p) {
  constexpr int kBoxes = D / 64;
  constexpr int kKV = kBoxes * kRowBox;  // the key tile
  constexpr int kQBox = BQ * 128;        // a BQ-row box
  constexpr int kQT = kBoxes * kQBox;    // a BQ-row tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + kKV;
  unsigned char* sQ = sV + kKV;                 // [2][kQT]
  unsigned char* sDO = sQ + 2 * kQT;            // [2][kQT]
  float* sL = reinterpret_cast<float*>(sDO + 2 * kQT);  // [2][BQ]
  float* sDelta = sL + 2 * BQ;                          // [2][BQ]
  __shared__ __align__(8) uint64_t kv_full, full[2];

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int n0 = blockIdx.x * kWgRows;
  const int m_begin = p.causal ? n0 : 0;  // earlier queries see none of these keys
  const int n_q = (p.S - m_begin + BQ - 1) / BQ;
  const bool loader = threadIdx.x == 0;

  // Q and dO of tile it into stage it & 1 (thread 0), and its lse and delta
  // (threads 0 .. 2 BQ - 1; zeros past S).
  auto load_q_tile = [&](int it) {
    const int st = it & 1, q0 = m_begin + it * BQ;
    if (loader) {
      sm90::mbar_arrive_expect_tx(&full[st], 2 * kQT);
      for (int x = 0; x < kBoxes; ++x) {
        sm90::tma_load_4d(sQ + st * kQT + x * kQBox, &tq, &full[st], x * 64,
                          h, q0, b);
        sm90::tma_load_4d(sDO + st * kQT + x * kQBox, &tdo, &full[st],
                          x * 64, h, q0, b);
      }
    }
    const int r = threadIdx.x % BQ;
    if (threadIdx.x < 2 * BQ) {
      const bool in = q0 + r < p.S;
      const long long at = (long long)bh * p.S + (in ? q0 + r : 0);
      if (threadIdx.x < BQ)
        sm90::cp_async_4(sL + st * BQ + r, p.lse + at, in);
      else
        sm90::cp_async_4(sDelta + st * BQ + r, p.delta + at, in);
    }
  };
  if (loader) {
    sm90::mbar_init(&kv_full, 1);
    sm90::mbar_init(&full[0], 1);
    sm90::mbar_init(&full[1], 1);
    sm90::mbar_fence_init();
    sm90::mbar_arrive_expect_tx(&kv_full, 2 * kKV);
    for (int x = 0; x < kBoxes; ++x) {
      sm90::tma_load_4d(sK + x * kRowBox, &tk, &kv_full, x * 64, h, n0, b);
      sm90::tma_load_4d(sV + x * kRowBox, &tv, &kv_full, x * 64, h, n0, b);
    }
  }
  __syncthreads();  // the barriers are set up
  for (int it = 0; it < min(n_q, 2); ++it) load_q_tile(it);
  sm90::cp_async_wait_all();
  __syncthreads();  // the first statistics are in

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int key_lo = n0 + 16 * warp + (lane >> 2);  // and key_lo + 8
  const float sl2 = p.scale * kLog2e;

  float dk[kBoxes][32], dv[kBoxes][32];
#pragma unroll
  for (int x = 0; x < kBoxes; ++x)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[x][e] = dv[x][e] = 0.f;

  sm90::mbar_wait(&kv_full, 0);
  for (int it = 0; it < n_q; ++it) {
    const int st = it & 1;
    const int q0 = m_begin + it * BQ;
    const unsigned char* q_t = sQ + st * kQT;
    const unsigned char* do_t = sDO + st * kQT;
    const float* L = sL + st * BQ;
    const float* Dl = sDelta + st * BQ;
    sm90::mbar_wait(&full[st], (it >> 1) & 1);

    // S^T = K Q^T; P^T = exp(S^T * scale - lse), only tiles on the
    // diagonal or past S paying for the mask.
    float s[BQ / 2], dp[BQ / 2];
    sm90::wgmma_fence();
    rows_by_tile<D, BQ>(s, sK, q_t);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    if (q0 + BQ > p.S || (p.causal && q0 < n0 + kWgRows))
      probs_t<true, BQ>(s, L, sl2, q0, key_lo, t, p.S, p.causal);
    else
      probs_t<false, BQ>(s, L, sl2, q0, key_lo, t, p.S, p.causal);
    // dV += P^T dO (P^T rounded to bf16, as the TPU kernel casts p), and
    // dP^T = V dO^T.  Waiting for both before dS^T keeps P^T's fragments
    // and dS^T's apart: fewer registers, and more blocks on an SM.
    uint32_t pa[BQ / 16][4];
    to_a_frags<BQ / 16>(pa, s);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) sm90::fence_regs(dv[x]);
    sm90::wgmma_fence();
    frags_by_tile<D, BQ>(dv, pa, do_t);
    rows_by_tile<D, BQ>(dp, sV, do_t);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) sm90::fence_regs(dv[x]);
    sm90::fence_regs(dp);
    sm90::fence_regs(pa);

    // dS^T = P^T o (dP^T - delta) * scale; dK += dS^T Q.
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - Dl[qi]) * p.scale;
      }
    uint32_t da[BQ / 16][4];
    to_a_frags<BQ / 16>(da, dp);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) sm90::fence_regs(dk[x]);
    sm90::wgmma_fence();
    frags_by_tile<D, BQ>(dk, da, q_t);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) sm90::fence_regs(dk[x]);
    sm90::fence_regs(da);
    sm90::cp_async_wait_all();  // tile it + 1's statistics
    __syncthreads();            // tile it is done; tile it + 1's stats seen
    if (it + 2 < n_q) load_q_tile(it + 2);
  }

  const long long o_ss = (long long)p.H * D;
  const long long off = (long long)b * p.S * o_ss + (long long)h * D;
  store_wg_rows<D>(p.dk + off, o_ss, dk, key_lo, p.S, lane);
  store_wg_rows<D>(p.dv + off, o_ss, dv, key_lo, p.S, lane);
}

// The block's K6 query tile: 64 rows at head_dim 64; 32 at head_dim 128,
// where dK and dV take 128 fp32 registers a thread and a 64-row tile's
// score and dP accumulators would not fit beside them without spilling.
template <int D>
constexpr int dkv_rows() { return D == 64 ? 64 : 32; }

template <int D>
constexpr size_t fwd_smem() { return 1024 + (D / 64) * (kRowBox + 4 * kBox); }

template <int D>
constexpr size_t dkv_smem() {
  return 1024 + (D / 64) * (2 * kRowBox + 4 * dkv_rows<D>() * 128) +
         4 * dkv_rows<D>() * sizeof(float);
}

template <int D>
constexpr size_t dq_smem() { return 1024 + 6 * (D / 64) * kRowBox; }

// Launches `kernel` on a (64-row tile, b*h) grid, one warpgroup a block,
// with `smem` bytes of dynamic shared memory, passing it `maps` and `p`.
template <typename... KernelArgs, typename... Maps>
int launch(void (*kernel)(KernelArgs...), const Params& p, size_t smem,
           void* stream, const Maps&... maps) {
  if (p.B * p.H > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n = (p.S + kWgRows - 1) / kWgRows;
  kernel<<<dim3(n, p.B * p.H), kWgThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(maps..., p);
  return (int)cudaGetLastError();
}

// The tensor map of one input, `rows` sequence positions a box.
bool map_of(CUtensorMap* map, const bf16* x, long long sb, long long ss,
            long long sh, const Params& p, int D, int rows) {
  return p.S > 0 && sm90::bshd_map(map, x, p.B, p.S, p.H, D, sb, ss, sh, rows);
}

template <int D>
int launch_fwd(const Params& p, void* stream) {
  CUtensorMap tq, tk, tv, tout;
  const long long o_ss = (long long)p.H * D;  // out is contiguous
  if (!map_of(&tq, p.q, p.q_sb, p.q_ss, p.q_sh, p, D, kWgRows) ||
      !map_of(&tk, p.k, p.k_sb, p.k_ss, p.k_sh, p, D, kKvRows) ||
      !map_of(&tv, p.v, p.v_sb, p.v_ss, p.v_sh, p, D, kKvRows) ||
      !map_of(&tout, p.out, p.S * o_ss, o_ss, D, p, D, kWgRows))
    return (int)cudaErrorInvalidValue;
  return launch(fwd_kernel<D>, p, fwd_smem<D>(), stream, tq, tk, tv, tout);
}

template <int D>
int launch_dq(const Params& p, void* stream) {
  CUtensorMap tq, tk, tv, tdo, tout;
  if (!map_of(&tq, p.q, p.q_sb, p.q_ss, p.q_sh, p, D, kWgRows) ||
      !map_of(&tk, p.k, p.k_sb, p.k_ss, p.k_sh, p, D, kWgRows) ||
      !map_of(&tv, p.v, p.v_sb, p.v_ss, p.v_sh, p, D, kWgRows) ||
      !map_of(&tdo, p.dout, p.do_sb, p.do_ss, p.do_sh, p, D, kWgRows) ||
      !map_of(&tout, p.out, p.o_sb, p.o_ss, p.o_sh, p, D, kWgRows))
    return (int)cudaErrorInvalidValue;
  return launch(bwd_dq_kernel<D>, p, dq_smem<D>(), stream, tq, tk, tv, tdo,
                tout);
}

template <int D>
int launch_dkv(const Params& p, void* stream) {
  constexpr int BQ = dkv_rows<D>();
  CUtensorMap tq, tk, tv, tdo;
  if (!map_of(&tq, p.q, p.q_sb, p.q_ss, p.q_sh, p, D, BQ) ||
      !map_of(&tk, p.k, p.k_sb, p.k_ss, p.k_sh, p, D, kWgRows) ||
      !map_of(&tv, p.v, p.v_sb, p.v_ss, p.v_sh, p, D, kWgRows) ||
      !map_of(&tdo, p.dout, p.do_sb, p.do_ss, p.do_sh, p, D, BQ))
    return (int)cudaErrorInvalidValue;
  return launch(bwd_dkv_kernel<D, BQ>, p, dkv_smem<D>(), stream, tq, tk, tv,
                tdo);
}

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
  p.o_sb = strides[12]; p.o_ss = strides[13]; p.o_sh = strides[14];
  p.B = B; p.H = H; p.S = S;
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

// strides: 15 int64, (batch, seq, head) element strides of q, k, v, dout
// and out (dout's are read by the backward only, out's by K5 only).
// Outputs are contiguous [B, S, H, D]; lse, dlse and delta are [B*H, S].
// A layout the driver refuses to map for TMA returns cudaErrorInvalidValue.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const long long* strides,
                             int B, int H, int S, int D, float scale,
                             int causal, void* stream) {
  Params p = make_params(q, k, v, strides, B, H, S, scale, causal);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  if (D == 64) return launch_fwd<64>(p, stream);
  if (D == 128) return launch_fwd<128>(p, stream);
  return (int)cudaErrorInvalidValue;
}

// K5: dq, and delta = rowsum(dout o out) - dlse (dlse may be null) into
// `delta` for K6.
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* out,
                                const void* lse, const void* dlse,
                                void* delta, void* dq,
                                const long long* strides, int B, int H, int S,
                                int D, float scale, int causal, void* stream) {
  Params p = make_params(q, k, v, strides, B, H, S, scale, causal);
  p.dout = static_cast<const bf16*>(dout);
  p.out = const_cast<bf16*>(static_cast<const bf16*>(out));
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.dlse = static_cast<const float*>(dlse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  if (D == 64) return launch_dq<64>(p, stream);
  if (D == 128) return launch_dq<128>(p, stream);
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
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  if (D == 64) return launch_dkv<64>(p, stream);
  if (D == 128) return launch_dkv<128>(p, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
