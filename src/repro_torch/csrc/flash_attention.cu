// Flash attention (GQA, causal or not, sliding window) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (`flash_attention`,
// body `_kernel`).
//
// What bounds it on the H100. At the main path's shape (B 4, H 32, K 8,
// S 512, d 128, causal, bf16) the live work is 4 B H d S (S + 1) / 2 =
// 8.6 GFLOP, 8.7 us at 989 TFLOP/s. The bytes are q, k, v and the output,
// 2 (2 B H + 2 B K) S d = 41.9 MB, 12.5 us at 3.35 TB/s. That is 205
// operations per byte, below the card's 295, so the bound is the bytes
// (chip_smoke.py computes the same). The design therefore keeps the
// (S, S) scores out of device memory, as on the TPU; each q tile re-reads
// its K/V tiles, mostly from L2.
//
// Design. One block per (q tile, head, batch); the TPU grid's innermost KV
// axis becomes a loop inside the block over KV tiles, and it stops at the
// causal edge and skips tiles wholly outside the window (the TPU kernel's
// dead-tile skip). q head h reads kv head h / (H / K). The online softmax
// keeps m, l and the output accumulator in f32; probabilities are rounded
// to the input dtype before the PV product, as the TPU kernel does. Masked scores take the finite
// NEG_INF = -1e30, never -inf, so a row that a live tile masks wholly stays
// finite and the next tile's alpha = 0 wipes it. Ragged S is masked in the
// kernel (keys >= S are dead, query rows >= S are not written) in place of
// the TPU kernel's pad-and-slice. l is clamped at 1e-30 in the final divide.
//
// Three bodies, chosen by kernels/flash_attention/flash_attention.py::plan
// from the dtype, d and alignment. In both bf16 bodies each warp owns 16
// of the block's 64 query rows and the online softmax lives in registers:
// the product's accumulator layout is fixed (a lane holds rows lane / 4
// and lane / 4 + 8), so the row max and sum are two quad shuffles, the
// alpha rescale happens in registers, P is converted to bf16 in registers
// and used directly as PV's A operand, and the output accumulator leaves
// registers only at the end; scores are kept in the log2 domain (exp2f).
//   `fa3::flash_kernel_wg` (bf16, d 64 and 128, 16-byte-aligned bases):
//     the block is one warpgroup; QK^T and PV run on wgmma (Q and K from
//     128-byte-swizzled shared memory, P from registers, V MN-major); Q
//     and the K/V tiles come by TMA (3-D maps, so a tile past S is zero
//     within its head), tile j + 1 in flight on an mbarrier while tile j's
//     math runs, one barrier per tile.
//   `fa2::flash_kernel_mma` (other bf16: d 16, 32 and 256, the rank-space
//     prefill's padded widths, or unaligned bases) follows
//     FlashAttention-2: Q loaded once into registers with ldmatrix; K and
//     V through a two-stage cp.async ring, one barrier per tile; QK^T and
//     PV on mma.sync.m16n8k16, V through ldmatrix.trans. At d 256 (gemma3's
//     head dim) the 64 x 256 output accumulator alone takes 128 registers
//     a thread, so Q's fragments are not held: each k16 step of QK^T
//     reads its fragment from the q tile in shared memory (ldmatrix), and
//     the tile and the two K/V stages take 165 KB of the 227 KB a block
//     may have.
//   `flash_kernel` (f32) runs both products on FMA from shared memory so
//     that it stays exact f32 (tensor-core f32 input is TF32); at d 256
//     its q, K and V tiles and the score tile take 210 KB.
//
// Known limits, for later work: the wg body waits out each product before
// the softmax (no ping-pong of two warpgroups or intra-warpgroup
// overlap, FlashAttention-3's schedule), and each q tile re-reads its K/V
// tiles from L2 (the 4 heads of a GQA group share them there).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per KV tile
constexpr int THREADS = 128;  // rows ty + 8 i, columns tx + 16 j
constexpr int SP = BKV + 1;   // padded row of the score tile
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)(BQ + 2 * BKV) * (D + 1) + (size_t)BQ * SP + 3 * BQ;
}

// q (B, H, S, D), k/v (B, K, S, D), o (B, H, S, D), all contiguous.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int K, int S,
             float scale, int causal, int window) {
  constexpr int DP = D + 1;     // padded feature row (no bank conflicts)
  constexpr int DC = D / 16;    // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // BQ x DP
  float* k_s = q_s + BQ * DP;        // BKV x DP
  float* v_s = k_s + BKV * DP;       // BKV x DP
  float* s_s = v_s + BKV * DP;       // BQ x SP scores, then probabilities
  float* m_s = s_s + BQ * SP;        // running max
  float* l_s = m_s + BQ;             // running sum
  float* a_s = l_s + BQ;             // this tile's rescale factor

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const T* qb = q + ((long)b * H + h) * S * D;
  const T* kb = k + ((long)b * K + kh) * S * D;
  const T* vb = v + ((long)b * K + kh) * S * D;
  T* ob = o + ((long)b * H + h) * S * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int i = e / D, c = e % D;
    q_s[i * DP + c] = (q0 + i < S) ? to_f(qb[(long)(q0 + i) * D + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[8][DC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int nk = (S + BKV - 1) / BKV;
  const int j_hi = causal ? min(nk - 1, (q0 + BQ - 1) / BKV) : nk - 1;
  for (int j = 0; j <= j_hi; ++j) {
    const int k0 = j * BKV;
    if (window > 0 && k0 + BKV - 1 <= q0 - window) continue;  // dead tile
    __syncthreads();   // previous tile's readers are done with k_s / v_s / s_s
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int t = e / D, c = e % D;
      const bool ok = k0 + t < S;
      k_s[t * DP + c] = ok ? to_f(kb[(long)(k0 + t) * D + c]) : 0.f;
      v_s[t * DP + c] = ok ? to_f(vb[(long)(k0 + t) * D + c]) : 0.f;
    }
    __syncthreads();

    // scores, masked to NEG_INF
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[8], kc[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qr[i] = q_s[(ty + 8 * i) * DP + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kc[jj] = k_s[(tx + 16 * jj) * DP + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qr[i], kc[jj], s[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i, qi = q0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj, kj = k0 + c;
        bool ok = kj < S;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        s_s[r * SP + c] = ok ? s[i][jj] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one thread per query row
    if (tid < BQ) {
      float* row = s_s + tid * SP;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int c = 0; c < BKV; ++c) m_new = fmaxf(m_new, row[c]);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int c = 0; c < BKV; ++c) {
        const float p = expf(row[c] - m_new);
        sum += p;
        row[c] = to_f(from_f<T>(p));   // PV uses p in the input dtype
      }
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P @ V
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float al = a_s[ty + 8 * i];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= al;
    }
#pragma unroll 4
    for (int t = 0; t < BKV; ++t) {
      float pr[8], vc[DC];
#pragma unroll
      for (int i = 0; i < 8; ++i) pr[i] = s_s[(ty + 8 * i) * SP + t];
#pragma unroll
      for (int c = 0; c < DC; ++c) vc[c] = v_s[t * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pr[i], vc[c], acc[i][c]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    if (q0 + r >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[(long)(q0 + r) * D + tx + 16 * c] = from_f<T>(acc[i][c] / l);
  }
}

// ===========================================================================
// The bf16 body: FlashAttention-2 on mma.sync m16n8k16.
// ===========================================================================
namespace fa2 {

using namespace hopper;

constexpr int WARPS = 4;            // each owns 16 query rows
constexpr int ROWS = 16 * WARPS;    // query rows per block
constexpr int KEYS = 64;            // keys per KV tile
constexpr int NT = 32 * WARPS;      // threads per block

// Shared memory (dynamic), per block, in bf16 rows of LD = D + 8 elements
// (the 16-byte pad puts the 8 rows an ldmatrix reads in 8 distinct banks):
//   q_s               ROWS x LD   query rows (later the output staging)
//   ring[2] = (k, v)  KEYS x LD   two stages of the K/V tile ring
template <int D>
struct Layout {
  static constexpr int LD = D + 8;
  static constexpr int KV = KEYS * LD;   // elements of one K or V tile
  static constexpr size_t BYTES =
      sizeof(__nv_bfloat16) * (ROWS * LD + 4 * KV);
};

// dst (N x LD) = rows row0 .. row0 + N - 1 of src (S x D), zero past S:
// cp.async 16 bytes at a time (zero-filled past S), or plain copies when a
// base pointer is not 16-byte aligned.
template <int D, int N>
__device__ __forceinline__ void load_tile(__nv_bfloat16* __restrict__ dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int row0, int S, bool vec) {
  constexpr int LD = D + 8, VPR = D / 8;
  for (int u = threadIdx.x; u < N * VPR; u += NT) {
    const int i = u / VPR, c = (u % VPR) * 8;
    const bool ok = row0 + i < S;
    __nv_bfloat16* d = dst + i * LD + c;
    const __nv_bfloat16* g = src + (long)(ok ? row0 + i : 0) * D + c;
    if (vec) {
      cp_async_16(d, g, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = ok ? g[e] : __float2bfloat16(0.f);
    }
  }
}

// Each warp owns 16 query rows. Per KV tile: one barrier; the
// next tile's cp.async copies are issued before this tile's math; scores,
// softmax statistics, P (as the PV product's A operand) and the output
// accumulator stay in registers. Lane l holds rows l / 4 and l / 4 + 8 of
// its warp's 16 and, of every 8-column block, columns 2 (l % 4) and + 1.
template <int D>
__global__ void __launch_bounds__(NT)
flash_kernel_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int H, int K, int S,
                 float scale, int causal, int window) {
  using L = Layout<D>;
  constexpr int LD = L::LD, DK = D / 16, DN = D / 8, NB = KEYS / 8;
  constexpr bool QREG = D <= 128;     // Q's fragments held in registers
  extern __shared__ __align__(128) unsigned char smem_mma[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* ring = q_s + ROWS * LD;   // stage st: k, then v

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // the longest causal rows start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS, h = blockIdx.y,
            b = blockIdx.z;
  const int kh = h / (H / K);
  const __nv_bfloat16* qb = q + ((long)b * H + h) * S * D;
  const __nv_bfloat16* kb = k + ((long)b * K + kh) * S * D;
  const __nv_bfloat16* vb = v + ((long)b * K + kh) * S * D;
  __nv_bfloat16* ob = o + ((long)b * H + h) * S * D;
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % 16) == 0;

  // live KV tiles j_lo .. j_hi: stop at the causal edge, skip the tiles
  // wholly outside the window (a prefix);
  // kernels/flash_attention/flash_attention.py::kv_tiles mirrors this.
  const int nk = (S + KEYS - 1) / KEYS;
  const int j_hi = causal ? min(nk - 1, (q0 + ROWS - 1) / KEYS) : nk - 1;
  int j_lo = 0;
  if (window > 0)
    while (j_lo <= j_hi && j_lo * KEYS + KEYS - 1 <= q0 - window) ++j_lo;

  if (j_lo <= j_hi) {
    load_tile<D, ROWS>(q_s, qb, q0, S, vec);
    load_tile<D, KEYS>(ring, kb, j_lo * KEYS, S, vec);
    load_tile<D, KEYS>(ring + L::KV, vb, j_lo * KEYS, S, vec);
  }
  cp_async_commit();

  uint32_t qf[QREG ? DK : 1][4];
  float acc[DN][4];
#pragma unroll
  for (int c = 0; c < DN; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const int qi0 = q0 + warp * 16 + g;    // this lane's rows: qi0, qi0 + 8
  const float scale2 = scale * 1.4426950408889634f;   // scale * log2(e)

  for (int j = j_lo, st = 0; j <= j_hi; ++j, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();   // tile j is in; every warp is done with tile j - 1
    const __nv_bfloat16* q_w =
        q_s + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;
    if constexpr (QREG) {
      if (j == j_lo) {
#pragma unroll
        for (int kd = 0; kd < DK; ++kd) ldmatrix_x4(qf[kd], q_w + kd * 16);
      }
    }
    if (j < j_hi) {    // tile j + 1 into the other stage, in flight below
      __nv_bfloat16* nxt = ring + 2 * (st ^ 1) * L::KV;
      load_tile<D, KEYS>(nxt, kb, (j + 1) * KEYS, S, vec);
      load_tile<D, KEYS>(nxt + L::KV, vb, (j + 1) * KEYS, S, vec);
    }
    cp_async_commit();
    const __nv_bfloat16* k_t = ring + 2 * st * L::KV;
    const __nv_bfloat16* v_t = k_t + L::KV;

    // scores: this warp's 16 x KEYS
    float s[NB][4];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DK; ++kd) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kd][e];
      } else {
        ldmatrix_x4(qa, q_w + kd * 16);
      }
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_t + (n2 * 16 + (lane / 16) * 8 + (lane % 8)) * LD +
                            kd * 16 + ((lane / 8) % 2) * 8);
        mma_m16n8k16_bf16(s[2 * n2], qa, bk[0], bk[1]);
        mma_m16n8k16_bf16(s[2 * n2 + 1], qa, bk[2], bk[3]);
      }
    }

    // scale and mask to NEG_INF; online softmax in registers. Scores and
    // m are kept in the log2 domain (log2 e folded into the scale, exp2f
    // for expf: FlashAttention's form, which moves p only in the last bits
    // of f32, far below its rounding to bf16). A tile whose every
    // (row, key) pair is live (inside S, the causal edge and the window)
    // skips the mask.
    const int k0 = j * KEYS;
    const bool live = k0 + KEYS <= S && (!causal || k0 + KEYS - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + ROWS - 1 - window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[c][e] * scale2;
        if (!live) {
          const int qi = qi0 + 8 * (e / 2), kj = k0 + c * 8 + 2 * t4 + (e % 2);
          bool ok = kj < S;
          if (causal) ok = ok && kj <= qi;
          if (window > 0) ok = ok && kj > qi - window;
          x = ok ? x : NEG_INF;
        }
        s[c][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    // p in f32 for the row sums; rounded to bf16 as PV's A operand
    uint32_t pa[KEYS / 16][4];
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[c][e] - m_r[e / 2]);
        sum[e / 2] += p[e];
      }
      pa[c / 2][(c % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[c / 2][(c % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = l_r[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int c = 0; c < DN; ++c) {
      acc[c][0] *= alpha[0];
      acc[c][1] *= alpha[0];
      acc[c][2] *= alpha[1];
      acc[c][3] *= alpha[1];
    }

    // this warp's 16 x D output += P (16 x KEYS) @ V (KEYS x D)
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
#pragma unroll
      for (int d2 = 0; d2 < DN / 2; ++d2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_t + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                                  d2 * 16 + (lane / 16) * 8);
        mma_m16n8k16_bf16(acc[2 * d2], pa[kk], bv[0], bv[1]);
        mma_m16n8k16_bf16(acc[2 * d2 + 1], pa[kk], bv[2], bv[3]);
      }
    }
  }

  // out = acc / max(l, 1e-30), staged through this warp's own q_s rows
  // (only this warp read them) for 16-byte stores
  __nv_bfloat16* o_s = q_s + warp * 16 * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = fmaxf(l_r[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DN; ++c)
      *reinterpret_cast<uint32_t*>(o_s + (g + 8 * r) * LD + c * 8 + 2 * t4) =
          pack_bf16(acc[c][2 * r] / l, acc[c][2 * r + 1] / l);
  }
  __syncwarp();
  for (int u = lane; u < 16 * DN; u += 32) {
    const int i = u / DN, c = (u % DN) * 8, qi = q0 + warp * 16 + i;
    if (qi < S)
      *reinterpret_cast<uint4*>(ob + (long)qi * D + c) =
          *reinterpret_cast<const uint4*>(o_s + i * LD + c);
  }
}

}  // namespace fa2

// Raise a kernel's dynamic shared-memory limit once per device.
template <typename F>
int smem_limit_once(F* kernel, size_t bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && (done >> dev) & 1u) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32) done |= 1u << dev;
  return 0;
}


// ===========================================================================
// The bf16 body for d 64 and 128: both products on wgmma, fed by TMA.
// ===========================================================================
namespace fa3 {

using namespace hopper;

constexpr int ROWS = 64;           // query rows per block: one warpgroup
constexpr int KEYS = 64;           // keys per KV tile
constexpr int NT = 128;
constexpr int BOX = 64 * 64 * 2;   // one 64-row x 64-column TMA box, 8 KB

// Shared memory (dynamic), 1 KB aligned for the 128-byte swizzle: the q
// tile, two stages of (k, v) tiles, each D / 64 boxes of 64 rows x 128 B,
// then the mbarriers (two stages, q).
template <int D>
struct Layout {
  static constexpr int NB = D / 64;
  static constexpr int TILE = NB * BOX;
  static constexpr size_t BYTES = 1024 + 5 * TILE + 3 * 8;
};

// Issue the TMA loads of K/V tile j of head kz into stage st.
template <int D>
__device__ __forceinline__ void load_kv(unsigned char* kv_s, uint64_t* full,
                                        const CUtensorMap* map_k,
                                        const CUtensorMap* map_v, int j,
                                        int st, int kz) {
  using L = Layout<D>;
  unsigned char* k_t = kv_s + 2 * st * L::TILE;
  mbar_arrive_expect_tx(&full[st], 2 * L::TILE);
#pragma unroll
  for (int bx = 0; bx < L::NB; ++bx) {
    tma_load_3d(k_t + bx * BOX, map_k, bx * 64, j * KEYS, kz, &full[st]);
    tma_load_3d(k_t + L::TILE + bx * BOX, map_v, bx * 64, j * KEYS, kz,
                &full[st]);
  }
}

// One warpgroup owns 64 query rows; each warp's 16 of them sit in the
// wgmma accumulators exactly as in mma.sync's layout (lane l: rows l / 4
// and l / 4 + 8, columns 2 (l % 4) and + 1 of every 8-column block), so
// the online softmax is the mma body's. S = Q K^T reads Q and K from
// shared memory (K-major, m64n64k16); O += P V takes P from registers as
// the A operand and V from shared memory (MN-major, m64nDk16). One thread
// keeps the next K/V tile's TMA loads in flight on an mbarrier; one block
// barrier per tile hands the old stage back.
template <int D>
__global__ void __launch_bounds__(NT)
flash_kernel_wg(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                __nv_bfloat16* __restrict__ o, int H, int K, int S,
                float scale, int causal, int window) {
  using L = Layout<D>;
  constexpr int NB = L::NB, DK = D / 16, DN = D / 8;
  extern __shared__ unsigned char smem_wg[];
  unsigned char* q_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_wg) + 1023) & ~uintptr_t(1023));
  unsigned char* kv_s = q_s + L::TILE;   // stage st: k, then v
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + 4 * L::TILE);
  uint64_t* q_full = full + 2;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  // the longest causal rows start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS, h = blockIdx.y,
            b = blockIdx.z;
  const int qz = b * H + h, kz = b * K + h / (H / K);   // heads in the maps

  // live KV tiles j_lo .. j_hi, as in the mma body
  const int nk = (S + KEYS - 1) / KEYS;
  const int j_hi = causal ? min(nk - 1, (q0 + ROWS - 1) / KEYS) : nk - 1;
  int j_lo = 0;
  if (window > 0)
    while (j_lo <= j_hi && j_lo * KEYS + KEYS - 1 <= q0 - window) ++j_lo;

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && j_lo <= j_hi) {
    mbar_arrive_expect_tx(q_full, L::TILE);
#pragma unroll
    for (int bx = 0; bx < NB; ++bx)
      tma_load_3d(q_s + bx * BOX, &map_q, bx * 64, q0, qz, q_full);
    load_kv<D>(kv_s, full, &map_k, &map_v, j_lo, 0, kz);
  }

  float acc[4 * DN];
#pragma unroll
  for (int i = 0; i < 4 * DN; ++i) acc[i] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const int qi0 = q0 + warp * 16 + g;    // this lane's rows: qi0, qi0 + 8
  const float scale2 = scale * 1.4426950408889634f;   // scale * log2(e)
  uint32_t parity = 0;   // bit st: the parity of stage st's next phase
  if (j_lo <= j_hi) mbar_wait(q_full, 0);

  for (int j = j_lo, st = 0; j <= j_hi; ++j, st ^= 1) {
    __syncthreads();   // every warp is done with tile j - 1's stage
    if (tid == 0 && j < j_hi)
      load_kv<D>(kv_s, full, &map_k, &map_v, j + 1, st ^ 1, kz);
    mbar_wait(&full[st], (parity >> st) & 1u);
    parity ^= 1u << st;
    const unsigned char* k_t = kv_s + 2 * st * L::TILE;
    const unsigned char* v_t = k_t + L::TILE;

    // scores: this warpgroup's 64 x 64; a k16 step is 32 bytes along the
    // swizzled rows of a box, four steps a box
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DK; ++kd)
      wgmma_m64n64k16_bf16_ss(
          s, wgmma_desc(q_s + (kd / 4) * BOX + (kd % 4) * 32, 16, 1024),
          wgmma_desc(k_t + (kd / 4) * BOX + (kd % 4) * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scale and mask to NEG_INF, online softmax: as in the mma body
    const int k0 = j * KEYS;
    const bool live = k0 + KEYS <= S && (!causal || k0 + KEYS - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + ROWS - 1 - window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale2;
      if (!live) {
        const int qi = qi0 + 8 * ((i % 4) / 2);
        const int kj = k0 + (i / 4) * 8 + 2 * t4 + (i % 2);
        bool ok = kj < S;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        x = ok ? x : NEG_INF;
      }
      s[i] = x;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    // p in f32 for the row sums; rounded to bf16 as PV's A operand: the
    // accumulators of key blocks 2kk and 2kk + 1 are the A fragment of
    // k16 step kk
    uint32_t pa[KEYS / 16][4];
#pragma unroll
    for (int c = 0; c < KEYS / 8; ++c) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[4 * c + e] - m_r[e / 2]);
        sum[e / 2] += p[e];
      }
      pa[c / 2][(c % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[c / 2][(c % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = l_r[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int i = 0; i < 4 * DN; ++i) acc[i] *= alpha[(i % 4) / 2];

    // O += P (64 x 64) @ V (64 x D); V is MN-major, its 64-column boxes
    // BOX apart, a k16 step 16 rows down
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      const uint64_t dv = wgmma_desc(v_t + kk * 16 * 128, BOX, 1024);
      if constexpr (D == 128)
        wgmma_m64n128k16_bf16_rs_tn(acc, pa[kk], dv);
      else
        wgmma_m64n64k16_bf16_rs_tn(acc, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // out = acc / max(l, 1e-30): into q_s in its swizzled layout (every
  // product has read it), then 16-byte rows to device memory
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = fmaxf(l_r[r], 1e-30f);
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int c = 0; c < DN; ++c)
      *reinterpret_cast<uint32_t*>(q_s + (c / 8) * BOX + row * 128 +
                                   (((c % 8) ^ (row % 8)) << 4) + t4 * 4) =
          pack_bf16(acc[4 * c + 2 * r] / l, acc[4 * c + 2 * r + 1] / l);
  }
  __syncthreads();
  __nv_bfloat16* ob = o + (long)qz * S * D;
  for (int u = tid; u < ROWS * DN; u += NT) {
    const int row = u / DN, c = u % DN;
    if (q0 + row < S)
      *reinterpret_cast<uint4*>(ob + (long)(q0 + row) * D + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + (c / 8) * BOX + row * 128 +
                                          (((c % 8) ^ (row % 8)) << 4));
  }
}

// Maps of q (B H, S, D) and k, v (B K, S, D) as 3-D tensors, so that a
// tile past S is zero-filled within its head.
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int K, int S, float scale, int causal, int window,
           cudaStream_t stream) {
  static unsigned done = 0;   // devices whose limit is set, one bit each
  CUtensorMap mq, mk, mv;
  const uint32_t box[3] = {64, KEYS, 1};
  const uint64_t dq[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)B * H};
  const uint64_t dk[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)B * K};
  if (!make_map(&mq, q, 3, dq, box) || !make_map(&mk, k, 3, dk, box) ||
      !make_map(&mv, v, 3, dk, box))
    return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<D>::BYTES;
  const int err = smem_limit_once(flash_kernel_wg<D>, smem, done);
  if (err != 0) return err;
  dim3 grid((S + ROWS - 1) / ROWS, H, B);
  flash_kernel_wg<D><<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), H, K, S, scale, causal,
      window);
  return (int)cudaGetLastError();
}

}  // namespace fa3

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int K, int S, float scale, int causal, int window, bool wg,
           cudaStream_t stream) {
  static unsigned done = 0;   // devices whose limit is set, one bit each
  if constexpr (std::is_same<T, __nv_bfloat16>::value && (D == 64 || D == 128)) {
    if (wg)
      return fa3::launch<D>(q, k, v, o, B, H, K, S, scale, causal, window,
                            stream);
  }
  if (wg) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    dim3 grid((S + fa2::ROWS - 1) / fa2::ROWS, H, B);
    const size_t smem = fa2::Layout<D>::BYTES;
    const int err = smem_limit_once(fa2::flash_kernel_mma<D>, smem, done);
    if (err != 0) return err;
    fa2::flash_kernel_mma<D><<<grid, fa2::NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), H, K, S, scale, causal, window);
  } else {
    dim3 grid((S + BQ - 1) / BQ, H, B);
    const size_t smem = smem_floats<D>() * sizeof(float);
    const int err = smem_limit_once(flash_kernel<T, D>, smem, done);
    if (err != 0) return err;
    flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), H, K, S, scale, causal, window);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int H,
               int K, int S, int D, float scale, int causal, int window,
               bool wg, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, K, S, scale, causal, window, wg, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, K, S, scale, causal, window, wg, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, K, S, scale, causal, window, wg, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, K, S, scale, causal, window, wg, s);
    case 256: return launch<T, 256>(q, k, v, o, B, H, K, S, scale, causal, window, wg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// body: 0 = fma (float32), 1 = mma (bfloat16), 2 = wg (bfloat16, D 64 or
// 128, 16-byte-aligned bases). Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int H, int K, int S, int D,
                                      float scale, int causal, int window,
                                      int body, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 0)
    return dispatch_d<float>(q, k, v, o, B, H, K, S, D, scale, causal, window,
                             false, s);
  if (body == 1 || body == 2)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, K, S, D, scale, causal,
                                     window, body == 2, s);
  return (int)cudaErrorInvalidValue;
}
