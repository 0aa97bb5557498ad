// Paged-attention decode for Hopper (sm_90a): split-KV flash-decoding over
// a cp.async K/V ring, block-table reads, rank-space CUR-KV.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/paged_attention.py (`paged_attention`,
// body `_kernel`).
//
// What it computes. Folded, pre-scaled queries q (B, K, G', r) attend to
// the K/V pools (n_blocks, bs, K, r) through a block table (B, maxb):
// token t of slot b lives at (table[b, t / bs], t % bs). Row g of slot b
// is the query at position qpos = ctx[b] + g / (G' / span) (span 1: every
// row at ctx[b]). A table entry is skipped when it is unassigned (< 0),
// starts past ctx + span - 1, or, with a window, ends at or before
// ctx - window -- the TPU kernel's pl.when skip. Inside a live entry,
// token t is live for row g iff t <= qpos and, with a window,
// t > qpos - window; masked scores take the finite NEG_INF = -1e30, m and
// l are f32, p is rounded to the pool dtype before the PV product, and the
// output is acc / max(l, 1e-30): a slot with no live entry gets exact
// zeros. Dense pools are the r == head_dim case; CUR-KV pools store r
// DEIM-selected columns and the caller folds the link matrices into q and
// the output.
//
// What bounds it on the H100. At the serving shape (B 8, K 8, G' 4, r 128,
// bs 16, bf16, contexts ~1100) the live K and V are 36 MB, 10.8 us at
// 3.35 TB/s, against ~2 operations per byte: the bound is the bytes. To
// reach it the card needs every SM busy and tens of KB in flight per SM.
// The first port (one 128-thread block per (slot, kv-head), 64 blocks,
// one f32-staged tile in flight, one thread per query row in the softmax)
// reached 104 GB/s.
//
// Design (kernels/paged_attention/paged_attention.py::plan chooses the
// body, the padded rank and the split of the table; PERF.md has the
// measured times).
//   * Split-KV (flash-decoding). Grid (B K, splits): each block takes a
//     contiguous run of `eps` table entries of one (slot, kv-head), and
//     B K splits fills the card once (at the serving shape and r 128: 4
//     splits of 18 entries, 256 blocks, two per SM; a second wave would
//     wait out the first one's tail). The block loads its run of the
//     table and ctx[b], applies the skip rule per entry and compacts the
//     live entries in table order with each one's pool offset (warp 0,
//     one ballot per 32 entries).
//   * A three-stage cp.async ring. A stage holds TS tokens (64 at bf16
//     r <= 128) of K and V in the pool dtype, gathered 16 bytes at a time
//     from the live entries (several entries per stage at bs < TS, several
//     stages per entry at bs > TS), two stages ahead of use, one barrier
//     per stage. A block's stream is bound by its own instructions more
//     than by memory, so the copies' addresses avoid integer division. Token slots past the live entries and columns past r are
//     zero-filled and masked as -inf (they are no token of the TPU
//     kernel's, so they add nothing even to a row that is all NEG_INF).
//     Pools whose strides or base are not 16-byte multiples take plain
//     loads into the same ring. cp.async, not TMA: an entry is bs rows of
//     r elements at an arbitrary block stride, which a TMA box per entry
//     could describe, but a stage gathers several entries and the 16-byte
//     copies need no descriptor per call.
//   * Warps. The G' rows are padded to MT m16 tiles (G' <= 64: MT <= 4);
//     warp w owns tile w % MT and every (4 / MT)-th 16-token piece, with
//     its own online softmax state in registers. bf16 (`mma` body): q is
//     loaded once as mma.sync A fragments, scores are m16n8k16 products
//     against K through ldmatrix, the softmax runs on quad shuffles, the
//     score accumulators become PV's A operand in registers (rounded to
//     bf16) and V comes through ldmatrix.trans. f32 (`fma` body): exact
//     f32 on FMA units, lanes across tokens for the scores (q from shared
//     memory), half-warp reductions for the softmax, lanes across r for
//     PV. r that is not a multiple of 16 is zero-padded (exact).
//   * Combines in a fixed order, no atomics on data, so two calls give the
//     same bits. In the block, the warps sharing a tile merge through
//     shared memory (M = max m_w, scale exp(m_w - M), warps in order).
//     With one split that writes the output. Otherwise each split writes
//     (m, l, acc) to an f32 workspace, bumps a per-(slot, kv-head)
//     counter, and the block that finds itself last merges the splits in
//     order 0 .. splits - 1, rounds once to the dtype, and resets the
//     counter to 0 for the next call. A split with no live entry writes
//     (NEG_INF, 0) and no acc, and adds nothing.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;            // cp.async ring depth
constexpr int MAX_G = 64;            // query rows: at most four m16 tiles
constexpr int MAX_ENTRIES = 512;     // table entries per split
constexpr int MAX_SPLITS = 64;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float neg_inf_exact() {
  return __uint_as_float(0xff800000u);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The shape of one instantiation: R is r zero-padded to 16, 32, 64, 128
// or 256; a stage holds TS tokens (about 16 KB each of K and V).
template <typename T, int R>
struct Geo {
  static constexpr int ES = sizeof(T);
  static constexpr int VE = 16 / ES;                   // elements per copy
  static constexpr int LD = R + VE;                    // ring row pitch
  static constexpr int TS = 16384 / (R * ES) < 64 ? 16384 / (R * ES) : 64;
  static constexpr int TILE = TS * LD;                 // one K or V tile
  static constexpr size_t RING = (size_t)STAGES * 2 * TILE * ES;
  static constexpr int LDQ = R + 4;                    // f32 q rows (fma)
  static constexpr bool F32 = std::is_same<T, float>::value;
  // after the loop the ring holds the warps' states and the split factors
  static_assert(RING >= (size_t)WARPS * 16 * (R + 8) * 4 + 3 * WARPS * 16 * 4,
                "the warp states must fit in the ring");
  static_assert(RING >= (size_t)MAX_G * MAX_SPLITS * 4,
                "the split factors must fit in the ring");
  static_assert(TS % 16 == 0, "a stage is whole 16-token pieces");
};

// Dynamic shared memory: the ring | q rows (f32 body) | token positions of
// each stage | the live list (each entry's pool offset, its index) |
// per-row M and L | two ints. kernels/paged_attention/paged_attention.py::plan mirrors it.
template <typename T, int R>
size_t smem_bytes(int G, int eps) {
  using Gm = Geo<T, R>;
  const size_t qs = Gm::F32 ? (size_t)((G + 15) / 16) * 16 * Gm::LDQ * 4 : 0;
  return Gm::RING + qs + (size_t)STAGES * Gm::TS * 4 +
         ((12 * (size_t)eps + 15) / 16) * 16 + 2 * MAX_G * 4 + 16;
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* table;
  const int* ctx_len;
  void* o;
  float* ws;          // splits > 1: acc, then (m, l), of every split
  int* counters;      // splits > 1: one per (slot, kv-head), zero between calls
  int K, G, r, bs, maxb;
  long s_blk, s_row, s_head;
  int window, span, splits, eps, vec;
};

// ---- the bf16 body's warp: mma.sync m16n8k16 ------------------------------
// Lane l holds rows l / 4 and l / 4 + 8 of the warp's m16 tile and, of
// every 8 columns, columns 2 (l % 4) and + 1.
template <int R>
struct MmaWarp {
  static constexpr int KD = R / 16, DN = R / 8, LD = Geo<__nv_bfloat16, R>::LD;
  uint32_t qf[KD][4];
  float acc[DN][4];
  float m[2], l[2];
  int qpos[2];

  __device__ __forceinline__ void init(const Args& a, int bk, int mt,
                                       int lane, int ctx) {
    const int g = lane / 4, t4 = lane % 4, group = a.G / a.span;
    const unsigned short* qb =
        static_cast<const unsigned short*>(a.q) + (long)bk * a.G * a.r;
    const bool pairs = a.r % 2 == 0;     // (col, col + 1) is one 4-byte load
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row = mt * 16 + g + 8 * (x % 2);
        const int col = kd * 16 + 2 * t4 + 8 * (x / 2);
        const unsigned short* p = qb + (long)row * a.r + col;
        uint32_t v = 0;
        if (row < a.G && col < a.r) {
          if (pairs)
            v = *reinterpret_cast<const uint32_t*>(p);
          else
            v = p[0] | (col + 1 < a.r ? (uint32_t)p[1] << 16 : 0u);
        }
        qf[kd][x] = v;
      }
#pragma unroll
    for (int c = 0; c < DN; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
      qpos[i] = ctx + (mt * 16 + g + 8 * i) / group;
    }
  }

  // One piece: 16 token slots of K and V (rows of pitch LD), their token
  // positions tp (-1: no token).
  __device__ __forceinline__ void piece(const __nv_bfloat16* k,
                                        const __nv_bfloat16* v,
                                        const int* tp, int window, int lane) {
    const int t4 = lane % 4;
    float s[2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t bk[4];
      ldmatrix_x4(bk, k + ((lane / 16) * 8 + (lane % 8)) * LD + kd * 16 +
                          ((lane / 8) % 2) * 8);
      mma_m16n8k16_bf16(s[0], qf[kd], bk[0], bk[1]);
      mma_m16n8k16_bf16(s[1], qf[kd], bk[2], bk[3]);
    }
    float mx[2] = {neg_inf_exact(), neg_inf_exact()};
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tp[c * 8 + 2 * t4 + (e % 2)];
        float x = neg_inf_exact();
        if (t >= 0) {
          const int qp = qpos[e / 2];
          bool ok = t <= qp;
          if (window > 0) ok = ok && t > qp - window;
          x = ok ? s[c][e] : NEG_INF;
        }
        s[c][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    // p in f32 for the row sums; rounded to bf16 as PV's A operand
    uint32_t pa[4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[c][e] - m[e / 2]);
        sum[e / 2] += p[e];
      }
      pa[2 * c] = pack_bf16(p[0], p[1]);
      pa[2 * c + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int c = 0; c < DN; ++c) {
      acc[c][0] *= alpha[0];
      acc[c][1] *= alpha[0];
      acc[c][2] *= alpha[1];
      acc[c][3] *= alpha[1];
    }
#pragma unroll
    for (int d2 = 0; d2 < DN / 2; ++d2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, v + ((lane % 8) + ((lane / 8) % 2) * 8) * LD +
                                d2 * 16 + (lane / 16) * 8);
      mma_m16n8k16_bf16(acc[2 * d2], pa, bv[0], bv[1]);
      mma_m16n8k16_bf16(acc[2 * d2 + 1], pa, bv[2], bv[3]);
    }
  }

  // wacc (16 rows of pitch WP f32), wm and wl (16): this warp's state;
  // 8-byte stores, no bank conflict at pitch R + 8
  __device__ __forceinline__ void store(float* wacc, float* wm, float* wl,
                                        int lane) const {
    const int g = lane / 4, t4 = lane % 4;
    constexpr int WP = R + 8;
#pragma unroll
    for (int c = 0; c < DN; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(wacc + (g + 8 * h) * WP + c * 8 + 2 * t4) =
            make_float2(acc[c][2 * h], acc[c][2 * h + 1]);
    if (t4 == 0) {
      wm[g] = m[0];
      wm[g + 8] = m[1];
      wl[g] = l[0];
      wl[g + 8] = l[1];
    }
  }
};

// ---- the f32 body's warp: FMA ---------------------------------------------
// Lane l takes token l % 16 of a piece for the scores and columns
// l % 16 + 16 j for PV, both for rows 8 (l / 16) .. + 7 of the warp's tile.
template <int R>
struct FmaWarp {
  static constexpr int NC = R / 16, LD = Geo<float, R>::LD,
                       LDQ = Geo<float, R>::LDQ;
  float acc[8][NC];
  float m[8], l[8];
  int qpos[8];
  const float* qrow;   // this lane's first q row in shared memory

  __device__ __forceinline__ void init(const float* q_s, int mt, int lane,
                                       int ctx, int group) {
    const int row0 = mt * 16 + (lane / 16) * 8;
    qrow = q_s + row0 * LDQ;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
      qpos[i] = ctx + (row0 + i) / group;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
    }
  }

  __device__ __forceinline__ void piece(const float* k, const float* v,
                                        const int* tp, int window, int lane) {
    const int tok = lane % 16, half = lane / 16;
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    const float* kr = k + tok * LD;
#pragma unroll 4
    for (int c = 0; c < R; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + i * LDQ + c);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }
    const int t = tp[tok];
    float p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float x = neg_inf_exact();
      if (t >= 0) {
        bool ok = t <= qpos[i];
        if (window > 0) ok = ok && t > qpos[i] - window;
        x = ok ? s[i] : NEG_INF;
      }
      float mx = x;
#pragma unroll
      for (int o = 1; o < 16; o *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      p[i] = expf(x - m_new);
      float sum = p[i];
#pragma unroll
      for (int o = 1; o < 16; o *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 2
    for (int t2 = 0; t2 < 16; ++t2) {
      float pt[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pt[i] = __shfl_sync(0xffffffffu, p[i], half * 16 + t2);
      const float* vr = v + t2 * LD + tok;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = vr[16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(pt[i], vv, acc[i][j]);
      }
    }
  }

  __device__ __forceinline__ void store(float* wacc, float* wm, float* wl,
                                        int lane) const {
    const int tok = lane % 16, half = lane / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
        wacc[(half * 8 + i) * (R + 8) + tok + 16 * j] = acc[i][j];
      if (tok == 0) {
        wm[half * 8 + i] = m[i];
        wl[half * 8 + i] = l[i];
      }
    }
  }
};

// ---- the kernel -----------------------------------------------------------

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const Args a) {
  using Gm = Geo<T, R>;
  using Warp = typename std::conditional<Gm::F32, FmaWarp<R>, MmaWarp<R>>::type;
  constexpr int TS = Gm::TS, LD = Gm::LD, VE = Gm::VE, VPR = R / VE;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int MT = (a.G + 15) / 16;
  size_t off = Gm::RING;
  float* q_s = reinterpret_cast<float*>(smem + off);            // fma only
  if (Gm::F32) off += (size_t)MT * 16 * Gm::LDQ * 4;
  int* tpos = reinterpret_cast<int*>(smem + off);
  off += (size_t)STAGES * TS * 4;
  long* list_off = reinterpret_cast<long*>(smem + off);   // entry's K/V row 0
  int* list_j = reinterpret_cast<int*>(list_off + a.eps);
  off += ((12 * (size_t)a.eps + 15) / 16) * 16;
  float* rowM = reinterpret_cast<float*>(smem + off);
  float* rowL = rowM + MAX_G;
  int* misc = reinterpret_cast<int*>(rowL + MAX_G);   // n_live, last block

  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / a.K, kh = bk % a.K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G, r = a.r;
  // this split's first 32 table entries load beside ctx[b]
  const int j0 = split * a.eps;
  const int n_ent = max(0, min(a.eps, a.maxb - j0));
  const int* trow = a.table + (long)b * a.maxb;
  int blk_next = warp == 0 && lane < n_ent ? trow[j0 + lane] : -1;
  const int ctx = a.ctx_len[b];
  const T* kp = static_cast<const T*>(a.k_pool);
  const T* vp = static_cast<const T*>(a.v_pool);

  if constexpr (Gm::F32) {   // q rows (zero past G and r) for the scores
    const float* qb = static_cast<const float*>(a.q) + (long)bk * G * r;
    for (int e = tid; e < MT * 16 * R; e += THREADS) {
      const int row = e / R, c = e % R;
      q_s[row * Gm::LDQ + c] = row < G && c < r ? qb[(long)row * r + c] : 0.f;
    }
  }

  // warp w: m16 tile w % MT, every nw-th 16-token piece from the idx-th;
  // its q fragments load while warp 0 reads the table
  const int mt = warp % MT;
  const int nw = (WARPS - mt + MT - 1) / MT, idx = warp / MT;
  Warp st;
  if constexpr (Gm::F32)
    st.init(q_s, mt, lane, ctx, G / a.span);
  else
    st.init(a, bk, mt, lane, ctx);

  // the live entries of this split's run of the table, in table order
  if (warp == 0) {
    int base = 0;
    for (int i0 = 0; i0 < n_ent; i0 += 32) {
      const int j = j0 + i0 + lane;
      const int blk = blk_next;
      if (i0 + 32 + lane < n_ent) blk_next = trow[j + 32];
      bool live = false;
      if (i0 + lane < n_ent) {
        const int start = j * a.bs;
        live = blk >= 0 && start <= ctx + a.span - 1;
        if (a.window > 0) live = live && start + a.bs - 1 > ctx - a.window;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int pos = base + __popc(mask & ((1u << lane) - 1u));
        list_off[pos] = (long)blk * a.s_blk + (long)kh * a.s_head;
        list_j[pos] = j;
      }
      base += __popc(mask);
    }
    if (lane == 0) misc[0] = base;
  }
  __syncthreads();
  const int n_live = misc[0];

  // stages: CPS chunks of CR rows each; an entry is CPE chunks
  const int CR = min(a.bs, TS);
  const int CPE = (a.bs + CR - 1) / CR;
  const int CPS = TS / CR;
  const int n_chunks = n_live * CPE;
  const int n_stages = (n_chunks + CPS - 1) / CPS;

  // token slot i of a stage is row i % CR of chunk i / CR; chunk gc is
  // rows (gc % CPE) CR .. of live entry gc / CPE. The quotients of these
  // small integers come exactly from float reciprocals ((n + 0.5) / d is
  // at least 0.5 / d from an integer), not from integer division, which
  // costs tens of instructions per copy.
  const float inv_cr = 1.f / CR, inv_cpe = 1.f / CPE;
  auto slot = [&](int c0, int i, int& ent, int& row) {
    const int ci = __float2int_rz((i + 0.5f) * inv_cr);
    const int gc = c0 + ci;
    row = i - ci * CR;
    ent = gc;
    if (CPE > 1) {
      ent = __float2int_rz((gc + 0.5f) * inv_cpe);
      row += (gc - ent * CPE) * CR;
    }
    return ci < CPS && gc < n_chunks && row < a.bs;
  };
  auto load_stage = [&](int u) {
    const int sl = u % STAGES;
    T* kd = ring + (size_t)sl * 2 * Gm::TILE;
    T* vd = kd + Gm::TILE;
    const int c0 = u * CPS;
    for (int v = tid; v < TS * VPR; v += THREADS) {
      const int i = v / VPR, c = (v % VPR) * VE;
      int ent, row;
      const bool ok = slot(c0, i, ent, row);
      const long src = ok ? list_off[ent] + (long)row * a.s_row : 0;
      if (a.vec) {
        const bool in = ok && c < r;
        cp_async_16(kd + i * LD + c, kp + (in ? src + c : 0), in ? 16 : 0);
        cp_async_16(vd + i * LD + c, vp + (in ? src + c : 0), in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          const bool in = ok && c + e < r;
          kd[i * LD + c + e] = in ? kp[src + c + e] : from_f<T>(0.f);
          vd[i * LD + c + e] = in ? vp[src + c + e] : from_f<T>(0.f);
        }
      }
    }
    for (int i = tid; i < TS; i += THREADS) {
      int ent, row;
      const bool ok = slot(c0, i, ent, row);
      tpos[sl * TS + i] = ok ? list_j[ent] * a.bs + row : -1;
    }
  };

  if (n_stages > 0) load_stage(0);
  cp_async_commit();
  if (n_stages > 1) load_stage(1);
  cp_async_commit();
  for (int u = 0; u < n_stages; ++u) {
    cp_async_wait<1>();
    __syncthreads();   // stage u is in; every warp is done with stage u - 1
    if (u + 2 < n_stages) load_stage(u + 2);
    cp_async_commit();
    const int st_u = u % STAGES;
    const T* k_t = ring + (size_t)st_u * 2 * Gm::TILE;
    const T* v_t = k_t + Gm::TILE;
    const int* tp = tpos + st_u * TS;
    const int filled = min(CPS, n_chunks - u * CPS) * CR;
    for (int p = 0; p < TS / 16 && 16 * p < filled; ++p)
      if ((u * (TS / 16) + p) % nw == idx)
        st.piece(k_t + 16 * p * LD, v_t + 16 * p * LD, tp + 16 * p, a.window,
                 lane);
  }
  cp_async_wait_all();
  __syncthreads();   // the ring is free

  // merge the warps of each tile, in warp order: M = max m_w, then
  // L = sum l_w exp(m_w - M) and A = sum acc_w exp(m_w - M)
  constexpr int WP = R + 8;                    // row pitch of a state
  float* wacc = reinterpret_cast<float*>(smem);
  float* wm = wacc + WARPS * 16 * WP;
  float* wl = wm + WARPS * 16;
  float* wf = wl + WARPS * 16;
  st.store(wacc + warp * 16 * WP, wm + warp * 16, wl + warp * 16, lane);
  __syncthreads();
  if (tid < WARPS * 16) {
    const int w = tid / 16, rr = tid % 16, wt = w % MT;
    float M = NEG_INF;
    for (int w2 = wt; w2 < WARPS; w2 += MT) M = fmaxf(M, wm[w2 * 16 + rr]);
    wf[tid] = expf(wm[tid] - M);
    const int g = wt * 16 + rr;
    if (w == wt && g < G) {
      float L = 0.f;
      for (int w2 = wt; w2 < WARPS; w2 += MT)
        L += wl[w2 * 16 + rr] * expf(wm[w2 * 16 + rr] - M);
      rowM[g] = M;
      rowL[g] = L;
    }
  }
  __syncthreads();
  const int splits = a.splits;
  T* ob = static_cast<T*>(a.o) + (long)bk * G * r;
  float* ws_acc = a.ws + ((long)bk * splits + split) * G * r;
  float* ws_ml = a.ws + (long)gridDim.x * splits * G * r +
                 ((long)bk * splits + split) * G * 2;
  // four columns per thread where r allows (16-byte reads and stores)
  const int cw = r % 4 == 0 ? 4 : 1, rq = r / cw;
  for (int e = tid; e < G * rq; e += THREADS) {
    const int g = e / rq, c = (e - g * rq) * cw, wt = g / 16, rr = g % 16;
    float A[4] = {0.f, 0.f, 0.f, 0.f};
    for (int w2 = wt; w2 < WARPS; w2 += MT) {
      const float* x = wacc + (w2 * 16 + rr) * WP + c;
      const float f = wf[w2 * 16 + rr];
      if (cw == 4) {
        const float4 x4 = *reinterpret_cast<const float4*>(x);
        A[0] += x4.x * f;
        A[1] += x4.y * f;
        A[2] += x4.z * f;
        A[3] += x4.w * f;
      } else {
        A[0] += x[0] * f;
      }
    }
    if (splits == 1) {
      const float L = fmaxf(rowL[g], 1e-30f);
      for (int i = 0; i < cw; ++i) ob[g * r + c + i] = from_f<T>(A[i] / L);
    } else if (rowL[g] != 0.f) {
      if (cw == 4)
        *reinterpret_cast<float4*>(ws_acc + g * r + c) =
            make_float4(A[0], A[1], A[2], A[3]);
      else
        ws_acc[g * r + c] = A[0];
    }
  }
  if (splits == 1) return;
  for (int g = tid; g < G; g += THREADS) {
    ws_ml[2 * g] = rowM[g];
    ws_ml[2 * g + 1] = rowL[g];
  }

  // the last split of (slot, kv-head) to finish merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) misc[1] = atomicAdd(&a.counters[bk], 1) == splits - 1;
  __syncthreads();
  if (!misc[1]) return;
  __threadfence();
  const float* accs = a.ws + (long)bk * splits * G * r;
  const float* ml = a.ws + (long)gridDim.x * splits * G * r +
                    (long)bk * splits * G * 2;
  // a thread's first four columns of each of the first PRE splits load
  // now, beside the (m, l) loads below (f 0 or not, they are allocated)
  constexpr int PRE = 8;
  const int n4 = r % 4 == 0 ? G * r / 4 : 0;
  float4 pre[PRE];
#pragma unroll
  for (int s = 0; s < PRE; ++s)
    if (tid < n4 && s < splits)
      pre[s] = __ldcg(
          reinterpret_cast<const float4*>(accs + (long)s * G * r + 4 * tid));
  // per row: M = max m_s (one lane per split, a warp per row), then
  // L = sum l_s exp(m_s - M) in split order, and each split's factor
  float* fac = reinterpret_cast<float*>(smem);   // (splits, G)
  for (int g = warp; g < G; g += WARPS) {
    float m2[2], l2[2], M = NEG_INF;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = lane + 32 * h;
      m2[h] = NEG_INF;
      l2[h] = 0.f;
      if (s < splits) {
        const float2 v =
            __ldcg(reinterpret_cast<const float2*>(ml + ((long)s * G + g) * 2));
        m2[h] = v.x;
        l2[h] = v.y;
      }
      M = fmaxf(M, m2[h]);
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float lf[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = lane + 32 * h;
      const float f = expf(m2[h] - M);
      lf[h] = l2[h] * f;
      if (s < splits) fac[s * G + g] = l2[h] != 0.f ? f : 0.f;  // 0: no acc
    }
    float L = 0.f;
    for (int s = 0; s < splits; ++s)
      L += __shfl_sync(0xffffffffu, s < 32 ? lf[0] : lf[1], s % 32);
    if (lane == 0) rowL[g] = L;
  }
  __syncthreads();
  // A = sum over splits of f_s acc_s, four columns per thread where the
  // rows allow; every split's loads are issued before the sums (a split
  // with f 0 is loaded, being allocated, and not added)
  for (int e4 = tid; e4 < n4; e4 += THREADS) {
    const int e = 4 * e4, g = e / r;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](const float4& x, float f) {
      if (f > 0.f) {
        A.x += x.x * f;
        A.y += x.y * f;
        A.z += x.z * f;
        A.w += x.w * f;
      }
    };
#pragma unroll
    for (int s = 0; s < PRE; ++s)
      if (s < splits)
        add(e4 == tid ? pre[s]
                      : __ldcg(reinterpret_cast<const float4*>(
                            accs + (long)s * G * r + e)),
            fac[s * G + g]);
#pragma unroll 8
    for (int s = PRE; s < splits; ++s)
      add(__ldcg(reinterpret_cast<const float4*>(accs + (long)s * G * r + e)),
          fac[s * G + g]);
    const float L = fmaxf(rowL[g], 1e-30f);
    ob[e] = from_f<T>(A.x / L);
    ob[e + 1] = from_f<T>(A.y / L);
    ob[e + 2] = from_f<T>(A.z / L);
    ob[e + 3] = from_f<T>(A.w / L);
  }
  for (int e = 4 * n4 + tid; e < G * r; e += THREADS) {
    const int g = e / r;
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const float x = __ldcg(accs + (long)s * G * r + e);
      const float f = fac[s * G + g];
      if (f > 0.f) A += x * f;
    }
    ob[e] = from_f<T>(A / fmaxf(rowL[g], 1e-30f));
  }
  if (tid == 0) a.counters[bk] = 0;
}

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

template <typename T, int R>
int launch(const Args& a, int BK, int smem, cudaStream_t stream) {
  static unsigned done = 0;   // devices whose limit is set, one bit each
  if ((size_t)smem != smem_bytes<T, R>(a.G, a.eps))
    return (int)cudaErrorInvalidValue;
  const int err = smem_limit_once(paged_split_kernel<T, R>,
                                  smem_bytes<T, R>(MAX_G, MAX_ENTRIES), done);
  if (err != 0) return err;
  dim3 grid(BK, a.splits);
  paged_split_kernel<T, R><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rank(const Args& a, int rank, int BK, int smem, cudaStream_t s) {
  switch (rank) {
    case 16: return launch<T, 16>(a, BK, smem, s);
    case 32: return launch<T, 32>(a, BK, smem, s);
    case 64: return launch<T, 64>(a, BK, smem, s);
    case 128: return launch<T, 128>(a, BK, smem, s);
    case 256: return launch<T, 256>(a, BK, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One call's arguments, packed by the wrapper into one buffer (a ctypes
// call with two dozen arguments costs more host time than the launch).
// q (B, K, G, r) and o contiguous; pools (n_blocks, bs, K, r) with element
// strides s_blk, s_row, s_head and a unit last stride; table (B, maxb) and
// ctx (B,) int32. dtype: 0 = float32 (fma body), 1 = bfloat16 (mma body).
// rank (r padded), splits, eps (table entries per split) and smem (bytes)
// come from the wrapper's plan and are checked here. With splits > 1, ws
// holds B K splits G (r + 2) floats (16-byte aligned) and counters B K ints
// that are 0 (and are 0 again after the kernel).
struct Launch {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* table;
  const void* ctx;
  void* o;
  void* ws;
  void* counters;
  void* stream;
  long long s_blk, s_row, s_head;
  int B, K, G, r, bs, maxb, window, span, dtype, rank, splits, eps, smem, pad;
};
static_assert(sizeof(Launch) == 12 * 8 + 14 * 4, "the wrapper packs 12q14i");

// Returns a cudaError_t (0 on success).
extern "C" int paged_attention_launch(const Launch* L) {
  const int G = L->G, r = L->r, rank = L->rank, splits = L->splits,
            eps = L->eps, maxb = L->maxb;
  if (G < 1 || G > MAX_G || r < 1 || r > rank || L->bs < 1 || L->span < 1 ||
      G % L->span != 0 || maxb < 0 || eps < 1 || eps > MAX_ENTRIES ||
      splits < 1 || splits > MAX_SPLITS || (long)splits * eps < maxb ||
      (splits > 1 && (long)(splits - 1) * eps >= maxb) ||
      (splits > 1 && (L->ws == nullptr || L->counters == nullptr)) ||
      L->dtype < 0 || L->dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int VE = L->dtype == 0 ? 4 : 8;
  const bool vec =
      r % VE == 0 && L->s_blk % VE == 0 && L->s_row % VE == 0 &&
      L->s_head % VE == 0 &&
      ((reinterpret_cast<uintptr_t>(L->k_pool) |
        reinterpret_cast<uintptr_t>(L->v_pool)) % 16) == 0;
  Args a{L->q, L->k_pool, L->v_pool, static_cast<const int*>(L->table),
         static_cast<const int*>(L->ctx), L->o, static_cast<float*>(L->ws),
         static_cast<int*>(L->counters), L->K, G, r, L->bs, maxb,
         (long)L->s_blk, (long)L->s_row, (long)L->s_head, L->window, L->span,
         splits, eps, (int)vec};
  cudaStream_t s = static_cast<cudaStream_t>(L->stream);
  const int BK = L->B * L->K;
  if (L->dtype == 0) return dispatch_rank<float>(a, rank, BK, L->smem, s);
  return dispatch_rank<__nv_bfloat16>(a, rank, BK, L->smem, s);
}
