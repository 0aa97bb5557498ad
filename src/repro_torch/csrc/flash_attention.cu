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
// Two bodies. bf16 runs both products on the tensor cores (WMMA mma.sync
// 16x16x16, f32 accumulate): each of the 4 warps owns 16 of the block's 64
// query rows, so scores, probabilities and the f32 output accumulator are
// per-warp and only the K/V tile loads need the whole block. f32 runs both
// products on FMA from shared memory so that it stays exact f32 (WMMA's
// f32 input is TF32).
//
// Known limits, for later work: K/V tiles are loaded with no double
// buffering (no cp.async / TMA), the output accumulator goes through
// shared memory once per KV tile (WMMA does not expose a fragment's rows
// for the online-softmax rescale), and there is no wgmma.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>
#include <type_traits>

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

// bf16 tensor-core body. Shared memory (dynamic), per block:
//   q_s, k_s, v_s  64 x LDQ bf16   query rows, this KV tile's keys / values
//   s_s            64 x LDS f32    scores of this tile
//   p_s            64 x LDP bf16   probabilities of this tile
//   o_s            64 x LDO f32    output accumulator
//   m_s, l_s       64 f32 each     running max and sum
// Every region's size is a multiple of 128 bytes, so each starts aligned
// for WMMA (256-bit) and 16-byte vector copies.
template <int D>
struct TcLayout {
  static constexpr int LDQ = D + 8;
  static constexpr int LDS = BKV + 4;
  static constexpr int LDP = BKV + 8;
  static constexpr int LDO = D + 4;
  static constexpr size_t Q = 0;
  static constexpr size_t KT = Q + sizeof(__nv_bfloat16) * BQ * LDQ;
  static constexpr size_t VT = KT + sizeof(__nv_bfloat16) * BKV * LDQ;
  static constexpr size_t ST = VT + sizeof(__nv_bfloat16) * BKV * LDQ;
  static constexpr size_t PT = ST + sizeof(float) * BQ * LDS;
  static constexpr size_t OT = PT + sizeof(__nv_bfloat16) * BQ * LDP;
  static constexpr size_t ML = OT + sizeof(float) * BQ * LDO;
  static constexpr size_t BYTES = ML + sizeof(float) * 2 * BQ;
};

// dst (64 x D+8, shared) = rows row0 .. row0+63 of src (S x D), zero past
// S; 16-byte copies when the source is aligned.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* __restrict__ dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int row0, int S, bool vec) {
  constexpr int LDQ = D + 8, VPR = D / 8;
  for (int u = threadIdx.x; u < 64 * VPR; u += THREADS) {
    const int i = u / VPR, c = (u % VPR) * 8;
    __nv_bfloat16* d = dst + i * LDQ + c;
    const __nv_bfloat16* g = src + (long)(row0 + i) * D + c;
    if (row0 + i >= S) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else if (vec) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(g);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = g[e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel_tc(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int H, int K, int S,
                float scale, int causal, int window) {
  using namespace nvcuda;
  using L = TcLayout<D>;
  constexpr int DK = D / 16;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::Q);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::KT);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::VT);
  float* s_s = reinterpret_cast<float*>(smem_tc + L::ST);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem_tc + L::PT);
  float* o_s = reinterpret_cast<float*>(smem_tc + L::OT);
  float* m_s = reinterpret_cast<float*>(smem_tc + L::ML);
  float* l_s = m_s + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const __nv_bfloat16* qb = q + ((long)b * H + h) * S * D;
  const __nv_bfloat16* kb = k + ((long)b * K + kh) * S * D;
  const __nv_bfloat16* vb = v + ((long)b * K + kh) * S * D;
  __nv_bfloat16* ob = o + ((long)b * H + h) * S * D;
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % 16) == 0;

  load_rows<D>(q_s, qb, q0, S, vec);
  for (int e = tid; e < BQ * L::LDO; e += THREADS) o_s[e] = 0.f;
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[DK];
#pragma unroll
  for (int kd = 0; kd < DK; ++kd)
    wmma::load_matrix_sync(qa[kd], q_s + warp * 16 * L::LDQ + kd * 16, L::LDQ);

  // softmax layout: two lanes per query row, 32 keys each
  const int row = warp * 16 + lane / 2, half = lane % 2;
  const int qi = q0 + row;
  const float* s_row = s_s + row * L::LDS + half * 32;
  __nv_bfloat16* p_row = p_s + row * L::LDP + half * 32;
  float* o_row = o_s + row * L::LDO + half * (D / 2);

  const int nk = (S + BKV - 1) / BKV;
  const int j_hi = causal ? min(nk - 1, (q0 + BQ - 1) / BKV) : nk - 1;
  for (int j = 0; j <= j_hi; ++j) {
    const int k0 = j * BKV;
    if (window > 0 && k0 + BKV - 1 <= q0 - window) continue;  // dead tile
    __syncthreads();   // every warp is done with the previous k_s / v_s
    load_rows<D>(k_s, kb, k0, S, vec);
    load_rows<D>(v_s, vb, k0, S, vec);
    __syncthreads();

    // this warp's 16 x 64 scores
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kd = 0; kd < DK; ++kd) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, k_s + c * 16 * L::LDQ + kd * 16, L::LDQ);
        wmma::mma_sync(sf, qa[kd], kf, sf);
      }
      wmma::store_matrix_sync(s_s + warp * 16 * L::LDS + c * 16, sf, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, masked to NEG_INF
    float sv[32];
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kj = k0 + half * 32 + c;
      bool ok = kj < S;
      if (causal) ok = ok && kj <= qi;
      if (window > 0) ok = ok && kj > qi - window;
      sv[c] = ok ? s_row[c] * scale : NEG_INF;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_prev = m_s[row];
    const float m_new = fmaxf(m_prev, mx);
    const float alpha = expf(m_prev - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(sv[c] - m_new);
      sum += p;
      p_row[c] = __float2bfloat16(p);   // PV uses p in bf16
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) o_row[c] *= alpha;
    __syncwarp();
    if (half == 0) {
      l_s[row] = l_s[row] * alpha + sum;
      m_s[row] = m_new;
    }

    // this warp's 16 x D output += P @ V
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf[BKV / 16];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wmma::load_matrix_sync(pf[kk], p_s + warp * 16 * L::LDP + kk * 16, L::LDP);
#pragma unroll
    for (int c = 0; c < DK; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      float* o_tile = o_s + warp * 16 * L::LDO + c * 16;
      wmma::load_matrix_sync(of, o_tile, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, v_s + kk * 16 * L::LDQ + c * 16, L::LDQ);
        wmma::mma_sync(of, pf[kk], vf, of);
      }
      wmma::store_matrix_sync(o_tile, of, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncwarp();
  if (qi < S) {
    const float l = fmaxf(l_s[row], 1e-30f);
#pragma unroll
    for (int c = 0; c < D / 2; ++c)
      ob[(long)qi * D + half * (D / 2) + c] = __float2bfloat16(o_row[c] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int K, int S, float scale, int causal, int window, cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, H, B);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t smem = TcLayout<D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_kernel_tc<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), H, K, S, scale, causal, window);
  } else {
    const size_t smem = smem_floats<D>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), H, K, S, scale, causal, window);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int H,
               int K, int S, int D, float scale, int causal, int window,
               cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, K, S, scale, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, K, S, scale, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, K, S, scale, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, K, S, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int H, int K, int S, int D,
                                      float scale, int causal, int window,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, H, K, S, D, scale, causal, window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, K, S, D, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
