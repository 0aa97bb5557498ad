// Paged-attention decode for Hopper (sm_90a): block-table K/V reads,
// online softmax, rank-space CUR-KV.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/paged_attention.py (`paged_attention`,
// body `_kernel`).
//
// What it computes. Folded, pre-scaled queries q (B, K, G', r) attend to
// the K/V pools (n_blocks, bs, K, r) through a block table (B, maxb):
// token t of slot b lives at (table[b, t / bs], t % bs). Row g of slot b
// is the query at position qpos = ctx[b] + g / (G' / span) (span 1: every
// row at ctx[b]); token t is live for it iff t <= qpos, t > qpos - window
// when window > 0, and its table entry is >= 0. Dense pools are the
// r == head_dim case; CUR-KV pools store r DEIM-selected columns and the
// caller folds the link matrices into q and the output.
//
// What bounds it on the H100. At the serving path's shape (B 8, K 8,
// G' 4, r 128, bs 16, bf16) a slot reads up to ctx * r * 2 * 2 bytes of
// K and V per kv-head and does 4 G' r operations per position: G' / 2 = 2
// operations per byte read, far below the ~295 where the tensor cores
// become the limit. The bound is the bytes of the live blocks, so the
// design reads each live block once per (slot, kv-head), as the TPU
// kernel does, and does the arithmetic on FMA units from shared memory.
//
// Design. One block of 128 threads per (slot, kv-head): the TPU grid's
// innermost block-index axis becomes a loop over the slot's table row,
// which the block loads itself (no scalar prefetch). A table entry is
// skipped when it is unassigned (< 0), starts past the last query position
// (start > ctx + span - 1), or, with a window, ends before it
// (start + bs - 1 <= ctx - window) -- the TPU kernel's pl.when skip. A
// live block's (bs, r) K and V tiles of head k are staged in shared memory
// as f32 (16-byte vector loads when the strides allow), in chunks of at
// most TR rows. Scores are f32 (one thread per (row, token) pair); one
// thread per query row runs the online softmax with m, l in f32; p is
// rounded to the pool dtype before the PV product, as the TPU kernel
// does; the f32 accumulator (G', r) lives in shared memory. Masked scores
// take the finite NEG_INF = -1e30, so the arithmetic is the TPU kernel's
// step for step. The output is acc / max(l, 1e-30): a slot with no live
// position writes exact zeros.
//
// Known limits, for later work: B * K = 64 blocks at the serving shape on
// 132 SMs, one block's loads in flight at a time (no cp.async / TMA double
// buffering), and no split of the sequence across blocks (flash-decoding).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int TR = 32;          // pool rows staged per chunk
constexpr int MAX_R = 256;
constexpr int MAX_G = 64;
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

// Shared memory, in floats: q (G, r+1), k and v (TR, r+1) each,
// acc (G, r), scores (G, TR+1), m / l / alpha (G each).
__host__ __device__ inline size_t smem_floats(int G, int r) {
  return (size_t)G * (r + 1) + 2 * (size_t)TR * (r + 1) + (size_t)G * r +
         (size_t)G * (TR + 1) + 3 * (size_t)G;
}

// dst (rows x r, row pitch r+1, f32) = rows row0 .. row0+rows-1 of head kh
// of pool block blk. Element (t, c) sits at
// pool[blk * s_blk + t * s_row + kh * s_head + c].
template <typename T>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const T* __restrict__ pool,
                                           long base, int row0, int rows,
                                           long s_row, int r, bool vec) {
  constexpr int VW = 16 / sizeof(T);   // elements per 16-byte load
  const int rp = r + 1;
  if (vec) {
    const int vpr = r / VW;
    for (int u = threadIdx.x; u < rows * vpr; u += THREADS) {
      const int t = u / vpr, c = (u % vpr) * VW;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          pool + base + (long)(row0 + t) * s_row + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VW; ++i) dst[t * rp + c + i] = to_f(e[i]);
    }
  } else {
    for (int u = threadIdx.x; u < rows * r; u += THREADS) {
      const int t = u / r, c = u % r;
      dst[t * rp + c] = to_f(pool[base + (long)(row0 + t) * s_row + c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
             const T* __restrict__ v_pool, const int* __restrict__ table,
             const int* __restrict__ ctx_len, T* __restrict__ o, int K, int G,
             int r, int bs, int maxb, long s_blk, long s_row, long s_head,
             int window, int span, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int rp = r + 1, tp = TR + 1;
  float* q_s = smem;                       // G x rp
  float* k_s = q_s + (size_t)G * rp;       // TR x rp
  float* v_s = k_s + (size_t)TR * rp;      // TR x rp
  float* a_s = v_s + (size_t)TR * rp;      // G x r accumulator
  float* s_s = a_s + (size_t)G * r;        // G x tp scores / probabilities
  float* m_s = s_s + (size_t)G * tp;       // running max
  float* l_s = m_s + G;                    // running sum
  float* al_s = l_s + G;                   // this chunk's rescale factor

  const int b = blockIdx.x, kh = blockIdx.y, tid = threadIdx.x;
  const int group = G / span;
  const int ctx = ctx_len[b];
  const T* qb = q + ((long)b * K + kh) * G * r;
  T* ob = o + ((long)b * K + kh) * G * r;
  const int* trow = table + (long)b * maxb;

  for (int e = tid; e < G * r; e += THREADS) {
    q_s[(e / r) * rp + e % r] = to_f(qb[e]);
    a_s[e] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  for (int j = 0; j < maxb; ++j) {
    const int blk = trow[j];
    const int start = j * bs;
    bool live = blk >= 0 && start <= ctx + span - 1;
    if (window > 0) live = live && start + bs - 1 > ctx - window;
    if (!live) continue;                    // uniform across the block
    const long base = (long)blk * s_blk + (long)kh * s_head;
    for (int c0 = 0; c0 < bs; c0 += TR) {
      const int rows = min(TR, bs - c0);
      __syncthreads();   // the previous chunk's readers are done
      stage_rows<T>(k_s, k_pool, base, c0, rows, s_row, r, vec);
      stage_rows<T>(v_s, v_pool, base, c0, rows, s_row, r, vec);
      __syncthreads();

      // scores, masked to NEG_INF
      for (int u = tid; u < G * rows; u += THREADS) {
        const int g = u / rows, t = u % rows;
        const float* qr = q_s + g * rp;
        const float* kr = k_s + t * rp;
        float acc = 0.f;
        for (int c = 0; c < r; ++c) acc = fmaf(qr[c], kr[c], acc);
        const int idx = start + c0 + t;
        const int qpos = ctx + g / group;
        bool ok = idx <= qpos;
        if (window > 0) ok = ok && idx > qpos - window;
        s_s[g * tp + t] = ok ? acc : NEG_INF;
      }
      __syncthreads();

      // online softmax, one thread per query row
      for (int g = tid; g < G; g += THREADS) {
        float* row = s_s + g * tp;
        const float m_prev = m_s[g];
        float m_new = m_prev;
        for (int t = 0; t < rows; ++t) m_new = fmaxf(m_new, row[t]);
        const float alpha = expf(m_prev - m_new);
        float sum = 0.f;
        for (int t = 0; t < rows; ++t) {
          const float p = expf(row[t] - m_new);
          sum += p;
          row[t] = to_f(from_f<T>(p));      // PV uses p in the pool dtype
        }
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        al_s[g] = alpha;
      }
      __syncthreads();

      // acc = acc * alpha + P @ V
      for (int e = tid; e < G * r; e += THREADS) {
        const int g = e / r, c = e % r;
        const float* pr = s_s + g * tp;
        float acc = a_s[e] * al_s[g];
        for (int t = 0; t < rows; ++t) acc = fmaf(pr[t], v_s[t * rp + c], acc);
        a_s[e] = acc;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * r; e += THREADS)
    ob[e] = from_f<T>(a_s[e] / fmaxf(l_s[e / r], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* ctx, void* o, int B, int K, int G, int r, int bs,
           int maxb, long s_blk, long s_row, long s_head, int window, int span,
           cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  const bool vec =
      r % VW == 0 && s_blk % VW == 0 && s_row % VW == 0 && s_head % VW == 0 &&
      ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) % 16) == 0;
  const size_t smem = smem_floats(G, r) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, K);
  paged_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, ctx, static_cast<T*>(o), K, G, r, bs,
      maxb, s_blk, s_row, s_head, window, span, (int)vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, K, G, r) and o contiguous; pools (n_blocks, bs, K, r) with the
// given element strides of the block, row and head dims and a unit last
// stride; table (B, maxb) and ctx (B,) int32. dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* ctx, void* o, int B, int K,
                                      int G, int r, int bs, int maxb,
                                      long s_blk, long s_row, long s_head,
                                      int window, int span, int dtype,
                                      void* stream) {
  if (G < 1 || G > MAX_G || r < 1 || r > MAX_R || bs < 1 || span < 1 ||
      G % span != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* cx = static_cast<const int*>(ctx);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tb, cx, o, B, K, G, r, bs, maxb,
                         s_blk, s_row, s_head, window, span, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tb, cx, o, B, K, G, r, bs,
                                 maxb, s_blk, s_row, s_head, window, span, s);
  return (int)cudaErrorInvalidValue;
}
