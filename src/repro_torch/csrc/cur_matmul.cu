// Fused CUR matmul for Hopper (sm_90a): y = (x @ CU) @ R.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cur_matmul/cur_matmul.py
// (`cur_matmul` -> `_cur_matmul_aligned`, body `_kernel`).
//
// What bounds it on the H100. The work is 2 M r (m + n) operations over
// (M + r)(m + n) elements, each read or written once, so in bf16 it does
// M r / (M + r) operations per byte whatever m and n are: 228 at the main
// path's M = 2048, r = 256, below the card's 295 (989 TFLOP/s over
// 3.35 TB/s). The bound is the bytes. For w_gate (m 4096, n 14336) that
// is 84.9 MB in 25.4 us against 19.3 GFLOP in 19.5 us; chip_smoke.py
// computes the same bound from its shapes. So the kernel must not move
// more than it reads: the fusion keeps the (M, r) intermediate, which
// would add 2 M r elements of traffic, out of device memory, as on the
// TPU, and CU and R are re-read by every block from L2, not from HBM.
//
// Design. GPU blocks share nothing and run in no order, so the TPU grid's
// sequential N axis (the `pl.when(j == 0)` scratch fill) becomes a loop
// inside the block: one block owns a BM-row tile of x, forms
// t = x_tile @ CU once into shared memory, and then walks every N tile of
// R itself. t is kept in x's dtype in shared memory, which is exactly the
// TPU kernel's cast of its f32 scratch before the second product; both
// products accumulate in f32. Ragged M / r / n edges are masked in the
// loads and the store (the TPU kernel padded and sliced instead). bf16 runs
// on the tensor cores through WMMA (mma.sync 16x16x16); f32 runs on plain
// FMA so that it stays exact f32 (WMMA's f32 input is TF32).
//
// Each block re-reads all of CU and R (from L2), so the row tile is short
// (BM = 16): at M = 2048 that gives 128 blocks for the 132 SMs, where
// BM = 64 gave 32. A staged slice is 128 x 128 bf16 (64 x 128 f32), moved
// with 16-byte loads that a thread issues all at once, so that each
// round trip to L2 brings 32 KB.
//
// Known limits, for later work: one block per SM cannot hide the L2
// latency of a slice behind the products (no cp.async / TMA double
// buffering), and there is no wgmma.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 16;        // rows of x owned by one block
constexpr int BN = 128;       // output tile width of each product
constexpr int THREADS = 128;  // 4 warps
constexpr int LDC = BN + 4;   // padded leading dim of the f32 staging tile

// Per-dtype tiling: a staged slice is BK deep; loads move 16 bytes
// (VEC elements) at a time. Leading dims are padded by 8 elements, which
// keeps every row 16-byte aligned (vector stores, WMMA's 256-bit rule).
template <typename T> struct Tile {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int BK = sizeof(T) == 2 ? 128 : 64;
  static constexpr int LDA = BK + 8;
  static constexpr int LDB = BN + 8;
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// dst (ROWS x COLS, leading dim LD, shared) = src (leading dim ld), zero
// outside rows x cols. Whole 16-byte vectors go through registers (all of
// a thread's loads are issued before its stores); a vector that crosses
// the ragged edge, or a source that is not 16-byte aligned, is copied
// element by element.
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src, long ld,
                                          int rows, int cols, bool vec_ok) {
  constexpr int VEC = Tile<T>::VEC;
  constexpr int VPR = COLS / VEC;
  constexpr int PER = ROWS * VPR / THREADS;
  static_assert(ROWS * VPR % THREADS == 0, "tile must split evenly");
  uint4 buf[PER];
  bool fast[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int v = threadIdx.x + u * THREADS;
    const int i = v / VPR, c = (v % VPR) * VEC;
    fast[u] = vec_ok && i < rows && c + VEC <= cols;
    if (fast[u]) buf[u] = *reinterpret_cast<const uint4*>(src + i * ld + c);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int v = threadIdx.x + u * THREADS;
    const int i = v / VPR, c = (v % VPR) * VEC;
    T* d = dst + i * LD + c;
    if (fast[u]) {
      *reinterpret_cast<uint4*>(d) = buf[u];
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        d[e] = (i < rows && c + e < cols) ? src[i * ld + c + e] : from_f<T>(0.f);
    }
  }
}

// c_s (BM x BN, f32) = A (a_rows x K) @ B (K x b_cols), zero outside the
// valid rows / columns / depth. A(i, k) = A[i * lda + k] and
// B(k, j) = B[k * ldb + j]; A may point to global or shared memory.
template <typename T>
__device__ void tile_gemm(const T* A, long lda, int a_rows, const T* B,
                          long ldb, int b_cols, int K, T* a_s, T* b_s,
                          float* c_s) {
  using C = Tile<T>;
  const bool a_vec = reinterpret_cast<uintptr_t>(A) % 16 == 0 && lda % C::VEC == 0;
  const bool b_vec = reinterpret_cast<uintptr_t>(B) % 16 == 0 && ldb % C::VEC == 0;
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, float>::value) {
    const int tx = tid % 16, ty = tid / 16;   // rows ty + 8 i, cols tx + 16 j
    float acc[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += C::BK) {
      load_tile<T, BM, C::BK, C::LDA>(a_s, A + k0, lda, a_rows, K - k0, a_vec);
      load_tile<T, C::BK, BN, C::LDB>(b_s, B + (long)k0 * ldb, ldb, K - k0,
                                      b_cols, b_vec);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < C::BK; ++k) {
        float a[2], b[8];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = a_s[(ty + 8 * i) * C::LDA + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = b_s[k * C::LDB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c_s[(ty + 8 * i) * LDC + tx + 16 * j] = acc[i][j];
  } else {
    using namespace nvcuda;
    const int warp = tid / 32;                 // columns warp * 32 .. + 32
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int k0 = 0; k0 < K; k0 += C::BK) {
      load_tile<T, BM, C::BK, C::LDA>(a_s, A + k0, lda, a_rows, K - k0, a_vec);
      load_tile<T, C::BK, BN, C::LDB>(b_s, B + (long)k0 * ldb, ldb, K - k0,
                                      b_cols, b_vec);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < C::BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, a_s + kk, C::LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, b_s + kk * C::LDB + warp * 32 + j * 16, C::LDB);
          wmma::mma_sync(acc[j], af, bf, acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_s + warp * 32 + j * 16, acc[j], LDC,
                              wmma::mem_row_major);
  }
  __syncthreads();
}

template <typename T>
size_t smem_bytes(int rkp) {
  return sizeof(float) * BM * LDC + sizeof(T) * BM * rkp +
         sizeof(T) * BM * Tile<T>::LDA + sizeof(T) * Tile<T>::BK * Tile<T>::LDB;
}

// One block per BM-row tile of x. Shared memory (dynamic):
//   c_s  BM x LDC f32   staging of one product tile
//   t_s  BM x rkp  T    the block's rows of x @ CU (rkp = r rounded up to BN)
//   a_s  BM x LDA  T    staged slice of the left operand
//   b_s  BK x LDB  T    staged slice of the right operand
// Every region's size is a multiple of 128 bytes, so each starts aligned.
template <typename T>
__global__ void __launch_bounds__(THREADS)
cur_matmul_kernel(const T* __restrict__ x, const T* __restrict__ cu,
                  const T* __restrict__ r, T* __restrict__ y, int M, int m,
                  int rk, int n, int rkp) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* c_s = reinterpret_cast<float*>(smem);
  T* t_s = reinterpret_cast<T*>(smem + sizeof(float) * BM * LDC);
  T* a_s = t_s + BM * rkp;
  T* b_s = a_s + BM * Tile<T>::LDA;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, M - row0);

  // t = x_tile @ CU, formed once per block, kept in x's dtype.
  for (int c0 = 0; c0 < rk; c0 += BN) {
    tile_gemm<T>(x + (long)row0 * m, m, rows, cu + c0, rk, min(BN, rk - c0), m,
                 a_s, b_s, c_s);
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int i = e / BN, j = e % BN;
      t_s[i * rkp + c0 + j] = from_f<T>(c_s[i * LDC + j]);
    }
    __syncthreads();
  }
  // y_tile = t @ R_tile for every N tile.
  for (int j0 = 0; j0 < n; j0 += BN) {
    const int cols = min(BN, n - j0);
    tile_gemm<T>(t_s, rkp, BM, r + j0, n, cols, rk, a_s, b_s, c_s);
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int i = e / BN, j = e % BN;
      if (i < rows && j < cols) y[(long)(row0 + i) * n + j0 + j] = from_f<T>(c_s[i * LDC + j]);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const void* cu, const void* r, void* y, int M, int m,
           int rk, int n, cudaStream_t stream) {
  const int rkp = (rk + BN - 1) / BN * BN;
  const size_t smem = smem_bytes<T>(rkp);
  cudaError_t err = cudaFuncSetAttribute(
      cur_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM);
  cur_matmul_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(cu), static_cast<const T*>(r),
      static_cast<T*>(y), M, m, rk, n, rkp);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int cur_matmul_launch(const void* x, const void* cu, const void* r,
                                 void* y, int M, int m, int rk, int n,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, cu, r, y, M, m, rk, n, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, cu, r, y, M, m, rk, n, s);
  return (int)cudaErrorInvalidValue;
}
