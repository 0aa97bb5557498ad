// CUR matmul for Hopper (sm_90a): y = (x @ CU) @ R.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cur_matmul/cur_matmul.py
// (`cur_matmul` -> `_cur_matmul_aligned`, body `_kernel`).
//
// What bounds it on the H100. The work is 2 M r (m + n) operations over
// (M + r)(m + n) elements, each read or written once, so in bf16 it does
// M r / (M + r) operations per byte whatever m and n are: 228 at the main
// path's M = 2048, r = 256, below the card's 295 (989 TFLOP/s over
// 3.35 TB/s). The bound is the bytes: 146 MB for one layer's wq, wk and
// w_gate (84.9 MB, 25.4 us, for w_gate alone); chip_smoke.py computes the
// same bound from its shapes.
//
// Why the TPU kernel's fusion gives way here. On the TPU the grid's N axis
// runs in order on one core, so the (bm, r) intermediate t = x_tile @ CU
// is formed once per row tile in scratch and reused for every N tile at no
// cost. The literal translation (the `fused` body below) makes one block
// own a 16-row tile of x and walk every N tile of R itself, so each of the
// 128 blocks re-reads all of CU and R from L2: 4.2 MB for wq, 2.6 MB for
// wk, 9.4 MB for w_gate, about 2.1 GB of L2 traffic per layer against the
// 146 MB the function needs. Writing t to device memory instead costs
// 2 M r bytes each way, 1 MB at M 2048, r 256: 6.3 MB for the three
// weights, 4.3% of the 146 MB, and it stays in the 50 MB L2.
//
// Design of the bf16 body (`tc`): two GEMMs, each the Hopper way.
//   pass 1  t_s = x @ CU over a slice range s of m, f32 partial sums to a
//           workspace (split-K: M r is only 32 tiles of 128 x 128 at the
//           main shape, so m is split until ~132 work items exist);
//   reduce  t = bf16(sum_s t_s), the splits added in a fixed order, so the
//           result is bit-identical from call to call (no atomics) and t
//           is rounded once from an f32 sum over all of m, as on the TPU;
//   pass 2  y = t @ R, 128 x 128 output tiles over K = r.
// Both GEMMs are warp-specialised: warpgroup 0 is the producer, one thread
// keeping TMA loads in flight in a ring of 128-byte-swizzled shared memory
// (6 stages in pass 1, 4 in pass 2), completed on mbarriers; warpgroups 1 and 2 each run
// wgmma m64n128k16 over 64 rows with the f32 accumulators in registers,
// keep one wgmma group in flight, and hand a stage back on an "empty"
// mbarrier. B (CU or R) is row-major, so wgmma reads it MN-major
// (transposed) from the same swizzled layout. Pass 1 is persistent (one
// block per SM walking (row tile, column tile, split) items in a fixed
// stride). In pass 2 every tile re-reading its 128 x r rows of t would
// cost as much L2 traffic as streaming R, so a block owns one row tile,
// loads its t rows (r <= 512: at most 128 KB) once, and walks a stride of
// column tiles with only R in the ring; its epilogue rounds to bf16 into
// swizzled shared memory and stores 64 x 64 boxes with TMA, which
// overlaps the next tile's loads. Ragged M, r and n are TMA's
// out-of-bounds zero fill on loads and its clipping on stores; a ragged
// last slice of m is zero-filled the same way.
//
// TMA describes a tensor only when every row stride is a multiple of 16
// bytes, so the `tc` body needs m, r and n to be multiples of 8 (and
// 16-byte-aligned base pointers). For any other bf16 shape, and for f32,
// the wrapper (`kernels/cur_matmul/cur_matmul.py::plan`) routes by shape to
// the `fused` body, which stays for that purpose: f32 runs on FMA there so
// that it stays exact f32 (WMMA's f32 input is TF32).
//
// The `fused` body: one block owns a BM = 16 row tile of x, forms
// t = x_tile @ CU once into shared memory in x's dtype, then walks every N
// tile of R; both products accumulate in f32; bf16 on WMMA (mma.sync
// 16x16x16), f32 on FMA; ragged edges masked in its loads and store.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

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


// ===========================================================================
// The two-pass bf16 body (TMA + wgmma).
// ===========================================================================
namespace tc {

using namespace hopper;

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES1 = 6;                // pass 1's ring: A and B slices
constexpr int STAGES2 = 4;                // pass 2's ring: B slices
constexpr int THREADS = 384;              // producer + two consumer warpgroups
constexpr int A_BYTES = BM * BK * 2;      // 16 KB: 128 rows x 128 B
constexpr int B_HALF = BK * 64 * 2;       // 8 KB: 64 rows x 64 columns
constexpr int B_BYTES = 2 * B_HALF;       // 16 KB: the 128-column tile
constexpr int OUT_HALF = 64 * 64 * 2;     // 8 KB: one 64 x 64 store box
constexpr int OUT_BYTES = 2 * OUT_HALF;   // a consumer's 64 x 128 tile
constexpr int MAX_KT = 8;                 // r <= 512: pass 2 keeps all of A

// Dynamic shared memory: a ring of A tiles (pass 1) or all kt of them
// (pass 2), the ring of S B tiles, the consumers' store boxes (pass 2),
// the barriers.
constexpr int smem_bytes(int a_tiles, int S, int out_bytes) {
  return 1024 + a_tiles * A_BYTES + S * B_BYTES + out_bytes + (2 * S + 1) * 8;
}

struct Smem {
  unsigned char *a, *b, *out;
  uint64_t *full, *empty, *a_full;
};

template <int S>
__device__ __forceinline__ Smem carve(unsigned char* raw, int a_tiles,
                                      int out_bytes) {
  Smem m;
  m.a = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  m.b = m.a + a_tiles * A_BYTES;
  m.out = m.b + S * B_BYTES;
  m.full = reinterpret_cast<uint64_t*>(m.out + out_bytes);
  m.empty = m.full + S;
  m.a_full = m.empty + S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&m.full[s], 1);    // the producer's arrive + the TMA bytes
      mbar_init(&m.empty[s], 8);   // one arrive per consumer warp
    }
    mbar_init(m.a_full, 1);
    mbar_fence_init();
  }
  __syncthreads();
  return m;
}

template <int S>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// acc (this warpgroup's 64 x 128) += A (64 rows at a: K-major, 128-byte
// swizzled, BK deep) @ B (BK x 128 at b: MN-major, two 64-column boxes
// B_HALF apart). A k16 step is 32 bytes along A's swizzled rows and 16
// rows (two 1 KB swizzle atoms) down B.
__device__ __forceinline__ void mma_slice(float (&acc)[64],
                                          const unsigned char* a,
                                          const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_m64n128k16_bf16_tn(acc, wgmma_desc(a + kk * 32, 16, 1024),
                             wgmma_desc(b + kk * 16 * 128, B_HALF, 1024));
}

// The consumers' main loop over slices kb .. ke - 1 of one output tile.
// One wgmma group stays in flight: a stage goes back to the producer once
// the group after it has been issued. a_of(k) is the A tile of slice k.
template <int S, typename AOf>
__device__ __forceinline__ void mainloop(float (&acc)[64], Smem& m, Ring<S>& ring,
                                         int kb, int ke, int lane, AOf a_of) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int prev = -1;
  for (int k = kb; k < ke; ++k) {
    mbar_wait(&m.full[ring.stage], ring.phase);
    fence_regs(acc);
    wgmma_fence();
    mma_slice(acc, a_of(k, ring.stage), m.b + ring.stage * B_BYTES);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(&m.empty[prev]);
    prev = ring.stage;
    ring.next();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (prev >= 0 && lane == 0) mbar_arrive(&m.empty[prev]);
}

// Producer side of one B slice: wait for the stage, expect its bytes, load.
template <int S>
__device__ __forceinline__ void load_b(Smem& m, Ring<S>& ring,
                                       const CUtensorMap* map_b, int n0, int k,
                                       int a_bytes) {
  mbar_wait(&m.empty[ring.stage], ring.phase ^ 1);
  mbar_arrive_expect_tx(&m.full[ring.stage], B_BYTES + a_bytes);
  unsigned char* b = m.b + ring.stage * B_BYTES;
  tma_load_2d(b, map_b, n0, k * BK, &m.full[ring.stage]);
  tma_load_2d(b + B_HALF, map_b, n0 + 64, k * BK, &m.full[ring.stage]);
}

// Pass 1 work item -> (row tile, column tile, split, slices [kb, ke)).
// kernels/cur_matmul/cur_matmul.py::work_items mirrors this.
__device__ __forceinline__ void decode(int it, int tiles_m, int tiles_n,
                                       int splits, int kt, int& mt, int& nt,
                                       int& s, int& kb, int& ke) {
  mt = it % tiles_m;
  const int rest = it / tiles_m;
  nt = rest % tiles_n;
  s = rest / tiles_n;
  kb = (int)((long)s * kt / splits);
  ke = (int)((long)(s + 1) * kt / splits);
}

// Pass 1: ws[s] (M x N, f32) = x[:, slices of split s] @ CU[those rows, :].
// Persistent: block b takes work items b, b + gridDim.x, ...
__global__ void __launch_bounds__(THREADS, 1)
pass1_kernel(const __grid_constant__ CUtensorMap map_x,
             const __grid_constant__ CUtensorMap map_cu,
             float* __restrict__ ws, int M, int N, int kt, int tiles_m,
             int tiles_n, int splits) {
  extern __shared__ unsigned char smem_raw[];
  Smem m = carve<STAGES1>(smem_raw, STAGES1, 0);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int items = tiles_m * tiles_n * splits;
  Ring<STAGES1> ring;
  if (wg == 0) {
    if (tid == 0) {
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        int mt, nt, s, kb, ke;
        decode(it, tiles_m, tiles_n, splits, kt, mt, nt, s, kb, ke);
        for (int k = kb; k < ke; ++k) {
          load_b(m, ring, &map_cu, nt * BN, k, A_BYTES);
          tma_load_2d(m.a + ring.stage * A_BYTES, &map_x, k * BK, mt * BM,
                      &m.full[ring.stage]);
          ring.next();
        }
      }
    }
    return;
  }
  const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int mt, nt, s, kb, ke;
    decode(it, tiles_m, tiles_n, splits, kt, mt, nt, s, kb, ke);
    float acc[64];
    mainloop(acc, m, ring, kb, ke, lane, [&](int, int st) {
      return m.a + st * A_BYTES + cw * 64 * 128;
    });
    // acc[4j + 2h + e]: row warp * 16 + lane / 4 + 8h, column
    // 8j + 2 (lane % 4) + e of this warpgroup's 64 x 128 tile
    float* dst = ws + (long)s * M * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = nt * BN + j * 8 + (lane % 4) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * BM + cw * 64 + warp * 16 + lane / 4 + 8 * h;
        if (row < M && col < N)   // N % 8 == 0: col + 1 < N too
          *reinterpret_cast<float2*>(dst + (long)row * N + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// Pass 2: y = t @ R. Block b owns row tile b % tiles_m and keeps all of
// its rows of t (128 x r, kt slices) in shared memory, loaded once; it
// walks column tiles b / tiles_m, + per_m, ..., so only R streams through
// the ring. The epilogue rounds to bf16 into swizzled shared memory and
// stores 64 x 64 boxes with TMA, overlapping the next tile's loads.
__global__ void __launch_bounds__(THREADS, 1)
pass2_kernel(const __grid_constant__ CUtensorMap map_t,
             const __grid_constant__ CUtensorMap map_r,
             const __grid_constant__ CUtensorMap map_y, int kt, int tiles_m,
             int tiles_n, int per_m) {
  extern __shared__ unsigned char smem_raw[];
  Smem m = carve<STAGES2>(smem_raw, kt, 2 * OUT_BYTES);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int mt = blockIdx.x % tiles_m, g = blockIdx.x / tiles_m;
  Ring<STAGES2> ring;
  if (wg == 0) {
    if (tid == 0) {
      mbar_arrive_expect_tx(m.a_full, kt * A_BYTES);
      for (int k = 0; k < kt; ++k)
        tma_load_2d(m.a + k * A_BYTES, &map_t, k * BK, mt * BM, m.a_full);
      for (int nt = g; nt < tiles_n; nt += per_m)
        for (int k = 0; k < kt; ++k) {
          load_b(m, ring, &map_r, nt * BN, k, 0);
          ring.next();
        }
    }
    return;
  }
  const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
  unsigned char* out = m.out + cw * OUT_BYTES;
  mbar_wait(m.a_full, 0);
  for (int nt = g; nt < tiles_n; nt += per_m) {
    float acc[64];
    mainloop(acc, m, ring, 0, kt, lane, [&](int k, int) {
      return m.a + k * A_BYTES + cw * 64 * 128;
    });
    if (tid == 0) bulk_wait_read_all();   // the previous tile's stores
    bar_sync(1 + cw, 128);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + lane / 4 + 8 * h;
        // the 128-byte swizzle TMA expects: 16-byte chunk ^ (row % 8)
        *reinterpret_cast<uint32_t*>(
            out + (j >> 3) * OUT_HALF + row * 128 +
            (((j & 7) ^ (row & 7)) << 4) + (lane % 4) * 4) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    fence_proxy_async();
    bar_sync(1 + cw, 128);
    if (tid == 0) {
      tma_store_2d(&map_y, out, nt * BN, mt * BM + cw * 64);
      tma_store_2d(&map_y, out + OUT_HALF, nt * BN + 64, mt * BM + cw * 64);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();
}

// t = bf16(ws[0] + ws[1] + ... + ws[splits - 1]), in that order; n4 float4s.
__global__ void reduce_kernel(const float4* __restrict__ ws,
                              uint2* __restrict__ t, long n4, int splits) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    float4 a = ws[i];
    for (int s = 1; s < splits; ++s) {
      const float4 b = ws[(long)s * n4 + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    t[i] = make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
  }
}

// Map of a row-major bf16 (rows x cols) matrix, boxes of box_rows x
// box_cols, 128-byte swizzle, zero fill out of bounds.
bool map_2d(CUtensorMap* map, const void* base, int rows, int cols,
            int box_rows, int box_cols) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint32_t box[2] = {(uint32_t)box_cols, (uint32_t)box_rows};
  return make_map(map, base, 2, dims, box);
}

// The shared-memory limit of both kernels, set once per device.
int set_smem_limits() {
  static unsigned done = 0;   // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && (done >> dev) & 1u) return 0;
  err = cudaFuncSetAttribute(pass1_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(STAGES1, STAGES1, 0));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pass2_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(MAX_KT, STAGES2, 2 * OUT_BYTES));
  if (err != cudaSuccess) return (int)err;
  if (dev < 32) done |= 1u << dev;
  return 0;
}

int launch(const void* x, const void* cu, const void* r, void* y, void* ws,
           void* t, int M, int m, int rk, int n, int splits, int grid1,
           int grid2, int grid_r, cudaStream_t stream) {
  const int kt2 = (rk + BK - 1) / BK;
  if (kt2 > MAX_KT || grid2 % ((M + BM - 1) / BM) != 0)
    return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mx, mcu, mt, mr, my;
  if (!map_2d(&mx, x, M, m, BM, BK) || !map_2d(&mcu, cu, m, rk, BK, 64) ||
      !map_2d(&mt, t, M, rk, BM, BK) || !map_2d(&mr, r, rk, n, BK, 64) ||
      !map_2d(&my, y, M, n, 64, 64))
    return (int)cudaErrorInvalidValue;
  int e = set_smem_limits();
  if (e != 0) return e;
  const int tiles_m = (M + BM - 1) / BM;
  pass1_kernel<<<grid1, THREADS, smem_bytes(STAGES1, STAGES1, 0), stream>>>(
      mx, mcu, static_cast<float*>(ws), M, rk, (m + BK - 1) / BK, tiles_m,
      (rk + BN - 1) / BN, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<grid_r, 256, 0, stream>>>(
      static_cast<const float4*>(ws), static_cast<uint2*>(t),
      (long)M * rk / 4, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  pass2_kernel<<<grid2, THREADS, smem_bytes(kt2, STAGES2, 2 * OUT_BYTES),
                 stream>>>(
      mt, mr, my, kt2, tiles_m, (n + BN - 1) / BN, grid2 / tiles_m);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
// The `fused` body (f32, and bf16 shapes TMA cannot describe).
extern "C" int cur_matmul_launch(const void* x, const void* cu, const void* r,
                                 void* y, int M, int m, int rk, int n,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, cu, r, y, M, m, rk, n, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, cu, r, y, M, m, rk, n, s);
  return (int)cudaErrorInvalidValue;
}

// The two-pass bf16 body. ws: splits x M x rk f32; t: M x rk bf16; the
// wrapper's plan gives splits and the three grids. Returns a cudaError_t.
extern "C" int cur_matmul_tc_launch(const void* x, const void* cu,
                                    const void* r, void* y, void* ws, void* t,
                                    int M, int m, int rk, int n, int splits,
                                    int grid1, int grid2, int grid_r,
                                    void* stream) {
  return tc::launch(x, cu, r, y, ws, t, M, m, rk, n, splits, grid1, grid2,
                    grid_r, static_cast<cudaStream_t>(stream));
}
