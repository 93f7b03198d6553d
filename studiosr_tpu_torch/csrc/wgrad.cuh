// Weight gradients of the backward kernels B7 (mlp_bwd.cu) and B8
// (attn_bwd.cu): dW = A^T B over all token rows, and the column sums of B
// (the bias gradient), deterministically.
//
// The TPU kernels sum per-program partials by revisiting an output block
// along a sequential grid. Blocks on the card run in no order, so the rows
// are split into S ranges: block (m-tile, n-tile, s) multiplies its
// 128 x 128 tile over range s into an f32 partial of its own, and a second
// pass sums the S partials in a fixed order. No atomics: the result is the
// same bits from run to run.
//
// A block stages 32-row chunks of A and B by 16-byte cp.async into two
// buffers (the next chunk in flight while the current one is multiplied),
// one barrier per chunk. bf16 runs on the tensor cores, each warp a 32 x 64
// piece (two A and four B fragments feed eight products per 16 rows); f32
// runs on the FMA pipes, 8 x 8 outputs a thread. The operands' row strides
// must be multiples of 8 elements and their rows 16-byte aligned; the
// columns past M (or N) of the last tile are read as they are (the caller
// leaves 2 WG_BM elements of slack after the last matrix) and their outputs
// are dropped. K must be a multiple of WG_BK.
#pragma once

#include "swin_common.cuh"

constexpr int WG_BM = 128;  // tile rows (of dW) and columns
constexpr int WG_BK = 32;   // token rows a chunk
constexpr int WG_LDS = WG_BM + SB_SKEW;
constexpr int WG_TARGET_BLOCKS = 264;  // two blocks on each of the H100's 132 SMs

template <typename T>
__host__ __device__ constexpr size_t wgrad_smem_bytes() {
  return 4 * WG_BK * WG_LDS * sizeof(T);  // two buffers of an A and a B chunk
}

struct WgradPlan {
  int splits, krows;     // S ranges of krows rows (a multiple of WG_BK)
  long long part_elems;  // f32 partials: S * M * N, then S * N column sums
};

__host__ inline WgradPlan wgrad_plan(long long K, int M, int N) {
  const int tiles = ((M + WG_BM - 1) / WG_BM) * ((N + WG_BM - 1) / WG_BM);
  const long long chunks = (K + WG_BK - 1) / WG_BK;
  long long s = (WG_TARGET_BLOCKS + tiles - 1) / tiles;
  if (s > chunks) s = chunks;
  if (s < 1) s = 1;
  WgradPlan p;
  p.krows = (int)((chunks + s - 1) / s) * WG_BK;
  p.splits = (int)((K + p.krows - 1) / p.krows);
  if (p.splits < 1) p.splits = 1;
  p.part_elems = (long long)p.splits * M * N + (long long)p.splits * N;
  return p;
}

// Issue the copies of the chunk at row k0 of A's columns [m0, m0 + WG_BM)
// and B's columns [n0, n0 + WG_BM) into As / Bs, as one cp.async group.
template <typename T>
__device__ __forceinline__ void wgrad_stage(T* As, T* Bs, const T* A, int lda, const T* B, int ldb, long long k0,
                                            int m0, int n0) {
  constexpr int PER = 16 / (int)sizeof(T);
  constexpr int ROW = WG_BM / PER;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < WG_BK * ROW; i += SB_THREADS) {
    const int r = i / ROW, c = (i % ROW) * PER;
    cp_async16(As + r * WG_LDS + c, A + (k0 + r) * lda + m0 + c);
    cp_async16(Bs + r * WG_LDS + c, B + (k0 + r) * ldb + n0 + c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// part[s][m][n] = sum over rows k of range s of A[k * lda + m] * B[k * ldb + n];
// colpart[s][n] = sum of B[k * ldb + n] over the same rows (m-tile 0 only).
template <typename T>
__global__ void __launch_bounds__(SB_THREADS) wgrad_kernel(const T* __restrict__ A, int lda, const T* __restrict__ B,
                                                          int ldb, long long K, int M, int N, int krows,
                                                          float* __restrict__ part, float* __restrict__ colpart) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value;
  constexpr int BUF = WG_BK * WG_LDS;
  T* stage = (T*)smem;  // buffer b: A chunk at stage + 2 b BUF, B chunk at stage + (2 b + 1) BUF
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * WG_BM, s = blockIdx.z;
  const long long kb = (long long)s * krows;
  const int nchunks = (int)(((kb + krows < K ? kb + krows : K) - kb) / WG_BK);
  const bool sums = blockIdx.x == 0 && colpart != nullptr;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;  // the warp's piece (tensor cores)
  const int tx = tid & 15, ty = tid >> 4;                  // the thread's outputs (FMA)
  AccFrag frag[2][4];
  float acc[8][8] = {};
  if constexpr (tc) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(frag[i][j], 0.f);
  }
  float colsum = 0.f;
  wgrad_stage(stage, stage + BUF, A, lda, B, ldb, kb, m0, n0);
  for (int t = 0; t < nchunks; ++t) {
    cp_async_wait_all();
    __syncthreads();  // chunk t is in; every thread is done with chunk t - 1's buffers
    if (t + 1 < nchunks) {
      T* next = stage + ((t + 1) & 1) * 2 * BUF;
      wgrad_stage(next, next + BUF, A, lda, B, ldb, kb + (long long)(t + 1) * WG_BK, m0, n0);
    }
    const T* As = stage + (t & 1) * 2 * BUF;
    const T* Bs = As + BUF;
    if constexpr (tc) {
#pragma unroll
      for (int ks = 0; ks < WG_BK / 16; ++ks) {
        // A^T: element (m, k) of the product's left operand sits at As[k][m]
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], As + ks * 16 * WG_LDS + wm + i * 16, WG_LDS);
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(bf[j], Bs + ks * 16 * WG_LDS + wn + j * 16, WG_LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(frag[i][j], af[i], bf[j], frag[i][j]);
      }
    } else {
      for (int k = 0; k < WG_BK; ++k) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = to_f32(As[k * WG_LDS + ty + 16 * i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = to_f32(Bs[k * WG_LDS + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (sums && tid < WG_BM)
      for (int k = 0; k < WG_BK; ++k) colsum += to_f32(Bs[k * WG_LDS + tid]);
  }
  float* out = part + (size_t)s * M * N;
  if constexpr (tc) {
    __syncthreads();  // the staging buffers become each warp's 16 x 16 output tile
    float* tile = (float*)smem + warp * 256;
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(tile, frag[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int m = m0 + wm + i * 16 + e / 16, n = n0 + wn + j * 16 + e % 16;
          if (m < M && n < N) out[(size_t)m * N + n] = tile[e];
        }
        __syncwarp();
      }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
        if (m < M && n < N) out[(size_t)m * N + n] = acc[i][j];
      }
  }
  if (sums && tid < WG_BM && n0 + tid < N) colpart[(size_t)s * N + n0 + tid] = colsum;
}

// out[i] = sum over s < S of part[s * n + i], in order of s.
__global__ void reduce_parts_kernel(const float* __restrict__ part, int S, long long n, float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += part[(size_t)s * n + i];
    out[i] = v;
  }
}

static cudaError_t reduce_parts(const float* part, int S, long long n, float* out, cudaStream_t stream) {
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  reduce_parts_kernel<<<blocks, 256, 0, stream>>>(part, S, n, out);
  return cudaGetLastError();
}

// dw (M x N) = A^T B over K rows and, when db is not null, db (N) = the
// column sums of B; `part` holds wgrad_plan(K, M, N).part_elems floats.
template <typename T>
static cudaError_t wgrad(const T* A, int lda, const T* B, int ldb, long long K, int M, int N, float* dw, float* db,
                         float* part, cudaStream_t stream) {
  if (lda % 8 || ldb % 8 || K % WG_BK) return cudaErrorInvalidValue;
  const WgradPlan p = wgrad_plan(K, M, N);
  float* colpart = part + (size_t)p.splits * M * N;
  cudaError_t err = allow_smem(wgrad_kernel<T>, wgrad_smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid((M + WG_BM - 1) / WG_BM, (N + WG_BM - 1) / WG_BM, p.splits);
  wgrad_kernel<T><<<grid, SB_THREADS, wgrad_smem_bytes<T>(), stream>>>(A, lda, B, ldb, K, M, N, p.krows, part,
                                                                       db ? colpart : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = reduce_parts(part, p.splits, (long long)M * N, dw, stream);
  if (err != cudaSuccess || !db) return err;
  return reduce_parts(colpart, p.splits, N, db, stream);
}
