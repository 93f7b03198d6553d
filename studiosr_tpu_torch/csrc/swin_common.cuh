// Device building blocks shared by the Swin kernels (B1 swin_block.cu, B5
// window_attention.cu, B6 mlp_block.cu, B7 mlp_bwd.cu, B8 attn_bwd.cu).
//
// One thread block of 256 threads works on a 64-row tile (one 8 x 8 window
// or 64 token rows). gemm64 multiplies a 64-row operand in shared memory by
// a weight matrix that streams from L2 in 32 x 64 chunks through two
// shared-memory buffers (16-byte cp.async, the next chunk in flight while
// the current one is multiplied); gemm64_smem multiplies two operands that
// are both in shared memory. f32 runs the products on the FMA pipes; bf16
// runs them on the tensor cores (wmma 16x16x16, f32 accumulation) and hands
// the accumulator elements to the epilogue in registers (FragMap).
//
// Weights reach gemm64 packed: K rows (a multiple of SB_KC) by a multiple of
// 64 columns, zero outside the source matrix, so every staged chunk is
// whole and 16-byte aligned. pack_segments lays any set of (strided)
// sub-matrices out that way.
#pragma once

#include <mma.h>

#include <type_traits>
#include <vector>

#include "common.cuh"

constexpr int SB_THREADS = 256;
constexpr int SB_WS = 8;
constexpr int SB_TOK = SB_WS * SB_WS;  // tokens per window; the GEMM rows
constexpr int SB_KC = 32;              // rows of B staged per step; K pads to a multiple
// Row strides of shared-memory operands are padded by SB_SKEW elements so
// that the 16 rows of a wmma fragment fall on different banks (an unpadded
// stride of 64 or 192 bf16 elements is a multiple of 128 bytes, and every
// row of a fragment would hit the same 8 banks).
constexpr int SB_SKEW = 8;
constexpr int SB_BL = 64 + SB_SKEW;      // stride of the staged B chunk
constexpr int SB_TL = 64 + SB_SKEW / 2;  // stride of the f32 scores

__host__ __device__ inline int pad8(int v) { return (v + 7) & ~7; }
__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline int pad32(int v) { return (v + 31) & ~31; }
__host__ __device__ inline int pad64(int v) { return (v + 63) & ~63; }
__host__ __device__ inline size_t align32(size_t v) { return (v + 31) & ~(size_t)31; }

// Bytes of the two staging buffers gemm64 needs.
template <typename T>
__host__ __device__ constexpr size_t staging_bytes() {
  return 2 * SB_KC * SB_BL * sizeof(T);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Issue the copy of the 32 x 64 chunk of B at (k0, n0) (row stride ldb,
// 16-byte aligned rows) into dst (row stride SB_BL), as one cp.async group.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* B, int ldb, int k0, int n0) {
  constexpr int PIECES = 64 * (int)sizeof(T) / 16;  // 16-byte pieces per chunk row
  constexpr int PER = 16 / (int)sizeof(T);
  for (int i = threadIdx.x; i < SB_KC * PIECES; i += SB_THREADS) {
    const int r = i / PIECES, c = (i % PIECES) * PER;
    cp_async16(dst + r * SB_BL + c, B + (size_t)(k0 + r) * ldb + n0 + c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// f32 micro-kernel: the thread's 4 x 4 outputs (rows ty + 16i, columns
// tx + 16j) over k in [0, kend): acc += A(r, k) * B(k, n).
template <typename AF, typename BF>
__device__ __forceinline__ void fma_steps(float (&acc)[4][4], AF a_at, int kend, BF b_at) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int kk = 0; kk < kend; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = to_f32(a_at(ty + 16 * i, kk));
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = to_f32(b_at(kk, tx + 16 * j));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename EP>
__device__ __forceinline__ void fma_epilogue(const float (&acc)[4][4], int n0, int N, EP epi) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) epi(ty + 16 * i, n, acc[i][j]);
    }
}

using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;
static_assert(AccFrag::num_elements == 8, "FragMap packs 8 accumulator elements");

// Where each of the 8 accumulator elements a thread holds sits in its
// 16 x 16 fragment: one byte per element, row in the high and column in
// the low nibble, four bytes a word. wmma leaves the layout unspecified, so
// read_frag_map reads it once per thread from a fragment loaded from an
// index table.
struct FragMap {
  uint32_t w[2];
};

// `table`: 256 floats of shared memory, free until the call returns.
// Called by every thread of the block.
__device__ inline FragMap read_frag_map(float* table) {
  for (int i = threadIdx.x; i < 256; i += SB_THREADS) table[i] = (float)i;
  __syncthreads();
  AccFrag f;
  nvcuda::wmma::load_matrix_sync(f, table, 16, nvcuda::wmma::mem_row_major);
  FragMap m{{0u, 0u}};
#pragma unroll
  for (int i = 0; i < 8; ++i) m.w[i >> 2] |= (uint32_t)f.x[i] << (8 * (i & 3));
  __syncthreads();
  return m;
}

// The frag map a bf16 block needs (f32 blocks do not use one); `table` as
// for read_frag_map.
template <typename T>
__device__ inline FragMap frag_map_for(float* table) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) return read_frag_map(table);
  return FragMap{{0u, 0u}};
}

// Warp w's share of a 64 x 64 output tile on the tensor cores: rows
// 16 (w % 4) and the two column fragments 2 (w / 4), 2 (w / 4) + 1.
// After the K loop each thread hands its accumulator elements straight to
// the element-wise epilogue, for n0 + column < N.
template <typename EP>
__device__ __forceinline__ void tc_epilogue(const AccFrag (&acc)[2], const FragMap& map, int n0, int N, EP epi) {
  const int warp = threadIdx.x >> 5, mf = warp & 3, nf = (warp >> 2) * 2;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int code = (map.w[i >> 2] >> (8 * (i & 3))) & 0xff;
      const int n = n0 + (nf + j) * 16 + (code & 15);
      if (n < N) epi(mf * 16 + (code >> 4), n, acc[j].x[i]);
    }
}

// acc(r, n) = sum_k A[r * lda + k] * B[k * ldb + n] over the 64 token rows
// and n < N, handed to epi(r, n, acc). B is packed: KP rows (a multiple of
// SB_KC) by pad64(N) columns, zero outside the product. The (n-tile,
// K-chunk) rounds run as one sequence through the two buffers of bst, one
// barrier each. f32 runs on the FMA pipes. bf16 runs on the tensor cores
// and needs A's rows 32-byte aligned, lda a multiple of 8 and A's columns
// past the true K zero up to KP. Ends with a barrier.
template <typename T, typename EP>
__device__ void gemm64(const T* A, int lda, int KP, int N, const T* B, int ldb, T* bst, const FragMap& map, EP epi) {
  using namespace nvcuda;
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value;
  constexpr int BUF = SB_KC * SB_BL;
  const int warp = threadIdx.x >> 5, mf = warp & 3, nf = (warp >> 2) * 2;
  const int nk = KP / SB_KC, rounds = (N + 63) / 64 * nk;
  float acc[4][4] = {};
  AccFrag frag[2];
  if constexpr (tc) {
    wmma::fill_fragment(frag[0], 0.f);
    wmma::fill_fragment(frag[1], 0.f);
  }
  stage_chunk(bst, B, ldb, 0, 0);
  for (int t = 0; t < rounds; ++t) {
    const int kc = t % nk, n0 = t / nk * 64, k0 = kc * SB_KC;
    cp_async_wait_all();
    __syncthreads();  // chunk t is in; every thread is done with chunk t - 1's buffer
    if (t + 1 < rounds) stage_chunk(bst + ((t + 1) & 1) * BUF, B, ldb, (t + 1) % nk * SB_KC, (t + 1) / nk * 64);
    const T* b = bst + (t & 1) * BUF;
    if constexpr (tc) {
#pragma unroll
      for (int ks = 0; ks < SB_KC / 16; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, A + mf * 16 * lda + k0 + ks * 16, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, b + ks * 16 * SB_BL + (nf + j) * 16, SB_BL);
          wmma::mma_sync(frag[j], af, bf, frag[j]);
        }
      }
    } else {
      fma_steps(acc, [&](int r, int k) { return A[r * lda + k0 + k]; }, SB_KC,
                [&](int kk, int n) { return b[kk * SB_BL + n]; });
    }
    if (kc == nk - 1) {  // the n-tile is complete
      if constexpr (tc) {
        tc_epilogue(frag, map, n0, N, epi);
        wmma::fill_fragment(frag[0], 0.f);
        wmma::fill_fragment(frag[1], 0.f);
      } else {
        fma_epilogue(acc, n0, N, epi);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
    }
  }
  __syncthreads();
}

// The same product with both operands already in shared memory, read in
// place: A(r, k) = A[r * lda + k] (ALayout row_major) or A[k * lda + r]
// (col_major); B(k, n) = B[k * ldb + n] (BLayout row_major) or
// B[n * ldb + k] (col_major). 64 rows, N <= 64, K a multiple of 16, lda
// and ldb multiples of 8. Ends with a barrier.
template <typename ALayout, typename BLayout, typename T, typename EP>
__device__ void gemm64_smem(const T* A, int lda, const T* B, int ldb, int K, int N, const FragMap& map, EP epi) {
  using namespace nvcuda;
  constexpr bool arow = std::is_same<ALayout, wmma::row_major>::value;
  constexpr bool brow = std::is_same<BLayout, wmma::row_major>::value;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = threadIdx.x >> 5, mf = warp & 3, nf = (warp >> 2) * 2;
    AccFrag frag[2];
    wmma::fill_fragment(frag[0], 0.f);
    wmma::fill_fragment(frag[1], 0.f);
    if (nf * 16 < N) {
      for (int ks = 0; ks < K / 16; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> af;
        wmma::load_matrix_sync(af, arow ? A + mf * 16 * lda + ks * 16 : A + ks * 16 * lda + mf * 16, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> bf;
          const int c = (nf + j) * 16;
          wmma::load_matrix_sync(bf, brow ? B + ks * 16 * ldb + c : B + c * ldb + ks * 16, ldb);
          wmma::mma_sync(frag[j], af, bf, frag[j]);
        }
      }
    }
    tc_epilogue(frag, map, 0, N, epi);
  } else {
    float acc[4][4] = {};
    fma_steps(acc, [&](int r, int k) { return arow ? A[r * lda + k] : A[k * lda + r]; }, K,
              [&](int k, int n) { return brow ? B[k * ldb + n] : B[n * ldb + k]; });
    fma_epilogue(acc, 0, N, epi);
  }
  __syncthreads();
}

// LayerNorm (eps 1e-5) of the 64 rows of xs (stride C) into out (stride
// ldo); one warp per row.
template <typename T>
__device__ void layernorm_rows(const T* xs, int C, const float* g, const float* b, T* out, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < SB_TOK; r += SB_THREADS / 32) {
    const T* row = xs + r * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f32(row[c]);
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dv = to_f32(row[c]) - mean;
      v += dv * dv;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + 1e-5f);
    for (int c = lane; c < C; c += 32) out[r * ldo + c] = from_f32<T>((to_f32(row[c]) - mean) * rstd * g[c] + b[c]);
  }
}

// Mean and 1/std (eps 1e-5) of one row of C values, computed by one warp;
// every lane gets both.
template <typename T>
__device__ __forceinline__ void row_stats(const T* row, int C, float& mean, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32(row[c]);
  mean = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dv = to_f32(row[c]) - mean;
    v += dv * dv;
  }
  rstd = rsqrtf(warp_sum(v) / C + 1e-5f);
}

// Row stride, in elements of T, of the probabilities written over the
// scores (row r of both starts at the same byte).
template <typename T>
__host__ __device__ constexpr int probs_ld() {
  return SB_TL * (int)(sizeof(float) / sizeof(T));
}

// Row softmax of the 64 x 64 f32 scores in sc, in place: row r becomes
// exp(s - max) rounded to T (the operand of the AV product, stride
// probs_ld<T>()), and inv[r] <- 1 / (f32 row sum). One warp per row, so a
// row is read whole before any lane of its warp writes it.
template <typename T>
__device__ void softmax_rows(float* sc, float* inv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* probs = reinterpret_cast<T*>(sc);
  constexpr int LDP = probs_ld<T>();
  for (int r = warp; r < SB_TOK; r += SB_THREADS / 32) {
    const float a = sc[r * SB_TL + lane], b = sc[r * SB_TL + lane + 32];
    const float m = warp_max(fmaxf(a, b));
    const float ea = expf(a - m), eb = expf(b - m);
    const float s = warp_sum(ea + eb);
    __syncwarp();
    probs[r * LDP + lane] = from_f32<T>(ea);
    probs[r * LDP + lane + 32] = from_f32<T>(eb);
    if (lane == 0) inv[r] = 1.f / s;
  }
}

// Region of coordinate i of the rolled map along an axis of length n:
// [0, n - ws) -> 0, [n - ws, n - shift) -> 1, [n - shift, n) -> 2.
__device__ __forceinline__ int region_id(int i, int n, int shift) {
  return i < n - SB_WS ? 0 : (i < n - shift ? 1 : 2);
}

// Element offset, in a (B, H, W, C) map, of token t of window wi (row-major
// windows of image img) of the map rolled by -shift: token (h, w) of the
// rolled map is read from ((h + shift) mod H, (w + shift) mod W).
__device__ __forceinline__ size_t window_token_offset(int img, int wi, int t, int H, int W, int C, int shift) {
  const int nwx = W / SB_WS;
  const int hs = ((wi / nwx) * SB_WS + t / SB_WS + shift) % H;
  const int ws = ((wi % nwx) * SB_WS + t % SB_WS + shift) % W;
  return (((size_t)img * H + hs) * W + ws) * C;
}

// Mask region of token t of window wi of the rolled map (0 without shift).
__device__ __forceinline__ int window_token_region(int wi, int t, int H, int W, int shift) {
  if (!shift) return 0;
  const int nwx = W / SB_WS;
  return 3 * region_id((wi / nwx) * SB_WS + t / SB_WS, H, shift) + region_id((wi % nwx) * SB_WS + t % SB_WS, W, shift);
}

// The two above at any window ws (window_attention.cu and attn_bwd.cu at
// windows 2..8, the tokens of a window the first ws^2 of its 64 rows).
__device__ __forceinline__ size_t window_token_offset_ws(int img, int wi, int t, int H, int W, int C, int shift,
                                                         int ws) {
  const int nwx = W / ws;
  const int y = ((wi / nwx) * ws + t / ws + shift) % H;
  const int x = ((wi % nwx) * ws + t % ws + shift) % W;
  return (((size_t)img * H + y) * W + x) * C;
}

__device__ __forceinline__ int window_token_region_ws(int wi, int t, int H, int W, int shift, int ws) {
  if (!shift) return 0;
  const int nwx = W / ws, y = (wi / nwx) * ws + t / ws, x = (wi % nwx) * ws + t % ws;
  return 3 * (y < H - ws ? 0 : (y < H - shift ? 1 : 2)) + (x < W - ws ? 0 : (x < W - shift ? 1 : 2));
}

template <typename T>
__device__ __forceinline__ void zero_columns(T* buf, int ld, int from, int to) {
  const int width = to - from;
  for (int i = threadIdx.x; i < SB_TOK * width; i += SB_THREADS) buf[(i / width) * ld + from + i % width] = from_f32<T>(0.f);
}

__device__ __forceinline__ float gelu_f(float v) { return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)); }

// d gelu / dv = Phi(v) + v phi(v).
__device__ __forceinline__ float gelu_grad_f(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) + v * 0.39894228040143268f * expf(-0.5f * v * v);
}

// -- weight packing ------------------------------------------------------------

// One strided sub-matrix to pack: dst[dst_off + k * ldd + n] = src[k * sk +
// n * sn] for k < K, n < N (elements of T).
struct PackSeg {
  const void* src;
  long long dst_off;
  int ldd, K, N, sk, sn;
};

constexpr int PACK_MAX_SEGS = 32;
struct PackTable {
  PackSeg seg[PACK_MAX_SEGS];
};

template <typename T>
__global__ void pack_kernel(PackTable tab, T* __restrict__ dst) {
  const PackSeg s = tab.seg[blockIdx.y];
  const T* src = (const T*)s.src;
  const int total = s.K * s.N;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int k = i / s.N, n = i % s.N;
    dst[s.dst_off + (long long)k * s.ldd + n] = src[(long long)k * s.sk + (long long)n * s.sn];
  }
}

// Zero `total` elements of dst, then copy every segment in; on `stream`.
template <typename T>
static cudaError_t pack_segments(const std::vector<PackSeg>& segs, T* dst, size_t total, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(dst, 0, total * sizeof(T), stream);
  if (err != cudaSuccess) return err;
  for (size_t first = 0; first < segs.size(); first += PACK_MAX_SEGS) {
    PackTable tab{};
    const int n = (int)(segs.size() - first < (size_t)PACK_MAX_SEGS ? segs.size() - first : PACK_MAX_SEGS);
    for (int i = 0; i < n; ++i) tab.seg[i] = segs[first + i];
    pack_kernel<T><<<dim3(16, n), 256, 0, stream>>>(tab, dst);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Opt a kernel in to `bytes` of dynamic shared memory, preferring shared
// memory over L1.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
}

// -- window attention pieces shared by B5 and B8 -------------------------------

// Packed q|k|v weights, one kc x nq block per head: head h's q, k and v in
// columns [0, DP), [DP, 2 DP), [2 DP, 3 DP) (zero past d), with kc =
// pad32(C), nq = pad64(3 DP), DP = pad16(d). Appends the segments taking
// them from wqkv (C, 3C) with q | k | v column blocks.
template <typename T>
static void qkv_head_segments(std::vector<PackSeg>& segs, const T* wqkv, int C, int heads, long long off) {
  const int d = C / heads, DP = pad16(d), kc = pad32(C), nq = pad64(3 * DP);
  for (int h = 0; h < heads; ++h)
    for (int part = 0; part < 3; ++part)
      segs.push_back(PackSeg{wqkv + part * C + h * d, off + (long long)h * kc * nq + part * DP, nq, C, d, 3 * C, 1});
}

// q|k|v of head h into qkvh (64 rows, stride ldq): column part * DP + j
// holds part (q, k, v) of head h's column j, plus its bias; q is scaled by
// 1/sqrt(d) (the weights are unscaled); columns j >= d are zero. lnb: the
// LayerNorm output (stride lda, zero past C up to pad32(C)).
template <typename T>
__device__ void head_qkv(const T* lnb, int lda, const T* packed_h, const float* bqkv, int C, int heads, int h,
                         T* qkvh, int ldq, T* bst, const FragMap& map) {
  const int d = C / heads, DP = pad16(d);
  const float qscale = rsqrtf((float)d);
  gemm64<T>(lnb, lda, pad32(C), 3 * DP, packed_h, pad64(3 * DP), bst, map, [&](int r, int n, float acc) {
    const int part = n >= 2 * DP ? 2 : (n >= DP ? 1 : 0), j = n - part * DP;
    float v = 0.f;
    if (j < d) {
      v = acc + bqkv[part * C + h * d + j];
      if (part == 0) v *= qscale;
    }
    qkvh[r * ldq + n] = from_f32<T>(v);
  });
}
