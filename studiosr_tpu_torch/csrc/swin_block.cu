// B1: the whole Swin transformer block in one pass over the map,
//   z = x + proj(WA(LN1 x)),  y = z + fc2(gelu(fc1(LN2 z))),
// with window attention (WA) over 8 x 8 windows, the relative-position bias
// and, for shifted blocks, the shifted-window mask.
//
// Replaces studiosr_tpu/ops/pallas/swin_block.py::fused_swin_block. It
// computes what the TPU kernel computes, not its Mosaic layout: no
// window-pair score packing, no -1e30 pair bias, no compressed mask rows,
// no half-stripe shift reads. The rounding points follow the TPU kernel:
// LN outputs, q/k/v, probabilities, the attention output, z and the GELU
// output are rounded to the storage type T; sums, LayerNorm and softmax
// statistics are f32.
//
// Design: one thread block of 256 threads per window (1089 windows at the
// main path's 264 x 264 map). The window's working set lives in shared
// memory: x then z (64 x C), the LN output (64 x C), and a region that
// holds the attention output, one head's q|k|v and its scores (overwritten
// in place by its probabilities), and later the 64 x hidden MLP
// activation. The block loops over heads, so q/k/v never exist for all
// heads at once. Every weight product is a 64-row GEMM (gemm64) whose B
// operand streams from L2 in 32 x 64 chunks through two shared-memory
// buffers (16-byte cp.async, the next chunk in flight while the current one
// is multiplied). So that every chunk is whole and 16-byte aligned, a small
// pack kernel first lays the four weight matrices out in one zero-padded
// scratch (SwinPack; about 0.66 MB in bf16, L2-resident). q k^T and p v
// read k and v in place (gemm64_smem). f32 blocks run the products on the
// FMA pipes; bf16 blocks run them on the tensor cores (wmma 16x16x16, f32
// accumulation). Operand K dimensions are padded with zeros (C 180 -> 192,
// head dim 30 -> 32, hidden 360 -> 384). bf16 epilogues read the
// accumulator fragments in registers (FragMap), so no f32 output tile
// passes through shared memory. At C 180 a bf16 block takes 114,688 bytes
// of shared memory and at most 128 registers a thread: two windows per SM.
//
// The shift: with shift s, token (h, w) of the rolled map is read from
// ((h + s) mod H, (w + s) mod W) and its output is written back to that
// same source position. That is roll(+s) . block . roll(-s), the linen
// block exactly, so the output stays aligned and the caller keeps no
// rolled-space bookkeeping. The mask is computed per token from its region
// id (ops/windows.py::shift_region_ids holds the same rule against
// calculate_mask) instead of being read from a dense (nW, 64, 64) operand.
//
// Bound on the card: 39.4 GFLOP per launch at the main path's shapes
// against about 50 MB of traffic, so the block is bound by operations
// (tensor-core bf16 rate, about 40 us). This first version is bound by
// latency instead: 16 warps per SM, a barrier per staged K chunk, and
// short dependent wmma chains in the per-head loop of small GEMMs
// (64 x 96 x 192, 64 x 64 x 32, 64 x 32 x 64)
// (scripts/torch_ablate_swin_block.py splits the time). Reading and
// writing the map exactly once is what it keeps from the TPU design.
#include <mma.h>

#include <type_traits>

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

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline int pad32(int v) { return (v + 31) & ~31; }
__host__ __device__ inline int pad64(int v) { return (v + 63) & ~63; }
__host__ __device__ inline size_t align32(size_t v) { return (v + 31) & ~(size_t)31; }

// Shared-memory layout of one window: byte offsets and row strides (in
// elements). K dimensions are padded with zero columns (lnb and attn to
// pad32(C), each of q/k/v to DP = pad16(d), hid to pad32(hidden)), and
// every stride gets SB_SKEW more. bst holds two staged B chunks. The
// scores sc are 64 x SB_TL f32; the probabilities overwrite them in place,
// row r of probabilities (in T) starting where row r of scores starts.
struct SwinSmem {
  size_t xs, lnb, attn, qkvh, sc, inv, rid, hid, bst, total;
  int ld_c, ld_qkv, ld_h;
};

__host__ __device__ inline SwinSmem swin_smem_layout(int C, int heads, int hidden, size_t tsz) {
  SwinSmem L;
  L.ld_c = pad32(C) + SB_SKEW;
  L.ld_qkv = 3 * pad16(C / heads) + SB_SKEW;
  L.ld_h = pad32(hidden) + SB_SKEW;
  size_t o = 0;
  L.xs = o;
  o = align32(o + SB_TOK * C * tsz);
  L.lnb = o;
  o = align32(o + SB_TOK * L.ld_c * tsz);
  const size_t region = o;  // attention phase, then the MLP phase
  L.attn = o;
  o = align32(o + SB_TOK * L.ld_c * tsz);
  L.qkvh = o;
  o = align32(o + SB_TOK * L.ld_qkv * tsz);
  L.sc = o;
  o = align32(o + SB_TOK * SB_TL * sizeof(float));
  L.inv = o;
  o = align32(o + SB_TOK * sizeof(float));
  L.rid = o;
  o = align32(o + SB_TOK * sizeof(int));
  L.hid = region;
  const size_t mlp_end = align32(region + SB_TOK * L.ld_h * tsz);
  L.bst = o > mlp_end ? o : mlp_end;
  L.total = L.bst + 2 * SB_KC * SB_BL * tsz;
  return L;
}

// Packed weights, one scratch per launch (elements of T): qkv, heads
// blocks of kc x nq, head h's q, k and v in columns [0, DP), [DP, 2 DP),
// [2 DP, 3 DP) (zero past d); then proj kc x nc, fc1 kc x nh, fc2 kh x nc.
// kc = pad32(C), kh = pad32(hidden), nq = pad64(3 DP), nc = pad64(C),
// nh = pad64(hidden); zero outside the source matrices, so every staged
// chunk is whole. ops/cuda/swin_block.py::packed_elements mirrors total.
struct SwinPack {
  int kc, kh, nq, nc, nh;
  size_t qkv, proj, fc1, fc2, total;
};

__host__ __device__ inline SwinPack swin_pack_layout(int C, int heads, int hidden) {
  SwinPack P;
  P.kc = pad32(C);
  P.kh = pad32(hidden);
  P.nq = pad64(3 * pad16(C / heads));
  P.nc = pad64(C);
  P.nh = pad64(hidden);
  P.qkv = 0;
  P.proj = (size_t)heads * P.kc * P.nq;
  P.fc1 = P.proj + (size_t)P.kc * P.nc;
  P.fc2 = P.fc1 + (size_t)P.kc * P.nh;
  P.total = P.fc2 + (size_t)P.kh * P.nc;
  return P;
}

template <typename T>
__global__ void swin_pack_kernel(const T* __restrict__ wqkv, const T* __restrict__ wproj, const T* __restrict__ w1,
                                 const T* __restrict__ w2, T* __restrict__ packed, int C, int heads, int hidden) {
  const SwinPack P = swin_pack_layout(C, heads, hidden);
  const int d = C / heads, DP = pad16(d);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < P.total; i += (size_t)gridDim.x * blockDim.x) {
    T v = from_f32<T>(0.f);
    if (i < P.proj) {
      const int h = (int)(i / ((size_t)P.kc * P.nq)), r = (int)(i % ((size_t)P.kc * P.nq));
      const int k = r / P.nq, n = r % P.nq, part = n / DP, j = n % DP;
      if (k < C && part < 3 && j < d) v = wqkv[(size_t)k * 3 * C + part * C + h * d + j];
    } else if (i < P.fc1) {
      const int r = (int)(i - P.proj), k = r / P.nc, n = r % P.nc;
      if (k < C && n < C) v = wproj[(size_t)k * C + n];
    } else if (i < P.fc2) {
      const int r = (int)(i - P.fc1), k = r / P.nh, n = r % P.nh;
      if (k < C && n < hidden) v = w1[(size_t)k * hidden + n];
    } else {
      const int r = (int)(i - P.fc2), k = r / P.nc, n = r % P.nc;
      if (k < hidden && n < C) v = w2[(size_t)k * C + n];
    }
    packed[i] = v;
  }
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
// tx + 16j) over k in [0, kend): acc += A[r][k0 + k] * B(k, n).
template <typename T, typename BF>
__device__ __forceinline__ void fma_steps(float (&acc)[4][4], const T* A, int lda, int k0, int kend, BF b_at) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int kk = 0; kk < kend; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = to_f32(A[(ty + 16 * i) * lda + k0 + kk]);
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
__device__ FragMap read_frag_map(float* table) {
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
// and needs A's rows 32-byte aligned, lda a multiple of 16 and A's columns
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
      fma_steps(acc, A, lda, k0, SB_KC, [&](int kk, int n) { return b[kk * SB_BL + n]; });
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

// The same product with B already in shared memory, read in place:
// B(k, n) = B[k * ldb + n] (Layout row_major) or B[n * ldb + k]
// (col_major). N <= 64, K a multiple of 16, ldb a multiple of 16.
template <typename Layout, typename T, typename EP>
__device__ void gemm64_smem(const T* A, int lda, const T* B, int ldb, int K, int N, const FragMap& map, EP epi) {
  using namespace nvcuda;
  constexpr bool row = std::is_same<Layout, nvcuda::wmma::row_major>::value;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = threadIdx.x >> 5, mf = warp & 3, nf = (warp >> 2) * 2;
    AccFrag frag[2];
    wmma::fill_fragment(frag[0], 0.f);
    wmma::fill_fragment(frag[1], 0.f);
    if (nf * 16 < N) {
      for (int ks = 0; ks < K / 16; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, A + mf * 16 * lda + ks * 16, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, Layout> bf;
          const int c = (nf + j) * 16;
          wmma::load_matrix_sync(bf, row ? B + ks * 16 * ldb + c : B + c * ldb + ks * 16, ldb);
          wmma::mma_sync(frag[j], af, bf, frag[j]);
        }
      }
    }
    tc_epilogue(frag, map, 0, N, epi);
  } else {
    float acc[4][4] = {};
    fma_steps(acc, A, lda, 0, K, [&](int k, int n) { return row ? B[k * ldb + n] : B[n * ldb + k]; });
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

template <typename T>
__device__ __forceinline__ void zero_columns(T* buf, int ld, int from, int to) {
  const int width = to - from;
  for (int i = threadIdx.x; i < SB_TOK * width; i += SB_THREADS) buf[(i / width) * ld + from + i % width] = from_f32<T>(0.f);
}

template <typename T>
__global__ void __launch_bounds__(SB_THREADS, 2) swin_block_kernel(
    const T* __restrict__ x, T* __restrict__ out, int H, int W, int C, int heads, int hidden, int shift,
    const float* __restrict__ ln1_w, const float* __restrict__ ln1_b, const float* __restrict__ bqkv,
    const float* __restrict__ bproj, const float* __restrict__ relbias, const float* __restrict__ ln2_w,
    const float* __restrict__ ln2_b, const float* __restrict__ b1, const float* __restrict__ b2,
    const T* __restrict__ packed) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SwinSmem L = swin_smem_layout(C, heads, hidden, sizeof(T));
  const SwinPack P = swin_pack_layout(C, heads, hidden);
  T* xs = (T*)(smem + L.xs);
  T* lnb = (T*)(smem + L.lnb);
  T* attn = (T*)(smem + L.attn);
  T* qkvh = (T*)(smem + L.qkvh);
  float* sc = (float*)(smem + L.sc);
  T* probs = (T*)sc;  // written over the scores by softmax_rows
  float* inv = (float*)(smem + L.inv);
  int* rid = (int*)(smem + L.rid);
  T* hid = (T*)(smem + L.hid);
  T* bst = (T*)(smem + L.bst);

  const int tid = threadIdx.x;
  const int d = C / heads, DP = pad16(d);
  const int LC = L.ld_c, LQ = L.ld_qkv, LH = L.ld_h;
  const int nwx = W / SB_WS, nwin = (H / SB_WS) * nwx;
  const int img = blockIdx.x / nwin, wi = blockIdx.x % nwin;
  const int wy = wi / nwx, wx = wi % nwx;
  // Element offset of token t's source position (see the shift note above).
  auto src = [&](int t) -> size_t {
    const int hs = (wy * SB_WS + t / SB_WS + shift) % H;
    const int ws = (wx * SB_WS + t % SB_WS + shift) % W;
    return (((size_t)img * H + hs) * W + ws) * C;
  };

  for (int i = tid; i < SB_TOK * C; i += SB_THREADS) {
    const int t = i / C;
    xs[i] = x[src(t) + (i - t * C)];
  }
  if (tid < SB_TOK) {
    rid[tid] = shift ? 3 * region_id(wy * SB_WS + tid / SB_WS, H, shift) + region_id(wx * SB_WS + tid % SB_WS, W, shift)
                     : 0;
  }
  zero_columns(lnb, LC, C, P.kc);
  zero_columns(attn, LC, C, P.kc);
  FragMap map{{0u, 0u}};
  if constexpr (std::is_same<T, __nv_bfloat16>::value) map = read_frag_map(sc);  // sc is free until the scores
  __syncthreads();
  layernorm_rows<T>(xs, C, ln1_w, ln1_b, lnb, LC);

  const float qscale = rsqrtf((float)d);
  for (int h = 0; h < heads; ++h) {
    // q|k|v of head h, each DP wide (columns >= d are zero): column
    // part * DP + j of qkvh is column part * C + h * d + j of wqkv.
    auto part_of = [&](int n) { return n >= 2 * DP ? 2 : (n >= DP ? 1 : 0); };
    gemm64<T>(lnb, LC, P.kc, 3 * DP, packed + P.qkv + (size_t)h * P.kc * P.nq, P.nq, bst, map,
              [&](int r, int n, float acc) {
                const int part = part_of(n), j = n - part * DP;
                float v = 0.f;
                if (j < d) {
                  v = acc + bqkv[part * C + h * d + j];
                  if (part == 0) v *= qscale;
                }
                qkvh[r * LQ + n] = from_f32<T>(v);
              });
    // scores = q k^T + bias (+ mask)
    gemm64_smem<nvcuda::wmma::col_major>(
        qkvh, LQ, qkvh + DP, LQ, DP, SB_TOK, map, [&](int r, int n, float acc) {
          float v = acc + relbias[(h * SB_TOK + r) * SB_TOK + n];
          if (rid[r] != rid[n]) v += -100.f;
          sc[r * SB_TL + n] = v;
        });
    softmax_rows<T>(sc, inv);
    __syncthreads();
    gemm64_smem<nvcuda::wmma::row_major>(
        probs, probs_ld<T>(), qkvh + 2 * DP, LQ, SB_TOK, DP, map, [&](int r, int n, float acc) {
          if (n < d) attn[r * LC + h * d + n] = from_f32<T>(acc * inv[r]);
        });
  }

  gemm64<T>(attn, LC, P.kc, C, packed + P.proj, P.nc, bst, map, [&](int r, int n, float acc) {
    const int i = r * C + n;
    xs[i] = from_f32<T>(to_f32(xs[i]) + (acc + bproj[n]));
  });
  zero_columns(hid, LH, hidden, P.kh);  // the region now holds the MLP activation
  layernorm_rows<T>(xs, C, ln2_w, ln2_b, lnb, LC);
  __syncthreads();
  gemm64<T>(lnb, LC, P.kc, hidden, packed + P.fc1, P.nh, bst, map, [&](int r, int n, float acc) {
    const float v = acc + b1[n];
    hid[r * LH + n] = from_f32<T>(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
  });
  gemm64<T>(hid, LH, P.kh, C, packed + P.fc2, P.nc, bst, map,
            [&](int r, int n, float acc) { out[src(r) + n] = from_f32<T>(to_f32(xs[r * C + n]) + (acc + b2[n])); });
}

// Packs the weights into `packed` (pack_elems elements, SwinPack), then
// runs the block; both on `stream`.
template <typename T>
static cudaError_t swin_block(const T* x, T* out, int B, int H, int W, int C, int heads, int hidden, int shift,
                              const float* ln1_w, const float* ln1_b, const T* wqkv, const float* bqkv,
                              const T* wproj, const float* bproj, const float* relbias, const float* ln2_w,
                              const float* ln2_b, const T* w1, const float* b1, const T* w2, const float* b2,
                              T* packed, long long pack_elems, cudaStream_t stream) {
  const SwinPack P = swin_pack_layout(C, heads, hidden);
  if ((long long)P.total != pack_elems) return cudaErrorInvalidValue;
  swin_pack_kernel<T><<<(int)((P.total + 255) / 256), 256, 0, stream>>>(wqkv, wproj, w1, w2, packed, C, heads,
                                                                       hidden);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const SwinSmem L = swin_smem_layout(C, heads, hidden, sizeof(T));
  err = cudaFuncSetAttribute(swin_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(swin_block_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int blocks = B * (H / SB_WS) * (W / SB_WS);
  swin_block_kernel<T><<<blocks, SB_THREADS, L.total, stream>>>(x, out, H, W, C, heads, hidden, shift, ln1_w,
                                                               ln1_b, bqkv, bproj, relbias, ln2_w, ln2_b, b1, b2,
                                                               packed);
  return cudaGetLastError();
}

#define SWIN_BLOCK_ENTRY(NAME, T)                                                                            \
  extern "C" int NAME(const void* x, void* out, int B, int H, int W, int C, int heads, int hidden, int shift, \
                      const void* ln1_w, const void* ln1_b, const void* wqkv, const void* bqkv,              \
                      const void* wproj, const void* bproj, const void* relbias, const void* ln2_w,          \
                      const void* ln2_b, const void* w1, const void* b1, const void* w2, const void* b2,     \
                      void* packed, long long pack_elems, void* stream) {                                    \
    return (int)swin_block<T>((const T*)x, (T*)out, B, H, W, C, heads, hidden, shift, (const float*)ln1_w,   \
                              (const float*)ln1_b, (const T*)wqkv, (const float*)bqkv, (const T*)wproj,      \
                              (const float*)bproj, (const float*)relbias, (const float*)ln2_w,               \
                              (const float*)ln2_b, (const T*)w1, (const float*)b1, (const T*)w2,             \
                              (const float*)b2, (T*)packed, pack_elems, (cudaStream_t)stream);               \
  }

SWIN_BLOCK_ENTRY(swin_block_f32, float)
SWIN_BLOCK_ENTRY(swin_block_bf16, __nv_bfloat16)
