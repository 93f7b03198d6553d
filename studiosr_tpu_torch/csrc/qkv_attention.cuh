// Window attention in two passes through device memory, shared by B5 at
// windows 9-16 (window_attention16.cu) and B10 (ocab.cu), each in f32 and at
// the geometries the bf16 kernels written for the H100 do not take (in bf16
// B5 runs window_attention_mma.cu, B10 ocab_mma.cu); B9 (attn_bwd16.cu)
// shares pass 1.
//
// Pass 1, ln_qkv_kernel: LayerNorm and the q|k|v projection of 64 pixel
// rows a block (gemm64_ktile below: each 64-column tile of the packed
// weights staged whole, one barrier a tile), written to a scratch in a
// per-pixel, per-head layout, qkv[pixel][head][q|k|v][DP] (DP = d padded to
// 16, zero past d; q already carries 1/sqrt(d)), rounded to T as the TPU
// kernels round q, k and v. B9 (attn_bwd16.cu) runs this pass too and
// keeps the LayerNorm rows (ln_out).
//
// Pass 2: one block of 256 threads per (window, 64 consecutive queries of
// it). It streams the window's keys and values in chunks of 64 through two
// shared-memory buffers (cp.async, the next chunk in flight while the
// current one is used) and keeps an online, max-subtracted softmax: per
// query row the running max m and sum l in f32, and the f32 output o,
// rescaled by exp(m_old - m_new) as each chunk comes. Probabilities are
// rounded to T for the p.v product, as the TPU kernels round them; l sums
// the unrounded ones. Then proj and the residual: out = x + d_b (attn Wproj
// + bproj), written to the query's own pixel. In bf16
// (qkv_attention_mma_kernel) each warp keeps 16 query rows of one head's
// scores, softmax and p.v in registers on mma.sync (the flash-attention
// layout), two heads at a time, so that only the key chunk's buffers need
// a block barrier. In f32 (the checks' dtype) qkv_attention_kernel does the
// same one head at a time on the FMA pipes, through shared-memory tiles
// (swin_common.cuh's gemm64_smem).
//
// Which keys a window sees:
// * B5 (OVERLAP false): the ws x ws window itself of the map rolled by
//   -shift. Token (h, w) of the rolled map is read from ((h + shift) mod H,
//   (w + shift) mod W), and the output is written back there, which is
//   roll(+shift) . block . roll(-shift); keys of another region of the
//   rolled map (shift_region_ids) take -100 on their logit, as
//   calculate_mask's mask.
// * B10 (OVERLAP true): the owin x owin window around it, owin = ws + 2 pad.
//   Keys and values outside the image are zero rows (the reference's
//   zero-padded unfold of the projected map): their logits are the bias
//   alone. They are not masked. Key slots past owin^2 (the last chunk's
//   padding) are masked to -inf.
#pragma once

#include <math.h>

#include "swin_common.cuh"

// -- pass 1: LayerNorm + q|k|v projection -----------------------------------

// Packed weights: q|k|v kc x nq, column (h * 3 + part) * DP + j for part
// (q, k, v) of head h's column j (zero past d); then proj kc x nc.
struct QkvPack {
  int d, DP, N, kc, nq, nc;
  long long proj, total;
};

__host__ __device__ inline QkvPack qkv_pack_layout(int C, int heads) {
  QkvPack P;
  P.d = C / heads;
  P.DP = pad16(P.d);
  P.N = heads * 3 * P.DP;
  P.kc = pad32(C);
  P.nq = pad64(P.N);
  P.nc = pad64(C);
  P.proj = (long long)P.kc * P.nq;
  P.total = P.proj + (long long)P.kc * P.nc;
  return P;
}

// The segments that pack wqkv (C, 3C, q | k | v column blocks) and wproj
// (C, C) into `packed` at `off` (qkv_pack_layout).
template <typename T>
static void qkv_pack_segments(std::vector<PackSeg>& segs, const T* wqkv, const T* wproj, int C, int heads,
                              long long off) {
  const QkvPack P = qkv_pack_layout(C, heads);
  for (int h = 0; h < heads; ++h)
    for (int part = 0; part < 3; ++part)
      segs.push_back(PackSeg{wqkv + part * C + h * P.d, off + (h * 3 + part) * P.DP, P.nq, C, P.d, 3 * C, 1});
  segs.push_back(PackSeg{wproj, off + P.proj, P.nc, C, C, C, 1});
}

// acc(r, n) = sum_k A[r * lda + k] * B[k * ldb + n] over the 64 rows and
// n < N, handed to epi(r, n, acc), as swin_common.cuh's gemm64 (same packed
// B, same operand rules) but staging each 64-column tile of B whole (all KP
// rows) into one of two buffers of bst, the next tile in flight: one
// barrier a tile instead of one a 32-row chunk. bst: 2 x KP x SB_BL
// elements. Ends with a barrier.
template <typename T, typename EP>
__device__ void gemm64_ktile(const T* A, int lda, int KP, int N, const T* B, int ldb, T* bst, const FragMap& map,
                             EP epi) {
  using namespace nvcuda;
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value;
  constexpr int PIECES = 64 * (int)sizeof(T) / 16, PER = 16 / (int)sizeof(T);
  const int warp = threadIdx.x >> 5, mf = warp & 3, nf = (warp >> 2) * 2;
  const int tiles = (N + 63) / 64;
  const size_t buf = (size_t)KP * SB_BL;
  auto stage = [&](int t) {
    T* dst = bst + (t & 1) * buf;
    for (int i = threadIdx.x; i < KP * PIECES; i += SB_THREADS) {
      const int r = i / PIECES, c = (i % PIECES) * PER;
      cp_async16(dst + r * SB_BL + c, B + (size_t)r * ldb + t * 64 + c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1's buffer
    if (t + 1 < tiles) stage(t + 1);
    const T* b = bst + (t & 1) * buf;
    if constexpr (tc) {
      AccFrag frag[2];
      wmma::fill_fragment(frag[0], 0.f);
      wmma::fill_fragment(frag[1], 0.f);
      for (int ks = 0; ks < KP / 16; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, A + mf * 16 * lda + ks * 16, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, b + ks * 16 * SB_BL + (nf + j) * 16, SB_BL);
          wmma::mma_sync(frag[j], af, bf, frag[j]);
        }
      }
      tc_epilogue(frag, map, t * 64, N, epi);
    } else {
      float acc[4][4] = {};
      fma_steps(acc, [&](int r, int k) { return A[r * lda + k]; }, KP, [&](int k, int n) { return b[k * SB_BL + n]; });
      fma_epilogue(acc, t * 64, N, epi);
    }
  }
  __syncthreads();
}

struct LnQkvSmem {
  size_t xs, lnb, bst, total;
  int ld_c;
};

template <typename T>
__host__ __device__ inline LnQkvSmem ln_qkv_smem_layout(int C) {
  const size_t tsz = sizeof(T);
  LnQkvSmem L;
  L.ld_c = pad32(C) + SB_SKEW;
  size_t o = 0;
  L.xs = o;
  o = align32(o + SB_TOK * C * tsz);
  L.lnb = o;
  o = align32(o + SB_TOK * L.ld_c * tsz);
  L.bst = o;
  L.total = o + 2 * (size_t)pad32(C) * SB_BL * tsz;  // gemm64_ktile's two tiles of the packed weights
  return L;
}

template <typename T>
__global__ void __launch_bounds__(SB_THREADS, 2) ln_qkv_kernel(
    const T* __restrict__ x, T* __restrict__ qkv, long long rows, int C, int heads, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, const float* __restrict__ bqkv, const T* __restrict__ packed,
    T* __restrict__ ln_out, int ld_ln) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LnQkvSmem L = ln_qkv_smem_layout<T>(C);
  const QkvPack P = qkv_pack_layout(C, heads);
  T* xs = (T*)(smem + L.xs);
  T* lnb = (T*)(smem + L.lnb);
  T* bst = (T*)(smem + L.bst);
  const long long r0 = (long long)blockIdx.x * SB_TOK;
  const int nrows = rows - r0 < SB_TOK ? (int)(rows - r0) : SB_TOK;
  const float qscale = rsqrtf((float)P.d);

  for (int i = threadIdx.x; i < SB_TOK * C; i += SB_THREADS) xs[i] = i / C < nrows ? x[r0 * C + i] : from_f32<T>(0.f);
  zero_columns(lnb, L.ld_c, C, P.kc);
  const FragMap map = frag_map_for<T>((float*)bst);  // bst is free until the first staged chunk
  __syncthreads();
  layernorm_rows<T>(xs, C, ln_w, ln_b, lnb, L.ld_c);
  if (ln_out) {  // B9 keeps the LayerNorm rows for d Wqkv
    __syncthreads();
    for (int i = threadIdx.x; i < nrows * C; i += SB_THREADS)
      ln_out[(r0 + i / C) * ld_ln + i % C] = lnb[(i / C) * L.ld_c + i % C];
  }
  gemm64_ktile<T>(lnb, L.ld_c, P.kc, P.N, packed, P.nq, bst, map, [&](int r, int n, float acc) {
    if (r >= nrows) return;
    const int hp = n / P.DP, j = n - hp * P.DP, h = hp / 3, part = hp - 3 * h;
    float v = 0.f;
    if (j < P.d) {
      v = acc + bqkv[part * C + h * P.d + j];
      if (part == 0) v *= qscale;
    }
    qkv[(r0 + r) * P.N + n] = from_f32<T>(v);
  });
}

// -- pass 2: attention, proj and residual -------------------------------------

constexpr int QA_CHUNK = 64;  // queries a block, keys a streamed chunk

template <typename T>
__host__ __device__ constexpr int qa_skew() {
  return 16 / (int)sizeof(T);  // 16 bytes: wmma's ldm rule in bf16, and fewer bank conflicts
}

struct QaSmem {
  size_t q, k, v, sc, o, m, l, cr, rid, attn, bst, total;
  int lq, lsc, lo, ld_c;
};

// Scores are f32 rows of lsc = 68; the T probabilities are written over
// them with the same row start (stride lsc * 4 / sizeof(T) elements).
template <typename T>
__host__ __device__ inline QaSmem qa_smem_layout(int C, int heads) {
  const int DP = pad16(C / heads);
  const size_t tsz = sizeof(T);
  QaSmem L;
  L.lq = DP + qa_skew<T>();
  L.lsc = QA_CHUNK + 4;
  L.lo = DP + 4;
  L.ld_c = pad32(C) + SB_SKEW;
  size_t o = 0;
  L.q = o;
  o = align32(o + QA_CHUNK * L.lq * tsz);
  L.k = o;  // two buffers
  o = align32(o + 2 * QA_CHUNK * L.lq * tsz);
  L.v = o;  // two buffers
  o = align32(o + 2 * QA_CHUNK * L.lq * tsz);
  L.sc = o;
  o = align32(o + QA_CHUNK * L.lsc * sizeof(float));
  L.o = o;
  o = align32(o + QA_CHUNK * L.lo * sizeof(float));
  L.m = o;
  o = align32(o + QA_CHUNK * sizeof(float));
  L.l = o;
  o = align32(o + QA_CHUNK * sizeof(float));
  L.cr = o;
  o = align32(o + QA_CHUNK * sizeof(float));
  L.rid = o;
  o = align32(o + QA_CHUNK * sizeof(int));
  L.attn = o;
  o = align32(o + QA_CHUNK * L.ld_c * tsz);
  L.bst = o;
  L.total = o + 2 * SB_KC * SB_BL * tsz;
  return L;
}

// Where the tokens of a block live. Window wi (row-major) of image img;
// queries qc * 64 .. + 63 of its ws x ws tokens (row-major), those past nq
// (the last chunk of a window of ws^2 not a multiple of 64) zero rows that
// are never stored.
struct QaGeom {
  int H, W, ws, shift, pad, owin, nq, nk;
  int img, wy, wx, qc;

  // Pixel (linear in the batch) of query token t (window-local), shift folded
  // in, or -1 past nq.
  __device__ long long query_row(int t) const { return t < nq ? query_pixel(t) : -1; }
  __device__ long long query_pixel(int t) const {
    const int y = (wy * ws + t / ws + shift) % H, x = (wx * ws + t % ws + shift) % W;
    return ((long long)img * H + y) * W + x;
  }
  // Pixel of key token t, or -1 where the key is a zero row (outside the
  // image or past nk).
  template <bool OVERLAP>
  __device__ long long key_pixel(int t) const {
    if (t >= nk) return -1;
    if constexpr (OVERLAP) {
      const int y = wy * ws - pad + t / owin, x = wx * ws - pad + t % owin;
      if (y < 0 || y >= H || x < 0 || x >= W) return -1;
      return ((long long)img * H + y) * W + x;
    } else {
      return query_pixel(t);
    }
  }
  // Region of the rolled map (shift_region_ids) of window token t; 0 without shift.
  __device__ int region(int t) const {
    if (!shift) return 0;
    const int y = wy * ws + t / ws, x = wx * ws + t % ws;
    const int ry = y < H - ws ? 0 : (y < H - shift ? 1 : 2);
    const int rx = x < W - ws ? 0 : (x < W - shift ? 1 : 2);
    return 3 * ry + rx;
  }
};

// Copy 64 rows of one head's part (q, k or v) into dst (stride ld): row i
// from the scratch row of pixel(i), zero where pixel(i) < 0. One cp.async
// group.
template <typename T, typename PixelOf>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* qkv, int N, int col, int DP, PixelOf pixel) {
  const int per = 16 / (int)sizeof(T), pieces = DP / per;
  for (int i = threadIdx.x; i < QA_CHUNK * pieces; i += SB_THREADS) {
    const int r = i / pieces, c = (i - r * pieces) * per;
    const long long p = pixel(r);
    T* d = dst + r * ld + c;
    if (p >= 0) {
      cp_async16(d, qkv + p * N + col + c);
    } else {
#pragma unroll
      for (int e = 0; e < 16 / (int)sizeof(T); ++e) d[e] = from_f32<T>(0.f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// out[pixel] = x[pixel] + d_b (attn Wproj + bproj) for each query of the
// block, attention over its window's keys (OVERLAP: the overlapping owin
// window). relbias is the (heads, nq, nk) f32 bias; dp the per-image
// drop-path scales or null; packed_proj proj's kc x nc packed weights.
template <typename T, bool OVERLAP>
__global__ void __launch_bounds__(SB_THREADS) qkv_attention_kernel(
    const T* __restrict__ x, T* __restrict__ out, const T* __restrict__ qkv, int H, int W, int C, int heads, int ws,
    int shift, int pad, const float* __restrict__ relbias, const float* __restrict__ bproj,
    const float* __restrict__ dp, const T* __restrict__ packed_proj) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const QaSmem L = qa_smem_layout<T>(C, heads);
  const QkvPack P = qkv_pack_layout(C, heads);
  T* qs = (T*)(smem + L.q);
  T* kbuf = (T*)(smem + L.k);
  T* vbuf = (T*)(smem + L.v);
  float* sc = (float*)(smem + L.sc);
  T* probs = (T*)sc;  // written over the scores, row r at the same byte
  float* o = (float*)(smem + L.o);
  float* mrow = (float*)(smem + L.m);
  float* lrow = (float*)(smem + L.l);
  float* cr = (float*)(smem + L.cr);
  int* rid = (int*)(smem + L.rid);
  T* attn = (T*)(smem + L.attn);
  T* bst = (T*)(smem + L.bst);
  const int lq = L.lq, lsc = L.lsc, lo = L.lo, LC = L.ld_c, DP = P.DP, d = P.d, N = P.N;
  const int ldp = lsc * (int)(sizeof(float) / sizeof(T));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  QaGeom g;
  g.H = H;
  g.W = W;
  g.ws = ws;
  g.shift = shift;
  g.pad = pad;
  g.owin = ws + 2 * pad;
  g.nq = ws * ws;
  g.nk = OVERLAP ? g.owin * g.owin : g.nq;
  const int nqc = (g.nq + QA_CHUNK - 1) / QA_CHUNK, nwx = W / ws, nwin = (H / ws) * nwx;
  g.qc = blockIdx.x % nqc;
  const int wi = (blockIdx.x / nqc) % nwin;
  g.img = blockIdx.x / (nqc * nwin);
  g.wy = wi / nwx;
  g.wx = wi % nwx;
  const int nkc = (g.nk + QA_CHUNK - 1) / QA_CHUNK, q0 = g.qc * QA_CHUNK;
  const float scale = dp ? dp[g.img] : 1.f;

  if (tid < QA_CHUNK) rid[tid] = OVERLAP ? 0 : g.region(q0 + tid);
  zero_columns(attn, LC, C, P.kc);
  const FragMap map = frag_map_for<T>(sc);  // sc is free until the first scores
  auto qpix = [&](int r) { return g.query_row(q0 + r); };

  for (int h = 0; h < heads; ++h) {
    const int col = h * 3 * DP;
    __syncthreads();  // the previous head is done with every buffer
    stage_rows(qs, lq, qkv, N, col, DP, qpix);
    stage_rows(kbuf, lq, qkv, N, col + DP, DP, [&](int r) { return g.key_pixel<OVERLAP>(r); });
    stage_rows(vbuf, lq, qkv, N, col + 2 * DP, DP, [&](int r) { return g.key_pixel<OVERLAP>(r); });
    for (int i = tid; i < QA_CHUNK * DP; i += SB_THREADS) o[(i / DP) * lo + i % DP] = 0.f;
    if (tid < QA_CHUNK) {
      mrow[tid] = -INFINITY;
      lrow[tid] = 0.f;
    }
    for (int j = 0; j < nkc; ++j) {
      T* ks = kbuf + (j & 1) * QA_CHUNK * lq;
      T* vs = vbuf + (j & 1) * QA_CHUNK * lq;
      cp_async_wait_all();
      __syncthreads();  // chunk j is in; every thread is done with chunk j - 1's buffers
      if (j + 1 < nkc) {
        const int k0 = (j + 1) * QA_CHUNK;
        T* kn = kbuf + ((j + 1) & 1) * QA_CHUNK * lq;
        T* vn = vbuf + ((j + 1) & 1) * QA_CHUNK * lq;
        stage_rows(kn, lq, qkv, N, col + DP, DP, [&](int r) { return g.key_pixel<OVERLAP>(k0 + r); });
        stage_rows(vn, lq, qkv, N, col + 2 * DP, DP, [&](int r) { return g.key_pixel<OVERLAP>(k0 + r); });
      }
      // scores = q k^T + bias (+ the shift mask); -inf past the last key
      const int k0 = j * QA_CHUNK;
      gemm64_smem<wmma::row_major, wmma::col_major>(qs, lq, ks, lq, DP, QA_CHUNK, map, [&](int r, int n, float acc) {
        const int t = k0 + n;
        float v = -INFINITY;
        if (t < g.nk) {
          v = acc + (q0 + r < g.nq ? relbias[((size_t)h * g.nq + q0 + r) * g.nk + t] : 0.f);
          if (!OVERLAP && rid[r] != g.region(t)) v += -100.f;
        }
        sc[r * lsc + n] = v;
      });
      // online softmax: one warp per row
      for (int r = warp; r < QA_CHUNK; r += SB_THREADS / 32) {
        const float a = sc[r * lsc + lane], b = sc[r * lsc + lane + 32];
        const float m_old = mrow[r];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(a, b)));
        const float ea = expf(a - m_new), eb = expf(b - m_new);
        const float s = warp_sum(ea + eb);
        __syncwarp();
        probs[r * ldp + lane] = from_f32<T>(ea);
        probs[r * ldp + lane + 32] = from_f32<T>(eb);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);  // 0 at the first chunk (m_old = -inf)
          cr[r] = corr;
          lrow[r] = lrow[r] * corr + s;
          mrow[r] = m_new;
        }
      }
      __syncthreads();
      // o = o * corr + p v
      gemm64_smem<wmma::row_major, wmma::row_major>(probs, ldp, vs, lq, QA_CHUNK, DP, map,
                                                    [&](int r, int n, float acc) {
                                                      o[r * lo + n] = o[r * lo + n] * cr[r] + acc;
                                                    });
    }
    for (int i = tid; i < QA_CHUNK * d; i += SB_THREADS) {
      const int r = i / d, n = i - r * d;
      attn[r * LC + h * d + n] = from_f32<T>(o[r * lo + n] / lrow[r]);
    }
  }
  __syncthreads();
  gemm64<T>(attn, LC, P.kc, C, packed_proj, P.nc, bst, map, [&](int r, int n, float acc) {
    if (q0 + r >= g.nq) return;
    const size_t p = (size_t)qpix(r) * C + n;
    out[p] = from_f32<T>(to_f32(x[p]) + scale * (acc + bproj[n]));
  });
}

// -- pass 2 in bf16 on mma.sync, one warp per 16 query rows ----------------------

// Shared memory of qkv_attention_mma_kernel: two buffers x two head groups
// of a key chunk's k and v rows, the query regions, the attention output
// and gemm64's staging for proj.
struct QaMmaSmem {
  size_t k, v, rid, attn, bst, total;
  int lq, ld_c;
};

__host__ __device__ inline QaMmaSmem qa_mma_smem_layout(int C, int heads) {
  const int DP = pad16(C / heads);
  QaMmaSmem L;
  L.lq = DP + 8;  // 80-byte rows at DP 32: the 8 rows a fragment load touches fall on distinct banks
  L.ld_c = pad32(C) + SB_SKEW;
  const size_t chunk = (size_t)QA_CHUNK * L.lq * sizeof(__nv_bfloat16);
  size_t o = 0;
  L.k = o;  // [buffer][group]
  o = align32(o + 4 * chunk);
  L.v = o;
  o = align32(o + 4 * chunk);
  L.rid = o;
  o = align32(o + QA_CHUNK * sizeof(int));
  L.attn = o;
  o = align32(o + QA_CHUNK * L.ld_c * sizeof(__nv_bfloat16));
  L.bst = o;
  L.total = o + staging_bytes<__nv_bfloat16>();
  return L;
}

// d += a b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col),
// d 16 x 8 f32. Fragments as PTX lays them out for lane = 4 g + t:
// a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)},
// b = {(k 2t.., n g), (k 2t + 8.., n g)}, d = {(g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The b fragment of rows k0 .. k0 + 15 (k), columns n0 .. n0 + 7 (n) of a
// row-major bf16 matrix in shared memory (stride ld, 16-byte aligned rows):
// ldmatrix with transpose, lanes 0-15 giving the 16 row addresses.
__device__ __forceinline__ void ldmatrix_b_trans(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* m, int ld, int k0,
                                                 int n0) {
  const int lane = threadIdx.x & 31;
  const unsigned addr = (unsigned)__cvta_generic_to_shared(m + (k0 + (lane & 15)) * ld + n0);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n" : "=r"(b0), "=r"(b1) : "r"(addr));
}

// The same function as qkv_attention_kernel in bf16, with the scores, the
// softmax and p.v in registers (the flash-attention layout): warp w owns
// query rows 16 (w % 4) .. + 15 and head group w / 4, heads taken in pairs
// (head 2 i + group). A block barrier only guards each key chunk's buffers.
template <bool OVERLAP>
__global__ void __launch_bounds__(SB_THREADS, 2) qkv_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ qkv,
    int H, int W, int C, int heads, int ws, int shift, int pad, const float* __restrict__ relbias,
    const float* __restrict__ bproj, const float* __restrict__ dp, const __nv_bfloat16* __restrict__ packed_proj) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  const QaMmaSmem L = qa_mma_smem_layout(C, heads);
  const QkvPack P = qkv_pack_layout(C, heads);
  T* kbuf = (T*)(smem + L.k);
  T* vbuf = (T*)(smem + L.v);
  int* rid = (int*)(smem + L.rid);
  T* attn = (T*)(smem + L.attn);
  T* bst = (T*)(smem + L.bst);
  const int lq = L.lq, LC = L.ld_c, DP = P.DP, d = P.d, N = P.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int group = warp >> 2, row0 = (warp & 3) * 16;
  const size_t chunk = (size_t)QA_CHUNK * lq;

  QaGeom g;
  g.H = H;
  g.W = W;
  g.ws = ws;
  g.shift = shift;
  g.pad = pad;
  g.owin = ws + 2 * pad;
  g.nq = ws * ws;
  g.nk = OVERLAP ? g.owin * g.owin : g.nq;
  const int nqc = (g.nq + QA_CHUNK - 1) / QA_CHUNK, nwx = W / ws, nwin = (H / ws) * nwx;
  g.qc = blockIdx.x % nqc;
  const int wi = (blockIdx.x / nqc) % nwin;
  g.img = blockIdx.x / (nqc * nwin);
  g.wy = wi / nwx;
  g.wx = wi % nwx;
  const int nkc = (g.nk + QA_CHUNK - 1) / QA_CHUNK, q0 = g.qc * QA_CHUNK;
  const float scale = dp ? dp[g.img] : 1.f;

  if (tid < QA_CHUNK) rid[tid] = OVERLAP ? 0 : g.region(q0 + tid);
  zero_columns(attn, LC, C, P.kc);
  const FragMap map = frag_map_for<T>((float*)bst);  // bst is free until proj
  const int qrow[2] = {q0 + row0 + gq, q0 + row0 + gq + 8};  // this thread's two query rows (window tokens)
  const int qrid[2] = {rid[row0 + gq], rid[row0 + gq + 8]};
  auto stage = [&](int j, int hp) {  // chunk j of heads 2 hp and 2 hp + 1 into buffer j & 1
    const int k0 = j * QA_CHUNK;
    for (int grp = 0; grp < 2; ++grp) {
      const int h = 2 * hp + grp;
      if (h >= heads) continue;
      T* kd = kbuf + ((j & 1) * 2 + grp) * chunk;
      T* vd = vbuf + ((j & 1) * 2 + grp) * chunk;
      stage_rows(kd, lq, qkv, N, h * 3 * DP + DP, DP, [&](int r) { return g.key_pixel<OVERLAP>(k0 + r); });
      stage_rows(vd, lq, qkv, N, h * 3 * DP + 2 * DP, DP, [&](int r) { return g.key_pixel<OVERLAP>(k0 + r); });
    }
  };

  for (int hp = 0; 2 * hp < heads; ++hp) {
    const int h = 2 * hp + group;
    const bool active = h < heads;
    // q of this warp's 16 rows, as a fragments (DP / 16 k-steps, at most 4)
    uint32_t qa[4][4];
    if (active) {
      // a query row past nq reads some pixel's q: its scores are never stored
      const T* qr0 = qkv + g.query_pixel(qrow[0]) * N + h * 3 * DP;
      const T* qr1 = qkv + g.query_pixel(qrow[1]) * N + h * 3 * DP;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks * 16 >= DP) break;
        const int c = ks * 16 + 2 * tq;
        qa[ks][0] = *reinterpret_cast<const uint32_t*>(qr0 + c);
        qa[ks][1] = *reinterpret_cast<const uint32_t*>(qr1 + c);
        qa[ks][2] = *reinterpret_cast<const uint32_t*>(qr0 + c + 8);
        qa[ks][3] = *reinterpret_cast<const uint32_t*>(qr1 + c + 8);
      }
    }
    __syncthreads();  // the previous pair is done with every buffer
    stage(0, hp);
    float o[8][4];  // DP / 8 column tiles of 8, at most 8
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const float* bias_h = relbias + (size_t)h * g.nq * g.nk;
    for (int j = 0; j < nkc; ++j) {
      cp_async_wait_all();
      __syncthreads();  // chunk j is in; every warp is done with chunk j - 1's buffers
      if (j + 1 < nkc) stage(j + 1, hp);
      if (!active) continue;
      const T* ks_ = kbuf + ((j & 1) * 2 + group) * chunk;
      const T* vs_ = vbuf + ((j & 1) * 2 + group) * chunk;
      // s = q k^T over the chunk's 64 keys: 8 tiles of 8 keys
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks * 16 >= DP) break;
          const T* kr = ks_ + (nt * 8 + gq) * lq + ks * 16 + 2 * tq;
          mma_bf16_16816(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
                         *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
      // + bias (+ the shift mask), -inf past the last key (no bias past the
      // last query); running max
      const int k0 = j * QA_CHUNK;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int t = k0 + nt * 8 + 2 * tq;  // columns t, t + 1
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v0 = -INFINITY, v1 = -INFINITY;
          const bool qin = qrow[half] < g.nq;
          const float* br = bias_h + (size_t)qrow[half] * g.nk + t;
          if (t < g.nk) {
            v0 = s[nt][2 * half] + (qin ? br[0] : 0.f);
            if (!OVERLAP && shift && g.region(t) != qrid[half]) v0 += -100.f;
          }
          if (t + 1 < g.nk) {
            v1 = s[nt][2 * half + 1] + (qin ? br[1] : 0.f);
            if (!OVERLAP && shift && g.region(t + 1) != qrid[half]) v1 += -100.f;
          }
          s[nt][2 * half] = v0;
          s[nt][2 * half + 1] = v1;
          mx[half] = fmaxf(mx[half], fmaxf(v0, v1));
        }
      }
      float corr[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
        const float mn = fmaxf(m[half], mx[half]);
        corr[half] = expf(m[half] - mn);  // 0 at the first chunk (m = -inf)
        m[half] = mn;
        l[half] *= corr[half];
      }
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        o[dn][0] *= corr[0];
        o[dn][1] *= corr[0];
        o[dn][2] *= corr[1];
        o[dn][3] *= corr[1];
      }
      // p = exp(s - m), rounded to bf16 as p.v's a fragments (tiles 2 kk and
      // 2 kk + 1 of s are k-step kk's a); l sums the unrounded p
      uint32_t pa[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float p0 = expf(s[nt][0] - m[0]), p1 = expf(s[nt][1] - m[0]);
        const float p2 = expf(s[nt][2] - m[1]), p3 = expf(s[nt][3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[nt >> 1][(nt & 1) * 2] = pack_bf16x2(p0, p1);
        pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16x2(p2, p3);
      }
      // o += p v: 4 k-steps of 16 keys x DP / 8 column tiles
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int dn = 0; dn < 8; ++dn) {
          if (dn * 8 >= DP) break;
          uint32_t b0, b1;
          ldmatrix_b_trans(b0, b1, vs_, lq, kk * 16, dn * 8);
          mma_bf16_16816(o[dn], pa[kk], b0, b1);
        }
    }
    if (active) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
        l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
      }
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        if (dn * 8 >= DP) break;
        const int n = dn * 8 + 2 * tq;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + gq + (e >> 1) * 8, c = n + (e & 1);
          if (c < d) attn[r * LC + h * d + c] = __float2bfloat16(o[dn][e] / l[e >> 1]);
        }
      }
    }
  }
  __syncthreads();
  gemm64<T>(attn, LC, P.kc, C, packed_proj, P.nc, bst, map, [&](int r, int n, float acc) {
    if (q0 + r >= g.nq) return;
    const size_t p = (size_t)g.query_pixel(q0 + r) * C + n;
    out[p] = __float2bfloat16(__bfloat162float(x[p]) + scale * (acc + bproj[n]));
  });
}

// Scratch elements of pass 1 for `rows` pixels.
extern "C" long long qkv_attention_scratch_elems(int rows, int C, int heads) {
  return (long long)rows * qkv_pack_layout(C, heads).N;
}

// Both passes on `stream`, with wqkv and wproj packed into `packed`
// (qkv_pack_layout). OVERLAP: B10's key windows (shift 0).
template <typename T, bool OVERLAP>
static cudaError_t qkv_attention(const T* x, T* out, T* qkv, int B, int H, int W, int C, int heads, int ws,
                                 int shift, int pad, const float* ln_w, const float* ln_b, const T* wqkv,
                                 const float* bqkv, const T* wproj, const float* bproj, const float* relbias,
                                 const float* dp, T* packed, cudaStream_t stream) {
  const QkvPack P = qkv_pack_layout(C, heads);
  if (ws <= 0 || H % ws || W % ws || C % heads || P.DP > 64) return cudaErrorInvalidValue;
  std::vector<PackSeg> segs;
  qkv_pack_segments(segs, wqkv, wproj, C, heads, 0);
  cudaError_t err = pack_segments(segs, packed, (size_t)P.total, stream);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)B * H * W;
  const LnQkvSmem L1 = ln_qkv_smem_layout<T>(C);
  err = allow_smem(ln_qkv_kernel<T>, L1.total);
  if (err != cudaSuccess) return err;
  ln_qkv_kernel<T><<<(unsigned)((rows + SB_TOK - 1) / SB_TOK), SB_THREADS, L1.total, stream>>>(
      x, qkv, rows, C, heads, ln_w, ln_b, bqkv, packed, nullptr, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)B * (H / ws) * (W / ws) * ((ws * ws + QA_CHUNK - 1) / QA_CHUNK);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const QaMmaSmem L2 = qa_mma_smem_layout(C, heads);
    err = allow_smem(qkv_attention_mma_kernel<OVERLAP>, L2.total);
    if (err != cudaSuccess) return err;
    qkv_attention_mma_kernel<OVERLAP><<<blocks, SB_THREADS, L2.total, stream>>>(
        x, out, qkv, H, W, C, heads, ws, shift, pad, relbias, bproj, dp, packed + P.proj);
  } else {
    const QaSmem L2 = qa_smem_layout<T>(C, heads);
    err = allow_smem(qkv_attention_kernel<T, OVERLAP>, L2.total);
    if (err != cudaSuccess) return err;
    qkv_attention_kernel<T, OVERLAP><<<blocks, SB_THREADS, L2.total, stream>>>(
        x, out, qkv, H, W, C, heads, ws, shift, pad, relbias, bproj, dp, packed + P.proj);
  }
  return cudaGetLastError();
}
