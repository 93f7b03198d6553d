// The shared pieces of the f32 kernels written for the H100, SwinFIR's
// training recipe, which trains in f32 (studiosr_tpu/models/swinfir.py
// _TRAINING_CONFIG): its forward (window_attention_f32.cu: B5 in f32;
// mlp_block_f32.cu: B6 in f32) and its backward (attn_bwd_f32.cu: B8 in f32,
// and B9 at HAT's windows 9-16 with tf_window16.cuh; mlp_bwd_f32.cu: B7 in
// f32), and the other f32 kernels on mma.sync (oca_bwd_f32.cu: B13;
// window_attn.cu: B15). Every product in 3xTF32 on the tensor cores,
// the f32 row passes a warp a row, the epilogues they share, and the pack
// that splits the weights.
//
// 3xTF32. The card has no f32 tensor-core rate; its FMA pipes peak at 66.9
// TFLOP/s. An f32 operand a splits into a_hi = tf32(a) (cvt.rna: 10 mantissa
// bits, round to nearest, ties away) and a_lo = tf32(a - a_hi); a b is then
// a_lo b_hi + a_hi b_lo + a_hi b_hi, each a TF32 product accumulated in f32
// (the small terms first), which keeps f32's accuracy: the dropped a_lo b_lo
// and the two roundings are below 2^-21 |a| |b|. Three TF32 products run at
// 494.7 / 3 = 164.9 TFLOP/s, 2.5 times the FMA pipes. ops/cuda/tf32x3.py is
// the plain version.
//
// The products: the row products (a token row's activations times the
// weights) on wgmma's tf32 form (tfw_gemm_kernel: A split in registers, the
// weights split once a call into the hi and lo images wgmma reads); the
// weight gradients, A^T B over the token rows with both operands
// token-major, which wgmma's tf32 form cannot read (it wants both K-major),
// and the attention core, which reads one tile as A of one product and as
// B^T of another, on mma.sync.m16n8k8.tf32 from registers (tf_gemm_kernel,
// ab32_attn_kernel, wa32_attn_kernel), each fragment split once where it is
// loaded, or from hi / lo images in shared memory where several warps read
// one operand (tw_rows_kernel, ab16_main_kernel, o32_*: the attention cores
// below).
// tf_gemm_kernel: dW (M x N) = A^T B, a 32-row K tile a stage through four
// cp.async stages (16-byte pieces, zero-filled past M, N and K), a block of
// eight warps (2 x 4) a 32 MT x 32 NT tile, each warp 16 MT x 8 NT outputs;
// K split over blockIdx.z, each split an f32 partial summed afterwards in a
// fixed order by reduce_parts; the blocks of the first M tile also write
// their split's column sums of B (a bias gradient).
#pragma once

#include "am_common.cuh"

// K rows a stage. The tensor cores add a product's terms to their f32
// accumulator with the alignment's low bits cut off (rounded toward zero),
// so over a long K their sum drifts: at 288 TF32 terms a chain (a weight
// gradient's 768 rows) a gradient read 1.6e-5 from the f64 witness. So a
// stage's 12 terms go to a fresh accumulator, added to the running f32 sum
// (round to nearest) once a stage.
constexpr int TF_BK = 32;
constexpr int TF_STAGES = 4;  // cp.async stages in flight
constexpr int TF_THREADS = 256;
constexpr int TF_WGRAD_MT = 3;  // dW tiles of 96 rows, one block an SM: more work a block over the long K
constexpr int TF_MAX_C = 256;  // the row passes: C a multiple of 4 up to 256 (64 four-column pieces a row)

__host__ __device__ inline int tf_pad4(int v) { return (v + 3) & ~3; }

// The windows the f32 window-attention kernels take (B5's and B8's):
// windows 2..8 (one 64-token tile), C a multiple of 4 up to TF_MAX_C, head
// dims up to 32.
__host__ inline bool tf_window_ok(int C, int heads, int ws) {
  return ws >= 2 && ws * ws <= AM_TOK && heads >= 1 && C >= 4 && C <= TF_MAX_C && C % 4 == 0 && C % heads == 0 &&
         C / heads <= 32;
}

// The windows the f32 kernels' second family takes (B5's and B9's at windows
// 9..16: two to four 64-token tiles a window, tf_window16.cuh), at the same
// C and head dims.
__host__ inline bool tf_window16_ok(int C, int heads, int ws) {
  return ws >= 9 && ws <= 16 && tf_window_ok(C, heads, 8);
}


__device__ __forceinline__ uint32_t tf_round(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo (to 2^-22 |v|), each a TF32 value.
__device__ __forceinline__ void tf_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf_round(v);
  lo = tf_round(v - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 product. Fragments for lane = 4 g + t: a =
// {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)} of the 16 x 8 A tile; b =
// {(k t, n g), (k t + 4, n g)} of the 8 x 8 B tile; d = {(g, 2t), (g, 2t +
// 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void tf_mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two independent 3xTF32 products, d += a b and e += c f, each the small
// terms first, the two interleaved: a product's three terms wait on one
// another, so one product alone leaves the tensor pipe idle between them.
__device__ __forceinline__ void tf_mma3x2(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                          const uint32_t (&bh)[2], const uint32_t (&bl)[2], float (&e)[4],
                                          const uint32_t (&ch)[4], const uint32_t (&cl)[4], const uint32_t (&fh)[2],
                                          const uint32_t (&fl)[2]) {
  tf_mma(d, al, bh);
  tf_mma(e, cl, fh);
  tf_mma(d, ah, bl);
  tf_mma(e, ch, fl);
  tf_mma(d, ah, bh);
  tf_mma(e, ch, fh);
}

// The four values of an A fragment, split.
__device__ __forceinline__ void tf_split4(const float (&v)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) tf_split(v[i], hi[i], lo[i]);
}

__device__ __forceinline__ void tf_split2(float v0, float v1, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  tf_split(v0, hi[0], lo[0]);
  tf_split(v1, hi[1], lo[1]);
}

// -- the attention cores on mma.sync ---------------------------------------------------
//
// The attention cores (oca_bwd_f32.cu: B13 in f32; tf_window16.cuh and
// attn_bwd_f32.cu: B5 and B9 in f32 at windows 9-16) read an operand that
// several warps share (k and v, and q and g of a slab) from hi and lo images
// in shared memory, each value split once, and split only the values formed
// in registers (p, dscores) where their fragments are loaded.

// hi and lo (TF32 bit patterns) of rows x DP f32 values at src (rows LD
// apart), to the same places of hi and lo, by the block's THREADS threads;
// src may be hi (split in place).
template <int DP, int LD, int THREADS>
__device__ __forceinline__ void tf_split_rows(const float* src, uint32_t* hi, uint32_t* lo, int rows) {
  for (int i = threadIdx.x; i < rows * (DP / 4); i += THREADS) {
    const int at = (i / (DP / 4)) * LD + 4 * (i % (DP / 4));
    const float4 x = *reinterpret_cast<const float4*>(src + at);
    uint4 h, l;
    tf_split(x.x, h.x, l.x);
    tf_split(x.y, h.y, l.y);
    tf_split(x.z, h.z, l.z);
    tf_split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

// The A fragment of rows r, r + 8 (LD apart), columns 8 ks + t, + 4, split.
__device__ __forceinline__ void tf_afrag(const float* rows, int LD, int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* r = rows + g * LD + 8 * ks + t;
  const float v[4] = {r[0], r[8 * LD], r[4], r[8 * LD + 4]};
  tf_split4(v, hi, lo);
}

// The same fragment from split images.
__device__ __forceinline__ void tf_afrag_split(const uint32_t* hrows, const uint32_t* lrows, int LD, int ks,
                                               uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, at = (lane >> 2) * LD + 8 * ks + (lane & 3);
  hi[0] = hrows[at], hi[1] = hrows[at + 8 * LD], hi[2] = hrows[at + 4], hi[3] = hrows[at + 8 * LD + 4];
  lo[0] = lrows[at], lo[1] = lrows[at + 8 * LD], lo[2] = lrows[at + 4], lo[3] = lrows[at + 8 * LD + 4];
}

// The scores s = q k^T and dprobs dp = g v^T of a warp's 16 rows against a
// 64-key chunk (split images of k and v, 64 rows LD apart), q and g split
// in (qh, ql), (gh, gl) for each 8-column step ks. DP <= 32: the K dimension
// is one 32-row stage, one accumulator.
template <int KS, int LD, typename QF>
__device__ __forceinline__ void tf_scores(float (&s)[8][4], float (&dp)[8][4], QF qfrag, const uint32_t* Kh,
                                          const uint32_t* Kl, const uint32_t* Vh, const uint32_t* Vl) {
  static_assert(KS <= 4, "one 32-row stage");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f, dp[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t qh[4], ql[4], gh[4], gl[4];
    qfrag(ks, qh, ql, gh, gl);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int at = (8 * nt + g) * LD + 8 * ks + t;
      const uint32_t kh[2] = {Kh[at], Kh[at + 4]}, kl[2] = {Kl[at], Kl[at + 4]};
      const uint32_t vh[2] = {Vh[at], Vh[at + 4]}, vl[2] = {Vl[at], Vl[at + 4]};
      tf_mma3x2(s[nt], qh, ql, kh, kl, dp[nt], gh, gl, vh, vl);
    }
  }
}

// The window groups of a pass whose blocks each own (group, `per_group`
// units of a window) and walk the group's windows, one block an SM: the
// count, up to 64 and to `windows`, that makes its waves take the fewest
// window steps.
__host__ inline int tf_groups(long long windows, int per_group, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int G = 1; G <= windows && G <= 64; ++G) {
    const long long blocks = (long long)G * per_group, waves = (blocks + sms - 1) / sms;
    const long long cost = waves * ((windows + G - 1) / G);
    if (best_cost < 0 || cost < best_cost) best = G, best_cost = cost;
  }
  return best;
}

// -- the product --------------------------------------------------------------------

struct TfGemm {
  const float* A;  // K x M row-major (lda apart)
  const float* B;  // K x N row-major
  long long lda, ldb, M, K;
  int N;
  long long ksplit;  // K rows of a split (a multiple of TF_BK when there are several); K when there is one
  float* colsum;     // when set: [split][N] column sums of B, written by the blocks of M tile 0
};

// A stage: the A tile (32 x (32 MT + 8)), then the B tile (32 x (32 NT +
// 8)). The strides keep every fragment load free of bank conflicts (8 t + g).
template <int MT, int NT>
struct TfTile {
  static constexpr int BM = 32 * MT, BN = 32 * NT;
  static constexpr int LA = BM + 8, LB = BN + 8;
  static constexpr int A_ELEMS = TF_BK * LA, STAGE = A_ELEMS + TF_BK * LB;
  static constexpr size_t SMEM = (size_t)TF_STAGES * STAGE * 4;
};

template <int MT, int NT, typename Epi>
__global__ void __launch_bounds__(TF_THREADS, MT <= 2 ? 2 : 1) tf_gemm_kernel(const TfGemm q, const Epi epi) {
  using L = TfTile<MT, NT>;
  extern __shared__ __align__(128) float tsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const long long m0 = (long long)blockIdx.y * L::BM;  // the N tiles of an M tile run together: A read once
  const int n0 = blockIdx.x * L::BN, split = blockIdx.z;
  const long long kb = (long long)split * q.ksplit, ke = kb + q.ksplit < q.K ? kb + q.ksplit : q.K;
  const int ktiles = (int)((ke - kb + TF_BK - 1) / TF_BK);
  const bool sums = q.colsum != nullptr && blockIdx.y == 0;

  // K tile kt into stage kt % TF_STAGES, one cp.async group (empty past the last)
  auto load = [&](int kt) {
    if (kt < ktiles) {
      float* sa = tsm + (kt % TF_STAGES) * L::STAGE;
      float* sb = sa + L::A_ELEMS;
      const long long k0 = kb + (long long)kt * TF_BK;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int i = tid + TF_THREADS * j, r = i / (L::BM / 4), c4 = i % (L::BM / 4);
        const bool ok = k0 + r < ke && m0 + 4 * c4 < q.M;
        hm_cp_async<16>(sa + r * L::LA + 4 * c4, ok ? q.A + (k0 + r) * q.lda + m0 + 4 * c4 : q.A, ok);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int i = tid + TF_THREADS * j, r = i / (L::BN / 4), c4 = i % (L::BN / 4);
        const bool ok = k0 + r < ke && n0 + 4 * c4 < q.N;
        hm_cp_async<16>(sb + r * L::LB + 4 * c4, ok ? q.B + (k0 + r) * q.ldb + n0 + 4 * c4 : q.B, ok);
      }
    }
    hm_cp_commit();
  };

  // acc sums the K tiles' products in f32 (round to nearest); part, a K
  // tile's, is the tensor cores' own sum (see TF_BK)
  float acc[MT][NT][4] = {}, part[MT][NT][4];
  float colsum = 0.f;

#pragma unroll
  for (int s = 0; s < TF_STAGES - 1; ++s) load(s);
  for (int kt = 0; kt < ktiles; ++kt) {
    hm_cp_wait_upto(TF_STAGES - 2);
    __syncthreads();  // tile kt is in; every warp is done with the stage the next load refills
    load(kt + TF_STAGES - 1);
    const float* sa = tsm + (kt % TF_STAGES) * L::STAGE;
    const float* sb = sa + L::A_ELEMS;
    if (sums && tid < L::BN)
#pragma unroll 8
      for (int r = 0; r < TF_BK; ++r) colsum += sb[r * L::LB + tid];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TF_BK; kk += 8) {
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = wn * 8 * NT + nt * 8 + g;
        tf_split2(sb[(kk + t) * L::LB + col], sb[(kk + t + 4) * L::LB + col], bh[nt], bl[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = wm * 16 * MT + mt * 16 + g;
        const float av[4] = {sa[(kk + t) * L::LA + row], sa[(kk + t) * L::LA + row + 8],
                             sa[(kk + t + 4) * L::LA + row], sa[(kk + t + 4) * L::LA + row + 8]};
        uint32_t ah[4], al[4];
        tf_split4(av, ah, al);
        // term by term over the N tiles: NT independent products between two
        // terms of one accumulator
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) tf_mma(part[mt][nt], al, bh[nt]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) tf_mma(part[mt][nt], ah, bl[nt]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) tf_mma(part[mt][nt], ah, bh[nt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
  hm_cp_wait_upto(0);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        epi(split, m0 + wm * 16 * MT + mt * 16 + g + 8 * hh, n0 + wn * 8 * NT + nt * 8 + 2 * t, acc[mt][nt][2 * hh],
            acc[mt][nt][2 * hh + 1]);
  if (sums && tid < L::BN && n0 + tid < q.N) q.colsum[(size_t)split * q.N + n0 + tid] = colsum;
}

// The N tile (32 NT columns, NT 2, 3 or 4) that pads N the least; a tie
// takes the wider.
__host__ inline int tf_nt(int N) {
  int best = 4;
  long long pad = (long long)(N + 127) / 128 * 128;
  for (int nt = 3; nt >= 2; --nt) {
    const long long p = (long long)(N + 32 * nt - 1) / (32 * nt) * (32 * nt);
    if (p < pad) pad = p, best = nt;
  }
  return best;
}

template <int MT, int NT, typename Epi>
static cudaError_t tf_gemm_launch(const TfGemm& q, int splits, const Epi& epi, cudaStream_t stream) {
  using L = TfTile<MT, NT>;
  cudaError_t err = allow_smem(tf_gemm_kernel<MT, NT, Epi>, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((q.N + L::BN - 1) / L::BN), (unsigned)((q.M + L::BM - 1) / L::BM), (unsigned)splits);
  tf_gemm_kernel<MT, NT, Epi><<<grid, TF_THREADS, L::SMEM, stream>>>(q, epi);
  return cudaGetLastError();
}

// The product at tf_nt(N)'s width, in `splits` K splits. Operands: rows
// 16-byte aligned (lda, ldb multiples of 4, the bases 16-byte aligned); the
// values between M (or N) and the next multiple of 4 finite (they are read
// and multiply into dropped outputs).
template <int MT, typename Epi>
static cudaError_t tf_gemm(const TfGemm& q, int splits, const Epi& epi, cudaStream_t stream) {
  if (q.lda % 4 || q.ldb % 4 || (splits > 1 && q.ksplit % TF_BK) || q.ksplit < 1 ||
      (long long)splits * q.ksplit < q.K || (uintptr_t)q.A % 16 || (uintptr_t)q.B % 16)
    return cudaErrorInvalidValue;
  switch (tf_nt(q.N)) {
    case 2: return tf_gemm_launch<MT, 2>(q, splits, epi, stream);
    case 3: return tf_gemm_launch<MT, 3>(q, splits, epi, stream);
    default: return tf_gemm_launch<MT, 4>(q, splits, epi, stream);
  }
}

// v0 to o[0] and, when both, v1 to o[1]: one 8-byte store where o is
// 8-byte aligned (an odd row length leaves every other row's pairs on odd
// places).
__device__ __forceinline__ void tf_store2(float* o, float v0, float v1, bool both) {
  if (both && ((uintptr_t)o & 7) == 0) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    o[0] = v0;
    if (both) o[1] = v1;
  }
}

// The epilogue that stores columns below N of rows below M in f32 to rows
// ld apart. A row product's epilogue may name a second operand (AUX: a
// matrix aux, ld apart, of the product's M x N shape); tfw_gemm_kernel
// hands it the operand's values at (r, c), (r, c + 1).
struct TfStore {
  static constexpr bool AUX = false;  // a row product's epilogue reads no second operand
  float* out;
  long long M, ld;
  int N;
  __device__ __forceinline__ void operator()(int, long long r, int c, float v0, float v1, float2) const {
    if (r >= M || c >= N) return;
    tf_store2(out + r * ld + c, v0, v1, c + 1 < N);
  }
};

// The epilogue of a split product: split s's partial of the M x N result.
struct TfStorePart {
  float* part;
  long long M;
  int N;
  __device__ __forceinline__ void operator()(int s, long long r, int c, float v0, float v1) const {
    if (r >= M || c >= N) return;
    tf_store2(part + ((long long)s * M + r) * N + c, v0, v1, c + 1 < N);
  }
};

// The q|k|v epilogue of a window-attention half (B5's pass 1 and B8's):
// column p HD + h DP + j holds part p (q, k, v) of head h's column j plus
// its bias, q scaled by 1/sqrt(d); zero for j >= d.
struct TfQkv {
  static constexpr bool AUX = false;
  float* qkv;
  const float* bqkv;
  long long rows;
  int K3, HD, DP, C, d;
  float scale;
  __device__ __forceinline__ void operator()(int, long long r, int c, float v0, float v1, float2) const {
    if (r >= rows || c >= K3) return;
    const int p = c / HD, h = (c - p * HD) / DP, j = c - p * HD - h * DP;  // c even, DP a multiple of 16
    const float sc = p == 0 ? scale : 1.f;
    const float* b = bqkv + p * C + h * d + j;
    *reinterpret_cast<float2*>(qkv + r * K3 + c) =
        make_float2(j < d ? (v0 + __ldg(b)) * sc : 0.f, j + 1 < d ? (v1 + __ldg(b + 1)) * sc : 0.f);
  }
};

// The residual epilogue that ends a forward half (B5's projection, B6's
// fc2): y = x + d_r (acc + bias) to row r of out (C a row, C a multiple of
// 4), d_r = dp[r / rps] (1 without dp); x (aux, C a row, 16-byte aligned)
// comes in through shared memory ahead of the epilogue.
struct TfResid {
  static constexpr bool AUX = true;
  const float* aux;  // x, or B6's joined x'
  long long ld;
  float* out;
  const float *bias, *dp;
  long long rows, rps;
  int C;
  __device__ __forceinline__ void operator()(int, long long r, int c, float v0, float v1, float2 x) const {
    if (r >= rows || c >= C) return;
    const float dd = dp ? __ldg(dp + r / rps) : 1.f;
    *reinterpret_cast<float2*>(out + r * C + c) =
        make_float2(x.x + dd * (v0 + __ldg(bias + c)), x.y + dd * (v1 + __ldg(bias + c + 1)));
  }
};

// -- the row products on wgmma ------------------------------------------------------
//
// The row products (a token row's activations times the weights: q|k|v,
// dattn and dln in B8, h1, dg1 and dln in B7) run on wgmma's tf32 form,
// m64nNk8, one warpgroup a 64 x BN output tile (BN 64 or 96): A from
// registers (this warp's 16 rows, mma.m16n8k8's A fragment, split once by
// the warp that owns the rows), B from shared memory in both its halves. The
// weights change every step, so the pack splits them once a call (tfw_pack)
// into the images a stage copies as they lie: per N tile and 32-row K stage,
// the hi image then the lo image of its BN x 32 values, K-major core
// matrices of 8 n x 4 k (128 contiguous bytes; k groups 128 bytes apart,
// n groups 1024). tf32 takes no transposed operand, so only the row
// products run here; the weight gradients (A^T B over the token rows) keep
// tf_gemm_kernel. Each stage's 12 products go to a fresh accumulator, added
// to the running f32 sum (see TF_BK).
constexpr int TFW_STAGES = 2;  // three blocks an SM (two stages of 33.8 KB at BN 96); three stages: two, slower

template <int N>
__device__ __forceinline__ void tfw_rs(float* d, const uint32_t (&a)[4], uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void tfw_rs<32>(float* d, const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void tfw_rs<64>(float* d, const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void tfw_rs<96>(float* d, const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// Element (k, n) of a stage image (32 K rows x BN columns), in floats.
__host__ __device__ inline int tfw_image(int k, int n) { return (n / 8) * 256 + (k / 4) * 32 + (n % 8) * 4 + k % 4; }

// The N tile of a row product: 96 columns unless 64 pads N less (64 pads no
// more than 128 ever does). Mirrored by ops/cuda/tf32x3.py tfw_bn.
__host__ __device__ inline int tfw_bn(int N) { return (N + 95) / 96 * 96 <= (N + 63) / 64 * 64 ? 96 : 64; }

// Values of a K x N product's packed hi images (its lo images as many).
__host__ __device__ inline long long tfw_elems(int K, int N) {
  const int bn = tfw_bn(N);
  return (long long)((N + bn - 1) / bn) * ((K + TF_BK - 1) / TF_BK) * bn * TF_BK;
}

template <int BN>
struct TfwTile {
  static constexpr int LA = TF_BK + 4;  // A's rows (floats): conflict-free fragment loads
  static constexpr int A_ELEMS = 64 * LA, STAGE = A_ELEMS + 2 * BN * TF_BK;
  static constexpr size_t SMEM = (size_t)TFW_STAGES * STAGE * 4;
};

struct TfwGemm {
  const float* A;  // M x K row-major, lda apart
  const float* B;  // the packed images (tfw_pack)
  long long lda, M;
  int K, N;
};

template <int BN, typename Epi>
__global__ void __launch_bounds__(128) tfw_gemm_kernel(const TfwGemm q, const Epi epi) {
  using L = TfwTile<BN>;
  constexpr int NA = BN / 2;  // accumulators a thread
  extern __shared__ __align__(128) float wsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const long long m0 = (long long)blockIdx.y * 64;  // the N tiles of an M tile run together: A read once
  const int ktiles = (q.K + TF_BK - 1) / TF_BK;
  const float* img = q.B + (long long)blockIdx.x * ktiles * 2 * BN * TF_BK;

  // K stage kt into stage kt % TFW_STAGES, one cp.async group (empty past the last)
  auto load = [&](int kt) {
    if (kt < ktiles) {
      float* sa = wsm + (kt % TFW_STAGES) * L::STAGE;
      const int k0 = kt * TF_BK;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = tid + 128 * j, r = i >> 3, c4 = i & 7;
        const bool ok = m0 + r < q.M && k0 + 4 * c4 < q.K;
        hm_cp_async<16>(sa + r * L::LA + 4 * c4, ok ? q.A + (m0 + r) * q.lda + k0 + 4 * c4 : q.A, ok);
      }
      const float* src = img + (long long)kt * 2 * BN * TF_BK;
      float* sb = sa + L::A_ELEMS;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int i = tid + 128 * j;
        hm_cp_async<16>(sb + 4 * i, src + 4 * i, true);
      }
    }
    hm_cp_commit();
  };

  float acc[NA] = {}, part[NA];
#pragma unroll
  for (int s = 0; s < TFW_STAGES - 1; ++s) load(s);
  for (int kt = 0; kt < ktiles; ++kt) {
    hm_cp_wait_upto(TFW_STAGES - 2);
    wg_proxy_fence();  // this thread's copies, seen by wgmma
    __syncthreads();   // stage kt is in; every warp is done with the stage the next load refills
    load(kt + TFW_STAGES - 1);
    const float* sa = wsm + (kt % TFW_STAGES) * L::STAGE;
    const float* sb = sa + L::A_ELEMS;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* r0 = sa + (16 * warp + g) * L::LA + 8 * kk + t;
      const float av[4] = {r0[0], r0[8 * L::LA], r0[4], r0[8 * L::LA + 4]};
      tf_split4(av, ah[kk], al[kk]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bh = wg_desc(sb + 64 * kk, 128, 1024), bl = wg_desc(sb + BN * TF_BK + 64 * kk, 128, 1024);
      tfw_rs<BN>(part, al[kk], bh, kk > 0);
      tfw_rs<BN>(part, ah[kk], bl, 1);
      tfw_rs<BN>(part, ah[kk], bh, 1);
    }
    wg_commit();
    wg_wait0();
    wg_hold<NA>(part);
    wg_hold<16>(&ah[0][0]);
    wg_hold<16>(&al[0][0]);
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] += part[i];
    if constexpr (Epi::AUX) {
      if (kt == ktiles - 1) {
        // the epilogue's second operand (a 64 x BN tile of epi.aux) into a
        // stage no load refills, in flight under the last products
        float* ax = wsm + ((kt + 1) % TFW_STAGES) * L::STAGE;
        for (int i = tid; i < 64 * BN / 4; i += 128) {
          const int r = i / (BN / 4), c4 = i % (BN / 4);
          const bool ok = m0 + r < q.M && n0 + 4 * c4 < q.N;
          hm_cp_async<16>(ax + r * (BN + 4) + 4 * c4, ok ? epi.aux + (m0 + r) * epi.ld + n0 + 4 * c4 : epi.aux, ok);
        }
        hm_cp_commit();
      }
    }
  }
  hm_cp_wait_upto(0);
  const float* ax = wsm + (ktiles % TFW_STAGES) * L::STAGE;
  if (Epi::AUX) __syncthreads();
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * warp + g + 8 * hh, c = 8 * nt + 2 * t;
      const float2 x = Epi::AUX ? *reinterpret_cast<const float2*>(ax + r * (BN + 4) + c) : make_float2(0.f, 0.f);
      epi(0, m0 + r, n0 + c, acc[4 * nt + 2 * hh], acc[4 * nt + 2 * hh + 1], x);
    }
}

template <int BN, typename Epi>
static cudaError_t tfw_gemm_launch(const TfwGemm& q, const Epi& epi, cudaStream_t stream) {
  using L = TfwTile<BN>;
  cudaError_t err = allow_smem(tfw_gemm_kernel<BN, Epi>, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((q.N + BN - 1) / BN), (unsigned)((q.M + 63) / 64));
  tfw_gemm_kernel<BN, Epi><<<grid, 128, L::SMEM, stream>>>(q, epi);
  return cudaGetLastError();
}

// C = A B for a row product, B packed by tfw_pack for (K, N); A's rows
// 16-byte aligned (lda a multiple of 4), K a multiple of 4, the values
// between M and the next multiple of 4 never read.
template <typename Epi>
static cudaError_t tfw_gemm(const TfwGemm& q, const Epi& epi, cudaStream_t stream) {
  if (q.lda % 4 || q.K % 4 || (uintptr_t)q.A % 16 || (uintptr_t)q.B % 16) return cudaErrorInvalidValue;
  return tfw_bn(q.N) == 96 ? tfw_gemm_launch<96>(q, epi, stream) : tfw_gemm_launch<64>(q, epi, stream);
}

// The packed images of one product: value i of the hi images is the element
// at flat index idx[i] of a (na elements) and b (nb elements) laid end to
// end, or 0 past both; it goes to its stage block (bnk values a block) as
// tf32(v) in the block's hi image and tf32(v - hi) in its lo image.
__global__ void tfw_pack_kernel(const float* __restrict__ a, long long na, const float* __restrict__ b, long long nb,
                                const int* __restrict__ idx, long long n, int bnk, float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const long long k = idx[i], blk = i / bnk, pos = i - blk * bnk;
    const float v = k < na ? a[k] : (k < na + nb ? b[k - na] : 0.f);
    uint32_t hi, lo;
    tf_split(v, hi, lo);
    out[2 * blk * bnk + pos] = __uint_as_float(hi);
    out[2 * blk * bnk + bnk + pos] = __uint_as_float(lo);
  }
}

// The images of a K x N product whose index table starts at idx, to out
// (2 tfw_elems(K, N) floats).
static cudaError_t tfw_pack(const float* a, long long na, const float* b, long long nb, const int* idx, int K, int N,
                            float* out, cudaStream_t stream) {
  const long long n = tfw_elems(K, N);
  tfw_pack_kernel<<<(int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024), 256, 0, stream>>>(
      a, na, b, nb, idx, n, tfw_bn(N) * TF_BK, out);
  return cudaGetLastError();
}

// The weight gradient's plan: dW (M x N) = A^T B over K token rows in
// `splits` ranges of `krows` rows, about two blocks an SM (two waves of the
// one-block tiles). wgmma's tf32 form cannot read both operands
// token-major; a version that wrote each stage's B tile, split, into K-major
// images for it (the next stage's image under this stage's products) took
// 1.48 ms at B8's shapes against this kernel's 0.92.
struct TfWgradPlan {
  int mt, splits;
  long long krows, part_elems;  // splits x M x N, then splits x N column sums
};

__host__ inline TfWgradPlan tf_wgrad_plan(long long K, int M, int N, int sms) {
  TfWgradPlan p;
  p.mt = TF_WGRAD_MT;
  const int nt = tf_nt(N);
  const long long tiles = (long long)((M + 32 * p.mt - 1) / (32 * p.mt)) * ((N + 32 * nt - 1) / (32 * nt));
  const long long chunks = (K + TF_BK - 1) / TF_BK;
  long long s = (2LL * sms + tiles - 1) / tiles;
  if (s > chunks) s = chunks;
  if (s < 1) s = 1;
  p.krows = (chunks + s - 1) / s * TF_BK;
  p.splits = (int)((K + p.krows - 1) / p.krows);
  if (p.splits < 1) p.splits = 1;
  p.part_elems = (long long)p.splits * M * N + (long long)p.splits * N;
  return p;
}

// dw (M x N) = A^T B over K rows (A: K x M, B: K x N, rows lda / ldb apart)
// and, when db is set, db = the column sums of B; every partial summed in
// a fixed order. `part` holds tf_wgrad_plan(K, M, N, sms).part_elems floats.
static cudaError_t tf_wgrad(const float* A, long long lda, const float* B, long long ldb, long long K, int M, int N,
                            float* dw, float* db, float* part, int sms, cudaStream_t stream) {
  const TfWgradPlan p = tf_wgrad_plan(K, M, N, sms);
  float* colpart = part + (size_t)p.splits * M * N;
  const TfGemm q{A, B, lda, ldb, M, K, N, p.krows, db ? colpart : nullptr};
  const TfStorePart epi{part, M, N};
  cudaError_t err = tf_gemm<TF_WGRAD_MT>(q, p.splits, epi, stream);
  if (err != cudaSuccess) return err;
  err = reduce_parts(part, p.splits, (long long)M * N, dw, stream);
  if (err != cudaSuccess || !db) return err;
  return reduce_parts(colpart, p.splits, N, db, stream);
}

// -- the row passes, a warp a row ----------------------------------------------------

// The lane's four-column pieces l and l + 32 of an f32 row (zero past C).
__device__ __forceinline__ void tf_load_row(const float* xr, int C, float4 (&v)[2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = 4 * (lane + 32 * j);
    v[j] = c < C ? *reinterpret_cast<const float4*>(xr + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// LN of one row held as the lane's pieces (tf_load_row; eps 1e-5, f32
// statistics: the mean, then the mean of the squared deviations) to lnr,
// and (mean, rstd) to stats when it is set. C a multiple of 4, at most
// TF_MAX_C.
__device__ __forceinline__ void tf_ln_fwd(const float4 (&v)[2], int C, const float* ln_w, const float* ln_b,
                                          float* lnr, float* stats = nullptr) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) s += (v[j].x + v[j].y) + (v[j].z + v[j].w);
  const float mean = warp_sum(s) / C;
  float qs = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (4 * (lane + 32 * j) < C) {
      const float a = v[j].x - mean, b = v[j].y - mean, c = v[j].z - mean, d = v[j].w - mean;
      qs += (a * a + b * b) + (c * c + d * d);
    }
  const float rstd = rsqrtf(warp_sum(qs) / C + 1e-5f);
  if (stats && lane == 0) stats[0] = mean, stats[1] = rstd;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = 4 * (lane + 32 * j);
    if (c >= C) continue;
    const float4 w = *reinterpret_cast<const float4*>(ln_w + c), b = *reinterpret_cast<const float4*>(ln_b + c);
    *reinterpret_cast<float4*>(lnr + c) =
        make_float4((v[j].x - mean) * rstd * w.x + b.x, (v[j].y - mean) * rstd * w.y + b.y,
                    (v[j].z - mean) * rstd * w.z + b.z, (v[j].w - mean) * rstd * w.w + b.w);
  }
}

// The backward's LN row: LN and its (mean, rstd) as tf_ln_fwd, and g_b = dd
// g to gbr.
__device__ __forceinline__ void tf_ln_row(const float* xr, const float* gr, float dd, int C, const float* ln_w,
                                          const float* ln_b, float* stats, float* lnr, float* gbr) {
  float4 v[2], gv[2];
  tf_load_row(xr, C, v);
  tf_load_row(gr, C, gv);
  tf_ln_fwd(v, C, ln_w, ln_b, lnr, stats);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = 4 * (threadIdx.x & 31) + 128 * j;
    if (c < C)
      *reinterpret_cast<float4*>(gbr + c) = make_float4(dd * gv[j].x, dd * gv[j].y, dd * gv[j].z, dd * gv[j].w);
  }
}

// Zeros to the C columns of a padding token's LN and g_b rows.
__device__ __forceinline__ void tf_zero_row(int C, float* lnr, float* gbr) {
  for (int c = 4 * (threadIdx.x & 31); c < C; c += 128) {
    *reinterpret_cast<float4*>(lnr + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(gbr + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The LN backward of one row and its dx, dx = d g + rstd (dxhat - mean(dxhat)
// - xhat mean(dxhat xhat)) + (1 - d) g with dxhat = dln s; this row's dln
// xhat and dln are added to the lane's column sums cs (per piece: four of
// dln xhat, then four of dln).
__device__ __forceinline__ void tf_lnb_row(const float* dlr, const float* xr, const float* gr, float* dxr, float mean,
                                           float rstd, float dd, int C, const float* ln_w, float (&cs)[2][8]) {
  const int lane = threadIdx.x & 31;
  float dl[2][4], xh[2][4], gv[2][4], w[2][4];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = 4 * (lane + 32 * j);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), x = a, gg = a, ww = a;
    if (c < C) {
      a = *reinterpret_cast<const float4*>(dlr + c);
      x = *reinterpret_cast<const float4*>(xr + c);
      gg = *reinterpret_cast<const float4*>(gr + c);
      ww = *reinterpret_cast<const float4*>(ln_w + c);
    }
    const float av[4] = {a.x, a.y, a.z, a.w}, xv[4] = {x.x, x.y, x.z, x.w}, gq[4] = {gg.x, gg.y, gg.z, gg.w},
                wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dl[j][e] = av[e], gv[j][e] = gq[e], w[j][e] = wv[e];
      xh[j][e] = c < C ? (xv[e] - mean) * rstd : 0.f;
      const float dxh = av[e] * wv[e];
      s1 += dxh;
      s2 += dxh * xh[j][e];
      cs[j][e] += av[e] * xh[j][e];
      cs[j][4 + e] += av[e];
    }
  }
  const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = 4 * (lane + 32 * j);
    if (c >= C) continue;
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] = dd * gv[j][e] + (dl[j][e] * w[j][e] - m1 - xh[j][e] * m2) * rstd + (1.f - dd) * gv[j][e];
    *reinterpret_cast<float4*>(dxr + c) = make_float4(y[0], y[1], y[2], y[3]);
  }
}

// A 256-thread block's column sums of dln xhat and dln (each warp's cs, the
// warps added in order) to out[0 .. 2C); `sums` is the block's shared 8 x 2
// TF_MAX_C scratch. Call with every thread of the block.
__device__ __forceinline__ void tf_lnb_sums(const float (&cs)[2][8], int C, float (*sums)[2 * TF_MAX_C], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = 4 * (lane + 32 * j);
    if (c < C)
#pragma unroll
      for (int e = 0; e < 4; ++e) sums[warp][c + e] = cs[j][e], sums[warp][C + c + e] = cs[j][4 + e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += 256) {
    float v = 0.f;
    for (int wi = 0; wi < 8; ++wi) v += sums[wi][i];
    out[i] = v;
  }
}
