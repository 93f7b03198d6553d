// B12 in bf16, written for the H100: the forward of the core of HAT's
// overlapping cross-attention,
//   out = softmax(q k^T + bias) v,
// on q (bw, heads, nq, d), already scaled by 1/sqrt(d), k and v (bw, heads,
// nk, d) and the bias (heads, nq, nk), f32 or bf16 as the caller hands it.
//
// Replaces studiosr_tpu/ops/pallas/oca_core.py::oca_core_fwd (:117, kernel
// _fwd_kernel at :57) in bf16; f32, the checks' dtype, keeps oca_core.cu on
// attn_core.cuh, and so do head dims above 32, more than 256 queries or 576
// keys. The contract is its: scores and the softmax in f32, p rounded to
// bf16 before its product with v, products accumulated in f32, the output
// rounded once. The softmax is taken online over 64-key chunks with the row
// max subtracted (a deliberate difference: ROADMAP.md C), so p is rounded
// before its division by the row sum, which follows the product.
//
// Bound on the card at HAT's training shapes (bw 512 = batch 32 x 16
// windows, 6 heads, nq 256, nk 576, d 30): 4 bw heads nq nk d = 54.4 GFLOP
// against 310 MB, so bytes (0.093 ms). oca_core.cu ran attn_core.cuh's row
// pass on mma.sync and staged the OCAB's 60-byte rows (a 360-byte token
// stride) in 4-byte cp.async pieces: 1.667 ms (NVIDIA H100 80GB HBM3, 700 W).
// Here, two passes, the precedent being B13's (oca_bwd_mma.cu):
// 0. of_pack_kernel: q, k and v, strided views read in place, into wgmma's
//    core-matrix images, per (window, head) 64-token tiles with d padded to
//    DP (32 at d 30) and tokens to whole tiles, the padding zero: q and k
//    K-major in d (the scores' A and B), v token-contiguous (K-major in the
//    keys: the B of p v), so no transpose is needed later and every later
//    read is a 16-byte cp.async. The keys of a chunk are stored permuted
//    (of_perm), k and v alike, so a thread's 16 score columns are 16
//    consecutive keys: its bias comes in 16-byte loads.
// 1. of_fwd_kernel, a block a (window, head, pair of query tiles), a
//    warpgroup a tile, two blocks an SM (80 KB of shared memory at nk 576):
//    the unit's k and v images and the pair's q tiles copied in, a cp.async
//    group a key chunk, so the first chunk's products start while the rest
//    arrive. For each 64-key chunk: s = q k^T on wgmma in registers, the
//    bias added (its loads issued before the products), keys past nk
//    masked; the online row max and sum in f32; p rounded to bf16 in
//    registers as wgmma's A fragment, o += p v on wgmma with A in registers.
//    The epilogue divides by the row sum, rounds, stages the tile row-major
//    in the warpgroup's own q tile and writes each row's d values to the
//    strided out view with consecutive lanes on consecutive bytes.
// The bias is the largest read: every block reads its 128 x nk slice, 1.8
// GB from L2 a launch in f32 at HAT's shapes (the score products are 58
// GFLOP). With the keys in score-fragment order a quad of lanes reads 64
// (f32) or 32 (bf16) contiguous bytes a row and a thread four or two
// 16-byte pieces; read as mma's fragment order lays it (8-byte pairs 32
// bytes apart) it cost the pass 0.23 ms in f32 and 0.39 in bf16
// (scripts/torch_ablate_cab_oca.py). A bias the caller hands in bf16 (the
// bf16 step gathers it from its bf16 table) is read as it is, half the
// bytes and the same values; an f32 bias is never rounded. No sums across
// blocks: two launches give the same bits.
//
// Measured at HAT's step shapes (scripts/torch_ablate_cab_oca.py, NVIDIA
// H100 80GB HBM3, 700.00 W): 0.676 ms a call with the step's bf16 bias (pack
// 0.226, attention 0.450), 0.736 with an f32 bias; SDPA with the bias as
// its mask 10.2.
#include "am_common.cuh"

constexpr int OF_MAX_NQ = 256, OF_MAX_NK = 576;

// Strides, in elements, of the eight tensors of oca_core.cu's stride table,
// (window, head, token) each: q, k, v, g (unused), out, dq, dk, dv (unused).
enum { OF_Q = 0, OF_K = 1, OF_V = 2, OF_O = 4, OF_N = 8 };

struct OfArgs {
  const bf16 *q, *k, *v;
  bf16* out;
  long long st[OF_N][3];
  const void* bias;  // (heads, nq, nk), f32 or bf16
  bf16* img;         // per unit: q (QT tiles), k (KT chunks), v (KT chunks), each 64 x DP
  long long units, unit_elems;
  int heads, nq, nk, d, QT, KT, pairs;  // pairs: out takes 4-byte stores
  int vec;  // the bias's rows take 16-byte loads (aligned base, nk a multiple of 16 bytes' worth)
};

// The key a chunk's image position p holds: p = 8 nt + 2 tq + e, the score
// fragment's column (nt, e) of lane quad index tq, holds key 16 tq + 2 nt +
// e, so a thread's 16 columns are 16 consecutive keys.
__host__ __device__ __forceinline__ int of_perm(int p) { return 16 * ((p & 7) >> 1) + 2 * (p >> 3) + (p & 1); }

// -- pass 0: the images -----------------------------------------------------------------

// One thread a 16-byte piece of every unit's image: in a q or k tile 8 d
// values of a token (am_kmajor(j, t, DP)), in a v chunk 8 tokens of a d
// column (am_kmajor(t, j, 64)).
template <int DP>
__global__ void __launch_bounds__(256) of_pack_kernel(const OfArgs a) {
  constexpr int JG = DP / 8, PIECES = AM_TOK * DP / 8;
  const int tiles = a.QT + 2 * a.KT;
  const long long per_unit = (long long)tiles * PIECES, total = a.units * per_unit;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < total;
       p += (long long)gridDim.x * blockDim.x) {
    const long long u = p / per_unit;
    const int r = (int)(p - u * per_unit), tile = r / PIECES, pc = r % PIECES;
    const int w = (int)(u / a.heads), h = (int)(u % a.heads);
    int which, ti, n;
    if (tile < a.QT) which = OF_Q, ti = tile, n = a.nq;
    else if (tile < a.QT + a.KT) which = OF_K, ti = tile - a.QT, n = a.nk;
    else which = OF_V, ti = tile - a.QT - a.KT, n = a.nk;
    const bf16* base = (which == OF_Q ? a.q : which == OF_K ? a.k : a.v) + w * a.st[which][0] + h * a.st[which][1];
    const long long ts = a.st[which][2];
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(0.f);
    int off;
    if (which != OF_V) {  // 8 d values of the token at image position t
      const int t = pc / JG, jg = pc % JG, token = ti * AM_TOK + (which == OF_K ? of_perm(t) : t);
      if (token < n) {
        const bf16* src = base + token * ts;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (8 * jg + e < a.d) vals[e] = src[8 * jg + e];
      }
      off = am_kmajor(8 * jg, t, DP);
    } else {  // column j at 8 image positions; a warp's lanes take consecutive j
      const int tg = pc / DP, j = pc % DP;
      if (j < a.d) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int token = ti * AM_TOK + of_perm(8 * tg + e);
          if (token < n) vals[e] = base[token * ts + j];
        }
      }
      off = am_kmajor(8 * tg, j, AM_TOK);
    }
    *reinterpret_cast<uint4*>(a.img + u * a.unit_elems + (long long)tile * AM_TOK * DP + off) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

// -- pass 1: the attention -----------------------------------------------------------------

// The bias of a thread's score fragments, rows r and r + 8, keys col .. col
// + 15 (of_perm's order: key col + 2 nt + e is column (nt, e)), zero
// outside (nq, nk): 16-byte loads where the row's 16 keys are in.
template <typename BT>
__device__ __forceinline__ void of_bias16(const OfArgs& a, int h, int r, int col, float (&bv)[2][16]) {
  const BT* b = reinterpret_cast<const BT*>(a.bias) + (size_t)h * a.nq * a.nk;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r + 8 * hh;
    const BT* p = b + (size_t)row * a.nk + col;
    if (row < a.nq && a.vec && col + 16 <= a.nk) {
      if constexpr (std::is_same<BT, float>::value) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
          bv[hh][4 * i] = f.x, bv[hh][4 * i + 1] = f.y, bv[hh][4 * i + 2] = f.z, bv[hh][4 * i + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
          const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
            bv[hh][8 * i + 2 * k] = f.x, bv[hh][8 * i + 2 * k + 1] = f.y;
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) bv[hh][i] = row < a.nq && col + i < a.nk ? to_f32(__ldg(p + i)) : 0.f;
    }
  }
}

// A block a (window, head, pair of query tiles), warpgroup w the tile 2 pair
// + w (past the last tile it computes on the next image's rows and stores
// nothing).
template <int DP, typename BT>
__global__ void __launch_bounds__(256, 2) of_fwd_kernel(const OfArgs a) {
  constexpr int NDT = DP / 8, KS = DP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, wr = wt >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int npair = (a.QT + 1) / 2, KT = a.KT;
  const long long u = blockIdx.x / npair;
  const int pair = blockIdx.x % npair, i = 2 * pair + wg, h = (int)(u % a.heads);
  const long long tile = (long long)AM_TOK * DP;
  bf16* K = (bf16*)smem;   // KT chunks of k
  bf16* VT = K + KT * tile;  // KT chunks of v, token-contiguous
  bf16* Q = VT + KT * tile;  // the pair's q tiles
  {
    const bf16* src = a.img + u * a.unit_elems;
    const int cp = (int)tile / 8, qp = 2 * cp;  // 16-byte pieces of a chunk, of the pair's q
    for (int c = 0; c < KT; ++c) {  // group c: chunk c of k and v (group 0 also the q tiles)
      for (int e = tid; e < 2 * cp + (c == 0 ? qp : 0); e += 256) {
        if (e < cp) hm_cp_async<16>(K + c * tile + 8 * e, src + (a.QT + c) * tile + 8 * e, true);
        else if (e < 2 * cp) hm_cp_async<16>(VT + c * tile + 8 * (e - cp), src + (a.QT + KT + c) * tile + 8 * (e - cp), true);
        else hm_cp_async<16>(Q + 8 * (e - 2 * cp), src + 2 * pair * tile + 8 * (e - 2 * cp), true);
      }
      hm_cp_commit();
    }
  }
  bf16* const Qw = Q + wg * tile;
  const int r0 = i * AM_TOK + 16 * wr + gq;  // this thread's query rows r0, r0 + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[NDT][4];
#pragma unroll
  for (int nt = 0; nt < NDT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll 1
  for (int c = 0; c < KT; ++c) {
    float bv[2][16];  // loaded before the products, so their latency hides under them
    const int key0 = c * AM_TOK + 16 * tq;  // this thread's 16 keys
    of_bias16<BT>(a, h, r0, key0, bv);
    hm_cp_wait_upto(KT - 1 - c);  // chunk c is in
    wg_proxy_fence();
    __syncthreads();
    float s[8][4];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wg_ss<64>(&s[0][0], wg_desc(Qw + ks * 128, 128, DP * 16), wg_desc(K + c * tile + ks * 128, 128, DP * 16),
                ks > 0);
    wg_commit();
    wg_wait0();
    wg_hold<32>(&s[0][0]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 2 * nt + (e & 1);  // column (nt, e & 1) holds key key0 + m
        s[nt][e] = key0 + m < a.nk ? s[nt][e] + bv[e >> 1][m] : -INFINITY;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      const float mn = fmaxf(m[hh], am_quad_max(mx) * AM_LOG2E), sc = am_exp2(m[hh] - mn);
      l[hh] *= sc, m[hh] = mn;
#pragma unroll
      for (int nt = 0; nt < NDT; ++nt) o[nt][2 * hh] *= sc, o[nt][2 * hh + 1] *= sc;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = am_exp2(fmaf(s[nt][2 * hh + e], AM_LOG2E, -mn));
          l[hh] += p, s[nt][2 * hh + e] = p;
        }
    }
    uint32_t pa[4][4];  // p as wgmma's A fragments, 16 keys each
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      pa[nt >> 1][(nt & 1) * 2] = hm_pack(s[nt][0], s[nt][1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(s[nt][2], s[nt][3]);
    }
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wg_rs<DP>(&o[0][0], pa[ks], wg_desc(VT + c * tile + ks * 128, 128, AM_TOK * 16), 1);
    wg_commit();
    wg_wait0();
    wg_hold<NDT * 4>(&o[0][0]);
    wg_hold<16>(&pa[0][0]);
  }
  // o / l, rounded, staged row-major (DP a row) in the warpgroup's own q
  // tile (no wgmma reads it any more), a warp its 16 rows; then each row's d
  // values to the out view.
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.f / am_quad_sum(l[hh]);
  bf16* const stage = Qw + 16 * wr * DP;
#pragma unroll
  for (int nt = 0; nt < NDT; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<__nv_bfloat162*>(stage + (gq + 8 * hh) * DP + nt * 8 + 2 * tq) =
          __floats2bfloat162_rn(o[nt][2 * hh] * inv[hh], o[nt][2 * hh + 1] * inv[hh]);
  __syncwarp();
  const long long w = u / a.heads;
  bf16* const out = a.out + w * a.st[OF_O][0] + h * a.st[OF_O][1];
  const int row0 = i * AM_TOK + 16 * wr;
  if (a.pairs) {
    const int half = a.d / 2;
    for (int e = lane; e < 16 * half; e += 32) {
      const int rr = e / half, jw = e - rr * half;
      if (i < a.QT && row0 + rr < a.nq)
        *reinterpret_cast<uint32_t*>(out + (row0 + rr) * a.st[OF_O][2] + 2 * jw) =
            *reinterpret_cast<const uint32_t*>(stage + rr * DP + 2 * jw);
    }
  } else {
    for (int e = lane; e < 16 * a.d; e += 32) {
      const int rr = e / a.d, j = e - rr * a.d;
      if (i < a.QT && row0 + rr < a.nq) out[(row0 + rr) * a.st[OF_O][2] + j] = stage[rr * DP + j];
    }
  }
}

// -- host ------------------------------------------------------------------------------

static bool of_shape_ok(int bw, int heads, int nq, int nk, int d) {
  return bw > 0 && heads > 0 && nq > 0 && nq <= OF_MAX_NQ && nk > 0 && nk <= OF_MAX_NK && d > 0 && d <= 32;
}

struct OfPlan {
  long long units, unit_elems, t_elems;
  int QT, KT, DP;
};

static OfPlan of_plan(int bw, int heads, int nq, int nk, int d) {
  OfPlan P;
  P.QT = (nq + AM_TOK - 1) / AM_TOK;
  P.KT = (nk + AM_TOK - 1) / AM_TOK;
  P.DP = d <= 16 ? 16 : 32;
  P.units = (long long)bw * heads;
  P.unit_elems = (long long)(P.QT + 2 * P.KT) * AM_TOK * P.DP;
  P.t_elems = P.units * P.unit_elems;
  return P;
}

// Elements of the bf16 scratch (the images).
extern "C" int oca_core_fwd_mma_scratch(int bw, int heads, int nq, int nk, int d, long long* t_elems) {
  if (!of_shape_ok(bw, heads, nq, nk, d)) return (int)cudaErrorInvalidValue;
  *t_elems = of_plan(bw, heads, nq, nk, d).t_elems;
  return 0;
}

template <int DP, typename BT>
static cudaError_t of_launch(const OfArgs& a, const OfPlan& P, cudaStream_t st) {
  const long long pieces = P.units * (P.QT + 2 * P.KT) * AM_TOK * (DP / 8);
  of_pack_kernel<DP><<<(int)((pieces + 255) / 256 < 8192 ? (pieces + 255) / 256 : 8192), 256, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t bytes = (size_t)(2 * P.KT + 2) * AM_TOK * DP * 2;
  err = allow_smem(of_fwd_kernel<DP, BT>, bytes);
  if (err != cudaSuccess) return err;
  of_fwd_kernel<DP, BT><<<(int)(P.units * ((P.QT + 1) / 2)), 256, bytes, st>>>(a);
  return cudaGetLastError();
}

// strides: (window, head, token) of q, k, v, g (unused), out, dq, dk, dv
// (unused), in elements; d contiguous in each. bias_bf16: the bias is bf16
// (else f32).
extern "C" int oca_core_fwd_mma_bf16(const void* q, const void* k, const void* v, const void* bias, void* out,
                                     const long long* strides, int bias_bf16, int bw, int heads, int nq, int nk,
                                     int d, void* tscratch, long long t_elems, void* stream) {
  if (!of_shape_ok(bw, heads, nq, nk, d)) return (int)cudaErrorInvalidValue;
  const OfPlan P = of_plan(bw, heads, nq, nk, d);
  if (P.t_elems != t_elems) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)tscratch % 16) return (int)cudaErrorMisalignedAddress;
  OfArgs a{};
  a.q = (const bf16*)q, a.k = (const bf16*)k, a.v = (const bf16*)v, a.out = (bf16*)out;
  for (int t = 0; t < OF_N; ++t)
    for (int j = 0; j < 3; ++j) a.st[t][j] = strides[3 * t + j];
  a.bias = bias;
  a.img = (bf16*)tscratch;
  a.units = P.units, a.unit_elems = P.unit_elems;
  a.heads = heads, a.nq = nq, a.nk = nk, a.d = d, a.QT = P.QT, a.KT = P.KT;
  a.pairs = d % 2 == 0 && (uintptr_t)out % 4 == 0;
  a.vec = (uintptr_t)bias % 16 == 0 && nk % (bias_bf16 ? 8 : 4) == 0;
  for (int j = 0; j < 3; ++j) a.pairs = a.pairs && strides[3 * OF_O + j] % 2 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (P.DP == 32)
    return (int)(bias_bf16 ? of_launch<32, bf16>(a, P, st) : of_launch<32, float>(a, P, st));
  return (int)(bias_bf16 ? of_launch<16, bf16>(a, P, st) : of_launch<16, float>(a, P, st));
}
