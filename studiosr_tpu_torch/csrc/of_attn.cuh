// B12's forward attention as the bf16 kernels written for the H100 share it
// (oca_fwd_mma.cu: B12; ocab_mma.cu: B10's attention pass): the operand
// images (per (window, head) unit, 64-token tiles in wgmma's core-matrix
// layout, the keys of a chunk in of_perm order), the pass that packs them
// from strided views (of_pack_kernel) and the attention pass over them
// (of_fwd_kernel). What the passes compute, and why they are laid out so:
// oca_fwd_mma.cu's header.
#pragma once

#include "am_common.cuh"
#include "lf_core.cuh"

// The attention pass holds a unit's whole k and v images in shared memory up
// to OF_MAX_NK keys (of_fwd_kernel: B12's oca_core_fwd_mma entry, B10 up to
// window 16); past it, and in B12's large entry, the pass is lf_core.cuh's
// (lf_fwd_kernel on LfOf), which streams the key chunks for any count.
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
  // what the attention pass reads: unit u's q tiles from qimg + u q_unit, its
  // k then v chunks from img + u unit_elems + kv0 (B12: qimg = img, q_unit =
  // unit_elems, kv0 = QT tiles; B10 keeps q where its projection wrote it)
  const bf16* qimg;
  long long q_unit, kv0;
  int heads, nq, nk, d, QT, KT, pairs;  // pairs: out takes 4-byte stores
  int vec;  // the bias's rows take 16-byte loads (aligned base, nk a multiple of 16 bytes' worth)
  int nrows;  // query rows stored (nq; B10 stores a padded window's whole tiles)
  void* bfrag;  // the bias in fragment order (of_bias_kernel), for lf_core.cuh's pass: of_bias_elems
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
// nothing). PADQ: the rows stored are a.nrows (B10's padded windows; the
// bias rows a.nq), else a.nq.
template <int DP, typename BT, bool PADQ = false>
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
    const bf16* kv = a.img + u * a.unit_elems + a.kv0;
    const bf16* qs = a.qimg + u * a.q_unit + 2 * pair * tile;
    const int cp = (int)tile / 8, qp = 2 * cp;  // 16-byte pieces of a chunk, of the pair's q
    for (int c = 0; c < KT; ++c) {  // group c: chunk c of k and v (group 0 also the q tiles)
      for (int e = tid; e < 2 * cp + (c == 0 ? qp : 0); e += 256) {
        if (e < cp) hm_cp_async<16>(K + c * tile + 8 * e, kv + c * tile + 8 * e, true);
        else if (e < 2 * cp) hm_cp_async<16>(VT + c * tile + 8 * (e - cp), kv + (KT + c) * tile + 8 * (e - cp), true);
        else hm_cp_async<16>(Q + 8 * (e - 2 * cp), qs + 8 * (e - 2 * cp), true);
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
      if (i < a.QT && row0 + rr < (PADQ ? a.nrows : a.nq))
        *reinterpret_cast<uint32_t*>(out + (row0 + rr) * a.st[OF_O][2] + 2 * jw) =
            *reinterpret_cast<const uint32_t*>(stage + rr * DP + 2 * jw);
    }
  } else {
    for (int e = lane; e < 16 * a.d; e += 32) {
      const int rr = e / a.d, j = e - rr * a.d;
      if (i < a.QT && row0 + rr < (PADQ ? a.nrows : a.nq)) out[(row0 + rr) * a.st[OF_O][2] + j] = stage[rr * DP + j];
    }
  }
}

// Above OF_MAX_NK keys (and in B12's large entry) the pass runs on
// lf_core.cuh's pipelined forward, a block a (unit, query tile). Its bias
// is first put in fragment order by of_bias_kernel (below), so a stage
// takes a tile's bias in one bulk copy (a copy a 64-key row, 192 a chunk
// for a first version's three tiles, held the pass to the copy engine's
// rate: 5.6 ms at the HAT window-24 step, scripts/torch_ablate_large_fwd.py).
// This family's part: the images as of_fwd_kernel reads them; rows below
// a.nrows stored through the block's q tile, as of_fwd_kernel stores them.
template <int DP>
struct LfOf {
  OfArgs a;
  int QT, KT, heads;
  long long units;
  const void* bias;  // a.bfrag
  __device__ const bf16* q(long long u, int r) const { return a.qimg + u * a.q_unit + (long long)r * AM_TOK * DP; }
  __device__ const bf16* k(long long u, int c) const {
    return a.img + u * a.unit_elems + a.kv0 + (long long)c * AM_TOK * DP;
  }
  __device__ const bf16* v(long long u, int c) const {
    return a.img + u * a.unit_elems + a.kv0 + (long long)(a.KT + c) * AM_TOK * DP;
  }
  __device__ bool masked(long long) const { return false; }
  __device__ int tag(long long, int) const { return 0; }
  // o / l, rounded, staged row-major (DP a row) in the warpgroup's own q
  // tile, a warp its 16 rows; then each row's d values to the out view
  __device__ void store(long long u, int r, const float (&o)[DP / 8][4], const float (&inv)[2], bf16* Qw) const {
    const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) & 3, gq = lane >> 2, tq = lane & 3;
    bf16* const stage = Qw + 16 * wr * DP;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<__nv_bfloat162*>(stage + (gq + 8 * hh) * DP + nt * 8 + 2 * tq) =
            __floats2bfloat162_rn(o[nt][2 * hh] * inv[hh], o[nt][2 * hh + 1] * inv[hh]);
    __syncwarp();
    bf16* const out = a.out + u / heads * a.st[OF_O][0] + (u % heads) * a.st[OF_O][1];
    const int row0 = r * AM_TOK + 16 * wr;
    if (a.pairs) {
      const int half = a.d / 2;
      for (int e = lane; e < 16 * half; e += 32) {
        const int rr = e / half, jw = e - rr * half;
        if (row0 + rr < a.nrows)
          *reinterpret_cast<uint32_t*>(out + (row0 + rr) * a.st[OF_O][2] + 2 * jw) =
              *reinterpret_cast<const uint32_t*>(stage + rr * DP + 2 * jw);
      }
    } else {
      for (int e = lane; e < 16 * a.d; e += 32) {
        const int rr = e / a.d, j = e - rr * a.d;
        if (row0 + rr < a.nrows) out[(row0 + rr) * a.st[OF_O][2] + j] = stage[rr * DP + j];
      }
    }
  }
};

// The bias (heads, nq, nk; BT) in lf_core.cuh's fragment order, as
// am_bias_kernel lays B5's: group ((h QT + r) KT + c) 1024 + 128 nt + wt (a
// float4, or four bf16) is thread wt's score fragment of query tile r, key
// chunk c, 8-column tile nt: rows q, q + 8 (q = 64 r + 16 (wt / 32) + wt % 32
// / 4), image positions p, p + 1 (p = 8 nt + 2 (wt % 4)), which hold keys
// 64 c + of_perm(p) and the next; -inf past nk (as the old pass scored keys
// past nk), 0 past nq. bf16 stays bf16, f32 f32.
template <typename BT>
__global__ void of_bias_kernel(const BT* __restrict__ bias, int heads, int nq, int nk, int QT, int KT,
                               BT* __restrict__ out) {
  const long long groups = (long long)heads * QT * KT * 1024;
  const BT ninf = from_f32<BT>(-INFINITY), zero = from_f32<BT>(0.f);
  for (long long gi = blockIdx.x * (long long)blockDim.x + threadIdx.x; gi < groups;
       gi += (long long)gridDim.x * blockDim.x) {
    const int wt = (int)(gi % 128), nt = (int)(gi / 128 % 8), c = (int)(gi / 1024 % KT);
    const long long hr = gi / (1024LL * KT);
    const int r = (int)(hr % QT), h = (int)(hr / QT);
    const int q = AM_TOK * r + 16 * (wt >> 5) + ((wt & 31) >> 2), key = AM_TOK * c + of_perm(8 * nt + 2 * (wt & 3));
    BT v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int qq = q + 8 * (k >> 1), kk = key + (k & 1);
      v[k] = kk >= nk ? ninf : qq >= nq ? zero : bias[((long long)h * nq + qq) * nk + kk];
    }
    if constexpr (std::is_same<BT, float>::value) {
      reinterpret_cast<float4*>(out)[gi] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      __nv_bfloat162 v0, v1;
      v0.x = v[0], v0.y = v[1], v1.x = v[2], v1.y = v[3];
      reinterpret_cast<uint2*>(out)[gi] =
          make_uint2(*reinterpret_cast<uint32_t*>(&v0), *reinterpret_cast<uint32_t*>(&v1));
    }
  }
}

// Elements of bf16 scratch the fragment-ordered bias takes (b16: a bf16
// bias, else an f32 one).
__host__ __device__ inline long long of_bias_elems(int heads, int QT, int KT, bool b16) {
  return (long long)heads * QT * KT * 1024 * (b16 ? 4 : 8);
}

// -- host ------------------------------------------------------------------------------

// The geometries of B12's entries: the whole-unit one takes at most
// OF_MAX_NQ queries and OF_MAX_NK keys, the large one (`any`) every count.
static bool of_shape_ok(int bw, int heads, int nq, int nk, int d, bool any = false) {
  return bw > 0 && heads > 0 && nq > 0 && nk > 0 && d > 0 && d <= 32 && (any || (nq <= OF_MAX_NQ && nk <= OF_MAX_NK));
}

// The attention pass: every key chunk in its own buffer up to OF_MAX_NK
// keys; above them, or in B12's large entry (`large`), lf_core.cuh's
// pipelined forward.
template <int DP, typename BT>
static cudaError_t of_attn_launch(const OfArgs& a, cudaStream_t st, bool large = false) {
  if (large || a.KT * AM_TOK > OF_MAX_NK) {
    const long long groups = (long long)a.heads * a.QT * a.KT * 1024;
    of_bias_kernel<BT><<<(int)((groups + 255) / 256 < 8192 ? (groups + 255) / 256 : 8192), 256, 0, st>>>(
        (const BT*)a.bias, a.heads, a.nq, a.nk, a.QT, a.KT, (BT*)a.bfrag);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return lf_launch<DP>(LfOf<DP>{a, a.QT, a.KT, a.heads, a.units, a.bfrag}, std::is_same<BT, bf16>::value, st);
  }
  const bool padq = a.nrows != a.nq;
  const size_t bytes = (size_t)(2 * a.KT + 2) * AM_TOK * DP * 2;
  const int blocks = (int)(a.units * ((a.QT + 1) / 2));
  auto kernel = padq ? of_fwd_kernel<DP, BT, true> : of_fwd_kernel<DP, BT>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 256, bytes, st>>>(a);
  return cudaGetLastError();
}

struct OfPlan {
  long long units, unit_elems, t_elems, bias;  // bias: where the fragment-ordered bias starts (large)
  int QT, KT, DP;
};

// The scratch: the images, then (`large`: lf_core.cuh's pass) the bias in
// fragment order (b16: bf16, else f32).
static OfPlan of_plan(int bw, int heads, int nq, int nk, int d, bool large, bool b16) {
  OfPlan P;
  P.QT = (nq + AM_TOK - 1) / AM_TOK;
  P.KT = (nk + AM_TOK - 1) / AM_TOK;
  P.DP = d <= 16 ? 16 : 32;
  P.units = (long long)bw * heads;
  P.unit_elems = (long long)(P.QT + 2 * P.KT) * AM_TOK * P.DP;
  P.bias = P.units * P.unit_elems;
  P.t_elems = P.bias + (large ? of_bias_elems(heads, P.QT, P.KT, b16) : 0);
  return P;
}

