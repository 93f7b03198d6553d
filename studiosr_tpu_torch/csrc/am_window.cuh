// The window-attention half of a Swin block as the bf16 kernels written for
// the H100 see it (attn_bwd_mma.cu: B8 / B9, window_attention_mma.cu: B5):
// tokens in tile order (64 tokens a tile: a window at 8, a quarter of one at
// 16; a window of N = ws^2 tokens takes NCH = ceil(N / 64) tiles, the tokens
// past N padding that no pass loads or stores: LN and g_b rows of zeros, keys
// whose bias is -inf), the shift folded into reads and writes, the geometry
// and the packed
// weights' layout (mirrored by ops/cuda/attn_bwd.py and
// ops/cuda/window_attention.py), and the passes both directions share: the
// LN rows (am_ln_kernel), q|k|v on wgmma (am_proj_kernel; with dattn in the
// backward) and the rel-pos bias in fragment order (am_bias_kernel).
#pragma once

#include "am_common.cuh"

// The geometry, shared by the kernels and the host; the packed layouts are
// mirrored by ops/cuda/attn_bwd.py (the backward's) and
// ops/cuda/window_attention.py (the forward's).
struct AmGeom {
  int C, heads, d, DP, KC, HD, K3, NP, ws, N, NCH, SC, NV;  // N: NCH whole tiles; NV = ws^2 of them real
  __host__ __device__ AmGeom(int C_, int heads_, int ws_) : C(C_), heads(heads_), ws(ws_) {
    d = C / heads;
    DP = am_pad16(d);
    KC = am_pad16(C);
    HD = heads * DP;
    K3 = 3 * HD;
    NP = am_np(C);
    NV = ws * ws;
    NCH = (NV + AM_TOK - 1) / AM_TOK;
    N = NCH * AM_TOK;
    SC = (C + 7) & ~7;
  }
  // a head's weights: q|k|v (KC x 3 DP) and Wproj^T's head columns (KC x
  // DP), in stages of AM_KROWS K rows, each q|k|v's rows then Wproj^T's
  __host__ __device__ int proj_stages() const { return (KC + AM_KROWS - 1) / AM_KROWS; }
  __host__ __device__ int proj_rows(int s) const { return am_min(AM_KROWS, KC - AM_KROWS * s); }
  __host__ __device__ long long proj_elems() const { return (long long)heads * 4 * KC * DP; }
  __host__ __device__ int dln_stages() const { return (K3 + AM_KSTAGE - 1) / AM_KSTAGE; }
  __host__ __device__ int dln_rows(int s) const { return am_min(AM_KSTAGE, K3 - AM_KSTAGE * s); }
  __host__ __device__ long long pack_elems() const { return proj_elems() + (long long)K3 * NP; }
  // the forward's packed weights: per head its q|k|v columns (KC x 3 DP) in
  // stages of AM_KROWS K rows, then Wproj (HD x NP: row h DP + j is Wproj's
  // row h d + j) in stages of AM_KSTAGE rows
  __host__ __device__ long long qkv_elems() const { return (long long)heads * 3 * KC * DP; }
  __host__ __device__ long long fwd_pack_elems() const { return qkv_elems() + (long long)HD * NP; }
};

struct AmArgs {
  const bf16 *x, *g;  // g, gb and stats are unused (null) in the forward
  bf16* dx;           // the forward's output, or the backward's dx
  const float *ln_w, *ln_b, *bqkv, *bproj, *dp;
  const void* relbias;  // the bias in fragment order (am_bias_kernel): f32, or bf16 when bias16
  const bf16* w;  // the packed weights
  bf16 *img, *ln, *gb, *att, *dqkv;
  float *stats, *dbias_part, *lnst, *dln;
  int H, W, shift, nwx, nwi, windows, tiles, groups, bias16;
};

// Whether token t (0..63) of tile `tile` is one of its window's NV tokens
// (always, without the division, when the window fills its tiles).
__device__ __forceinline__ bool am_valid(const AmGeom& G, int tile, int t) {
  return G.NV == G.N || (tile % G.NCH) * AM_TOK + t < G.NV;
}

// Pixel of token t (0..63) of tile `tile`: window tile / NCH, its tokens
// 64 (tile % NCH) + t, through the shift; only for a valid token.
__device__ __forceinline__ long long am_pixel(const AmGeom& G, const AmArgs& a, int tile, int t) {
  const int w = tile / G.NCH, n = (tile % G.NCH) * AM_TOK + t;
  const int img = w / a.nwi, wi = w % a.nwi;
  int y = (wi / a.nwx) * G.ws + n / G.ws + a.shift, x = (wi % a.nwx) * G.ws + n % G.ws + a.shift;
  if (y >= a.H) y -= a.H;
  if (x >= a.W) x -= a.W;
  return ((long long)img * a.H + y) * a.W + x;
}

// calculate_mask's region of window token n of the rolled map.
__device__ __forceinline__ int am_region(const AmGeom& G, const AmArgs& a, int wi, int n) {
  const int y = (wi / a.nwx) * G.ws + n / G.ws, x = (wi % a.nwx) * G.ws + n % G.ws;
  return 3 * (y < a.H - G.ws ? 0 : (y < a.H - a.shift ? 1 : 2)) + (x < a.W - G.ws ? 0 : (x < a.W - a.shift ? 1 : 2));
}

// -- LN rows (and g_b); q|k|v (and dattn) ------------------------------------------

// Shared memory of am_proj_kernel: the ring, its barriers, then per
// warpgroup its LN and g_b tiles (K-major, 64 x KC).
__host__ __device__ inline size_t am_proj_smem(const AmGeom& G) {
  return (size_t)AM_SLOTS * AM_SLOT_BYTES + AM_HEAD_BYTES + 2 * (size_t)2 * AM_TOK * G.KC * 2;
}

// Pass 0, a warp a token row (rows in tile order, many blocks an SM): LN
// (eps 1e-5, f32 statistics) into the row-major scratch (SC columns, zero
// past C), rounded; in the backward (BWD) also g_b = d g, rounded, and LN's
// (mean, rstd) into stats. PAD (a window that does not fill its tiles): a
// padding token's rows are zeros.
template <bool BWD, bool PAD>
__global__ void __launch_bounds__(256) am_ln_kernel(const AmArgs a, const AmGeom G, long long rows) {
  for (long long row = blockIdx.x * 8LL + (threadIdx.x >> 5); row < rows; row += gridDim.x * 8LL) {
    const int tile = (int)(row / AM_TOK);
    if (PAD && !am_valid(G, tile, (int)(row % AM_TOK))) {
      for (int c = 4 * (threadIdx.x & 31); c < G.SC; c += 128) {
        *reinterpret_cast<uint2*>(a.ln + row * G.SC + c) = make_uint2(0u, 0u);
        if (BWD) *reinterpret_cast<uint2*>(a.gb + row * G.SC + c) = make_uint2(0u, 0u);
      }
      if (BWD && (threadIdx.x & 31) == 0) a.stats[2 * row] = 0.f, a.stats[2 * row + 1] = 0.f;
      continue;
    }
    const long long off = am_pixel(G, a, tile, (int)(row % AM_TOK)) * G.C;
    const float dd = a.dp ? a.dp[(tile / G.NCH) / a.nwi] : 1.f;
    am_ln_row<BWD>(a.x + off, BWD ? a.g + off : nullptr, dd, G.C, G.SC, a.ln_w, a.ln_b,
                   BWD ? a.stats + 2 * row : nullptr, a.ln + row * G.SC, BWD ? a.gb + row * G.SC : nullptr);
  }
}

// One warpgroup a 64-token tile, two a block, persistent over tile pairs: per
// head, q|k|v = LN Wqkv (+ bqkv, q scaled by 1/sqrt(d)) and, in the backward
// (DATTN), dattn = g_b Wproj^T on wgmma, the head's packed weights streamed
// once per tile pair through the ring. The results go out rounded, as the
// K-major image of each (window, head, 64 tokens): q, k (and dattn) K-major
// in d, the operand of a product over d; v K-major in d in the backward and
// in the token (am_kmajor(t, j, 64)) in the forward, the operand of p v.
template <int DP, bool DATTN>
__global__ void __launch_bounds__(256, 1) am_proj_kernel(const AmArgs a, const AmGeom G) {
  constexpr int NQ = 3 * DP, NQT = NQ / 8, NDT = DP / 8, PARTS = DATTN ? 4 : 3;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int wg = warp >> 2, wr = warp & 3;
  bf16* lnb = (bf16*)(smem + AM_SLOTS * AM_SLOT_BYTES + AM_HEAD_BYTES) + (size_t)wg * 2 * AM_TOK * G.KC;
  bf16* gbb = lnb + AM_TOK * G.KC;
  const int npairs = (a.tiles + 1) / 2;
  const int pairs = blockIdx.x < npairs ? (npairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int hst = G.proj_stages(), nst = G.heads * hst;
  AmRing ring = am_ring_start(smem, a.w, nst, nst * pairs, 8, [&](int j) { return PARTS * G.proj_rows(j % hst) * DP; });
  const float qscale = rsqrtf((float)G.d);
  const int KC = G.KC, N = G.N;
  for (int p = blockIdx.x; p < npairs; p += gridDim.x) {
    const int tile = 2 * p + wg;
    const bool valid = tile < a.tiles;
    am_wg_sync(wg);  // the warpgroup's products on the last tiles are done
    am_load_rows(KC, G.SC, a.ln, tile, valid, lnb);
    if (DATTN) am_load_rows(KC, G.SC, a.gb, tile, valid, gbb);
    hm_cp_commit();
    hm_cp_wait_upto(0);
    wg_proxy_fence();
    am_wg_sync(wg);
    const int w = tile / G.NCH, c = tile % G.NCH;
    for (int h = 0; h < G.heads; ++h) {
      float aq[NQT][4], ad[NDT][4];
      for (int sk = 0; sk < hst; ++sk) {
        const bf16* st = ring.acquire();
        const int k0 = sk * AM_KROWS, kr = G.proj_rows(sk);
        wg_fence();
        for (int kk = 0; kk < kr; kk += 16)
          wg_ss<NQ>(&aq[0][0], wg_desc(lnb + (k0 + kk) * 8, 128, KC * 16), wg_desc(st + kk * 8, 128, kr * 16),
                    k0 + kk > 0);
        if constexpr (DATTN)
          for (int kk = 0; kk < kr; kk += 16)
            wg_ss<DP>(&ad[0][0], wg_desc(gbb + (k0 + kk) * 8, 128, KC * 16),
                      wg_desc(st + kr * NQ + kk * 8, 128, kr * 16), k0 + kk > 0);
        wg_commit();
        wg_wait0();
        wg_hold<NQT * 4>(&aq[0][0]);
        if constexpr (DATTN) wg_hold<NDT * 4>(&ad[0][0]);
        ring.release();
      }
      if (!valid) continue;
      // q (scaled), k, v (, dattn) of the (window, head) unit, chunk c:
      // images of 64 x DP, array order q, k, v (, dattn)
      bf16* unit = a.img + ((long long)w * G.heads + h) * PARTS * N * DP + c * AM_TOK * DP;
#pragma unroll
      for (int nt = 0; nt < NQT + (DATTN ? NDT : 0); ++nt) {
        const int part = nt < NQT ? nt / NDT : 3, j = (nt < NQT ? nt % NDT : nt - NQT) * 8 + 2 * tq;
        const float* acc = nt < NQT ? aq[nt] : ad[nt - NQT];
        float b0 = 0.f, b1 = 0.f;
        if (part < 3) {
          const float* bp = a.bqkv + part * G.C + h * G.d;
          b0 = j < G.d ? __ldg(bp + j) : 0.f;
          b1 = j + 1 < G.d ? __ldg(bp + j + 1) : 0.f;
        }
        const float sc = part == 0 ? qscale : 1.f;
        bf16* dst = unit + (long long)part * N * DP;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * wr + gq + 8 * hh;
          const float v0 = j < G.d ? (acc[2 * hh] + b0) * sc : 0.f;
          const float v1 = j + 1 < G.d ? (acc[2 * hh + 1] + b1) * sc : 0.f;
          if (!DATTN && part == 2) {
            dst[am_kmajor(r, j, AM_TOK)] = __float2bfloat16(v0);
            dst[am_kmajor(r, j + 1, AM_TOK)] = __float2bfloat16(v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dst + am_kmajor(j, r, DP)) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

// The gathered rel-pos bias (heads, nv, nv; f32, or bf16 when bias16) in the
// order the attention pass's threads read it (bias4): element e of float4 /
// 4-value group ((h NCH + r) NCH + c) 1024 + 128 nt + wt is the score
// fragment of thread wt of the block of query chunk r, key chunk c, 8-column
// tile nt. A padding key's column is -inf, so it takes no probability; a
// padding query's row is zero at the real keys (a finite row, never stored).
// bf16 stays bf16 (exact), f32 stays f32.
__global__ void am_bias_kernel(const void* __restrict__ bias, int bias16, int heads, int nch, int nv,
                               void* __restrict__ out) {
  const int n = nch * AM_TOK;
  const long long groups = (long long)heads * n * n / 4;
  for (long long gi = blockIdx.x * (long long)blockDim.x + threadIdx.x; gi < groups;
       gi += (long long)gridDim.x * blockDim.x) {
    const int wt = (int)(gi % 128), nt = (int)(gi / 128 % 8), c = (int)(gi / 1024 % nch);
    const int r = (int)(gi / (1024LL * nch) % nch), h = (int)(gi / (1024LL * nch * nch));
    const int q = AM_TOK * r + 16 * (wt >> 5) + ((wt & 31) >> 2), col = AM_TOK * c + 8 * nt + 2 * (wt & 3);
    // elements (q, col), (q, col + 1), (q + 8, col), (q + 8, col + 1): the
    // bias, or -1 for 0 (a padding query) and -2 for -inf (a padding key)
    long long e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int qq = q + 8 * (k >> 1), cc = col + (k & 1);
      e[k] = cc >= nv ? -2 : (qq >= nv ? -1 : ((long long)h * nv + qq) * nv + cc);
    }
    if (bias16) {
      const bf16* b = (const bf16*)bias;
      auto at = [&](int k) { return e[k] >= 0 ? b[e[k]] : __float2bfloat16(e[k] == -1 ? 0.f : -INFINITY); };
      __nv_bfloat162 v0, v1;
      v0.x = at(0), v0.y = at(1), v1.x = at(2), v1.y = at(3);
      reinterpret_cast<uint2*>(out)[gi] =
          make_uint2(*reinterpret_cast<uint32_t*>(&v0), *reinterpret_cast<uint32_t*>(&v1));
    } else {
      const float* b = (const float*)bias;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = e[k] >= 0 ? b[e[k]] : (e[k] == -1 ? 0.f : -INFINITY);
      reinterpret_cast<float4*>(out)[gi] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The epilogue of the projection that ends an attention half (B5's pass 3,
// B10's proj): y = x + d_b (acc + bproj), rounded, at the pixels of
// rows r0, r0 + 8 of tile `tile` (columns below C; with PAD, none for a
// padding token). Every x load is issued before the first store: y may lie
// where x does, so a load after a store would wait for it.
template <bool PAD>
struct WaOut {
  AmArgs a;
  AmGeom G;
  template <int NT>
  __device__ __forceinline__ void operator()(int tile, int r0, int tq, const float (&acc)[NT][4]) const {
    const float dd = a.dp ? a.dp[(tile / G.NCH) / a.nwi] : 1.f;
    const bool ok[2] = {!PAD || am_valid(G, tile, r0), !PAD || am_valid(G, tile, r0 + 8)};
    const long long off[2] = {ok[0] ? am_pixel(G, a, tile, r0) * G.C : 0, ok[1] ? am_pixel(G, a, tile, r0 + 8) * G.C : 0};
    __nv_bfloat162 xv[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        xv[nt][hh] = c < G.C && ok[hh] ? *reinterpret_cast<const __nv_bfloat162*>(a.x + off[hh] + c) : __nv_bfloat162();
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tq;
      if (c >= G.C) continue;
      const float b0 = __ldg(a.bproj + c), b1 = __ldg(a.bproj + c + 1);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (!ok[hh]) continue;
        const float2 x = __bfloat1622float2(xv[nt][hh]);
        *reinterpret_cast<__nv_bfloat162*>(a.dx + off[hh] + c) =
            __floats2bfloat162_rn(x.x + dd * (acc[nt][2 * hh] + b0), x.y + dd * (acc[nt][2 * hh + 1] + b1));
      }
    }
  }
};

// The bias of score fragment (thread wt, 8-column tile nt) of query chunk r,
// key chunk c, head h from am_bias_kernel's copy: (q, col), (q, col + 1),
// (q + 8, col), (q + 8, col + 1).
__device__ __forceinline__ float4 am_bias4(const AmArgs& a, int nch, int h, int r, int c, int nt, int wt) {
  const size_t e = (((size_t)(h * nch + r) * nch + c) * 8 + nt) * 128 + wt;
  if (!a.bias16) return reinterpret_cast<const float4*>(a.relbias)[e];
  const uint2 u = reinterpret_cast<const uint2*>(a.relbias)[e];
  const float2 p0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 p1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(p0.x, p0.y, p1.x, p1.y);
}

// Square windows from 2 (the entries take their own ranges: 2..8, 9..16 and
// 17 up): N = ws^2 tokens in NCH = ceil(N / 64) tiles.
static bool am_geometry_ok(int C, int heads, int ws) {
  if (!(ws >= 2 && heads >= 1 && C >= 4 && C <= AM_MAX_C && C % 4 == 0 && C % heads == 0 &&
        C / heads <= 32))
    return false;
  const AmGeom G(C, heads, ws);
  return G.heads * G.proj_stages() <= AM_MAX_STAGES && G.dln_stages() <= AM_MAX_STAGES;
}
