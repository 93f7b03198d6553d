// B8: the backward of B5 (window_attention.cu) with the forward recomputed
// flash-style,
//   y = x + d_b * proj(WA(LN x))  on (B, H, W, C) maps, windows 2..8,
// with the shift folded into reads and writes as B5 does: from x and the
// cotangent g it emits dx and the f32 gradients of the LN scale and bias,
// Wqkv, bqkv, Wproj, bproj and the gathered rel-pos bias (heads, N, N),
// N = ws^2. A window's tokens are the first N of the block's 64 rows; the
// rest are zero LN and g_b rows whose keys score -inf, so their p, dscores
// and dq / dk / dv are zeros: they add nothing to the weight gradients, d
// bias or the LN sums, and nothing is stored for them.
//
// Replaces studiosr_tpu/ops/pallas/attn_bwd.py::pairs_attention_bwd at the
// geometries the kernels written for the H100 do not take: head dims above
// 32 (bf16 and f32), and f32 at C not a multiple of 4 or above 256 (f32
// otherwise runs attn_bwd_f32.cu, bf16 attn_bwd_mma.cu). Its
// window-pair score packing, -1e30 pair bias and head padding to 32 lanes
// are Mosaic layouts and have no counterpart. The branch cotangent is g_b =
// d g rounded to T; dx = g_b + LN-backward(dln) + (1 - d) g. wqkv is
// unscaled, q = 1/sqrt(d) (LN Wq + bq) as in B1 and B5, so dq carries the
// scale and the q columns of dWqkv and dbqkv need no re-scaling. Rounding
// points follow the TPU kernel: LN output, q/k/v, probabilities, dattn,
// dscores and dq/dk/dv in T; products accumulate in f32; softmax, its
// backward and the LN backward in f32.
//
// Design, four passes, all on the launch's stream:
// 1. attention backward per window (attn_bwd_window_kernel, one block of
//    256 threads per window, two an SM in bf16 (112,896 bytes of shared
//    memory), the blocks walking the windows with a fixed stride): LN,
//    dattn = g_b Wproj^T for all heads, then per head q|k|v,
//    the normalized probabilities, attn = p v, dprobs = dattn_h v^T,
//    dscores, dk, dq, dv, all in shared memory. It writes LN, g_b, attn
//    and dq|dk|dv (in T) to a scratch and adds dscores to the block's own
//    f32 rel-pos-bias partial (one per block, windows in a fixed order).
// 2. per window (attn_bwd_ln_kernel): dln = dqkv Wqkv^T from the scratch,
//    the LN backward and dx, and the window's f32 sums of dln xhat and dln.
// 3. dWqkv = LN^T dqkv, dWproj = attn^T g_b and the bias gradients over all
//    token rows (wgrad.cuh);
// 4. the partials summed in a fixed order: deterministic, no atomics.
//
// Bound on the card: recompute 2 T C 3C + 4 T 64 C, backward 2 T C (C + 3C)
// + 8 T 64 C (dprobs, dq, dk, dv) + 2 T C (C + 3C) (weight gradients), 112
// GFLOP per launch at the training shapes (32 x 64 x 64 tokens, C 180)
// against 141 MB for x, g and dx: bound by operations. The scratch adds
// about 0.6 GB of traffic; this first version is bound by that and by
// latency (per-head GEMMs of 64 x 32 x 64).
#include "wgrad.cuh"

constexpr int AB_SLOTS = 256;  // rel-pos-bias partials: blocks of pass 1
constexpr int AB_LPT = SB_TOK + SB_SKEW;  // stride of the T copy of the probabilities (bf16)

struct AttnBwdSmem {
  size_t lnb, datt, gb, qkv, p, pt, dpr, dst, rid, bst, total;
  int ld_c, ld_a, ld_q, ld_pt, ld_dst;
};

__host__ __device__ inline AttnBwdSmem attn_bwd_smem_layout(int C, int heads, size_t tsz) {
  AttnBwdSmem L;
  const bool f32 = tsz == sizeof(float);  // f32 blocks read p and dscores in place
  const int DP = pad16(C / heads);
  L.ld_c = pad32(C) + SB_SKEW;
  L.ld_a = heads * DP + SB_SKEW;
  L.ld_q = 4 * DP + SB_SKEW;  // dq | k | v | dk after the head's backward: slots 0..3
  L.ld_pt = f32 ? SB_TL : AB_LPT;
  size_t o = 0;
  L.lnb = o;
  o = align32(o + SB_TOK * L.ld_c * tsz);
  L.datt = o;
  o = align32(o + SB_TOK * L.ld_a * tsz);
  const size_t region = o;  // g_b until dattn, then the head buffers
  L.gb = region;
  L.qkv = o;
  o = align32(o + SB_TOK * L.ld_q * tsz);
  L.p = o;
  o = align32(o + SB_TOK * SB_TL * sizeof(float));
  L.pt = f32 ? L.p : o;
  if (!f32) o = align32(o + SB_TOK * AB_LPT * tsz);
  L.dpr = o;
  o = align32(o + SB_TOK * SB_TL * sizeof(float));
  // dscores in T: in place of dprobs (f32), or over the rows of the f32
  // probabilities (bf16: a warp reads its row whole before it writes it;
  // the products read the probabilities from pt)
  L.dst = f32 ? L.dpr : L.p;
  L.ld_dst = f32 ? SB_TL : probs_ld<__nv_bfloat16>();
  const size_t gb_end = align32(region + SB_TOK * L.ld_c * tsz);
  if (o < gb_end) o = gb_end;
  L.rid = o;
  o = align32(o + SB_TOK * sizeof(int));
  // bf16 stages the weights over dprobs, which is dead whenever a weight
  // product runs; that makes two windows an SM
  L.bst = f32 ? o : L.dpr;
  L.total = f32 ? o + 2 * SB_KC * SB_BL * tsz : o;
  return L;
}

struct AttnBwdLnSmem {
  size_t dq, dln, mean, rstd, bst, total;
  int ld_q;
};

__host__ __device__ inline AttnBwdLnSmem attn_bwd_ln_smem_layout(int C, size_t tsz) {
  AttnBwdLnSmem L;
  L.ld_q = pad32(3 * C) + SB_SKEW;
  size_t o = 0;
  L.dq = o;
  o = align32(o + SB_TOK * L.ld_q * tsz);
  L.dln = o;
  o = align32(o + SB_TOK * C * sizeof(float));
  L.mean = o;
  o = align32(o + SB_TOK * sizeof(float));
  L.rstd = o;
  o = align32(o + SB_TOK * sizeof(float));
  L.bst = o;
  L.total = o + 2 * SB_KC * SB_BL * tsz;
  return L;
}

// Packed weights: q|k|v per head (qkv_head_segments), Wproj^T kc x npt with
// head h's rows of Wproj in columns [h DP, h DP + d), Wqkv^T kq3 x nc.
struct AttnBwdPack {
  int kc, nq, npt, kq3, nc;
  long long wpt, wqt, total;
};

__host__ __device__ inline AttnBwdPack attn_bwd_pack_layout(int C, int heads) {
  AttnBwdPack P;
  const int DP = pad16(C / heads);
  P.kc = pad32(C);
  P.nq = pad64(3 * DP);
  P.npt = pad64(heads * DP);
  P.kq3 = pad32(3 * C);
  P.nc = pad64(C);
  P.wpt = (long long)heads * P.kc * P.nq;
  P.wqt = P.wpt + (long long)P.kc * P.npt;
  P.total = P.wqt + (long long)P.kq3 * P.nc;
  return P;
}

// Scratch in T: LN, g_b, attn (R rows of pad8(C) each, R = B H W token
// rows in window order), dqkv (R rows of pad8(3C)), the packed weights, and
// the slack wgrad.cuh reads past its last tile. f32: the rel-pos-bias
// partials, per-window (dLN scale, bias) sums, wgrad partials.
struct AttnBwdScratch {
  long long rows, ln, gb, att, dqkv, pack, t_elems;
  long long slots, dbias, stats, part, f_elems;
};

__host__ inline AttnBwdScratch attn_bwd_scratch_layout(int B, int H, int W, int C, int heads, int ws) {
  AttnBwdScratch S;
  const long long wins = (long long)B * (H / ws) * (W / ws);
  S.rows = wins * SB_TOK;
  S.ln = 0;
  S.gb = S.ln + S.rows * pad8(C);
  S.att = S.gb + S.rows * pad8(C);
  S.dqkv = S.att + S.rows * pad8(C);
  S.pack = S.dqkv + S.rows * pad8(3 * C);
  S.t_elems = S.pack + attn_bwd_pack_layout(C, heads).total + 2 * WG_BM;
  S.slots = wins < AB_SLOTS ? wins : AB_SLOTS;
  S.dbias = 0;
  S.stats = S.slots * heads * SB_TOK * SB_TOK;
  S.part = S.stats + wins * 2 * C;
  const long long p1 = wgrad_plan(S.rows, C, 3 * C).part_elems, p2 = wgrad_plan(S.rows, C, C).part_elems;
  S.f_elems = S.part + (p1 > p2 ? p1 : p2);
  return S;
}

template <typename T>
__global__ void __launch_bounds__(SB_THREADS, 2) attn_bwd_window_kernel(
    const T* __restrict__ x, const T* __restrict__ g, int B, int H, int W, int C, int heads, int ws, int shift,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, const float* __restrict__ bqkv,
    const float* __restrict__ relbias, const float* __restrict__ dp, const T* __restrict__ packed,
    T* __restrict__ ln_out, T* __restrict__ gb_out, T* __restrict__ att_out, T* __restrict__ dqkv_out,
    float* __restrict__ dbias_part) {
  using nvcuda::wmma::col_major;
  using nvcuda::wmma::row_major;
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnBwdSmem L = attn_bwd_smem_layout(C, heads, sizeof(T));
  const AttnBwdPack P = attn_bwd_pack_layout(C, heads);
  T* lnb = (T*)(smem + L.lnb);
  T* datt = (T*)(smem + L.datt);
  T* gbs = (T*)(smem + L.gb);
  T* qkv = (T*)(smem + L.qkv);
  float* p = (float*)(smem + L.p);
  T* pt = (T*)(smem + L.pt);
  float* dpr = (float*)(smem + L.dpr);
  T* dst = (T*)(smem + L.dst);
  int* rid = (int*)(smem + L.rid);
  T* bst = (T*)(smem + L.bst);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = C / heads, DP = pad16(d);
  const int LC = L.ld_c, LA = L.ld_a, LQ = L.ld_q, LPT = L.ld_pt, LDS = L.ld_dst;
  const int SC = pad8(C), S3 = pad8(3 * C);  // scratch row strides
  const float qscale = rsqrtf((float)d);
  const int nv = ws * ws, nwin = (H / ws) * (W / ws), total = B * nwin;
  float* part = dbias_part + (size_t)blockIdx.x * heads * nv * nv;

  zero_columns(lnb, LC, C, P.kc);
  const FragMap map = frag_map_for<T>((float*)bst);
  __syncthreads();
  for (int win = blockIdx.x; win < total; win += gridDim.x) {
    const int img = win / nwin, wi = win % nwin;
    const float dd = dp ? dp[img] : 1.f;
    const long long row0 = (long long)win * SB_TOK;
    if (tid < SB_TOK) rid[tid] = window_token_region_ws(wi, tid, H, W, shift, ws);
    for (int i = tid; i < SB_TOK * C; i += SB_THREADS) {
      const int t = i / C, c = i - t * C;
      const T v = t < nv ? from_f32<T>(dd * to_f32(g[window_token_offset_ws(img, wi, t, H, W, C, shift, ws) + c]))
                         : from_f32<T>(0.f);
      gbs[t * LC + c] = v;
      gb_out[(row0 + t) * SC + c] = v;
    }
    zero_columns(gbs, LC, C, P.kc);
    for (int r = warp; r < SB_TOK; r += SB_THREADS / 32) {
      if (r >= nv) {
        for (int c = lane; c < C; c += 32) lnb[r * LC + c] = ln_out[(row0 + r) * SC + c] = from_f32<T>(0.f);
        continue;
      }
      const T* xr = x + window_token_offset_ws(img, wi, r, H, W, C, shift, ws);
      float mu, rs;
      row_stats(xr, C, mu, rs);
      for (int c = lane; c < C; c += 32) {
        const T v = from_f32<T>((to_f32(xr[c]) - mu) * rs * ln_w[c] + ln_b[c]);
        lnb[r * LC + c] = v;
        ln_out[(row0 + r) * SC + c] = v;
      }
    }
    // dattn = g_b Wproj^T, head h in columns [h DP, h DP + d), zero past d
    gemm64<T>(gbs, LC, P.kc, heads * DP, packed + P.wpt, P.npt, bst, map,
              [&](int r, int n, float acc) { datt[r * LA + n] = from_f32<T>(acc); });

    for (int h = 0; h < heads; ++h) {
      const T* dav = datt + h * DP;
      head_qkv<T>(lnb, LC, packed + (size_t)h * P.kc * P.nq, bqkv, C, heads, h, qkv, LQ, bst, map);
      gemm64_smem<row_major, col_major>(qkv, LQ, qkv + DP, LQ, DP, SB_TOK, map, [&](int r, int n, float acc) {
        float v = -INFINITY;  // past the window's keys
        if (n < nv) {
          v = acc + (r < nv ? relbias[(h * nv + r) * nv + n] : 0.f);
          if (rid[r] != rid[n]) v += -100.f;
        }
        p[r * SB_TL + n] = v;
      });
      // normalized probabilities, f32 and in T; one warp per row
      for (int r = warp; r < SB_TOK; r += SB_THREADS / 32) {
        const float a = p[r * SB_TL + lane], b = p[r * SB_TL + lane + 32];
        const float m = warp_max(fmaxf(a, b));
        const float ea = expf(a - m), eb = expf(b - m);
        const float inv = 1.f / warp_sum(ea + eb);
        p[r * SB_TL + lane] = ea * inv;
        p[r * SB_TL + lane + 32] = eb * inv;
        pt[r * LPT + lane] = from_f32<T>(ea * inv);
        pt[r * LPT + lane + 32] = from_f32<T>(eb * inv);
      }
      __syncthreads();
      // attn_h = p v
      gemm64_smem<row_major, row_major>(pt, LPT, qkv + 2 * DP, LQ, SB_TOK, DP, map, [&](int r, int n, float acc) {
        if (n < d) att_out[(row0 + r) * SC + h * d + n] = from_f32<T>(acc);
      });
      // dprobs = dattn_h v^T
      gemm64_smem<row_major, col_major>(dav, LA, qkv + 2 * DP, LQ, DP, SB_TOK, map,
                                        [&](int r, int n, float acc) { dpr[r * SB_TL + n] = acc; });
      // dscores = p (dprobs - sum(dprobs p)); f32 into the bias partial, T for the products
      for (int r = warp; r < SB_TOK; r += SB_THREADS / 32) {
        const float pa = p[r * SB_TL + lane], pb = p[r * SB_TL + lane + 32];
        const float da = dpr[r * SB_TL + lane], db = dpr[r * SB_TL + lane + 32];
        const float t = warp_sum(pa * da + pb * db);
        const float sa = pa * (da - t), sb = pb * (db - t);
        __syncwarp();
        dst[r * LDS + lane] = from_f32<T>(sa);
        dst[r * LDS + lane + 32] = from_f32<T>(sb);
        if (r < nv) {
          float* pr = part + (h * nv + r) * nv;
          if (lane < nv) pr[lane] += sa;
          if (lane + 32 < nv) pr[lane + 32] += sb;
        }
      }
      __syncthreads();
      // dk = dscores^T q -> slot 3
      gemm64_smem<col_major, row_major>(dst, LDS, qkv, LQ, SB_TOK, DP, map, [&](int r, int n, float acc) {
        qkv[r * LQ + 3 * DP + n] = from_f32<T>(n < d ? acc : 0.f);
      });
      // dq = dscores k / sqrt(d) -> slot 0 (q is no longer read)
      gemm64_smem<row_major, row_major>(dst, LDS, qkv + DP, LQ, SB_TOK, DP, map, [&](int r, int n, float acc) {
        qkv[r * LQ + n] = from_f32<T>(n < d ? acc * qscale : 0.f);
      });
      // dv = p^T dattn_h -> slot 1 (k is no longer read)
      gemm64_smem<col_major, row_major>(pt, LPT, dav, LA, SB_TOK, DP, map, [&](int r, int n, float acc) {
        qkv[r * LQ + DP + n] = from_f32<T>(n < d ? acc : 0.f);
      });
      for (int i = tid; i < SB_TOK * 3 * d; i += SB_THREADS) {
        const int r = i / (3 * d), rem = i - r * 3 * d, part_ = rem / d, j = rem - part_ * d;
        const int slot = part_ == 0 ? 0 : (part_ == 1 ? 3 : 1);
        dqkv_out[(row0 + r) * S3 + part_ * C + h * d + j] = qkv[r * LQ + slot * DP + j];
      }
      __syncthreads();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(SB_THREADS) attn_bwd_ln_kernel(
    const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx, int H, int W, int C, int ws, int shift,
    const float* __restrict__ ln_w, const float* __restrict__ dp, const T* __restrict__ dqkv,
    const T* __restrict__ wqt, int nc, float* __restrict__ stats) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnBwdLnSmem L = attn_bwd_ln_smem_layout(C, sizeof(T));
  T* dq = (T*)(smem + L.dq);
  float* dln = (float*)(smem + L.dln);
  float* mean = (float*)(smem + L.mean);
  float* rstd = (float*)(smem + L.rstd);
  T* bst = (T*)(smem + L.bst);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int LQ = L.ld_q, C3 = 3 * C, S3 = pad8(C3);
  const int nv = ws * ws, nwin = (H / ws) * (W / ws), win = blockIdx.x, img = win / nwin, wi = win % nwin;
  const float dd = dp ? dp[img] : 1.f;
  const long long row0 = (long long)win * SB_TOK;

  for (int i = tid; i < SB_TOK * C3; i += SB_THREADS) {
    const int r = i / C3, c = i - r * C3;
    dq[r * LQ + c] = dqkv[(row0 + r) * S3 + c];
  }
  zero_columns(dq, LQ, C3, pad32(C3));
  const FragMap map = frag_map_for<T>((float*)bst);
  __syncthreads();
  gemm64<T>(dq, LQ, pad32(C3), C, wqt, nc, bst, map, [&](int r, int n, float acc) { dln[r * C + n] = acc; });

  for (int r = warp; r < nv; r += SB_THREADS / 32) {
    const size_t off = window_token_offset_ws(img, wi, r, H, W, C, shift, ws);
    const T* xr = x + off;
    const T* gr = g + off;
    float mu, rs;
    row_stats(xr, C, mu, rs);
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_f32(xr[c]) - mu) * rs, dxh = dln[r * C + c] * ln_w[c];
      s1 += dxh;
      s2 += dxh * xh;
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float gv = to_f32(gr[c]), gbv = to_f32(from_f32<T>(dd * gv));
      const float xh = (to_f32(xr[c]) - mu) * rs, dxh = dln[r * C + c] * ln_w[c];
      dx[off + c] = from_f32<T>(gbv + (dxh - m1 - xh * m2) * rs + (1.f - dd) * gv);
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += SB_THREADS) {
    float sw = 0.f, sb = 0.f;
    for (int r = 0; r < nv; ++r) {
      const float dl = dln[r * C + c];
      sw += dl * (to_f32(x[window_token_offset_ws(img, wi, r, H, W, C, shift, ws) + c]) - mean[r]) * rstd[r];
      sb += dl;
    }
    stats[win * 2LL * C + c] = sw;
    stats[win * 2LL * C + C + c] = sb;
  }
}

extern "C" void attn_bwd_scratch(int B, int H, int W, int C, int heads, int ws, long long* t_elems,
                                 long long* f_elems) {
  const AttnBwdScratch S = attn_bwd_scratch_layout(B, H, W, C, heads, ws);
  *t_elems = S.t_elems;
  *f_elems = S.f_elems;
}

template <typename T>
static cudaError_t attn_bwd(const T* x, const T* g, T* dx, int B, int H, int W, int C, int heads, int ws, int shift,
                            const float* ln_w, const float* ln_b, const T* wqkv, const float* bqkv, const T* wproj,
                            const float* relbias, const float* dp, float* ds_db, float* dwqkv, float* dbqkv,
                            float* dwproj, float* dbproj, float* dbias, T* tscratch, long long t_elems,
                            float* fscratch, long long f_elems, cudaStream_t stream) {
  if (ws < 2 || ws > SB_WS || H % ws || W % ws || shift < 0 || shift >= ws) return cudaErrorInvalidValue;
  const AttnBwdScratch S = attn_bwd_scratch_layout(B, H, W, C, heads, ws);
  const AttnBwdPack P = attn_bwd_pack_layout(C, heads);
  if (S.t_elems != t_elems || S.f_elems != f_elems) return cudaErrorInvalidValue;
  const int d = C / heads, DP = pad16(d);
  std::vector<PackSeg> segs;
  qkv_head_segments(segs, wqkv, C, heads, 0);
  for (int h = 0; h < heads; ++h) segs.push_back(PackSeg{wproj + (size_t)h * d * C, P.wpt + h * DP, P.npt, C, d, 1, C});
  segs.push_back(PackSeg{wqkv, P.wqt, P.nc, 3 * C, C, 1, 3 * C});
  T* packed = tscratch + S.pack;
  cudaError_t err = pack_segments(segs, packed, (size_t)P.total, stream);
  if (err != cudaSuccess) return err;
  T *ln = tscratch + S.ln, *gb = tscratch + S.gb, *att = tscratch + S.att, *dqkv = tscratch + S.dqkv;
  err = cudaMemsetAsync(fscratch + S.dbias, 0, S.stats * sizeof(float), stream);
  if (err != cudaSuccess) return err;

  const AttnBwdSmem L1 = attn_bwd_smem_layout(C, heads, sizeof(T));
  err = allow_smem(attn_bwd_window_kernel<T>, L1.total);
  if (err != cudaSuccess) return err;
  attn_bwd_window_kernel<T><<<(int)S.slots, SB_THREADS, L1.total, stream>>>(
      x, g, B, H, W, C, heads, ws, shift, ln_w, ln_b, bqkv, relbias, dp, packed, ln, gb, att, dqkv,
      fscratch + S.dbias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const AttnBwdLnSmem L2 = attn_bwd_ln_smem_layout(C, sizeof(T));
  err = allow_smem(attn_bwd_ln_kernel<T>, L2.total);
  if (err != cudaSuccess) return err;
  const int wins = (int)(S.rows / SB_TOK);
  attn_bwd_ln_kernel<T><<<wins, SB_THREADS, L2.total, stream>>>(x, g, dx, H, W, C, ws, shift, ln_w, dp, dqkv,
                                                               packed + P.wqt, P.nc, fscratch + S.stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = reduce_parts(fscratch + S.dbias, (int)S.slots, (long long)heads * ws * ws * ws * ws, dbias, stream);
  if (err != cudaSuccess) return err;
  err = reduce_parts(fscratch + S.stats, wins, 2LL * C, ds_db, stream);
  if (err != cudaSuccess) return err;
  const int SC = pad8(C), S3 = pad8(3 * C);
  err = wgrad(ln, SC, dqkv, S3, S.rows, C, 3 * C, dwqkv, dbqkv, fscratch + S.part, stream);
  if (err != cudaSuccess) return err;
  return wgrad(att, SC, gb, SC, S.rows, C, C, dwproj, dbproj, fscratch + S.part, stream);
}

#define ATTN_BWD_ENTRY(NAME, T)                                                                                   \
  extern "C" int NAME(const void* x, const void* g, void* dx, int B, int H, int W, int C, int heads, int ws,      \
                      int shift,                                                                                  \
                      const void* ln_w, const void* ln_b, const void* wqkv, const void* bqkv, const void* wproj,  \
                      const void* relbias, const void* dp, void* ds_db, void* dwqkv, void* dbqkv, void* dwproj,   \
                      void* dbproj, void* dbias, void* tscratch, long long t_elems, void* fscratch,                \
                      long long f_elems, void* stream) {                                                          \
    return (int)attn_bwd<T>((const T*)x, (const T*)g, (T*)dx, B, H, W, C, heads, ws, shift, (const float*)ln_w,   \
                            (const float*)ln_b, (const T*)wqkv, (const float*)bqkv, (const T*)wproj,              \
                            (const float*)relbias, (const float*)dp, (float*)ds_db, (float*)dwqkv,                \
                            (float*)dbqkv, (float*)dwproj, (float*)dbproj, (float*)dbias, (T*)tscratch, t_elems, \
                            (float*)fscratch, f_elems, (cudaStream_t)stream);                                     \
  }

ATTN_BWD_ENTRY(attn_bwd_f32, float)
ATTN_BWD_ENTRY(attn_bwd_bf16, __nv_bfloat16)
