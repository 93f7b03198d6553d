// B9: the backward of B5 at windows from 9 (window_attention16.cu) with the
// forward recomputed,
//   y = x + d_b * proj(WA(LN x))  on (B, H, W, C) maps, ws x ws windows,
// the shift folded into reads and writes as B5 does: from x and the
// cotangent g it emits dx and the f32 gradients of the LN scale and bias,
// Wqkv, bqkv, Wproj, bproj and the gathered rel-pos bias (heads, N, N),
// N = ws^2 (HAT's 256). The contract is B8's (attn_bwd.cu) at other windows.
// attn_core.cuh takes a window of N tokens in ceil(N / 64) chunks, the last
// one ragged; the pixel-row passes take B H W rows in blocks of 64, the last
// one ragged (rows past the map read as zeros and are never stored).
//
// Replaces studiosr_tpu/ops/pallas/attn_bwd.py::v5_attention_bwd (kernel
// _bwd_kernel_v5). The TPU kernel takes a stripe of windows per program
// and their whole (heads, 256, 256) f32 scores in VMEM, with the softmax
// clamped at 80 instead of max-subtracted and the heads padded to 32 lanes:
// Mosaic layouts. A head's 256 x 256 f32 scores (256 KB) do not fit one
// block's shared memory, so the attention backward runs on 64-query x
// 64-key tiles with every score recomputed (attn_core.cuh). Rounding points
// follow the TPU kernel: LN output, q, k, v, the probabilities, dattn,
// dscores and dq / dk / dv in T; products accumulate in f32; softmax, its
// backward and the LN backward in f32. The branch cotangent is g_b = d g
// rounded to T; dx = g_b + LN-backward(dln) + (1 - d) g.
//
// Design, on the launch's stream:
// 1. LN + the q|k|v projection per 64 pixel rows into a per-pixel, per-head
//    scratch (qkv_attention.cuh's pass 1, shared with B5 at window 16),
//    keeping the LN rows;
// 2. per 64 pixel rows (ab16_gb_kernel): g_b, and dattn = g_b Wproj^T per
//    head into a per-pixel scratch;
// 3. attn_core.cuh's row pass, one block per (window, head, 64 queries):
//    the row statistics (max, sum, D = sum p dp), attn = p v (for d Wproj)
//    and dq; then its column pass, one block per (head, 64 keys, window
//    group): dk and dv, and the group's d bias tile in shared memory; in
//    bf16 both on mma.sync with the tiles in registers;
// 4. per 64 pixel rows (ab16_ln_kernel): dln = dqkv Wqkv^T (dqkv's rows
//    streamed 32 columns a round beside the weights' chunks, swin_common.cuh
//    gemm64_ga), the LN backward and dx, and the block's sums of dln xhat
//    and dln;
// 5. d Wqkv = LN^T dqkv, d Wproj = attn^T g_b and the bias gradients over
//    all pixel rows (wgrad.cuh), every partial summed in a fixed order: no
//    atomics, the same bits from run to run.
//
// Bound on the card at the HAT training shapes (T = 131,072 tokens, C 180,
// 6 heads, N 256): recompute 2 T C 3C + 4 T N C, proj backward 2 2 T C^2,
// attention backward 8 T N C, weight and LN backward 2 2 T C 3C: 166
// GFLOP against 141 MB for x, g and dx, bound by operations (0.168 ms). The
// d bias partials are one f32 (heads, 256, 256) tile per window group
// (about 17 MB in all at the 11 groups of 132 SMs), not one per window;
// the scratch (q|k|v, dattn, LN, g_b, attn, dqkv: about 0.5 GB in bf16) is
// written once and read once or twice. The scores are computed three times
// (the row pass's two sweeps, the column pass): 18 T N C of attention flops
// against the 12 T N C the bound counts.
#include "attn_core.cuh"
#include "qkv_attention.cuh"

template <typename T>
struct WinGeom {
  const T* qkv;   // [pixel][head][q|k|v][DP], q scaled
  const T* datt;  // [pixel][head][DP]
  T* att;         // [pixel][SC]
  T* dqkv;        // [pixel][S3]: dq | dk | dv, head h at columns h d ..
  const float* relbias;
  long long units;
  int heads, nq, nk, d;
  float dq_scale;
  int H, W, ws, shift, C, DP, SC, S3, nwx, nwin;
  static constexpr bool PADDED = true;  // rows of DP values, zero past d, 32-byte aligned

  __host__ __device__ bool mma_rows() const { return true; }

  // One (window, head) of the map rolled by -shift: its window's origin
  // there (y0, x0), the head's columns and bias.
  struct Unit {
    const T *qkv, *datt;
    T *att, *dqkv;
    const float* b;
    long long id, base, qkv_row, datt_row;  // base: the first pixel of the window's image
    int H, W, ws, shift, y0, x0, qkv_col, datt_col, out_col, DP, C, SC, S3, nq, nk;
    // Pixel of token t: ((y0 + t / ws + shift) mod H, (x0 + t % ws + shift) mod W).
    __device__ long long pixel(int t) const {
      int y = y0 + t / ws + shift, x = x0 + t % ws + shift;
      if (y >= H) y -= H;
      if (x >= W) x -= W;
      return base + (long long)y * W + x;
    }
    // calculate_mask's region of token t of the rolled map.
    __device__ int region(int t) const {
      const int y = y0 + t / ws, x = x0 + t % ws;
      return 3 * (y < H - ws ? 0 : (y < H - shift ? 1 : 2)) + (x < W - ws ? 0 : (x < W - shift ? 1 : 2));
    }
    __device__ const T* part(int t, int p) const { return qkv + pixel(t) * qkv_row + qkv_col + p * DP; }
    __device__ const T* q(int r) const { return r < nq ? part(r, 0) : nullptr; }
    __device__ const T* k(int t) const { return t < nk ? part(t, 1) : nullptr; }
    __device__ const T* v(int t) const { return t < nk ? part(t, 2) : nullptr; }
    __device__ const T* g(int r) const { return r < nq ? datt + pixel(r) * datt_row + datt_col : nullptr; }
    __device__ float bias(int r, int t) const {
      const float v = b[(size_t)r * nk + t];
      return shift && region(r) != region(t) ? v + -100.f : v;
    }
    __device__ void put_o(int r, int j, float x) const { att[pixel(r) * SC + out_col + j] = from_f32<T>(x); }
    __device__ void put_dq(int r, int j, float x) const { dqkv[pixel(r) * S3 + out_col + j] = from_f32<T>(x); }
    __device__ void put_dk(int t, int j, float x) const { dqkv[pixel(t) * S3 + C + out_col + j] = from_f32<T>(x); }
    __device__ void put_dv(int t, int j, float x) const { dqkv[pixel(t) * S3 + 2 * C + out_col + j] = from_f32<T>(x); }
  };
  __device__ Unit unit(long long u) const {
    const long long win = u / heads;
    const int h = (int)(u % heads), img = (int)(win / nwin), wi = (int)(win % nwin);
    return Unit{qkv, datt, att, dqkv, relbias + (size_t)h * nq * nk, u, (long long)img * H * W, 3LL * heads * DP,
                (long long)heads * DP, H, W, ws, shift, (wi / nwx) * ws, (wi % nwx) * ws, h * 3 * DP, h * DP, h * d,
                DP, C, SC, S3, nq, nk};
  }
};

// Packed weights after the projection pass's (qkv_pack_layout): Wproj^T
// kc x npt with head h's rows of Wproj in columns [h DP, h DP + d), then
// Wqkv^T kq3 x nc.
struct Ab16Pack {
  int kc, npt, kq3, nc;
  long long wpt, wqt, total;
};

__host__ __device__ inline Ab16Pack ab16_pack_layout(int C, int heads) {
  Ab16Pack P;
  P.kc = pad32(C);
  P.npt = pad64(heads * pad16(C / heads));
  P.kq3 = pad32(3 * C);
  P.nc = pad64(C);
  P.wpt = qkv_pack_layout(C, heads).total;
  P.wqt = P.wpt + (long long)P.kc * P.npt;
  P.total = P.wqt + (long long)P.kq3 * P.nc;
  return P;
}

// Scratch in T: q|k|v, dattn (pixel rows), LN, g_b, attn, dqkv (pixel rows
// and zero rows up to whole chunks of the weight gradients' K), the packed
// weights and the slack wgrad.cuh reads past its last tile. f32: the
// attention passes' statistics and d bias partials, the LN sums per block,
// the wgrad partials.
struct Ab16Scratch {
  long long rows, rows_k, qkv, datt, ln, gb, att, dqkv, pack, t_elems;
  long long attn, lnst, wg, f_elems;
  int groups;
};

__host__ inline Ab16Scratch ab16_scratch_layout(int B, int H, int W, int C, int heads, int ws) {
  Ab16Scratch S;
  const int DP = pad16(C / heads), n = ws * ws;
  S.rows = (long long)B * H * W;
  S.rows_k = (S.rows + SB_TOK - 1) / SB_TOK * SB_TOK;  // wgrad.cuh's K: a multiple of WG_BK
  S.qkv = 0;
  S.datt = S.qkv + S.rows * heads * 3 * DP;
  S.ln = S.datt + S.rows * heads * DP;
  S.gb = S.ln + S.rows_k * pad8(C);
  S.att = S.gb + S.rows_k * pad8(C);
  S.dqkv = S.att + S.rows_k * pad8(C);
  S.pack = S.dqkv + S.rows_k * pad8(3 * C);
  S.t_elems = S.pack + ab16_pack_layout(C, heads).total + 2 * WG_BM;
  const long long windows = (long long)B * (H / ws) * (W / ws);
  S.groups = ac_groups(windows, heads, n);
  S.attn = 0;
  S.lnst = S.attn + ac_stats_elems(windows * heads, n) + ac_part_elems(S.groups, heads, n, n);
  S.wg = S.lnst + S.rows_k / SB_TOK * 2 * C;  // a partial a block of 64 rows
  const long long p1 = wgrad_plan(S.rows_k, C, 3 * C).part_elems, p2 = wgrad_plan(S.rows_k, C, C).part_elems;
  S.f_elems = S.wg + (p1 > p2 ? p1 : p2);
  return S;
}

// g_b = d g (rounded to T) of 64 pixel rows (of `rows`), and dattn = g_b
// Wproj^T per head.
template <typename T>
__global__ void __launch_bounds__(SB_THREADS) ab16_gb_kernel(const T* __restrict__ g, long long rows, int HW, int C,
                                                            int heads,
                                                            const float* __restrict__ dp, const T* __restrict__ wpt,
                                                            int npt, T* __restrict__ gb, int SC,
                                                            T* __restrict__ datt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LC = pad32(C) + SB_SKEW, HD = heads * pad16(C / heads);
  T* gbs = (T*)smem;
  T* bst = (T*)(smem + align32((size_t)SB_TOK * LC * sizeof(T)));
  const long long r0 = (long long)blockIdx.x * SB_TOK;
  for (int i = threadIdx.x; i < SB_TOK * C; i += SB_THREADS) {
    const int r = i / C, c = i - r * C;
    const long long row = r0 + r;
    if (row >= rows) {
      gbs[r * LC + c] = from_f32<T>(0.f);
      continue;
    }
    const T v = from_f32<T>((dp ? dp[row / HW] : 1.f) * to_f32(g[row * C + c]));
    gbs[r * LC + c] = v;
    gb[row * SC + c] = v;
  }
  zero_columns(gbs, LC, C, pad32(C));
  const FragMap map = frag_map_for<T>((float*)bst);  // bst is free until the first staged chunk
  __syncthreads();
  gemm64<T>(gbs, LC, pad32(C), HD, wpt, npt, bst, map,
            [&](int r, int n, float acc) {
              if (r0 + r < rows) datt[(r0 + r) * HD + n] = from_f32<T>(acc);
            });
}

__host__ inline size_t ab16_gb_smem(int C, size_t tsz) {
  return align32((size_t)SB_TOK * (pad32(C) + SB_SKEW) * tsz) + 2 * SB_KC * SB_BL * tsz;
}

// dqkv's rows stream through the dln product 32 columns a round
// (gemm64_ga), so the shared memory holds no whole 3C rows: dln (f32), the
// rows' statistics and the two operands' stages.
struct Ab16LnSmem {
  size_t dln, mean, rstd, ast, bst, total;
};

__host__ __device__ inline Ab16LnSmem ab16_ln_smem_layout(int C, size_t tsz) {
  Ab16LnSmem L;
  size_t o = 0;
  L.dln = o;
  o = align32(o + SB_TOK * C * sizeof(float));
  L.mean = o;
  o = align32(o + SB_TOK * sizeof(float));
  L.rstd = o;
  o = align32(o + SB_TOK * sizeof(float));
  L.ast = o;
  o = align32(o + 2 * SB_TOK * SB_AL * tsz);
  L.bst = o;
  L.total = o + 2 * SB_KC * SB_BL * tsz;
  return L;
}

// dln = dqkv Wqkv^T of 64 pixel rows (of `rows`), the LN backward and dx,
// and the block's column sums of dln xhat and dln into stats[block][2C].
template <typename T>
__global__ void __launch_bounds__(SB_THREADS) ab16_ln_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                                            T* __restrict__ dx, long long rows, int HW, int C,
                                                            const float* __restrict__ ln_w,
                                                            const float* __restrict__ dp, const T* __restrict__ dqkv,
                                                            int S3, const T* __restrict__ wqt, int nc,
                                                            float* __restrict__ stats) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ab16LnSmem L = ab16_ln_smem_layout(C, sizeof(T));
  float* dln = (float*)(smem + L.dln);
  float* mean = (float*)(smem + L.mean);
  float* rstd = (float*)(smem + L.rstd);
  T* ast = (T*)(smem + L.ast);
  T* bst = (T*)(smem + L.bst);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C3 = 3 * C;
  const long long row0 = (long long)blockIdx.x * SB_TOK;
  const int nr = rows - row0 < SB_TOK ? (int)(rows - row0) : SB_TOK;

  const FragMap map = frag_map_for<T>((float*)bst);
  gemm64_ga<T>(dqkv + row0 * S3, S3, nr, C3, pad32(C3), C, wqt, nc, ast, bst, map,
               [&](int r, int n, float acc) { dln[r * C + n] = acc; });

  for (int r = warp; r < nr; r += SB_THREADS / 32) {
    const long long row = row0 + r;
    const size_t off = (size_t)row * C;
    const float dd = dp ? dp[row / HW] : 1.f;
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
    for (int r = 0; r < nr; ++r) {
      const float dl = dln[r * C + c];
      sw += dl * (to_f32(x[(size_t)(row0 + r) * C + c]) - mean[r]) * rstd[r];
      sb += dl;
    }
    stats[blockIdx.x * 2LL * C + c] = sw;
    stats[blockIdx.x * 2LL * C + C + c] = sb;
  }
}

static bool ab16_shape_ok(int B, int H, int W, int C, int heads, int ws, int shift) {
  return B > 0 && ws >= 9 && H > 0 && W > 0 && H % ws == 0 && W % ws == 0 && C % heads == 0 &&
         pad16(C / heads) <= 64 && shift >= 0 && shift < ws;
}

extern "C" void attn_bwd16_scratch(int B, int H, int W, int C, int heads, int ws, long long* t_elems,
                                   long long* f_elems) {
  const Ab16Scratch S = ab16_scratch_layout(B, H, W, C, heads, ws);
  *t_elems = S.t_elems;
  *f_elems = S.f_elems;
}

template <typename T>
static cudaError_t attn_bwd16(const T* x, const T* g, T* dx, int B, int H, int W, int C, int heads, int ws,
                              int shift, const float* ln_w, const float* ln_b, const T* wqkv, const float* bqkv,
                              const T* wproj, const float* relbias, const float* dp, float* ds_db, float* dwqkv,
                              float* dbqkv, float* dwproj, float* dbproj, float* dbias, T* tscratch,
                              long long t_elems, float* fscratch, long long f_elems, cudaStream_t stream) {
  if (!ab16_shape_ok(B, H, W, C, heads, ws, shift)) return cudaErrorInvalidValue;
  const Ab16Scratch S = ab16_scratch_layout(B, H, W, C, heads, ws);
  if (S.t_elems != t_elems || S.f_elems != f_elems) return cudaErrorInvalidValue;
  const Ab16Pack P = ab16_pack_layout(C, heads);
  const int d = C / heads, DP = pad16(d), SC = pad8(C), S3 = pad8(3 * C);
  std::vector<PackSeg> segs;
  qkv_pack_segments(segs, wqkv, wproj, C, heads, 0);
  for (int h = 0; h < heads; ++h) segs.push_back(PackSeg{wproj + (size_t)h * d * C, P.wpt + h * DP, P.npt, C, d, 1, C});
  segs.push_back(PackSeg{wqkv, P.wqt, P.nc, 3 * C, C, 1, 3 * C});
  T* packed = tscratch + S.pack;
  cudaError_t err = pack_segments(segs, packed, (size_t)P.total, stream);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(S.rows_k / SB_TOK);
  if (S.rows_k > S.rows) {  // the weight gradients' zero rows past the map
    const long long tail = S.rows_k - S.rows;
    const long long zeroed[3] = {S.ln, S.gb, S.att};
    for (const long long at : zeroed)
      if ((err = cudaMemsetAsync(tscratch + at + S.rows * SC, 0, tail * SC * sizeof(T), stream)) != cudaSuccess)
        return err;
    if ((err = cudaMemsetAsync(tscratch + S.dqkv + S.rows * S3, 0, tail * S3 * sizeof(T), stream)) != cudaSuccess)
      return err;
  }

  const LnQkvSmem L1 = ln_qkv_smem_layout<T>(C);
  err = allow_smem(ln_qkv_kernel<T>, L1.total);
  if (err != cudaSuccess) return err;
  ln_qkv_kernel<T><<<blocks, SB_THREADS, L1.total, stream>>>(x, tscratch + S.qkv, S.rows, C, heads, ln_w, ln_b,
                                                               bqkv, packed, tscratch + S.ln, SC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t L2 = ab16_gb_smem(C, sizeof(T));
  err = allow_smem(ab16_gb_kernel<T>, L2);
  if (err != cudaSuccess) return err;
  ab16_gb_kernel<T><<<blocks, SB_THREADS, L2, stream>>>(g, S.rows, H * W, C, heads, dp, packed + P.wpt, P.npt,
                                                        tscratch + S.gb, SC, tscratch + S.datt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  WinGeom<T> G;
  G.qkv = tscratch + S.qkv;
  G.datt = tscratch + S.datt;
  G.att = tscratch + S.att;
  G.dqkv = tscratch + S.dqkv;
  G.relbias = relbias;
  G.heads = heads;
  G.nq = G.nk = ws * ws;
  G.d = d;
  G.dq_scale = 1.f / sqrtf((float)d);
  G.H = H;
  G.W = W;
  G.ws = ws;
  G.shift = shift;
  G.C = C;
  G.DP = DP;
  G.SC = SC;
  G.S3 = S3;
  G.nwx = W / ws;
  G.nwin = (H / ws) * (W / ws);
  G.units = (long long)B * G.nwin * heads;
  err = ac_backward<T, WinGeom<T>, AC_ROWS_O>(G, S.groups, fscratch + S.attn, dbias, stream);
  if (err != cudaSuccess) return err;

  const Ab16LnSmem L4 = ab16_ln_smem_layout(C, sizeof(T));
  err = allow_smem(ab16_ln_kernel<T>, L4.total);
  if (err != cudaSuccess) return err;
  ab16_ln_kernel<T><<<blocks, SB_THREADS, L4.total, stream>>>(x, g, dx, S.rows, H * W, C, ln_w, dp, tscratch + S.dqkv, S3,
                                                              packed + P.wqt, P.nc, fscratch + S.lnst);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = reduce_parts(fscratch + S.lnst, (int)blocks, 2LL * C, ds_db, stream);
  if (err != cudaSuccess) return err;
  err = wgrad(tscratch + S.ln, SC, tscratch + S.dqkv, S3, S.rows_k, C, 3 * C, dwqkv, dbqkv, fscratch + S.wg, stream);
  if (err != cudaSuccess) return err;
  return wgrad(tscratch + S.att, SC, tscratch + S.gb, SC, S.rows_k, C, C, dwproj, dbproj, fscratch + S.wg, stream);
}

// Two entries a dtype: windows 9..16 and 17 up (the column pass without its
// d bias rows, ac_dbias_kernel beside it: attn_core.cuh's ac_cols).
#define ATTN_BWD16_ENTRY(NAME, T, WS_LO, WS_HI)                                                                   \
  extern "C" int NAME(const void* x, const void* g, void* dx, int B, int H, int W, int C, int heads, int ws,      \
                      int shift, const void* ln_w, const void* ln_b, const void* wqkv, const void* bqkv,         \
                      const void* wproj, const void* relbias, const void* dp, void* ds_db, void* dwqkv,          \
                      void* dbqkv, void* dwproj, void* dbproj, void* dbias, void* tscratch, long long t_elems,   \
                      void* fscratch, long long f_elems, void* stream) {                                         \
    if (ws < WS_LO || ws > WS_HI) return (int)cudaErrorInvalidValue;                                             \
    return (int)attn_bwd16<T>((const T*)x, (const T*)g, (T*)dx, B, H, W, C, heads, ws, shift, (const float*)ln_w, \
                              (const float*)ln_b, (const T*)wqkv, (const float*)bqkv, (const T*)wproj,           \
                              (const float*)relbias, (const float*)dp, (float*)ds_db, (float*)dwqkv,             \
                              (float*)dbqkv, (float*)dwproj, (float*)dbproj, (float*)dbias, (T*)tscratch,        \
                              t_elems, (float*)fscratch, f_elems, (cudaStream_t)stream);                         \
  }

ATTN_BWD16_ENTRY(attn_bwd16_f32, float, 9, 16)
ATTN_BWD16_ENTRY(attn_bwd16_bf16, __nv_bfloat16, 9, 16)
ATTN_BWD16_ENTRY(attn_bwd_large_f32, float, 17, 1 << 14)
ATTN_BWD16_ENTRY(attn_bwd_large_bf16, __nv_bfloat16, 17, 1 << 14)
