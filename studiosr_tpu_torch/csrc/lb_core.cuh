// The attention core's backward above window 16 in bf16, written for the
// H100: one design for B9's large family (attn_bwd_mma.cu, windows from 17)
// and B13's (oca_bwd_mma.cu, above 256 queries or 576 keys). On a unit u =
// (window w, head h) of QT query tiles and KT key chunks of 64 tokens, the
// images of pass 1 / pass 0 (q, g = dattn, k, v, each 64 x DP K-major) and a
// bias (heads, nq, nk):
//   p = softmax(q k^T + bias [+ mask]), dscores = p (g v^T - D), D = rowsum(p
//   g v^T); dq = dscores k, dk = dscores^T q, dv = p^T g, d bias = the sum of
//   dscores over the windows; and (B9) the attention output p v.
// The contract is the families': p and dscores rounded to bf16 before their
// products, products accumulated in f32, the softmax, its backward and d
// bias in f32; every sum across blocks has one owner and a fixed order (no
// atomics: the same bits from run to run).
//
// Each score tile q k^T and dprob tile g v^T is formed twice, not four times
// as in the streaming passes this replaces (a row pass that swept the key
// chunks twice, a column pass, a d-bias pass):
// 1. lb_stats_kernel (formation 1), a block a (unit, pair of query tiles), a
//    warpgroup a tile; the key chunks stream through two cp.async buffers the
//    warpgroups share. Online row max m, sum l and u = sum p dp, so D = u /
//    l; out (m, 1 / l, D) a query row. With the output (B9) also o = sum of
//    2^(s - m) (rounded to bf16) v over the chunks, rescaled as m grows
//    (FlashAttention's forward), divided by l at the end: the probabilities
//    are rounded before their normalisation, as B5's forward above window
//    16 (lf_core.cuh) rounds them (the streaming passes this
//    replaces rounded them after it; the bf16 step's tolerance holds
//    either).
// 2. lb_main_kernel (formation 2), a block a (group of windows g, head h, key
//    chunk c, query part p), two warpgroups taking the part's query tiles in
//    turn; for each window of the group the chunk's k and v are loaded once
//    and the query tiles with their statistics stream past. Per tile: s and
//    dp on wgmma, p and dscores in registers; d bias added into the block's
//    slab (the part's query tiles x the chunk's 64 keys, f32 in shared
//    memory in fragment order, each element owned by one thread), which
//    stays on the chip across the group's windows of the batch and goes
//    out to the group's slab in global memory, the next batch's block
//    taking it up from there (one slab a group, whatever the batches);
//    dq's partial of the chunk = dscores k (A from registers) to an f32
//    scratch; p^T and dscores^T to shared memory (stmatrix.trans), then dv
//    += p^T g and dk += dscores^T q in registers. At the window's end the
//    two warpgroups' dk / dv are added in order and stored (one part), or
//    stored as the part's partial (QT > QMAX: several parts).
// 3. lb_dq_kernel: dq, the key chunks' partials summed in chunk order;
//    lb_kv_kernel (several parts only): dk and dv, the parts in order;
//    lb_dbias_kernel: d bias, the groups' slabs in order.
// Windows go through passes 2 and 3 in batches (LbPlan::WB) so that the dq
// partials stay under LB_DQP_FLOATS; the slab holds at most QMAX query tiles
// (9 at DP 32: 147 KB of the block's 227 KB), and a window of more query
// tiles is cut into parts whose dk / dv partials lb_kv_kernel adds. Where one
// window's dq partials (heads QT KT 64 DP: DP / 64 of its heads nq nk
// scores) pass LB_DQP_FLOATS, a batch is one window and passes 2 and 3 take
// its parts PB at a time, so the dq partials are at most the larger of
// LB_DQP_FLOATS and one part's (heads QMAX KT 64 DP). The scratch is then
// the statistics, those dq partials, the dk / dv partials of a batch's
// parts and G slabs of heads nq nk: a small multiple of d bias's own size.
// A batch after the first reads its groups' slabs back, so one-window
// batches (HAT from window 48) move 8 bytes of slab a score a window.
//
// What bounds it on the card, at the HAT window-24 step (288 windows, 6
// heads, d 30; B9 576 x 576, B13 576 x 1296): the operations are B9's 12
// T N C + projections (324.6 GFLOP, 0.33 ms) and B13's 10 bw heads nq nk d
// (387 GFLOP, 0.39 ms) at 989 TFLOP/s; the exponentials, the tile's score
// elements once (B13 1.29e9, B9 0.57e9) at about 4.2e12 a second on the
// SFUs, are 0.31 / 0.14 ms a formation; the element-wise work around them
// (the bias, the mask, p, dscores, the slab) about 20 f32 operations an
// element, about 0.8 / 0.35 ms a formation on the FP32 pipes; the traffic:
// the bias tile read once a formation and window from L2 (f32 16 KB, or
// bf16 8 KB, a tile), the streamed operand 8 KB a tile, and the dq partials
// 8 KB a tile written and read again (B13 2.67 GB, B9 1.15 GB at 3.35
// TB/s: 1.6 / 0.7 ms). So the element-wise work and the partials' bytes,
// not the tensor cores. The design forms each tile twice (the element-wise
// work and the bias reads halved), keeps the d-bias accumulator on the chip
// across windows (the d-bias pass and its re-reads gone) and streams one
// operand a tile; the dq partials are the price of keeping dk, dv and d bias
// whole in one block (three sums over three axes: a block holds two).
#pragma once

#include "am_common.cuh"

constexpr int LB_SMEM = 232448;                 // a block's most shared memory on the H100
constexpr long long LB_DQP_FLOATS = 64LL << 20;  // dq partials a batch: 256 MiB
constexpr int LB_MAX_GROUPS = 32;
enum { LB_DQ, LB_DK, LB_DV, LB_O };

// The launch plan, on the host and in every kernel. A batch is the windows
// [w0, w1); where one window's dq partials pass the cap it is one window,
// its parts taken PB at a time.
struct LbPlan {
  int heads, QT, KT, DP, QMAX, P, PB, G, WB, batches, windows;
  int w0, w1, p0, p1, carry;  // this launch: windows [w0, w1), parts [p0, p1); carry: the slabs hold earlier batches
  float *stats, *dqp, *kvp, *dbp;
};

// Shared memory of pass 2 without the slab: the chunk's k and v (K-major)
// and k token-contiguous; per warpgroup its q and g tiles (K-major and
// token-contiguous), p^T and dscores^T, the tile's statistics; the keys' tags.
__host__ __device__ inline int lb_main_rest(int DP) {
  const int ch = AM_TOK * DP * 2;
  return 3 * ch + 2 * (4 * ch + 2 * AM_TOK * AM_TOK * 2 + AM_TOK * 3 * 4) + AM_TOK;
}
// The query tiles a slab holds: 9 at DP 32, 10 at DP 16.
__host__ __device__ inline int lb_qmax(int DP) { return (LB_SMEM - lb_main_rest(DP)) / (AM_TOK * AM_TOK * 4); }
__host__ __device__ inline int lb_main_smem(int DP, int QMAX) { return QMAX * AM_TOK * AM_TOK * 4 + lb_main_rest(DP); }
// Pass 1: the pair's q and g tiles, two buffers of k and v, (with the
// output) two of v token-contiguous, two of the keys' tags.
__host__ __device__ inline int lb_stats_smem(int DP, bool out) {
  const int ch = AM_TOK * DP * 2;
  return 4 * ch + 4 * ch + (out ? 2 * ch : 0) + 2 * AM_TOK;
}

// The plan for `windows` windows of QT x KT tiles: the parts; the batches,
// as few as keep a batch's dq partials within LB_DQP_FLOATS (at least one
// window; one window above the cap, its parts then in runs of PB, as few and
// as even as keep a run within the cap, at least one part), of as even a
// size WB as they can be; the groups of a batch: the
// count, up to LB_MAX_GROUPS and WB / 8 (a block's slab serves at least
// about eight windows), whose waves of heads x KT x P blocks (one an SM)
// take the fewest window steps, the smallest on a tie (ops/cuda/large_bwd.py
// mirrors it).
static LbPlan lb_plan(int windows, int heads, int QT, int KT, int DP, int sms) {
  LbPlan L{};
  L.heads = heads, L.QT = QT, L.KT = KT, L.DP = DP, L.windows = windows;
  L.QMAX = lb_qmax(DP);
  L.P = (QT + L.QMAX - 1) / L.QMAX;
  L.PB = L.P;
  const long long per = (long long)heads * QT * KT * AM_TOK * DP;
  long long wb = LB_DQP_FLOATS / per;
  if (wb < 1) {
    long long pb = LB_DQP_FLOATS / ((long long)heads * L.QMAX * KT * AM_TOK * DP);
    pb = pb < 1 ? 1 : pb;
    const int runs = (int)((L.P + pb - 1) / pb);
    L.PB = (L.P + runs - 1) / runs;
  }
  wb = wb < 1 ? 1 : (wb > windows ? windows : wb);
  L.batches = (int)((windows + wb - 1) / wb);
  L.WB = (windows + L.batches - 1) / L.batches;
  long long best = -1;
  L.G = 1;
  for (int g = 1; g <= L.WB / 8 && g <= LB_MAX_GROUPS; ++g) {
    const long long blocks = (long long)g * heads * KT * L.PB, waves = (blocks + sms - 1) / sms;
    const long long cost = waves * ((L.WB + g - 1) / g);
    if (best < 0 || cost < best) best = cost, L.G = g;
  }
  return L;
}

// f32 scratch of the plan: the row statistics (3 a padded query row), a
// launch's dq partials (WB x heads x min(QT, PB QMAX) x KT tiles of 64 x
// DP), a batch's dk / dv partials (several parts only), the d-bias slabs (G
// x heads x 64 QT x 64 KT).
__host__ __device__ inline long long lb_stats_elems(const LbPlan& L) {
  return (long long)L.windows * L.heads * L.QT * AM_TOK * 3;
}
// The query tiles of a launch's dq partials.
__host__ __device__ inline int lb_dq_rows(const LbPlan& L) { return L.PB * L.QMAX < L.QT ? L.PB * L.QMAX : L.QT; }
__host__ __device__ inline long long lb_dqp_elems(const LbPlan& L) {
  return (long long)L.WB * L.heads * lb_dq_rows(L) * L.KT * AM_TOK * L.DP;
}
__host__ __device__ inline long long lb_kvp_elems(const LbPlan& L) {
  return L.P > 1 ? (long long)L.WB * L.heads * L.KT * L.P * 2 * AM_TOK * L.DP : 0;
}
__host__ __device__ inline long long lb_dbp_elems(const LbPlan& L) {
  return (long long)L.G * L.heads * L.QT * AM_TOK * L.KT * AM_TOK;
}
__host__ __device__ inline long long lb_f_elems(const LbPlan& L) {
  return lb_stats_elems(L) + lb_dqp_elems(L) + lb_kvp_elems(L) + lb_dbp_elems(L);
}
// The plan's scratch pointers from the start of its f32 region (16-byte aligned parts).
__host__ __device__ inline void lb_place(LbPlan& L, float* f) {
  L.stats = f;
  L.dqp = L.stats + lb_stats_elems(L);
  L.kvp = L.dqp + lb_dqp_elems(L);
  L.dbp = L.kvp + lb_kvp_elems(L);
}

// s = q k^T and dp = g v^T of a 64-query tile and a 64-key chunk (K-major
// images in shared memory), this warp's 16 rows in registers.
template <int DP>
__device__ __forceinline__ void lb_scores(float (&s)[8][4], float (&dp)[8][4], const bf16* Q, const bf16* G,
                                          const bf16* K, const bf16* V) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    wg_ss<64>(&s[0][0], wg_desc(Q + ks * 128, 128, DP * 16), wg_desc(K + ks * 128, 128, DP * 16), ks > 0);
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    wg_ss<64>(&dp[0][0], wg_desc(G + ks * 128, 128, DP * 16), wg_desc(V + ks * 128, 128, DP * 16), ks > 0);
  wg_commit();
  wg_wait0();
  wg_hold<32>(&s[0][0]);
  wg_hold<32>(&dp[0][0]);
}

// The token-contiguous copy of one 64 x DP K-major chunk by the four warps
// of a warpgroup (am_transpose's core-matrix mapping).
template <int DP>
__device__ __forceinline__ void lb_transpose(const bf16* src, bf16* dst) {
  constexpr int JG = DP / 8, GROUPS = 8 * JG / 4;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, mi = lane >> 3, rho = lane & 7;
  for (int q = warp; q < GROUPS; q += 4) {
    const int core = q * 4 + mi, tg = core / JG, jg = core % JG;
    uint32_t r0, r1, r2, r3;
    hm_ldsm_x4(r0, r1, r2, r3, src + tg * DP * 8 + jg * 64 + rho * 8);
    am_stsm_x4_t(dst + jg * 512 + tg * 64 + rho * 8, r0, r1, r2, r3);
  }
}

// p^T (or dscores^T) of a warpgroup's tile as an A image (m = key, k = query).
__device__ __forceinline__ void lb_store_t(bf16* T, const uint32_t (&a)[4][4]) {
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) & 3, mi = lane >> 3, rho = lane & 7;
#pragma unroll
  for (int np = 0; np < 4; ++np)
    am_stsm_x4_t(T + (2 * np + (mi >> 1)) * 512 + (2 * wr + (mi & 1)) * 64 + rho * 8, a[np][0], a[np][1], a[np][2],
                 a[np][3]);
}

__device__ __forceinline__ void lb_pack(const float (&x)[8][4], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    a[nt >> 1][(nt & 1) * 2] = hm_pack(x[nt][0], x[nt][1]);
    a[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(x[nt][2], x[nt][3]);
  }
}

// s + bias, and where the chunk takes a mask (the shift's regions, keys past
// the last) the family's masked score from the query rows' and keys' tags.
template <class F>
__device__ __forceinline__ void lb_add_bias(const F& f, float (&s)[8][4], const float4 (&bb)[8], bool masked,
                                            const int (&qtag)[2], const signed char* ktag) {
  const int tq = threadIdx.x & 3;
  if (masked) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * tq;
      const float b4[4] = {bb[nt].x, bb[nt].y, bb[nt].z, bb[nt].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = f.score(s[nt][e], b4[e], qtag[e >> 1], ktag[col + (e & 1)]);
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      s[nt][0] += bb[nt].x, s[nt][1] += bb[nt].y, s[nt][2] += bb[nt].z, s[nt][3] += bb[nt].w;
  }
}

// -- pass 1: the row statistics (and the output) -------------------------------------
//
// A family F gives: the images q(u, r), g(u, r), k(u, c), v(u, c);
// bias4(h, r, c, nt, wt), the bias of thread wt's score fragment of tile
// (r, c); masked(c), whether key chunk c's scores take a mask, and then
// row_tag(w, n) and col_tag(w, n), a token's tag, and score(s, b, qtag,
// ktag), the masked score (unmasked: s + b); store4(kind, u, tile, nt, wt, v), a float4
// of a dq / dk / dv / output fragment (rows q, q + 8 of the tile, columns
// j, j + 1) rounded to its view.
template <int DP, class F, bool OUT>
__global__ void __launch_bounds__(256, 2) lb_stats_kernel(const F f, const LbPlan L) {
  constexpr int CH = AM_TOK * DP, NDT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Q = (bf16*)smem;  // the pair's q tiles, then g tiles
  bf16* KV = Q + 4 * CH;   // two buffers of k, v
  bf16* Vt = KV + 4 * CH;  // two buffers (OUT)
  signed char* tag = (signed char*)(Vt + (OUT ? 2 * CH : 0));  // two buffers of 64
  const int QT = L.QT, KT = L.KT, npair = (QT + 1) / 2;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, wr = wt >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3, q0 = 16 * wr + gq;
  const long long u = blockIdx.x / npair;
  const int pair = blockIdx.x % npair, r = 2 * pair + wg, rb = r < QT ? r : QT - 1, h = (int)(u % L.heads);
  const long long w = u / L.heads;
  const bool valid = r < QT;
  {
    constexpr int PIECES = CH / 8;
    for (int e = tid; e < 4 * PIECES; e += 256) {
      const int part = e / PIECES, i = e % PIECES, t = 2 * pair + (part & 1);
      const bool in = t < QT;
      const bf16* src = part < 2 ? f.q(u, in ? t : 0) : f.g(u, in ? t : 0);
      hm_cp_async<16>(Q + part * CH + 8 * i, src + 8 * i, in);  // past the last tile: zeros
    }
  }
  auto load = [&](int c) {
    constexpr int PIECES = CH / 8;
    bf16* d = KV + (c & 1) * 2 * CH;
    const bf16 *ks = f.k(u, c), *vs = f.v(u, c);
    for (int e = tid; e < 2 * PIECES; e += 256)
      hm_cp_async<16>(d + 8 * e, e < PIECES ? ks + 8 * e : vs + 8 * (e - PIECES), true);
    if (tid < AM_TOK) tag[(c & 1) * AM_TOK + tid] = (signed char)f.col_tag(w, c * AM_TOK + tid);
    hm_cp_commit();
  };
  load(0);
  const int qtag[2] = {f.row_tag(w, rb * AM_TOK + q0), f.row_tag(w, rb * AM_TOK + q0 + 8)};
  const bf16 *Qw = Q + wg * CH, *Gw = Q + (2 + wg) * CH;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, us[2] = {0.f, 0.f};
  float o[NDT][4];
#pragma unroll
  for (int nt = 0; nt < NDT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll 1
  for (int c = 0; c < KT; ++c) {
    const int b = c & 1;
    if (c + 1 < KT) {
      load(c + 1);
      hm_cp_wait_upto(1);
    } else {
      hm_cp_wait_upto(0);
    }
    wg_proxy_fence();
    __syncthreads();  // chunk c (and the pair's tiles) in
    const bf16 *K = KV + b * 2 * CH, *V = K + CH;
    if constexpr (OUT) {
      am_transpose<DP>(V, Vt + b * CH, 1, 8);
      wg_proxy_fence();
      __syncthreads();
    }
    float4 bb[8];  // loaded before the products, so their latency hides under them
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) bb[nt] = f.bias4(h, rb, c, nt, wt);
    float s[8][4], dp[8][4];
    lb_scores<DP>(s, dp, Qw, Gw, K, V);
    lb_add_bias(f, s, bb, f.masked(c), qtag, tag + b * AM_TOK);
    float sc[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      const float mn = fmaxf(m[hh], am_quad_max(mx) * AM_LOG2E);
      sc[hh] = am_exp2(m[hh] - mn);
      l[hh] *= sc[hh], us[hh] *= sc[hh], m[hh] = mn;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = am_exp2(fmaf(s[nt][2 * hh + e], AM_LOG2E, -mn));
          s[nt][2 * hh + e] = p;
          l[hh] += p, us[hh] += p * dp[nt][2 * hh + e];
        }
    }
    if constexpr (OUT) {
      uint32_t pa[4][4];
      lb_pack(s, pa);
#pragma unroll
      for (int nt = 0; nt < NDT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] *= sc[e >> 1];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wg_rs<DP>(&o[0][0], pa[ks], wg_desc(Vt + b * CH + ks * 128, 128, AM_TOK * 16), 1);
      wg_commit();
      wg_wait0();
      wg_hold<NDT * 4>(&o[0][0]);
      wg_hold<16>(&pa[0][0]);
    }
    __syncthreads();  // every warp is done with buffer b before chunk c + 2 fills it
  }
  float linv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = am_quad_sum(l[hh]), us[hh] = am_quad_sum(us[hh]);
    linv[hh] = 1.f / l[hh];
    if (valid && tq == 0) {
      float* st = L.stats + (u * QT * AM_TOK + r * AM_TOK + q0 + 8 * hh) * 3;
      st[0] = m[hh], st[1] = linv[hh], st[2] = us[hh] * linv[hh];
    }
  }
  if constexpr (OUT) {
    if (valid)
#pragma unroll
      for (int nt = 0; nt < NDT; ++nt)
        f.store4(LB_O, u, r, nt, wt,
                 make_float4(o[nt][0] * linv[0], o[nt][1] * linv[0], o[nt][2] * linv[1], o[nt][3] * linv[1]));
  }
}

// -- pass 2: p, dscores, d bias, dq's partials, dk and dv ------------------------------

struct LbMainSmem {
  int slab, kk, vk, kt, qk, gk, qt, gt, pt, sd, st, tag, total;
};

// The slab first, then the chunk's k, v and k^T, then per warpgroup (wg
// times the stride) q, g, q^T, g^T, p^T, dscores^T and the statistics.
__host__ __device__ inline LbMainSmem lb_main_layout(int DP, int QMAX) {
  LbMainSmem S;
  const int ch = AM_TOK * DP * 2, sq = AM_TOK * AM_TOK * 2;
  int o = 0;
  S.slab = o, o += QMAX * AM_TOK * AM_TOK * 4;
  S.kk = o, o += ch;
  S.vk = o, o += ch;
  S.kt = o, o += ch;
  S.qk = o, o += 2 * ch;
  S.gk = o, o += 2 * ch;
  S.qt = o, o += 2 * ch;
  S.gt = o, o += 2 * ch;
  S.pt = o, o += 2 * sq;
  S.sd = o, o += 2 * sq;
  S.st = o, o += 2 * AM_TOK * 3 * 4;
  S.tag = o, o += AM_TOK;
  S.total = o;
  return S;
}

// A block owns (group g, head h, key chunk c, query part p of the launch's
// p0 .. p1 - 1): blocks (g, h, p, 0 .. KT - 1) are neighbours, so a window's
// query tiles serve its chunks' blocks from L2. Its slab starts from zeros
// in the first batch and from the group's slab in global memory after it. Warpgroup wg takes the part's tiles wg, wg + 2,
// ...; past the part's last tile it computes on a stale tile with p = 0 and
// stores nothing, so no branch between a warpgroup's products depends on its
// tiles.
template <int DP, class F>
__global__ void __launch_bounds__(256, 1) lb_main_kernel(const F f, const LbPlan L) {
  constexpr int CH = AM_TOK * DP, NDT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const LbMainSmem S = lb_main_layout(DP, L.QMAX);
  float4* slab = (float4*)(smem + S.slab);
  bf16 *Kk = (bf16*)(smem + S.kk), *Vk = (bf16*)(smem + S.vk), *Kt = (bf16*)(smem + S.kt);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, wr = wt >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3, q0 = 16 * wr + gq;
  bf16 *Qk = (bf16*)(smem + S.qk) + wg * CH, *Gk = (bf16*)(smem + S.gk) + wg * CH;
  bf16 *Qt = (bf16*)(smem + S.qt) + wg * CH, *Gt = (bf16*)(smem + S.gt) + wg * CH;
  bf16 *PT = (bf16*)(smem + S.pt) + wg * AM_TOK * AM_TOK, *ST = (bf16*)(smem + S.sd) + wg * AM_TOK * AM_TOK;
  float* stw = (float*)(smem + S.st) + wg * AM_TOK * 3;
  signed char* ktag = (signed char*)(smem + S.tag);
  const int QT = L.QT, KT = L.KT, heads = L.heads;
  int bi = blockIdx.x;
  const int c = bi % KT;
  bi /= KT;
  const int part = L.p0 + bi % (L.p1 - L.p0);
  bi /= L.p1 - L.p0;
  const int h = bi % heads, g = bi / heads;
  const bool masked = f.masked(c);
  const int r0 = part * L.QMAX, QTB = QT - r0 < L.QMAX ? QT - r0 : L.QMAX, steps = (QTB + 1) / 2;
  const int NQP = QT * AM_TOK, NKP = KT * AM_TOK, dr0 = L.p0 * L.QMAX, DQR = lb_dq_rows(L);
  // the group's slab: rows of the part's tiles, the chunk's 64 columns; each
  // thread takes up and puts back the elements it adds into
  float* dbp = L.dbp + ((long long)g * heads + h) * NQP * NKP;
  for (int lr = wg; lr < QTB; lr += 2)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const long long row = (long long)(r0 + lr) * AM_TOK + q0, col = c * AM_TOK + nt * 8 + 2 * tq;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (L.carry) {
        const float2 a = *reinterpret_cast<const float2*>(dbp + row * NKP + col);
        const float2 b = *reinterpret_cast<const float2*>(dbp + (row + 8) * NKP + col);
        v = make_float4(a.x, a.y, b.x, b.y);
      }
      slab[(lr * 8 + nt) * 128 + wt] = v;
    }
  for (int e = tid; e < 4 * CH / 8; e += 256)  // both warpgroups' q and g: a tile past the part's last starts as zeros
    reinterpret_cast<uint4*>(smem + S.qk)[e] = make_uint4(0u, 0u, 0u, 0u);
  for (int e = tid; e < 2 * AM_TOK * 3; e += 256) ((float*)(smem + S.st))[e] = 0.f;
  __syncthreads();
  // the chunk's k and v of window w, by every thread
  auto load_kv = [&](long long w) {
    const long long u = w * heads + h;
    constexpr int PIECES = CH / 8;
    const bf16 *ks = f.k(u, c), *vs = f.v(u, c);
    for (int e = tid; e < 2 * PIECES; e += 256)
      hm_cp_async<16>(e < PIECES ? Kk + 8 * e : Vk + 8 * (e - PIECES), e < PIECES ? ks + 8 * e : vs + 8 * (e - PIECES),
                      true);
  };
  // the warpgroup's tile lr of window w (q, g, statistics), by its threads
  auto load_tile = [&](long long w, int lr) {
    if (lr >= QTB) return;
    const long long u = w * heads + h;
    const int r = r0 + lr;
    constexpr int PIECES = CH / 8, SP = AM_TOK * 3 / 4;
    for (int e = wt; e < 2 * PIECES + SP; e += 128) {
      if (e < PIECES)
        hm_cp_async<16>(Qk + 8 * e, f.q(u, r) + 8 * e, true);
      else if (e < 2 * PIECES)
        hm_cp_async<16>(Gk + 8 * (e - PIECES), f.g(u, r) + 8 * (e - PIECES), true);
      else
        hm_cp_async<16>(stw + 4 * (e - 2 * PIECES), L.stats + (u * QT + r) * AM_TOK * 3 + 4 * (e - 2 * PIECES), true);
    }
  };
  const long long wfirst = L.w0 + g;
  if (wfirst < L.w1) load_kv(wfirst), load_tile(wfirst, wg);
  hm_cp_commit();
  // The warpgroups meet only where they share: at a window's start (its k,
  // v, k^T and key tags), at its last step (both done with k and v, so the
  // next window's come in) and at its end (dk / dv added); within a window
  // each loads its own next tile and waits for nothing of the other's.
#pragma unroll 1
  for (long long w = wfirst; w < L.w1; w += L.G) {
    const long long u = w * heads + h, ub = (w - L.w0) * heads + h;
    float dk[NDT][4], dv[NDT][4];
    hm_cp_wait_upto(0);
    wg_proxy_fence();
    __syncthreads();  // k, v and the first tiles in; the last window's k^T and tags free
    am_transpose<DP>(Kk, Kt, 1, 8);
    if (tid < AM_TOK) ktag[tid] = (signed char)f.col_tag(w, c * AM_TOK + tid);
    wg_proxy_fence();
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < steps; ++i) {
      if (i > 0) {
        hm_cp_wait_upto(0);
        wg_proxy_fence();
        am_wg_sync(wg);  // the warpgroup's tile in; its last step's buffers free
      }
      const int lr = 2 * i + wg, r = r0 + lr, rb = r < QT ? r : QT - 1;
      const bool valid = lr < QTB;
      float4 bb[8];  // loaded before the products, so their latency hides under them
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) bb[nt] = f.bias4(h, rb, c, nt, wt);
      float s[8][4], dp[8][4];
      lb_scores<DP>(s, dp, Qk, Gk, Kk, Vk);
      lb_transpose<DP>(Qk, Qt);
      lb_transpose<DP>(Gk, Gt);
      float m[2], linv[2], D[2];
      int qtag[2] = {0, 0};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float* st = stw + (q0 + 8 * hh) * 3;
        m[hh] = st[0], linv[hh] = st[1], D[hh] = st[2];
        if (masked) qtag[hh] = f.row_tag(w, rb * AM_TOK + q0 + 8 * hh);
      }
      lb_add_bias(f, s, bb, masked, qtag, ktag);
      wg_proxy_fence();
      if (i + 1 < steps) {
        am_wg_sync(wg);  // the warpgroup is done reading its tile and statistics
        load_tile(w, lr + 2);
      } else {
        __syncthreads();  // both warpgroups are done with k and v
        if (w + L.G < L.w1) load_kv(w + L.G), load_tile(w + L.G, wg);
      }
      hm_cp_commit();
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float4 ds4;
        float* d4 = &ds4.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = valid ? am_exp2(fmaf(s[nt][e], AM_LOG2E, -m[e >> 1])) * linv[e >> 1] : 0.f;
          const float ds = p * (dp[nt][e] - D[e >> 1]);
          s[nt][e] = p, dp[nt][e] = ds, d4[e] = ds;
        }
        if (valid) {
          float4& acc = slab[(lr * 8 + nt) * 128 + wt];
          float4 a = acc;
          a.x += ds4.x, a.y += ds4.y, a.z += ds4.z, a.w += ds4.w;
          acc = a;
        }
      }
      lb_pack(s, pa);
      lb_pack(dp, sa);
      lb_store_t(PT, pa);
      lb_store_t(ST, sa);
      wg_proxy_fence();
      am_wg_sync(wg);
      float dq[NDT][4];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wg_rs<DP>(&dq[0][0], sa[ks], wg_desc(Kt + ks * 128, 128, AM_TOK * 16), ks > 0);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wg_ss<DP>(&dk[0][0], wg_desc(ST + ks * 128, 128, AM_TOK * 16), wg_desc(Qt + ks * 128, 128, AM_TOK * 16),
                  i > 0 || ks > 0);
        wg_ss<DP>(&dv[0][0], wg_desc(PT + ks * 128, 128, AM_TOK * 16), wg_desc(Gt + ks * 128, 128, AM_TOK * 16),
                  i > 0 || ks > 0);
      }
      wg_commit();
      wg_wait0();
      wg_hold<NDT * 4>(&dq[0][0]);
      wg_hold<NDT * 4>(&dk[0][0]);
      wg_hold<NDT * 4>(&dv[0][0]);
      wg_hold<16>(&pa[0][0]);
      wg_hold<16>(&sa[0][0]);
      am_wg_sync(wg);  // every warp is done with the warpgroup's p^T, dscores^T, q^T and g^T
      if (valid) {
        float4* dst = (float4*)L.dqp + ((ub * DQR + r - dr0) * KT + c) * NDT * 128;
#pragma unroll
        for (int nt = 0; nt < NDT; ++nt) dst[nt * 128 + wt] = make_float4(dq[nt][0], dq[nt][1], dq[nt][2], dq[nt][3]);
      }
    }
    // dk and dv of the window: warpgroup 1's through its p^T and dscores^T
    // buffers, added after warpgroup 0's (past the part's last tile
    // warpgroup 1's are zeros)
    float4 *boxk = (float4*)(smem + S.pt) + AM_TOK * AM_TOK / 8, *boxv = (float4*)(smem + S.sd) + AM_TOK * AM_TOK / 8;
    if (wg == 1)
#pragma unroll
      for (int nt = 0; nt < NDT; ++nt) {
        boxk[nt * 128 + wt] = make_float4(dk[nt][0], dk[nt][1], dk[nt][2], dk[nt][3]);
        boxv[nt * 128 + wt] = make_float4(dv[nt][0], dv[nt][1], dv[nt][2], dv[nt][3]);
      }
    __syncthreads();  // warpgroup 1's dk and dv in
    if (wg == 0) {
#pragma unroll
      for (int nt = 0; nt < NDT; ++nt) {
        float4 k4 = make_float4(dk[nt][0], dk[nt][1], dk[nt][2], dk[nt][3]);
        float4 v4 = make_float4(dv[nt][0], dv[nt][1], dv[nt][2], dv[nt][3]);
        const float4 k1 = boxk[nt * 128 + wt], v1 = boxv[nt * 128 + wt];
        k4.x += k1.x, k4.y += k1.y, k4.z += k1.z, k4.w += k1.w;
        v4.x += v1.x, v4.y += v1.y, v4.z += v1.z, v4.w += v1.w;
        if (L.P == 1) {
          f.store4(LB_DK, u, c, nt, wt, k4);
          f.store4(LB_DV, u, c, nt, wt, v4);
        } else {
          float4* dst = (float4*)L.kvp + ((ub * KT + c) * L.P + part) * 2 * NDT * 128;
          dst[nt * 128 + wt] = k4;
          dst[(NDT + nt) * 128 + wt] = v4;
        }
      }
    }
  }
  // the slab back to the group's
  for (int lr = wg; lr < QTB; lr += 2)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float4 v = slab[(lr * 8 + nt) * 128 + wt];
      const long long row = (long long)(r0 + lr) * AM_TOK + q0, col = c * AM_TOK + nt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(dbp + row * NKP + col) = make_float2(v.x, v.y);
      *reinterpret_cast<float2*>(dbp + (row + 8) * NKP + col) = make_float2(v.z, v.w);
    }
}

// -- pass 3: the sums ------------------------------------------------------------------

// A thread a float4 of a (unit, query tile)'s fragment-ordered dq, the
// launch's parts' tiles: the key chunks' partials summed in chunk order.
template <int DP, class F>
__global__ void __launch_bounds__(256) lb_dq_kernel(const F f, const LbPlan L) {
  constexpr int NDT = DP / 8;
  const int dr0 = L.p0 * L.QMAX, rows = (L.p1 * L.QMAX < L.QT ? L.p1 * L.QMAX : L.QT) - dr0, DQR = lb_dq_rows(L);
  const int per = rows * NDT * 128;
  const long long total = (long long)(L.w1 - L.w0) * L.heads * per;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long ub = e / per;
    const int rem = (int)(e - ub * per), r = rem / (NDT * 128), fr = rem % (NDT * 128);
    const float4* part = (const float4*)L.dqp + (ub * DQR + r) * L.KT * NDT * 128 + fr;
    float4 sum = part[0];
    for (int c = 1; c < L.KT; ++c) {
      const float4 v = part[(long long)c * NDT * 128];
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    f.store4(LB_DQ, (long long)L.w0 * L.heads + ub, dr0 + r, fr / 128, fr % 128, sum);
  }
}

// Several parts: a thread a float4 of a (unit, key chunk)'s dk or dv, the
// parts' partials summed in part order.
template <int DP, class F>
__global__ void __launch_bounds__(256) lb_kv_kernel(const F f, const LbPlan L) {
  constexpr int NDT = DP / 8;
  const int per = L.KT * 2 * NDT * 128;
  const long long total = (long long)(L.w1 - L.w0) * L.heads * per;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long ub = e / per;
    const int rem = (int)(e - ub * per), c = rem / (2 * NDT * 128), fr = rem % (2 * NDT * 128);
    const float4* part = (const float4*)L.kvp + (ub * L.KT + c) * L.P * 2 * NDT * 128 + fr;
    float4 sum = part[0];
    for (int p = 1; p < L.P; ++p) {
      const float4 v = part[(long long)p * 2 * NDT * 128];
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    const int kind = fr < NDT * 128 ? LB_DK : LB_DV, g = fr % (NDT * 128);
    f.store4(kind, (long long)L.w0 * L.heads + ub, c, g / 128, g % 128, sum);
  }
}

// out[h][q][k] (nq x nk) = the groups' slabs summed in group order.
__global__ void lb_dbias_kernel(const LbPlan L, int nq, int nk, float* __restrict__ out) {
  const long long NQP = (long long)L.QT * AM_TOK, NKP = (long long)L.KT * AM_TOK, per = (long long)nq * nk;
  const int parts = L.G;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < L.heads * per;
       i += (long long)gridDim.x * blockDim.x) {
    const long long h = i / per, e = i % per, src = (e / nk) * NKP + e % nk;
    float v = 0.f;
    for (int p = 0; p < parts; ++p) v += L.dbp[(p * (long long)L.heads + h) * NQP * NKP + src];
    out[i] = v;
  }
}

static int lb_blocks(long long n) { return (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192); }

// The passes on the stream for the plan's windows: statistics (with OUT the
// output), then for each batch of windows and each run of PB parts the main
// pass and dq, for each batch (several parts) dk / dv, then d bias (heads,
// nq, nk) into `dbias`.
template <int DP, class F, bool OUT>
static cudaError_t lb_launch(const F& f, LbPlan L, int nq, int nk, float* dbias, cudaStream_t st) {
  constexpr int NDT = DP / 8;
  size_t bytes = lb_stats_smem(DP, OUT);
  cudaError_t err = allow_smem(lb_stats_kernel<DP, F, OUT>, bytes);
  if (err != cudaSuccess) return err;
  lb_stats_kernel<DP, F, OUT><<<(int)((long long)L.windows * L.heads * ((L.QT + 1) / 2)), 256, bytes, st>>>(f, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bytes = lb_main_smem(DP, L.QMAX);
  if ((err = allow_smem(lb_main_kernel<DP, F>, bytes)) != cudaSuccess) return err;
  for (int b = 0; b < L.batches; ++b) {
    L.w0 = b * L.WB;
    L.w1 = L.w0 + L.WB < L.windows ? L.w0 + L.WB : L.windows;
    L.carry = b > 0;
    const long long units = (long long)(L.w1 - L.w0) * L.heads;
    for (L.p0 = 0; L.p0 < L.P; L.p0 += L.PB) {
      L.p1 = L.p0 + L.PB < L.P ? L.p0 + L.PB : L.P;
      lb_main_kernel<DP, F><<<L.G * L.heads * (L.p1 - L.p0) * L.KT, 256, bytes, st>>>(f, L);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      lb_dq_kernel<DP, F><<<lb_blocks(units * lb_dq_rows(L) * NDT * 128), 256, 0, st>>>(f, L);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (L.P > 1) {
      lb_kv_kernel<DP, F><<<lb_blocks(units * L.KT * 2 * NDT * 128), 256, 0, st>>>(f, L);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  lb_dbias_kernel<<<lb_blocks((long long)L.heads * nq * nk), 256, 0, st>>>(L, nq, nk, dbias);
  return cudaGetLastError();
}
