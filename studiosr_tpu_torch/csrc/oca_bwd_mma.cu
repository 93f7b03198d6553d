// B13 in bf16, written for the H100: the backward of the core of HAT's
// overlapping cross-attention,
//   out = softmax(q k^T + bias) v,
// on q (bw, heads, nq, d), already scaled by 1/sqrt(d), k and v (bw, heads,
// nk, d), the f32 bias (heads, nq, nk) and the cotangent g of out: dq, dk,
// dv in bf16 and d bias summed over the bw windows in f32.
//
// Replaces studiosr_tpu/ops/pallas/oca_core.py::oca_core_bwd (:157, kernel
// _bwd_kernel at :73) in bf16; f32, the checks' dtype, keeps oca_core.cu on
// attn_core.cuh, and so do head dims above 32. Two entries: up to 256
// queries and 576 keys (HAT's windows up to 16) oca_core_bwd_mma_bf16 runs
// the five passes below; above (HAT's windows from 17) oca_core_bwd_large_mma_bf16
// runs pass 0 and three streaming passes whose shared memory does not grow
// with nq or nk (below, before the host code). The contract is its: p and dscores = p (dp - D) rounded to bf16
// before their products, products accumulated in f32, the softmax (max
// subtracted, a deliberate difference: ROADMAP.md C) and its backward in
// f32, d bias the sum of the f32 dscores; every sum across blocks in a fixed
// order (no atomic sums: the same bits from run to run).
//
// Bound on the card at HAT's training shapes (bw 512 = batch 32 x 16
// windows, 6 heads, nq 256, nk 576, d 30): 10 bw heads nq nk d = 135.9
// GFLOP against 573 MB, so bytes (0.171 ms). oca_core.cu ran a row pass (two
// sweeps: the row statistics, then dq) and a column pass (dk, dv, d bias) on
// mma.sync, staging the 60-byte rows of the OCAB's transposed views (a
// 360-byte token stride) by 4-byte cp.async, and so computed every score
// three times. Here, five passes, the scores computed twice:
// 0. ob_pack_kernel: q, g, k and v, strided views read in place, into
//    wgmma's K-major core-matrix image, per (window, head) 64-token tiles
//    with d padded to DP (32 at d 30) and tokens to whole tiles, the padding
//    zero (one pass over the views; every later read is a 16-byte cp.async:
//    copying the views in place in 4-byte pieces instead took 3.92 ms
//    against 2.31 on an H100, scripts/torch_ablate_mlp_oca.py).
// 1. ob_stats_kernel, a block a (window, head, pair of query tiles), a
//    warpgroup a tile, two blocks an SM: the unit's k and v images and the
//    pair's q and g tiles in shared memory; sweep 1 over the key chunks, the
//    scores and dprobs = g v^T on wgmma in registers, the bias added, keys
//    past nk masked; the online row max m, sum l and u = sum p dp, so D =
//    u / l. Out: (m, 1 / l, D) a query row.
// 2. ob_main_kernel, a block a (head, key chunk, group of windows), two
//    warpgroups over the query tiles (padded to an even count, so no branch
//    between a warpgroup's products depends on its tiles): sweep 2 for each
//    window of the group, the scores and dprobs again on wgmma, p and
//    dscores in registers; d bias, f32, accumulated in registers over the
//    group's windows (each thread owns its fragments of the block's 256 x 64
//    slice; the bias slice stays in shared memory in fragment order); dq's
//    partial of the chunk = dscores k on wgmma (A in registers) to an f32
//    scratch in fragment order; p^T and dscores^T to shared memory
//    (stmatrix.trans), then dk = dscores^T q and dv = p^T g over all the
//    window's queries as one product chain each, so the chunk's dk and dv
//    come out whole. The next window's operands are copied in meanwhile.
//    Shared memory: 211,968 bytes at nq 256, d 30, one block an SM.
// 3. ob_dq_kernel: dq, the chunk partials summed in chunk order.
// 4. reduce_parts: d bias, the groups' partials summed in group order.
// The three sums (dq over key chunks, dk / dv over query tiles, d bias over
// windows) each have one owner and a fixed order: no atomics.
#include "am_common.cuh"

constexpr int OB_MAX_NQ = 256, OB_MAX_NK = 576;

// Strides, in elements, of the eight tensors, (window, head, token) each:
// q, k, v, g, out (unused), dq, dk, dv (the order of oca_core.cu's OC_*).
enum { OB_Q, OB_K, OB_V, OB_G, OB_O, OB_DQ, OB_DK, OB_DV, OB_N };

struct ObArgs {
  const bf16 *q, *k, *v, *g;
  bf16 *dq, *dk, *dv;
  long long st[OB_N][3];
  const float* bias;  // (heads, nq, nk)
  bf16* img;          // per unit: q, g (QT tiles), k, v (KT chunks), each 64 x DP K-major
  float *stats, *dqp, *dbp;
  long long units, unit_elems;
  int bw, heads, nq, nk, d, QT, KT, groups, pairs;  // pairs: dq, dk, dv take 4-byte stores
};

// -- pass 0: the images ---------------------------------------------------------------

// One thread a 16-byte piece (8 d values of a token) of every unit's image.
template <int DP>
__global__ void __launch_bounds__(256) ob_pack_kernel(const ObArgs a) {
  constexpr int JG = DP / 8;
  const int tiles = 2 * a.QT + 2 * a.KT;
  const long long per_unit = (long long)tiles * AM_TOK * JG, total = a.units * per_unit;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < total;
       p += (long long)gridDim.x * blockDim.x) {
    const long long u = p / per_unit;
    const int r = (int)(p - u * per_unit), tile = r / (AM_TOK * JG), t = (r / JG) % AM_TOK, jg = r % JG;
    const int w = (int)(u / a.heads), h = (int)(u % a.heads);
    int which, ti, n;
    if (tile < a.QT) which = OB_Q, ti = tile, n = a.nq;
    else if (tile < 2 * a.QT) which = OB_G, ti = tile - a.QT, n = a.nq;
    else if (tile < 2 * a.QT + a.KT) which = OB_K, ti = tile - 2 * a.QT, n = a.nk;
    else which = OB_V, ti = tile - 2 * a.QT - a.KT, n = a.nk;
    const bf16* base = which == OB_Q ? a.q : which == OB_G ? a.g : which == OB_K ? a.k : a.v;
    const int token = ti * AM_TOK + t;
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(0.f);
    if (token < n) {
      const bf16* src = base + w * a.st[which][0] + h * a.st[which][1] + token * a.st[which][2];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (8 * jg + e < a.d) vals[e] = src[8 * jg + e];
    }
    *reinterpret_cast<uint4*>(a.img + u * a.unit_elems + (long long)tile * AM_TOK * DP + am_kmajor(8 * jg, t, DP)) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

// -- the scores ------------------------------------------------------------------------

// s = q k^T and dp = g v^T of a 64-query tile and a 64-key chunk (K-major
// images in shared memory), this warp's 16 rows in registers.
template <int DP>
__device__ __forceinline__ void ob_scores(float (&s)[8][4], float (&dp)[8][4], const bf16* Q, const bf16* G,
                                          const bf16* K, const bf16* V) {
  constexpr int KS = DP / 16;
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wg_ss<64>(&s[0][0], wg_desc(Q + ks * 128, 128, DP * 16), wg_desc(K + ks * 128, 128, DP * 16), ks > 0);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wg_ss<64>(&dp[0][0], wg_desc(G + ks * 128, 128, DP * 16), wg_desc(V + ks * 128, 128, DP * 16), ks > 0);
  wg_commit();
  wg_wait0();
  wg_hold<32>(&s[0][0]);
  wg_hold<32>(&dp[0][0]);
}

// The bias of a thread's score fragment (rows r, r + 8; columns col, col +
// 1; col even), zero outside (nq, nk): two 8-byte loads when nk is even.
__device__ __forceinline__ float4 ob_bias4(const ObArgs& a, int h, int r, int col) {
  const float* b = a.bias + (size_t)h * a.nq * a.nk;
  float v[4];
  if ((a.nk & 1) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r + 8 * hh;
      const float2 f = row < a.nq && col < a.nk ? __ldg(reinterpret_cast<const float2*>(b + (size_t)row * a.nk + col))
                                                : make_float2(0.f, 0.f);
      v[2 * hh] = f.x, v[2 * hh + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e >> 1), c = col + (e & 1);
      v[e] = row < a.nq && c < a.nk ? __ldg(b + (size_t)row * a.nk + c) : 0.f;
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// -- pass 1: the row statistics ---------------------------------------------------------

// A block a (window, head, pair of query tiles), warpgroup w the tile 2 pair
// + w (past the last tile it computes on the next image's rows and stores
// nothing): the unit's k and v images and the pair's q and g tiles copied in
// (88 KB at nk 576, two blocks an SM), then sweep 1 over the key chunks.
template <int DP>
__global__ void __launch_bounds__(256, 2) ob_stats_kernel(const ObArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, wr = wt >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int npair = (a.QT + 1) / 2;
  const long long u = blockIdx.x / npair;
  const int i = 2 * (blockIdx.x % npair) + wg, h = (int)(u % a.heads);
  const long long tile = (long long)AM_TOK * DP;
  bf16* K = (bf16*)smem;  // KT chunks of k, then of v
  bf16* V = K + a.KT * tile;
  bf16* QG = V + a.KT * tile;  // the pair's q tiles, then its g tiles
  {
    const bf16* src = a.img + u * a.unit_elems;
    const int kv = 2 * a.KT * (int)tile / 8, qg = 2 * (int)tile / 8;  // 16-byte pieces
    const int q0 = 2 * (blockIdx.x % npair);
    for (int e = tid; e < kv + 2 * qg; e += 256) {
      if (e < kv) {
        hm_cp_async<16>(K + 8 * e, src + 2 * a.QT * tile + 8 * e, true);
      } else {
        const int f = e - kv, part = f / qg, r = f % qg;  // part 0: q, 1: g
        // tile q0 + 1 may lie past the last: a copy of the next tile's place, never stored from
        hm_cp_async<16>(QG + part * 2 * tile + 8 * r, src + (part * a.QT + q0) * tile + 8 * r, true);
      }
    }
    hm_cp_commit();
  }
  hm_cp_wait_upto(0);
  wg_proxy_fence();
  __syncthreads();
  const bf16 *Q = QG + wg * tile, *G = QG + (2 + wg) * tile;
  const int r0 = i * AM_TOK + 16 * wr + gq;  // this thread's query rows r0, r0 + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, us[2] = {0.f, 0.f};
#pragma unroll 1
  for (int c = 0; c < a.KT; ++c) {
    float4 bb[8];  // loaded before the products, so their latency hides under them
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) bb[nt] = ob_bias4(a, h, r0, c * AM_TOK + nt * 8 + 2 * tq);
    float s[8][4], dp[8][4];
    ob_scores<DP>(s, dp, Q, G, K + c * tile, V + c * tile);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = c * AM_TOK + nt * 8 + 2 * tq;
      s[nt][0] = col < a.nk ? s[nt][0] + bb[nt].x : -INFINITY;
      s[nt][1] = col + 1 < a.nk ? s[nt][1] + bb[nt].y : -INFINITY;
      s[nt][2] = col < a.nk ? s[nt][2] + bb[nt].z : -INFINITY;
      s[nt][3] = col + 1 < a.nk ? s[nt][3] + bb[nt].w : -INFINITY;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      const float mn = fmaxf(m[hh], am_quad_max(mx) * AM_LOG2E), sc = am_exp2(m[hh] - mn);
      l[hh] *= sc, us[hh] *= sc, m[hh] = mn;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = am_exp2(fmaf(s[nt][2 * hh + e], AM_LOG2E, -mn));
          l[hh] += p, us[hh] += p * dp[nt][2 * hh + e];
        }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = am_quad_sum(l[hh]), us[hh] = am_quad_sum(us[hh]);
    if (tq == 0 && i < a.QT) {
      float* st = a.stats + (u * a.QT * AM_TOK + r0 + 8 * hh) * 3;
      st[0] = m[hh], st[1] = 1.f / l[hh], st[2] = us[hh] / l[hh];
    }
  }
}

// -- pass 2: p, dscores and the sums -------------------------------------------------------

struct ObMainSmem {
  size_t bias, qk, gk, qt, gt, kk, vk, kt, pt, sd, stat, total;
};

// The key chunk's bias in fragment order (f32), q and g of every query tile
// (K-major in d, then token-contiguous; QTP tiles, QT rounded up to even,
// the last zero when QT is odd), the chunk's k, v (K-major in d) and k
// (token-contiguous), p^T and dscores^T of every query tile (A images) and
// the row statistics: 211,968 bytes at nq 256, d 30.
__host__ __device__ inline ObMainSmem ob_main_smem(int QTP, int DP) {
  ObMainSmem L;
  const size_t tile = (size_t)AM_TOK * DP * 2, sq = (size_t)AM_TOK * AM_TOK * 2;
  size_t o = 0;
  L.bias = o, o += (size_t)QTP * 8 * 128 * 16;
  L.qk = o, o += QTP * tile;
  L.gk = o, o += QTP * tile;
  L.qt = o, o += QTP * tile;
  L.gt = o, o += QTP * tile;
  L.kk = o, o += tile;
  L.vk = o, o += tile;
  L.kt = o, o += tile;
  L.pt = o, o += QTP * sq;
  L.sd = o, o += QTP * sq;
  L.stat = o, o += (size_t)QTP * AM_TOK * 3 * 4;
  L.total = (o + 127) & ~(size_t)127;
  return L;
}

// A block owns (group g, head h, key chunk c): blocks (g, h, 0 .. KT - 1)
// are neighbours, so a window's q and g serve its chunks' blocks from L2.
// Warpgroup wg takes the query tiles wg and wg + 2 (QTP 4) or wg (QTP 2), so
// no branch between a warpgroup's products depends on its tiles. The next
// window's operands are copied in while this window's dk and dv run.
template <int DP, int QTP>
__global__ void __launch_bounds__(256, 1) ob_main_kernel(const ObArgs a) {
  constexpr int NDT = DP / 8, TPW = QTP / 2;  // 8-column tiles of d; query tiles a warpgroup
  extern __shared__ __align__(128) unsigned char smem[];
  const int QT = a.QT, KT = a.KT;
  const ObMainSmem L = ob_main_smem(QTP, DP);
  float4* Bs = (float4*)(smem + L.bias);
  bf16 *Qk = (bf16*)(smem + L.qk), *Gk = (bf16*)(smem + L.gk), *Qt = (bf16*)(smem + L.qt), *Gt = (bf16*)(smem + L.gt);
  bf16 *Kk = (bf16*)(smem + L.kk), *Vk = (bf16*)(smem + L.vk), *Kt = (bf16*)(smem + L.kt);
  bf16 *PT = (bf16*)(smem + L.pt), *ST = (bf16*)(smem + L.sd);
  float* stat = (float*)(smem + L.stat);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, wr = wt >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int c = blockIdx.x % KT, h = (blockIdx.x / KT) % a.heads, g = blockIdx.x / (KT * a.heads);
  const int q0 = 16 * wr + gq;  // this thread's rows q0, q0 + 8 of a query tile
  const long long tile_elems = (long long)AM_TOK * DP;
  for (int e = tid; e < QTP * 8 * 128; e += 256) {
    const int i = e / 1024, nt = (e / 128) % 8, t = e % 128;
    Bs[e] = ob_bias4(a, h, i * AM_TOK + 16 * (t >> 5) + ((t & 31) >> 2), c * AM_TOK + nt * 8 + 2 * (t & 3));
  }
  if (QT < QTP) {  // the padding tile: zero q, g and statistics, never copied over
    for (int e = tid; e < (int)tile_elems / 8; e += 256) {
      reinterpret_cast<uint4*>(Qk + QT * tile_elems)[e] = make_uint4(0u, 0u, 0u, 0u);
      reinterpret_cast<uint4*>(Gk + QT * tile_elems)[e] = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int e = tid; e < AM_TOK * 3; e += 256) stat[QT * AM_TOK * 3 + e] = 0.f;
  }
  // window w's q, g (QT tiles), the chunk's k and v and the statistics, one cp.async group
  auto load = [&](int w) {
    const long long u = (long long)w * a.heads + h;
    const bf16* img = a.img + u * a.unit_elems;
    const int qp = QT * AM_TOK * DP / 8, kp = AM_TOK * DP / 8, sp = QT * AM_TOK * 3 / 4;  // 16-byte pieces
    const float* sts = a.stats + u * QT * AM_TOK * 3;
    for (int e = tid; e < 2 * qp + 2 * kp + sp; e += 256) {
      if (e < qp) hm_cp_async<16>(Qk + 8 * e, img + 8 * e, true);
      else if (e < 2 * qp) hm_cp_async<16>(Gk + 8 * (e - qp), img + QT * tile_elems + 8 * (e - qp), true);
      else if (e < 2 * qp + kp)
        hm_cp_async<16>(Kk + 8 * (e - 2 * qp), img + (2 * QT + c) * tile_elems + 8 * (e - 2 * qp), true);
      else if (e < 2 * qp + 2 * kp)
        hm_cp_async<16>(Vk + 8 * (e - 2 * qp - kp), img + (2 * QT + KT + c) * tile_elems + 8 * (e - 2 * qp - kp),
                        true);
      else hm_cp_async<16>(stat + 4 * (e - 2 * qp - 2 * kp), sts + 4 * (e - 2 * qp - 2 * kp), true);
    }
    hm_cp_commit();
  };
  float db[TPW][8][4] = {};  // d bias of the warpgroup's query tiles x the chunk's keys, f32
  if (g < a.bw) load(g);
#pragma unroll 1
  for (int w = g; w < a.bw; w += a.groups) {
    const long long u = (long long)w * a.heads + h;
    hm_cp_wait_upto(0);
    __syncthreads();  // window w's operands are in; the last window's transposed copies are free
    am_transpose<DP>(Qk, Qt, QTP, 8);
    am_transpose<DP>(Gk, Gt, QTP, 8);
    am_transpose<DP>(Kk, Kt, 1, 8);
    wg_proxy_fence();
    __syncthreads();
#pragma unroll
    for (int t = 0; t < TPW; ++t) {
      const int i = wg + 2 * t;
      float s[8][4], dp[8][4];
      ob_scores<DP>(s, dp, Qk + i * tile_elems, Gk + i * tile_elems, Kk, Vk);
      float m[2], linv[2], D[2];
      bool rin[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float* st = stat + (i * AM_TOK + q0 + 8 * hh) * 3;
        m[hh] = st[0], linv[hh] = st[1], D[hh] = st[2];
        rin[hh] = i * AM_TOK + q0 + 8 * hh < a.nq;
      }
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float4 bb = Bs[(i * 8 + nt) * 128 + wt];
        const float b4[4] = {bb.x, bb.y, bb.z, bb.w};
        const int col = c * AM_TOK + nt * 8 + 2 * tq;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = rin[e >> 1] && col + (e & 1) < a.nk;
          const float p = in ? am_exp2(fmaf(s[nt][e] + b4[e], AM_LOG2E, -m[e >> 1])) * linv[e >> 1] : 0.f;
          const float ds = p * (dp[nt][e] - D[e >> 1]);
          s[nt][e] = p, dp[nt][e] = ds;
          db[t][nt][e] += ds;
        }
        pa[nt >> 1][(nt & 1) * 2] = hm_pack(s[nt][0], s[nt][1]);
        pa[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(s[nt][2], s[nt][3]);
        sa[nt >> 1][(nt & 1) * 2] = hm_pack(dp[nt][0], dp[nt][1]);
        sa[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(dp[nt][2], dp[nt][3]);
      }
      // p^T and dscores^T of tile i as A images (m = key, k = query)
      {
        const int mi = lane >> 3, rho = lane & 7;
        bf16 *pt = PT + i * AM_TOK * AM_TOK, *sd = ST + i * AM_TOK * AM_TOK;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int off = (2 * np + (mi >> 1)) * 512 + (2 * wr + (mi & 1)) * 64 + rho * 8;
          am_stsm_x4_t(pt + off, pa[np][0], pa[np][1], pa[np][2], pa[np][3]);
          am_stsm_x4_t(sd + off, sa[np][0], sa[np][1], sa[np][2], sa[np][3]);
        }
      }
      // the chunk's partial of dq = dscores k, to the scratch in fragment order
      float dq[NDT][4];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wg_rs<DP>(&dq[0][0], sa[ks], wg_desc(Kt + ks * 128, 128, AM_TOK * 16), ks > 0);
      wg_commit();
      wg_wait0();
      wg_hold<NDT * 4>(&dq[0][0]);
      wg_hold<16>(&sa[0][0]);
      if (i < QT) {
        float4* part = (float4*)a.dqp + ((u * KT + c) * QT + i) * NDT * 128;
#pragma unroll
        for (int nt = 0; nt < NDT; ++nt) part[nt * 128 + wt] = make_float4(dq[nt][0], dq[nt][1], dq[nt][2], dq[nt][3]);
      }
    }
    wg_proxy_fence();
    __syncthreads();  // every tile's p^T and dscores^T are in; q, g, k, v and the statistics are free
    if (w + a.groups < a.bw) load(w + a.groups);
    {
      // warpgroup 0: dk = dscores^T q, 1: dv = p^T g, over the window's queries
      const bf16* A = wg == 0 ? ST : PT;
      const bf16* B = wg == 0 ? Qt : Gt;
      float acc[NDT][4];
      wg_fence();
#pragma unroll
      for (int i = 0; i < QTP; ++i)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wg_ss<DP>(&acc[0][0], wg_desc(A + i * AM_TOK * AM_TOK + ks * 128, 128, AM_TOK * 16),
                    wg_desc(B + i * tile_elems + ks * 128, 128, AM_TOK * 16), i > 0 || ks > 0);
      wg_commit();
      wg_wait0();
      wg_hold<NDT * 4>(&acc[0][0]);
      const int which = wg == 0 ? OB_DK : OB_DV;
      bf16* out = (wg == 0 ? a.dk : a.dv) + (long long)w * a.st[which][0] + h * a.st[which][1];
#pragma unroll
      for (int nt = 0; nt < NDT; ++nt) {
        const int j = nt * 8 + 2 * tq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = c * AM_TOK + q0 + 8 * hh;
          if (key >= a.nk || j >= a.d) continue;
          bf16* dst = out + (long long)key * a.st[which][2] + j;
          if (a.pairs) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
          } else {
            dst[0] = __float2bfloat16(acc[nt][2 * hh]);
            if (j + 1 < a.d) dst[1] = __float2bfloat16(acc[nt][2 * hh + 1]);
          }
        }
      }
    }
  }
  // the block's d bias, f32, to the group's partial (g, h)
  float* dbp = a.dbp + ((size_t)g * a.heads + h) * a.nq * a.nk;
#pragma unroll
  for (int t = 0; t < TPW; ++t) {
    const int i = wg + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = i * AM_TOK + q0 + 8 * (e >> 1), col = c * AM_TOK + nt * 8 + 2 * tq + (e & 1);
        if (row < a.nq && col < a.nk) dbp[(size_t)row * a.nk + col] = db[t][nt][e];
      }
  }
}

// -- pass 3: dq ------------------------------------------------------------------------

// A thread a float4 of a (window, head, query tile)'s fragment-ordered dq:
// the key chunks' partials summed in chunk order, rounded, to the dq view.
template <int DP>
__global__ void __launch_bounds__(256) ob_dq_kernel(const ObArgs a) {
  constexpr int NDT = DP / 8, MAX_KT = OB_MAX_NK / AM_TOK;
  const int QT = a.QT, KT = a.KT, per = QT * NDT * 128;
  const long long total = a.units * per;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long u = e / per;
    const int r = (int)(e - u * per);
    const float4* part = (const float4*)a.dqp + u * KT * per + r;
    float4 v[MAX_KT];
#pragma unroll
    for (int cc = 0; cc < MAX_KT; ++cc) v[cc] = cc < KT ? part[(long long)cc * per] : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 sum = v[0];
#pragma unroll
    for (int cc = 1; cc < MAX_KT; ++cc)
      if (cc < KT) sum.x += v[cc].x, sum.y += v[cc].y, sum.z += v[cc].z, sum.w += v[cc].w;
    const int i = r / (NDT * 128), nt = (r / 128) % NDT, t = r % 128;
    const int row = i * AM_TOK + 16 * (t >> 5) + ((t & 31) >> 2), j = nt * 8 + 2 * (t & 3);
    bf16* out = a.dq + (u / a.heads) * a.st[OB_DQ][0] + (u % a.heads) * a.st[OB_DQ][1];
    const float v4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (row + 8 * hh >= a.nq || j >= a.d) continue;
      bf16* dst = out + (long long)(row + 8 * hh) * a.st[OB_DQ][2] + j;
      if (a.pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v4[2 * hh], v4[2 * hh + 1]);
      } else {
        dst[0] = __float2bfloat16(v4[2 * hh]);
        if (j + 1 < a.d) dst[1] = __float2bfloat16(v4[2 * hh + 1]);
      }
    }
  }
}

// -- above 256 queries or 576 keys: three streaming passes -------------------------------
//
// ob_main_kernel keeps every query tile of a window in shared memory and a
// block's d bias slice (all query rows x 64 keys) in registers, so it stops
// at 256 queries; ob_stats_kernel and the d bias partials' owners stop at
// 576 keys. Above, the attention core runs as B9 runs it above window 16
// (attn_bwd_mma.cu al_*_kernel), generalised to nq x nk and to the images
// of pass 0, a warpgroup a block streaming 64-token chunks through two
// cp.async buffers, every score and dprob recomputed:
// 1. ol_rows_kernel, (window, head, query tile r): sweep 1 over the key
//    chunks keeps the row max m, sum l and u = sum p dp online (m, 1 / l and
//    D = u / l to the statistics, ob_stats_kernel's layout); sweep 2 forms p
//    and dscores and runs dq = dscores k (k made token-contiguous by
//    am_transpose), summed over the chunks in order in registers, and writes
//    dq once.
// 2. ol_cols_kernel, (window, head, key chunk c): s^T = k q^T and dp^T = v
//    g^T for each query tile in order, p^T and dscores^T from the statistics,
//    dv = p^T g and dk = dscores^T q in registers, written once.
// 3. ol_dbias_kernel, (window group, head, query tile, key chunk): the tile's
//    dscores over the group's windows in order, summed in registers and
//    written once to the group's partial; reduce_parts sums the groups in
//    order. The partials are groups x heads x nq x nk f32, the groups few
//    (ol_groups: about two blocks an SM).
// About 34 KB of shared memory a block at DP 32, at any nq and nk. The
// scores and dprobs are computed three times and the statistics twice; the
// rounding points are those of the passes above (p and dscores rounded to
// bf16 before their products, the softmax and d bias in f32).

// A query tile's statistics (64 rows x (m, 1 / l, D)) into shared memory.
__device__ __forceinline__ void ol_load_stats(float* dst, const float* src) {
  for (int i = threadIdx.x; i < 3 * AM_TOK / 4; i += 128) hm_cp_async<16>(dst + 4 * i, src + 4 * i, true);
}

// Store rows row, row + 8 (columns j, j + 1) of a dq / dk / dv tile held as
// wgmma accumulators to a strided view: rows below n, columns below d.
template <int NDT>
__device__ __forceinline__ void ol_store(const ObArgs& a, bf16* out, long long ts, int row, int n,
                                         const float (&acc)[NDT][4]) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NDT; ++nt) {
    const int j = nt * 8 + 2 * tq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (row + 8 * hh >= n || j >= a.d) continue;
      bf16* dst = out + (long long)(row + 8 * hh) * ts + j;
      if (a.pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
      } else {
        dst[0] = __float2bfloat16(acc[nt][2 * hh]);
        if (j + 1 < a.d) dst[1] = __float2bfloat16(acc[nt][2 * hh + 1]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(128, 2) ol_rows_kernel(const ObArgs a) {
  constexpr int CH = AM_TOK * DP, NDT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qk = (bf16*)smem;
  bf16* Gk = Qk + CH;
  bf16* Kb = Gk + CH;      // two buffers
  bf16* Vb = Kb + 2 * CH;  // two buffers
  bf16* Kt = Vb + 2 * CH;
  const int QT = a.QT, KT = a.KT;
  const int tid = threadIdx.x, wr = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const long long u = blockIdx.x / QT;
  const int r = blockIdx.x % QT, h = (int)(u % a.heads);
  const bf16* img = a.img + u * a.unit_elems;
  const bf16 *kimg = img + 2LL * QT * CH, *vimg = kimg + (long long)KT * CH;
  const int row = r * AM_TOK + 16 * wr + gq;  // this thread's query rows row, row + 8
  auto load_kv = [&](int c) {
    const int b = c & 1;
    am_load_chunks<DP, 2>({kimg + (long long)c * CH, vimg + (long long)c * CH}, {Kb + b * CH, Vb + b * CH});
    hm_cp_commit();
  };
  am_load_chunks<DP, 2>({img + (long long)r * CH, img + (long long)(QT + r) * CH}, {Qk, Gk});
  float s[8][4], dp[8][4];
  // chunk c's scores (+ bias, -inf past nk) and dprobs into s, dp
  auto sd = [&](int c) {
    float4 bb[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) bb[nt] = ob_bias4(a, h, row, c * AM_TOK + nt * 8 + 2 * tq);
    ob_scores<DP>(s, dp, Qk, Gk, Kb + (c & 1) * CH, Vb + (c & 1) * CH);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = c * AM_TOK + nt * 8 + 2 * tq;
      s[nt][0] = col < a.nk ? s[nt][0] + bb[nt].x : -INFINITY;
      s[nt][1] = col + 1 < a.nk ? s[nt][1] + bb[nt].y : -INFINITY;
      s[nt][2] = col < a.nk ? s[nt][2] + bb[nt].z : -INFINITY;
      s[nt][3] = col + 1 < a.nk ? s[nt][3] + bb[nt].w : -INFINITY;
    }
  };
  // chunk c of a sweep ready in buffer c & 1, chunk c + 1 in flight
  auto next = [&](int c) {
    if (c + 1 < KT) {
      load_kv(c + 1);
      hm_cp_wait_upto(1);
    } else {
      hm_cp_wait_upto(0);
    }
    wg_proxy_fence();
    __syncthreads();
  };

  // sweep 1: m (log2 units), l and u
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, us[2] = {0.f, 0.f};
  load_kv(0);
#pragma unroll 1
  for (int c = 0; c < KT; ++c) {
    next(c);
    sd(c);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      const float mn = fmaxf(m[hh], am_quad_max(mx) * AM_LOG2E), sc = am_exp2(m[hh] - mn);
      l[hh] *= sc, us[hh] *= sc, m[hh] = mn;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = am_exp2(fmaf(s[nt][2 * hh + e], AM_LOG2E, -mn));
          l[hh] += p, us[hh] += p * dp[nt][2 * hh + e];
        }
    }
    __syncthreads();  // buffer c & 1 is free for chunk c + 2
  }
  float linv[2], D[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = am_quad_sum(l[hh]), us[hh] = am_quad_sum(us[hh]);
    linv[hh] = 1.f / l[hh], D[hh] = us[hh] / l[hh];
    if (tq == 0) {
      float* st = a.stats + (u * QT * AM_TOK + row + 8 * hh) * 3;
      st[0] = m[hh], st[1] = linv[hh], st[2] = D[hh];
    }
  }

  // sweep 2: p, dscores; dq = dscores k
  float dq[NDT][4];
  load_kv(0);
#pragma unroll 1
  for (int c = 0; c < KT; ++c) {
    next(c);
    am_transpose<DP>(Kb + (c & 1) * CH, Kt, 1, 4);
    sd(c);
    uint32_t sa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = am_exp2(fmaf(s[nt][e], AM_LOG2E, -m[e >> 1])) * linv[e >> 1];
        dp[nt][e] = p * (dp[nt][e] - D[e >> 1]);
      }
      sa[nt >> 1][(nt & 1) * 2] = hm_pack(dp[nt][0], dp[nt][1]);
      sa[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(dp[nt][2], dp[nt][3]);
    }
    wg_proxy_fence();
    __syncthreads();  // the transposed k is in
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wg_rs<DP>(&dq[0][0], sa[ks], wg_desc(Kt + ks * 128, 128, AM_TOK * 16), c > 0 || ks > 0);
    wg_commit();
    wg_wait0();
    wg_hold<NDT * 4>(&dq[0][0]);
    wg_hold<16>(&sa[0][0]);
    __syncthreads();  // every warp is done with the buffers and the transposed copy
  }
  ol_store<NDT>(a, a.dq + (u / a.heads) * a.st[OB_DQ][0] + h * a.st[OB_DQ][1], a.st[OB_DQ][2], row, a.nq, dq);
}

template <int DP>
__global__ void __launch_bounds__(128, 2) ol_cols_kernel(const ObArgs a) {
  constexpr int CH = AM_TOK * DP, NDT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Kk = (bf16*)smem;
  bf16* Vk = Kk + CH;
  bf16* Qb = Vk + CH;      // two buffers
  bf16* Gb = Qb + 2 * CH;  // two buffers
  bf16* Qt = Gb + 2 * CH;
  bf16* Gt = Qt + CH;
  float* stb = (float*)(Gt + CH);  // two buffers of a query tile's (m, 1 / l, D)
  const int QT = a.QT, KT = a.KT;
  const int tid = threadIdx.x, wr = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const long long u = blockIdx.x / KT;
  const int c = blockIdx.x % KT, h = (int)(u % a.heads);
  const bf16* img = a.img + u * a.unit_elems;
  const float* ust = a.stats + u * QT * AM_TOK * 3;
  const float* bias = a.bias + (size_t)h * a.nq * a.nk;
  const int key = c * AM_TOK + 16 * wr + gq;  // this thread's key rows key, key + 8
  auto load_q = [&](int r) {
    const int b = r & 1;
    am_load_chunks<DP, 2>({img + (long long)r * CH, img + (long long)(QT + r) * CH}, {Qb + b * CH, Gb + b * CH});
    ol_load_stats(stb + b * 3 * AM_TOK, ust + (long long)r * AM_TOK * 3);
    hm_cp_commit();
  };
  am_load_chunks<DP, 2>({img + (long long)(2 * QT + c) * CH, img + (long long)(2 * QT + KT + c) * CH}, {Kk, Vk});
  load_q(0);
  float dk[NDT][4], dv[NDT][4];
#pragma unroll 1
  for (int r = 0; r < QT; ++r) {
    const int b = r & 1;
    float bv[8][4];  // the bias of this thread's (key, query) pairs, loaded before the products
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = r * AM_TOK + nt * 8 + 2 * tq + (e & 1), k = key + 8 * (e >> 1);
        bv[nt][e] = q < a.nq && k < a.nk ? __ldg(bias + (size_t)q * a.nk + k) : 0.f;
      }
    if (r + 1 < QT) {
      load_q(r + 1);
      hm_cp_wait_upto(1);
    } else {
      hm_cp_wait_upto(0);
    }
    wg_proxy_fence();
    __syncthreads();  // query tile r (and k, v) in
    am_transpose<DP>(Qb + b * CH, Qt, 1, 4);
    am_transpose<DP>(Gb + b * CH, Gt, 1, 4);
    float s[8][4], dp[8][4];  // rows: keys key, key + 8; columns: the tile's queries
    ob_scores<DP>(s, dp, Kk, Vk, Qb + b * CH, Gb + b * CH);
    const float* st = stb + b * 3 * AM_TOK;
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qq = nt * 8 + 2 * tq + (e & 1);
        const bool in = r * AM_TOK + qq < a.nq && key + 8 * (e >> 1) < a.nk;
        const float p = in ? am_exp2(fmaf(s[nt][e] + bv[nt][e], AM_LOG2E, -st[3 * qq])) * st[3 * qq + 1] : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - st[3 * qq + 2]);
      }
      pa[nt >> 1][(nt & 1) * 2] = hm_pack(s[nt][0], s[nt][1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(s[nt][2], s[nt][3]);
      sa[nt >> 1][(nt & 1) * 2] = hm_pack(dp[nt][0], dp[nt][1]);
      sa[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(dp[nt][2], dp[nt][3]);
    }
    wg_proxy_fence();
    __syncthreads();  // the transposed q and g are in
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wg_rs<DP>(&dv[0][0], pa[ks], wg_desc(Gt + ks * 128, 128, AM_TOK * 16), r > 0 || ks > 0);
      wg_rs<DP>(&dk[0][0], sa[ks], wg_desc(Qt + ks * 128, 128, AM_TOK * 16), r > 0 || ks > 0);
    }
    wg_commit();
    wg_wait0();
    wg_hold<NDT * 4>(&dv[0][0]);
    wg_hold<NDT * 4>(&dk[0][0]);
    wg_hold<16>(&pa[0][0]);
    wg_hold<16>(&sa[0][0]);
    __syncthreads();  // every warp is done with buffer b and the transposed copies
  }
  const long long w = u / a.heads;
  ol_store<NDT>(a, a.dk + w * a.st[OB_DK][0] + h * a.st[OB_DK][1], a.st[OB_DK][2], key, a.nk, dk);
  ol_store<NDT>(a, a.dv + w * a.st[OB_DV][0] + h * a.st[OB_DV][1], a.st[OB_DV][2], key, a.nk, dv);
}

template <int DP>
__global__ void __launch_bounds__(128, 2) ol_dbias_kernel(const ObArgs a) {
  constexpr int CH = AM_TOK * DP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf = (bf16*)smem;                  // two buffers of q, g (tile r), k, v (chunk c)
  float* stb = (float*)(buf + 2 * 4 * CH);  // two buffers of the query tile's (m, 1 / l, D)
  const int QT = a.QT, KT = a.KT;
  const int tid = threadIdx.x, wr = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  int i = blockIdx.x;
  const int c = i % KT;
  i /= KT;
  const int r = i % QT;
  i /= QT;
  const int h = i % a.heads, g = i / a.heads;
  const int q0 = 16 * wr + gq, row = r * AM_TOK + q0;
  auto load = [&](int w, int b) {
    const long long u = (long long)w * a.heads + h;
    const bf16* img = a.img + u * a.unit_elems;
    bf16* d = buf + b * 4 * CH;
    am_load_chunks<DP, 4>({img + (long long)r * CH, img + (long long)(QT + r) * CH,
                           img + (long long)(2 * QT + c) * CH, img + (long long)(2 * QT + KT + c) * CH},
                          {d, d + CH, d + 2 * CH, d + 3 * CH});
    ol_load_stats(stb + b * 3 * AM_TOK, a.stats + (u * QT * AM_TOK + r * AM_TOK) * 3);
    hm_cp_commit();
  };
  float4 bb[8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) bb[nt] = ob_bias4(a, h, row, c * AM_TOK + nt * 8 + 2 * tq);
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  if (g < a.bw) load(g, 0);
  int b = 0;
#pragma unroll 1
  for (int w = g; w < a.bw; w += a.groups, b ^= 1) {
    if (w + a.groups < a.bw) {
      load(w + a.groups, b ^ 1);
      hm_cp_wait_upto(1);
    } else {
      hm_cp_wait_upto(0);
    }
    wg_proxy_fence();
    __syncthreads();
    const bf16* d = buf + b * 4 * CH;
    const float* st = stb + b * 3 * AM_TOK;
    float s[8][4], dp[8][4];
    ob_scores<DP>(s, dp, d, d + CH, d + 2 * CH, d + 3 * CH);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float b4[4] = {bb[nt].x, bb[nt].y, bb[nt].z, bb[nt].w};
      const int col = c * AM_TOK + nt * 8 + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q0 + 8 * (e >> 1);
        const bool in = row + 8 * (e >> 1) < a.nq && col + (e & 1) < a.nk;
        const float p = in ? am_exp2(fmaf(s[nt][e] + b4[e], AM_LOG2E, -st[3 * q])) * st[3 * q + 1] : 0.f;
        acc[nt][e] += p * (dp[nt][e] - st[3 * q + 2]);
      }
    }
    __syncthreads();  // every warp is done with buffer b before the window after next fills it
  }
  float* part = a.dbp + ((size_t)g * a.heads + h) * a.nq * a.nk;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = row + 8 * (e >> 1), col = c * AM_TOK + nt * 8 + 2 * tq + (e & 1);
      if (rr < a.nq && col < a.nk) part[(size_t)rr * a.nk + col] = acc[nt][e];
    }
}

// Shared memory of the three streaming passes: seven or eight 64 x DP
// chunks, and in 2 and 3 two buffers of a query tile's statistics.
__host__ __device__ inline size_t ol_rows_smem(int DP) { return (size_t)7 * AM_TOK * DP * 2; }
__host__ __device__ inline size_t ol_cols_smem(int DP) { return (size_t)8 * AM_TOK * DP * 2 + 2 * 3 * AM_TOK * 4; }

// -- host ------------------------------------------------------------------------------

// The geometries of B13's entries: the first takes at most OB_MAX_NQ queries
// and OB_MAX_NK keys, the large one (`large`) every count.
static bool ob_shape_ok(int bw, int heads, int nq, int nk, int d, bool large) {
  return bw > 0 && heads > 0 && nq > 0 && nk > 0 && d > 0 && d <= 32 && (large || (nq <= OB_MAX_NQ && nk <= OB_MAX_NK));
}

// Scratch in bf16: the images (units x (2 QT + 2 KT) tiles of 64 x DP). In
// f32: the row statistics (3 a padded query row), dq's chunk partials (units
// x KT x QT x 64 x DP; none in the large entry, whose row pass owns dq), the
// groups' d bias partials (groups x heads x nq x nk).
struct ObScratch {
  long long units, unit_elems, t_elems, stats, dqp, dbp, f_elems;
  int QT, KT, DP, groups;
};

// The window groups: the count that makes the main pass's waves (one block
// an SM) take the fewest window steps.
static int ob_groups(int bw, int heads, int KT, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int G = 1; G <= bw && G <= 64; ++G) {
    const long long blocks = (long long)G * heads * KT, waves = (blocks + sms - 1) / sms;
    const long long cost = waves * ((bw + G - 1) / G);
    if (best_cost < 0 || cost < best_cost) best = G, best_cost = cost;
  }
  return best;
}

// The large entry's window groups (ol_dbias_kernel): about two blocks an
// SM, at most one a window.
static int ol_groups(int bw, int heads, int QT, int KT, int sms) {
  const long long tiles = (long long)heads * QT * KT, g = (2LL * sms + tiles - 1) / tiles;
  return (int)(g > bw ? bw : (g < 1 ? 1 : g));
}

static ObScratch ob_scratch(int bw, int heads, int nq, int nk, int d, int sms, bool large) {
  ObScratch S;
  S.QT = (nq + AM_TOK - 1) / AM_TOK;
  S.KT = (nk + AM_TOK - 1) / AM_TOK;
  S.DP = d <= 16 ? 16 : 32;
  S.groups = large ? ol_groups(bw, heads, S.QT, S.KT, sms) : ob_groups(bw, heads, S.KT, sms);
  S.units = (long long)bw * heads;
  S.unit_elems = (long long)(2 * S.QT + 2 * S.KT) * AM_TOK * S.DP;
  S.t_elems = S.units * S.unit_elems;
  S.stats = 0;
  S.dqp = S.stats + S.units * S.QT * AM_TOK * 3;
  S.dbp = S.dqp + (large ? 0 : S.units * S.KT * S.QT * AM_TOK * S.DP);
  S.f_elems = S.dbp + (long long)S.groups * heads * nq * nk;
  return S;
}

static int ob_sizes(int bw, int heads, int nq, int nk, int d, bool large, long long* t_elems, long long* f_elems) {
  if (!ob_shape_ok(bw, heads, nq, nk, d, large)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const ObScratch S = ob_scratch(bw, heads, nq, nk, d, sms, large);
  *t_elems = S.t_elems;
  *f_elems = S.f_elems;
  return 0;
}

extern "C" int oca_core_bwd_mma_scratch(int bw, int heads, int nq, int nk, int d, long long* t_elems,
                                        long long* f_elems) {
  return ob_sizes(bw, heads, nq, nk, d, false, t_elems, f_elems);
}

extern "C" int oca_core_bwd_large_mma_scratch(int bw, int heads, int nq, int nk, int d, long long* t_elems,
                                              long long* f_elems) {
  return ob_sizes(bw, heads, nq, nk, d, true, t_elems, f_elems);
}

template <int DP>
static cudaError_t ob_pack(const ObArgs& a, const ObScratch& S, cudaStream_t st) {
  const long long pieces = S.units * (2 * S.QT + 2 * S.KT) * AM_TOK * (DP / 8);
  ob_pack_kernel<DP><<<(int)((pieces + 255) / 256 < 8192 ? (pieces + 255) / 256 : 8192), 256, 0, st>>>(a);
  return cudaGetLastError();
}

template <int DP, int QTP>
static cudaError_t ob_launch(const ObArgs& a, const ObScratch& S, float* dbias, cudaStream_t st) {
  cudaError_t err = ob_pack<DP>(a, S, st);
  if (err != cudaSuccess) return err;
  const int npair = (S.QT + 1) / 2;
  const size_t sbytes = (size_t)(2 * S.KT + 4) * AM_TOK * DP * 2;
  err = allow_smem(ob_stats_kernel<DP>, sbytes);
  if (err != cudaSuccess) return err;
  ob_stats_kernel<DP><<<(int)(S.units * npair), 256, sbytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t mbytes = ob_main_smem(QTP, DP).total;
  err = allow_smem(ob_main_kernel<DP, QTP>, mbytes);
  if (err != cudaSuccess) return err;
  ob_main_kernel<DP, QTP><<<S.groups * a.heads * S.KT, 256, mbytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long quads = S.units * S.QT * (DP / 8) * 128;
  ob_dq_kernel<DP><<<(int)((quads + 255) / 256 < 8192 ? (quads + 255) / 256 : 8192), 256, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(a.dbp, S.groups, (long long)a.heads * a.nq * a.nk, dbias, st);
}

template <int DP>
static cudaError_t ol_launch(const ObArgs& a, const ObScratch& S, float* dbias, cudaStream_t st) {
  cudaError_t err = ob_pack<DP>(a, S, st);
  if (err != cudaSuccess) return err;
  size_t bytes = ol_rows_smem(DP);
  if ((err = allow_smem(ol_rows_kernel<DP>, bytes)) != cudaSuccess) return err;
  ol_rows_kernel<DP><<<(int)(S.units * S.QT), 128, bytes, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bytes = ol_cols_smem(DP);
  if ((err = allow_smem(ol_cols_kernel<DP>, bytes)) != cudaSuccess) return err;
  ol_cols_kernel<DP><<<(int)(S.units * S.KT), 128, bytes, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(ol_dbias_kernel<DP>, bytes)) != cudaSuccess) return err;
  ol_dbias_kernel<DP><<<S.groups * a.heads * S.QT * S.KT, 128, bytes, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_parts(a.dbp, S.groups, (long long)a.heads * a.nq * a.nk, dbias, st);
}

// strides: (window, head, token) of q, k, v, g, out (unused), dq, dk, dv,
// in elements; d contiguous in each. dbias (heads, nq, nk) comes back in f32.
static int ob_run(const void* q, const void* k, const void* v, const void* relbias, const void* g, void* dq, void* dk,
                  void* dv, void* dbias, const long long* strides, int bw, int heads, int nq, int nk, int d,
                  void* tscratch, long long t_elems, void* fscratch, long long f_elems, void* stream, bool large) {
  if (!ob_shape_ok(bw, heads, nq, nk, d, large)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const ObScratch S = ob_scratch(bw, heads, nq, nk, d, sms, large);
  if (S.t_elems != t_elems || S.f_elems != f_elems) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)tscratch % 16 || (uintptr_t)fscratch % 16) return (int)cudaErrorMisalignedAddress;
  ObArgs a{};
  a.q = (const bf16*)q, a.k = (const bf16*)k, a.v = (const bf16*)v, a.g = (const bf16*)g;
  a.dq = (bf16*)dq, a.dk = (bf16*)dk, a.dv = (bf16*)dv;
  for (int i = 0; i < OB_N; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  a.bias = (const float*)relbias;
  a.img = (bf16*)tscratch;
  float* f = (float*)fscratch;
  a.stats = f + S.stats, a.dqp = f + S.dqp, a.dbp = f + S.dbp;
  a.units = S.units, a.unit_elems = S.unit_elems;
  a.bw = bw, a.heads = heads, a.nq = nq, a.nk = nk, a.d = d, a.QT = S.QT, a.KT = S.KT, a.groups = S.groups;
  a.pairs = d % 2 == 0;
  const void* outs[3] = {dq, dk, dv};
  for (int i = 0; i < 3; ++i) {
    a.pairs = a.pairs && (uintptr_t)outs[i] % 4 == 0;
    for (int j = 0; j < 3; ++j) a.pairs = a.pairs && strides[3 * (OB_DQ + i) + j] % 2 == 0;
  }
  cudaStream_t st = (cudaStream_t)stream;
  float* db = (float*)dbias;
  if (large) return (int)(S.DP == 32 ? ol_launch<32>(a, S, db, st) : ol_launch<16>(a, S, db, st));
  const bool four = S.QT > 2;  // QT rounded up to even: 2 or 4 query tiles
  if (S.DP == 32) return (int)(four ? ob_launch<32, 4>(a, S, db, st) : ob_launch<32, 2>(a, S, db, st));
  return (int)(four ? ob_launch<16, 4>(a, S, db, st) : ob_launch<16, 2>(a, S, db, st));
}

#define OB_ENTRY(NAME, LARGE)                                                                                     \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* relbias, const void* g, void* dq, \
                      void* dk, void* dv, void* dbias, const long long* strides, int bw, int heads, int nq,      \
                      int nk, int d, void* tscratch, long long t_elems, void* fscratch, long long f_elems,       \
                      void* stream) {                                                                             \
    return ob_run(q, k, v, relbias, g, dq, dk, dv, dbias, strides, bw, heads, nq, nk, d, tscratch, t_elems,      \
                  fscratch, f_elems, stream, LARGE);                                                              \
  }

OB_ENTRY(oca_core_bwd_mma_bf16, false)
OB_ENTRY(oca_core_bwd_large_mma_bf16, true)
