// B13 in bf16, written for the H100: the backward of the core of HAT's
// overlapping cross-attention,
//   out = softmax(q k^T + bias) v,
// on q (bw, heads, nq, d), already scaled by 1/sqrt(d), k and v (bw, heads,
// nk, d), the f32 bias (heads, nq, nk) and the cotangent g of out: dq, dk,
// dv in bf16 and d bias summed over the bw windows in f32.
//
// Replaces studiosr_tpu/ops/pallas/oca_core.py::oca_core_bwd (:157, kernel
// _bwd_kernel at :73) in bf16; f32 runs oca_bwd_f32.cu (head dims above 32
// and more than 256 queries or 576 keys keep oca_core.cu on attn_core.cuh,
// as bf16 head dims above 32 do). Two entries: up to 256
// queries and 576 keys (HAT's windows up to 16) oca_core_bwd_mma_bf16 runs
// the five passes below; above (HAT's windows from 17) oca_core_bwd_large_mma_bf16
// runs pass 0 and lb_core.cuh's two-formation core, each score tile formed
// twice (below, before the host code; what bounds it and what its design
// does about each: lb_core.cuh's note). The contract is its: p and dscores = p (dp - D) rounded to bf16
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
#include "lb_core.cuh"

constexpr int OB_MAX_NQ = 256, OB_MAX_NK = 576;

// Strides, in elements, of the eight tensors, (window, head, token) each:
// q, k, v, g, out (unused), dq, dk, dv (the order of oca_core.cu's OC_*).
enum { OB_Q, OB_K, OB_V, OB_G, OB_O, OB_DQ, OB_DK, OB_DV, OB_N };

struct ObArgs {
  const bf16 *q, *k, *v, *g;
  bf16 *dq, *dk, *dv;
  long long st[OB_N][3];
  const float* bias;  // (heads, nq, nk); bf16 when bias16 (the large entry only)
  bf16* img;          // per unit: q, g (QT tiles), k, v (KT chunks), each 64 x DP K-major
  float *stats, *dqp, *dbp;
  const void* bfrag;  // the large entry: the bias in fragment order (ob_bias_frag_kernel)
  long long units, unit_elems;
  int bw, heads, nq, nk, d, QT, KT, groups, pairs, bias16;  // pairs: dq, dk, dv take 4-byte stores
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

// -- the scores (lb_scores, lb_core.cuh) and the bias -------------------------------------

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
    lb_scores<DP>(s, dp, Q, G, K + c * tile, V + c * tile);
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
      lb_scores<DP>(s, dp, Qk + i * tile_elems, Gk + i * tile_elems, Kk, Vk);
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

// -- above 256 queries or 576 keys: the two-formation core (lb_core.cuh) -----------------
//
// ob_main_kernel keeps every query tile of a window in shared memory and a
// block's d bias slice (all query rows x 64 keys) in registers, so it stops
// at 256 queries; ob_stats_kernel and the dq partials' sum stop at 576 keys.
// Above, the attention core runs lb_core.cuh's passes on the images of pass
// 0 (B9's large family runs the same): the statistics per (window, head,
// pair of query tiles), then p, dscores, d bias, dq's partials, dk and dv per
// (group of windows, head, key chunk), then the sums. LbB13 is B13's view for
// them: the images, the f32 bias (zero outside (nq, nk)), keys past nk
// tagged and scored -inf, and the stores of dq, dk and dv to their strided
// views (rows below nq / nk, columns below d).
// The bias in fragment order (am_bias_kernel's layout, by query tile and key
// chunk): 4-value group ((h QT + r) KT + c) 1024 + 128 nt + wt is the score
// fragment of thread wt of tile (r, c), 8-column tile nt, zero outside (nq,
// nk); bf16 stays bf16, f32 f32. One pass, so that every later read of a
// tile's bias is a coalesced 8- or 16-byte load a thread. The bf16 fragments
// halve the bias bytes both formations read: with the same values in f32
// fragments the HAT window-24 step's backward takes 0.27 ms more of its 6.6
// (H100 80GB HBM3 at 700 W, scripts/torch_time_attn_kernels.py --large).
__global__ void ob_bias_frag_kernel(const ObArgs a, void* __restrict__ out) {
  const long long groups = (long long)a.heads * a.QT * a.KT * 1024;
  for (long long gi = blockIdx.x * (long long)blockDim.x + threadIdx.x; gi < groups;
       gi += (long long)gridDim.x * blockDim.x) {
    const int wt = (int)(gi % 128), nt = (int)(gi / 128 % 8), c = (int)(gi / 1024 % a.KT);
    const int r = (int)(gi / (1024LL * a.KT) % a.QT), h = (int)(gi / (1024LL * a.KT * a.QT));
    const int row = r * AM_TOK + 16 * (wt >> 5) + ((wt & 31) >> 2), col = c * AM_TOK + nt * 8 + 2 * (wt & 3);
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int rr = row + 8 * (k >> 1), cc = col + (k & 1);
      const size_t i = ((size_t)h * a.nq + rr) * a.nk + cc;
      const float b = rr < a.nq && cc < a.nk
                          ? (a.bias16 ? __bfloat162float(reinterpret_cast<const bf16*>(a.bias)[i]) : a.bias[i])
                          : 0.f;
      v[k] = b;
    }
    if (a.bias16) {
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(v[0], v[1]), p1 = __floats2bfloat162_rn(v[2], v[3]);
      reinterpret_cast<uint2*>(out)[gi] =
          make_uint2(*reinterpret_cast<const uint32_t*>(&p0), *reinterpret_cast<const uint32_t*>(&p1));
    } else {
      reinterpret_cast<float4*>(out)[gi] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

struct LbB13 {
  ObArgs a;
  int DP;
  __device__ const bf16* tile(long long u, int t) const {
    return a.img + u * a.unit_elems + (long long)t * AM_TOK * DP;
  }
  __device__ const bf16* q(long long u, int r) const { return tile(u, r); }
  __device__ const bf16* g(long long u, int r) const { return tile(u, a.QT + r); }
  __device__ const bf16* k(long long u, int c) const { return tile(u, 2 * a.QT + c); }
  __device__ const bf16* v(long long u, int c) const { return tile(u, 2 * a.QT + a.KT + c); }
  __device__ float4 bias4(int h, int r, int c, int nt, int wt) const {
    const size_t e = (((size_t)(h * a.QT + r) * a.KT + c) * 8 + nt) * 128 + wt;
    if (!a.bias16) return reinterpret_cast<const float4*>(a.bfrag)[e];
    const uint2 u = reinterpret_cast<const uint2*>(a.bfrag)[e];
    const float2 p0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 p1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(p0.x, p0.y, p1.x, p1.y);
  }
  __device__ bool masked(int c) const { return (c + 1) * AM_TOK > a.nk; }
  __device__ int row_tag(long long, int) const { return 0; }
  __device__ int col_tag(long long, int n) const { return n < a.nk ? 0 : 1; }
  __device__ float score(float s, float b, int, int ktag) const { return ktag ? -INFINITY : s + b; }
  __device__ void store4(int kind, long long u, int tile, int nt, int wt, float4 v) const {
    const int which = kind == LB_DQ ? OB_DQ : kind == LB_DK ? OB_DK : OB_DV;
    const int n = kind == LB_DQ ? a.nq : a.nk;
    bf16* out = (kind == LB_DQ ? a.dq : kind == LB_DK ? a.dk : a.dv) + (u / a.heads) * a.st[which][0] +
                (u % a.heads) * a.st[which][1];
    const int row = tile * AM_TOK + 16 * (wt >> 5) + ((wt & 31) >> 2), j = nt * 8 + 2 * (wt & 3);
    const float v4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (row + 8 * hh >= n || j >= a.d) continue;
      bf16* dst = out + (long long)(row + 8 * hh) * a.st[which][2] + j;
      if (a.pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v4[2 * hh], v4[2 * hh + 1]);
      } else {
        dst[0] = __float2bfloat16(v4[2 * hh]);
        if (j + 1 < a.d) dst[1] = __float2bfloat16(v4[2 * hh + 1]);
      }
    }
  }
};

// -- host ------------------------------------------------------------------------------

// The geometries of B13's entries: the first takes at most OB_MAX_NQ queries
// and OB_MAX_NK keys, the large one (`large`) every count.
static bool ob_shape_ok(int bw, int heads, int nq, int nk, int d, bool large) {
  return bw > 0 && heads > 0 && nq > 0 && nk > 0 && d > 0 && d <= 32 && (large || (nq <= OB_MAX_NQ && nk <= OB_MAX_NK));
}

// Scratch in bf16: the images (units x (2 QT + 2 KT) tiles of 64 x DP). In
// f32: the row statistics (3 a padded query row), dq's chunk partials (units
// x KT x QT x 64 x DP), the groups' d bias partials (groups x heads x nq x
// nk); the large entry's is lb_core.cuh's (lb_f_elems of its plan).
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

static ObScratch ob_scratch(int bw, int heads, int nq, int nk, int d, int sms, bool large) {
  ObScratch S;
  S.QT = (nq + AM_TOK - 1) / AM_TOK;
  S.KT = (nk + AM_TOK - 1) / AM_TOK;
  S.DP = d <= 16 ? 16 : 32;
  S.groups = large ? 1 : ob_groups(bw, heads, S.KT, sms);
  S.units = (long long)bw * heads;
  S.unit_elems = (long long)(2 * S.QT + 2 * S.KT) * AM_TOK * S.DP;
  S.t_elems = S.units * S.unit_elems;
  S.stats = 0;
  S.dqp = S.stats + S.units * S.QT * AM_TOK * 3;
  S.dbp = S.dqp + S.units * S.KT * S.QT * AM_TOK * S.DP;
  // the large entry: lb_core.cuh's scratch, then the bias in fragment order
  S.f_elems = large ? lb_f_elems(lb_plan(bw, heads, S.QT, S.KT, S.DP, sms)) + (long long)heads * S.QT * S.KT * 4096
                    : S.dbp + (long long)S.groups * heads * nq * nk;
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
static cudaError_t lb_launch_b13(ObArgs a, const ObScratch& S, int sms, float* f, float* dbias, cudaStream_t st) {
  cudaError_t err = ob_pack<DP>(a, S, st);
  if (err != cudaSuccess) return err;
  LbPlan L = lb_plan(a.bw, a.heads, S.QT, S.KT, DP, sms);
  lb_place(L, f);
  float* frag = f + lb_f_elems(L);
  a.bfrag = frag;
  ob_bias_frag_kernel<<<lb_blocks((long long)a.heads * S.QT * S.KT * 1024), 256, 0, st>>>(a, frag);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return lb_launch<DP, LbB13, false>(LbB13{a, DP}, L, a.nq, a.nk, dbias, st);
}

// strides: (window, head, token) of q, k, v, g, out (unused), dq, dk, dv,
// in elements; d contiguous in each. The bias is f32, or (the large entry,
// bias16) bf16, read as it is; dbias (heads, nq, nk) comes back in f32.
static int ob_run(const void* q, const void* k, const void* v, const void* relbias, const void* g, void* dq, void* dk,
                  void* dv, void* dbias, const long long* strides, int bias16, int bw, int heads, int nq, int nk,
                  int d, void* tscratch, long long t_elems, void* fscratch, long long f_elems, void* stream,
                  bool large) {
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
  a.bias = (const float*)relbias, a.bias16 = large && bias16;
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
  if (large)
    return (int)(S.DP == 32 ? lb_launch_b13<32>(a, S, sms, f, db, st) : lb_launch_b13<16>(a, S, sms, f, db, st));
  const bool four = S.QT > 2;  // QT rounded up to even: 2 or 4 query tiles
  if (S.DP == 32) return (int)(four ? ob_launch<32, 4>(a, S, db, st) : ob_launch<32, 2>(a, S, db, st));
  return (int)(four ? ob_launch<16, 4>(a, S, db, st) : ob_launch<16, 2>(a, S, db, st));
}

extern "C" int oca_core_bwd_mma_bf16(const void* q, const void* k, const void* v, const void* relbias, const void* g,
                                     void* dq, void* dk, void* dv, void* dbias, const long long* strides, int bw,
                                     int heads, int nq, int nk, int d, void* tscratch, long long t_elems,
                                     void* fscratch, long long f_elems, void* stream) {
  return ob_run(q, k, v, relbias, g, dq, dk, dv, dbias, strides, 0, bw, heads, nq, nk, d, tscratch, t_elems, fscratch,
                f_elems, stream, false);
}

// The large entry also takes the bias in bf16 (bias16), as the bf16 step hands it over.
extern "C" int oca_core_bwd_large_mma_bf16(const void* q, const void* k, const void* v, const void* relbias,
                                           const void* g, void* dq, void* dk, void* dv, void* dbias,
                                           const long long* strides, int bias16, int bw, int heads, int nq, int nk,
                                           int d, void* tscratch, long long t_elems, void* fscratch,
                                           long long f_elems, void* stream) {
  return ob_run(q, k, v, relbias, g, dq, dk, dv, dbias, strides, bias16, bw, heads, nq, nk, d, tscratch, t_elems,
                fscratch, f_elems, stream, true);
}
