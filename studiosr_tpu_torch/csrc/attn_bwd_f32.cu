// B8 and B9 in f32, written for the H100: the backward of the attention
// half of a Swin block with the forward recomputed,
//   y = x + d_b * proj(WA(LN x))  on (B, H, W, C) maps,
// window attention over ws x ws windows, ws 2..8 (attn_bwd_mma_f32, B8) and
// 9..16 (attn_bwd16_mma_f32, B9: below), the shift folded into reads and
// writes. From x and the cotangent g it emits dx and the f32 gradients of
// the LN scale and bias, Wqkv, bqkv, Wproj, bproj and the gathered rel-pos
// bias (heads, N, N).
//
// Replaces studiosr_tpu/ops/pallas/attn_bwd.py::pairs_attention_bwd (:209)
// and, at windows 9..16, ::v5_attention_bwd (:508, kernel _bwd_kernel_v5
// :362) in f32, the dtype SwinFIR's recipe and HAT's f32 step train in
// (SwinIR's and MaxSR's f32 steps and checks take it too); bf16 runs
// attn_bwd_mma.cu, windows from 17 and head dims above 32 attn_bwd16.cu /
// attn_bwd.cu. The contract is the TPU kernel's with T = f32: g_b
// = d g, dx = g_b + LN-backward(dln) + (1 - d) g, wqkv unscaled and q =
// (LN Wq + bq) / sqrt(d), so dq carries the scale; products accumulate in
// f32; softmax, its backward, the LN backward and d bias in f32; every sum
// across blocks in a fixed order (no atomics: the same bits from run to
// run). A window of N = ws^2 tokens is padded to one 64-token tile
// (am_window.cuh): the padding tokens' LN and g_b rows are zeros and their
// keys score -inf, so their p, dscores, dq, dk and dv are zeros and they add
// nothing to the weight gradients, d bias or the LN sums.
//
// Bound on the card at SwinFIR's step (T = 131,072 tokens, C 180, 6 heads
// of 30): 111.6 GFLOP, 0.677 ms at 3xTF32 (0.084 ms for x, g and dx).
// attn_bwd.cu ran a window a block, its heads one after another, each head's
// 64 x 32 x 64 products on the FMA pipes (4 x 4 outputs a thread, a barrier
// every 32-row weight chunk, the weights restaged from L2 for every window).
// Here, the passes of attn_bwd_mma.cu, every product 3xTF32 on the tensor
// cores (tf32x3.cuh), tokens in tile order (a window a 64-row tile):
// 0. ab32_ln_kernel, a warp a token row: LN (its f32 statistics kept) and
//    g_b, gathered through the shift, zero rows for padding tokens;
// 1. q|k|v = LN Wqkv + bqkv (q scaled; tf32x3.cuh TfQkv) and dattn = g_b
//    Wproj^T, row products on wgmma (tfw_gemm_kernel), each head padded to
//    DP = pad16(d) columns (zero past d);
// 2. ab32_attn_kernel, a block of four warps owning (head, group of
//    windows), a window at a time: q, k, v and dattn by cp.async into
//    shared memory, the next window's in flight; each warp's 16 queries:
//    scores = q k^T and dprobs = dattn v^T on mma.sync, the softmax, D =
//    sum p dprobs and dscores in registers, the block's d bias rows
//    accumulated in registers across its windows; attn =
//    p v and dq = dscores k with p and dscores as A fragments straight from
//    the score fragments (the key order inside each 8-key step permuted so
//    that a thread's two score columns are its two A columns, and v's and
//    k's rows read in the same order); p^T and dscores^T to shared memory,
//    then each warp's 16 keys: dk = dscores^T q and dv = p^T dattn;
// 3. dln = dqkv Wqkv^T (K the padded dq|dk|dv columns) on wgmma;
// 4. ab32_lnb_kernel, a warp a token row: the LN backward and dx, and
//    per-block column sums of dln xhat and dln;
// 5. d Wqkv = LN^T dqkv, d Wproj = attn^T g_b and the bias gradients:
//    split-K partials on tf_gemm_kernel; every partial summed in a fixed
//    order.
// The weights change every step, so they are packed per call (tfw_pack: a
// gather by the index table of ops/cuda/attn_bwd.py _f32_pack_index and the
// split into hi and lo images: Wqkv with each head's q, k, v columns padded
// to DP, Wproj^T with its head columns padded, and Wqkv^T). The gradients of Wqkv, bqkv and Wproj
// come back head-padded, as attn_bwd_mma.cu's do.
// Windows 9..16 (B9; bound at HAT's f32 step, batch 32 of 64 x 64 maps, C
// 180, 6 heads of 30: 165.9 GFLOP, 1.006 ms at 3xTF32): a window's N = ws^2
// tokens fill NCH = ceil(N / 64) tiles (am_window.cuh), so passes 0, 1, 3,
// 4 and 5 run as above over NCH tiles a window; pass 2 becomes two sweeps
// over its key chunks, each score tile formed twice (attn_bwd16.cu formed
// it three times): tf_window16.cuh's tw_rows_kernel (attn and each row's
// statistics) and ab16_main_kernel (below), then dq's and d bias's sums.
// Takes f32, windows 2..16, head dims up to 32, C a multiple of 4 up to
// 256, H and W multiples of the window; the wrapper routes anything else.
#include <cmath>

#include "tf_window16.cuh"

constexpr int AB32_LDP = AM_TOK + 4;  // p^T / dscores^T row stride (floats): conflict-free reads and writes

struct Ab32Args {
  AmArgs geo;  // H, W, shift, nwx, nwi: the token geometry am_pixel and am_region read
  const float *x, *g, *ln_w, *ln_b, *bqkv, *relbias, *dp;
  float* dx;
  float *ln, *gb, *qkv, *dattn, *att, *dqkv, *dln, *stats, *dbias_part, *lnst;
  long long windows, rows;
  int groups;
  float scale;  // 1 / sqrt(d), rounded once
  // windows 9..16: the bias in fragment order, the attention rows'
  // statistics (QR = SL 128 rows a (window, head)), dq's key-chunk partials
  const float4* bfrag;
  float *astats, *dqp;
  int SL, QR;
};

// Pass 0, a warp a token row (rows in tile order): LN and g_b, or zeros for
// a padding token.
__global__ void __launch_bounds__(256) ab32_ln_kernel(const Ab32Args a, const AmGeom G) {
  for (long long row = blockIdx.x * 8LL + (threadIdx.x >> 5); row < a.rows; row += gridDim.x * 8LL) {
    const int tile = (int)(row / AM_TOK), t = (int)(row % AM_TOK);
    if (!am_valid(G, tile, t)) {
      tf_zero_row(G.C, a.ln + row * G.C, a.gb + row * G.C);
      if ((threadIdx.x & 31) == 0) a.stats[2 * row] = 0.f, a.stats[2 * row + 1] = 0.f;
      continue;
    }
    const long long off = am_pixel(G, a.geo, tile, t) * G.C;
    const float dd = a.dp ? a.dp[tile / G.NCH / a.geo.nwi] : 1.f;
    tf_ln_row(a.x + off, a.g + off, dd, G.C, a.ln_w, a.ln_b, a.stats + 2 * row, a.ln + row * G.C, a.gb + row * G.C);
  }
}

// Pass 2: a block of four warps owns (head h, window group gi) and walks the
// group's windows; warp w takes queries 16 w .. 16 w + 15 of the window, then
// keys 16 w .. 16 w + 15. Shared memory: two sets of q, k, v, dattn (64 x
// DP, rows DP + 4 apart; the next window's loads in flight while this one
// is computed), p^T and dscores^T (64 x 64, rows 68 apart, each 8-query step
// in the permuted order), the keys' shift regions.
__host__ __device__ inline size_t ab32_attn_smem(int DP) {
  return (8 * (size_t)AM_TOK * (DP + 4) + 2 * (size_t)AM_TOK * AB32_LDP) * 4 + AM_TOK * 4;
}

template <int DP>
__global__ void __launch_bounds__(128, 2) ab32_attn_kernel(const Ab32Args a, const AmGeom G) {
  constexpr int LDQ = DP + 4, NDT = DP / 8, LDP = AB32_LDP;
  extern __shared__ __align__(16) float sm32[];
  float *PT = sm32 + 8 * AM_TOK * LDQ, *ST = PT + AM_TOK * LDP;
  int* reg = (int*)(ST + AM_TOK * LDP);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x % G.heads, gi = blockIdx.x / G.heads, q0 = 16 * warp, NV = G.NV;
  const float scale = a.scale;
  // the permuted place of query q0 + g (and q0 + g + 8) in its 8-query step
  const int pos = (g & 1) ? (g >> 1) + 4 : g >> 1;
  float db[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[nt][e] = 0.f;
  // the bias and mask of score (row, col)
  auto bias = [&](int row, int col) -> float {
    if (col >= NV) return -INFINITY;
    if (row >= NV) return 0.f;
    const float b = __ldg(a.relbias + ((long long)h * NV + row) * NV + col);
    return a.geo.shift && reg[row] != reg[col] ? b - 100.f : b;
  };

  // window w's q, k, v and dattn into set b, one cp.async group
  auto load = [&](long long w, int b) {
    const long long row0 = w * AM_TOK;
    float* set = sm32 + b * 4 * AM_TOK * LDQ;
    for (int i = tid; i < 4 * AM_TOK * (DP / 4); i += 128) {
      const int buf = i / (AM_TOK * (DP / 4)), rem = i % (AM_TOK * (DP / 4)), r = rem / (DP / 4), c4 = rem % (DP / 4);
      const float* src = buf == 3 ? a.dattn + (row0 + r) * G.HD + h * DP + 4 * c4
                                  : a.qkv + (row0 + r) * G.K3 + buf * G.HD + h * DP + 4 * c4;
      hm_cp_async<16>(set + (buf * AM_TOK + r) * LDQ + 4 * c4, src, true);
    }
  };
  if (gi < a.windows) load(gi, 0);
  hm_cp_commit();
  int it = 0;
  for (long long w = gi; w < a.windows; w += a.groups, ++it) {
    const long long row0 = w * AM_TOK;
    const float* Qs = sm32 + (it & 1) * 4 * AM_TOK * LDQ;
    const float *Ks = Qs + AM_TOK * LDQ, *Vs = Ks + AM_TOK * LDQ, *Ds = Vs + AM_TOK * LDQ;
    __syncthreads();  // the last window's set, p^T, dscores^T and regions are read
    if (w + a.groups < a.windows) load(w + a.groups, (it & 1) ^ 1);
    hm_cp_commit();
    if (a.geo.shift)
      for (int k = tid; k < AM_TOK; k += 128) reg[k] = k < NV ? am_region(G, a.geo, (int)(w % a.geo.nwi), k) : -1;
    hm_cp_wait_upto(1);  // this window's set is in
    __syncthreads();

    // scores and dprobs of this warp's 16 queries against the 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f, dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP; ks += 8) {
      uint32_t qh[4], ql[4], dh[4], dl[4];
      const float* qr = Qs + (q0 + g) * LDQ + ks + t;
      const float* dr = Ds + (q0 + g) * LDQ + ks + t;
      const float qv[4] = {qr[0], qr[8 * LDQ], qr[4], qr[8 * LDQ + 4]};
      const float dv[4] = {dr[0], dr[8 * LDQ], dr[4], dr[8 * LDQ + 4]};
      tf_split4(qv, qh, ql);
      tf_split4(dv, dh, dl);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t kh[2], kl[2], vh[2], vl[2];
        tf_split2(Ks[(8 * nt + g) * LDQ + ks + t], Ks[(8 * nt + g) * LDQ + ks + t + 4], kh, kl);
        tf_split2(Vs[(8 * nt + g) * LDQ + ks + t], Vs[(8 * nt + g) * LDQ + ks + t + 4], vh, vl);
        tf_mma3x2(s[nt], qh, ql, kh, kl, dp[nt], dh, dl, vh, vl);
      }
    }
    // softmax, D = sum p dprobs, dscores = p (dprobs - D); d bias
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] += bias(q0 + g + 8 * (e >> 1), 8 * nt + 2 * t + (e & 1));
        m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
      }
    float l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) m[hh] = am_quad_max(m[hh]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.f / am_quad_sum(l[hh]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] *= inv[e >> 1];
        u[e >> 1] += s[nt][e] * dp[nt][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) u[hh] = am_quad_sum(u[hh]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[nt][e] = s[nt][e] * (dp[nt][e] - u[e >> 1]);
        db[nt][e] += dp[nt][e];
      }

    // attn = p v and dq = dscores k: key 8 kb + 2t + e of the score fragment
    // is A column t + 4 e of step kb, and v's and k's rows are read in that order
    float o[NDT][4], dq[NDT][4];
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = 0.f, dq[nd][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      const float pv[4] = {s[kb][0], s[kb][2], s[kb][1], s[kb][3]};
      const float sv[4] = {dp[kb][0], dp[kb][2], dp[kb][1], dp[kb][3]};
      tf_split4(pv, ph, pl);
      tf_split4(sv, sh, sl);
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd) {
        uint32_t vh[2], vl[2], kh[2], kl[2];
        const int r = (8 * kb + 2 * t) * LDQ + 8 * nd + g;
        tf_split2(Vs[r], Vs[r + LDQ], vh, vl);
        tf_split2(Ks[r], Ks[r + LDQ], kh, kl);
        tf_mma3x2(o[nd], ph, pl, vh, vl, dq[nd], sh, sl, kh, kl);
      }
    }
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long row = row0 + q0 + g + 8 * hh;
        const int col = h * DP + 8 * nd + 2 * t;
        *reinterpret_cast<float2*>(a.att + row * G.HD + col) = make_float2(o[nd][2 * hh], o[nd][2 * hh + 1]);
        *reinterpret_cast<float2*>(a.dqkv + row * G.K3 + col) =
            make_float2(dq[nd][2 * hh] * scale, dq[nd][2 * hh + 1] * scale);
      }
    // p^T and dscores^T: key k's row, query q at 8 (q / 8) + its permuted place
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * nt + 2 * t + (e & 1), qp = q0 + 8 * (e >> 1) + pos;
        PT[key * LDP + qp] = s[nt][e];
        ST[key * LDP + qp] = dp[nt][e];
      }
    __syncthreads();
    // dk = dscores^T q and dv = p^T dattn for keys q0 .. q0 + 15 (query 8 qb
    // + 2t + e is A column t + 4 e of step qb)
    float dk[NDT][4], dv[NDT][4];
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[nd][e] = 0.f, dv[nd][e] = 0.f;
#pragma unroll
    for (int qb = 0; qb < 8; ++qb) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      const int k0 = (q0 + g) * LDP + 8 * qb + t;
      const float sv[4] = {ST[k0], ST[k0 + 8 * LDP], ST[k0 + 4], ST[k0 + 8 * LDP + 4]};
      const float pv[4] = {PT[k0], PT[k0 + 8 * LDP], PT[k0 + 4], PT[k0 + 8 * LDP + 4]};
      tf_split4(sv, sh, sl);
      tf_split4(pv, ph, pl);
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd) {
        uint32_t qh[2], ql[2], dh[2], dl[2];
        const int r = (8 * qb + 2 * t) * LDQ + 8 * nd + g;
        tf_split2(Qs[r], Qs[r + LDQ], qh, ql);
        tf_split2(Ds[r], Ds[r + LDQ], dh, dl);
        tf_mma3x2(dk[nd], sh, sl, qh, ql, dv[nd], ph, pl, dh, dl);
      }
    }
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* dr = a.dqkv + (row0 + q0 + g + 8 * hh) * G.K3 + h * DP + 8 * nd + 2 * t;
        *reinterpret_cast<float2*>(dr + G.HD) = make_float2(dk[nd][2 * hh], dk[nd][2 * hh + 1]);
        *reinterpret_cast<float2*>(dr + 2 * G.HD) = make_float2(dv[nd][2 * hh], dv[nd][2 * hh + 1]);
      }
  }
  // this block's d bias rows to its partial (head h, group gi)
  float* part = a.dbias_part + ((long long)h * a.groups + gi) * AM_TOK * AM_TOK;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(part + (q0 + g + 8 * hh) * AM_TOK + 8 * nt + 2 * t) =
          make_float2(db[nt][2 * hh], db[nt][2 * hh + 1]);
}

// out[h][q][k] (nv x nv) = sum over groups of part[h][g][q][k] (64 x 64), in
// order of g.
__global__ void ab32_dbias_reduce_kernel(const float* __restrict__ part, int heads, int groups, int nv,
                                         float* __restrict__ out) {
  const long long vv = (long long)nv * nv;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < heads * vv;
       i += (long long)gridDim.x * blockDim.x) {
    const long long h = i / vv, e = i % vv, src = e / nv * AM_TOK + e % nv;
    float v = 0.f;
    for (int g = 0; g < groups; ++g) v += part[(h * groups + g) * AM_TOK * AM_TOK + src];
    out[i] = v;
  }
}

// -- windows 9..16: the attention pass in two sweeps ------------------------------------
//
// Sweep 1 is tf_window16.cuh's tw_rows_kernel<DP, true> (attn and the rows'
// statistics). Sweep 2, ab16_main_kernel: a block of eight warps owns (group
// gi of windows, head h, key chunk c); blocks (gi, h, 0 .. NCH - 1) are
// neighbours, so a window's q and dattn serve its chunks' blocks from L2. It
// walks its windows a slab of 128 query rows at a time (a step; NCH 3 leaves
// the second slab's last 64 rows, past the window, to no warp): at a step's
// start the slab's q and dattn (copied in during the last step) are split
// into hi / lo images, and at a window's first step the chunk's k and v
// (copied in once the last window's scores were formed, split in place) and
// the keys' regions; then the next step's rows are copied in while this one
// runs. Warp w forms the scores and dprobs of the slab's rows 16 w .. 16 w +
// 15 again, p and dscores = p (dprobs - D) in registers (the bias in
// fragment order, the mask from the regions), adds dscores to its d-bias
// slice (registers, across the group's windows), writes the chunk's partial
// of dq = dscores k (p and dscores as A fragments straight from the score
// fragments) and p^T, dscores^T to shared memory; then warps 0-3 accumulate
// dk = dscores^T q and warps 4-7 dv = p^T dattn for 16 keys each over the
// slab's rows, whole after the window's last slab. ab16_dq_kernel sums dq's
// chunk partials in chunk order; reduce_parts the groups' d bias in group
// order. Shared memory: 219,136 bytes at N 256, DP 32: one block of eight
// warps an SM.
constexpr int AB16_SLAB = 128;             // query rows a step: eight warps of 16
constexpr int AB16_LDP = AB16_SLAB + 4;   // p^T / dscores^T row stride: conflict-free writes and A reads
constexpr int AB16_MAX_KT = 4;            // key chunks a window (window 16)

struct Ab16Smem {
  size_t stage, qg, kv, pt, sd, stat, reg, total;
};

// In 4-byte words: the next step's q and dattn in f32 (128 x LD each), this
// step's split (q hi, q lo, dattn hi, dattn lo), the chunk's k and v split
// (k hi, k lo, v hi, v lo), p^T and dscores^T (64 keys x LDP), the window's
// row statistics (SL 128 x 3), the keys' regions (N).
__host__ __device__ inline Ab16Smem ab16_main_smem(int SL, int DP, int N) {
  const int LD = DP + 4;
  Ab16Smem L;
  size_t o = 0;
  L.stage = o, o += (size_t)2 * AB16_SLAB * LD;
  L.qg = o, o += (size_t)4 * AB16_SLAB * LD;
  L.kv = o, o += (size_t)4 * AM_TOK * LD;
  L.pt = o, o += (size_t)AM_TOK * AB16_LDP;
  L.sd = o, o += (size_t)AM_TOK * AB16_LDP;
  L.stat = o, o += (size_t)SL * AB16_SLAB * 3;
  L.reg = o, o += (size_t)N;
  L.total = o * 4;
  return L;
}

template <int DP, int SL>
__global__ void __launch_bounds__(TW_THREADS, 1) ab16_main_kernel(const Ab32Args a, const AmGeom G) {
  constexpr int LD = DP + 4, KS = DP / 8, NDT = DP / 8, SLAB_F = AB16_SLAB * LD, CH = AM_TOK * LD, LDP = AB16_LDP;
  extern __shared__ __align__(16) float ab16_sm[];
  const Ab16Smem L = ab16_main_smem(SL, DP, G.N);
  float* stage = ab16_sm + L.stage;
  uint32_t* qg = reinterpret_cast<uint32_t*>(ab16_sm + L.qg);  // q hi, q lo, dattn hi, dattn lo
  uint32_t* kv = reinterpret_cast<uint32_t*>(ab16_sm + L.kv);  // k hi, k lo, v hi, v lo
  float *PT = ab16_sm + L.pt, *ST = ab16_sm + L.sd, *stat = ab16_sm + L.stat;
  int* reg = reinterpret_cast<int*>(ab16_sm + L.reg);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int KT = G.NCH, N = G.N, NV = G.NV, c = blockIdx.x % KT, h = (blockIdx.x / KT) % G.heads;
  const int gi = blockIdx.x / (KT * G.heads);
  const int pos = (g & 1) ? (g >> 1) + 4 : g >> 1;  // the permuted place of query 16 w + g (+ 8) in its 8-query step
  const bool shift = a.geo.shift != 0;
  // slab sl of window w's q and dattn into the stage, zeros past the window (the caller commits)
  auto load_qg = [&](long long w, int sl) {
    constexpr int PER = AB16_SLAB * (DP / 4);
    for (int i = tid; i < 2 * PER; i += TW_THREADS) {
      const int which = i / PER, r = (i % PER) / (DP / 4), c4 = i % (DP / 4), q = sl * AB16_SLAB + r;
      const long long row = w * N + q;
      const float* src = which ? a.dattn + row * G.HD + h * DP + 4 * c4 : a.qkv + row * G.K3 + h * DP + 4 * c4;
      hm_cp_async<16>(stage + which * SLAB_F + r * LD + 4 * c4, q < N ? src : a.qkv, q < N);
    }
  };
  // window w's chunk of k and v (f32, into the hi images) and its rows' statistics (the caller commits)
  auto load_kv = [&](long long w) {
    constexpr int PER = AM_TOK * (DP / 4);
    for (int i = tid; i < 2 * PER; i += TW_THREADS) {
      const int which = i / PER, r = (i % PER) / (DP / 4), c4 = i % (DP / 4);
      hm_cp_async<16>(kv + 2 * which * CH + r * LD + 4 * c4,
                      a.qkv + (w * N + c * AM_TOK + r) * G.K3 + (1 + which) * G.HD + h * DP + 4 * c4, true);
    }
    const float* sts = a.astats + (w * G.heads + h) * a.QR * 3;
    for (int i = tid; i < a.QR * 3 / 4; i += TW_THREADS) hm_cp_async<16>(stat + 4 * i, sts + 4 * i, true);
  };
  const int windows = (int)((a.windows - gi + a.groups - 1) / a.groups), steps = windows * SL;
  load_qg(gi, 0);
  load_kv(gi);
  hm_cp_commit();
  float db[SL][8][4];  // d bias of the warp's rows of each slab x the chunk's keys, over the group's windows
#pragma unroll
  for (int sl = 0; sl < SL; ++sl)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) db[sl][nt][e] = 0.f;
  const int kind = warp >> 2, kt = warp & 3;  // kind 0: dk, 1: dv, of keys 16 kt .. 16 kt + 15
  float acc[NDT][4];
#pragma unroll 1
  for (int wi = 0; wi < windows; ++wi)
#pragma unroll
  for (int sl = 0; sl < SL; ++sl) {  // sl a constant, so db[sl] stays in registers
    const int it = wi * SL + sl;
    const long long w = gi + (long long)a.groups * wi, u = w * G.heads + h;
    const int qrows = am_min(AB16_SLAB, N - sl * AB16_SLAB);  // the slab's rows in the window: 64 or 128
    hm_cp_wait_upto(0);
    __syncthreads();  // step it's rows are in; step it - 1's products are done
    tf_split_rows<DP, LD, TW_THREADS>(stage, qg, qg + SLAB_F, qrows);
    tf_split_rows<DP, LD, TW_THREADS>(stage + SLAB_F, qg + 2 * SLAB_F, qg + 3 * SLAB_F, qrows);
    if (sl == 0) {
      tf_split_rows<DP, LD, TW_THREADS>(reinterpret_cast<const float*>(kv), kv, kv + CH, AM_TOK);
      tf_split_rows<DP, LD, TW_THREADS>(reinterpret_cast<const float*>(kv + 2 * CH), kv + 2 * CH, kv + 3 * CH, AM_TOK);
      if (shift)
        for (int k = tid; k < N; k += TW_THREADS) reg[k] = k < NV ? am_region(G, a.geo, (int)(w % a.geo.nwi), k) : -1;
    }
    __syncthreads();  // the split images and regions are in; the stage is free
    if (it + 1 < steps) load_qg(gi + (long long)a.groups * ((it + 1) / SL), (it + 1) % SL);
    hm_cp_commit();
    if (16 * warp < qrows) {
      const float4* bf =
          a.bfrag + ((size_t)(h * KT + 2 * sl + (warp >> 2)) * KT + c) * 1024 + 32 * (warp & 3) + lane;
      float4 bb[8];  // loaded before the products, so their latency hides under them
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) bb[nt] = __ldg(bf + 128 * nt);
      // the scores and dprobs of the warp's 16 rows, again
      float s[8][4], dp[8][4];
      const uint32_t* qrow = qg + 16 * warp * LD;
      tf_scores<KS, LD>(
          s, dp,
          [&](int ks, uint32_t (&a0)[4], uint32_t (&a1)[4], uint32_t (&b0)[4], uint32_t (&b1)[4]) {
            tf_afrag_split(qrow, qrow + SLAB_F, LD, ks, a0, a1);
            tf_afrag_split(qrow + 2 * SLAB_F, qrow + 3 * SLAB_F, LD, ks, b0, b1);
          },
          kv, kv + CH, kv + 2 * CH, kv + 3 * CH);
      // p and dscores from the statistics; d bias
      float m[2], linv[2], D[2];
      int rreg[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = sl * AB16_SLAB + 16 * warp + g + 8 * hh;
        m[hh] = stat[row * 3], linv[hh] = stat[row * 3 + 1], D[hh] = stat[row * 3 + 2];
        rreg[hh] = shift && row < NV ? reg[row] : -1;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float b4[4] = {bb[nt].x, bb[nt].y, bb[nt].z, bb[nt].w};
        const int col = c * AM_TOK + nt * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool masked = rreg[e >> 1] >= 0 && col + (e & 1) < NV && reg[col + (e & 1)] != rreg[e >> 1];
          const float sc = s[nt][e] + (masked ? b4[e] - 100.f : b4[e]);
          const float p = am_exp2(fmaf(sc, AM_LOG2E, -m[e >> 1])) * linv[e >> 1];
          const float ds = p * (dp[nt][e] - D[e >> 1]);
          s[nt][e] = p, dp[nt][e] = ds;
          db[sl][nt][e] += ds;
        }
      }
      // the chunk's partial of dq = dscores k: key 8 kb + 2t + e of the score
      // fragment is A column t + 4 e of step kb, and k's rows are read in that
      // order; a fresh accumulator for each 32 keys
      float dq[NDT][4];
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float part[NDT][4];
#pragma unroll
        for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[nd][e] = 0.f;
#pragma unroll
        for (int kb = 4 * half; kb < 4 * half + 4; ++kb) {
          uint32_t sh[4], sl4[4];
          const float sv[4] = {dp[kb][0], dp[kb][2], dp[kb][1], dp[kb][3]};
          tf_split4(sv, sh, sl4);
#pragma unroll
          for (int nd = 0; nd < NDT; nd += 2) {
            const int at = (8 * kb + 2 * t) * LD + 8 * nd + g;
            const uint32_t k0h[2] = {kv[at], kv[at + LD]}, k0l[2] = {kv[CH + at], kv[CH + at + LD]};
            const uint32_t k1h[2] = {kv[at + 8], kv[at + LD + 8]}, k1l[2] = {kv[CH + at + 8], kv[CH + at + LD + 8]};
            tf_mma3x2(part[nd], sh, sl4, k0h, k0l, part[nd + 1], sh, sl4, k1h, k1l);
          }
        }
#pragma unroll
        for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[nd][e] += part[nd][e];
      }
      float4* dst = reinterpret_cast<float4*>(a.dqp) + (((u * KT + c) * SL + sl) * 8 + warp) * NDT * 32 + lane;
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd) dst[nd * 32] = make_float4(dq[nd][0], dq[nd][1], dq[nd][2], dq[nd][3]);
      // p^T and dscores^T: key k's row, query q of the slab at 8 (q / 8) + its permuted place
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * nt + 2 * t + (e & 1), qp = 16 * warp + 8 * (e >> 1) + pos;
          PT[key * LDP + qp] = s[nt][e];
          ST[key * LDP + qp] = dp[nt][e];
        }
    }
    __syncthreads();  // p^T and dscores^T are in; k, v, the statistics and regions are read no more this window
    if (sl == SL - 1 && it + 1 < steps) load_kv(w + a.groups);
    hm_cp_commit();
    // dk = dscores^T q (warps 0-3) or dv = p^T dattn (warps 4-7) of keys 16 kt
    // .., over the slab's rows: query 8 qb + 2t + e is A column t + 4 e of step
    // qb; a fresh accumulator for each 32 queries
    if (sl == 0) {
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
    }
    {
      const float* A = (kind ? PT : ST) + 16 * kt * LDP;
      const uint32_t* Bh = qg + 2 * kind * SLAB_F;
      const uint32_t* Bl = Bh + SLAB_F;
#pragma unroll 1
      for (int st = 0; st < qrows / 32; ++st) {
        float part[NDT][4];
#pragma unroll
        for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[nd][e] = 0.f;
#pragma unroll
        for (int qb = 4 * st; qb < 4 * st + 4; ++qb) {
          uint32_t ah[4], al[4];
          tf_afrag(A, LDP, qb, ah, al);
#pragma unroll
          for (int nd = 0; nd < NDT; nd += 2) {
            const int at = (8 * qb + 2 * t) * LD + 8 * nd + g;
            const uint32_t b0h[2] = {Bh[at], Bh[at + LD]}, b0l[2] = {Bl[at], Bl[at + LD]};
            const uint32_t b1h[2] = {Bh[at + 8], Bh[at + LD + 8]}, b1l[2] = {Bl[at + 8], Bl[at + LD + 8]};
            tf_mma3x2(part[nd], ah, al, b0h, b0l, part[nd + 1], ah, al, b1h, b1l);
          }
        }
#pragma unroll
        for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nd][e] += part[nd][e];
      }
    }
    if (sl == SL - 1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* dr = a.dqkv + (w * N + c * AM_TOK + 16 * kt + g + 8 * hh) * G.K3 + (1 + kind) * G.HD + h * DP + 2 * t;
#pragma unroll
        for (int nd = 0; nd < NDT; ++nd)
          *reinterpret_cast<float2*>(dr + 8 * nd) = make_float2(acc[nd][2 * hh], acc[nd][2 * hh + 1]);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // the block's d bias to the group's partial (gi, h), the real rows and keys
  float* dbp = a.dbias_part + ((size_t)gi * G.heads + h) * NV * NV;
#pragma unroll
  for (int sl = 0; sl < SL; ++sl)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = sl * AB16_SLAB + 16 * warp + g + 8 * (e >> 1), col = c * AM_TOK + 8 * nt + 2 * t + (e & 1);
        if (row < NV && col < NV) dbp[(size_t)row * NV + col] = db[sl][nt][e];
      }
}

// A thread a float4 of a (window, head)'s fragment-ordered dq (slab, warp,
// 8-column tile, lane): the key chunks' partials summed in chunk order,
// scaled by 1 / sqrt(d), to its dq columns of dqkv; rows past the window dropped.
template <int DP>
__global__ void __launch_bounds__(256) ab16_dq_kernel(const Ab32Args a, const AmGeom G) {
  constexpr int NDT = DP / 8;
  const int KT = G.NCH, per = a.SL * 8 * NDT * 32;
  const long long total = a.windows * G.heads * per;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long u = e / per;
    const int r = (int)(e - u * per);
    const float4* part = reinterpret_cast<const float4*>(a.dqp) + u * KT * per + r;
    float4 v[AB16_MAX_KT];
#pragma unroll
    for (int cc = 0; cc < AB16_MAX_KT; ++cc)
      v[cc] = cc < KT ? part[(long long)cc * per] : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 sum = v[0];
#pragma unroll
    for (int cc = 1; cc < AB16_MAX_KT; ++cc)
      if (cc < KT) sum.x += v[cc].x, sum.y += v[cc].y, sum.z += v[cc].z, sum.w += v[cc].w;
    const int lane = r & 31, nd = (r >> 5) % NDT, wr = (r / (32 * NDT)) & 7, sl = r / (256 * NDT);
    const int row = sl * AB16_SLAB + 16 * wr + (lane >> 2), j = 8 * nd + 2 * (lane & 3);
    float* out = a.dqkv + ((u / G.heads) * G.N + row) * G.K3 + (u % G.heads) * DP + j;
    if (row < G.N) *reinterpret_cast<float2*>(out) = make_float2(sum.x * a.scale, sum.y * a.scale);
    if (row + 8 < G.N) *reinterpret_cast<float2*>(out + 8 * G.K3) = make_float2(sum.z * a.scale, sum.w * a.scale);
  }
}

// Pass 4, a warp a token row (block b takes rows b, b + gridDim, ...): the LN
// backward and dx, the block's column sums of dln xhat and dln into
// lnst[block][2 C]; padding tokens are skipped.
__global__ void __launch_bounds__(256) ab32_lnb_kernel(const Ab32Args a, const AmGeom G) {
  __shared__ float sums[8][2 * TF_MAX_C];
  const int warp = threadIdx.x >> 5, C = G.C;
  float cs[2][8] = {};
  for (long long row = blockIdx.x + (long long)gridDim.x * warp; row < a.rows; row += gridDim.x * 8LL) {
    const int tile = (int)(row / AM_TOK), t = (int)(row % AM_TOK);
    if (!am_valid(G, tile, t)) continue;
    const long long off = am_pixel(G, a.geo, tile, t) * C;
    const float dd = a.dp ? a.dp[tile / G.NCH / a.geo.nwi] : 1.f;
    tf_lnb_row(a.dln + row * C, a.x + off, a.g + off, a.dx + off, a.stats[2 * row], a.stats[2 * row + 1], dd, C,
               a.ln_w, cs);
  }
  tf_lnb_sums(cs, C, sums, a.lnst + (long long)blockIdx.x * 2 * C);
}

// The packed weights: Wqkv (C x K3), Wproj^T (C x HD), Wqkv^T (K3 x C).
// The row products' weights (tfw_pack's images): Wqkv (C x K3), Wproj^T (C x
// HD), Wqkv^T (K3 x C); their hi values (the lo ones as many).
static long long ab32_pack_elems(const AmGeom& G) {
  return tfw_elems(G.C, G.K3) + tfw_elems(G.C, G.HD) + tfw_elems(G.K3, G.C);
}

// The f32 scratch, each region 16-byte aligned: the packed weights; LN and
// g_b rows (C), q|k|v rows (K3), dattn and attn rows (HD), dq|dk|dv rows
// (K3), dln rows (C), the rows in tile order (N a window); the LN
// statistics (2 a row); the d bias partials (windows 2..8: heads x groups x
// 64 x 64; 9..16: groups x heads x NV x NV); pass 4's blocks' column sums
// and their sums by eights; the wgrad partials; at windows 9..16 also the
// bias in fragment order (heads x N x N), the attention rows' statistics
// (windows x heads x QR x 3) and dq's key-chunk partials (windows x heads x
// NCH x QR x DP).
struct Ab32Scratch {
  long long pack, ln, gb, qkv, dattn, att, dqkv, dln, stats, dbias, lnst, wg, bfrag, astats, dqp, f_elems;
  long long windows, rows;
  int groups, rgroups, row_blocks, sms, SL, QR;
};

static Ab32Scratch ab32_scratch(int B, int H, int W, int C, int heads, int ws, int sms) {
  const AmGeom G(C, heads, ws);
  const bool w16 = G.NCH > 1;
  Ab32Scratch S;
  auto at = [](long long& o, long long n) {
    const long long r = o;
    o = (o + n + 3) & ~3LL;
    return r;
  };
  S.windows = (long long)B * (H / ws) * (W / ws);
  S.rows = S.windows * G.N;
  if (w16) {  // sweep 2's groups; sweep 1 one block an SM
    S.groups = tf_groups(S.windows, heads * G.NCH, sms);
    S.rgroups = tw_rows_groups(S.windows, heads, sms);
  } else {
    long long groups = (3LL * sms + heads - 1) / heads;  // about three attention blocks an SM
    S.groups = (int)(groups > S.windows ? S.windows : groups);
    S.rgroups = 0;
  }
  S.SL = (G.N + AB16_SLAB - 1) / AB16_SLAB;
  S.QR = S.SL * AB16_SLAB;
  S.row_blocks = 8 * sms;
  S.sms = sms;
  const long long units = S.windows * heads;
  long long o = 0;
  S.pack = at(o, 2 * ab32_pack_elems(G));
  S.ln = at(o, S.rows * C);
  S.gb = at(o, S.rows * C);
  S.qkv = at(o, S.rows * G.K3);
  S.dattn = at(o, S.rows * G.HD);
  S.att = at(o, S.rows * G.HD);
  S.dqkv = at(o, S.rows * G.K3);
  S.dln = at(o, S.rows * C);
  S.stats = at(o, 2 * S.rows);
  S.dbias = at(o, w16 ? (long long)S.groups * heads * G.NV * G.NV : (long long)heads * S.groups * AM_TOK * AM_TOK);
  S.lnst = at(o, (long long)(S.row_blocks + sms) * 2 * C);
  const long long p1 = tf_wgrad_plan(S.rows, C, G.K3, sms).part_elems;
  const long long p2 = tf_wgrad_plan(S.rows, G.HD, C, sms).part_elems;
  S.wg = at(o, p1 > p2 ? p1 : p2);
  S.bfrag = at(o, w16 ? (long long)heads * G.N * G.N : 0);
  S.astats = at(o, w16 ? units * S.QR * 3 : 0);
  S.dqp = at(o, w16 ? units * G.NCH * S.QR * G.DP : 0);
  S.f_elems = o;
  return S;
}

// Elements of the packed weights (ops/cuda/attn_bwd.py checks its own count
// against it), or -1 for a geometry the kernels do not take; both families
// pack the same weights.
extern "C" long long attn_bwd_mma_f32_pack_elems(int C, int heads) {
  return tf_window_ok(C, heads, 8) ? ab32_pack_elems(AmGeom(C, heads, 8)) : -1;
}

extern "C" int attn_bwd_mma_f32_scratch(int B, int H, int W, int C, int heads, int ws, long long* f_elems) {
  int sms = 0;
  const cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  *f_elems = ab32_scratch(B, H, W, C, heads, ws, sms).f_elems;
  return 0;
}

template <int DP>
static cudaError_t ab32_launch_attn(const Ab32Args& a, const AmGeom& G, cudaStream_t stream) {
  const size_t bytes = ab32_attn_smem(DP);
  cudaError_t err = allow_smem(ab32_attn_kernel<DP>, bytes);
  if (err != cudaSuccess) return err;
  ab32_attn_kernel<DP><<<G.heads * a.groups, 128, bytes, stream>>>(a, G);
  return cudaGetLastError();
}

// Windows 9..16: the bias in fragment order, sweep 1 (attn and the rows'
// statistics), sweep 2 (dq's chunk partials, dk, dv, the d bias partials),
// dq's sum, d bias's sum.
template <int DP, int SL>
static cudaError_t ab16_launch_attn(const Ab32Args& a, const Ab32Scratch& S, const AmGeom& G, float* bfrag,
                                    float* dbias, cudaStream_t st) {
  cudaError_t err = tw_bias_order(a.relbias, G, bfrag, st);
  if (err != cudaSuccess) return err;
  TwRows r{a.geo, a.qkv, a.dattn, a.bfrag, a.att, a.astats, a.windows, S.rgroups, S.QR};
  if ((err = tw_rows_launch<DP, true>(r, G, st)) != cudaSuccess) return err;
  const size_t bytes = ab16_main_smem(SL, DP, G.N).total;
  if ((err = allow_smem(ab16_main_kernel<DP, SL>, bytes)) != cudaSuccess) return err;
  ab16_main_kernel<DP, SL><<<S.groups * G.heads * G.NCH, TW_THREADS, bytes, st>>>(a, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = a.windows * G.heads * SL * 8 * (DP / 8) * 32;
  ab16_dq_kernel<DP><<<(int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192), 256, 0, st>>>(a, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_parts(a.dbias_part, S.groups, (long long)G.heads * G.NV * G.NV, dbias, st);
}

// The gradients with the heads padded to DP: dwqkv (C x K3), dbqkv (K3) and
// dwproj (HD x C) have zero rows / columns at d .. DP of each head, which
// the wrapper drops. relbias is the gathered bias (heads, ws^2, ws^2) in f32.
static int ab32_run(const void* x, const void* g, void* dx, int B, int H, int W, int C, int heads, int ws, int shift,
                    const void* ln_w, const void* ln_b, const void* bqkv, const void* relbias, const void* dp,
                    const void* wqkv, const void* wproj, const void* pack_index, long long pack_elems, void* ds_db,
                    void* dwqkv, void* dbqkv, void* dwproj, void* dbproj, void* dbias, void* fscratch,
                    long long f_elems, void* stream) {
  if (B < 1 || H < ws || W < ws || H % ws || W % ws || shift < 0 || shift >= ws) return (int)cudaErrorInvalidValue;
  const AmGeom G(C, heads, ws);
  int sms = 0;
  cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const Ab32Scratch S = ab32_scratch(B, H, W, C, heads, ws, sms);
  if (S.f_elems != f_elems || ab32_pack_elems(G) != pack_elems) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || (uintptr_t)g % 16 || (uintptr_t)dx % 16 || (uintptr_t)fscratch % 16 ||
      (uintptr_t)ln_w % 16 || (uintptr_t)ln_b % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  float* f = (float*)fscratch;
  Ab32Args a{};
  a.geo.H = H, a.geo.W = W, a.geo.shift = shift, a.geo.nwx = W / ws, a.geo.nwi = (H / ws) * (W / ws);
  a.x = (const float*)x, a.g = (const float*)g, a.dx = (float*)dx;
  a.ln_w = (const float*)ln_w, a.ln_b = (const float*)ln_b, a.bqkv = (const float*)bqkv;
  a.relbias = (const float*)relbias, a.dp = (const float*)dp;
  a.ln = f + S.ln, a.gb = f + S.gb, a.qkv = f + S.qkv, a.dattn = f + S.dattn, a.att = f + S.att, a.dqkv = f + S.dqkv;
  a.dln = f + S.dln, a.stats = f + S.stats, a.dbias_part = f + S.dbias, a.lnst = f + S.lnst;
  a.windows = S.windows, a.rows = S.rows, a.groups = S.groups;
  a.scale = (float)(1.0 / std::sqrt((double)G.d));
  a.bfrag = reinterpret_cast<const float4*>(f + S.bfrag), a.astats = f + S.astats, a.dqp = f + S.dqp;
  a.SL = S.SL, a.QR = S.QR;
  const long long rows = S.rows, e1 = tfw_elems(C, G.K3), e2 = tfw_elems(C, G.HD);
  float *wq = f + S.pack, *wpt = wq + 2 * e1, *wqt = wpt + 2 * e2;
  const int* idx = (const int*)pack_index;

  const float *wa = (const float*)wqkv, *wb = (const float*)wproj;
  err = tfw_pack(wa, 3LL * C * C, wb, (long long)C * C, idx, C, G.K3, wq, st);
  if (err == cudaSuccess) err = tfw_pack(wa, 3LL * C * C, wb, (long long)C * C, idx + e1, C, G.HD, wpt, st);
  if (err == cudaSuccess) err = tfw_pack(wa, 3LL * C * C, wb, (long long)C * C, idx + e1 + e2, G.K3, C, wqt, st);
  if (err != cudaSuccess) return (int)err;
  ab32_ln_kernel<<<S.row_blocks, 256, 0, st>>>(a, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // q|k|v = LN Wqkv + bqkv (q scaled); dattn = g_b Wproj^T
  err = tfw_gemm(TfwGemm{a.ln, wq, C, rows, C, G.K3}, TfQkv{a.qkv, a.bqkv, rows, G.K3, G.HD, G.DP, C, G.d, a.scale},
                 st);
  if (err != cudaSuccess) return (int)err;
  err = tfw_gemm(TfwGemm{a.gb, wpt, C, rows, C, G.HD}, TfStore{a.dattn, rows, G.HD, G.HD}, st);
  if (err != cudaSuccess) return (int)err;
  if (G.NCH > 1) {
    float *bf = f + S.bfrag, *db = (float*)dbias;
    if (G.DP == 32)
      err = S.SL == 2 ? ab16_launch_attn<32, 2>(a, S, G, bf, db, st) : ab16_launch_attn<32, 1>(a, S, G, bf, db, st);
    else
      err = S.SL == 2 ? ab16_launch_attn<16, 2>(a, S, G, bf, db, st) : ab16_launch_attn<16, 1>(a, S, G, bf, db, st);
    if (err != cudaSuccess) return (int)err;
  } else {
    err = G.DP == 32 ? ab32_launch_attn<32>(a, G, st) : ab32_launch_attn<16>(a, G, st);
    if (err != cudaSuccess) return (int)err;
    const long long nb = heads * (long long)G.NV * G.NV;
    ab32_dbias_reduce_kernel<<<(int)((nb + 255) / 256 < 1024 ? (nb + 255) / 256 : 1024), 256, 0, st>>>(
        a.dbias_part, heads, S.groups, G.NV, (float*)dbias);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // dln = dqkv Wqkv^T
  err = tfw_gemm(TfwGemm{a.dqkv, wqt, G.K3, rows, G.K3, C}, TfStore{a.dln, rows, C, C}, st);
  if (err != cudaSuccess) return (int)err;
  ab32_lnb_kernel<<<S.row_blocks, 256, 0, st>>>(a, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // block b's partial is part s = b / sms of group b % sms: first the eight
  // of each group, then the groups, in order
  float* lnst1 = a.lnst + (long long)S.row_blocks * 2 * C;
  err = reduce_parts(a.lnst, S.row_blocks / sms, (long long)sms * 2 * C, lnst1, st);
  if (err != cudaSuccess) return (int)err;
  err = reduce_parts(lnst1, sms, 2LL * C, (float*)ds_db, st);
  if (err != cudaSuccess) return (int)err;
  err = tf_wgrad(a.ln, C, a.dqkv, G.K3, rows, C, G.K3, (float*)dwqkv, (float*)dbqkv, f + S.wg, sms, st);
  if (err != cudaSuccess) return (int)err;
  return (int)tf_wgrad(a.att, G.HD, a.gb, C, rows, G.HD, C, (float*)dwproj, (float*)dbproj, f + S.wg, sms, st);
}

// Two entries, one a family: windows 2..8 (B8, one tile a window) and 9..16
// (B9, two to four tiles), each with its own geometry rule.
#define ATTN_BWD_F32_ENTRY(NAME, OK)                                                                              \
  extern "C" int NAME(const void* x, const void* g, void* dx, int B, int H, int W, int C, int heads, int ws,      \
                      int shift, const void* ln_w, const void* ln_b, const void* bqkv, const void* relbias,       \
                      const void* dp, const void* wqkv, const void* wproj, const void* pack_index,                \
                      long long pack_elems, void* ds_db, void* dwqkv, void* dbqkv, void* dwproj, void* dbproj,    \
                      void* dbias, void* fscratch, long long f_elems, void* stream) {                             \
    if (!OK(C, heads, ws)) return (int)cudaErrorInvalidValue;                                                     \
    return ab32_run(x, g, dx, B, H, W, C, heads, ws, shift, ln_w, ln_b, bqkv, relbias, dp, wqkv, wproj,           \
                    pack_index, pack_elems, ds_db, dwqkv, dbqkv, dwproj, dbproj, dbias, fscratch, f_elems,        \
                    stream);                                                                                      \
  }

ATTN_BWD_F32_ENTRY(attn_bwd_mma_f32, tf_window_ok)
ATTN_BWD_F32_ENTRY(attn_bwd16_mma_f32, tf_window16_ok)
