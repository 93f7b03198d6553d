// B8 in f32, written for the H100: the backward of the attention half of a
// Swin block with the forward recomputed,
//   y = x + d_b * proj(WA(LN x))  on (B, H, W, C) maps,
// window attention over ws x ws windows, ws 2..8, the shift folded into
// reads and writes. From x and the cotangent g it emits dx and the f32
// gradients of the LN scale and bias, Wqkv, bqkv, Wproj, bproj and the
// gathered rel-pos bias (heads, N, N).
//
// Replaces studiosr_tpu/ops/pallas/attn_bwd.py::pairs_attention_bwd (:209)
// in f32, the dtype SwinFIR's recipe trains in (SwinIR's, HAT's and MaxSR's
// f32 steps and checks take it too); bf16 runs attn_bwd_mma.cu, windows
// from 9 attn_bwd16.cu. The contract is the TPU kernel's with T = f32: g_b
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
// Takes f32, windows 2..8, head dims up to 32, C a multiple of 4 up to 256,
// H and W multiples of the window; the wrapper routes anything else.
#include <cmath>

#include "am_window.cuh"
#include "tf32x3.cuh"

constexpr int AB32_LDP = AM_TOK + 4;  // p^T / dscores^T row stride (floats): conflict-free reads and writes

struct Ab32Args {
  AmArgs geo;  // H, W, shift, nwx, nwi: the token geometry am_pixel and am_region read
  const float *x, *g, *ln_w, *ln_b, *bqkv, *relbias, *dp;
  float* dx;
  float *ln, *gb, *qkv, *dattn, *att, *dqkv, *dln, *stats, *dbias_part, *lnst;
  long long windows, rows;
  int groups;
  float scale;  // 1 / sqrt(d), rounded once
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
    const float dd = a.dp ? a.dp[tile / a.geo.nwi] : 1.f;
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
    const float dd = a.dp ? a.dp[tile / a.geo.nwi] : 1.f;
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
// (K3), dln rows (C); the LN statistics (2 a row); the d bias partials
// (heads x groups x 64 x 64); pass 4's blocks' column sums and their sums by
// eights; the wgrad partials.
struct Ab32Scratch {
  long long pack, ln, gb, qkv, dattn, att, dqkv, dln, stats, dbias, lnst, wg, f_elems;
  long long windows, rows;
  int groups, row_blocks, sms;
};

static Ab32Scratch ab32_scratch(int B, int H, int W, int C, int heads, int ws, int sms) {
  const AmGeom G(C, heads, ws);
  Ab32Scratch S;
  auto at = [](long long& o, long long n) {
    const long long r = o;
    o = (o + n + 3) & ~3LL;
    return r;
  };
  S.windows = (long long)B * (H / ws) * (W / ws);
  S.rows = S.windows * AM_TOK;
  long long groups = (3LL * sms + heads - 1) / heads;  // about three attention blocks an SM
  S.groups = (int)(groups > S.windows ? S.windows : groups);
  S.row_blocks = 8 * sms;
  S.sms = sms;
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
  S.dbias = at(o, (long long)heads * S.groups * AM_TOK * AM_TOK);
  S.lnst = at(o, (long long)(S.row_blocks + sms) * 2 * C);
  const long long p1 = tf_wgrad_plan(S.rows, C, G.K3, sms).part_elems;
  const long long p2 = tf_wgrad_plan(S.rows, G.HD, C, sms).part_elems;
  S.wg = at(o, p1 > p2 ? p1 : p2);
  S.f_elems = o;
  return S;
}

// Elements of the packed weights (ops/cuda/attn_bwd.py checks its own count
// against it), or -1 for a geometry the kernels do not take.
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

// The gradients with the heads padded to DP: dwqkv (C x K3), dbqkv (K3) and
// dwproj (HD x C) have zero rows / columns at d .. DP of each head, which
// the wrapper drops. relbias is the gathered bias (heads, ws^2, ws^2) in f32.
extern "C" int attn_bwd_mma_f32(const void* x, const void* g, void* dx, int B, int H, int W, int C, int heads, int ws,
                                int shift, const void* ln_w, const void* ln_b, const void* bqkv, const void* relbias,
                                const void* dp, const void* wqkv, const void* wproj, const void* pack_index,
                                long long pack_elems, void* ds_db, void* dwqkv, void* dbqkv, void* dwproj,
                                void* dbproj, void* dbias, void* fscratch, long long f_elems, void* stream) {
  if (!tf_window_ok(C, heads, ws) || B < 1 || H < ws || W < ws || H % ws || W % ws || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
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
  err = G.DP == 32 ? ab32_launch_attn<32>(a, G, st) : ab32_launch_attn<16>(a, G, st);
  if (err != cudaSuccess) return (int)err;
  const long long nb = heads * (long long)G.NV * G.NV;
  ab32_dbias_reduce_kernel<<<(int)((nb + 255) / 256 < 1024 ? (nb + 255) / 256 : 1024), 256, 0, st>>>(
      a.dbias_part, heads, S.groups, G.NV, (float*)dbias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
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
