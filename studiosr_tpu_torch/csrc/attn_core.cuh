// Attention over 64-row tiles with every score recomputed, forward and
// backward, shared by B12 / B13 (oca_core.cu, the OCAB core on
// (windows, heads, tokens, d) tensors) and B9 (attn_bwd16.cu, window 16 on
// a per-pixel q|k|v scratch).
//
// One unit is one (window, head): nq query rows, nk key rows, head dim d
// (padded to DP = pad16(d) with zeros), a logit bias per (query, key). A
// geometry class G says where the rows of a unit live and where results go.
// It has members units, heads, nq, nk, d, dq_scale; PADDED (rows hold DP
// values, zero past d, 16-byte aligned); mma_rows() (the mma kernels may
// stage its rows: PADDED, or d even and 4-byte aligned rows); and unit(u),
// a view of unit u = window * heads + head, with its index id, nq, nk and
//   const T* q(r), k(t), v(t), g(r)  the row (d values, unit stride), or
//       null past nq / nk (read as zeros);
//   float bias(r, t)                the logit bias (mask included);
//   put_o, put_dq, put_dk, put_dv(row, j, value)  store in T.
//
// Two passes, no atomics, every sum in a fixed order:
// * ac_rows_kernel, one block per (unit, 64 queries). Sweep 1 streams the
//   key chunks with an online, max-subtracted softmax: per row the max m,
//   the sum l of exp(s - m) and D = sum_t p_t dp_t with dp = g v^T (the
//   softmax backward's row term, kept online as l is). In forward mode it
//   accumulates o = p v and stores o / l (B12); B9 stores that too (the
//   attention output that d Wproj needs). Sweep 2 recomputes the scores and
//   dp, forms dscores = p (dp - D) and accumulates dq = dscores k; the row
//   statistics (m, l, D) go to a scratch for the second pass.
// * ac_cols_kernel, one block per (head, 64 keys, window group): for each
//   window of its group, in order, it loops over the query chunks, forms p
//   and dscores from the stored statistics and accumulates dv = p^T g and
//   dk = dscores^T q for its keys whole, and adds dscores into its group's
//   f32 (nq x 64) d bias tile in shared memory. The groups' tiles are
//   summed in a fixed order afterwards (wgrad.cuh's reduce_parts).
//
// In bf16 at head dims up to 32 (HAT's 30, the trained fixtures' 16) both
// passes run on mma.sync with the tiles in registers, the flash-attention
// layout of qkv_attention.cuh's forward: a block of four warps, each warp
// owning 16 query rows (ac_rows_mma_kernel: scores, dp, the probabilities,
// dscores and the o / dq accumulators of its rows in registers) or 16 key
// rows (ac_cols_mma_kernel: k and v as mma operands, s^T = k q^T, dp^T = v
// g^T, and the dk / dv accumulators in registers; its d bias tile in shared
// memory, each element owned by one thread). Only the streamed tiles go
// through shared memory. f32 (the checks' dtype) and wider heads take the
// kernels above, on 64-row tiles in shared memory through swin_common.cuh's
// gemm64_smem (FMA in f32, wmma in bf16).
//
// Rounding points follow the TPU kernels: q, k, v, g in T; products
// accumulate in f32; the probabilities and dscores are rounded to T for the
// products; softmax, D and d bias are f32.
#pragma once

#include <math.h>

#include "qkv_attention.cuh"
#include "wgrad.cuh"

constexpr int AC_TILE = 64;     // query rows a tile, keys a chunk
constexpr int AC_MAX_NQ = 256;  // the column pass keeps nq x 64 f32 of d bias in shared memory (64 KB); above, ac_dbias_kernel
// Row-pass modes: B12's forward; B13's dq; B9's dq and attention output.
constexpr int AC_FWD = 0, AC_ROWS = 1, AC_ROWS_O = 2;
constexpr int AC_MMA_THREADS = 128;  // the mma kernels: four warps of 16 rows
constexpr int AC_BLOCKS_PER_SM = 2;  // the column pass's target, for its window groups

struct AcSmem {
  size_t q, g, k, v, sc, dp, acc0, acc1, m, l, dsum, cr, rows, dbias, total;
  int lq, lsc, lacc;
};

// Shared memory of both kernels; `cols` adds the column pass's d bias tile
// (nq rounded up to 64 rows of 64 f32).
template <typename T>
__host__ __device__ inline AcSmem ac_smem_layout(int DP, int nq, bool cols) {
  AcSmem L;
  L.lq = DP + 16 / (int)sizeof(T);  // 16 bytes of skew: wmma's ldm rule in bf16, fewer bank conflicts
  L.lsc = AC_TILE + 4;
  L.lacc = DP + 4;
  const size_t tile = (size_t)AC_TILE * L.lq * sizeof(T);
  const size_t ftile = (size_t)AC_TILE * L.lsc * sizeof(float);
  const size_t atile = (size_t)AC_TILE * L.lacc * sizeof(float);
  size_t o = 0;
  L.q = o;
  o = align32(o + tile);
  L.g = o;
  o = align32(o + tile);
  L.k = o;
  o = align32(o + tile);
  L.v = o;
  o = align32(o + tile);
  L.sc = o;  // f32 scores; probabilities (T) over them, row r at the same byte
  o = align32(o + ftile);
  L.dp = o;  // f32 dp; dscores (T) over it
  o = align32(o + ftile);
  L.acc0 = o;  // rows: o; cols: dv
  o = align32(o + atile);
  L.acc1 = o;  // rows: dq; cols: dk
  o = align32(o + atile);
  L.m = o;
  o = align32(o + AC_TILE * sizeof(float));
  L.l = o;
  o = align32(o + AC_TILE * sizeof(float));
  L.dsum = o;
  o = align32(o + AC_TILE * sizeof(float));
  L.cr = o;
  o = align32(o + AC_TILE * sizeof(float));
  L.rows = o;  // row pointers of the two tiles being loaded
  o = align32(o + 2 * AC_TILE * sizeof(void*));
  L.dbias = o;
  if (cols) o = align32(o + (size_t)pad64(nq) * AC_TILE * sizeof(float));
  L.total = o;
  return L;
}

// Fill two 64 x DP tiles (stride ld) from rows ra(i) and rb(i) (null: a
// zero row; columns d..DP zero). Needs a barrier before (the tiles and the
// row pointers free) and one after (before the tiles are read).
template <typename T, typename RA, typename RB>
__device__ void ac_load2(T* a, RA ra, T* b, RB rb, int ld, int d, int DP, const T** rows) {
  const int tid = threadIdx.x;
  if (tid < AC_TILE) rows[tid] = ra(tid);
  else if (tid < 2 * AC_TILE) rows[tid] = rb(tid - AC_TILE);
  __syncthreads();
  for (int i = tid; i < 2 * AC_TILE * DP; i += SB_THREADS) {
    const int r = i / DP, c = i - r * DP;
    const T* p = rows[r];
    (r < AC_TILE ? a : b)[(r & (AC_TILE - 1)) * ld + c] = (p && c < d) ? p[c] : from_f32<T>(0.f);
  }
}

// sc = q k^T + bias over key chunk k0 (-inf past nk, no bias past nq).
template <typename T, class U_>
__device__ __forceinline__ void ac_scores(const U_& U, int q0, int k0, const T* qs, const T* ks, int lq, int DP,
                                          float* sc, int lsc, const FragMap& map) {
  using nvcuda::wmma::col_major;
  using nvcuda::wmma::row_major;
  gemm64_smem<row_major, col_major>(qs, lq, ks, lq, DP, AC_TILE, map, [&](int r, int n, float acc) {
    const int t = k0 + n, qr = q0 + r;
    sc[r * lsc + n] = t < U.nk ? acc + (qr < U.nq ? U.bias(qr, t) : 0.f) : -INFINITY;
  });
}

template <typename T, class G, int MODE>
__global__ void __launch_bounds__(SB_THREADS) ac_rows_kernel(G geo, float* __restrict__ stats) {
  using nvcuda::wmma::col_major;
  using nvcuda::wmma::row_major;
  constexpr bool FWD = MODE == AC_FWD, WANT_O = MODE != AC_ROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = geo.d, DP = pad16(d), nq = geo.nq;
  const AcSmem L = ac_smem_layout<T>(DP, nq, false);
  T* qs = (T*)(smem + L.q);
  T* gs = (T*)(smem + L.g);
  T* ks = (T*)(smem + L.k);
  T* vs = (T*)(smem + L.v);
  float* sc = (float*)(smem + L.sc);
  T* pt = (T*)sc;
  float* dpr = (float*)(smem + L.dp);
  float* o = (float*)(smem + L.acc0);
  float* dq = (float*)(smem + L.acc1);
  float* mrow = (float*)(smem + L.m);
  float* lrow = (float*)(smem + L.l);
  float* drow = (float*)(smem + L.dsum);
  float* cr = (float*)(smem + L.cr);
  const T** rows = (const T**)(smem + L.rows);
  const int lq = L.lq, lsc = L.lsc, la = L.lacc, ldp = lsc * (int)(sizeof(float) / sizeof(T));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nqc = (nq + AC_TILE - 1) / AC_TILE, nkc = (geo.nk + AC_TILE - 1) / AC_TILE;
  const auto U = geo.unit(blockIdx.x / nqc);
  const int q0 = (int)(blockIdx.x % nqc) * AC_TILE;

  const FragMap map = frag_map_for<T>(sc);  // sc is free until the first scores
  ac_load2(qs, [&](int r) { return U.q(q0 + r); }, gs,
           [&](int r) { return FWD ? (const T*)nullptr : U.g(q0 + r); }, lq, d, DP, rows);
  if (tid < AC_TILE) {
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
    drow[tid] = 0.f;
  }
  for (int i = tid; i < AC_TILE * la; i += SB_THREADS) o[i] = dq[i] = 0.f;

  // sweep 1: m, l, D online (and o = p v)
  for (int kc = 0; kc < nkc; ++kc) {
    const int k0 = kc * AC_TILE;
    __syncthreads();  // every thread is done with the previous chunk
    ac_load2(ks, [&](int t) { return U.k(k0 + t); }, vs, [&](int t) { return U.v(k0 + t); }, lq, d, DP,
             rows);
    __syncthreads();
    ac_scores<T>(U, q0, k0, qs, ks, lq, DP, sc, lsc, map);
    if (!FWD)
      gemm64_smem<row_major, col_major>(gs, lq, vs, lq, DP, AC_TILE, map,
                                        [&](int r, int n, float acc) { dpr[r * lsc + n] = acc; });
    for (int r = warp; r < AC_TILE; r += SB_THREADS / 32) {
      const float a = sc[r * lsc + lane], b = sc[r * lsc + lane + 32];
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, b)));
      const float ea = expf(a - m_new), eb = expf(b - m_new);
      const float s = warp_sum(ea + eb);
      const float t = FWD ? 0.f : warp_sum(ea * dpr[r * lsc + lane] + eb * dpr[r * lsc + lane + 32]);
      __syncwarp();
      if (WANT_O) {
        pt[r * ldp + lane] = from_f32<T>(ea);
        pt[r * ldp + lane + 32] = from_f32<T>(eb);
      }
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // 0 at the first chunk (m_old = -inf)
        cr[r] = corr;
        lrow[r] = lrow[r] * corr + s;
        drow[r] = drow[r] * corr + t;
        mrow[r] = m_new;
      }
    }
    __syncthreads();
    if (WANT_O)
      gemm64_smem<row_major, row_major>(pt, ldp, vs, lq, AC_TILE, DP, map, [&](int r, int n, float acc) {
        o[r * la + n] = o[r * la + n] * cr[r] + acc;
      });
  }
  if (WANT_O)
    for (int i = tid; i < AC_TILE * d; i += SB_THREADS) {
      const int r = i / d, j = i - r * d;
      if (q0 + r < nq) U.put_o(q0 + r, j, o[r * la + j] / lrow[r]);
    }
  if (FWD) return;
  if (tid < AC_TILE) {
    drow[tid] /= lrow[tid];
    if (q0 + tid < nq) {
      float* st = stats + ((size_t)U.id * nq + q0 + tid) * 3;
      st[0] = mrow[tid];
      st[1] = lrow[tid];
      st[2] = drow[tid];
    }
  }

  // sweep 2: dscores = p (dp - D), dq = dscores k
  for (int kc = 0; kc < nkc; ++kc) {
    const int k0 = kc * AC_TILE;
    __syncthreads();
    ac_load2(ks, [&](int t) { return U.k(k0 + t); }, vs, [&](int t) { return U.v(k0 + t); }, lq, d, DP,
             rows);
    __syncthreads();
    ac_scores<T>(U, q0, k0, qs, ks, lq, DP, sc, lsc, map);
    gemm64_smem<row_major, col_major>(gs, lq, vs, lq, DP, AC_TILE, map,
                                      [&](int r, int n, float acc) { dpr[r * lsc + n] = acc; });
    for (int r = warp; r < AC_TILE; r += SB_THREADS / 32) {
      const float m = mrow[r], il = 1.f / lrow[r], dd = drow[r];
      const float pa = expf(sc[r * lsc + lane] - m) * il, pb = expf(sc[r * lsc + lane + 32] - m) * il;
      const float sa = pa * (dpr[r * lsc + lane] - dd), sb = pb * (dpr[r * lsc + lane + 32] - dd);
      __syncwarp();
      pt[r * ldp + lane] = from_f32<T>(sa);
      pt[r * ldp + lane + 32] = from_f32<T>(sb);
    }
    __syncthreads();
    gemm64_smem<row_major, row_major>(pt, ldp, ks, lq, AC_TILE, DP, map,
                                      [&](int r, int n, float acc) { dq[r * la + n] += acc; });
  }
  for (int i = tid; i < AC_TILE * d; i += SB_THREADS) {
    const int r = i / d, j = i - r * d;
    if (q0 + r < nq) U.put_dq(q0 + r, j, dq[r * la + j] * geo.dq_scale);
  }
}

// DBIAS false (nq above AC_MAX_NQ): dk and dv only, d bias by ac_dbias_kernel.
template <typename T, class G, bool DBIAS = true>
__global__ void __launch_bounds__(SB_THREADS) ac_cols_kernel(G geo, const float* __restrict__ stats, int groups,
                                                             float* __restrict__ dbias_part) {
  using nvcuda::wmma::col_major;
  using nvcuda::wmma::row_major;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = geo.d, DP = pad16(d), nq = geo.nq, nk = geo.nk, heads = geo.heads;
  const AcSmem L = ac_smem_layout<T>(DP, nq, DBIAS);
  T* qs = (T*)(smem + L.q);
  T* gs = (T*)(smem + L.g);
  T* ks = (T*)(smem + L.k);
  T* vs = (T*)(smem + L.v);
  float* sc = (float*)(smem + L.sc);
  T* pt = (T*)sc;
  float* dpr = (float*)(smem + L.dp);
  T* dst = (T*)dpr;
  float* dv = (float*)(smem + L.acc0);
  float* dk = (float*)(smem + L.acc1);
  float* mrow = (float*)(smem + L.m);
  float* ilrow = (float*)(smem + L.l);
  float* drow = (float*)(smem + L.dsum);
  const T** rows = (const T**)(smem + L.rows);
  float* db = (float*)(smem + L.dbias);
  const int lq = L.lq, lsc = L.lsc, la = L.lacc, ldp = lsc * (int)(sizeof(float) / sizeof(T));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nqc = (nq + AC_TILE - 1) / AC_TILE, nkc = (nk + AC_TILE - 1) / AC_TILE;
  const int grp = blockIdx.x % groups, kc = (blockIdx.x / groups) % nkc, h = blockIdx.x / (groups * nkc);
  const int k0 = kc * AC_TILE;
  const long long windows = geo.units / heads;

  if (DBIAS)
    for (int i = tid; i < nqc * AC_TILE * AC_TILE; i += SB_THREADS) db[i] = 0.f;
  const FragMap map = frag_map_for<T>(sc);
  for (long long w = grp; w < windows; w += groups) {
    const auto U = geo.unit(w * heads + h);
    __syncthreads();  // the previous window is done with every buffer
    ac_load2(ks, [&](int t) { return U.k(k0 + t); }, vs, [&](int t) { return U.v(k0 + t); }, lq, d, DP,
             rows);
    for (int i = tid; i < AC_TILE * la; i += SB_THREADS) dk[i] = dv[i] = 0.f;
    for (int qc = 0; qc < nqc; ++qc) {
      const int q0 = qc * AC_TILE;
      __syncthreads();  // the previous query chunk is done with q, g, p, dscores and the statistics
      ac_load2(qs, [&](int r) { return U.q(q0 + r); }, gs, [&](int r) { return U.g(q0 + r); }, lq, d, DP,
               rows);
      if (tid < AC_TILE) {
        mrow[tid] = ilrow[tid] = drow[tid] = 0.f;  // a missing row has p = 0
        if (q0 + tid < nq) {
          const float* st = stats + ((size_t)U.id * nq + q0 + tid) * 3;
          mrow[tid] = st[0];
          ilrow[tid] = 1.f / st[1];
          drow[tid] = st[2];
        }
      }
      __syncthreads();
      ac_scores<T>(U, q0, k0, qs, ks, lq, DP, sc, lsc, map);
      gemm64_smem<row_major, col_major>(gs, lq, vs, lq, DP, AC_TILE, map,
                                        [&](int r, int n, float acc) { dpr[r * lsc + n] = acc; });
      for (int r = warp; r < AC_TILE; r += SB_THREADS / 32) {
        const float m = mrow[r], il = ilrow[r], dd = drow[r];
        const float pa = expf(sc[r * lsc + lane] - m) * il, pb = expf(sc[r * lsc + lane + 32] - m) * il;
        const float sa = pa * (dpr[r * lsc + lane] - dd), sb = pb * (dpr[r * lsc + lane + 32] - dd);
        __syncwarp();
        pt[r * ldp + lane] = from_f32<T>(pa);
        pt[r * ldp + lane + 32] = from_f32<T>(pb);
        dst[r * ldp + lane] = from_f32<T>(sa);
        dst[r * ldp + lane + 32] = from_f32<T>(sb);
        if (DBIAS) {
          float* dbr = db + (size_t)(q0 + r) * AC_TILE;
          dbr[lane] += sa;
          dbr[lane + 32] += sb;
        }
      }
      __syncthreads();
      // dv = p^T g, dk = dscores^T q (rows: this block's keys)
      gemm64_smem<col_major, row_major>(pt, ldp, gs, lq, AC_TILE, DP, map,
                                        [&](int r, int n, float acc) { dv[r * la + n] += acc; });
      gemm64_smem<col_major, row_major>(dst, ldp, qs, lq, AC_TILE, DP, map,
                                        [&](int r, int n, float acc) { dk[r * la + n] += acc; });
    }
    for (int i = tid; i < AC_TILE * d; i += SB_THREADS) {
      const int r = i / d, j = i - r * d;
      if (k0 + r < nk) {
        U.put_dk(k0 + r, j, dk[r * la + j]);
        U.put_dv(k0 + r, j, dv[r * la + j]);
      }
    }
  }
  if (!DBIAS) return;
  __syncthreads();
  float* part = dbias_part + ((size_t)grp * heads + h) * nq * nk;
  for (int i = tid; i < nq * AC_TILE; i += SB_THREADS) {
    const int q = i / AC_TILE, n = i - q * AC_TILE;
    if (k0 + n < nk) part[(size_t)q * nk + k0 + n] = db[i];
  }
}

// d bias above AC_MAX_NQ, where the column pass's nq x 64 f32 rows outgrow
// shared memory: a block owns one 64 x 64 tile (window group grp, head h,
// query chunk qc, key chunk kc), recomputes its scores and dp for each window
// of the group, and sums its dscores in shared memory (16 KB) in window
// order; the tile goes to the group's partial as the column pass's would.
template <typename T, class G>
__global__ void __launch_bounds__(SB_THREADS) ac_dbias_kernel(G geo, const float* __restrict__ stats, int groups,
                                                              float* __restrict__ dbias_part) {
  using nvcuda::wmma::col_major;
  using nvcuda::wmma::row_major;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = geo.d, DP = pad16(d), nq = geo.nq, nk = geo.nk, heads = geo.heads;
  const AcSmem L = ac_smem_layout<T>(DP, nq, false);
  T* qs = (T*)(smem + L.q);
  T* gs = (T*)(smem + L.g);
  T* ks = (T*)(smem + L.k);
  T* vs = (T*)(smem + L.v);
  float* sc = (float*)(smem + L.sc);
  float* dpr = (float*)(smem + L.dp);
  float* mrow = (float*)(smem + L.m);
  float* ilrow = (float*)(smem + L.l);
  float* drow = (float*)(smem + L.dsum);
  const T** rows = (const T**)(smem + L.rows);
  float* db = (float*)(smem + L.total);
  const int lq = L.lq, lsc = L.lsc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nqc = (nq + AC_TILE - 1) / AC_TILE, nkc = (nk + AC_TILE - 1) / AC_TILE;
  int b = blockIdx.x;
  const int kc = b % nkc;
  b /= nkc;
  const int qc = b % nqc;
  b /= nqc;
  const int h = b % heads, grp = b / heads;
  const int q0 = qc * AC_TILE, k0 = kc * AC_TILE;
  const long long windows = geo.units / heads;
  for (int i = tid; i < AC_TILE * AC_TILE; i += SB_THREADS) db[i] = 0.f;
  const FragMap map = frag_map_for<T>(sc);
  for (long long w = grp; w < windows; w += groups) {
    const auto U = geo.unit(w * heads + h);
    __syncthreads();  // the previous window is done with every buffer
    ac_load2(qs, [&](int r) { return U.q(q0 + r); }, gs, [&](int r) { return U.g(q0 + r); }, lq, d, DP, rows);
    __syncthreads();
    ac_load2(ks, [&](int t) { return U.k(k0 + t); }, vs, [&](int t) { return U.v(k0 + t); }, lq, d, DP, rows);
    if (tid < AC_TILE) {
      mrow[tid] = ilrow[tid] = drow[tid] = 0.f;  // a missing row has p = 0
      if (q0 + tid < nq) {
        const float* st = stats + ((size_t)U.id * nq + q0 + tid) * 3;
        mrow[tid] = st[0];
        ilrow[tid] = 1.f / st[1];
        drow[tid] = st[2];
      }
    }
    __syncthreads();
    ac_scores<T>(U, q0, k0, qs, ks, lq, DP, sc, lsc, map);
    gemm64_smem<row_major, col_major>(gs, lq, vs, lq, DP, AC_TILE, map,
                                      [&](int r, int n, float acc) { dpr[r * lsc + n] = acc; });
    for (int r = warp; r < AC_TILE; r += SB_THREADS / 32) {
      const float m = mrow[r], il = ilrow[r], dd = drow[r];
      const float pa = expf(sc[r * lsc + lane] - m) * il, pb = expf(sc[r * lsc + lane + 32] - m) * il;
      db[r * AC_TILE + lane] += pa * (dpr[r * lsc + lane] - dd);
      db[r * AC_TILE + lane + 32] += pb * (dpr[r * lsc + lane + 32] - dd);
    }
  }
  __syncthreads();
  float* part = dbias_part + ((size_t)grp * heads + h) * nq * nk;
  for (int i = tid; i < AC_TILE * AC_TILE; i += SB_THREADS) {
    const int q = i / AC_TILE, n = i - q * AC_TILE;
    if (q0 + q < nq && k0 + n < nk) part[(size_t)(q0 + q) * nk + k0 + n] = db[i];
  }
}


// -- bf16 on mma.sync, tiles in registers -------------------------------------

// The a fragments of rows row0 .. row0 + 15, columns 0 .. 16 KS - 1 of a bf16
// tile in shared memory (stride ld), one per k-step of 16 (mma_bf16_16816's
// layout).
template <int KS>
__device__ __forceinline__ void ac_frag_a(uint32_t (&a)[KS][4], const __nv_bfloat16* tile, int ld, int row0) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* r0 = tile + (row0 + gq) * ld + ks * 16 + 2 * tq;
    const __nv_bfloat16* r1 = r0 + 8 * ld;
    a[ks][0] = *reinterpret_cast<const uint32_t*>(r0);
    a[ks][1] = *reinterpret_cast<const uint32_t*>(r1);
    a[ks][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    a[ks][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }
}

// acc (16 x 64, eight 16 x 8 tiles) = a b^T, a the warp's 16 x 16 KS rows as
// a fragments, b the 64 rows of a bf16 tile in shared memory (their first
// 16 KS columns, stride ld).
template <int KS>
__device__ __forceinline__ void ac_mma_abt(float (&acc)[8][4], const uint32_t (&a)[KS][4], const __nv_bfloat16* b,
                                           int ld) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const __nv_bfloat16* r = b + (nt * 8 + gq) * ld + ks * 16 + 2 * tq;
      mma_bf16_16816(acc[nt], a[ks], *reinterpret_cast<const uint32_t*>(r), *reinterpret_cast<const uint32_t*>(r + 8));
    }
  }
}

// acc (16 x 16 KS) += a b, a a 16 x 64 operand as four k-steps of a
// fragments (ac_pack), b the 64 rows (first 16 KS columns) of a bf16 tile in
// shared memory, row-major (stride ld, 16-byte aligned rows).
template <int KS>
__device__ __forceinline__ void ac_mma_ab(float (&acc)[2 * KS][4], const uint32_t (&a)[4][4], const __nv_bfloat16* b,
                                          int ld) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int dn = 0; dn < 2 * KS; ++dn) {
      uint32_t b0, b1;
      ldmatrix_b_trans(b0, b1, b, ld, kk * 16, dn * 8);
      mma_bf16_16816(acc[dn], a[kk], b0, b1);
    }
}

// The 16 x 64 accumulator v, rounded to bf16, as the a fragments of four
// k-steps of 16 columns.
__device__ __forceinline__ void ac_pack(uint32_t (&a)[4][4], const float (&v)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    a[nt >> 1][(nt & 1) * 2] = pack_bf16x2(v[nt][0], v[nt][1]);
    a[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16x2(v[nt][2], v[nt][3]);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Start copying two 64 x DP bf16 tiles (stride ld) with cp.async, one row
// a thread of a 128-thread block (rows 0-63 of a, then of b): row i from
// ra(i) / rb(i), zeros for a null row. G::PADDED rows hold DP values (zero
// past d) at 16-byte aligned addresses; other rows hold d values, d even,
// at 4-byte aligned addresses, and the columns past d are zeroed here. One
// cp.async group.
template <class G, typename RA, typename RB>
__device__ __forceinline__ void ac_stage2(__nv_bfloat16* a, RA ra, __nv_bfloat16* b, RB rb, int ld, int d, int DP) {
  const int tid = threadIdx.x;
  const __nv_bfloat16* src = tid < AC_TILE ? ra(tid) : rb(tid - AC_TILE);
  __nv_bfloat16* dst = (tid < AC_TILE ? a : b) + (tid & (AC_TILE - 1)) * ld;
  if constexpr (G::PADDED) {
    for (int c = 0; c < DP; c += 8) {
      if (src) cp_async16(dst + c, src + c);
      else *reinterpret_cast<uint4*>(dst + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int c = 0; c < DP; c += 2) {
      if (src && c < d) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst + c)),
                     "l"(src + c));
      } else {
        *reinterpret_cast<uint32_t*>(dst + c) = 0u;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// ac_rows_kernel in bf16 at DP = 16 KS: warp w owns query rows 16 w .. 16 w
// + 15 of the block's 64; accumulator element e of tile nt sits at row
// 16 w + lane / 4 + 8 (e / 2), column nt 8 + 2 (lane % 4) + e % 2. The key
// chunks stream through two buffers, the next in flight while the current
// one is used.
template <class G, int MODE, int KS>
__global__ void __launch_bounds__(AC_MMA_THREADS) ac_rows_mma_kernel(G geo, float* __restrict__ stats) {
  using T = __nv_bfloat16;
  constexpr bool FWD = MODE == AC_FWD, WANT_O = MODE != AC_ROWS;
  constexpr int DP = 16 * KS, LQ = DP + 8, DT = 2 * KS, TILE = AC_TILE * LQ;  // 16-byte skew: ldmatrix banks
  __shared__ __align__(128) T qs[TILE], gs[TILE], kbuf[2 * TILE], vbuf[2 * TILE];
  const int tid = threadIdx.x, lane = tid & 31, gq = lane >> 2, tq = lane & 3, row0 = (tid >> 5) * 16;
  const int d = geo.d, nq = geo.nq, nk = geo.nk;
  const int nqc = (nq + AC_TILE - 1) / AC_TILE, nkc = (nk + AC_TILE - 1) / AC_TILE;
  const auto U = geo.unit(blockIdx.x / nqc);
  const int q0 = (int)(blockIdx.x % nqc) * AC_TILE;
  const int qr[2] = {q0 + row0 + gq, q0 + row0 + gq + 8};

  auto stage = [&](int kc) {  // key chunk kc into buffer kc & 1
    const int k0 = kc * AC_TILE;
    ac_stage2<G>(kbuf + (kc & 1) * TILE, [&](int t) { return U.k(k0 + t); }, vbuf + (kc & 1) * TILE,
                 [&](int t) { return U.v(k0 + t); }, LQ, d, DP);
  };
  // scores of chunk kc in s: q k^T + bias, -inf past nk (no bias past nq)
  uint32_t qa[KS][4], ga[KS][4];
  auto scores = [&](float (&s)[8][4], int kc) {
    ac_mma_abt<KS>(s, qa, kbuf + (kc & 1) * TILE, LQ);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = kc * AC_TILE + nt * 8 + 2 * tq + (e & 1), r = qr[e >> 1];
        s[nt][e] = t < nk ? s[nt][e] + (r < nq ? U.bias(r, t) : 0.f) : -INFINITY;
      }
  };
  ac_stage2<G>(qs, [&](int r) { return U.q(q0 + r); }, gs,
               [&](int r) { return FWD ? (const T*)nullptr : U.g(q0 + r); }, LQ, d, DP);
  stage(0);

  // sweep 1: m, l, D online (and o = p v)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  for (int kc = 0; kc < nkc; ++kc) {
    cp_async_wait_all();
    __syncthreads();  // chunk kc is in; every warp is done with chunk kc - 1's buffers
    if (kc == 0) {
      ac_frag_a<KS>(qa, qs, LQ, row0);
      ac_frag_a<KS>(ga, gs, LQ, row0);
    }
    if (kc + 1 < nkc) stage(kc + 1);
    const T* vs = vbuf + (kc & 1) * TILE;
    float s[8][4], dp[8][4];
    scores(s, kc);
    if (!FWD) ac_mma_abt<KS>(dp, ga, vs, LQ);
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      const float mn = fmaxf(m[h], quad_max(mx));
      corr[h] = expf(m[h] - mn);  // 0 at the first chunk (m = -inf)
      m[h] = mn;
      l[h] *= corr[h];
      dsum[h] *= corr[h];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += p;
        if (!FWD) dsum[e >> 1] += p * dp[nt][e];
        s[nt][e] = p;
      }
    if (WANT_O) {
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        o[dn][0] *= corr[0];
        o[dn][1] *= corr[0];
        o[dn][2] *= corr[1];
        o[dn][3] *= corr[1];
      }
      uint32_t pa[4][4];
      ac_pack(pa, s);
      ac_mma_ab<KS>(o, pa, vs, LQ);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    dsum[h] = quad_sum(dsum[h]) / l[h];
  }
  if (WANT_O)
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = qr[e >> 1], c = dn * 8 + 2 * tq + (e & 1);
        if (r < nq && c < d) U.put_o(r, c, o[dn][e] / l[e >> 1]);
      }
  if (FWD) return;
  if (tq == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qr[h] < nq) {
        float* st = stats + ((size_t)U.id * nq + qr[h]) * 3;
        st[0] = m[h];
        st[1] = l[h];
        st[2] = dsum[h];
      }

  // sweep 2: dscores = p (dp - D), dq = dscores k
  const float il[2] = {1.f / l[0], 1.f / l[1]};
  float dq[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;
  __syncthreads();  // every warp is done with sweep 1's buffers
  stage(0);
  for (int kc = 0; kc < nkc; ++kc) {
    cp_async_wait_all();
    __syncthreads();
    if (kc + 1 < nkc) stage(kc + 1);
    float s[8][4], dp[8][4];
    scores(s, kc);
    ac_mma_abt<KS>(dp, ga, vbuf + (kc & 1) * TILE, LQ);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[nt][e] = expf(s[nt][e] - m[h]) * il[h] * (dp[nt][e] - dsum[h]);
      }
    uint32_t da[4][4];
    ac_pack(da, s);
    ac_mma_ab<KS>(dq, da, kbuf + (kc & 1) * TILE, LQ);
  }
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = qr[e >> 1], c = dn * 8 + 2 * tq + (e & 1);
      if (r < nq && c < d) U.put_dq(r, c, dq[dn][e] * geo.dq_scale);
    }
}

// ac_cols_kernel in bf16 at DP = 16 KS: warp w owns key rows 16 w .. 16 w +
// 15 of the block's 64; s^T and dp^T are 16 keys x 64 queries in registers.
// The block's (window, query chunk) items stream through two buffers, the
// next item's q, g and statistics (and at a window's first chunk its k and
// v) in flight while the current one is used. The d bias tile (pad64(nq) x
// 64 f32) is dynamic shared memory.
template <class G, int KS>
__global__ void __launch_bounds__(AC_MMA_THREADS) ac_cols_mma_kernel(G geo, const float* __restrict__ stats,
                                                                    int groups, float* __restrict__ dbias_part) {
  using T = __nv_bfloat16;
  constexpr int DP = 16 * KS, LQ = DP + 8, DT = 2 * KS, TILE = AC_TILE * LQ;
  __shared__ __align__(128) T qbuf[2 * TILE], gbuf[2 * TILE], kbuf[2 * TILE], vbuf[2 * TILE];
  __shared__ float mrow[2][AC_TILE], ilrow[2][AC_TILE], drow[2][AC_TILE];
  extern __shared__ __align__(16) float db[];
  const int tid = threadIdx.x, lane = tid & 31, gq = lane >> 2, tq = lane & 3, krow0 = (tid >> 5) * 16;
  const int d = geo.d, nq = geo.nq, nk = geo.nk, heads = geo.heads;
  const int nqc = (nq + AC_TILE - 1) / AC_TILE, nkc = (nk + AC_TILE - 1) / AC_TILE;
  const int grp = blockIdx.x % groups, kc = (blockIdx.x / groups) % nkc, h = blockIdx.x / (groups * nkc);
  const int k0 = kc * AC_TILE;
  const int kl[2] = {krow0 + gq, krow0 + gq + 8};  // this thread's two keys, local to the block's 64
  const long long windows = geo.units / heads;
  const long long items = grp < windows ? ((windows - 1 - grp) / groups + 1) * nqc : 0;  // (window, query chunk)

  auto stage = [&](long long i) {  // item i: window grp + (i / nqc) groups, query chunk i % nqc
    const int b = (int)(i & 1), q0 = (int)(i % nqc) * AC_TILE;
    const long long wi = i / nqc;
    const auto U = geo.unit((grp + wi * groups) * heads + h);
    if (q0 == 0)
      ac_stage2<G>(kbuf + (wi & 1) * TILE, [&](int t) { return U.k(k0 + t); }, vbuf + (wi & 1) * TILE,
                   [&](int t) { return U.v(k0 + t); }, LQ, d, DP);
    ac_stage2<G>(qbuf + b * TILE, [&](int r) { return U.q(q0 + r); }, gbuf + b * TILE,
                 [&](int r) { return U.g(q0 + r); }, LQ, d, DP);
    if (tid < AC_TILE) {
      float m = 0.f, il = 0.f, dd = 0.f;  // a missing row has p = 0
      if (q0 + tid < nq) {
        const float* st = stats + ((size_t)U.id * nq + q0 + tid) * 3;
        m = st[0];
        il = 1.f / st[1];
        dd = st[2];
      }
      mrow[b][tid] = m;
      ilrow[b][tid] = il;
      drow[b][tid] = dd;
    }
  };

  for (int i = tid; i < nqc * AC_TILE * AC_TILE; i += AC_MMA_THREADS) db[i] = 0.f;
  uint32_t ka[KS][4], va[KS][4];
  float dk[DT][4], dv[DT][4];
  if (items) stage(0);
  for (long long i = 0; i < items; ++i) {
    const int b = (int)(i & 1), qc = (int)(i % nqc), q0 = qc * AC_TILE;
    const long long wi = i / nqc;
    const auto U = geo.unit((grp + wi * groups) * heads + h);
    cp_async_wait_all();
    __syncthreads();  // item i is in; every warp is done with item i - 1's buffers
    if (i + 1 < items) stage(i + 1);
    if (qc == 0) {
      ac_frag_a<KS>(ka, kbuf + (wi & 1) * TILE, LQ, krow0);
      ac_frag_a<KS>(va, vbuf + (wi & 1) * TILE, LQ, krow0);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
    }
    const T* qs = qbuf + b * TILE;
    const T* gs = gbuf + b * TILE;
    float st_[8][4], dpt[8][4];  // s^T = k q^T, dp^T = v g^T: (key, query)
    ac_mma_abt<KS>(st_, ka, qs, LQ);
    ac_mma_abt<KS>(dpt, va, gs, LQ);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * tq + (e & 1), qg = q0 + ql, key = k0 + kl[e >> 1];
        float p = 0.f;
        if (qg < nq && key < nk) p = expf(st_[nt][e] + U.bias(qg, key) - mrow[b][ql]) * ilrow[b][ql];
        const float ds = p * (dpt[nt][e] - drow[b][ql]);
        st_[nt][e] = p;
        dpt[nt][e] = ds;
        db[(size_t)qg * AC_TILE + kl[e >> 1]] += ds;  // this thread's own element; 0 past nq or nk
      }
    uint32_t pa[4][4], da[4][4];
    ac_pack(pa, st_);
    ac_pack(da, dpt);
    ac_mma_ab<KS>(dv, pa, gs, LQ);  // dv += p^T g
    ac_mma_ab<KS>(dk, da, qs, LQ);  // dk += dscores^T q
    if (qc == nqc - 1)
#pragma unroll
      for (int dn = 0; dn < DT; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kl[e >> 1], c = dn * 8 + 2 * tq + (e & 1);
          if (key < nk && c < d) {
            U.put_dk(key, c, dk[dn][e]);
            U.put_dv(key, c, dv[dn][e]);
          }
        }
  }
  __syncthreads();
  float* part = dbias_part + ((size_t)grp * heads + h) * nq * nk;
  for (int i = tid; i < nq * AC_TILE; i += AC_MMA_THREADS) {
    const int q = i / AC_TILE, n = i - q * AC_TILE;
    if (k0 + n < nk) part[(size_t)q * nk + k0 + n] = db[i];
  }
}

// Window groups of the column pass: about AC_BLOCKS_PER_SM blocks per SM.
__host__ inline int ac_groups(long long windows, int heads, int nk) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int per = heads * ((nk + AC_TILE - 1) / AC_TILE);
  long long g = AC_BLOCKS_PER_SM * sms / per;
  if (g > windows) g = windows;
  return g < 1 ? 1 : (int)g;
}

// Scratch floats of the two passes: the row statistics, then the groups'
// d bias partials.
__host__ inline long long ac_stats_elems(long long units, int nq) { return units * nq * 3; }
__host__ inline long long ac_part_elems(int groups, int heads, int nq, int nk) {
  return (long long)groups * heads * nq * nk;
}

// The row pass in MODE: mma.sync in bf16 at DP 16 or 32, else the
// shared-memory kernel.
template <typename T, class G, int MODE>
static cudaError_t ac_rows(const G& geo, float* stats, cudaStream_t stream) {
  const int DP = pad16(geo.d), nqc = (geo.nq + AC_TILE - 1) / AC_TILE;
  const unsigned blocks = (unsigned)(geo.units * nqc);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if ((DP == 16 || DP == 32) && geo.mma_rows()) {
      if (DP == 16) ac_rows_mma_kernel<G, MODE, 1><<<blocks, AC_MMA_THREADS, 0, stream>>>(geo, stats);
      else ac_rows_mma_kernel<G, MODE, 2><<<blocks, AC_MMA_THREADS, 0, stream>>>(geo, stats);
      return cudaGetLastError();
    }
  }
  const AcSmem L = ac_smem_layout<T>(DP, geo.nq, false);
  cudaError_t err = allow_smem(ac_rows_kernel<T, G, MODE>, L.total);
  if (err != cudaSuccess) return err;
  ac_rows_kernel<T, G, MODE><<<blocks, SB_THREADS, L.total, stream>>>(geo, stats);
  return cudaGetLastError();
}

template <typename T, class G>
static cudaError_t ac_cols(const G& geo, const float* stats, int groups, float* part, cudaStream_t stream) {
  const int DP = pad16(geo.d), nkc = (geo.nk + AC_TILE - 1) / AC_TILE;
  const unsigned blocks = (unsigned)(geo.heads * nkc * groups);
  if (geo.nq > AC_MAX_NQ) {  // windows above 16: dk / dv, then d bias a 64 x 64 tile a block
    const AcSmem L = ac_smem_layout<T>(DP, geo.nq, false);
    cudaError_t err = allow_smem(ac_cols_kernel<T, G, false>, L.total);
    if (err != cudaSuccess) return err;
    ac_cols_kernel<T, G, false><<<blocks, SB_THREADS, L.total, stream>>>(geo, stats, groups, part);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const size_t bytes = L.total + (size_t)AC_TILE * AC_TILE * sizeof(float);
    if ((err = allow_smem(ac_dbias_kernel<T, G>, bytes)) != cudaSuccess) return err;
    const int nqc = (geo.nq + AC_TILE - 1) / AC_TILE;
    ac_dbias_kernel<T, G><<<(unsigned)(groups * geo.heads * nqc * nkc), SB_THREADS, bytes, stream>>>(geo, stats, groups,
                                                                                                    part);
    return cudaGetLastError();
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if ((DP == 16 || DP == 32) && geo.mma_rows()) {
      const size_t bytes = (size_t)pad64(geo.nq) * AC_TILE * sizeof(float);
      cudaError_t err =
          DP == 16 ? allow_smem(ac_cols_mma_kernel<G, 1>, bytes) : allow_smem(ac_cols_mma_kernel<G, 2>, bytes);
      if (err != cudaSuccess) return err;
      if (DP == 16) ac_cols_mma_kernel<G, 1><<<blocks, AC_MMA_THREADS, bytes, stream>>>(geo, stats, groups, part);
      else ac_cols_mma_kernel<G, 2><<<blocks, AC_MMA_THREADS, bytes, stream>>>(geo, stats, groups, part);
      return cudaGetLastError();
    }
  }
  const AcSmem L = ac_smem_layout<T>(DP, geo.nq, true);
  cudaError_t err = allow_smem(ac_cols_kernel<T, G>, L.total);
  if (err != cudaSuccess) return err;
  ac_cols_kernel<T, G><<<blocks, SB_THREADS, L.total, stream>>>(geo, stats, groups, part);
  return cudaGetLastError();
}

template <typename T, class G>
static cudaError_t ac_forward(const G& geo, cudaStream_t stream) {
  return ac_rows<T, G, AC_FWD>(geo, nullptr, stream);
}

// Both backward passes on `stream` (MODE: AC_ROWS or AC_ROWS_O), then d bias
// = the groups' partials summed in order. `fscratch` holds ac_stats_elems +
// ac_part_elems floats.
template <typename T, class G, int MODE>
static cudaError_t ac_backward(const G& geo, int groups, float* fscratch, float* dbias, cudaStream_t stream) {
  float* stats = fscratch;
  float* part = fscratch + ac_stats_elems(geo.units, geo.nq);
  cudaError_t err = ac_rows<T, G, MODE>(geo, stats, stream);
  if (err != cudaSuccess) return err;
  err = ac_cols<T, G>(geo, stats, groups, part, stream);
  if (err != cudaSuccess) return err;
  return reduce_parts(part, groups, (long long)geo.heads * geo.nq * geo.nk, dbias, stream);
}
