// B7: the backward of B6 (mlp_block.cu) with the forward recomputed,
//   y = x + d * fc2(gelu(fc1(LN x))),  d = dp[row / rows_per_sample]:
// from x and the cotangent g it emits dx and the f32 gradients of the LN
// scale and bias, fc1 (W1, b1) and fc2 (W2, b2).
//
// At the widths the kernels written for the H100 do not take (f32 runs
// mlp_bwd_f32.cu at C a multiple of 4 up to 256, bf16 mlp_bwd_mma.cu at C a
// multiple of 4 up to 184 and hidden up to 512),
// replaces studiosr_tpu/ops/pallas/mlp_vjp.py::_bwd (reached through
// _dp_bwd): the branch cotangent is g_b = d g rounded to T, dx = g_b +
// LN-backward(dln) + (1 - d) g. Rounding points follow the TPU kernel: LN
// output, GELU output, dh1 and g_b in T; products accumulate in f32;
// LayerNorm statistics and the LN backward are f32.
//
// Design, three passes, all on the launch's stream:
// 1. per 64-row tile (one block of 256 threads): dg1 = g_b W2^T, the
//    recomputed LN and h1 = LN W1 + b1, dh1 = dg1 gelu'(h1), dln = dh1 W1^T
//    and dx, with dg1/dh1 (64 x hidden, f32) and the LN output in shared
//    memory. The tile writes LN, g_b, gelu(h1) and dh1 (in T) to a scratch
//    and its own f32 partial sums of dln xhat and dln (dLN scale, bias).
// 2. the weight gradients dW1 = LN^T dh1, dW2 = gelu(h1)^T g_b and the bias
//    gradients (column sums) over all rows (wgrad.cuh);
// 3. the partials summed in a fixed order: deterministic, no atomics.
// The TPU kernel accumulates its partial dW blocks along a sequential
// grid; on the card blocks run in no order, hence the scratch and the
// second pass.
//
// Bound on the card: 2 R C hidden (3 products in pass 1) + 4 R C hidden
// (pass 2), 85 GFLOP per launch at the training shapes (R = 131,072, C
// 180, hidden 360) against 94 MB of traffic for x, g and dx: bound by
// operations. The scratch adds about 0.6 GB of traffic at those shapes;
// this first version is bound by that and by latency.
#include "wgrad.cuh"

struct MlpBwdSmem {
  size_t r1, dg, mean, rstd, dscale, bst, total;
  int ld_c, ld_g;
};

__host__ __device__ inline MlpBwdSmem mlp_bwd_smem_layout(int C, int hidden, size_t tsz) {
  MlpBwdSmem L;
  L.ld_c = pad32(C) + SB_SKEW;
  L.ld_g = pad32(hidden) + SB_SKEW;  // f32 elements; rows stay 32-byte aligned
  const size_t r1 = SB_TOK * L.ld_c * tsz, dln = SB_TOK * C * sizeof(float);
  size_t o = 0;
  L.r1 = o;  // g_b (T), then the LN output (T), then dln (f32)
  o = align32(o + (r1 > dln ? r1 : dln));
  L.dg = o;  // dg1, then dh1 (f32), then dh1 in T written over it
  o = align32(o + SB_TOK * L.ld_g * sizeof(float));
  L.mean = o;
  o = align32(o + SB_TOK * sizeof(float));
  L.rstd = o;
  o = align32(o + SB_TOK * sizeof(float));
  L.dscale = o;
  o = align32(o + SB_TOK * sizeof(float));
  L.bst = o;
  L.total = o + 2 * SB_KC * SB_BL * tsz;
  return L;
}

// Packed weights: W2^T kc x nh, W1 kc x nh, W1^T kh x nc.
struct MlpBwdPack {
  int kc, kh, nc, nh;
  long long w1, w1t, total;
};

__host__ __device__ inline MlpBwdPack mlp_bwd_pack_layout(int C, int hidden) {
  MlpBwdPack P;
  P.kc = pad32(C);
  P.kh = pad32(hidden);
  P.nc = pad64(C);
  P.nh = pad64(hidden);
  P.w1 = (long long)P.kc * P.nh;
  P.w1t = 2 * P.w1;
  P.total = P.w1t + (long long)P.kh * P.nc;
  return P;
}

// Scratch in T: LN, g_b (tiles * 64 rows of pad8(C) each), gelu(h1), dh1
// (tiles * 64 rows of pad8(hidden) each), the packed weights, and the slack
// wgrad.cuh reads past its last tile.
struct MlpBwdScratch {
  long long rows64, ln, gb, g1, dh1, pack, t_elems;
  long long stats, part, f_elems;  // f32: per-tile (dLN scale, bias) sums, wgrad partials
};

__host__ inline MlpBwdScratch mlp_bwd_scratch_layout(int rows, int C, int hidden) {
  MlpBwdScratch S;
  const long long tiles = (rows + SB_TOK - 1) / SB_TOK;
  S.rows64 = tiles * SB_TOK;
  S.ln = 0;
  S.gb = S.ln + S.rows64 * pad8(C);
  S.g1 = S.gb + S.rows64 * pad8(C);
  S.dh1 = S.g1 + S.rows64 * pad8(hidden);
  S.pack = S.dh1 + S.rows64 * pad8(hidden);
  S.t_elems = S.pack + mlp_bwd_pack_layout(C, hidden).total + 2 * WG_BM;
  const long long p1 = wgrad_plan(S.rows64, C, hidden).part_elems, p2 = wgrad_plan(S.rows64, hidden, C).part_elems;
  S.stats = 0;
  S.part = tiles * 2 * C;
  S.f_elems = S.part + (p1 > p2 ? p1 : p2);
  return S;
}

template <typename T>
__global__ void __launch_bounds__(SB_THREADS) mlp_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx, int rows, int C, int hidden,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, const float* __restrict__ b1,
    const float* __restrict__ dp, int rows_per_sample, const T* __restrict__ packed, T* __restrict__ ln_out,
    T* __restrict__ gb_out, T* __restrict__ g1_out, T* __restrict__ dh1_out, float* __restrict__ stats) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpBwdSmem L = mlp_bwd_smem_layout(C, hidden, sizeof(T));
  const MlpBwdPack P = mlp_bwd_pack_layout(C, hidden);
  T* r1t = (T*)(smem + L.r1);
  float* dln = (float*)(smem + L.r1);
  float* dg = (float*)(smem + L.dg);
  T* dgt = (T*)(smem + L.dg);
  float* mean = (float*)(smem + L.mean);
  float* rstd = (float*)(smem + L.rstd);
  float* dscale = (float*)(smem + L.dscale);
  T* bst = (T*)(smem + L.bst);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int LC = L.ld_c, LG = L.ld_g, LGT = L.ld_g * (int)(sizeof(float) / sizeof(T));
  const int SC = pad8(C), SH = pad8(hidden);  // scratch row strides
  const long long r0 = (long long)blockIdx.x * SB_TOK;
  const int nrows = rows - r0 < SB_TOK ? (int)(rows - r0) : SB_TOK;

  // Rows past the end take d = 0 and x = 0: they add nothing to any sum.
  if (tid < SB_TOK) dscale[tid] = tid < nrows ? (dp ? dp[(r0 + tid) / rows_per_sample] : 1.f) : 0.f;
  __syncthreads();
  for (int i = tid; i < SB_TOK * C; i += SB_THREADS) {
    const int r = i / C, c = i - r * C;
    const float gv = r < nrows ? to_f32(g[r0 * C + i]) : 0.f;
    const T v = from_f32<T>(dscale[r] * gv);
    r1t[r * LC + c] = v;
    gb_out[(r0 + r) * SC + c] = v;
  }
  zero_columns(r1t, LC, C, P.kc);
  const FragMap map = frag_map_for<T>((float*)bst);
  __syncthreads();
  // dg1 = g_b W2^T
  gemm64<T>(r1t, LC, P.kc, hidden, packed, P.nh, bst, map, [&](int r, int n, float acc) { dg[r * LG + n] = acc; });

  // LN output over g_b's rows (zero columns past C stay zero)
  for (int r = warp; r < SB_TOK; r += SB_THREADS / 32) {
    float mu = 0.f, rs = rsqrtf(1e-5f);
    if (r < nrows) row_stats(x + (r0 + r) * C, C, mu, rs);
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
    for (int c = lane; c < C; c += 32) {
      const float xv = r < nrows ? to_f32(x[(r0 + r) * C + c]) : 0.f;
      const T v = from_f32<T>((xv - mu) * rs * ln_w[c] + ln_b[c]);
      r1t[r * LC + c] = v;
      ln_out[(r0 + r) * SC + c] = v;
    }
  }
  // h1 = LN W1 + b1; gelu(h1) out; dh1 = dg1 gelu'(h1) in place
  gemm64<T>(r1t, LC, P.kc, hidden, packed + P.w1, P.nh, bst, map, [&](int r, int n, float acc) {
    const float h = acc + b1[n];
    g1_out[(r0 + r) * SH + n] = from_f32<T>(gelu_f(h));
    dg[r * LG + n] *= gelu_grad_f(h);
  });
  // dh1 to T, in place (row r of the T view starts where row r of dg does;
  // a warp reads a 512-column chunk whole before it writes it), and out.
  for (int r = warp; r < SB_TOK; r += SB_THREADS / 32) {
    for (int c0 = 0; c0 < hidden; c0 += 512) {
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + lane + 32 * j;
        v[j] = c < hidden ? dg[r * LG + c] : 0.f;
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < hidden) {
          const T t = from_f32<T>(v[j]);
          dgt[r * LGT + c] = t;
          dh1_out[(r0 + r) * SH + c] = t;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
  zero_columns(dgt, LGT, hidden, P.kh);
  // dln = dh1 W1^T (f32, over the LN output's bytes)
  gemm64<T>(dgt, LGT, P.kh, C, packed + P.w1t, P.nc, bst, map,
            [&](int r, int n, float acc) { dln[r * C + n] = acc; });

  // LN backward: dx = g_b + (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) rstd + (1 - d) g
  for (int r = warp; r < nrows; r += SB_THREADS / 32) {
    const T* xr = x + (r0 + r) * C;
    const T* gr = g + (r0 + r) * C;
    const float mu = mean[r], rs = rstd[r], dd = dscale[r];
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
      dx[(r0 + r) * C + c] = from_f32<T>(gbv + (dxh - m1 - xh * m2) * rs + (1.f - dd) * gv);
    }
  }
  // this tile's sums of dln xhat and dln
  for (int c = tid; c < C; c += SB_THREADS) {
    float sw = 0.f, sb = 0.f;
    for (int r = 0; r < nrows; ++r) {
      const float dl = dln[r * C + c];
      sw += dl * (to_f32(x[(r0 + r) * C + c]) - mean[r]) * rstd[r];
      sb += dl;
    }
    stats[blockIdx.x * 2LL * C + c] = sw;
    stats[blockIdx.x * 2LL * C + C + c] = sb;
  }
}

extern "C" void mlp_bwd_scratch(int rows, int C, int hidden, long long* t_elems, long long* f_elems) {
  const MlpBwdScratch S = mlp_bwd_scratch_layout(rows, C, hidden);
  *t_elems = S.t_elems;
  *f_elems = S.f_elems;
}

template <typename T>
static cudaError_t mlp_bwd(const T* x, const T* g, T* dx, int rows, int C, int hidden, const float* ln_w,
                           const float* ln_b, const T* w1, const float* b1, const T* w2, const float* dp,
                           int rows_per_sample, float* ds_db, float* dw1, float* db1, float* dw2, float* db2,
                           T* tscratch, long long t_elems, float* fscratch, long long f_elems, cudaStream_t stream) {
  const MlpBwdScratch S = mlp_bwd_scratch_layout(rows, C, hidden);
  const MlpBwdPack P = mlp_bwd_pack_layout(C, hidden);
  if (S.t_elems != t_elems || S.f_elems != f_elems || (dp && rows_per_sample <= 0)) return cudaErrorInvalidValue;
  const std::vector<PackSeg> segs{PackSeg{w2, 0, P.nh, C, hidden, 1, C},
                                  PackSeg{w1, P.w1, P.nh, C, hidden, hidden, 1},
                                  PackSeg{w1, P.w1t, P.nc, hidden, C, 1, hidden}};
  T* packed = tscratch + S.pack;
  cudaError_t err = pack_segments(segs, packed, (size_t)P.total, stream);
  if (err != cudaSuccess) return err;
  const MlpBwdSmem L = mlp_bwd_smem_layout(C, hidden, sizeof(T));
  err = allow_smem(mlp_bwd_kernel<T>, L.total);
  if (err != cudaSuccess) return err;
  const int tiles = (int)(S.rows64 / SB_TOK);
  T *ln = tscratch + S.ln, *gb = tscratch + S.gb, *g1 = tscratch + S.g1, *dh1 = tscratch + S.dh1;
  mlp_bwd_kernel<T><<<tiles, SB_THREADS, L.total, stream>>>(x, g, dx, rows, C, hidden, ln_w, ln_b, b1, dp,
                                                           rows_per_sample, packed, ln, gb, g1, dh1,
                                                           fscratch + S.stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = reduce_parts(fscratch + S.stats, tiles, 2LL * C, ds_db, stream);
  if (err != cudaSuccess) return err;
  const int SC = pad8(C), SH = pad8(hidden);
  err = wgrad(ln, SC, dh1, SH, S.rows64, C, hidden, dw1, db1, fscratch + S.part, stream);
  if (err != cudaSuccess) return err;
  return wgrad(g1, SH, gb, SC, S.rows64, hidden, C, dw2, db2, fscratch + S.part, stream);
}

#define MLP_BWD_ENTRY(NAME, T)                                                                                  \
  extern "C" int NAME(const void* x, const void* g, void* dx, int rows, int C, int hidden, const void* ln_w,     \
                      const void* ln_b, const void* w1, const void* b1, const void* w2, const void* dp,          \
                      int rows_per_sample, void* ds_db, void* dw1, void* db1, void* dw2, void* db2,              \
                      void* tscratch, long long t_elems, void* fscratch, long long f_elems, void* stream) {      \
    return (int)mlp_bwd<T>((const T*)x, (const T*)g, (T*)dx, rows, C, hidden, (const float*)ln_w,               \
                           (const float*)ln_b, (const T*)w1, (const float*)b1, (const T*)w2, (const float*)dp,  \
                           rows_per_sample, (float*)ds_db, (float*)dw1, (float*)db1, (float*)dw2, (float*)db2,   \
                           (T*)tscratch, t_elems, (float*)fscratch, f_elems, (cudaStream_t)stream);             \
  }

MLP_BWD_ENTRY(mlp_bwd_f32, float)
MLP_BWD_ENTRY(mlp_bwd_bf16, __nv_bfloat16)
