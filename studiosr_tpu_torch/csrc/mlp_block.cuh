// B6, the MLP half of a Swin block over token rows with a per-sample
// drop-path scale,
//   y = x + d_{row / rows_per_sample} * fc2(gelu(fc1(LN x))),
// x (rows, C): the forward of fused training's MLP half (ops/mlp_vjp.py),
// and the MLP tail of B10 (ocab.cu: f32, and the bf16 geometries
// ocab_mma.cu does not take). Or, with HAT's CAB join folded in
// (EXTRA, HAT serving at batch 1),
//   x' = x + extra * escale (escale per channel, f32),
//   y = x' + fc2(gelu(fc1(LN x'))),
// the residual the f32 x', not a re-rounded one.
//
// Replaces studiosr_tpu/ops/pallas/swin_block.py::fused_mlp_block
// (_mlp_kernel) at the widths the kernels written for the H100 do not take
// (mlp_block_mma.cu in bf16, mlp_block_f32.cu in f32: C not a multiple of
// 4 or above 184 / 256, hidden above 512), and in B10's f32 tail. Rounding
// points follow the TPU kernel: LN output and GELU output rounded to the
// storage type T; sums and LayerNorm statistics f32; d scales the f32
// delta.
//
// Design: B1's MLP phase on a 64-row tile per block of 256 threads: x, the
// LN output and the 64 x hidden activation in shared memory, fc1 and fc2
// packed once per launch and streamed from L2 by cp.async
// (swin_common.cuh); the activation never leaves the SM. At C 180, hidden
// 360 a bf16 block takes about 108 KB of shared memory: two tiles per SM.
//
// Bound on the card: 4 R C hidden flops, 34 GFLOP per launch at the
// training shapes (R = 131,072 rows, C 180, hidden 360) against 47 MB of
// row traffic: bound by operations. Latency-bound as B1 is. With EXTRA at
// the HAT serving shapes (65,536 rows) the work halves and the extra map's
// read is one more map of traffic: 17.0 GFLOP against 70.8 MB, bound by
// bytes (0.021 ms).
#pragma once

#include "swin_common.cuh"

struct MlpSmem {
  size_t xs, lnb, hid, bst, total;
  int ld_c, ld_h;
};

__host__ __device__ inline MlpSmem mlp_smem_layout(int C, int hidden, size_t tsz) {
  MlpSmem L;
  L.ld_c = pad32(C) + SB_SKEW;
  L.ld_h = pad32(hidden) + SB_SKEW;
  size_t o = 0;
  L.xs = o;
  o = align32(o + SB_TOK * C * tsz);
  L.lnb = o;
  o = align32(o + SB_TOK * L.ld_c * tsz);
  L.hid = o;
  o = align32(o + SB_TOK * L.ld_h * tsz);
  L.bst = o;
  L.total = o + 2 * SB_KC * SB_BL * tsz;
  return L;
}

// Packed weights: fc1 kc x nh, then fc2 kh x nc.
struct MlpPack {
  int kc, kh, nc, nh;
  long long fc2, total;
};

__host__ __device__ inline MlpPack mlp_pack_layout(int C, int hidden) {
  MlpPack P;
  P.kc = pad32(C);
  P.kh = pad32(hidden);
  P.nc = pad64(C);
  P.nh = pad64(hidden);
  P.fc2 = (long long)P.kc * P.nh;
  P.total = P.fc2 + (long long)P.kh * P.nc;
  return P;
}

// x' = x + extra * escale of row r of the tile at column c, in f32 (one
// fused multiply-add, the same wherever it is recomputed).
template <typename T>
__device__ __forceinline__ float joined(const T* xs, const T* extra, const float* escale, int C, int r, int c) {
  return fmaf(to_f32(extra[(size_t)r * C + c]), escale[c], to_f32(xs[r * C + c]));
}

// LayerNorm (eps 1e-5) of the tile's rows of x' = x + extra * escale (rows
// past nrows: of x, which is zero there) into out (stride ldo); one warp
// per row. `extra` points at the tile's first row.
template <typename T>
__device__ void layernorm_rows_joined(const T* xs, const T* extra, const float* escale, int nrows, int C,
                                      const float* g, const float* b, T* out, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < SB_TOK; r += SB_THREADS / 32) {
    auto at = [&](int c) { return r < nrows ? joined(xs, extra, escale, C, r, c) : to_f32(xs[r * C + c]); };
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += at(c);
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dv = at(c) - mean;
      v += dv * dv;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + 1e-5f);
    for (int c = lane; c < C; c += 32) out[r * ldo + c] = from_f32<T>((at(c) - mean) * rstd * g[c] + b[c]);
  }
}

// EXTRA: HAT's CAB join, x' = x + extra * escale before the LayerNorm and as
// the residual (f32, not re-rounded); the extra rows are read from L2 where
// needed rather than staged, so the tile keeps B6's shared memory. With
// EXTRA false this is B6 as it was.
template <typename T, bool EXTRA>
__global__ void __launch_bounds__(SB_THREADS, 2) mlp_block_kernel(
    const T* __restrict__ x, T* __restrict__ out, int rows, int C, int hidden, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, const float* __restrict__ b1, const float* __restrict__ b2,
    const float* __restrict__ dp, int rows_per_sample, const T* __restrict__ packed,
    const T* __restrict__ extra, const float* __restrict__ escale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpSmem L = mlp_smem_layout(C, hidden, sizeof(T));
  const MlpPack P = mlp_pack_layout(C, hidden);
  T* xs = (T*)(smem + L.xs);
  T* lnb = (T*)(smem + L.lnb);
  T* hid = (T*)(smem + L.hid);
  T* bst = (T*)(smem + L.bst);
  const int LC = L.ld_c, LH = L.ld_h;
  const long long r0 = (long long)blockIdx.x * SB_TOK;
  const int nrows = rows - r0 < SB_TOK ? (int)(rows - r0) : SB_TOK;

  for (int i = threadIdx.x; i < SB_TOK * C; i += SB_THREADS) {
    const int r = i / C;
    xs[i] = r < nrows ? x[r0 * C + i] : from_f32<T>(0.f);
  }
  zero_columns(lnb, LC, C, P.kc);
  zero_columns(hid, LH, hidden, P.kh);
  const FragMap map = frag_map_for<T>((float*)bst);  // bst is free until the first staged chunk
  __syncthreads();
  const T* ext = EXTRA ? extra + r0 * C : nullptr;
  if constexpr (EXTRA)
    layernorm_rows_joined<T>(xs, ext, escale, nrows, C, ln_w, ln_b, lnb, LC);
  else
    layernorm_rows<T>(xs, C, ln_w, ln_b, lnb, LC);
  gemm64<T>(lnb, LC, P.kc, hidden, packed, P.nh, bst, map,
            [&](int r, int n, float acc) { hid[r * LH + n] = from_f32<T>(gelu_f(acc + b1[n])); });
  gemm64<T>(hid, LH, P.kh, C, packed + P.fc2, P.nc, bst, map, [&](int r, int n, float acc) {
    if (r < nrows) {
      if constexpr (EXTRA) {
        out[(r0 + r) * C + n] = from_f32<T>(joined(xs, ext, escale, C, r, n) + (acc + b2[n]));
      } else {
        const float scale = dp ? dp[(r0 + r) / rows_per_sample] : 1.f;
        out[(r0 + r) * C + n] = from_f32<T>(to_f32(xs[r * C + n]) + scale * (acc + b2[n]));
      }
    }
  });
}

// Pack fc1 and fc2 into `packed` and launch the kernel on `stream`.
template <typename T, bool EXTRA>
static cudaError_t mlp_block(const T* x, T* out, int rows, int C, int hidden, const float* ln_w, const float* ln_b,
                             const T* w1, const float* b1, const T* w2, const float* b2, const float* dp,
                             int rows_per_sample, const T* extra, const float* escale, T* packed,
                             long long pack_elems, cudaStream_t stream) {
  const MlpPack P = mlp_pack_layout(C, hidden);
  if (P.total != pack_elems || (dp && rows_per_sample <= 0) || (EXTRA && (!extra || !escale || dp)))
    return cudaErrorInvalidValue;
  const std::vector<PackSeg> segs{PackSeg{w1, 0, P.nh, C, hidden, hidden, 1},
                                  PackSeg{w2, P.fc2, P.nc, hidden, C, C, 1}};
  cudaError_t err = pack_segments(segs, packed, (size_t)P.total, stream);
  if (err != cudaSuccess) return err;
  const MlpSmem L = mlp_smem_layout(C, hidden, sizeof(T));
  err = allow_smem(mlp_block_kernel<T, EXTRA>, L.total);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + SB_TOK - 1) / SB_TOK;
  mlp_block_kernel<T, EXTRA><<<blocks, SB_THREADS, L.total, stream>>>(x, out, rows, C, hidden, ln_w, ln_b, b1, b2,
                                                                     dp, rows_per_sample, packed, extra, escale);
  return cudaGetLastError();
}

