// B6: the MLP half of a Swin block over token rows with a per-sample
// drop-path scale,
//   y = x + d_{row / rows_per_sample} * fc2(gelu(fc1(LN x))),
// x (rows, C). The forward of fused training's MLP half (ops/mlp_vjp.py).
//
// Replaces studiosr_tpu/ops/pallas/swin_block.py::fused_mlp_block (with
// drop_path / rows_per_sample; its HAT operands extra / extra_scale are not
// part of this port yet). Rounding points follow the TPU kernel: LN output
// and GELU output rounded to the storage type T; sums and LayerNorm
// statistics f32; d scales the f32 delta.
//
// Design: B1's MLP phase on a 64-row tile per block of 256 threads: x, the
// LN output and the 64 x hidden activation in shared memory, fc1 and fc2
// packed once per launch and streamed from L2 by cp.async
// (swin_common.cuh); the activation never leaves the SM. At C 180, hidden
// 360 a bf16 block takes about 108 KB of shared memory: two tiles per SM.
//
// Bound on the card: 4 R C hidden flops, 34 GFLOP per launch at the
// training shapes (R = 131,072 rows, C 180, hidden 360) against 47 MB of
// row traffic: bound by operations. Latency-bound as B1 is.
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

template <typename T>
__global__ void __launch_bounds__(SB_THREADS, 2) mlp_block_kernel(
    const T* __restrict__ x, T* __restrict__ out, int rows, int C, int hidden, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, const float* __restrict__ b1, const float* __restrict__ b2,
    const float* __restrict__ dp, int rows_per_sample, const T* __restrict__ packed) {
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
  layernorm_rows<T>(xs, C, ln_w, ln_b, lnb, LC);
  gemm64<T>(lnb, LC, P.kc, hidden, packed, P.nh, bst, map,
            [&](int r, int n, float acc) { hid[r * LH + n] = from_f32<T>(gelu_f(acc + b1[n])); });
  gemm64<T>(hid, LH, P.kh, C, packed + P.fc2, P.nc, bst, map, [&](int r, int n, float acc) {
    if (r < nrows) {
      const float scale = dp ? dp[(r0 + r) / rows_per_sample] : 1.f;
      out[(r0 + r) * C + n] = from_f32<T>(to_f32(xs[r * C + n]) + scale * (acc + b2[n]));
    }
  });
}

extern "C" long long mlp_block_pack_elems(int C, int hidden) { return mlp_pack_layout(C, hidden).total; }

template <typename T>
static cudaError_t mlp_block(const T* x, T* out, int rows, int C, int hidden, const float* ln_w, const float* ln_b,
                             const T* w1, const float* b1, const T* w2, const float* b2, const float* dp,
                             int rows_per_sample, T* packed, long long pack_elems, cudaStream_t stream) {
  const MlpPack P = mlp_pack_layout(C, hidden);
  if (P.total != pack_elems || (dp && rows_per_sample <= 0)) return cudaErrorInvalidValue;
  const std::vector<PackSeg> segs{PackSeg{w1, 0, P.nh, C, hidden, hidden, 1},
                                  PackSeg{w2, P.fc2, P.nc, hidden, C, C, 1}};
  cudaError_t err = pack_segments(segs, packed, (size_t)P.total, stream);
  if (err != cudaSuccess) return err;
  const MlpSmem L = mlp_smem_layout(C, hidden, sizeof(T));
  err = allow_smem(mlp_block_kernel<T>, L.total);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + SB_TOK - 1) / SB_TOK;
  mlp_block_kernel<T><<<blocks, SB_THREADS, L.total, stream>>>(x, out, rows, C, hidden, ln_w, ln_b, b1, b2, dp,
                                                              rows_per_sample, packed);
  return cudaGetLastError();
}

#define MLP_BLOCK_ENTRY(NAME, T)                                                                               \
  extern "C" int NAME(const void* x, void* out, int rows, int C, int hidden, const void* ln_w, const void* ln_b, \
                      const void* w1, const void* b1, const void* w2, const void* b2, const void* dp,           \
                      int rows_per_sample, void* packed, long long pack_elems, void* stream) {                  \
    return (int)mlp_block<T>((const T*)x, (T*)out, rows, C, hidden, (const float*)ln_w, (const float*)ln_b,     \
                             (const T*)w1, (const float*)b1, (const T*)w2, (const float*)b2, (const float*)dp,  \
                             rows_per_sample, (T*)packed, pack_elems, (cudaStream_t)stream);                    \
  }

MLP_BLOCK_ENTRY(mlp_block_f32, float)
MLP_BLOCK_ENTRY(mlp_block_bf16, __nv_bfloat16)
