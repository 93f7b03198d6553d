// B6's f32 passes written for the H100 (mlp_block_f32.cu's design, in its
// header): the LN row pass, fc1 + GELU and fc2 + residual, each product
// 3xTF32 on wgmma (tf32x3.cuh's tfw_gemm_kernel). Shared by B6 in f32
// (mlp_block_f32.cu) and B10's f32 MLP tail (ocab_f32.cu).
#pragma once

#include "tf32x3.cuh"

constexpr int MF32_MAX_HIDDEN = 512;

struct Mf32Geom {
  int C, hidden, HP;  // HP: hidden padded to 4
  __host__ __device__ Mf32Geom(int C_, int hidden_) : C(C_), hidden(hidden_), HP(tf_pad4(hidden_)) {}
  // the row products' weights (tfw_pack's images): W1 (C x HP), W2 (HP x
  // C); their hi values (the lo ones as many)
  __host__ __device__ long long pack_elems() const { return tfw_elems(C, HP) + tfw_elems(HP, C); }
};

// Pass 0, a warp a row: LN of x, or with EXTRA of x' = x + extra * escale
// (kept in xj, the residual of pass 2).
template <bool EXTRA>
__global__ void __launch_bounds__(256) mf32_ln_kernel(const float* x, const float* extra, const float* escale,
                                                      float* xj, float* ln, const float* ln_w, const float* ln_b,
                                                      long long rows, int C) {
  const int lane = threadIdx.x & 31;
  for (long long row = blockIdx.x * 8LL + (threadIdx.x >> 5); row < rows; row += gridDim.x * 8LL) {
    float4 v[2];
    tf_load_row(x + row * C, C, v);
    if constexpr (EXTRA) {
      float4 e[2];
      tf_load_row(extra + row * C, C, e);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 4 * (lane + 32 * j);
        if (c >= C) continue;
        const float4 s = *reinterpret_cast<const float4*>(escale + c);
        v[j] = make_float4(fmaf(e[j].x, s.x, v[j].x), fmaf(e[j].y, s.y, v[j].y), fmaf(e[j].z, s.z, v[j].z),
                           fmaf(e[j].w, s.w, v[j].w));
        *reinterpret_cast<float4*>(xj + row * C + c) = v[j];
      }
    }
    tf_ln_fwd(v, C, ln_w, ln_b, ln + row * C);
  }
}

// Pass 1's epilogue: g = gelu(acc + b1) (zero past the hidden units).
struct Mf32Gelu {
  static constexpr bool AUX = false;
  float* g;
  const float* b1;
  long long rows;
  int hidden, HP;
  __device__ __forceinline__ void operator()(int, long long r, int c, float v0, float v1, float2) const {
    if (r >= rows || c >= HP) return;
    const float h0 = c < hidden ? v0 + __ldg(b1 + c) : 0.f, h1 = c + 1 < hidden ? v1 + __ldg(b1 + c + 1) : 0.f;
    float c0, p0, c1, p1;
    am_gauss(h0, c0, p0);
    am_gauss(h1, c1, p1);
    *reinterpret_cast<float2*>(g + r * HP + c) = make_float2(h0 * c0, h1 * c1);
  }
};

static bool mf32_geometry_ok(int C, int hidden) {
  return C >= 4 && C <= TF_MAX_C && C % 4 == 0 && hidden >= 1 && hidden <= MF32_MAX_HIDDEN;
}

// The f32 scratch, each region 16-byte aligned: the packed weights; LN rows
// (C), GELU rows (HP) and, with EXTRA, x' rows (C).
struct Mf32Scratch {
  long long pack, ln, g, xj, f_elems;
};

static Mf32Scratch mf32_scratch(long long rows, int C, int hidden, bool extra) {
  const Mf32Geom G(C, hidden);
  Mf32Scratch S;
  auto at = [](long long& o, long long n) {
    const long long r = o;
    o = (o + n + 3) & ~3LL;
    return r;
  };
  long long o = 0;
  S.pack = at(o, 2 * G.pack_elems());
  S.ln = at(o, rows * C);
  S.g = at(o, rows * G.HP);
  S.xj = at(o, extra ? rows * C : 0);
  S.f_elems = o;
  return S;
}

// w1 (C x hidden) and w2 (hidden x C), (in, out) layout, are gathered by
// pack_index.
template <bool EXTRA>
static int mf32_run(const void* x, const void* extra, const void* escale, void* out, int rows, int C, int hidden,
                    const void* ln_w, const void* ln_b, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* dp, int rows_per_sample, const void* pack_index,
                    long long pack_elems, void* fscratch, long long f_elems, void* stream) {
  if (!mf32_geometry_ok(C, hidden) || rows < 1 || (dp && rows_per_sample <= 0)) return (int)cudaErrorInvalidValue;
  const Mf32Geom G(C, hidden);
  const Mf32Scratch S = mf32_scratch(rows, C, hidden, EXTRA);
  if (S.f_elems != f_elems || G.pack_elems() != pack_elems) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || (uintptr_t)out % 16 || (uintptr_t)fscratch % 16 || (uintptr_t)ln_w % 16 ||
      (uintptr_t)ln_b % 16 || (EXTRA && ((uintptr_t)extra % 16 || (uintptr_t)escale % 16)))
    return (int)cudaErrorMisalignedAddress;
  int sms = 0;
  cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  float* f = (float*)fscratch;
  float *ln = f + S.ln, *g = f + S.g, *xj = f + S.xj;
  const long long e1 = tfw_elems(C, G.HP), n1 = (long long)C * hidden;
  float *w1p = f + S.pack, *w2p = w1p + 2 * e1;
  const int* idx = (const int*)pack_index;

  err = tfw_pack((const float*)w1, n1, (const float*)w2, n1, idx, C, G.HP, w1p, st);
  if (err == cudaSuccess) err = tfw_pack((const float*)w1, n1, (const float*)w2, n1, idx + e1, G.HP, C, w2p, st);
  if (err != cudaSuccess) return (int)err;
  mf32_ln_kernel<EXTRA><<<8 * sms, 256, 0, st>>>((const float*)x, (const float*)extra, (const float*)escale, xj, ln,
                                                (const float*)ln_w, (const float*)ln_b, rows, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // g = gelu(LN W1 + b1)
  err = tfw_gemm(TfwGemm{ln, w1p, C, rows, C, G.HP}, Mf32Gelu{g, (const float*)b1, rows, hidden, G.HP}, st);
  if (err != cudaSuccess) return (int)err;
  // y = x + d (g W2 + b2), or x' + (g W2 + b2)
  return (int)tfw_gemm(TfwGemm{g, w2p, G.HP, rows, G.HP, C},
                       TfResid{EXTRA ? xj : (const float*)x, C, (float*)out, (const float*)b2, (const float*)dp, rows,
                               rows_per_sample, C},
                       st);
}
