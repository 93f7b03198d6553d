// B11: HAT's CAB trunk with the squeeze-excite channel sums,
//   y2 = res_scale conv2(gelu(conv1(LN x))),  sums[b, c] = sum over H, W of y2[b, :, :, c],
// x (B, H, W, C), conv1 C -> Cm, conv2 Cm -> C, both 3x3 with zero SAME
// padding of their own input (the LayerNorm output and h1 are zero outside
// the image, as in the reference chain).
//
// Replaces studiosr_tpu/ops/pallas/conv3x3.py::fused_cab_body (kernel
// _cab_kernel). Rounding points follow the TPU kernel: the LN output, h1
// (after GELU) and y2 are rounded to the storage type T; the sums are taken
// in f32 before y2 is rounded. The TPU kernel's row bands with halos and
// their re-zeroed border rows were its way to keep the chain in VMEM; here
// the zero padding is the conv kernel's own.
//
// The geometries csrc/cab_mma.cu's kernels written for the H100 do not take
// run this file (bf16: C odd or above 192, Cm above 64; f32: C not a
// multiple of 4 or above 256, Cm above 64).
//
// Design (simple version, four launches through device memory): a
// LayerNorm pass (one warp per pixel), conv1 with the GELU in its epilogue
// and conv2 with per-tile channel partials in its epilogue (both the conv
// kernel of conv3x3.cuh, tensor cores in bf16), then a reduction of the
// partials, one thread per (image, channel) summing its tiles in order: no
// atomics, so repeated forwards are bitwise equal.
//
// Bound on the card: 2 T 9 C Cm x 2 flops, 25.5 GFLOP at the HAT serving
// shapes (T = 65,536 pixels, C 180, Cm 60) against 47 MB of map traffic:
// bound by operations (0.026 ms). The LN output and h1 round trips add
// about 55 MB in bf16; a version that keeps them on chip over a halo is for
// a later change.
#include "conv3x3.cuh"

// LayerNorm (eps 1e-5) of each pixel row; one warp per row.
template <typename T>
__global__ void __launch_bounds__(256) cab_ln_kernel(const T* __restrict__ x, const float* __restrict__ g,
                                                     const float* __restrict__ b, T* __restrict__ out,
                                                     long long rows, int C) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* row = x + r * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32(row[c]);
  const float mean = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dv = to_f32(row[c]) - mean;
    v += dv * dv;
  }
  const float rstd = rsqrtf(warp_sum(v) / C + 1e-5f);
  for (int c = lane; c < C; c += 32) out[r * C + c] = from_f32<T>((to_f32(row[c]) - mean) * rstd * g[c] + b[c]);
}

// sums[b, c] = sum over the image's tiles, in order, of psum[b, tile, c].
__global__ void cab_sum_kernel(const float* __restrict__ psum, float* __restrict__ sums, int B, int tiles, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += psum[((size_t)b * tiles + t) * C + c];
  sums[i] = s;
}

extern "C" int cab_body_partials(int H, int W, int C) { return conv3x3_pixel_tiles(H, W, C); }

template <typename T>
static cudaError_t cab_body(const T* x, const float* ln_w, const float* ln_b, const T* w1, const float* b1,
                            const T* w2, const float* b2, T* ln, T* h1, float* psum, T* out, float* sums, int B,
                            int H, int W, int C, int Cm, float res_scale, cudaStream_t s) {
  const long long rows = (long long)B * H * W;
  cab_ln_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(x, ln_w, ln_b, ln, rows, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_conv3x3<T, true>(ln, w1, b1, nullptr, h1, B, H, W, C, Cm, ACT_GELU, 0.f, 0, 0, s);
  if (err != cudaSuccess) return err;
  err = launch_conv3x3<T, true>(h1, w2, b2, nullptr, out, B, H, W, Cm, C, ACT_NONE, 0.f, 0, 0, s, psum, res_scale);
  if (err != cudaSuccess) return err;
  cab_sum_kernel<<<(B * C + 255) / 256, 256, 0, s>>>(psum, sums, B, conv3x3_pixel_tiles(H, W, C), C);
  return cudaGetLastError();
}

#define CAB_BODY_ENTRY(NAME, T)                                                                             \
  extern "C" int NAME(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1,    \
                      const void* w2, const void* b2, void* ln, void* h1, void* psum, void* out, void* sums, \
                      int B, int H, int W, int C, int Cm, float res_scale, void* stream) {                  \
    return (int)cab_body<T>((const T*)x, (const float*)ln_w, (const float*)ln_b, (const T*)w1,               \
                            (const float*)b1, (const T*)w2, (const float*)b2, (T*)ln, (T*)h1, (float*)psum,  \
                            (T*)out, (float*)sums, B, H, W, C, Cm, res_scale, (cudaStream_t)stream);         \
  }

CAB_BODY_ENTRY(cab_body_f32, float)
CAB_BODY_ENTRY(cab_body_bf16, __nv_bfloat16)
