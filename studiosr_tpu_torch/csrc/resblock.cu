// B14: the residual block y = x + res_scale (conv2(act(conv1(x) + b1)) + b2),
// both 3x3 SAME convolutions of C channels on an NHWC map, act relu or
// leaky relu.
//
// Replaces studiosr_tpu/ops/pallas/conv3x3.py::fused_resblock (kernel
// _resblock_kernel). The TPU kernel keeps a 2-row halo of h1 = act(conv1(x)
// + b1) in VMEM and must zero h1 outside the image before conv2 (act(b1) is
// not zero in the padding); its halo-2 row bands need an even height, and
// the JAX wrapper declines odd ones to two convs. Here the block is two
// passes of a 3x3 conv kernel, for any height:
// * pass 1: h1 = act(conv1(x) + b1), stored over the image only (a scratch
//   of the map's size and dtype, the rounding point of the TPU kernel);
// * pass 2: conv2 over h1, whose staged patch is zero outside the image,
//   which is exactly the "h1 is zero outside the image" rule, with the
//   epilogue x + res_scale (acc + b2) (x as the skip map).
// bf16 (resblock_mma_bf16) runs both passes on conv3x3_mma.cuh, B2's kernel
// written for the H100 (its design is there), on weights packed at load time
// by ops/cuda/conv3x3.py pack_conv3x3_weights; pass 2 takes x as its extra
// map and res_scale in the epilogue. f32 with C > 16 (resblock_mma_f32,
// SwinFIR's f32 serving) runs both passes on conv3x3_f32.cuh's 3xTF32
// kernel (its design is there) on weights packed at load time by
// ops/cuda/conv3x3.py pack_conv3x3_f32_weights; f32 with C <= 16
// (resblock_f32) keeps two passes of conv3x3.cuh's FMA kernel on HWIO.
//
// Bound on the card at SwinFIR's serving shapes (264 x 264, C 180): 2 x 2 T
// 9 C^2 = 81.3 GFLOP against about 50 MB (x read, y written, h1's round trip
// not counted), so bound by operations (0.082 ms). The h1 round trip costs
// one map written and read again (25 MB at 264 x 264 x 180, L2-sized); a
// one-pass version keeping h1's halo in shared memory would save it.
// Measured on an H100 (PERF.md, PR 8): bf16 0.413-0.431 ms at that shape
// (two passes of about 0.21 ms), cuDNN's two convs 0.54. -Xptxas -v
// (sm_90a): the bf16 passes run B2's conv3x3_mma_kernel, 128 registers, 28
// B spilled.
#include "conv3x3.cuh"
#include "conv3x3_f32.cuh"
#include "conv3x3_mma.cuh"

extern "C" int resblock_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* h1,
                            void* out, int B, int H, int W, int C, int act, float slope, float res_scale,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_conv3x3<float>((const float*)x, (const float*)w1, (const float*)b1, nullptr, (float*)h1,
                                          B, H, W, C, C, act, slope, 0, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_conv3x3<float>((const float*)h1, (const float*)w2, (const float*)b2, (const float*)x,
                                    (float*)out, B, H, W, C, C, ACT_NONE, 0.f, 0, 0, s, nullptr, res_scale);
}

// w1, w2: the packed weights of ops/cuda/conv3x3.py pack_conv3x3_f32_weights; C > 16.
extern "C" int resblock_mma_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* h1,
                                void* out, int B, int H, int W, int C, int act, float slope, float res_scale,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_conv3x3_f32((const float*)x, (const float*)w1, (const float*)b1, nullptr, (float*)h1, B, H,
                                      W, C, C, act, slope, 0, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_conv3x3_f32((const float*)h1, (const float*)w2, (const float*)b2, (const float*)x, (float*)out,
                                 B, H, W, C, C, ACT_NONE, 0.f, 0, 0, s, res_scale);
}

// w1, w2: the packed weights of ops/cuda/conv3x3.py pack_conv3x3_weights.
extern "C" int resblock_mma_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* h1, void* out, int B, int H, int W, int C, int act, float slope,
                                 float res_scale, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)w1 % 16 || (uintptr_t)w2 % 16) return (int)cudaErrorMisalignedAddress;
  const long long c = C;
  cudaStream_t s = (cudaStream_t)stream;
  CmArgs a;
  a.x = (const __nv_bfloat16*)x;
  a.w = (const __nv_bfloat16*)w1;
  a.bias = (const float*)b1;
  a.extra = nullptr;
  a.out = (__nv_bfloat16*)h1;
  a.B = B, a.H = H, a.W = W, a.Cin = C, a.Cout = C, a.act = act, a.slope = slope, a.res_scale = 1.f;
  a.residual = 0;
  a.xw = hm_copy_width(x, C, &c, 1);
  a.pairs = C % 2 == 0 && (uintptr_t)h1 % 4 == 0 && (uintptr_t)x % 4 == 0;
  cudaError_t err = launch_conv3x3_mma(a, s);
  if (err != cudaSuccess) return (int)err;
  a.x = (const __nv_bfloat16*)h1;
  a.w = (const __nv_bfloat16*)w2;
  a.bias = (const float*)b2;
  a.extra = (const __nv_bfloat16*)x;
  a.out = (__nv_bfloat16*)out;
  a.act = 0, a.slope = 0.f, a.res_scale = res_scale;
  a.xw = hm_copy_width(h1, C, &c, 1);
  a.pairs = C % 2 == 0 && (uintptr_t)out % 4 == 0 && (uintptr_t)h1 % 4 == 0 && (uintptr_t)x % 4 == 0;
  return (int)launch_conv3x3_mma(a, s);
}
