// B14: the residual block y = x + res_scale (conv2(act(conv1(x) + b1)) + b2),
// both 3x3 SAME convolutions of C channels on an NHWC map, act relu or
// leaky relu.
//
// Replaces studiosr_tpu/ops/pallas/conv3x3.py::fused_resblock (kernel
// _resblock_kernel). The TPU kernel keeps a 2-row halo of h1 = act(conv1(x)
// + b1) in VMEM and must zero h1 outside the image before conv2 (act(b1) is
// not zero in the padding); its halo-2 row bands need an even height, and
// the JAX wrapper declines odd ones to two convs. Here the block is two
// passes of conv3x3.cuh, for any height:
// * pass 1: h1 = act(conv1(x) + b1), stored over the image only (a scratch
//   of the map's size and dtype, the rounding point of the TPU kernel);
// * pass 2: conv2 over h1, whose staged patch is zero outside the image,
//   which is exactly the "h1 is zero outside the image" rule, with the
//   epilogue x + res_scale (acc + b2) (x as conv3x3.cuh's skip map).
//
// Bound on the card at SwinFIR's serving shapes (264 x 264, C 180): 2 x 2 T
// 9 C^2 = 81.3 GFLOP against about 50 MB (x read, y written, h1's round trip
// not counted), so bound by operations (0.082 ms). The h1 round trip costs
// one map written and read again; a one-pass version keeping h1's halo in
// shared memory would save it.
#include "conv3x3.cuh"

#define RESBLOCK_ENTRY(NAME, T)                                                                                   \
  extern "C" int NAME(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* h1,   \
                      void* out, int B, int H, int W, int C, int act, float slope, float res_scale, void* stream) { \
    cudaStream_t s = (cudaStream_t)stream;                                                                       \
    cudaError_t err = launch_conv3x3<T>((const T*)x, (const T*)w1, (const float*)b1, nullptr, (T*)h1, B, H, W,  \
                                        C, C, act, slope, 0, 0, s);                                              \
    if (err != cudaSuccess) return (int)err;                                                                     \
    return (int)launch_conv3x3<T>((const T*)h1, (const T*)w2, (const float*)b2, (const T*)x, (T*)out, B, H, W,  \
                                  C, C, ACT_NONE, 0.f, 0, 0, s, nullptr, res_scale);                             \
  }

RESBLOCK_ENTRY(resblock_f32, float)
RESBLOCK_ENTRY(resblock_bf16, __nv_bfloat16)
