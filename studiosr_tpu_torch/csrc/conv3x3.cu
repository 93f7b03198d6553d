// B2: fused 3x3 convolution, y = act(conv3x3(x) + b) [+ x] [+ extra].
//
// Replaces studiosr_tpu/ops/pallas/conv3x3.py::fused_conv3x3. The kernel
// itself, its bound and its design are in conv3x3.cuh. The Pallas kernel's
// 128-lane tap stacking and row-band halo operands were Mosaic layout
// workarounds; here the halo is part of the staged patch.
#include "conv3x3.cuh"

#define CONV3X3_ENTRY(NAME, T)                                                                         \
  extern "C" int NAME(const void* x, const void* w, const void* bias, const void* extra, void* out,    \
                      int B, int H, int W, int Cin, int Cout, int act, float slope, int residual,      \
                      void* stream) {                                                                  \
    return (int)launch_conv3x3<T>((const T*)x, (const T*)w, (const float*)bias, (const T*)extra,       \
                                  (T*)out, B, H, W, Cin, Cout, act, slope, residual, 0,                \
                                  (cudaStream_t)stream);                                               \
  }

CONV3X3_ENTRY(conv3x3_f32, float)
CONV3X3_ENTRY(conv3x3_bf16, __nv_bfloat16)
