// B2: fused 3x3 convolution, y = act(conv3x3(x) + b) [+ x] [+ extra].
//
// Replaces studiosr_tpu/ops/pallas/conv3x3.py::fused_conv3x3 (:212). bf16
// runs conv3x3_mma.cuh's kernel (its bound and design are there); f32 with
// Cout > 16 conv3x3_f32.cuh's 3xTF32 kernel on weights packed at load time
// (conv3x3_mma_f32), f32 with Cout <= 16 conv3x3.cuh's FMA kernel
// (conv3x3_f32). The Pallas kernel's 128-lane tap stacking and row-band
// halo operands were Mosaic layout workarounds; here the halo is part of
// the staged patch.
#include "conv3x3.cuh"
#include "conv3x3_f32.cuh"
#include "conv3x3_mma.cuh"

extern "C" int conv3x3_f32(const void* x, const void* w, const void* bias, const void* extra, void* out, int B, int H,
                           int W, int Cin, int Cout, int act, float slope, int residual, void* stream) {
  return (int)launch_conv3x3<float>((const float*)x, (const float*)w, (const float*)bias, (const float*)extra,
                                    (float*)out, B, H, W, Cin, Cout, act, slope, residual, 0, (cudaStream_t)stream);
}

// w: the packed weights of ops/cuda/conv3x3.py pack_conv3x3_f32_weights; Cout > 16.
extern "C" int conv3x3_mma_f32(const void* x, const void* w, const void* bias, const void* extra, void* out, int B,
                               int H, int W, int Cin, int Cout, int act, float slope, int residual, void* stream) {
  return (int)launch_conv3x3_f32((const float*)x, (const float*)w, (const float*)bias, (const float*)extra,
                                 (float*)out, B, H, W, Cin, Cout, act, slope, residual, 0, (cudaStream_t)stream);
}

// Floats of the packed f32 weights (ops/cuda/conv3x3.py checks its own count against it).
extern "C" long long conv3x3_mma_f32_elements(int Cin, int Cout) { return ct_packed_elems(Cin, Cout); }

// w: the packed weights of ops/cuda/conv3x3.py pack_conv3x3_weights.
extern "C" int conv3x3_mma_bf16(const void* x, const void* w, const void* bias, const void* extra, void* out, int B,
                                int H, int W, int Cin, int Cout, int act, float slope, int residual, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || (residual && Cin != Cout)) return (int)cudaErrorInvalidValue;
  CmArgs a;
  a.x = (const __nv_bfloat16*)x;
  a.w = (const __nv_bfloat16*)w;
  a.bias = (const float*)bias;
  a.extra = (const __nv_bfloat16*)extra;
  a.out = (__nv_bfloat16*)out;
  a.B = B, a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout, a.act = act, a.slope = slope, a.residual = residual;
  a.res_scale = 1.f;
  if ((uintptr_t)w % 16) return (int)cudaErrorMisalignedAddress;  // packed stages are copied in 16-byte pieces
  const long long cin = Cin;
  a.xw = hm_copy_width(x, Cin, &cin, 1);
  a.pairs = Cout % 2 == 0 && (uintptr_t)out % 4 == 0 && (uintptr_t)x % 4 == 0 && (uintptr_t)extra % 4 == 0;
  return (int)launch_conv3x3_mma(a, (cudaStream_t)stream);
}
