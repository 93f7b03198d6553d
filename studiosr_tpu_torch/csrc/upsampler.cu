// B3: the x4 pixelshuffle tail,
//   conv3x3(Cin -> 4 Cin) -> pixel_shuffle(2) -> conv3x3(Cin -> 4 Cin)
//   -> pixel_shuffle(2) -> conv3x3(Cin -> n_colors).
//
// Replaces studiosr_tpu/ops/pallas/upsampler.py::fused_upsample_x4. This is
// the simple version: three launches of the conv kernel of conv3x3.cuh, the
// first two storing through the pixel shuffle (the shuffle folded into the
// store index), the intermediates at 2H x 2W and 4H x 4W in device memory
// in the map dtype (the TPU kernel rounds them to the map dtype too). Each
// conv zero-pads at its own resolution, as the reference chain does. The
// Pallas kernel's quadrant-planar form and subpixel packing were Mosaic
// workarounds.
//
// Bound on the card: 106.6 GFLOP at the main path's shapes (264 x 264 x 64
// in), almost all of it in the second conv, against 16 MB of input and
// output: bound by operations. The intermediates add about 0.36 GB of
// traffic per forward in bf16; a fused launch that recomputes them in
// shared memory over a halo is the design for a later change.
//
// B4: the x2 / x3 pixelshuffle tail,
//   conv3x3(Cin -> s^2 Cin) -> pixel_shuffle(s) -> conv3x3(Cin -> n_colors).
//
// Replaces studiosr_tpu/ops/pallas/upsampler.py::fused_upsample_s. The
// simple version again: two launches of the same conv kernel, the first
// storing c0 through pixel_shuffle(s) (torch channel order) into an
// sH x sW x Cin map in device memory in the map dtype, where the TPU kernel
// rounds it to the map dtype as well; conv_last then zero-pads at sH x sW,
// as the reference chain does. The batch rides the grid (the TPU wrapper
// maps over it).
//
// Bound on the card: at SwinIR's 264 x 264 x 64 input, 20.6 GFLOP (x2) or
// 46.2 GFLOP (x3) in conv0 and under 2.2 in conv_last against under 20 MB of
// input and output: bound by operations. The round trip of c0 through
// device memory (80 MB each way in bf16 at x3) costs about as much as that
// bound; the one-launch design keeps a c0 tile with a one-pixel LR halo in
// shared memory and applies conv_last there.
#include "conv3x3.cuh"

template <typename T>
static cudaError_t upsample_x4(const T* x, const T* w0, const float* b0, const T* w1, const float* b1,
                               const T* w2, const float* b2, T* t1, T* t2, T* out, int B, int H, int W,
                               int Cin, int n_colors, cudaStream_t s) {
  cudaError_t err = launch_conv3x3<T>(x, w0, b0, nullptr, t1, B, H, W, Cin, 4 * Cin, ACT_NONE, 0.f, 0, 2, s);
  if (err != cudaSuccess) return err;
  err = launch_conv3x3<T>(t1, w1, b1, nullptr, t2, B, 2 * H, 2 * W, Cin, 4 * Cin, ACT_NONE, 0.f, 0, 2, s);
  if (err != cudaSuccess) return err;
  return launch_conv3x3<T>(t2, w2, b2, nullptr, out, B, 4 * H, 4 * W, Cin, n_colors, ACT_NONE, 0.f, 0, 0, s);
}

template <typename T>
static cudaError_t upsample_s(const T* x, const T* w0, const float* b0, const T* w2, const float* b2, T* c0,
                              T* out, int B, int H, int W, int Cin, int n_colors, int scale, cudaStream_t s) {
  if (scale != 2 && scale != 3) return cudaErrorInvalidValue;
  cudaError_t err =
      launch_conv3x3<T>(x, w0, b0, nullptr, c0, B, H, W, Cin, scale * scale * Cin, ACT_NONE, 0.f, 0, scale, s);
  if (err != cudaSuccess) return err;
  return launch_conv3x3<T>(c0, w2, b2, nullptr, out, B, scale * H, scale * W, Cin, n_colors, ACT_NONE, 0.f, 0, 0,
                           s);
}

#define UPSAMPLE_ENTRY(NAME, T)                                                                         \
  extern "C" int NAME(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,    \
                      const void* w2, const void* b2, void* t1, void* t2, void* out, int B, int H,      \
                      int W, int Cin, int n_colors, void* stream) {                                     \
    return (int)upsample_x4<T>((const T*)x, (const T*)w0, (const float*)b0, (const T*)w1,               \
                               (const float*)b1, (const T*)w2, (const float*)b2, (T*)t1, (T*)t2,        \
                               (T*)out, B, H, W, Cin, n_colors, (cudaStream_t)stream);                  \
  }

UPSAMPLE_ENTRY(upsample_x4_f32, float)
UPSAMPLE_ENTRY(upsample_x4_bf16, __nv_bfloat16)

#define UPSAMPLE_S_ENTRY(NAME, T)                                                                        \
  extern "C" int NAME(const void* x, const void* w0, const void* b0, const void* w2, const void* b2,     \
                      void* c0, void* out, int B, int H, int W, int Cin, int n_colors, int scale,        \
                      void* stream) {                                                                    \
    return (int)upsample_s<T>((const T*)x, (const T*)w0, (const float*)b0, (const T*)w2,                 \
                              (const float*)b2, (T*)c0, (T*)out, B, H, W, Cin, n_colors, scale,          \
                              (cudaStream_t)stream);                                                     \
  }

UPSAMPLE_S_ENTRY(upsample_s_f32, float)
UPSAMPLE_S_ENTRY(upsample_s_bf16, __nv_bfloat16)
