// The 3x3 SAME convolution in f32 for Cout > 16, written for the H100:
//   y = res_scale act(conv3x3(x) + b) [+ x] [+ extra]
// on NHWC maps, the store in place or through pixel_shuffle(s)
// (conv3x3.cuh conv_out_index). An implicit GEMM on wgmma's tf32 form,
// every product in 3xTF32 (tf32x3.cuh).
//
// Replaces conv3x3.cuh's FMA kernel (conv3x3_kernel) for f32 maps with
// Cout > 16 in every caller but B11: B2 (conv3x3.cu conv3x3_mma_f32, for
// studiosr_tpu/ops/pallas/conv3x3.py::fused_conv3x3 :212), the wide passes
// of B3 and B4 (upsampler.cu, upsampler.py:274 and :487) and both passes of
// B14 (resblock.cu, conv3x3.py:266). conv_last (Cout <= 16: 3 colours, one
// 96-column tile would be 97 % padding) keeps the FMA kernel, and so does
// B11's CAB instantiation (GELU and the channel partials), cab_body.cu.
//
// Bound on the card at the main path's 264 x 264 x 180 -> 180 map: 2 T 9
// Cin Cout = 40.65 GFLOP against 76 MB, so operations: 0.2465 ms at 3xTF32
// (164.9 TFLOP/s), 0.608 on the FMA pipes. conv3x3_kernel ran each
// thread's 4 x 4 outputs on the FMA pipes, restaged its patch and weights
// by ordinary loads every 16 input channels between two barriers, and staged
// the patch again for each of three 64-channel blocks. Here:
// * M is a tile of 12 x 16 pixels, three warpgroups of 4 x 16 (a warp one
//   row of 16 pixels: wgmma's 16 rows), N a 96-column tile of Cout (a block;
//   Cout 180 is two), K = 9 taps x Cin in stages of one tap x 32 input
//   channels (32 K rows, each stage's 12 products in a fresh accumulator
//   added to the running f32 sum: the TF_BK rule of tf32x3.cuh).
// * The A side: the tile's (12 + 2) x (16 + 2) patch x 32 channels is
//   staged by cp.async (zero outside the image and past Cin: the SAME
//   padding) once for the chunk's nine taps, two patch buffers so the next
//   chunk's loads run under this one's; each warp reads its A fragments for
//   a tap from the patch shifted by the tap (pixel rows 36 floats apart:
//   conflict-free) and splits them hi / lo in registers.
// * The B side: the weights' hi and lo K-major images are packed at load
//   time (ops/cuda/conv3x3.py pack_conv3x3_f32_weights): per N tile, chunk
//   and tap the two 32 x 96 images of a ring slot in tfw_image's order,
//   zero past Cin and Cout, copied as they lie through a ring of three
//   slots, two stages ahead.
// * The epilogue in registers: bias, activation, res_scale, residual and
//   extra, each value stored once where it lands (the shuffle by
//   conv_out_index).
// One block an SM (three warpgroups, 146 KB of shared memory, up to 168
// registers a thread): a staged weight serves 192 pixels, and three
// warpgroups' products queue on the tensor pipes between two barriers.
// What bounds it (scripts/torch_ablate_f32_serving.py, ms at the main
// path's shape, full 0.69): one TF32 term a product instead of three 0.45,
// no weight loads 0.67, no patch loads 0.65, so mostly the tensor pipes;
// two warpgroups (an 8 x 16 tile) took 0.79.
#pragma once

#include "conv3x3.cuh"
#include "tf32x3.cuh"

constexpr int CT_WG = 3;                      // warpgroups a block
constexpr int CT_TH = 4 * CT_WG, CT_TW = 16;  // the pixel tile: a warpgroup 4 x 16, a warp one row of 16
constexpr int CT_THREADS = 128 * CT_WG;
constexpr int CT_BN = 96;                     // output channels a block (one wgmma N tile)
constexpr int CT_KC = TF_BK;                  // input channels a chunk: one 32-row K stage a tap
constexpr int CT_PL = CT_KC + 4;              // floats between patch pixels: conflict-free fragment loads
constexpr int CT_PH = CT_TH + 2, CT_PW = CT_TW + 2;
constexpr int CT_PATCH = CT_PH * CT_PW * CT_PL;  // floats of a patch buffer
constexpr int CT_WSTAGE = 2 * CT_BN * CT_KC;     // floats of a weight slot: the hi image, then the lo image
constexpr int CT_SLOTS = 3;                      // weight ring slots: stages s + 1 and s + 2 in flight under s
constexpr size_t CT_SMEM = (size_t)(2 * CT_PATCH + CT_SLOTS * CT_WSTAGE) * 4;

// Floats of the packed weights: (N tiles, Cin chunks, 9 taps, hi | lo
// image of 32 x 96). ops/cuda/conv3x3.py packed_conv3x3_f32_shape mirrors it.
__host__ inline long long ct_packed_elems(int Cin, int Cout) {
  return (long long)((Cout + CT_BN - 1) / CT_BN) * ((Cin + CT_KC - 1) / CT_KC) * 9 * CT_WSTAGE;
}

struct CtArgs {
  const float* x;      // (B, H, W, Cin)
  const float* w;      // packed (ct_packed_elems)
  const float* bias;   // (Cout)
  const float* extra;  // (B, H, W, Cout) or null
  float* out;
  int H, W, Cin, Cout, act;
  float slope, res_scale;
  int residual, shuffle;
};

// XW: bytes a patch copy (16, 8 or 4: what x's rows allow).
template <int XW>
__global__ void __launch_bounds__(CT_THREADS, 1) ct_conv_kernel(const CtArgs a) {
  constexpr int E = XW / 4, PIECES = CT_KC / E;  // floats a copy; copies a pixel
  extern __shared__ __align__(128) float csm[];
  float* const patch0 = csm;                 // two patch buffers
  float* const ring = csm + 2 * CT_PATCH;    // the weight slots
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int prow = warp;                     // this warp's pixel row of the tile (warpgroup warp >> 2: rows 4 wg ..)
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int tiles_w = (W + CT_TW - 1) / CT_TW;
  const int y0 = (blockIdx.x / tiles_w) * CT_TH, x0 = (blockIdx.x % tiles_w) * CT_TW;
  const int n0 = blockIdx.y * CT_BN, b = blockIdx.z;
  const float* const xb = a.x + (size_t)b * H * W * Cin;
  const int chunks = (Cin + CT_KC - 1) / CT_KC, nst = 9 * chunks;
  const float* const wtile = a.w + (size_t)blockIdx.y * nst * CT_WSTAGE;

  // stage s (chunk s / 9, tap s % 9): its weight slot and, at tap 0, the
  // chunk's patch; one cp.async group (empty past the last stage)
  auto load = [&](int s) {
    if (s < nst) {
      const int chunk = s / 9, tap = s - 9 * chunk;
      if (tap == 0) {
        float* const P = patch0 + (chunk & 1) * CT_PATCH;
        const int c0 = chunk * CT_KC;
        for (int i = tid; i < CT_PH * CT_PW * PIECES; i += CT_THREADS) {
          const int px = i / PIECES, c = (i - px * PIECES) * E;
          const int gy = y0 - 1 + px / CT_PW, gx = x0 - 1 + px % CT_PW;
          const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + c < Cin;
          hm_cp_async<XW>(P + px * CT_PL + c, ok ? xb + ((size_t)gy * W + gx) * Cin + c0 + c : a.x, ok);
        }
      }
      const float* const src = wtile + (size_t)s * CT_WSTAGE;
      float* const dst = ring + (s % CT_SLOTS) * CT_WSTAGE;
#pragma unroll
      for (int j = 0; j < CT_WSTAGE / 4 / CT_THREADS; ++j) {
        const int i = tid + CT_THREADS * j;
        hm_cp_async<16>(dst + 4 * i, src + 4 * i, true);
      }
    }
    hm_cp_commit();
  };

  float acc[CT_BN / 2] = {}, part[CT_BN / 2];
#pragma unroll
  for (int s = 0; s < CT_SLOTS - 1; ++s) load(s);
  for (int s = 0; s < nst; ++s) {
    hm_cp_wait_upto(CT_SLOTS - 2);
    wg_proxy_fence();  // this thread's copies, seen by wgmma
    __syncthreads();   // stage s is in; every warp is done with stage s - 1, whose slot the next load refills
    load(s + CT_SLOTS - 1);
    const int chunk = s / 9, tap = s - 9 * chunk, dy = tap / 3, dx = tap - 3 * dy;
    const float* const sb = ring + (s % CT_SLOTS) * CT_WSTAGE;
    // A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of k-step kk: pixels
    // g and g + 8 of this warp's row shifted by the tap, channels 8 kk + t, + 4
    const float* const pa = patch0 + (chunk & 1) * CT_PATCH + ((prow + dy) * CT_PW + dx + g) * CT_PL + t;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float av[4] = {pa[8 * kk], pa[8 * CT_PL + 8 * kk], pa[8 * kk + 4], pa[8 * CT_PL + 8 * kk + 4]};
      tf_split4(av, ah[kk], al[kk]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bh = wg_desc(sb + 64 * kk, 128, 1024), bl = wg_desc(sb + CT_BN * CT_KC + 64 * kk, 128, 1024);
      tfw_rs<CT_BN>(part, al[kk], bh, kk > 0);
      tfw_rs<CT_BN>(part, ah[kk], bl, 1);
      tfw_rs<CT_BN>(part, ah[kk], bh, 1);
    }
    wg_commit();
    wg_wait0();
    wg_hold<CT_BN / 2>(part);
    wg_hold<16>(&ah[0][0]);
    wg_hold<16>(&al[0][0]);
#pragma unroll
    for (int i = 0; i < CT_BN / 2; ++i) acc[i] += part[i];
  }
  hm_cp_wait_upto(0);

  // epilogue: accumulator (nt, hh, e) is pixel (prow, g + 8 hh) of the
  // tile, channel n0 + 8 nt + 2 t + e
  const int gy = y0 + prow;
  if (gy >= H) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gx = x0 + g + 8 * hh;
    if (gx >= W) continue;
    const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
    for (int nt = 0; nt < CT_BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = n0 + 8 * nt + 2 * t + e;
        if (co >= Cout) continue;
        float v = acc[4 * nt + 2 * hh + e] + __ldg(a.bias + co);
        if (a.act == ACT_RELU) v = fmaxf(v, 0.f);
        else if (a.act == ACT_LRELU) v = v >= 0.f ? v : a.slope * v;
        v *= a.res_scale;
        if (a.residual) v += __ldg(a.x + pix * Cin + co);
        if (a.extra) v += __ldg(a.extra + pix * Cout + co);
        a.out[a.shuffle ? conv_out_index(b, gy, gx, co, H, W, Cout, a.shuffle) : pix * Cout + co] = v;
      }
  }
}

template <int XW>
static cudaError_t ct_launch(const CtArgs& a, int B, cudaStream_t stream) {
  cudaError_t err = allow_smem(ct_conv_kernel<XW>, CT_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(((a.H + CT_TH - 1) / CT_TH) * ((a.W + CT_TW - 1) / CT_TW)),
                  (unsigned)((a.Cout + CT_BN - 1) / CT_BN), (unsigned)B);
  ct_conv_kernel<XW><<<grid, CT_THREADS, CT_SMEM, stream>>>(a);
  return cudaGetLastError();
}

// Launch on `stream`: out = res_scale act(conv(x, w) + bias) [+ x] [+ extra]
// with w packed for (Cin, Cout); Cout > 16, shuffle 0, 2 or 3 (Cout a
// multiple of shuffle^2). Returns cudaGetLastError().
static cudaError_t launch_conv3x3_f32(const float* x, const float* w, const float* bias, const float* extra,
                                      float* out, int B, int H, int W, int Cin, int Cout, int act, float slope,
                                      int residual, int shuffle, cudaStream_t stream, float res_scale = 1.f) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout <= 16 || (residual && Cin != Cout) ||
      (shuffle && (shuffle < 2 || shuffle > 3 || Cout % (shuffle * shuffle))))
    return cudaErrorInvalidValue;
  if ((uintptr_t)w % 16) return cudaErrorMisalignedAddress;  // the packed slots are copied in 16-byte pieces
  const CtArgs a{x, w, bias, extra, out, H, W, Cin, Cout, act, slope, res_scale, residual, shuffle};
  if (Cin % 4 == 0 && (uintptr_t)x % 16 == 0) return ct_launch<16>(a, B, stream);
  if (Cin % 2 == 0 && (uintptr_t)x % 8 == 0) return ct_launch<8>(a, B, stream);
  return ct_launch<4>(a, B, stream);
}
