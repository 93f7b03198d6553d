// The 3x3 SAME convolution in f32 for Cout > 16, written for the H100:
//   y = res_scale act(conv3x3(x) + b) [+ x] [+ extra]
// on NHWC maps, the store in place or through pixel_shuffle(s)
// (conv3x3.cuh conv_out_index). An implicit GEMM on wgmma's tf32 form,
// every product in 3xTF32 (tf32x3.cuh).
//
// Replaces conv3x3.cuh's FMA kernel (conv3x3_kernel) for f32 maps with
// Cout > 16: B2 (conv3x3.cu conv3x3_mma_f32, for
// studiosr_tpu/ops/pallas/conv3x3.py::fused_conv3x3 :212), the wide passes
// of B3 and B4 (upsampler.cu, upsampler.py:274 and :487), both passes of
// B14 (resblock.cu, conv3x3.py:266) and both convs of B11 (cab_mma.cu
// cab_body_mma_f32, conv3x3.py:393: the CAB instantiation, below). conv_last
// (Cout <= 16: 3 colours, one 96-column tile would be 97 % padding) keeps
// the FMA kernel.
//
// B11's instantiation (CAB): N tiles of BN = 64 (conv1, Cm <= 64 padded to
// 64, not 96, which would waste a third) or 96 (conv2); conv1's epilogue
// adds b1, takes the exact erf GELU and stores h1 at ostride channels a
// pixel, zero past Cm; conv2's adds b2, scales by res_scale, stores y2 and
// takes each column's f32 sum over the tile's pixels in a fixed order (a
// thread's two pixels, the warp's by shuffles, then the twelve warps in
// order through shared memory) into part[b, tile, c]: no atomics.
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
constexpr int CT_SLOTS = 3;                      // weight ring slots: stages s + 1 and s + 2 in flight under s
constexpr int CT_WARPS = CT_THREADS / 32;

// Floats of a weight slot of an N tile of BN columns: the hi image, then
// the lo image.
template <int BN>
__host__ __device__ constexpr int ct_wstage() {
  return 2 * BN * CT_KC;
}

// The patch buffers, the ring and (CAB) the warps' column sums.
template <int BN, bool CAB>
__host__ __device__ constexpr size_t ct_smem() {
  return (size_t)(2 * CT_PATCH + CT_SLOTS * ct_wstage<BN>()) * 4 + (CAB ? (size_t)CT_WARPS * BN * 4 : 0);
}

// Floats of the packed weights of B2's 96-column tiles: (N tiles, Cin
// chunks, 9 taps, hi | lo image of 32 x 96). ops/cuda/conv3x3.py
// packed_conv3x3_f32_shape mirrors it.
__host__ inline long long ct_packed_elems(int Cin, int Cout) {
  return (long long)((Cout + CT_BN - 1) / CT_BN) * ((Cin + CT_KC - 1) / CT_KC) * 9 * ct_wstage<CT_BN>();
}

// Pixel tiles of an H x W map: a conv's blockIdx.x, B11's partials' middle
// dimension.
__host__ __device__ inline int ct_pixel_tiles(int H, int W) {
  return ((H + CT_TH - 1) / CT_TH) * ((W + CT_TW - 1) / CT_TW);
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
  float* part;  // CAB conv2: (B, tiles, Cout) column sums of out; null in conv1
  int ostride;  // CAB conv1: channels a pixel of out (>= Cout, zero past Cout)
};

__device__ __forceinline__ float ct_gelu(float v) { return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)); }

// B11's epilogues of a thread's accumulators (pixels (gy, gx) and (gy, gx +
// 8), channels n0 + 8 nt + 2 t + e): conv1 (a.part null) h1 = gelu(acc +
// b1) at a.ostride channels a pixel, zero past Cout; conv2 y2 = res_scale
// (acc + b2) and the tile's column sums of y2 into a.part, through `red`
// (CT_WARPS x BN floats). Called by every thread of the block.
template <int BN>
__device__ __forceinline__ void ct_cab_epilogue(const CtArgs& a, const float (&acc)[BN / 2], float* red, int gy,
                                                int gx0, int n0, int b) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int H = a.H, W = a.W, Cout = a.Cout;
  float cs[BN / 8][2];
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) cs[nt][0] = cs[nt][1] = 0.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gx = gx0 + 8 * hh;
    const bool in = gy < H && gx < W;
    const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = n0 + 8 * nt + 2 * t + e;
        const float v = acc[4 * nt + 2 * hh + e];
        if (a.part) {
          if (co >= Cout) continue;
          const float y = (v + __ldg(a.bias + co)) * a.res_scale;
          if (in) {
            cs[nt][e] += y;
            a.out[pix * Cout + co] = y;
          }
        } else if (in && co < a.ostride) {
          a.out[pix * a.ostride + co] = co < Cout ? ct_gelu(v + __ldg(a.bias + co)) : 0.f;
        }
      }
  }
  if (!a.part) return;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = cs[nt][e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) red[warp * BN + 8 * nt + 2 * t + e] = s;
    }
  __syncthreads();
  if (tid < BN && n0 + tid < Cout) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < CT_WARPS; ++w) s += red[w * BN + tid];
    a.part[((size_t)b * gridDim.x + blockIdx.x) * Cout + n0 + tid] = s;
  }
}

// XW: bytes a patch copy (16, 8 or 4: what x's rows allow); BN: the N
// tile; CAB: B11's epilogues (above).
template <int XW, int BN = CT_BN, bool CAB = false>
__global__ void __launch_bounds__(CT_THREADS, 1) ct_conv_kernel(const CtArgs a) {
  constexpr int E = XW / 4, PIECES = CT_KC / E;  // floats a copy; copies a pixel
  constexpr int WSTAGE = ct_wstage<BN>(), WPIECES = WSTAGE / 4;
  static_assert(CAB || BN == CT_BN, "the plain convs run 96-column tiles");
  extern __shared__ __align__(128) float csm[];
  float* const patch0 = csm;                 // two patch buffers
  float* const ring = csm + 2 * CT_PATCH;    // the weight slots
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int prow = warp;                     // this warp's pixel row of the tile (warpgroup warp >> 2: rows 4 wg ..)
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int tiles_w = (W + CT_TW - 1) / CT_TW;
  const int y0 = (blockIdx.x / tiles_w) * CT_TH, x0 = (blockIdx.x % tiles_w) * CT_TW;
  const int n0 = blockIdx.y * BN, b = blockIdx.z;
  const float* const xb = a.x + (size_t)b * H * W * Cin;
  const int chunks = (Cin + CT_KC - 1) / CT_KC, nst = 9 * chunks;
  const float* const wtile = a.w + (size_t)blockIdx.y * nst * WSTAGE;

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
      const float* const src = wtile + (size_t)s * WSTAGE;
      float* const dst = ring + (s % CT_SLOTS) * WSTAGE;
#pragma unroll
      for (int j = 0; j < (WPIECES + CT_THREADS - 1) / CT_THREADS; ++j) {
        const int i = tid + CT_THREADS * j;
        if (WPIECES % CT_THREADS == 0 || i < WPIECES) hm_cp_async<16>(dst + 4 * i, src + 4 * i, true);
      }
    }
    hm_cp_commit();
  };

  float acc[BN / 2] = {}, part[BN / 2];
#pragma unroll
  for (int s = 0; s < CT_SLOTS - 1; ++s) load(s);
  for (int s = 0; s < nst; ++s) {
    hm_cp_wait_upto(CT_SLOTS - 2);
    wg_proxy_fence();  // this thread's copies, seen by wgmma
    __syncthreads();   // stage s is in; every warp is done with stage s - 1, whose slot the next load refills
    load(s + CT_SLOTS - 1);
    const int chunk = s / 9, tap = s - 9 * chunk, dy = tap / 3, dx = tap - 3 * dy;
    const float* const sb = ring + (s % CT_SLOTS) * WSTAGE;
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
      const uint64_t bh = wg_desc(sb + 64 * kk, 128, 1024), bl = wg_desc(sb + BN * CT_KC + 64 * kk, 128, 1024);
      tfw_rs<BN>(part, al[kk], bh, kk > 0);
      tfw_rs<BN>(part, ah[kk], bl, 1);
      tfw_rs<BN>(part, ah[kk], bh, 1);
    }
    wg_commit();
    wg_wait0();
    wg_hold<BN / 2>(part);
    wg_hold<16>(&ah[0][0]);
    wg_hold<16>(&al[0][0]);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  }
  hm_cp_wait_upto(0);

  // epilogue: accumulator (nt, hh, e) is pixel (prow, g + 8 hh) of the
  // tile, channel n0 + 8 nt + 2 t + e
  if constexpr (CAB) {
    ct_cab_epilogue<BN>(a, acc, csm + 2 * CT_PATCH + CT_SLOTS * WSTAGE, y0 + prow, x0 + g, n0, b);
  } else {
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
}

template <int XW, int BN = CT_BN, bool CAB = false>
static cudaError_t ct_launch(const CtArgs& a, int B, cudaStream_t stream) {
  constexpr size_t bytes = ct_smem<BN, CAB>();
  cudaError_t err = allow_smem(ct_conv_kernel<XW, BN, CAB>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)ct_pixel_tiles(a.H, a.W), (unsigned)((a.Cout + BN - 1) / BN), (unsigned)B);
  ct_conv_kernel<XW, BN, CAB><<<grid, CT_THREADS, bytes, stream>>>(a);
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
  const CtArgs a{x, w, bias, extra, out, H, W, Cin, Cout, act, slope, res_scale, residual, shuffle, nullptr, Cout};
  if (Cin % 4 == 0 && (uintptr_t)x % 16 == 0) return ct_launch<16>(a, B, stream);
  if (Cin % 2 == 0 && (uintptr_t)x % 8 == 0) return ct_launch<8>(a, B, stream);
  return ct_launch<4>(a, B, stream);
}
