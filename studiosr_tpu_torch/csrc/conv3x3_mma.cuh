// B2 in bf16: y = act(conv3x3(x) + b) [+ x] [+ extra] on NHWC maps (zero
// SAME padding, f32 accumulation), an implicit GEMM on mma.sync m16n8k16:
// M = a tile of 8 x 16 pixels, N = the whole Cout (padded to the block's
// width inside the block, so every input patch is staged once), K = 9 Cin in
// stages of 16 input channels.
//
// Replaces studiosr_tpu/ops/pallas/conv3x3.py::fused_conv3x3 (:212) in
// bf16; f32 keeps conv3x3.cuh's FMA kernel. Bound on the card at the main
// path's 264 x 264 x 180 -> 180 map: 40.65 GFLOP against 76 MB, so the
// tensor-core rate (0.041 ms at 989 TFLOP/s). conv3x3.cuh's wmma kernel
// (1.0 ms) was bound by issuing loads: every 16-channel chunk restaged its
// patch and weights with 2-byte loads between two barriers, three channel
// blocks restaged the same patch, and the epilogue went through a 32 KB f32
// tile. Here:
// * a ring of three stages in dynamic shared memory (patch of the tile and
//   its halo x 16 channels, weights 9 taps x 16 x the block's Cout), filled
//   by cp.async; stage s + 2 is in flight while stage s multiplies, one
//   barrier a stage. The patch takes 16-, 8- or 4-byte copies (8 at C =
//   180: a 360-byte pixel row is not 16-byte aligned) that zero-fill outside
//   the image and past Cin. The weights come packed at load time
//   (ops/cuda/conv3x3.py pack_conv3x3_weights): each stage's 9 x 16 x (N +
//   8) block is contiguous, zero-padded and 16-byte aligned, the image of
//   its shared-memory stage, so it is copied in 16-byte pieces (copied from
//   HWIO rows in 8-byte pieces, the weights bounded the kernel).
// * the 9 taps read shifted views of the one staged patch through ldmatrix
//   (a pixel row of 16 channels is 48 bytes apart: eight rows on distinct
//   banks), the weights through transposed ldmatrix (rows Cout + 8 apart);
// * sixteen warps split the pixel tile and the block's 192 output channels
//   (Cout 180 padded inside the block), each holding its m16n8 f32
//   accumulators in registers, so a staged weight serves the whole tile;
// * the epilogue in registers: bias, activation, the res_scale factor (1 for
//   B2; B14's second pass scales its conv by it before x is added), residual
//   and extra read and the result stored as bf16 pairs (4 bytes) where Cout
//   is even.
// The weight stages (57.6 KB of a stage at Cout 180) make one block an SM;
// every block reads all the weights from L2 (0.7 MB a block).
#pragma once

#include "hopper_mma.cuh"

constexpr int CM_KC = 16;                 // input channels a stage: one mma k-step
constexpr int CM_STAGES = 3;              // ring depth
constexpr int CM_PL = CM_KC + 8;          // elements between patch pixels: ldmatrix rows on distinct banks
constexpr int CM_RELU = 1, CM_LRELU = 2;  // activation codes shared with ops/cuda/conv3x3.py

constexpr int CM_BLOCK_N = 192;           // output channels a block: ops/cuda/conv3x3.py packs in blocks of it

struct CmArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;  // packed: (Cout blocks, Cin stages, 9, 16, N + 8), zero-padded
  const float* bias;
  const __nv_bfloat16* extra;  // (B, H, W, Cout) or null
  __nv_bfloat16* out;
  int B, H, W, Cin, Cout, act;
  float slope;
  float res_scale;  // scales act(conv + bias) before residual and extra are added
  int residual;
  int xw;      // copy width (bytes) of x's pixel rows: 16, 8, 4 or 2
  int pairs;   // out, x and extra take 4-byte (bf16 pair) accesses
};

// Block shape: a TH x TW pixel tile, WM x WN warps, each MT m-tiles (16
// pixels of the tile in row-major order) x NT n-tiles (8 output channels).
template <int TH, int TW, int MT, int NT, int WM, int WN>
struct CmShape {
  static constexpr int THREADS = 32 * WM * WN, NP = 8 * NT * WN, WL = NP + 8;  // WL: weight row stride
  static constexpr int PH = TH + 2, PW = TW + 2;                               // the patch, halo included
  static constexpr int PATCH = PH * PW * CM_PL, WTS = 9 * CM_KC * WL, STAGE = PATCH + WTS;  // elements
  static constexpr size_t BYTES = (size_t)CM_STAGES * STAGE * 2;
  static_assert(WM * MT * 16 == TH * TW, "the warps cover the pixel tile");
  static_assert(WTS % 8 == 0 && PATCH % 8 == 0, "stages of whole 16-byte pieces");
  static_assert(NT % 2 == 0, "n-tiles in pairs: one transposed ldmatrix.x4 each");
};

template <int TH, int TW, int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, 1) conv3x3_mma_kernel(const CmArgs a) {
  using S = CmShape<TH, TW, MT, NT, WM, WN>;
  using T = __nv_bfloat16;
  constexpr int NWARPS = WM * WN;
  extern __shared__ __align__(128) unsigned char smem[];
  T* const ring = (T*)smem;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const int wm = warp / WN, wn = warp % WN;
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int tiles_w = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH, x0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * S::NP, b = blockIdx.z;
  const T* const xb = a.x + (size_t)b * H * W * Cin;
  const int nst = (Cin + CM_KC - 1) / CM_KC;
  const T* const wblock = a.w + (size_t)blockIdx.y * nst * S::WTS;

  // Stage s (input channels 16 s ..) into ring slot s % 3, one cp.async
  // group (empty past the last stage).
  auto stage = [&](int s) {
    if (s < nst) {
      T* const P = ring + (s % CM_STAGES) * S::STAGE;
      T* const Wt = P + S::PATCH;
      const int c0 = s * CM_KC;
      auto patch = [&](auto bytes_c) {
        constexpr int BYTES = decltype(bytes_c)::value, E = BYTES / 2, PER = CM_KC / E;
        for (int i = tid; i < S::PH * S::PW * PER; i += S::THREADS) {
          const int px = i / PER, c = (i - px * PER) * E;
          const int gy = y0 - 1 + px / S::PW, gx = x0 - 1 + px % S::PW;
          const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + c < Cin;
          const T* src = ok ? xb + ((size_t)gy * W + gx) * Cin + c0 + c : a.x;
          if constexpr (BYTES >= 4) hm_cp_async<BYTES>(P + px * CM_PL + c, src, ok);
          else P[px * CM_PL + c] = ok ? *src : __float2bfloat16(0.f);
        }
      };
      switch (a.xw) {
        case 16: patch(std::integral_constant<int, 16>{}); break;
        case 8: patch(std::integral_constant<int, 8>{}); break;
        case 4: patch(std::integral_constant<int, 4>{}); break;
        default: patch(std::integral_constant<int, 2>{}); break;
      }
      const T* const ws = wblock + (size_t)s * S::WTS;
      for (int i = tid; i < S::WTS / 8; i += S::THREADS) hm_cp_async<16>(Wt + 8 * i, ws + 8 * i, true);
    }
    hm_cp_commit();
  };

  // The patch pixel of this lane's ldmatrix row in each m-tile (tap 0, 0).
  int arow[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int p = (wm * MT + i) * 16 + (mi & 1) * 8 + (lane & 7);
    arow[i] = (p / TW) * S::PW + p % TW;
  }
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  stage(0);
  stage(1);
  for (int s = 0; s < nst; ++s) {
    hm_cp_wait_upto(CM_STAGES - 2);
    __syncthreads();  // stage s is in; every warp is done with stage s - 1, whose slot takes s + 2
    stage(s + CM_STAGES - 1);
    const T* const P = ring + (s % CM_STAGES) * S::STAGE;
    const T* const Wt = P + S::PATCH;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * S::PW + tap % 3;
      uint32_t bf[NT][2];
      const T* wrow = Wt + (tap * CM_KC + (mi & 1) * 8 + (lane & 7)) * S::WL + wn * NT * 8 + (mi >> 1) * 8;
#pragma unroll
      for (int j = 0; j < NT; j += 2) hm_ldsm_x4_t(bf[j][0], bf[j][1], bf[j + 1][0], bf[j + 1][1], wrow + j * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t af[4];
        hm_ldsm_x4(af[0], af[1], af[2], af[3], P + (arow[i] + shift) * CM_PL + (mi >> 1) * 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) hm_mma(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // epilogue: element (i, j, e) is pixel 16 (wm MT + i) + gq + 8 (e / 2) of
  // the tile, channel co0 + 8 (wn NT + j) + 2 tq + e % 2
  auto finish = [&](float v, int co) {
    v += a.bias[co];
    if (a.act == CM_RELU) v = fmaxf(v, 0.f);
    else if (a.act == CM_LRELU) v = v >= 0.f ? v : a.slope * v;
    return v * a.res_scale;
  };
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = (wm * MT + i) * 16 + gq + 8 * hh;
      const int gy = y0 + p / TW, gx = x0 + p % TW;
      if (gy >= H || gx >= W) continue;
      const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = co0 + (wn * NT + j) * 8 + 2 * tq;
        if (co >= Cout) continue;
        float v0 = finish(acc[i][j][2 * hh], co);
        if (a.pairs) {  // Cout even: co + 1 < Cout
          float v1 = finish(acc[i][j][2 * hh + 1], co + 1);
          if (a.residual) {
            const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.x + pix * Cin + co));
            v0 += r.x, v1 += r.y;
          }
          if (a.extra) {
            const float2 e = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.extra + pix * Cout + co));
            v0 += e.x, v1 += e.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(a.out + pix * Cout + co) = __floats2bfloat162_rn(v0, v1);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (co + e >= Cout) break;
            float v = e ? finish(acc[i][j][2 * hh + 1], co + 1) : v0;
            if (a.residual) v += __bfloat162float(a.x[pix * Cin + co + e]);
            if (a.extra) v += __bfloat162float(a.extra[pix * Cout + co + e]);
            a.out[pix * Cout + co + e] = __float2bfloat16(v);
          }
        }
      }
    }
}

template <int TH, int TW, int MT, int NT, int WM, int WN>
static cudaError_t cm_launch(const CmArgs& a, cudaStream_t stream) {
  using S = CmShape<TH, TW, MT, NT, WM, WN>;
  auto kernel = conv3x3_mma_kernel<TH, TW, MT, NT, WM, WN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW), (a.Cout + S::NP - 1) / S::NP, a.B);
  kernel<<<grid, S::THREADS, S::BYTES, stream>>>(a);
  return cudaGetLastError();
}

// Launch on `stream`; returns cudaGetLastError(). Sixteen warps, 4 along
// pixels x 4 along Cout, each 32 pixels x 48 channels; blocks of 192 output
// channels (more than 192: several along grid y). scripts/
// torch_ablate_b2_b15.py times this shape against 8 warps of 64 x 48 and a
// 6 x 24 tile of 12 warps.
inline cudaError_t launch_conv3x3_mma(const CmArgs& a, cudaStream_t stream) {
  static_assert(CmShape<8, 16, 2, 6, 4, 4>::NP == CM_BLOCK_N, "the packed block width");
  return cm_launch<8, 16, 2, 6, 4, 4>(a, stream);
}
