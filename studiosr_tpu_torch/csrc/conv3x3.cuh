// 3x3 SAME convolution on NHWC maps, as an implicit GEMM.
//
// Shared by B2 (conv3x3.cu), B3 and B4 (upsampler.cu, which store through a
// pixel shuffle) and B11 (cab_body.cu). A thread block owns a TH x TW pixel tile and BN output
// channels. It walks Cin in chunks of KC: the chunk's (TH+2) x (TW+2) input
// patch (zero outside the image: the SAME padding) and its 9 x KC x BN
// weights are staged in shared memory, and the products accumulate in f32.
// The epilogue adds the bias, applies the activation, adds the residual and
// the skip map, and stores once. B11's instantiation (CAB) adds the exact
// GELU and, with `psum` set, has each block write the sums over its tile's
// pixels of every output channel's f32 value (before rounding to T),
// psum[(b * tiles + tile) * Cout + co], summed in a fixed order (no
// atomics), for the caller to reduce deterministically; B2's and B3's
// instantiations compile without either. f32 maps run on the FMA pipes
// (conv3x3_kernel, each thread owning TM pixels x TN channels); bf16 maps
// run on the tensor cores through wmma fragments (conv3x3_wmma_kernel).
//
// Bound on the card: at the main path's shapes (264 x 264 x 180 -> 180) the
// work is 40.6 GFLOP against 76 MB of traffic, so the conv is bound by
// operations (tensor-core bf16 rate). Staging keeps each input and weight
// value read from device memory once per tile; wmma through shared memory,
// with no cp.async/TMA pipelining and a barrier per K chunk, still leaves
// it well above that bound.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

// Activation codes shared with ops/cuda/conv3x3.py (_ACT_CODES); ACT_GELU
// (exact, erf) is B11's and has no Python code.
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LRELU = 2, ACT_GELU = 3 };

constexpr int CONV_THREADS = 256;
constexpr int CONV_KC = 16;

// Where output (b, gy, gx, co) of an H x W x Cout map is stored. shuffle = 0
// stores in place; shuffle = s (2 or 3) stores through pixel_shuffle(s) with
// torch channel order: co = k s^2 + a s + b goes to pixel (s gy + a, s gx + b),
// channel k, of an sH x sW x Cout/s^2 map. s = 2 keeps its shift arithmetic.
__device__ __forceinline__ size_t conv_out_index(int b, int gy, int gx, int co, int H, int W, int Cout,
                                                 int shuffle) {
  if (!shuffle) return (((size_t)b * H + gy) * W + gx) * Cout + co;
  if (shuffle == 2) {
    const int k = co >> 2, sa = (co >> 1) & 1, sb = co & 1;
    return (((size_t)b * 2 * H + 2 * gy + sa) * (2 * W) + 2 * gx + sb) * (Cout >> 2) + k;
  }
  const int s = shuffle, s2 = s * s;
  const int k = co / s2, r = co - k * s2, sa = r / s, sb = r - sa * s;
  return (((size_t)b * s * H + s * gy + sa) * (s * W) + s * gx + sb) * (Cout / s2) + k;
}

template <typename T, int BN, int TN, int TH, int TW, bool CAB>
__global__ void __launch_bounds__(CONV_THREADS) conv3x3_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
    const T* __restrict__ extra, T* __restrict__ out, int H, int W, int Cin, int Cout,
    int act, float slope, int residual, int shuffle, float* __restrict__ psum) {
  constexpr int COLS = BN / TN;             // threads along output channels
  constexpr int ROWS = CONV_THREADS / COLS; // threads along pixels
  constexpr int TM = TH * TW / ROWS;        // pixels per thread
  constexpr int PH = TH + 2, PW = TW + 2;
  constexpr int KC = CONV_KC;
  static_assert(TM * ROWS == TH * TW, "tile must split evenly over threads");
  __shared__ float patch[PH * PW * KC];  // [py][px][kc]
  __shared__ float wsm[9 * KC * BN];     // [tap][kc][n]

  const int tid = threadIdx.x;
  const int cg = tid % COLS, rg = tid / COLS;
  const int tiles_w = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH, x0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const T* xb = x + (size_t)b * H * W * Cin;

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    __syncthreads();
    for (int i = tid; i < PH * PW * KC; i += CONV_THREADS) {
      const int kc = i % KC, p = i / KC;
      const int gy = y0 + p / PW - 1, gx = x0 + p % PW - 1, ci = c0 + kc;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Cin) v = to_f32(xb[((size_t)gy * W + gx) * Cin + ci]);
      patch[i] = v;
    }
    for (int i = tid; i < 9 * KC * BN; i += CONV_THREADS) {
      const int n = i % BN, r = i / BN;
      const int kc = r % KC, tap = r / KC;
      const int ci = c0 + kc, co = co0 + n;
      float v = 0.f;
      if (ci < Cin && co < Cout) v = to_f32(w[((size_t)tap * Cin + ci) * Cout + co]);
      wsm[i] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll 4
      for (int kc = 0; kc < KC; ++kc) {
        float a[TM], bw[TN];
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const int p = rg + ROWS * m;
          a[m] = patch[((p / TW + dy) * PW + (p % TW + dx)) * KC + kc];
        }
#pragma unroll
        for (int n = 0; n < TN; ++n) bw[n] = wsm[(tap * KC + kc) * BN + cg + COLS * n];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], bw[n], acc[m][n]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int p = rg + ROWS * m;
    const int gy = y0 + p / TW, gx = x0 + p % TW;
    if constexpr (CAB) {
      if (gy >= H || gx >= W) {
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;  // out of the map: adds nothing to psum
        continue;
      }
    } else if (gy >= H || gx >= W) {
      continue;
    }
    const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int co = co0 + cg + COLS * n;
      if (co >= Cout) {
        if constexpr (CAB) acc[m][n] = 0.f;
        continue;
      }
      float v = acc[m][n] + bias[co];
      if (act == ACT_RELU) v = fmaxf(v, 0.f);
      else if (act == ACT_LRELU) v = v >= 0.f ? v : slope * v;
      else if (CAB && act == ACT_GELU) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
      if (residual) v += to_f32(x[pix * Cin + co]);
      if (extra) v += to_f32(extra[pix * Cout + co]);
      if constexpr (CAB) acc[m][n] = v;
      out[shuffle ? conv_out_index(b, gy, gx, co, H, W, Cout, shuffle) : pix * Cout + co] = from_f32<T>(v);
    }
  }
  if constexpr (CAB) {
    if (psum) {  // block-uniform
      static_assert(ROWS * BN <= 9 * KC * BN, "the channel partials fit in wsm");
      __syncthreads();  // every thread is done with wsm
      float* red = wsm;  // [rg][n]
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < TM; ++m) s += acc[m][n];
        red[rg * BN + cg + COLS * n] = s;
      }
      __syncthreads();
      for (int n = tid; n < BN; n += CONV_THREADS) {
        float s = 0.f;
        for (int r = 0; r < ROWS; ++r) s += red[r * BN + n];
        if (co0 + n < Cout) psum[((size_t)b * gridDim.x + blockIdx.x) * Cout + co0 + n] = s;
      }
    }
  }
}

// bf16 variant on the tensor cores (wmma 16x16x16, f32 accumulation). The
// tile is TH image rows x 16 pixels x BN channels; warp w owns pixel rows
// w, w + 8, ... and all BN / 16 channel fragments. A row of 16 pixels of
// the staged patch at tap (dy, dx) is a row-major 16 x KC matrix with
// leading dimension KC, so the A fragments load straight from the patch.
// After the K loop the patch and weights are dead and the same shared
// memory holds the f32 accumulator tile for the shared epilogue.
template <int BN, int TH, bool CAB>
__global__ void __launch_bounds__(CONV_THREADS) conv3x3_wmma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ extra, __nv_bfloat16* __restrict__ out, int H, int W, int Cin, int Cout,
    int act, float slope, int residual, int shuffle, float* __restrict__ psum) {
  using namespace nvcuda;
  constexpr int TW = 16, KC = CONV_KC, PH = TH + 2, PW = TW + 2;
  constexpr int NF = BN / 16, MPW = TH / (CONV_THREADS / 32);
  // The staged weights' rows are BN + 8 elements apart so that the 16 rows
  // of a B fragment fall on different banks.
  constexpr int WLD = BN + 8;
  constexpr int PATCH = PH * PW * KC, WSZ = 9 * KC * WLD;
  constexpr int IN_BYTES = (PATCH + WSZ) * 2, OUT_BYTES = TH * TW * BN * 4;
  static_assert(KC == 16 && MPW >= 1 && MPW * (CONV_THREADS / 32) == TH, "wmma tile shape");
  __shared__ __align__(128) unsigned char raw[IN_BYTES > OUT_BYTES ? IN_BYTES : OUT_BYTES];
  __nv_bfloat16* patch = (__nv_bfloat16*)raw;  // [py][px][kc]
  __nv_bfloat16* wsm = patch + PATCH;          // [tap][kc][n], row stride WLD
  float* tile = (float*)raw;                   // [pixel][n], after the K loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int tiles_w = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH, x0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const __nv_bfloat16* xb = x + (size_t)b * H * W * Cin;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MPW][NF];
#pragma unroll
  for (int m = 0; m < MPW; ++m)
#pragma unroll
    for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[m][n], 0.f);

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    __syncthreads();
    for (int i = tid; i < PATCH; i += CONV_THREADS) {
      const int kc = i % KC, p = i / KC;
      const int gy = y0 + p / PW - 1, gx = x0 + p % PW - 1, ci = c0 + kc;
      patch[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Cin) ? xb[((size_t)gy * W + gx) * Cin + ci] : zero;
    }
    for (int i = tid; i < 9 * KC * BN; i += CONV_THREADS) {
      const int n = i % BN, r = i / BN;
      const int ci = c0 + r % KC, co = co0 + n;
      wsm[r * WLD + n] = (ci < Cin && co < Cout) ? w[((size_t)(r / KC) * Cin + ci) * Cout + co] : zero;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[NF];
#pragma unroll
      for (int n = 0; n < NF; ++n) wmma::load_matrix_sync(bf[n], wsm + tap * KC * WLD + n * 16, WLD);
#pragma unroll
      for (int m = 0; m < MPW; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, patch + ((warp + 8 * m + dy) * PW + dx) * KC, KC);
#pragma unroll
        for (int n = 0; n < NF; ++n) wmma::mma_sync(acc[m][n], af, bf[n], acc[m][n]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MPW; ++m)
#pragma unroll
    for (int n = 0; n < NF; ++n)
      wmma::store_matrix_sync(tile + (warp + 8 * m) * TW * BN + n * 16, acc[m][n], BN, wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < TH * TW * BN; e += CONV_THREADS) {
    const int p = e / BN, co = co0 + e % BN;
    const int gy = y0 + p / TW, gx = x0 + p % TW;
    if (gy >= H || gx >= W || co >= Cout) {
      if constexpr (CAB) tile[e] = 0.f;  // out of the map: adds nothing to psum
      continue;
    }
    const size_t pix = ((size_t)b * H + gy) * W + gx;
    float v = tile[e] + bias[co];
    if (act == ACT_RELU) v = fmaxf(v, 0.f);
    else if (act == ACT_LRELU) v = v >= 0.f ? v : slope * v;
    else if (CAB && act == ACT_GELU) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    if (residual) v += to_f32(x[pix * Cin + co]);
    if (extra) v += to_f32(extra[pix * Cout + co]);
    if constexpr (CAB) tile[e] = v;
    out[shuffle ? conv_out_index(b, gy, gx, co, H, W, Cout, shuffle) : pix * Cout + co] = __float2bfloat16(v);
  }
  if constexpr (CAB) {
    if (psum) {  // block-uniform; each thread sums the channels it owns, pixels in order
      __syncthreads();
      for (int n = tid; n < BN; n += CONV_THREADS) {
        float s = 0.f;
        for (int p = 0; p < TH * TW; ++p) s += tile[p * BN + n];
        if (co0 + n < Cout) psum[((size_t)b * gridDim.x + blockIdx.x) * Cout + co0 + n] = s;
      }
    }
  }
}

// Pixel tiles a launch cuts an image into (gridDim.x): wide outputs take
// 8 x 16 pixel tiles, narrow ones (Cout <= 16) 16 x 16.
__host__ inline int conv3x3_pixel_tiles(int H, int W, int Cout) {
  const int th = Cout > 16 ? 8 : 16;
  return ((H + th - 1) / th) * ((W + 15) / 16);
}

// Launch on `stream`; returns cudaGetLastError(). f32 maps take the FMA
// kernel, bf16 maps the tensor-core one. Wide outputs take 8 x 16 pixel
// tiles x 64 channels; narrow ones (conv_last, Cout <= 16) take 16 x 16
// pixel tiles x 16 channels so fewer lanes idle. `shuffle` (0, 2 or 3) is
// conv_out_index's. CAB (B11) admits ACT_GELU and `psum`, B x
// conv3x3_pixel_tiles(H, W, Cout) x Cout f32 channel partials (or null).
template <typename T, bool CAB = false>
cudaError_t launch_conv3x3(const T* x, const T* w, const float* bias, const T* extra, T* out, int B, int H,
                           int W, int Cin, int Cout, int act, float slope, int residual, int shuffle,
                           cudaStream_t stream, float* psum = nullptr) {
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value;
  if (Cout > 16) {
    constexpr int BN = 64, TH = 8, TW = 16;
    dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), (Cout + BN - 1) / BN, B);
    if constexpr (tc)
      conv3x3_wmma_kernel<BN, TH, CAB><<<grid, CONV_THREADS, 0, stream>>>(x, w, bias, extra, out, H, W, Cin, Cout, act,
                                                                     slope, residual, shuffle, psum);
    else
      conv3x3_kernel<T, BN, 4, TH, TW, CAB><<<grid, CONV_THREADS, 0, stream>>>(x, w, bias, extra, out, H, W, Cin, Cout,
                                                                          act, slope, residual, shuffle, psum);
  } else {
    constexpr int BN = 16, TH = 16, TW = 16;
    dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), (Cout + BN - 1) / BN, B);
    if constexpr (tc)
      conv3x3_wmma_kernel<BN, TH, CAB><<<grid, CONV_THREADS, 0, stream>>>(x, w, bias, extra, out, H, W, Cin, Cout, act,
                                                                     slope, residual, shuffle, psum);
    else
      conv3x3_kernel<T, BN, 1, TH, TW, CAB><<<grid, CONV_THREADS, 0, stream>>>(x, w, bias, extra, out, H, W, Cin, Cout,
                                                                          act, slope, residual, shuffle, psum);
  }
  return cudaGetLastError();
}
