// B3: the x4 pixelshuffle tail,
//   conv3x3(Cin -> 4 Cin) -> pixel_shuffle(2) -> conv3x3(Cin -> 4 Cin)
//   -> pixel_shuffle(2) -> conv3x3(Cin -> n_colors).
// B4: the x2 / x3 pixelshuffle tail,
//   conv3x3(Cin -> s^2 Cin) -> pixel_shuffle(s) -> conv3x3(Cin -> n_colors).
//
// Replace studiosr_tpu/ops/pallas/upsampler.py::fused_upsample_x4 (:274) and
// ::fused_upsample_s (:487). Each conv zero-pads at its own resolution, as
// the reference chain does, and the intermediates (2H x 2W and 4H x 4W at
// x4, sH x sW at x2 / x3) are rounded to the map dtype in device memory, as
// the TPU kernel rounds them. The batch rides the grid. The Pallas kernel's
// quadrant-planar packing and manual halo DMA were Mosaic workarounds.
//
// Bound on the card at SwinIR's 264 x 264 x 64 input: B3 is 106.6 GFLOP
// (conv0 20.6, conv1 82.2, conv_last 3.9) against 16 MB of input and
// output, B4 21.5 (x2) / 48.4 (x3): bound by operations, 0.108 / 0.022 /
// 0.049 ms at the bf16 tensor-core rate.
//
// f32 runs one launch a conv, the shuffle folded into the store index: the
// wide convs (s^2 Cin > 16) on conv3x3_f32.cuh's 3xTF32 kernel on weights
// packed at load time (upsample_x4_mma_f32, upsample_s_mma_f32; its design
// is there), conv_last (n_colors <= 16) on conv3x3.cuh's FMA kernel on
// HWIO; narrower tails keep conv3x3.cuh's kernel for every conv
// (upsample_x4_f32, upsample_s_f32).
// Its bf16 wmma kernel (three launches a B3 call: 2.6 ms, 25x the bound)
// was bound by issuing loads: 2-byte staging loads between two barriers a
// 16-channel chunk. bf16 runs the kernels written for the H100:
//
// * upsample_conv_kernel (conv0, conv1): an implicit GEMM on wgmma, A and B
//   both read from shared memory by descriptor. A block owns a 16 x 8 UP_MT
//   pixel tile; its (tile + halo) x Cin patch is staged once, in planes of
//   8 channels (K zero-padded to 64), so each 8 x 8 pixel m-tile shifted by
//   a tap is a K-major wgmma operand (core matrix: 8 pixels of a row x 16
//   bytes; LBO one plane, SBO one patch row) and the 9 taps need no im2col.
//   Two warpgroups, one per 8-row half of the tile, each UP_MT m64 tiles.
//   The weights (9 x 64 x s^2 64: 295 KB at x4, more than shared memory
//   holds) stream through a 4-slot cp.async ring, one tap of one NC-column
//   chunk a slot, packed at load time as the image of a slot (ops/cuda/
//   upsampler.py pack_shuffle_conv_weights), so every staged weight serves
//   the whole tile. The ring runs across chunks, so the next chunk's taps
//   load during a chunk's epilogue; one barrier a tap, and a tap's wgmmas
//   stay in flight while the next tap's are issued.
// * the pixel shuffle in the epilogue: the packer orders the columns (i, j,
//   c) instead of torch's (c, i, j), so 8 columns are 8 channels of one
//   subpixel plane. Each warp rounds 8 pixels x NC columns (bias added, read
//   in torch's order) into a padded shared buffer and copies them out 16
//   bytes a lane, consecutive lanes on consecutive bytes of the HR map
//   (512 contiguous bytes a store at x2 / x4).
// * UP_MT 1 and two blocks an SM: one block's epilogue (its stores are
//   bound by device memory, every block of a wave storing at once) runs
//   beside the other's products. scripts/torch_ablate_upsampler.py times it
//   against a 16 x 16 tile at one block an SM and a 3-slot ring.
// * upsample_last_kernel (conv_last, Cout = n_colors <= 8): mma.sync
//   m16n8k16 with N 8, not a block padded to 64 or more columns. A block
//   stages an (8 + 2) x (32 + 2) x Cin patch and the packed weights (mma's
//   B fragments in lane order, pack_conv_last_weights) by cp.async; each
//   warp runs two 16-pixel row segments, one ldmatrix.x4 and one 8-byte
//   fragment load a tap and k-step. It reads the HR map (143 MB at x4) once
//   from device memory: bound by bytes. Fusing it into conv1's launch would
//   save that map's round trip but recompute a one-pixel HR halo (PERF.md §6
//   says why it was not taken).
#include <initializer_list>

#include "conv3x3.cuh"
#include "conv3x3_f32.cuh"
#include "hopper_mma.cuh"
#include "wgmma.cuh"

// -- f32: the simple version ---------------------------------------------------

static cudaError_t upsample_x4_f32_passes(const float* x, const float* w0, const float* b0, const float* w1,
                                          const float* b1, const float* w2, const float* b2, float* t1, float* t2,
                                          float* out, int B, int H, int W, int Cin, int n_colors, cudaStream_t s) {
  cudaError_t err = launch_conv3x3<float>(x, w0, b0, nullptr, t1, B, H, W, Cin, 4 * Cin, ACT_NONE, 0.f, 0, 2, s);
  if (err != cudaSuccess) return err;
  err = launch_conv3x3<float>(t1, w1, b1, nullptr, t2, B, 2 * H, 2 * W, Cin, 4 * Cin, ACT_NONE, 0.f, 0, 2, s);
  if (err != cudaSuccess) return err;
  return launch_conv3x3<float>(t2, w2, b2, nullptr, out, B, 4 * H, 4 * W, Cin, n_colors, ACT_NONE, 0.f, 0, 0, s);
}

static cudaError_t upsample_s_f32_passes(const float* x, const float* w0, const float* b0, const float* w2,
                                         const float* b2, float* c0, float* out, int B, int H, int W, int Cin,
                                         int n_colors, int scale, cudaStream_t s) {
  if (scale != 2 && scale != 3) return cudaErrorInvalidValue;
  cudaError_t err =
      launch_conv3x3<float>(x, w0, b0, nullptr, c0, B, H, W, Cin, scale * scale * Cin, ACT_NONE, 0.f, 0, scale, s);
  if (err != cudaSuccess) return err;
  return launch_conv3x3<float>(c0, w2, b2, nullptr, out, B, scale * H, scale * W, Cin, n_colors, ACT_NONE, 0.f, 0,
                               0, s);
}

// -- bf16: the kernels written for the H100 -------------------------------------

constexpr int UP_WG = 2;                  // warpgroups a block: one per 8-row half of the pixel tile
constexpr int UP_THREADS = 128 * UP_WG;
constexpr int UP_K = 64;                  // K a tap: Cin, a multiple of 16 up to 64, zero-padded to 64
constexpr int UP_MT = 1;                  // 8 x 8 m-tiles a warpgroup: the tile is 16 x 8 UP_MT pixels
constexpr int UP_MIN_BLOCKS = UP_MT == 1 ? 2 : 1;  // blocks an SM (registers: 64 or 128 accumulators a thread)
constexpr int UP_STAGES = 4;                       // weight ring: one tap of one column chunk a slot
constexpr int UL_TH = 8, UL_TW = 32, UL_THREADS = 256;  // conv_last: tile rows x columns, one row a warp
constexpr int UL_MIN_BLOCKS = 2;          // conv_last blocks an SM at least (58 KB of shared memory each at Cin 64)
constexpr int UL_MAX_COLORS = 8;          // conv_last's N: one mma n-tile

// Columns a chunk: ops/cuda/upsampler.py _CHUNK mirrors it.
template <int S>
struct UpChunk {
  static constexpr int NC = S == 2 ? 128 : 96;
};

struct UpArgs {
  const __nv_bfloat16* x;  // (B, H, W, Cin)
  const __nv_bfloat16* w;  // packed: (chunks, 9, 8, NC / 8, 8, 8), columns (i, j, c), zero past S^2 Cin and Cin
  const float* bias;       // (S^2 Cin), torch's channel order c S^2 + i S + j
  __nv_bfloat16* out;      // (B, S H, S W, Cin)
  int H, W, Cin;
};

// Bytes of one 8-channel plane of the patch: 16 a pixel, rounded to an odd
// count of 16-byte pieces so the 8 planes of a pixel fall on distinct banks.
__host__ __device__ constexpr int up_plane_bytes(int pixels) { return 16 * (pixels | 1); }

// Bytes of a ring slot: one tap of a chunk, UP_K input channels x NC columns.
template <int NC>
constexpr int UP_STAGE_BYTES = UP_K * NC * 2;

// Bytes between pixels of a warp's output staging buffer: NC columns and 16
// bytes of pad, so the 8 pixels a store instruction writes fall on distinct banks.
template <int NC>
constexpr int UP_OUT_PITCH = NC * 2 + 16;

struct UpShape {
  static constexpr int TH = 8 * UP_WG, TW = 8 * UP_MT, PH = TH + 2, PW = TW + 2;
  template <int NC>  // the patch, the ring, an 8-pixel staging buffer a warp
  static constexpr size_t SMEM = (size_t)(UP_K / 8) * up_plane_bytes(PH * PW) + (size_t)UP_STAGES * UP_STAGE_BYTES<NC> +
                                 (size_t)(UP_THREADS / 32) * 8 * UP_OUT_PITCH<NC>;
};

// conv3x3(x) + bias stored through pixel_shuffle(S): out (b, S y + i, S x +
// j, c) = conv channel c S^2 + i S + j at (b, y, x).
template <int S>
__global__ void __launch_bounds__(UP_THREADS, UP_MIN_BLOCKS) upsample_conv_kernel(const UpArgs a) {
  constexpr int NC = UpChunk<S>::NC, MT = UP_MT;
  using U = UpShape;
  using T = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = S * S * Cin, ncg = Cin / 8;
  constexpr int plane = up_plane_bytes(U::PH * U::PW);
  unsigned char* const patch = smem;
  unsigned char* const ring = smem + (UP_K / 8) * plane;
  unsigned char* const obuf = ring + UP_STAGES * UP_STAGE_BYTES<NC> + (tid >> 5) * 8 * UP_OUT_PITCH<NC>;
  const int tiles_w = (W + U::TW - 1) / U::TW;
  const int y0 = (blockIdx.x / tiles_w) * U::TH, x0 = (blockIdx.x % tiles_w) * U::TW, b = blockIdx.y;
  const T* const xb = a.x + (size_t)b * H * W * Cin;
  const int nchunks = (Cout + NC - 1) / NC, nsteps = 9 * nchunks;

  // The patch, zero outside the image (the SAME padding) and past Cin:
  // plane cg holds channels 8 cg .. 8 cg + 7 of every pixel, 16 bytes a pixel.
  for (int i = tid; i < U::PH * U::PW * (UP_K / 8); i += UP_THREADS) {
    const int px = i / (UP_K / 8), cg = i - px * (UP_K / 8);
    const int gy = y0 - 1 + px / U::PW, gx = x0 - 1 + px % U::PW;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && cg < ncg;
    hm_cp_async<16>(patch + cg * plane + px * 16, ok ? xb + ((size_t)gy * W + gx) * Cin + 8 * cg : a.x, ok);
  }
  // Step g (chunk g / 9, tap g % 9) into ring slot g % UP_STAGES, one
  // cp.async group (empty past the last step).
  auto stage = [&](int g) {
    if (g < nsteps) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(a.w) + (size_t)g * UP_STAGE_BYTES<NC>;
      unsigned char* dst = ring + (g % UP_STAGES) * UP_STAGE_BYTES<NC>;
      for (int i = tid; i < UP_STAGE_BYTES<NC> / 16; i += UP_THREADS) hm_cp_async<16>(dst + 16 * i, src + 16 * i, true);
    }
    hm_cp_commit();
  };

  float acc[MT][NC / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[m][i] = 0.f;
  // A: the patch, K-major (element (pixel, k) at (pixel / 8) SBO + (k / 8)
  // LBO + (pixel % 8) 16 + (k % 8) 2 from the m-tile's first pixel);
  // B: a ring slot, element (n, k) at (n / 8) 128 + (k / 8) NC 16 + ...
  const uint64_t da0 = wg_desc(patch, plane, U::PW * 16), db0 = wg_desc(ring, NC * 16, 128);

  constexpr int AHEAD = UP_STAGES - 2;  // steps in flight beyond the one multiplied
  for (int i = 0; i < AHEAD; ++i) stage(i);  // the patch rides in step 0's group
  for (int q = 0, g = 0; q < nchunks; ++q) {
    for (int tap = 0; tap < 9; ++tap, ++g) {
      hm_cp_wait_upto(AHEAD - 1);  // step g is in (the steps after it may still be loading)
      wg_proxy_fence();            // cp.async wrote through the generic proxy; wgmma reads through the async one
      __syncthreads();             // every thread's copies of step g are in; every warpgroup is done with step g - 2
      stage(g + AHEAD);            // into step g - 2's slot
      const int dy = tap / 3, dx = tap - 3 * dy;
      const uint32_t sb = (uint32_t)((g % UP_STAGES) * UP_STAGE_BYTES<NC>) >> 4;
#pragma unroll
      for (int m = 0; m < MT; ++m) wg_hold<NC / 2>(acc[m]);
      wg_fence();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const uint32_t sa = (uint32_t)(((8 * wg + dy) * U::PW + 8 * m + dx) * 16) >> 4;
#pragma unroll
        for (int ks = 0; ks < UP_K / 16; ++ks)
          wg_ss<NC>(acc[m], da0 + sa + (uint32_t)((2 * ks * plane) >> 4), db0 + sb + (uint32_t)(2 * ks * NC),
                    tap > 0 || ks > 0);
      }
      wg_commit();
#pragma unroll
      for (int m = 0; m < MT; ++m) wg_hold<NC / 2>(acc[m]);
      wg_wait1();  // step g - 1's products are done with its slot
    }
    wg_wait0();
#pragma unroll
    for (int m = 0; m < MT; ++m) wg_hold<NC / 2>(acc[m]);
    // Epilogue, 8 pixels at a time: accumulator (m, 4 j + 2 hh + e) is row
    // 16 wi + gq + 8 hh of m-tile m (pixel (2 wi + hh, gq) of its 8 x 8),
    // column 8 j + 2 tq + e of chunk q. Bias added, rounded to bf16 into this
    // warp's buffer (8 pixels x NC columns), then copied out 16 bytes a lane:
    // 8 columns are 8 channels of one subpixel plane, and consecutive lanes
    // write consecutive bytes of the HR map.
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int co = q * NC + 8 * j + 2 * tq, p = co / Cin, c = co - p * Cin;
          const bool live = co < Cout;
          const float b0 = live ? a.bias[c * S * S + p] : 0.f, b1 = live ? a.bias[(c + 1) * S * S + p] : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(obuf + gq * UP_OUT_PITCH<NC> + (8 * j + 2 * tq) * 2) =
              __floats2bfloat162_rn(acc[m][4 * j + 2 * hh] + b0, acc[m][4 * j + 2 * hh + 1] + b1);
        }
        __syncwarp();
        const int gy = y0 + 8 * wg + 2 * wi + hh;
#pragma unroll
        for (int e = lane; e < 8 * (NC / 8); e += 32) {
          const int px = e / (NC / 8), piece = e - px * (NC / 8), co = q * NC + 8 * piece, gx = x0 + 8 * m + px;
          if (gy < H && gx < W && co < Cout) {
            const int p = co / Cin, c = co - p * Cin, pi = p / S, pj = p - pi * S;
            *reinterpret_cast<uint4*>(a.out + (((size_t)b * S * H + S * gy + pi) * S * W + S * gx + pj) * Cin + c) =
                *reinterpret_cast<const uint4*>(obuf + px * UP_OUT_PITCH<NC> + piece * 16);
          }
        }
        __syncwarp();
      }
  }
}

struct UlArgs {
  const __nv_bfloat16* x;  // (B, H, W, Cin)
  const __nv_bfloat16* w;  // packed: (9, Cin / 16, 8, 4, 4), mma.m16n8k16's B fragments in lane order
  const float* bias;       // (n_colors)
  __nv_bfloat16* out;      // (B, H, W, n_colors)
  int H, W, Cin, n_colors;
};

// Bytes of conv_last's shared memory: the (UL_TH + 2) x (UL_TW + 2) patch
// at Cin + 8 elements a pixel, then the packed weights (9 x Cin / 16 x 32
// lanes x 8 bytes).
__host__ inline size_t upsample_last_smem(int Cin) {
  return (size_t)(UL_TH + 2) * (UL_TW + 2) * (Cin + 8) * 2 + (size_t)9 * (Cin / 16) * 32 * 8;
}

// conv3x3(x) + bias with Cout = n_colors <= 8.
__global__ void __launch_bounds__(UL_THREADS, UL_MIN_BLOCKS) upsample_last_kernel(const UlArgs a) {
  using T = __nv_bfloat16;
  constexpr int PH = UL_TH + 2, PW = UL_TW + 2;
  extern __shared__ __align__(128) unsigned char smem[];
  T* const P = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const int H = a.H, W = a.W, Cin = a.Cin, ncg = Cin / 8, nks = Cin / 16;
  const int PL = Cin + 8;  // elements between patch pixels: ldmatrix rows on distinct banks
  T* const Wf = P + PH * PW * PL;  // B fragments: lane l's 4 values of (tap, ks) at ((tap nks + ks) 32 + l) 4
  const int tiles_w = (W + UL_TW - 1) / UL_TW;
  const int y0 = (blockIdx.x / tiles_w) * UL_TH, x0 = (blockIdx.x % tiles_w) * UL_TW, b = blockIdx.y;
  const T* const xb = a.x + (size_t)b * H * W * Cin;
  for (int i = tid; i < PH * PW * ncg; i += UL_THREADS) {
    const int px = i / ncg, cg = i - px * ncg;
    const int gy = y0 - 1 + px / PW, gx = x0 - 1 + px % PW;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    hm_cp_async<16>(P + px * PL + 8 * cg, ok ? xb + ((size_t)gy * W + gx) * Cin + 8 * cg : a.x, ok);
  }
  for (int i = tid; i < 9 * nks * 16; i += UL_THREADS) hm_cp_async<16>(Wf + 8 * i, a.w + 8 * i, true);
  hm_cp_commit();
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float acc[2][4] = {};
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int ks = 0; ks < UP_K / 16; ++ks) {
      if (ks >= nks) break;
      const uint2 bw = *reinterpret_cast<const uint2*>(Wf + ((tap * nks + ks) * 32 + lane) * 4);
#pragma unroll
      for (int seg = 0; seg < 2; ++seg) {
        uint32_t af[4];
        const int px = (warp + dy) * PW + 16 * seg + dx + (mi & 1) * 8 + (lane & 7);
        hm_ldsm_x4(af[0], af[1], af[2], af[3], P + px * PL + 16 * ks + (mi >> 1) * 8);
        hm_mma(acc[seg], af, bw.x, bw.y);
      }
    }
  }
  // element e of acc[seg]: pixel 16 seg + gq + 8 (e / 2) of row `warp`, column 2 tq + e % 2
  const int gy = y0 + warp;
  if (gy >= H) return;
#pragma unroll
  for (int seg = 0; seg < 2; ++seg)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gx = x0 + 16 * seg + gq + 8 * (e >> 1), n = 2 * tq + (e & 1);
      if (gx < W && n < a.n_colors)
        a.out[(((size_t)b * H + gy) * W + gx) * a.n_colors + n] = __float2bfloat16(acc[seg][e] + a.bias[n]);
    }
}

template <int S>
static cudaError_t upsample_conv(const __nv_bfloat16* x, const void* w, const float* bias, __nv_bfloat16* out, int B,
                                 int H, int W, int Cin, cudaStream_t stream) {
  using U = UpShape;
  auto kernel = upsample_conv_kernel<S>;
  const size_t bytes = U::SMEM<UpChunk<S>::NC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const UpArgs a{x, (const __nv_bfloat16*)w, bias, out, H, W, Cin};
  const dim3 grid(((H + U::TH - 1) / U::TH) * ((W + U::TW - 1) / U::TW), B);
  kernel<<<grid, UP_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

static cudaError_t upsample_last(const __nv_bfloat16* x, const void* w, const float* bias, __nv_bfloat16* out, int B,
                                 int H, int W, int Cin, int n_colors, cudaStream_t stream) {
  const size_t bytes = upsample_last_smem(Cin);
  cudaError_t err =
      cudaFuncSetAttribute(upsample_last_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const UlArgs a{x, (const __nv_bfloat16*)w, bias, out, H, W, Cin, n_colors};
  const dim3 grid(((H + UL_TH - 1) / UL_TH) * ((W + UL_TW - 1) / UL_TW), B);
  upsample_last_kernel<<<grid, UL_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The geometry the bf16 kernels take, and 16-byte alignment of every map
// and packed weight they copy in 16-byte pieces.
static bool upsample_mma_ok(int B, int H, int W, int Cin, int n_colors, std::initializer_list<const void*> ptrs) {
  if (B < 1 || H < 1 || W < 1 || Cin < 16 || Cin > UP_K || Cin % 16 || n_colors < 1 ||
      n_colors > UL_MAX_COLORS)
    return false;
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return false;
  return true;
}

// Weights: w0, w1 packed by pack_shuffle_conv_weights, w2 by
// pack_conv_last_weights (ops/cuda/upsampler.py); biases f32.
extern "C" int upsample_x4_mma_bf16(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
                                    const void* w2, const void* b2, void* t1, void* t2, void* out, int B, int H,
                                    int W, int Cin, int n_colors, void* stream) {
  using T = __nv_bfloat16;
  if (!upsample_mma_ok(B, H, W, Cin, n_colors, {x, w0, w1, w2, t1, t2})) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = upsample_conv<2>((const T*)x, w0, (const float*)b0, (T*)t1, B, H, W, Cin, s);
  if (err != cudaSuccess) return (int)err;
  err = upsample_conv<2>((const T*)t1, w1, (const float*)b1, (T*)t2, B, 2 * H, 2 * W, Cin, s);
  if (err != cudaSuccess) return (int)err;
  return (int)upsample_last((const T*)t2, w2, (const float*)b2, (T*)out, B, 4 * H, 4 * W, Cin, n_colors, s);
}

extern "C" int upsample_s_mma_bf16(const void* x, const void* w0, const void* b0, const void* w2, const void* b2,
                                   void* c0, void* out, int B, int H, int W, int Cin, int n_colors, int scale,
                                   void* stream) {
  using T = __nv_bfloat16;
  if ((scale != 2 && scale != 3) || !upsample_mma_ok(B, H, W, Cin, n_colors, {x, w0, w2, c0}))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = scale == 2 ? upsample_conv<2>((const T*)x, w0, (const float*)b0, (T*)c0, B, H, W, Cin, s)
                               : upsample_conv<3>((const T*)x, w0, (const float*)b0, (T*)c0, B, H, W, Cin, s);
  if (err != cudaSuccess) return (int)err;
  return (int)upsample_last((const T*)c0, w2, (const float*)b2, (T*)out, B, scale * H, scale * W, Cin, n_colors, s);
}

extern "C" int upsample_x4_f32(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* t1, void* t2, void* out, int B, int H, int W,
                               int Cin, int n_colors, void* stream) {
  return (int)upsample_x4_f32_passes((const float*)x, (const float*)w0, (const float*)b0, (const float*)w1,
                                     (const float*)b1, (const float*)w2, (const float*)b2, (float*)t1, (float*)t2,
                                     (float*)out, B, H, W, Cin, n_colors, (cudaStream_t)stream);
}

extern "C" int upsample_s_f32(const void* x, const void* w0, const void* b0, const void* w2, const void* b2, void* c0,
                              void* out, int B, int H, int W, int Cin, int n_colors, int scale, void* stream) {
  return (int)upsample_s_f32_passes((const float*)x, (const float*)w0, (const float*)b0, (const float*)w2,
                                    (const float*)b2, (float*)c0, (float*)out, B, H, W, Cin, n_colors, scale,
                                    (cudaStream_t)stream);
}

// w0 (and w1) packed by ops/cuda/conv3x3.py pack_conv3x3_f32_weights (4 Cin
// > 16), w2 HWIO.
extern "C" int upsample_x4_mma_f32(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
                                   const void* w2, const void* b2, void* t1, void* t2, void* out, int B, int H, int W,
                                   int Cin, int n_colors, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_conv3x3_f32((const float*)x, (const float*)w0, (const float*)b0, nullptr, (float*)t1, B, H,
                                      W, Cin, 4 * Cin, ACT_NONE, 0.f, 0, 2, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_conv3x3_f32((const float*)t1, (const float*)w1, (const float*)b1, nullptr, (float*)t2, B, 2 * H, 2 * W,
                           Cin, 4 * Cin, ACT_NONE, 0.f, 0, 2, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_conv3x3<float>((const float*)t2, (const float*)w2, (const float*)b2, nullptr, (float*)out, B,
                                    4 * H, 4 * W, Cin, n_colors, ACT_NONE, 0.f, 0, 0, s);
}

// w0 packed by pack_conv3x3_f32_weights (s^2 Cin > 16), w2 HWIO.
extern "C" int upsample_s_mma_f32(const void* x, const void* w0, const void* b0, const void* w2, const void* b2,
                                  void* c0, void* out, int B, int H, int W, int Cin, int n_colors, int scale,
                                  void* stream) {
  if (scale != 2 && scale != 3) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_conv3x3_f32((const float*)x, (const float*)w0, (const float*)b0, nullptr, (float*)c0, B, H,
                                      W, Cin, scale * scale * Cin, ACT_NONE, 0.f, 0, scale, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_conv3x3<float>((const float*)c0, (const float*)w2, (const float*)b2, nullptr, (float*)out, B,
                                    scale * H, scale * W, Cin, n_colors, ACT_NONE, 0.f, 0, 0, s);
}
