// B11 in bf16 and f32, written for the H100: HAT's CAB trunk with the
// squeeze-excite channel sums,
//   y2 = res_scale (conv2(gelu(conv1(LN x) + b1)) + b2),
//   sums[b, c] = sum over H, W of y2[b, :, :, c] in f32, before y2 is rounded,
// x (B, H, W, C), conv1 C -> Cm, conv2 Cm -> C, both 3x3, each zero-padding
// its own input (the LayerNorm output and h1 are zero outside the image).
//
// Replaces studiosr_tpu/ops/pallas/conv3x3.py::fused_cab_body (:393, kernel
// _cab_kernel at :319) in bf16 and, below, in f32 (HAT served in f32, the
// checks' dtype); cab_body.cu keeps the geometries these decline (bf16: C
// above 192 or odd, Cm above 64; f32: C above 256 or not a multiple of 4,
// Cm above 64). Rounding as
// the TPU kernel: the LN output, h1 (after the exact erf GELU) and y2 are
// rounded to bf16; products accumulate in f32.
//
// Bound on the card at HAT serving's shapes (B 1, 256 x 256, C 180, Cm 60):
// 2 x 2 T 9 C Cm = 25.5 GFLOP against 47 MB, so operations (0.026 ms).
// cab_body.cu ran both convs on conv3x3.cuh's wmma kernel: a barrier and
// 2-byte staging loads a 16-channel chunk, 0.662 ms a call (NVIDIA H100
// 80GB HBM3, 700 W), 26x the bound. Here, four passes:
// 1. cb_ln_kernel, a warp a pixel: the LN rows (eps 1e-5, f32 statistics),
//    rounded, at a row stride of KP = 64 ceil(C / 64) channels with zeros past
//    C, so conv1 stages whole 16-byte pieces and its K needs no mask.
// 2. cab_conv_kernel<KCH, 64, false> (conv1): an implicit GEMM on wgmma, A
//    and B both read from shared memory by descriptor, as B3's
//    upsample_conv_kernel. A block owns a 16 x 8 pixel tile; its (tile +
//    halo) x KP patch is staged once in planes of 8 channels, so each 8 x 8
//    pixel m-tile shifted by a tap is a K-major wgmma operand (core matrix: 8
//    pixels of a row x 16 bytes; LBO one plane, SBO one patch row) and the 9
//    taps need no im2col. Two warpgroups, one per 8-row half of the tile.
//    The weights stream through a 4-slot cp.async ring, one (tap, 64 input
//    channels) of one column chunk a slot, packed at load time as the image
//    of a slot (ops/cuda/conv3x3.py pack_cab_weights), 8 KB a slot: 100 KB
//    of shared memory with the 24-plane patch, two blocks an SM. N is Cm
//    padded to 64 (B2's 192-column block would waste two thirds of every
//    product). The epilogue adds b1, takes the exact GELU (erff), rounds and
//    stores h1 at 64 channels a pixel, zero past Cm (the weights and bias
//    are zero there and GELU(0) = 0).
// 3. cab_conv_kernel<1, 96, true> (conv2): the same kernel on h1 (8 planes,
//    K 64 a tap), C in chunks of 96 columns (12 KB a slot). The epilogue
//    adds b2, scales by res_scale, takes each column's f32 sum over the
//    tile's pixels (a thread's rows, then the warp's by shuffles, then the
//    block's eight warps through shared memory in warp order), writes it to
//    part[b, tile, c], then rounds and stores y2.
// 4. cb_sum_kernel: sums[b, c], the tiles' partials summed in a fixed
//    order (eight interleaved runs of tiles, each in tile order, then the
//    runs in order).
// h1 goes through device memory (16 MB round trip at HAT's shapes, about 5
// us): fusing the convs over a halo would recompute about 40 % of conv1. No
// atomic sums: two launches give the same bits.
//
// Wave shape: at 256 x 256, 512 tiles of 16 x 8 pixels on 132 SMs at two
// blocks an SM (264 at once) run in 1.94 waves; a 16 x 16 tile (256 tiles)
// would hold 157 KB in conv1 and run one block an SM, the same 1.94 waves.
//
// Measured at HAT serving's shapes (scripts/torch_time_conv_kernels.py,
// NVIDIA H100 80GB HBM3, 700.00 W): 0.141 ms a call (LN 0.021, conv1 0.055,
// conv2 0.052, the sum 0.004), against 0.51 for the same function as a
// sequence of bf16 PyTorch calls with cuDNN's convs.
//
// f32 (cab_body_mma_f32, below), written for the H100 too: the same four
// passes in 3xTF32 on conv3x3_f32.cuh's implicit-GEMM kernel (wgmma's tf32
// form, a 12 x 16 pixel tile of three warpgroups, the patch staged once a
// 32-channel chunk for its nine taps, the weights' hi / lo images through a
// three-slot ring), its CAB instantiation:
// 1. cb32_ln_kernel, a warp a pixel: the LN rows (eps 1e-5, f32
//    statistics) at a stride of KP = pad32(C) channels, zero past C, so
//    conv1's patch copies are whole 16-byte pieces with no channel mask.
// 2. conv1, ct_conv_kernel<16, 64, true>: N = Cm padded to 64 (tfw_rs<64>;
//    96 would waste a third of every product). The epilogue adds b1, takes
//    the exact erf GELU and stores h1 at pad32(Cm) channels, zero past Cm.
// 3. conv2, ct_conv_kernel<16, 96, true>: C in 96-column tiles. The
//    epilogue adds b2, scales by res_scale, stores y2 and takes each
//    column's f32 sum over the tile's pixels (a thread's two pixels, the
//    warp's by shuffles, then the twelve warps in order) into part[b, tile,
//    c].
// 4. cb_sum_kernel (above): sums[b, c] in a fixed order. No atomics: two
//    launches give the same bits.
// The weights are the hi / lo images of conv3x3_f32.cuh's packed layout,
// conv1 in 64-column tiles and conv2 in 96 (ops/cuda/conv3x3.py
// pack_cab_f32_convs; HAT's f32 serving packs them at load time, HWIO
// weights are packed per call). A block holds 124,800 bytes of shared
// memory in conv1 and 150,912 in conv2 (two patch buffers of 14 x 18
// pixels x 36 floats, three ring slots, the twelve warps' column sums), up
// to 168 registers a thread at 384 threads: one block an SM. Takes C a
// multiple of 4 up to 256 and Cm up to 64 (conv3x3.py cab_f32_mma_takes);
// other f32 geometries keep cab_body.cu.
// Bound at HAT serving's shapes (B 1, 256 x 256, C 180, Cm 60): 25.5 GFLOP,
// 0.1545 ms at 3xTF32 (164.9 TFLOP/s), 0.381 on the FMA pipes; cab_body.cu
// ran both convs on conv3x3.cuh's FMA kernel, 1.599 ms (NVIDIA H100 80GB
// HBM3, 700 W).
#include "conv3x3_f32.cuh"
#include "hopper_mma.cuh"
#include "wgmma.cuh"

using cb_bf16 = __nv_bfloat16;

constexpr int CB_WG = 2, CB_THREADS = 128 * CB_WG;  // a warpgroup per 8-row half of the tile
constexpr int CB_TH = 8 * CB_WG, CB_TW = 8, CB_PH = CB_TH + 2, CB_PW = CB_TW + 2;
constexpr int CB_STAGES = 4;   // ring slots: one (tap, 64 input channels) of a column chunk each
constexpr int CB_N1 = 64;      // conv1's columns: Cm padded
constexpr int CB_N2 = 96;      // conv2's columns a chunk
constexpr int CB_MAX_C = 192, CB_MAX_CM = 64;

// Bytes of one 8-channel plane of the patch: 16 a pixel, rounded to an odd
// count of 16-byte pieces so the planes of a pixel fall on distinct banks.
constexpr int CB_PLANE = 16 * ((CB_PH * CB_PW) | 1);

template <int NC>
constexpr int CB_SLOT = 64 * NC * 2;

// The patch, the ring and (conv2) the eight warps' column sums.
template <int KCH, int NC, bool CONV2>
constexpr size_t CB_SMEM = (size_t)8 * KCH * CB_PLANE + (size_t)CB_STAGES * CB_SLOT<NC> + (CONV2 ? 8 * NC * 4 : 0);

struct CbArgs {
  const cb_bf16* in;  // (B, H, W, 64 KCH), zero past the real channels
  const cb_bf16* w;   // packed: (chunks, 9, KCH, 8, NC / 8, 8, 8)
  const float* bias;  // (N)
  cb_bf16* out;       // conv1: h1 (B, H, W, 64); conv2: y2 (B, H, W, C)
  float* part;        // conv2: (B, tiles, C) f32 tile sums of y2
  int H, W, N, ostride;
  float res_scale;
};

__device__ __forceinline__ float cb_gelu(float v) { return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)); }

// LN of each pixel row, rounded, KP channels a row, zero past C (C even).
__global__ void __launch_bounds__(256) cb_ln_kernel(const cb_bf16* __restrict__ x, const float* __restrict__ g,
                                                    const float* __restrict__ bt, cb_bf16* __restrict__ ln,
                                                    long long rows, int C, int KP) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const cb_bf16* xr = x + r * C;
  float2 v[3];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int c = 2 * (lane + 32 * j);
    v[j] = c < C ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + c)) : make_float2(0.f, 0.f);
    s += v[j].x + v[j].y;
  }
  const float mean = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (2 * (lane + 32 * j) < C) q += (v[j].x - mean) * (v[j].x - mean) + (v[j].y - mean) * (v[j].y - mean);
  const float rstd = rsqrtf(warp_sum(q) / C + 1e-5f);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int c = 2 * (lane + 32 * j);
    if (c >= KP) continue;
    const bool in = c < C;
    *reinterpret_cast<__nv_bfloat162*>(ln + r * KP + c) =
        __floats2bfloat162_rn(in ? (v[j].x - mean) * rstd * g[c] + bt[c] : 0.f,
                              in ? (v[j].y - mean) * rstd * g[c + 1] + bt[c + 1] : 0.f);
  }
}

// conv3x3 of `in` (KP = 64 KCH channels a pixel) to N columns; conv1
// (CONV2 false): + bias, GELU, to h1; conv2: res_scale (. + bias) to y2
// with the tile's f32 column sums.
template <int KCH, int NC, bool CONV2>
__global__ void __launch_bounds__(CB_THREADS, 2) cab_conv_kernel(const CbArgs a) {
  constexpr int KP = 64 * KCH, PLANES = KP / 8, SLOT = CB_SLOT<NC>, AHEAD = CB_STAGES - 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const patch = smem;
  unsigned char* const ring = smem + PLANES * CB_PLANE;
  float* const red = reinterpret_cast<float*>(ring + CB_STAGES * SLOT);  // conv2: [warp][NC]
  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int H = a.H, W = a.W;
  const int tiles_w = (W + CB_TW - 1) / CB_TW;
  const int y0 = (blockIdx.x / tiles_w) * CB_TH, x0 = (blockIdx.x % tiles_w) * CB_TW, b = blockIdx.y;
  const cb_bf16* const xb = a.in + (size_t)b * H * W * KP;
  const int nchunks = (a.N + NC - 1) / NC, nsteps = 9 * KCH * nchunks;

  // The patch, zero outside the image (the SAME padding): plane cg holds
  // channels 8 cg .. 8 cg + 7 of every pixel, 16 bytes a pixel.
  for (int i = tid; i < CB_PH * CB_PW * PLANES; i += CB_THREADS) {
    const int px = i / PLANES, cg = i - px * PLANES;
    const int gy = y0 - 1 + px / CB_PW, gx = x0 - 1 + px % CB_PW;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    hm_cp_async<16>(patch + cg * CB_PLANE + px * 16, ok ? xb + ((size_t)gy * W + gx) * KP + 8 * cg : a.in, ok);
  }
  // Step g (chunk g / (9 KCH), tap g / KCH % 9, K chunk g % KCH) into ring
  // slot g % CB_STAGES, one cp.async group (empty past the last step).
  auto stage = [&](int g) {
    if (g < nsteps) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(a.w) + (size_t)g * SLOT;
      unsigned char* dst = ring + (g % CB_STAGES) * SLOT;
      for (int i = tid; i < SLOT / 16; i += CB_THREADS) hm_cp_async<16>(dst + 16 * i, src + 16 * i, true);
    }
    hm_cp_commit();
  };

  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  // A: the patch, element (pixel, k) at (pixel / 8) SBO + (k / 8) LBO +
  // (pixel % 8) 16 + (k % 8) 2 from the m-tile's first pixel; B: a ring
  // slot, element (n, k) at (n / 8) 128 + (k / 8) NC 16 + (n % 8) 16 + (k % 8) 2.
  const uint64_t da0 = wg_desc(patch, CB_PLANE, CB_PW * 16), db0 = wg_desc(ring, NC * 16, 128);
  for (int i = 0; i < AHEAD; ++i) stage(i);  // the patch rides in step 0's group
  for (int q = 0, g = 0; q < nchunks; ++q) {
    for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
      for (int kc = 0; kc < KCH; ++kc, ++g) {
        hm_cp_wait_upto(AHEAD - 1);  // step g is in (the steps after it may still be loading)
        wg_proxy_fence();            // cp.async wrote through the generic proxy; wgmma reads through the async one
        __syncthreads();             // every thread's copies of step g are in; every warpgroup is done with step g - 2
        stage(g + AHEAD);            // into step g - 2's slot
        const int dy = tap / 3, dx = tap - 3 * dy;
        const uint32_t sb = (uint32_t)((g % CB_STAGES) * SLOT) >> 4;
        const uint32_t sa = (uint32_t)(((8 * wg + dy) * CB_PW + dx) * 16 + kc * 8 * CB_PLANE) >> 4;
        wg_hold<NC / 2>(acc);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wg_ss<NC>(acc, da0 + sa + (uint32_t)((2 * ks * CB_PLANE) >> 4), db0 + sb + (uint32_t)(2 * ks * NC),
                    tap > 0 || kc > 0 || ks > 0);
        wg_commit();
        wg_hold<NC / 2>(acc);
        wg_wait1();  // step g - 1's products are done with its slot
      }
    }
    wg_wait0();
    wg_hold<NC / 2>(acc);
    // Epilogue: accumulator 4 j + 2 hh + e is row 16 wi + gq + 8 hh of the
    // warpgroup's m-tile, pixel (2 wi + hh, gq) of its 8 x 8, column
    // q NC + 8 j + 2 tq + e.
    const int gx = x0 + gq;
    float cs[NC / 8][2];
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gy = y0 + 8 * wg + 2 * wi + hh;
      const bool in = gy < H && gx < W;
      cb_bf16* const dst = a.out + (((size_t)b * H + gy) * W + gx) * a.ostride;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int col = q * NC + 8 * j + 2 * tq;
        const bool live = col < a.N;  // N even for conv2: a pair is in or out whole
        const float b0 = live ? __ldg(a.bias + col) : 0.f, b1 = col + 1 < a.N ? __ldg(a.bias + col + 1) : 0.f;
        float v0 = acc[4 * j + 2 * hh] + b0, v1 = acc[4 * j + 2 * hh + 1] + b1;
        if constexpr (CONV2) {
          v0 *= a.res_scale, v1 *= a.res_scale;
          if (in && live) {
            cs[j][0] += v0, cs[j][1] += v1;
            *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(v0, v1);
          }
        } else if (in) {
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(cb_gelu(v0), cb_gelu(v1));
        }
      }
    }
    if constexpr (CONV2) {
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = cs[j][e];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          if (gq == 0) red[warp * NC + 8 * j + 2 * tq + e] = s;
        }
      __syncthreads();
      if (tid < NC && q * NC + tid < a.N) {
        float s = 0.f;
#pragma unroll
        for (int w8 = 0; w8 < CB_THREADS / 32; ++w8) s += red[w8 * NC + tid];
        a.part[((size_t)b * gridDim.x + blockIdx.x) * a.N + q * NC + tid] = s;
      }
      // red is written again only after the next chunk's first barrier
    }
  }
}

// sums[b, c]: warp w of block (c / 32, b) sums the tiles w, w + 8, ... in
// order, lane = channel; then the eight runs in order.
__global__ void __launch_bounds__(256) cb_sum_kernel(const float* __restrict__ part, float* __restrict__ sums,
                                                     int tiles, int C) {
  __shared__ float red[8][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = blockIdx.x * 32 + lane, b = blockIdx.y;
  float s = 0.f;
  if (c < C) {
    const float* p = part + (size_t)b * tiles * C + c;
#pragma unroll 8
    for (int t = warp; t < tiles; t += 8) s += p[(size_t)t * C];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < C) {
    float total = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < 8; ++w8) total += red[w8][lane];
    sums[(size_t)b * C + c] = total;
  }
}

template <int KCH, int NC, bool CONV2>
static cudaError_t cb_conv(const CbArgs& a, int B, cudaStream_t s) {
  auto kernel = cab_conv_kernel<KCH, NC, CONV2>;
  const size_t bytes = CB_SMEM<KCH, NC, CONV2>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(((a.H + CB_TH - 1) / CB_TH) * ((a.W + CB_TW - 1) / CB_TW), B);
  kernel<<<grid, CB_THREADS, bytes, s>>>(a);
  return cudaGetLastError();
}

// The geometry the kernel takes: C even up to 192, Cm up to 64.
static bool cb_shape_ok(int B, int H, int W, int C, int Cm) {
  return B >= 1 && H >= 1 && W >= 1 && C >= 2 && C <= CB_MAX_C && C % 2 == 0 && Cm >= 1 && Cm <= CB_MAX_CM;
}

// Tiles of an image: the partials' middle dimension.
extern "C" int cab_body_mma_tiles(int H, int W) { return ((H + CB_TH - 1) / CB_TH) * ((W + CB_TW - 1) / CB_TW); }

// x (B, H, W, C) bf16; w1, w2 packed by ops/cuda/conv3x3.py pack_cab_weights
// (conv1 in 64-column chunks, conv2 in 96); ln_w, ln_b, b1, b2 f32. Scratch:
// ln (B, H, W, 64 ceil(C / 64)) and h1 (B, H, W, 64) bf16, part (B, tiles, C) f32.
extern "C" int cab_body_mma_bf16(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* ln, void* h1, void* part, void* out,
                                 void* sums, int B, int H, int W, int C, int Cm, float res_scale, void* stream) {
  if (!cb_shape_ok(B, H, W, C, Cm)) return (int)cudaErrorInvalidValue;
  const void* const copied[] = {ln, h1, w1, w2};  // read in 16-byte pieces
  for (const void* p : copied)
    if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
  if ((uintptr_t)x % 4 || (uintptr_t)out % 4) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  const int KCH = (C + 63) / 64, KP = 64 * KCH;
  const long long rows = (long long)B * H * W;
  cb_ln_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>((const cb_bf16*)x, (const float*)ln_w,
                                                          (const float*)ln_b, (cb_bf16*)ln, rows, C, KP);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const CbArgs a1{(const cb_bf16*)ln, (const cb_bf16*)w1, (const float*)b1, (cb_bf16*)h1, nullptr, H, W, Cm,
                  CB_N1, 1.f};
  err = KCH == 1 ? cb_conv<1, CB_N1, false>(a1, B, s)
                 : KCH == 2 ? cb_conv<2, CB_N1, false>(a1, B, s) : cb_conv<3, CB_N1, false>(a1, B, s);
  if (err != cudaSuccess) return (int)err;
  const CbArgs a2{(const cb_bf16*)h1, (const cb_bf16*)w2, (const float*)b2, (cb_bf16*)out, (float*)part, H, W, C,
                  C, res_scale};
  err = cb_conv<1, CB_N2, true>(a2, B, s);
  if (err != cudaSuccess) return (int)err;
  cb_sum_kernel<<<dim3((C + 31) / 32, B), 256, 0, s>>>((const float*)part, (float*)sums, cab_body_mma_tiles(H, W),
                                                       C);
  return (int)cudaGetLastError();
}

// -- f32 -------------------------------------------------------------------------

constexpr int CB32_MAX_CM = 64, CB32_N1 = 64, CB32_N2 = 96;

// LN of each pixel row in f32 (a warp a row: tf32x3.cuh's row pass), KP
// channels a row, zero past C (C a multiple of 4 up to TF_MAX_C).
__global__ void __launch_bounds__(256) cb32_ln_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                                      const float* __restrict__ bt, float* __restrict__ ln,
                                                      long long rows, int C, int KP) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  float4 v[2];
  tf_load_row(x + r * C, C, v);
  tf_ln_fwd(v, C, g, bt, ln + r * KP);
  for (int c = C + 4 * (threadIdx.x & 31); c < KP; c += 128)
    *reinterpret_cast<float4*>(ln + r * KP + c) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The geometry the f32 kernel takes: C a multiple of 4 up to 256, Cm up to 64.
static bool cb32_shape_ok(int B, int H, int W, int C, int Cm) {
  return B >= 1 && H >= 1 && W >= 1 && C >= 4 && C <= TF_MAX_C && C % 4 == 0 && Cm >= 1 && Cm <= CB32_MAX_CM;
}

// Tiles of an image in the f32 kernel: the partials' middle dimension.
extern "C" int cab_body_mma_f32_tiles(int H, int W) { return ct_pixel_tiles(H, W); }

// x (B, H, W, C) f32; w1, w2 packed by ops/cuda/conv3x3.py pack_cab_f32_convs
// (conv3x3_f32.cuh's images, conv1 in 64-column tiles, conv2 in 96); ln_w,
// ln_b, b1, b2 f32. Scratch: ln (B, H, W, pad32(C)) and h1 (B, H, W,
// pad32(Cm)) f32, part (B, tiles, C) f32.
extern "C" int cab_body_mma_f32(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* ln, void* h1, void* part, void* out,
                                void* sums, int B, int H, int W, int C, int Cm, float res_scale, void* stream) {
  if (!cb32_shape_ok(B, H, W, C, Cm)) return (int)cudaErrorInvalidValue;
  const void* const wide[] = {x, ln_w, ln_b, ln, h1, w1, w2};  // read in 16-byte pieces
  for (const void* p : wide)
    if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  const int KP = (C + CT_KC - 1) / CT_KC * CT_KC, CMP = (Cm + CT_KC - 1) / CT_KC * CT_KC;
  const long long rows = (long long)B * H * W;
  cb32_ln_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>((const float*)x, (const float*)ln_w, (const float*)ln_b,
                                                           (float*)ln, rows, C, KP);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const CtArgs a1{(const float*)ln, (const float*)w1, (const float*)b1, nullptr, (float*)h1, H, W, KP, Cm,
                  ACT_GELU, 0.f, 1.f, 0, 0, nullptr, CMP};
  err = ct_launch<16, CB32_N1, true>(a1, B, s);
  if (err != cudaSuccess) return (int)err;
  const CtArgs a2{(const float*)h1, (const float*)w2, (const float*)b2, nullptr, (float*)out, H, W, CMP, C,
                  ACT_NONE, 0.f, res_scale, 0, 0, (float*)part, C};
  err = ct_launch<16, CB32_N2, true>(a2, B, s);
  if (err != cudaSuccess) return (int)err;
  cb_sum_kernel<<<dim3((C + 31) / 32, B), 256, 0, s>>>((const float*)part, (float*)sums, ct_pixel_tiles(H, W), C);
  return (int)cudaGetLastError();
}
