// B1 in bf16: the whole Swin transformer block,
//   z = x + proj(WA(LN1 x)),  y = z + fc2(gelu(fc1(LN2 z))),
// window attention (WA) over 8 x 8 windows with the relative-position bias
// and, for shifted blocks, the shifted-window mask; written for the H100.
//
// Replaces studiosr_tpu/ops/pallas/swin_block.py::fused_swin_block (:691) in
// bf16; f32, the checks' dtype, keeps swin_block.cu. Semantics as there: the
// shift is folded into the reads and writes (token (h, w) of the rolled map
// is read from and written back to ((h + s) mod H, (w + s) mod W)), the mask
// comes from per-token region ids, and the rounding points are the TPU
// kernel's: LN outputs, q / k / v, the probabilities, the attention output,
// z and the GELU output are rounded to bf16; sums, LayerNorm and softmax
// statistics are f32.
//
// Bound on the card at the main path's 264 x 264 x 180 map (6 heads of 30,
// hidden 360): 39.35 GFLOP against about 50 MB, so the tensor-core rate
// (0.040 ms at 989 TFLOP/s). swin_block.cu's bf16 route (1.25 ms) packed
// the weights on every call, restaged them from L2 for every window in 32 x
// 64 chunks with a barrier each, multiplied on legacy wmma tiles, passed the
// scores through shared memory and multiplied a quarter of the q|k|v
// columns by zero padding. Here:
// * A window is one wgmma M tile: its four warps (a warpgroup) own 16 token
//   rows each and run every product as wgmma.m64nNk16 (wgmma.cuh), f32
//   accumulators in registers, B from shared memory, A from shared memory
//   (the LN outputs) or from registers (q, the probabilities, the attention
//   output, the GELU output).
// * The weights come packed at load time (ops/cuda/swin_block.py
//   pack_swin_weights): one bf16 blob laid out in the order the kernel
//   consumes it, each stage the image of a ring slot in wgmma's K-major core
//   matrix layout, zero-padded. Per head: its q|k|v columns (3 x pad16(d):
//   96 at d 30) in stages of rows, then one stage of its rel-pos bias (f32,
//   in the order the score fragments hold it) and its pad16(d) rows of
//   proj; per hidden chunk of 64: fc1's columns, then fc2's rows.
// * Thread 0 streams the stages with cp.async.bulk into a ring of three 28
//   KB slots on mbarriers (full: the bytes arrived; empty: all eight warps
//   are done with the slot), two stages ahead of its own warp. A block holds
//   two windows (two warpgroups), so every staged byte serves 128 tokens;
//   blocks are persistent (one an SM) and walk window pairs while the ring
//   runs on across pairs: a launch reads 545 x 0.67 MB = 363 MB from L2 at
//   the main path's shapes (swin_block.cu: 1089 x 0.66 MB = 720 MB).
// * Attention in registers, per head: q (scaled, rounded) is the A operand
//   of q k^T; bias (+ -100 where the region ids differ), the softmax (ex2,
//   f32 row sums) and P V stay in registers; the normalised output, rounded,
//   is the A operand of the head's rows of proj, which accumulate in
//   registers over the heads. k and v go to shared memory (one named
//   barrier a head, two buffers alternating); no score touches it.
// * The MLP in chunks of 64 hidden units: fc1's chunk, + b1, GELU (erf),
//   rounded, is the A operand of fc2's rows of the chunk; fc2 accumulates in
//   registers. The hidden activation never touches shared memory.
// * Padding: q|k|v columns to pad16(d) (30 -> 32), K to pad16(C) (180 ->
//   192), proj's and fc2's columns to NP (184 at C 180; 32, 64, 96, 128 for
//   narrower maps).
// Takes window 8, C a multiple of 4 up to 184, head dim up to 32, any
// hidden, batch, H and W multiples of 8 (ops/cuda/swin_block.py raises
// otherwise). Dynamic shared memory at C 180: 219,520 B (design constants
// below). -Xptxas -v (sm_90a): <2, 184>, the main path's, 255
// registers, 16 B spill stores, 32 B spill loads; the narrower
// instantiations 191-255 registers, at most 20 / 32 B spilled; ptxas
// serializes the wgmmas of the KS = 1 ones (C7520). Measured on an H100
// (PERF.md, PR 8): 0.375 ms at the main path's shapes, 9.4x its bound; the
// products take a third of it, the LayerNorms a fifth
// (scripts/torch_ablate_swin_block.py splits the rest).
#include "hopper_mma.cuh"
#include "wgmma.cuh"

constexpr int SM_WS = 8, SM_TOK = 64;                // a window: 8 x 8 tokens
constexpr int SM_WINDOWS = 2;                        // windows a block, a warpgroup each
constexpr int SM_CWARPS = 4 * SM_WINDOWS;            // warps, 16 token rows each
constexpr int SM_THREADS = 32 * SM_CWARPS;
constexpr int SM_SLOTS = 3;                          // ring slots
constexpr int SM_SLOT_BYTES = 28672;                 // bytes a slot (a stage's most)
constexpr int SM_MAX_STAGES = 64;                    // stages a window pair
constexpr int SM_HEAD_BYTES = 384;                   // barriers (64 B) and the stage offsets, 128-byte padded
constexpr int SM_CHUNK = 64;                         // hidden units a fc1 -> fc2 chunk
constexpr int SM_BIAS_ELEMS = SM_TOK * SM_TOK * 2;   // a head's f32 bias, in bf16 elements
constexpr int SM_MAX_C = 184;
constexpr float SM_LOG2E = 1.4426950408889634f;

__host__ __device__ inline int sm_pad16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline int sm_min(int a, int b) { return a < b ? a : b; }
// Columns of proj's and fc2's products: the wgmma widths the kernel has.
__host__ __device__ inline int sm_np(int C) { return C <= 32 ? 32 : C <= 64 ? 64 : C <= 96 ? 96 : C <= 128 ? 128 : 184; }

// Element (k, n) of a K-major operand with `rows` K rows (its K extent, a
// multiple of 16): core matrices of 8 n x 8 k, k-groups 64 elements (LBO 128
// bytes) and n-groups rows * 8 elements (SBO rows * 16 bytes) apart.
__host__ __device__ inline int sm_kmajor(int k, int n, int rows) {
  return (n / 8) * rows * 8 + (k / 8) * 64 + (n % 8) * 8 + k % 8;
}

// The geometry, shared by the kernel and the host; the stage order is
// mirrored by ops/cuda/swin_block.py swin_pack_stages.
struct SmGeom {
  int C, heads, hidden, d, DP, KC, NQ, NP, LX, RQ;
  __host__ __device__ SmGeom(int C_, int heads_, int hidden_) : C(C_), heads(heads_), hidden(hidden_) {
    d = C / heads;
    DP = sm_pad16(d);
    KC = sm_pad16(C);  // K of the products on the LN outputs
    NQ = 3 * DP;       // a head's q|k|v columns
    NP = sm_np(C);
    LX = KC + 8;       // x / z rows (row-major; 16-byte rows, an odd count of them)
    RQ = rows(NQ);
  }
  // K rows a stage of n columns holds: as many 16-row steps as fit a slot.
  __host__ __device__ int rows(int n) const { return sm_min(KC, (SM_SLOT_BYTES / (2 * n)) / 16 * 16); }
  __host__ __device__ int chunk(int c0) const { return sm_pad16(sm_min(SM_CHUNK, hidden - c0)); }
  // Bytes of shared memory: the ring, its barriers and stage table, then each
  // window's x / z rows, LN outputs (K-major) and two k / v buffers.
  __host__ __device__ size_t window_bytes() const { return (size_t)SM_TOK * (LX + KC + 4 * DP) * 2; }
  __host__ __device__ size_t smem_bytes() const {
    return (size_t)SM_SLOTS * SM_SLOT_BYTES + SM_HEAD_BYTES + SM_WINDOWS * window_bytes();
  }
  // Visits every stage in order, f(elements), and returns the total (f is
  // a device lambda in the kernel, a host one on the host).
#pragma nv_exec_check_disable
  template <typename F>
  __host__ __device__ long long stages(F f) const {
    long long total = 0;
    for (int h = 0; h < heads; ++h) {
      for (int r0 = 0; r0 < KC; r0 += RQ) total += f(sm_min(RQ, KC - r0) * NQ);
      total += f(SM_BIAS_ELEMS + DP * NP);
    }
    for (int c0 = 0; c0 < hidden; c0 += SM_CHUNK) {
      const int hc = chunk(c0), RH = rows(hc);
      for (int r0 = 0; r0 < KC; r0 += RH) total += f(sm_min(RH, KC - r0) * hc);
      total += f(hc * NP);
    }
    return total;
  }
};

struct SmArgs {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  const __nv_bfloat16* w;  // the packed blob
  const float *ln1_w, *ln1_b, *bqkv, *bproj, *ln2_w, *ln2_b, *b1, *b2;
  int H, W, shift, nwin, npairs;  // nwin: windows of all images
  int nst;                        // stages a window pair
};

// -- mbarriers and the bulk copy ----------------------------------------------------

__device__ __forceinline__ void sm_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(hm_smem(bar)), "r"(count) : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait of more than
// about ten seconds traps, so a fault in the ring ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void sm_bar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(hm_smem(bar)), "r"(parity)
      : "memory");
  if (done) return;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(hm_smem(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  } while (!done);
}

__device__ __forceinline__ void sm_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(hm_smem(bar)) : "memory");
}

// The producer's arrival: the stage's bytes are expected, then copied in.
__device__ __forceinline__ void sm_bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(hm_smem(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   hm_smem(dst)),
               "l"(src), "r"(bytes), "r"(hm_smem(bar))
               : "memory");
}

// The four warps of window w (named barrier 1 + w).
__device__ __forceinline__ void sm_window_sync(int win) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + win) : "memory");
}

// A warp's view of the ring. Thread 0 of the block is also its producer: on
// acquiring stage i it issues stage i + 2 (slots - 1 ahead) into the slot of
// stage i - 1, once every warp has released that one.
struct SmRing {
  unsigned char* slots;
  uint64_t *full, *empty;
  const int* off;                 // element offsets of a pair's stages in the blob, nst + 1
  const __nv_bfloat16* w;         // the blob
  int nst, total;                 // stages a pair; stages of all this block's pairs
  int i, slot, phase;             // the next stage to acquire, its slot and full-barrier parity
  __device__ void issue(int k) {  // thread 0: stage k (of all pairs) into slot k % SM_SLOTS
    const int j = k % nst, sl = k % SM_SLOTS;
    sm_bar_wait(&empty[sl], ((k / SM_SLOTS) & 1) ^ 1);
    sm_bulk_load(slots + (size_t)sl * SM_SLOT_BYTES, w + off[j], 2 * (off[j + 1] - off[j]), &full[sl]);
  }
  __device__ const __nv_bfloat16* acquire() {
    if (threadIdx.x == 0 && i + SM_SLOTS - 1 < total) issue(i + SM_SLOTS - 1);
    __syncwarp();
    sm_bar_wait(&full[slot], phase);
    return (const __nv_bfloat16*)(slots + (size_t)slot * SM_SLOT_BYTES);
  }
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) sm_bar_arrive(&empty[slot]);
    ++i;
    if (++slot == SM_SLOTS) slot = 0, phase ^= 1;
  }
};

// -- helpers ---------------------------------------------------------------------------

__device__ __forceinline__ float sm_quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float sm_quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float sm_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc (N / 2 values) = the window's 64 LN rows (K-major at lnb, KC columns)
// x a matrix of N columns streamed through the ring in stages of `rows` K
// rows (K-major). wgmma reads both operands from shared memory.
template <int N>
__device__ __forceinline__ void sm_gemm_ln(float* acc, const __nv_bfloat16* lnb, int KC, int rows, SmRing& ring) {
  for (int k0 = 0; k0 < KC; k0 += rows) {
    const __nv_bfloat16* bs = ring.acquire();
    const int kr = sm_min(rows, KC - k0);
    wg_fence();
    for (int kk = 0; kk < kr; kk += 16)
      wg_ss<N>(acc, wg_desc(lnb + (k0 + kk) * 8, 128, KC * 16), wg_desc(bs + kk * 8, 128, kr * 16), k0 + kk > 0);
    wg_commit();
    wg_wait0();
    wg_hold<N / 2>(acc);
    ring.release();
  }
}

// The same for a runtime chunk width n (16, 32, 48 or 64) into af (32 values).
__device__ __forceinline__ void sm_gemm_fc1(float* af, int n, const __nv_bfloat16* lnb, int KC, int rows,
                                            SmRing& ring) {
  switch (n) {
    case 16: sm_gemm_ln<16>(af, lnb, KC, rows, ring); break;
    case 32: sm_gemm_ln<32>(af, lnb, KC, rows, ring); break;
    case 48: sm_gemm_ln<48>(af, lnb, KC, rows, ring); break;
    default: sm_gemm_ln<64>(af, lnb, KC, rows, ring); break;
  }
}

// LayerNorm (eps 1e-5, f32 statistics) of the warp's 16 rows of xs (stride
// LX, C a multiple of 4) into the window's K-major LN buffer (KC columns,
// rows row0 ..), rounded to bf16, zero in columns C .. KC. Eight rows at a
// time: lane 8 q + i takes row i and the 8-column groups q, q + 4, ..., so
// the four lanes of a row reduce with two shuffles and every store covers 4
// whole core matrices (512 contiguous bytes, no bank conflict).
__device__ __forceinline__ void sm_layernorm16(const __nv_bfloat16* xs, int LX, __nv_bfloat16* lnb, int row0, int KC,
                                               int C, const float* __restrict__ g, const float* __restrict__ b) {
  const int lane = threadIdx.x & 31, ri = lane & 7, cq = lane >> 3, KG = KC / 8;
  // the 8 values of column group kg of a row, zero past C
  auto load = [&](const __nv_bfloat16* row, int kg, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + kg * 8);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = kg * 8 + 2 * e < C ? f.x : 0.f;
      v[2 * e + 1] = kg * 8 + 2 * e + 1 < C ? f.y : 0.f;
    }
  };
  for (int rg = 0; rg < 16; rg += 8) {
    const __nv_bfloat16* row = xs + (rg + ri) * LX;
    float s = 0.f;
    for (int kg = cq; kg < KG; kg += 4) {
      float v[8];
      load(row, kg, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[e];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    const float mean = s / C;
    float q = 0.f;
    for (int kg = cq; kg < KG; kg += 4) {
      float v[8];
      load(row, kg, v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (kg * 8 + e < C) q += (v[e] - mean) * (v[e] - mean);
    }
    q += __shfl_xor_sync(0xffffffffu, q, 8);
    q += __shfl_xor_sync(0xffffffffu, q, 16);
    const float rstd = rsqrtf(q / C + 1e-5f);
    for (int kg = cq; kg < KG; kg += 4) {
      float v[8];
      load(row, kg, v);
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kg * 8 + 2 * e;
        const float y0 = c < C ? (v[2 * e] - mean) * rstd * __ldg(g + c) + __ldg(b + c) : 0.f;
        const float y1 = c + 1 < C ? (v[2 * e + 1] - mean) * rstd * __ldg(g + c + 1) + __ldg(b + c + 1) : 0.f;
        o[e] = hm_pack(y0, y1);
      }
      *reinterpret_cast<uint4*>(lnb + sm_kmajor(kg * 8, row0 + rg + ri, KC)) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// Region of coordinate i of the rolled map along an axis of length n:
// [0, n - ws) -> 0, [n - ws, n - shift) -> 1, [n - shift, n) -> 2.
__device__ __forceinline__ int sm_region(int i, int n, int shift) {
  return i < n - SM_WS ? 0 : (i < n - shift ? 1 : 2);
}

__device__ __forceinline__ float sm_gelu(float v) { return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)); }

// -- the kernel -------------------------------------------------------------------------

// KS: 16-column k-steps of a head (pad16(d) / 16); NP: proj's and fc2's
// product width (sm_np).
template <int KS, int NP>
__global__ void __launch_bounds__(SM_THREADS, 1) swin_block_mma_kernel(const SmArgs a, const SmGeom G) {
  using T = __nv_bfloat16;
  constexpr int NQ = 48 * KS, NQT = NQ / 8, DP = 16 * KS, NCT = NP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  uint64_t* full = (uint64_t*)(smem + SM_SLOTS * SM_SLOT_BYTES);
  uint64_t* empty = full + SM_SLOTS;
  int* off = (int*)(smem + SM_SLOTS * SM_SLOT_BYTES + 64);  // after 64 bytes of barriers
  const int pairs = blockIdx.x < a.npairs ? (a.npairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (tid == 0) {
    for (int i = 0; i < SM_SLOTS; ++i) sm_bar_init(&full[i], 1), sm_bar_init(&empty[i], SM_CWARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    int n = 0;
    off[0] = 0;
    G.stages([&](int elems) {
      off[n + 1] = off[n] + elems;
      ++n;
      return (long long)elems;
    });
  }
  __syncthreads();
  SmRing ring{smem, full, empty, off, a.w, a.nst, a.nst * pairs, 0, 0, 0};
  if (tid == 0)
    for (int k = 0; k < SM_SLOTS - 1 && k < ring.total; ++k) ring.issue(k);

  // warp = 4 win + wr owns token rows 16 wr .. 16 wr + 15 of window win
  const int win = warp >> 2, wr = warp & 3;
  const int C = G.C, d = G.d, LX = G.LX, KC = G.KC;
  T* const xs = (T*)(smem + G.smem_bytes() - (SM_WINDOWS - win) * G.window_bytes());
  T* const lnb = xs + SM_TOK * LX;   // K-major (64 rows x KC)
  T* const kvb = lnb + SM_TOK * KC;  // two buffers of k (K-major in d) then v (K-major in tokens)
  T* const xw = xs + 16 * wr * LX;   // this warp's rows

  const int nwx = a.W / SM_WS, nwi = nwx * (a.H / SM_WS), shift = a.shift;
  const float qscale = rsqrtf((float)d);
  const int C4 = C / 4;
  int kvsel = 0;
  float acc[NCT][4];
  for (int p = blockIdx.x; p < a.npairs; p += gridDim.x) {
    const int g = 2 * p + win;
    const bool valid = g < a.nwin;
    const int img = valid ? g / nwi : 0, wi = g % nwi, wy = wi / nwx, wx = wi % nwx;
    // element offset of this warp's token row r in the map (through the shift)
    auto src = [&](int r) -> size_t {
      const int t = 16 * wr + r;
      const int hs = (wy * SM_WS + t / SM_WS + shift) % a.H, ws = (wx * SM_WS + t % SM_WS + shift) % a.W;
      return (((size_t)img * a.H + hs) * a.W + ws) * C;
    };
    for (int i = lane; i < 16 * C4; i += 32) {
      const int r = i / C4, c = (i - r * C4) * 4;
      hm_cp_async<8>(xw + r * LX + c, valid ? a.x + src(r) + c : a.x, valid);
    }
    hm_cp_commit();
    hm_cp_wait_upto(0);
    __syncwarp();
    sm_layernorm16(xw, LX, lnb, 16 * wr, KC, C, a.ln1_w, a.ln1_b);
    // mask bit 4 nt + i: element i of score tile nt (row gq + 8 (i / 2), key
    // 8 nt + 2 tq + i % 2) lies in another region than its query
    uint32_t mbits = 0;
    if (shift) {
      const int rw0 = sm_region(wx * SM_WS + 2 * tq, a.W, shift), rw1 = sm_region(wx * SM_WS + 2 * tq + 1, a.W, shift);
      const int rq = sm_region(wx * SM_WS + gq, a.W, shift);
      const int q0 = 3 * sm_region(wy * SM_WS + 2 * wr, a.H, shift) + rq;
      const int q1 = 3 * sm_region(wy * SM_WS + 2 * wr + 1, a.H, shift) + rq;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int kh = 3 * sm_region(wy * SM_WS + nt, a.H, shift);
        mbits |= (uint32_t)(kh + rw0 != q0) << (4 * nt) | (uint32_t)(kh + rw1 != q0) << (4 * nt + 1) |
                 (uint32_t)(kh + rw0 != q1) << (4 * nt + 2) | (uint32_t)(kh + rw1 != q1) << (4 * nt + 3);
      }
    }
    wg_proxy_fence();
    sm_window_sync(win);  // the window's LN rows are in, for wgmma

    for (int h = 0; h < G.heads; ++h) {
      // q|k|v of head h; q stays in registers as the A operand of q k^T, k
      // and v go to the window's buffer
      T* const kbuf = kvb + kvsel * 2 * SM_TOK * DP;
      T* const vbuf = kbuf + SM_TOK * DP;
      kvsel ^= 1;
      uint32_t qa[KS][4];
      {
        float aq[NQT][4];
        sm_gemm_ln<NQ>(&aq[0][0], lnb, KC, G.RQ, ring);
#pragma unroll
        for (int nt = 0; nt < NQT; ++nt) {
          const int part = nt / (2 * KS), jt = nt % (2 * KS), j = jt * 8 + 2 * tq;
          const float* bp = a.bqkv + part * C + h * d;
          const float bj0 = j < d ? __ldg(bp + j) : 0.f, bj1 = j + 1 < d ? __ldg(bp + j + 1) : 0.f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 16 * wr + gq + 8 * hh;
            const float v0 = j < d ? aq[nt][2 * hh] + bj0 : 0.f, v1 = j + 1 < d ? aq[nt][2 * hh + 1] + bj1 : 0.f;
            if (part == 0) {
              qa[jt >> 1][(jt & 1) * 2 + hh] = hm_pack(v0 * qscale, v1 * qscale);
            } else if (part == 1) {  // k: token r's row, K-major in j
              *reinterpret_cast<__nv_bfloat162*>(kbuf + sm_kmajor(j, r, DP)) = __floats2bfloat162_rn(v0, v1);
            } else {  // v: column j's row, K-major in tokens
              vbuf[sm_kmajor(r, j, SM_TOK)] = __float2bfloat16(v0);
              vbuf[sm_kmajor(r, j + 1, SM_TOK)] = __float2bfloat16(v1);
            }
          }
        }
      }
      wg_proxy_fence();
      sm_window_sync(win);  // the window's k and v are in
      const T* const pb = ring.acquire();  // the head's bias fragments, then its rows of proj
      // s = q k^T + bias (+ mask): the warp's 16 queries x 64 keys
      float s[8][4];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wg_rs<64>(&s[0][0], qa[ks], wg_desc(kbuf + ks * 128, 128, DP * 16), ks > 0);
      wg_commit();
      wg_wait0();
      wg_hold<32>(&s[0][0]);
      wg_hold<4 * KS>(&qa[0][0]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float4 bb = reinterpret_cast<const float4*>(pb)[(wr * 8 + nt) * 32 + lane];
        s[nt][0] += bb.x, s[nt][1] += bb.y, s[nt][2] += bb.z, s[nt][3] += bb.w;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if ((mbits >> (4 * nt + i)) & 1u) s[nt][i] += -100.f;
      }
      // softmax over the 64 keys of rows gq and gq + 8: p = 2^((s - max) log2 e),
      // rounded to bf16 as P V's A fragments; l the f32 row sums
      float mb[2], l[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
        mb[hh] = sm_quad_max(mx) * SM_LOG2E;
      }
      uint32_t pa[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[nt][i] = sm_exp2(fmaf(s[nt][i], SM_LOG2E, -mb[i >> 1]));
          l[i >> 1] += s[nt][i];
        }
        pa[nt >> 1][(nt & 1) * 2] = hm_pack(s[nt][0], s[nt][1]);
        pa[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(s[nt][2], s[nt][3]);
      }
      const float inv0 = 1.f / sm_quad_sum(l[0]), inv1 = 1.f / sm_quad_sum(l[1]);
      // o = p v: 16 x pad16(d)
      float o[2 * KS][4];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wg_rs<DP>(&o[0][0], pa[ks], wg_desc(vbuf + ks * 128, 128, SM_TOK * 16), ks > 0);
      wg_commit();
      wg_wait0();
      wg_hold<8 * KS>(&o[0][0]);
      wg_hold<16>(&pa[0][0]);
      // the attention output, normalised and rounded, times the head's rows of proj
      uint32_t oa[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        oa[ks][0] = hm_pack(o[2 * ks][0] * inv0, o[2 * ks][1] * inv0);
        oa[ks][1] = hm_pack(o[2 * ks][2] * inv1, o[2 * ks][3] * inv1);
        oa[ks][2] = hm_pack(o[2 * ks + 1][0] * inv0, o[2 * ks + 1][1] * inv0);
        oa[ks][3] = hm_pack(o[2 * ks + 1][2] * inv1, o[2 * ks + 1][3] * inv1);
      }
      const T* const wp = pb + SM_BIAS_ELEMS;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wg_rs<NP>(&acc[0][0], oa[ks], wg_desc(wp + ks * 128, 128, DP * 16), h > 0 || ks > 0);
      wg_commit();
      wg_wait0();
      wg_hold<NP / 2>(&acc[0][0]);
      wg_hold<4 * KS>(&oa[0][0]);
      ring.release();
    }

    // z = x + proj + bproj, rounded, over x; then LN2
#pragma unroll
    for (int nt = 0; nt < NCT; ++nt) {
      const int n = nt * 8 + 2 * tq;
      if (n >= C) continue;
      const float b0 = __ldg(a.bproj + n), b1 = __ldg(a.bproj + n + 1);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        __nv_bfloat162* zp = reinterpret_cast<__nv_bfloat162*>(xw + (gq + 8 * hh) * LX + n);
        const float2 xv = __bfloat1622float2(*zp);
        *zp = __floats2bfloat162_rn(xv.x + (acc[nt][2 * hh] + b0), xv.y + (acc[nt][2 * hh + 1] + b1));
      }
    }
    __syncwarp();
    sm_layernorm16(xw, LX, lnb, 16 * wr, KC, C, a.ln2_w, a.ln2_b);
    wg_proxy_fence();
    sm_window_sync(win);

    // the MLP in chunks of 64 hidden units: fc1, GELU, rounded, as fc2's A
    for (int c0 = 0; c0 < G.hidden; c0 += SM_CHUNK) {
      const int hc = G.chunk(c0), hct = hc / 8;
      uint32_t ha[4][4];
      {
        float af[8][4];
        sm_gemm_fc1(&af[0][0], hc, lnb, KC, G.rows(hc), ring);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = c0 + nt * 8 + 2 * tq;
          const bool in = nt < hct;
          const float bj0 = in && n < G.hidden ? __ldg(a.b1 + n) : 0.f;
          const float bj1 = in && n + 1 < G.hidden ? __ldg(a.b1 + n + 1) : 0.f;
          const float f0 = in ? af[nt][0] : 0.f, f1 = in ? af[nt][1] : 0.f;
          const float f2 = in ? af[nt][2] : 0.f, f3 = in ? af[nt][3] : 0.f;
          ha[nt >> 1][(nt & 1) * 2] = hm_pack(sm_gelu(f0 + bj0), sm_gelu(f1 + bj1));
          ha[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(sm_gelu(f2 + bj0), sm_gelu(f3 + bj1));
        }
      }
      const T* const w2 = ring.acquire();
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (2 * ks < hct) wg_rs<NP>(&acc[0][0], ha[ks], wg_desc(w2 + ks * 128, 128, hc * 16), c0 > 0 || ks > 0);
      wg_commit();
      wg_wait0();
      wg_hold<NP / 2>(&acc[0][0]);
      wg_hold<16>(&ha[0][0]);
      ring.release();
    }

    // y = z + fc2 + b2, rounded, over z; then the rows go out whole
#pragma unroll
    for (int nt = 0; nt < NCT; ++nt) {
      const int n = nt * 8 + 2 * tq;
      if (n >= C) continue;
      const float b0 = __ldg(a.b2 + n), b1 = __ldg(a.b2 + n + 1);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        __nv_bfloat162* yp = reinterpret_cast<__nv_bfloat162*>(xw + (gq + 8 * hh) * LX + n);
        const float2 zv = __bfloat1622float2(*yp);
        *yp = __floats2bfloat162_rn(zv.x + (acc[nt][2 * hh] + b0), zv.y + (acc[nt][2 * hh + 1] + b1));
      }
    }
    __syncwarp();
    if (valid)
      for (int i = lane; i < 16 * C4; i += 32) {
        const int r = i / C4, c = (i - r * C4) * 4;
        *reinterpret_cast<uint2*>(a.out + src(r) + c) = *reinterpret_cast<const uint2*>(xw + r * LX + c);
      }
    __syncwarp();
  }
}

template <int KS, int NP>
static cudaError_t sm_launch(const SmArgs& a, const SmGeom& G, int blocks, cudaStream_t stream) {
  auto kernel = swin_block_mma_kernel<KS, NP>;
  const int bytes = (int)G.smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, SM_THREADS, bytes, stream>>>(a, G);
  return cudaGetLastError();
}

template <int KS>
static cudaError_t sm_launch_np(const SmArgs& a, const SmGeom& G, int blocks, cudaStream_t stream) {
  switch (G.NP) {
    case 32: return sm_launch<KS, 32>(a, G, blocks, stream);
    case 64: return sm_launch<KS, 64>(a, G, blocks, stream);
    case 96: return sm_launch<KS, 96>(a, G, blocks, stream);
    case 128: return sm_launch<KS, 128>(a, G, blocks, stream);
    default: return sm_launch<KS, 184>(a, G, blocks, stream);
  }
}

// Elements of the packed blob for a geometry (ops/cuda/swin_block.py checks
// its own count against it), or -1 for a geometry the kernel does not take.
extern "C" long long swin_block_mma_elements(int C, int heads, int hidden) {
  if (C < 4 || C > SM_MAX_C || C % 4 || heads < 1 || C % heads || C / heads > 32 || hidden < 1) return -1;
  const SmGeom G(C, heads, hidden);
  int nst = 0;
  const long long total = G.stages([&](int elems) { return ++nst, (long long)elems; });
  return nst <= SM_MAX_STAGES ? total : -1;
}

extern "C" int swin_block_mma_bf16(const void* x, void* out, const void* packed, const void* ln1_w, const void* ln1_b,
                                   const void* bqkv, const void* bproj, const void* ln2_w, const void* ln2_b,
                                   const void* b1, const void* b2, int B, int H, int W, int C, int heads, int hidden,
                                   int shift, long long pack_elems, void* stream) {
  if (swin_block_mma_elements(C, heads, hidden) != pack_elems || B < 1 || H < SM_WS || W < SM_WS || H % SM_WS ||
      W % SM_WS || shift < 0 || shift >= SM_WS)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)packed % 16 || (uintptr_t)x % 8 || (uintptr_t)out % 8) return (int)cudaErrorMisalignedAddress;
  const SmGeom G(C, heads, hidden);
  SmArgs a;
  a.x = (const __nv_bfloat16*)x;
  a.out = (__nv_bfloat16*)out;
  a.w = (const __nv_bfloat16*)packed;
  a.ln1_w = (const float*)ln1_w, a.ln1_b = (const float*)ln1_b, a.bqkv = (const float*)bqkv;
  a.bproj = (const float*)bproj, a.ln2_w = (const float*)ln2_w, a.ln2_b = (const float*)ln2_b;
  a.b1 = (const float*)b1, a.b2 = (const float*)b2;
  a.H = H, a.W = W, a.shift = shift;
  a.nwin = B * (H / SM_WS) * (W / SM_WS);
  a.npairs = (a.nwin + SM_WINDOWS - 1) / SM_WINDOWS;
  a.nst = 0;
  G.stages([&](int elems) { return ++a.nst, (long long)elems; });
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int blocks = a.npairs < sms ? a.npairs : sms;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(G.DP == 32 ? sm_launch_np<2>(a, G, blocks, s) : sm_launch_np<1>(a, G, blocks, s));
}
