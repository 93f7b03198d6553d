// B1 in f32, written for the H100: the whole Swin transformer block,
//   z = x + proj(WA(LN1 x)),  y = z + fc2(gelu(fc1(LN2 z))),
// window attention (WA) over 8 x 8 windows with the relative-position bias
// and, for shifted blocks, the shifted-window mask.
//
// Replaces studiosr_tpu/ops/pallas/swin_block.py::fused_swin_block (:691) in
// f32, the dtype of SwinFIR's recipe (a SwinFIR model is f32 unless halved)
// and of every fused f32 check; bf16 runs swin_block_mma.cu, geometries this
// kernel does not take swin_block.cu. Semantics as there: the shift folded
// into the reads and writes (token (h, w) of the rolled map is read from and
// written back to ((h + s) mod H, (w + s) mod W)), the mask from per-token
// region ids, the output aligned with the input; products accumulate in
// f32, LayerNorm and softmax statistics in f32, GELU is h Phi(h) (am_gauss:
// the erf GELU to f32 accuracy).
//
// Bound on the card at the main path's 264 x 264 x 180 map (6 heads of 30,
// hidden 360): 2 T C (3C + C + 2 hidden) + 4 T 64 C = 39.35 GFLOP against
// about 58 MB, so operations: 0.2386 ms at 3xTF32 (164.9 TFLOP/s), 0.588 on
// the FMA pipes. swin_block.cu ran a window a 256-thread block, every product
// on the FMA pipes through gemm64 in shared memory (a barrier every 32-row
// weight chunk), and packed all four weights into a scratch on every launch.
// Here every product is 3xTF32 (tf32x3.cuh: operands split hi / lo, three
// TF32 terms, each 32-row K stage in a fresh accumulator added to the running
// f32 sum), all on wgmma's tf32 form, A from registers:
// * A block holds two windows, a warpgroup each (a warp 16 token rows), and
//   every weight stage serves both (m64n96k8, B from shared memory).
// * The weights come packed at load time (ops/cuda/swin_block.py
//   pack_swin_f32): one f32 blob of equal stages, each the hi then the lo
//   K-major image (tfw_image) of a 32 x 96 block, in the order the kernel
//   consumes them; per head its q|k|v columns (32 a part: head dims padded
//   to 32) by 32 LN channels, then its 32 rows of proj for each 96-column
//   output tile; per 96 hidden units fc1's columns by 32 LN channels, then
//   fc2's rows for each 32 units and output tile. proj's and fc2's rows are
//   permuted inside each 8-row group (row i < 4 holds unit 2 i, row i >= 4
//   unit 2 (i - 4) + 1), so that the attention output and the GELU output,
//   held as accumulators (columns 2 t, 2 t + 1), are A fragments as they
//   lie. The bias of each head comes in score-fragment order (a float4 a
//   lane and key tile). The stages stream through a ring of three slots,
//   one bulk copy a stage on mbarriers, two stages ahead, across heads and
//   the MLP; the two warpgroups run apart by up to a stage (no block-wide
//   barrier a stage), so one's epilogues and waits run under the other's
//   products.
// * LN1 rows (a warp a row) go to a 64 x C tile in shared memory, the A
//   operand of q|k|v. Per head: q stays in registers as the A fragments of
//   q k^T; k and v are split once into hi / lo K-major images in shared
//   memory (their rows permuted like proj's, to meet q's and the
//   probabilities' fragments); scores (m64n64k8) and p v (m64n32k8, two
//   32-key stages) run on wgmma, the bias, mask and softmax (f32 statistics)
//   in registers; the head's output is the A operand of its rows of proj,
//   which accumulate over the heads in registers with the block's output
//   tile.
// * z = x + proj + bproj stays in those registers; LN2's statistics come
//   from them (quad shuffles) and LN2 z goes to the LN tile, fc1's A. The
//   MLP in chunks of 96 hidden units: fc1 + b1 and GELU in registers, the
//   A operand of fc2's rows of the chunk, which accumulate onto z. y is
//   written back from registers, through the shift.
// What bounds it (scripts/torch_ablate_f32_serving.py, ms at the main
// path's shape, full 1.02, the unchanged kernel 1.02-1.07 across variants):
// one TF32 term a weight product instead of three 0.83, no weight loads
// 0.99, no attention products 1.03, so the tensor pipes' share is a fifth
// and the rest is each stage's wait on its products and the serial phases
// of a window, with two warpgroups an SM (255 registers a thread: the 64 x
// 192 output tile is 96 of them). A block-wide barrier a stage (the
// warpgroups in step) took 1.15, LN1's rows one at a time 1.12.
// Takes window 8, C a multiple of 4 up to 180 (two windows' tiles and three
// slots fill the 227 KB of shared memory: 231,984 B at C 180), head dims up
// to 32, any hidden, H and W multiples of 8; ops/cuda/swin_block.py
// f32_mma_takes routes anything else to swin_block.cu.
#include <cmath>
#include <initializer_list>

#include "tf32x3.cuh"

constexpr int SB32_TOK = 64;              // a window: 8 x 8 tokens, one wgmma M tile
constexpr int SB32_THREADS = 256;         // two windows, a warpgroup each
constexpr int SB32_BN = 96;               // columns a stage: one wgmma N tile
constexpr int SB32_DP = 32;               // a head's q, k, v columns (head dims padded to 32)
constexpr int SB32_STAGE = 2 * SB32_BN * TF_BK;  // floats a stage: hi image, then lo image
constexpr int SB32_SLOTS = 3;             // ring slots: stages s + 1 and s + 2 in flight under s
constexpr int SB32_IMG = SB32_DP * SB32_TOK;  // floats of a k or v image plane (hi or lo)
constexpr int SB32_MAX_C = 180;           // the widest C whose two windows and three slots fit (LDL = C)
constexpr int SB32_BIAS = SB32_TOK * SB32_TOK;  // floats of a head's bias
// a packed 8-row group's row holding unit u % 8 of its group (the inverse of
// the permutation ops/cuda/swin_block.py _PERM8 applies)
__device__ __forceinline__ int sb32_row8(int u) { return (u & ~7) | ((u & 1) << 2) | ((u & 7) >> 1); }

__host__ __device__ inline int sb32_pad32(int v) { return (v + 31) & ~31; }

// The geometry, shared by the kernel and the host; ops/cuda/swin_block.py
// swin_f32_stages mirrors the stage order.
struct Sb32Geom {
  int C, heads, hidden, d, KS, NT, chunks, LDL;
  __host__ __device__ Sb32Geom(int C_, int heads_, int hidden_) : C(C_), heads(heads_), hidden(hidden_) {
    d = C / heads;
    KS = sb32_pad32(C) / TF_BK;                 // 32-row K stages of the LN products
    NT = (C + SB32_BN - 1) / SB32_BN;           // output tiles of proj and fc2
    chunks = (hidden + SB32_BN - 1) / SB32_BN;  // hidden chunks
    LDL = C % 8 == 4 ? C : C + 4;               // LN tile rows: 4 mod 8 floats, conflict-free fragment loads
  }
  __host__ __device__ int stages() const { return heads * (KS + NT) + chunks * (KS + 3 * NT); }
  // a window's LN tile, k and v images (hi and lo each) and region ids
  __host__ __device__ size_t window_floats() const { return (size_t)SB32_TOK * LDL + 4 * SB32_IMG + SB32_TOK; }
  __host__ __device__ size_t smem_bytes() const {  // the slots, two windows, the ring's mbarriers
    return ((size_t)SB32_SLOTS * SB32_STAGE + 2 * window_floats()) * 4 + 2 * SB32_SLOTS * 8;
  }
};

__host__ inline bool sb32_geometry_ok(int C, int heads, int hidden) {
  return heads >= 1 && C >= 4 && C % 4 == 0 && C <= SB32_MAX_C && C % heads == 0 && C / heads <= SB32_DP &&
         hidden >= 1;
}

struct Sb32Args {
  const float *x, *w, *bias, *ln1_w, *ln1_b, *bqkv, *bproj, *ln2_w, *ln2_b, *b1, *b2;
  float* out;
  int H, W, shift, windows, nwi;
  float scale;  // 1 / sqrt(d), rounded once
};

// e^v for the softmax: ex2.approx of v log2(e) (max relative error 2^-22).
__device__ __forceinline__ float sb32_exp(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v * 1.4426950408889634f));
  return r;
}

// 12 products of one 32-row stage: d = A (this warp's fragments ah / al of
// four k-steps) x the stage at sb (hi image, then lo image), d fresh.
__device__ __forceinline__ void sb32_stage(float* d, uint32_t (&ah)[4][4], uint32_t (&al)[4][4], const float* sb) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bh = wg_desc(sb + 64 * kk, 128, 1024), bl = wg_desc(sb + SB32_BN * TF_BK + 64 * kk, 128, 1024);
    tfw_rs<SB32_BN>(d, al[kk], bh, kk > 0);
    tfw_rs<SB32_BN>(d, ah[kk], bl, 1);
    tfw_rs<SB32_BN>(d, ah[kk], bh, 1);
  }
  wg_commit();
  wg_wait0();
  wg_hold<SB32_BN / 2>(d);
  wg_hold<16>(&ah[0][0]);
  wg_hold<16>(&al[0][0]);
}

// The A fragments of four k-steps from accumulator-ordered values v (the
// 16 of this thread's columns 8 m + 2 t, + 1 for m = m0 .. m0 + 3 of rows
// g, g + 8): k-step kk's A column t is column 8 (m0 + kk) + 2 t, column t +
// 4 the next one (the packed rows are permuted to match).
__device__ __forceinline__ void sb32_acc_frags(const float* v, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float av[4] = {v[4 * kk], v[4 * kk + 2], v[4 * kk + 1], v[4 * kk + 3]};
    tf_split4(av, ah[kk], al[kk]);
  }
}

template <int NT>
__global__ void __launch_bounds__(SB32_THREADS, 1) sb32_kernel(const Sb32Args a, const Sb32Geom G) {
  extern __shared__ __align__(128) float ssm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wi = warp & 3;  // this warp's window of the pair; its token rows 16 wi ..
  const int C = G.C, LDL = G.LDL;
  float* const ring = ssm;
  float* const Lt = ssm + SB32_SLOTS * SB32_STAGE + wg * G.window_floats();  // LN tile
  float* const Ks = Lt + SB32_TOK * LDL;  // k's hi then lo image: B of q k^T (32 dims x 64 keys)
  float* const Vs = Ks + 2 * SB32_IMG;    // v's hi then lo image: B of p v (64 keys x 32 dims)
  int* const reg = (int*)(Vs + 2 * SB32_IMG);
  const int w = 2 * blockIdx.x + wg;
  const bool live = w < a.windows;  // the second window of the last pair may be missing
  const int img = live ? w / a.nwi : 0, wix = live ? w % a.nwi : 0;
  const int nst = G.stages();

  // -- the weight ring: stage s in slot s % 3, filled by one bulk copy that
  // thread 0 issues when its warp takes stage s - 2, once all eight warps
  // have released that slot (mbarriers, no block-wide barrier a stage: the
  // two windows' warpgroups run apart by up to a stage) -----------------------------
  uint64_t* const full = (uint64_t*)(ssm + SB32_SLOTS * SB32_STAGE + 2 * G.window_floats());
  uint64_t* const empty = full + SB32_SLOTS;
  auto issue = [&](int s) {
    const int sl = s % SB32_SLOTS;
    am_bar_wait(&empty[sl], ((s / SB32_SLOTS) & 1) ^ 1);
    am_bulk_load(ring + sl * SB32_STAGE, a.w + (size_t)s * SB32_STAGE, SB32_STAGE * 4, &full[sl]);
  };
  if (tid == 0) {
    for (int i = 0; i < SB32_SLOTS; ++i) am_bar_init(&full[i], 1), am_bar_init(&empty[i], SB32_THREADS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < SB32_SLOTS - 1 && s < nst; ++s) issue(s);
  int s_next = 0;
  // the next stage's slot, once it is in
  auto next_stage = [&]() -> const float* {
    const int s = s_next, sl = s % SB32_SLOTS;
    if (tid == 0 && s + SB32_SLOTS - 1 < nst) issue(s + SB32_SLOTS - 1);
    __syncwarp();
    am_bar_wait(&full[sl], (s / SB32_SLOTS) & 1);
    return ring + sl * SB32_STAGE;
  };
  // this warp is done with the stage next_stage gave it
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) am_bar_arrive(&empty[s_next % SB32_SLOTS]);
    ++s_next;
  };
  // the window's four warps (named barrier 1 + wg; barrier 0 is __syncthreads')
  auto window_sync = [&]() { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); };

  // -- LN1 rows (warp wi: rows 16 wi .. 16 wi + 15), region ids ------------------------
  for (int r0_ = 16 * wi; r0_ < 16 * wi + 16; r0_ += 4) {  // four rows' loads in flight at once
    float4 v[4][2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k][0] = v[k][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) tf_load_row(a.x + window_token_offset(img, wix, r0_ + k, a.H, a.W, C, a.shift), C, v[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      tf_ln_fwd(v[k], C, a.ln1_w, a.ln1_b, Lt + (r0_ + k) * LDL);
      if (lane == 0) reg[r0_ + k] = window_token_region(wix, r0_ + k, a.H, a.W, a.shift);
    }
  }

  const int r0 = 16 * wi + g;  // this thread's token rows r0, r0 + 8
  const float* const la = Lt + r0 * LDL + t;
  // the A fragments of LN stage ks (columns past C read as zeros: the rows
  // are LDL >= C apart, and the packed weights are zero there)
  auto ln_frags = [&](int ks, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
    const int left = C - TF_BK * ks - t;  // columns 8 kk (+ 4) below it are in the map
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* p = la + TF_BK * ks + 8 * kk;
      const bool c0 = 8 * kk < left, c4 = 8 * kk + 4 < left;
      const float av[4] = {c0 ? p[0] : 0.f, c0 ? p[8 * LDL] : 0.f, c4 ? p[4] : 0.f, c4 ? p[8 * LDL + 4] : 0.f};
      tf_split4(av, ah[kk], al[kk]);
    }
  };

  // the shifted-window mask of this thread's query rows r0, r0 + 8: bit 2
  // nt + e set where key 8 nt + 2 t + e lies in another region
  uint32_t apart[2] = {0u, 0u};
  window_sync();  // the region ids are in
  if (a.shift)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          apart[hh] |= (uint32_t)(reg[8 * nt + 2 * t + e] != reg[r0 + 8 * hh]) << (2 * nt + e);

  float y[NT][SB32_BN / 2];  // proj over the heads, then z, then y: columns 96 nt + 8 m + 2 t + e
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < SB32_BN / 2; ++i) y[nt][i] = 0.f;
  float acc[SB32_BN / 2], part[SB32_BN / 2];
  uint32_t ah[4][4], al[4][4];
  const float scale = a.scale;

  for (int h = 0; h < G.heads; ++h) {
    // q|k|v of head h = LN1 Wqkv_h + bqkv_h
#pragma unroll
    for (int i = 0; i < SB32_BN / 2; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < G.KS; ++ks) {
      const float* sb = next_stage();
      ln_frags(ks, ah, al);
      sb32_stage(part, ah, al, sb);
      release();
#pragma unroll
      for (int i = 0; i < SB32_BN / 2; ++i) acc[i] += part[i];
    }
    // column 32 p + j: part p (q, k, v), head dim j (zero past d); q scaled
    // and kept in acc; k and v split into their images: k's dims and v's
    // keys in the row order of the A fragments that meet them (sb32_row8)
#pragma unroll
    for (int m = 0; m < SB32_BN / 8; ++m) {
      const int p = m / 4, j = 8 * (m % 4) + 2 * t;
      const float b0 = j < G.d ? __ldg(a.bqkv + p * C + h * G.d + j) : 0.f;
      const float b1 = j + 1 < G.d ? __ldg(a.bqkv + p * C + h * G.d + j + 1) : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float& v0 = acc[4 * m + 2 * hh];
        float& v1 = acc[4 * m + 2 * hh + 1];
        v0 = j < G.d ? v0 + b0 : 0.f;
        v1 = j + 1 < G.d ? v1 + b1 : 0.f;
        const int r = r0 + 8 * hh;
        if (p == 0) {
          v0 *= scale, v1 *= scale;
        } else {
          // k: (dim, key) of a 32 x 64 image; v: (key, dim) of a 64 x 32 image
          const int i0 = p == 1 ? tfw_image(sb32_row8(j), r) : (j / 8) * 512 + (sb32_row8(r) / 4) * 32 + (j % 8) * 4 + sb32_row8(r) % 4;
          const int i1 = p == 1 ? tfw_image(sb32_row8(j + 1), r) : i0 + 4;
          float* const im = p == 1 ? Ks : Vs;
          uint32_t hi, lo;
          tf_split(v0, hi, lo);
          im[i0] = __uint_as_float(hi), im[SB32_IMG + i0] = __uint_as_float(lo);
          tf_split(v1, hi, lo);
          im[i1] = __uint_as_float(hi), im[SB32_IMG + i1] = __uint_as_float(lo);
        }
      }
    }
    // the head's bias fragments, in flight under the scores
    const float4* bf = reinterpret_cast<const float4*>(a.bias + (size_t)h * SB32_BIAS) + wi * 8 * 32 + lane;
    float4 bias4[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) bias4[nt] = __ldg(bf + nt * 32);
    wg_proxy_fence();  // the images, seen by wgmma
    window_sync();     // k and v in

    // scores = q k^T on wgmma (m64n64k8): q (acc columns 0..31) as A
    // fragments, k's image as B; one 32-row stage
    float sc[32];
    sb32_acc_frags(acc, ah, al);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t kh = wg_desc(Ks + 64 * kk, 128, 1024), kl = wg_desc(Ks + SB32_IMG + 64 * kk, 128, 1024);
      tfw_rs<64>(sc, al[kk], kh, kk > 0);
      tfw_rs<64>(sc, ah[kk], kl, 1);
      tfw_rs<64>(sc, ah[kk], kh, 1);
    }
    wg_commit();
    wg_wait0();
    wg_hold<32>(sc);
    wg_hold<16>(&ah[0][0]);
    wg_hold<16>(&al[0][0]);
    // bias (fragment order), mask, softmax with f32 statistics; score (row g
    // + 8 hh, key 8 nt + 2 t + e) is sc[4 nt + 2 hh + e]
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float bv[4] = {bias4[nt].x, bias4[nt].y, bias4[nt].z, bias4[nt].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = sc[4 * nt + e] + bv[e];
        if ((apart[e >> 1] >> (2 * nt + (e & 1))) & 1) v -= 100.f;
        sc[4 * nt + e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) mx[hh] = am_quad_max(mx[hh]);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = sb32_exp(sc[i] - mx[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.f / am_quad_sum(l[hh]);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= inv[(i >> 1) & 1];

    // o = p v on wgmma (m64n32k8): the probabilities as A fragments (key 8 kb
    // + 2 t + e is A column t + 4 e of k-step kb), v's image as B; two
    // 32-key stages, each in a fresh accumulator
    float o[16], opart[16];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sb32_acc_frags(sc + 16 * half, ah, al);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int kb = 4 * half + kk;
        const uint64_t vh = wg_desc(Vs + 64 * kb, 128, 2048), vl = wg_desc(Vs + SB32_IMG + 64 * kb, 128, 2048);
        tfw_rs<32>(opart, al[kk], vh, kk > 0);
        tfw_rs<32>(opart, ah[kk], vl, 1);
        tfw_rs<32>(opart, ah[kk], vh, 1);
      }
      wg_commit();
      wg_wait0();
      wg_hold<16>(opart);
      wg_hold<16>(&ah[0][0]);
      wg_hold<16>(&al[0][0]);
#pragma unroll
      for (int i = 0; i < 16; ++i) o[i] = half ? o[i] + opart[i] : opart[i];
    }
    // its rows of proj: o's columns 8 nd + 2 t, + 1 are the permuted rows'
    // A fragments
    sb32_acc_frags(o, ah, al);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* sb = next_stage();
      sb32_stage(part, ah, al, sb);
      release();
#pragma unroll
      for (int i = 0; i < SB32_BN / 2; ++i) y[nt][i] += part[i];
    }
  }

  // z = x + (proj + bproj) in y (zero past C); LN2 z to the LN tile
  size_t pix[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) pix[hh] = live ? window_token_offset(img, wix, r0 + 8 * hh, a.H, a.W, C, a.shift) : 0;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int m = 0; m < SB32_BN / 8; ++m) {
      const int c = SB32_BN * nt + 8 * m + 2 * t;
      const bool in = c < C;  // C a multiple of 4: c + 1 < C too
      const float2 bp = in ? __ldg(reinterpret_cast<const float2*>(a.bproj + c)) : make_float2(0.f, 0.f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 xv = in && live ? __ldg(reinterpret_cast<const float2*>(a.x + pix[hh] + c)) : make_float2(0.f, 0.f);
        float& v0 = y[nt][4 * m + 2 * hh];
        float& v1 = y[nt][4 * m + 2 * hh + 1];
        v0 = in ? xv.x + (v0 + bp.x) : 0.f;
        v1 = in ? xv.y + (v1 + bp.y) : 0.f;
        sum[hh] += v0 + v1;
      }
    }
  float mean[2], rstd[2], sq[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) mean[hh] = am_quad_sum(sum[hh]) / C;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int m = 0; m < SB32_BN / 8; ++m) {
      const int c = SB32_BN * nt + 8 * m + 2 * t;
      if (c >= C) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float d0 = y[nt][4 * m + 2 * hh] - mean[hh], d1 = y[nt][4 * m + 2 * hh + 1] - mean[hh];
        sq[hh] += d0 * d0 + d1 * d1;
      }
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) rstd[hh] = rsqrtf(am_quad_sum(sq[hh]) / C + 1e-5f);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int m = 0; m < SB32_BN / 8; ++m) {
      const int c = SB32_BN * nt + 8 * m + 2 * t;
      if (c >= C) continue;
      const float2 lw = __ldg(reinterpret_cast<const float2*>(a.ln2_w + c));
      const float2 lb = __ldg(reinterpret_cast<const float2*>(a.ln2_b + c));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(Lt + (r0 + 8 * hh) * LDL + c) =
            make_float2((y[nt][4 * m + 2 * hh] - mean[hh]) * rstd[hh] * lw.x + lb.x,
                        (y[nt][4 * m + 2 * hh + 1] - mean[hh]) * rstd[hh] * lw.y + lb.y);
    }
  // (the next stage's barrier makes the tile visible to the warp's other lanes)

  // the MLP in chunks of 96 hidden units; fc2 accumulates onto z
  for (int ch = 0; ch < G.chunks; ++ch) {
#pragma unroll
    for (int i = 0; i < SB32_BN / 2; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < G.KS; ++ks) {
      const float* sb = next_stage();
      ln_frags(ks, ah, al);
      sb32_stage(part, ah, al, sb);
      release();
#pragma unroll
      for (int i = 0; i < SB32_BN / 2; ++i) acc[i] += part[i];
    }
#pragma unroll
    for (int m = 0; m < SB32_BN / 8; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int u = SB32_BN * ch + 8 * m + 2 * t + e;
        const float b = u < G.hidden ? __ldg(a.b1 + u) : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float hv = u < G.hidden ? acc[4 * m + 2 * hh + e] + b : 0.f;
          float cdf, pdf;
          am_gauss(hv, cdf, pdf);
          acc[4 * m + 2 * hh + e] = hv * cdf;
        }
      }
#pragma unroll
    for (int kst = 0; kst < 3; ++kst) {
      sb32_acc_frags(acc + 16 * kst, ah, al);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* sb = next_stage();
        sb32_stage(part, ah, al, sb);
        release();
#pragma unroll
        for (int i = 0; i < SB32_BN / 2; ++i) y[nt][i] += part[i];
      }
    }
  }
  // y = z + fc2 + b2, written back through the shift
  if (!live) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int m = 0; m < SB32_BN / 8; ++m) {
      const int c = SB32_BN * nt + 8 * m + 2 * t;
      if (c >= C) continue;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b2 + c));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(a.out + pix[hh] + c) =
            make_float2(y[nt][4 * m + 2 * hh] + bb.x, y[nt][4 * m + 2 * hh + 1] + bb.y);
    }
}

// Floats of the packed blob (ops/cuda/swin_block.py checks its own count
// against it): the stages, then each head's bias; -1 for a geometry the
// kernel does not take.
extern "C" long long swin_block_mma_f32_elements(int C, int heads, int hidden) {
  if (!sb32_geometry_ok(C, heads, hidden)) return -1;
  const Sb32Geom G(C, heads, hidden);
  return (long long)G.stages() * SB32_STAGE + (long long)heads * SB32_BIAS;
}

template <int NT>
static cudaError_t sb32_launch(const Sb32Args& a, const Sb32Geom& G, cudaStream_t stream) {
  const size_t bytes = G.smem_bytes();
  cudaError_t err = allow_smem(sb32_kernel<NT>, bytes);
  if (err != cudaSuccess) return err;
  sb32_kernel<NT><<<(a.windows + 1) / 2, SB32_THREADS, bytes, stream>>>(a, G);
  return cudaGetLastError();
}

// packed: the blob of ops/cuda/swin_block.py pack_swin_f32 (the weights'
// stages, then the bias); LayerNorm weights and biases f32, natural order.
extern "C" int swin_block_mma_f32(const void* x, void* out, const void* packed, const void* ln1_w, const void* ln1_b,
                                  const void* bqkv, const void* bproj, const void* ln2_w, const void* ln2_b,
                                  const void* b1, const void* b2, int B, int H, int W, int C, int heads, int hidden,
                                  int shift, long long packed_elems, void* stream) {
  if (!sb32_geometry_ok(C, heads, hidden) || B < 1 || H < 8 || W < 8 || H % 8 || W % 8 || shift < 0 || shift >= 8)
    return (int)cudaErrorInvalidValue;
  const Sb32Geom G(C, heads, hidden);
  if (packed_elems != (long long)G.stages() * SB32_STAGE + (long long)heads * SB32_BIAS)
    return (int)cudaErrorInvalidValue;
  for (const void* p : std::initializer_list<const void*>{x, out, packed, ln1_w, ln1_b, ln2_w, ln2_b, bproj, b2})
    if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
  Sb32Args a;
  a.x = (const float*)x, a.out = (float*)out, a.w = (const float*)packed;
  a.bias = a.w + (size_t)G.stages() * SB32_STAGE;
  a.ln1_w = (const float*)ln1_w, a.ln1_b = (const float*)ln1_b, a.bqkv = (const float*)bqkv;
  a.bproj = (const float*)bproj, a.ln2_w = (const float*)ln2_w, a.ln2_b = (const float*)ln2_b;
  a.b1 = (const float*)b1, a.b2 = (const float*)b2;
  a.H = H, a.W = W, a.shift = shift, a.nwi = (H / 8) * (W / 8), a.windows = B * a.nwi;
  a.scale = (float)(1.0 / std::sqrt((double)G.d));
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(G.NT == 1 ? sb32_launch<1>(a, G, st) : sb32_launch<2>(a, G, st));
}
