// B7 in bf16, written for the H100: the backward of the MLP half of a Swin
// block with the forward recomputed,
//   y = x + d * fc2(gelu(fc1(LN x))),  d = dp[row / rows_per_sample],
// over token rows: from x and the cotangent g it emits dx and the f32
// gradients of the LN scale and bias, fc1 (W1, b1) and fc2 (W2, b2).
//
// Replaces studiosr_tpu/ops/pallas/mlp_vjp.py::_bwd (:148, reached through
// _dp_bwd) in bf16; f32, the checks' dtype, keeps mlp_bwd.cu. The contract is
// its: g_b = d g rounded to bf16, dx = g_b + LN-backward(dln) + (1 - d) g;
// the LN output, gelu(h1), dh1 and g_b rounded to bf16; products accumulate
// in f32; LN statistics and the LN backward in f32; the exact erf GELU;
// every sum across blocks in a fixed order (no atomics: the same bits from
// run to run).
//
// Bound on the card at the training shapes (R = 131,072 rows, C 180, hidden
// 360): 5 products of 2 R C hidden, 85 GFLOP, against 141 MB for x, g and dx,
// so the tensor-core rate (0.086 ms). mlp_bwd.cu ran three products a 64-row
// tile on wmma with its f32 dh1 tile in shared memory, one block of eight
// warps a tile, and its weight gradients on wgrad.cuh's wmma. Here, the
// structure of attn_bwd_mma.cu with GELU in place of the attention (its
// pieces in am_common.cuh), rows in 64-row tiles:
// 0. mb_ln_kernel, a warp a row: LN (its f32 statistics kept) and g_b, to
//    row-major scratch rows, at full occupancy; the rows are padded to whole
//    pairs of 64-row tiles, the padding zero.
// 1. mb_prod_kernel, a tile a warpgroup, two a block: the tile's LN and g_b
//    rows by cp.async into K-major tiles; per chunk of 96 hidden units, h1 =
//    LN W1 and dg1 = g_b W2^T on wgmma (K = C padded to 16), W1's and W2^T's
//    columns of the chunk streamed once per tile pair through the four-slot
//    cp.async.bulk / mbarrier ring; in registers h1 + b1, gelu(h1) and dh1 =
//    dg1 gelu'(h1), both rounded to row-major scratch rows (hidden padded to
//    16, the padding zero), each staged through shared memory so that a
//    warp writes whole 16-byte pieces of its rows.
// 2. am_rowgemm_kernel: dln = dh1 W1^T on wgmma (A the tile's dh1 rows in
//    64-column chunks, W1^T streamed), in f32 to a scratch.
// 3. mb_lnb_kernel, a warp a row: the LN backward and dx, and per-block
//    column sums of dln xhat and dln (summed in a fixed order).
// 4. am_wgrad: dW1 = LN^T dh1, dW2 = gelu(h1)^T g_b and the bias gradients
//    as column sums, split-K f32 partials on wgmma summed in a fixed order.
// The weights change every step, so they are packed per call (one gather by
// the index table of ops/cuda/mlp_bwd.py _pack_index, am_pack_kernel): per
// chunk of 96 hidden units, in stages of 64 K rows, the images of W1's and
// W2^T's columns; then W1^T (K the padded hidden units) in stages of 64
// rows; each stage the image of a ring slot in wgmma's K-major core-matrix
// layout (am_kmajor in am_common.cuh, _k_major there: change both together).
// Takes bf16, C a multiple of 4 up to 184, hidden up to 512 (MB_MAX_HIDDEN).
#include "am_common.cuh"

constexpr int MB_CHUNK = 96;  // hidden units a product chunk
// hidden units at most: MaxSR's feed-forward (dim 128 x 4), six chunks, the
// last 32 wide. The chunk loop and pass 2's K loop are not unrolled, and no
// shared memory, register or ring table grows with it (at most 18 stages of
// the 80 the ring's table holds); only the scratch rows do. Mirrored by
// ops/cuda/mlp_bwd.py MMA_MAX_HIDDEN.
constexpr int MB_MAX_HIDDEN = 512;

// The geometry, shared by the kernels and the host; the packed layout is
// mirrored by ops/cuda/mlp_bwd.py.
struct MbGeom {
  int C, hidden, KC, SC, HP, NP, chunks;
  __host__ __device__ MbGeom(int C_, int hidden_) : C(C_), hidden(hidden_) {
    KC = am_pad16(C);
    SC = (C + 7) & ~7;
    HP = am_pad16(hidden);
    NP = am_np(C);
    chunks = (HP + MB_CHUNK - 1) / MB_CHUNK;
  }
  // a chunk's stages: AM_KSTAGE K rows each, W1's columns then W2^T's
  __host__ __device__ int kstages() const { return (KC + AM_KSTAGE - 1) / AM_KSTAGE; }
  __host__ __device__ int krows(int s) const { return am_min(AM_KSTAGE, KC - AM_KSTAGE * s); }
  __host__ __device__ long long prod_elems() const { return (long long)chunks * 2 * KC * MB_CHUNK; }
  __host__ __device__ long long pack_elems() const { return prod_elems() + (long long)HP * NP; }
};

struct MbArgs {
  const bf16 *x, *g;
  bf16* dx;
  const float *ln_w, *ln_b, *b1, *dp;
  const bf16* w;  // the packed weights
  bf16 *ln, *gb, *g1, *dh1;
  float *stats, *dln, *lnst;
  long long rows;
  int tiles, rps;
};

// Pass 0, a warp a row: LN, its statistics and g_b of rows below R; the
// padding rows past R zero.
__global__ void __launch_bounds__(256) mb_ln_kernel(const MbArgs a, const MbGeom G) {
  const long long rows64 = (long long)a.tiles * AM_TOK;
  for (long long row = blockIdx.x * 8LL + (threadIdx.x >> 5); row < rows64; row += gridDim.x * 8LL) {
    if (row < a.rows) {
      const float dd = a.dp ? a.dp[row / a.rps] : 1.f;
      am_ln_row<true>(a.x + row * G.C, a.g + row * G.C, dd, G.C, G.SC, a.ln_w, a.ln_b, a.stats + 2 * row,
                      a.ln + row * G.SC, a.gb + row * G.SC);
    } else {
      for (int c = 4 * (threadIdx.x & 31); c < G.SC; c += 128) {
        *reinterpret_cast<uint2*>(a.ln + row * G.SC + c) = make_uint2(0u, 0u);
        *reinterpret_cast<uint2*>(a.gb + row * G.SC + c) = make_uint2(0u, 0u);
      }
    }
  }
}

constexpr int MB_SROW = MB_CHUNK + 8;  // a staged row's stride (elements): rows 16-byte aligned, no bank conflicts

// Shared memory of pass 1: the ring, its barriers, then per warpgroup its
// LN and g_b tiles (K-major, 64 x KC), then per warpgroup the row-major
// staging of a chunk's 64 x 96 outputs (223,616 bytes at C 180).
__host__ __device__ inline size_t mb_prod_smem(const MbGeom& G) {
  return (size_t)AM_SLOTS * AM_SLOT_BYTES + AM_HEAD_BYTES + 2 * (size_t)2 * AM_TOK * G.KC * 2 +
         2 * (size_t)AM_TOK * MB_SROW * 2;
}

// Pass 1, one warpgroup a 64-row tile, two a block, persistent over tile
// pairs (the tile count is even, so both tiles of a pair are real and no
// branch between a warpgroup's products depends on its tile).
__global__ void __launch_bounds__(256, 1) mb_prod_kernel(const MbArgs a, const MbGeom G) {
  constexpr int NT = MB_CHUNK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int wg = warp >> 2, wr = warp & 3;
  bf16* lnb = (bf16*)(smem + AM_SLOTS * AM_SLOT_BYTES + AM_HEAD_BYTES) + (size_t)wg * 2 * AM_TOK * G.KC;
  bf16* gbb = lnb + AM_TOK * G.KC;
  // this warp's 16 staged rows
  bf16* stg = (bf16*)(smem + AM_SLOTS * AM_SLOT_BYTES + AM_HEAD_BYTES) + (size_t)4 * AM_TOK * G.KC +
              (size_t)(4 * wg + wr) * 16 * MB_SROW;
  const int npairs = (a.tiles + 1) / 2;
  const int pairs = blockIdx.x < npairs ? (npairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int kst = G.kstages(), nst = G.chunks * kst;
  AmRing ring = am_ring_start(smem, a.w, nst, nst * pairs, 8, [&](int j) { return 2 * G.krows(j % kst) * MB_CHUNK; });
  const int KC = G.KC;
  for (int p = blockIdx.x; p < npairs; p += gridDim.x) {
    const int tile = 2 * p + wg;
    am_wg_sync(wg);  // the warpgroup's products on the last tiles are done
    am_load_rows(KC, G.SC, a.ln, tile, true, lnb);
    am_load_rows(KC, G.SC, a.gb, tile, true, gbb);
    hm_cp_commit();
    hm_cp_wait_upto(0);
    wg_proxy_fence();
    am_wg_sync(wg);
    for (int ch = 0; ch < G.chunks; ++ch) {
      float ah[NT][4], ag[NT][4];  // h1 - b1 and dg1 of the chunk's 96 hidden units
      for (int sk = 0; sk < kst; ++sk) {
        const bf16* st = ring.acquire();
        const int k0 = sk * AM_KSTAGE, kr = G.krows(sk);
        wg_fence();
        for (int kk = 0; kk < kr; kk += 16)
          wg_ss<MB_CHUNK>(&ah[0][0], wg_desc(lnb + (k0 + kk) * 8, 128, KC * 16), wg_desc(st + kk * 8, 128, kr * 16),
                          k0 + kk > 0);
        for (int kk = 0; kk < kr; kk += 16)
          wg_ss<MB_CHUNK>(&ag[0][0], wg_desc(gbb + (k0 + kk) * 8, 128, KC * 16),
                          wg_desc(st + kr * MB_CHUNK + kk * 8, 128, kr * 16), k0 + kk > 0);
        wg_commit();
        wg_wait0();
        wg_hold<NT * 4>(&ah[0][0]);
        wg_hold<NT * 4>(&ag[0][0]);
        ring.release();
      }
      // gelu(h1) and dh1 = dg1 gelu'(h1), rounded (zero past the hidden
      // units and past the last row)
      uint32_t pg[NT][2], pd[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = ch * MB_CHUNK + nt * 8 + 2 * tq;
        const float bj[2] = {j < G.hidden ? __ldg(a.b1 + j) : 0.f, j + 1 < G.hidden ? __ldg(a.b1 + j + 1) : 0.f};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long row = (long long)tile * AM_TOK + 16 * wr + gq + 8 * hh;
          float gl[2], dh[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float h = ah[nt][2 * hh + e] + bj[e];
            float cdf, pdf;
            am_gauss(h, cdf, pdf);
            const bool in = row < a.rows && j + e < G.hidden;
            gl[e] = in ? h * cdf : 0.f;
            dh[e] = in ? ag[nt][2 * hh + e] * (cdf + h * pdf) : 0.f;
          }
          pg[nt][hh] = hm_pack(gl[0], gl[1]);
          pd[nt][hh] = hm_pack(dh[0], dh[1]);
        }
      }
      // each through the warp's staging rows to whole 16-byte pieces of
      // the rows: the chunk's columns below HP (a multiple of 16)
      const int pieces = am_min(MB_CHUNK, G.HP - ch * MB_CHUNK) / 8;
      const long long row0 = (long long)tile * AM_TOK + 16 * wr;
#pragma unroll
      for (int out = 0; out < 2; ++out) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<uint32_t*>(stg + (gq + 8 * hh) * MB_SROW + nt * 8 + 2 * tq) =
                out ? pd[nt][hh] : pg[nt][hh];
        __syncwarp();
        bf16* dst = (out ? a.dh1 : a.g1) + row0 * G.HP + ch * MB_CHUNK;
        for (int i = lane; i < 16 * pieces; i += 32) {
          const int r = i / pieces, pc = i - r * pieces;
          *reinterpret_cast<uint4*>(dst + (long long)r * G.HP + 8 * pc) =
              *reinterpret_cast<const uint4*>(stg + r * MB_SROW + 8 * pc);
        }
        __syncwarp();
      }
    }
  }
}

// Pass 3, a warp a row (block b takes rows b, b + gridDim, ...): the LN
// backward and dx (am_lnb_row), and the block's column sums of dln xhat and
// dln into lnst[block][2 C].
__global__ void __launch_bounds__(256) mb_lnb_kernel(const MbArgs a, const MbGeom G) {
  __shared__ float sums[8][2 * AM_MAX_C];
  const int warp = threadIdx.x >> 5, C = G.C;
  float cs[3][4] = {};
  for (long long row = blockIdx.x + (long long)gridDim.x * warp; row < a.rows; row += gridDim.x * 8LL) {
    const float dd = a.dp ? a.dp[row / a.rps] : 1.f;
    am_lnb_row(a.dln + row * C, a.x + row * C, a.g + row * C, a.dx + row * C, a.stats[2 * row], a.stats[2 * row + 1],
               dd, C, a.ln_w, cs);
  }
  am_lnb_sums(cs, C, sums, a.lnst + (long long)blockIdx.x * 2 * C);
}

static bool mb_geometry_ok(int C, int hidden) {
  return C >= 4 && C <= AM_MAX_C && C % 4 == 0 && hidden >= 1 && hidden <= MB_MAX_HIDDEN;
}

// Scratch in bf16: LN and g_b rows (SC), gelu(h1) and dh1 rows (HP), the
// packed weights and the slack am_wgrad reads past its last tile; every row
// count padded to whole tile pairs (the padding rows zero). In f32: LN statistics (2 a row), dln rows
// (C), pass 3's blocks' column sums and their sums by eights, the wgrad
// partials.
struct MbScratch {
  long long rows64, ln, gb, g1, dh1, pack, t_elems;
  long long stats, dln, lnst, wg, f_elems;
  int tiles, prod_blocks, row_blocks;
};

static MbScratch mb_scratch(int rows, int C, int hidden, int sms) {
  const MbGeom G(C, hidden);
  MbScratch S;
  S.tiles = ((rows + 2 * AM_TOK - 1) / (2 * AM_TOK)) * 2;  // whole tile pairs
  S.rows64 = (long long)S.tiles * AM_TOK;
  const int pairs = (S.tiles + 1) / 2;
  S.prod_blocks = pairs < sms ? pairs : sms;
  S.row_blocks = 8 * sms;
  S.ln = 0;
  S.gb = S.ln + S.rows64 * G.SC;
  S.g1 = S.gb + S.rows64 * G.SC;
  S.dh1 = S.g1 + S.rows64 * G.HP;
  S.pack = S.dh1 + S.rows64 * G.HP;
  S.t_elems = S.pack + G.pack_elems() + 2 * WG_BM;
  S.stats = 0;
  S.dln = S.stats + 2 * S.rows64;
  S.lnst = S.dln + S.rows64 * C;
  S.wg = S.lnst + (long long)(S.row_blocks + sms) * 2 * C;
  const long long p1 = aw_plan(S.rows64, C, hidden, sms).part_elems, p2 = aw_plan(S.rows64, hidden, C, sms).part_elems;
  S.f_elems = S.wg + (p1 > p2 ? p1 : p2);
  return S;
}

// Elements of the packed weights (ops/cuda/mlp_bwd.py checks its own count
// against it), or -1 for a geometry the kernels do not take.
extern "C" long long mlp_bwd_mma_pack_elems(int C, int hidden) {
  return mb_geometry_ok(C, hidden) ? MbGeom(C, hidden).pack_elems() : -1;
}

extern "C" int mlp_bwd_mma_scratch(int rows, int C, int hidden, long long* t_elems, long long* f_elems) {
  int sms = 0;
  const cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const MbScratch S = mb_scratch(rows, C, hidden, sms);
  *t_elems = S.t_elems;
  *f_elems = S.f_elems;
  return 0;
}

// w1 (C x hidden) and w2 (hidden x C), (in, out) layout, are gathered by
// pack_index; dw1 (C x hidden), db1, dw2 (hidden x C), db2 and ds_db (the LN
// scale's gradient, then its bias's) come back in f32.
extern "C" int mlp_bwd_mma_bf16(const void* x, const void* g, void* dx, int rows, int C, int hidden, const void* ln_w,
                                const void* ln_b, const void* w1, const void* b1, const void* w2, const void* dp,
                                int rows_per_sample, const void* pack_index, long long pack_elems, void* ds_db,
                                void* dw1, void* db1, void* dw2, void* db2, void* tscratch, long long t_elems,
                                void* fscratch, long long f_elems, void* stream) {
  if (!mb_geometry_ok(C, hidden) || rows < 1 || (dp && rows_per_sample <= 0)) return (int)cudaErrorInvalidValue;
  const MbGeom G(C, hidden);
  int sms = 0;
  cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const MbScratch S = mb_scratch(rows, C, hidden, sms);
  if (S.t_elems != t_elems || S.f_elems != f_elems || G.pack_elems() != pack_elems) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 8 || (uintptr_t)g % 8 || (uintptr_t)dx % 8 || (uintptr_t)tscratch % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  bf16* t = (bf16*)tscratch;
  float* f = (float*)fscratch;
  MbArgs a{};
  a.x = (const bf16*)x, a.g = (const bf16*)g, a.dx = (bf16*)dx;
  a.ln_w = (const float*)ln_w, a.ln_b = (const float*)ln_b, a.b1 = (const float*)b1, a.dp = (const float*)dp;
  a.w = t + S.pack;
  a.ln = t + S.ln, a.gb = t + S.gb, a.g1 = t + S.g1, a.dh1 = t + S.dh1;
  a.stats = f + S.stats, a.dln = f + S.dln, a.lnst = f + S.lnst;
  a.rows = rows, a.tiles = S.tiles, a.rps = rows_per_sample;

  const long long n1 = (long long)C * hidden;
  err = am_pack((const bf16*)w1, n1, (const bf16*)w2, n1, (const int*)pack_index, pack_elems, t + S.pack, st);
  if (err != cudaSuccess) return (int)err;
  mb_ln_kernel<<<S.row_blocks, 256, 0, st>>>(a, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = mb_prod_smem(G);
  err = allow_smem(mb_prod_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  mb_prod_kernel<<<S.prod_blocks, 256, bytes, st>>>(a, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = am_rowgemm(AmRowGemm{a.dh1, a.w + G.prod_elems(), G.HP, G.HP, S.tiles}, C, AmStoreF32{a.dln, C}, S.prod_blocks,
                   st);
  if (err != cudaSuccess) return (int)err;
  mb_lnb_kernel<<<S.row_blocks, 256, 0, st>>>(a, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // block b's partial is part s = b / sms of group b % sms: first the eight
  // of each group, then the groups, in order
  float* lnst1 = a.lnst + (long long)S.row_blocks * 2 * C;
  err = reduce_parts(a.lnst, S.row_blocks / sms, (long long)sms * 2 * C, lnst1, st);
  if (err != cudaSuccess) return (int)err;
  err = reduce_parts(lnst1, sms, 2LL * C, (float*)ds_db, st);
  if (err != cudaSuccess) return (int)err;
  err = am_wgrad(a.ln, G.SC, a.dh1, G.HP, S.rows64, C, hidden, (float*)dw1, (float*)db1, f + S.wg, sms, st);
  if (err != cudaSuccess) return (int)err;
  return (int)am_wgrad(a.g1, G.HP, a.gb, G.SC, S.rows64, hidden, C, (float*)dw2, (float*)db2, f + S.wg, sms, st);
}
