// The attention core's forward above window 16 in bf16, written for the
// H100: one design for B5's large family (window_attention_mma.cu, windows
// from 17), B12's large entry (oca_fwd_mma.cu, above 256 queries or 576
// keys) and B10's attention pass above 576 keys (ocab_mma.cu). On a unit u
// (window w, head h) of QT query tiles and KT key chunks of 64 tokens, the
// images of the caller's earlier pass (q, k, each 64 x DP K-major in d; v
// K-major in the token) and a bias:
//   out = softmax(q k^T + bias [+ mask]) v.
// The contract is the families' (and what B9's large family recomputes,
// lb_core.cuh): scores and the softmax in f32, online over the 64-key
// chunks in ascending order with the row max subtracted; 2^(s - m) rounded
// to bf16 before its product with v, the division by the row sum after the
// product; the output rounded once; every output row has one owner and no
// sum crosses blocks (no atomics: two launches give the same bits). Each
// element's arithmetic is the kernels' this replaces (wa_attn_large_kernel,
// of_fwd_ring_kernel), in the same order.
//
// What held those back (scripts/torch_ablate_large_fwd.py, the kernels
// before this core, at the HAT window-24 step): B5's shifted windows
// computed the shift's region of every key of every chunk, integer
// divisions by ws, 0.68 of its pass's 1.13 ms; B12's threads read their
// bias rows from L2 in the chunk loop, 0.37 of 1.46; and each chunk ran its
// score product, a wait, its softmax, its p v product and a wait in series,
// the chunk's copies issued by every thread and met by a block barrier.
//
// Here a block owns (unit u, query tile r): one warpgroup, at most 54 KB of
// shared memory, four blocks an SM (scripts/torch_ablate_large_fwd.py's
// "design" variants: three tiles a block sharing one k / v stream, with
// three warpgroups and a producer warp, ran 10 to 15 % slower than blocks of
// one tile, four an SM; a shared stream saves little where the chunk loads
// are 2 % of the time, and independent blocks hide each other's waits).
// - A ring of S stages (S from LF_MIN_STAGES to LF_MAX_STAGES, as the
//   block's share of shared memory allows), each a key chunk's k and v
//   images, the tile's bias against that chunk (in fragment order: B5's from
//   am_bias_kernel, B12 / B10's reordered per call by of_bias_kernel; a
//   bf16 bias loaded into registers instead measured within 2 %) and the
//   chunk's 64 key tags, filled by cp.async.bulk copies completing on the
//   stage's `full` mbarrier. Warp 0 refills a stage (chunk c + S) right
//   after chunk c's p v, which ends every read of it (a producer warp of its
//   own, or an `empty` mbarrier the four warps arrive on, cost 5 to 10 %:
//   the first leaves three blocks an SM, the second stalls warp 0). No
//   block-wide barrier is left in the chunk loop.
// - The warpgroup issues chunk c + 1's score product and chunk c's p v
//   product together (FlashAttention-3's order), waits for the first, and
//   takes chunk c + 1's softmax while the tensor cores finish the second;
//   one score accumulator, q and p held as register A fragments (q is read
//   from shared memory once, not by every chunk's product). Nothing between
//   a product's issue and its wait branches, or ptxas serialises every
//   product of the kernel (C7515): the shift's mask is a compile-time
//   variant of the loop, the bias's dtype a template parameter.
// - B5's shift: a window off the last row and column of windows has one
//   region, so it takes no mask (exactly as before: every -100 there was
//   skipped); the others have their key regions computed once a chunk, as
//   it is loaded, the query regions once a block.
// What bounds it now (the same script): no one pipe. At the HAT window-24
// step the pass takes 0.53 ms against 0.11 of the tensor cores and 0.14 of
// the exponentials on the SFUs; taking out the softmax saves 35 %, the
// products 17 %, the mask 15 %, the bias reads 13 %, and waiting for chunk
// c's p v before the softmax (no overlap) costs nothing measurable: a
// latency chain a step that four blocks an SM do not hide.
// Shared memory: the q tile, S stages, the barriers; at most LF_SMEM.
#pragma once

#include <type_traits>

#include "am_common.cuh"

constexpr int LF_BLOCKS = 4;  // blocks an SM
// a block's share of the SM's 233,472 bytes of shared memory (1 KB of each
// block's is the system's)
constexpr int LF_SMEM = 233472 / LF_BLOCKS - 1024;
constexpr int LF_MIN_STAGES = 2, LF_MAX_STAGES = 4;
constexpr int LF_TAGS = 64;  // bytes of key tags a stage

// The layout of a block's shared memory: the q tile, then S stages of [k
// chunk | v chunk | bias tile of bias_tile bytes | 64 key tags], each
// rounded to 128 bytes, then the barriers full[S] and the q tile's
// (ops/cuda/large_fwd.py mirrors it).
struct LfLayout {
  int DP, S, bias_tile;
  __host__ __device__ int q_bytes() const { return AM_TOK * DP * 2; }
  __host__ __device__ int kv_bytes() const { return 2 * AM_TOK * DP * 2; }
  __host__ __device__ int tag_off() const { return kv_bytes() + bias_tile; }
  __host__ __device__ int stage_bytes() const { return (tag_off() + LF_TAGS + 127) & ~127; }
  __host__ __device__ int bar_off() const { return q_bytes() + S * stage_bytes(); }
  __host__ __device__ int bytes() const { return bar_off() + (LF_MAX_STAGES + 1) * 8; }
};

// The most stages that fit (at least LF_MIN_STAGES: the warpgroup holds
// chunk c's v and c + 1's k at once); S 0 where even those do not.
__host__ __device__ inline LfLayout lf_layout(int DP, int bias_tile) {
  LfLayout L{DP, LF_MAX_STAGES, bias_tile};
  while (L.S > LF_MIN_STAGES && L.bytes() > LF_SMEM) --L.S;
  if (L.bytes() > LF_SMEM) L.S = 0;
  return L;
}

// One arrival on `bar` that also expects `bytes` of bulk copies.
__device__ __forceinline__ void lf_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(hm_smem(bar)), "r"(bytes) : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) that
// completes on `bar`.
__device__ __forceinline__ void lf_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   hm_smem(dst)),
               "l"(src), "r"(bytes), "r"(hm_smem(bar))
               : "memory");
}

// The bias of score fragment (thread wt, 8-column tile nt) of a tile in the
// fragment order of am_bias_kernel / of_bias_kernel: element 128 nt + wt,
// a float4 or (B16) four bf16, rows q, q + 8 and columns p, p + 1 (-inf at a
// padding key, 0 at a padding query); s += it.
template <bool B16>
__device__ __forceinline__ void lf_add_bias(float (&s)[8][4], const unsigned char* tile) {
  const int wt = threadIdx.x & 127;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float4 b;
    if constexpr (B16) {
      const uint2 w = reinterpret_cast<const uint2*>(tile)[nt * 128 + wt];
      const float2 p0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
      const float2 p1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
      b = make_float4(p0.x, p0.y, p1.x, p1.y);
    } else {
      b = reinterpret_cast<const float4*>(tile)[nt * 128 + wt];
    }
    s[nt][0] += b.x, s[nt][1] += b.y, s[nt][2] += b.z, s[nt][3] += b.w;
  }
}

// Bytes of a (query tile, key chunk) bias in fragment order.
__host__ __device__ constexpr int lf_bias_tile(bool b16) { return (b16 ? 8 : 16) * 8 * 128; }

// A family F gives: QT, KT, heads, units; q(u, r), k(u, c), v(u, c), the
// images; bias, the (heads, QT, KT) tiles of its bias in fragment order
// (B16: bf16, else f32), tile (h, r, c) the ((h QT + r) KT + c)-th;
// masked(u), whether unit u's scores take the shift's mask, and tag(u, n),
// token n's region; store(u, r, o, inv, stage), o / l rounded to the
// output (stage: the block's q tile, free once its last product is done).
template <int DP, bool B16, class F>
__global__ void __launch_bounds__(128, LF_BLOCKS) lf_fwd_kernel(const F f, const LfLayout L) {
  constexpr int CH = AM_TOK * DP, KS = DP / 16, NDT = DP / 8, BT = lf_bias_tile(B16);
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tq = lane & 3, q0 = 16 * warp + (lane >> 2);
  const int QT = f.QT, KT = f.KT, S = L.S, SB = L.stage_bytes();
  const long long u = blockIdx.x / QT;
  const int r = (int)(blockIdx.x % QT), h = (int)(u % f.heads);
  bf16* const Q = (bf16*)smem;
  unsigned char* const ring = smem + L.q_bytes();
  uint64_t* const full = (uint64_t*)(smem + L.bar_off());
  uint64_t* const qbar = full + LF_MAX_STAGES;
  const bool mk = f.masked(u);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) am_bar_init(&full[s], 32);
    am_bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const unsigned char* const bias = (const unsigned char*)f.bias + (size_t)(h * QT + r) * KT * BT;
  // chunk c into its stage, by warp 0: its lanes write the key tags, lane 0
  // issues the copies; the stage's full barrier takes the 32 arrivals and
  // the bytes
  auto issue = [&](int c) {
    unsigned char* const sb = ring + (size_t)(c % S) * SB;
    if (mk) {
      signed char* tag = (signed char*)(sb + L.tag_off());
      tag[lane] = (signed char)f.tag(u, c * AM_TOK + lane);
      tag[lane + 32] = (signed char)f.tag(u, c * AM_TOK + lane + 32);
    }
    uint64_t* const bar = &full[c % S];
    if (lane == 0) {
      lf_arrive_expect(bar, L.kv_bytes() + BT);
      lf_copy(sb, f.k(u, c), L.kv_bytes() / 2, bar);
      lf_copy(sb + L.kv_bytes() / 2, f.v(u, c), L.kv_bytes() / 2, bar);
      lf_copy(sb + L.kv_bytes(), bias + (size_t)c * BT, BT, bar);
    } else {
      am_bar_arrive(bar);
    }
  };
  if (warp == 0) {
    if (lane == 0) lf_arrive_expect(qbar, CH * 2), lf_copy(Q, f.q(u, r), CH * 2, qbar);
    for (int c = 0; c < S && c < KT; ++c) issue(c);
  }
  int rq[2] = {0, 0};
  if (mk) rq[0] = f.tag(u, r * AM_TOK + q0), rq[1] = f.tag(u, r * AM_TOK + q0 + 8);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, sc[2], o[NDT][4], s[8][4];
  uint32_t pa[4][4];  // p as wgmma's A fragments, 16 keys each
#pragma unroll
  for (int nt = 0; nt < NDT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  // the scores of the chunk in stage st into s, q from registers: one group
  uint32_t qa[KS][4];  // this warp's 16 rows of q as A fragments, 16 d a slice
  auto scores = [&](int st) {
    const bf16* K = (const bf16*)(ring + (size_t)st * SB);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) wg_rs<64>(&s[0][0], qa[ks], wg_desc(K + ks * 128, 128, DP * 16), ks > 0);
    wg_commit();
  };
  // o = o sc + p v of the chunk in stage st: one group
  auto pv = [&](int st) {
#pragma unroll
    for (int nt = 0; nt < NDT; ++nt) o[nt][0] *= sc[0], o[nt][1] *= sc[0], o[nt][2] *= sc[1], o[nt][3] *= sc[1];
    const bf16* V = (const bf16*)(ring + (size_t)st * SB + L.kv_bytes() / 2);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wg_rs<DP>(&o[0][0], pa[ks], wg_desc(V + ks * 128, 128, AM_TOK * 16), 1);
    wg_commit();
  };
  // chunk c's scores in s: + bias, + the shift's mask where MASKED, then the
  // online softmax: p = 2^(s - m) in s, m and l updated, sc the factor of
  // o. No branch here: it runs while a product is in flight.
  auto softmax = [&](int c, auto masked) {
    const unsigned char* const sbuf = ring + (size_t)(c % S) * SB;
    lf_add_bias<B16>(s, sbuf + L.kv_bytes());
    if constexpr (decltype(masked)::value) {
      const signed char* tag = (const signed char*)(sbuf + L.tag_off());
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + 2 * tq, k0 = tag[col], k1 = tag[col + 1];
        if (k0 != rq[0]) s[nt][0] += -100.f;
        if (k1 != rq[0]) s[nt][1] += -100.f;
        if (k0 != rq[1]) s[nt][2] += -100.f;
        if (k1 != rq[1]) s[nt][3] += -100.f;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      const float mn = fmaxf(m[hh], am_quad_max(mx) * AM_LOG2E);
      sc[hh] = am_exp2(m[hh] - mn);
      l[hh] *= sc[hh], m[hh] = mn;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = am_exp2(fmaf(s[nt][2 * hh + e], AM_LOG2E, -mn));
          s[nt][2 * hh + e] = p;
          l[hh] += p;
        }
    }
  };
  auto pack = [&]() {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      pa[nt >> 1][(nt & 1) * 2] = hm_pack(s[nt][0], s[nt][1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(s[nt][2], s[nt][3]);
    }
  };
  // step c: chunk c + 1's scores and chunk c's p v in flight together, chunk
  // c + 1's softmax under the p v, then chunk c's stage refilled with chunk c
  // + S by warp 0. No barrier is needed for that: every read of the stage
  // is done once chunk c's p v is (k by chunk c's scores, waited for in the
  // step before; the bias and tags by each warp's softmax of chunk c, whose
  // p is that product's operand; v by the product itself, which takes the
  // four warps' operands at once).
  auto step = [&](int c, auto masked) {
    am_bar_wait(&full[(c + 1) % S], ((c + 1) / S) & 1);
    scores((c + 1) % S);
    pv(c % S);
    wg_wait1();  // the scores are in
    wg_hold<32>(&s[0][0]);
    softmax(c + 1, masked);
    wg_wait0();  // chunk c's p v is done, so chunk c's stage is free
    wg_hold<NDT * 4>(&o[0][0]);
    wg_hold<16>(&pa[0][0]);
    if (warp == 0 && c + S < KT) issue(c + S);
    pack();
  };
  auto run = [&](auto masked) {
    am_bar_wait(qbar, 0);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {  // ldmatrix x4: rows + 8 (i & 1), d + 8 (i >> 1) of matrix i = lane / 8
      const int i = lane >> 3;
      hm_ldsm_x4(qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3],
                 Q + am_kmajor(16 * ks + 8 * (i >> 1), 16 * warp + 8 * (i & 1) + (lane & 7), DP));
    }
    am_bar_wait(&full[0], 0);
    scores(0);
    wg_wait0();
    wg_hold<32>(&s[0][0]);
    softmax(0, masked);
    pack();
#pragma unroll 1
    for (int c = 0; c + 1 < KT; ++c) step(c, masked);
    pv((KT - 1) % S);
    wg_wait0();
    wg_hold<NDT * 4>(&o[0][0]);
  };
  if (mk) run(std::true_type{});
  else run(std::false_type{});
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.f / am_quad_sum(l[hh]);
  f.store(u, r, o, inv, Q);
}

// The launch: QT blocks a unit, a unit's blocks neighbours (its k and v
// serve them from L2); b16: the bias tiles are bf16.
template <int DP, class F>
static cudaError_t lf_launch(const F& f, bool b16, cudaStream_t st) {
  const LfLayout L = lf_layout(DP, lf_bias_tile(b16));
  const long long blocks = f.units * f.QT;
  if (L.S == 0 || blocks > 0x7fffffffLL || (uintptr_t)f.bias % 16) return cudaErrorInvalidValue;
  auto kernel = b16 ? lf_fwd_kernel<DP, true, F> : lf_fwd_kernel<DP, false, F>;
  cudaError_t err = allow_smem(kernel, L.bytes());
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, 128, L.bytes(), st>>>(f, L);
  return cudaGetLastError();
}
