// B8 and B9 in bf16, written for the H100: the backward of the attention
// half of a Swin block with the forward recomputed,
//   y = x + d_b * proj(WA(LN x))  on (B, H, W, C) maps,
// window attention over ws x ws windows, ws 2..8 (B8: SwinIR's 8), 9..16 or 17 up
// (B9: HAT's 16), the shift folded into reads and writes. From x and the cotangent g it
// emits dx and the f32 gradients of the LN scale and bias, Wqkv, bqkv,
// Wproj, bproj and the gathered rel-pos bias (heads, N, N).
//
// Replaces studiosr_tpu/ops/pallas/attn_bwd.py::pairs_attention_bwd (:209)
// and ::v5_attention_bwd (:508) in bf16; f32, the checks' dtype, keeps
// attn_bwd.cu / attn_bwd16.cu, and so do head dims above 32. A window of
// N = ws^2 tokens is padded to NCH = ceil(N / 64) whole tiles (am_window.cuh):
// the padding tokens' LN and g_b rows are zeros and their keys score -inf
// (their bias, am_bias_kernel),
// so their p, dscores, dq, dk and dv are zeros and they add nothing to the
// weight gradients, d bias or the LN sums; the entry attn_bwd_mma_bf16 takes
// windows 2..8 (one tile), attn_bwd16_mma_bf16 9..16 (two to four),
// attn_bwd_large_mma_bf16 17 up (pass 2 on lb_core.cuh's two-formation core, below;
// what bounds it there and what its design does about each: lb_core.cuh's note). The contract
// is theirs: g_b = d g rounded to bf16, dx = g_b + LN-backward(dln) + (1 -
// d) g; the LN output, q / k / v, the probabilities, dattn, dscores and dq /
// dk / dv rounded to bf16 (from window 17 the probabilities of attn = p v,
// which feeds d Wproj, are rounded before their normalisation: 2^(s - m)
// rounded, attn divided by the row sum after the product, as B5's forward
// above window 16, lf_core.cuh, rounds them; those of dv and
// dscores after it, as below 17); products accumulate in f32; softmax, its
// backward, the LN backward and d bias in f32; every sum across blocks in a
// fixed order (no atomics: the same bits from run to run).
//
// Bound on the card at the training shapes (T = 131,072 tokens, C 180, 6
// heads of 30): 112 GFLOP (B8) and 166 GFLOP (B9) against 141 MB for x, g
// and dx, so the tensor-core rate (0.11 / 0.17 ms). The older kernels ran
// their products on wmma 64 x 64 tiles, restaged the weights from L2 for
// every window (B8) or every 64 rows (B9), ran the heads of a window one
// after another with a barrier between phases, and B9 computed every score
// three times. Here, one structure for both windows, tokens in tile order
// (64 tokens a tile: a window at 8, a quarter of one at 16):
// 0. am_ln_kernel, a warp a row: LN (its f32 statistics kept) and g_b, to
//    row-major scratch rows, at full occupancy.
// 1. am_proj_kernel, a tile a warpgroup, two a block: the tile's LN and g_b
//    rows by cp.async into K-major tiles; per head, q|k|v = LN Wqkv and
//    dattn = g_b Wproj^T on wgmma, the head's packed weights streamed once
//    per tile pair through a four-slot cp.async.bulk / mbarrier ring. q
//    (scaled), k, v and dattn go out as wgmma's K-major core-matrix image of
//    each (window, head, 64 tokens), 128 contiguous bytes a warp store.
// 2. am_attn_kernel, a block owning (head, 64 queries of the window, a group
//    of windows): the window's k and v and its queries' q and dattn come in
//    by cp.async, the token-contiguous copies the products on the other side
//    need are made by ldmatrix + stmatrix.trans. Sweep 1 computes the scores
//    and dprobs = dattn v^T of every 64-key chunk on wgmma in registers and
//    keeps the row max, sum and D = sum p dp online; sweep 2 recomputes them
//    (over one chunk, windows 2-8, it keeps them), forms p and dscores in
//    registers and runs attn = p v, dq = dscores k, and, from p^T and
//    dscores^T written to shared memory by stmatrix.trans, dk = dscores^T q
//    and dv = p^T dattn. Each block keeps its f32 d bias rows (64 x N) in
//    shared memory across its windows. Over two to four chunks (windows
//    9-16) two warpgroups split the key chunks (at three, warpgroup 1 takes
//    one), and the blocks of a window's query chunks form a cluster: each
//    pushes its dk / dv partial of a chunk into the chunk's owner's inbox
//    in distributed shared memory (st.async, counted on the owner's
//    mbarrier), and the owner adds them in a fixed order when its
//    next window's sweep 2 begins, handing back credits (a remote mbarrier
//    arrival) before any block refills an inbox. The scores are computed
//    twice, not three times. dq|dk|dv and attn go out per token row, heads
//    padded to DP.
// 3. am_rowgemm_kernel (am_common.cuh), a tile a warpgroup: dln = dqkv
//    Wqkv^T on wgmma (A the tile's dq|dk|dv in 64-column chunks by cp.async,
//    B streamed through the ring), in f32 to a scratch; 3b. am_lnb_kernel, a
//    warp a row: the LN backward and dx, and per-block column sums of dln
//    xhat and dln.
// 4. am_wgrad_kernel: d Wqkv = LN^T dqkv, d Wproj = attn^T g_b and the bias
//    gradients over all token rows on wgmma (split-K f32 partials), every
//    partial summed in a fixed order (wgrad.cuh's reduce_parts).
// The element-wise row passes (LN, the LN backward) run on their own, at
// full occupancy: in the product kernels, eight warps an SM left them bound
// by latency (scripts/torch_ablate_attn_bwd.py).
// The weights change every step, so they are packed per call (one gather on
// the stream, am_pack_kernel, by the index table of ops/cuda/attn_bwd.py
// _pack_index): per head, in stages of 96 K rows, its q|k|v columns and its
// rows of Wproj; then Wqkv^T (K the padded dq|dk|dv columns) in stages of
// 64 rows; each stage the image of a ring slot in wgmma's K-major
// core-matrix layout (am_kmajor in am_common.cuh, _k_major there: change both
// together).
// Takes bf16, windows from 2, head dims up to 32, C a multiple of 4 up to
// 184, H and W multiples of the window; the wrapper routes anything else.
// The pieces B5 and B7 share with it are in am_window.cuh and am_common.cuh.
#include "am_window.cuh"
#include "lb_core.cuh"

__device__ __forceinline__ void am_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// p (an address of this block's shared memory) as it lies in block `rank` of
// the cluster.
__device__ __forceinline__ uint32_t am_mapa(const void* p, unsigned rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(hm_smem(p)), "r"(rank));
  return a;
}

// v to the cluster address a, its 16 bytes counted on the mbarrier at cluster
// address bar (complete_tx).
__device__ __forceinline__ void am_st_async(uint32_t a, float4 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
               : "memory");
}

// An arrival, released at cluster scope, on the mbarrier at cluster address bar.
__device__ __forceinline__ void am_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The phase of parity `parity` of a barrier other blocks of the cluster
// arrive on or count bytes on, acquired at cluster scope; traps after about
// ten seconds as am_bar_wait does.
__device__ __forceinline__ void am_bar_wait_cluster(uint64_t* bar, int parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(hm_smem(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// -- pass 2: the attention core ---------------------------------------------------

// Warpgroups of an attention block: two over two to four tiles, splitting
// the key chunks of the block's 64 queries; one over one tile.
__host__ __device__ constexpr int am_wgs(int nch) { return nch == 1 ? 1 : 2; }

struct AmAttnSmem {
  size_t kk, vk, kt, vt, qk, dk, qt, dt, pt, st, slab, inbox, stat, bars, reg, total;
};

// k and v of the whole window (K-major in d, then token-contiguous), q and
// dattn of the block's 64 queries (the same two layouts), per warpgroup p^T
// and dscores^T (A images), the f32 d bias rows, the dk / dv inbox (one
// slot for each partial the block's keys take from the others: NCH - 1), the warpgroups' row
// statistics, two mbarriers and the keys' region ids. At window 16, C 180:
// 231,184 bytes.
__host__ __device__ inline AmAttnSmem am_attn_smem(const AmGeom& G) {
  AmAttnSmem L;
  const int wgs = am_wgs(G.NCH);
  const size_t big = (size_t)G.N * G.DP * 2, small = (size_t)AM_TOK * G.DP * 2, sq = (size_t)AM_TOK * AM_TOK * 2;
  size_t o = 0;
  L.kk = o, o += big;
  L.vk = o, o += big;
  L.kt = o, o += big;
  L.vt = o, o += big;
  L.qk = o, o += small;
  L.dk = o, o += small;
  L.qt = o, o += small;
  L.dt = o, o += small;
  L.pt = o, o += wgs * sq;
  L.st = o, o += wgs * sq;
  L.slab = o, o += (size_t)AM_TOK * G.N * 4;
  L.inbox = o, o += (size_t)(G.NCH - 1) * AM_TOK * G.DP * 2 * 4;
  L.stat = o, o += (size_t)wgs * AM_TOK * 3 * 4;
  L.bars = o, o += 16;  // the inbox's full barrier and the credit barrier
  L.reg = o, o += G.N;
  L.total = (o + 127) & ~(size_t)127;
  return L;
}

// A block owns (head h, query chunk r, window group g); NCH > 1 runs as
// clusters of NCH blocks, one a query chunk, each with two warpgroups:
// warpgroup k takes key chunks (r + 2 i + k) mod NCH for 2 i + k < NCH.
template <int NCH, int DP>
__global__ void __launch_bounds__(128 * am_wgs(NCH), NCH == 1 ? 3 : 1) am_attn_kernel(const AmArgs a, const AmGeom G) {
  constexpr int N = NCH * AM_TOK, KS = DP / 16, NDT = DP / 8;
  constexpr int WGS = am_wgs(NCH), STEPS = (NCH + WGS - 1) / WGS, THREADS = 128 * WGS;
  extern __shared__ __align__(128) unsigned char smem[];
  const AmAttnSmem L = am_attn_smem(G);
  bf16 *Kk = (bf16*)(smem + L.kk), *Vk = (bf16*)(smem + L.vk), *Kt = (bf16*)(smem + L.kt), *Vt = (bf16*)(smem + L.vt);
  bf16 *Qk = (bf16*)(smem + L.qk), *Dk = (bf16*)(smem + L.dk), *Qt = (bf16*)(smem + L.qt), *Dt = (bf16*)(smem + L.dt);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, wr = wt >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  bf16 *PT = (bf16*)(smem + L.pt) + wg * AM_TOK * AM_TOK, *ST = (bf16*)(smem + L.st) + wg * AM_TOK * AM_TOK;
  float4* slab = (float4*)(smem + L.slab);
  float4* inbox = (float4*)(smem + L.inbox);  // per slot 2 NDT x 128 float4
  // full: one phase a window, complete when the owner has arrived and the
  // NCH - 1 partials' bytes are in; credit: one phase a window, complete when
  // the NCH - 1 owners this block sends to have read their inboxes
  uint64_t* full = (uint64_t*)(smem + L.bars);
  uint64_t* credit = full + 1;
  constexpr int INBOX_BYTES = (NCH - 1) * 2 * NDT * 128 * 16;
  int n = 0;  // windows done
  float* stat = (float*)(smem + L.stat);         // [warpgroup][row][m, l, u]
  signed char* reg = (signed char*)(smem + L.reg);
  const int r = blockIdx.x % NCH, hg = blockIdx.x / NCH, h = hg % G.heads, g = hg / G.heads;
  const float dq_scale = rsqrtf((float)G.d);
  for (int i = tid; i < AM_TOK * N / 4; i += THREADS) slab[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (NCH > 1) {
    if (tid == 0) {
      am_bar_init(full, 1), am_bar_init(credit, NCH - 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    am_cluster_sync();  // every block of the cluster runs, its barriers set, before one writes to another
  }
  // the bias of this thread's score fragment of key chunk c, 8-column tile
  // nt: (q0, col), (q0, col + 1), (q0 + 8, col), (q0 + 8, col + 1), from the
  // fragment-ordered copy am_bias_kernel makes (bf16 when the bias is)
  auto bias4 = [&](int c, int nt) -> float4 {
    const size_t e = (((size_t)(h * NCH + r) * NCH + c) * 8 + nt) * 128 + wt;
    if (!a.bias16) return reinterpret_cast<const float4*>(a.relbias)[e];
    const uint2 u = reinterpret_cast<const uint2*>(a.relbias)[e];
    const float2 p0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 p1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(p0.x, p0.y, p1.x, p1.y);
  };

  const int q0 = 16 * wr + gq;  // this thread's query rows q0, q0 + 8 of the chunk

  // dk and dv of the block's own key chunk: this block's partial from step 0
  // of warpgroup 0, then (NCH > 1) the others' from the inbox, added when the
  // next window's sweep 2 begins (or after the last), so that no block waits
  // for another's partials at the end of a window
  float dko[NDT][4], dvo[NDT][4];
  long long own_row0 = 0;  // the first token row of the window dko / dvo belong to
  auto finish_own = [&]() {
    if (wg != 0) return;
    if constexpr (NCH > 1) {
      // the partial of step i, warpgroup k (from block (r - WGS i - k) mod
      // NCH) in order of (i, k); then each of those blocks gets a credit, and
      // waits for it only before it next fills an inbox (or exits)
      am_bar_wait_cluster(full, (n - 1) & 1);
#pragma unroll
      for (int q = 1; q < NCH; ++q) {
        const float4* sb = inbox + (q - 1) * 2 * NDT * 128;
#pragma unroll
        for (int nt = 0; nt < NDT; ++nt) {
          const float4 k4 = sb[nt * 128 + wt], v4 = sb[(NDT + nt) * 128 + wt];
          dko[nt][0] += k4.x, dko[nt][1] += k4.y, dko[nt][2] += k4.z, dko[nt][3] += k4.w;
          dvo[nt][0] += v4.x, dvo[nt][1] += v4.y, dvo[nt][2] += v4.z, dvo[nt][3] += v4.w;
        }
      }
      am_wg_sync(0);  // every thread of warpgroup 0 has read the inbox
      if (tid == 0) {
        // the next window's phase (this arrival and its partials' bytes),
        // armed before any of its partials can come
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(hm_smem(full)), "r"(INBOX_BYTES)
                     : "memory");
        for (int q = 1; q < NCH; ++q)
          am_arrive_cluster(am_mapa(credit, (unsigned)(((r - WGS * (q / WGS) - q % WGS) % NCH + NCH) % NCH)));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NDT; ++nt) {
      const int j = nt * 8 + 2 * tq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        bf16* dr = a.dqkv + (own_row0 + q0 + 8 * hh) * G.K3 + h * DP + j;
        *reinterpret_cast<__nv_bfloat162*>(dr + G.HD) = __floats2bfloat162_rn(dko[nt][2 * hh], dko[nt][2 * hh + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dr + 2 * G.HD) = __floats2bfloat162_rn(dvo[nt][2 * hh], dvo[nt][2 * hh + 1]);
      }
    }
  };
  if (NCH > 1 && tid == 0)  // the first window's phase
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(hm_smem(full)), "r"(INBOX_BYTES)
                 : "memory");

  for (int w = g; w < a.windows; w += a.groups) {
    __syncthreads();  // the last window's buffers are free
    const bf16* unit = a.img + ((long long)w * G.heads + h) * 4 * N * DP;
    {
      constexpr int BIG = N * DP / 8, SMALL = AM_TOK * DP / 8;  // 16-byte pieces
      for (int i = tid; i < 2 * BIG + 2 * SMALL; i += THREADS) {
        const bf16* s;
        bf16* d;
        if (i < BIG) s = unit + N * DP + i * 8, d = Kk + i * 8;
        else if (i < 2 * BIG) s = unit + 2 * N * DP + (i - BIG) * 8, d = Vk + (i - BIG) * 8;
        else if (i < 2 * BIG + SMALL) s = unit + r * AM_TOK * DP + (i - 2 * BIG) * 8, d = Qk + (i - 2 * BIG) * 8;
        else s = unit + 3 * N * DP + r * AM_TOK * DP + (i - 2 * BIG - SMALL) * 8, d = Dk + (i - 2 * BIG - SMALL) * 8;
        hm_cp_async<16>(d, s, true);
      }
      hm_cp_commit();
    }
    const int wi = w % a.nwi;
    if (a.shift)
      for (int t = tid; t < N; t += THREADS) reg[t] = (signed char)am_region(G, a, wi, t);
    hm_cp_wait_upto(0);
    __syncthreads();
    am_transpose<DP>(Kk, Kt, NCH, 4 * WGS);
    am_transpose<DP>(Vk, Vt, NCH, 4 * WGS);
    am_transpose<DP>(Qk, Qt, 1, 4 * WGS);
    am_transpose<DP>(Dk, Dt, 1, 4 * WGS);
    wg_proxy_fence();
    __syncthreads();
    const int rq0 = a.shift ? reg[r * AM_TOK + q0] : 0, rq1 = a.shift ? reg[r * AM_TOK + q0 + 8] : 0;

    // scores (+ bias and mask) and dprobs of key chunk c, this warp's 16 rows
    float s[8][4], dp[8][4];
    auto sd = [&](int c) {
      float4 bb[8];  // the bias, loaded before the products so their latency hides under them
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) bb[nt] = bias4(c, nt);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wg_ss<64>(&s[0][0], wg_desc(Qk + ks * 128, 128, DP * 16), wg_desc(Kk + c * AM_TOK * DP + ks * 128, 128, DP * 16),
                  ks > 0);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wg_ss<64>(&dp[0][0], wg_desc(Dk + ks * 128, 128, DP * 16),
                  wg_desc(Vk + c * AM_TOK * DP + ks * 128, 128, DP * 16), ks > 0);
      wg_commit();
      wg_wait0();
      wg_hold<32>(&s[0][0]);
      wg_hold<32>(&dp[0][0]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = c * AM_TOK + nt * 8 + 2 * tq;
        s[nt][0] += bb[nt].x, s[nt][1] += bb[nt].y, s[nt][2] += bb[nt].z, s[nt][3] += bb[nt].w;
        if (a.shift) {
          const int k0 = reg[col], k1 = reg[col + 1];
          if (k0 != rq0) s[nt][0] += -100.f;
          if (k1 != rq0) s[nt][1] += -100.f;
          if (k0 != rq1) s[nt][2] += -100.f;
          if (k1 != rq1) s[nt][3] += -100.f;
        }
      }
    };

    // sweep 1 over this warpgroup's key chunks: row max m (log2 units), sum
    // l of 2^(s - m) and u of 2^(s - m) dp
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
#pragma unroll 1
    for (int i = 0; i < STEPS; ++i) {
      if (NCH % WGS && WGS * i + wg >= NCH) break;  // NCH 3: warpgroup 1 takes one chunk
      sd((r + WGS * i + wg) % NCH);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
        const float mn = fmaxf(m[hh], am_quad_max(mx) * AM_LOG2E), sc = am_exp2(m[hh] - mn);
        l[hh] *= sc, u[hh] *= sc, m[hh] = mn;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = am_exp2(fmaf(s[nt][2 * hh + e], AM_LOG2E, -mn));
            l[hh] += p, u[hh] += p * dp[nt][2 * hh + e];
          }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = am_quad_sum(l[hh]), u[hh] = am_quad_sum(u[hh]);
    if constexpr (WGS > 1) {
      // both warpgroups combine the two partial statistics of a row in the
      // same order, from shared memory, so they hold the same bits
      if (tq == 0)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float* st = stat + (wg * AM_TOK + q0 + 8 * hh) * 3;
          st[0] = m[hh], st[1] = l[hh], st[2] = u[hh];
        }
      __syncthreads();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float* s0 = stat + (q0 + 8 * hh) * 3;
        const float* s1 = stat + (AM_TOK + q0 + 8 * hh) * 3;
        const float mn = fmaxf(s0[0], s1[0]), e0 = am_exp2(s0[0] - mn), e1 = am_exp2(s1[0] - mn);
        m[hh] = mn, l[hh] = s0[1] * e0 + s1[1] * e1, u[hh] = s0[2] * e0 + s1[2] * e1;
      }
    }
    float linv[2], D[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) linv[hh] = 1.f / l[hh], D[hh] = u[hh] / l[hh];

    // sweep 2: step i takes key chunk (r + WGS i + wg) mod NCH
    float o[NDT][4], dq[NDT][4];
    if (n > 0) {
      finish_own();  // the last window's dk and dv
      if (NCH > 1) am_bar_wait_cluster(credit, (n - 1) & 1);  // the owners have read the last window's partials
    }
#pragma unroll 1
    for (int i = 0; i < STEPS; ++i) {
      if (NCH % WGS && WGS * i + wg >= NCH) break;
      const int c = (r + WGS * i + wg) % NCH;
      if (NCH > 1) sd(c);
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = am_exp2(fmaf(s[nt][e], AM_LOG2E, -m[e >> 1])) * linv[e >> 1];
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - D[e >> 1]);
        }
        pa[nt >> 1][(nt & 1) * 2] = hm_pack(s[nt][0], s[nt][1]);
        pa[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(s[nt][2], s[nt][3]);
        sa[nt >> 1][(nt & 1) * 2] = hm_pack(dp[nt][0], dp[nt][1]);
        sa[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(dp[nt][2], dp[nt][3]);
        float4& acc = slab[(c * 8 + nt) * 128 + wt];
        float4 v = acc;
        v.x += dp[nt][0], v.y += dp[nt][1], v.z += dp[nt][2], v.w += dp[nt][3];
        acc = v;
      }
      // p^T and dscores^T as A images (m = key, k = query)
      {
        const int mi = lane >> 3, rho = lane & 7;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int off = (2 * np + (mi >> 1)) * 512 + (2 * wr + (mi & 1)) * 64 + rho * 8;
          am_stsm_x4_t(PT + off, pa[np][0], pa[np][1], pa[np][2], pa[np][3]);
          am_stsm_x4_t(ST + off, sa[np][0], sa[np][1], sa[np][2], sa[np][3]);
        }
      }
      wg_proxy_fence();
      am_wg_sync(wg);
      float dkp[NDT][4], dvp[NDT][4];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wg_rs<DP>(&o[0][0], pa[ks], wg_desc(Vt + c * AM_TOK * DP + ks * 128, 128, AM_TOK * 16), i > 0 || ks > 0);
        wg_rs<DP>(&dq[0][0], sa[ks], wg_desc(Kt + c * AM_TOK * DP + ks * 128, 128, AM_TOK * 16), i > 0 || ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wg_ss<DP>(&dkp[0][0], wg_desc(ST + ks * 128, 128, AM_TOK * 16), wg_desc(Qt + ks * 128, 128, AM_TOK * 16),
                  ks > 0);
        wg_ss<DP>(&dvp[0][0], wg_desc(PT + ks * 128, 128, AM_TOK * 16), wg_desc(Dt + ks * 128, 128, AM_TOK * 16),
                  ks > 0);
      }
      wg_commit();
      wg_wait0();
      wg_hold<NDT * 4>(&o[0][0]);
      wg_hold<NDT * 4>(&dq[0][0]);
      wg_hold<NDT * 4>(&dkp[0][0]);
      wg_hold<NDT * 4>(&dvp[0][0]);
      wg_hold<16>(&pa[0][0]);
      wg_hold<16>(&sa[0][0]);
      am_wg_sync(wg);  // every warp is done with this warpgroup's p^T and dscores^T
      const bool own = i == 0 && wg == 0;  // chunk r, this block's own keys
      if (own) {
#pragma unroll
        for (int nt = 0; nt < NDT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dko[nt][e] = dkp[nt][e], dvo[nt][e] = dvp[nt][e];
      }
      if constexpr (NCH > 1) {
        // the partial of chunk c to its owner, block c: slot WGS i + wg - 1
        // of its inbox
        if (!own) {
          float4* box = inbox + (WGS * i + wg - 1) * 2 * NDT * 128;
          const uint32_t bar = am_mapa(full, c);
#pragma unroll
          for (int nt = 0; nt < NDT; ++nt) {
            am_st_async(am_mapa(&box[nt * 128 + wt], c), make_float4(dkp[nt][0], dkp[nt][1], dkp[nt][2], dkp[nt][3]),
                        bar);
            am_st_async(am_mapa(&box[(NDT + nt) * 128 + wt], c),
                        make_float4(dvp[nt][0], dvp[nt][1], dvp[nt][2], dvp[nt][3]), bar);
          }
        }
      }
    }
    if constexpr (WGS > 1) {
      // warpgroup 1's o and dq partials to warpgroup 0 (through the p^T
      // buffers, free now), added in that order
      float4* box = (float4*)(smem + L.pt);
      __syncthreads();
      if (wg == 1) {
#pragma unroll
        for (int nt = 0; nt < NDT; ++nt) {
          box[nt * 128 + wt] = make_float4(o[nt][0], o[nt][1], o[nt][2], o[nt][3]);
          box[(NDT + nt) * 128 + wt] = make_float4(dq[nt][0], dq[nt][1], dq[nt][2], dq[nt][3]);
        }
      }
      __syncthreads();
      if (wg == 0) {
#pragma unroll
        for (int nt = 0; nt < NDT; ++nt) {
          const float4 o4 = box[nt * 128 + wt], q4 = box[(NDT + nt) * 128 + wt];
          o[nt][0] += o4.x, o[nt][1] += o4.y, o[nt][2] += o4.z, o[nt][3] += o4.w;
          dq[nt][0] += q4.x, dq[nt][1] += q4.y, dq[nt][2] += q4.z, dq[nt][3] += q4.w;
        }
      }
    }

    // dq (scaled) and the attention output, rounded, to the token rows (dk
    // and dv when their partials are in)
    own_row0 = ((long long)w * NCH + r) * AM_TOK;
    if (wg == 0) {
#pragma unroll
      for (int nt = 0; nt < NDT; ++nt) {
        const int j = nt * 8 + 2 * tq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long row = own_row0 + q0 + 8 * hh;
          *reinterpret_cast<__nv_bfloat162*>(a.dqkv + row * G.K3 + h * DP + j) =
              __floats2bfloat162_rn(dq[nt][2 * hh] * dq_scale, dq[nt][2 * hh + 1] * dq_scale);
          *reinterpret_cast<__nv_bfloat162*>(a.att + row * G.HD + h * DP + j) =
              __floats2bfloat162_rn(o[nt][2 * hh], o[nt][2 * hh + 1]);
        }
      }
    }
    ++n;
  }
  if (n > 0) finish_own();  // the last window's dk and dv

  // this block's d bias rows, f32, to its partial (head h, group g); it
  // exits only once the owners of its last partials have read them (their
  // credits are the last accesses to its shared memory)
  if (NCH > 1 && n > 0) am_bar_wait_cluster(credit, (n - 1) & 1);
  __syncthreads();
  float* part = a.dbias_part + (((size_t)h * a.groups + g) * N + r * AM_TOK) * N;
  for (int c = wg; c < NCH; c += WGS)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float4 v = slab[(c * 8 + nt) * 128 + wt];
      const int col = c * AM_TOK + nt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(part + (size_t)q0 * N + col) = make_float2(v.x, v.y);
      *reinterpret_cast<float2*>(part + (size_t)(q0 + 8) * N + col) = make_float2(v.z, v.w);
    }
}

// -- pass 2 above window 16: the two-formation core (lb_core.cuh) -----------------------
//
// At NCH >= 5 tiles (N > 256) the window's k and v (and the f32 d bias rows
// of a query chunk, 64 N) outgrow a block's shared memory, and the cluster
// of NCH blocks outgrows the portable cluster size of 8. So the attention
// core runs lb_core.cuh's passes on the images of pass 1: the statistics and
// the attention output per (window, head, pair of query chunks), then p,
// dscores, d bias, dq's partials, dk and dv per (group of windows, head, key
// chunk), then the sums. LbB9 is B9's view for them: the images, the
// fragment-ordered bias (am_bias_kernel, f32 or bf16), the shift's regions
// as the tokens' tags (-100 where a query's and a key's differ) and the
// stores of dq (scaled), dk and dv to the dq|dk|dv rows and of the output
// to the attn rows.
struct LbB9 {
  AmArgs a;
  AmGeom G;
  __device__ const bf16* img(long long u, int which, int t) const {
    return a.img + (u * 4 + which) * G.N * G.DP + (long long)t * AM_TOK * G.DP;
  }
  __device__ const bf16* q(long long u, int r) const { return img(u, 0, r); }
  __device__ const bf16* k(long long u, int c) const { return img(u, 1, c); }
  __device__ const bf16* v(long long u, int c) const { return img(u, 2, c); }
  __device__ const bf16* g(long long u, int r) const { return img(u, 3, r); }
  __device__ float4 bias4(int h, int r, int c, int nt, int wt) const { return am_bias4(a, G.NCH, h, r, c, nt, wt); }
  __device__ bool masked(int) const { return a.shift != 0; }
  __device__ int row_tag(long long w, int n) const { return am_region(G, a, (int)(w % a.nwi), n); }
  __device__ int col_tag(long long w, int n) const { return row_tag(w, n); }
  __device__ float score(float s, float b, int qtag, int ktag) const { return s + b + (qtag != ktag ? -100.f : 0.f); }
  __device__ void store4(int kind, long long u, int tile, int nt, int wt, float4 v) const {
    const long long w = u / G.heads;
    const int h = (int)(u % G.heads), q = 16 * (wt >> 5) + ((wt & 31) >> 2), j = h * G.DP + nt * 8 + 2 * (wt & 3);
    const long long row = (w * G.NCH + tile) * AM_TOK + q;
    bf16* d;
    long long step;
    float sc = 1.f;
    if (kind == LB_O) {
      d = a.att + row * G.HD + j, step = 8LL * G.HD;
    } else {
      d = a.dqkv + row * G.K3 + j + (kind == LB_DK ? G.HD : kind == LB_DV ? 2 * G.HD : 0), step = 8LL * G.K3;
      if (kind == LB_DQ) sc = rsqrtf((float)G.d);
    }
    *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(v.x * sc, v.y * sc);
    *reinterpret_cast<__nv_bfloat162*>(d + step) = __floats2bfloat162_rn(v.z * sc, v.w * sc);
  }
};

// out[h][q][k] (nv x nv) = sum over groups of part[h][g][q][k] (n x n, the
// padded window), in order of g.
__global__ void am_dbias_reduce_kernel(const float* __restrict__ part, int heads, int groups, int n, int nv,
                                       float* __restrict__ out) {
  const long long nn = (long long)n * n, vv = (long long)nv * nv;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < heads * vv;
       i += (long long)gridDim.x * blockDim.x) {
    const long long h = i / vv, e = i % vv, src = e / nv * n + e % nv;
    float v = 0.f;
    for (int g = 0; g < groups; ++g) v += part[(h * groups + g) * nn + src];
    out[i] = v;
  }
}

// -- pass 3: dln = dqkv Wqkv^T (am_rowgemm_kernel); 3b: the LN backward and dx -----

// Pass 3b, a warp a token row (rows in tile order; block b takes rows b, b +
// gridDim, ...): the LN backward and dx from dln, x, g and the LN statistics
// (am_lnb_row), and the block's column sums of dln xhat and dln into
// lnst[block][2 C]; padding tokens are skipped.
__global__ void __launch_bounds__(256) am_lnb_kernel(const AmArgs a, const AmGeom G, long long rows) {
  __shared__ float sums[8][2 * AM_MAX_C];
  const int warp = threadIdx.x >> 5, C = G.C;
  float cs[3][4] = {};  // per pair: dln xhat (c, c + 1), dln (c, c + 1)
  for (long long row = blockIdx.x + (long long)gridDim.x * warp; row < rows; row += gridDim.x * 8LL) {
    const int tile = (int)(row / AM_TOK);
    if (!am_valid(G, tile, (int)(row % AM_TOK))) continue;
    const long long off = am_pixel(G, a, tile, (int)(row % AM_TOK)) * C;
    const float dd = a.dp ? a.dp[(tile / G.NCH) / a.nwi] : 1.f;
    am_lnb_row(a.dln + row * C, a.x + off, a.g + off, a.dx + off, a.stats[2 * row], a.stats[2 * row + 1], dd, C, a.ln_w,
               cs);
  }
  am_lnb_sums(cs, C, sums, a.lnst + (long long)blockIdx.x * 2 * C);
}


// -- host ------------------------------------------------------------------------------

// Scratch in bf16: q|k|v|dattn images (windows x heads x 4 x N x DP), LN and
// g_b rows (SC), attn rows (HD), dq|dk|dv rows (K3), the packed weights
// and the slack wgrad.cuh reads past its last tile. In f32: LN statistics (2 a row), the d
// dln rows (C), the fragment-ordered bias (heads x N x N), the d bias partials (heads x groups x N x N; none
// above window 16), pass 3b's blocks' column sums, the wgrad partials, and above window 16 lb_core.cuh's
// scratch (lb_f_elems of the plan).
struct AmScratch {
  long long rows, img, ln, gb, att, dqkv, pack, t_elems;
  long long stats, dln, bias, dbias, lnst, wg, lb, f_elems;
  int windows, tiles, groups, proj_blocks, dln_blocks, row_blocks, sms;
};

static AmScratch am_scratch(int B, int H, int W, int C, int heads, int ws, int sms) {
  const AmGeom G(C, heads, ws);
  AmScratch S;
  S.windows = B * (H / ws) * (W / ws);
  S.tiles = S.windows * G.NCH;
  S.rows = (long long)S.tiles * AM_TOK;
  const int blocks = G.NCH == 1 ? 3 * sms : sms / G.NCH;  // attention blocks (clusters above window 8) in flight
  S.groups = blocks / heads < 1 ? 1 : blocks / heads;
  if (S.groups > S.windows) S.groups = S.windows;
  const int pairs = (S.tiles + 1) / 2;
  S.proj_blocks = S.dln_blocks = pairs < sms ? pairs : sms;
  S.row_blocks = 8 * sms;  // passes 0 and 3b: a warp a row, eight blocks an SM
  S.img = 0;
  S.ln = S.img + S.rows * 4 * G.HD;
  S.gb = S.ln + S.rows * G.SC;
  S.att = S.gb + S.rows * G.SC;
  S.dqkv = S.att + S.rows * G.HD;
  S.pack = S.dqkv + S.rows * G.K3;
  S.t_elems = S.pack + G.pack_elems() + 2 * WG_BM;
  S.stats = 0;
  S.dln = S.stats + 2 * S.rows;
  S.bias = S.dln + S.rows * C;
  S.dbias = S.bias + (long long)heads * G.N * G.N;
  S.lnst = S.dbias + (G.NCH > 4 ? 0 : (long long)heads * S.groups * G.N * G.N);
  S.wg = S.lnst + (long long)(S.row_blocks + sms) * 2 * C;  // 3b's partials, then their sums by eights
  const long long p1 = aw_plan(S.rows, C, G.K3, sms).part_elems, p2 = aw_plan(S.rows, G.HD, C, sms).part_elems;
  S.lb = (S.wg + (p1 > p2 ? p1 : p2) + 3) & ~3LL;  // lb_core.cuh's scratch above window 16, 16-byte aligned
  S.sms = sms;
  S.f_elems = S.lb + (G.NCH > 4 ? lb_f_elems(lb_plan(S.windows, heads, G.NCH, G.NCH, G.DP, sms)) : 0);
  return S;
}

// Elements of the packed weights for a geometry (ops/cuda/attn_bwd.py checks
// its own count against it), or -1 for one the kernels do not take.
extern "C" long long attn_bwd_mma_pack_elems(int C, int heads) {
  return am_geometry_ok(C, heads, 8) ? AmGeom(C, heads, 8).pack_elems() : -1;
}

extern "C" int attn_bwd_mma_scratch(int B, int H, int W, int C, int heads, int ws, long long* t_elems,
                                    long long* f_elems) {
  int sms = 0;
  const cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const AmScratch S = am_scratch(B, H, W, C, heads, ws, sms);
  *t_elems = S.t_elems;
  *f_elems = S.f_elems;
  return 0;
}

template <int NCH, int DP>
static cudaError_t am_launch_attn(const AmArgs& a, const AmGeom& G, int blocks, cudaStream_t stream) {
  auto kernel = am_attn_kernel<NCH, DP>;
  const size_t bytes = am_attn_smem(G).total;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  if (NCH == 1) {
    kernel<<<blocks, 128 * am_wgs(NCH), bytes, stream>>>(a, G);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(128 * am_wgs(NCH));
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NCH;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, G);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int DP>
static cudaError_t am_launch_proj_attn(const AmArgs& a, const AmGeom& G, const AmScratch& S, float* lbf,
                                       float* dbias, cudaStream_t stream) {
  const size_t bytes = am_proj_smem(G);
  cudaError_t err = allow_smem(am_proj_kernel<DP, true>, bytes);
  if (err != cudaSuccess) return err;
  am_proj_kernel<DP, true><<<S.proj_blocks, 256, bytes, stream>>>(a, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (G.NCH > 4) {
    LbPlan L = lb_plan(S.windows, G.heads, G.NCH, G.NCH, DP, S.sms);
    lb_place(L, lbf);
    return lb_launch<DP, LbB9, true>(LbB9{a, G}, L, G.NV, G.NV, dbias, stream);
  }
  const int blocks = G.heads * S.groups * G.NCH;
  switch (G.NCH) {
    case 1: return am_launch_attn<1, DP>(a, G, blocks, stream);
    case 2: return am_launch_attn<2, DP>(a, G, blocks, stream);
    case 3: return am_launch_attn<3, DP>(a, G, blocks, stream);
    default: return am_launch_attn<4, DP>(a, G, blocks, stream);
  }
}

// The gradients with the heads padded to DP: dwqkv (C x K3), dbqkv (K3) and
// dwproj (HD x C) have zero rows / columns at d .. DP of each head, which
// the wrapper drops.
static int am_run(int ws, const void* x, const void* g, void* dx, int B, int H, int W, int C, int heads, int shift,
                  int bias16,
                  const void* ln_w, const void* ln_b, const void* bqkv, const void* relbias, const void* dp,
                  const void* wqkv, const void* wproj, const int* pack_index, long long pack_elems, void* ds_db, void* dwqkv, void* dbqkv, void* dwproj,
                  void* dbproj, void* dbias, void* tscratch, long long t_elems, void* fscratch, long long f_elems,
                  void* stream) {
  if (!am_geometry_ok(C, heads, ws) || B < 1 || H < ws || W < ws || H % ws || W % ws || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  const AmGeom G(C, heads, ws);
  int sms = 0;
  cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const AmScratch S = am_scratch(B, H, W, C, heads, ws, sms);
  if (S.t_elems != t_elems || S.f_elems != f_elems || G.pack_elems() != pack_elems) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 8 || (uintptr_t)g % 8 || (uintptr_t)dx % 8 || (uintptr_t)tscratch % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  bf16* t = (bf16*)tscratch;
  float* f = (float*)fscratch;
  AmArgs a{};
  a.x = (const bf16*)x, a.g = (const bf16*)g, a.dx = (bf16*)dx;
  a.ln_w = (const float*)ln_w, a.ln_b = (const float*)ln_b, a.bqkv = (const float*)bqkv;
  a.relbias = f + S.bias, a.bias16 = bias16, a.dp = (const float*)dp;
  a.w = t + S.pack;
  a.img = t + S.img, a.ln = t + S.ln, a.gb = t + S.gb, a.att = t + S.att, a.dqkv = t + S.dqkv;
  a.stats = f + S.stats, a.dln = f + S.dln, a.dbias_part = f + S.dbias, a.lnst = f + S.lnst;
  a.H = H, a.W = W, a.shift = shift, a.nwx = W / ws, a.nwi = (H / ws) * (W / ws);
  a.windows = S.windows, a.tiles = S.tiles, a.groups = S.groups;

  err = am_pack((const bf16*)wqkv, 3LL * C * C, (const bf16*)wproj, (long long)C * C, pack_index, pack_elems, t + S.pack,
                st);
  if (err != cudaSuccess) return (int)err;
  am_bias_kernel<<<256, 256, 0, st>>>(relbias, bias16, heads, G.NCH, G.NV, f + S.bias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (G.NV < G.N)
    am_ln_kernel<true, true><<<S.row_blocks, 256, 0, st>>>(a, G, S.rows);
  else
    am_ln_kernel<true, false><<<S.row_blocks, 256, 0, st>>>(a, G, S.rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = G.DP == 32 ? am_launch_proj_attn<32>(a, G, S, f + S.lb, (float*)dbias, st)
                    : am_launch_proj_attn<16>(a, G, S, f + S.lb, (float*)dbias, st);
  if (err != cudaSuccess) return (int)err;
  if (G.NCH <= 4) {  // above window 16 lb_launch has summed d bias
    const long long n = heads * (long long)G.NV * G.NV;
    am_dbias_reduce_kernel<<<(int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024), 256, 0, st>>>(
        a.dbias_part, heads, S.groups, G.N, G.NV, (float*)dbias);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = am_rowgemm(AmRowGemm{a.dqkv, a.w + G.proj_elems(), G.K3, G.K3, S.tiles}, C, AmStoreF32{a.dln, C}, S.dln_blocks, st);
  if (err != cudaSuccess) return (int)err;
  am_lnb_kernel<<<S.row_blocks, 256, 0, st>>>(a, G, S.rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // block b's partial is part s = b / sms of group b % sms: first the eight
  // of each group, then the groups, in order
  float* lnst1 = a.lnst + (long long)S.row_blocks * 2 * C;
  err = reduce_parts(a.lnst, S.row_blocks / sms, (long long)sms * 2 * C, lnst1, st);
  if (err != cudaSuccess) return (int)err;
  err = reduce_parts(lnst1, sms, 2LL * C, (float*)ds_db, st);
  if (err != cudaSuccess) return (int)err;
  err = am_wgrad(a.ln, G.SC, a.dqkv, G.K3, S.rows, C, G.K3, (float*)dwqkv, (float*)dbqkv, f + S.wg, sms, st);
  if (err != cudaSuccess) return (int)err;
  return (int)am_wgrad(a.att, G.HD, a.gb, G.SC, S.rows, G.HD, C, (float*)dwproj, (float*)dbproj, f + S.wg, sms, st);
}

// Three entries, one a family: windows 2..8 (B8, one tile a window), 9..16
// (B9) and 17 up (B9 on lb_core.cuh's core).
#define ATTN_BWD_MMA_ENTRY(NAME, WS_LO, WS_HI)                                                                    \
  extern "C" int NAME(const void* x, const void* g, void* dx, int B, int H, int W, int C, int heads, int ws,      \
                      int shift, int bias16,                                                                      \
                      const void* ln_w, const void* ln_b, const void* bqkv, const void* relbias, const void* dp,  \
                      const void* wqkv, const void* wproj, const void* pack_index, long long pack_elems,          \
                      void* ds_db, void* dwqkv, void* dbqkv, void* dwproj, void* dbproj, void* dbias,             \
                      void* tscratch, long long t_elems, void* fscratch, long long f_elems, void* stream) {       \
    if (ws < WS_LO || ws > WS_HI) return (int)cudaErrorInvalidValue;                                             \
    return am_run(ws, x, g, dx, B, H, W, C, heads, shift, bias16, ln_w, ln_b, bqkv, relbias, dp, wqkv, wproj,    \
                  (const int*)pack_index, pack_elems, ds_db, dwqkv, dbqkv, dwproj, dbproj, dbias, tscratch,      \
                  t_elems, fscratch, f_elems, stream);                                                            \
  }

ATTN_BWD_MMA_ENTRY(attn_bwd_mma_bf16, 2, 8)
ATTN_BWD_MMA_ENTRY(attn_bwd16_mma_bf16, 9, 16)
ATTN_BWD_MMA_ENTRY(attn_bwd_large_mma_bf16, 17, 1 << 14)

