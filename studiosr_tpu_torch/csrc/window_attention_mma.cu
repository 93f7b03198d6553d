// B5 in bf16, written for the H100: the attention half of a Swin block,
//   y = x + d_b * proj(WA(LN x))  on (B, H, W, C) maps,
// window attention over ws x ws windows, any ws from 2 (SwinIR's 8, HAT's 16,
// MaxSR's adaptive ceil(sqrt(side))), with the
// gathered rel-pos bias (heads, N, N) and, for shifted blocks, the -100
// region mask of calculate_mask; the shift folded into reads and writes, the
// output aligned with the input; d_b the per-sample drop-path scale (none in
// serving).
//
// Replaces studiosr_tpu/ops/pallas/swin_block.py::fused_window_attention_block
// (:549) in bf16 at every window; f32 (SwinFIR's training recipe, which
// trains in f32, and the f32 checks) runs window_attention_f32.cu at windows
// 2..8 and keeps window_attention.cu / window_attention16.cu elsewhere, and
// so do head dims above 32.
// A window of N = ws^2 tokens is padded to NCH = ceil(N / 64) whole tiles
// (am_window.cuh): windows 2..8 take one tile (the entry
// window_attention_mma_bf16), 9..16 two to four (window_attention16_mma_bf16),
// 17 up five and more, the key chunks streamed (window_attention_large_mma_bf16:
// pass 2 is lf_core.cuh's pipelined forward);
// the padding keys score -inf (their bias, am_bias_kernel), the padding
// queries are never stored.
// Rounding points follow the TPU kernel: the LN output, q / k / v, the
// probabilities and the attention output rounded to bf16; products
// accumulate in f32; LN and softmax statistics in f32, the softmax
// max-subtracted (over two to four key chunks online, the probabilities
// rounded before they are normalised; over one chunk, after); d_b scales the
// f32 delta.
//
// Bound on the card at SwinIR's training shapes (T = 131,072 tokens, C 180,
// 6 heads of 30): 2 T C 4C + 4 T 64 C = 40 GFLOP against 94 MB for x and y,
// so the tensor-core rate (0.04 ms); at window 16 58 GFLOP (HAT's step) and
// 29 GFLOP (HAT x4 serving, T = 65,536). The older kernels ran the heads of a
// window one after another with small GEMMs and a barrier per staged K
// chunk (window 8), or an LN + q|k|v pass on wmma and an attention pass on
// mma.sync (window 16). Here, the forward half of attn_bwd_mma.cu's
// structure, tokens in tile order (64 tokens a tile: a window at 8, a
// quarter of one at 16), every pass but the attention in am_window.cuh /
// am_common.cuh:
// 0. am_ln_kernel, a warp a row: LN rows into a scratch, at full occupancy.
// 1. am_proj_kernel<DP, false>, a tile a warpgroup, two a block: q|k|v = LN
//    Wqkv on wgmma, the head's packed weights streamed once per tile pair
//    through a four-slot cp.async.bulk / mbarrier ring; q (scaled) and k go
//    out as the K-major images of a product over d, v as the K-major image
//    of p v (the token the K index), so no block transposes.
// 2. wa_attn_kernel, a warpgroup owning (window, head, 64 queries): the
//    window's k and v and its queries' q by cp.async; per 64-key chunk the
//    scores on wgmma in registers, the bias (in fragment order,
//    am_bias_kernel) and mask added, the online softmax, and o += p v on
//    wgmma with p as register A fragments. attn goes out per token row,
//    heads padded to DP.
// 3. am_rowgemm_kernel: y = x + d_b (attn Wproj + bproj) on wgmma, Wproj
//    streamed through the ring, written to the unshifted pixel.
// The weights are packed per call in training (one gather by the index table
// of ops/cuda/window_attention.py _fwd_pack_index, am_pack_kernel) and once,
// at load time, in serving (pack_window_attention: the blob, with the bias
// in fragment order after the weights); each stage the image of a ring slot in wgmma's K-major
// core-matrix layout (am_kmajor in am_common.cuh, _k_major there: change
// both together).
// Takes bf16, windows from 2, head dims up to 32, C a multiple of 4 up to
// 184, H and W multiples of the window; the wrapper routes anything else.
#include "am_window.cuh"
#include "lf_core.cuh"

// Shared memory of the attention pass: the window's k (K-major in d) and v
// (K-major in the token), the block's 64 queries' q and the keys' region ids.
__host__ __device__ inline size_t wa_attn_smem(const AmGeom& G) {
  return (((2 * (size_t)G.N + AM_TOK) * G.DP * 2 + G.N) + 127) & ~(size_t)127;
}

// A warpgroup owns (window w, head h, query chunk r): block w heads NCH + h
// NCH + r, so a window's blocks run together and share its k and v in L2.
template <int NCH, int DP>
__global__ void __launch_bounds__(128, 3) wa_attn_kernel(const AmArgs a, const AmGeom G) {
  constexpr int N = NCH * AM_TOK, KS = DP / 16, NDT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Kk = (bf16*)smem;
  bf16* Vt = Kk + N * DP;
  bf16* Qk = Vt + N * DP;
  signed char* reg = (signed char*)(Qk + AM_TOK * DP);
  const int tid = threadIdx.x, wr = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int r = blockIdx.x % NCH, h = (blockIdx.x / NCH) % G.heads, w = blockIdx.x / (NCH * G.heads);
  const bf16* unit = a.img + ((long long)w * G.heads + h) * 3 * N * DP;
  {
    constexpr int BIG = N * DP / 8, SMALL = AM_TOK * DP / 8;  // 16-byte pieces
    for (int i = tid; i < 2 * BIG + SMALL; i += 128) {
      const bf16* s;
      bf16* d;
      if (i < BIG) s = unit + N * DP + i * 8, d = Kk + i * 8;
      else if (i < 2 * BIG) s = unit + 2 * N * DP + (i - BIG) * 8, d = Vt + (i - BIG) * 8;
      else s = unit + r * AM_TOK * DP + (i - 2 * BIG) * 8, d = Qk + (i - 2 * BIG) * 8;
      hm_cp_async<16>(d, s, true);
    }
    hm_cp_commit();
  }
  if (a.shift)
    for (int t = tid; t < N; t += 128) reg[t] = (signed char)am_region(G, a, w % a.nwi, t);
  hm_cp_wait_upto(0);
  wg_proxy_fence();
  __syncthreads();
  const int q0 = 16 * wr + gq;  // this thread's query rows q0, q0 + 8 of the chunk
  const int rq0 = a.shift ? reg[r * AM_TOK + q0] : 0, rq1 = a.shift ? reg[r * AM_TOK + q0 + 8] : 0;
  // the bias of this thread's score fragment of key chunk c, 8-column tile nt
  auto bias4 = [&](int c, int nt) -> float4 {
    const size_t e = (((size_t)(h * NCH + r) * NCH + c) * 8 + nt) * 128 + tid;
    if (!a.bias16) return reinterpret_cast<const float4*>(a.relbias)[e];
    const uint2 u = reinterpret_cast<const uint2*>(a.relbias)[e];
    const float2 p0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 p1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(p0.x, p0.y, p1.x, p1.y);
  };

  // row max m (log2 units) and sum l of 2^(s - m), this thread's columns
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[NDT][4];
#pragma unroll 1
  for (int c = 0; c < NCH; ++c) {
    float4 bb[8];  // the bias, loaded before the product so its latency hides under it
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) bb[nt] = bias4(c, nt);
    float s[8][4];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wg_ss<64>(&s[0][0], wg_desc(Qk + ks * 128, 128, DP * 16), wg_desc(Kk + c * AM_TOK * DP + ks * 128, 128, DP * 16),
                ks > 0);
    wg_commit();
    wg_wait0();
    wg_hold<32>(&s[0][0]);
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
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      const float mn = fmaxf(m[hh], am_quad_max(mx) * AM_LOG2E), sc = am_exp2(m[hh] - mn);
      l[hh] *= sc, m[hh] = mn;
      if (c > 0)
#pragma unroll
        for (int nt = 0; nt < NDT; ++nt) o[nt][2 * hh] *= sc, o[nt][2 * hh + 1] *= sc;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = am_exp2(fmaf(s[nt][2 * hh + e], AM_LOG2E, -mn));
          s[nt][2 * hh + e] = p;
          l[hh] += p;
        }
    }
    if constexpr (NCH == 1) {
      // one chunk: the probabilities normalised before they are rounded
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] = am_quad_sum(l[hh]);
        const float inv = 1.f / l[hh];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) s[nt][2 * hh] *= inv, s[nt][2 * hh + 1] *= inv;
      }
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      pa[nt >> 1][(nt & 1) * 2] = hm_pack(s[nt][0], s[nt][1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(s[nt][2], s[nt][3]);
    }
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wg_rs<DP>(&o[0][0], pa[ks], wg_desc(Vt + c * AM_TOK * DP + ks * 128, 128, AM_TOK * 16), c > 0 || ks > 0);
    wg_commit();
    wg_wait0();
    wg_hold<NDT * 4>(&o[0][0]);
    wg_hold<16>(&pa[0][0]);
  }
  if constexpr (NCH > 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float inv = 1.f / am_quad_sum(l[hh]);
#pragma unroll
      for (int nt = 0; nt < NDT; ++nt) o[nt][2 * hh] *= inv, o[nt][2 * hh + 1] *= inv;
    }
  }
  // the attention output, rounded, to the token rows (head h's DP columns)
  const long long row0 = ((long long)w * NCH + r) * AM_TOK;
#pragma unroll
  for (int nt = 0; nt < NDT; ++nt) {
    const int j = nt * 8 + 2 * tq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<__nv_bfloat162*>(a.att + (row0 + q0 + 8 * hh) * G.HD + h * DP + j) =
          __floats2bfloat162_rn(o[nt][2 * hh], o[nt][2 * hh + 1]);
  }
}

// Windows above 16 (NCH >= 5 tiles): the window's k and v do not stay in
// shared memory (2 NCH 64 DP bf16, 144 KB at window 33 and without a bound
// above), so the attention runs on lf_core.cuh's pipelined forward: a block
// a (window, head, 64 queries) streaming the 64-key chunks through a ring;
// scores, bias, mask, the online softmax and o += p v as in
// wa_attn_kernel. This family's part: unit u = w heads + h of pass 1's
// images; the bias in am_bias_kernel's fragment order (tile (h, r, c) 1024
// float4, or uint2 in bf16, contiguous), as lf_core.cuh reads it; the
// shift's regions (am_region) as the tags; attn per token row, head h's DP
// columns, stored from the fragments.
template <int DP>
struct LfB5 {
  AmArgs a;
  AmGeom G;
  int QT, KT, heads;
  long long units;
  const void* bias;  // a.relbias: tile (h, r, c) the ((h NCH + r) NCH + c)-th of am_bias_kernel's order
  __device__ const bf16* img(long long u) const { return a.img + u * 3 * G.N * DP; }
  __device__ const bf16* q(long long u, int r) const { return img(u) + (long long)r * AM_TOK * DP; }
  __device__ const bf16* k(long long u, int c) const { return img(u) + ((long long)G.N + c * AM_TOK) * DP; }
  __device__ const bf16* v(long long u, int c) const { return img(u) + (2LL * G.N + c * AM_TOK) * DP; }
  // a window off the last row and column of windows lies in region 0 whole
  __device__ bool masked(long long u) const {
    const int wi = (int)((u / heads) % a.nwi);
    return a.shift && (wi / a.nwx == a.nwi / a.nwx - 1 || wi % a.nwx == a.nwx - 1);
  }
  __device__ int tag(long long u, int n) const { return am_region(G, a, (int)((u / heads) % a.nwi), n); }
  __device__ void store(long long u, int r, const float (&o)[DP / 8][4], const float (&inv)[2], bf16*) const {
    const int lane = threadIdx.x & 31, q0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2), tq = lane & 3;
    const int h = (int)(u % heads);
    const long long row0 = (u / heads * G.NCH + r) * AM_TOK;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<__nv_bfloat162*>(a.att + (row0 + q0 + 8 * hh) * G.HD + h * DP + nt * 8 + 2 * tq) =
            __floats2bfloat162_rn(o[nt][2 * hh] * inv[hh], o[nt][2 * hh + 1] * inv[hh]);
  }
};

// Scratch in bf16: the q|k|v images (windows x heads x 3 x N x DP), LN rows
// (SC), attn rows (HD), the packed weights and the bias in fragment order
// (f32, or bf16 when the bias is; the room of f32), the last two used only
// when the caller hands dense weights.
struct WaScratch {
  long long rows, img, ln, att, pack, bias, t_elems;
  int windows, tiles, proj_blocks, row_blocks;
};

static WaScratch wa_scratch(int B, int H, int W, int C, int heads, int ws, int sms) {
  const AmGeom G(C, heads, ws);
  WaScratch S;
  S.windows = B * (H / ws) * (W / ws);
  S.tiles = S.windows * G.NCH;
  S.rows = (long long)S.tiles * AM_TOK;
  const int pairs = (S.tiles + 1) / 2;
  S.proj_blocks = pairs < sms ? pairs : sms;
  S.row_blocks = 8 * sms;
  S.img = 0;
  S.ln = S.img + S.rows * 3 * G.HD;
  S.att = S.ln + S.rows * G.SC;
  S.pack = S.att + S.rows * G.HD;
  S.bias = S.pack + G.fwd_pack_elems();
  S.t_elems = S.bias + 2LL * heads * G.N * G.N;
  return S;
}

// Elements of the packed weights for a geometry (ops/cuda/window_attention.py
// checks its own count against it), or -1 for one the kernels do not take.
extern "C" long long window_attention_mma_pack_elems(int C, int heads) {
  return am_geometry_ok(C, heads, 8) ? AmGeom(C, heads, 8).fwd_pack_elems() : -1;
}

extern "C" int window_attention_mma_scratch(int B, int H, int W, int C, int heads, int ws, long long* t_elems) {
  int sms = 0;
  const cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  *t_elems = wa_scratch(B, H, W, C, heads, ws, sms).t_elems;
  return 0;
}

template <int DP>
static cudaError_t wa_launch(const AmArgs& a, const AmGeom& G, const WaScratch& S, cudaStream_t stream) {
  const size_t pbytes = am_proj_smem(G);
  cudaError_t err = allow_smem(am_proj_kernel<DP, false>, pbytes);
  if (err != cudaSuccess) return err;
  am_proj_kernel<DP, false><<<S.proj_blocks, 256, pbytes, stream>>>(a, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (G.NCH > 4) {
    const LfB5<DP> f{a, G, G.NCH, G.NCH, G.heads, (long long)S.windows * G.heads, a.relbias};
    return lf_launch<DP>(f, a.bias16, stream);
  }
  auto attn = G.NCH == 1   ? wa_attn_kernel<1, DP>
              : G.NCH == 2 ? wa_attn_kernel<2, DP>
              : G.NCH == 3 ? wa_attn_kernel<3, DP>
                           : wa_attn_kernel<4, DP>;
  const size_t abytes = wa_attn_smem(G);
  err = allow_smem(attn, abytes);
  if (err != cudaSuccess) return err;
  attn<<<S.windows * G.heads * G.NCH, 128, abytes, stream>>>(a, G);
  return cudaGetLastError();
}

// packed: the blob of pack_window_attention (the weights, then the bias in
// fragment order, f32), or null, and then wqkv, wproj (dense, (in, out)) are
// gathered by pack_index and relbias (heads, N, N; bf16 when bias16, else
// f32) reordered into the scratch.
static int wa_run(int ws, const void* x, void* out, int B, int H, int W, int C, int heads, int shift, int bias16,
                  const void* ln_w, const void* ln_b, const void* bqkv, const void* bproj, const void* relbias,
                  const void* dp, const void* wqkv, const void* wproj, const int* pack_index, const void* packed,
                  long long pack_elems, void* tscratch, long long t_elems, void* stream) {
  if (!am_geometry_ok(C, heads, ws) || B < 1 || H < ws || W < ws || H % ws || W % ws || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  const AmGeom G(C, heads, ws);
  int sms = 0;
  cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const WaScratch S = wa_scratch(B, H, W, C, heads, ws, sms);
  if (S.t_elems != t_elems || G.fwd_pack_elems() != pack_elems || (!packed && !(wqkv && wproj && pack_index)))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 8 || (uintptr_t)out % 8 || (uintptr_t)tscratch % 16 || (uintptr_t)packed % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  bf16* t = (bf16*)tscratch;
  AmArgs a{};
  a.x = (const bf16*)x, a.dx = (bf16*)out;
  a.ln_w = (const float*)ln_w, a.ln_b = (const float*)ln_b, a.bqkv = (const float*)bqkv;
  a.bproj = (const float*)bproj, a.dp = (const float*)dp;
  a.img = t + S.img, a.ln = t + S.ln, a.att = t + S.att;
  a.H = H, a.W = W, a.shift = shift, a.nwx = W / ws, a.nwi = (H / ws) * (W / ws);
  a.windows = S.windows, a.tiles = S.tiles;
  if (packed) {
    a.w = (const bf16*)packed;
    a.relbias = (const bf16*)packed + pack_elems, a.bias16 = 0;
  } else {
    a.w = t + S.pack;
    a.relbias = t + S.bias, a.bias16 = bias16;
    err = am_pack((const bf16*)wqkv, 3LL * C * C, (const bf16*)wproj, (long long)C * C, pack_index, pack_elems,
                  t + S.pack, st);
    if (err != cudaSuccess) return (int)err;
    am_bias_kernel<<<256, 256, 0, st>>>(relbias, bias16, heads, G.NCH, G.NV, t + S.bias);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const bool pad = G.NV < G.N;  // a window that does not fill its tiles
  if (pad)
    am_ln_kernel<false, true><<<S.row_blocks, 256, 0, st>>>(a, G, S.rows);
  else
    am_ln_kernel<false, false><<<S.row_blocks, 256, 0, st>>>(a, G, S.rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = G.DP == 32 ? wa_launch<32>(a, G, S, st) : wa_launch<16>(a, G, S, st);
  if (err != cudaSuccess) return (int)err;
  const AmRowGemm q{a.att, a.w + G.qkv_elems(), G.HD, G.HD, S.tiles};
  return (int)(pad ? am_rowgemm(q, C, WaOut<true>{a, G}, S.proj_blocks, st)
                   : am_rowgemm(q, C, WaOut<false>{a, G}, S.proj_blocks, st));
}

// Three entries, one a family: windows 2..8 (one tile a window), 9..16 and
// 17 up (the key chunks streamed).
#define WINDOW_ATTENTION_MMA_ENTRY(NAME, WS_LO, WS_HI)                                                                \
  extern "C" int NAME(const void* x, void* out, int B, int H, int W, int C, int heads, int ws, int shift,             \
                      int bias16, const void* ln_w, const void* ln_b, const void* bqkv, const void* bproj,            \
                      const void* relbias, const void* dp, const void* wqkv, const void* wproj,                       \
                      const void* pack_index, const void* packed, long long pack_elems, void* tscratch,               \
                      long long t_elems, void* stream) {                                                              \
    if (ws < WS_LO || ws > WS_HI) return (int)cudaErrorInvalidValue;                                                 \
    return wa_run(ws, x, out, B, H, W, C, heads, shift, bias16, ln_w, ln_b, bqkv, bproj, relbias, dp, wqkv, wproj,   \
                  (const int*)pack_index, packed, pack_elems, tscratch, t_elems, stream);                             \
  }

WINDOW_ATTENTION_MMA_ENTRY(window_attention_mma_bf16, 2, 8)
WINDOW_ATTENTION_MMA_ENTRY(window_attention16_mma_bf16, 9, 16)
WINDOW_ATTENTION_MMA_ENTRY(window_attention_large_mma_bf16, 17, 1 << 14)
