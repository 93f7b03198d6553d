// B5 in f32, written for the H100: the attention half of a Swin block,
//   y = x + d_b * proj(WA(LN x))  on (B, H, W, C) maps,
// window attention over ws x ws windows, ws 2..8 (window_attention_mma_f32)
// and 9..16 (window_attention16_mma_f32: below), with the gathered rel-pos
// bias (heads, N, N) and, for shifted blocks, the -100 region mask of
// calculate_mask; the shift folded into reads and writes, the output aligned
// with the input; d_b the per-sample drop-path scale.
//
// Replaces studiosr_tpu/ops/pallas/swin_block.py::fused_window_attention_block
// (:549; at windows 9..16 its per-head kernel _attn_block_kernel :474) in
// f32, the dtype SwinFIR's recipe and HAT's f32 step train in (every
// SwinFIR step runs it 36 times, every HAT f32 step and f32 forward 36 at
// window 16; SwinIR's and MaxSR's f32 steps and checks take it too); bf16
// runs window_attention_mma.cu, head dims above 32 and windows from 17
// window_attention.cu / window_attention16.cu. The contract is the
// TPU kernel's with T = f32: q = (LN Wq + bq) / sqrt(d) with wqkv unscaled;
// products accumulate in f32; LN and softmax statistics in f32, the softmax
// max-subtracted; d_b scales the f32 delta. A window of N = ws^2 tokens is
// padded to one 64-token tile (am_window.cuh): the padding tokens' LN rows
// are zeros and their keys score -inf, and their rows are never stored.
//
// Bound on the card at SwinFIR's step (T = 131,072 tokens, C 180, 6 heads
// of 30): 2 T C 4C + 4 T 64 C = 40.0 GFLOP, 0.243 ms at 3xTF32 (0.598 on
// the FMA pipes), against 0.028 ms for x and y. window_attention.cu ran a
// window a 256-thread block, its heads one after another, every product on
// the FMA pipes (4 x 4 outputs a thread, a barrier every 32-row weight
// chunk, the weights restaged from L2 for every window and head; 211 KB of
// shared memory at C 180, one window an SM). Here, the forward half of
// attn_bwd_f32.cu's structure, every product 3xTF32 on the tensor cores
// (tf32x3.cuh), tokens in tile order (a window a 64-row tile):
// 0. wa32_ln_kernel, a warp a token row: LN, gathered through the shift,
//    zero rows for padding tokens;
// 1. q|k|v = LN Wqkv + bqkv (q scaled), a row product on wgmma
//    (tfw_gemm_kernel, B8 f32's epilogue TfQkv), each head padded to DP =
//    pad16(d) columns (zero past d);
// 2. wa32_attn_kernel, a block of four warps owning (head, group of
//    windows), a window at a time: q, k and v by cp.async into shared
//    memory, the next window's in flight; each warp's 16 queries: scores =
//    q k^T on mma.sync, bias and mask, the softmax in registers, attn = p v
//    with p as A fragments straight from the score fragments (the key order
//    inside each 8-key step permuted so that a thread's two score columns
//    are its two A columns, and v's rows read in the same order). attn goes
//    out to the row of the token's own pixel (the shift undone), heads
//    padded to DP;
// 3. y = x + d_b (attn Wproj + bproj), a row product on wgmma over the
//    pixels in order, x read into shared memory under the last products
//    (TfResid).
// The bytes a launch moves (LN rows 0.19 GB, q|k|v 0.60 GB, attn 0.20 GB,
// x and y) take about 0.38 ms at 3.35 TB/s: the passes overlap them with
// the products of other blocks. What bounds it (scripts/torch_ablate_f32_fwd.py):
// not the tensor pipes, since one TF32 term a product instead of three saves
// a tenth of the time; the row products (q|k|v the largest pass) wait on
// their stage loop, each 32-row stage's products drained before its sum is
// added (tf32x3.cuh TF_BK), at three blocks an SM; the attention pass runs
// three blocks an SM too, where its registers do not spill.
// The weights change every step, so they are packed per call (tfw_pack: a
// gather by the index table of ops/cuda/window_attention.py
// _f32_fwd_pack_index and the split into hi and lo images: Wqkv with each
// head's q, k, v columns padded to DP, Wproj with its head rows padded).
// Windows 9..16 (bound on HAT x4 f32 serving's 256 x 256 map 0.176 ms, at
// its f32 step 0.353 at 3xTF32): a window fills NCH = ceil(ws^2 / 64)
// tiles, so passes 0, 1 and 3 run as above over NCH tiles a window; pass 2
// is the bias put in fragment order (am_bias_kernel) and tf_window16.cuh's
// tw_rows_kernel (one block of eight warps an SM, a window's keys split once
// and kept in shared memory, the online softmax over its 64-key chunks).
// Takes f32, windows 2..16, head dims up to 32, C a multiple of 4 up to
// 256, H and W multiples of the window; the wrapper routes anything else.
#include <cmath>

#include "tf_window16.cuh"

// Attention blocks an SM (55.6 KB of shared memory each at DP 32): three, at
// up to 168 registers a thread; four spill at 128 (scripts/torch_ablate_f32_fwd.py)
constexpr int WA32_BLOCKS = 3;

struct Wa32Args {
  AmArgs geo;  // H, W, shift, nwx, nwi: the token geometry am_pixel and am_region read
  const float *x, *ln_w, *ln_b, *relbias;
  float *ln, *qkv, *att;
  long long windows, rows;
  int groups;
};

// Pass 0, a warp a token row (rows in tile order): LN, or zeros for a
// padding token.
__global__ void __launch_bounds__(256) wa32_ln_kernel(const Wa32Args a, const AmGeom G) {
  for (long long row = blockIdx.x * 8LL + (threadIdx.x >> 5); row < a.rows; row += gridDim.x * 8LL) {
    const int tile = (int)(row / AM_TOK), t = (int)(row % AM_TOK);
    float4 v[2];
    if (!am_valid(G, tile, t)) {
      for (int c = 4 * (threadIdx.x & 31); c < G.C; c += 128)
        *reinterpret_cast<float4*>(a.ln + row * G.C + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    tf_load_row(a.x + am_pixel(G, a.geo, tile, t) * G.C, G.C, v);
    tf_ln_fwd(v, G.C, a.ln_w, a.ln_b, a.ln + row * G.C);
  }
}

// Pass 2: a block of four warps owns (head h, window group gi) and walks the
// group's windows; warp w takes queries 16 w .. 16 w + 15 of the window.
// Shared memory: two sets of q, k, v (64 x DP, rows DP + 4 apart; the next
// window's loads in flight while this one is computed), the keys' shift
// regions.
__host__ __device__ inline size_t wa32_attn_smem(int DP) {
  return 6 * (size_t)AM_TOK * (DP + 4) * 4 + AM_TOK * 4;
}

template <int DP>
__global__ void __launch_bounds__(128, WA32_BLOCKS) wa32_attn_kernel(const Wa32Args a, const AmGeom G) {
  constexpr int LDQ = DP + 4, NDT = DP / 8, SET = 3 * AM_TOK * LDQ;
  extern __shared__ __align__(16) float sm32[];
  int* reg = (int*)(sm32 + 2 * SET);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x % G.heads, gi = blockIdx.x / G.heads, q0 = 16 * warp, NV = G.NV;
  // the bias and mask of score (row, col)
  auto bias = [&](int row, int col) -> float {
    if (col >= NV) return -INFINITY;
    if (row >= NV) return 0.f;
    const float b = __ldg(a.relbias + ((long long)h * NV + row) * NV + col);
    return a.geo.shift && reg[row] != reg[col] ? b - 100.f : b;
  };

  // window w's q, k and v into set b, one cp.async group
  auto load = [&](long long w, int b) {
    const long long row0 = w * AM_TOK;
    float* set = sm32 + b * SET;
    for (int i = tid; i < 3 * AM_TOK * (DP / 4); i += 128) {
      const int buf = i / (AM_TOK * (DP / 4)), rem = i % (AM_TOK * (DP / 4)), r = rem / (DP / 4), c4 = rem % (DP / 4);
      hm_cp_async<16>(set + (buf * AM_TOK + r) * LDQ + 4 * c4, a.qkv + (row0 + r) * G.K3 + buf * G.HD + h * DP + 4 * c4,
                      true);
    }
  };
  if (gi < a.windows) load(gi, 0);
  hm_cp_commit();
  int it = 0;
  for (long long w = gi; w < a.windows; w += a.groups, ++it) {
    const float* Qs = sm32 + (it & 1) * SET;
    const float *Ks = Qs + AM_TOK * LDQ, *Vs = Ks + AM_TOK * LDQ;
    __syncthreads();  // the last window's set and regions are read
    if (w + a.groups < a.windows) load(w + a.groups, (it & 1) ^ 1);
    hm_cp_commit();
    if (a.geo.shift)
      for (int k = tid; k < AM_TOK; k += 128) reg[k] = k < NV ? am_region(G, a.geo, (int)(w % a.geo.nwi), k) : -1;
    hm_cp_wait_upto(1);  // this window's set is in
    __syncthreads();

    // scores of this warp's 16 queries against the 64 keys, two key tiles
    // interleaved
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP; ks += 8) {
      uint32_t qh[4], ql[4];
      const float* qr = Qs + (q0 + g) * LDQ + ks + t;
      const float qv[4] = {qr[0], qr[8 * LDQ], qr[4], qr[8 * LDQ + 4]};
      tf_split4(qv, qh, ql);
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t kh[2], kl[2], jh[2], jl[2];
        const float* k0 = Ks + (8 * nt + g) * LDQ + ks + t;
        tf_split2(k0[0], k0[4], kh, kl);
        tf_split2(k0[8 * LDQ], k0[8 * LDQ + 4], jh, jl);
        tf_mma3x2(s[nt], qh, ql, kh, kl, s[nt + 1], qh, ql, jh, jl);
      }
    }
    // the softmax, max-subtracted, in f32
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] += bias(q0 + g + 8 * (e >> 1), 8 * nt + 2 * t + (e & 1));
        m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
      }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) m[hh] = am_quad_max(m[hh]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.f / am_quad_sum(l[hh]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= inv[e >> 1];

    // attn = p v: key 8 kb + 2t + e of the score fragment is A column t + 4 e
    // of step kb, and v's rows are read in that order; two column tiles
    // interleaved
    float o[NDT][4];
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      uint32_t ph[4], pl[4];
      const float pv[4] = {s[kb][0], s[kb][2], s[kb][1], s[kb][3]};
      tf_split4(pv, ph, pl);
#pragma unroll
      for (int nd = 0; nd < NDT; nd += 2) {
        uint32_t vh[2], vl[2], uh[2], ul[2];
        const int r = (8 * kb + 2 * t) * LDQ + 8 * nd + g;
        tf_split2(Vs[r], Vs[r + LDQ], vh, vl);
        tf_split2(Vs[r + 8], Vs[r + LDQ + 8], uh, ul);
        tf_mma3x2(o[nd], ph, pl, vh, vl, o[nd + 1], ph, pl, uh, ul);
      }
    }
    // to the rows of the queries' own pixels (padding queries dropped)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = q0 + g + 8 * hh;
      if (q >= NV) continue;
      float* dst = a.att + am_pixel(G, a.geo, (int)w, q) * G.HD + h * DP + 2 * t;
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd)
        *reinterpret_cast<float2*>(dst + 8 * nd) = make_float2(o[nd][2 * hh], o[nd][2 * hh + 1]);
    }
  }
}

// The packed weights (tfw_pack's images): Wqkv (C x K3) and Wproj (HD x C);
// their hi values (the lo ones as many).
static long long wa32_pack_elems(const AmGeom& G) { return tfw_elems(G.C, G.K3) + tfw_elems(G.HD, G.C); }

// The f32 scratch, each region 16-byte aligned: the packed weights; LN rows
// (C) and q|k|v rows (K3) in tile order; attn rows (HD) in pixel order.
struct Wa32Scratch {
  long long pack, ln, qkv, att, bfrag, f_elems;
  long long windows, rows, pixels;
  int groups;
};

static Wa32Scratch wa32_scratch(int B, int H, int W, int C, int heads, int ws, int sms) {
  const AmGeom G(C, heads, ws);
  Wa32Scratch S;
  auto at = [](long long& o, long long n) {
    const long long r = o;
    o = (o + n + 3) & ~3LL;
    return r;
  };
  S.windows = (long long)B * (H / ws) * (W / ws);
  S.rows = S.windows * G.N;
  S.pixels = (long long)B * H * W;
  if (G.NCH > 1) {
    S.groups = tw_rows_groups(S.windows, heads, sms);
  } else {
    const long long groups = ((long long)WA32_BLOCKS * sms + heads - 1) / heads;  // about WA32_BLOCKS an SM
    S.groups = (int)(groups > S.windows ? S.windows : groups);
  }
  long long o = 0;
  S.pack = at(o, 2 * wa32_pack_elems(G));
  S.ln = at(o, S.rows * C);
  S.qkv = at(o, S.rows * G.K3);
  S.att = at(o, S.pixels * G.HD);
  S.bfrag = at(o, G.NCH > 1 ? (long long)heads * G.N * G.N : 0);
  S.f_elems = o;
  return S;
}

// Elements of the packed weights (ops/cuda/window_attention.py checks its
// own count against it), or -1 for a geometry the kernels do not take.
extern "C" long long window_attention_mma_f32_pack_elems(int C, int heads) {
  return tf_window_ok(C, heads, 8) ? wa32_pack_elems(AmGeom(C, heads, 8)) : -1;
}

extern "C" int window_attention_mma_f32_scratch(int B, int H, int W, int C, int heads, int ws, long long* f_elems) {
  int sms = 0;
  const cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  *f_elems = wa32_scratch(B, H, W, C, heads, ws, sms).f_elems;
  return 0;
}

template <int DP>
static cudaError_t wa32_launch_attn(const Wa32Args& a, const AmGeom& G, cudaStream_t stream) {
  const size_t bytes = wa32_attn_smem(DP);
  cudaError_t err = allow_smem(wa32_attn_kernel<DP>, bytes);
  if (err != cudaSuccess) return err;
  wa32_attn_kernel<DP><<<G.heads * a.groups, 128, bytes, stream>>>(a, G);
  return cudaGetLastError();
}

// relbias is the gathered bias (heads, ws^2, ws^2) in f32; wqkv (C x 3C)
// and wproj (C x C), (in, out) layout, are gathered by pack_index.
static int wa32_run(const void* x, void* out, int B, int H, int W, int C, int heads, int ws, int shift,
                    const void* ln_w, const void* ln_b, const void* bqkv, const void* bproj, const void* relbias,
                    const void* dp, const void* wqkv, const void* wproj, const void* pack_index, long long pack_elems,
                    void* fscratch, long long f_elems, void* stream) {
  if (B < 1 || H < ws || W < ws || H % ws || W % ws || shift < 0 || shift >= ws) return (int)cudaErrorInvalidValue;
  const AmGeom G(C, heads, ws);
  int sms = 0;
  cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const Wa32Scratch S = wa32_scratch(B, H, W, C, heads, ws, sms);
  if (S.f_elems != f_elems || wa32_pack_elems(G) != pack_elems) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || (uintptr_t)out % 16 || (uintptr_t)fscratch % 16 || (uintptr_t)ln_w % 16 ||
      (uintptr_t)ln_b % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  float* f = (float*)fscratch;
  Wa32Args a{};
  a.geo.H = H, a.geo.W = W, a.geo.shift = shift, a.geo.nwx = W / ws, a.geo.nwi = (H / ws) * (W / ws);
  a.x = (const float*)x, a.ln_w = (const float*)ln_w, a.ln_b = (const float*)ln_b;
  a.relbias = (const float*)relbias;
  a.ln = f + S.ln, a.qkv = f + S.qkv, a.att = f + S.att;
  a.windows = S.windows, a.rows = S.rows, a.groups = S.groups;
  const float scale = (float)(1.0 / std::sqrt((double)G.d));  // 1 / sqrt(d), rounded once
  const long long e1 = tfw_elems(C, G.K3);
  float *wq = f + S.pack, *wp = wq + 2 * e1;
  const int* idx = (const int*)pack_index;

  const float *wa = (const float*)wqkv, *wb = (const float*)wproj;
  err = tfw_pack(wa, 3LL * C * C, wb, (long long)C * C, idx, C, G.K3, wq, st);
  if (err == cudaSuccess) err = tfw_pack(wa, 3LL * C * C, wb, (long long)C * C, idx + e1, G.HD, C, wp, st);
  if (err != cudaSuccess) return (int)err;
  wa32_ln_kernel<<<8 * sms, 256, 0, st>>>(a, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // q|k|v = LN Wqkv + bqkv (q scaled)
  err = tfw_gemm(TfwGemm{a.ln, wq, C, S.rows, C, G.K3},
                 TfQkv{a.qkv, (const float*)bqkv, S.rows, G.K3, G.HD, G.DP, C, G.d, scale}, st);
  if (err != cudaSuccess) return (int)err;
  if (G.NCH > 1) {  // windows 9..16: the bias in fragment order, then tf_window16.cuh's pass
    float* bf = f + S.bfrag;
    err = tw_bias_order(a.relbias, G, bf, st);
    const TwRows r{a.geo, a.qkv, nullptr, reinterpret_cast<const float4*>(bf), a.att, nullptr, a.windows, a.groups, 0};
    if (err == cudaSuccess) err = G.DP == 32 ? tw_rows_launch<32, false>(r, G, st) : tw_rows_launch<16, false>(r, G, st);
  } else {
    err = G.DP == 32 ? wa32_launch_attn<32>(a, G, st) : wa32_launch_attn<16>(a, G, st);
  }
  if (err != cudaSuccess) return (int)err;
  // y = x + d_b (attn Wproj + bproj), the pixels in order
  return (int)tfw_gemm(TfwGemm{a.att, wp, G.HD, S.pixels, G.HD, C},
                       TfResid{a.x, C, (float*)out, (const float*)bproj, (const float*)dp, S.pixels,
                               (long long)H * W, C},
                       st);
}

// Two entries, one a family: windows 2..8 (one tile a window) and 9..16 (two
// to four tiles), each with its own geometry rule.
#define WINDOW_ATTENTION_F32_ENTRY(NAME, OK)                                                                      \
  extern "C" int NAME(const void* x, void* out, int B, int H, int W, int C, int heads, int ws, int shift,         \
                      const void* ln_w, const void* ln_b, const void* bqkv, const void* bproj, const void* relbias, \
                      const void* dp, const void* wqkv, const void* wproj, const void* pack_index,                \
                      long long pack_elems, void* fscratch, long long f_elems, void* stream) {                    \
    if (!OK(C, heads, ws)) return (int)cudaErrorInvalidValue;                                                     \
    return wa32_run(x, out, B, H, W, C, heads, ws, shift, ln_w, ln_b, bqkv, bproj, relbias, dp, wqkv, wproj,      \
                    pack_index, pack_elems, fscratch, f_elems, stream);                                           \
  }

WINDOW_ATTENTION_F32_ENTRY(window_attention_mma_f32, tf_window_ok)
WINDOW_ATTENTION_F32_ENTRY(window_attention16_mma_f32, tf_window16_ok)
