// B10 in f32, written for the H100: HAT's overlapping cross-attention block,
//   u = LN1 x;  q from each ws x ws window of u Wq; k, v from the owin x owin
//   window around it (owin = ws + 2 pad) of u Wk, u Wv, zero outside the image;
//   y = x + proj(softmax(q k^T / sqrt(d) + bias) v);
//   out = y + fc2(gelu(fc1(LN2 y))).
//
// Replaces studiosr_tpu/ops/pallas/ocab.py::fused_ocab_block (:173, kernel
// _ocab_kernel at :41) in f32: HAT served in f32 (6 launches a forward at
// x4) and every f32 check of it. bf16 runs ocab_mma.cu; f32 outside the
// geometry below keeps ocab.cu. The contract is the TPU kernel's with T =
// f32: q = (LN1 Wq + bq) / sqrt(d) with wqkv unscaled; keys and values
// outside the image are zero rows after the projection (the reference's
// zero-padded unfold), so their logits are the bias alone and they take
// softmax mass, unmasked; key slots past owin^2 are masked; LN and softmax
// statistics in f32, the softmax max-subtracted; every product accumulated
// in f32.
//
// Bound on the card at HAT x4 serving's shapes (T = 65,536 pixels, C 180,
// 6 heads of 30, ws 16, 576 keys, hidden 360): 2 T C 4C (q|k|v, proj) + 4 T
// 576 C (scores, p v) + 4 T C hidden (MLP) = 61.2 GFLOP, 0.3708 ms at
// 3xTF32 (164.9 TFLOP/s), 0.914 on the FMA pipes, against 0.094 ms for x
// and out. ocab.cu ran its attention pass on the FMA pipes through
// shared-memory tiles, one head at a time (6.26 of its 8.22 ms, NVIDIA H100
// 80GB HBM3, 700 W). Here every product is 3xTF32 on the tensor cores
// (tf32x3.cuh), five passes:
// 0. LN1, a warp a pixel (mf32_mlp.cuh's row pass), pixels in order;
// 1. q|k|v = LN1 Wqkv + bqkv (q scaled), a row product on wgmma
//    (tfw_gemm_kernel, epilogue TfQkv), each head padded to DP = pad16(d)
//    columns, zero past d: the keys are projected once a pixel;
// 2. oc32_attn_kernel (below): a block of eight warps owns (window, head,
//    slab of 128 queries), each warp 16 query rows whose q fragments stay
//    split in registers; the owin^2 keys come in 64-key chunks (k and v
//    gathered from their pixels' q|k|v rows, a zero row outside the image)
//    through a ring of four cp.async stages, each chunk split once into hi /
//    lo images of k and v in shared memory (two sets, so one barrier a chunk
//    serves the split of chunk c + 1 and the products of chunk c, as
//    oca_bwd_f32.cu's o32_stats_kernel); scores on mma.sync, the bias read
//    in the score fragments' order (two 8-byte loads a key pair), keys past
//    owin^2 at -inf, the online softmax in base 2, and o += p v with p as A
//    fragments straight from the score fragments (a fresh accumulator each
//    32 keys, TF_BK); attn = o / l to the queries' own pixel rows;
// 3. y = x + attn Wproj + bproj, a row product on wgmma with the residual
//    epilogue (TfResid);
// 4. the MLP tail over y's rows: B6 f32's passes (mf32_mlp.cuh).
// The weights are packed per call as B5 f32's and B6 f32's are (tfw_pack
// by the index tables of ops/cuda/window_attention.py _f32_fwd_pack_index
// and ops/cuda/mlp_block.py _f32_pack_index). The attention pass holds
// 147,456 bytes of shared memory at DP 32 (one block an SM) and is written
// for any (nq, nk) of one (window, head) with the bias (heads, nq, nk), so
// B12 f32's forward (oca_core_fwd at 256 x 576) could run it too.
// Takes f32, windows from 2 with an even key margin up to 256 queries and
// 576 keys, head dims up to 32, C a multiple of 4 up to 256, hidden up to
// 512 (ops/cuda/ocab.py ocab_f32_mma_takes).
#include <cmath>

#include "mf32_mlp.cuh"

constexpr int OC32_SLAB = 128;  // query rows a block: eight warps of 16
constexpr int OC32_TOK = 64;    // keys a chunk
constexpr int OC32_THREADS = 256;
constexpr int OC32_STAGES = 4;  // key chunks in flight
constexpr int OC32_MAX_NQ = 256, OC32_MAX_NK = 576;

struct Oc32Geom {
  int C, heads, d, DP, HD, K3, ws, pad, owin, nq, nk, SL, KT, hidden;
  __host__ __device__ Oc32Geom(int C_, int heads_, int ws_, int pad_, int hidden_)
      : C(C_), heads(heads_), ws(ws_), pad(pad_), hidden(hidden_) {
    d = C / heads;
    DP = (d + 15) & ~15;
    HD = heads * DP;
    K3 = 3 * HD;
    owin = ws + 2 * pad;
    nq = ws * ws;
    nk = owin * owin;
    SL = (nq + OC32_SLAB - 1) / OC32_SLAB;
    KT = (nk + OC32_TOK - 1) / OC32_TOK;
  }
};

static bool oc32_geometry_ok(const Oc32Geom& G) {
  return G.ws >= 2 && G.pad >= 0 && G.heads >= 1 && G.C % G.heads == 0 && G.C % 4 == 0 && G.C >= 4 &&
         G.C <= TF_MAX_C && G.d <= 32 && G.nq <= OC32_MAX_NQ && G.nk <= OC32_MAX_NK && G.hidden >= 1 &&
         G.hidden <= MF32_MAX_HIDDEN;
}

struct Oc32Attn {
  const float* qkv;   // pixel rows of K3: q (scaled) | k | v, each head DP columns, zero past d
  const float* bias;  // (heads, nq, nk) f32
  float* att;         // pixel rows of HD
  int H, W, nwx, nwin;
};

// Shared memory of the attention pass: OC32_STAGES f32 stages of a chunk's
// k and v (64 x (DP + 4) each), then two sets of the hi and lo images of k
// and v.
template <int DP>
__host__ __device__ inline size_t oc32_attn_smem() {
  return ((size_t)OC32_STAGES * 2 + 8) * OC32_TOK * (DP + 4) * 4;
}

template <int DP>
__global__ void __launch_bounds__(OC32_THREADS, 1) oc32_attn_kernel(const Oc32Attn a, const Oc32Geom G) {
  constexpr int LD = DP + 4, KS = DP / 8, NDT = DP / 8, CH = OC32_TOK * LD, PIECES = 2 * OC32_TOK * (DP / 4);
  extern __shared__ __align__(16) float oc32_sm[];
  uint32_t* splits = reinterpret_cast<uint32_t*>(oc32_sm + OC32_STAGES * 2 * CH);  // two sets of k hi, k lo, v hi, v lo
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int sl = blockIdx.x % G.SL, h = (blockIdx.x / G.SL) % G.heads;
  const long long win = blockIdx.x / G.SL / G.heads;
  const int img = (int)(win / a.nwin), wi = (int)(win % a.nwin), wy = wi / a.nwx, wx = wi % a.nwx;
  const long long base = (long long)img * a.H * a.W;
  const int KT = G.KT, nq = G.nq, nk = G.nk;
  // pixel of query row q of the window, or -1 past nq
  auto qpix = [&](int q) -> long long {
    return q < nq ? base + (long long)(wy * G.ws + q / G.ws) * a.W + wx * G.ws + q % G.ws : -1;
  };
  // pixel of key k of the window's owin x owin keys, or -1 (a zero row: outside the image or past nk)
  auto kpix = [&](int k) -> long long {
    if (k >= nk) return -1;
    const int y = wy * G.ws - G.pad + k / G.owin, x = wx * G.ws - G.pad + k % G.owin;
    return y < 0 || y >= a.H || x < 0 || x >= a.W ? -1 : base + (long long)y * a.W + x;
  };
  const int r0 = sl * OC32_SLAB + 16 * warp;  // the warp's first query row
  uint32_t qh[KS][4], ql[KS][4];
  {
    const long long p0 = qpix(r0 + g), p1 = qpix(r0 + g + 8);
    const float* q0 = p0 >= 0 ? a.qkv + p0 * G.K3 + h * DP : nullptr;
    const float* q1 = p1 >= 0 ? a.qkv + p1 * G.K3 + h * DP : nullptr;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = 8 * ks + t;
      const float v[4] = {q0 ? __ldg(q0 + c) : 0.f, q1 ? __ldg(q1 + c) : 0.f, q0 ? __ldg(q0 + c + 4) : 0.f,
                          q1 ? __ldg(q1 + c + 4) : 0.f};
      tf_split4(v, qh[ks], ql[ks]);
    }
  }
  // chunk c's k and v into stage c % OC32_STAGES, one cp.async group (empty past the last)
  auto load = [&](int c) {
    if (c < KT) {
      float* stage = oc32_sm + (c % OC32_STAGES) * 2 * CH;
      for (int i = tid; i < PIECES; i += OC32_THREADS) {
        const int which = i / (PIECES / 2), rem = i % (PIECES / 2), r = rem / (DP / 4), c4 = rem % (DP / 4);
        const long long p = kpix(c * OC32_TOK + r);
        hm_cp_async<16>(stage + which * CH + r * LD + 4 * c4,
                        p >= 0 ? a.qkv + p * G.K3 + (1 + which) * G.HD + h * DP + 4 * c4 : a.qkv, p >= 0);
      }
    }
    hm_cp_commit();
  };
  // chunk c's f32 stage into split set c & 1
  auto split_chunk = [&](int c) {
    const float* stage = oc32_sm + (c % OC32_STAGES) * 2 * CH;
    uint32_t* set = splits + (c & 1) * 4 * CH;
    tf_split_rows<DP, LD, OC32_THREADS>(stage, set, set + CH, OC32_TOK);
    tf_split_rows<DP, LD, OC32_THREADS>(stage + CH, set + 2 * CH, set + 3 * CH, OC32_TOK);
  };
  // the bias of the score fragment (rows r, r + 8; columns col, col + 1), zero past nq and nk
  const float* bh = a.bias + (size_t)h * nq * nk;
  auto bias4 = [&](int r, int col) -> float4 {
    float v[4];
    if ((nk & 1) == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r + 8 * hh;
        const float2 f = row < nq && col < nk ? __ldg(reinterpret_cast<const float2*>(bh + (size_t)row * nk + col))
                                              : make_float2(0.f, 0.f);
        v[2 * hh] = f.x, v[2 * hh + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r + 8 * (e >> 1), cc = col + (e & 1);
        v[e] = row < nq && cc < nk ? __ldg(bh + (size_t)row * nk + cc) : 0.f;
      }
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  };
  static_assert(OC32_STAGES >= 3, "chunk c + 1 in flight while chunk c is formed");
#pragma unroll
  for (int j = 0; j < OC32_STAGES - 1; ++j) load(j);
  hm_cp_wait_upto(OC32_STAGES - 2);
  __syncthreads();  // chunk 0 is in
  split_chunk(0);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[NDT][4];
#pragma unroll
  for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
#pragma unroll 1
  for (int c = 0; c < KT; ++c) {
    hm_cp_wait_upto(OC32_STAGES - 3);
    __syncthreads();  // chunk c's split set and chunk c + 1 are in; every warp is done with chunk c - 1
    load(c + OC32_STAGES - 1);  // into chunk c - 1's stage, split two chunks ago
    float4 bb[8];  // loaded before the products, so their latency hides under them
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) bb[nt] = bias4(r0 + g, c * OC32_TOK + nt * 8 + 2 * t);
    if (c + 1 < KT) split_chunk(c + 1);  // into the set chunk c - 1 used
    const uint32_t* Kh = splits + (c & 1) * 4 * CH;
    const uint32_t *Kl = Kh + CH, *Vh = Kh + 2 * CH, *Vl = Kh + 3 * CH;
    // scores = q k^T + bias, -inf past nk
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        const int at = (8 * nt + g) * LD + 8 * ks + t;
        const uint32_t k0h[2] = {Kh[at], Kh[at + 4]}, k0l[2] = {Kl[at], Kl[at + 4]};
        const uint32_t k1h[2] = {Kh[at + 8 * LD], Kh[at + 8 * LD + 4]};
        const uint32_t k1l[2] = {Kl[at + 8 * LD], Kl[at + 8 * LD + 4]};
        tf_mma3x2(s[nt], qh[ks], ql[ks], k0h, k0l, s[nt + 1], qh[ks], ql[ks], k1h, k1l);
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = c * OC32_TOK + nt * 8 + 2 * t;
      s[nt][0] = col < nk ? s[nt][0] + bb[nt].x : -INFINITY;
      s[nt][1] = col + 1 < nk ? s[nt][1] + bb[nt].y : -INFINITY;
      s[nt][2] = col < nk ? s[nt][2] + bb[nt].z : -INFINITY;
      s[nt][3] = col + 1 < nk ? s[nt][3] + bb[nt].w : -INFINITY;
    }
    // the online softmax (chunk 0 always holds a key, so m is finite from it on)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      const float mn = fmaxf(m[hh], am_quad_max(mx) * AM_LOG2E), sc = am_exp2(m[hh] - mn);
      l[hh] *= sc, m[hh] = mn;
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd) o[nd][2 * hh] *= sc, o[nd][2 * hh + 1] *= sc;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = am_exp2(fmaf(s[nt][2 * hh + e], AM_LOG2E, -mn));
          l[hh] += p;
          s[nt][2 * hh + e] = p;
        }
    }
    // o += p v, a fresh accumulator for each 32 keys
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float part[NDT][4];
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nd][e] = 0.f;
#pragma unroll
      for (int kb = 4 * half; kb < 4 * half + 4; ++kb) {
        uint32_t ph[4], pl[4];
        const float pv[4] = {s[kb][0], s[kb][2], s[kb][1], s[kb][3]};
        tf_split4(pv, ph, pl);
#pragma unroll
        for (int nd = 0; nd < NDT; nd += 2) {
          const int at = (8 * kb + 2 * t) * LD + 8 * nd + g;
          const uint32_t v0h[2] = {Vh[at], Vh[at + LD]}, v0l[2] = {Vl[at], Vl[at + LD]};
          const uint32_t v1h[2] = {Vh[at + 8], Vh[at + LD + 8]}, v1l[2] = {Vl[at + 8], Vl[at + LD + 8]};
          tf_mma3x2(part[nd], ph, pl, v0h, v0l, part[nd + 1], ph, pl, v1h, v1l);
        }
      }
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nd][e] += part[nd][e];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float inv = 1.f / am_quad_sum(l[hh]);
    const long long p = qpix(r0 + g + 8 * hh);
    if (p < 0) continue;  // a padding query: no pixel
    float* dst = a.att + p * G.HD + h * DP + 2 * t;
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd)
      *reinterpret_cast<float2*>(dst + 8 * nd) = make_float2(o[nd][2 * hh] * inv, o[nd][2 * hh + 1] * inv);
  }
}

template <int DP>
static cudaError_t oc32_attn_launch(const Oc32Attn& a, const Oc32Geom& G, long long windows, cudaStream_t stream) {
  const size_t bytes = oc32_attn_smem<DP>();
  cudaError_t err = allow_smem(oc32_attn_kernel<DP>, bytes);
  if (err != cudaSuccess) return err;
  oc32_attn_kernel<DP><<<(unsigned)(windows * G.heads * G.SL), OC32_THREADS, bytes, stream>>>(a, G);
  return cudaGetLastError();
}

// The attention half's packed weights (tfw_pack's images): Wqkv (C x K3)
// and Wproj (HD x C); their hi values (the lo ones as many).
static long long oc32_pack_elems(const Oc32Geom& G) { return tfw_elems(G.C, G.K3) + tfw_elems(G.HD, G.C); }

// The f32 scratch, each region 16-byte aligned: the attention half's packed
// weights; LN1 rows (C), q|k|v rows (K3), attn rows (HD) and y rows (C), in
// pixel order; the MLP tail's own scratch (mf32_scratch).
struct Oc32Scratch {
  long long pack, ln, qkv, att, y, mlp, mlp_elems, f_elems;
};

static Oc32Scratch oc32_scratch(long long pixels, const Oc32Geom& G) {
  Oc32Scratch S;
  auto at = [](long long& o, long long n) {
    const long long r = o;
    o = (o + n + 3) & ~3LL;
    return r;
  };
  long long o = 0;
  S.pack = at(o, 2 * oc32_pack_elems(G));
  S.ln = at(o, pixels * G.C);
  S.qkv = at(o, pixels * G.K3);
  S.att = at(o, pixels * G.HD);
  S.y = at(o, pixels * G.C);
  S.mlp_elems = mf32_scratch(pixels, G.C, G.hidden, false).f_elems;
  S.mlp = at(o, S.mlp_elems);
  S.f_elems = o;
  return S;
}

// Elements of the attention half's packed weights (ops/cuda/ocab.py checks
// its own count against it), or -1 for a geometry the kernels do not take.
extern "C" long long ocab_mma_f32_pack_elems(int C, int heads, int ws, int pad, int hidden) {
  const Oc32Geom G(C, heads, ws, pad, hidden);
  return oc32_geometry_ok(G) ? oc32_pack_elems(G) : -1;
}

extern "C" long long ocab_mma_f32_scratch(int B, int H, int W, int C, int heads, int ws, int pad, int hidden) {
  return oc32_scratch((long long)B * H * W, Oc32Geom(C, heads, ws, pad, hidden)).f_elems;
}

// relbias is the gathered bias (heads, ws^2, owin^2) in f32; wqkv (C x 3C),
// wproj (C x C) are gathered by attn_index (B5 f32's rule), w1 (C x hidden)
// and w2 (hidden x C) by mlp_index (B6 f32's), all (in, out).
extern "C" int ocab_mma_f32(const void* x, void* out, int B, int H, int W, int C, int heads, int ws, int pad,
                            int hidden, const void* ln1_w, const void* ln1_b, const void* bqkv, const void* bproj,
                            const void* relbias, const void* ln2_w, const void* ln2_b, const void* b1,
                            const void* b2, const void* wqkv, const void* wproj, const void* w1, const void* w2,
                            const void* attn_index, long long attn_pack, const void* mlp_index, long long mlp_pack,
                            void* fscratch, long long f_elems, void* stream) {
  const Oc32Geom G(C, heads, ws, pad, hidden);
  if (!oc32_geometry_ok(G) || B < 1 || H < ws || W < ws || H % ws || W % ws) return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)B * H * W;
  const Oc32Scratch S = oc32_scratch(pixels, G);
  if (S.f_elems != f_elems || oc32_pack_elems(G) != attn_pack) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || (uintptr_t)out % 16 || (uintptr_t)fscratch % 16 || (uintptr_t)ln1_w % 16 ||
      (uintptr_t)ln1_b % 16 || ((G.nk & 1) == 0 && (uintptr_t)relbias % 8))
    return (int)cudaErrorMisalignedAddress;
  int sms = 0;
  cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  float* f = (float*)fscratch;
  float *ln = f + S.ln, *qkv = f + S.qkv, *att = f + S.att, *y = f + S.y;
  const float scale = (float)(1.0 / std::sqrt((double)G.d));  // 1 / sqrt(d), rounded once
  const long long e1 = tfw_elems(C, G.K3);
  float *wq = f + S.pack, *wp = wq + 2 * e1;
  const int* idx = (const int*)attn_index;
  const float *wa = (const float*)wqkv, *wb = (const float*)wproj;
  err = tfw_pack(wa, 3LL * C * C, wb, (long long)C * C, idx, C, G.K3, wq, st);
  if (err == cudaSuccess) err = tfw_pack(wa, 3LL * C * C, wb, (long long)C * C, idx + e1, G.HD, C, wp, st);
  if (err != cudaSuccess) return (int)err;
  // LN1, the pixels in order
  mf32_ln_kernel<false><<<8 * sms, 256, 0, st>>>((const float*)x, nullptr, nullptr, nullptr, ln, (const float*)ln1_w,
                                                (const float*)ln1_b, pixels, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // q|k|v = LN1 Wqkv + bqkv (q scaled)
  err = tfw_gemm(TfwGemm{ln, wq, C, pixels, C, G.K3},
                 TfQkv{qkv, (const float*)bqkv, pixels, G.K3, G.HD, G.DP, C, G.d, scale}, st);
  if (err != cudaSuccess) return (int)err;
  const Oc32Attn a{qkv, (const float*)relbias, att, H, W, W / ws, (H / ws) * (W / ws)};
  const long long windows = (long long)B * a.nwin;
  err = G.DP == 32 ? oc32_attn_launch<32>(a, G, windows, st) : oc32_attn_launch<16>(a, G, windows, st);
  if (err != cudaSuccess) return (int)err;
  // y = x + attn Wproj + bproj
  err = tfw_gemm(TfwGemm{att, wp, G.HD, pixels, G.HD, C},
                 TfResid{(const float*)x, C, y, (const float*)bproj, nullptr, pixels, (long long)H * W, C}, st);
  if (err != cudaSuccess) return (int)err;
  // out = y + fc2(gelu(fc1(LN2 y)))
  return mf32_run<false>(y, nullptr, nullptr, out, (int)pixels, C, hidden, ln2_w, ln2_b, w1, b1, w2, b2, nullptr, 0,
                         mlp_index, mlp_pack, f + S.mlp, S.mlp_elems, stream);
}
