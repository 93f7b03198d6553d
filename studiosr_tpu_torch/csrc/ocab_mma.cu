// B10 in bf16, written for the H100: HAT's overlapping cross-attention block,
//   u = LN1 x;  q from each ws x ws window of u Wq (scaled by 1/sqrt(d)); k,
//   v from the owin x owin window around it (owin = ws + 2 pad) of u Wk,
//   u Wv, zero outside the image;
//   y = x + proj(softmax(q k^T + bias) v);
//   out = y + fc2(gelu(fc1(LN2 y))),
// on (B, H, W, C) maps.
//
// Replaces studiosr_tpu/ops/pallas/ocab.py::fused_ocab_block (:173, kernel
// _ocab_kernel at :41) in bf16; f32, the checks' dtype, keeps ocab.cu, and so
// do head dims above 32, windows other than 8 and 16, more than 576 keys and
// hidden widths above 384. Keys outside the image are zero k and v rows
// whose logit is the bias alone: they take softmax mass and are not masked
// (only the image slots past owin^2 are). The bias is read in bf16, as the
// TPU kernel rounds it to the map's dtype. Rounding points follow the TPU
// kernel: the LN outputs, q, k, v, the probabilities, the attention output,
// y and the GELU output rounded to bf16; every product accumulated in f32; LN
// and softmax statistics in f32 (the softmax online over 64-key chunks with
// the row max subtracted, p rounded before its division by the row sum, as
// in B12).
//
// Bound on the card at HAT x4 serving's shapes (T = 65,536 tokens, C 180, 6
// heads of 30, window 16, overlap 0.5: 576 keys, hidden 360): 2 T C 4C + 4 T
// 576 C + 4 T C hidden = 61.2 GFLOP against 48 MB of x and out, so the
// tensor-core rate (0.062 ms). ocab.cu ran an LN + q|k|v pass on wmma, an
// attention pass on mma.sync with an f32 bias and B6's first MLP kernel:
// 1.596 ms (NVIDIA H100 80GB HBM3, 700 W). Here, six passes counted as one
// launch, each a pass the other bf16 kernels already run:
// 0. am_ln_kernel (am_window.cuh): LN1 rows in tile order (64 tokens a tile:
//    a window at 8, a quarter of one at 16).
// 1. am_proj_kernel<DP, false>, B5's q|k|v on wgmma, once a pixel (the TPU
//    kernel re-projects each key 2.25 times): per (window, head) q (scaled)
//    and k K-major in d, v K-major in the token, each window's own tokens.
// 2. oc_gather_kernel, a block a (window, head, key chunk): B12's key
//    images, KT chunks of 64 keys of the owin x owin window in of_perm
//    order, k then v, copied from pass 1's images of the one to four
//    windows that hold them; zero rows where a key lies outside the image
//    and past owin^2. Each position's source is found once a block (a
//    first version found it for each 16-byte piece, 64-bit divisions
//    included: 0.30 ms at HAT's shapes, instruction-bound).
// 3. of_fwd_kernel (of_attn.cuh), B12's attention pass, on pass 1's q
//    images and pass 2's key images, the bias read in bf16; the attention
//    output per token row, each head's DP columns (zero past d).
// 4. am_rowgemm_kernel with WaOut, B5's pass 3: y = x + attn Wproj + bproj,
//    to the pixel.
// 5. mf_kernel (mf_mlp.cuh), B6's kernel: out = y + fc2(gelu(fc1(LN2 y))).
// The weights are one blob packed at load time (ops/cuda/ocab.py
// pack_ocab_block): B5's q|k|v and Wproj stages (_fwd_pack_index), then B6's
// fc1 and fc2 stages (_mma_pack_index). No sums across blocks: two launches
// give the same bits.
#include "am_window.cuh"
#include "mf_mlp.cuh"
#include "of_attn.cuh"

// Pass 2's view: pass 1's images (per (window, head) q, k, v of N x DP each)
// and the key images it fills (per (window, head) KT chunks of k, then KT of
// v, each 64 x DP), with the map's window geometry.
struct OcArgs {
  const bf16* proj;
  bf16* kv;
  long long units;
  int heads, ws, pad, owin, nk, N, KT, H, W, nwx, nwi;
};

// Pass 1's image offset of unit u's key `key`: the 64-token q tile (add
// part N DP for k or v) of the (window, head) that holds it, and the key's
// token t in that tile; -1 for a key past owin^2 or outside the image.
__device__ __forceinline__ long long oc_source(const OcArgs& a, long long u, int key, int DP, int& t) {
  if (key >= a.nk) return -1;
  const long long w = u / a.heads;
  const int h = (int)(u % a.heads), img = (int)(w / a.nwi), wi = (int)(w % a.nwi);
  const int y = (wi / a.nwx) * a.ws - a.pad + key / a.owin, x = (wi % a.nwx) * a.ws - a.pad + key % a.owin;
  if (y < 0 || y >= a.H || x < 0 || x >= a.W) return -1;
  const long long sw = (long long)img * a.nwi + (y / a.ws) * a.nwx + x / a.ws;
  const int n = (y % a.ws) * a.ws + x % a.ws;
  t = n % AM_TOK;
  return (sw * a.heads + h) * 3 * a.N * DP + (long long)(n / AM_TOK) * AM_TOK * DP;
}

// A block a (unit, key chunk): its 64 positions' sources first (a thread a
// position, into shared memory), then, as of_pack_kernel writes them, the
// chunk's k image in 16-byte pieces (8 d values of the key at a position, a
// 16-byte copy from pass 1's k image) and its v image in 16-byte pieces of 8
// positions of a d column (eight elements of pass 1's token-major v
// images), consecutive threads on consecutive pieces of the destination.
template <int DP>
__global__ void __launch_bounds__(256) oc_gather_kernel(const OcArgs a) {
  constexpr int JG = DP / 8;
  __shared__ long long src[AM_TOK];
  __shared__ int tok[AM_TOK];
  const long long u = blockIdx.x / a.KT;
  const int c = (int)(blockIdx.x % a.KT), tid = threadIdx.x;
  if (tid < AM_TOK) {
    int t = 0;
    src[tid] = oc_source(a, u, c * AM_TOK + of_perm(tid), DP, t);
    tok[tid] = t;
  }
  __syncthreads();
  const long long part = (long long)a.N * DP;
  bf16* const dst = a.kv + u * 2 * a.KT * AM_TOK * DP;
  for (int i = tid; i < AM_TOK * JG; i += blockDim.x) {  // k
    const int pos = i / JG, jg = i % JG;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (src[pos] >= 0) val = *reinterpret_cast<const uint4*>(a.proj + src[pos] + part + am_kmajor(8 * jg, tok[pos], DP));
    *reinterpret_cast<uint4*>(dst + (long long)c * AM_TOK * DP + am_kmajor(8 * jg, pos, DP)) = val;
  }
  for (int i = tid; i < AM_TOK / 8 * DP; i += blockDim.x) {  // v
    const int tg = i / DP, j = i % DP;
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int pos = 8 * tg + e;
      vals[e] = src[pos] >= 0 ? a.proj[src[pos] + 2 * part + am_kmajor(tok[pos], j, AM_TOK)] : __float2bfloat16(0.f);
    }
    *reinterpret_cast<uint4*>(dst + (long long)(a.KT + c) * AM_TOK * DP + am_kmajor(8 * tg, j, AM_TOK)) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

static bool oc_geometry_ok(int B, int H, int W, int C, int heads, int ws, int pad, int hidden) {
  const int owin = ws + 2 * pad;
  return am_geometry_ok(C, heads, ws) && ws * ws % AM_TOK == 0 && mf_geometry_ok(C, hidden) && pad >= 0 && owin * owin <= OF_MAX_NK &&
         ws * ws <= OF_MAX_NQ && B >= 1 && H >= ws && W >= ws && H % ws == 0 && W % ws == 0;
}

// Scratch in bf16: LN1 rows (SC), pass 1's images (windows x heads x 3 x N x
// DP), the key images (windows x heads x 2 KT x 64 x DP), the attention rows
// (HD) and y (C), each on a 16-byte boundary.
struct OcScratch {
  long long rows, ln, proj, kv, att, y, t_elems;
  int windows, tiles, KT, proj_blocks, row_blocks;
};

static OcScratch oc_scratch(int B, int H, int W, int C, int heads, int ws, int pad, int sms) {
  const AmGeom G(C, heads, ws);
  const int owin = ws + 2 * pad;
  OcScratch S;
  S.KT = (owin * owin + AM_TOK - 1) / AM_TOK;
  S.windows = B * (H / ws) * (W / ws);
  S.tiles = S.windows * G.NCH;
  S.rows = (long long)S.tiles * AM_TOK;
  const int pairs = (S.tiles + 1) / 2;
  S.proj_blocks = pairs < sms ? pairs : sms;
  S.row_blocks = 8 * sms;
  S.ln = 0;
  S.proj = S.ln + S.rows * G.SC;
  S.kv = S.proj + (long long)S.windows * heads * 3 * G.N * G.DP;
  S.att = S.kv + (long long)S.windows * heads * 2 * S.KT * AM_TOK * G.DP;
  S.y = S.att + S.rows * G.HD;
  S.t_elems = S.y + (S.rows * C + 7) / 8 * 8;
  return S;
}

// Elements of the packed weights (ops/cuda/ocab.py checks its own count
// against it), or -1 for a C, heads and hidden width the kernels do not take.
extern "C" long long ocab_mma_pack_elems(int C, int heads, int hidden) {
  if (!am_geometry_ok(C, heads, 16) || !mf_geometry_ok(C, hidden)) return -1;
  return AmGeom(C, heads, 16).fwd_pack_elems() + MfGeom(C, hidden).pack_elems();
}

extern "C" int ocab_mma_scratch(int B, int H, int W, int C, int heads, int ws, int pad, int hidden,
                                long long* t_elems) {
  if (!oc_geometry_ok(B, H, W, C, heads, ws, pad, hidden)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  *t_elems = oc_scratch(B, H, W, C, heads, ws, pad, sms).t_elems;
  return 0;
}

// Passes 1 to 3.
template <int DP>
static cudaError_t oc_launch(const AmArgs& a, const AmGeom& G, const OcArgs& g, const OfArgs& o,
                             const OcScratch& S, cudaStream_t st) {
  const size_t pbytes = am_proj_smem(G);
  cudaError_t err = allow_smem(am_proj_kernel<DP, false>, pbytes);
  if (err != cudaSuccess) return err;
  am_proj_kernel<DP, false><<<S.proj_blocks, 256, pbytes, st>>>(a, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  oc_gather_kernel<DP><<<(int)(g.units * g.KT), 256, 0, st>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t bytes = (size_t)(2 * o.KT + 2) * AM_TOK * DP * 2;
  err = allow_smem(of_fwd_kernel<DP, bf16>, bytes);
  if (err != cudaSuccess) return err;
  of_fwd_kernel<DP, bf16><<<(int)(o.units * ((o.QT + 1) / 2)), 256, bytes, st>>>(o);
  return cudaGetLastError();
}

// packed: the blob of pack_ocab_block; relbias (heads, ws^2, owin^2) bf16;
// LayerNorm weights and biases, bqkv (3C), bproj, b1 and b2 f32.
extern "C" int ocab_mma_bf16(const void* x, void* out, int B, int H, int W, int C, int heads, int ws, int pad,
                             int hidden, const void* ln1_w, const void* ln1_b, const void* bqkv, const void* bproj,
                             const void* relbias, const void* ln2_w, const void* ln2_b, const void* b1,
                             const void* b2, const void* packed, long long pack_elems, void* tscratch,
                             long long t_elems, void* stream) {
  if (!oc_geometry_ok(B, H, W, C, heads, ws, pad, hidden)) return (int)cudaErrorInvalidValue;
  const AmGeom G(C, heads, ws);
  const MfGeom M(C, hidden);
  int sms = 0;
  cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const OcScratch S = oc_scratch(B, H, W, C, heads, ws, pad, sms);
  const long long wpack = G.fwd_pack_elems();
  if (S.t_elems != t_elems || wpack + M.pack_elems() != pack_elems || !packed) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 8 || (uintptr_t)out % 8 || (uintptr_t)tscratch % 16 || (uintptr_t)packed % 16)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  bf16* t = (bf16*)tscratch;
  const int owin = ws + 2 * pad;
  AmArgs a{};
  a.x = (const bf16*)x, a.dx = t + S.y;
  a.ln_w = (const float*)ln1_w, a.ln_b = (const float*)ln1_b, a.bqkv = (const float*)bqkv;
  a.bproj = (const float*)bproj;
  a.w = (const bf16*)packed;
  a.img = t + S.proj, a.ln = t + S.ln;
  a.H = H, a.W = W, a.shift = 0, a.nwx = W / ws, a.nwi = (H / ws) * (W / ws);
  a.windows = S.windows, a.tiles = S.tiles;
  OcArgs g{};
  g.proj = t + S.proj, g.kv = t + S.kv, g.units = (long long)S.windows * heads;
  g.heads = heads, g.ws = ws, g.pad = pad, g.owin = owin, g.nk = owin * owin, g.N = G.N, g.KT = S.KT;
  g.H = H, g.W = W, g.nwx = a.nwx, g.nwi = a.nwi;
  OfArgs o{};
  o.out = t + S.att;
  o.st[OF_O][0] = (long long)G.N * G.HD, o.st[OF_O][1] = G.DP, o.st[OF_O][2] = G.HD;
  o.bias = relbias;
  o.img = t + S.kv, o.units = g.units, o.unit_elems = 2LL * S.KT * AM_TOK * G.DP, o.kv0 = 0;
  o.qimg = t + S.proj, o.q_unit = 3LL * G.N * G.DP;
  // d = DP: each head's padding columns go out too (zero: v's padding is)
  o.heads = heads, o.nq = G.N, o.nk = owin * owin, o.d = G.DP, o.QT = G.NCH, o.KT = S.KT, o.pairs = 1;
  o.vec = (uintptr_t)relbias % 16 == 0 && o.nk % 8 == 0;
  am_ln_kernel<false, false><<<S.row_blocks, 256, 0, st>>>(a, G, S.rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = G.DP == 32 ? oc_launch<32>(a, G, g, o, S, st) : oc_launch<16>(a, G, g, o, S, st);
  if (err != cudaSuccess) return (int)err;
  err = am_rowgemm(AmRowGemm{t + S.att, a.w + G.qkv_elems(), G.HD, G.HD, S.tiles}, C, WaOut<false>{a, G},
                   S.proj_blocks, st);
  if (err != cudaSuccess) return (int)err;
  return mf_run<false>(t + S.y, nullptr, out, (int)S.rows, C, hidden, ln2_w, ln2_b, nullptr, b1, nullptr, b2, nullptr,
                       0, nullptr, nullptr, a.w + wpack, M.pack_elems(), nullptr, stream);
}
