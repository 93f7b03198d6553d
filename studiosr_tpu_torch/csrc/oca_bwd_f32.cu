// B13 in f32, written for the H100: the backward of the core of HAT's
// overlapping cross-attention,
//   out = softmax(q k^T + bias) v,
// on q (bw, heads, nq, d), already scaled by 1/sqrt(d), k and v (bw, heads,
// nk, d), the f32 bias (heads, nq, nk) and the cotangent g of out: dq, dk,
// dv in f32 and d bias summed over the bw windows in f32.
//
// Replaces studiosr_tpu/ops/pallas/oca_core.py::oca_core_bwd (:157, kernel
// _bwd_kernel at :73) in f32, the dtype of HAT's f32 training step
// (Trainer(bfloat16=False)) and of its gradient checks. bf16 runs
// oca_bwd_mma.cu; head dims above 32 and more than 256 queries or 576 keys
// (HAT's windows from 17) keep oca_core.cu in f32. The contract is the
// TPU kernel's with T = f32: the softmax max-subtracted in f32, every
// product accumulated in f32, p and dscores = p (dp - D) kept in f32, d bias
// the sum of the f32 dscores; every sum across blocks in a fixed order (no
// atomics: the same bits from run to run).
//
// Bound on the card at HAT's f32 step (bw 512 = batch 32 x 16 windows, 6
// heads, nq 256, nk 576, d 30): 10 bw heads nq nk d = 135.9 GFLOP, 0.824 ms
// at 3xTF32 (164.9 TFLOP/s); its f32 operands and results (about 1.14 GB)
// move in 0.34 ms. oca_core.cu ran attn_core.cuh's row pass (two sweeps:
// the row statistics, then dq) and its column pass on the FMA pipes, staging
// the OCAB's 120-byte rows (a 720-byte token stride) in 4-byte pieces, so it
// formed every score three times. Here every product is 3xTF32 on
// mma.sync.m16n8k8 (tf32x3.cuh: each operand split hi / lo with cvt.rna
// once, where its fragment is loaded; the small terms first; a fresh
// accumulator for each 32-row stage of the K dimension, added to the running
// f32 sum), and each score tile is formed twice. The splits bounded the
// first form of this kernel (cvt.rna issues at a fraction of the FMA
// pipes' rate and every warp split every fragment it loaded), so an operand
// that several warps read (k and v by all eight, q and g by
// four in dk / dv) is split once into hi and lo images in shared memory,
// and only the values formed in registers (p, dscores) are split where
// their fragments are loaded. Six passes:
// 0. o32_pack_kernel: q, g, k and v, strided views read in place, into
//    16-byte-aligned f32 rows of DP (16 or 32) values, zero past d, per
//    (window, head): q and g padded to whole 128-row slabs, k and v to whole
//    64-key chunks, the padding zero. Every later read is a 16-byte cp.async.
//    o32_bias_frag_kernel: the bias in the main pass's fragment order.
// 1. o32_stats_kernel, a block of eight warps a (window, head, slab of 128
//    queries), each warp 16 query rows whose q and g fragments stay split in
//    registers: sweep 1 over the key chunks (a ring of four cp.async stages
//    of k and v, each chunk split once into hi / lo images), the scores and
//    dprobs = g v^T, the bias added, keys past nk masked; the online row max
//    m, sum l and u = sum p dp. Out: (m, 1 / l, D = u / l) a query row.
// 2. o32_main_kernel, a block of eight warps a (head, key chunk of 64, group
//    of windows), one block an SM: for each window of the group and each of
//    its slabs (the next slab's q and g copied in meanwhile; this slab's and
//    the chunk's k and v split once into hi / lo images), each warp forms
//    the scores and dprobs of its 16 rows again, p and dscores in
//    registers, adds dscores to its d-bias slice (registers, across the
//    group's windows), computes the chunk's partial of dq = dscores k with p
//    and dscores as A fragments straight from the score fragments (the key
//    order inside each 8-key step permuted, as attn_bwd_f32.cu's
//    ab32_attn_kernel does), and writes p^T and dscores^T to shared memory;
//    then warps 0-3 accumulate dk = dscores^T q and warps 4-7 dv = p^T g for
//    16 keys each over the slab's queries, so the chunk's dk and dv come out
//    whole after the window's last slab. Shared memory: 218,112 bytes at nq
//    256, d 30.
// 3. o32_dq_kernel: dq, the key chunks' partials summed in chunk order.
// 4. reduce_parts: d bias, the groups' partials summed in group order.
#include "tf32x3.cuh"

constexpr int O32_MAX_NQ = 256, O32_MAX_NK = 576, O32_MAX_D = 32;
constexpr int O32_SLAB = 128;    // query rows a slab: eight warps of 16
constexpr int O32_TOK = 64;      // keys a chunk
constexpr int O32_THREADS = 256;
constexpr int O32_STAGES = 4;    // the statistics pass: key chunks in flight
constexpr int O32_MAX_KT = O32_MAX_NK / O32_TOK;

// Strides, in elements, of the eight tensors, (window, head, token) each:
// q, k, v, g, out (unused), dq, dk, dv (the order of oca_core.cu's OC_*).
enum { O32_Q, O32_K, O32_V, O32_G, O32_O, O32_DQ, O32_DK, O32_DV, O32_N };

struct O32Args {
  const float *q, *k, *v, *g, *bias;
  float *dq, *dk, *dv;
  long long st[O32_N][3];
  float *img, *stats, *dqp, *dbp;
  long long units, unit_elems;  // a unit's image: q, g (QR rows each), k, v (KT chunks of 64 rows each), DP a row
  int bw, heads, nq, nk, d, QR, SL, KT, groups;
  int pairs;  // dq, dk, dv take 8-byte stores
};

// -- pass 0: the padded rows -------------------------------------------------------------

// One thread a 16-byte piece (4 d values of a token) of every unit's image.
template <int DP>
__global__ void __launch_bounds__(256) o32_pack_kernel(const O32Args a) {
  constexpr int JG = DP / 4;
  const int KR = a.KT * O32_TOK, rows = 2 * a.QR + 2 * KR;
  const long long per_unit = (long long)rows * JG, total = a.units * per_unit;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < total;
       p += (long long)gridDim.x * blockDim.x) {
    const long long u = p / per_unit;
    const int r = (int)(p - u * per_unit), row = r / JG, jg = r % JG;
    const int w = (int)(u / a.heads), h = (int)(u % a.heads);
    int which, token, n;
    if (row < a.QR) which = O32_Q, token = row, n = a.nq;
    else if (row < 2 * a.QR) which = O32_G, token = row - a.QR, n = a.nq;
    else if (row < 2 * a.QR + KR) which = O32_K, token = row - 2 * a.QR, n = a.nk;
    else which = O32_V, token = row - 2 * a.QR - KR, n = a.nk;
    float vals[4] = {0.f, 0.f, 0.f, 0.f};
    if (token < n) {
      const float* base = which == O32_Q ? a.q : which == O32_G ? a.g : which == O32_K ? a.k : a.v;
      const float* src = base + w * a.st[which][0] + h * a.st[which][1] + token * a.st[which][2];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * jg + e < a.d) vals[e] = __ldg(src + 4 * jg + e);
    }
    *reinterpret_cast<float4*>(a.img + u * a.unit_elems + (long long)row * DP + 4 * jg) =
        make_float4(vals[0], vals[1], vals[2], vals[3]);
  }
}

// -- the pieces both sweeps share ----------------------------------------------------------

// The bias of a thread's score fragment (rows r, r + 8; columns col, col +
// 1; col even), zero outside (nq, nk): two 8-byte loads when nk is even.
__device__ __forceinline__ float4 o32_bias4(const O32Args& a, int h, int r, int col) {
  const float* b = a.bias + (size_t)h * a.nq * a.nk;
  float v[4];
  if ((a.nk & 1) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r + 8 * hh;
      const float2 f = row < a.nq && col < a.nk ? __ldg(reinterpret_cast<const float2*>(b + (size_t)row * a.nk + col))
                                                : make_float2(0.f, 0.f);
      v[2 * hh] = f.x, v[2 * hh + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e >> 1), c = col + (e & 1);
      v[e] = row < a.nq && c < a.nk ? __ldg(b + (size_t)row * a.nk + c) : 0.f;
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// hi and lo (TF32 bit patterns) of rows x DP f32 values at src (rows LD
// apart), to the same places of hi and lo; src may be hi (split in place).
// Each value is split once here, and every fragment that reads it later
// loads its two halves.
template <int DP, int LD>
__device__ __forceinline__ void o32_split_rows(const float* src, uint32_t* hi, uint32_t* lo, int rows) {
  for (int i = threadIdx.x; i < rows * (DP / 4); i += O32_THREADS) {
    const int at = (i / (DP / 4)) * LD + 4 * (i % (DP / 4));
    const float4 x = *reinterpret_cast<const float4*>(src + at);
    uint4 h, l;
    tf_split(x.x, h.x, l.x);
    tf_split(x.y, h.y, l.y);
    tf_split(x.z, h.z, l.z);
    tf_split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

// The A fragment of rows r, r + 8 (LD apart), columns 8 ks + t, + 4, split.
__device__ __forceinline__ void o32_afrag(const float* rows, int LD, int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* r = rows + g * LD + 8 * ks + t;
  const float v[4] = {r[0], r[8 * LD], r[4], r[8 * LD + 4]};
  tf_split4(v, hi, lo);
}

// The same fragment from split images.
__device__ __forceinline__ void o32_afrag_split(const uint32_t* hrows, const uint32_t* lrows, int LD, int ks,
                                                uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, at = (lane >> 2) * LD + 8 * ks + (lane & 3);
  hi[0] = hrows[at], hi[1] = hrows[at + 8 * LD], hi[2] = hrows[at + 4], hi[3] = hrows[at + 8 * LD + 4];
  lo[0] = lrows[at], lo[1] = lrows[at + 8 * LD], lo[2] = lrows[at + 4], lo[3] = lrows[at + 8 * LD + 4];
}

// The scores s = q k^T and dprobs dp = g v^T of a warp's 16 rows against a
// 64-key chunk (split images of k and v, 64 rows LD apart), q and g split
// in (qh, ql), (gh, gl) for each 8-column step ks. DP <= 32: the K dimension
// is one 32-row stage, one accumulator.
template <int KS, int LD, typename QF>
__device__ __forceinline__ void o32_scores(float (&s)[8][4], float (&dp)[8][4], QF qfrag, const uint32_t* Kh,
                                           const uint32_t* Kl, const uint32_t* Vh, const uint32_t* Vl) {
  static_assert(KS <= 4, "one 32-row stage");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f, dp[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t qh[4], ql[4], gh[4], gl[4];
    qfrag(ks, qh, ql, gh, gl);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int at = (8 * nt + g) * LD + 8 * ks + t;
      const uint32_t kh[2] = {Kh[at], Kh[at + 4]}, kl[2] = {Kl[at], Kl[at + 4]};
      const uint32_t vh[2] = {Vh[at], Vh[at + 4]}, vl[2] = {Vl[at], Vl[at + 4]};
      tf_mma3x2(s[nt], qh, ql, kh, kl, dp[nt], gh, gl, vh, vl);
    }
  }
}

// -- pass 1: the row statistics ----------------------------------------------------------

// A block of eight warps a (unit, slab): warp w the slab's rows 16 w ..
// 16 w + 15 (past nq: zero rows, statistics stored and never read). k and
// v come through O32_STAGES f32 chunk stages (64 x (DP + 4) each, k then
// v); each chunk is split once into hi and lo images of k and v (two sets,
// chunk c in set c & 1), which every warp reads: while the warps form chunk
// c's scores from one set they split chunk c + 1 into the other, so one
// barrier a chunk serves both.
template <int DP>
__host__ __device__ inline size_t o32_stats_smem() {
  return ((size_t)O32_STAGES * 2 + 8) * O32_TOK * (DP + 4) * 4;
}

template <int DP>
__global__ void __launch_bounds__(O32_THREADS, 1) o32_stats_kernel(const O32Args a) {
  constexpr int LD = DP + 4, KS = DP / 8, CH = O32_TOK * LD, PIECES = 2 * O32_TOK * (DP / 4);
  extern __shared__ __align__(16) float o32_sm[];
  uint32_t* splits = reinterpret_cast<uint32_t*>(o32_sm + O32_STAGES * 2 * CH);  // two sets of k hi, k lo, v hi, v lo
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long u = blockIdx.x / a.SL;
  const int sl = blockIdx.x % a.SL, h = (int)(u % a.heads), KT = a.KT;
  const float* img = a.img + u * a.unit_elems;
  const int r0 = sl * O32_SLAB + 16 * warp;  // the warp's first row
  uint32_t qh[KS][4], ql[KS][4], gh[KS][4], gl[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    o32_afrag(img + (size_t)r0 * DP, DP, ks, qh[ks], ql[ks]);
    o32_afrag(img + (size_t)(a.QR + r0) * DP, DP, ks, gh[ks], gl[ks]);
  }
  const float* kimg = img + (size_t)2 * a.QR * DP;
  const float* vimg = kimg + (size_t)KT * O32_TOK * DP;
  // chunk c's k and v into stage c % O32_STAGES, one cp.async group (empty past the last)
  auto load = [&](int c) {
    if (c < KT) {
      float* stage = o32_sm + (c % O32_STAGES) * 2 * CH;
      for (int i = tid; i < PIECES; i += O32_THREADS) {
        const int which = i / (PIECES / 2), rem = i % (PIECES / 2), r = rem / (DP / 4), c4 = rem % (DP / 4);
        hm_cp_async<16>(stage + which * CH + r * LD + 4 * c4,
                        (which ? vimg : kimg) + ((size_t)c * O32_TOK + r) * DP + 4 * c4, true);
      }
    }
    hm_cp_commit();
  };
  // chunk c's f32 stage into split set c & 1
  auto split_chunk = [&](int c) {
    const float* stage = o32_sm + (c % O32_STAGES) * 2 * CH;
    uint32_t* set = splits + (c & 1) * 4 * CH;
    o32_split_rows<DP, LD>(stage, set, set + CH, O32_TOK);
    o32_split_rows<DP, LD>(stage + CH, set + 2 * CH, set + 3 * CH, O32_TOK);
  };
  static_assert(O32_STAGES >= 3, "chunk c + 1 in flight while chunk c is formed");
#pragma unroll
  for (int j = 0; j < O32_STAGES - 1; ++j) load(j);
  hm_cp_wait_upto(O32_STAGES - 2);
  __syncthreads();  // chunk 0 is in
  split_chunk(0);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, us[2] = {0.f, 0.f};
#pragma unroll 1
  for (int c = 0; c < KT; ++c) {
    hm_cp_wait_upto(O32_STAGES - 3);
    __syncthreads();  // chunk c's split set and chunk c + 1 are in; every warp is done with chunk c - 1
    load(c + O32_STAGES - 1);  // into chunk c - 1's stage, split two chunks ago
    float4 bb[8];  // loaded before the products, so their latency hides under them
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) bb[nt] = o32_bias4(a, h, r0 + g, c * O32_TOK + nt * 8 + 2 * t);
    if (c + 1 < KT) split_chunk(c + 1);  // into the set chunk c - 1 used
    const uint32_t* split = splits + (c & 1) * 4 * CH;
    float s[8][4], dp[8][4];
    o32_scores<KS, LD>(
        s, dp,
        [&](int ks, uint32_t (&a0)[4], uint32_t (&a1)[4], uint32_t (&b0)[4], uint32_t (&b1)[4]) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a0[i] = qh[ks][i], a1[i] = ql[ks][i], b0[i] = gh[ks][i], b1[i] = gl[ks][i];
        },
        split, split + CH, split + 2 * CH, split + 3 * CH);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = c * O32_TOK + nt * 8 + 2 * t;
      s[nt][0] = col < a.nk ? s[nt][0] + bb[nt].x : -INFINITY;
      s[nt][1] = col + 1 < a.nk ? s[nt][1] + bb[nt].y : -INFINITY;
      s[nt][2] = col < a.nk ? s[nt][2] + bb[nt].z : -INFINITY;
      s[nt][3] = col + 1 < a.nk ? s[nt][3] + bb[nt].w : -INFINITY;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      const float mn = fmaxf(m[hh], am_quad_max(mx) * AM_LOG2E), sc = am_exp2(m[hh] - mn);
      l[hh] *= sc, us[hh] *= sc, m[hh] = mn;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = am_exp2(fmaf(s[nt][2 * hh + e], AM_LOG2E, -mn));
          l[hh] += p, us[hh] += p * dp[nt][2 * hh + e];
        }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = am_quad_sum(l[hh]), us[hh] = am_quad_sum(us[hh]);
    if (t == 0) {
      float* st = a.stats + (u * a.QR + r0 + g + 8 * hh) * 3;
      st[0] = m[hh], st[1] = 1.f / l[hh], st[2] = us[hh] / l[hh];
    }
  }
}

// -- pass 2: p, dscores and the sums -------------------------------------------------------

// The bias in fragment order (bias4's values, zero outside (nq, nk)): float4
// ((h KT + c) SL 8 + slab 8 + warp) 256 + 32 nt + lane is the score
// fragment of that lane's rows (slab 128 + 16 warp + g, + 8) and columns
// (c 64 + 8 nt + 2t, + 1). One pass, so that the main pass reads a step's
// bias as eight coalesced 16-byte loads a thread.
__global__ void o32_bias_frag_kernel(const O32Args a, float4* __restrict__ out) {
  const long long n = (long long)a.heads * a.KT * a.SL * 8 * 256;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n; e += (long long)gridDim.x * blockDim.x) {
    const int ln = (int)(e & 31), nt = (int)((e >> 5) & 7), wr = (int)((e >> 8) & 7);
    const long long r = e >> 11;  // (h KT + c) SL + slab
    const int sl = (int)(r % a.SL), c = (int)(r / a.SL % a.KT), h = (int)(r / a.SL / a.KT);
    out[e] = o32_bias4(a, h, sl * O32_SLAB + 16 * wr + (ln >> 2), c * O32_TOK + 8 * nt + 2 * (ln & 3));
  }
}

// Shared memory of the main pass, in 4-byte words: the next step's q and g
// in f32 (a slab, 128 x LD each, copied in while this step runs), this
// step's q and g split (hi and lo images of each), the chunk's k and v split
// (hi, lo, hi, lo: the hi images take the next window's f32 rows by
// cp.async and are split in place), p^T and dscores^T of a slab (64 keys x
// LDP), the window's row statistics (SL 128 x 3).
constexpr int O32_LDP = O32_SLAB + 4;  // conflict-free writes (8 t + the query's place) and A reads (4 g + t)

struct O32Smem {
  size_t stage, qg, kv, pt, sd, stat, total;
};

__host__ __device__ inline O32Smem o32_main_smem(int SL, int DP) {
  const int LD = DP + 4;
  O32Smem L;
  size_t o = 0;
  L.stage = o, o += (size_t)2 * O32_SLAB * LD;
  L.qg = o, o += (size_t)4 * O32_SLAB * LD;
  L.kv = o, o += (size_t)4 * O32_TOK * LD;
  L.pt = o, o += (size_t)O32_TOK * O32_LDP;
  L.sd = o, o += (size_t)O32_TOK * O32_LDP;
  L.stat = o, o += (size_t)SL * O32_SLAB * 3;
  L.total = o * 4;
  return L;
}

// Stores two f32 values of a row (columns j, j + 1; j even) to a strided
// view, columns below d.
__device__ __forceinline__ void o32_store2(float* dst, int j, int d, float x, float y, bool pairs) {
  if (j >= d) return;
  if (pairs) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  } else {
    dst[0] = x;
    if (j + 1 < d) dst[1] = y;
  }
}

// A block owns (group gi, head h, key chunk c): blocks (gi, h, 0 .. KT - 1)
// are neighbours, so a window's q and g serve its chunks' blocks from L2. It
// walks the windows gi, gi + groups, ..., each a slab at a time (a step): at
// a step's start its q and g (copied in during the last step) are split,
// and at a window's first step its k and v (copied in once the last
// window's scores were formed); then the next step's q and g are copied in
// while this one runs. Warp w: query rows 16 w .. 16 w + 15 of each slab in
// the score phase, then keys 16 (w & 3) .. of the chunk for dk (w < 4) or
// dv (w >= 4).
template <int DP, int SL>
__global__ void __launch_bounds__(O32_THREADS, 1) o32_main_kernel(const O32Args a, const float4* __restrict__ bfrag) {
  constexpr int LD = DP + 4, KS = DP / 8, NDT = DP / 8, SLAB_F = O32_SLAB * LD, CH = O32_TOK * LD, LDP = O32_LDP;
  extern __shared__ __align__(16) float o32_sm[];
  const O32Smem L = o32_main_smem(SL, DP);
  float* stage = o32_sm + L.stage;
  uint32_t* qg = reinterpret_cast<uint32_t*>(o32_sm + L.qg);  // q hi, q lo, g hi, g lo
  uint32_t* kv = reinterpret_cast<uint32_t*>(o32_sm + L.kv);  // k hi, k lo, v hi, v lo
  float *PT = o32_sm + L.pt, *ST = o32_sm + L.sd, *stat = o32_sm + L.stat;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int KT = a.KT, c = blockIdx.x % KT, h = (blockIdx.x / KT) % a.heads, gi = blockIdx.x / (KT * a.heads);
  const int pos = (g & 1) ? (g >> 1) + 4 : g >> 1;  // the permuted place of query 16 w + g (+ 8) in its 8-query step
  auto unit_img = [&](int w) { return a.img + ((long long)w * a.heads + h) * a.unit_elems; };
  // slab sl of window w's q and g into the stage (the caller commits)
  auto load_qg = [&](int w, int sl) {
    const float* img = unit_img(w);
    constexpr int PER = O32_SLAB * (DP / 4);
    for (int i = tid; i < 2 * PER; i += O32_THREADS) {
      const int which = i / PER, r = (i % PER) / (DP / 4), c4 = i % (DP / 4);
      hm_cp_async<16>(stage + which * SLAB_F + r * LD + 4 * c4,
                      img + ((size_t)which * a.QR + sl * O32_SLAB + r) * DP + 4 * c4, true);
    }
  };
  // window w's chunk of k and v (f32, into the hi images) and its row statistics (the caller commits)
  auto load_kv = [&](int w) {
    const float* img = unit_img(w) + (size_t)2 * a.QR * DP;
    constexpr int PER = O32_TOK * (DP / 4);
    for (int i = tid; i < 2 * PER; i += O32_THREADS) {
      const int which = i / PER, r = (i % PER) / (DP / 4), c4 = i % (DP / 4);
      hm_cp_async<16>(kv + 2 * which * CH + r * LD + 4 * c4,
                      img + ((size_t)which * KT * O32_TOK + c * O32_TOK + r) * DP + 4 * c4, true);
    }
    const float* sts = a.stats + ((long long)w * a.heads + h) * a.QR * 3;
    for (int i = tid; i < a.QR * 3 / 4; i += O32_THREADS) hm_cp_async<16>(stat + 4 * i, sts + 4 * i, true);
  };
  const int windows = (a.bw - gi + a.groups - 1) / a.groups, steps = windows * SL;
  load_qg(gi, 0);
  load_kv(gi);
  hm_cp_commit();
  float db[SL][8][4];  // d bias of the warp's rows of each slab x the chunk's keys, over the group's windows
#pragma unroll
  for (int sl = 0; sl < SL; ++sl)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) db[sl][nt][e] = 0.f;
  const int kind = warp >> 2, kt = warp & 3;  // kind 0: dk, 1: dv, of keys 16 kt .. 16 kt + 15
  float acc[NDT][4];
#pragma unroll 1
  for (int wi = 0; wi < windows; ++wi)
#pragma unroll
  for (int sl = 0; sl < SL; ++sl) {  // sl a constant, so db[sl] stays in registers
    const int it = wi * SL + sl, w = gi + a.groups * wi;
    const long long u = (long long)w * a.heads + h;
    hm_cp_wait_upto(0);
    __syncthreads();  // step it's rows are in; step it - 1's products are done
    o32_split_rows<DP, LD>(stage, qg, qg + SLAB_F, O32_SLAB);
    o32_split_rows<DP, LD>(stage + SLAB_F, qg + 2 * SLAB_F, qg + 3 * SLAB_F, O32_SLAB);
    if (sl == 0) {
      o32_split_rows<DP, LD>(reinterpret_cast<const float*>(kv), kv, kv + CH, O32_TOK);
      o32_split_rows<DP, LD>(reinterpret_cast<const float*>(kv + 2 * CH), kv + 2 * CH, kv + 3 * CH, O32_TOK);
    }
    __syncthreads();  // the split images are in; the stage is free
    if (it + 1 < steps) load_qg(gi + a.groups * ((it + 1) / SL), (it + 1) % SL);
    hm_cp_commit();
    {
      const float4* bf = bfrag + ((((long long)h * KT + c) * SL + sl) * 8 + warp) * 256 + lane;
      float4 bb[8];  // loaded before the products, so their latency hides under them
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) bb[nt] = __ldg(bf + 32 * nt);
      // the scores and dprobs of the warp's 16 rows, again
      float s[8][4], dp[8][4];
      const uint32_t* qrow = qg + 16 * warp * LD;
      o32_scores<KS, LD>(
          s, dp,
          [&](int ks, uint32_t (&a0)[4], uint32_t (&a1)[4], uint32_t (&b0)[4], uint32_t (&b1)[4]) {
            o32_afrag_split(qrow, qrow + SLAB_F, LD, ks, a0, a1);
            o32_afrag_split(qrow + 2 * SLAB_F, qrow + 3 * SLAB_F, LD, ks, b0, b1);
          },
          kv, kv + CH, kv + 2 * CH, kv + 3 * CH);
      // p and dscores from the statistics; d bias
      float m[2], linv[2], D[2];
      bool rin[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = sl * O32_SLAB + 16 * warp + g + 8 * hh;
        m[hh] = stat[row * 3], linv[hh] = stat[row * 3 + 1], D[hh] = stat[row * 3 + 2];
        rin[hh] = row < a.nq;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float b4[4] = {bb[nt].x, bb[nt].y, bb[nt].z, bb[nt].w};
        const int col = c * O32_TOK + nt * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = rin[e >> 1] && col + (e & 1) < a.nk;
          const float p = in ? am_exp2(fmaf(s[nt][e] + b4[e], AM_LOG2E, -m[e >> 1])) * linv[e >> 1] : 0.f;
          const float ds = p * (dp[nt][e] - D[e >> 1]);
          s[nt][e] = p, dp[nt][e] = ds;
          db[sl][nt][e] += ds;
        }
      }
      // the chunk's partial of dq = dscores k: key 8 kb + 2t + e of the score
      // fragment is A column t + 4 e of step kb, and k's rows are read in that
      // order; a fresh accumulator for each 32 keys
      float dq[NDT][4];
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float part[NDT][4];
#pragma unroll
        for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[nd][e] = 0.f;
#pragma unroll
        for (int kb = 4 * half; kb < 4 * half + 4; ++kb) {
          uint32_t sh[4], sl4[4];
          const float sv[4] = {dp[kb][0], dp[kb][2], dp[kb][1], dp[kb][3]};
          tf_split4(sv, sh, sl4);
#pragma unroll
          for (int nd = 0; nd < NDT; nd += 2) {
            const int at = (8 * kb + 2 * t) * LD + 8 * nd + g;
            const uint32_t k0h[2] = {kv[at], kv[at + LD]}, k0l[2] = {kv[CH + at], kv[CH + at + LD]};
            const uint32_t k1h[2] = {kv[at + 8], kv[at + LD + 8]}, k1l[2] = {kv[CH + at + 8], kv[CH + at + LD + 8]};
            tf_mma3x2(part[nd], sh, sl4, k0h, k0l, part[nd + 1], sh, sl4, k1h, k1l);
          }
        }
#pragma unroll
        for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[nd][e] += part[nd][e];
      }
      float4* dst = reinterpret_cast<float4*>(a.dqp) + (((u * KT + c) * SL + sl) * 8 + warp) * NDT * 32 + lane;
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd) dst[nd * 32] = make_float4(dq[nd][0], dq[nd][1], dq[nd][2], dq[nd][3]);
      // p^T and dscores^T: key k's row, query q of the slab at 8 (q / 8) + its permuted place
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * nt + 2 * t + (e & 1), qp = 16 * warp + 8 * (e >> 1) + pos;
          PT[key * LDP + qp] = s[nt][e];
          ST[key * LDP + qp] = dp[nt][e];
        }
    }
    __syncthreads();  // p^T and dscores^T are in; k, v and the statistics are read no more this window
    if (sl == SL - 1 && it + 1 < steps) load_kv(w + a.groups);
    hm_cp_commit();
    // dk = dscores^T q (warps 0-3) or dv = p^T g (warps 4-7) of keys 16 kt ..,
    // over the slab's queries: query 8 qb + 2t + e is A column t + 4 e of step
    // qb; a fresh accumulator for each 32 queries
    if (sl == 0) {
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
    }
    {
      const float* A = (kind ? PT : ST) + 16 * kt * LDP;
      const uint32_t* Bh = qg + 2 * kind * SLAB_F;
      const uint32_t* Bl = Bh + SLAB_F;
#pragma unroll 1
      for (int st = 0; st < O32_SLAB / 32; ++st) {
        float part[NDT][4];
#pragma unroll
        for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[nd][e] = 0.f;
#pragma unroll
        for (int qb = 4 * st; qb < 4 * st + 4; ++qb) {
          uint32_t ah[4], al[4];
          o32_afrag(A, LDP, qb, ah, al);
#pragma unroll
          for (int nd = 0; nd < NDT; nd += 2) {
            const int at = (8 * qb + 2 * t) * LD + 8 * nd + g;
            const uint32_t b0h[2] = {Bh[at], Bh[at + LD]}, b0l[2] = {Bl[at], Bl[at + LD]};
            const uint32_t b1h[2] = {Bh[at + 8], Bh[at + LD + 8]}, b1l[2] = {Bl[at + 8], Bl[at + LD + 8]};
            tf_mma3x2(part[nd], ah, al, b0h, b0l, part[nd + 1], ah, al, b1h, b1l);
          }
        }
#pragma unroll
        for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nd][e] += part[nd][e];
      }
    }
    if (sl == SL - 1) {
      const int which = kind ? O32_DV : O32_DK;
      float* out = (kind ? a.dv : a.dk) + (long long)w * a.st[which][0] + (long long)h * a.st[which][1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int key = c * O32_TOK + 16 * kt + g + 8 * hh;
        if (key >= a.nk) continue;
#pragma unroll
        for (int nd = 0; nd < NDT; ++nd) {
          const int j = 8 * nd + 2 * t;
          o32_store2(out + (long long)key * a.st[which][2] + j, j, a.d, acc[nd][2 * hh], acc[nd][2 * hh + 1], a.pairs);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // the block's d bias, f32, to the group's partial (gi, h)
  float* dbp = a.dbp + ((size_t)gi * a.heads + h) * a.nq * a.nk;
#pragma unroll
  for (int sl = 0; sl < SL; ++sl)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = sl * O32_SLAB + 16 * warp + g + 8 * (e >> 1), col = c * O32_TOK + 8 * nt + 2 * t + (e & 1);
        if (row < a.nq && col < a.nk) dbp[(size_t)row * a.nk + col] = db[sl][nt][e];
      }
}

// -- pass 3: dq ------------------------------------------------------------------------

// A thread a float4 of a unit's fragment-ordered dq (slab, warp, 8-column
// tile, lane): the key chunks' partials summed in chunk order, to the dq view.
template <int DP>
__global__ void __launch_bounds__(256) o32_dq_kernel(const O32Args a) {
  constexpr int NDT = DP / 8;
  const int KT = a.KT, per = a.SL * 8 * NDT * 32;
  const long long total = a.units * per;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long u = e / per;
    const int r = (int)(e - u * per);
    const float4* part = reinterpret_cast<const float4*>(a.dqp) + u * KT * per + r;
    float4 v[O32_MAX_KT];
#pragma unroll
    for (int cc = 0; cc < O32_MAX_KT; ++cc)
      v[cc] = cc < KT ? part[(long long)cc * per] : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 sum = v[0];
#pragma unroll
    for (int cc = 1; cc < O32_MAX_KT; ++cc)
      if (cc < KT) sum.x += v[cc].x, sum.y += v[cc].y, sum.z += v[cc].z, sum.w += v[cc].w;
    const int lane = r & 31, nd = (r >> 5) % NDT, wr = (r / (32 * NDT)) & 7, sl = r / (256 * NDT);
    const int row = sl * O32_SLAB + 16 * wr + (lane >> 2), j = 8 * nd + 2 * (lane & 3);
    float* out = a.dq + (u / a.heads) * a.st[O32_DQ][0] + (u % a.heads) * a.st[O32_DQ][1];
    if (row < a.nq) o32_store2(out + (long long)row * a.st[O32_DQ][2] + j, j, a.d, sum.x, sum.y, a.pairs);
    if (row + 8 < a.nq) o32_store2(out + (long long)(row + 8) * a.st[O32_DQ][2] + j, j, a.d, sum.z, sum.w, a.pairs);
  }
}

// -- host ------------------------------------------------------------------------------

static bool o32_shape_ok(int bw, int heads, int nq, int nk, int d) {
  return bw > 0 && heads > 0 && nq > 0 && nk > 0 && d > 0 && d <= O32_MAX_D && nq <= O32_MAX_NQ && nk <= O32_MAX_NK;
}

// The f32 scratch, each region 16-byte aligned: the images (units x (2 QR +
// 2 KT 64) rows of DP), the row statistics (3 a padded query row), dq's
// chunk partials (units x KT x QR x DP), the groups' d bias partials
// (groups x heads x nq x nk), the bias in fragment order (heads x KT x QR x
// 64).
struct O32Scratch {
  long long units, unit_elems, stats, dqp, dbp, bfrag, f_elems;
  int QR, SL, KT, DP, groups;
};

// The window groups: the count, up to 64 and to bw, that makes the main
// pass's waves (one block an SM) take the fewest window steps.
static int o32_groups(int bw, int heads, int KT, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int G = 1; G <= bw && G <= 64; ++G) {
    const long long blocks = (long long)G * heads * KT, waves = (blocks + sms - 1) / sms;
    const long long cost = waves * ((bw + G - 1) / G);
    if (best_cost < 0 || cost < best_cost) best = G, best_cost = cost;
  }
  return best;
}

static O32Scratch o32_scratch(int bw, int heads, int nq, int nk, int d, int sms) {
  O32Scratch S;
  S.SL = (nq + O32_SLAB - 1) / O32_SLAB;
  S.QR = S.SL * O32_SLAB;
  S.KT = (nk + O32_TOK - 1) / O32_TOK;
  S.DP = d <= 16 ? 16 : 32;
  S.groups = o32_groups(bw, heads, S.KT, sms);
  S.units = (long long)bw * heads;
  S.unit_elems = (long long)(2 * S.QR + 2 * S.KT * O32_TOK) * S.DP;
  S.stats = S.units * S.unit_elems;
  S.dqp = S.stats + S.units * S.QR * 3;
  S.dbp = S.dqp + S.units * S.KT * S.QR * S.DP;
  S.bfrag = S.dbp + (((long long)S.groups * heads * nq * nk + 3) & ~3LL);
  S.f_elems = S.bfrag + (long long)heads * S.KT * S.QR * O32_TOK;
  return S;
}

extern "C" int oca_core_bwd_mma_f32_scratch(int bw, int heads, int nq, int nk, int d, long long* f_elems) {
  if (!o32_shape_ok(bw, heads, nq, nk, d)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  *f_elems = o32_scratch(bw, heads, nq, nk, d, sms).f_elems;
  return 0;
}

static int o32_blocks(long long n) { return (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192); }

template <int DP, int SL>
static cudaError_t o32_launch(const O32Args& a, const O32Scratch& S, float* f, float* dbias, cudaStream_t st) {
  o32_pack_kernel<DP><<<o32_blocks(S.units * (2 * S.QR + 2 * S.KT * O32_TOK) * (DP / 4)), 256, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float4* bfrag = reinterpret_cast<float4*>(f + S.bfrag);
  o32_bias_frag_kernel<<<o32_blocks((long long)a.heads * S.KT * S.QR * O32_TOK / 4), 256, 0, st>>>(a, bfrag);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t sbytes = o32_stats_smem<DP>();
  if ((err = allow_smem(o32_stats_kernel<DP>, sbytes)) != cudaSuccess) return err;
  o32_stats_kernel<DP><<<(int)(S.units * SL), O32_THREADS, sbytes, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t mbytes = o32_main_smem(SL, DP).total;
  if ((err = allow_smem(o32_main_kernel<DP, SL>, mbytes)) != cudaSuccess) return err;
  o32_main_kernel<DP, SL><<<S.groups * a.heads * S.KT, O32_THREADS, mbytes, st>>>(a, bfrag);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  o32_dq_kernel<DP><<<o32_blocks(S.units * SL * 8 * (DP / 8) * 32), 256, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_parts(a.dbp, S.groups, (long long)a.heads * a.nq * a.nk, dbias, st);
}

// strides: (window, head, token) of q, k, v, g, out (unused), dq, dk, dv,
// in elements; d contiguous in each. bias and dbias (heads, nq, nk) in f32.
extern "C" int oca_core_bwd_mma_f32(const void* q, const void* k, const void* v, const void* relbias, const void* g,
                                    void* dq, void* dk, void* dv, void* dbias, const long long* strides, int bw,
                                    int heads, int nq, int nk, int d, void* fscratch, long long f_elems,
                                    void* stream) {
  if (!o32_shape_ok(bw, heads, nq, nk, d)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const O32Scratch S = o32_scratch(bw, heads, nq, nk, d, sms);
  if (S.f_elems != f_elems) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)fscratch % 16) return (int)cudaErrorMisalignedAddress;
  O32Args a{};
  a.q = (const float*)q, a.k = (const float*)k, a.v = (const float*)v, a.g = (const float*)g;
  a.bias = (const float*)relbias;
  a.dq = (float*)dq, a.dk = (float*)dk, a.dv = (float*)dv;
  for (int i = 0; i < O32_N; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  float* f = (float*)fscratch;
  a.img = f, a.stats = f + S.stats, a.dqp = f + S.dqp, a.dbp = f + S.dbp;
  a.units = S.units, a.unit_elems = S.unit_elems;
  a.bw = bw, a.heads = heads, a.nq = nq, a.nk = nk, a.d = d, a.QR = S.QR, a.SL = S.SL, a.KT = S.KT;
  a.groups = S.groups;
  a.pairs = d % 2 == 0;
  const void* outs[3] = {dq, dk, dv};
  for (int i = 0; i < 3; ++i) {
    a.pairs = a.pairs && (uintptr_t)outs[i] % 8 == 0;
    for (int j = 0; j < 3; ++j) a.pairs = a.pairs && strides[3 * (O32_DQ + i) + j] % 2 == 0;
  }
  cudaStream_t st = (cudaStream_t)stream;
  float* db = (float*)dbias;
  if (S.DP == 32) return (int)(S.SL == 2 ? o32_launch<32, 2>(a, S, f, db, st) : o32_launch<32, 1>(a, S, f, db, st));
  return (int)(S.SL == 2 ? o32_launch<16, 2>(a, S, f, db, st) : o32_launch<16, 1>(a, S, f, db, st));
}
