// B12 in bf16, written for the H100: the forward of the core of HAT's
// overlapping cross-attention,
//   out = softmax(q k^T + bias) v,
// on q (bw, heads, nq, d), already scaled by 1/sqrt(d), k and v (bw, heads,
// nk, d) and the bias (heads, nq, nk), f32 or bf16 as the caller hands it.
//
// Replaces studiosr_tpu/ops/pallas/oca_core.py::oca_core_fwd (:117, kernel
// _fwd_kernel at :57) in bf16; f32, the checks' dtype, keeps oca_core.cu on
// attn_core.cuh, and so do head dims above 32. Two entries: up to 256
// queries and 576 keys (HAT's windows up to 16) oca_core_fwd_mma_bf16 holds
// a unit's k and v whole in shared memory; above, oca_core_fwd_large_mma_bf16
// (HAT's windows from 17: 576 x 1296 at window 24) runs the same pack, puts
// the bias in fragment order (of_bias_kernel), then runs lf_core.cuh's
// pipelined forward, a block a (unit, query tile). The
// contract is its: scores and the softmax in f32, p rounded to
// bf16 before its product with v, products accumulated in f32, the output
// rounded once. The softmax is taken online over 64-key chunks with the row
// max subtracted (a deliberate difference: ROADMAP.md C), so p is rounded
// before its division by the row sum, which follows the product.
//
// Bound on the card at HAT's training shapes (bw 512 = batch 32 x 16
// windows, 6 heads, nq 256, nk 576, d 30): 4 bw heads nq nk d = 54.4 GFLOP
// against 310 MB, so bytes (0.093 ms). oca_core.cu ran attn_core.cuh's row
// pass on mma.sync and staged the OCAB's 60-byte rows (a 360-byte token
// stride) in 4-byte cp.async pieces: 1.667 ms (NVIDIA H100 80GB HBM3, 700 W).
// Here, two passes, the precedent being B13's (oca_bwd_mma.cu):
// 0. of_pack_kernel: q, k and v, strided views read in place, into wgmma's
//    core-matrix images, per (window, head) 64-token tiles with d padded to
//    DP (32 at d 30) and tokens to whole tiles, the padding zero: q and k
//    K-major in d (the scores' A and B), v token-contiguous (K-major in the
//    keys: the B of p v), so no transpose is needed later and every later
//    read is a 16-byte cp.async. The keys of a chunk are stored permuted
//    (of_perm), k and v alike, so a thread's 16 score columns are 16
//    consecutive keys: its bias comes in 16-byte loads.
// 1. of_fwd_kernel, a block a (window, head, pair of query tiles), a
//    warpgroup a tile, two blocks an SM (80 KB of shared memory at nk 576):
//    the unit's k and v images and the pair's q tiles copied in, a cp.async
//    group a key chunk, so the first chunk's products start while the rest
//    arrive. For each 64-key chunk: s = q k^T on wgmma in registers, the
//    bias added (its loads issued before the products), keys past nk
//    masked; the online row max and sum in f32; p rounded to bf16 in
//    registers as wgmma's A fragment, o += p v on wgmma with A in registers.
//    The epilogue divides by the row sum, rounds, stages the tile row-major
//    in the warpgroup's own q tile and writes each row's d values to the
//    strided out view with consecutive lanes on consecutive bytes.
// The bias is the largest read: every block reads its 128 x nk slice, 1.8
// GB from L2 a launch in f32 at HAT's shapes (the score products are 58
// GFLOP). With the keys in score-fragment order a quad of lanes reads 64
// (f32) or 32 (bf16) contiguous bytes a row and a thread four or two
// 16-byte pieces; read as mma's fragment order lays it (8-byte pairs 32
// bytes apart) it cost the pass 0.23 ms in f32 and 0.39 in bf16
// (scripts/torch_ablate_cab_oca.py). A bias the caller hands in bf16 (the
// bf16 step gathers it from its bf16 table) is read as it is, half the
// bytes and the same values; an f32 bias is never rounded. No sums across
// blocks: two launches give the same bits.
//
// Measured at HAT's step shapes (scripts/torch_ablate_cab_oca.py, NVIDIA
// H100 80GB HBM3, 700.00 W): 0.676 ms a call with the step's bf16 bias (pack
// 0.226, attention 0.450), 0.736 with an f32 bias; SDPA with the bias as
// its mask 10.2.
// The images, the passes and the geometry rule live in of_attn.cuh (B10's
// attention pass runs the same of_fwd_kernel, and above 576 keys the same
// lf_core.cuh pass).
#include "of_attn.cuh"

// Elements of the bf16 scratch (the images; in the large entry, `any`, also
// the bias in fragment order, in its dtype: bias_bf16 or f32).
static int of_scratch(int bw, int heads, int nq, int nk, int d, bool any, int bias_bf16, long long* t_elems) {
  if (!of_shape_ok(bw, heads, nq, nk, d, any)) return (int)cudaErrorInvalidValue;
  *t_elems = of_plan(bw, heads, nq, nk, d, any, bias_bf16).t_elems;
  return 0;
}

extern "C" int oca_core_fwd_mma_scratch(int bw, int heads, int nq, int nk, int d, long long* t_elems) {
  return of_scratch(bw, heads, nq, nk, d, false, 0, t_elems);
}

extern "C" int oca_core_fwd_large_mma_scratch(int bw, int heads, int nq, int nk, int d, int bias_bf16,
                                              long long* t_elems) {
  return of_scratch(bw, heads, nq, nk, d, true, bias_bf16, t_elems);
}

template <int DP, typename BT>
static cudaError_t of_launch(const OfArgs& a, const OfPlan& P, cudaStream_t st, bool large) {
  const long long pieces = P.units * (P.QT + 2 * P.KT) * AM_TOK * (DP / 8);
  of_pack_kernel<DP><<<(int)((pieces + 255) / 256 < 8192 ? (pieces + 255) / 256 : 8192), 256, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return of_attn_launch<DP, BT>(a, st, large);
}

// strides: (window, head, token) of q, k, v, g (unused), out, dq, dk, dv
// (unused), in elements; d contiguous in each. bias_bf16: the bias is bf16
// (else f32).
static int of_run(const void* q, const void* k, const void* v, const void* bias, void* out, const long long* strides,
                  int bias_bf16, int bw, int heads, int nq, int nk, int d, void* tscratch, long long t_elems,
                  void* stream, bool any) {
  if (!of_shape_ok(bw, heads, nq, nk, d, any)) return (int)cudaErrorInvalidValue;
  const OfPlan P = of_plan(bw, heads, nq, nk, d, any, bias_bf16);
  if (P.t_elems != t_elems) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)tscratch % 16) return (int)cudaErrorMisalignedAddress;
  OfArgs a{};
  a.q = (const bf16*)q, a.k = (const bf16*)k, a.v = (const bf16*)v, a.out = (bf16*)out;
  for (int t = 0; t < OF_N; ++t)
    for (int j = 0; j < 3; ++j) a.st[t][j] = strides[3 * t + j];
  a.bias = bias;
  a.img = (bf16*)tscratch;
  a.bfrag = any ? (bf16*)tscratch + P.bias : nullptr;
  a.units = P.units, a.unit_elems = P.unit_elems;
  a.qimg = a.img, a.q_unit = P.unit_elems, a.kv0 = (long long)P.QT * AM_TOK * P.DP;
  a.heads = heads, a.nq = nq, a.nk = nk, a.d = d, a.QT = P.QT, a.KT = P.KT, a.nrows = nq;
  a.pairs = d % 2 == 0 && (uintptr_t)out % 4 == 0;
  a.vec = (uintptr_t)bias % 16 == 0 && nk % (bias_bf16 ? 8 : 4) == 0;
  for (int j = 0; j < 3; ++j) a.pairs = a.pairs && strides[3 * OF_O + j] % 2 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (P.DP == 32)
    return (int)(bias_bf16 ? of_launch<32, bf16>(a, P, st, any) : of_launch<32, float>(a, P, st, any));
  return (int)(bias_bf16 ? of_launch<16, bf16>(a, P, st, any) : of_launch<16, float>(a, P, st, any));
}

#define OF_ENTRY(NAME, ANY)                                                                                       \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* bias, void* out,                  \
                      const long long* strides, int bias_bf16, int bw, int heads, int nq, int nk, int d,         \
                      void* tscratch, long long t_elems, void* stream) {                                         \
    return of_run(q, k, v, bias, out, strides, bias_bf16, bw, heads, nq, nk, d, tscratch, t_elems, stream, ANY); \
  }

OF_ENTRY(oca_core_fwd_mma_bf16, false)
OF_ENTRY(oca_core_fwd_large_mma_bf16, true)
