// B12 and B13: the core of HAT's overlapping cross-attention,
//   out = softmax(q k^T + bias) v
// on q (bw, heads, nq, d), already scaled by 1/sqrt(d), k and v (bw, heads,
// nk, d) and the f32 bias (heads, nq, nk); the backward returns dq, dk, dv
// and d bias summed over the bw windows.
//
// Replaces studiosr_tpu/ops/pallas/oca_core.py::oca_core_fwd (B12) and
// ::oca_core_bwd (B13). The TPU kernels hold a window's whole (heads, 256,
// 576) f32 score block in VMEM and take the softmax without the max
// subtraction (exp(min(s, 80))), a Mosaic shortcut; here a 64-query x
// 576-key f32 tile (147 KB) does not fit a block beside its operands, so
// the keys stream in chunks of 64 with an online, max-subtracted softmax
// (attn_core.cuh), which is the softmax of the reference math
// (oca_vjp.py::_core_math).
//
// Operands are read and results written through strides: a tensor is any
// (window, head, token) strided view whose d values are contiguous, so the
// OCAB's transposed q / k / v views and the cotangent of its transposed
// output reach the kernels without a copy, and the wrapper allocates out, dq,
// dk, dv as transposed views of (bw, tokens, heads, d) tensors, the layout
// the block reads them back in.
//
// Routes: bf16 B12 / B13 at head dims up to 32 run oca_fwd_mma.cu /
// oca_bwd_mma.cu, f32 B13 at head dims up to 32 with at most 256 queries
// and 576 keys oca_bwd_f32.cu; the rest runs here.
//
// Design: B12 is attn_core.cuh's row pass in forward mode, one block per
// (window, head, 64 queries). B13 is its row pass (row statistics, then dq)
// and its column pass (dk, dv for 64 keys of every window of a group, and
// the group's d bias tile in shared memory; above 256 queries, HAT's windows
// from 17, the d bias of a 64 x 64 tile a block in ac_dbias_kernel), then a
// fixed-order sum of the groups' tiles: no atomics, the same bits from run
// to run. In bf16 with d
// even and 4-byte aligned rows (the OCAB's d 30 views) both run on
// mma.sync, the rows staged by 4-byte cp.async: a 60-byte row at a 360-byte
// stride admits no wider copy, which is the cost of reading the views in
// place (no 0.3 GB of contiguous copies a launch).
//
// Bound on the card at the HAT training shapes (bw 512, heads 6, nq 256, nk
// 576, d 30): B12 4 bw heads nq nk d = 54.4 GFLOP against about 310 MB, B13
// 10 bw heads nq nk d = 135.9 GFLOP against about 573 MB: both bound by
// bytes (0.093 and 0.171 ms). B13 computes the scores three times (the row
// pass's two sweeps, the column pass).
#include "attn_core.cuh"

// Strides, in elements, of the eight tensors, (window, head, token) each:
// q, k, v, g, out, dq, dk, dv.
enum { OC_Q, OC_K, OC_V, OC_G, OC_O, OC_DQ, OC_DK, OC_DV, OC_N };

template <typename T>
struct OcaGeom {
  const T *qp, *kp, *vp, *gp;
  T *op, *dqp, *dkp, *dvp;
  long long st[OC_N][3];
  const float* relbias;
  long long units;
  int heads, nq, nk, d;
  float dq_scale;
  bool pairs;  // d even and every operand row 4-byte aligned: the mma kernels stage rows in 4-byte copies
  static constexpr bool PADDED = false;

  __host__ __device__ bool mma_rows() const { return pairs; }

  // One (window, head): row 0 of each tensor, the token strides, the head's bias.
  struct Unit {
    const T *q0, *k0, *v0, *g0;
    T *o0, *dq0, *dk0, *dv0;
    long long sq, sk, sv, sg, so, sdq, sdk, sdv, id;
    const float* b;
    int nq, nk;
    __device__ const T* q(int r) const { return r < nq ? q0 + r * sq : nullptr; }
    __device__ const T* g(int r) const { return r < nq ? g0 + r * sg : nullptr; }
    __device__ const T* k(int t) const { return t < nk ? k0 + t * sk : nullptr; }
    __device__ const T* v(int t) const { return t < nk ? v0 + t * sv : nullptr; }
    __device__ float bias(int r, int t) const { return b[(size_t)r * nk + t]; }
    __device__ void put_o(int r, int j, float x) const { o0[r * so + j] = from_f32<T>(x); }
    __device__ void put_dq(int r, int j, float x) const { dq0[r * sdq + j] = from_f32<T>(x); }
    __device__ void put_dk(int t, int j, float x) const { dk0[t * sdk + j] = from_f32<T>(x); }
    __device__ void put_dv(int t, int j, float x) const { dv0[t * sdv + j] = from_f32<T>(x); }
  };
  __device__ Unit unit(long long u) const {
    const long long w = u / heads, h = u % heads;
    auto at = [&](int which) { return w * st[which][0] + h * st[which][1]; };
    return Unit{qp + at(OC_Q), kp + at(OC_K), vp + at(OC_V), gp + at(OC_G), op + at(OC_O), dqp + at(OC_DQ),
                dkp + at(OC_DK), dvp + at(OC_DV), st[OC_Q][2], st[OC_K][2], st[OC_V][2], st[OC_G][2],
                st[OC_O][2], st[OC_DQ][2], st[OC_DK][2], st[OC_DV][2], u, relbias + (size_t)h * nq * nk, nq, nk};
  }
};

template <typename T>
static OcaGeom<T> oca_geom(const void* q, const void* k, const void* v, const void* g, void* out, void* dq, void* dk,
                           void* dv, const long long* strides, const float* relbias, int bw, int heads, int nq,
                           int nk, int d) {
  OcaGeom<T> G;
  G.qp = (const T*)q;
  G.kp = (const T*)k;
  G.vp = (const T*)v;
  G.gp = (const T*)g;
  G.op = (T*)out;
  G.dqp = (T*)dq;
  G.dkp = (T*)dk;
  G.dvp = (T*)dv;
  for (int i = 0; i < OC_N; ++i)
    for (int j = 0; j < 3; ++j) G.st[i][j] = strides[3 * i + j];
  G.relbias = relbias;
  G.units = (long long)bw * heads;
  G.heads = heads;
  G.nq = nq;
  G.nk = nk;
  G.d = d;
  G.dq_scale = 1.f;
  G.pairs = d % 2 == 0;
  const void* rows[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i)
    if (rows[i]) {
      G.pairs = G.pairs && (uintptr_t)rows[i] % 4 == 0;
      for (int j = 0; j < 3; ++j) G.pairs = G.pairs && strides[3 * i + j] % 2 == 0;
    }
  return G;
}

// Any query and key count: above AC_MAX_NQ queries the column pass leaves d
// bias to ac_dbias_kernel (a 64 x 64 tile a block, nq x nk as they come).
static bool oca_shape_ok(int bw, int heads, int nq, int nk, int d) {
  return bw > 0 && heads > 0 && nq > 0 && nk > 0 && d > 0 && pad16(d) <= 64;
}

extern "C" long long oca_core_bwd_scratch(int bw, int heads, int nq, int nk) {
  const int groups = ac_groups(bw, heads, nk);
  return ac_stats_elems((long long)bw * heads, nq) + ac_part_elems(groups, heads, nq, nk);
}

#define OCA_ENTRIES(SUFFIX, T)                                                                                     \
  extern "C" int oca_core_fwd_##SUFFIX(const void* q, const void* k, const void* v, const void* relbias, void* out, \
                                       const long long* strides, int bw, int heads, int nq, int nk, int d,        \
                                       void* stream) {                                                            \
    if (!oca_shape_ok(bw, heads, nq, nk, d)) return (int)cudaErrorInvalidValue;                                  \
    const OcaGeom<T> G = oca_geom<T>(q, k, v, nullptr, out, nullptr, nullptr, nullptr, strides,                   \
                                     (const float*)relbias, bw, heads, nq, nk, d);                                \
    return (int)ac_forward<T>(G, (cudaStream_t)stream);                                                           \
  }                                                                                                               \
  extern "C" int oca_core_bwd_##SUFFIX(const void* q, const void* k, const void* v, const void* relbias,          \
                                       const void* g, void* dq, void* dk, void* dv, void* dbias,                  \
                                       const long long* strides, int bw, int heads, int nq, int nk, int d,        \
                                       void* fscratch, long long f_elems, void* stream) {                        \
    if (!oca_shape_ok(bw, heads, nq, nk, d) || f_elems != oca_core_bwd_scratch(bw, heads, nq, nk))               \
      return (int)cudaErrorInvalidValue;                                                                          \
    const OcaGeom<T> G = oca_geom<T>(q, k, v, g, nullptr, dq, dk, dv, strides, (const float*)relbias, bw, heads,  \
                                     nq, nk, d);                                                                  \
    return (int)ac_backward<T, OcaGeom<T>, AC_ROWS>(G, ac_groups(bw, heads, nk), (float*)fscratch,               \
                                                    (float*)dbias, (cudaStream_t)stream);                         \
  }

OCA_ENTRIES(f32, float)
OCA_ENTRIES(bf16, __nv_bfloat16)
