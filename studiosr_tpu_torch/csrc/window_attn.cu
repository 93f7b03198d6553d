// B15: the window-attention core,
//   out = softmax(q k^T + bias + mask) v
// on q (B', heads, N, d), already scaled by 1/sqrt(d), k and v (B', heads,
// M, d), an optional f32 bias (heads, N, M) (none: a zero bias, MaxSR's
// adaptive mode) and an optional f32 mask (nW, N, M), window b' taking mask
// b' mod nW (B' = images x nW windows in row-major order).
//
// Replaces studiosr_tpu/ops/pallas/window_attn.py::window_attention_pallas
// (_window_attention_impl, kernel _kernel). The TPU kernel holds a block of
// windows' (N, M) f32 scores in VMEM, takes its mask only where the window
// count equals the batch (batch 1) and N, M <= 1024; it subtracts the row
// max, and rounds the probabilities to v's dtype before the product with v.
// Here the contract is attention_core's: any batch of images under one
// mask. N, M <= 1024 (the wrapper raises above), d <= 64.
//
// Design: attn_core.cuh's row pass in forward mode (B12's kernel), one block
// per (window, head, 64 queries); the keys stream in chunks of 64 with an
// online max-subtracted softmax, so the scores never reach device memory
// and N is not bounded by shared memory (the column pass's AC_MAX_NQ is a
// backward limit and does not apply). The unnormalised probabilities are
// rounded to v's dtype for the product and the sum is divided out at the
// end. In bf16 at head dims 16 / 32 with even d (MaxSR's 32, the trained
// fixture's 16, MaxSR light's 12) it runs on mma.sync with the tiles in
// registers; f32 and other head dims take the shared-memory kernel.
//
// Bound on the card at MaxSR's adaptive serving shapes (256 windows of 256
// tokens, 4 heads, d 32, bf16): 4 B' heads N M d = 8.6 GFLOP against 67 MB
// (q, k, v read, out written), bound by bytes (0.020 ms). The static mode
// (1024 windows of 64 tokens with a 64 KB bias table) moves the same bytes.
#include "attn_core.cuh"

// Strides, in elements, of q, k, v, out: (window, head, token) each.
enum { WA_Q, WA_K, WA_V, WA_O, WA_N };

template <typename T>
struct WinGeom {
  const T *qp, *kp, *vp;
  T* op;
  long long st[WA_N][3];
  const float* relbias;  // (heads, nq, nk) or null
  const float* mask;     // (nw, nq, nk) or null
  long long units;
  int heads, nq, nk, d, nw;
  float dq_scale;
  bool pairs;  // d even and every operand row 4-byte aligned: the mma kernel stages rows in 4-byte copies
  static constexpr bool PADDED = false;

  __host__ __device__ bool mma_rows() const { return pairs; }

  struct Unit {
    const T *q0, *k0, *v0;
    T* o0;
    long long sq, sk, sv, so, id;
    const float *b, *m;
    int nq, nk;
    __device__ const T* q(int r) const { return r < nq ? q0 + r * sq : nullptr; }
    __device__ const T* g(int) const { return nullptr; }
    __device__ const T* k(int t) const { return t < nk ? k0 + t * sk : nullptr; }
    __device__ const T* v(int t) const { return t < nk ? v0 + t * sv : nullptr; }
    __device__ float bias(int r, int t) const {
      const size_t i = (size_t)r * nk + t;
      return (b ? b[i] : 0.f) + (m ? m[i] : 0.f);
    }
    __device__ void put_o(int r, int j, float x) const { o0[r * so + j] = from_f32<T>(x); }
    // The row pass's backward modes are not instantiated for this geometry.
    __device__ void put_dq(int, int, float) const {}
    __device__ void put_dk(int, int, float) const {}
    __device__ void put_dv(int, int, float) const {}
  };
  __device__ Unit unit(long long u) const {
    const long long w = u / heads, h = u % heads;
    auto at = [&](int which) { return w * st[which][0] + h * st[which][1]; };
    return Unit{qp + at(WA_Q), kp + at(WA_K), vp + at(WA_V), op + at(WA_O), st[WA_Q][2], st[WA_K][2], st[WA_V][2],
                st[WA_O][2], u, relbias ? relbias + (size_t)h * nq * nk : nullptr,
                mask ? mask + (size_t)(w % nw) * nq * nk : nullptr, nq, nk};
  }
};

constexpr int WA_MAX_TOKENS = 1024;  // window_attn.py's limit on N and M

static bool wa_shape_ok(long long bw, int heads, int nq, int nk, int d, int nw) {
  return bw > 0 && heads > 0 && nq > 0 && nq <= WA_MAX_TOKENS && nk > 0 && nk <= WA_MAX_TOKENS && d > 0 &&
         pad16(d) <= 64 && nw > 0 && bw % nw == 0;
}

#define WINDOW_ATTN_ENTRY(SUFFIX, T)                                                                              \
  extern "C" int window_attn_##SUFFIX(const void* q, const void* k, const void* v, const void* relbias,          \
                                      const void* mask, void* out, const long long* strides, long long bw,       \
                                      int heads, int nq, int nk, int d, int nw, void* stream) {                  \
    if (!wa_shape_ok(bw, heads, nq, nk, d, nw)) return (int)cudaErrorInvalidValue;                               \
    WinGeom<T> G;                                                                                                \
    G.qp = (const T*)q;                                                                                          \
    G.kp = (const T*)k;                                                                                          \
    G.vp = (const T*)v;                                                                                          \
    G.op = (T*)out;                                                                                              \
    for (int i = 0; i < WA_N; ++i)                                                                               \
      for (int j = 0; j < 3; ++j) G.st[i][j] = strides[3 * i + j];                                               \
    G.relbias = (const float*)relbias;                                                                           \
    G.mask = (const float*)mask;                                                                                 \
    G.units = bw * heads;                                                                                        \
    G.heads = heads;                                                                                             \
    G.nq = nq;                                                                                                   \
    G.nk = nk;                                                                                                   \
    G.d = d;                                                                                                     \
    G.nw = nw;                                                                                                   \
    G.dq_scale = 1.f;                                                                                            \
    G.pairs = d % 2 == 0;                                                                                        \
    const void* rows[3] = {q, k, v};                                                                             \
    for (int i = 0; i < 3; ++i) {                                                                                \
      G.pairs = G.pairs && (uintptr_t)rows[i] % 4 == 0;                                                          \
      for (int j = 0; j < 3; ++j) G.pairs = G.pairs && strides[3 * i + j] % 2 == 0;                             \
    }                                                                                                            \
    return (int)ac_forward<T>(G, (cudaStream_t)stream);                                                          \
  }

WINDOW_ATTN_ENTRY(f32, float)
WINDOW_ATTN_ENTRY(bf16, __nv_bfloat16)
