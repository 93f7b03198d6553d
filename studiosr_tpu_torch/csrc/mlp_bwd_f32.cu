// B7 in f32, written for the H100: the backward of the MLP half of a Swin
// block with the forward recomputed,
//   y = x + d * fc2(gelu(fc1(LN x))),  d = dp[row / rows_per_sample],
// over token rows: from x and the cotangent g it emits dx and the f32
// gradients of the LN scale and bias, fc1 (W1, b1) and fc2 (W2, b2).
//
// Replaces studiosr_tpu/ops/pallas/mlp_vjp.py::_bwd (:148, reached through
// _dp_bwd) in f32, the dtype SwinFIR's recipe trains in (MaxSR's, HAT's and
// SwinIR's f32 steps and checks take it too); bf16 runs mlp_bwd_mma.cu. The
// contract is the TPU kernel's with T = f32: g_b = d g, dx = g_b +
// LN-backward(dln) + (1 - d) g, the exact erf GELU (am_gauss's Phi, within
// 2.3e-7 of the exact one, at a third of erff's and expf's instructions:
// the epilogue of pass 2 took a third of its time), products accumulated in
// f32, LN statistics and the LN backward in f32, every sum across blocks in
// a fixed order (no atomics: the same bits from run to run).
//
// Bound on the card at SwinFIR's step (R = 131,072 rows, C 180, hidden 360):
// five products of 2 R C hidden, 84.9 GFLOP, 0.515 ms at 3xTF32 (0.084 ms
// for x, g and dx). mlp_bwd.cu ran its three row products a 64-row tile on
// the FMA pipes (4 x 4 outputs a thread, a barrier every 32-row weight
// chunk, the weights restaged from L2 for every tile) and its weight
// gradients at 8 x 8 a thread. Here, the structure of mlp_bwd_mma.cu with
// every product in 3xTF32 on the tensor cores (tf32x3.cuh: the row products
// 1-3 on wgmma, the weight gradients on mma.sync):
// 0. mb32_ln_kernel, a warp a row: LN (its f32 statistics kept) and g_b to
//    row-major scratch rows;
// 1. h1 = LN W1 + b1 to the g1 rows (N = hidden padded to 4);
// 2. dg1 = g_b W2^T, its epilogue reading h1 back (its tile copied in under
//    the last products): g1 = gelu(h1) in place, dh1 = dg1 gelu'(h1) (zero
//    in the padding columns);
// 3. dln = dh1 W1^T to f32 rows;
// 4. mb32_lnb_kernel, a warp a row: the LN backward and dx, per-block column
//    sums of dln xhat and dln (summed in a fixed order);
// 5. dW1 = LN^T dh1, dW2 = gelu(h1)^T g_b and the bias gradients, split-K
//    partials of the same GEMM summed in a fixed order.
// The weights change every step, so they are packed per call (tfw_pack: a
// gather by the index table of ops/cuda/mlp_bwd.py _f32_pack_index and the
// split into hi and lo images: W1, W2^T and W1^T, hidden padded to 4 with
// zeros).
// Takes f32, C a multiple of 4 up to 256, any hidden width.
#include "tf32x3.cuh"

struct Mb32Geom {
  int C, hidden, HP;  // HP: hidden padded to 4
  __host__ __device__ Mb32Geom(int C_, int hidden_) : C(C_), hidden(hidden_), HP(tf_pad4(hidden_)) {}
  // the row products' weights (tfw_pack's images): W1 (C x HP), W2^T (C x
  // HP), W1^T (HP x C); their hi values (the lo ones as many)
  __host__ __device__ long long pack_elems() const { return 2 * tfw_elems(C, HP) + tfw_elems(HP, C); }
};

struct Mb32Args {
  const float *x, *g, *ln_w, *ln_b, *dp;
  float* dx;
  float *ln, *gb, *g1, *dh1, *dln, *stats, *lnst;
  long long rows;
  int rps;
};

// Pass 0, a warp a row: LN, its statistics and g_b.
__global__ void __launch_bounds__(256) mb32_ln_kernel(const Mb32Args a, const Mb32Geom G) {
  for (long long row = blockIdx.x * 8LL + (threadIdx.x >> 5); row < a.rows; row += gridDim.x * 8LL) {
    const float dd = a.dp ? a.dp[row / a.rps] : 1.f;
    tf_ln_row(a.x + row * G.C, a.g + row * G.C, dd, G.C, a.ln_w, a.ln_b, a.stats + 2 * row, a.ln + row * G.C,
              a.gb + row * G.C);
  }
}

// Pass 1's epilogue: h1 = acc + b1 (zero past the hidden units) to the g1 rows.
struct Mb32H1 {
  static constexpr bool AUX = false;
  float* h1;
  const float* b1;
  long long rows;
  int hidden, HP;
  __device__ __forceinline__ void operator()(int, long long r, int c, float v0, float v1, float2) const {
    if (r >= rows || c >= HP) return;
    const float h0 = c < hidden ? v0 + __ldg(b1 + c) : 0.f, hh = c + 1 < hidden ? v1 + __ldg(b1 + c + 1) : 0.f;
    *reinterpret_cast<float2*>(h1 + r * HP + c) = make_float2(h0, hh);
  }
};

// Pass 2's epilogue: dg1 = acc; g1 = gelu(h1) over h1, dh1 = dg1 gelu'(h1);
// h1 (aux, the g1 rows) comes in through shared memory ahead of the
// epilogue.
struct Mb32Dh1 {
  static constexpr bool AUX = true;
  const float* aux;  // h1
  long long ld;
  float *g1, *dh1;
  long long rows;
  int HP;
  __device__ __forceinline__ void operator()(int, long long r, int c, float v0, float v1, float2 h) const {
    if (r >= rows || c >= HP) return;
    float c0, p0, c1, p1;
    am_gauss(h.x, c0, p0);
    am_gauss(h.y, c1, p1);
    *reinterpret_cast<float2*>(g1 + r * HP + c) = make_float2(h.x * c0, h.y * c1);
    *reinterpret_cast<float2*>(dh1 + r * HP + c) = make_float2(v0 * (c0 + h.x * p0), v1 * (c1 + h.y * p1));
  }
};

// Pass 4, a warp a row (block b takes rows b, b + gridDim, ...): the LN
// backward and dx, and the block's column sums of dln xhat and dln into
// lnst[block][2 C].
__global__ void __launch_bounds__(256) mb32_lnb_kernel(const Mb32Args a, const Mb32Geom G) {
  __shared__ float sums[8][2 * TF_MAX_C];
  const int warp = threadIdx.x >> 5, C = G.C;
  float cs[2][8] = {};
  for (long long row = blockIdx.x + (long long)gridDim.x * warp; row < a.rows; row += gridDim.x * 8LL) {
    const float dd = a.dp ? a.dp[row / a.rps] : 1.f;
    tf_lnb_row(a.dln + row * C, a.x + row * C, a.g + row * C, a.dx + row * C, a.stats[2 * row], a.stats[2 * row + 1],
               dd, C, a.ln_w, cs);
  }
  tf_lnb_sums(cs, C, sums, a.lnst + (long long)blockIdx.x * 2 * C);
}

static bool mb32_geometry_ok(int C, int hidden) { return C >= 4 && C <= TF_MAX_C && C % 4 == 0 && hidden >= 1; }

// The f32 scratch, each region 16-byte aligned: the packed weights; LN,
// g_b (C) and g1, dh1 (HP) rows; dln rows (C); the LN statistics (2 a
// row); pass 4's blocks' column sums and their sums by eights; the wgrad
// partials.
struct Mb32Scratch {
  long long pack, ln, gb, g1, dh1, dln, stats, lnst, wg, f_elems;
  int row_blocks;
};

static Mb32Scratch mb32_scratch(long long rows, int C, int hidden, int sms) {
  const Mb32Geom G(C, hidden);
  Mb32Scratch S;
  auto at = [](long long& o, long long n) {
    const long long r = o;
    o = (o + n + 3) & ~3LL;
    return r;
  };
  long long o = 0;
  S.row_blocks = 8 * sms;
  S.pack = at(o, 2 * G.pack_elems());
  S.ln = at(o, rows * C);
  S.gb = at(o, rows * C);
  S.g1 = at(o, rows * G.HP);
  S.dh1 = at(o, rows * G.HP);
  S.dln = at(o, rows * C);
  S.stats = at(o, 2 * rows);
  S.lnst = at(o, (long long)(S.row_blocks + sms) * 2 * C);
  const long long p1 = tf_wgrad_plan(rows, C, hidden, sms).part_elems;
  const long long p2 = tf_wgrad_plan(rows, hidden, C, sms).part_elems;
  S.wg = at(o, p1 > p2 ? p1 : p2);
  S.f_elems = o;
  return S;
}

// Elements of the packed weights (ops/cuda/mlp_bwd.py checks its own count
// against it), or -1 for a geometry the kernels do not take.
extern "C" long long mlp_bwd_mma_f32_pack_elems(int C, int hidden) {
  return mb32_geometry_ok(C, hidden) ? Mb32Geom(C, hidden).pack_elems() : -1;
}

extern "C" int mlp_bwd_mma_f32_scratch(int rows, int C, int hidden, long long* f_elems) {
  int sms = 0;
  const cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  *f_elems = mb32_scratch(rows, C, hidden, sms).f_elems;
  return 0;
}

// w1 (C x hidden) and w2 (hidden x C), (in, out) layout, are gathered by
// pack_index; dw1 (C x hidden), db1, dw2 (hidden x C), db2 and ds_db (the LN
// scale's gradient, then its bias's) come back in f32.
extern "C" int mlp_bwd_mma_f32(const void* x, const void* g, void* dx, int rows, int C, int hidden, const void* ln_w,
                               const void* ln_b, const void* w1, const void* b1, const void* w2, const void* dp,
                               int rows_per_sample, const void* pack_index, long long pack_elems, void* ds_db,
                               void* dw1, void* db1, void* dw2, void* db2, void* fscratch, long long f_elems,
                               void* stream) {
  if (!mb32_geometry_ok(C, hidden) || rows < 1 || (dp && rows_per_sample <= 0)) return (int)cudaErrorInvalidValue;
  const Mb32Geom G(C, hidden);
  int sms = 0;
  cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const Mb32Scratch S = mb32_scratch(rows, C, hidden, sms);
  if (S.f_elems != f_elems || G.pack_elems() != pack_elems) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || (uintptr_t)g % 16 || (uintptr_t)dx % 16 || (uintptr_t)fscratch % 16 ||
      (uintptr_t)ln_w % 16 || (uintptr_t)ln_b % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  float* f = (float*)fscratch;
  Mb32Args a{};
  a.x = (const float*)x, a.g = (const float*)g, a.dx = (float*)dx;
  a.ln_w = (const float*)ln_w, a.ln_b = (const float*)ln_b, a.dp = (const float*)dp;
  a.ln = f + S.ln, a.gb = f + S.gb, a.g1 = f + S.g1, a.dh1 = f + S.dh1, a.dln = f + S.dln;
  a.stats = f + S.stats, a.lnst = f + S.lnst;
  a.rows = rows, a.rps = rows_per_sample;
  const long long e1 = tfw_elems(C, G.HP), n1 = (long long)C * hidden;
  float *w1p = f + S.pack, *w2tp = w1p + 2 * e1, *w1tp = w2tp + 2 * e1;
  const int* idx = (const int*)pack_index;

  const float *wa = (const float*)w1, *wb = (const float*)w2;
  err = tfw_pack(wa, n1, wb, n1, idx, C, G.HP, w1p, st);
  if (err == cudaSuccess) err = tfw_pack(wa, n1, wb, n1, idx + e1, C, G.HP, w2tp, st);
  if (err == cudaSuccess) err = tfw_pack(wa, n1, wb, n1, idx + 2 * e1, G.HP, C, w1tp, st);
  if (err != cudaSuccess) return (int)err;
  mb32_ln_kernel<<<S.row_blocks, 256, 0, st>>>(a, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // h1 = LN W1 + b1
  err = tfw_gemm(TfwGemm{a.ln, w1p, C, rows, C, G.HP}, Mb32H1{a.g1, (const float*)b1, rows, hidden, G.HP}, st);
  if (err != cudaSuccess) return (int)err;
  // dg1 = g_b W2^T; gelu(h1), dh1
  err = tfw_gemm(TfwGemm{a.gb, w2tp, C, rows, C, G.HP}, Mb32Dh1{a.g1, G.HP, a.g1, a.dh1, rows, G.HP}, st);
  if (err != cudaSuccess) return (int)err;
  // dln = dh1 W1^T
  err = tfw_gemm(TfwGemm{a.dh1, w1tp, G.HP, rows, G.HP, C}, TfStore{a.dln, rows, C, C}, st);
  if (err != cudaSuccess) return (int)err;
  mb32_lnb_kernel<<<S.row_blocks, 256, 0, st>>>(a, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // block b's partial is part s = b / sms of group b % sms: first the eight
  // of each group, then the groups, in order
  float* lnst1 = a.lnst + (long long)S.row_blocks * 2 * C;
  err = reduce_parts(a.lnst, S.row_blocks / sms, (long long)sms * 2 * C, lnst1, st);
  if (err != cudaSuccess) return (int)err;
  err = reduce_parts(lnst1, sms, 2LL * C, (float*)ds_db, st);
  if (err != cudaSuccess) return (int)err;
  err = tf_wgrad(a.ln, C, a.dh1, G.HP, rows, C, hidden, (float*)dw1, (float*)db1, f + S.wg, sms, st);
  if (err != cudaSuccess) return (int)err;
  return (int)tf_wgrad(a.g1, G.HP, a.gb, C, rows, hidden, C, (float*)dw2, (float*)db2, f + S.wg, sms, st);
}
