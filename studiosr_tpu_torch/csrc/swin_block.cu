// B1: the whole Swin transformer block in one pass over the map,
//   z = x + proj(WA(LN1 x)),  y = z + fc2(gelu(fc1(LN2 z))),
// with window attention (WA) over 8 x 8 windows, the relative-position bias
// and, for shifted blocks, the shifted-window mask.
//
// Replaces studiosr_tpu/ops/pallas/swin_block.py::fused_swin_block in f32,
// the checks' dtype (C entry swin_block_f32); bf16 runs the kernel written
// for the H100, swin_block_mma.cu. It computes what the TPU kernel
// computes, not its Mosaic layout: no
// window-pair score packing, no -1e30 pair bias, no compressed mask rows,
// no half-stripe shift reads. The rounding points follow the TPU kernel:
// LN outputs, q/k/v, probabilities, the attention output, z and the GELU
// output are rounded to the storage type T; sums, LayerNorm and softmax
// statistics are f32.
//
// Design: one thread block of 256 threads per window (1089 windows at the
// main path's 264 x 264 map). The window's working set lives in shared
// memory: x then z (64 x C), the LN output (64 x C), and a region that
// holds the attention output, one head's q|k|v and its scores (overwritten
// in place by its probabilities), and later the 64 x hidden MLP
// activation. The block loops over heads, so q/k/v never exist for all
// heads at once. Every weight product is a 64-row GEMM (gemm64) whose B
// operand streams from L2 in 32 x 64 chunks through two shared-memory
// buffers (16-byte cp.async, the next chunk in flight while the current one
// is multiplied). So that every chunk is whole and 16-byte aligned, a small
// pack kernel first lays the four weight matrices out in one zero-padded
// scratch (SwinPack). q k^T and p v read k and v in place (gemm64_smem);
// the products run on the FMA pipes. Operand K dimensions are padded with
// zeros (C 180 -> 192, head dim 30 -> 32, hidden 360 -> 384).
//
// The shift: with shift s, token (h, w) of the rolled map is read from
// ((h + s) mod H, (w + s) mod W) and its output is written back to that
// same source position. That is roll(+s) . block . roll(-s), the linen
// block exactly, so the output stays aligned and the caller keeps no
// rolled-space bookkeeping. The mask is computed per token from its region
// id (ops/windows.py::shift_region_ids holds the same rule against
// calculate_mask) instead of being read from a dense (nW, 64, 64) operand.
//
// Bound on the card: 39.4 GFLOP per launch at the main path's shapes
// against about 50 MB of traffic, so the block is bound by operations.
// Reading and writing the map exactly once is what it keeps from the TPU
// design.
#include "swin_common.cuh"

// Shared-memory layout of one window: byte offsets and row strides (in
// elements). K dimensions are padded with zero columns (lnb and attn to
// pad32(C), each of q/k/v to DP = pad16(d), hid to pad32(hidden)), and
// every stride gets SB_SKEW more. bst holds two staged B chunks. The
// scores sc are 64 x SB_TL f32; the probabilities overwrite them in place,
// row r of probabilities (in T) starting where row r of scores starts.
struct SwinSmem {
  size_t xs, lnb, attn, qkvh, sc, inv, rid, hid, bst, total;
  int ld_c, ld_qkv, ld_h;
};

__host__ __device__ inline SwinSmem swin_smem_layout(int C, int heads, int hidden, size_t tsz) {
  SwinSmem L;
  L.ld_c = pad32(C) + SB_SKEW;
  L.ld_qkv = 3 * pad16(C / heads) + SB_SKEW;
  L.ld_h = pad32(hidden) + SB_SKEW;
  size_t o = 0;
  L.xs = o;
  o = align32(o + SB_TOK * C * tsz);
  L.lnb = o;
  o = align32(o + SB_TOK * L.ld_c * tsz);
  const size_t region = o;  // attention phase, then the MLP phase
  L.attn = o;
  o = align32(o + SB_TOK * L.ld_c * tsz);
  L.qkvh = o;
  o = align32(o + SB_TOK * L.ld_qkv * tsz);
  L.sc = o;
  o = align32(o + SB_TOK * SB_TL * sizeof(float));
  L.inv = o;
  o = align32(o + SB_TOK * sizeof(float));
  L.rid = o;
  o = align32(o + SB_TOK * sizeof(int));
  L.hid = region;
  const size_t mlp_end = align32(region + SB_TOK * L.ld_h * tsz);
  L.bst = o > mlp_end ? o : mlp_end;
  L.total = L.bst + 2 * SB_KC * SB_BL * tsz;
  return L;
}

// Packed weights, one scratch per launch (elements of T): qkv, heads
// blocks of kc x nq, head h's q, k and v in columns [0, DP), [DP, 2 DP),
// [2 DP, 3 DP) (zero past d); then proj kc x nc, fc1 kc x nh, fc2 kh x nc.
// kc = pad32(C), kh = pad32(hidden), nq = pad64(3 DP), nc = pad64(C),
// nh = pad64(hidden); zero outside the source matrices, so every staged
// chunk is whole. ops/cuda/swin_block.py::packed_elements mirrors total.
struct SwinPack {
  int kc, kh, nq, nc, nh;
  size_t qkv, proj, fc1, fc2, total;
};

__host__ __device__ inline SwinPack swin_pack_layout(int C, int heads, int hidden) {
  SwinPack P;
  P.kc = pad32(C);
  P.kh = pad32(hidden);
  P.nq = pad64(3 * pad16(C / heads));
  P.nc = pad64(C);
  P.nh = pad64(hidden);
  P.qkv = 0;
  P.proj = (size_t)heads * P.kc * P.nq;
  P.fc1 = P.proj + (size_t)P.kc * P.nc;
  P.fc2 = P.fc1 + (size_t)P.kc * P.nh;
  P.total = P.fc2 + (size_t)P.kh * P.nc;
  return P;
}

template <typename T>
__global__ void swin_pack_kernel(const T* __restrict__ wqkv, const T* __restrict__ wproj, const T* __restrict__ w1,
                                 const T* __restrict__ w2, T* __restrict__ packed, int C, int heads, int hidden) {
  const SwinPack P = swin_pack_layout(C, heads, hidden);
  const int d = C / heads, DP = pad16(d);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < P.total; i += (size_t)gridDim.x * blockDim.x) {
    T v = from_f32<T>(0.f);
    if (i < P.proj) {
      const int h = (int)(i / ((size_t)P.kc * P.nq)), r = (int)(i % ((size_t)P.kc * P.nq));
      const int k = r / P.nq, n = r % P.nq, part = n / DP, j = n % DP;
      if (k < C && part < 3 && j < d) v = wqkv[(size_t)k * 3 * C + part * C + h * d + j];
    } else if (i < P.fc1) {
      const int r = (int)(i - P.proj), k = r / P.nc, n = r % P.nc;
      if (k < C && n < C) v = wproj[(size_t)k * C + n];
    } else if (i < P.fc2) {
      const int r = (int)(i - P.fc1), k = r / P.nh, n = r % P.nh;
      if (k < C && n < hidden) v = w1[(size_t)k * hidden + n];
    } else {
      const int r = (int)(i - P.fc2), k = r / P.nc, n = r % P.nc;
      if (k < hidden && n < C) v = w2[(size_t)k * C + n];
    }
    packed[i] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(SB_THREADS, 2) swin_block_kernel(
    const T* __restrict__ x, T* __restrict__ out, int H, int W, int C, int heads, int hidden, int shift,
    const float* __restrict__ ln1_w, const float* __restrict__ ln1_b, const float* __restrict__ bqkv,
    const float* __restrict__ bproj, const float* __restrict__ relbias, const float* __restrict__ ln2_w,
    const float* __restrict__ ln2_b, const float* __restrict__ b1, const float* __restrict__ b2,
    const T* __restrict__ packed) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SwinSmem L = swin_smem_layout(C, heads, hidden, sizeof(T));
  const SwinPack P = swin_pack_layout(C, heads, hidden);
  T* xs = (T*)(smem + L.xs);
  T* lnb = (T*)(smem + L.lnb);
  T* attn = (T*)(smem + L.attn);
  T* qkvh = (T*)(smem + L.qkvh);
  float* sc = (float*)(smem + L.sc);
  T* probs = (T*)sc;  // written over the scores by softmax_rows
  float* inv = (float*)(smem + L.inv);
  int* rid = (int*)(smem + L.rid);
  T* hid = (T*)(smem + L.hid);
  T* bst = (T*)(smem + L.bst);

  const int tid = threadIdx.x;
  const int d = C / heads, DP = pad16(d);
  const int LC = L.ld_c, LQ = L.ld_qkv, LH = L.ld_h;
  const int nwx = W / SB_WS, nwin = (H / SB_WS) * nwx;
  const int img = blockIdx.x / nwin, wi = blockIdx.x % nwin;
  const int wy = wi / nwx, wx = wi % nwx;
  // Element offset of token t's source position (see the shift note above).
  auto src = [&](int t) -> size_t {
    const int hs = (wy * SB_WS + t / SB_WS + shift) % H;
    const int ws = (wx * SB_WS + t % SB_WS + shift) % W;
    return (((size_t)img * H + hs) * W + ws) * C;
  };

  for (int i = tid; i < SB_TOK * C; i += SB_THREADS) {
    const int t = i / C;
    xs[i] = x[src(t) + (i - t * C)];
  }
  if (tid < SB_TOK) {
    rid[tid] = shift ? 3 * region_id(wy * SB_WS + tid / SB_WS, H, shift) + region_id(wx * SB_WS + tid % SB_WS, W, shift)
                     : 0;
  }
  zero_columns(lnb, LC, C, P.kc);
  zero_columns(attn, LC, C, P.kc);
  FragMap map{{0u, 0u}};  // read only by the tensor-core products, which f32 does not run
  __syncthreads();
  layernorm_rows<T>(xs, C, ln1_w, ln1_b, lnb, LC);

  const float qscale = rsqrtf((float)d);
  for (int h = 0; h < heads; ++h) {
    // q|k|v of head h, each DP wide (columns >= d are zero): column
    // part * DP + j of qkvh is column part * C + h * d + j of wqkv.
    auto part_of = [&](int n) { return n >= 2 * DP ? 2 : (n >= DP ? 1 : 0); };
    gemm64<T>(lnb, LC, P.kc, 3 * DP, packed + P.qkv + (size_t)h * P.kc * P.nq, P.nq, bst, map,
              [&](int r, int n, float acc) {
                const int part = part_of(n), j = n - part * DP;
                float v = 0.f;
                if (j < d) {
                  v = acc + bqkv[part * C + h * d + j];
                  if (part == 0) v *= qscale;
                }
                qkvh[r * LQ + n] = from_f32<T>(v);
              });
    // scores = q k^T + bias (+ mask)
    gemm64_smem<nvcuda::wmma::row_major, nvcuda::wmma::col_major>(
        qkvh, LQ, qkvh + DP, LQ, DP, SB_TOK, map, [&](int r, int n, float acc) {
          float v = acc + relbias[(h * SB_TOK + r) * SB_TOK + n];
          if (rid[r] != rid[n]) v += -100.f;
          sc[r * SB_TL + n] = v;
        });
    softmax_rows<T>(sc, inv);
    __syncthreads();
    gemm64_smem<nvcuda::wmma::row_major, nvcuda::wmma::row_major>(
        probs, probs_ld<T>(), qkvh + 2 * DP, LQ, SB_TOK, DP, map, [&](int r, int n, float acc) {
          if (n < d) attn[r * LC + h * d + n] = from_f32<T>(acc * inv[r]);
        });
  }

  gemm64<T>(attn, LC, P.kc, C, packed + P.proj, P.nc, bst, map, [&](int r, int n, float acc) {
    const int i = r * C + n;
    xs[i] = from_f32<T>(to_f32(xs[i]) + (acc + bproj[n]));
  });
  zero_columns(hid, LH, hidden, P.kh);  // the region now holds the MLP activation
  layernorm_rows<T>(xs, C, ln2_w, ln2_b, lnb, LC);
  __syncthreads();
  gemm64<T>(lnb, LC, P.kc, hidden, packed + P.fc1, P.nh, bst, map, [&](int r, int n, float acc) {
    const float v = acc + b1[n];
    hid[r * LH + n] = from_f32<T>(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
  });
  gemm64<T>(hid, LH, P.kh, C, packed + P.fc2, P.nc, bst, map,
            [&](int r, int n, float acc) { out[src(r) + n] = from_f32<T>(to_f32(xs[r * C + n]) + (acc + b2[n])); });
}

// Packs the weights into `packed` (pack_elems elements, SwinPack), then
// runs the block; both on `stream`.
template <typename T>
static cudaError_t swin_block(const T* x, T* out, int B, int H, int W, int C, int heads, int hidden, int shift,
                              const float* ln1_w, const float* ln1_b, const T* wqkv, const float* bqkv,
                              const T* wproj, const float* bproj, const float* relbias, const float* ln2_w,
                              const float* ln2_b, const T* w1, const float* b1, const T* w2, const float* b2,
                              T* packed, long long pack_elems, cudaStream_t stream) {
  const SwinPack P = swin_pack_layout(C, heads, hidden);
  if ((long long)P.total != pack_elems) return cudaErrorInvalidValue;
  swin_pack_kernel<T><<<(int)((P.total + 255) / 256), 256, 0, stream>>>(wqkv, wproj, w1, w2, packed, C, heads,
                                                                       hidden);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const SwinSmem L = swin_smem_layout(C, heads, hidden, sizeof(T));
  err = cudaFuncSetAttribute(swin_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(swin_block_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int blocks = B * (H / SB_WS) * (W / SB_WS);
  swin_block_kernel<T><<<blocks, SB_THREADS, L.total, stream>>>(x, out, H, W, C, heads, hidden, shift, ln1_w,
                                                               ln1_b, bqkv, bproj, relbias, ln2_w, ln2_b, b1, b2,
                                                               packed);
  return cudaGetLastError();
}

#define SWIN_BLOCK_ENTRY(NAME, T)                                                                            \
  extern "C" int NAME(const void* x, void* out, int B, int H, int W, int C, int heads, int hidden, int shift, \
                      const void* ln1_w, const void* ln1_b, const void* wqkv, const void* bqkv,              \
                      const void* wproj, const void* bproj, const void* relbias, const void* ln2_w,          \
                      const void* ln2_b, const void* w1, const void* b1, const void* w2, const void* b2,     \
                      void* packed, long long pack_elems, void* stream) {                                    \
    return (int)swin_block<T>((const T*)x, (T*)out, B, H, W, C, heads, hidden, shift, (const float*)ln1_w,   \
                              (const float*)ln1_b, (const T*)wqkv, (const float*)bqkv, (const T*)wproj,      \
                              (const float*)bproj, (const float*)relbias, (const float*)ln2_w,               \
                              (const float*)ln2_b, (const T*)w1, (const float*)b1, (const T*)w2,             \
                              (const float*)b2, (T*)packed, pack_elems, (cudaStream_t)stream);               \
  }

SWIN_BLOCK_ENTRY(swin_block_f32, float)
