// B5: the attention half of a Swin block with a per-sample drop-path scale,
//   y = x + d_b * proj(WA(LN x)),
// with window attention (WA) over ws x ws windows, ws 2..8, the
// relative-position bias and, for shifted blocks, the shifted-window mask.
// The forward of fused training (ops/attn_vjp.py). A window's N = ws^2 tokens
// are the first N of the block's 64 rows: the rest are zero rows whose keys
// score -inf and whose outputs are never stored.
//
// Replaces studiosr_tpu/ops/pallas/swin_block.py::fused_window_attention_block
// (its window-pair kernel with drop_path). As B1 (swin_block.cu) it folds
// the shift into its reads and writes: token (h, w) of the rolled map is
// read from ((h + s) mod H, (w + s) mod W) and its output is written back
// there, which is roll(+s) . block . roll(-s), the map-level function of
// attention_map_vjp; the mask comes from per-token region ids. Rounding
// points follow the TPU kernel: LN output, q/k/v, probabilities and the
// attention output are rounded to the storage type T; sums, LayerNorm and
// softmax statistics are f32; d_b scales the f32 delta.
//
// Design: B1's attention phase, one block of 256 threads per window, the
// window's x, LN output, attention output, one head's q|k|v and scores in
// shared memory, weights packed once per launch (qkv per head, proj) and
// streamed from L2 by cp.async (swin_common.cuh). At C 180 a bf16 block
// takes 114,688 bytes of shared memory, as B1's: two windows per SM.
//
// Bound on the card: 2 T C (3C + C) + 4 T 64 C flops, 40 GFLOP per launch
// at the training shapes (32 x 64 x 64 tokens, C 180) against 47 MB of
// map traffic: bound by operations. This first version is latency-bound as
// B1 is (PERF.md): small per-head GEMMs, a barrier per staged K chunk.
#include "swin_common.cuh"

struct AttnSmem {
  size_t xs, lnb, attn, qkvh, sc, inv, rid, bst, total;
  int ld_c, ld_qkv;
};

__host__ __device__ inline AttnSmem attn_smem_layout(int C, int heads, size_t tsz) {
  AttnSmem L;
  L.ld_c = pad32(C) + SB_SKEW;
  L.ld_qkv = 3 * pad16(C / heads) + SB_SKEW;
  size_t o = 0;
  L.xs = o;
  o = align32(o + SB_TOK * C * tsz);
  L.lnb = o;
  o = align32(o + SB_TOK * L.ld_c * tsz);
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
  L.bst = o;
  L.total = o + 2 * SB_KC * SB_BL * tsz;
  return L;
}

// Packed weights: qkv_head_segments (heads blocks of kc x nq), then proj
// kc x nc.
struct AttnPack {
  int kc, nq, nc;
  long long proj, total;
};

__host__ __device__ inline AttnPack attn_pack_layout(int C, int heads) {
  AttnPack P;
  P.kc = pad32(C);
  P.nq = pad64(3 * pad16(C / heads));
  P.nc = pad64(C);
  P.proj = (long long)heads * P.kc * P.nq;
  P.total = P.proj + (long long)P.kc * P.nc;
  return P;
}

template <typename T>
__global__ void __launch_bounds__(SB_THREADS, 2) window_attention_kernel(
    const T* __restrict__ x, T* __restrict__ out, int H, int W, int C, int heads, int ws, int shift,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, const float* __restrict__ bqkv,
    const float* __restrict__ bproj, const float* __restrict__ relbias, const float* __restrict__ dp,
    const T* __restrict__ packed) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnSmem L = attn_smem_layout(C, heads, sizeof(T));
  const AttnPack P = attn_pack_layout(C, heads);
  T* xs = (T*)(smem + L.xs);
  T* lnb = (T*)(smem + L.lnb);
  T* attn = (T*)(smem + L.attn);
  T* qkvh = (T*)(smem + L.qkvh);
  float* sc = (float*)(smem + L.sc);
  T* probs = (T*)sc;  // written over the scores by softmax_rows
  float* inv = (float*)(smem + L.inv);
  int* rid = (int*)(smem + L.rid);
  T* bst = (T*)(smem + L.bst);

  const int tid = threadIdx.x;
  const int d = C / heads, DP = pad16(d);
  const int LC = L.ld_c, LQ = L.ld_qkv;
  const int nv = ws * ws, nwin = (H / ws) * (W / ws);
  const int img = blockIdx.x / nwin, wi = blockIdx.x % nwin;
  const float scale = dp ? dp[img] : 1.f;

  for (int i = tid; i < SB_TOK * C; i += SB_THREADS) {
    const int t = i / C;
    xs[i] = t < nv ? x[window_token_offset_ws(img, wi, t, H, W, C, shift, ws) + (i - t * C)] : from_f32<T>(0.f);
  }
  if (tid < SB_TOK) rid[tid] = window_token_region_ws(wi, tid, H, W, shift, ws);
  zero_columns(lnb, LC, C, P.kc);
  zero_columns(attn, LC, C, P.kc);
  const FragMap map = frag_map_for<T>(sc);  // sc is free until the scores
  __syncthreads();
  layernorm_rows<T>(xs, C, ln_w, ln_b, lnb, LC);

  for (int h = 0; h < heads; ++h) {
    head_qkv<T>(lnb, LC, packed + (size_t)h * P.kc * P.nq, bqkv, C, heads, h, qkvh, LQ, bst, map);
    // scores = q k^T + bias (+ mask); -inf past the window's keys
    gemm64_smem<nvcuda::wmma::row_major, nvcuda::wmma::col_major>(
        qkvh, LQ, qkvh + DP, LQ, DP, SB_TOK, map, [&](int r, int n, float acc) {
          float v = -INFINITY;
          if (n < nv) {
            v = acc + (r < nv ? relbias[(h * nv + r) * nv + n] : 0.f);
            if (rid[r] != rid[n]) v += -100.f;
          }
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
    if (r >= nv) return;
    const size_t o = window_token_offset_ws(img, wi, r, H, W, C, shift, ws) + n;
    out[o] = from_f32<T>(to_f32(xs[r * C + n]) + scale * (acc + bproj[n]));
  });
}

extern "C" long long window_attention_pack_elems(int C, int heads) { return attn_pack_layout(C, heads).total; }

template <typename T>
static cudaError_t window_attention(const T* x, T* out, int B, int H, int W, int C, int heads, int ws, int shift,
                                    const float* ln_w, const float* ln_b, const T* wqkv, const float* bqkv,
                                    const T* wproj, const float* bproj, const float* relbias, const float* dp,
                                    T* packed, long long pack_elems, cudaStream_t stream) {
  const AttnPack P = attn_pack_layout(C, heads);
  if (P.total != pack_elems || ws < 2 || ws > SB_WS || H % ws || W % ws || shift < 0 || shift >= ws)
    return cudaErrorInvalidValue;
  std::vector<PackSeg> segs;
  qkv_head_segments(segs, wqkv, C, heads, 0);
  segs.push_back(PackSeg{wproj, P.proj, P.nc, C, C, C, 1});
  cudaError_t err = pack_segments(segs, packed, (size_t)P.total, stream);
  if (err != cudaSuccess) return err;
  const AttnSmem L = attn_smem_layout(C, heads, sizeof(T));
  err = allow_smem(window_attention_kernel<T>, L.total);
  if (err != cudaSuccess) return err;
  const int blocks = B * (H / ws) * (W / ws);
  window_attention_kernel<T><<<blocks, SB_THREADS, L.total, stream>>>(x, out, H, W, C, heads, ws, shift, ln_w,
                                                                     ln_b, bqkv, bproj, relbias, dp, packed);
  return cudaGetLastError();
}

#define WINDOW_ATTENTION_ENTRY(NAME, T)                                                                          \
  extern "C" int NAME(const void* x, void* out, int B, int H, int W, int C, int heads, int ws, int shift,      \
                      const void* ln_w, const void* ln_b, const void* wqkv, const void* bqkv, const void* wproj, \
                      const void* bproj, const void* relbias, const void* dp, void* packed, long long pack_elems, \
                      void* stream) {                                                                            \
    return (int)window_attention<T>((const T*)x, (T*)out, B, H, W, C, heads, ws, shift, (const float*)ln_w,      \
                                    (const float*)ln_b, (const T*)wqkv, (const float*)bqkv, (const T*)wproj,     \
                                    (const float*)bproj, (const float*)relbias, (const float*)dp, (T*)packed,    \
                                    pack_elems, (cudaStream_t)stream);                                           \
  }

WINDOW_ATTENTION_ENTRY(window_attention_f32, float)
WINDOW_ATTENTION_ENTRY(window_attention_bf16, __nv_bfloat16)
