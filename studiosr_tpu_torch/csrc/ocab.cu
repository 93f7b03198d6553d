// B10: HAT's overlapping cross-attention block,
//   u = LN1 x;  q from each ws x ws window of u Wq; k, v from the owin x owin
//   window around it (owin = ws + 2 pad) of u Wk, u Wv, zero outside the image;
//   y = x + proj(softmax(q k^T + bias) v);
//   out = y + fc2(gelu(fc1(LN2 y))).
//
// Replaces studiosr_tpu/ops/pallas/ocab.py::fused_ocab_block (_ocab_kernel)
// at the geometries the kernels written for the H100 do not take (bf16
// ocab_mma.cu, f32 ocab_f32.cu).
// Keys and values outside the image are zero after the projection, as in
// the TPU kernel (and the reference's zero-padded unfold): those logits are
// the bias alone and take softmax mass; they are not masked. Rounding points
// follow the TPU kernel: q, k, v, the probabilities, the attention output
// and y rounded to the storage type T; LayerNorm and softmax statistics and
// every sum f32. The TPU kernel's softmax without the max subtraction
// (logits clamped at 80) is the same function as the max-subtracted one
// here.
//
// Design: three launches. qkv_attention.cuh's projection pass writes q|k|v
// once per pixel to a device scratch (the TPU kernel instead re-projects kv
// 2.25x per window to spare VMEM traffic; a 576-token kv window is 415 KB in
// bf16 and cannot stay in shared memory); its attention pass takes 64
// queries of a window per block and streams the 576 keys in chunks of 64,
// a zero row where a key lies outside the image, with an online softmax,
// then proj + residual into a y scratch; B6's kernel (mlp_block.cuh) runs
// the MLP tail over y's rows.
//
// Bound on the card: 2 T C 4C (qkv + proj) + 4 T 576 C (scores, p v) +
// 4 T C hidden (MLP) flops, 61.2 GFLOP at the HAT serving shapes (T =
// 65,536, C 180, hidden 360, the kv projected once per pixel) against 48 MB
// of map traffic: bound by operations (0.062 ms).
#include "mlp_block.cuh"
#include "qkv_attention.cuh"

struct OcabPack {
  long long mlp, total;
};

__host__ inline OcabPack ocab_pack_layout(int C, int heads, int hidden) {
  OcabPack P;
  P.mlp = qkv_pack_layout(C, heads).total;
  P.total = P.mlp + mlp_pack_layout(C, hidden).total;
  return P;
}

extern "C" long long ocab_pack_elems(int C, int heads, int hidden) {
  return ocab_pack_layout(C, heads, hidden).total;
}

template <typename T>
static cudaError_t ocab(const T* x, T* out, int B, int H, int W, int C, int heads, int ws, int pad, int hidden,
                        const float* ln1_w, const float* ln1_b, const T* wqkv, const float* bqkv, const T* wproj,
                        const float* bproj, const float* relbias, const float* ln2_w, const float* ln2_b,
                        const T* w1, const float* b1, const T* w2, const float* b2, T* qkv, T* y, T* packed,
                        long long pack_elems, cudaStream_t stream) {
  const OcabPack P = ocab_pack_layout(C, heads, hidden);
  if (P.total != pack_elems || pad < 0) return cudaErrorInvalidValue;
  cudaError_t err = qkv_attention<T, true>(x, y, qkv, B, H, W, C, heads, ws, 0, pad, ln1_w, ln1_b, wqkv, bqkv, wproj,
                                           bproj, relbias, nullptr, packed, stream);
  if (err != cudaSuccess) return err;
  return mlp_block<T, false>(y, out, B * H * W, C, hidden, ln2_w, ln2_b, w1, b1, w2, b2, nullptr, 0, nullptr,
                             nullptr, packed + P.mlp, P.total - P.mlp, stream);
}

#define OCAB_ENTRY(NAME, T)                                                                                      \
  extern "C" int NAME(const void* x, void* out, int B, int H, int W, int C, int heads, int ws, int pad,          \
                      int hidden, const void* ln1_w, const void* ln1_b, const void* wqkv, const void* bqkv,      \
                      const void* wproj, const void* bproj, const void* relbias, const void* ln2_w,             \
                      const void* ln2_b, const void* w1, const void* b1, const void* w2, const void* b2,         \
                      void* qkv, void* y, void* packed, long long pack_elems, void* stream) {                    \
    return (int)ocab<T>((const T*)x, (T*)out, B, H, W, C, heads, ws, pad, hidden, (const float*)ln1_w,          \
                        (const float*)ln1_b, (const T*)wqkv, (const float*)bqkv, (const T*)wproj,                \
                        (const float*)bproj, (const float*)relbias, (const float*)ln2_w, (const float*)ln2_b,    \
                        (const T*)w1, (const float*)b1, (const T*)w2, (const float*)b2, (T*)qkv, (T*)y,          \
                        (T*)packed, pack_elems, (cudaStream_t)stream);                                           \
  }

OCAB_ENTRY(ocab_f32, float)
OCAB_ENTRY(ocab_bf16, __nv_bfloat16)
