// B5 at windows 9-16 (HAT serving at 16): the attention half of a Swin block,
//   y = x + d_b * proj(WA(LN x)),
// with window attention (WA) over ws x ws windows (N = ws^2 tokens, 256 at
// 16; a window of N not a multiple of 64 ends in a ragged chunk of queries
// and keys), the (heads, N, N) relative-position bias and, for shifted
// blocks, the shifted-window mask; the output aligned with the input (the
// shift folded into reads and writes, as window_attention.cu does at 2-8).
//
// Replaces studiosr_tpu/ops/pallas/swin_block.py::fused_window_attention_block
// at ws 16 (its "v5" per-head kernel, _attn_block_kernel / _v5_attn_stripe).
// The TPU kernel's 32-lane head padding, its compressed mask rows and its
// softmax without the max subtraction (logits clamped at 80) are Mosaic
// matters; here the softmax subtracts the running max, which is the same
// function.
//
// Design: qkv_attention.cuh's two passes. A 256-token window's q|k|v for
// all heads (256 x 576 bf16 at C 180) and one head's f32 scores (256 KB)
// do not fit one block's 227 KB of shared memory, so the projection goes
// through a device scratch and each block takes 64 queries of one window
// and streams its keys in chunks of 64 with an online softmax; 88 KB of
// shared memory in bf16 at C 180, two blocks an SM.
//
// Bound on the card: 2 T C 4C + 4 T 256 C flops, 29.1 GFLOP at the HAT
// serving shapes (T = 65,536 tokens, C 180) against 48 MB of map traffic:
// bound by operations (0.029 ms).
#include "qkv_attention.cuh"

extern "C" long long qkv_attention_pack_elems(int C, int heads) { return qkv_pack_layout(C, heads).total; }

#define WINDOW_ATTENTION16_ENTRY(NAME, T)                                                                         \
  extern "C" int NAME(const void* x, void* out, int B, int H, int W, int C, int heads, int ws, int shift,        \
                      const void* ln_w, const void* ln_b, const void* wqkv, const void* bqkv, const void* wproj, \
                      const void* bproj, const void* relbias, const void* dp, void* qkv, void* packed,          \
                      long long pack_elems, void* stream) {                                                     \
    if (pack_elems != qkv_pack_layout(C, heads).total || shift < 0 || shift >= ws) return (int)cudaErrorInvalidValue; \
    return (int)qkv_attention<T, false>((const T*)x, (T*)out, (T*)qkv, B, H, W, C, heads, ws, shift, 0,          \
                                        (const float*)ln_w, (const float*)ln_b, (const T*)wqkv,                  \
                                        (const float*)bqkv, (const T*)wproj, (const float*)bproj,                \
                                        (const float*)relbias, (const float*)dp, (T*)packed,                     \
                                        (cudaStream_t)stream);                                                   \
  }

WINDOW_ATTENTION16_ENTRY(window_attention16_f32, float)
WINDOW_ATTENTION16_ENTRY(window_attention16_bf16, __nv_bfloat16)
