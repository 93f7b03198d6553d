// B6: the MLP half of a Swin block over token rows (kernel, bound and
// design in mlp_block.cuh). Replaces
// studiosr_tpu/ops/pallas/swin_block.py::fused_mlp_block, with drop_path /
// rows_per_sample (fused training) or extra / extra_scale (HAT serving).
#include "mlp_block.cuh"

extern "C" long long mlp_block_pack_elems(int C, int hidden) { return mlp_pack_layout(C, hidden).total; }

#define MLP_BLOCK_ENTRY(NAME, T)                                                                               \
  extern "C" int NAME(const void* x, void* out, int rows, int C, int hidden, const void* ln_w, const void* ln_b, \
                      const void* w1, const void* b1, const void* w2, const void* b2, const void* dp,           \
                      int rows_per_sample, void* packed, long long pack_elems, void* stream) {                  \
    return (int)mlp_block<T, false>((const T*)x, (T*)out, rows, C, hidden, (const float*)ln_w,                \
                                    (const float*)ln_b, (const T*)w1, (const float*)b1, (const T*)w2,            \
                                    (const float*)b2, (const float*)dp, rows_per_sample, nullptr, nullptr,       \
                                    (T*)packed, pack_elems, (cudaStream_t)stream);                               \
  }

MLP_BLOCK_ENTRY(mlp_block_f32, float)
MLP_BLOCK_ENTRY(mlp_block_bf16, __nv_bfloat16)

// HAT's CAB join folded in: y = x' + fc2(gelu(fc1(LN x'))), x' = x + extra * escale.
#define MLP_BLOCK_EXTRA_ENTRY(NAME, T)                                                                          \
  extern "C" int NAME(const void* x, void* out, int rows, int C, int hidden, const void* ln_w, const void* ln_b, \
                      const void* w1, const void* b1, const void* w2, const void* b2, const void* extra,        \
                      const void* escale, void* packed, long long pack_elems, void* stream) {                   \
    return (int)mlp_block<T, true>((const T*)x, (T*)out, rows, C, hidden, (const float*)ln_w,                   \
                                   (const float*)ln_b, (const T*)w1, (const float*)b1, (const T*)w2,             \
                                   (const float*)b2, nullptr, 0, (const T*)extra, (const float*)escale,          \
                                   (T*)packed, pack_elems, (cudaStream_t)stream);                                \
  }

MLP_BLOCK_EXTRA_ENTRY(mlp_block_extra_f32, float)
MLP_BLOCK_EXTRA_ENTRY(mlp_block_extra_bf16, __nv_bfloat16)
