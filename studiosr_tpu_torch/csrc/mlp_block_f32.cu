// B6 in f32, written for the H100: the MLP half of a Swin block over token
// rows,
//   y = x + d * fc2(gelu(fc1(LN x))),  d = dp[row / rows_per_sample] (1 without),
// the forward of fused training's MLP half (ops/mlp_vjp.py); or, with HAT's
// CAB join folded in (EXTRA),
//   x' = x + extra * escale (escale per channel, one fused multiply-add),
//   y = x' + fc2(gelu(fc1(LN x'))),
// the residual the f32 x'.
//
// Replaces studiosr_tpu/ops/pallas/swin_block.py::fused_mlp_block (:904,
// _mlp_kernel at :882) in f32, both variants: the dtype SwinFIR's recipe
// trains in (36 launches a SwinFIR step; SwinIR's, HAT's and MaxSR's f32
// steps and checks take it too); bf16 runs mlp_block_mma.cu, other widths
// mlp_block.cu. The contract is the TPU kernel's with T = f32: products
// accumulate in f32, LN statistics in f32, b2, d and the residual added in
// f32. GELU is h Phi(h), Phi from am_gauss (am_common.cuh): the exact erf
// GELU to f32 accuracy (within 2.3e-7 of erff's Phi), as B7 in f32
// (mlp_bwd_f32.cu) recomputes it.
//
// Bound on the card at SwinFIR's step (R = 131,072 rows, C 180, hidden
// 360): 4 R C hidden = 34.0 GFLOP, 0.206 ms at 3xTF32 (0.508 on the FMA
// pipes), against 0.028 ms for x and y. mlp_block.cuh ran a 64-row tile a
// 256-thread block, fc1 and fc2 on the FMA pipes (4 x 4 outputs a thread, a
// barrier every 32-row weight chunk, the weights restaged from L2 for every
// tile). Here, three passes, the products 3xTF32 on the tensor cores
// (tf32x3.cuh):
// 0. mf32_ln_kernel, a warp a row: LN (with EXTRA, x' formed and kept);
// 1. g = gelu(LN W1 + b1), a row product on wgmma (tfw_gemm_kernel), GELU
//    in its epilogue, to rows of HP (hidden padded to 4, zero past it);
// 2. y = x + d (g W2 + b2), a row product on wgmma, x (x') read into
//    shared memory under the last products (TfResid).
// The activation goes through device memory: a launch moves about 0.85 GB
// (0.25 ms at 3.35 TB/s), which the products of other blocks hide; kept on
// the chip it would be the register A operand of fc2 as in mlp_block_mma.cu,
// which in f32 needs a 64 x 184 fresh and running accumulator pair beside
// fc1's (more than a thread's 255 registers at one warpgroup a tile). What
// bounds the two products (scripts/torch_ablate_f32_fwd.py): as B5's, their
// stage loop and not the tensor pipes.
// The weights change every step, so they are packed per call (tfw_pack: a
// gather by the index table of ops/cuda/mlp_block.py _f32_pack_index and the
// split into hi and lo images: W1 (C x HP) and W2 (HP x C)).
// Takes f32, C a multiple of 4 up to 256, hidden up to 512; the wrapper
// routes anything else.
#include "mf32_mlp.cuh"

// Elements of the packed weights (ops/cuda/mlp_block.py checks its own count
// against it), or -1 for a geometry the kernels do not take.
extern "C" long long mlp_block_mma_f32_pack_elems(int C, int hidden) {
  return mf32_geometry_ok(C, hidden) ? Mf32Geom(C, hidden).pack_elems() : -1;
}

extern "C" long long mlp_block_mma_f32_scratch(int rows, int C, int hidden, int extra) {
  return mf32_scratch(rows, C, hidden, extra != 0).f_elems;
}

extern "C" int mlp_block_mma_f32(const void* x, void* out, int rows, int C, int hidden, const void* ln_w,
                                 const void* ln_b, const void* w1, const void* b1, const void* w2, const void* b2,
                                 const void* dp, int rows_per_sample, const void* pack_index, long long pack_elems,
                                 void* fscratch, long long f_elems, void* stream) {
  return mf32_run<false>(x, nullptr, nullptr, out, rows, C, hidden, ln_w, ln_b, w1, b1, w2, b2, dp, rows_per_sample,
                         pack_index, pack_elems, fscratch, f_elems, stream);
}

// HAT's CAB join folded in: y = x' + fc2(gelu(fc1(LN x'))), x' = x + extra * escale.
extern "C" int mlp_block_extra_mma_f32(const void* x, void* out, int rows, int C, int hidden, const void* ln_w,
                                       const void* ln_b, const void* w1, const void* b1, const void* w2,
                                       const void* b2, const void* extra, const void* escale,
                                       const void* pack_index, long long pack_elems, void* fscratch,
                                       long long f_elems, void* stream) {
  return mf32_run<true>(x, extra, escale, out, rows, C, hidden, ln_w, ln_b, w1, b1, w2, b2, nullptr, 0, pack_index,
                        pack_elems, fscratch, f_elems, stream);
}
