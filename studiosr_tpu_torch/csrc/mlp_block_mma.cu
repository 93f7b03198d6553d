// B6 in bf16, written for the H100: the MLP half of a Swin block over token
// rows,
//   y = x + d * fc2(gelu(fc1(LN x))),  d = dp[row / rows_per_sample] (1 without),
// the forward of fused training's MLP half (ops/mlp_vjp.py); or, with HAT's
// CAB join folded in (EXTRA, HAT serving at batch 1),
//   x' = x + extra * escale (escale per channel, f32, one fused multiply-add),
//   y = x' + fc2(gelu(fc1(LN x'))),
// the residual the f32 x', not a re-rounded one.
//
// Replaces studiosr_tpu/ops/pallas/swin_block.py::fused_mlp_block (:904,
// _mlp_kernel at :882) in bf16, both variants; f32 (SwinFIR's training
// recipe, which trains in f32, and the f32 checks) runs mlp_block_f32.cu,
// other widths keep mlp_block.cuh, and so does B10's MLP tail in f32
// (ocab.cu; in bf16 B10 runs this kernel, ocab_mma.cu). Rounding points as
// there: the LN output and the GELU output rounded to bf16; products
// accumulate in f32; LN statistics f32; b2, d and the residual added in f32.
// GELU is h Phi(h), Phi from am_gauss (am_common.cuh): the exact erf GELU to
// f32 accuracy (within 2.3e-7 of erff's Phi), as B7 evaluates it.
//
// Bound on the card: 4 R C hidden flops against the rows' traffic. At the
// training shapes (R = 131,072 rows, C 180, hidden 360) 34 GFLOP against 94
// MB: the tensor-core rate (0.034 ms). With EXTRA at HAT serving (65,536
// rows) 17.0 GFLOP against 70.8 MB: bytes (0.021 ms). mlp_block.cuh ran a
// 64-row tile a 256-thread block on wmma (gemm64), the weights packed on
// every launch and restaged from L2 in 32 x 64 chunks with a barrier each,
// the 64 x hidden activation staged in shared memory. Here, B1's MLP phase
// (swin_block_mma.cu) over 64-row tiles:
// * One warpgroup a tile, two a block, persistent over tile pairs (one block
//   an SM). The warpgroup's four warps normalise its 64 rows straight from
//   device memory (x' formed in f32 on the way) into a K-major LN tile in
//   shared memory, eight rows a warp at once so their loads overlap (0.268
//   ms on an H100 at the training shapes, against 0.295 with the LN as a
//   row pass before the kernel: scripts/torch_ablate_mlp_oca.py).
// * Per chunk of 64 hidden units: fc1 on wgmma (m64n64k16, A the LN tile, B
//   the chunk's fc1 columns), + b1, GELU and rounding in registers, the
//   result the register A operand of fc2's rows of the chunk (wgmma
//   m64nNPk16, NP 184 at C 180), which accumulate in registers over the
//   chunks. The activation never leaves the registers.
// * The weights stream through am_common.cuh's four-slot cp.async.bulk /
//   mbarrier ring from a blob in wgmma's K-major core-matrix image: per
//   chunk one stage of fc1 (KC x 64, 24 KB at KC 192) and one of fc2 (64 x
//   NP); the hidden units padded to whole chunks (360 -> 384), the padding
//   zero. Each staged byte serves the block's two tiles.
// * The epilogue loads the tile's x (and extra) at its accumulator
//   fragments' positions, all before its first store, adds b2, d or x', and
//   writes the rounded rows.
// Training packs the weights on every call (one gather by the index table of
// ops/cuda/mlp_block.py _mma_pack_index, am_pack_kernel); HAT serving packs
// them once, at load time (pack_mlp_block). Takes bf16, C a multiple of 4
// up to 184, hidden up to 512 (MF_MAX_HIDDEN); the wrapper routes anything else.
// The kernel and its launch live in mf_mlp.cuh (B10's MLP tail runs them too).
#include "mf_mlp.cuh"

// Elements of the packed weights (ops/cuda/mlp_block.py checks its own count
// against it), or -1 for a geometry the kernel does not take.
extern "C" long long mlp_block_mma_pack_elems(int C, int hidden) {
  return mf_geometry_ok(C, hidden) ? MfGeom(C, hidden).pack_elems() : -1;
}

extern "C" int mlp_block_mma_bf16(const void* x, void* out, int rows, int C, int hidden, const void* ln_w,
                                  const void* ln_b, const void* w1, const void* b1, const void* w2, const void* b2,
                                  const void* dp, int rows_per_sample, const void* pack_index, const void* packed,
                                  long long pack_elems, void* scratch, void* stream) {
  return mf_run<false>(x, nullptr, out, rows, C, hidden, ln_w, ln_b, w1, b1, w2, b2, dp, rows_per_sample, nullptr,
                       (const int*)pack_index, packed, pack_elems, scratch, stream);
}

// HAT's CAB join folded in: y = x' + fc2(gelu(fc1(LN x'))), x' = x + extra * escale.
extern "C" int mlp_block_extra_mma_bf16(const void* x, void* out, int rows, int C, int hidden, const void* ln_w,
                                        const void* ln_b, const void* w1, const void* b1, const void* w2,
                                        const void* b2, const void* extra, const void* escale,
                                        const void* pack_index, const void* packed, long long pack_elems,
                                        void* scratch, void* stream) {
  return mf_run<true>(x, extra, out, rows, C, hidden, ln_w, ln_b, w1, b1, w2, b2, nullptr, 0, escale,
                      (const int*)pack_index, packed, pack_elems, scratch, stream);
}
