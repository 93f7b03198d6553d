// The shared pieces of the bf16 kernels written for the H100 around window
// attention, the MLP half and the OCA core (attn_bwd_mma.cu: B8 / B9;
// window_attention_mma.cu: B5; mlp_bwd_mma.cu: B7; mlp_block_mma.cu: B6;
// oca_bwd_mma.cu: B13): the wgmma widths they add to wgmma.cuh, the K-major
// core-matrix image every wgmma operand is laid out in (am_kmajor, mirrored
// by the packers in ops/cuda/), a weight ring fed by cp.async.bulk through
// mbarriers, the GELU's Phi without branches (am_gauss), the token-contiguous
// copy of K-major tiles (am_transpose), the row passes (LN, the LN backward)
// a warp a row, a product per 64-row tile with the weights streamed through
// the ring (am_rowgemm_kernel), the weight gradients on wgmma with every
// partial summed in a fixed order (am_wgrad), and the gather that packs
// weights by an index table (am_pack_kernel).
#pragma once

#include "hopper_mma.cuh"
#include "wgmma.cuh"
#include "wgrad.cuh"

using bf16 = __nv_bfloat16;

// Products of width C 180 (184) and the weight gradients' (192); wgmma.cuh
// has the register-A form of the first.
template <>
__device__ __forceinline__ void wg_ss<184>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %94, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n184k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91}, %92, %93, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91])
      : "l"(da), "l"(db), "r"(scale_d));
}


template <>
__device__ __forceinline__ void wg_ss<192>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

constexpr int AM_TOK = 64;      // a tile's tokens; a chunk's queries or keys
constexpr int AM_SLOTS = 4;     // ring slots
constexpr int AM_SLOT_BYTES = 24576;  // bytes a slot (a stage's most)
constexpr int AM_KROWS = 96;    // K rows of a projection stage
constexpr int AM_MAX_STAGES = 64;
constexpr int AM_HEAD_BYTES = 384;  // the ring's barriers (64 B) and stage table, 128-byte padded
constexpr int AM_KSTAGE = 64;   // K rows of a weight stage of am_rowgemm_kernel
constexpr int AM_ABUF = 4;      // am_rowgemm_kernel: A chunk buffers a warpgroup (AM_ABUF - 1 in flight)
constexpr int AM_MAX_C = 184;
constexpr float AM_LOG2E = 1.4426950408889634f;

__host__ __device__ inline int am_pad16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline int am_min(int a, int b) { return a < b ? a : b; }
// Product width for n columns (n at most 184): the wgmma widths the kernels have.
__host__ __device__ inline int am_np(int C) {
  return C <= 16 ? 16 : C <= 32 ? 32 : C <= 48 ? 48 : C <= 64 ? 64 : C <= 96 ? 96 : C <= 128 ? 128 : 184;
}
// Element (k, n) of a K-major operand image with `rows` K rows: core
// matrices of 8 n x 8 k, k-groups 64 elements apart (LBO 128 bytes),
// n-groups rows * 8 elements apart (SBO rows * 16 bytes). An A operand (m, k)
// is am_kmajor(k, m, K).
__host__ __device__ inline int am_kmajor(int k, int n, int rows) {
  return (n / 8) * rows * 8 + (k / 8) * 64 + (n % 8) * 8 + k % 8;
}

// -- mbarriers, the bulk copy and the ring ------------------------------------------

__device__ __forceinline__ void am_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(hm_smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ bool am_bar_try(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(hm_smem(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity`; traps after about ten seconds, so
// a fault in the ring ends the launch with an error instead of hanging.
__device__ __forceinline__ void am_bar_wait(uint64_t* bar, int parity) {
  if (am_bar_try(bar, parity)) return;
  const long long start = clock64();
  while (!am_bar_try(bar, parity))
    if (clock64() - start > 20000000000LL) __trap();
}

__device__ __forceinline__ void am_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(hm_smem(bar)) : "memory");
}

__device__ __forceinline__ void am_bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(hm_smem(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   hm_smem(dst)),
               "l"(src), "r"(bytes), "r"(hm_smem(bar))
               : "memory");
}

// A warp's view of the weight ring: stage j (of nst, repeating) is the
// elements off[j] .. off[j + 1] of w (a table in shared memory). Thread 0 of
// the block is also the producer: on acquiring stage i it issues stage
// i + AM_SLOTS - 1, once every warp has released that slot.
struct AmRing {
  unsigned char* slots;
  uint64_t *full, *empty;
  const int* off;
  const bf16* w;
  int nst, total;
  int i, slot, phase;
  __device__ void issue(int k) {
    const int j = k % nst, sl = k % AM_SLOTS;
    am_bar_wait(&empty[sl], ((k / AM_SLOTS) & 1) ^ 1);
    am_bulk_load(slots + (size_t)sl * AM_SLOT_BYTES, w + off[j], 2 * (off[j + 1] - off[j]), &full[sl]);
  }
  __device__ const bf16* acquire() {
    if (threadIdx.x == 0 && i + AM_SLOTS - 1 < total) issue(i + AM_SLOTS - 1);
    __syncwarp();
    am_bar_wait(&full[slot], phase);
    return (const bf16*)(slots + (size_t)slot * AM_SLOT_BYTES);
  }
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) am_bar_arrive(&empty[slot]);
    ++i;
    if (++slot == AM_SLOTS) slot = 0, phase ^= 1;
  }
};

// The ring at the start of shared memory (AM_SLOTS slots, then AM_HEAD_BYTES
// of barriers and the stage table, filled by thread 0 from `elems(j)`, the
// elements of stage j), for `warps` consumer warps; the first stages
// issued. Call with every thread, before any acquire.
template <typename F>
__device__ inline AmRing am_ring_start(unsigned char* smem, const bf16* w, int nst, int total, int warps, F elems) {
  uint64_t* bars = (uint64_t*)(smem + AM_SLOTS * AM_SLOT_BYTES);
  int* off = (int*)(smem + AM_SLOTS * AM_SLOT_BYTES + 64);
  if (threadIdx.x == 0) {
    for (int i = 0; i < AM_SLOTS; ++i) am_bar_init(&bars[i], 1), am_bar_init(&bars[AM_SLOTS + i], warps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    off[0] = 0;
    for (int j = 0; j < nst; ++j) off[j + 1] = off[j] + elems(j);
  }
  __syncthreads();
  AmRing r{smem, bars, bars + AM_SLOTS, off, w, nst, total, 0, 0, 0};
  if (threadIdx.x == 0)
    for (int k = 0; k < AM_SLOTS - 1 && k < total; ++k) r.issue(k);
  return r;
}

// -- helpers ------------------------------------------------------------------------

__device__ __forceinline__ float am_quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float am_quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float am_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float am_round(float v) { return __bfloat162float(__float2bfloat16(v)); }

// Four 8 x 8 bf16 tiles from registers, each stored transposed: lane l gives
// the address of row l % 8 of tile l / 8, which receives column l % 8.
__device__ __forceinline__ void am_stsm_x4_t(void* p, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n" ::"r"(hm_smem(p)), "r"(r0),
               "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ void am_wg_sync(int wg) { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); }
// The rows of a 64-row tile of a row-major bf16 scratch (SC columns a row,
// SC a multiple of 8) into a K-major tile of KC columns (zero past SC), one
// cp.async group of the warpgroup's threads.
__device__ __forceinline__ void am_load_rows(int KC, int SC, const bf16* rows, int tile, bool valid, bf16* tileb) {
  const int KG = KC / 8, SG = SC / 8;
  for (int i = threadIdx.x & 127; i < AM_TOK * KG; i += 128) {
    const int t = i / KG, kg = i - t * KG;
    const bool in = valid && kg < SG;
    hm_cp_async<16>(tileb + am_kmajor(8 * kg, t, KC), in ? rows + ((long long)tile * AM_TOK + t) * SC + 8 * kg : rows,
                    in);
  }
}

// The standard normal's cdf Phi(h) and density phi(h), without branches:
// Phi from erfc(|h| / sqrt 2) by Numerical Recipes' erfcc (fractional error
// below 1.2e-7 everywhere; in f32 Phi is within 2.3e-7 of the exact value,
// and keeps its relative accuracy in the lower tail, where 1 + erf(x)
// cancels), its e^(-h^2 / 2) shared with phi. GELU is h Phi(h), its
// derivative Phi(h) + h phi(h): the exact erf GELU to f32 accuracy, at a
// third of erff's and expf's instructions (the epilogue bounds
// mlp_bwd_mma.cu's pass 1; mlp_block_mma.cu's GELU is h Phi(h) as well).
__device__ __forceinline__ void am_gauss(float h, float& cdf, float& pdf) {
  const float z = fabsf(h) * 0.70710678118654752f, t = __fdividef(1.f, fmaf(0.5f, z, 1.f));
  float p = 0.17087277f;
  p = fmaf(p, t, -0.82215223f);
  p = fmaf(p, t, 1.48851587f);
  p = fmaf(p, t, -1.13520398f);
  p = fmaf(p, t, 0.27886807f);
  p = fmaf(p, t, -0.18628806f);
  p = fmaf(p, t, 0.09678418f);
  p = fmaf(p, t, 0.37409196f);
  p = fmaf(p, t, 1.00002368f);
  p = fmaf(p, t, -1.26551223f);
  const float e = __expf(-z * z), half = 0.5f * t * e * __expf(p);  // e^(-h^2/2); erfc(z) / 2
  cdf = h >= 0.f ? 1.f - half : half;
  pdf = 0.39894228040143268f * e;
}

// The token-contiguous copy of `chunks` 64 x DP K-major chunks: core matrix
// (token group tg, column group jg) of a chunk goes, transposed, to core
// matrix (jg, tg) of the same chunk laid out as am_kmajor(t, j, 64). The
// block's warps share the work, four core matrices an ldmatrix / stmatrix.
template <int DP>
__device__ __forceinline__ void am_transpose(const bf16* src, bf16* dst, int chunks, int warps) {
  constexpr int JG = DP / 8, GROUPS = 8 * JG / 4;  // x4 groups a chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, mi = lane >> 3, rho = lane & 7;
  for (int q = warp; q < chunks * GROUPS; q += warps) {
    const int c = q / GROUPS, core = (q % GROUPS) * 4 + mi, tg = core / JG, jg = core % JG;
    const bf16* s = src + c * AM_TOK * DP + tg * DP * 8 + jg * 64 + rho * 8;
    bf16* d = dst + c * AM_TOK * DP + jg * 512 + tg * 64 + rho * 8;
    uint32_t r0, r1, r2, r3;
    hm_ldsm_x4(r0, r1, r2, r3, s);
    am_stsm_x4_t(d, r0, r1, r2, r3);
  }
}

// -- the row passes, a warp a row ----------------------------------------------------

// LN of one row (eps 1e-5, f32 statistics) into scratch rows of SC columns
// (zero past C), rounded; in the backward (BWD) also g_b = dd g, rounded,
// and (mean, rstd) to stats[0], stats[1]. Lane l takes the 4-column pieces
// l, l + 32 (C a multiple of 4, at most 184).
template <bool BWD>
__device__ __forceinline__ void am_ln_row(const bf16* xr, const bf16* gr, float dd, int C, int SC, const float* ln_w,
                                          const float* ln_b, float* stats, bf16* lnr, bf16* gbr) {
  const int lane = threadIdx.x & 31, NPC = SC / 4;
  float v[2][4], gv[2][4], s = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = 4 * (lane + 32 * j);
    uint2 ux = make_uint2(0u, 0u), ug = make_uint2(0u, 0u);
    if (c < C) {
      ux = *reinterpret_cast<const uint2*>(xr + c);
      if (BWD) ug = *reinterpret_cast<const uint2*>(gr + c);
    }
    const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ux.x));
    const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ux.y));
    const float2 g0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ug.x));
    const float2 g1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ug.y));
    v[j][0] = x0.x, v[j][1] = x0.y, v[j][2] = x1.x, v[j][3] = x1.y;
    gv[j][0] = g0.x, gv[j][1] = g0.y, gv[j][2] = g1.x, gv[j][3] = g1.y;
    s += v[j][0] + v[j][1] + v[j][2] + v[j][3];
  }
  const float mean = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (4 * (lane + 32 * j) < C)
#pragma unroll
      for (int e = 0; e < 4; ++e) q += (v[j][e] - mean) * (v[j][e] - mean);
  const float rstd = rsqrtf(warp_sum(q) / C + 1e-5f);
  if (BWD && lane == 0) stats[0] = mean, stats[1] = rstd;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int pc = lane + 32 * j, c = 4 * pc;
    if (pc >= NPC) continue;
    uint32_t lo[2], go[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c0 = c + 2 * e;
      const bool in = c0 < C;  // C is a multiple of 4: a pair is in or out whole
      lo[e] = hm_pack(in ? (v[j][2 * e] - mean) * rstd * __ldg(ln_w + c0) + __ldg(ln_b + c0) : 0.f,
                      in ? (v[j][2 * e + 1] - mean) * rstd * __ldg(ln_w + c0 + 1) + __ldg(ln_b + c0 + 1) : 0.f);
      go[e] = hm_pack(dd * gv[j][2 * e], dd * gv[j][2 * e + 1]);
    }
    *reinterpret_cast<uint2*>(lnr + c) = make_uint2(lo[0], lo[1]);
    if (BWD) *reinterpret_cast<uint2*>(gbr + c) = make_uint2(go[0], go[1]);
  }
}

// The LN backward of one row and its dx, dx = g_b + rstd (dxhat - mean(dxhat)
// - xhat mean(dxhat xhat)) + (1 - d) g with dxhat = dln s and g_b = d g
// rounded; this row's dln xhat and dln are added to the lane's column-pair
// sums cs. Lane l takes the column pairs l, l + 32, l + 64.
__device__ __forceinline__ void am_lnb_row(const float* dlr, const bf16* xr, const bf16* gr, bf16* dxr, float mean,
                                           float rstd, float dd, int C, const float* ln_w, float (&cs)[3][4]) {
  const int lane = threadIdx.x & 31;
  float2 dl[3], xh[3], gv[3], w[3];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int c = 2 * (lane + 32 * j);
    dl[j] = xh[j] = gv[j] = w[j] = make_float2(0.f, 0.f);
    if (c < C) {
      dl[j] = *reinterpret_cast<const float2*>(dlr + c);
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + c));
      gv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gr + c));
      w[j] = make_float2(__ldg(ln_w + c), __ldg(ln_w + c + 1));
      xh[j] = make_float2((xv.x - mean) * rstd, (xv.y - mean) * rstd);
    }
    const float d0 = dl[j].x * w[j].x, d1 = dl[j].y * w[j].y;
    s1 += d0 + d1;
    s2 += d0 * xh[j].x + d1 * xh[j].y;
    cs[j][0] += dl[j].x * xh[j].x, cs[j][1] += dl[j].y * xh[j].y, cs[j][2] += dl[j].x, cs[j][3] += dl[j].y;
  }
  const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int c = 2 * (lane + 32 * j);
    if (c >= C) continue;
    const float y0 = am_round(dd * gv[j].x) + (dl[j].x * w[j].x - m1 - xh[j].x * m2) * rstd + (1.f - dd) * gv[j].x;
    const float y1 = am_round(dd * gv[j].y) + (dl[j].y * w[j].y - m1 - xh[j].y * m2) * rstd + (1.f - dd) * gv[j].y;
    *reinterpret_cast<__nv_bfloat162*>(dxr + c) = __floats2bfloat162_rn(y0, y1);
  }
}

// A 256-thread block's column sums of dln xhat and dln (each warp's cs, the
// warps added in order) to out[0 .. 2C); `sums` is the block's shared
// 8 x 2 AM_MAX_C scratch. Call with every thread of the block.
__device__ __forceinline__ void am_lnb_sums(const float (&cs)[3][4], int C, float (*sums)[2 * AM_MAX_C], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int c = 2 * (lane + 32 * j);
    if (c < C) {
      sums[warp][c] = cs[j][0], sums[warp][c + 1] = cs[j][1];
      sums[warp][C + c] = cs[j][2], sums[warp][C + c + 1] = cs[j][3];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += 256) {
    float v = 0.f;
    for (int wi = 0; wi < 8; ++wi) v += sums[wi][i];
    out[i] = v;
  }
}

// -- a product per 64-row tile, the weights streamed ---------------------------------

// acc (64 x NP, f32) = A's tile (64 rows of K columns, lda apart) x B, B the
// weights at w in stages of AM_KSTAGE K rows, each the K-major image of its
// rows x NP (K a multiple of 16).
struct AmRowGemm {
  const bf16* A;
  const bf16* w;
  int lda, K, tiles;
  __host__ __device__ int stages() const { return (K + AM_KSTAGE - 1) / AM_KSTAGE; }
  __host__ __device__ int rows(int s) const { return am_min(AM_KSTAGE, K - AM_KSTAGE * s); }
};

// The ring, its barriers and stage table, and each warpgroup's AM_ABUF A
// chunk buffers (K-major, 64 rows x 64 K).
__host__ __device__ inline size_t am_rowgemm_smem() {
  return (size_t)AM_SLOTS * AM_SLOT_BYTES + AM_HEAD_BYTES + 2 * (size_t)AM_ABUF * AM_TOK * AM_KSTAGE * 2;
}

// One warpgroup a tile, two a block, persistent over tile pairs: the tile's
// A rows by cp.async in 64-column chunks (AM_ABUF - 1 in flight), B through
// the ring. epi(tile, r0, tq, acc) takes each thread's accumulator whole:
// acc[nt][2 hh + e] is row r0 + 8 hh, column 8 nt + 2 tq + e of the tile, so
// an epilogue can issue all its loads before its first store.
template <int NP, typename Epi>
__global__ void __launch_bounds__(256, 1) am_rowgemm_kernel(const AmRowGemm q, const Epi epi) {
  constexpr int NT = NP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int wg = warp >> 2, wr = warp & 3, wt = tid & 127;
  bf16* Ab = (bf16*)(smem + AM_SLOTS * AM_SLOT_BYTES + AM_HEAD_BYTES) + (size_t)wg * AM_ABUF * AM_TOK * AM_KSTAGE;
  const int npairs = (q.tiles + 1) / 2, nst = q.stages();
  const int pairs = blockIdx.x < npairs ? (npairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  AmRing ring = am_ring_start(smem, q.w, nst, nst * pairs, 8, [&](int j) { return q.rows(j) * NP; });
  for (int p = blockIdx.x; p < npairs; p += gridDim.x) {
    const int tile = 2 * p + wg;
    const bool valid = tile < q.tiles;
    const bf16* src = q.A + (long long)tile * AM_TOK * q.lda;
    // K chunk s of the tile's A rows into buffer s % AM_ABUF, one cp.async group
    auto load = [&](int s) {
      if (valid && s < nst) {
        const int kr = q.rows(s), KG = kr / 8;
        bf16* dst = Ab + (s % AM_ABUF) * AM_TOK * AM_KSTAGE;
        for (int i = wt; i < AM_TOK * KG; i += 128) {
          const int t = i / KG, kg = i - t * KG;
          hm_cp_async<16>(dst + am_kmajor(8 * kg, t, kr), src + (long long)t * q.lda + AM_KSTAGE * s + 8 * kg, true);
        }
      }
      hm_cp_commit();
    };
    am_wg_sync(wg);  // the warpgroup's last products are done with its buffers
    for (int s = 0; s < AM_ABUF - 1; ++s) load(s);
    float acc[NT][4];
    for (int s = 0; s < nst; ++s) {
      load(s + AM_ABUF - 1);
      hm_cp_wait_upto(AM_ABUF - 1);
      wg_proxy_fence();
      am_wg_sync(wg);  // chunk s is in
      const bf16* bs = ring.acquire();
      const bf16* As = Ab + (s % AM_ABUF) * AM_TOK * AM_KSTAGE;
      const int kr = q.rows(s);
      wg_fence();
      for (int kk = 0; kk < kr; kk += 16)
        wg_ss<NP>(&acc[0][0], wg_desc(As + kk * 8, 128, kr * 16), wg_desc(bs + kk * 8, 128, kr * 16), s > 0 || kk > 0);
      wg_commit();
      wg_wait0();
      wg_hold<NT * 4>(&acc[0][0]);
      ring.release();
      am_wg_sync(wg);  // every warp is done with buffer s % AM_ABUF
    }
    if (!valid) continue;
    epi(tile, 16 * wr + gq, tq, acc);
  }
}

template <int NP, typename Epi>
static cudaError_t am_rowgemm_launch(const AmRowGemm& q, const Epi& epi, int blocks, cudaStream_t stream) {
  const size_t bytes = am_rowgemm_smem();
  cudaError_t err = allow_smem(am_rowgemm_kernel<NP, Epi>, bytes);
  if (err != cudaSuccess) return err;
  am_rowgemm_kernel<NP, Epi><<<blocks, 256, bytes, stream>>>(q, epi);
  return cudaGetLastError();
}

// The product at the width am_np gives for `np` columns, on `blocks` blocks.
template <typename Epi>
static cudaError_t am_rowgemm(const AmRowGemm& q, int np, const Epi& epi, int blocks, cudaStream_t stream) {
  switch (am_np(np)) {
    case 16: return am_rowgemm_launch<16>(q, epi, blocks, stream);
    case 32: return am_rowgemm_launch<32>(q, epi, blocks, stream);
    case 48: return am_rowgemm_launch<48>(q, epi, blocks, stream);
    case 64: return am_rowgemm_launch<64>(q, epi, blocks, stream);
    case 96: return am_rowgemm_launch<96>(q, epi, blocks, stream);
    case 128: return am_rowgemm_launch<128>(q, epi, blocks, stream);
    default: return am_rowgemm_launch<184>(q, epi, blocks, stream);
  }
}

// The epilogue that stores a product's first C columns in f32 to token rows
// (row tile * 64 + r, C apart).
struct AmStoreF32 {
  float* out;
  int C;
  template <int NT>
  __device__ __forceinline__ void operator()(int tile, int r0, int tq, const float (&acc)[NT][4]) const {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tq;
      if (c >= C) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(out + ((long long)tile * AM_TOK + r0 + 8 * hh) * C + c) =
            make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
    }
  }
};

// -- packing by an index table --------------------------------------------------------

// out[i] = the element at flat index idx[i] of a (na elements) and b (nb
// elements) laid end to end, or 0 at an index past both.
__global__ void am_pack_kernel(const bf16* __restrict__ a, long long na, const bf16* __restrict__ b, long long nb,
                               const int* __restrict__ idx, long long n, bf16* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const long long k = idx[i];
    out[i] = k < na ? a[k] : (k < na + nb ? b[k - na] : __float2bfloat16(0.f));
  }
}

static cudaError_t am_pack(const bf16* a, long long na, const bf16* b, long long nb, const int* idx, long long n,
                           bf16* out, cudaStream_t stream) {
  am_pack_kernel<<<(int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024), 256, 0, stream>>>(a, na, b, nb, idx, n, out);
  return cudaGetLastError();
}

static cudaError_t am_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// -- the weight gradients -------------------------------------------------------------

// dW (M x N) = A^T B over K token rows (A: K x M, B: K x N, row-major bf16,
// strides multiples of 8) and the column sums of B, on wgmma. A block of
// three warpgroups owns a 192 x 192 tile of dW and a range of K (split-K: each
// range an f32 partial of its own, summed afterwards in a fixed order). Per
// 64-row K chunk: cp.async of the A and B rows into a staging buffer (the
// next chunk in flight), ldmatrix + stmatrix.trans into K-major images
// (tokens contiguous), and four m64n192k16 products a warpgroup. At M 180 a
// tile holds all of dW's rows, so B is read once and A once for each column
// tile. Columns
// past M or N of the last tiles are read as they lie (the caller leaves
// 2 WG_BM elements of slack after the last matrix) and dropped.
constexpr int AW_WGS = 3, AW_THREADS = 128 * AW_WGS, AW_M = 64 * AW_WGS, AW_N = 192, AW_K = 64, AW_LA = AW_M + 8, AW_LB = AW_N + 8;

struct AwSmem {
  static constexpr size_t sa = (size_t)AW_K * AW_LA * 2, sb = (size_t)AW_K * AW_LB * 2;
  static constexpr size_t ia = (size_t)AW_M * AW_K * 2, ib = (size_t)AW_N * AW_K * 2;
  static constexpr size_t total = 2 * (sa + sb) + ia + ib;
};

struct AwPlan {
  int mt, nt, splits, krows;
  long long part_elems;  // splits x M x N, then splits x N column sums
};

static AwPlan aw_plan(long long K, int M, int N, int sms) {
  AwPlan p;
  p.mt = (M + AW_M - 1) / AW_M, p.nt = (N + AW_N - 1) / AW_N;
  const long long chunks = K / AW_K;
  long long s = (sms + p.mt * p.nt - 1) / (p.mt * p.nt);
  if (s > chunks) s = chunks;
  if (s < 1) s = 1;
  p.krows = (int)((chunks + s - 1) / s) * AW_K;
  p.splits = (int)((K + p.krows - 1) / p.krows);
  p.part_elems = (long long)p.splits * M * N + (long long)p.splits * N;
  return p;
}

__global__ void __launch_bounds__(AW_THREADS, 1) am_wgrad_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B,
                                                         int ldb, long long K, int M, int N, int krows,
                                                         float* __restrict__ part, float* __restrict__ colpart) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stA = (bf16*)smem;                            // [2][64][AW_LA]
  bf16* stB = (bf16*)(smem + 2 * AwSmem::sa);         // [2][64][AW_LB]
  bf16* imA = (bf16*)(smem + 2 * (AwSmem::sa + AwSmem::sb));  // am_kmajor(t, m, 64)
  bf16* imB = imA + AW_M * AW_K;                      // am_kmajor(t, n, 64)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int wg = warp >> 2, wr = warp & 3;
  const int m0 = blockIdx.x * AW_M, n0 = blockIdx.y * AW_N, s = blockIdx.z;
  const long long kb = (long long)s * krows;
  const int nch = (int)(((kb + krows < K ? kb + krows : K) - kb) / AW_K);
  const bool sums = blockIdx.x == 0 && colpart != nullptr;
  auto stage = [&](int j) {
    if (j < nch) {
      bf16* sa = stA + (j & 1) * AW_K * AW_LA;
      bf16* sb = stB + (j & 1) * AW_K * AW_LB;
      const long long k0 = kb + (long long)j * AW_K;
      for (int i = tid; i < AW_K * (AW_M + AW_N) / 8; i += AW_THREADS) {
        if (i < AW_K * AW_M / 8) {
          const int t = i / (AW_M / 8), q = i % (AW_M / 8);
          hm_cp_async<16>(sa + t * AW_LA + 8 * q, A + (k0 + t) * lda + m0 + 8 * q, true);
        } else {
          const int i2 = i - AW_K * AW_M / 8, t = i2 / (AW_N / 8), q = i2 % (AW_N / 8);
          hm_cp_async<16>(sb + t * AW_LB + 8 * q, B + (k0 + t) * ldb + n0 + 8 * q, true);
        }
      }
    }
    hm_cp_commit();
  };
  float acc[AW_N / 8][4];
  float colsum = 0.f;
  stage(0);
  for (int j = 0; j < nch; ++j) {
    stage(j + 1);
    hm_cp_wait_upto(1);
    __syncthreads();  // chunk j is staged; the last products are done with the images
    const bf16* sa = stA + (j & 1) * AW_K * AW_LA;
    const bf16* sb = stB + (j & 1) * AW_K * AW_LB;
    {
      const int mi = lane >> 3, rho = lane & 7;
      // core matrices (token group tg, column group cg): AW_M of A, AW_N of B
      for (int q = warp; q < (AW_M + AW_N) / 4; q += 4 * AW_WGS) {
        const int core = 4 * q + mi, tg = core & 7, cg = core >> 3;
        const bool ina = cg < AW_M / 8;
        const int cc = ina ? cg : cg - AW_M / 8;
        const bf16* src = ina ? sa + (8 * tg + rho) * AW_LA + 8 * cc : sb + (8 * tg + rho) * AW_LB + 8 * cc;
        bf16* dst = (ina ? imA : imB) + cc * 512 + tg * 64 + rho * 8;
        uint32_t r0, r1, r2, r3;
        hm_ldsm_x4(r0, r1, r2, r3, src);
        am_stsm_x4_t(dst, r0, r1, r2, r3);
      }
    }
    if (sums && tid < AW_N)
      for (int t = 0; t < AW_K; ++t) colsum += __bfloat162float(sb[t * AW_LB + tid]);
    wg_proxy_fence();
    __syncthreads();
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < AW_K / 16; ++ks)
      wg_ss<AW_N>(&acc[0][0], wg_desc(imA + wg * 8 * 512 + ks * 128, 128, 1024), wg_desc(imB + ks * 128, 128, 1024),
                  j > 0 || ks > 0);
    wg_commit();
    wg_wait0();
    wg_hold<AW_N / 2>(&acc[0][0]);
  }
  float* out = part + (size_t)s * M * N;
#pragma unroll
  for (int nt = 0; nt < AW_N / 8; ++nt) {
    const int n = n0 + nt * 8 + 2 * tq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + 64 * wg + 16 * wr + gq + 8 * hh;
      if (m < M && n < N) {
        const float v0 = nch > 0 ? acc[nt][2 * hh] : 0.f, v1 = nch > 0 ? acc[nt][2 * hh + 1] : 0.f;
        if (n + 1 < N) *reinterpret_cast<float2*>(out + (size_t)m * N + n) = make_float2(v0, v1);
        else out[(size_t)m * N + n] = v0;
      }
    }
  }
  if (sums && tid < AW_N && n0 + tid < N) colpart[(size_t)s * N + n0 + tid] = colsum;
}

// dw (M x N) = A^T B over K rows and, when db is not null, db = the column
// sums of B; `part` holds aw_plan(K, M, N, sms).part_elems floats.
static cudaError_t am_wgrad(const bf16* A, int lda, const bf16* B, int ldb, long long K, int M, int N, float* dw,
                            float* db, float* part, int sms, cudaStream_t stream) {
  if (lda % 8 || ldb % 8 || K % AW_K) return cudaErrorInvalidValue;
  const AwPlan p = aw_plan(K, M, N, sms);
  float* colpart = part + (size_t)p.splits * M * N;
  cudaError_t err = allow_smem(am_wgrad_kernel, AwSmem::total);
  if (err != cudaSuccess) return err;
  am_wgrad_kernel<<<dim3(p.mt, p.nt, p.splits), AW_THREADS, AwSmem::total, stream>>>(A, lda, B, ldb, K, M, N, p.krows, part,
                                                                              db ? colpart : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = reduce_parts(part, p.splits, (long long)M * N, dw, stream);
  if (err != cudaSuccess || !db) return err;
  return reduce_parts(colpart, p.splits, N, db, stream);
}
