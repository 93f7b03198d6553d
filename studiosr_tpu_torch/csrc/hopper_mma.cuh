// Register-tile primitives of the bf16 kernels redesigned for the H100 (B2's
// conv3x3_mma.cuh, B15's window_attn.cu): mma.sync m16n8k16 with f32
// accumulators, ldmatrix (plain and transposed, two or four 8 x 8 tiles),
// cp.async of 4, 8 or 16 bytes that zero-fills what it does not read, and a
// cp.async wait on a count known only at run time.
//
// Fragment layout of hm_mma for lane = 4 g + t: a = {(g, 2t..), (g + 8,
// 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)} of a 16 x 16 row-major tile; b =
// {(k 2t.., n g), (k 2t + 8.., n g)} of a 16 x 8 tile; d = {(g, 2t), (g,
// 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
#pragma once

#include <type_traits>

#include "common.cuh"

__device__ __forceinline__ void hm_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t hm_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned hm_smem(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// Four 8 x 8 bf16 tiles; lane l gives the address of row l % 8 of tile l / 8.
__device__ __forceinline__ void hm_ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(hm_smem(p)));
}

__device__ __forceinline__ void hm_ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(hm_smem(p)));
}

// Two tiles: lanes 0-15 give the row addresses (the others are ignored).
__device__ __forceinline__ void hm_ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n" : "=r"(r0), "=r"(r1) : "r"(hm_smem(p)));
}

// Copy BYTES (4, 8 or 16) from global src to shared dst, or write BYTES of
// zeros when !valid (src is then not read, but must be a valid address).
template <int BYTES>
__device__ __forceinline__ void hm_cp_async(void* dst, const void* src, bool valid) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hm_smem(dst)), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(hm_smem(dst)), "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void hm_cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most n of this thread's most recent cp.async groups are
// pending (every older group complete). n above 7 waits for all but 7,
// which is never too little.
__device__ __forceinline__ void hm_cp_wait_upto(int n) {
  switch (n < 0 ? 0 : n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// The widest copy (16, 8, 4 or 2 bytes) that keeps every piece of a row of
// bf16 tensor `base` aligned: the row length, each stride (elements) and the
// base address must all be multiples of it.
__host__ inline int hm_copy_width(const void* base, int row_elems, const long long* strides, int nstrides) {
  for (int w = 16; w > 2; w /= 2) {
    bool ok = (uintptr_t)base % w == 0 && (row_elems * 2) % w == 0;
    for (int i = 0; i < nstrides; ++i) ok = ok && (strides[i] * 2) % w == 0;
    if (ok) return w;
  }
  return 2;
}
