// B8 and B9 in bf16, written for the H100: the backward of the attention
// half of a Swin block with the forward recomputed,
//   y = x + d_b * proj(WA(LN x))  on (B, H, W, C) maps,
// window attention over 8 x 8 (B8, SwinIR) or 16 x 16 (B9, HAT) windows,
// the shift folded into reads and writes. From x and the cotangent g it
// emits dx and the f32 gradients of the LN scale and bias, Wqkv, bqkv,
// Wproj, bproj and the gathered rel-pos bias (heads, N, N).
//
// Replaces studiosr_tpu/ops/pallas/attn_bwd.py::pairs_attention_bwd (:209)
// and ::v5_attention_bwd (:508) in bf16; f32, the checks' dtype, keeps
// attn_bwd.cu / attn_bwd16.cu, and so do head dims above 32. The contract
// is theirs: g_b = d g rounded to bf16, dx = g_b + LN-backward(dln) + (1 -
// d) g; the LN output, q / k / v, the probabilities, dattn, dscores and dq /
// dk / dv rounded to bf16; products accumulate in f32; softmax, its
// backward, the LN backward and d bias in f32; every sum across blocks in a
// fixed order (no atomics: the same bits from run to run).
//
// Bound on the card at the training shapes (T = 131,072 tokens, C 180, 6
// heads of 30): 112 GFLOP (B8) and 166 GFLOP (B9) against 141 MB for x, g
// and dx, so the tensor-core rate (0.11 / 0.17 ms). The older kernels ran
// their products on wmma 64 x 64 tiles, restaged the weights from L2 for
// every window (B8) or every 64 rows (B9), ran the heads of a window one
// after another with a barrier between phases, and B9 computed every score
// three times. Here, one structure for both windows, tokens in tile order
// (64 tokens a tile: a window at 8, a quarter of one at 16):
// 0. am_ln_kernel, a warp a row: LN (its f32 statistics kept) and g_b, to
//    row-major scratch rows, at full occupancy.
// 1. am_proj_kernel, a tile a warpgroup, two a block: the tile's LN and g_b
//    rows by cp.async into K-major tiles; per head, q|k|v = LN Wqkv and
//    dattn = g_b Wproj^T on wgmma, the head's packed weights streamed once
//    per tile pair through a four-slot cp.async.bulk / mbarrier ring. q
//    (scaled), k, v and dattn go out as wgmma's K-major core-matrix image of
//    each (window, head, 64 tokens), 128 contiguous bytes a warp store.
// 2. am_attn_kernel, a block owning (head, 64 queries of the window, a group
//    of windows): the window's k and v and its queries' q and dattn come in
//    by cp.async, the token-contiguous copies the products on the other side
//    need are made by ldmatrix + stmatrix.trans. Sweep 1 computes the scores
//    and dprobs = dattn v^T of every 64-key chunk on wgmma in registers and
//    keeps the row max, sum and D = sum p dp online; sweep 2 recomputes them
//    (at window 8, one chunk, it keeps them), forms p and dscores in
//    registers and runs attn = p v, dq = dscores k, and, from p^T and
//    dscores^T written to shared memory by stmatrix.trans, dk = dscores^T q
//    and dv = p^T dattn. Each block keeps its f32 d bias rows (64 x N) in
//    shared memory across its windows. At window 16 two warpgroups split
//    the key chunks, and the four blocks of a window's query quarters form a
//    cluster: each pushes its dk / dv partial of a chunk into the chunk's
//    owner's inbox in distributed shared memory (st.async, counted on the
//    owner's mbarrier), and the owner adds them in a fixed order when its
//    next window's sweep 2 begins, handing back credits (a remote mbarrier
//    arrival) before any block refills an inbox. The scores are computed
//    twice, not three times. dq|dk|dv and attn go out per token row, heads
//    padded to DP.
// 3. am_dln_kernel, a tile a warpgroup: dln = dqkv Wqkv^T on wgmma (A the
//    tile's dq|dk|dv in 64-column chunks by cp.async, B streamed through
//    the ring), in f32 to a scratch; 3b. am_lnb_kernel, a warp a row: the LN
//    backward and dx, and per-block column sums of dln xhat and dln.
// 4. am_wgrad_kernel: d Wqkv = LN^T dqkv, d Wproj = attn^T g_b and the bias
//    gradients over all token rows on wgmma (split-K f32 partials), every
//    partial summed in a fixed order (wgrad.cuh's reduce_parts).
// The element-wise row passes (LN, the LN backward) run on their own, at
// full occupancy: in the product kernels, eight warps an SM left them bound
// by latency (scripts/torch_ablate_attn_bwd.py).
// The weights change every step, so they are packed per call (one gather on
// the stream, am_pack_kernel, by the index table of ops/cuda/attn_bwd.py
// _pack_index): per head, in stages of 96 K rows, its q|k|v columns and its
// rows of Wproj; then Wqkv^T (K the padded dq|dk|dv columns) in stages of
// 64 rows; each stage the image of a ring slot in wgmma's K-major
// core-matrix layout (am_kmajor here, _k_major there: change both
// together).
// Takes bf16, window 8 or 16, head dims up to 32, C a multiple of 4 up to
// 184, H and W multiples of the window; the wrapper routes anything else.
#include "hopper_mma.cuh"
#include "wgmma.cuh"
#include "wgrad.cuh"

using bf16 = __nv_bfloat16;

// dln's product at C 180 and the weight gradients' (wgmma.cuh has the
// register-A form of the first).
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
constexpr int AM_KSTAGE = 64;   // K rows of a dln weight stage
constexpr int AM_ABUF = 4;      // dln: dq|dk|dv chunk buffers a warpgroup (AM_ABUF - 1 in flight)
constexpr int AM_MAX_C = 184;
constexpr float AM_LOG2E = 1.4426950408889634f;

__host__ __device__ inline int am_pad16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline int am_min(int a, int b) { return a < b ? a : b; }
// Product width of dln (columns of C): the wgmma widths the kernel has.
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

// The geometry, shared by the kernels and the host; the packed layout is
// mirrored by ops/cuda/attn_bwd.py.
struct AmGeom {
  int C, heads, d, DP, KC, HD, K3, NP, ws, N, NCH, SC;
  __host__ __device__ AmGeom(int C_, int heads_, int ws_) : C(C_), heads(heads_), ws(ws_) {
    d = C / heads;
    DP = am_pad16(d);
    KC = am_pad16(C);
    HD = heads * DP;
    K3 = 3 * HD;
    NP = am_np(C);
    N = ws * ws;
    NCH = N / AM_TOK;
    SC = (C + 7) & ~7;
  }
  // a head's weights: q|k|v (KC x 3 DP) and Wproj^T's head columns (KC x
  // DP), in stages of AM_KROWS K rows, each q|k|v's rows then Wproj^T's
  __host__ __device__ int proj_stages() const { return (KC + AM_KROWS - 1) / AM_KROWS; }
  __host__ __device__ int proj_rows(int s) const { return am_min(AM_KROWS, KC - AM_KROWS * s); }
  __host__ __device__ long long proj_elems() const { return (long long)heads * 4 * KC * DP; }
  __host__ __device__ int dln_stages() const { return (K3 + AM_KSTAGE - 1) / AM_KSTAGE; }
  __host__ __device__ int dln_rows(int s) const { return am_min(AM_KSTAGE, K3 - AM_KSTAGE * s); }
  __host__ __device__ long long pack_elems() const { return proj_elems() + (long long)K3 * NP; }
};

struct AmArgs {
  const bf16 *x, *g;
  bf16* dx;
  const float *ln_w, *ln_b, *bqkv, *dp;
  const void* relbias;  // the bias in fragment order (am_bias_kernel): f32, or bf16 when bias16
  const bf16* w;  // the packed weights
  bf16 *img, *ln, *gb, *att, *dqkv;
  float *stats, *dbias_part, *lnst, *dln;
  int H, W, shift, nwx, nwi, windows, tiles, groups, bias16;
};

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

__device__ __forceinline__ void am_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// p (an address of this block's shared memory) as it lies in block `rank` of
// the cluster.
__device__ __forceinline__ uint32_t am_mapa(const void* p, unsigned rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(hm_smem(p)), "r"(rank));
  return a;
}

// v to the cluster address a, its 16 bytes counted on the mbarrier at cluster
// address bar (complete_tx).
__device__ __forceinline__ void am_st_async(uint32_t a, float4 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
               : "memory");
}

// An arrival, released at cluster scope, on the mbarrier at cluster address bar.
__device__ __forceinline__ void am_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The phase of parity `parity` of a barrier other blocks of the cluster
// arrive on or count bytes on, acquired at cluster scope; traps after about
// ten seconds as am_bar_wait does.
__device__ __forceinline__ void am_bar_wait_cluster(uint64_t* bar, int parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(hm_smem(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void am_wg_sync(int wg) { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); }

// Pixel of token t (0..63) of tile `tile`: window tile / NCH, its tokens
// 64 (tile % NCH) + t, through the shift.
__device__ __forceinline__ long long am_pixel(const AmGeom& G, const AmArgs& a, int tile, int t) {
  const int w = tile / G.NCH, n = (tile % G.NCH) * AM_TOK + t;
  const int img = w / a.nwi, wi = w % a.nwi;
  int y = (wi / a.nwx) * G.ws + n / G.ws + a.shift, x = (wi % a.nwx) * G.ws + n % G.ws + a.shift;
  if (y >= a.H) y -= a.H;
  if (x >= a.W) x -= a.W;
  return ((long long)img * a.H + y) * a.W + x;
}

// calculate_mask's region of window token n of the rolled map.
__device__ __forceinline__ int am_region(const AmGeom& G, const AmArgs& a, int wi, int n) {
  const int y = (wi / a.nwx) * G.ws + n / G.ws, x = (wi % a.nwx) * G.ws + n % G.ws;
  return 3 * (y < a.H - G.ws ? 0 : (y < a.H - a.shift ? 1 : 2)) + (x < a.W - G.ws ? 0 : (x < a.W - a.shift ? 1 : 2));
}

// -- passes 0 and 1: LN and g_b rows; q|k|v and dattn --------------------------------

// Shared memory of pass 1: the ring, its barriers, then per warpgroup its
// LN and g_b tiles (K-major, 64 x KC).
__host__ __device__ inline size_t am_proj_smem(const AmGeom& G) {
  return (size_t)AM_SLOTS * AM_SLOT_BYTES + AM_HEAD_BYTES + 2 * (size_t)2 * AM_TOK * G.KC * 2;
}

// Pass 0, a warp a token row (rows in tile order, many blocks an SM): LN
// (eps 1e-5, f32 statistics) and g_b = d g, rounded, into the row-major
// scratch (SC columns, zero past C), LN's (mean, rstd) into stats. Lane l
// takes the 4-column pieces l, l + 32 (C a multiple of 4, at most 184).
__global__ void __launch_bounds__(256) am_ln_kernel(const AmArgs a, const AmGeom G, long long rows) {
  const int lane = threadIdx.x & 31, C = G.C, NPC = G.SC / 4;
  for (long long row = blockIdx.x * 8LL + (threadIdx.x >> 5); row < rows; row += gridDim.x * 8LL) {
    const int tile = (int)(row / AM_TOK);
    const long long off = am_pixel(G, a, tile, (int)(row % AM_TOK)) * C;
    const float dd = a.dp ? a.dp[(tile / G.NCH) / a.nwi] : 1.f;
    float v[2][4], gv[2][4], s = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 4 * (lane + 32 * j);
      uint2 ux = make_uint2(0u, 0u), ug = make_uint2(0u, 0u);
      if (c < C) {
        ux = *reinterpret_cast<const uint2*>(a.x + off + c);
        ug = *reinterpret_cast<const uint2*>(a.g + off + c);
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
    if (lane == 0) a.stats[2 * row] = mean, a.stats[2 * row + 1] = rstd;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int pc = lane + 32 * j, c = 4 * pc;
      if (pc >= NPC) continue;
      uint32_t lo[2], go[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c0 = c + 2 * e;
        const bool in = c0 < C;  // C is a multiple of 4: a pair is in or out whole
        lo[e] = hm_pack(in ? (v[j][2 * e] - mean) * rstd * __ldg(a.ln_w + c0) + __ldg(a.ln_b + c0) : 0.f,
                        in ? (v[j][2 * e + 1] - mean) * rstd * __ldg(a.ln_w + c0 + 1) + __ldg(a.ln_b + c0 + 1) : 0.f);
        go[e] = hm_pack(dd * gv[j][2 * e], dd * gv[j][2 * e + 1]);
      }
      *reinterpret_cast<uint2*>(a.ln + row * G.SC + c) = make_uint2(lo[0], lo[1]);
      *reinterpret_cast<uint2*>(a.gb + row * G.SC + c) = make_uint2(go[0], go[1]);
    }
  }
}

// The LN or g_b rows of a tile from the scratch into a K-major tile (KC
// columns, zero past SC), one cp.async group of the warpgroup's threads.
__device__ __forceinline__ void am_load_rows(const AmGeom& G, const bf16* rows, int tile, bool valid, bf16* tileb) {
  const int KG = G.KC / 8, SG = G.SC / 8;
  for (int i = threadIdx.x & 127; i < AM_TOK * KG; i += 128) {
    const int t = i / KG, kg = i - t * KG;
    const bool in = valid && kg < SG;
    hm_cp_async<16>(tileb + am_kmajor(8 * kg, t, G.KC), in ? rows + ((long long)tile * AM_TOK + t) * G.SC + 8 * kg : rows,
                    in);
  }
}

// One warpgroup a 64-token tile, two a block, persistent over tile pairs.
template <int DP>
__global__ void __launch_bounds__(256, 1) am_proj_kernel(const AmArgs a, const AmGeom G) {
  constexpr int NQ = 3 * DP, NQT = NQ / 8, NDT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int wg = warp >> 2, wr = warp & 3;
  bf16* lnb = (bf16*)(smem + AM_SLOTS * AM_SLOT_BYTES + AM_HEAD_BYTES) + (size_t)wg * 2 * AM_TOK * G.KC;
  bf16* gbb = lnb + AM_TOK * G.KC;
  const int npairs = (a.tiles + 1) / 2;
  const int pairs = blockIdx.x < npairs ? (npairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int hst = G.proj_stages(), nst = G.heads * hst;
  AmRing ring = am_ring_start(smem, a.w, nst, nst * pairs, 8, [&](int j) { return 4 * G.proj_rows(j % hst) * DP; });
  const float qscale = rsqrtf((float)G.d);
  const int KC = G.KC, N = G.N;
  for (int p = blockIdx.x; p < npairs; p += gridDim.x) {
    const int tile = 2 * p + wg;
    const bool valid = tile < a.tiles;
    am_wg_sync(wg);  // the warpgroup's products on the last tiles are done
    am_load_rows(G, a.ln, tile, valid, lnb);
    am_load_rows(G, a.gb, tile, valid, gbb);
    hm_cp_commit();
    hm_cp_wait_upto(0);
    wg_proxy_fence();
    am_wg_sync(wg);
    const int w = tile / G.NCH, c = tile % G.NCH;
    for (int h = 0; h < G.heads; ++h) {
      float aq[NQT][4], ad[NDT][4];
      for (int sk = 0; sk < hst; ++sk) {
        const bf16* st = ring.acquire();
        const int k0 = sk * AM_KROWS, kr = G.proj_rows(sk);
        wg_fence();
        for (int kk = 0; kk < kr; kk += 16)
          wg_ss<NQ>(&aq[0][0], wg_desc(lnb + (k0 + kk) * 8, 128, KC * 16), wg_desc(st + kk * 8, 128, kr * 16),
                    k0 + kk > 0);
        for (int kk = 0; kk < kr; kk += 16)
          wg_ss<DP>(&ad[0][0], wg_desc(gbb + (k0 + kk) * 8, 128, KC * 16),
                    wg_desc(st + kr * NQ + kk * 8, 128, kr * 16), k0 + kk > 0);
        wg_commit();
        wg_wait0();
        wg_hold<NQT * 4>(&aq[0][0]);
        wg_hold<NDT * 4>(&ad[0][0]);
        ring.release();
      }
      if (!valid) continue;
      // q (scaled), k, v, dattn of the (window, head) unit, chunk c: K-major
      // images of 64 x DP, array order q, k, v, dattn
      bf16* unit = a.img + ((long long)w * G.heads + h) * 4 * N * DP + c * AM_TOK * DP;
#pragma unroll
      for (int nt = 0; nt < NQT + NDT; ++nt) {
        const int part = nt < NQT ? nt / NDT : 3, j = (nt < NQT ? nt % NDT : nt - NQT) * 8 + 2 * tq;
        const float* acc = nt < NQT ? aq[nt] : ad[nt - NQT];
        float b0 = 0.f, b1 = 0.f;
        if (part < 3) {
          const float* bp = a.bqkv + part * G.C + h * G.d;
          b0 = j < G.d ? __ldg(bp + j) : 0.f;
          b1 = j + 1 < G.d ? __ldg(bp + j + 1) : 0.f;
        }
        const float sc = part == 0 ? qscale : 1.f;
        bf16* dst = unit + (long long)part * N * DP;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * wr + gq + 8 * hh;
          const float v0 = j < G.d ? (acc[2 * hh] + b0) * sc : 0.f;
          const float v1 = j + 1 < G.d ? (acc[2 * hh + 1] + b1) * sc : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(dst + am_kmajor(j, r, DP)) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// -- pass 2: the attention core ---------------------------------------------------

// Warpgroups of an attention block: at window 16 two, splitting the key
// chunks of the block's 64 queries (AM_WGS(4) = 2); at window 8 one.
__host__ __device__ constexpr int am_wgs(int nch) { return nch == 1 ? 1 : 2; }

struct AmAttnSmem {
  size_t kk, vk, kt, vt, qk, dk, qt, dt, pt, st, slab, inbox, stat, bars, reg, total;
};

// k and v of the whole window (K-major in d, then token-contiguous), q and
// dattn of the block's 64 queries (the same two layouts), per warpgroup p^T
// and dscores^T (A images), the f32 d bias rows, the dk / dv inbox (one
// slot for each partial the block's keys take from the others: NCH - 1), the warpgroups' row
// statistics, two mbarriers and the keys' region ids. At window 16, C 180:
// 231,184 bytes.
__host__ __device__ inline AmAttnSmem am_attn_smem(const AmGeom& G) {
  AmAttnSmem L;
  const int wgs = am_wgs(G.NCH);
  const size_t big = (size_t)G.N * G.DP * 2, small = (size_t)AM_TOK * G.DP * 2, sq = (size_t)AM_TOK * AM_TOK * 2;
  size_t o = 0;
  L.kk = o, o += big;
  L.vk = o, o += big;
  L.kt = o, o += big;
  L.vt = o, o += big;
  L.qk = o, o += small;
  L.dk = o, o += small;
  L.qt = o, o += small;
  L.dt = o, o += small;
  L.pt = o, o += wgs * sq;
  L.st = o, o += wgs * sq;
  L.slab = o, o += (size_t)AM_TOK * G.N * 4;
  L.inbox = o, o += (size_t)(G.NCH - 1) * AM_TOK * G.DP * 2 * 4;
  L.stat = o, o += (size_t)wgs * AM_TOK * 3 * 4;
  L.bars = o, o += 16;  // the inbox's full barrier and the credit barrier
  L.reg = o, o += G.N;
  L.total = (o + 127) & ~(size_t)127;
  return L;
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

// A block owns (head h, query chunk r, window group g); NCH 4 (window 16)
// runs as clusters of four blocks, one a query chunk, each with two
// warpgroups: warpgroup k takes key chunks (r + 2 i + k) mod 4, i = 0, 1.
template <int NCH, int DP>
__global__ void __launch_bounds__(128 * am_wgs(NCH), NCH == 1 ? 3 : 1) am_attn_kernel(const AmArgs a, const AmGeom G) {
  constexpr int N = NCH * AM_TOK, KS = DP / 16, NDT = DP / 8;
  constexpr int WGS = am_wgs(NCH), STEPS = NCH / WGS, THREADS = 128 * WGS;
  extern __shared__ __align__(128) unsigned char smem[];
  const AmAttnSmem L = am_attn_smem(G);
  bf16 *Kk = (bf16*)(smem + L.kk), *Vk = (bf16*)(smem + L.vk), *Kt = (bf16*)(smem + L.kt), *Vt = (bf16*)(smem + L.vt);
  bf16 *Qk = (bf16*)(smem + L.qk), *Dk = (bf16*)(smem + L.dk), *Qt = (bf16*)(smem + L.qt), *Dt = (bf16*)(smem + L.dt);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, wr = wt >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  bf16 *PT = (bf16*)(smem + L.pt) + wg * AM_TOK * AM_TOK, *ST = (bf16*)(smem + L.st) + wg * AM_TOK * AM_TOK;
  float4* slab = (float4*)(smem + L.slab);
  float4* inbox = (float4*)(smem + L.inbox);  // per slot 2 NDT x 128 float4
  // full: one phase a window, complete when the owner has arrived and the
  // NCH - 1 partials' bytes are in; credit: one phase a window, complete when
  // the NCH - 1 owners this block sends to have read their inboxes
  uint64_t* full = (uint64_t*)(smem + L.bars);
  uint64_t* credit = full + 1;
  constexpr int INBOX_BYTES = (NCH - 1) * 2 * NDT * 128 * 16;
  int n = 0;  // windows done
  float* stat = (float*)(smem + L.stat);         // [warpgroup][row][m, l, u]
  signed char* reg = (signed char*)(smem + L.reg);
  const int r = blockIdx.x % NCH, hg = blockIdx.x / NCH, h = hg % G.heads, g = hg / G.heads;
  const float dq_scale = rsqrtf((float)G.d);
  for (int i = tid; i < AM_TOK * N / 4; i += THREADS) slab[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (NCH > 1) {
    if (tid == 0) {
      am_bar_init(full, 1), am_bar_init(credit, NCH - 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    am_cluster_sync();  // every block of the cluster runs, its barriers set, before one writes to another
  }
  // the bias of this thread's score fragment of key chunk c, 8-column tile
  // nt: (q0, col), (q0, col + 1), (q0 + 8, col), (q0 + 8, col + 1), from the
  // fragment-ordered copy am_bias_kernel makes (bf16 when the bias is)
  auto bias4 = [&](int c, int nt) -> float4 {
    const size_t e = (((size_t)(h * NCH + r) * NCH + c) * 8 + nt) * 128 + wt;
    if (!a.bias16) return reinterpret_cast<const float4*>(a.relbias)[e];
    const uint2 u = reinterpret_cast<const uint2*>(a.relbias)[e];
    const float2 p0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 p1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(p0.x, p0.y, p1.x, p1.y);
  };

  const int q0 = 16 * wr + gq;  // this thread's query rows q0, q0 + 8 of the chunk

  // dk and dv of the block's own key chunk: this block's partial from step 0
  // of warpgroup 0, then (NCH > 1) the others' from the inbox, added when the
  // next window's sweep 2 begins (or after the last), so that no block waits
  // for another's partials at the end of a window
  float dko[NDT][4], dvo[NDT][4];
  long long own_row0 = 0;  // the first token row of the window dko / dvo belong to
  auto finish_own = [&]() {
    if (wg != 0) return;
    if constexpr (NCH > 1) {
      // the partial of step i, warpgroup k (from block (r - WGS i - k) mod
      // NCH) in order of (i, k); then each of those blocks gets a credit, and
      // waits for it only before it next fills an inbox (or exits)
      am_bar_wait_cluster(full, (n - 1) & 1);
#pragma unroll
      for (int q = 1; q < NCH; ++q) {
        const float4* sb = inbox + (q - 1) * 2 * NDT * 128;
#pragma unroll
        for (int nt = 0; nt < NDT; ++nt) {
          const float4 k4 = sb[nt * 128 + wt], v4 = sb[(NDT + nt) * 128 + wt];
          dko[nt][0] += k4.x, dko[nt][1] += k4.y, dko[nt][2] += k4.z, dko[nt][3] += k4.w;
          dvo[nt][0] += v4.x, dvo[nt][1] += v4.y, dvo[nt][2] += v4.z, dvo[nt][3] += v4.w;
        }
      }
      am_wg_sync(0);  // every thread of warpgroup 0 has read the inbox
      if (tid == 0) {
        // the next window's phase (this arrival and its partials' bytes),
        // armed before any of its partials can come
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(hm_smem(full)), "r"(INBOX_BYTES)
                     : "memory");
        for (int q = 1; q < NCH; ++q)
          am_arrive_cluster(am_mapa(credit, (unsigned)(((r - WGS * (q / WGS) - q % WGS) % NCH + NCH) % NCH)));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NDT; ++nt) {
      const int j = nt * 8 + 2 * tq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        bf16* dr = a.dqkv + (own_row0 + q0 + 8 * hh) * G.K3 + h * DP + j;
        *reinterpret_cast<__nv_bfloat162*>(dr + G.HD) = __floats2bfloat162_rn(dko[nt][2 * hh], dko[nt][2 * hh + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dr + 2 * G.HD) = __floats2bfloat162_rn(dvo[nt][2 * hh], dvo[nt][2 * hh + 1]);
      }
    }
  };
  if (NCH > 1 && tid == 0)  // the first window's phase
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(hm_smem(full)), "r"(INBOX_BYTES)
                 : "memory");

  for (int w = g; w < a.windows; w += a.groups) {
    __syncthreads();  // the last window's buffers are free
    const bf16* unit = a.img + ((long long)w * G.heads + h) * 4 * N * DP;
    {
      constexpr int BIG = N * DP / 8, SMALL = AM_TOK * DP / 8;  // 16-byte pieces
      for (int i = tid; i < 2 * BIG + 2 * SMALL; i += THREADS) {
        const bf16* s;
        bf16* d;
        if (i < BIG) s = unit + N * DP + i * 8, d = Kk + i * 8;
        else if (i < 2 * BIG) s = unit + 2 * N * DP + (i - BIG) * 8, d = Vk + (i - BIG) * 8;
        else if (i < 2 * BIG + SMALL) s = unit + r * AM_TOK * DP + (i - 2 * BIG) * 8, d = Qk + (i - 2 * BIG) * 8;
        else s = unit + 3 * N * DP + r * AM_TOK * DP + (i - 2 * BIG - SMALL) * 8, d = Dk + (i - 2 * BIG - SMALL) * 8;
        hm_cp_async<16>(d, s, true);
      }
      hm_cp_commit();
    }
    const int wi = w % a.nwi;
    if (a.shift)
      for (int t = tid; t < N; t += THREADS) reg[t] = (signed char)am_region(G, a, wi, t);
    hm_cp_wait_upto(0);
    __syncthreads();
    am_transpose<DP>(Kk, Kt, NCH, 4 * WGS);
    am_transpose<DP>(Vk, Vt, NCH, 4 * WGS);
    am_transpose<DP>(Qk, Qt, 1, 4 * WGS);
    am_transpose<DP>(Dk, Dt, 1, 4 * WGS);
    wg_proxy_fence();
    __syncthreads();
    const int rq0 = a.shift ? reg[r * AM_TOK + q0] : 0, rq1 = a.shift ? reg[r * AM_TOK + q0 + 8] : 0;

    // scores (+ bias and mask) and dprobs of key chunk c, this warp's 16 rows
    float s[8][4], dp[8][4];
    auto sd = [&](int c) {
      float4 bb[8];  // the bias, loaded before the products so their latency hides under them
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) bb[nt] = bias4(c, nt);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wg_ss<64>(&s[0][0], wg_desc(Qk + ks * 128, 128, DP * 16), wg_desc(Kk + c * AM_TOK * DP + ks * 128, 128, DP * 16),
                  ks > 0);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wg_ss<64>(&dp[0][0], wg_desc(Dk + ks * 128, 128, DP * 16),
                  wg_desc(Vk + c * AM_TOK * DP + ks * 128, 128, DP * 16), ks > 0);
      wg_commit();
      wg_wait0();
      wg_hold<32>(&s[0][0]);
      wg_hold<32>(&dp[0][0]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = c * AM_TOK + nt * 8 + 2 * tq;
        s[nt][0] += bb[nt].x, s[nt][1] += bb[nt].y, s[nt][2] += bb[nt].z, s[nt][3] += bb[nt].w;
        if (a.shift) {
          const int k0 = reg[col], k1 = reg[col + 1];
          if (k0 != rq0) s[nt][0] += -100.f;
          if (k1 != rq0) s[nt][1] += -100.f;
          if (k0 != rq1) s[nt][2] += -100.f;
          if (k1 != rq1) s[nt][3] += -100.f;
        }
      }
    };

    // sweep 1 over this warpgroup's key chunks: row max m (log2 units), sum
    // l of 2^(s - m) and u of 2^(s - m) dp
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
#pragma unroll 1
    for (int i = 0; i < STEPS; ++i) {
      sd((r + WGS * i + wg) % NCH);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
        const float mn = fmaxf(m[hh], am_quad_max(mx) * AM_LOG2E), sc = am_exp2(m[hh] - mn);
        l[hh] *= sc, u[hh] *= sc, m[hh] = mn;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = am_exp2(fmaf(s[nt][2 * hh + e], AM_LOG2E, -mn));
            l[hh] += p, u[hh] += p * dp[nt][2 * hh + e];
          }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = am_quad_sum(l[hh]), u[hh] = am_quad_sum(u[hh]);
    if constexpr (WGS > 1) {
      // both warpgroups combine the two partial statistics of a row in the
      // same order, from shared memory, so they hold the same bits
      if (tq == 0)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float* st = stat + (wg * AM_TOK + q0 + 8 * hh) * 3;
          st[0] = m[hh], st[1] = l[hh], st[2] = u[hh];
        }
      __syncthreads();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float* s0 = stat + (q0 + 8 * hh) * 3;
        const float* s1 = stat + (AM_TOK + q0 + 8 * hh) * 3;
        const float mn = fmaxf(s0[0], s1[0]), e0 = am_exp2(s0[0] - mn), e1 = am_exp2(s1[0] - mn);
        m[hh] = mn, l[hh] = s0[1] * e0 + s1[1] * e1, u[hh] = s0[2] * e0 + s1[2] * e1;
      }
    }
    float linv[2], D[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) linv[hh] = 1.f / l[hh], D[hh] = u[hh] / l[hh];

    // sweep 2: step i takes key chunk (r + WGS i + wg) mod NCH
    float o[NDT][4], dq[NDT][4];
    if (n > 0) {
      finish_own();  // the last window's dk and dv
      if (NCH > 1) am_bar_wait_cluster(credit, (n - 1) & 1);  // the owners have read the last window's partials
    }
#pragma unroll 1
    for (int i = 0; i < STEPS; ++i) {
      const int c = (r + WGS * i + wg) % NCH;
      if (NCH > 1) sd(c);
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = am_exp2(fmaf(s[nt][e], AM_LOG2E, -m[e >> 1])) * linv[e >> 1];
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - D[e >> 1]);
        }
        pa[nt >> 1][(nt & 1) * 2] = hm_pack(s[nt][0], s[nt][1]);
        pa[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(s[nt][2], s[nt][3]);
        sa[nt >> 1][(nt & 1) * 2] = hm_pack(dp[nt][0], dp[nt][1]);
        sa[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(dp[nt][2], dp[nt][3]);
        float4& acc = slab[(c * 8 + nt) * 128 + wt];
        float4 v = acc;
        v.x += dp[nt][0], v.y += dp[nt][1], v.z += dp[nt][2], v.w += dp[nt][3];
        acc = v;
      }
      // p^T and dscores^T as A images (m = key, k = query)
      {
        const int mi = lane >> 3, rho = lane & 7;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int off = (2 * np + (mi >> 1)) * 512 + (2 * wr + (mi & 1)) * 64 + rho * 8;
          am_stsm_x4_t(PT + off, pa[np][0], pa[np][1], pa[np][2], pa[np][3]);
          am_stsm_x4_t(ST + off, sa[np][0], sa[np][1], sa[np][2], sa[np][3]);
        }
      }
      wg_proxy_fence();
      am_wg_sync(wg);
      float dkp[NDT][4], dvp[NDT][4];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wg_rs<DP>(&o[0][0], pa[ks], wg_desc(Vt + c * AM_TOK * DP + ks * 128, 128, AM_TOK * 16), i > 0 || ks > 0);
        wg_rs<DP>(&dq[0][0], sa[ks], wg_desc(Kt + c * AM_TOK * DP + ks * 128, 128, AM_TOK * 16), i > 0 || ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wg_ss<DP>(&dkp[0][0], wg_desc(ST + ks * 128, 128, AM_TOK * 16), wg_desc(Qt + ks * 128, 128, AM_TOK * 16),
                  ks > 0);
        wg_ss<DP>(&dvp[0][0], wg_desc(PT + ks * 128, 128, AM_TOK * 16), wg_desc(Dt + ks * 128, 128, AM_TOK * 16),
                  ks > 0);
      }
      wg_commit();
      wg_wait0();
      wg_hold<NDT * 4>(&o[0][0]);
      wg_hold<NDT * 4>(&dq[0][0]);
      wg_hold<NDT * 4>(&dkp[0][0]);
      wg_hold<NDT * 4>(&dvp[0][0]);
      wg_hold<16>(&pa[0][0]);
      wg_hold<16>(&sa[0][0]);
      am_wg_sync(wg);  // every warp is done with this warpgroup's p^T and dscores^T
      const bool own = i == 0 && wg == 0;  // chunk r, this block's own keys
      if (own) {
#pragma unroll
        for (int nt = 0; nt < NDT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dko[nt][e] = dkp[nt][e], dvo[nt][e] = dvp[nt][e];
      }
      if constexpr (NCH > 1) {
        // the partial of chunk c to its owner, block c: slot WGS i + wg - 1
        // of its inbox
        if (!own) {
          float4* box = inbox + (WGS * i + wg - 1) * 2 * NDT * 128;
          const uint32_t bar = am_mapa(full, c);
#pragma unroll
          for (int nt = 0; nt < NDT; ++nt) {
            am_st_async(am_mapa(&box[nt * 128 + wt], c), make_float4(dkp[nt][0], dkp[nt][1], dkp[nt][2], dkp[nt][3]),
                        bar);
            am_st_async(am_mapa(&box[(NDT + nt) * 128 + wt], c),
                        make_float4(dvp[nt][0], dvp[nt][1], dvp[nt][2], dvp[nt][3]), bar);
          }
        }
      }
    }
    if constexpr (WGS > 1) {
      // warpgroup 1's o and dq partials to warpgroup 0 (through the p^T
      // buffers, free now), added in that order
      float4* box = (float4*)(smem + L.pt);
      __syncthreads();
      if (wg == 1) {
#pragma unroll
        for (int nt = 0; nt < NDT; ++nt) {
          box[nt * 128 + wt] = make_float4(o[nt][0], o[nt][1], o[nt][2], o[nt][3]);
          box[(NDT + nt) * 128 + wt] = make_float4(dq[nt][0], dq[nt][1], dq[nt][2], dq[nt][3]);
        }
      }
      __syncthreads();
      if (wg == 0) {
#pragma unroll
        for (int nt = 0; nt < NDT; ++nt) {
          const float4 o4 = box[nt * 128 + wt], q4 = box[(NDT + nt) * 128 + wt];
          o[nt][0] += o4.x, o[nt][1] += o4.y, o[nt][2] += o4.z, o[nt][3] += o4.w;
          dq[nt][0] += q4.x, dq[nt][1] += q4.y, dq[nt][2] += q4.z, dq[nt][3] += q4.w;
        }
      }
    }

    // dq (scaled) and the attention output, rounded, to the token rows (dk
    // and dv when their partials are in)
    own_row0 = ((long long)w * NCH + r) * AM_TOK;
    if (wg == 0) {
#pragma unroll
      for (int nt = 0; nt < NDT; ++nt) {
        const int j = nt * 8 + 2 * tq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long row = own_row0 + q0 + 8 * hh;
          *reinterpret_cast<__nv_bfloat162*>(a.dqkv + row * G.K3 + h * DP + j) =
              __floats2bfloat162_rn(dq[nt][2 * hh] * dq_scale, dq[nt][2 * hh + 1] * dq_scale);
          *reinterpret_cast<__nv_bfloat162*>(a.att + row * G.HD + h * DP + j) =
              __floats2bfloat162_rn(o[nt][2 * hh], o[nt][2 * hh + 1]);
        }
      }
    }
    ++n;
  }
  if (n > 0) finish_own();  // the last window's dk and dv

  // this block's d bias rows, f32, to its partial (head h, group g); it
  // exits only once the owners of its last partials have read them (their
  // credits are the last accesses to its shared memory)
  if (NCH > 1 && n > 0) am_bar_wait_cluster(credit, (n - 1) & 1);
  __syncthreads();
  float* part = a.dbias_part + (((size_t)h * a.groups + g) * N + r * AM_TOK) * N;
  for (int c = wg; c < NCH; c += WGS)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float4 v = slab[(c * 8 + nt) * 128 + wt];
      const int col = c * AM_TOK + nt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(part + (size_t)q0 * N + col) = make_float2(v.x, v.y);
      *reinterpret_cast<float2*>(part + (size_t)(q0 + 8) * N + col) = make_float2(v.z, v.w);
    }
}

// The gathered rel-pos bias (heads, N, N; f32, or bf16 when bias16) in the
// order the attention pass's threads read it (bias4): element e of float4 /
// 4-value group ((h NCH + r) NCH + c) 1024 + 128 nt + wt is the score
// fragment of thread wt of the block of query chunk r, key chunk c, 8-column
// tile nt. bf16 stays bf16 (exact), f32 stays f32.
__global__ void am_bias_kernel(const void* __restrict__ bias, int bias16, int heads, int nch,
                               void* __restrict__ out) {
  const int n = nch * AM_TOK;
  const long long groups = (long long)heads * n * n / 4;
  for (long long gi = blockIdx.x * (long long)blockDim.x + threadIdx.x; gi < groups;
       gi += (long long)gridDim.x * blockDim.x) {
    const int wt = (int)(gi % 128), nt = (int)(gi / 128 % 8), c = (int)(gi / 1024 % nch);
    const int r = (int)(gi / (1024LL * nch) % nch), h = (int)(gi / (1024LL * nch * nch));
    const int q = AM_TOK * r + 16 * (wt >> 5) + ((wt & 31) >> 2), col = AM_TOK * c + 8 * nt + 2 * (wt & 3);
    const long long e0 = ((long long)h * n + q) * n + col, e1 = e0 + 8LL * n;
    if (bias16) {
      const bf16* b = (const bf16*)bias;
      __nv_bfloat162 v0, v1;
      v0.x = b[e0], v0.y = b[e0 + 1], v1.x = b[e1], v1.y = b[e1 + 1];
      reinterpret_cast<uint2*>(out)[gi] =
          make_uint2(*reinterpret_cast<uint32_t*>(&v0), *reinterpret_cast<uint32_t*>(&v1));
    } else {
      const float* b = (const float*)bias;
      reinterpret_cast<float4*>(out)[gi] = make_float4(b[e0], b[e0 + 1], b[e1], b[e1 + 1]);
    }
  }
}

// out[h][e] = sum over groups of part[h][g][e], in order of g.
__global__ void am_dbias_reduce_kernel(const float* __restrict__ part, int heads, int groups, long long nn,
                                       float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < heads * nn;
       i += (long long)gridDim.x * blockDim.x) {
    const long long h = i / nn, e = i % nn;
    float v = 0.f;
    for (int g = 0; g < groups; ++g) v += part[(h * groups + g) * nn + e];
    out[i] = v;
  }
}

// -- pass 3: dln = dqkv Wqkv^T; 3b: the LN backward and dx -------------------------

// The ring, its barriers and stage table, and each warpgroup's AM_ABUF
// dq|dk|dv chunk buffers (K-major, 64 tokens x 64 K).
__host__ __device__ inline size_t am_dln_smem(const AmGeom& G) {
  return (size_t)AM_SLOTS * AM_SLOT_BYTES + AM_HEAD_BYTES + 2 * (size_t)AM_ABUF * AM_TOK * AM_KSTAGE * 2;
}

template <int NP>
__global__ void __launch_bounds__(256, 1) am_dln_kernel(const AmArgs a, const AmGeom G) {
  constexpr int NT = NP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int wg = warp >> 2, wr = warp & 3, wt = tid & 127;
  const int K3 = G.K3, C = G.C;
  bf16* Ab = (bf16*)(smem + AM_SLOTS * AM_SLOT_BYTES + AM_HEAD_BYTES) + (size_t)wg * AM_ABUF * AM_TOK * AM_KSTAGE;
  const int npairs = (a.tiles + 1) / 2, nst = G.dln_stages();
  const int pairs = blockIdx.x < npairs ? (npairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  AmRing ring = am_ring_start(smem, a.w + G.proj_elems(), nst, nst * pairs, 8,
                              [&](int j) { return G.dln_rows(j) * NP; });
  for (int p = blockIdx.x; p < npairs; p += gridDim.x) {
    const int tile = 2 * p + wg;
    const bool valid = tile < a.tiles;
    const bf16* src = a.dqkv + (long long)tile * AM_TOK * K3;
    // K chunk s of the tile's dq|dk|dv rows into buffer s % AM_ABUF, one cp.async group
    auto load = [&](int s) {
      if (valid && s < nst) {
        const int kr = G.dln_rows(s), KG = kr / 8;
        bf16* dst = Ab + (s % AM_ABUF) * AM_TOK * AM_KSTAGE;
        for (int i = wt; i < AM_TOK * KG; i += 128) {
          const int t = i / KG, kg = i - t * KG;
          hm_cp_async<16>(dst + am_kmajor(8 * kg, t, kr), src + (long long)t * K3 + AM_KSTAGE * s + 8 * kg, true);
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
      const int kr = G.dln_rows(s);
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
    // dln in f32 to the token rows (pass 3b takes the LN backward)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tq;
      if (c >= C) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long row = (long long)tile * AM_TOK + 16 * wr + gq + 8 * hh;
        *reinterpret_cast<float2*>(a.dln + row * C + c) = make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
      }
    }
  }
}

// Pass 3b, a warp a token row (rows in tile order; block b takes rows b, b +
// gridDim, ...): the LN backward and dx from dln, x, g and the LN
// statistics, dx = g_b + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
// + (1 - d) g with dxhat = dln s, and the block's column sums of dln xhat
// and dln (each lane its column pairs, the warps added in order) into
// lnst[block][2 C]. Lane l takes the column pairs l, l + 32, l + 64.
__global__ void __launch_bounds__(256) am_lnb_kernel(const AmArgs a, const AmGeom G, long long rows) {
  __shared__ float sums[8][2 * AM_MAX_C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, C = G.C;
  float cs[3][4] = {};  // per pair: dln xhat (c, c + 1), dln (c, c + 1)
  for (long long row = blockIdx.x + (long long)gridDim.x * warp; row < rows; row += gridDim.x * 8LL) {
    const int tile = (int)(row / AM_TOK);
    const long long off = am_pixel(G, a, tile, (int)(row % AM_TOK)) * C;
    const float dd = a.dp ? a.dp[(tile / G.NCH) / a.nwi] : 1.f;
    const float mean = a.stats[2 * row], rstd = a.stats[2 * row + 1];
    float2 dl[3], xh[3], gv[3], w[3];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int c = 2 * (lane + 32 * j);
      dl[j] = xh[j] = gv[j] = w[j] = make_float2(0.f, 0.f);
      if (c < C) {
        dl[j] = *reinterpret_cast<const float2*>(a.dln + row * C + c);
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.x + off + c));
        gv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.g + off + c));
        w[j] = make_float2(__ldg(a.ln_w + c), __ldg(a.ln_w + c + 1));
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
      *reinterpret_cast<__nv_bfloat162*>(a.dx + off + c) = __floats2bfloat162_rn(y0, y1);
    }
  }
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
    a.lnst[(long long)blockIdx.x * 2 * C + i] = v;
  }
}

// -- pass 4: the weight gradients ---------------------------------------------------

// dW (M x N) = A^T B over K token rows (A: K x M, B: K x N, row-major bf16,
// strides multiples of 8) and the column sums of B, on wgmma. A block of
// three warpgroups owns a 192 x 192 tile of dW and a range of K (split-K: each
// range an f32 partial of its own, summed afterwards in a fixed order). Per
// 64-row K chunk: cp.async of the A and B rows into a staging buffer (the
// next chunk in flight), ldmatrix + stmatrix.trans into K-major images
// (tokens contiguous), and four m64n192k16 products a warpgroup. At C 180 a
// tile holds all of dW's rows, so B (dq|dk|dv) is read once and A (LN) once
// for each of the three column tiles. Columns
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

// -- host ------------------------------------------------------------------------------

static bool am_geometry_ok(int C, int heads, int ws) {
  if (!((ws == 8 || ws == 16) && heads >= 1 && C >= 4 && C <= AM_MAX_C && C % 4 == 0 && C % heads == 0 &&
        C / heads <= 32))
    return false;
  const AmGeom G(C, heads, ws);
  return G.heads * G.proj_stages() <= AM_MAX_STAGES && G.dln_stages() <= AM_MAX_STAGES;
}

// Scratch in bf16: q|k|v|dattn images (windows x heads x 4 x N x DP), LN and
// g_b rows (SC), attn rows (HD), dq|dk|dv rows (K3), the packed weights
// and the slack wgrad.cuh reads past its last tile. In f32: LN statistics (2 a row), the d
// dln rows (C), the fragment-ordered bias (heads x N x N), the d bias partials (heads x groups x N x N), pass 3b's
// blocks' column sums, the
// wgrad partials.
struct AmScratch {
  long long rows, img, ln, gb, att, dqkv, pack, t_elems;
  long long stats, dln, bias, dbias, lnst, wg, f_elems;
  int windows, tiles, groups, proj_blocks, dln_blocks, row_blocks;
};

static AmScratch am_scratch(int B, int H, int W, int C, int heads, int ws, int sms) {
  const AmGeom G(C, heads, ws);
  AmScratch S;
  S.windows = B * (H / ws) * (W / ws);
  S.tiles = S.windows * G.NCH;
  S.rows = (long long)S.tiles * AM_TOK;
  const int blocks = G.NCH == 1 ? 3 * sms : sms / G.NCH;  // attention blocks (clusters at window 16) in flight
  S.groups = blocks / heads < 1 ? 1 : blocks / heads;
  if (S.groups > S.windows) S.groups = S.windows;
  const int pairs = (S.tiles + 1) / 2;
  S.proj_blocks = S.dln_blocks = pairs < sms ? pairs : sms;
  S.row_blocks = 8 * sms;  // passes 0 and 3b: a warp a row, eight blocks an SM
  S.img = 0;
  S.ln = S.img + S.rows * 4 * G.HD;
  S.gb = S.ln + S.rows * G.SC;
  S.att = S.gb + S.rows * G.SC;
  S.dqkv = S.att + S.rows * G.HD;
  S.pack = S.dqkv + S.rows * G.K3;
  S.t_elems = S.pack + G.pack_elems() + 2 * WG_BM;
  S.stats = 0;
  S.dln = S.stats + 2 * S.rows;
  S.bias = S.dln + S.rows * C;
  S.dbias = S.bias + (long long)heads * G.N * G.N;
  S.lnst = S.dbias + (long long)heads * S.groups * G.N * G.N;
  S.wg = S.lnst + (long long)(S.row_blocks + sms) * 2 * C;  // 3b's partials, then their sums by eights
  const long long p1 = aw_plan(S.rows, C, G.K3, sms).part_elems, p2 = aw_plan(S.rows, G.HD, C, sms).part_elems;
  S.f_elems = S.wg + (p1 > p2 ? p1 : p2);
  return S;
}

static cudaError_t am_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Elements of the packed weights for a geometry (ops/cuda/attn_bwd.py checks
// its own count against it), or -1 for one the kernels do not take.
extern "C" long long attn_bwd_mma_pack_elems(int C, int heads) {
  return am_geometry_ok(C, heads, 8) ? AmGeom(C, heads, 8).pack_elems() : -1;
}

extern "C" int attn_bwd_mma_scratch(int B, int H, int W, int C, int heads, int ws, long long* t_elems,
                                    long long* f_elems) {
  int sms = 0;
  const cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const AmScratch S = am_scratch(B, H, W, C, heads, ws, sms);
  *t_elems = S.t_elems;
  *f_elems = S.f_elems;
  return 0;
}

template <int NCH, int DP>
static cudaError_t am_launch_attn(const AmArgs& a, const AmGeom& G, int blocks, cudaStream_t stream) {
  auto kernel = am_attn_kernel<NCH, DP>;
  const size_t bytes = am_attn_smem(G).total;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  if (NCH == 1) {
    kernel<<<blocks, 128 * am_wgs(NCH), bytes, stream>>>(a, G);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(128 * am_wgs(NCH));
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NCH;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, G);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int DP>
static cudaError_t am_launch_proj_attn(const AmArgs& a, const AmGeom& G, const AmScratch& S, cudaStream_t stream) {
  const size_t bytes = am_proj_smem(G);
  cudaError_t err = allow_smem(am_proj_kernel<DP>, bytes);
  if (err != cudaSuccess) return err;
  am_proj_kernel<DP><<<S.proj_blocks, 256, bytes, stream>>>(a, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = G.heads * S.groups * G.NCH;
  return G.NCH == 1 ? am_launch_attn<1, DP>(a, G, blocks, stream) : am_launch_attn<4, DP>(a, G, blocks, stream);
}

template <int NP>
static cudaError_t am_launch_dln(const AmArgs& a, const AmGeom& G, const AmScratch& S, cudaStream_t stream) {
  const size_t bytes = am_dln_smem(G);
  cudaError_t err = allow_smem(am_dln_kernel<NP>, bytes);
  if (err != cudaSuccess) return err;
  am_dln_kernel<NP><<<S.dln_blocks, 256, bytes, stream>>>(a, G);
  return cudaGetLastError();
}

// The packed weights: out[i] = wqkv (C x 3C) or wproj (C x C) at flat
// index idx[i] of the two laid end to end, or 0 past them (the rule is
// ops/cuda/attn_bwd.py _pack_index).
__global__ void am_pack_kernel(const bf16* __restrict__ wqkv, const bf16* __restrict__ wproj, int C,
                               const int* __restrict__ idx, long long n, bf16* __restrict__ out) {
  const long long q = 3LL * C * C, z = 4LL * C * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const long long k = idx[i];
    out[i] = k < q ? wqkv[k] : (k < z ? wproj[k - q] : __float2bfloat16(0.f));
  }
}

// The gradients with the heads padded to DP: dwqkv (C x K3), dbqkv (K3) and
// dwproj (HD x C) have zero rows / columns at d .. DP of each head, which
// the wrapper drops.
static int am_run(int ws, const void* x, const void* g, void* dx, int B, int H, int W, int C, int heads, int shift,
                  int bias16,
                  const void* ln_w, const void* ln_b, const void* bqkv, const void* relbias, const void* dp,
                  const void* wqkv, const void* wproj, const int* pack_index, long long pack_elems, void* ds_db, void* dwqkv, void* dbqkv, void* dwproj,
                  void* dbproj, void* dbias, void* tscratch, long long t_elems, void* fscratch, long long f_elems,
                  void* stream) {
  if (!am_geometry_ok(C, heads, ws) || B < 1 || H < ws || W < ws || H % ws || W % ws || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  const AmGeom G(C, heads, ws);
  int sms = 0;
  cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const AmScratch S = am_scratch(B, H, W, C, heads, ws, sms);
  if (S.t_elems != t_elems || S.f_elems != f_elems || G.pack_elems() != pack_elems) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 8 || (uintptr_t)g % 8 || (uintptr_t)dx % 8 || (uintptr_t)tscratch % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  bf16* t = (bf16*)tscratch;
  float* f = (float*)fscratch;
  AmArgs a;
  a.x = (const bf16*)x, a.g = (const bf16*)g, a.dx = (bf16*)dx;
  a.ln_w = (const float*)ln_w, a.ln_b = (const float*)ln_b, a.bqkv = (const float*)bqkv;
  a.relbias = f + S.bias, a.bias16 = bias16, a.dp = (const float*)dp;
  a.w = t + S.pack;
  a.img = t + S.img, a.ln = t + S.ln, a.gb = t + S.gb, a.att = t + S.att, a.dqkv = t + S.dqkv;
  a.stats = f + S.stats, a.dln = f + S.dln, a.dbias_part = f + S.dbias, a.lnst = f + S.lnst;
  a.H = H, a.W = W, a.shift = shift, a.nwx = W / ws, a.nwi = (H / ws) * (W / ws);
  a.windows = S.windows, a.tiles = S.tiles, a.groups = S.groups;

  am_pack_kernel<<<(int)((pack_elems + 255) / 256 < 1024 ? (pack_elems + 255) / 256 : 1024), 256, 0, st>>>(
      (const bf16*)wqkv, (const bf16*)wproj, C, pack_index, pack_elems, t + S.pack);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  am_bias_kernel<<<256, 256, 0, st>>>(relbias, bias16, heads, G.NCH, f + S.bias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  am_ln_kernel<<<S.row_blocks, 256, 0, st>>>(a, G, S.rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = G.DP == 32 ? am_launch_proj_attn<32>(a, G, S, st) : am_launch_proj_attn<16>(a, G, S, st);
  if (err != cudaSuccess) return (int)err;
  const long long nn = (long long)G.N * G.N;
  const long long n = heads * nn;
  am_dbias_reduce_kernel<<<(int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024), 256, 0, st>>>(
      a.dbias_part, heads, S.groups, nn, (float*)dbias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (G.NP) {
    case 16: err = am_launch_dln<16>(a, G, S, st); break;
    case 32: err = am_launch_dln<32>(a, G, S, st); break;
    case 48: err = am_launch_dln<48>(a, G, S, st); break;
    case 64: err = am_launch_dln<64>(a, G, S, st); break;
    case 96: err = am_launch_dln<96>(a, G, S, st); break;
    case 128: err = am_launch_dln<128>(a, G, S, st); break;
    default: err = am_launch_dln<184>(a, G, S, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  am_lnb_kernel<<<S.row_blocks, 256, 0, st>>>(a, G, S.rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // block b's partial is part s = b / sms of group b % sms: first the eight
  // of each group, then the groups, in order
  float* lnst1 = a.lnst + (long long)S.row_blocks * 2 * C;
  err = reduce_parts(a.lnst, S.row_blocks / sms, (long long)sms * 2 * C, lnst1, st);
  if (err != cudaSuccess) return (int)err;
  err = reduce_parts(lnst1, sms, 2LL * C, (float*)ds_db, st);
  if (err != cudaSuccess) return (int)err;
  err = am_wgrad(a.ln, G.SC, a.dqkv, G.K3, S.rows, C, G.K3, (float*)dwqkv, (float*)dbqkv, f + S.wg, sms, st);
  if (err != cudaSuccess) return (int)err;
  return (int)am_wgrad(a.att, G.HD, a.gb, G.SC, S.rows, G.HD, C, (float*)dwproj, (float*)dbproj, f + S.wg, sms, st);
}

#define ATTN_BWD_MMA_ENTRY(NAME, WS)                                                                              \
  extern "C" int NAME(const void* x, const void* g, void* dx, int B, int H, int W, int C, int heads, int shift,   \
                      int bias16,                                                                                 \
                      const void* ln_w, const void* ln_b, const void* bqkv, const void* relbias, const void* dp,  \
                      const void* wqkv, const void* wproj, const void* pack_index, long long pack_elems,          \
                      void* ds_db, void* dwqkv, void* dbqkv, void* dwproj, void* dbproj, void* dbias,             \
                      void* tscratch, long long t_elems, void* fscratch, long long f_elems, void* stream) {       \
    return am_run(WS, x, g, dx, B, H, W, C, heads, shift, bias16, ln_w, ln_b, bqkv, relbias, dp, wqkv, wproj,    \
                  (const int*)pack_index, pack_elems, ds_db, dwqkv, dbqkv, dwproj, dbproj, dbias, tscratch,      \
                  t_elems, fscratch, f_elems, stream);                                                            \
  }

ATTN_BWD_MMA_ENTRY(attn_bwd_mma_bf16, 8)
ATTN_BWD_MMA_ENTRY(attn_bwd16_mma_bf16, 16)
