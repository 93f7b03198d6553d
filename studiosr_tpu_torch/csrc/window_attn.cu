// B15: the window-attention core,
//   out = softmax(q k^T + bias + mask) v
// on q (B', heads, N, d), already scaled by 1/sqrt(d), k and v (B', heads,
// M, d), an optional f32 bias (heads, N, M) (none: a zero bias, MaxSR's
// adaptive mode) and an optional f32 mask (nW, N, M), window b' taking mask
// b' mod nW (B' = images x nW windows in row-major order).
//
// Replaces studiosr_tpu/ops/pallas/window_attn.py::window_attention_pallas
// (:115; _window_attention_impl, kernel _kernel). The TPU kernel holds a
// block of windows' (N, M) f32 scores in VMEM, takes its mask only where the
// window count equals the batch (batch 1) and N, M <= 1024; it subtracts the
// row max, and rounds the probabilities to v's dtype before the product with
// v. Here the contract is attention_core's: any batch of images under one
// mask. N, M <= 1024 (the wrapper raises above), d <= 64.
//
// Bound on the card at MaxSR's adaptive serving shapes (256 windows of 256
// tokens, 4 heads, d 32, bf16): 4 B' heads N M d = 8.6 GFLOP against 67 MB
// (q, k, v read, out written), bound by bytes (0.020 ms); the static mode
// (1024 windows of 64 tokens and a 64 KB bias) moves the same bytes.
//
// bf16, every shape (wf_kernel): a forward kernel of its own, built so that
// each byte of q, k, v and out crosses the chip once.
// * A block of four warps owns one head (and, with a mask, one mask window)
//   and walks several windows of it; the grid fills the card once
//   (occupancy x SMs blocks; at d <= 32 four an SM, registers held to 128
//   a thread). A unit is one (window, head).
// * K and V of a unit go to shared memory once, in 64-key chunks, each its
//   own cp.async group, so the first chunk's products start while the last
//   is in flight; every query of the unit is served from them: warps take
//   16 query rows at a time and loop over the unit's queries. The other
//   blocks of the SM hide a block's loads (a second unit buffer, loading
//   the next window during this one, measured no faster). Where one unit
//   does not fit (M 1024 at d > 32), the chunks stream through a ring.
// * Copies are as wide as the operands allow: 16 bytes when rows, strides
//   and base are 16-byte aligned (MaxSR's q, k, v, out at d 32), 8 or 4
//   otherwise (MaxSR light's d 12), 2 for odd ones; columns d .. pad16(d)
//   and rows past N or M are zero-filled by the copy itself.
// * The bias (+ mask) tile of the block's head (and mask window) is staged
//   once in shared memory when it fits (pad16(N) x (pad64(M) + 8) f32 up to
//   64 KB; MaxSR static's is 18 KB), else read from device memory per score.
// * Scores, the max-subtracted softmax (ex2.approx, log2 e folded into one
//   FMA) and P V stay in registers on mma.sync m16n8k16; the unnormalised
//   probabilities are rounded to bf16 for P V and the f32 row sum divided
//   out at the end. A warp loads q when its tile starts: prefetched into
//   registers a tile ahead it measured no faster.
// * The output is normalised in registers, staged through the warp's q tile
//   and stored in whole rows (16 bytes a piece at d 32) into the transposed
//   (B', N, heads, d) layout.
//
// f32 (the checks' dtype) keeps attn_core.cuh's shared-memory row pass.
#include "attn_core.cuh"
#include "hopper_mma.cuh"

// Strides, in elements, of q, k, v, out: (window, head, token) each.
enum { WA_Q, WA_K, WA_V, WA_O, WA_N };

constexpr int WA_MAX_TOKENS = 1024;  // window_attn.py's limit on N and M

static bool wa_shape_ok(long long bw, int heads, int nq, int nk, int d, int nw) {
  return bw > 0 && heads > 0 && nq > 0 && nq <= WA_MAX_TOKENS && nk > 0 && nk <= WA_MAX_TOKENS && d > 0 &&
         pad16(d) <= 64 && nw > 0 && bw % nw == 0;
}

// -- f32: attn_core.cuh's forward row pass ---------------------------------------

struct WinGeomF32 {
  const float *qp, *kp, *vp;
  float* op;
  long long st[WA_N][3];
  const float* relbias;  // (heads, nq, nk) or null
  const float* mask;     // (nw, nq, nk) or null
  long long units;
  int heads, nq, nk, d, nw;
  float dq_scale;
  static constexpr bool PADDED = false;

  __host__ __device__ bool mma_rows() const { return false; }

  struct Unit {
    const float *q0, *k0, *v0;
    float* o0;
    long long sq, sk, sv, so, id;
    const float *b, *m;
    int nq, nk;
    __device__ const float* q(int r) const { return r < nq ? q0 + r * sq : nullptr; }
    __device__ const float* g(int) const { return nullptr; }
    __device__ const float* k(int t) const { return t < nk ? k0 + t * sk : nullptr; }
    __device__ const float* v(int t) const { return t < nk ? v0 + t * sv : nullptr; }
    __device__ float bias(int r, int t) const {
      const size_t i = (size_t)r * nk + t;
      return (b ? b[i] : 0.f) + (m ? m[i] : 0.f);
    }
    __device__ void put_o(int r, int j, float x) const { o0[r * so + j] = x; }
    // The row pass's backward modes are not instantiated for this geometry.
    __device__ void put_dq(int, int, float) const {}
    __device__ void put_dk(int, int, float) const {}
    __device__ void put_dv(int, int, float) const {}
  };
  __device__ Unit unit(long long u) const {
    const long long w = u / heads, h = u % heads;
    auto at = [&](int which) { return w * st[which][0] + h * st[which][1]; };
    return Unit{qp + at(WA_Q), kp + at(WA_K), vp + at(WA_V), op + at(WA_O), st[WA_Q][2], st[WA_K][2], st[WA_V][2],
                st[WA_O][2], u, relbias ? relbias + (size_t)h * nq * nk : nullptr,
                mask ? mask + (size_t)(w % nw) * nq * nk : nullptr, nq, nk};
  }
};

extern "C" int window_attn_f32(const void* q, const void* k, const void* v, const void* relbias, const void* mask,
                               void* out, const long long* strides, long long bw, int heads, int nq, int nk, int d,
                               int nw, void* stream) {
  if (!wa_shape_ok(bw, heads, nq, nk, d, nw)) return (int)cudaErrorInvalidValue;
  WinGeomF32 G;
  G.qp = (const float*)q;
  G.kp = (const float*)k;
  G.vp = (const float*)v;
  G.op = (float*)out;
  for (int i = 0; i < WA_N; ++i)
    for (int j = 0; j < 3; ++j) G.st[i][j] = strides[3 * i + j];
  G.relbias = (const float*)relbias;
  G.mask = (const float*)mask;
  G.units = bw * heads;
  G.heads = heads;
  G.nq = nq;
  G.nk = nk;
  G.d = d;
  G.nw = nw;
  G.dq_scale = 1.f;
  return (int)ac_forward<float>(G, (cudaStream_t)stream);
}

// -- bf16: wf_kernel ----------------------------------------------------------------

constexpr int WF_WARPS = 4, WF_THREADS = 32 * WF_WARPS;
constexpr int WF_CHUNK = 64;                       // keys a chunk (one cp.async group of K and V rows)
constexpr size_t WF_BIAS_SMEM_MAX = 64 * 1024;     // a larger bias (+ mask) tile is read from device memory
constexpr size_t WF_SMEM_MAX = 220 * 1024;         // one unit resident up to this, else a ring of chunks
constexpr float WF_LOG2E = 1.4426950408889634f;
enum { WF_BIAS_NONE = 0, WF_BIAS_SMEM = 1, WF_BIAS_GLOBAL = 2 };

struct WfArgs {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  long long st[WA_N][3];       // (window, head, token) strides in elements
  const float *bias, *mask;    // (heads, nq, nk), (nw, nq, nk) or null
  int bw, heads, nq, nk, d, nw;
  int nwm;                     // mask windows the blocks split over: nw with a mask, else 1
  int groups;                  // blocks per (head, mask window)
  int width[WA_N];             // copy widths in bytes: 16, 8, 4 or 2
  int slots;                   // 0: a unit's chunks all resident; else a ring of this many
};

// rows x DP bf16 tile at dst (stride LD) <- rows of src (stride rs elements):
// row r < valid, columns < d; zeros elsewhere. Threads t, t + nthr, ... share
// the pieces. cp.async for widths 4-16 (the caller commits), plain
// loads and stores for 2.
template <int DP, int LD>
__device__ __forceinline__ void wf_stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, long long rs, int rows,
                                              int valid, int d, int width, int t, int nthr) {
  auto run = [&](auto bytes_c) {
    constexpr int BYTES = decltype(bytes_c)::value, E = BYTES / 2, PER = DP / E;
    for (int i = t; i < rows * PER; i += nthr) {
      const int r = i / PER, c = (i - r * PER) * E;
      const bool ok = r < valid && c < d;
      if constexpr (BYTES >= 4) {
        hm_cp_async<BYTES>(dst + r * LD + c, ok ? src + r * rs + c : src, ok);
      } else {
        dst[r * LD + c] = ok ? src[r * rs + c] : __float2bfloat16(0.f);
      }
    }
  };
  switch (width) {
    case 16: run(std::integral_constant<int, 16>{}); break;
    case 8: run(std::integral_constant<int, 8>{}); break;
    case 4: run(std::integral_constant<int, 4>{}); break;
    default: run(std::integral_constant<int, 2>{}); break;
  }
}

// A warp's 16 q rows into its tile (stride LD) by plain loads and stores in
// pieces of `width` bytes: rows < valid, columns < d; zeros elsewhere.
template <int DP, int LD>
__device__ __forceinline__ void wf_load_q(__nv_bfloat16* tile, const __nv_bfloat16* src, long long rs, int valid,
                                          int d, int width) {
  const int lane = threadIdx.x & 31;
  auto run = [&](auto bytes_c) {
    constexpr int BYTES = decltype(bytes_c)::value, E = BYTES / 2, PER = DP / E;
    using V = typename std::conditional<BYTES == 16, uint4,
              typename std::conditional<BYTES == 8, uint2,
              typename std::conditional<BYTES == 4, uint32_t, unsigned short>::type>::type>::type;
    for (int i = lane; i < 16 * PER; i += 32) {
      const int r = i / PER, c = (i - r * PER) * E;
      V x{};
      if (r < valid && c < d) x = __ldg(reinterpret_cast<const V*>(src + r * rs + c));
      *reinterpret_cast<V*>(tile + r * LD + c) = x;
    }
  };
  switch (width) {
    case 16: run(std::integral_constant<int, 16>{}); break;
    case 8: run(std::integral_constant<int, 8>{}); break;
    case 4: run(std::integral_constant<int, 4>{}); break;
    default: run(std::integral_constant<int, 2>{}); break;
  }
}

// Store a warp's 16 output rows (bf16 in its tile) to rows of dst (stride
// rs): rows < valid, columns < d, in pieces of `width` bytes.
template <int DP>
__device__ __forceinline__ void wf_store_rows(__nv_bfloat16* dst, long long rs, int valid, int d, int width,
                                              const __nv_bfloat16* tile, int ld) {
  const int lane = threadIdx.x & 31;
  auto run = [&](auto bytes_c) {
    constexpr int BYTES = decltype(bytes_c)::value, E = BYTES / 2, PER = DP / E;
    for (int i = lane; i < 16 * PER; i += 32) {
      const int r = i / PER, c = (i - r * PER) * E;
      if (r >= valid || c >= d) continue;
      const __nv_bfloat16* s = tile + r * ld + c;
      __nv_bfloat16* p = dst + r * rs + c;
      if constexpr (BYTES == 16) *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(s);
      else if constexpr (BYTES == 8) *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(s);
      else if constexpr (BYTES == 4) *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(s);
      else *p = *s;
    }
  };
  switch (width) {
    case 16: run(std::integral_constant<int, 16>{}); break;
    case 8: run(std::integral_constant<int, 8>{}); break;
    case 4: run(std::integral_constant<int, 4>{}); break;
    default: run(std::integral_constant<int, 2>{}); break;
  }
}

__device__ __forceinline__ float wf_exp2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory: the K / V chunks (each 64 x LQ of K, then of V), the warps'
// q / out tiles (16 x LQ each), the f32 bias tile (pad16(nq) x LB).
__host__ __device__ inline int wf_lq(int DP) { return DP + 8; }  // 16-byte skew: ldmatrix rows on distinct banks
__host__ __device__ inline int wf_lb(int nk) { return pad64(nk) + 8; }  // float2 reads of 8 rows on distinct banks
__host__ __device__ inline size_t wf_chunk_bytes(int DP) { return (size_t)2 * WF_CHUNK * wf_lq(DP) * 2; }
__host__ __device__ inline size_t wf_tiles_bytes(int DP) { return (size_t)WF_WARPS * 16 * wf_lq(DP) * 2; }
__host__ __device__ inline size_t wf_bias_bytes(int nq, int nk) { return (size_t)pad16(nq) * wf_lb(nk) * 4; }

template <int KS, int BIAS>
__global__ void __launch_bounds__(WF_THREADS, KS <= 2 ? 4 : 2) wf_kernel(const WfArgs a) {
  using T = __nv_bfloat16;
  constexpr int DP = 16 * KS, LQ = DP + 8, DT = 2 * KS, CH = WF_CHUNK * LQ;  // CH: elements of K (or V) a chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int nq = a.nq, nk = a.nk, d = a.d;
  const int nkc = (nk + WF_CHUNK - 1) / WF_CHUNK, ntq = (nq + 15) / 16, passes = (ntq + WF_WARPS - 1) / WF_WARPS;
  const int mine_passes = ntq > warp ? (ntq - warp + WF_WARPS - 1) / WF_WARPS : 0;
  const int classes = a.heads * a.nwm, cls = blockIdx.x % classes, grp = blockIdx.x / classes;
  const int h = cls / a.nwm, mw = cls % a.nwm;
  const int per_class = a.bw / a.nwm;
  const int units = grp < per_class ? (per_class - grp + a.groups - 1) / a.groups : 0;
  const bool ring = a.slots > 0;
  const int chunks = ring ? a.slots : nkc;
  T* kv = (T*)smem;
  T* tile = kv + (size_t)chunks * 2 * CH + warp * 16 * LQ;  // this warp's q / out tile
  float* btile = (float*)(kv + (size_t)chunks * 2 * CH + WF_WARPS * 16 * LQ);
  const int LB = wf_lb(nk);

  auto window = [&](int i) { return (long long)mw + (long long)a.nwm * (grp + (long long)a.groups * i); };
  auto base = [&](int which, int i) { return window(i) * a.st[which][0] + (long long)h * a.st[which][1]; };
  // K and V rows of chunk kc of unit i into chunk slot c, one cp.async group
  // (empty past the block's units).
  auto stage = [&](int i, int kc, int c) {
    if (i < units) {
      const int k0 = kc * WF_CHUNK;
      T* ks = kv + (size_t)c * 2 * CH;
      wf_stage_rows<DP, LQ>(ks, a.k + base(WA_K, i) + k0 * a.st[WA_K][2], a.st[WA_K][2], WF_CHUNK, nk - k0, d,
                            a.width[WA_K], tid, WF_THREADS);
      wf_stage_rows<DP, LQ>(ks + CH, a.v + base(WA_V, i) + k0 * a.st[WA_V][2], a.st[WA_V][2], WF_CHUNK, nk - k0,
                            d, a.width[WA_V], tid, WF_THREADS);
    }
    hm_cp_commit();
  };

  if constexpr (BIAS == WF_BIAS_SMEM) {  // visible after the first chunk's barrier
    const float* bh = a.bias ? a.bias + (size_t)h * nq * nk : nullptr;
    const float* mh = a.mask ? a.mask + (size_t)mw * nq * nk : nullptr;
    const int cols = pad64(nk);
    for (int i = tid; i < pad16(nq) * cols; i += WF_THREADS) {
      const int r = i / cols, c = i - r * cols;
      float x = 0.f;
      if (r < nq && c < nk) x = (bh ? bh[(size_t)r * nk + c] : 0.f) + (mh ? mh[(size_t)r * nk + c] : 0.f);
      btile[r * LB + c] = x;
    }
  }
  const float* gbias = BIAS == WF_BIAS_GLOBAL && a.bias ? a.bias + (size_t)h * nq * nk : nullptr;
  const float* gmask = BIAS == WF_BIAS_GLOBAL && a.mask ? a.mask + (size_t)mw * nq * nk : nullptr;

  const int uses_per_unit = passes * nkc;
  if (ring)
    for (int j = 0; j < a.slots - 1; ++j) stage(j / uses_per_unit, j % nkc, j);
  int use = 0;  // the ring's chunk uses so far
  for (int i = 0; i < units; ++i) {
    if (!ring) {
      __syncthreads();  // every warp is done with unit i - 1
      for (int kc = 0; kc < nkc; ++kc) stage(i, kc, kc);
    }
    T* const obase = a.o + base(WA_O, i);
    for (int p = 0; p < passes; ++p) {
      const bool mine = p < mine_passes;
      const int q0 = (p * WF_WARPS + warp) * 16;
      uint32_t qa[KS][4];
      if (mine) {
        wf_load_q<DP, LQ>(tile, a.q + base(WA_Q, i) + q0 * a.st[WA_Q][2], a.st[WA_Q][2], nq - q0, d, a.width[WA_Q]);
        __syncwarp();
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const int mi = lane >> 3;
          hm_ldsm_x4(qa[s][0], qa[s][1], qa[s][2], qa[s][3],
                     tile + ((mi & 1) * 8 + (lane & 7)) * LQ + s * 16 + (mi >> 1) * 8);
        }
      }
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      float o[DT][4];
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
      for (int kc = 0; kc < nkc; ++kc) {
        int c = kc;
        if (!ring) {
          if (p == 0) {  // chunk kc of this unit is in; later passes find every chunk in place
            hm_cp_wait_upto(nkc - 1 - kc);
            __syncthreads();
          }
        } else {
          c = use % a.slots;
          hm_cp_wait_upto(a.slots - 2);
          __syncthreads();  // use `use` is in; every warp is done with the slot refilled next
          const int nxt = use + a.slots - 1;
          stage(nxt / uses_per_unit, nxt % nkc, nxt % a.slots);
          ++use;
        }
        if (!mine) continue;
        const T* ks = kv + (size_t)c * 2 * CH;
        const T* vs = ks + CH;
        const int k0 = kc * WF_CHUNK;
        // s = q k^T (16 queries x 64 keys)
        float s[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
          const T* krow = ks + (nt * 8 + (lane & 7)) * LQ + (lane >> 3) * 8;
#pragma unroll
          for (int s2 = 0; s2 + 1 < KS; s2 += 2) {
            uint32_t b0, b1, b2, b3;
            hm_ldsm_x4(b0, b1, b2, b3, krow + s2 * 16);
            hm_mma(s[nt], qa[s2], b0, b1);
            hm_mma(s[nt], qa[s2 + 1], b2, b3);
          }
          if constexpr (KS & 1) {
            uint32_t b0, b1;
            hm_ldsm_x2(b0, b1, ks + (nt * 8 + (lane & 7)) * LQ + (KS - 1) * 16 + ((lane >> 3) & 1) * 8);
            hm_mma(s[nt], qa[KS - 1], b0, b1);
          }
        }
        if constexpr (BIAS == WF_BIAS_SMEM) {
          const float* br = btile + (q0 + gq) * LB + k0 + 2 * tq;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const float2 x0 = *reinterpret_cast<const float2*>(br + nt * 8);
            const float2 x1 = *reinterpret_cast<const float2*>(br + 8 * LB + nt * 8);
            s[nt][0] += x0.x, s[nt][1] += x0.y, s[nt][2] += x1.x, s[nt][3] += x1.y;
          }
        } else if constexpr (BIAS == WF_BIAS_GLOBAL) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = q0 + gq + 8 * (e >> 1), t = k0 + nt * 8 + 2 * tq + (e & 1);
              if (r < nq && t < nk) {
                const size_t at = (size_t)r * nk + t;
                s[nt][e] += (gbias ? gbias[at] : 0.f) + (gmask ? gmask[at] : 0.f);
              }
            }
        }
        if (k0 + WF_CHUNK > nk)  // the last chunk: keys past M take no weight
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k0 + nt * 8 + 2 * tq + (e & 1) >= nk) s[nt][e] = -INFINITY;
        // online softmax in base 2: p = 2^(s log2e - m log2e)
        float mb[2], corr[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
          const float mn = fmaxf(m[hh], quad_max(mx));
          mb[hh] = mn == -INFINITY ? 0.f : mn * WF_LOG2E;  // a row with no finite score yet keeps p = 0
          corr[hh] = wf_exp2(m[hh] * WF_LOG2E - mb[hh]);   // 0 at the first chunk (m = -inf)
          m[hh] = mn;
          l[hh] *= corr[hh];
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = wf_exp2(fmaf(s[nt][e], WF_LOG2E, -mb[e >> 1]));
            l[e >> 1] += pe;
            s[nt][e] = pe;
          }
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) {
          o[dn][0] *= corr[0];
          o[dn][1] *= corr[0];
          o[dn][2] *= corr[1];
          o[dn][3] *= corr[1];
        }
        // o += p v: p as a fragments (bf16), v through transposed ldmatrix
        uint32_t pa[4][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          pa[nt >> 1][(nt & 1) * 2] = hm_pack(s[nt][0], s[nt][1]);
          pa[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(s[nt][2], s[nt][3]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int mi = lane >> 3;
          const T* vrow = vs + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LQ + (mi >> 1) * 8;
#pragma unroll
          for (int dn = 0; dn < DT; dn += 2) {
            uint32_t b0, b1, b2, b3;
            hm_ldsm_x4_t(b0, b1, b2, b3, vrow + dn * 8);
            hm_mma(o[dn], pa[kk], b0, b1);
            hm_mma(o[dn + 1], pa[kk], b2, b3);
          }
        }
      }
      if (!mine) continue;
      // normalise, stage through the tile, store whole rows
      const float il0 = 1.f / quad_sum(l[0]), il1 = 1.f / quad_sum(l[1]);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        T* t0 = tile + gq * LQ + dn * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(t0) = hm_pack(o[dn][0] * il0, o[dn][1] * il0);
        *reinterpret_cast<uint32_t*>(t0 + 8 * LQ) = hm_pack(o[dn][2] * il1, o[dn][3] * il1);
      }
      __syncwarp();
      wf_store_rows<DP>(obase + q0 * a.st[WA_O][2], a.st[WA_O][2], nq - q0, d, a.width[WA_O], tile, LQ);
      __syncwarp();  // the tile takes the next q
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int KS, int BIAS>
static cudaError_t wf_launch(WfArgs a, cudaStream_t stream) {
  const int DP = 16 * KS, nkc = (a.nk + WF_CHUNK - 1) / WF_CHUNK;
  const size_t fixed = wf_tiles_bytes(DP) + (BIAS == WF_BIAS_SMEM ? wf_bias_bytes(a.nq, a.nk) : 0);
  const size_t chunk = wf_chunk_bytes(DP);
  a.slots = fixed + nkc * chunk <= WF_SMEM_MAX ? 0 : (int)((WF_SMEM_MAX - fixed) / chunk);
  const size_t bytes = fixed + (a.slots ? a.slots : nkc) * chunk;
  cudaError_t err = cudaFuncSetAttribute(wf_kernel<KS, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wf_kernel<KS, BIAS>, WF_THREADS, bytes);
  if (err != cudaSuccess) return err;
  const int classes = a.heads * a.nwm, per_class = a.bw / a.nwm;
  const long long target = (long long)(per_sm < 1 ? 1 : per_sm) * sms;
  long long groups = (target + classes - 1) / classes;
  if (groups > per_class) groups = per_class;
  a.groups = (int)groups;
  wf_kernel<KS, BIAS><<<(unsigned)(classes * groups), WF_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int KS>
static cudaError_t wf_dispatch_bias(const WfArgs& a, cudaStream_t stream) {
  if (!a.bias && !a.mask) return wf_launch<KS, WF_BIAS_NONE>(a, stream);
  if (wf_bias_bytes(a.nq, a.nk) <= WF_BIAS_SMEM_MAX) return wf_launch<KS, WF_BIAS_SMEM>(a, stream);
  return wf_launch<KS, WF_BIAS_GLOBAL>(a, stream);
}

extern "C" int window_attn_flash_bf16(const void* q, const void* k, const void* v, const void* relbias,
                                      const void* mask, void* out, const long long* strides, long long bw, int heads,
                                      int nq, int nk, int d, int nw, void* stream) {
  if (!wa_shape_ok(bw, heads, nq, nk, d, nw) || bw > INT32_MAX) return (int)cudaErrorInvalidValue;
  WfArgs a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.o = (__nv_bfloat16*)out;
  const void* ptrs[WA_N] = {q, k, v, out};
  for (int i = 0; i < WA_N; ++i) {
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
    a.width[i] = hm_copy_width(ptrs[i], d, a.st[i], 3);
  }
  a.bias = (const float*)relbias;
  a.mask = (const float*)mask;
  a.bw = (int)bw;
  a.heads = heads;
  a.nq = nq;
  a.nk = nk;
  a.d = d;
  a.nw = nw;
  a.nwm = mask ? nw : 1;
  a.groups = 1;
  a.slots = 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (pad16(d) / 16) {
    case 1: return (int)wf_dispatch_bias<1>(a, s);
    case 2: return (int)wf_dispatch_bias<2>(a, s);
    case 3: return (int)wf_dispatch_bias<3>(a, s);
    default: return (int)wf_dispatch_bias<4>(a, s);
  }
}
