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
// _mlp_kernel at :882) in bf16, both variants; f32, the checks' dtype, keeps
// mlp_block.cuh, and so does B10's MLP tail (ocab.cu). Rounding points as
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
// up to 184, hidden up to 384; the wrapper routes anything else.
#include "am_common.cuh"

constexpr int MF_CHUNK = 64;  // hidden units a chunk
constexpr int MF_MAX_HIDDEN = 6 * MF_CHUNK;

// fc2's product width for C columns: the register-A wgmma widths wgmma.cuh has.
__host__ __device__ inline int mf_np(int C) {
  return C <= 32 ? 32 : C <= 64 ? 64 : C <= 96 ? 96 : C <= 128 ? 128 : 184;
}

// The geometry, shared by the kernel and the host; the packed layout is
// mirrored by ops/cuda/mlp_block.py _mma_pack_index.
struct MfGeom {
  int C, hidden, KC, HP, NP, chunks;
  __host__ __device__ MfGeom(int C_, int hidden_) : C(C_), hidden(hidden_) {
    KC = am_pad16(C);
    HP = (hidden + MF_CHUNK - 1) / MF_CHUNK * MF_CHUNK;
    NP = mf_np(C);
    chunks = HP / MF_CHUNK;
  }
  // stage j: fc1's columns of chunk j / 2 (KC x 64) for even j, fc2's rows (64 x NP) for odd
  __host__ __device__ int stage_elems(int j) const { return j & 1 ? MF_CHUNK * NP : KC * MF_CHUNK; }
  __host__ __device__ long long pack_elems() const { return (long long)chunks * (KC + NP) * MF_CHUNK; }
};

struct MfArgs {
  const bf16 *x, *extra;
  bf16* out;
  const float *ln_w, *ln_b, *b1, *b2, *dp, *escale;
  const bf16* w;  // the packed weights
  long long rows;
  int tiles, rps;
};

// The ring, its barriers and stage table, then each warpgroup's K-major LN
// tile (64 x KC): 147,840 bytes at C 180.
__host__ __device__ inline size_t mf_smem(const MfGeom& G) {
  return (size_t)AM_SLOTS * AM_SLOT_BYTES + AM_HEAD_BYTES + 2 * (size_t)AM_TOK * G.KC * 2;
}

// LN (eps 1e-5, f32 statistics) of this warp's 16 rows, from row r0 on, into
// rows t0 .. t0 + 15 of the warpgroup's K-major LN tile (KC columns, zero
// past C and in rows past the last), of x' = x + extra * escale with EXTRA.
// Eight rows at a time: lane 8 q + i takes row i and the 4-column groups q,
// q + 4, ..., all loaded before the first sum, and the four lanes of a row
// reduce with two shuffles.
template <bool EXTRA>
__device__ __forceinline__ void mf_layernorm16(const MfArgs& a, const MfGeom& G, long long r0, bf16* lnb, int t0) {
  constexpr int GMAX = AM_MAX_C / 16 + 1;  // 4-column groups a lane, at most (KC / 4 / 4 = 12)
  const int lane = threadIdx.x & 31, ri = lane & 7, cq = lane >> 3, C = G.C, NG = C / 4, KG = G.KC / 4;
  for (int rg = 0; rg < 16; rg += 8) {
    const long long row = r0 + rg + ri;
    const bool in = row < a.rows;
    float v[GMAX][4];
#pragma unroll
    for (int i = 0; i < GMAX; ++i) {
      const int g = cq + 4 * i;
      uint2 ux = make_uint2(0u, 0u), ue = make_uint2(0u, 0u);
      if (in && g < NG) {
        ux = *reinterpret_cast<const uint2*>(a.x + row * C + 4 * g);
        if (EXTRA) ue = *reinterpret_cast<const uint2*>(a.extra + row * C + 4 * g);
      }
      const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ux.x));
      const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ux.y));
      v[i][0] = x0.x, v[i][1] = x0.y, v[i][2] = x1.x, v[i][3] = x1.y;
      if (EXTRA && in && g < NG) {
        const float2 e0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ue.x));
        const float2 e1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ue.y));
        const float4 es = *reinterpret_cast<const float4*>(a.escale + 4 * g);
        v[i][0] = fmaf(e0.x, es.x, v[i][0]), v[i][1] = fmaf(e0.y, es.y, v[i][1]);
        v[i][2] = fmaf(e1.x, es.z, v[i][2]), v[i][3] = fmaf(e1.y, es.w, v[i][3]);
      }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < GMAX; ++i) s += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    const float mean = s / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < GMAX; ++i)
      if (cq + 4 * i < NG)
#pragma unroll
        for (int e = 0; e < 4; ++e) q += (v[i][e] - mean) * (v[i][e] - mean);
    q += __shfl_xor_sync(0xffffffffu, q, 8);
    q += __shfl_xor_sync(0xffffffffu, q, 16);
    const float rstd = rsqrtf(q / C + 1e-5f);
#pragma unroll
    for (int i = 0; i < GMAX; ++i) {
      const int g = cq + 4 * i;
      if (g >= KG) continue;
      uint2 o = make_uint2(0u, 0u);
      if (in && g < NG) {
        const float4 w = *reinterpret_cast<const float4*>(a.ln_w + 4 * g);
        const float4 b = *reinterpret_cast<const float4*>(a.ln_b + 4 * g);
        o.x = hm_pack((v[i][0] - mean) * rstd * w.x + b.x, (v[i][1] - mean) * rstd * w.y + b.y);
        o.y = hm_pack((v[i][2] - mean) * rstd * w.z + b.z, (v[i][3] - mean) * rstd * w.w + b.w);
      }
      *reinterpret_cast<uint2*>(lnb + am_kmajor(4 * g, t0 + rg + ri, G.KC)) = o;
    }
  }
}

// One warpgroup a 64-row tile, two a block, persistent over tile pairs. A
// warpgroup whose tile lies past the last (an odd tile count) runs the
// products on a zero LN tile, so that every warp takes every stage of the
// ring, and stores nothing.
template <int NP, bool EXTRA>
__global__ void __launch_bounds__(256, 1) mf_kernel(const MfArgs a, const MfGeom G) {
  constexpr int NT = NP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int wg = warp >> 2, wr = warp & 3;
  bf16* lnb = (bf16*)(smem + AM_SLOTS * AM_SLOT_BYTES + AM_HEAD_BYTES) + (size_t)wg * AM_TOK * G.KC;
  const int npairs = (a.tiles + 1) / 2, nst = 2 * G.chunks;
  const int pairs = blockIdx.x < npairs ? (npairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  AmRing ring = am_ring_start(smem, a.w, nst, nst * pairs, 8, [&](int j) { return G.stage_elems(j); });
  const int KC = G.KC;
  for (int p = blockIdx.x; p < npairs; p += gridDim.x) {
    const long long row0 = (long long)(2 * p + wg) * AM_TOK;
    am_wg_sync(wg);  // the warpgroup's last products are done with its LN tile
    mf_layernorm16<EXTRA>(a, G, row0 + 16 * wr, lnb, 16 * wr);
    wg_proxy_fence();
    am_wg_sync(wg);  // the LN tile is in, for wgmma
    float acc[NT][4];
#pragma unroll 1
    for (int ch = 0; ch < G.chunks; ++ch) {
      uint32_t ha[4][4];  // gelu(fc1 + b1) of the chunk, rounded: fc2's A fragments
      {
        float af[8][4];
        const bf16* w1 = ring.acquire();
        wg_fence();
        for (int kk = 0; kk < KC; kk += 16)
          wg_ss<64>(&af[0][0], wg_desc(lnb + kk * 8, 128, KC * 16), wg_desc(w1 + kk * 8, 128, KC * 16), kk > 0);
        wg_commit();
        wg_wait0();
        wg_hold<32>(&af[0][0]);
        ring.release();
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int j = ch * MF_CHUNK + nt * 8 + 2 * tq;
          const float bj0 = j < G.hidden ? __ldg(a.b1 + j) : 0.f, bj1 = j + 1 < G.hidden ? __ldg(a.b1 + j + 1) : 0.f;
          float gl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float h = af[nt][e] + (e & 1 ? bj1 : bj0);
            float cdf, pdf;
            am_gauss(h, cdf, pdf);
            gl[e] = h * cdf;
          }
          ha[nt >> 1][(nt & 1) * 2] = hm_pack(gl[0], gl[1]);
          ha[nt >> 1][(nt & 1) * 2 + 1] = hm_pack(gl[2], gl[3]);
        }
      }
      const bf16* w2 = ring.acquire();
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wg_rs<NP>(&acc[0][0], ha[ks], wg_desc(w2 + ks * 128, 128, MF_CHUNK * 16), ch > 0 || ks > 0);
      wg_commit();
      wg_wait0();
      wg_hold<NP / 2>(&acc[0][0]);
      wg_hold<16>(&ha[0][0]);
      ring.release();
    }
    // y = x + d (acc + b2), or x' + (acc + b2), rounded, at rows r, r + 8;
    // in two halves of the columns, each half's loads before its stores
    const long long r = row0 + 16 * wr + gq;
    const bool in[2] = {r < a.rows, r + 8 < a.rows};
    float dd[2] = {1.f, 1.f};
    if (!EXTRA && a.dp)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) dd[hh] = in[hh] ? a.dp[(r + 8 * hh) / a.rps] : 0.f;
    constexpr int HALF = (NT + 1) / 2;
#pragma unroll
    for (int h0 = 0; h0 < NT; h0 += HALF) {
      uint32_t xv[HALF][2], ev[HALF][2];
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const int c = (h0 + i) * 8 + 2 * tq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const bool ok = h0 + i < NT && c < G.C && in[hh];
          const long long o = (r + 8 * hh) * G.C + c;
          xv[i][hh] = ok ? *reinterpret_cast<const uint32_t*>(a.x + o) : 0u;
          ev[i][hh] = EXTRA && ok ? *reinterpret_cast<const uint32_t*>(a.extra + o) : 0u;
        }
      }
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const int nt = h0 + i, c = nt * 8 + 2 * tq;
        if (nt >= NT || c >= G.C) continue;
        const float b0 = __ldg(a.b2 + c), b1 = __ldg(a.b2 + c + 1);
        float2 es = make_float2(0.f, 0.f);
        if (EXTRA) es = *reinterpret_cast<const float2*>(a.escale + c);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (!in[hh]) continue;
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv[i][hh]));
          float y0, y1;
          if (EXTRA) {
            const float2 e = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ev[i][hh]));
            y0 = fmaf(e.x, es.x, x.x) + (acc[nt][2 * hh] + b0);
            y1 = fmaf(e.y, es.y, x.y) + (acc[nt][2 * hh + 1] + b1);
          } else {
            y0 = x.x + dd[hh] * (acc[nt][2 * hh] + b0);
            y1 = x.y + dd[hh] * (acc[nt][2 * hh + 1] + b1);
          }
          *reinterpret_cast<__nv_bfloat162*>(a.out + (r + 8 * hh) * G.C + c) = __floats2bfloat162_rn(y0, y1);
        }
      }
    }
  }
}

static bool mf_geometry_ok(int C, int hidden) {
  return C >= 4 && C <= AM_MAX_C && C % 4 == 0 && hidden >= 1 && hidden <= MF_MAX_HIDDEN;
}

template <int NP, bool EXTRA>
static cudaError_t mf_launch(const MfArgs& a, const MfGeom& G, int blocks, cudaStream_t stream) {
  const size_t bytes = mf_smem(G);
  cudaError_t err = allow_smem(mf_kernel<NP, EXTRA>, bytes);
  if (err != cudaSuccess) return err;
  mf_kernel<NP, EXTRA><<<blocks, 256, bytes, stream>>>(a, G);
  return cudaGetLastError();
}

// packed: the blob of pack_mlp_block, or null, and then w1 (C x hidden) and
// w2 (hidden x C), (in, out) layout, are gathered by pack_index into the
// scratch (pack_elems bf16).
template <bool EXTRA>
static int mf_run(const void* x, const void* extra, void* out, int rows, int C, int hidden, const void* ln_w,
                  const void* ln_b, const void* w1, const void* b1, const void* w2, const void* b2, const void* dp,
                  int rows_per_sample, const void* escale, const int* pack_index, const void* packed,
                  long long pack_elems, void* scratch, void* stream) {
  if (!mf_geometry_ok(C, hidden) || rows < 1 || (dp && rows_per_sample <= 0) || (EXTRA && (!extra || !escale)))
    return (int)cudaErrorInvalidValue;
  const MfGeom G(C, hidden);
  if (G.pack_elems() != pack_elems || (!packed && !(w1 && w2 && pack_index && scratch)))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 8 || (uintptr_t)out % 8 || (EXTRA && (uintptr_t)extra % 8) || (uintptr_t)packed % 16 ||
      (uintptr_t)scratch % 16 || (uintptr_t)ln_w % 16 || (uintptr_t)ln_b % 16 || (EXTRA && (uintptr_t)escale % 16))
    return (int)cudaErrorMisalignedAddress;
  int sms = 0;
  cudaError_t err = am_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  MfArgs a{};
  a.x = (const bf16*)x, a.extra = (const bf16*)extra, a.out = (bf16*)out;
  a.ln_w = (const float*)ln_w, a.ln_b = (const float*)ln_b, a.b1 = (const float*)b1, a.b2 = (const float*)b2;
  a.dp = (const float*)dp, a.escale = (const float*)escale;
  a.rows = rows, a.tiles = (rows + AM_TOK - 1) / AM_TOK, a.rps = rows_per_sample;
  if (packed) {
    a.w = (const bf16*)packed;
  } else {
    const long long n1 = (long long)C * hidden;
    err = am_pack((const bf16*)w1, n1, (const bf16*)w2, n1, pack_index, pack_elems, (bf16*)scratch, st);
    if (err != cudaSuccess) return (int)err;
    a.w = (const bf16*)scratch;
  }
  const int npairs = (a.tiles + 1) / 2, blocks = npairs < sms ? npairs : sms;
  switch (G.NP) {
    case 32: return (int)mf_launch<32, EXTRA>(a, G, blocks, st);
    case 64: return (int)mf_launch<64, EXTRA>(a, G, blocks, st);
    case 96: return (int)mf_launch<96, EXTRA>(a, G, blocks, st);
    case 128: return (int)mf_launch<128, EXTRA>(a, G, blocks, st);
    default: return (int)mf_launch<184, EXTRA>(a, G, blocks, st);
  }
}

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
