// The attention pass the f32 window kernels share at windows 9..16 (two to
// four 64-token tiles a window, am_window.cuh's AmGeom): B5's forward
// (window_attention_f32.cu, window_attention16_mma_f32) and the first sweep
// of B9's backward (attn_bwd_f32.cu, attn_bwd16_mma_f32), every product
// 3xTF32 on mma.sync.m16n8k8 (tf32x3.cuh).
//
// tw_rows_kernel: a block of eight warps owns (head h, group of windows) and
// walks the group's windows. A window's N keys (k and v of head h, N x DP
// f32 from the q|k|v rows in tile order) come in by cp.async a window ahead
// and are split once into hi / lo images that stay in shared memory while
// the eight warps take the window's query rows 16 at a time (rows 16 j ..
// 16 j + 15 to warp j % 8): q (and, in the backward, dattn) split in
// registers, then for each 64-key chunk the scores (and dprobs = dattn
// v^T), the bias read in fragment order (am_bias_kernel's copy: -inf at the
// padding keys, 0 at the padding queries), the -100 mask of the shifted
// map from the keys' regions, the online softmax in base 2 (max-subtracted,
// ex2.approx) and o += p v with p as A fragments straight from the score
// fragments (key 8 kb + 2t + e is A column t + 4 e of step kb, v's rows
// read in that order; a fresh accumulator for each 32 keys). Out: attn =
// o / l, to the queries' own pixel rows in the forward (padding queries
// dropped), in tile order in the backward with the row statistics (m in
// base 2, 1 / l, D = sum p dprobs) that B9's second sweep reads.
// Shared memory: 6 N (DP + 4) + N words, 222,208 bytes at N 256, DP 32: one
// block an SM.
#pragma once

#include "am_window.cuh"
#include "tf32x3.cuh"

constexpr int TW_THREADS = 256, TW_WARPS = TW_THREADS / 32;

struct TwRows {
  AmArgs geo;           // H, W, shift, nwx, nwi: the token geometry am_pixel and am_region read
  const float* qkv;     // q|k|v rows (K3 a row) in tile order, q scaled, each head padded to DP
  const float* dattn;   // the backward: dattn rows (HD a row) in tile order
  const float4* bfrag;  // the bias in fragment order (am_bias_kernel, f32)
  float* att;           // attn rows (HD a row): at the pixels in the forward, in tile order in the backward
  float* stats;         // the backward: (m, 1 / l, D) of (window, head, query row), QR rows a (window, head)
  long long windows;
  int groups, QR;
};

__host__ __device__ inline size_t tw_rows_smem(int N, int DP) { return ((size_t)6 * N * (DP + 4) + N) * 4; }

// The blocks an SM of tw_rows_kernel (one) times the SMs, a head each.
__host__ inline int tw_rows_groups(long long windows, int heads, int sms) {
  const long long g = (sms + heads - 1) / heads;
  return (int)(g < windows ? g : windows);
}

template <int DP, bool BWD>
__global__ void __launch_bounds__(TW_THREADS, 1) tw_rows_kernel(const TwRows a, const AmGeom G) {
  constexpr int LD = DP + 4, KS = DP / 8, NDT = DP / 8;
  extern __shared__ __align__(16) float tw_sm[];
  const int N = G.N, NCH = G.NCH, NV = G.NV, KV = N * LD;
  uint32_t* kvs = reinterpret_cast<uint32_t*>(tw_sm);  // k hi, k lo, v hi, v lo
  float* stage = tw_sm + 4 * KV;                       // the next window's k, v in f32
  int* reg = reinterpret_cast<int*>(stage + 2 * KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x % G.heads, gi = blockIdx.x / G.heads;
  // window w's k and v of head h into the stage, one cp.async group
  auto load = [&](long long w) {
    const float* src = a.qkv + w * N * G.K3 + G.HD + h * DP;
    for (int i = tid; i < 2 * N * (DP / 4); i += TW_THREADS) {
      const int which = i / (N * (DP / 4)), rem = i % (N * (DP / 4)), r = rem / (DP / 4), c4 = rem % (DP / 4);
      hm_cp_async<16>(stage + which * KV + r * LD + 4 * c4, src + (long long)r * G.K3 + which * G.HD + 4 * c4, true);
    }
    hm_cp_commit();
  };
  load(gi);
  for (long long w = gi; w < a.windows; w += a.groups) {
    hm_cp_wait_upto(0);
    __syncthreads();  // window w's rows are in; every warp is done with the last window's images and regions
    tf_split_rows<DP, LD, TW_THREADS>(stage, kvs, kvs + KV, N);
    tf_split_rows<DP, LD, TW_THREADS>(stage + KV, kvs + 2 * KV, kvs + 3 * KV, N);
    if (a.geo.shift)
      for (int k = tid; k < N; k += TW_THREADS) reg[k] = k < NV ? am_region(G, a.geo, (int)(w % a.geo.nwi), k) : -1;
    __syncthreads();  // the images and regions are in; the stage is free
    if (w + a.groups < a.windows) load(w + a.groups);
    for (int j = warp; j < N / 16; j += TW_WARPS) {
      const long long row0 = w * N + 16 * j;  // the rows' first token row
      uint32_t qh[KS][4], ql[KS][4], gh[BWD ? KS : 1][4], gl[BWD ? KS : 1][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        tf_afrag(a.qkv + row0 * G.K3 + h * DP, G.K3, ks, qh[ks], ql[ks]);
        if constexpr (BWD) tf_afrag(a.dattn + row0 * G.HD + h * DP, G.HD, ks, gh[ks], gl[ks]);
      }
      const int rows[2] = {16 * j + g, 16 * j + g + 8};
      const bool shift = a.geo.shift != 0;
      const int rreg[2] = {shift && rows[0] < NV ? reg[rows[0]] : -1, shift && rows[1] < NV ? reg[rows[1]] : -1};
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, us[2] = {0.f, 0.f}, o[NDT][4];
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
#pragma unroll 1
      for (int c = 0; c < NCH; ++c) {
        const float4* bf = a.bfrag + ((size_t)(h * NCH + (j >> 2)) * NCH + c) * 1024 + 32 * (j & 3) + lane;
        float4 bb[8];  // loaded before the products, so their latency hides under them
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) bb[nt] = __ldg(bf + 128 * nt);
        const uint32_t* Kh = kvs + c * AM_TOK * LD;
        const uint32_t *Kl = Kh + KV, *Vh = Kh + 2 * KV, *Vl = Kh + 3 * KV;
        float s[8][4], dp[8][4];
        if constexpr (BWD) {
          tf_scores<KS, LD>(
              s, dp,
              [&](int ks, uint32_t (&a0)[4], uint32_t (&a1)[4], uint32_t (&b0)[4], uint32_t (&b1)[4]) {
#pragma unroll
                for (int i = 0; i < 4; ++i) a0[i] = qh[ks][i], a1[i] = ql[ks][i], b0[i] = gh[ks][i], b1[i] = gl[ks][i];
              },
              Kh, Kl, Vh, Vl);
        } else {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int nt = 0; nt < 8; nt += 2) {
              const int at = (8 * nt + g) * LD + 8 * ks + t;
              const uint32_t k0h[2] = {Kh[at], Kh[at + 4]}, k0l[2] = {Kl[at], Kl[at + 4]};
              const uint32_t k1h[2] = {Kh[at + 8 * LD], Kh[at + 8 * LD + 4]};
              const uint32_t k1l[2] = {Kl[at + 8 * LD], Kl[at + 8 * LD + 4]};
              tf_mma3x2(s[nt], qh[ks], ql[ks], k0h, k0l, s[nt + 1], qh[ks], ql[ks], k1h, k1l);
            }
        }
        // the bias, the shifted map's mask, the online softmax
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float b4[4] = {bb[nt].x, bb[nt].y, bb[nt].z, bb[nt].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c * AM_TOK + 8 * nt + 2 * t + (e & 1);
            const bool masked = rreg[e >> 1] >= 0 && col < NV && reg[col] != rreg[e >> 1];
            s[nt][e] += masked ? b4[e] - 100.f : b4[e];
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
          const float mn = fmaxf(m[hh], am_quad_max(mx) * AM_LOG2E), sc = am_exp2(m[hh] - mn);
          l[hh] *= sc, us[hh] *= sc, m[hh] = mn;
#pragma unroll
          for (int nd = 0; nd < NDT; ++nd) o[nd][2 * hh] *= sc, o[nd][2 * hh + 1] *= sc;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = am_exp2(fmaf(s[nt][2 * hh + e], AM_LOG2E, -mn));
              l[hh] += p;
              if constexpr (BWD) us[hh] += p * dp[nt][2 * hh + e];
              s[nt][2 * hh + e] = p;
            }
        }
        // o += p v, a fresh accumulator for each 32 keys
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float part[NDT][4];
#pragma unroll
          for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[nd][e] = 0.f;
#pragma unroll
          for (int kb = 4 * half; kb < 4 * half + 4; ++kb) {
            uint32_t ph[4], pl[4];
            const float pv[4] = {s[kb][0], s[kb][2], s[kb][1], s[kb][3]};
            tf_split4(pv, ph, pl);
#pragma unroll
            for (int nd = 0; nd < NDT; nd += 2) {
              const int at = (8 * kb + 2 * t) * LD + 8 * nd + g;
              const uint32_t v0h[2] = {Vh[at], Vh[at + LD]}, v0l[2] = {Vl[at], Vl[at + LD]};
              const uint32_t v1h[2] = {Vh[at + 8], Vh[at + LD + 8]}, v1l[2] = {Vl[at + 8], Vl[at + LD + 8]};
              tf_mma3x2(part[nd], ph, pl, v0h, v0l, part[nd + 1], ph, pl, v1h, v1l);
            }
          }
#pragma unroll
          for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[nd][e] += part[nd][e];
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float inv = 1.f / am_quad_sum(l[hh]), D = BWD ? am_quad_sum(us[hh]) * inv : 0.f;
        const int q = rows[hh];
        float* dst;
        if constexpr (BWD) {
          dst = a.att + (w * N + q) * G.HD + h * DP + 2 * t;
          if (t == 0) {
            float* st = a.stats + ((w * G.heads + h) * a.QR + q) * 3;
            st[0] = m[hh], st[1] = inv, st[2] = D;
          }
        } else {
          if (q >= NV) continue;  // a padding query: no pixel
          dst = a.att + am_pixel(G, a.geo, (int)(w * NCH + q / AM_TOK), q % AM_TOK) * G.HD + h * DP + 2 * t;
        }
#pragma unroll
        for (int nd = 0; nd < NDT; ++nd)
          *reinterpret_cast<float2*>(dst + 8 * nd) = make_float2(o[nd][2 * hh] * inv, o[nd][2 * hh + 1] * inv);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int DP, bool BWD>
static cudaError_t tw_rows_launch(const TwRows& a, const AmGeom& G, cudaStream_t stream) {
  const size_t bytes = tw_rows_smem(G.N, DP);
  cudaError_t err = allow_smem(tw_rows_kernel<DP, BWD>, bytes);
  if (err != cudaSuccess) return err;
  tw_rows_kernel<DP, BWD><<<G.heads * a.groups, TW_THREADS, bytes, stream>>>(a, G);
  return cudaGetLastError();
}

// The bias (heads, NV, NV) in f32 in the order the passes read it
// (am_bias_kernel) to out (heads N N floats).
static cudaError_t tw_bias_order(const float* bias, const AmGeom& G, float* out, cudaStream_t stream) {
  const long long n = (long long)G.heads * G.N * G.N / 4;
  am_bias_kernel<<<(int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024), 256, 0, stream>>>(bias, 0, G.heads, G.NCH,
                                                                                              G.NV, out);
  return cudaGetLastError();
}
