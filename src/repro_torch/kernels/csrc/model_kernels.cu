// Hand-written Hopper (sm_90a) kernels for the model stack's float hot
// paths: causal / sliding-window / softcapped GQA flash attention, the
// Mamba2 chunked SSD scan, the RWKV-6 chunked WKV scan and the grouped
// expert matmul.  They replace the Pallas TPU kernels
//
//   flash_attention  repro/kernels/flash_attention/kernel.py  flash_attention_fwd
//   ssd              repro/kernels/mamba2_ssd/kernel.py       ssd_fwd
//   wkv6             repro/kernels/rwkv6_scan/kernel.py       wkv6_fwd
//   gmm              repro/kernels/moe_gmm/kernel.py          gmm
//
// and compute the same functions with fp32 sums on bf16 or fp32 inputs.
// Tensors keep the model's layouts (q [B,S,H,hd], k/v [B,S,KV,hd],
// x [B,S,H,hd], dt [B,S,H], B/C [B,S,N], r/k/v/w [B,S,H,hd],
// x [E,C,D] and w [E,D,F] for gmm); the kernels index them with their own
// strides, so nothing is transposed or padded on the host and any
// sequence length S (any C, D, F) is taken (the TPU kernels needed S a
// multiple of their block).
//
// What bounds them on this card, at the main paths' shapes (S=4096):
// causal attention does ~S/2 operations per byte of q, k and v, far above
// the H100's bf16 ridge (~295), so it is bound by arithmetic; the SSD scan
// does ~94 per byte and the WKV scan ~30, below the ridge, so their bound
// is the bytes they move; gmm at qwen3-moe's expert shape sits at the
// ridge.
//
// In bf16, flash attention and gmm run on the tensor cores: wgmma fed by
// TMA through a ring of shared-memory stages, a producer warpgroup and two
// consumer warpgroups (flash_tc.cu, gmm_tc.cu; the notes there).  The
// launchers below send bf16 there at every shape they take.  In fp32 both
// stay on the fp32 CUDA cores here (the tensor cores take fp32 only as
// TF32, which cannot meet the fp32 tolerances), as do the SSD and WKV
// scans at both types: tiles staged in shared memory, sums kept in
// registers, device memory read once per tile; these sit far above their
// bounds.
//
// Plain C interface (loaded with ctypes): each launcher takes device
// pointers, sizes and the CUDA stream to launch on, and returns the
// cudaError_t of the launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;     // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);         // round to nearest even, as torch
}

// ---------------------------------------------------------------------------
// flash attention forward
// ---------------------------------------------------------------------------
//
// The fp32 kernel (bf16 runs flash_tc.cu's).  One block of 128 threads
// per (query tile of BQ rows, b * H + h).  The query tile and each
// key/value tile of kBK rows are staged in shared memory as fp32; per key
// tile, as _flash_fwd_kernel does per key block:
//
//   A. scores S = (Q K^T) * scale, softcapped and masked: each thread a
//      register tile of BQ/8 rows x kBK/16 keys, float4 loads along hd;
//   B. the online softmax: per row (128/BQ threads each) the tile's max,
//      m' = max(m, max_j s), corr = exp(m - m'), P = exp(S - m') (masked
//      to 0) back into shared memory, l' = l corr + sum_j P;
//   C. acc' = acc corr + P @ V: each thread BQ/8 rows x hd/16 columns of
//      the fp32 accumulator in registers.
//
// Key tiles that no row of the block may see (past the causal frontier,
// before the window) are skipped.  GQA: head h reads kv head h / (H / KV),
// the TPU kernel's b // G index map.  Row strides of hd + 4 floats keep the
// float4 loads 16-byte aligned and spread over the banks.

constexpr int kFlashThreads = 128;
constexpr int kBK = 32;
constexpr int kPStride = kBK + 1;

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal,
                                        int window) {
  return kp < S && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

template <int HD, int BQ>
constexpr int flash_smem_floats() {
  return BQ * (HD + 4) + kBK * (HD + 4) + kBK * HD + BQ * kPStride + 2 * BQ;
}

template <typename T, int HD, int BQ>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int H,
                 int KV, int causal, int window, float softcap,
                 float scale) {
  constexpr int ST = HD + 4;                // q and k row stride
  constexpr int RA = BQ / 8;                // rows per thread (A and C)
  constexpr int NB = kBK / 16;              // keys per thread (A)
  constexpr int CW = HD / 16;               // columns per thread (C)
  constexpr int TPR = kFlashThreads / BQ;   // threads per row (B)
  constexpr int PER = kBK / TPR;            // keys per thread (B)
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][ST]
  float* ks = qs + BQ * ST;                       // [kBK][ST]
  float* vs = ks + kBK * ST;                      // [kBK][HD]
  float* ps = vs + kBK * HD;                      // [BQ][kPStride]
  float* rowc = ps + BQ * kPStride;               // [BQ] this tile's corr
  float* rowl = rowc + BQ;                        // [BQ] final l

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;         // A and C
  const int brow = tid / TPR, bsub = tid % TPR;   // B
  const long long qstride = (long long)H * HD;
  const long long kstride = (long long)KV * HD;
  const T* qb = q + ((long long)b * S * H + h) * HD;
  const T* kb = k + ((long long)b * S * KV + kvh) * HD;
  const T* vb = v + ((long long)b * S * KV + kvh) * HD;
  T* ob = out + ((long long)b * S * H + h) * HD;

  for (int idx = tid; idx < BQ * HD; idx += kFlashThreads) {
    const int r = idx / HD, d = idx - r * HD;
    const int qp = q0 + r;
    qs[r * ST + d] = qp < S ? to_f(qb[qp * qstride + d]) : 0.f;
  }
  float acc[RA][CW];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int w = 0; w < CW; ++w) acc[a][w] = 0.f;
  float m_run = kNegInf, l_run = 0.f;             // of row brow

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kt0 = (k_begin / kBK) * kBK; kt0 < k_end; kt0 += kBK) {
    __syncthreads();                        // the last tile's readers are done
    for (int idx = tid; idx < kBK * HD; idx += kFlashThreads) {
      const int j = idx / HD, d = idx - j * HD;
      const int kp = kt0 + j;
      const bool in = kp < S;
      ks[j * ST + d] = in ? to_f(kb[kp * kstride + d]) : 0.f;
      vs[idx] = in ? to_f(vb[kp * kstride + d]) : 0.f;
    }
    __syncthreads();

    // A: scores, rows tr + 8 a, keys tc + 16 c
    {
      float sc[RA][NB];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < NB; ++c) sc[a][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float4 kv[NB];
#pragma unroll
        for (int c = 0; c < NB; ++c)
          kv[c] = *reinterpret_cast<const float4*>(ks + (tc + 16 * c) * ST + d);
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + (tr + 8 * a) * ST + d);
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            sc[a][c] = fmaf(qv.x, kv[c].x, sc[a][c]);
            sc[a][c] = fmaf(qv.y, kv[c].y, sc[a][c]);
            sc[a][c] = fmaf(qv.z, kv[c].z, sc[a][c]);
            sc[a][c] = fmaf(qv.w, kv[c].w, sc[a][c]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int r = tr + 8 * a;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          const int j = tc + 16 * c;
          float s = sc[a][c] * scale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          ps[r * kPStride + j] =
              visible(q0 + r, kt0 + j, S, causal, window) ? s : kNegInf;
        }
      }
    }
    __syncthreads();

    // B: the online softmax of row brow over this tile's keys
    {
      float* prow = ps + brow * kPStride;
      float mt = kNegInf;
#pragma unroll
      for (int i = 0; i < PER; ++i) mt = fmaxf(mt, prow[bsub + TPR * i]);
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m_run, mt);
      const float corr = expf(m_run - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int j = bsub + TPR * i;
        const float p = visible(q0 + brow, kt0 + j, S, causal, window)
                            ? expf(prow[j] - m_new) : 0.f;
        prow[j] = p;
        lsum += p;
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
      l_run = l_run * corr + lsum;
      m_run = m_new;
      if (bsub == 0) rowc[brow] = corr;
    }
    __syncthreads();

    // C: acc = acc * corr + P @ V, rows tr + 8 a, columns tc + 16 w
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const float c = rowc[tr + 8 * a];
#pragma unroll
      for (int w = 0; w < CW; ++w) acc[a][w] *= c;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[RA], vv[CW];
#pragma unroll
      for (int a = 0; a < RA; ++a) pv[a] = ps[(tr + 8 * a) * kPStride + j];
#pragma unroll
      for (int w = 0; w < CW; ++w) vv[w] = vs[j * HD + tc + 16 * w];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int w = 0; w < CW; ++w) acc[a][w] = fmaf(pv[a], vv[w], acc[a][w]);
    }
  }

  if (bsub == 0) rowl[brow] = l_run;
  __syncthreads();
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = tr + 8 * a;
    const int qp = q0 + r;
    if (qp >= S) continue;
    const float den = fmaxf(rowl[r], 1e-30f);
#pragma unroll
    for (int w = 0; w < CW; ++w)
      ob[qp * qstride + tc + 16 * w] = from_f<T>(acc[a][w] / den);
  }
}

template <typename T, int HD, int BQ>
int flash_launch_t(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  const int smem = flash_smem_floats<HD, BQ>() * (int)sizeof(float);
  auto kern = flash_fwd_kernel<T, HD, BQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, kFlashThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, KV, causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int flash_dispatch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, int hd, int causal,
                   int window, float softcap, float scale,
                   cudaStream_t st) {
  switch (hd) {
    case 16: return flash_launch_t<T, 16, 64>(q, k, v, out, B, S, H, KV,
                                              causal, window, softcap, scale,
                                              st);
    case 32: return flash_launch_t<T, 32, 64>(q, k, v, out, B, S, H, KV,
                                              causal, window, softcap, scale,
                                              st);
    case 64: return flash_launch_t<T, 64, 64>(q, k, v, out, B, S, H, KV,
                                              causal, window, softcap, scale,
                                              st);
    case 80: return flash_launch_t<T, 80, 64>(q, k, v, out, B, S, H, KV,
                                              causal, window, softcap, scale,
                                              st);
    case 128: return flash_launch_t<T, 128, 64>(q, k, v, out, B, S, H, KV,
                                                causal, window, softcap,
                                                scale, st);
    case 256: return flash_launch_t<T, 256, 32>(q, k, v, out, B, S, H, KV,
                                                causal, window, softcap,
                                                scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Mamba2 chunked SSD scan
// ---------------------------------------------------------------------------
//
// One block per (b, h); it walks the chunks of Q steps in order with the
// state h [hd, N] in fp32 shared memory (the TPU kernel's sequential chunk
// grid dimension becomes this loop).  Per chunk, as _ssd_kernel does:
//
//   cum_t  = sum_{s<=t} dt_s A                       (log decay)
//   M[t,s] = (C_t . B_s) exp(cum_t - cum_s) dt_s     for s <= t
//   y      = M @ x + (C exp(cum)) @ h^T
//   h'     = h exp(cum_Q) + (x * dt exp(cum_Q - cum))^T @ B
//
// B and C are indexed by the batch row (shared across heads, the TPU
// kernel's b // H index map), so they are never copied per head.  A
// chunk's x, B^T, C^T and M are staged in shared memory (~180 KB at Q=128,
// hd=64, N=64: above 48 KB, so the launcher raises the block's dynamic
// shared-memory limit).  Rows past the end of the sequence are staged as
// zeros: dt = 0 adds no decay, B = 0 and x = 0 add nothing, so a ragged
// last chunk computes the same function.

constexpr int kSsdThreads = 256;
constexpr int kQMax = 128;
constexpr int kQP = kQMax + 1;              // padded row stride

__host__ __device__ constexpr int ssd_smem_floats(int hd, int n) {
  return kQMax * hd + 2 * n * kQP + kQMax * kQP + hd * (n + 1) + 4 * kQMax;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kSsdThreads)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ h0,
               T* __restrict__ y, float* __restrict__ hout, int S, int H,
               int N, int Q) {
  extern __shared__ float sm[];
  const int NP = N + 1;
  float* xs = sm;                           // [kQMax][HD]
  float* bt = xs + kQMax * HD;              // [N][kQP]   B^T
  float* ct = bt + N * kQP;                 // [N][kQP]   C^T
  float* ms = ct + N * kQP;                 // [kQMax][kQP]
  float* hs = ms + kQMax * kQP;             // [HD][NP]
  float* dts = hs + HD * NP;                // [kQMax]
  float* cum = dts + kQMax;                 // [kQMax]
  float* wts = cum + kQMax;                 // [kQMax] dt_s exp(cum_Q - cum_s)
  float* ecum = wts + kQMax;                // [kQMax] exp(cum_t)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const float a = A[h];
  const int tid = threadIdx.x;
  for (int idx = tid; idx < HD * N; idx += kSsdThreads) {
    const int p = idx / N, n = idx - p * N;
    hs[p * NP + n] = h0 ? h0[(long long)bh * HD * N + idx] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int L = min(Q, S - c0);
    __syncthreads();                        // the last chunk's readers are done
    for (int idx = tid; idx < kQMax * HD; idx += kSsdThreads) {
      const int t = idx / HD, p = idx - t * HD;
      xs[idx] = t < L ? to_f(x[(((long long)b * S + c0 + t) * H + h) * HD + p])
                      : 0.f;
    }
    for (int idx = tid; idx < kQMax * N; idx += kSsdThreads) {
      const int t = idx / N, n = idx - t * N;
      const long long g = ((long long)b * S + c0 + t) * N + n;
      bt[n * kQP + t] = t < L ? to_f(Bm[g]) : 0.f;
      ct[n * kQP + t] = t < L ? to_f(Cm[g]) : 0.f;
    }
    for (int t = tid; t < kQMax; t += kSsdThreads)
      dts[t] = t < L ? dt[((long long)b * S + c0 + t) * H + h] : 0.f;
    __syncthreads();

    // cum: inclusive prefix sum of dt * A, in order, rounded as the plain
    // version rounds (the product, then the sum; no fused multiply-add).
    // A parallel scan would reach cum_t and cum_s through different partial
    // sums, whose rounding (~ulp of |cum|) exp(cum_t - cum_s) would turn
    // into relative errors even between neighbouring steps
    if (tid == 0) {
      float run = 0.f;
      for (int t = 0; t < kQMax; ++t) {
        run = __fadd_rn(run, __fmul_rn(dts[t], a));
        cum[t] = run;
      }
    }
    __syncthreads();
    const float cum_last = cum[kQMax - 1];   // = cum[L - 1]: dt is 0 after

    // M = (C B^T) * exp(cum_t - cum_s) * dt_s on and below the diagonal;
    // thread tile t = ti + 16 a, s = si + 16 b
    {
      const int si = tid % 16, ti = tid / 16;
      float cb[8][8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int w = 0; w < 8; ++w) cb[u][w] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) cv[u] = ct[n * kQP + ti + 16 * u];
#pragma unroll
        for (int w = 0; w < 8; ++w) bv[w] = bt[n * kQP + si + 16 * w];
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int w = 0; w < 8; ++w) cb[u][w] = fmaf(cv[u], bv[w], cb[u][w]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = ti + 16 * u;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const int s = si + 16 * w;
          ms[t * kQP + s] =
              s <= t ? cb[u][w] * expf(cum[t] - cum[s]) * dts[s] : 0.f;
        }
      }
      for (int t = tid; t < kQMax; t += kSsdThreads) {
        wts[t] = expf(cum_last - cum[t]) * dts[t];
        ecum[t] = expf(cum[t]);
      }
    }
    __syncthreads();

    // y = M @ x + (C exp(cum)) @ h^T; thread tile t = ti + 32 a,
    // p = pi + 8 k
    {
      constexpr int KP = (HD + 7) / 8;
      const int pi = tid % 8, ti = tid / 8;
      float acc[4][KP];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < KP; ++w) acc[u][w] = 0.f;
      for (int s = 0; s < kQMax; ++s) {
        float mv[4], xv[KP];
#pragma unroll
        for (int u = 0; u < 4; ++u) mv[u] = ms[(ti + 32 * u) * kQP + s];
#pragma unroll
        for (int w = 0; w < KP; ++w) xv[w] = xs[s * HD + pi + 8 * w];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < KP; ++w) acc[u][w] = fmaf(mv[u], xv[w], acc[u][w]);
      }
      float ec[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) ec[u] = ecum[ti + 32 * u];
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[KP];
#pragma unroll
        for (int u = 0; u < 4; ++u) cv[u] = ct[n * kQP + ti + 32 * u] * ec[u];
#pragma unroll
        for (int w = 0; w < KP; ++w) hv[w] = hs[(pi + 8 * w) * NP + n];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < KP; ++w) acc[u][w] = fmaf(cv[u], hv[w], acc[u][w]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = ti + 32 * u;
        if (t >= L) continue;
        T* yr = y + (((long long)b * S + c0 + t) * H + h) * HD;
#pragma unroll
        for (int w = 0; w < KP; ++w) yr[pi + 8 * w] = from_f<T>(acc[u][w]);
      }
    }
    __syncthreads();

    // h' = h exp(cum_last) + (x * w)^T @ B; thread tile p = pj + 16 j,
    // n = ni + 16 k
    for (int idx = tid; idx < kQMax * HD; idx += kSsdThreads)
      xs[idx] *= wts[idx / HD];
    __syncthreads();
    {
      constexpr int JP = (HD + 15) / 16;
      const int ni = tid % 16, pj = tid / 16;
      const float decay = expf(cum_last);
      float acc[JP][8];
#pragma unroll
      for (int j = 0; j < JP; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;
      for (int s = 0; s < kQMax; ++s) {
        float xv[JP], bv[8];
#pragma unroll
        for (int j = 0; j < JP; ++j) xv[j] = xs[s * HD + pj + 16 * j];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int n = ni + 16 * k;
          bv[k] = n < N ? bt[n * kQP + s] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < JP; ++j)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[j][k] = fmaf(xv[j], bv[k], acc[j][k]);
      }
#pragma unroll
      for (int j = 0; j < JP; ++j) {
        const int p = pj + 16 * j;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int n = ni + 16 * k;
          if (p < HD && n < N)
            hs[p * NP + n] = hs[p * NP + n] * decay + acc[j][k];
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < HD * N; idx += kSsdThreads) {
    const int p = idx / N, n = idx - p * N;
    hout[(long long)bh * HD * N + idx] = hs[p * NP + n];
  }
}

template <typename T, int HD>
int ssd_launch_t(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* h0, void* y, void* h, int B,
                 int S, int H, int N, int Q, cudaStream_t stream) {
  const int smem = ssd_smem_floats(HD, N) * (int)sizeof(float);
  auto kern = ssd_fwd_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B * H, kSsdThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const float*)h0, (T*)y, (float*)h, S, H, N, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int ssd_dispatch(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* h0, void* y, void* h, int B,
                 int S, int H, int hd, int N, int Q, cudaStream_t st) {
  switch (hd) {
    case 16: return ssd_launch_t<T, 16>(x, dt, A, Bm, Cm, h0, y, h, B, S, H,
                                        N, Q, st);
    case 32: return ssd_launch_t<T, 32>(x, dt, A, Bm, Cm, h0, y, h, B, S, H,
                                        N, Q, st);
    case 64: return ssd_launch_t<T, 64>(x, dt, A, Bm, Cm, h0, y, h, B, S, H,
                                        N, Q, st);
    case 128: return ssd_launch_t<T, 128>(x, dt, A, Bm, Cm, h0, y, h, B, S,
                                          H, N, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// RWKV-6 chunked WKV scan
// ---------------------------------------------------------------------------
//
// One block per (b, h); it walks the chunks of Q <= 32 steps in order with
// the state S [hd, hd] in fp32 shared memory (the TPU kernel's sequential
// chunk grid dimension becomes this loop).  Per chunk, as _wkv_kernel does:
//
//   lw       = max(log(max(w, 1e-30)), -60)         (clamped log decay)
//   cum_t    = sum_{s<=t} lw_s,  cum_prev_t = cum_t - lw_t
//   att[t,s] = sum_c r_tc k_sc exp(cum_prev_tc - cum_sc)   for s < t
//   att[t,t] = sum_c r_tc u_c k_tc                          (the bonus)
//   y        = att @ v + (r exp(cum_prev)) @ S
//   S'       = S exp(cum_L) + (k exp(cum_L - cum))^T @ v
//
// The exponent of every pair that is kept is <= 0, and the pairs that are
// not are never exponentiated, so strong decay stays finite.  The TPU
// kernel builds the [Q, Q, hd] tensor of exponentials (256 KB at hd=64,
// beyond a block's shared memory here); this kernel sums each att entry
// over the channels in a register instead.  The chunk's r, k, v, cum and
// cum_prev are staged as fp32 with a padded row stride (hd + 1: the
// threads of a warp read different rows of one column without bank
// conflicts): 62,336 bytes at hd=64.  Rows past the end of the sequence
// are staged as zeros with lw = 0: no decay and nothing added, so a ragged
// last chunk computes the same function.

constexpr int kWkvThreads = 256;
constexpr int kWkvQ = 32;

__host__ __device__ constexpr int wkv_smem_floats(int hd) {
  return 4 * kWkvQ * (hd + 1) + kWkvQ * hd + kWkvQ * (kWkvQ + 1) + hd * hd +
         hd;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWkvThreads)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const void* __restrict__ s0,
                int s0_kind, T* __restrict__ y, float* __restrict__ sout,
                int S, int H, int Q) {
  constexpr int RP = HD + 1;                // padded row stride
  constexpr int AP = kWkvQ + 1;             // att row stride
  constexpr int NG = kWkvThreads / HD;      // row groups (y, state update)
  constexpr int RQ = kWkvQ / NG;            // y rows per thread
  constexpr int RC = HD / NG;               // state rows per thread
  extern __shared__ float sm[];
  float* rs = sm;                           // [Q][RP] r, then r e^cum_prev
  float* ks = rs + kWkvQ * RP;              // [Q][RP] k, then k e^(cum_L-cum)
  float* cs = ks + kWkvQ * RP;              // [Q][RP] cum
  float* ps = cs + kWkvQ * RP;              // [Q][RP] lw, then cum_prev
  float* vs = ps + kWkvQ * RP;              // [Q][HD]
  float* as = vs + kWkvQ * HD;              // [Q][AP] att
  float* ss = as + kWkvQ * AP;              // [HD][HD] the state
  float* us = ss + HD * HD;                 // [HD] the bonus

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const long long step = (long long)H * HD;          // one time step
  const long long base = ((long long)b * S * H + h) * HD;
  const long long sbase = (long long)bh * HD * HD;

  for (int i = tid; i < HD * HD; i += kWkvThreads) {
    float s = 0.f;
    if (s0_kind == 1)
      s = static_cast<const float*>(s0)[sbase + i];
    else if (s0_kind == 2)
      s = __bfloat162float(static_cast<const __nv_bfloat16*>(s0)[sbase + i]);
    ss[i] = s;
  }
  for (int i = tid; i < HD; i += kWkvThreads) us[i] = u[h * HD + i];

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int L = min(Q, S - c0);
    __syncthreads();                        // the last chunk's readers are done
    for (int idx = tid; idx < kWkvQ * HD; idx += kWkvThreads) {
      const int t = idx / HD, c = idx - t * HD;
      const bool in = t < L;
      const long long g = base + (c0 + t) * step + c;
      rs[t * RP + c] = in ? to_f(r[g]) : 0.f;
      ks[t * RP + c] = in ? to_f(k[g]) : 0.f;
      vs[idx] = in ? to_f(v[g]) : 0.f;
      ps[t * RP + c] = in ? fmaxf(logf(fmaxf(w[g], 1e-30f)), -60.f) : 0.f;
    }
    __syncthreads();

    // cum and cum_prev per channel, summed in order and rounded as the
    // plain version rounds them (cum_prev = cum - lw, not cum_{t-1}):
    // exp(cum_prev_t - cum_s) turns their rounding into relative errors
    for (int c = tid; c < HD; c += kWkvThreads) {
      float run = 0.f;
      for (int t = 0; t < kWkvQ; ++t) {
        const float lw = ps[t * RP + c];
        run = __fadd_rn(run, lw);
        cs[t * RP + c] = run;
        ps[t * RP + c] = __fsub_rn(run, lw);
      }
    }
    __syncthreads();

    // att: thread (t = tid / 8) and s = tid % 8 + 8 j, summed over c
    {
      const int t = tid / 8, lane = tid % 8;
      const float* rt = rs + t * RP;
      const float* pt = ps + t * RP;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = lane + 8 * j;
        const float* kr = ks + s * RP;
        const float* cr = cs + s * RP;
        float a = 0.f;
        if (s < t) {
          for (int c = 0; c < HD; ++c)
            a = fmaf(rt[c] * kr[c], expf(pt[c] - cr[c]), a);
        } else if (s == t) {
          for (int c = 0; c < HD; ++c) a = fmaf(rt[c] * us[c], kr[c], a);
        }
        as[t * AP + s] = a;
      }
    }
    __syncthreads();

    // r e^cum_prev and k e^(cum_L - cum), in place (cum_L: the last row,
    // which padded rows carry unchanged)
    for (int idx = tid; idx < kWkvQ * HD; idx += kWkvThreads) {
      const int t = idx / HD, c = idx - t * HD;
      const float cl = cs[(kWkvQ - 1) * RP + c];
      rs[t * RP + c] *= expf(ps[t * RP + c]);
      ks[t * RP + c] *= expf(cl - cs[t * RP + c]);
    }
    __syncthreads();

    // y = att @ v + (r e^cum_prev) @ S; thread rows t = tg + NG i, column d
    {
      const int d = tid % HD, tg = tid / HD;
      float acc[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) acc[i] = 0.f;
      for (int s = 0; s < kWkvQ; ++s) {
        const float vv = vs[s * HD + d];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
          acc[i] = fmaf(as[(tg + NG * i) * AP + s], vv, acc[i]);
      }
      for (int c = 0; c < HD; ++c) {
        const float sv = ss[c * HD + d];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
          acc[i] = fmaf(rs[(tg + NG * i) * RP + c], sv, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int t = tg + NG * i;
        if (t < L) y[base + (c0 + t) * step + d] = from_f<T>(acc[i]);
      }
    }
    __syncthreads();

    // S' = S e^cum_L + (k e^(cum_L - cum))^T @ v; thread rows c = cg + NG i,
    // column d
    {
      const int d = tid % HD, cg = tid / HD;
      float acc[RC];
#pragma unroll
      for (int i = 0; i < RC; ++i) acc[i] = 0.f;
      for (int s = 0; s < kWkvQ; ++s) {
        const float vv = vs[s * HD + d];
#pragma unroll
        for (int i = 0; i < RC; ++i)
          acc[i] = fmaf(ks[s * RP + cg + NG * i], vv, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        const int c = cg + NG * i;
        const float decay = expf(cs[(kWkvQ - 1) * RP + c]);
        ss[c * HD + d] = fmaf(ss[c * HD + d], decay, acc[i]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < HD * HD; i += kWkvThreads) sout[sbase + i] = ss[i];
}

template <typename T, int HD>
int wkv6_launch_t(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, int s0_kind, void* y,
                  void* s, int B, int S, int H, int Q, cudaStream_t stream) {
  const int smem = wkv_smem_floats(HD) * (int)sizeof(float);
  auto kern = wkv6_fwd_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B * H, kWkvThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w,
      (const float*)u, s0, s0_kind, (T*)y, (float*)s, S, H, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int wkv6_dispatch(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, int s0_kind, void* y,
                  void* s, int B, int S, int H, int hd, int Q,
                  cudaStream_t st) {
  switch (hd) {
    case 16: return wkv6_launch_t<T, 16>(r, k, v, w, u, s0, s0_kind, y, s, B,
                                         S, H, Q, st);
    case 32: return wkv6_launch_t<T, 32>(r, k, v, w, u, s0, s0_kind, y, s, B,
                                         S, H, Q, st);
    case 64: return wkv6_launch_t<T, 64>(r, k, v, w, u, s0, s0_kind, y, s, B,
                                         S, H, Q, st);
    case 128: return wkv6_launch_t<T, 128>(r, k, v, w, u, s0, s0_kind, y, s,
                                           B, S, H, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// grouped expert matmul
// ---------------------------------------------------------------------------
//
// The fp32 kernel (bf16 runs gmm_tc.cu's).  y[e] = x[e] @ w[e].  One
// block of 256 threads per (128-column tile of F, 128-row tile of C,
// expert e), as the TPU kernel's (E, C/bc, F/bf) grid;
// its sequential D axis becomes the loop over tiles of 8.  Per D tile the
// x tile (transposed, [k][m]) and the w tile ([k][n]) are staged in shared
// memory as fp32; each thread keeps an 8 x 8 register tile of the fp32
// sums (rows ty + 16 i, columns tx + 16 j: a warp reads 2 rows of A, by
// broadcast, and 16 neighbouring columns of B).  Edge tiles are read as
// zeros and not written, so any C, D and F are taken.

constexpr int kGmmThreads = 256;
constexpr int kGBM = 128, kGBN = 128, kGBK = 8;

template <typename T>
__global__ void __launch_bounds__(kGmmThreads)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ y, int C, int D, int F) {
  __shared__ float as[kGBK][kGBM + 4];
  __shared__ float bs[kGBK][kGBN];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kGBM, n0 = blockIdx.x * kGBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* xe = x + (long long)e * C * D;
  const T* we = w + (long long)e * D * F;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kGBK) {
    for (int idx = tid; idx < kGBM * kGBK; idx += kGmmThreads) {
      const int m = idx / kGBK, kk = idx % kGBK;
      const int gm = m0 + m, gk = k0 + kk;
      as[kk][m] = (gm < C && gk < D) ? to_f(xe[(long long)gm * D + gk]) : 0.f;
    }
    for (int idx = tid; idx < kGBK * kGBN; idx += kGmmThreads) {
      const int kk = idx / kGBN, n = idx % kGBN;
      const int gk = k0 + kk, gn = n0 + n;
      bs[kk][n] = (gk < D && gn < F) ? to_f(we[(long long)gk * F + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGBK; ++kk) {
      float a[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= C) continue;
    T* yr = y + ((long long)e * C + gm) * F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < F) yr[gn] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int gmm_launch_t(const void* x, const void* w, void* y, int E, int C, int D,
                 int F, cudaStream_t stream) {
  const dim3 grid((F + kGBN - 1) / kGBN, (C + kGBM - 1) / kGBM, E);
  gmm_kernel<T><<<grid, kGmmThreads, 0, stream>>>(
      (const T*)x, (const T*)w, (T*)y, C, D, F);
  return (int)cudaGetLastError();
}

}  // namespace

// the bf16 tensor-core kernels (flash_tc.cu, gmm_tc.cu)
int tc_flash_bf16(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int H, int KV, int hd, int causal, int window,
                  float softcap, float scale, cudaStream_t st);
int tc_gmm_bf16(const void* x, const void* w, void* y, int E, int C, int D,
                int F, cudaStream_t st, int* route);

// The route of the last gmm launch: 0 the fp32 SIMT kernel, 1 the
// tensor-core kernel fed by TMA, 2 the tensor-core kernel fed by plain
// loads (D or F not a multiple of 8, or an operand not 16-byte aligned).
extern "C" {
int gmm_last_route = 0;
}

extern "C" {

// q [B,S,H,hd], k/v [B,S,KV,hd], out [B,S,H,hd], all bf16 (bf16 != 0) or
// fp32; window <= 0 means none, softcap <= 0 means none.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int H, int KV, int hd,
                           int causal, int window, float softcap, float scale,
                           int bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? tc_flash_bf16(q, k, v, out, B, S, H, KV, hd, causal, window,
                              softcap, scale, st)
              : flash_dispatch<float>(q, k, v, out, B, S, H, KV, hd, causal,
                                      window, softcap, scale, st);
}

// x [B,S,H,hd] and B/C [B,S,N] bf16 (bf16 != 0) or fp32; dt [B,S,H],
// A [H], h0 [B,H,hd,N] (or null: zeros) and h [B,H,hd,N] fp32;
// y [B,S,H,hd] in x's type.  Chunks of Q <= 128 steps, N <= 128.
int ssd_launch(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* h0, void* y, void* h, int B, int S,
               int H, int hd, int N, int Q, int bf16, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Q < 1 || Q > kQMax || N < 1 || N > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? ssd_dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, h, B, S,
                                            H, hd, N, Q, st)
              : ssd_dispatch<float>(x, dt, A, Bm, Cm, h0, y, h, B, S, H, hd,
                                    N, Q, st);
}

// r/k/v [B,S,H,hd] and y bf16 (bf16 != 0) or fp32; w [B,S,H,hd], u [H,hd]
// and s [B,H,hd,hd] fp32; s0 [B,H,hd,hd] null (s0_kind 0: zeros), fp32
// (1) or bf16 (2).  Chunks of Q <= 32 steps.
int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* y, void* s, int B, int S,
                int H, int hd, int Q, int bf16, int s0_kind, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Q < 1 || Q > kWkvQ || s0_kind < 0 || s0_kind > 2 ||
      (s0_kind != 0 && s0 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? wkv6_dispatch<__nv_bfloat16>(r, k, v, w, u, s0, s0_kind, y,
                                             s, B, S, H, hd, Q, st)
              : wkv6_dispatch<float>(r, k, v, w, u, s0, s0_kind, y, s, B, S,
                                     H, hd, Q, st);
}

// x [E,C,D], w [E,D,F], y [E,C,F], all bf16 (bf16 != 0) or fp32.
int gmm_launch(const void* x, const void* w, void* y, int E, int C, int D,
               int F, int bf16, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  if (E > 65535 || (C + kGBM - 1) / kGBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return tc_gmm_bf16(x, w, y, E, C, D, F, st, &gmm_last_route);
  gmm_last_route = 0;
  return gmm_launch_t<float>(x, w, y, E, C, D, F, st);
}

}  // extern "C"
