// Hand-written Hopper (sm_90a) kernels for the model stack's float hot
// paths: causal / sliding-window / softcapped GQA flash attention and the
// grouped expert matmul.  They replace the Pallas TPU kernels
//
//   flash_attention  repro/kernels/flash_attention/kernel.py  flash_attention_fwd
//   gmm              repro/kernels/moe_gmm/kernel.py          gmm
//
// and compute the same functions with fp32 sums on bf16 or fp32 inputs.
// (The chunked scans, ssd and wkv6, are in ssd_scan.cu and wkv_scan.cu.)
// Tensors keep the model's layouts (q [B,S,H,hd], k/v [B,S,KV,hd],
// x [E,C,D] and w [E,D,F] for gmm); the kernels index them with their own
// strides, so nothing is transposed or padded on the host and any
// sequence length S (any C, D, F) is taken (the TPU kernels needed S a
// multiple of their block).
//
// What bounds them on this card, at the main paths' shapes (S=4096):
// causal attention does ~S/2 operations per byte of q, k and v, far above
// the H100's bf16 ridge (~295), so it is bound by arithmetic; gmm at
// qwen3-moe's expert shape sits at the ridge.
//
// In bf16 both run on the tensor cores: wgmma fed by TMA through a ring of
// shared-memory stages, a producer warpgroup and two consumer warpgroups
// (flash_tc.cu, gmm_tc.cu; the notes there).  The launchers below send
// bf16 there at every shape they take.  In fp32 both stay on the fp32 CUDA
// cores here (the tensor cores take fp32 only as TF32, which cannot meet
// the fp32 tolerances): tiles staged in shared memory, sums kept in
// registers, device memory read once per tile.
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
