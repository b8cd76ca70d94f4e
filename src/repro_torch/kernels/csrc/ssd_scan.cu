// The Mamba2 chunked SSD scan, segment-parallel (scan_pass.cuh): x
// [B,S,H,hd], dt [B,S,H], A [H], B/C [B,S,N] (shared by the heads), an
// initial state h0 [B,H,hd,N] or zeros, any S.  It replaces the Pallas
// kernel ssd_fwd (repro/kernels/mamba2_ssd/kernel.py).  Per chunk of Q <=
// 128 steps, as _ssd_kernel does:
//
//   cum_t  = sum_{s<=t} dt_s A                       (log decay)
//   M[t,s] = (C_t . B_s) exp(cum_t - cum_s) dt_s     for s <= t
//   y      = M @ x + exp(cum) (C @ h^T)
//   h'     = h exp(cum_Q) + (x * dt exp(cum_Q - cum))^T @ B
//
// What bounds it: at zamba2's shape (B=2, S=4096, 80 heads of 64, N=64)
// it does ~94 operations per byte it must move, below the H100's bf16
// ridge (~295), so the bound is the bytes (175 MB, 0.052 ms).  The TPU's
// sequential chunk grid, carried over as one block per (b, h) walking all
// chunks, kept 160 blocks on 132 SMs: two serial walks a launch.  Cut into
// segments of G chunks, B x H x segments blocks run at once (1,280 at
// G = 4); each extra segment boundary costs one fp32 state (16 KB) written
// by (A), read and written by the pass (B) and read by (C).
//
// bf16 runs on the tensor cores (ssd_tc_kernel, compiled apart for (A)
// and (C)): mma.sync m16n8k16 with fp32 sums, 4 warps a block, three
// blocks a multiprocessor at hd = N = 64 (66 KB of shared memory, at most
// 168 registers), tiles staged in shared memory by cp.async in 16-byte
// rows swizzled for ldmatrix.  (C) loads each chunk's x, B and C at the
// chunk's start, while the multiprocessor's other two blocks compute: a
// ring of two stages for x and B needs ~100 KB a block, so two blocks a
// multiprocessor, and was 11% slower; loading only C (read by y alone)
// during the last chunk's state update gained nothing.  (A) has no C and
// no y, so its chunk is mostly loads: it stages the next chunk's x and B
// in a second stage, in the room (C) gives C and h's parts.
// mma.sync, not wgmma: the scan is bound by bytes and by the latency of
// its steps, its products are small (16-row tiles of a 128-step chunk,
// some triangular), and each warp keeps its own rows' scores in registers
// from C B^T through the decay mask into M x, as flash attention keeps P.
//
//   y, per warp two 16-row tiles of the chunk (t and 7 - t: the triangle's
//   work balanced): C h^T (h as two bf16 parts) scaled by exp(cum_t) in
//   fp32, then, for each half of the chunk's columns in turn (so that half
//   the scores' registers are live: with all of them, spills at the 168
//   registers cost 13%), S = C B^T on and below the diagonal, M = S
//   exp(cum_t - cum_s) dt_s in registers, y += M x with M as two bf16
//   parts (hi = the bf16 rounding, lo = the bf16 rounding of the rest: M
//   to ~2^-17, where one rounding leaves 2^-9, the error that failed the
//   flash kernel's tolerance on the model's own activations).  x, B and C enter as they
//   are: bf16 already, their products are exact in fp32.
//   The state update: (x w)^T B with x w as two bf16 parts, into h in
//   fp32, which stays in the registers of the warp that updates it (its
//   mma fragments); after each update h's two parts go to shared memory
//   once, as ldmatrix tiles for the next chunk's C h^T in all four warps
//   (each warp reading and splitting all of h for each of its row tiles
//   cost 9% more).  The next chunk's dt is loaded a chunk ahead.  cum is
//   a warp's parallel scan in base 2, for the special-function unit's exp2
//   (bf16 outputs cannot see its other rounding; the fp32 route keeps the
//   in-order natural sum).
//
// fp32 stays on the CUDA cores (ssd_simt_kernel: fp32 products; the
// tensor cores take fp32 only as TF32, which cannot meet fp32's 8e-5):
// one block per (b, h, segment), the state in shared memory, cum summed in
// order and rounded as the plain version rounds it.
//
// Rows past the end of the sequence are staged as zeros: dt = 0 adds no
// decay, B = 0 and x = 0 add nothing, so a ragged last chunk computes the
// same function.  N is padded in shared memory to 32, 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "scan_pass.cuh"

// The route of the last SSD call, set once its kernels were launched: 0
// the fp32 SIMT kernel, 1 the bf16 tensor-core kernel, -1 none.
extern "C" int ssd_last_route;   // defined with the launcher

namespace {

using tc::ex2;

constexpr int kQMax = 128;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// fp32: the CUDA cores
// ---------------------------------------------------------------------------
//
// One block per (b, h, segment); it walks its chunks in order with the
// state h [hd, N] in fp32 shared memory.  A chunk's x, B^T, C^T and M are
// staged in shared memory (~180 KB at Q=128, hd=64, N=64).  mode 0 is the
// segment's local state (no y), mode 1 the chunk loop from the start
// state.

constexpr int kSimtThreads = 256;
constexpr int kQP = kQMax + 1;              // padded row stride

__host__ __device__ constexpr int ssd_simt_floats(int hd, int n) {
  return kQMax * hd + 2 * n * kQP + kQMax * kQP + hd * (n + 1) + 4 * kQMax;
}

template <int HD>
__global__ void __launch_bounds__(kSimtThreads)
ssd_simt_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ hout,
                float* __restrict__ loc, float* __restrict__ dec, int S,
                int H, int N, int Q, int G, int mode) {
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

  const Seg sg(H, S, Q, G, mode);
  const int b = sg.b, h = sg.h;
  const long long hn = (long long)HD * N;
  const float a = A[h];
  const int tid = threadIdx.x;
  for (int idx = tid; idx < HD * N; idx += kSimtThreads) {
    const int p = idx / N, n = idx - p * N;
    hs[p * NP + n] = sg.start(mode, h0, h0 != nullptr, loc, hn, idx);
  }
  float segdec = 1.f;

  for (int c0 = sg.t_begin; c0 < sg.t_end; c0 += Q) {
    const int L = min(Q, S - c0);
    __syncthreads();                        // the last chunk's readers are done
    for (int idx = tid; idx < kQMax * HD; idx += kSimtThreads) {
      const int t = idx / HD, p = idx - t * HD;
      xs[idx] = t < L ? x[(((long long)b * S + c0 + t) * H + h) * HD + p]
                      : 0.f;
    }
    for (int idx = tid; idx < kQMax * N; idx += kSimtThreads) {
      const int t = idx / N, n = idx - t * N;
      const long long gi = ((long long)b * S + c0 + t) * N + n;
      bt[n * kQP + t] = t < L ? Bm[gi] : 0.f;
      ct[n * kQP + t] = t < L && mode ? Cm[gi] : 0.f;
    }
    for (int t = tid; t < kQMax; t += kSimtThreads)
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
      segdec *= expf(run);
    }
    __syncthreads();
    const float cum_last = cum[kQMax - 1];   // = cum[L - 1]: dt is 0 after

    // M = (C B^T) * exp(cum_t - cum_s) * dt_s on and below the diagonal;
    // thread tile t = ti + 16 a, s = si + 16 b
    if (mode) {
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
    }
    for (int t = tid; t < kQMax; t += kSimtThreads) {
      wts[t] = expf(cum_last - cum[t]) * dts[t];
      ecum[t] = expf(cum[t]);
    }
    __syncthreads();

    // y = M @ x + (C exp(cum)) @ h^T; thread tile t = ti + 32 a,
    // p = pi + 8 k
    if (mode) {
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
        float* yr = y + (((long long)b * S + c0 + t) * H + h) * HD;
#pragma unroll
        for (int w = 0; w < KP; ++w) yr[pi + 8 * w] = acc[u][w];
      }
      __syncthreads();
    }

    // h' = h exp(cum_last) + (x * w)^T @ B; thread tile p = pj + 16 j,
    // n = ni + 16 k
    for (int idx = tid; idx < kQMax * HD; idx += kSimtThreads)
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
  float* out = sg.out(mode, loc, hout, hn);
  if (out != nullptr)
    for (int idx = tid; idx < HD * N; idx += kSimtThreads) {
      const int p = idx / N, n = idx - p * N;
      out[idx] = hs[p * NP + n];
    }
  if (mode == 0 && tid == 0)
    dec[(long long)sg.bh * (sg.nseg - 1) + sg.g] = segdec;
}

// ---------------------------------------------------------------------------
// bf16: the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;

// Shared memory of the bf16 kernel (byte offsets): the chunk's x [128][HD],
// B [128][NP] and C [128][NP] in bf16, the state's two bf16 parts [HD][NP]
// (hi and lo, for y's C h^T; the fp32 state itself lives in the registers
// of the warps that update it), all swizzled for ldmatrix; and per step
// dt, cum, exp(cum) and the state update's weight dt exp(cum_Q - cum).
// 66 KB at hd = N = 64: three blocks a multiprocessor.
template <int HD, int NP>
struct TcSmem {
  static constexpr int X = 0;
  static constexpr int BT = X + kQMax * HD * 2;
  static constexpr int CT = BT + kQMax * NP * 2;
  static constexpr int HHI = CT + kQMax * NP * 2;
  static constexpr int HLO = HHI + HD * NP * 2;
  // (A)'s second stage of x and B, where (C) keeps C and h's parts
  static constexpr int X1 = CT, BT1 = X1 + kQMax * HD * 2;
  static constexpr int PARTS_END = HLO + HD * NP * 2;
  static constexpr int RING_END = BT1 + kQMax * NP * 2;
  static constexpr int DT = PARTS_END > RING_END ? PARTS_END : RING_END;
  static constexpr int CUM = DT + kQMax * 4;
  static constexpr int EC = CUM + kQMax * 4;
  static constexpr int W = EC + kQMax * 4;
  static constexpr int DECAY = W + kQMax * 4;
  static constexpr int BYTES = DECAY + 16;
};

// Rows t0 .. of a [rows][R] bf16 tile from global rows `stride` elements
// apart (n valid columns, the rest and rows past L zeros): 16-byte copies by
// cp.async when `vec` (n == R's valid width a multiple of 8, aligned), in
// a loop of known trip count so that they are issued together, else
// element by element.
template <int R>
__device__ __forceinline__ void stage_rows(uint8_t* smem, uint32_t tile,
                                           const __nv_bfloat16* src,
                                           long long stride, int L, int n,
                                           bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int i0 = 0; i0 < kQMax * (R / 8); i0 += kTcThreads) {
      const int i = i0 + tid;
      if (i >= kQMax * (R / 8)) break;
      const int t = i / (R / 8), c = (i % (R / 8)) * 8;
      const uint32_t dst = tc::swz<R>(tile, t, c);
      if (t < L && c < n)
        tc::cp_async16(dst, src + t * stride + c);
      else
        *reinterpret_cast<uint4*>(smem + (dst - tc::smem_u32(smem))) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = tid; i < kQMax * R; i += kTcThreads) {
      const int t = i / R, c = i % R;
      const uint32_t dst = tc::swz<R>(tile, t, c);
      *reinterpret_cast<__nv_bfloat16*>(smem + (dst - tc::smem_u32(smem))) =
          t < L && c < n ? src[t * stride + c] : __float2bfloat16(0.f);
    }
  }
}

// (three blocks a multiprocessor up to hd = 64: at most 170 registers)
template <int HD, int NP, int MODE>
__global__ void __launch_bounds__(kTcThreads, HD <= 64 ? 3 : 1)
ssd_tc_kernel(const __nv_bfloat16* __restrict__ x,
              const float* __restrict__ dt, const float* __restrict__ A,
              const __nv_bfloat16* __restrict__ Bm,
              const __nv_bfloat16* __restrict__ Cm,
              const float* __restrict__ h0, __nv_bfloat16* __restrict__ y,
              float* __restrict__ hout, float* __restrict__ loc,
              float* __restrict__ dec, int S, int H, int N, int Q, int G,
              int vec_x, int vec_bc) {
  constexpr int mode = MODE;
  using L_ = TcSmem<HD, NP>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = tc::smem_u32(smem);
  const uint32_t sc = base + L_::CT;
  const uint32_t shi = base + L_::HHI, slo = base + L_::HLO;
  float* dts = reinterpret_cast<float*>(smem + L_::DT);
  float* cum = reinterpret_cast<float*>(smem + L_::CUM);
  float* ecum = reinterpret_cast<float*>(smem + L_::EC);
  float* wts = reinterpret_cast<float*>(smem + L_::W);
  float* decay_s = reinterpret_cast<float*>(smem + L_::DECAY);

  const Seg sg(H, S, Q, G, mode);
  const int b = sg.b, h = sg.h;
  const long long hn = (long long)HD * N;
  const float a2 = A[h] * kLog2e;            // cum in base 2, for ex2
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index from lane 0, so that the compiler sees every branch on
  // it uniform across the warp
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g8 = lane >> 2, q2 = 2 * (lane & 3);

  // the chunk at c0 on its way into stage st's x and B
  const auto issue_xb = [&](int c0, int st) {
    const int L = min(Q, S - c0);
    stage_rows<HD>(smem, base + (st ? L_::X1 : L_::X),
                   x + (((long long)b * S + c0) * H + h) * HD,
                   (long long)H * HD, L, HD, vec_x, tid);
    stage_rows<NP>(smem, base + (st ? L_::BT1 : L_::BT),
                   Bm + ((long long)b * S + c0) * N, N, L, N, vec_bc, tid);
  };
  if (!mode && sg.t_begin < sg.t_end) issue_xb(sg.t_begin, 0);

  // The fp32 state h [HD][NP]: warp w keeps its 16-row tiles w, w + 4, ..
  // in registers, as the state update's mma fragments hold them: hr[m][j]
  // is row tile w + 4 m, columns 8 j .. 8 j + 7.
  constexpr int MT = (HD / 16 + 3) / 4, NJ = NP / 8;
  float hr[MT][NJ][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = (warp + 4 * m) * 16 + g8 + 8 * (e >> 1);
        const int n = 8 * j + q2 + (e & 1);
        hr[m][j][e] = p < HD && n < N
                          ? sg.start(mode, h0, h0 != nullptr, loc, hn,
                                     p * N + n)
                          : 0.f;
      }
  // its two bf16 parts into shared memory, for the next y
  const auto put_parts = [&]() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if ((warp + 4 * m) * 16 < HD)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            uint32_t hi, lo;
            tc::split_bf16(hr[m][j][2 * r], hr[m][j][2 * r + 1], hi, lo);
            const uint32_t o =
                tc::swz<NP>(0, (warp + 4 * m) * 16 + g8 + 8 * r, 8 * j + q2);
            *reinterpret_cast<uint32_t*>(smem + L_::HHI + o) = hi;
            *reinterpret_cast<uint32_t*>(smem + L_::HLO + o) = lo;
          }
  };
  if (mode) put_parts();
  float segdec = 1.f;
  // this thread's step of the next chunk's dt, loaded a chunk ahead
  static_assert(kTcThreads == kQMax, "a thread a step of the chunk");
  const auto dt_at = [&](int c0) {
    return c0 + tid < min(S, c0 + Q)
               ? dt[((long long)b * S + c0 + tid) * H + h] : 0.f;
  };
  float dt_next = sg.t_begin < sg.t_end ? dt_at(sg.t_begin) : 0.f;

  // (C) loads each chunk at its start, while the multiprocessor's other
  // blocks compute; (A), which has no C and no y, the next chunk's x and B
  // into a second stage while this one's state update runs
  int st = 0;
  for (int c0 = sg.t_begin; c0 < sg.t_end; c0 += Q, st ^= !mode) {
    const int L = min(Q, S - c0);
    const uint32_t sx = base + (st ? L_::X1 : L_::X);
    const uint32_t sb = base + (st ? L_::BT1 : L_::BT);
    __syncthreads();                        // the last chunk's readers are done
    if (mode) {
      issue_xb(c0, 0);
      stage_rows<NP>(smem, sc, Cm + ((long long)b * S + c0) * N, N, L, N,
                     vec_bc, tid);
    }
    dts[tid] = dt_next;
    if (c0 + Q < sg.t_end) dt_next = dt_at(c0 + Q);
    tc::cp_async_wait_all();
    __syncthreads();
    if (!mode && c0 + Q < sg.t_end) issue_xb(c0 + Q, st ^ 1);

    // cum: warp 0's scan (4 steps a lane in order, then across the lanes);
    // exp(cum), the state update's weights and the chunk's decay
    if (warp == 0) {
      float v[4], run = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        run += dts[4 * lane + i] * a2;
        v[i] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, tot, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] += excl;
      const float last = __shfl_sync(0xffffffffu, v[3], 31);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * lane + i;
        cum[t] = v[i];
        ecum[t] = exp2f(v[i]);
        wts[t] = exp2f(last - v[i]) * dts[t];
      }
      if (lane == 0) {
        decay_s[0] = exp2f(last);
        segdec *= decay_s[0];
      }
    }
    __syncthreads();

    if (mode) {
      // y for row tiles warp and 7 - warp
#pragma unroll 1
      for (int pass = 0; pass < 2; ++pass) {
        const int rt = pass ? 7 - warp : warp;
        if (rt * 16 >= L) continue;
        uint32_t ca[NP / 16][4];
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk)
          tc::ldsm_a<NP>(ca[kk], sc, rt * 16, kk * 16, lane);
        // exp(cum_t) (C h^T), h as its two parts (h^T's B fragments from
        // the parts' [p][n] tiles)
        float yacc[HD / 8][4];
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk)
#pragma unroll
          for (int j = 0; j < HD / 8; j += 2) {
            uint32_t bhi[2][2], blo[2][2];
            tc::ldsm_b_pair<NP>(bhi[0], bhi[1], shi, kk * 16, j * 8, lane);
            tc::ldsm_b_pair<NP>(blo[0], blo[1], slo, kk * 16, j * 8, lane);
            tc::mma_bf16(yacc[j], ca[kk], bhi[0]);
            tc::mma_bf16(yacc[j], ca[kk], blo[0]);
            tc::mma_bf16(yacc[j + 1], ca[kk], bhi[1]);
            tc::mma_bf16(yacc[j + 1], ca[kk], blo[1]);
          }
        const int t0 = rt * 16 + g8, t1 = t0 + 8;
        const float e0 = ecum[t0], e1 = ecum[t1];
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          yacc[j][0] *= e0;
          yacc[j][1] *= e0;
          yacc[j][2] *= e1;
          yacc[j][3] *= e1;
        }
        // S = C B^T, M and y += M x in two halves of the chunk's columns
        // (64 steps each), so that only a half's scores are live at once
        const float ct0 = cum[t0], ct1 = cum[t1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          constexpr int HJ = kQMax / 16;    // 8-column tiles a half
          const int jb = half * HJ;
          if (jb > 2 * rt + 1) break;
          // S on the 16-column tiles up to the diagonal
          float sacc[HJ][4];
#pragma unroll
          for (int j = 0; j < HJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < NP / 16; ++kk)
#pragma unroll
            for (int j = 0; j < HJ; j += 2)
              if (jb + j <= 2 * rt) {
                uint32_t b0[2], b1[2];
                tc::ldsm_b_pair<NP>(b0, b1, sb, kk * 16, (jb + j) * 8, lane);
                tc::mma_bf16(sacc[j], ca[kk], b0);
                tc::mma_bf16(sacc[j + 1], ca[kk], b1);
              }
          // M = S exp(cum_t - cum_s) dt_s for s <= t: the tiles left of
          // the diagonal tile need no mask (every exponent <= 0); on the
          // two diagonal ones the exponent is clamped at 0 and the entries
          // with s > t are then selected away, so that no branch is taken
#pragma unroll
          for (int j = 0; j < HJ; ++j) {
            const int s = 8 * (jb + j) + q2;
            const float2 cs = *reinterpret_cast<const float2*>(cum + s);
            const float2 ds = *reinterpret_cast<const float2*>(dts + s);
            if (jb + j < 2 * rt) {
              sacc[j][0] *= ex2(ct0 - cs.x) * ds.x;
              sacc[j][1] *= ex2(ct0 - cs.y) * ds.y;
              sacc[j][2] *= ex2(ct1 - cs.x) * ds.x;
              sacc[j][3] *= ex2(ct1 - cs.y) * ds.y;
            } else if (jb + j <= 2 * rt + 1) {
              const float m0 =
                  sacc[j][0] * ex2(fminf(ct0 - cs.x, 0.f)) * ds.x;
              const float m1 =
                  sacc[j][1] * ex2(fminf(ct0 - cs.y, 0.f)) * ds.y;
              const float m2 =
                  sacc[j][2] * ex2(fminf(ct1 - cs.x, 0.f)) * ds.x;
              const float m3 =
                  sacc[j][3] * ex2(fminf(ct1 - cs.y, 0.f)) * ds.y;
              sacc[j][0] = s <= t0 ? m0 : 0.f;
              sacc[j][1] = s + 1 <= t0 ? m1 : 0.f;
              sacc[j][2] = s <= t1 ? m2 : 0.f;
              sacc[j][3] = s + 1 <= t1 ? m3 : 0.f;
            }
          }
          // y += M x, M as its two parts
#pragma unroll
          for (int kk = 0; kk < HJ / 2; ++kk)
            if (jb / 2 + kk <= rt) {
              uint32_t mhi[4], mlo[4];
              tc::split_bf16(sacc[2 * kk][0], sacc[2 * kk][1], mhi[0],
                             mlo[0]);
              tc::split_bf16(sacc[2 * kk][2], sacc[2 * kk][3], mhi[1],
                             mlo[1]);
              tc::split_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1],
                             mhi[2], mlo[2]);
              tc::split_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3],
                             mhi[3], mlo[3]);
#pragma unroll
              for (int j = 0; j < HD / 8; j += 2) {
                uint32_t b0[2], b1[2];
                tc::ldsm_b_t_pair<HD>(b0, b1, sx, (jb / 2 + kk) * 16, j * 8,
                                      lane);
                tc::mma_bf16(yacc[j], mhi, b0);
                tc::mma_bf16(yacc[j], mlo, b0);
                tc::mma_bf16(yacc[j + 1], mhi, b1);
                tc::mma_bf16(yacc[j + 1], mlo, b1);
              }
            }
        }
        __nv_bfloat16* yr = y + (((long long)b * S + c0) * H + h) * HD + q2;
        const long long ys = (long long)H * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          if (t0 < L)
            *reinterpret_cast<uint32_t*>(yr + t0 * ys + 8 * j) =
                tc::pack_bf16(yacc[j][0], yacc[j][1]);
          if (t1 < L)
            *reinterpret_cast<uint32_t*>(yr + t1 * ys + 8 * j) =
                tc::pack_bf16(yacc[j][2], yacc[j][3]);
        }
      }
      __syncthreads();                      // h's parts read: now rewritten
    }

    // h' = h exp(cum_last) + (x w)^T B: warp w its 16-row tiles w, w + 4,
    // .. of h, 8 column tiles at a time; x w as its two parts
    const float decay = decay_s[0];
    constexpr int NG = NJ < 8 ? NJ : 8;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int mt = warp + 4 * m;
      if (mt * 16 >= HD) break;
#pragma unroll
      for (int n0 = 0; n0 < NJ; n0 += NG) {
        float acc[NG][4];
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kQMax / 16; ++kk)
          if (kk * 16 < L) {
            uint32_t ax[4], ahi[4], alo[4];
            tc::ldsm_a_t<HD>(ax, sx, mt * 16, kk * 16, lane);
            const int s = kk * 16 + q2;
            const float w0 = wts[s], w1 = wts[s + 1];
            const float w8 = wts[s + 8], w9 = wts[s + 9];
            tc::split_bf16(tc::bf16_lo(ax[0]) * w0, tc::bf16_hi(ax[0]) * w1,
                           ahi[0], alo[0]);
            tc::split_bf16(tc::bf16_lo(ax[1]) * w0, tc::bf16_hi(ax[1]) * w1,
                           ahi[1], alo[1]);
            tc::split_bf16(tc::bf16_lo(ax[2]) * w8, tc::bf16_hi(ax[2]) * w9,
                           ahi[2], alo[2]);
            tc::split_bf16(tc::bf16_lo(ax[3]) * w8, tc::bf16_hi(ax[3]) * w9,
                           ahi[3], alo[3]);
            uint32_t bb[NG][2];
            tc::ldsm_bs_t<NP, NG>(bb, sb, kk * 16, n0 * 8, lane);
#pragma unroll
            for (int j = 0; j < NG; ++j) tc::mma_bf16(acc[j], ahi, bb[j]);
#pragma unroll
            for (int j = 0; j < NG; ++j) tc::mma_bf16(acc[j], alo, bb[j]);
          }
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hr[m][n0 + j][e] = hr[m][n0 + j][e] * decay + acc[j][e];
      }
    }
    if (mode) put_parts();
  }
  float* out = sg.out(mode, loc, hout, hn);
  if (out != nullptr)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = (warp + 4 * m) * 16 + g8 + 8 * (e >> 1);
          const int n = 8 * j + q2 + (e & 1);
          if (p < HD && n < N) out[p * N + n] = hr[m][j][e];
        }
  if (mode == 0 && tid == 0)
    dec[(long long)sg.bh * (sg.nseg - 1) + sg.g] = segdec;
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct SsdArgs {
  const void *x, *dt, *A, *Bm, *Cm, *h0;
  void *y, *h, *loc, *dec;
  int B, S, H, N, Q, G, nseg;
  cudaStream_t st;
};

template <int HD>
int simt_launch(const SsdArgs& a) {
  const int smem = ssd_simt_floats(HD, a.N) * (int)sizeof(float);
  auto kern = ssd_simt_kernel<HD>;
  const int err = run_segments(
      a.B * a.H, a.nseg, a.h0, 0, (float*)a.loc, (const float*)a.dec,
      HD * a.N, HD * a.N, a.st, [&](dim3 grid, int mode) {
    const int e = prepare(kern, smem);
    if (e) return e;
    kern<<<grid, kSimtThreads, smem, a.st>>>(
        (const float*)a.x, (const float*)a.dt, (const float*)a.A,
        (const float*)a.Bm, (const float*)a.Cm, (const float*)a.h0,
        (float*)a.y, (float*)a.h, (float*)a.loc, (float*)a.dec, a.S, a.H,
        a.N, a.Q, a.G, mode);
    return (int)cudaGetLastError();
  });
  if (!err) ssd_last_route = 0;
  return err;
}

template <int HD, int NP>
int tc_launch(const SsdArgs& a) {
  constexpr int smem = TcSmem<HD, NP>::BYTES;
  static_assert(smem <= 232448, "shared memory of a block exceeded");
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = al(a.x);
  const int vec_bc = a.N % 8 == 0 && al(a.Bm) && al(a.Cm);
  const int err = run_segments(
      a.B * a.H, a.nseg, a.h0, 0, (float*)a.loc, (const float*)a.dec,
      HD * a.N, HD * a.N, a.st, [&](dim3 grid, int mode) {
    auto kern = mode ? ssd_tc_kernel<HD, NP, 1> : ssd_tc_kernel<HD, NP, 0>;
    const int e = prepare(kern, smem);
    if (e) return e;
    kern<<<grid, kTcThreads, smem, a.st>>>(
        (const __nv_bfloat16*)a.x, (const float*)a.dt, (const float*)a.A,
        (const __nv_bfloat16*)a.Bm, (const __nv_bfloat16*)a.Cm,
        (const float*)a.h0, (__nv_bfloat16*)a.y, (float*)a.h,
        (float*)a.loc, (float*)a.dec, a.S, a.H, a.N, a.Q, a.G, vec_x,
        vec_bc);
    return (int)cudaGetLastError();
  });
  if (!err) ssd_last_route = 1;
  return err;
}

template <int HD>
int tc_dispatch_n(const SsdArgs& a) {
  if (a.N <= 32) return tc_launch<HD, 32>(a);
  if (a.N <= 64) return tc_launch<HD, 64>(a);
  return tc_launch<HD, 128>(a);
}

}  // namespace

extern "C" {

int ssd_last_route = -1;

// x [B,S,H,hd] and B/C [B,S,N] bf16 (bf16 != 0) or fp32; dt [B,S,H],
// A [H], h0 [B,H,hd,N] (or null: zeros) and h [B,H,hd,N] fp32;
// y [B,S,H,hd] in x's type.  Chunks of Q <= 128 steps, N <= 128, segments
// of G chunks; loc (>= B*H*(segments - 1)*hd*N floats) and dec (>=
// B*H*(segments - 1)) the caller's scratch.
int ssd_launch(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* h0, void* y, void* h, void* loc,
               void* dec, int B, int S, int H, int hd, int N, int Q, int G,
               int bf16, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Q < 1 || Q > kQMax || N < 1 || N > 128 || G < 1 || S < 0)
    return (int)cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  const int nseg = nc > 0 ? (nc + G - 1) / G : 1;
  if (nseg > 65535 || (nseg > 1 && (loc == nullptr || dec == nullptr)))
    return (int)cudaErrorInvalidValue;
  const SsdArgs a{x, dt, A, Bm, Cm, h0, y, h, loc, dec, B, S, H, N, Q, G,
                  nseg, (cudaStream_t)stream};
  ssd_last_route = -1;
  if (bf16) {
    switch (hd) {
      case 16: return tc_dispatch_n<16>(a);
      case 32: return tc_dispatch_n<32>(a);
      case 64: return tc_dispatch_n<64>(a);
      case 128: return tc_dispatch_n<128>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 16: return simt_launch<16>(a);
    case 32: return simt_launch<32>(a);
    case 64: return simt_launch<64>(a);
    case 128: return simt_launch<128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
