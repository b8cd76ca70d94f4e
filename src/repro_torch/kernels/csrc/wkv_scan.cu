// The RWKV-6 chunked WKV scan, segment-parallel (scan_pass.cuh): r/k/v/w
// [B,S,H,hd], the bonus u [H,hd], an initial state s0 [B,H,hd,hd] (fp32,
// bf16 or zeros), any S.  It replaces the Pallas kernel wkv6_fwd
// (repro/kernels/rwkv6_scan/kernel.py).  Per chunk of Q <= 32 steps, as
// _wkv_kernel does:
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
// kernel builds the [Q, Q, hd] tensor of exponentials; here each att entry
// is summed over the channels in registers.
//
// What bounds it: at rwkv6's shape (B=2, S=4096, 40 heads of 64) some 30
// operations per byte it must move, far below the H100's ridge, so the
// bound is the bytes (253 MB, 0.076 ms).  The TPU's sequential chunk grid,
// carried over as one block per (b, h), kept 80 blocks on 132 SMs, each
// walking 128 chunks in order.  Cut into segments of G chunks, B x H x
// segments blocks run at once; each segment boundary costs one fp32 state
// (hd x hd) written by (A), read and written by the pass (B) and read by
// (C).  Within a chunk the per-pair, per-channel exponentials (~33,000 a
// chunk, some 335 million a launch: ~0.09 ms of the special-function
// units over the card) are what remains; the products are small.
//
// bf16 (wkv_tc_kernel), 4 warps a block: the exponentials on the CUDA
// cores, below the diagonal in 4 x 4 blocks of (t, s) pairs, 4 threads a
// block and a quarter of the channels each (float4 reads: every value read
// serves 4 pairs, so that shared memory keeps up with the special-function
// units), the 8 diagonal blocks 16 threads each, summed by shuffles; the
// three products on the tensor cores as mma.sync m16n8k16 with fp32 sums,
// r, k and v as they are (bf16), att, the decayed r and k and the fp32
// state S as two bf16 parts each (hi = the bf16 rounding, lo = the bf16
// rounding of the rest; S's parts made as its fragments are read).
// mma.sync, not wgmma: a 32-step chunk does not fill a wgmma's 64 rows,
// and the scan is bound by bytes and latency at some 32 operations a byte,
// far below the 295 ridge, where mma.sync's rate is more than enough.  The
// next chunk's r, k, v and w arrive by cp.async while this one computes.
// The log decays are taken in base 2 (the special-function unit's log2 and
// exp2) and summed per channel in order.
//
// fp32 stays on the CUDA cores (wkv_simt_kernel: fp32 products, natural
// exponentials; the tensor cores take fp32 only as TF32): the chunk's r,
// k, v, cum and cum_prev staged as fp32, each att entry one thread's sum
// over the channels, cum rounded as the plain version rounds it.
//
// Rows past the end of the sequence are staged as zeros with lw = 0: no
// decay and nothing added, so a ragged last chunk computes the same
// function.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "scan_pass.cuh"

// The route of the last WKV call, set once its kernels were launched: 0
// the fp32 SIMT kernel, 1 the bf16 kernel with its products on the tensor
// cores, -1 none.
extern "C" int wkv6_last_route;   // defined with the launcher

namespace {

using tc::ex2;

constexpr int kWkvQ = 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float clamped_log(float w) {
  return fmaxf(logf(fmaxf(w, 1e-30f)), -60.f);
}

// The same in base 2, by the special-function unit's log2.
__device__ __forceinline__ float clamped_log2(float w) {
  return fmaxf(__log2f(fmaxf(w, 1e-30f)), -60.f * kLog2e);
}

// ---------------------------------------------------------------------------
// fp32: the CUDA cores
// ---------------------------------------------------------------------------
//
// One block per (b, h, segment) walking its chunks with the state S [hd,
// hd] in fp32 shared memory.  The chunk's r, k, v, cum and cum_prev are
// staged as fp32 with a padded row stride (hd + 1: the threads of a warp
// read different rows of one column without bank conflicts): 62,336 bytes
// at hd=64.

constexpr int kSimtThreads = 256;

__host__ __device__ constexpr int wkv_simt_floats(int hd) {
  return 4 * kWkvQ * (hd + 1) + kWkvQ * hd + kWkvQ * (kWkvQ + 1) + hd * hd +
         2 * hd;
}

template <int HD>
__global__ void __launch_bounds__(kSimtThreads)
wkv_simt_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const void* __restrict__ s0,
                int s0_kind, float* __restrict__ y, float* __restrict__ sout,
                float* __restrict__ loc, float* __restrict__ dec, int S,
                int H, int Q, int G, int mode) {
  constexpr int RP = HD + 1;                // padded row stride
  constexpr int AP = kWkvQ + 1;             // att row stride
  constexpr int NG = kSimtThreads / HD;     // row groups (y, state update)
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
  float* sdec = us + HD;                    // [HD] the segment's decay

  const Seg sg(H, S, Q, G, mode);
  const int b = sg.b, h = sg.h;
  const int tid = threadIdx.x;
  const long long step = (long long)H * HD;          // one time step
  const long long base = ((long long)b * S * H + h) * HD;
  const long long hh = (long long)HD * HD;

  for (int i = tid; i < HD * HD; i += kSimtThreads)
    ss[i] = sg.start(mode, s0, s0_kind, loc, hh, i);
  for (int i = tid; i < HD; i += kSimtThreads) {
    us[i] = u[h * HD + i];
    sdec[i] = 1.f;
  }

  for (int c0 = sg.t_begin; c0 < sg.t_end; c0 += Q) {
    const int L = min(Q, S - c0);
    __syncthreads();                        // the last chunk's readers are done
    for (int idx = tid; idx < kWkvQ * HD; idx += kSimtThreads) {
      const int t = idx / HD, c = idx - t * HD;
      const bool in = t < L;
      const long long gi = base + (c0 + t) * step + c;
      rs[t * RP + c] = in && mode ? r[gi] : 0.f;
      ks[t * RP + c] = in ? k[gi] : 0.f;
      vs[idx] = in ? v[gi] : 0.f;
      ps[t * RP + c] = in ? clamped_log(w[gi]) : 0.f;
    }
    __syncthreads();

    // cum and cum_prev per channel, summed in order and rounded as the
    // plain version rounds them (cum_prev = cum - lw, not cum_{t-1}):
    // exp(cum_prev_t - cum_s) turns their rounding into relative errors
    for (int c = tid; c < HD; c += kSimtThreads) {
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
    if (mode) {
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
    for (int idx = tid; idx < kWkvQ * HD; idx += kSimtThreads) {
      const int t = idx / HD, c = idx - t * HD;
      const float cl = cs[(kWkvQ - 1) * RP + c];
      rs[t * RP + c] *= expf(ps[t * RP + c]);
      ks[t * RP + c] *= expf(cl - cs[t * RP + c]);
    }
    __syncthreads();

    // y = att @ v + (r e^cum_prev) @ S; thread rows t = tg + NG i, column d
    if (mode) {
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
        if (t < L) y[base + (c0 + t) * step + d] = acc[i];
      }
      __syncthreads();
    }

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
        if (d == 0) sdec[c] *= decay;
      }
    }
  }
  __syncthreads();
  float* out = sg.out(mode, loc, sout, hh);
  if (out != nullptr)
    for (int i = tid; i < HD * HD; i += kSimtThreads) out[i] = ss[i];
  if (mode == 0)
    for (int i = tid; i < HD; i += kSimtThreads)
      dec[((long long)sg.bh * (sg.nseg - 1) + sg.g) * HD + i] = sdec[i];
}

// ---------------------------------------------------------------------------
// bf16: exponentials on the CUDA cores, products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;

// Shared memory of the bf16 kernel (byte offsets): r, cum_prev (base 2), k
// and cum (base 2, after the log decays) as fp32 [32][HD + 4]; v in bf16
// [32][HD] (swizzled); att fp32 [32][33]; the state in fp32 [HD][HD + 4];
// the next chunk's r, k, v (bf16) and w (fp32) as they arrive by
// cp.async; per channel the bonus u, cum_L (base 2), exp(cum_L) and the
// segment's decay.
template <int HD, int MODE>
struct TcSmem {
  // (A) (MODE 0) has no r, cum_prev, att or r buffer: four blocks a
  // multiprocessor at hd = 64, where (C) fits two
  static constexpr int RS = HD + 4;         // fp32 row stride
  static constexpr int R = 0;
  static constexpr int AF = R + (MODE ? kWkvQ * RS * 4 : 0);
  static constexpr int K = AF + (MODE ? kWkvQ * RS * 4 : 0);
  static constexpr int BF = K + kWkvQ * RS * 4;
  static constexpr int V = BF + kWkvQ * RS * 4;
  static constexpr int ATT = V + kWkvQ * HD * 2;
  static constexpr int SF = ATT + (MODE ? kWkvQ * (kWkvQ + 1) * 4 : 0);
  static constexpr int RAW_R = SF + HD * RS * 4;
  static constexpr int RAW_K = RAW_R + (MODE ? kWkvQ * HD * 2 : 0);
  static constexpr int RAW_V = RAW_K + kWkvQ * HD * 2;
  static constexpr int RAW_W = RAW_V + kWkvQ * HD * 2;
  static constexpr int U = RAW_W + kWkvQ * HD * 4;
  static constexpr int CL = U + HD * 4;
  static constexpr int DL = CL + HD * 4;
  static constexpr int SDEC = DL + HD * 4;
  static constexpr int BYTES = SDEC + HD * 4;
};

// Rows t0 .. t0 + 31 of a [B,S,H,HD] tensor (rows of HD elements `step`
// apart; rows past L as zeros) into a [32][HD] buffer in shared memory:
// 16-byte cp.async copies when `vec`, in a loop of known trip count so
// that they are issued together, else element by element.
template <int HD, typename T>
__device__ __forceinline__ void stage_raw(T* dst, const T* src,
                                          long long step, int L, bool vec,
                                          int tid) {
  constexpr int PER = 16 / sizeof(T);       // elements a 16-byte copy
  if (vec) {
#pragma unroll
    for (int i0 = 0; i0 < kWkvQ * HD / PER; i0 += kTcThreads) {
      const int i = i0 + tid;
      if (i >= kWkvQ * HD / PER) break;
      const int t = i / (HD / PER), c = (i % (HD / PER)) * PER;
      if (t < L)
        tc::cp_async16(tc::smem_u32(dst + t * HD + c), src + t * step + c);
      else
        *reinterpret_cast<uint4*>(dst + t * HD + c) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = tid; i < kWkvQ * HD; i += kTcThreads) {
      const int t = i / HD, c = i % HD;
      dst[i] = t < L ? src[t * step + c] : T();
    }
  }
}

template <int HD, int MODE>
__global__ void __launch_bounds__(kTcThreads, MODE || HD > 64 ? 1 : 4)
wkv_tc_kernel(const __nv_bfloat16* __restrict__ r,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const float* __restrict__ w, const float* __restrict__ u,
              const void* __restrict__ s0, int s0_kind,
              __nv_bfloat16* __restrict__ y, float* __restrict__ sout,
              float* __restrict__ loc, float* __restrict__ dec, int S, int H,
              int Q, int G, int vec) {
  constexpr int mode = MODE;
  using L_ = TcSmem<HD, MODE>;
  constexpr int RS = L_::RS;
  constexpr int AP = kWkvQ + 1;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = tc::smem_u32(smem);
  float* rf = reinterpret_cast<float*>(smem + L_::R);
  float* af = reinterpret_cast<float*>(smem + L_::AF);
  float* kf = reinterpret_cast<float*>(smem + L_::K);
  float* bf = reinterpret_cast<float*>(smem + L_::BF);
  const uint32_t sv = base + L_::V;
  float* att = reinterpret_cast<float*>(smem + L_::ATT);
  float* sf = reinterpret_cast<float*>(smem + L_::SF);
  auto* raw_r = reinterpret_cast<__nv_bfloat16*>(smem + L_::RAW_R);
  auto* raw_k = reinterpret_cast<__nv_bfloat16*>(smem + L_::RAW_K);
  auto* raw_v = reinterpret_cast<__nv_bfloat16*>(smem + L_::RAW_V);
  auto* raw_w = reinterpret_cast<float*>(smem + L_::RAW_W);
  float* us = reinterpret_cast<float*>(smem + L_::U);
  float* cl = reinterpret_cast<float*>(smem + L_::CL);
  float* dl = reinterpret_cast<float*>(smem + L_::DL);
  float* sdec = reinterpret_cast<float*>(smem + L_::SDEC);

  const Seg sg(H, S, Q, G, mode);
  const int b = sg.b, h = sg.h;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g8 = lane >> 2, q2 = 2 * (lane & 3);
  const long long step = (long long)H * HD;          // one time step
  const long long gbase = ((long long)b * S * H + h) * HD;
  const long long hh = (long long)HD * HD;

  // the chunk at c0 on its way into the raw buffers
  const auto issue = [&](int c0) {
    const int L = min(Q, S - c0);
    const long long off = gbase + (long long)c0 * step;
    if (mode) stage_raw<HD>(raw_r, r + off, step, L, vec, tid);
    stage_raw<HD>(raw_k, k + off, step, L, vec, tid);
    stage_raw<HD>(raw_v, v + off, step, L, vec, tid);
    stage_raw<HD>(raw_w, w + off, step, L, vec, tid);
  };
  if (sg.t_begin < sg.t_end) issue(sg.t_begin);

  // the start state, 16 loads a thread in flight at once
#pragma unroll 1
  for (int i0 = tid; i0 < HD * HD; i0 += 16 * kTcThreads) {
    float sv0[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = i0 + j * kTcThreads;
      sv0[j] = i < HD * HD ? sg.start(mode, s0, s0_kind, loc, hh, i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = i0 + j * kTcThreads;
      if (i < HD * HD) sf[(i / HD) * RS + i % HD] = sv0[j];
    }
  }
  for (int i = tid; i < HD; i += kTcThreads) {
    us[i] = u[h * HD + i];
    sdec[i] = 1.f;
  }
  if (mode)
    for (int i = tid; i < kWkvQ * AP; i += kTcThreads) att[i] = 0.f;

  for (int c0 = sg.t_begin; c0 < sg.t_end; c0 += Q) {
    const int L = min(Q, S - c0);
    tc::cp_async_wait_all();
    __syncthreads();              // the chunk arrived; the last one's readers
                                  // are done
    // r and k to fp32, the clamped log decays in base 2 (0 past L), v
    // swizzled
#pragma unroll
    for (int i0 = 0; i0 < kWkvQ * HD / 4; i0 += kTcThreads) {
      const int i = i0 + tid;
      if (i >= kWkvQ * HD / 4) break;
      const int t = i / (HD / 4), c = (i % (HD / 4)) * 4;
      if (mode) {
        const uint2 p = *reinterpret_cast<const uint2*>(raw_r + t * HD + c);
        *reinterpret_cast<float4*>(rf + t * RS + c) =
            make_float4(tc::bf16_lo(p.x), tc::bf16_hi(p.x),
                        tc::bf16_lo(p.y), tc::bf16_hi(p.y));
      }
      const uint2 p = *reinterpret_cast<const uint2*>(raw_k + t * HD + c);
      *reinterpret_cast<float4*>(kf + t * RS + c) =
          make_float4(tc::bf16_lo(p.x), tc::bf16_hi(p.x), tc::bf16_lo(p.y),
                      tc::bf16_hi(p.y));
      const float4 wv = *reinterpret_cast<const float4*>(raw_w + t * HD + c);
      *reinterpret_cast<float4*>(bf + t * RS + c) =
          t < L ? make_float4(clamped_log2(wv.x), clamped_log2(wv.y),
                              clamped_log2(wv.z), clamped_log2(wv.w))
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i0 = 0; i0 < kWkvQ * HD / 2; i0 += kTcThreads) {
      const int i = i0 + tid;
      if (i >= kWkvQ * HD / 2) break;
      const int t = i / (HD / 2), d = 2 * (i % (HD / 2));
      *reinterpret_cast<uint32_t*>(smem + (tc::swz<HD>(sv, t, d) - base)) =
          *reinterpret_cast<const uint32_t*>(raw_v + t * HD + d);
    }
    __syncthreads();
    if (c0 + Q < sg.t_end) issue(c0 + Q);   // lands while this chunk computes

    // cum and cum_prev per channel (base 2), summed in order as the plain
    // version sums them; cum_L, exp(cum_L)
    for (int c = tid; c < HD; c += kTcThreads) {
      float run = 0.f;
#pragma unroll 8
      for (int t = 0; t < kWkvQ; ++t) {
        const float lw = bf[t * RS + c];
        run += lw;
        bf[t * RS + c] = run;
        if (mode) af[t * RS + c] = run - lw;
      }
      cl[c] = run;
      dl[c] = exp2f(run);
      sdec[c] *= dl[c];
    }
    __syncthreads();

    if (mode) {
      // att below the diagonal in 4 x 4 blocks (t = 4 tb + i, s = 4 sb +
      // j, sb < tb: 28 blocks), 4 threads a block (threads 0..111), a
      // thread the channel quads q, q + 4, .. (float4 reads; 16 sums of
      // 16 terms each at hd = 64), summed over the 4 by shuffles
      const unsigned offdiag = __ballot_sync(0xffffffffu, tid < 112);
      if (tid < 112) {
        const int blk = tid >> 2, qq = tid & 3;
        int tb = 1;
        while ((tb + 1) * tb / 2 <= blk) ++tb;
        const int t0 = 4 * tb, s0_ = 4 * (blk - tb * (tb - 1) / 2);
        float acc[4][4] = {};
#pragma unroll
        for (int m = 0; m < HD / 16; ++m) {
          const int c = 4 * (qq + 4 * m);
          float4 rv[4], av[4], kv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            rv[i] = *reinterpret_cast<const float4*>(rf + (t0 + i) * RS + c);
            av[i] = *reinterpret_cast<const float4*>(af + (t0 + i) * RS + c);
            kv[i] = *reinterpret_cast<const float4*>(kf + (s0_ + i) * RS + c);
            bv[i] = *reinterpret_cast<const float4*>(bf + (s0_ + i) * RS + c);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float& o = acc[i][j];
              o = fmaf(rv[i].x * kv[j].x, ex2(av[i].x - bv[j].x), o);
              o = fmaf(rv[i].y * kv[j].y, ex2(av[i].y - bv[j].y), o);
              o = fmaf(rv[i].z * kv[j].z, ex2(av[i].z - bv[j].z), o);
              o = fmaf(rv[i].w * kv[j].w, ex2(av[i].w - bv[j].w), o);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] += __shfl_xor_sync(offdiag, acc[i][j], 1);
            acc[i][j] += __shfl_xor_sync(offdiag, acc[i][j], 2);
          }
        // thread qq writes row t0 + qq of the block
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i == qq)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              att[(t0 + i) * AP + s0_ + j] = acc[i][j];
      }
      // the 8 diagonal 4 x 4 blocks, 16 threads each (channels p, p + 16,
      // ..), summed over the 16 by shuffles: below the diagonal the decayed
      // pairs, on it the bonus, above it zeros
      {
        const int t0 = 4 * (tid >> 4), p = tid & 15;
        float sv[4][4] = {};                // [t - t0][s - t0], s <= t
#pragma unroll
        for (int m = 0; m < HD / 16; ++m) {
          const int c = p + 16 * m;
          float rr[4], aa[4], kk[4], bb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            rr[i] = rf[(t0 + i) * RS + c];
            aa[i] = af[(t0 + i) * RS + c];
            kk[i] = kf[(t0 + i) * RS + c];
            bb[i] = bf[(t0 + i) * RS + c];
          }
          const float uc = us[c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < i; ++j)
              sv[i][j] = fmaf(rr[i] * kk[j], ex2(aa[i] - bb[j]), sv[i][j]);
            sv[i][i] = fmaf(rr[i] * uc, kk[i], sv[i][i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j)
#pragma unroll
            for (int off = 1; off < 16; off <<= 1)
              sv[i][j] += __shfl_xor_sync(0xffffffffu, sv[i][j], off);
        if (p < 4)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i == p)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                att[(t0 + i) * AP + t0 + j] = j <= i ? sv[i][j] : 0.f;
      }
      __syncthreads();

      // y = att v + (r e^cum_prev) S: warp w rows 16 (w & 1) .., its half
      // of the column tiles; att, r e^cum_prev and S as two bf16 parts
      constexpr int NH = HD / 16;           // column tiles a warp
      const int mt = warp & 1, nb = (warp >> 1) * NH;
      const int ta = 16 * mt + g8, tb_ = ta + 8;
      float yacc[NH][4];
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int s = 16 * kk + q2;
        uint32_t ahi[4], alo[4];
        tc::split_bf16(att[ta * AP + s], att[ta * AP + s + 1], ahi[0],
                       alo[0]);
        tc::split_bf16(att[tb_ * AP + s], att[tb_ * AP + s + 1], ahi[1],
                       alo[1]);
        tc::split_bf16(att[ta * AP + s + 8], att[ta * AP + s + 9], ahi[2],
                       alo[2]);
        tc::split_bf16(att[tb_ * AP + s + 8], att[tb_ * AP + s + 9], ahi[3],
                       alo[3]);
        // (the column tiles' high parts first, then their low parts, so
        // that no mma waits on the one just issued)
        uint32_t bv[NH][2];
        tc::ldsm_bs_t<HD, NH>(bv, sv, 16 * kk, nb * 8, lane);
#pragma unroll
        for (int j = 0; j < NH; ++j) tc::mma_bf16(yacc[j], ahi, bv[j]);
#pragma unroll
        for (int j = 0; j < NH; ++j) tc::mma_bf16(yacc[j], alo, bv[j]);
      }
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        const int c = 16 * kc + q2;
        const auto rn = [&](int t, int cc) {
          return rf[t * RS + cc] * ex2(af[t * RS + cc]);
        };
        uint32_t ahi[4], alo[4];
        tc::split_bf16(rn(ta, c), rn(ta, c + 1), ahi[0], alo[0]);
        tc::split_bf16(rn(tb_, c), rn(tb_, c + 1), ahi[1], alo[1]);
        tc::split_bf16(rn(ta, c + 8), rn(ta, c + 9), ahi[2], alo[2]);
        tc::split_bf16(rn(tb_, c + 8), rn(tb_, c + 9), ahi[3], alo[3]);
        // S's B fragments (rows c .., column d) as their two parts
        uint32_t bh[NH][2], bl[NH][2];
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const float* sc = sf + c * RS + (nb + j) * 8 + g8;
          tc::split_bf16(sc[0], sc[RS], bh[j][0], bl[j][0]);
          tc::split_bf16(sc[8 * RS], sc[9 * RS], bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int j = 0; j < NH; ++j) tc::mma_bf16(yacc[j], ahi, bh[j]);
#pragma unroll
        for (int j = 0; j < NH; ++j) tc::mma_bf16(yacc[j], ahi, bl[j]);
#pragma unroll
        for (int j = 0; j < NH; ++j) tc::mma_bf16(yacc[j], alo, bh[j]);
      }
      __nv_bfloat16* yr = y + gbase + (long long)c0 * step + q2;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int d = (nb + j) * 8;
        if (ta < L)
          *reinterpret_cast<uint32_t*>(yr + ta * step + d) =
              tc::pack_bf16(yacc[j][0], yacc[j][1]);
        if (tb_ < L)
          *reinterpret_cast<uint32_t*>(yr + tb_ * step + d) =
              tc::pack_bf16(yacc[j][2], yacc[j][3]);
      }
      __syncthreads();                      // S read: now rewritten
    }

    // S' = S e^cum_L + (k e^(cum_L - cum))^T v: warp w the 16-row tiles w,
    // w + 4, .. of S, 8 column tiles at a time; the decayed k as two parts
    constexpr int NG = HD / 8 < 8 ? HD / 8 : 8;
#pragma unroll 1
    for (int mt = warp; mt < HD / 16; mt += 4) {
      const int ca = 16 * mt + g8, cb = ca + 8;
      const float la = cl[ca], lb = cl[cb];
      const auto ke = [&](int s, int c, float lc) {
        return kf[s * RS + c] * ex2(lc - bf[s * RS + c]);
      };
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int s = 16 * kk + q2;
        tc::split_bf16(ke(s, ca, la), ke(s + 1, ca, la), ahi[kk][0],
                       alo[kk][0]);
        tc::split_bf16(ke(s, cb, lb), ke(s + 1, cb, lb), ahi[kk][1],
                       alo[kk][1]);
        tc::split_bf16(ke(s + 8, ca, la), ke(s + 9, ca, la), ahi[kk][2],
                       alo[kk][2]);
        tc::split_bf16(ke(s + 8, cb, lb), ke(s + 9, cb, lb), ahi[kk][3],
                       alo[kk][3]);
      }
      const float da = dl[ca], db = dl[cb];
#pragma unroll 1
      for (int n0 = 0; n0 < HD / 8; n0 += NG) {
        float acc[NG][4];
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t bv[NG][2];
          tc::ldsm_bs_t<HD, NG>(bv, sv, 16 * kk, n0 * 8, lane);
#pragma unroll
          for (int j = 0; j < NG; ++j) tc::mma_bf16(acc[j], ahi[kk], bv[j]);
#pragma unroll
          for (int j = 0; j < NG; ++j) tc::mma_bf16(acc[j], alo[kk], bv[j]);
        }
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const int d = (n0 + j) * 8 + q2;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float2* sp = reinterpret_cast<float2*>(sf + (rr ? cb : ca) * RS
                                                   + d);
            const float dc = rr ? db : da;
            const float2 s2 = *sp;
            *sp = make_float2(fmaf(s2.x, dc, acc[j][2 * rr]),
                              fmaf(s2.y, dc, acc[j][2 * rr + 1]));
          }
        }
      }
    }
  }
  __syncthreads();
  float* out = sg.out(mode, loc, sout, hh);
  if (out != nullptr)
    for (int i = tid; i < HD * HD; i += kTcThreads)
      out[i] = sf[(i / HD) * RS + i % HD];
  if (mode == 0)
    for (int i = tid; i < HD; i += kTcThreads)
      dec[((long long)sg.bh * (sg.nseg - 1) + sg.g) * HD + i] = sdec[i];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct WkvArgs {
  const void *r, *k, *v, *w, *u, *s0;
  int s0_kind;
  void *y, *s, *loc, *dec;
  int B, S, H, Q, G, nseg;
  cudaStream_t st;
};

template <int HD>
int simt_launch(const WkvArgs& a) {
  const int smem = wkv_simt_floats(HD) * (int)sizeof(float);
  auto kern = wkv_simt_kernel<HD>;
  const int err = run_segments(
      a.B * a.H, a.nseg, a.s0, a.s0_kind == 2, (float*)a.loc,
      (const float*)a.dec, HD * HD, HD, a.st, [&](dim3 grid, int mode) {
        const int e = prepare(kern, smem);
        if (e) return e;
        kern<<<grid, kSimtThreads, smem, a.st>>>(
            (const float*)a.r, (const float*)a.k, (const float*)a.v,
            (const float*)a.w, (const float*)a.u, a.s0, a.s0_kind,
            (float*)a.y, (float*)a.s, (float*)a.loc, (float*)a.dec, a.S,
            a.H, a.Q, a.G, mode);
        return (int)cudaGetLastError();
      });
  if (!err) wkv6_last_route = 0;
  return err;
}

template <int HD, int MODE>
int tc_launch_mode(const WkvArgs& a, dim3 grid) {
  constexpr int smem = TcSmem<HD, MODE>::BYTES;
  static_assert(smem <= 232448, "shared memory of a block exceeded");
  auto kern = wkv_tc_kernel<HD, MODE>;
  const int e = prepare(kern, smem);
  if (e) return e;
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = al(a.r) && al(a.k) && al(a.v) && al(a.w);
  kern<<<grid, kTcThreads, smem, a.st>>>(
      (const __nv_bfloat16*)a.r, (const __nv_bfloat16*)a.k,
      (const __nv_bfloat16*)a.v, (const float*)a.w, (const float*)a.u, a.s0,
      a.s0_kind, (__nv_bfloat16*)a.y, (float*)a.s, (float*)a.loc,
      (float*)a.dec, a.S, a.H, a.Q, a.G, vec);
  return (int)cudaGetLastError();
}

template <int HD>
int tc_launch(const WkvArgs& a) {
  const int err = run_segments(
      a.B * a.H, a.nseg, a.s0, a.s0_kind == 2, (float*)a.loc,
      (const float*)a.dec, HD * HD, HD, a.st, [&](dim3 grid, int mode) {
        return mode ? tc_launch_mode<HD, 1>(a, grid)
                    : tc_launch_mode<HD, 0>(a, grid);
      });
  if (!err) wkv6_last_route = 1;
  return err;
}

}  // namespace

extern "C" {

int wkv6_last_route = -1;

// r/k/v [B,S,H,hd] and y bf16 (bf16 != 0) or fp32; w [B,S,H,hd], u [H,hd]
// and s [B,H,hd,hd] fp32; s0 [B,H,hd,hd] null (s0_kind 0: zeros), fp32
// (1) or bf16 (2).  Chunks of Q <= 32 steps, segments of G chunks; loc (>=
// B*H*(segments - 1)*hd*hd floats) and dec (>= B*H*(segments - 1)*hd) the
// caller's scratch.
int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* y, void* s, void* loc,
                void* dec, int B, int S, int H, int hd, int Q, int G,
                int bf16, int s0_kind, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Q < 1 || Q > kWkvQ || G < 1 || S < 0 || s0_kind < 0 || s0_kind > 2 ||
      (s0_kind != 0 && s0 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  const int nseg = nc > 0 ? (nc + G - 1) / G : 1;
  if (nseg > 65535 || (nseg > 1 && (loc == nullptr || dec == nullptr)))
    return (int)cudaErrorInvalidValue;
  const WkvArgs a{r, k, v, w, u, s0, s0_kind, y, s, loc, dec, B, S, H, Q, G,
                  nseg, (cudaStream_t)stream};
  wkv6_last_route = -1;
  switch (hd) {
    case 16: return bf16 ? tc_launch<16>(a) : simt_launch<16>(a);
    case 32: return bf16 ? tc_launch<32>(a) : simt_launch<32>(a);
    case 64: return bf16 ? tc_launch<64>(a) : simt_launch<64>(a);
    case 128: return bf16 ? tc_launch<128>(a) : simt_launch<128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
