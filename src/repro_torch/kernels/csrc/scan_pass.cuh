// The segment-parallel structure shared by the two chunked scans
// (ssd_scan.cu, wkv_scan.cu).  A scan over S steps in chunks of Q carries a
// state from chunk to chunk; on a TPU the chunks run in order on one core.
// Here the chunks are cut into segments of G chunks, and one call runs
//
//   (A) per (batch row, head, segment but the last), in parallel: the
//       segment's end state from a zero start, and its decay (the product
//       of its chunks' decays: one factor per head for the SSD scan, one
//       per state row for the WKV scan);
//   (B) this pass, per (batch row, head) and state element: the segments'
//       start states in order, start(g + 1) = decay(g) start(g) + local(g),
//       from the scan's initial state;
//   (C) per (batch row, head, segment), in parallel: the chunk loop from the
//       segment's start state, writing y (the last segment also the final
//       state).
//
// (C) repeats (A)'s state updates; in exchange B x H x segments blocks run
// at once instead of B x H.  The local states live in a scratch buffer the
// caller allocates, [B*H][segments - 1][state], and (B) overwrites each with
// the start state of the segment after it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// s0 (null: zeros) is [B*H][n] in fp32 or bf16 (s0_bf16); loc [B*H][nseg -
// 1][n]; dec [B*H][nseg - 1][n / group]: element e of a state decays by
// factor e / group.
__global__ void scan_pass_kernel(const void* __restrict__ s0, int s0_bf16,
                                 float* __restrict__ loc,
                                 const float* __restrict__ dec, int nseg,
                                 int n, int group) {
  const int bh = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long o = (long long)bh * n + e;
  float s = 0.f;
  if (s0 != nullptr)
    s = s0_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(s0)[o])
                : static_cast<const float*>(s0)[o];
  const int nd = n / group;
  float* l = loc + (long long)bh * (nseg - 1) * n + e;
  const float* d = dec + (long long)bh * (nseg - 1) * nd + e / group;
  for (int g = 0; g < nseg - 1; ++g) {
    s = fmaf(d[(long long)g * nd], s, l[(long long)g * n]);
    l[(long long)g * n] = s;
  }
}

int scan_pass(const void* s0, int s0_bf16, float* loc, const float* dec,
              int BH, int nseg, int n, int group, cudaStream_t st) {
  const dim3 grid((n + 255) / 256, BH);
  scan_pass_kernel<<<grid, 256, 0, st>>>(s0, s0_bf16, loc, dec, nseg, n,
                                         group);
  return (int)cudaGetLastError();
}

// The segment of a block of (A) (mode 0: grid [B*H, segments - 1]) or (C)
// (mode 1: grid [B*H, segments]): its steps, and where its start and end
// states of n elements are.
struct Seg {
  int bh, b, h, g, nseg, t_begin, t_end;
  __device__ Seg(int H, int S, int Q, int G, int mode) {
    bh = blockIdx.x;
    b = bh / H;
    h = bh % H;
    g = blockIdx.y;
    nseg = gridDim.y + (mode == 0);
    t_begin = g * G * Q;
    t_end = min(S, t_begin + G * Q);
  }
  // the start state's element i: zeros (mode 0), the scan's initial state
  // s0 (the first segment; s0_kind 0 zeros, 1 fp32, 2 bf16) or the pass's
  // start state
  __device__ float start(int mode, const void* s0, int s0_kind,
                         const float* loc, long long n, long long i) const {
    if (mode == 0) return 0.f;
    if (g > 0) return loc[((long long)bh * (nseg - 1) + g - 1) * n + i];
    if (s0_kind == 1) return static_cast<const float*>(s0)[bh * n + i];
    if (s0_kind == 2)
      return __bfloat162float(
          static_cast<const __nv_bfloat16*>(s0)[bh * n + i]);
    return 0.f;
  }
  // where the end state goes: the scratch (mode 0), the scan's final
  // state (the last segment), or nowhere
  __device__ float* out(int mode, float* loc, float* sout,
                        long long n) const {
    if (mode == 0) return loc + ((long long)bh * (nseg - 1) + g) * n;
    return g == nseg - 1 ? sout + bh * n : nullptr;
  }
};

// `smem` bytes of dynamic shared memory for `kern`, with all of the SM's
// unified L1 as shared memory, so that as many blocks fit as it allows.
template <typename Kern>
int prepare(Kern kern, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

// One call: (A) on BH x (nseg - 1) blocks by bind(grid, 0), the pass from
// s0 ([BH][n] fp32 or bf16, or null), (C) on BH x nseg by bind(grid, 1).
template <typename Bind>
int run_segments(int BH, int nseg, const void* s0, int s0_bf16, float* loc,
                 const float* dec, int n, int group, cudaStream_t st,
                 Bind bind) {
  if (nseg > 1) {
    int err = bind(dim3(BH, nseg - 1), 0);
    if (!err) err = scan_pass(s0, s0_bf16, loc, dec, BH, nseg, n, group, st);
    if (err) return err;
  }
  return bind(dim3(BH, nseg), 1);
}

}  // namespace
