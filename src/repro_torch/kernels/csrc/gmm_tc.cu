// The grouped expert matmul in bf16 on Hopper's tensor cores: y[e] =
// x[e] @ w[e] with fp32 sums, x [E,C,D], w [E,D,F], y [E,C,F].  It
// replaces the Pallas kernel gmm (repro/kernels/moe_gmm/kernel.py) for
// bf16 inputs; gmm_launch (model_kernels.cu) sends fp32 to the SIMT kernel.
//
// What bounds it: at qwen3-moe's expert shape (E=128, C=640, D=2048,
// F=768) it does ~300 operations per byte read, at the H100's bf16 ridge,
// so the tensor cores' 989 TFLOP/s set its bound; the fp32 CUDA cores
// (67 TFLOP/s) cannot come near it.  So the products run as wgmma with the
// sums in registers, and the operand tiles reach shared memory
// asynchronously, a ring of stages ahead of the arithmetic.
//
// One block of 384 threads per (256-column tile of F, 128-row tile of C,
// expert), walking D in steps of 64 (one 128-byte swizzle atom of bf16);
// blocks in launch order share an expert's x and w in L2.
//
//   warpgroup 0, the producer, keeps a ring of 4 stages full, each the x
//     tile [128 x 64] and the w tile [64 x 256] (48 KB), and signals each
//     stage on its `full` mbarrier;
//   warpgroups 1 and 2, the consumers, each take 64 of the 128 rows and
//     issue wgmma m64n256k16 (4 per stage) into 128 fp32 accumulators a
//     thread, keeping one stage's products in flight while releasing the
//     stage before on its `empty` mbarrier; setmaxnreg moves registers
//     from the producer (40) to them (232).
//
// Both operands keep their layout in device memory: x[e] [C, D] is
// K-major, w[e] [D, F] MN-major (the descriptor's transpose bit); nothing
// is transposed on the host.  Two routes fill the same swizzled stages:
//
//   TMA (route 1), when D and F are multiples of 8 (16-byte row strides)
//     and x, w and y are 16-byte aligned: 3-D tensor maps over x [E,C,D]
//     and w [E,D,F], one thread issuing 5 loads a stage; their
//     out-of-bounds fill gives zeros past C, D and F inside each expert.
//   plain loads (route 2), for any other shape: the 128 producer threads
//     read the tiles element by element (zeros past the edges), store them
//     in the same 128-byte swizzle and fence them for the async proxy.
//     Each thread waits for its loads chunk by chunk, so this route is
//     bound by their latency, not by the tensor cores.
//
// The epilogue rounds the sums to bf16 (nearest even, as torch).  On the
// TMA route the tile is staged in the (then idle) ring and written by TMA
// stores over a map of y [E,C,F], which clip it at the C and F edges; on
// the other it is stored from the registers, masked at the edges.

#include <cuda_bf16.h>

#include "hopper.cuh"
#include "wgmma_ops.cuh"

namespace {

using tc::smem_u32;

constexpr int kThreads = 384;
constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kATile = kBM * kBK * 2;                 // 16 KB
constexpr int kBAtom = kBK * 64 * 2;                  // 8 KB: 64 columns
constexpr int kBTile = kBK * kBN * 2;                 // 32 KB
constexpr int kStage = kATile + kBTile;
constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;

// The 16-byte chunk `c` of row `r` of a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Eight bf16 of a row from `src` (columns col .. col+7 of `n`), zeros past
// the end or when the row is out of range.
__device__ __forceinline__ uint4 load8(const unsigned short* src, int col,
                                       int n, bool row_ok) {
  unsigned short h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    h[i] = (row_ok && col + i < n) ? __ldg(src + col + i) : (unsigned short)0;
  return make_uint4(h[0] | (uint32_t)h[1] << 16, h[2] | (uint32_t)h[3] << 16,
                    h[4] | (uint32_t)h[5] << 16, h[6] | (uint32_t)h[7] << 16);
}

__global__ void __launch_bounds__(kThreads, 1)
gmm_tc_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap,
              const __grid_constant__ CUtensorMap ymap,
              const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w,
              __nv_bfloat16* __restrict__ y, int C, int D, int F,
              int use_tma) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;       // swizzle atoms align
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + kStages * kStage;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int tid = threadIdx.x, wg = tid / 128;
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (D + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(full(s), use_tma ? 1 : 128);
      tc::mbar_init(empty(s), 8);                     // the consumer warps
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  // D step kt uses stage kt % kStages in its (kt / kStages)-th round
  if (wg == 0) {
    // ---- producer -------------------------------------------------------
    tc::setmaxnreg_dec<40>();
    if (use_tma) {
      if (tid == 0) {
        tc::tma_prefetch(&xmap);
        tc::tma_prefetch(&wmap);
        for (int kt = 0; kt < nk; ++kt) {
          const int s = kt % kStages;
          tc::mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
          const uint32_t a = base + s * kStage, b = a + kATile;
          tc::mbar_expect_tx(full(s), kStage);
          tc::tma_load_3d(a, &xmap, full(s), kt * kBK, m0, e);
#pragma unroll
          for (int i = 0; i < kBN / 64; ++i)
            tc::tma_load_3d(b + i * kBAtom, &wmap, full(s), n0 + 64 * i,
                            kt * kBK, e);
        }
      }
    } else {
      const unsigned short* xe = reinterpret_cast<const unsigned short*>(x)
                                 + (long long)e * C * D;
      const unsigned short* we = reinterpret_cast<const unsigned short*>(w)
                                 + (long long)e * D * F;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        tc::mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
        uint8_t* a = sbase + s * kStage;
        uint8_t* b = a + kATile;
        const int k0 = kt * kBK;
        // x tile: 128 rows x 8 chunks
        for (int id = tid; id < kBM * 8; id += 128) {
          const int r = id >> 3, c = id & 7, gm = m0 + r;
          *reinterpret_cast<uint4*>(a + sw128(r, c)) =
              load8(xe + (long long)(gm < C ? gm : 0) * D, k0 + 8 * c, D,
                    gm < C);
        }
        // w tile: 4 atoms of 64 k rows x 8 chunks
        for (int id = tid; id < (kBN / 64) * kBK * 8; id += 128) {
          const int at = id / (kBK * 8), r = (id >> 3) % kBK, c = id & 7;
          const int gk = k0 + r;
          *reinterpret_cast<uint4*>(b + at * kBAtom + sw128(r, c)) =
              load8(we + (long long)(gk < D ? gk : 0) * F,
                    n0 + 64 * at + 8 * c, F, gk < D);
        }
        tc::fence_proxy_async();
        tc::mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumers: rows 64 (wg - 1) .. + 63 of the tile ----------------
    tc::setmaxnreg_inc<232>();
    const int cw = wg - 1, ctid = tid - 128 * wg;
    const int warp = ctid / 32, lane = ctid % 32;
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      tc::mbar_wait(full(s), (kt / kStages) & 1);
      const uint32_t a = base + s * kStage + cw * 64 * 128;
      const uint32_t b = base + s * kStage + kATile;
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: K-major, 8-row groups 1024 B apart, k16 = 32 B into the atom;
        // B: MN-major, 64-column atoms kBAtom apart, 8-row groups of k
        // 1024 B apart, k16 = 16 rows = 2048 B
        const uint64_t da = tc::make_desc(a + kk * 32, 16, 1024,
                                          tc::kSwizzle128);
        const uint64_t db = tc::make_desc(b + kk * 2048, kBAtom, 1024,
                                          tc::kSwizzle128);
        tc::wgmma_ss<kBN, 1>(acc, da, db, 1);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<1>();                 // the step before is read
      if (kt > 0 && lane == 0) tc::mbar_arrive(empty((kt - 1) % kStages));
    }
    tc::wgmma_wait<0>();
    tc::fence_regs<kBN / 2>(acc);

    // accumulator i: row 16 warp + lane/4 + 8 ((i/2) & 1), column
    // 8 (i/4) + 2 (lane%4) + (i & 1)
    if (use_tma) {
      // The ring is read (every stage waited for, both warpgroups past
      // their last wgmma): the tile goes there as bf16, in four 64-column
      // boxes of the 128-byte swizzle (each row's 16-byte chunk j at
      // j ^ (row % 8), so a warp's writes meet no bank twice), and leaves
      // by TMA stores, which write whole lines and drop what lies past C
      // and F.
      tc::bar_sync(1, 256);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 64 * cw + 16 * warp + lane / 4 + 8 * hh;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          *reinterpret_cast<uint32_t*>(
              sbase + (j / 8) * kBM * 128 + sw128(r, j % 8)
              + 4 * (lane % 4)) =
              tc::pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      }
      tc::fence_proxy_async();
      tc::bar_sync(1, 256);
      if (ctid == 0 && cw == 0) {
#pragma unroll
        for (int i = 0; i < kBN / 64; ++i)
          tc::tma_store_3d(&ymap, base + i * kBM * 128, n0 + 64 * i, m0, e);
        tc::bulk_commit();
        tc::bulk_wait_read();
      }
      return;
    }
    __nv_bfloat16* ye = y + (long long)e * C * F;
    const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + 64 * cw + 16 * warp + lane / 4 + 8 * hh;
      if (row >= C) continue;
      __nv_bfloat16* yr = ye + (long long)row * F;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = col0 + 8 * j;
        const float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
        if ((F & 1) == 0 && col + 1 < F) {
          *reinterpret_cast<uint32_t*>(yr + col) = tc::pack_bf16(v0, v1);
        } else {
          if (col < F) yr[col] = __float2bfloat16(v0);
          if (col + 1 < F) yr[col + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

}  // namespace

// Launched by gmm_launch (model_kernels.cu) for bf16; *route is set to 1
// (TMA) or 2 (plain loads).
int tc_gmm_bf16(const void* x, const void* w, void* y, int E, int C, int D,
                int F, cudaStream_t stream, int* route) {
  const bool tma = D % 8 == 0 && F % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  CUtensorMap xmap{}, wmap{}, ymap{};
  if (tma) {
    const uint64_t xd[3] = {(uint64_t)D, (uint64_t)C, (uint64_t)E};
    const uint64_t xs[2] = {(uint64_t)D, (uint64_t)C * D};
    const uint32_t xb[3] = {kBK, kBM, 1};
    const uint64_t wd[3] = {(uint64_t)F, (uint64_t)D, (uint64_t)E};
    const uint64_t ws[2] = {(uint64_t)F, (uint64_t)D * F};
    const uint32_t wb[3] = {64, kBK, 1};
    const uint64_t yd[3] = {(uint64_t)F, (uint64_t)C, (uint64_t)E};
    const uint64_t ys[2] = {(uint64_t)F, (uint64_t)C * F};
    const uint32_t yb[3] = {64, kBM, 1};
    int err = tc::encode_bf16_map(&xmap, x, 3, xd, xs, xb,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
    if (!err) err = tc::encode_bf16_map(&wmap, w, 3, wd, ws, wb,
                                        CU_TENSOR_MAP_SWIZZLE_128B);
    if (!err) err = tc::encode_bf16_map(&ymap, y, 3, yd, ys, yb,
                                        CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  *route = tma ? 1 : 2;
  cudaError_t e = cudaFuncSetAttribute(
      gmm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  gmm_tc_kernel<<<grid, kThreads, kSmem, stream>>>(
      xmap, wmap, ymap, (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
      (__nv_bfloat16*)y, C, D, F, tma ? 1 : 0);
  return (int)cudaGetLastError();
}
