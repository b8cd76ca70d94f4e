// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (gmm_tc.cu, flash_tc.cu, ssd_scan.cu, wkv_scan.cu) and the hint-chain
// walk (metadata_kernels.cu): mbarriers, TMA loads (tiles and 1-D bulk)
// and stores, wgmma shared-memory descriptors and fences, register
// reallocation between warpgroups, the warp-level mma.sync and ldmatrix
// with the swizzle of their tiles, cp.async, the split of fp32 values into
// two bf16 parts, and the host-side encoding of TMA tensor maps.  Plain
// PTX; nothing from CUTLASS.
#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// never ends (a fault in the pipeline's protocol) traps after 10^10 clock
// cycles (~5 s), so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done) {
      const long long t = clock64();
      if (t0 == 0) t0 = t;
      else if (t - t0 > 10000000000LL) __trap();
    }
  } while (!done);
}

// --- TMA -------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// The TMA's 1-D form: `bytes` contiguous bytes from global to shared
// memory, completing on `bar`.  Both addresses 16-byte aligned, `bytes` a
// multiple of 16.
__device__ __forceinline__ void bulk_load_1d(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// TMA store of a box from shared memory (bulk group completion): only the
// part inside the tensor is written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
        "r"(c2) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Wait until the committed stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// A named barrier among `n` threads (id 0 is __syncthreads').
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma reading tiles stored by plain threads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// --- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode (1: 128 B, 3: 32 B; 2, 64 B, is
// not used here).
//   K-major, swizzled:  SBO = bytes between groups of 8 rows (M or N);
//                       LBO unused (1).
//   MN-major, swizzled: LBO = bytes between swizzle atoms along M or N,
//                       SBO = bytes between groups of 8 rows of K.
enum : int { kSwizzle128 = 1, kSwizzle32 = 3 };

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(swizzle) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may neither move their uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Give registers to (inc) or take them from (dec) this warpgroup.
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

// Two floats to a packed bf16 pair, round to nearest even (lo in the low
// half: the lower column or k index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// p0, p1 as a packed bf16 pair (the high part, nearest even) and the
// packed bf16 pair of what that rounding left (the low part): hi + lo
// holds p to ~2^-17 of its size, where hi alone holds it to 2^-9.
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(p0, p1);
  lo = pack_bf16(p0 - __uint_as_float(hi << 16),
                 p1 - __uint_as_float(hi & 0xffff0000u));
}

// 2^x by the special-function unit (flushing results below the normal
// range to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The two floats of a packed bf16 pair (lo: the low half).
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// --- warp-level mma.sync and ldmatrix ---------------------------------------
//
// mma.sync m16n8k16, bf16 in, fp32 sums: d += a b.  Thread (g = lane / 4,
// q = lane % 4) holds
//   a: a[0] = A[g][2q, 2q+1], a[1] = A[g+8][2q, 2q+1],
//      a[2] = A[g][2q+8, 2q+9], a[3] = A[g+8][2q+8, 2q+9];
//   b: b[0] = B[2q, 2q+1][g], b[1] = B[2q+8, 2q+9][g];
//   d: d[0], d[1] = D[g][2q, 2q+1], d[2], d[3] = D[g+8][2q, 2q+1].
// So the sums of two neighbouring n8 tiles are, packed pair by pair, the A
// operand of a product over those 16 columns.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix: each of 16 (x2) or 32 (x4) lanes gives the address of one
// 16-byte row of an 8 x 8 bf16 matrix; lane i of the warp receives row
// i / 4, columns 2 (i % 4), +1 of each matrix (.trans: column i / 4, rows
// 2 (i % 4), +1).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
               "[%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// A bf16 tile of rows of R elements (R a multiple of 16) in shared memory,
// its 16-byte chunks swizzled so that the 8 rows an ldmatrix reads at one
// column fall in 8 different bank groups: element (row, col) of the tile
// at `base` (a byte address).
template <int R>
__device__ __forceinline__ uint32_t swz(uint32_t base, int row, int col) {
  constexpr int CH = R / 8;                // 16-byte chunks a row
  const int c = col >> 3;
  int p;
  if constexpr (CH >= 8) p = c ^ (row & 7);
  else if constexpr (CH == 4) p = c ^ ((row >> 1) & 3);
  else p = c ^ ((row >> 2) & 1);
  return base + (uint32_t)(row * R + p * 8 + (col & 7)) * 2u;
}

// The A operand (16 x 16, rows m0.., columns k0..) of an mma from a tile
// [m][k] (ldsm_a) or from a tile [k][m] (ldsm_a_t), and the B operand (16
// x 8, rows k0.., column n0..) from a tile [k][n] (ldsm_b_t); R is the
// tile's row length.
template <int R>
__device__ __forceinline__ void ldsm_a(uint32_t* a, uint32_t t, int m0,
                                       int k0, int lane) {
  ldsm_x4(a, swz<R>(t, m0 + (lane & 15), k0 + (lane >> 4) * 8));
}
template <int R>
__device__ __forceinline__ void ldsm_a_t(uint32_t* a, uint32_t t, int m0,
                                         int k0, int lane) {
  const int j = lane >> 3;
  ldsm_x4_t(a, swz<R>(t, k0 + (j >> 1) * 8 + (lane & 7), m0 + (j & 1) * 8));
}
template <int R>
__device__ __forceinline__ void ldsm_b_t(uint32_t* b, uint32_t t, int k0,
                                         int n0, int lane) {
  ldsm_x2_t(b, swz<R>(t, k0 + ((lane >> 3) & 1) * 8 + (lane & 7), n0));
}

// The B operands of two neighbouring 8-column tiles (n0 and n0 + 8) by one
// ldmatrix.x4, from a tile [n][k] (ldsm_b_pair) or [k][n] (ldsm_b_t_pair).
template <int R>
__device__ __forceinline__ void ldsm_b_pair(uint32_t* b0, uint32_t* b1,
                                            uint32_t t, int k0, int n0,
                                            int lane) {
  uint32_t r[4];
  ldsm_x4(r, swz<R>(t, n0 + (lane & 7) + ((lane >> 4) << 3),
                    k0 + ((lane >> 3) & 1) * 8));
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}
template <int R>
__device__ __forceinline__ void ldsm_b_t_pair(uint32_t* b0, uint32_t* b1,
                                              uint32_t t, int k0, int n0,
                                              int lane) {
  uint32_t r[4];
  ldsm_x4_t(r, swz<R>(t, k0 + ((lane >> 3) & 1) * 8 + (lane & 7),
                      n0 + ((lane >> 4) << 3)));
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

// The B operands of NT neighbouring 8-column tiles from n0, from a tile
// [k][n]: in pairs, and an odd last one alone.
template <int R, int NT>
__device__ __forceinline__ void ldsm_bs_t(uint32_t (*b)[2], uint32_t t,
                                          int k0, int n0, int lane) {
#pragma unroll
  for (int j = 0; j + 1 < NT; j += 2)
    ldsm_b_t_pair<R>(b[j], b[j + 1], t, k0, n0 + 8 * j, lane);
  if constexpr (NT % 2) ldsm_b_t<R>(b[NT - 1], t, k0, n0 + 8 * (NT - 1), lane);
}

// --- cp.async ----------------------------------------------------------------

// 16 bytes from global to shared memory, asynchronously (in the L2 only).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// --- host: tensor maps -----------------------------------------------------

// cuTensorMapEncodeTiled is a driver API function: take it through the
// runtime's cudaGetDriverEntryPoint, so that the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first), element
// strides of the outer dimensions in elements, a box of `box` elements,
// out-of-bounds elements read as zeros.  Returns 0, or a cudaError_t:
// cudaErrorNotSupported without the driver's entry point,
// cudaErrorInvalidValue if the driver refuses the map.
inline int encode_bf16_map(CUtensorMap* map, const void* base, int rank,
                           const uint64_t* dims, const uint64_t* strides,
                           const uint32_t* box, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t gbox[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    gbox[i] = box[i];
    estride[i] = 1;
    if (i + 1 < rank) gstride[i] = strides[i] * 2;   // bytes
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(base), gdim, gstride, gbox, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace tc
