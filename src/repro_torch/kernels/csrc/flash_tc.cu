// Flash attention forward in bf16 on Hopper's tensor cores: causal,
// sliding-window and softcapped GQA attention with an online softmax, q
// [B,S,H,hd], k/v [B,S,KV,hd], any S.  It replaces the Pallas kernel
// flash_attention_fwd (repro/kernels/flash_attention/kernel.py) for bf16
// inputs; flash_attention_launch (model_kernels.cu) sends fp32 to the SIMT
// kernel.
//
// What bounds it: causal attention at the models' lengths does about S/2
// operations per byte of q, k and v, far above the H100's bf16 ridge
// (~295), so the bound is the tensor cores' 989 TFLOP/s.  So both products
// run as wgmma with fp32 sums, the scores never leave the registers, and
// the key/value tiles arrive by TMA ahead of the arithmetic.  Between the
// two products each score takes an exponential on the special-function
// units (16 a cycle a multiprocessor): at hd = 64 that is as many cycles
// as the products' tensor-core time, at hd = 80 four fifths of it.  Two
// consumer warpgroups, each running its own tiles' products and softmax,
// keep both units busy: one's softmax runs while the other's products do.
//
//   One block of 384 threads per (b * H + h, 128 query rows), the heaviest
//   query tiles of a causal mask launched first.
//   Warpgroup 2, the producer: one thread loads the Q tile once and the K
//     and V tiles of BK keys into rings of ST slots each with TMA over 4-D
//     maps of [B, S, heads, hd] (rows past S come back as zeros per batch
//     row), signalling each slot on its `full` mbarrier.
//   Warpgroups 0 and 1, the consumers, 64 query rows each.  Per key tile:
//     A. S = Q K^T by wgmma (Q and K K-major in shared memory) into BK/2
//        fp32 registers a thread; K's slot goes back to the producer on its
//        `empty` mbarrier.
//     B. The online softmax of _flash_fwd_kernel in base 2: scale, softcap
//        and mask in registers; the row max over the quad of threads that
//        holds a row (two shuffles); m' = max(m, max S), corr = 2^(m - m')
//        (O rescaled only when some row's max moved), P = 2^(S scale - m')
//        with the scale in the same FFMA (masked scores underflow to 0),
//        l' = l corr + sum P kept per thread and summed over the quad at
//        the end.  The fp32 accumulator fragment of S becomes, pair by
//        pair, the bf16 A fragment of P, as two: P's bf16 rounding and the
//        bf16 rounding of what that left.  One rounding (the TPU kernel's)
//        leaves up to 2^-9 of each weight: on the zamba2 forward's own
//        activations that put outputs past the bf16 tolerance against the
//        plain version (chip_smoke.py, phase 6); the two hold P to ~2^-17.
//     C. O += P_hi V + P_lo V by wgmma, P from registers, V the B operand
//        MN-major (the transpose bit); V's slot goes back to the producer.
//   setmaxnreg moves registers from the producer (24) to the consumers
//   (240).
//
// Two things set its speed.  Every branch around a wgmma must be uniform
// in the compiler's eyes (the warpgroup index is broadcast from lane 0):
// under a branch it takes for divergent, ptxas serializes the wgmmas, each
// waiting for the last.  And the registers: the compiler gives each thread
// at most 168, so O, S and both parts of P of one tile must fit, which
// sets the key tile: 128 keys at hd = 16, 64 up to hd = 128, 32 at
// hd = 256 (which still spills a little).  P V and the next tile's Q K^T
// in flight together would need a second S and P.
//
// Key tiles that no row of the block may see (past the causal frontier,
// before the window) are not loaded; a consumer skips the products of a
// tile none of its own 64 rows sees, and masks only tiles some of its rows
// see in part.  GQA: head h reads kv head h / (H / KV).
//
// Shared-memory layout: wgmma reads 128-byte-swizzled tiles markedly
// faster than 32-byte ones.  So the head-dim columns in whole 64s are kept
// as 64-column blocks in the 128-byte swizzle and the rest (16 or 32
// columns: hd = 16, 32, 80) as 16-column blocks in the 32-byte one, each
// block one TMA box.  hd = 80 is a 64-column block and a 16-column one: no
// padding, no wasted MMA work.  Q K^T walks the blocks one k16 step at a
// time; P V is one wgmma over the 64-column blocks (N = 64, 128 or 256)
// and one over the 16-column ones (N = 16 or 32).

#include <cuda_bf16.h>

#include "hopper.cuh"
#include "wgmma_ops.cuh"

namespace {

using tc::ex2;
using tc::smem_u32;
using tc::split_bf16;

constexpr int kConsumers = 256;            // warpgroups 0 and 1
constexpr int kThreads = kConsumers + 128; // and the producer, warpgroup 2
constexpr int kBQ = 128;
constexpr float kNegInf = -1e30f;          // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// A tile of R rows x HD columns in shared memory: HM columns as 64-column
// blocks (128-byte swizzle), then HT as 16-column blocks (32-byte swizzle).
template <int HD>
struct Tile {
  static constexpr int HM = HD / 64 * 64, HT = HD - HM;
  static_assert(HT % 16 == 0, "head dim not a multiple of 16");
  static constexpr __host__ __device__ int bytes(int R) {
    return R * HD * 2;
  }

  // Descriptor of the k16 step c (columns 16c .. 16c + 15) of a K-major
  // operand: rows row0 .. row0 + 63 (A) or all R (B).
  static __device__ __forceinline__ uint64_t kmajor(uint32_t t, int R, int c,
                                                    int row0) {
    if (16 * c < HM)
      return tc::make_desc(t + (16 * c / 64) * R * 128 + row0 * 128
                           + (16 * c % 64) * 2, 16, 1024, tc::kSwizzle128);
    return tc::make_desc(t + R * HM * 2 + ((16 * c - HM) / 16) * R * 32
                         + row0 * 32, 16, 256, tc::kSwizzle32);
  }

  // TMA of rows `row` .. + R - 1 of (b, head) into the tile at t.
  static __device__ __forceinline__ void load(
      uint32_t t, int R, const CUtensorMap* main, const CUtensorMap* tail,
      uint32_t bar, int head, int row, int b) {
#pragma unroll
    for (int i = 0; i < HM / 64; ++i)
      tc::tma_load_4d(t + i * R * 128, main, bar, 64 * i, head, row, b);
#pragma unroll
    for (int i = 0; i < HT / 16; ++i)
      tc::tma_load_4d(t + R * HM * 2 + i * R * 32, tail, bar, HM + 16 * i,
                      head, row, b);
  }
};

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal,
                                        int window) {
  return kp < S && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// O += P V for one tile, P as its bf16 high and low parts (pa, pl): V
// MN-major, 64-column atoms BK * 128 bytes apart with 8-key groups 1024
// bytes apart, 16-column atoms BK * 32 bytes apart with 8-key groups 256
// bytes apart.
template <typename T, int BK>
__device__ __forceinline__ void pv_issue(float* o, const uint32_t* pa,
                                         const uint32_t* pl, uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const uint32_t* a = (part ? pl : pa) + 4 * kk;
      if constexpr (T::HM > 0)
        tc::wgmma_rs<T::HM, 1>(
            o, a,
            tc::make_desc(v + kk * 16 * 128, BK * 128, 1024,
                          tc::kSwizzle128), 1);
      if constexpr (T::HT > 0)
        tc::wgmma_rs<T::HT, 1>(
            o + T::HM / 2, a,
            tc::make_desc(v + BK * T::HM * 2 + kk * 16 * 32, BK * 32, 256,
                          tc::kSwizzle32), 1);
    }
  }
}

// The online softmax of one tile's scores sc (this thread's rows ra, rb):
// softcap and mask in natural units, the rows' max over their quads, then
// base 2 with the scale in the exponent's FFMA.  Writes P (the A fragment
// of P V: its high and low bf16 parts), the rows' corrections, and
// updates m and l.
template <int BK>
__device__ __forceinline__ void softmax(
    float* sc, uint32_t* pa, uint32_t* pl, float& corr_a, float& corr_b,
    float& m_a, float& m_b, float& l_a, float& l_b, int ra, int rb, int cl,
    int k0, int wq0, int wq1, int S, int causal, int window, float softcap,
    float scale, float mult) {
  if (softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      sc[i] = softcap * tanhf(sc[i] * scale / softcap);
  }
  const bool whole = (!causal || k0 + BK - 1 <= wq0) &&
                     (window <= 0 || k0 > wq1 - window) && k0 + BK <= S;
  if (!whole) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int qp = (i & 2) ? rb : ra;
      const int kp = k0 + 8 * (i / 4) + cl + (i & 1);
      if (!visible(qp, kp, S, causal, window)) sc[i] = kNegInf;
    }
  }
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int i = 0; i < BK / 2; i += 4) {
    mx_a = fmaxf(mx_a, fmaxf(sc[i], sc[i + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[i + 2], sc[i + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a == kNegInf ? kNegInf : mx_a * mult);
  const float mn_b = fmaxf(m_b, mx_b == kNegInf ? kNegInf : mx_b * mult);
  corr_a = ex2(m_a - mn_a);
  corr_b = ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  // a row that has seen only masked keys subtracts 0, so its masked
  // entries still underflow to 0
  const float sub_a = mn_a == kNegInf ? 0.f : mn_a;
  const float sub_b = mn_b == kNegInf ? 0.f : mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; i += 4) {
    const float p0 = ex2(fmaf(sc[i], mult, -sub_a));
    const float p1 = ex2(fmaf(sc[i + 1], mult, -sub_a));
    const float p2 = ex2(fmaf(sc[i + 2], mult, -sub_b));
    const float p3 = ex2(fmaf(sc[i + 3], mult, -sub_b));
    sum_a += p0 + p1;
    sum_b += p2 + p3;
    // accumulator pairs i/2, i/2 + 1 are A-fragment registers i/2, i/2 + 1:
    // key step i/8, registers (row a, k lo), (row b, k lo), (row a, k hi),
    // (row b, k hi)
    split_bf16(p0, p1, pa[i / 2], pl[i / 2]);
    split_bf16(p2, p3, pa[i / 2 + 1], pl[i / 2 + 1]);
  }
  l_a = l_a * corr_a + sum_a;
  l_b = l_b * corr_b + sum_b;
}

struct Maps {
  CUtensorMap q_main, q_tail, k_main, k_tail, v_main, v_tail;
};

// HD head dims, BK keys a K or V tile, ST slots of each beside the Q tile
// (the launcher's table below).
template <int HD, int BK, int ST>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ Maps maps,
                __nv_bfloat16* __restrict__ out, int S, int H, int KV,
                int causal, int window, float softcap, float scale) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;       // swizzle atoms align
  // Q, then the K slots, then the V slots; each slot its `full` and
  // `empty` barrier (K's, then V's)
  const uint32_t qs = base;
  auto ks = [&](int s) { return base + T::bytes(kBQ) + s * T::bytes(BK); };
  auto vs = [&](int s) { return ks(ST + s); };
  const uint32_t bars = vs(ST);
  auto full_k = [&](int s) { return bars + 8 * s; };
  auto full_v = [&](int s) { return bars + 8 * (ST + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 * ST + s); };
  auto empty_v = [&](int s) { return bars + 8 * (3 * ST + s); };
  const uint32_t qbar = bars + 32 * ST;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;     // heaviest first
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = k_begin / BK, nt = (k_end + BK - 1) / BK - t0;

  if (tid == 0) {
    for (int s = 0; s < 2 * ST; ++s) {
      tc::mbar_init(bars + 8 * s, 1);                 // full: the producer
      tc::mbar_init(bars + 8 * (2 * ST + s), kConsumers / 32);  // empty
    }
    tc::mbar_init(qbar, 1);
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer -------------------------------------------------------
    tc::setmaxnreg_dec<24>();
    if (tid == kConsumers) {
      tc::mbar_expect_tx(qbar, T::bytes(kBQ));
      T::load(qs, kBQ, &maps.q_main, &maps.q_tail, qbar, h, q0, b);
      for (int it = 0; it < nt; ++it) {
        const int s = it % ST, par = ((it / ST) & 1) ^ 1;
        const int k0 = (t0 + it) * BK;
        tc::mbar_wait(empty_k(s), par);
        tc::mbar_expect_tx(full_k(s), T::bytes(BK));
        T::load(ks(s), BK, &maps.k_main, &maps.k_tail, full_k(s), kvh, k0,
                b);
        tc::mbar_wait(empty_v(s), par);
        tc::mbar_expect_tx(full_v(s), T::bytes(BK));
        T::load(vs(s), BK, &maps.v_main, &maps.v_tail, full_v(s), kvh, k0,
                b);
      }
    }
    return;
  }

  // ---- consumers: query rows q0 + 64 cw .. + 63 --------------------------
  tc::setmaxnreg_inc<240>();
  // the warpgroup and warp from lane 0, so that the compiler sees them
  // (and every branch on them) uniform across the warp: a wgmma under a
  // branch it must take for divergent is serialized
  const int cw = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, tid / 32 % 4, 0);
  const int lane = tid % 32;
  const int wq0 = q0 + 64 * cw, wq1 = wq0 + 63;
  // this thread's two rows (accumulator registers 4j + {0,1} and
  // 4j + {2,3}) and its first column within each 8-column group
  const int ra = wq0 + 16 * warp + lane / 4, rb = ra + 8;
  const int cl = 2 * (lane % 4);
  const float mult = softcap > 0.f ? kLog2e : scale * kLog2e;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  tc::mbar_wait(qbar, 0);
  for (int it = 0; it < nt; ++it) {
    const int s = it % ST, par = (it / ST) & 1, k0 = (t0 + it) * BK;
    const bool qk = (!causal || k0 <= wq1) &&
                    (window <= 0 || k0 + BK - 1 > wq0 - window);
    float sc[BK / 2];
    uint32_t pa[BK / 4], pl[BK / 4];        // P's A fragment: high, low
    tc::mbar_wait(full_k(s), par);
    if (qk) {                                // S = Q K^T
      tc::wgmma_fence();
#pragma unroll
      for (int c = 0; c < HD / 16; ++c)
        tc::wgmma_ss<BK, 0>(sc, T::kmajor(qs, kBQ, c, 64 * cw),
                             T::kmajor(ks(s), BK, c, 0), c > 0);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs<BK / 2>(sc);
    }
    if (lane == 0) tc::mbar_arrive(empty_k(s));
    if (qk) {
      float corr_a, corr_b;
      softmax<BK>(sc, pa, pl, corr_a, corr_b, m_a, m_b, l_a, l_b, ra, rb, cl,
                  k0, wq0, wq1, S, causal, window, softcap, scale, mult);
      if (__any_sync(0xffffffffu, corr_a != 1.f || corr_b != 1.f)) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= corr_a;
          o[4 * j + 1] *= corr_a;
          o[4 * j + 2] *= corr_b;
          o[4 * j + 3] *= corr_b;
        }
      }
    }
    tc::mbar_wait(full_v(s), par);
    if (qk) {                                // O += P V
      tc::wgmma_fence();
      pv_issue<T, BK>(o, pa, pl, vs(s));
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs<HD / 2>(o);
      tc::fence_regs<BK / 4>(pa);
      tc::fence_regs<BK / 4>(pl);
    }
    if (lane == 0) tc::mbar_arrive(empty_v(s));
  }

  // O / l, rows past S not written
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  const long long rstride = (long long)H * HD;
  __nv_bfloat16* ob = out + ((long long)b * S * H + h) * HD + cl;
  if (ra < S) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(ob + ra * rstride + 8 * j) =
          tc::pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
  }
  if (rb < S) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(ob + rb * rstride + 8 * j) =
          tc::pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

// The main and tail maps of one tensor [B, S, heads, HD] with boxes of R
// rows.
template <int HD>
int encode_pair(CUtensorMap* main, CUtensorMap* tail, const void* p, int B,
                int S, int heads, int R) {
  using T = Tile<HD>;
  const uint64_t d[4] = {HD, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const uint64_t st[3] = {HD, (uint64_t)heads * HD, (uint64_t)S * heads * HD};
  int err = 0;
  if (T::HM > 0) {
    const uint32_t box[4] = {64, 1, (uint32_t)R, 1};
    err = tc::encode_bf16_map(main, p, 4, d, st, box,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (!err && T::HT > 0) {
    const uint32_t box[4] = {16, 1, (uint32_t)R, 1};
    err = tc::encode_bf16_map(tail, p, 4, d, st, box,
                              CU_TENSOR_MAP_SWIZZLE_32B);
  }
  return err;
}

template <int HD, int BK, int ST>
int launch_t(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int KV, int causal, int window, float softcap,
             float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  constexpr int smem = T::bytes(kBQ) + 2 * ST * T::bytes(BK)
                       + (4 * ST + 1) * 8 + 1024;
  static_assert(smem <= 232448, "shared memory of a block exceeded");
  Maps maps{};
  int err = encode_pair<HD>(&maps.q_main, &maps.q_tail, q, B, S, H, kBQ);
  if (!err) err = encode_pair<HD>(&maps.k_main, &maps.k_tail, k, B, S, KV,
                                  BK);
  if (!err) err = encode_pair<HD>(&maps.v_main, &maps.v_tail, v, B, S, KV,
                                  BK);
  if (err) return err;
  auto kern = flash_tc_kernel<HD, BK, ST>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(maps, (__nv_bfloat16*)out, S, H, KV,
                                         causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launched by flash_attention_launch (model_kernels.cu) for bf16.
int tc_flash_bf16(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int H, int KV, int hd, int causal, int window,
                  float softcap, float scale, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorMisalignedAddress;
  // (HD, BK, ST): the key tile as large as the registers allow
#define FLASH_CASE(HD, BK, ST)                                              \
  case HD:                                                                  \
    return launch_t<HD, BK, ST>(q, k, v, out, B, S, H, KV, causal, window,  \
                                softcap, scale, st);
  switch (hd) {
    FLASH_CASE(16, 128, 4)
    FLASH_CASE(32, 64, 4)
    FLASH_CASE(64, 64, 4)
    FLASH_CASE(80, 64, 4)
    FLASH_CASE(128, 64, 4)
    FLASH_CASE(256, 32, 4)
#undef FLASH_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
