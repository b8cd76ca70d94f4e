// Hand-written Hopper (sm_90a) kernels for the metadata plane's integer
// hot paths: partition hashing, chain hashing, composite-PK validation,
// hint-chain resolution and subtree wave expansion.  They replace the Pallas
// TPU kernels
//
//   phash        repro/kernels/phash/kernel.py      phash, phash_chain
//   pkval        repro/kernels/pkval/kernel.py      pkval
//   hintchain    repro/kernels/hintchain/kernel.py  hintchain
//   treeagg      repro/kernels/treeagg/kernel.py    treeagg
//
// and compute the same functions bit for bit.  Every value is a 32-bit
// integer (inode ids, which treeagg hands back, are int64); uint32 keys and
// name hashes travel as int32 bit patterns and are reinterpreted here.
// phash is bound by device-memory traffic (a few integer operations per
// byte): one thread per key with a grid-stride loop.  phash_chain, pkval,
// hintchain and treeagg were redesigned for Hopper; their own notes below
// say what bounds each and what the design does about it.
// Nothing is padded: the kernels take any n.
//
// Plain C interface (loaded with ctypes): each launcher takes device
// pointers, sizes and the CUDA stream to launch on, and returns the
// cudaError_t of the launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr uint32_t kGolden = 0x9E3779B1u;
constexpr uint32_t kGolden2 = 0x85EBCA6Bu;
constexpr int32_t kEmpty = -1;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 resident blocks per SM

__device__ __forceinline__ uint32_t mix32(uint32_t k) {
  uint32_t h = k * kGolden;
  return h ^ (h >> 16);
}

__global__ void phash_kernel(const int32_t* __restrict__ keys,
                             int32_t* __restrict__ out, long long n,
                             uint32_t n_partitions) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = (int32_t)(mix32((uint32_t)keys[i]) % n_partitions);
}

// --- phash_chain -------------------------------------------------------------
//
// Per path row: the partition of every component's parent id, the partition
// of the row's hint id, and the chain signature folded over the first
// depths[r] components.  A thread per row would read and write its D
// components with a stride of D ints between neighbouring lanes (32
// sectors a warp access), and a planner window of a thousand rows would
// fill 4 blocks.  So a block takes a tile of `rows` rows, which is one
// contiguous span of rows x D ints: every thread reads parents and names
// of one element (16-byte vector loads where D % 4 == 0 and the pointers
// are 16-byte aligned), writes its comp coalesced, and leaves
// mix(parent) ^ name, the fold's operand, in shared memory (row stride D
// rounded up to odd, so the fold's reads hit distinct banks).  Then one
// thread a row folds the signature, which is sequential by definition:
// it reads its row's operands from shared memory 8 at a time into
// registers, so the reads overlap and only the multiply chain is serial
// (a fold straight from shared memory, one read a step, took 0.35 µs
// more at D = 16).  It writes the hint partition and the signature.
// Blocks of 64 threads and 16 rows put N = 1,024 on 64 SMs.

constexpr int kPcThreads = 64;
constexpr int kPcRows = 16;                       // rows a block, at most
constexpr int kPcSmemCap = 48 * 1024;             // fold operands a block

__device__ __forceinline__ void chain_elem(uint32_t p, uint32_t m, int e,
                                           int depth, int stride,
                                           uint32_t n_partitions,
                                           uint32_t* xs, int32_t* comp_e) {
  const uint32_t h = mix32(p);
  *comp_e = (int32_t)(h % n_partitions);
  const int r = e / depth;
  xs[r * stride + (e - r * depth)] = h ^ m;
}

__global__ void __launch_bounds__(kPcThreads) phash_chain_kernel(
    const int32_t* __restrict__ parents, const int32_t* __restrict__ names,
    const int32_t* __restrict__ hints, const int32_t* __restrict__ depths,
    int32_t* __restrict__ comp, int32_t* __restrict__ hint_parts,
    int32_t* __restrict__ sigs, long long n, int depth,
    uint32_t n_partitions, int rows, int vec) {
  extern __shared__ uint32_t xs[];
  const int stride = depth | 1;
  for (long long r0 = (long long)blockIdx.x * rows; r0 < n;
       r0 += (long long)gridDim.x * rows) {
    const int nr = (int)(n - r0 < rows ? n - r0 : rows);
    const long long base = r0 * depth;
    const int span = nr * depth;
    if (vec) {
      const int4* p4 = reinterpret_cast<const int4*>(parents + base);
      const int4* m4 = reinterpret_cast<const int4*>(names + base);
      int4* c4 = reinterpret_cast<int4*>(comp + base);
      for (int q = threadIdx.x; q < span / 4; q += kPcThreads) {
        const int4 p = __ldg(p4 + q), m = __ldg(m4 + q);
        int4 c;
        chain_elem(p.x, m.x, 4 * q, depth, stride, n_partitions, xs, &c.x);
        chain_elem(p.y, m.y, 4 * q + 1, depth, stride, n_partitions, xs,
                   &c.y);
        chain_elem(p.z, m.z, 4 * q + 2, depth, stride, n_partitions, xs,
                   &c.z);
        chain_elem(p.w, m.w, 4 * q + 3, depth, stride, n_partitions, xs,
                   &c.w);
        c4[q] = c;
      }
    } else {
      for (int e = threadIdx.x; e < span; e += kPcThreads)
        chain_elem((uint32_t)__ldg(parents + base + e),
                   (uint32_t)__ldg(names + base + e), e, depth, stride,
                   n_partitions, xs, comp + base + e);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nr; t += kPcThreads) {
      const long long r = r0 + t;
      const int dep = min(__ldg(depths + r), depth);
      const uint32_t* x = xs + t * stride;
      uint32_t sig = 0;
      for (int d0 = 0; d0 < dep; d0 += 8) {      // 8 loads in flight
        uint32_t v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = d0 + k < dep ? x[d0 + k] : 0u;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (d0 + k < dep) {
            const uint32_t s = (sig ^ v[k]) * kGolden2;
            sig = s ^ (s >> 15);
          }
      }
      hint_parts[r] = (int32_t)(mix32((uint32_t)__ldg(hints + r)) %
                                n_partitions);
      sigs[r] = (int32_t)sig;
    }
    __syncthreads();
  }
}

// --- pkval -------------------------------------------------------------------
//
// Linear-probe lookup of every (parent, name hash) probe in the inode
// index: at most max_probe slots from home; an EMPTY parent ends the chain,
// a tombstone (-2) is stepped over, AMBIG (-3) values are returned as they
// are, and a probe parent < 0 is padding and always misses.
//
// The inode index (2^23 slots, 3 x 32 MiB) does not fit in L2, so each
// slot read is a round trip to device memory, and a thread walking its
// probe's chain slot after slot (tn only after tp matched, tv only after
// that) would wait for up to 2-3 of them a step.  Here a group of
// kPkLanes = 8 lanes takes one probe: lane s reads tp, tn and tv of slot
// home + s, three independent loads, so a window of 8 slots costs one round
// trip.  Two ballots over the warp give each group its lanes that hold the
// key (a hit) and that hold EMPTY; the answer is the lowest lane set in
// either: its value for a hit, -1 for EMPTY, and -1 when no lane is set
// after max_probe slots (windows of 8 in turn for a larger max_probe).
// That is the step loop, bit for bit: the mask wraps the window past the
// table's last slot.
// Blocks of 128 threads take 16 probes each, so the main path's ~2,500
// probes spread over all 132 SMs.

constexpr int kPkLanes = 8;
constexpr int kPkThreads = 128;

__global__ void __launch_bounds__(kPkThreads) pkval_kernel(
    const int32_t* __restrict__ tp, const int32_t* __restrict__ tn,
    const int32_t* __restrict__ tv, uint32_t mask,
    const int32_t* __restrict__ parents, const int32_t* __restrict__ names,
    int32_t* __restrict__ out, long long n, int max_probe) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kGroups = 32 / kPkLanes;           // probes a warp
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kPkLanes - 1);
  const int lead = lane - sub;                     // the group's lane 0
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long g0 = warp * kGroups; g0 < n; g0 += warps * kGroups) {
    const long long i = g0 + lane / kPkLanes;
    const bool valid = i < n;
    const int32_t par = valid ? __ldg(parents + i) : -1;
    const uint32_t nam = valid ? (uint32_t)__ldg(names + i) : 0u;
    uint32_t h = ((uint32_t)par * kGolden) ^ (nam * kGolden2);
    h ^= h >> 16;
    const uint32_t home = h & mask;
    bool done = par < 0;                           // padding misses
    int32_t res = kEmpty;
    for (int w0 = 0; w0 < max_probe; w0 += kPkLanes) {
      if (__all_sync(kAll, done)) break;
      const int step = w0 + sub;
      bool hit = false, empty = false;
      int32_t ev = kEmpty;
      if (!done && step < max_probe) {
        const uint32_t j = (home + (uint32_t)step) & mask;
        const int32_t ep = __ldg(tp + j);
        const uint32_t en = (uint32_t)__ldg(tn + j);
        ev = __ldg(tv + j);
        hit = ep >= 0 && ep == par && en == nam;
        empty = ep == kEmpty;
      }
      const unsigned hits = (__ballot_sync(kAll, hit) >> lead) & 0xFFu;
      const unsigned ends =
          (__ballot_sync(kAll, hit || empty) >> lead) & 0xFFu;
      const int first = __ffs(ends) - 1;           // -1: none in the window
      const int32_t v = __shfl_sync(kAll, ev, lead + (first < 0 ? 0 : first));
      if (!done && ends) {
        res = (hits >> first) & 1u ? v : kEmpty;
        done = true;
      }
    }
    if (valid && sub == 0) out[i] = res;
  }
}

// --- hintchain ---------------------------------------------------------------
//
// A walk is a chain of D dependent probe steps, so the kernel is bound by
// the latency of each step, not by bytes.  Route smem (the probe keys of
// both tables, parent and name, 8 bytes a slot, fit in kHcSmemCap): each
// block first copies the key arrays into shared memory by the TMA's 1-D
// bulk copy onto one mbarrier, and the value arrays too where all 12 bytes
// a slot fit; then it walks its ops there, one shared-memory round trip a
// probe step (and one read of a value from device memory for each key
// found, where the values stayed there).  Route global (larger tables):
// the same walk through the non-coherent cache.  On both, a depth's client
// and fallback probes run interleaved, their loads issued before either
// answer is used.  Blocks are small (kHcThreads), so that a window of a
// thousand ops spreads over 16 SMs.

constexpr int kHcThreads = 64;
constexpr long long kHcSmemCap = 200 * 1024;   // table bytes on route smem
constexpr int kHcRow = 16;                     // names a thread holds at once

template <bool kSmem>
__device__ __forceinline__ int32_t ld_table(const int32_t* p) {
  if (kSmem) return *p;
  return __ldg(p);
}

// probe_table for (par, nam) in the client and the fallback table at once:
// each step loads both tables' slot before comparing either.  Keys (tp,
// tn) in shared memory where kKeys, values (tv) where kVals.
template <bool kKeys, bool kVals>
__device__ __forceinline__ void probe_both(
    const int32_t* cp, const int32_t* cn, const int32_t* cv, uint32_t cmask,
    const int32_t* fp, const int32_t* fn, const int32_t* fv, uint32_t fmask,
    int32_t par, uint32_t nam, int max_probe, int32_t& cval,
    int32_t& fval) {
  cval = kEmpty;
  fval = kEmpty;
  if (par < 0) return;
  uint32_t h = ((uint32_t)par * kGolden) ^ (nam * kGolden2);
  h ^= h >> 16;
  bool cgo = true, fgo = true;
  int32_t jc_hit = -1, jf_hit = -1;
  for (int step = 0; step < max_probe && (cgo || fgo); ++step) {
    const uint32_t jc = (h + (uint32_t)step) & cmask;
    const uint32_t jf = (h + (uint32_t)step) & fmask;
    const int32_t ec = ld_table<kKeys>(cp + jc), ef = ld_table<kKeys>(fp + jf);
    const uint32_t nc = (uint32_t)ld_table<kKeys>(cn + jc);
    const uint32_t nf = (uint32_t)ld_table<kKeys>(fn + jf);
    if (cgo) {
      if (ec >= 0 && ec == par && nc == nam) {
        jc_hit = (int32_t)jc;
        cgo = false;
      } else if (ec == kEmpty) {
        cgo = false;
      }
    }
    if (fgo) {
      if (ef >= 0 && ef == par && nf == nam) {
        jf_hit = (int32_t)jf;
        fgo = false;
      } else if (ef == kEmpty) {
        fgo = false;
      }
    }
  }
  // the two values, read together
  if (jc_hit >= 0) cval = ld_table<kVals>(cv + jc_hit);
  if (jf_hit >= 0) fval = ld_table<kVals>(fv + jf_hit);
}

// Ints of one table array in shared memory: a whole number of 16 bytes.
__host__ __device__ __forceinline__ long long hc_span(long long cap) {
  return (cap + 3) & ~3LL;
}

// One thread per op: walk the op's chain from root_id, one depth per step.
// A client answer other than a miss wins, an AMBIG (-3) answer included;
// child -3 tells the host to resolve that op again exactly.  Past the op's
// depth or its first miss: child -2, src -1.  out holds child [n, depth]
// then src [n, depth]; names are read and rows written as int4 where vec
// (depth a multiple of 4, names and out 16-byte aligned).
template <bool kKeys, bool kVals>
__global__ void __launch_bounds__(kHcThreads) hintchain_kernel(
    const int32_t* __restrict__ gcp, const int32_t* __restrict__ gcn,
    const int32_t* __restrict__ gcv, long long ccap,
    const int32_t* __restrict__ gfp, const int32_t* __restrict__ gfn,
    const int32_t* __restrict__ gfv, long long fcap,
    const int32_t* __restrict__ names, const int32_t* __restrict__ depths,
    int32_t* __restrict__ out, long long n, int depth, int32_t root_id,
    int max_probe, int vec) {
  extern __shared__ __align__(128) int32_t hsm[];
  __shared__ __align__(8) uint64_t bar;
  // client par, nam, val, fallback par, nam, val
  const int32_t* tab[6] = {gcp, gcn, gcv, gfp, gfn, gfv};
  uint32_t bulk = 0;                 // bytes the bulk copies bring
  if (kKeys) {
    // the keys (and the values where kVals) of both tables: each array by
    // one bulk copy where it is 16-byte aligned and a whole number of 16
    // bytes (capacities are powers of two: all but 1 and 2 slots), else
    // by plain loads
    constexpr int kArrays = kVals ? 6 : 4;
    const int which[6] = {0, 3, 1, 4, 2, 5};    // keys first, then values
    const long long cs = hc_span(ccap), fs = hc_span(fcap);
    long long off[6];
    off[0] = 0;
    for (int a = 1; a < kArrays; ++a)
      off[a] = off[a - 1] + (which[a - 1] < 3 ? cs : fs);
    bool by_bulk[6];
#pragma unroll
    for (int a = 0; a < kArrays; ++a) {
      const long long bytes = 4 * (which[a] < 3 ? ccap : fcap);
      by_bulk[a] = bytes % 16 == 0 && (uintptr_t)tab[which[a]] % 16 == 0;
      if (by_bulk[a]) bulk += (uint32_t)bytes;
    }
    const uint32_t b = tc::smem_u32(&bar);
    if (threadIdx.x == 0 && bulk) {
      tc::mbar_init(b, 1);
      tc::mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0 && bulk) {
      tc::mbar_expect_tx(b, bulk);
#pragma unroll
      for (int a = 0; a < kArrays; ++a)
        if (by_bulk[a])
          tc::bulk_load_1d(tc::smem_u32(hsm + off[a]), tab[which[a]],
                           (uint32_t)(4 * (which[a] < 3 ? ccap : fcap)), b);
    }
#pragma unroll
    for (int a = 0; a < kArrays; ++a)
      if (!by_bulk[a])
        for (long long j = threadIdx.x; j < (which[a] < 3 ? ccap : fcap);
             j += blockDim.x)
          hsm[off[a] + j] = tab[which[a]][j];
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kArrays; ++a) tab[which[a]] = hsm + off[a];
  }
  const uint32_t cmask = (uint32_t)(ccap - 1), fmask = (uint32_t)(fcap - 1);
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    const int32_t dep = depths[r];
    const int32_t* nrow = names + r * depth;
    int32_t* crow = out + r * depth;
    int32_t* srow = out + n * depth + r * depth;
    int32_t parent = root_id;
    bool alive = dep > 0;
    for (int d0 = 0; d0 < depth; d0 += kHcRow) {
      const int len = min(kHcRow, depth - d0);
      int32_t nm[kHcRow], c[kHcRow], s[kHcRow];
#pragma unroll
      for (int q = 0; q < kHcRow; q += 4) {
        if (vec && q < len) {
          const int4 x = __ldg(reinterpret_cast<const int4*>(nrow + d0 + q));
          nm[q] = x.x;
          nm[q + 1] = x.y;
          nm[q + 2] = x.z;
          nm[q + 3] = x.w;
        } else {
#pragma unroll
          for (int k = q; k < q + 4; ++k)
            nm[k] = k < len ? __ldg(nrow + d0 + k) : 0;
        }
      }
      // the bulk copies land while the block's first names are read
      if (bulk) {
        tc::mbar_wait(tc::smem_u32(&bar), 0);
        bulk = 0;
      }
#pragma unroll
      for (int k = 0; k < kHcRow; ++k) {
        int32_t ck = -2, sk = -1;
        if (alive && k < len && d0 + k < dep) {
          int32_t cval, fval;
          probe_both<kKeys, kVals>(tab[0], tab[1], tab[2], cmask, tab[3],
                                   tab[4], tab[5], fmask, parent,
                                   (uint32_t)nm[k], max_probe, cval, fval);
          const int32_t val = cval != kEmpty ? cval : fval;
          ck = val;
          if (val > 0) {
            sk = cval > 0 ? 0 : 1;
            parent = val;
          } else {
            alive = false;
          }
        } else {
          alive = false;
        }
        c[k] = ck;
        s[k] = sk;
      }
#pragma unroll
      for (int q = 0; q < kHcRow; q += 4) {
        if (vec && q < len) {
          *reinterpret_cast<int4*>(crow + d0 + q) =
              make_int4(c[q], c[q + 1], c[q + 2], c[q + 3]);
          *reinterpret_cast<int4*>(srow + d0 + q) =
              make_int4(s[q], s[q + 1], s[q + 2], s[q + 3]);
        } else {
#pragma unroll
          for (int k = q; k < q + 4; ++k)
            if (k < len) {
              crow[d0 + k] = c[k];
              srow[d0 + k] = s[k];
            }
        }
      }
    }
  }
}

// --- treeagg -----------------------------------------------------------------
//
// Every inode-table slot's parent is looked up in the sorted wave (a lower
// bound: the wave member the slot is a child of, or none; cleared slots
// carry parent -1), and each member gets the sums of 1, is_dir and size
// over its children, wrapping modulo 2^32 like the TPU kernel's int32 sums.
//
// Bound by reading par (4 bytes a slot; the children's other columns are
// read only for them).  A tile is kTaThreads threads x kTaVecs int4 loads
// of par (4,096 slots); persistent blocks, as many as fit on the card,
// take tiles from an atomic ticket, so a tile's predecessors have always
// started.  Up to kWaveSmemCap members the wave and the per-member sums
// sit in shared memory (each block adds its sums to the output once, at
// its end), above it the search and the sums go to device memory.  Within
// a thread, children of one member in a row are summed in registers
// before one atomic; at the end the warp's lanes that hold one member
// combine theirs (__match_any_sync, __reduce_add_sync).
//
// Two forms.  The seg form writes seg [n] (the member of every slot, -1
// none) and the sums.  The compact form writes no seg: it hands the
// children to the caller in slot order, compacted in the same pass by a
// single-pass scan with decoupled look-back (Merrill and Garland): each
// tile publishes its count of children and of directories among them in a
// status word, first alone (kAgg), then with all its predecessors'
// (kIncl); a tile's offset is the sum of its predecessors' words back to
// the nearest inclusive one.  Within a tile each warp takes a run of
// slots, int4 by int4, and offsets come from ballots of each int4's four
// slots and a scan of the warps' totals.
//
// out: counts [w] | dirs [w] | sizes [w] | n_children | n_dirs | ticket,
// then (compact) a status word per tile at status_off; at mid_off the
// children's ids (int64) from mid[0] on, the directories' ids among them
// backwards from mid[-1], so that both are one contiguous span.  The
// launcher zeroes the sums, counts, ticket and status words.

constexpr int kTaThreads = 256;
constexpr int kTaWarps = kTaThreads / 32;
constexpr int kTaVecs = 4;
constexpr int kTileSlots = kTaThreads * kTaVecs * 4;
constexpr int kWaveSmemCap = 8192;
constexpr unsigned long long kAgg = 1ull << 62, kIncl = 2ull << 62;
constexpr unsigned long long kValue = kAgg - 1;   // children << 31 | dirs
static_assert(kTaWarps <= 32, "one warp scans the tile's warp totals");

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Warp 0: the tile's exclusive prefix (children << 31 | dirs) over tiles
// 0..t-1, from their status words, 32 at a time, nearest first.
// Publishes the tile's inclusive word.  A word that never becomes ready (a
// fault) traps after ~5 s, so the launch fails instead of hanging the card.
__device__ __forceinline__ unsigned long long look_back(
    unsigned long long* status, long long t, unsigned long long mine,
    int lane) {
  if (t == 0) {
    if (lane == 0) st_relaxed(status, kIncl | mine);
    return 0;
  }
  if (lane == 0) st_relaxed(status + t, kAgg | mine);
  unsigned long long excl = 0;
  for (long long j = t - 1;; j -= 32) {
    const long long k = j - lane;
    unsigned long long s = kIncl;            // before tile 0: nothing
    if (k >= 0) {
      long long t0 = 0;
      while (((s = ld_relaxed(status + k)) >> 62) == 0) {
        const long long now = clock64();
        if (t0 == 0) t0 = now;
        else if (now - t0 > 10000000000LL) __trap();
      }
    }
    const unsigned incl = __ballot_sync(0xffffffffu, (s >> 62) == 2);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    unsigned long long v = lane <= stop ? (s & kValue) : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (incl) break;
  }
  if (lane == 0) st_relaxed(status + t, kIncl | (excl + mine));
  return excl;
}

// col[q..q+3] into out[] where any of the four slots is a child (m >= 0),
// as one 16-byte load where vec; zeros elsewhere.
__device__ __forceinline__ void load4(const int32_t* __restrict__ col,
                                      long long q, long long n, int vec,
                                      const int* m, int32_t* out) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = 0;
  if (max(max(m[0], m[1]), max(m[2], m[3])) < 0) return;
  if (vec && q + 3 < n) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(col + q));
    out[0] = m[0] >= 0 ? x.x : 0;
    out[1] = m[1] >= 0 ? x.y : 0;
    out[2] = m[2] >= 0 ? x.z : 0;
    out[3] = m[3] >= 0 ? x.w : 0;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (m[k] >= 0) out[k] = __ldg(col + q + k);
  }
}

template <bool kSmemWave, bool kSeg>
__global__ void __launch_bounds__(kTaThreads) treeagg_kernel(
    const int32_t* __restrict__ gwave, int w, const int32_t* __restrict__ par,
    const int32_t* __restrict__ isdir, const int32_t* __restrict__ size,
    const long long* __restrict__ ids, int32_t* __restrict__ seg,
    int32_t* __restrict__ out, unsigned long long* __restrict__ status,
    long long* __restrict__ mid, long long n, int vec) {
  extern __shared__ __align__(16) int32_t tsm[];   // wave, counts, dirs, sizes
  __shared__ int s_hits[32], s_dirs[32];    // per warp, then scanned
  __shared__ long long s_tile;
  __shared__ unsigned long long s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1;
  const int32_t* wave = gwave;
  unsigned* acc = reinterpret_cast<unsigned*>(out);   // counts, dirs, sizes
  if (kSmemWave) {
    for (int i = tid; i < w; i += kTaThreads) {
      tsm[i] = gwave[i];
      tsm[w + i] = tsm[2 * w + i] = tsm[3 * w + i] = 0;
    }
    wave = tsm;
    acc = reinterpret_cast<unsigned*>(tsm + w);
  }
  __syncthreads();
  const int32_t lo_id = w ? wave[0] : 0, hi_id = w ? wave[w - 1] : -1;
  const long long n_tiles = (n + kTileSlots - 1) / kTileSlots;
  unsigned* ticket = reinterpret_cast<unsigned*>(out + 3 * w + 2);
  int cur = -1;                 // the member whose run this thread sums
  unsigned rc = 0, rd = 0, rz = 0;
  for (;;) {
    if (tid == 0) s_tile = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long t = s_tile;
    if (t >= n_tiles) break;
    const long long base = t * kTileSlots;
    // m: each slot's parent, then its member.  Every load of par first,
    // so that all of the tile's reads are in flight at once.
    int m[kTaVecs][4], dv[kTaVecs][4];
#pragma unroll
    for (int v = 0; v < kTaVecs; ++v) {
      const long long q = base + 4LL * ((warp * kTaVecs + v) * 32 + lane);
      if (vec && q + 3 < n) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(par + q));
        m[v][0] = x.x;
        m[v][1] = x.y;
        m[v][2] = x.z;
        m[v][3] = x.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          m[v][k] = q + k < n ? __ldg(par + q + k) : -1;
      }
    }
#pragma unroll
    for (int v = 0; v < kTaVecs; ++v) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int32_t p = m[v][k];
        int s = -1;
        if (p >= lo_id && p <= hi_id && p >= 0) {
          int a = 0, b = w;
          while (a < b) {
            const int c = (a + b) >> 1;
            const int32_t x = kSmemWave ? wave[c] : __ldg(wave + c);
            if (x < p) a = c + 1; else b = c;
          }
          if ((kSmemWave ? wave[a] : __ldg(wave + a)) == p) s = a;
        }
        m[v][k] = s;
      }
    }
#pragma unroll
    for (int v = 0; v < kTaVecs; ++v) {
      const long long q = base + 4LL * ((warp * kTaVecs + v) * 32 + lane);
      // is_dir of the children: one 16-byte load for the four slots where
      // any is a child
      load4(isdir, q, n, vec, m[v], dv[v]);
      if (kSeg) {
        if (vec && q + 3 < n) {
          *reinterpret_cast<int4*>(seg + q) =
              make_int4(m[v][0], m[v][1], m[v][2], m[v][3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (q + k < n) seg[q + k] = m[v][k];
        }
      }
    }
    if (!kSeg) {
      // this lane's first child (directory) of each int4 among the
      // warp's: the warp's run of slots goes int4 by int4, lanes in order
      int hoff[kTaVecs], doff[kTaVecs];
      int th = 0, td = 0;
#pragma unroll
      for (int v = 0; v < kTaVecs; ++v) {
        hoff[v] = th;
        doff[v] = td;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const unsigned bh = __ballot_sync(0xffffffffu, m[v][k] >= 0);
          const unsigned bd =
              __ballot_sync(0xffffffffu, m[v][k] >= 0 && dv[v][k] == 1);
          th += __popc(bh);
          td += __popc(bd);
          hoff[v] += __popc(bh & lt);
          doff[v] += __popc(bd & lt);
        }
      }
      if (lane == 0) {
        s_hits[warp] = th;
        s_dirs[warp] = td;
      }
      __syncthreads();
      if (warp == 0) {
        const int h0 = lane < kTaWarps ? s_hits[lane] : 0;
        const int d0 = lane < kTaWarps ? s_dirs[lane] : 0;
        int h = h0, d = d0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int hx = __shfl_up_sync(0xffffffffu, h, o);
          const int dx = __shfl_up_sync(0xffffffffu, d, o);
          if (lane >= o) {
            h += hx;
            d += dx;
          }
        }
        if (lane < kTaWarps) {
          s_hits[lane] = h - h0;
          s_dirs[lane] = d - d0;
        }
        const unsigned long long mine =
            ((unsigned long long)__shfl_sync(0xffffffffu, h, 31) << 31) |
            (unsigned)__shfl_sync(0xffffffffu, d, 31);
        const unsigned long long excl = look_back(status, t, mine, lane);
        if (lane == 0) {
          s_base = excl;
          if (t == n_tiles - 1) {
            const unsigned long long all = excl + mine;
            out[3 * w] = (int32_t)(all >> 31);
            out[3 * w + 1] = (int32_t)(all & 0x7fffffff);
          }
        }
      }
      __syncthreads();
      const long long bh = (long long)(s_base >> 31);
      const long long bd = (long long)(s_base & 0x7fffffff);
#pragma unroll
      for (int v = 0; v < kTaVecs; ++v) {
        const long long q = base + 4LL * ((warp * kTaVecs + v) * 32 + lane);
        long long ph = bh + s_hits[warp] + hoff[v];
        long long pd = bd + s_dirs[warp] + doff[v];
        if (max(max(m[v][0], m[v][1]), max(m[v][2], m[v][3])) < 0) continue;
        long long id[4];
        if (vec && q + 3 < n) {
          const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(
                              ids + q));
          const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(
                              ids + q + 2));
          id[0] = a.x;
          id[1] = a.y;
          id[2] = b.x;
          id[3] = b.y;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) id[k] = m[v][k] >= 0 ? ids[q + k] : 0;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (m[v][k] < 0) continue;
          mid[ph++] = id[k];
          if (dv[v][k] == 1) mid[-1 - pd++] = id[k];
        }
      }
    }
    int32_t z[kTaVecs][4];
#pragma unroll
    for (int v = 0; v < kTaVecs; ++v)
      load4(size, base + 4LL * ((warp * kTaVecs + v) * 32 + lane), n, vec,
            m[v], z[v]);
#pragma unroll
    for (int v = 0; v < kTaVecs; ++v) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = m[v][k];
        if (s < 0) continue;
        if (s != cur) {
          if (cur >= 0) {
            atomicAdd(acc + cur, rc);
            atomicAdd(acc + w + cur, rd);
            atomicAdd(acc + 2 * w + cur, rz);
          }
          cur = s;
          rc = rd = rz = 0;
        }
        rc += 1;
        rd += (unsigned)dv[v][k];
        rz += (unsigned)z[v][k];
      }
    }
    __syncthreads();            // s_tile, s_hits and s_dirs are reused
  }
  const unsigned group = __match_any_sync(0xffffffffu, cur);
  if (cur >= 0) {
    const unsigned c = __reduce_add_sync(group, rc);
    const unsigned d = __reduce_add_sync(group, rd);
    const unsigned z = __reduce_add_sync(group, rz);
    if (lane == __ffs(group) - 1) {
      atomicAdd(acc + cur, c);
      atomicAdd(acc + w + cur, d);
      atomicAdd(acc + 2 * w + cur, z);
    }
  }
  if (kSmemWave) {
    __syncthreads();
    unsigned* sums = reinterpret_cast<unsigned*>(out);
    for (int i = tid; i < w; i += kTaThreads)
      if (acc[i]) {
        atomicAdd(sums + i, acc[i]);
        atomicAdd(sums + w + i, acc[w + i]);
        atomicAdd(sums + 2 * w + i, acc[2 * w + i]);
      }
  }
}

__global__ void noop_kernel() {}

// One thread follows `steps` dependent loads through `next`, a random cycle
// over a buffer larger than L2: steps round trips to device memory.
__global__ void chase_kernel(const int32_t* next, long long steps,
                             int32_t* out) {
  int32_t j = 0;
  for (long long s = 0; s < steps; ++s) j = next[j];
  *out = j;
}

inline unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// How many blocks of `kern` (`threads` threads, `smem` bytes of dynamic
// shared memory) the card holds at once, at least 1: the grid of a kernel
// whose blocks must all be resident, or that pays a fixed cost a block.
template <typename Kern>
cudaError_t resident_blocks(Kern kern, int threads, int smem,
                            long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  *blocks = std::max(1, sms * per_sm);
  return e;
}

}  // namespace

extern "C" {

// Two measurements beside the kernels' times, not kernels of any path (so
// not named *_launch): an empty kernel, what any launch costs on the card,
// and a pointer chase, what one round trip to device memory costs.
int launch_floor(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

int memory_round_trips(const void* next, long long steps, void* out,
                       void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int32_t*)next,
                                                  steps, (int32_t*)out);
  return (int)cudaGetLastError();
}

int phash_launch(const void* keys, void* out, long long n,
                 unsigned n_partitions, void* stream) {
  if (n <= 0) return 0;
  phash_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (int32_t*)out, n, n_partitions);
  return (int)cudaGetLastError();
}

// comp [n, depth], hint_parts [n] and sigs [n] (the binding passes three
// parts of one packed buffer).  depth must leave room for one row's fold
// operands in kPcSmemCap (the binding's MAX_DEPTH).
int phash_chain_launch(const void* parents, const void* names,
                       const void* hints, const void* depths, void* comp,
                       void* hint_parts, void* sigs, long long n, int depth,
                       unsigned n_partitions, void* stream) {
  if (n <= 0) return 0;
  const int stride = depth | 1;
  const int rows = std::min(kPcRows, kPcSmemCap / (4 * stride));
  if (depth < 0 || rows < 1) return (int)cudaErrorInvalidValue;
  const int vec = depth % 4 == 0 &&
                  ((uintptr_t)parents | (uintptr_t)names |
                   (uintptr_t)comp) % 16 == 0;
  const long long blocks =
      std::min((n + rows - 1) / rows, kMaxBlocks);
  phash_chain_kernel<<<(unsigned)blocks, kPcThreads, 4 * rows * stride,
                       (cudaStream_t)stream>>>(
      (const int32_t*)parents, (const int32_t*)names, (const int32_t*)hints,
      (const int32_t*)depths, (int32_t*)comp, (int32_t*)hint_parts,
      (int32_t*)sigs, n, depth, n_partitions, rows, vec);
  return (int)cudaGetLastError();
}

int pkval_launch(const void* tp, const void* tn, const void* tv,
                 long long cap, const void* parents, const void* names,
                 void* out, long long n, int max_probe, void* stream) {
  if (n <= 0) return 0;
  constexpr long long kProbesABlock = kPkThreads / kPkLanes;
  const long long blocks =
      std::min((n + kProbesABlock - 1) / kProbesABlock, kMaxBlocks);
  pkval_kernel<<<(unsigned)blocks, kPkThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tp, (const int32_t*)tn, (const int32_t*)tv,
      (uint32_t)(cap - 1), (const int32_t*)parents, (const int32_t*)names,
      (int32_t*)out, n, max_probe);
  return (int)cudaGetLastError();
}

// The route of the last hintchain launch: 0 global, 1 smem (-1: none yet,
// or the launch failed).
int hintchain_last_route = -1;

// out: child [n, depth] then src [n, depth].
int hintchain_launch(const void* cp, const void* cn, const void* cv,
                     long long ccap, const void* fp, const void* fn,
                     const void* fv, long long fcap, const void* names,
                     const void* depths, void* out, long long n, int depth,
                     int root_id, int max_probe, void* stream) {
  hintchain_last_route = -1;
  if (n <= 0) return 0;
  const int vec = depth % 4 == 0 && (uintptr_t)names % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  const long long keys = 8 * (hc_span(ccap) + hc_span(fcap));
  const long long all = keys + keys / 2;
  const bool in_smem = keys <= kHcSmemCap, vals = all <= kHcSmemCap;
  auto kern = !in_smem ? hintchain_kernel<false, false>
              : vals   ? hintchain_kernel<true, true>
                       : hintchain_kernel<true, false>;
  const int smem = !in_smem ? 0 : (int)(vals ? all : keys);
  long long blocks = (n + kHcThreads - 1) / kHcThreads;
  if (in_smem) {
    // every block copies the tables: no more blocks than fit at once
    long long fit = 0;
    const cudaError_t e = resident_blocks(kern, kHcThreads, smem, &fit);
    if (e != cudaSuccess) return (int)e;
    blocks = std::min(blocks, fit);
  } else {
    blocks = std::min(blocks, kMaxBlocks);
  }
  kern<<<(unsigned)blocks, kHcThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)cp, (const int32_t*)cn, (const int32_t*)cv, ccap,
      (const int32_t*)fp, (const int32_t*)fn, (const int32_t*)fv, fcap,
      (const int32_t*)names, (const int32_t*)depths, (int32_t*)out, n, depth,
      root_id, max_probe, vec);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (in_smem) hintchain_last_route = 1;
  else hintchain_last_route = 0;
  return 0;
}

// seg != null: the seg form (seg [n]; ids unused), else the compact form.
// out as treeagg_kernel lays it out; status_off and mid_off in ints.  The
// sums, counts, ticket and (compact) status words are zeroed here first.
int treeagg_launch(const void* wave, int w, const void* par, const void* isdir,
                   const void* size, const void* ids, void* seg, void* out,
                   long long status_off, long long mid_off, long long n,
                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n_tiles = (n + kTileSlots - 1) / kTileSlots;
  const long long zero = seg ? status_off : status_off + 2 * n_tiles;
  cudaError_t e = cudaMemsetAsync(out, 0, 4 * zero, st);
  if (e != cudaSuccess || n <= 0) return (int)e;
  const bool in_smem = w <= kWaveSmemCap;
  const int smem = in_smem ? 16 * w : 0;
  const int vec = ((uintptr_t)par | (uintptr_t)isdir | (uintptr_t)size |
                   (uintptr_t)ids | (uintptr_t)seg) % 16 == 0;
  auto kern = in_smem ? (seg ? treeagg_kernel<true, true>
                             : treeagg_kernel<true, false>)
                      : (seg ? treeagg_kernel<false, true>
                             : treeagg_kernel<false, false>);
  // persistent blocks, all resident at once: tiles by ticket
  long long fit = 0;
  e = resident_blocks(kern, kTaThreads, smem, &fit);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = std::min(n_tiles, fit);
  int32_t* o = (int32_t*)out;
  kern<<<(unsigned)blocks, kTaThreads, smem, st>>>(
      (const int32_t*)wave, w, (const int32_t*)par, (const int32_t*)isdir,
      (const int32_t*)size, (const long long*)ids, (int32_t*)seg, o,
      (unsigned long long*)(o + status_off), (long long*)(o + mid_off), n,
      vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
