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
// integer; uint32 keys and name hashes travel as int32 bit patterns and are
// reinterpreted here.  All five are bound by device-memory traffic (a few
// integer operations per byte), so each is one thread per output row with a
// grid-stride loop; the hash-table probes and the wave search read their
// read-only tables through the non-coherent cache (__ldg).  Nothing is
// padded: the kernels take any n.
//
// Plain C interface (loaded with ctypes): each launcher takes device
// pointers, sizes and the CUDA stream to launch on, and returns the
// cudaError_t of the launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

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

// Linear-probe lookup of (par, nam) in one open-addressing table: at most
// max_probe slots from home; an EMPTY parent ends the chain, a tombstone
// (-2) is stepped over, AMBIG (-3) values are returned as they are.  A probe
// parent < 0 is padding and always misses.
__device__ __forceinline__ int32_t probe_table(
    const int32_t* __restrict__ tp, const int32_t* __restrict__ tn,
    const int32_t* __restrict__ tv, uint32_t mask, int32_t par, uint32_t nam,
    int max_probe) {
  if (par < 0) return kEmpty;
  uint32_t h = ((uint32_t)par * kGolden) ^ (nam * kGolden2);
  h ^= h >> 16;
  const uint32_t home = h & mask;
  for (int step = 0; step < max_probe; ++step) {
    const uint32_t j = (home + (uint32_t)step) & mask;
    const int32_t ep = __ldg(tp + j);
    if (ep >= 0 && ep == par && (uint32_t)__ldg(tn + j) == nam)
      return __ldg(tv + j);
    if (ep == kEmpty) return kEmpty;
  }
  return kEmpty;
}

__global__ void phash_kernel(const int32_t* __restrict__ keys,
                             int32_t* __restrict__ out, long long n,
                             uint32_t n_partitions) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = (int32_t)(mix32((uint32_t)keys[i]) % n_partitions);
}

// One thread per path row: partition of every component's parent id, the
// partition of the row's hint id, and the chain signature folded over the
// first depths[r] components.
__global__ void phash_chain_kernel(
    const int32_t* __restrict__ parents, const int32_t* __restrict__ names,
    const int32_t* __restrict__ hints, const int32_t* __restrict__ depths,
    int32_t* __restrict__ comp, int32_t* __restrict__ hint_parts,
    int32_t* __restrict__ sigs, long long n, int depth,
    uint32_t n_partitions) {
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    const int32_t dep = depths[r];
    const long long base = r * depth;
    uint32_t sig = 0;
    for (int d = 0; d < depth; ++d) {
      const uint32_t h = mix32((uint32_t)parents[base + d]);
      comp[base + d] = (int32_t)(h % n_partitions);
      if (d < dep) {
        uint32_t s = (sig ^ h ^ (uint32_t)names[base + d]) * kGolden2;
        sig = s ^ (s >> 15);
      }
    }
    hint_parts[r] = (int32_t)(mix32((uint32_t)hints[r]) % n_partitions);
    sigs[r] = (int32_t)sig;
  }
}

// One thread per probe against the store's inode hash index.
__global__ void pkval_kernel(const int32_t* __restrict__ tp,
                             const int32_t* __restrict__ tn,
                             const int32_t* __restrict__ tv, uint32_t mask,
                             const int32_t* __restrict__ parents,
                             const int32_t* __restrict__ names,
                             int32_t* __restrict__ out, long long n,
                             int max_probe) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = probe_table(tp, tn, tv, mask, parents[i], (uint32_t)names[i],
                         max_probe);
}

// One thread per op: walk the op's chain from root_id, one depth per step,
// probing the client table and then the fallback table.  A client answer
// other than a miss wins, an AMBIG (-3) answer included; child -3 tells the
// host to resolve that op again exactly.  Past the op's depth or its first
// miss: child -2, src -1.
__global__ void hintchain_kernel(
    const int32_t* __restrict__ cp, const int32_t* __restrict__ cn,
    const int32_t* __restrict__ cv, uint32_t cmask,
    const int32_t* __restrict__ fp, const int32_t* __restrict__ fn,
    const int32_t* __restrict__ fv, uint32_t fmask,
    const int32_t* __restrict__ names, const int32_t* __restrict__ depths,
    int32_t* __restrict__ child, int32_t* __restrict__ src, long long n,
    int depth, int32_t root_id, int max_probe) {
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    const int32_t dep = depths[r];
    const long long base = r * depth;
    int32_t parent = root_id;
    bool alive = dep > 0;
    for (int d = 0; d < depth; ++d) {
      int32_t c = -2, s = -1;
      if (alive && d < dep) {
        const uint32_t nam = (uint32_t)names[base + d];
        const int32_t cval =
            probe_table(cp, cn, cv, cmask, parent, nam, max_probe);
        const int32_t val =
            cval != kEmpty
                ? cval
                : probe_table(fp, fn, fv, fmask, parent, nam, max_probe);
        c = val;
        if (val > 0) {
          s = cval > 0 ? 0 : 1;
          parent = val;
        } else {
          alive = false;
        }
      } else {
        alive = false;
      }
      child[base + d] = c;
      src[base + d] = s;
    }
  }
}

// One thread per inode-table slot.  A lower-bound search of the slot's
// parent in the sorted wave gives the wave member the slot is a child of
// (seg; -1 = none, cleared slots carry parent -1).  The per-member sums of
// 1, is_dir and size are warp-aggregated before the atomics: the lanes of a
// warp that found the same member add their values with __reduce_add_sync
// and one of them adds the warp's share, so a directory with a million
// children costs ~n/32 atomics on its counters rather than n.  Sums wrap
// modulo 2^32 like the TPU kernel's int32 sums, in any order.  The whole
// warp walks the grid-stride loop together (the loop runs over warp bases),
// so every lane takes part in the warp-wide intrinsics.
__global__ void treeagg_kernel(
    const int32_t* __restrict__ wave, int w, const int32_t* __restrict__ par,
    const int32_t* __restrict__ isdir, const int32_t* __restrict__ size,
    int32_t* __restrict__ seg, int32_t* __restrict__ counts,
    int32_t* __restrict__ dirs, int32_t* __restrict__ sizes, long long n) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = blockIdx.x * (long long)blockDim.x + threadIdx.x - lane;
       base < n; base += stride) {
    const long long i = base + lane;
    int32_t s = -1;
    uint32_t d = 0, z = 0;
    if (i < n) {
      const int32_t p = par[i];
      if (p >= 0) {
        int lo = 0, hi = w;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (__ldg(wave + mid) < p) lo = mid + 1; else hi = mid;
        }
        if (lo < w && __ldg(wave + lo) == p) s = lo;
      }
      seg[i] = s;
      if (s >= 0) {
        d = (uint32_t)isdir[i];
        z = (uint32_t)size[i];
      }
    }
    const unsigned group = __match_any_sync(0xffffffffu, s);
    if (s >= 0) {
      const uint32_t dsum = __reduce_add_sync(group, d);
      const uint32_t zsum = __reduce_add_sync(group, z);
      if (lane == __ffs(group) - 1) {
        atomicAdd((unsigned*)counts + s, (unsigned)__popc(group));
        atomicAdd((unsigned*)dirs + s, dsum);
        atomicAdd((unsigned*)sizes + s, zsum);
      }
    }
  }
}

inline unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" {

int phash_launch(const void* keys, void* out, long long n,
                 unsigned n_partitions, void* stream) {
  if (n <= 0) return 0;
  phash_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (int32_t*)out, n, n_partitions);
  return (int)cudaGetLastError();
}

int phash_chain_launch(const void* parents, const void* names,
                       const void* hints, const void* depths, void* comp,
                       void* hint_parts, void* sigs, long long n, int depth,
                       unsigned n_partitions, void* stream) {
  if (n <= 0) return 0;
  phash_chain_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)parents, (const int32_t*)names, (const int32_t*)hints,
      (const int32_t*)depths, (int32_t*)comp, (int32_t*)hint_parts,
      (int32_t*)sigs, n, depth, n_partitions);
  return (int)cudaGetLastError();
}

int pkval_launch(const void* tp, const void* tn, const void* tv,
                 long long cap, const void* parents, const void* names,
                 void* out, long long n, int max_probe, void* stream) {
  if (n <= 0) return 0;
  pkval_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tp, (const int32_t*)tn, (const int32_t*)tv,
      (uint32_t)(cap - 1), (const int32_t*)parents, (const int32_t*)names,
      (int32_t*)out, n, max_probe);
  return (int)cudaGetLastError();
}

int hintchain_launch(const void* cp, const void* cn, const void* cv,
                     long long ccap, const void* fp, const void* fn,
                     const void* fv, long long fcap, const void* names,
                     const void* depths, void* child, void* src, long long n,
                     int depth, int root_id, int max_probe, void* stream) {
  if (n <= 0) return 0;
  hintchain_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cp, (const int32_t*)cn, (const int32_t*)cv,
      (uint32_t)(ccap - 1), (const int32_t*)fp, (const int32_t*)fn,
      (const int32_t*)fv, (uint32_t)(fcap - 1), (const int32_t*)names,
      (const int32_t*)depths, (int32_t*)child, (int32_t*)src, n, depth,
      root_id, max_probe);
  return (int)cudaGetLastError();
}

// counts, dirs and sizes must hold zeros: the kernel adds into them.
int treeagg_launch(const void* wave, int w, const void* par, const void* isdir,
                   const void* size, void* seg, void* counts, void* dirs,
                   void* sizes, long long n, void* stream) {
  if (n <= 0) return 0;
  treeagg_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)wave, w, (const int32_t*)par, (const int32_t*)isdir,
      (const int32_t*)size, (int32_t*)seg, (int32_t*)counts, (int32_t*)dirs,
      (int32_t*)sizes, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
