// K13, K14 and K15: the access-telemetry sketch (count-min sketch and
// top-k hot rows), for Hopper (sm_90a).
//
// Replace the XLA-lowered body of
//   distributed_embeddings_tpu/analysis/telemetry.py:record_ids (:214),
//   with _buckets_of (:175), cms_update (:190) and cms_query (:204),
// which parallel/dist_embedding.py:update_telemetry (:1293) runs once per
// width slab and train step over the n logical slab rows the step routed
// (ids [n] int32, live [n] bool). Everything is integer arithmetic, so
// the kernels equal the plain PyTorch versions (ops/sketch.py) bit for
// bit. The hash, per id and depth row d:
//   h = uint32(id) * (MULTS[d % 8] ^ d);  h ^= h >> 15;  h *= MIX;
//   h ^= h >> 13;  column = h % buckets
//
// K13 (detpu_cms_update): adds live[i] into cms[d, column(live ? id : 0)]
//   for every position and depth row, and counts the live positions
//   (one int64 per block; K15 adds them up). Integer adds commute, so
//   atomics give JAX's result in any order. Zipfian traffic sends every
//   occurrence of a hot id to the same depth words, so a warp first
//   merges its lanes that hit one column (__match_any_sync) and adds
//   their count once; and when the sketch fits in shared memory (the
//   default 4 x 2048 x 4 B = 32 KB does) each block counts into its own
//   copy and adds the copy's nonzero words to the sketch at its end.
//   Otherwise the warps add to the sketch in device memory.
// K14 (detpu_cms_query, detpu_topk_pool): the standalone query
//   est[j] = min over d of cms[d, column(max(ids[j], 0))], and the
//   candidate pool of record_ids: dead positions become the pad id
//   INT32_MAX, the keys sort (radix_sort.cuh, keys only, 4 passes), each
//   first occurrence of a live id is scored by the query (a live id's
//   estimate depends only on the id, so JAX's score = where(first,
//   est_all[order], -1) is (first && id != pad) ? query(id) : -1 with no
//   permutation), and the k_pool = min(candidates, n) best positions are
//   selected by the key ((INT32_MAX - score) << 32) | position, smallest
//   first: lax.top_k's order, ties to the lower index. The selection is a
//   tournament: each block bitonic-sorts a tile of T keys in shared
//   memory and keeps its k_pool smallest; blocks then merge T / k_pool
//   such lists at a time until one is left, which the last round turns
//   into JAX's pool: the id where the score is >= 0, else the pad id.
// K15 (detpu_topk_merge, one block): sorts the pool and drops repeated
//   values (jnp.unique(pool, size=candidates, fill_value=pad)), marks the
//   candidates that repeat a carried id, scores the rest by the query and
//   the carried ids by max(query, carried estimate), takes the top `topk`
//   of [carried | candidates] by the same key (carried slots first among
//   equals), writes topk_ids (-1 where the estimate is negative) and
//   topk_est (clamped at 0), and adds the step's live count, rounded once
//   to float32, to the width's `ids` accumulator.
//
// Bound: bytes. K13 reads ~5 B a position (id and live flag) and
// read-modify-writes the small sketch; K14's sort moves each 4-byte key
// through 4 passes of reads and writes; K15 touches a few KB.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_sort.cuh"

namespace {

constexpr int kPad = 0x7fffffff;  // INT32_MAX: dead positions, padding
__constant__ uint32_t kMults[8] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                   0x27D4EB2Fu, 0x165667B1u, 0xD3A2646Du,
                                   0xFD7046C5u, 0xB55A4F09u};
constexpr uint32_t kMix = 0x2C1B3C6Du;
constexpr int kUpdThreads = 512;
constexpr int kSelThreads = 1024;
constexpr unsigned long long kNoKey = ~0ull;  // sorts after every key

__device__ __forceinline__ uint32_t column(uint32_t id, int d,
                                           uint32_t buckets) {
  uint32_t h = id * (kMults[d & 7] ^ static_cast<uint32_t>(d));
  h ^= h >> 15;
  h *= kMix;
  h ^= h >> 13;
  return h % buckets;
}

// Count-min estimate of one id (JAX queries max(id, 0)).
__device__ __forceinline__ int query(const int* __restrict__ cms, int depth,
                                     int buckets, int id) {
  const uint32_t u = static_cast<uint32_t>(id < 0 ? 0 : id);
  int est = 0x7fffffff;
  for (int d = 0; d < depth; ++d) {
    const int v = __ldg(cms + static_cast<int64_t>(d) * buckets +
                        column(u, d, static_cast<uint32_t>(buckets)));
    est = v < est ? v : est;
  }
  return est;
}

// The selection key of a score (-1 .. INT32_MAX) at an index.
__device__ __forceinline__ unsigned long long sel_key(int score,
                                                      uint32_t index) {
  return (static_cast<unsigned long long>(
              static_cast<uint32_t>(0x7fffffffLL - score)) << 32) | index;
}

__device__ __forceinline__ int key_score(unsigned long long k) {
  return static_cast<int>(0x7fffffffLL - static_cast<long long>(k >> 32));
}

// ------------------------------------------------------------------ K13

template <bool kShared>
__global__ void __launch_bounds__(kUpdThreads)
cms_update_kernel(int* __restrict__ cms, int depth, int buckets,
                  const int* __restrict__ ids,
                  const uint8_t* __restrict__ live, int64_t n,
                  long long* __restrict__ count_part) {
  extern __shared__ int sh[];
  __shared__ long long warp_counts[kUpdThreads / 32];
  const int cells = depth * buckets;
  int* target = cms;
  if constexpr (kShared) {
    for (int c = threadIdx.x; c < cells; c += blockDim.x) sh[c] = 0;
    __syncthreads();
    target = sh;
  }
  const int lane = threadIdx.x & 31;
  long long local = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // the bound is uniform over the block, so every lane of a warp runs
  // each round (the ballot below names the whole warp)
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < n; base += stride) {
    const int64_t i = base + threadIdx.x;
    const bool ok = i < n && live[i] != 0;
    const uint32_t id = ok ? static_cast<uint32_t>(ids[i]) : 0u;
    local += ok ? 1 : 0;
    const unsigned mask = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      for (int d = 0; d < depth; ++d) {
        const uint32_t col = column(id, d, static_cast<uint32_t>(buckets));
        const unsigned peers = __match_any_sync(mask, col);
        if (lane == __ffs(peers) - 1) {
          atomicAdd(target + static_cast<int64_t>(d) * buckets + col,
                    __popc(peers));
        }
      }
    }
  }
  // the block's live count
  for (int o = 16; o > 0; o >>= 1) {
    local += __shfl_down_sync(0xffffffffu, local, o);
  }
  if (lane == 0) warp_counts[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      s += warp_counts[w];
    }
    count_part[blockIdx.x] = s;
  }
  if constexpr (kShared) {
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      const int v = sh[c];
      if (v != 0) atomicAdd(cms + c, v);
    }
  }
}

// ------------------------------------------------------------------ K14

__global__ void __launch_bounds__(256)
cms_query_kernel(const int* __restrict__ cms, int depth, int buckets,
                 const int* __restrict__ ids, int64_t n,
                 int* __restrict__ est) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j < n) est[j] = query(cms, depth, buckets, ids[j]);
}

// Sort keys of the ids: the id (INT32_MAX where dead) with its sign bit
// flipped.
__global__ void __launch_bounds__(256)
pool_keys(const int* __restrict__ ids, const uint8_t* __restrict__ live,
          int64_t n, uint32_t* __restrict__ keys) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j < n) keys[j] = Key<int32_t>::of(live[j] != 0 ? ids[j] : kPad);
}

// Ascending bitonic sort of s[0, m) (m a power of two) by the block.
__device__ void bitonic_sort(unsigned long long* s, int m) {
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = s[i], b = s[p];
          if ((a > b) == ((i & k) == 0)) {
            s[i] = b;
            s[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// One tournament round: block b takes the keys [b*T, (b+1)*T) of its
// input (kScore: made from the sorted id keys, see the header; else read
// from `in`, kNoKey past n_in) and keeps its k smallest, in order. The
// last round (pool != null, one block) writes JAX's pool instead.
template <bool kScore>
__global__ void __launch_bounds__(kSelThreads)
select_kernel(const unsigned long long* __restrict__ in, int64_t n_in,
              const uint32_t* __restrict__ skeys, const int* __restrict__ cms,
              int depth, int buckets, int tile, int k,
              unsigned long long* __restrict__ out, int* __restrict__ pool) {
  extern __shared__ unsigned long long s[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const int64_t i = base + t;
    unsigned long long key = kNoKey;
    if (i < n_in) {
      if constexpr (kScore) {
        const uint32_t kk = skeys[i];
        const int id = Key<int32_t>::id(kk);
        const bool first = i == 0 || kk != skeys[i - 1];
        const int score = first && id != kPad
            ? query(cms, depth, buckets, id) : -1;
        key = sel_key(score, static_cast<uint32_t>(i));
      } else {
        key = in[i];
      }
    }
    s[t] = key;
  }
  __syncthreads();
  bitonic_sort(s, tile);
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const unsigned long long key = s[t];
    if (pool != nullptr) {
      const uint32_t pos = static_cast<uint32_t>(key & 0xffffffffu);
      pool[t] = key_score(key) >= 0 ? Key<int32_t>::id(skeys[pos]) : kPad;
    } else {
      out[static_cast<int64_t>(blockIdx.x) * k + t] = key;
    }
  }
}

// ------------------------------------------------------------------ K15

// Exclusive scan of one int per thread over the block (kSelThreads).
__device__ int block_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int r = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  __syncthreads();
  return r;
}

// Shared memory (dynamic): sort [m_all] u64 | cand [m_cand] int |
// all_ids [topk + cand] int | all_est [topk + cand] int.
__global__ void __launch_bounds__(kSelThreads)
topk_merge_kernel(const int* __restrict__ cms, int depth, int buckets,
                  const int* __restrict__ pool, int k_pool, int cand_n,
                  int m_cand, int m_all, int* __restrict__ topk_ids,
                  int* __restrict__ topk_est, int topk,
                  float* __restrict__ ids_acc,
                  const long long* __restrict__ count_part, int n_part,
                  float* __restrict__ count_out) {
  extern __shared__ unsigned long long s[];
  __shared__ int warp_sums[32];
  __shared__ int uniq;
  int* cand = reinterpret_cast<int*>(s + m_all);
  int* all_ids = cand + m_cand;
  int* all_est = all_ids + topk + cand_n;
  // 1. jnp.unique(pool, size=cand_n, fill_value=pad): sort, then keep
  // each value's first copy
  for (int j = threadIdx.x; j < m_cand; j += blockDim.x) {
    s[j] = j < k_pool
        ? static_cast<unsigned long long>(Key<int32_t>::of(pool[j]))
        : static_cast<unsigned long long>(Key<int32_t>::of(kPad));
  }
  __syncthreads();
  bitonic_sort(s, m_cand);
  for (int j0 = 0; j0 < m_cand; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool keep = j < m_cand && (j == 0 || s[j] != s[j - 1]);
    const int at = block_scan(keep ? 1 : 0, warp_sums);
    const int base = j0 == 0 ? 0 : uniq;
    if (keep) {
      cand[base + at] = Key<int32_t>::id(static_cast<uint32_t>(s[j]));
    }
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) uniq = base + at + (keep ? 1 : 0);
    __syncthreads();
  }
  for (int j = uniq + threadIdx.x; j < cand_n; j += blockDim.x) {
    cand[j] = kPad;
  }
  __syncthreads();
  // 2. estimates: carried slots re-query (the carried estimate a floor),
  // candidates that repeat a carried id or pad score -1
  for (int i = threadIdx.x; i < topk + cand_n; i += blockDim.x) {
    int id, est;
    if (i < topk) {
      id = topk_ids[i];
      est = id >= 0 ? max(query(cms, depth, buckets, id), topk_est[i]) : -1;
    } else {
      id = cand[i - topk];
      bool dup = false;
      for (int q = 0; q < topk; ++q) dup |= topk_ids[q] == id;
      est = id != kPad && !dup ? query(cms, depth, buckets, id) : -1;
    }
    all_ids[i] = id;
    all_est[i] = est;
  }
  __syncthreads();
  // 3. top `topk` of [carried | candidates]
  for (int i = threadIdx.x; i < m_all; i += blockDim.x) {
    s[i] = i < topk + cand_n ? sel_key(all_est[i], static_cast<uint32_t>(i))
                             : kNoKey;
  }
  __syncthreads();
  bitonic_sort(s, m_all);
  for (int i = threadIdx.x; i < topk; i += blockDim.x) {
    const int est = key_score(s[i]);
    const int ix = static_cast<int>(s[i] & 0xffffffffu);
    topk_ids[i] = est >= 0 ? all_ids[ix] : -1;
    topk_est[i] = est > 0 ? est : 0;
  }
  // 4. the live count, rounded once
  if (threadIdx.x == 0) {
    long long c = 0;
    for (int b = 0; b < n_part; ++b) c += count_part[b];
    const float f = __ll2float_rn(c);
    ids_acc[0] = __fadd_rn(ids_acc[0], f);
    count_out[0] = f;
  }
}

int next_pow2(int64_t v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

int64_t align16(int64_t b) { return (b + 15) / 16 * 16; }

// Tournament geometry: the tile (a power of two >= 2 * k_pool, at least
// 4096) and the list count after each round.
int sel_tile(int k_pool) {
  const int t = next_pow2(2 * static_cast<int64_t>(k_pool));
  return t < 4096 ? 4096 : t;
}

struct PoolScratch {
  uint32_t* keys[2];
  int* hist;
  int* partials;
  unsigned long long* lists[2];
};

// Carves the K14 scratch (or, with base null, returns its size).
int64_t carve_pool(void* base, int64_t n, int k_pool, PoolScratch* s) {
  const int tile = sel_tile(k_pool);
  const int64_t lists = (n + tile - 1) / tile * static_cast<int64_t>(k_pool);
  const int64_t sizes[] = {n * 4, n * 4, radix_hist_ints(n) * 4,
                           radix_partial_ints(n) * 4, lists * 8, lists * 8};
  void* ptrs[6];
  int64_t off = 0;
  for (int i = 0; i < 6; ++i) {
    ptrs[i] = base == nullptr ? nullptr : static_cast<char*>(base) + off;
    off += align16(sizes[i]);
  }
  if (s != nullptr) {
    s->keys[0] = static_cast<uint32_t*>(ptrs[0]);
    s->keys[1] = static_cast<uint32_t*>(ptrs[1]);
    s->hist = static_cast<int*>(ptrs[2]);
    s->partials = static_cast<int*>(ptrs[3]);
    s->lists[0] = static_cast<unsigned long long*>(ptrs[4]);
    s->lists[1] = static_cast<unsigned long long*>(ptrs[5]);
  }
  return off;
}

int max_dynamic_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 48 * 1024;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 48 * 1024;
  }
  return v;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, int64_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess) {
    return 132;
  }
  return v;
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks (and int64 count partials) detpu_cms_update launches for n
// positions.
extern "C" int detpu_cms_update_blocks(int64_t n) {
  // each block takes at least 16 positions a thread: fewer blocks, fewer
  // words to merge from the shared copies
  int64_t b = (n + kUpdThreads * 16 - 1) / (kUpdThreads * 16);
  const int64_t cap = 2 * static_cast<int64_t>(sm_count());
  if (b > cap) b = cap;
  if (b < 1) b = 1;
  return static_cast<int>(b);
}

// cms [depth, buckets] int32, updated in place; ids [n] int32, live [n]
// bool (one byte each); count_part [detpu_cms_update_blocks(...)] int64
// receives the live positions per block.
extern "C" int detpu_cms_update(void* cms, int depth, int buckets,
                                const void* ids, const void* live, int64_t n,
                                void* count_part, void* stream) {
  if (depth <= 0 || buckets <= 0 || n < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = detpu_cms_update_blocks(n);
  const int64_t smem = static_cast<int64_t>(depth) * buckets * 4;
  auto* c = static_cast<int*>(cms);
  auto* i = static_cast<const int*>(ids);
  auto* l = static_cast<const uint8_t*>(live);
  auto* p = static_cast<long long*>(count_part);
  if (smem <= max_dynamic_smem() - 1024) {
    const cudaError_t e = allow_smem(cms_update_kernel<true>, smem);
    if (e != cudaSuccess) return e;
    cms_update_kernel<true><<<blocks, kUpdThreads, smem, st>>>(
        c, depth, buckets, i, l, n, p);
  } else {
    cms_update_kernel<false><<<blocks, kUpdThreads, 0, st>>>(
        c, depth, buckets, i, l, n, p);
  }
  return cudaGetLastError();
}

// est[j] = the count-min estimate of ids[j] (int32 each).
extern "C" int detpu_cms_query(const void* cms, int depth, int buckets,
                               const void* ids, int64_t n, void* est,
                               void* stream) {
  if (depth <= 0 || buckets <= 0 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cms_query_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cms), depth, buckets,
      static_cast<const int*>(ids), n, static_cast<int*>(est));
  return cudaGetLastError();
}

// Bytes of scratch detpu_topk_pool needs (0 < k_pool <= n < 2^31).
extern "C" int64_t detpu_topk_pool_scratch_bytes(int64_t n, int k_pool) {
  return carve_pool(nullptr, n, k_pool, nullptr);
}

// The largest k_pool detpu_topk_pool takes (its tile must fit in shared
// memory).
extern "C" int detpu_topk_pool_max(void) {
  int k = 1;
  while (static_cast<int64_t>(sel_tile(2 * k)) * 8 <= max_dynamic_smem()) {
    k *= 2;
  }
  return k;
}

// pool [k_pool] int32 <- JAX's candidate pool of record_ids from the
// (already updated) sketch, ids [n] int32 and live [n] bool.
extern "C" int detpu_topk_pool(const void* cms, int depth, int buckets,
                               const void* ids, const void* live, int64_t n,
                               int k_pool, void* pool, void* scratch,
                               void* stream) {
  if (depth <= 0 || buckets <= 0 || n <= 0 || n > 0x7fffffffLL ||
      k_pool <= 0 || k_pool > n || k_pool > detpu_topk_pool_max()) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PoolScratch s;
  carve_pool(scratch, n, k_pool, &s);
  const int* c = static_cast<const int*>(cms);
  pool_keys<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const int*>(ids), static_cast<const uint8_t*>(live), n,
      s.keys[0]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  int cur = 0;
  e = radix_sort<uint32_t, false>(s.keys, nullptr, n, 32, s.hist,
                                  s.partials, st, &cur);
  if (e != cudaSuccess) return e;
  const uint32_t* sk = s.keys[cur];
  const int tile = sel_tile(k_pool);
  const int64_t smem = static_cast<int64_t>(tile) * 8;
  if ((e = allow_smem(select_kernel<true>, smem)) != cudaSuccess) return e;
  if ((e = allow_smem(select_kernel<false>, smem)) != cudaSuccess) return e;
  int64_t blocks = (n + tile - 1) / tile;
  int* out_pool = static_cast<int*>(pool);
  select_kernel<true><<<static_cast<unsigned>(blocks), kSelThreads, smem,
                        st>>>(nullptr, n, sk, c, depth, buckets, tile, k_pool,
                              s.lists[0], blocks == 1 ? out_pool : nullptr);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  int w = 0;
  while (blocks > 1) {
    const int64_t n_in = blocks * k_pool;
    blocks = (n_in + tile - 1) / tile;
    select_kernel<false><<<static_cast<unsigned>(blocks), kSelThreads, smem,
                           st>>>(s.lists[w], n_in, sk, c, depth, buckets,
                                 tile, k_pool, s.lists[1 - w],
                                 blocks == 1 ? out_pool : nullptr);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    w = 1 - w;
  }
  return cudaSuccess;
}

// The largest candidates + topk detpu_topk_merge takes.
extern "C" int detpu_topk_merge_max(void) {
  int k = 1;
  // sort buffer (8 B), candidates (4 B) and the merged ids and estimates
  // (8 B) per slot, powers of two
  while (static_cast<int64_t>(2 * k) * 20 <= max_dynamic_smem() - 1024) {
    k *= 2;
  }
  return k;
}

// The merge of record_ids (see the header): topk_ids and topk_est [topk]
// int32 and the width's ids accumulator [1] float32 updated in place;
// pool [k_pool] int32 from detpu_topk_pool (k_pool may be 0);
// count_part [n_part] int64 from detpu_cms_update; count_out [1] float32
// <- the live count rounded to float32.
extern "C" int detpu_topk_merge(const void* cms, int depth, int buckets,
                                const void* pool, int k_pool, int cand_n,
                                void* topk_ids, void* topk_est, int topk,
                                void* ids_acc, const void* count_part,
                                int n_part, void* count_out, void* stream) {
  if (depth <= 0 || buckets <= 0 || k_pool < 0 || k_pool > cand_n ||
      topk <= 0 || topk + cand_n > detpu_topk_merge_max()) {
    return cudaErrorInvalidValue;
  }
  const int m_cand = next_pow2(cand_n);
  const int m_all = next_pow2(topk + cand_n);
  const int64_t smem = static_cast<int64_t>(m_all) * 8 + m_cand * 4 +
                       static_cast<int64_t>(topk + cand_n) * 8;
  cudaError_t e = allow_smem(topk_merge_kernel, smem);
  if (e != cudaSuccess) return e;
  topk_merge_kernel<<<1, kSelThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cms), depth, buckets,
      static_cast<const int*>(pool), k_pool, cand_n, m_cand, m_all,
      static_cast<int*>(topk_ids), static_cast<int*>(topk_est), topk,
      static_cast<float*>(ids_acc),
      static_cast<const long long*>(count_part), n_part,
      static_cast<float*>(count_out));
  return cudaGetLastError();
}
