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
//   candidate pool of record_ids. JAX sorts the ids (dead positions as
//   the pad id INT32_MAX), scores each id's first occurrence in sorted
//   order by its estimate (every other position -1) and takes lax.top_k
//   of the scores. A live id's estimate depends only on the id, and the
//   first occurrences in sorted order are the distinct ids ascending, so
//   the pool is the k_pool = min(candidates, n) distinct live ids with
//   the largest estimates, ties to the smaller id, then the pad id. One
//   more entry can reach it: the first pad-valued position in stream
//   order (argsort is stable) scores the pad id's estimate when it is a
//   live INT32_MAX, and -1 when it is dead; that entry's pool value is
//   the pad id, and it sorts after every other id. The kernel computes
//   this without sorting the n positions:
//   1. cudaMemsetAsync(0xFF) clears the set and the counters (the first
//      pad-valued position, a log2 histogram of the estimates, the keys
//      each select round wrote; counts run down from 0xFFFFFFFF).
//   2. pool_insert_kernel, one pass over ids and live: each live id
//      below INT32_MAX goes into a device-wide open-addressing set of
//      flipped ids (uint32(id) ^ 0x80000000; the pad id flips to
//      0xFFFFFFFF, the empty slot), Fibonacci-hashed with linear
//      probing, at most half full. A block takes a contiguous span of
//      positions, a thread four a round with their loads, probes and
//      claims issued together. A 4096-slot filter in shared memory
//      keeps the ids the block has found or claimed, so a repeated id
//      needs no probe (hot ids are most positions); a probe reads a
//      slot before it takes atomicCAS. The thread whose atomicCAS claims
//      a slot owns the id: it queries the sketch once (D queries, not
//      n), counts the estimate in the histogram, and appends the key
//      ((INT32_MAX - est) << 32) | flipped id (smallest first = estimate
//      descending, then id ascending, signed) to the block's span of the
//      list at a shared-memory count: no barrier and no device-wide
//      counter in the loop. Each warp also atomicMins the first
//      pad-valued position.
//   3. pool_select_kernel, rounds of a tournament. Round 0 takes each
//      block's span (and the pad key when the first pad-valued position
//      is live), keeps the keys whose estimate bucket reaches the
//      highest bucket with k_pool keys at or above it (the others have
//      k_pool larger estimates ahead of them), bitonic-sorts them in
//      shared memory and appends each span's k_pool smallest; each later
//      round merges 8 * (T - k_pool) of the appended keys a block into
//      k_pool, until one task is left, which writes the pool: the ids of
//      its keys, the pad id past them. Grids and rounds follow n and
//      k_pool; the keys present (counted on the device) decide the work:
//      no host synchronisation, launches fixed by n and k_pool. The
//      list's order varies from run to run, but its keys are unique, so
//      the pool does not.
// K15 (detpu_topk_merge, one block): sorts the pool and drops repeated
//   values (jnp.unique(pool, size=candidates, fill_value=pad)), marks the
//   candidates that repeat a carried id, scores the rest by the query and
//   the carried ids by max(query, carried estimate), takes the top `topk`
//   of [carried | candidates] by the same key (carried slots first among
//   equals), writes topk_ids (-1 where the estimate is negative) and
//   topk_est (clamped at 0), and adds the step's live count, rounded once
//   to float32, to the width's `ids` accumulator.
//
// Bound: bytes. K13 and K14's pool read ~5 B a position (id and live
// flag); K13 read-modify-writes the small sketch, the pool clears its
// set (4 B a slot, 2-4 slots a position) and writes 8 B a distinct id;
// K15 touches a few KB.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kPad = 0x7fffffff;  // INT32_MAX: dead positions, padding
__constant__ uint32_t kMults[8] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                   0x27D4EB2Fu, 0x165667B1u, 0xD3A2646Du,
                                   0xFD7046C5u, 0xB55A4F09u};
constexpr uint32_t kMix = 0x2C1B3C6Du;
constexpr int kUpdThreads = 512;
constexpr int kInsThreads = 256;
constexpr int kInsPer = 4;        // positions a thread takes each round
constexpr int kFilter = 4096;     // a block's filter of ids it has seen
constexpr int kSelThreads = 1024;
constexpr unsigned long long kNoKey = ~0ull;  // sorts after every key
// an empty slot of the pool's set (the flipped pad id, never inserted);
// also "no position" and the start of every count of the pool (the
// memset that clears the set sets them; they count down)
constexpr uint32_t kEmpty = 0xffffffffu;
// the pool's counters: [1] the first pad-valued position, [kHist + b]
// the listed ids of estimate bucket b (est_bucket), [kOut + r] the keys
// select round r wrote; then the set
constexpr int kHist = 4;
constexpr int kOut = kHist + 32;
constexpr int kMaxRounds = 16;
constexpr int kCounters = kOut + kMaxRounds;
constexpr int kMaxPerThread = 16;  // select keys a thread holds: T <= 16K
constexpr int kMergeChunks = 8;    // chunks of C keys a task of round > 0

// The id with its sign bit flipped: unsigned order is signed order.
__device__ __forceinline__ uint32_t flip(int id) {
  return static_cast<uint32_t>(id) ^ 0x80000000u;
}

__device__ __forceinline__ int unflip(uint32_t w) {
  return static_cast<int>(w ^ 0x80000000u);
}

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

// The set's home slot of a flipped id: Fibonacci hashing, the top `bits`
// bits of the 64-bit product (bits <= 32).
__device__ __forceinline__ uint32_t home_slot(uint32_t w, int bits) {
  return static_cast<uint32_t>(
      (static_cast<uint64_t>(w) * 0x9E3779B97F4A7C15ull) >> (64 - bits));
}

// The slot of a flipped id in a block's filter.
__device__ __forceinline__ int filter_slot(uint32_t w) {
  return static_cast<int>((w * 0x85EBCA77u) >> 20) & (kFilter - 1);
}

// The bucket of an estimate: 0 for 0, else 1 + floor(log2(est)).
__device__ __forceinline__ int est_bucket(int est) {
  return est <= 0 ? 0 : 32 - __clz(est);
}

// Linear probing for w past slot s (which holds another id): true when
// this thread's atomicCAS claims a slot for w, false when w is found.
__device__ bool probe_on(uint32_t* set, uint32_t s, uint32_t mask,
                         uint32_t w) {
  for (;;) {
    s = (s + 1) & mask;
    const uint32_t cur = __ldcg(set + s);
    if (cur == w) return false;
    if (cur == kEmpty) {
      const uint32_t prev = atomicCAS(set + s, kEmpty, w);
      if (prev == kEmpty) return true;
      if (prev == w) return false;
    }
  }
}

// Step 2 of the pool (see the header and kCounters). Block b takes the
// positions [b * seg, (b + 1) * seg) and lists its winners' keys in the
// same span of `list` (shared-memory counts, no barrier in the loop),
// their number in seg_count[b].
__global__ void __launch_bounds__(kInsThreads)
pool_insert_kernel(const int* __restrict__ cms, int depth, int buckets,
                   const int* __restrict__ ids,
                   const uint8_t* __restrict__ live, int64_t n,
                   uint32_t* __restrict__ set, int bits,
                   unsigned long long* __restrict__ list, int64_t seg,
                   uint32_t* __restrict__ seg_count,
                   uint32_t* __restrict__ counters) {
  // ids this block has found in the set or claimed (a cache: a later
  // position with one of them needs no probe)
  __shared__ uint32_t seen[kFilter];
  __shared__ uint32_t listed, hist[32];
  for (int f = threadIdx.x; f < kFilter; f += blockDim.x) seen[f] = kEmpty;
  if (threadIdx.x < 32) hist[threadIdx.x] = 0;
  if (threadIdx.x == 0) listed = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t mask = static_cast<uint32_t>((uint64_t{1} << bits) - 1);
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * seg;
  const int64_t end = begin + seg < n ? begin + seg : n;
  unsigned long long* mine = list + begin;
  uint32_t first_pad = kEmpty;
  // each thread takes kInsPer positions a round, their loads, probes and
  // claims issued together; the bound is uniform over the block
  for (int64_t base = begin; base < end; base += kInsThreads * kInsPer) {
    uint32_t w[kInsPer];
    int fs[kInsPer];
    bool lead[kInsPer];
#pragma unroll
    for (int v = 0; v < kInsPer; ++v) {
      const int64_t i = base + v * kInsThreads + threadIdx.x;
      const bool in = i < end;
      const int id = in ? ids[i] : kPad;
      const bool ok = in && live[i] != 0 && id != kPad;
      if (in && !ok && first_pad == kEmpty) {
        first_pad = static_cast<uint32_t>(i);
      }
      w[v] = flip(id);
      fs[v] = filter_slot(w[v]);
      lead[v] = ok && seen[fs[v]] != w[v];
    }
    uint32_t slot[kInsPer], got[kInsPer];
    bool won[kInsPer];
#pragma unroll
    for (int v = 0; v < kInsPer; ++v) {
      if (lead[v]) {
        slot[v] = home_slot(w[v], bits);
        got[v] = __ldcg(set + slot[v]);
      }
    }
#pragma unroll
    for (int v = 0; v < kInsPer; ++v) {
      won[v] = false;
      if (lead[v] && got[v] == kEmpty) {
        got[v] = atomicCAS(set + slot[v], kEmpty, w[v]);
        won[v] = got[v] == kEmpty;
      }
    }
#pragma unroll
    for (int v = 0; v < kInsPer; ++v) {
      if (lead[v] && !won[v] && got[v] != w[v]) {
        won[v] = probe_on(set, slot[v], mask, w[v]);
      }
      if (lead[v]) seen[fs[v]] = w[v];  // w is in the set now
    }
#pragma unroll
    for (int v = 0; v < kInsPer; ++v) {
      const unsigned wins = __ballot_sync(0xffffffffu, won[v]);
      if (wins == 0) continue;
      int est = 0;
      if (won[v]) {
        est = query(cms, depth, buckets, unflip(w[v]));
        atomicAdd(&hist[est_bucket(est)], 1u);
      }
      const int first = __ffs(wins) - 1;
      uint32_t at = 0;
      if (lane == first) at = atomicAdd(&listed, __popc(wins));
      at = __shfl_sync(0xffffffffu, at, first);
      if (won[v]) {
        mine[at + __popc(wins & ((1u << lane) - 1u))] = sel_key(est, w[v]);
      }
    }
  }
  const uint32_t fp = __reduce_min_sync(0xffffffffu, first_pad);
  if (lane == 0 && fp != kEmpty) atomicMin(counters + 1, fp);
  __syncthreads();
  if (threadIdx.x < 32 && hist[threadIdx.x] != 0) {
    atomicSub(counters + kHist + threadIdx.x, hist[threadIdx.x]);
  }
  if (threadIdx.x == 0) seg_count[blockIdx.x] = listed;
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

// Step 3 of the pool: round `round` of the tournament, over `tasks`
// tasks. In round 0, task b < tasks - 1 is insert block b's segment
// (seg_count[b] keys at in + b * seg) and the last task holds the pad key
// when the first pad-valued position is live; in round r + 1, task t
// holds the keys [t * L, (t + 1) * L) of the m that round r wrote (L =
// kMergeChunks * C, C = T - k >= k; tasks past m have none). A block
// takes tasks blockIdx.x, + gridDim.x, ...: it reads a task's keys C at
// a time, keeps those that can reach the pool, sorts them with the k
// best it holds and keeps the k smallest, then appends them to `out` at
// the round's count (counters[kOut + round], counting down). In round 0
// a key can reach the pool when its estimate bucket is no lower than the
// highest bucket b* with k listed keys in b* and above (below it, k keys
// have larger estimates). The last round (pool != null, one task)
// writes JAX's pool instead: the k best ids, the pad id past them.
__global__ void __launch_bounds__(kSelThreads)
pool_select_kernel(const unsigned long long* __restrict__ in,
                   const uint32_t* __restrict__ seg_count, int64_t seg,
                   int64_t tasks, uint32_t* __restrict__ counters,
                   const int* __restrict__ cms, int depth, int buckets,
                   const uint8_t* __restrict__ live, int round, int tile,
                   int k, unsigned long long* __restrict__ out,
                   int* __restrict__ pool) {
  extern __shared__ unsigned long long s[];
  __shared__ int floor_bucket;
  __shared__ uint32_t kept, out_at;
  const int64_t m = round == 0 ? 0 : kEmpty - counters[kOut + round - 1];
  if (threadIdx.x == 0) {
    int b = 0;
    uint32_t above = 0;
    for (int j = 31; round == 0 && j > 0; --j) {
      above += kEmpty - counters[kHist + j];
      if (above >= static_cast<uint32_t>(k)) {
        b = j;
        break;
      }
    }
    floor_bucket = b;
  }
  const int lane = threadIdx.x & 31;
  const int chunk = tile - k;
  const int64_t task_len = static_cast<int64_t>(kMergeChunks) * chunk;
  for (int64_t t = blockIdx.x; t < tasks; t += gridDim.x) {
    // the task's keys: src[0, len), or the pad key
    const unsigned long long* src = in + t * task_len;
    int64_t len = m - t * task_len;
    len = len < 0 ? 0 : len > task_len ? task_len : len;
    bool pad_task = false;
    if (round == 0) {
      if (t < tasks - 1) {
        src = in + t * seg;
        len = seg_count[t];
      } else {
        const uint32_t fp = counters[1];
        pad_task = true;
        len = fp != kEmpty && live[fp] != 0 ? 1 : 0;
      }
    }
    int best = 0;  // s[0, best): the k best keys so far, in order
    for (int64_t off = 0; off < len; off += chunk) {
      __syncthreads();  // s and kept are free
      if (threadIdx.x == 0) kept = best;
      __syncthreads();
      // this thread's keys of the chunk that can reach the pool, after
      // the best ones in any order (the sort orders them)
      unsigned long long v[kMaxPerThread];
      int mine = 0;
#pragma unroll
      for (int j = 0; j < kMaxPerThread; ++j) {
        const int r = threadIdx.x + j * static_cast<int>(blockDim.x);
        const int64_t x = off + r;
        unsigned long long key = kNoKey;
        if (r < chunk && x < len) {
          key = pad_task ? sel_key(query(cms, depth, buckets, kPad), kEmpty)
                         : src[x];
          if (key != kNoKey && est_bucket(key_score(key)) < floor_bucket) {
            key = kNoKey;
          }
        }
        v[j] = key;
        mine += key != kNoKey ? 1 : 0;
      }
      int upto = mine;  // inclusive scan over the warp
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, upto, o);
        if (lane >= o) upto += y;
      }
      uint32_t at = 0;
      if (lane == 31 && upto > 0) at = atomicAdd(&kept, upto);
      at = __shfl_sync(0xffffffffu, at, 31) + upto - mine;
#pragma unroll
      for (int j = 0; j < kMaxPerThread; ++j) {
        if (v[j] != kNoKey) s[at++] = v[j];
      }
      __syncthreads();
      const int c = static_cast<int>(kept);
      int size = 1;
      while (size < c) size <<= 1;
      for (int x = c + threadIdx.x; x < size; x += blockDim.x) s[x] = kNoKey;
      __syncthreads();
      bitonic_sort(s, size);
      best = c < k ? c : k;
    }
    if (pool != nullptr) {
      for (int x = threadIdx.x; x < k; x += blockDim.x) {
        pool[x] = x < best ? unflip(static_cast<uint32_t>(s[x])) : kPad;
      }
    } else if (best > 0) {
      if (threadIdx.x == 0) {
        out_at = kEmpty - atomicSub(counters + kOut + round, best);
      }
      __syncthreads();
      for (int x = threadIdx.x; x < best; x += blockDim.x) {
        out[out_at + x] = s[x];
      }
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
        ? static_cast<unsigned long long>(flip(pool[j]))
        : static_cast<unsigned long long>(flip(kPad));
  }
  __syncthreads();
  bitonic_sort(s, m_cand);
  for (int j0 = 0; j0 < m_cand; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool keep = j < m_cand && (j == 0 || s[j] != s[j - 1]);
    const int at = block_scan(keep ? 1 : 0, warp_sums);
    const int base = j0 == 0 ? 0 : uniq;
    if (keep) {
      cand[base + at] = unflip(static_cast<uint32_t>(s[j]));
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

// The select's tile: T keys in shared memory, a power of two >= 2 * k_pool
// and at least 4096.
int sel_tile(int k_pool) {
  const int t = next_pow2(2 * static_cast<int64_t>(k_pool));
  return t < 4096 ? 4096 : t;
}

// log2 of the pool's set: the power of two >= 2n slots, so the set is
// at most half full when all n positions are distinct live ids.
int set_bits(int64_t n) {
  int b = 1;
  while ((int64_t{1} << b) < 2 * n) ++b;
  return b;
}

// Bytes the pool's memset clears: its counters and its set.
int64_t clear_bytes(int64_t n) {
  return 4 * (kCounters + (int64_t{1} << set_bits(n)));
}

int insert_blocks_per_sm();
int sm_count();
int max_dynamic_smem();

// The pool's launch geometry, fixed by n and k_pool.
struct PoolGeometry {
  int64_t blocks;       // insert blocks (as many as run at once)
  int64_t seg;          // list slots a block owns: the positions it takes
  int tile;             // select tile: T keys in shared memory
};

PoolGeometry pool_geometry(int64_t n, int k_pool) {
  PoolGeometry g;
  const int64_t step = static_cast<int64_t>(kInsThreads) * kInsPer;
  const int64_t cap =
      static_cast<int64_t>(insert_blocks_per_sm()) * sm_count();
  g.blocks = (n + step - 1) / step;
  if (g.blocks > cap) g.blocks = cap;
  if (g.blocks < 1) g.blocks = 1;
  g.seg = (n + g.blocks * step - 1) / (g.blocks * step) * step;
  g.tile = sel_tile(k_pool);
  return g;
}

struct PoolScratch {
  uint32_t* counters;  // [kCounters], then the set: one memset clears both
  uint32_t* set;
  uint32_t* seg_count;  // [blocks]
  unsigned long long* lists[2];  // the segments, round 0's lists
};

// Carves the K14 pool scratch (or, with base null, returns its size).
int64_t carve_pool(void* base, int64_t n, int k_pool, const PoolGeometry& g,
                   PoolScratch* s) {
  const int64_t task_len = static_cast<int64_t>(kMergeChunks) *
                           (g.tile - k_pool);
  const int64_t lists0 = (g.blocks + 1) * k_pool;
  const int64_t lists1 = (lists0 + task_len - 1) / task_len * k_pool;
  const int64_t segs = g.blocks * g.seg;
  const int64_t sizes[] = {clear_bytes(n), g.blocks * 4,
                           (segs > lists1 ? segs : lists1) * 8, lists0 * 8};
  void* ptrs[4];
  int64_t off = 0;
  for (int i = 0; i < 4; ++i) {
    ptrs[i] = base == nullptr ? nullptr : static_cast<char*>(base) + off;
    off += align16(sizes[i]);
  }
  if (s != nullptr) {
    s->counters = static_cast<uint32_t*>(ptrs[0]);
    s->set = s->counters + kCounters;
    s->seg_count = static_cast<uint32_t*>(ptrs[1]);
    s->lists[0] = static_cast<unsigned long long*>(ptrs[2]);
    s->lists[1] = static_cast<unsigned long long*>(ptrs[3]);
  }
  return off;
}

// A device attribute of the current device, queried once per device and
// process (fallback if the query fails).
constexpr int kMaxDevices = 64;
std::atomic<int> g_smem[kMaxDevices], g_sms[kMaxDevices];

int device_attr(std::atomic<int>* cache, cudaDeviceAttr attr, int fallback) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return fallback;
  }
  int v = cache[dev].load(std::memory_order_relaxed);
  if (v > 0) return v;
  if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess || v <= 0) {
    return fallback;
  }
  cache[dev].store(v, std::memory_order_relaxed);
  return v;
}

int max_dynamic_smem() {
  return device_attr(g_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                     48 * 1024);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, int64_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int sm_count() {
  return device_attr(g_sms, cudaDevAttrMultiProcessorCount, 132);
}

// Insert blocks that run at once on an SM of the current device (queried
// once per device).
std::atomic<int> g_ins[kMaxDevices];

int insert_blocks_per_sm() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 1;
  }
  int nb = g_ins[dev].load(std::memory_order_relaxed);
  if (nb > 0) return nb;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &nb, pool_insert_kernel, kInsThreads, 0) != cudaSuccess ||
      nb < 1) {
    return 1;
  }
  g_ins[dev].store(nb, std::memory_order_relaxed);
  return nb;
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
  return carve_pool(nullptr, n, k_pool, pool_geometry(n, k_pool), nullptr);
}

// Bytes of that scratch detpu_topk_pool clears each call (its memset).
extern "C" int64_t detpu_topk_pool_clear_bytes(int64_t n) {
  return clear_bytes(n);
}

// The largest k_pool detpu_topk_pool takes (its tile must fit in shared
// memory).
extern "C" int detpu_topk_pool_max(void) {
  int k = 1;
  while (static_cast<int64_t>(sel_tile(2 * k)) * 8 <= max_dynamic_smem() &&
         sel_tile(2 * k) <= kSelThreads * kMaxPerThread) {
    k *= 2;
  }
  return k;
}

// pool [k_pool] int32 <- JAX's candidate pool of record_ids from the
// (already updated) sketch, ids [n] int32 and live [n] bool; scratch of
// detpu_topk_pool_scratch_bytes(n, k_pool) bytes (see the header).
extern "C" int detpu_topk_pool(const void* cms, int depth, int buckets,
                               const void* ids, const void* live, int64_t n,
                               int k_pool, void* pool, void* scratch,
                               void* stream) {
  if (depth <= 0 || buckets <= 0 || n <= 0 || n > 0x7fffffffLL ||
      k_pool <= 0 || k_pool > n || k_pool > detpu_topk_pool_max()) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PoolGeometry g = pool_geometry(n, k_pool);
  PoolScratch s;
  carve_pool(scratch, n, k_pool, g, &s);
  const int bits = set_bits(n);
  cudaError_t e = cudaMemsetAsync(s.counters, 0xff, clear_bytes(n), st);
  if (e != cudaSuccess) return e;
  const int* c = static_cast<const int*>(cms);
  const auto* i = static_cast<const int*>(ids);
  const auto* l = static_cast<const uint8_t*>(live);
  pool_insert_kernel<<<static_cast<unsigned>(g.blocks), kInsThreads, 0,
                       st>>>(c, depth, buckets, i, l, n, s.set, bits,
                             s.lists[0], g.seg, s.seg_count, s.counters);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int64_t smem = static_cast<int64_t>(g.tile) * 8;
  if ((e = allow_smem(pool_select_kernel, smem)) != cudaSuccess) return e;
  // rounds until one task is left; a round's grid takes at most two
  // blocks an SM (they loop over its tasks)
  int64_t tasks = g.blocks + 1;
  for (int round = 0, w = 0; round < kMaxRounds; ++round, w = 1 - w) {
    const bool last = tasks == 1;
    const int64_t grid = tasks < 2 * sm_count() ? tasks : 2 * sm_count();
    pool_select_kernel<<<static_cast<unsigned>(grid), kSelThreads, smem,
                         st>>>(s.lists[w], s.seg_count, g.seg, tasks,
                               s.counters, c, depth, buckets, l, round,
                               g.tile, k_pool, s.lists[1 - w],
                               last ? static_cast<int*>(pool) : nullptr);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (last) return cudaSuccess;
    // each later task merges kMergeChunks * C >= 8k keys into k
    const int64_t m = tasks * k_pool;
    const int64_t task_len =
        static_cast<int64_t>(kMergeChunks) * (g.tile - k_pool);
    tasks = (m + task_len - 1) / task_len;
  }
  return cudaErrorInvalidValue;  // more rounds than n < 2^31 needs
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
