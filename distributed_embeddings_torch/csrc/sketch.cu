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
// K13 and K15 take the column without a division: a mask when buckets is
// a power of two, else Lemire's fastmod (exact for 32-bit operands).
//
// K13 (detpu_cms_update_*): adds live[i] into cms[d, column(live ? id :
//   0)] for every position and depth row, and counts the live positions.
//   Integer adds commute, so atomics give JAX's result in any order. One
//   launch of persistent CTAs, one a SM, a lane 16 positions a round
//   (four 16-byte loads of ids, one of live flags; element loads where
//   either array is not 16-byte aligned). When the sketch fits in shared
//   memory (the default 4 x 2048 x 4 B = 32 KB does), each CTA counts into
//   its own copy with one shared-memory atomic a live position and depth
//   row, then adds its copy's nonzero words to the sketch: one flush a
//   CTA. Otherwise the warps add to the sketch in device memory. Measured
//   in sketch_variants.py: a warp's merge of its lanes that hit one column
//   (__match_any_sync per depth row) ran 4-5x slower on the one-hot and
//   the ragged streams, and flushing once a thread-block cluster (each CTA
//   summing its share of the columns over the cluster's copies through
//   distributed shared memory) gained nothing: the flush is a small part
//   of either stream's time. The live count: each CTA writes its partial
//   and takes a ticket (a 64-bit counter in the record's scratch, never
//   reset); the CTA holding a call's last ticket folds the partials into
//   the one int64 the call returns. Nothing is reset between calls, so a
//   launch replays in a CUDA graph.
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
//   Above detpu_topk_pool_max() (a tile of 2 * k_pool keys no longer fits
//   in shared memory) step 3 runs in device memory instead:
//   pool_fill_kernel marks each segment's unused slots (and the pad key's
//   slot, live or not) with the key that sorts last, the stable radix
//   sort of radix_sort.cuh sorts the whole list on its 64 bits, and
//   pool_take_kernel writes the ids of the k_pool smallest keys, the pad
//   id past them. The keys are the same, so the pool is the same.
// K15 (detpu_topk_merge_*): sorts the pool and drops repeated values
//   (jnp.unique(pool, size=candidates, fill_value=pad)), marks the
//   candidates that repeat a carried id, scores the rest by the query and
//   the carried ids by max(query, carried estimate), takes the top `topk`
//   of [carried | candidates] by the key (INT32_MAX - score) << 32 | index
//   (carried slots first among equals, then the lower index), writes
//   topk_ids (-1 where the estimate is negative) and topk_est (clamped at
//   0), and adds the step's live count, rounded once to float32, to the
//   width's `ids` accumulator. Up to kBlockKeys = topk + candidates (the
//   default 32 + 128) it is ONE CTA of a thread an entry and four
//   barriers, no sort: a pool entry is kept where no earlier entry holds
//   its value and goes to the place the kept values below it give; each
//   thread scores its entry (the carried ids read broadcast from shared
//   memory for the duplicate test, its depth words loaded at once); a
//   key's rank is the number of keys below it (the keys are unique), and
//   the ranks below topk write the result. (One warp bitonic-sorting the
//   keys in registers with shuffles, with no barrier, measured slower
//   than the parent's 1024-thread CTA: sketch_variants.py's
//   `warp_sort`.) Past kBlockKeys the work is spread over the SMs: tiles
//   of kSortTile keys bitonic-sorted in shared memory, a key's place in
//   the whole order the sum of its binary searches in the other tiles
//   (tile_rank_kernel), for [pool | carried ids] as one list; one CTA's
//   scan compacts the unique candidates and marks those a carried id
//   repeats (its key follows theirs); then the scores and the same two
//   steps over the selection keys, whose rank-below-topk keys write the
//   result: six launches, the same keys, so the same result.
//
// Bound: bytes. K13 and K14's pool read ~5 B a position (id and live
// flag); K13 read-modify-writes the small sketch, the pool clears its
// set (4 B a slot, 2-4 slots a position) and writes 8 B a distinct id;
// K15 reads depth words for each carried id and candidate. K13's
// shared-memory atomics (depth a live position) and its flush (depth x
// buckets words a CTA) and K15's chain of dependent steps are what the
// designs above cut.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launches.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "radix_sort.cuh"

namespace {

constexpr int kPad = 0x7fffffff;  // INT32_MAX: dead positions, padding
__constant__ uint32_t kMults[8] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                   0x27D4EB2Fu, 0x165667B1u, 0xD3A2646Du,
                                   0xFD7046C5u, 0xB55A4F09u};
constexpr uint32_t kMix = 0x2C1B3C6Du;
constexpr int kUpdThreads = 1024;
constexpr int kPerLane = 16;      // K13's positions a lane a round
constexpr int kChunk = 32 * kPerLane;  // a warp's positions a round
constexpr int kBlockKeys = 512;   // K15's one-CTA merge: topk + candidates
// its threads: a thread an entry, whole warps, and the padding past the
// entries that its counting loops read
constexpr int kBlockThreads = kBlockKeys + 32;
constexpr int kSortThreads = 1024;
constexpr int kSortTile = 1024;   // keys a CTA sorts past one CTA (8 KB)
constexpr int kRankBatch = 8;     // tiles a thread searches at once
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

__device__ __forceinline__ uint32_t hash_of(uint32_t id, int d) {
  uint32_t h = id * (kMults[d & 7] ^ static_cast<uint32_t>(d));
  h ^= h >> 15;
  h *= kMix;
  h ^= h >> 13;
  return h;
}

__device__ __forceinline__ uint32_t column(uint32_t id, int d,
                                           uint32_t buckets) {
  return hash_of(id, d) % buckets;
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

// A sketch's columns without a division: h & mask when buckets is a power
// of two, else Lemire's fastmod, h % b == umulhi64(ceil(2^64 / b) * h, b)
// for every 32-bit h and b (b == 1 wraps the multiplier to 0: column 0).
struct Cols {
  unsigned long long mult;  // ceil(2^64 / buckets), mod 2^64
  uint32_t buckets;
  uint32_t mask;            // buckets - 1
  int pow2;
};

Cols cols_of(int buckets) {
  Cols c;
  c.buckets = static_cast<uint32_t>(buckets);
  c.mask = c.buckets - 1u;
  c.pow2 = (c.buckets & c.mask) == 0u;
  c.mult = ~0ull / c.buckets + 1ull;
  return c;
}

__device__ __forceinline__ uint32_t fast_col(uint32_t h, const Cols& c) {
  return c.pow2 ? (h & c.mask)
                : static_cast<uint32_t>(__umul64hi(c.mult * h, c.buckets));
}

// query() through fast_col: the same words, so the same estimate.
__device__ __forceinline__ int query_fast(const int* __restrict__ cms,
                                          int depth, const Cols& c, int id) {
  const uint32_t u = static_cast<uint32_t>(id < 0 ? 0 : id);
  int est = 0x7fffffff;
#pragma unroll 4
  for (int d = 0; d < depth; ++d) {
    const int v = __ldg(cms + static_cast<int64_t>(d) * c.buckets +
                        fast_col(hash_of(u, d), c));
    est = v < est ? v : est;
  }
  return est;
}

// ------------------------------------------------------------------ K13

struct UpdParams {
  Cols cols;
  int depth;
  int64_t n;
  long long* partials;          // [grid], the record's scratch
  unsigned long long* ticket;   // [1], the record's scratch, never reset
};

// Adds a live position into its column of every depth row of `target`.
__device__ __forceinline__ void add_position(int* target, const UpdParams& p,
                                             uint32_t id, bool ok) {
  if (!ok) return;
  for (int d = 0; d < p.depth; ++d) {
    atomicAdd(target + static_cast<int64_t>(d) * p.cols.buckets +
                  fast_col(hash_of(id, d), p.cols), 1);
  }
}

// vec: ids and live both 16-byte aligned (decided per call).
template <bool kShared>
__global__ void __launch_bounds__(kUpdThreads)
cms_update_kernel(const UpdParams p, int* __restrict__ cms,
                  const int* __restrict__ ids,
                  const uint8_t* __restrict__ live, int vec,
                  long long* __restrict__ count) {
  extern __shared__ int sh[];
  __shared__ long long warp_counts[kUpdThreads / 32];
  __shared__ int last;
  const int cells = p.depth * static_cast<int>(p.cols.buckets);
  int* target = cms;
  if constexpr (kShared) {
    for (int c = threadIdx.x; c < cells; c += kUpdThreads) sh[c] = 0;
    __syncthreads();
    target = sh;
  }
  const int lane = threadIdx.x & 31;
  const int64_t n = p.n;
  long long local = 0;
  // warp w of the grid takes the chunks w, w + warps, ... of kChunk
  // positions (the bound is uniform over the warp); lane l the positions
  // [16 l, 16 l + 16) of a chunk
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kUpdThreads / 32);
  for (int64_t chunk = static_cast<int64_t>(blockIdx.x) * (kUpdThreads / 32)
                       + (threadIdx.x >> 5);
       chunk * kChunk < n; chunk += warps) {
    const int64_t first = chunk * kChunk + lane * kPerLane;
    int id[kPerLane];
    uint32_t flags[kPerLane / 4] = {0u, 0u, 0u, 0u};  // a live byte each
    if (vec && first + kPerLane <= n) {
      const int4* iv = reinterpret_cast<const int4*>(ids + first);
#pragma unroll
      for (int q = 0; q < kPerLane / 4; ++q) {
        const int4 v = __ldg(iv + q);
        id[4 * q] = v.x;
        id[4 * q + 1] = v.y;
        id[4 * q + 2] = v.z;
        id[4 * q + 3] = v.w;
      }
      const uint4 f = __ldg(reinterpret_cast<const uint4*>(live + first));
      flags[0] = f.x;
      flags[1] = f.y;
      flags[2] = f.z;
      flags[3] = f.w;
    } else {
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int64_t i = first + q;
        const bool in = i < n;
        id[q] = in ? __ldg(ids + i) : 0;
        flags[q >> 2] |= (in && __ldg(live + i) != 0 ? 1u : 0u)
                         << (8 * (q & 3));
      }
    }
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const bool ok = ((flags[q >> 2] >> (8 * (q & 3))) & 0xffu) != 0u;
      local += ok ? 1 : 0;
      add_position(target, p, static_cast<uint32_t>(id[q]), ok);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    local += __shfl_down_sync(0xffffffffu, local, o);
  }
  if (lane == 0) warp_counts[threadIdx.x >> 5] = local;
  __syncthreads();  // the CTA's copy and its warps' counts are complete
  if constexpr (kShared) {
    for (int c = threadIdx.x; c < cells; c += kUpdThreads) {
      const int s = sh[c];
      if (s != 0) atomicAdd(cms + c, s);
    }
  }
  // the CTA's live count, then its ticket: the call's last CTA folds the
  // partials into the call's count
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int w = 0; w < kUpdThreads / 32; ++w) s += warp_counts[w];
    p.partials[blockIdx.x] = s;
    __threadfence();
    const unsigned long long old = atomicAdd(p.ticket, 1ull);
    last = (old + 1) % static_cast<unsigned long long>(gridDim.x) == 0;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    long long s = 0;
    for (int b = threadIdx.x; b < static_cast<int>(gridDim.x);
         b += kUpdThreads) {
      s += __ldcg(p.partials + b);
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) warp_counts[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      long long t = 0;
      for (int w = 0; w < kUpdThreads / 32; ++w) t += warp_counts[w];
      count[0] = t;
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

// Step 3 of the pool above the select tile: every slot of the list that
// no insert block wrote (segment b's slots past seg_count[b]) and the pad
// key's slot at blocks * seg get a key; kNoKey sorts after every key.
__global__ void __launch_bounds__(256)
pool_fill_kernel(unsigned long long* __restrict__ list,
                 const uint32_t* __restrict__ seg_count, int64_t seg,
                 int64_t blocks, const uint32_t* __restrict__ counters,
                 const int* __restrict__ cms, int depth, int buckets,
                 const uint8_t* __restrict__ live) {
  const int64_t total = blocks * seg;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j <= total; j += stride) {
    if (j == total) {
      const uint32_t fp = counters[1];
      list[j] = fp != kEmpty && live[fp] != 0
          ? sel_key(query(cms, depth, buckets, kPad), kEmpty) : kNoKey;
    } else if (j - j / seg * seg >= seg_count[j / seg]) {
      list[j] = kNoKey;
    }
  }
}

// The pool from the sorted list: the ids of its k smallest keys, the pad
// id past the keys that are there.
__global__ void __launch_bounds__(256)
pool_take_kernel(const unsigned long long* __restrict__ sorted, int k,
                 int* __restrict__ pool) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x < k) {
    const unsigned long long key = sorted[x];
    pool[x] = key != kNoKey ? unflip(static_cast<uint32_t>(key)) : kPad;
  }
}

// ------------------------------------------------------------------ K15

struct MergeParams {
  Cols cols;
  int depth;
  int k_pool;    // pool entries (<= cand_n)
  int cand_n;    // candidates
  int topk;      // carried slots
  int n_count;   // int64 live-count words to sum
  int block;     // 1: one CTA (topk + cand_n <= kBlockKeys)
  // past it: the record's scratch
  unsigned long long* tiles_pool;   // [k_pool + topk] sorted tiles
  unsigned long long* sorted_pool;  // [k_pool + topk] sorted
  int* cand;                        // [cand_n]
  uint8_t* dup;                     // [cand_n] repeats a carried id
  int* all_ids;                     // [topk + cand_n]
  unsigned long long* keys;         // [topk + cand_n] selection keys
  unsigned long long* tiles_sel;    // [topk + cand_n] sorted tiles
};

// The merge's result from the selection key of rank `i` (< topk).
struct SelectOut {
  int* topk_ids;
  int* topk_est;
  const int* all_ids;
  int topk;
};

__device__ __forceinline__ void write_top(const SelectOut& o, int i,
                                          unsigned long long key) {
  const int est = key_score(key);
  o.topk_ids[i] = est >= 0 ? o.all_ids[static_cast<uint32_t>(key)] : -1;
  o.topk_est[i] = est > 0 ? est : 0;
}

// The values one warp folds the live count into, loaded early.
struct CountIn {
  long long c;   // this lane's sum of the int64 count words
  float acc;     // the width's accumulator (lane 0)
  float total;   // total (lane 0; read when not first)
};

__device__ __forceinline__ CountIn load_count(const long long* count,
                                              int n_count,
                                              const float* ids_acc,
                                              const float* total,
                                              int first) {
  const int lane = threadIdx.x & 31;
  CountIn in{0, 0.0f, 0.0f};
  for (int i = lane; i < n_count; i += 32) in.c += count[i];
  if (lane == 0) {
    in.acc = ids_acc[0];
    if (total != nullptr && !first) in.total = total[0];
  }
  return in;
}

// The live count (the warp's sum of `in.c`), rounded once to float32:
// added to the width's accumulator and to `total` (set there when
// `first`); lane 0 writes.
__device__ __forceinline__ void fold_count(CountIn in, float* ids_acc,
                                           float* total, int first) {
  long long c = in.c;
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) {
    const float f = __ll2float_rn(c);
    ids_acc[0] = __fadd_rn(in.acc, f);
    if (total != nullptr) total[0] = first ? f : __fadd_rn(in.total, f);
  }
}

// The merge by one CTA of topk + cand_n <= kBlockKeys threads, a thread
// an entry, four barriers: the unique pool by counting (an entry is kept
// where no earlier entry holds its value; a kept value's place is the
// number of kept values below it), the scores (the duplicate test reads
// the carried ids broadcast from shared memory; each thread's query loads
// its depth words at once), and the selection by rank (a key's place is
// the number of keys below it: the keys are unique). The counting loops
// read 16 bytes of shared memory a step, the arrays padded past their
// ends with values that count nowhere.
__global__ void __launch_bounds__(kBlockThreads)
topk_merge_block_kernel(const MergeParams p, const int* __restrict__ cms,
                        const int* __restrict__ pool, int* topk_ids,
                        int* topk_est, float* ids_acc,
                        const long long* __restrict__ count, float* total,
                        int first) {
  __shared__ __align__(16) int s_pool[kBlockThreads];  // past P: kPad
  __shared__ __align__(16) int s_kept[kBlockThreads];  // kept, or kPad
  __shared__ int s_ids[kBlockKeys];                    // [carried | cand]
  __shared__ __align__(16) unsigned long long s_keys[kBlockThreads];
  const int t = threadIdx.x;
  const int topk = p.topk, P = p.k_pool, M = topk + p.cand_n;
  const int P4 = (P + 3) & ~3, M2 = (M + 1) & ~1;
  const int v = t < P ? pool[t] : kPad;
  const int cest = t < topk ? topk_est[t] : 0;
  CountIn in{0, 0.0f, 0.0f};  // warp 0 loads the count's inputs first
  if (t < 32) in = load_count(count, p.n_count, ids_acc, total, first);
  s_pool[t] = v;
  if (t < topk) s_ids[t] = topk_ids[t];
  __syncthreads();
  // 1. jnp.unique(pool, size=cand_n, fill_value=pad)
  int same = 0;  // earlier entries that hold v
#pragma unroll 8
  for (int i = 0; i < P4; i += 4) {
    const int4 w = *reinterpret_cast<const int4*>(s_pool + i);
    same += (i < t && w.x == v) + (i + 1 < t && w.y == v) +
            (i + 2 < t && w.z == v) + (i + 3 < t && w.w == v);
  }
  const bool keep = t < P && same == 0;
  s_kept[t] = keep ? v : kPad;  // kPad counts below no value
  const int uniq = __syncthreads_count(keep);
  if (keep) {
    int at = 0;
#pragma unroll 8
    for (int i = 0; i < P4; i += 4) {
      const int4 w = *reinterpret_cast<const int4*>(s_kept + i);
      at += (w.x < v) + (w.y < v) + (w.z < v) + (w.w < v);
    }
    s_ids[topk + at] = v;
  }
  for (int c = uniq + t; c < p.cand_n; c += blockDim.x) {
    s_ids[topk + c] = kPad;
  }
  __syncthreads();
  // 2. scores: carried slots re-query (the carried estimate a floor);
  // candidates that repeat a carried id, and pads, score -1
  int id = 0;
  unsigned long long key = kNoKey;
  if (t < M) {
    id = s_ids[t];
    bool need = t < topk ? id >= 0 : id != kPad;
    if (t >= topk) {
      int hits = 0;
#pragma unroll 4
      for (int q = 0; q < topk; ++q) hits += s_ids[q] == id;
      need = need && hits == 0;
    }
    int est = -1;
    if (need) {
      est = query_fast(cms, p.depth, p.cols, id);
      if (t < topk) est = max(est, cest);
    }
    key = sel_key(est, static_cast<uint32_t>(t));
  }
  s_keys[t] = key;  // kNoKey past M counts below no key
  __syncthreads();
  // 3. the top `topk` of [carried | candidates]
  if (t < M) {
    int rank = 0;
#pragma unroll 8
    for (int i = 0; i < M2; i += 2) {
      const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(s_keys + i);
      rank += (w.x < key) + (w.y < key);
    }
    if (rank < topk) {
      const int est = key_score(key);
      topk_ids[rank] = est >= 0 ? id : -1;
      topk_est[rank] = est > 0 ? est : 0;
    }
  }
  // 4. the live count, rounded once
  if (t < 32) fold_count(in, ids_acc, total, first);
}

// Past one CTA. Sorts tiles of kSortTile keys in shared memory: keys[],
// or where `keys` is null ((flipped value << 32) | position) of [pool |
// carried ids] (k_pool of them from `pool`, the rest from `carried`);
// past m, kNoKey. Writes the sorted tiles, or (o.topk_ids
// not null: one tile) the merge's result from its first topk keys.
__global__ void __launch_bounds__(kSortThreads)
tile_sort_kernel(const unsigned long long* __restrict__ keys,
                 const int* __restrict__ pool, int k_pool,
                 const int* __restrict__ carried, int64_t m,
                 unsigned long long* __restrict__ tiles, SelectOut o) {
  __shared__ unsigned long long s[kSortTile];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kSortTile;
  for (int i = threadIdx.x; i < kSortTile; i += kSortThreads) {
    const int64_t j = base + i;
    unsigned long long v = kNoKey;
    if (j < m && keys == nullptr) {
      const int id = j < k_pool ? pool[j] : carried[j - k_pool];
      v = (static_cast<unsigned long long>(flip(id)) << 32) |
          static_cast<uint32_t>(j);
    } else if (j < m) {
      v = keys[j];
    }
    s[i] = v;
  }
  __syncthreads();
  bitonic_sort(s, kSortTile);
  if (o.topk_ids != nullptr) {
    for (int i = threadIdx.x; i < o.topk; i += kSortThreads) {
      write_top(o, i, s[i]);
    }
    return;
  }
  for (int i = threadIdx.x; i < kSortTile && base + i < m;
       i += kSortThreads) {
    tiles[base + i] = s[i];
  }
}

// A key's place in the sorted whole of `tiles` (m unique keys in sorted
// tiles of kSortTile): its place in its tile plus, for every other tile,
// how many of its keys are smaller (binary searches, kRankBatch tiles at
// once). Writes sorted[rank] = key, or (sorted null) the merge's result
// for rank < topk.
__global__ void __launch_bounds__(256)
tile_rank_kernel(const unsigned long long* __restrict__ tiles, int64_t m,
                 int ntiles, unsigned long long* __restrict__ sorted,
                 SelectOut o) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= m) return;
  const unsigned long long key = tiles[j];
  const int own = static_cast<int>(j / kSortTile);
  int64_t rank = j - static_cast<int64_t>(own) * kSortTile;
  for (int u0 = 0; u0 < ntiles; u0 += kRankBatch) {
    const unsigned long long* t[kRankBatch];
    int len[kRankBatch], pos[kRankBatch];
#pragma unroll
    for (int q = 0; q < kRankBatch; ++q) {
      const int u = u0 + q;
      const int64_t b = static_cast<int64_t>(u) * kSortTile;
      t[q] = tiles + b;
      len[q] = u < ntiles && u != own
          ? static_cast<int>(m - b < kSortTile ? m - b : kSortTile) : 0;
      pos[q] = 0;
    }
    for (int step = kSortTile; step > 0; step >>= 1) {
#pragma unroll
      for (int q = 0; q < kRankBatch; ++q) {
        if (pos[q] + step <= len[q] && __ldg(t[q] + pos[q] + step - 1) < key) {
          pos[q] += step;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRankBatch; ++q) rank += pos[q];
  }
  if (sorted != nullptr) {
    sorted[rank] = key;
  } else if (rank < o.topk) {
    write_top(o, static_cast<int>(rank), key);
  }
}

// One CTA over the sorted keys of [pool | carried ids] (m of them; equal
// values in list order, so the pool's before the carried ids'): a pool
// key whose value differs from the key before it starts a candidate
// (ascending; a scan places them; the pad id past them to cand_n), and a
// carried key right after a pool key of its value marks that candidate a
// repeat of a carried id. Also the live count.
__global__ void __launch_bounds__(kSortThreads)
merge_unique_kernel(const MergeParams p,
                    const unsigned long long* __restrict__ sorted, int m,
                    const long long* __restrict__ count, float* ids_acc,
                    float* total, int first) {
  __shared__ int warp_sums[kSortThreads / 32];
  const int P = p.k_pool;
  const int per = (m + kSortThreads - 1) / kSortThreads;
  const int lo = min(m, static_cast<int>(threadIdx.x) * per);
  const int hi = min(m, lo + per);
  for (int c = threadIdx.x; c < p.cand_n; c += kSortThreads) p.dup[c] = 0;
  // the key before j: its value and whether it is the pool's
  unsigned long long prev = lo > 0 ? sorted[lo - 1] : kNoKey;
  int mine = 0;
  for (int j = lo; j < hi; ++j) {
    const unsigned long long k = sorted[j];
    mine += static_cast<uint32_t>(k) < static_cast<uint32_t>(P) &&
            (j == 0 || (k >> 32) != (prev >> 32)) ? 1 : 0;
    prev = k;
  }
  int uniq;
  int at = block_exclusive_scan(mine, warp_sums, &uniq);  // a barrier
  prev = lo > 0 ? sorted[lo - 1] : kNoKey;
  for (int j = lo; j < hi; ++j) {
    const unsigned long long k = sorted[j];
    const bool same = j > 0 && (k >> 32) == (prev >> 32);
    if (static_cast<uint32_t>(k) < static_cast<uint32_t>(P)) {
      if (!same) p.cand[at++] = unflip(static_cast<uint32_t>(k >> 32));
    } else if (same && static_cast<uint32_t>(prev) <
                           static_cast<uint32_t>(P)) {
      p.dup[at - 1] = 1;
    }
    prev = k;
  }
  for (int c = uniq + threadIdx.x; c < p.cand_n; c += kSortThreads) {
    p.cand[c] = kPad;
  }
  if (threadIdx.x < 32) {
    fold_count(load_count(count, p.n_count, ids_acc, total, first),
               ids_acc, total, first);
  }
}

// The scores and selection keys of [carried | candidates].
__global__ void __launch_bounds__(256)
merge_score_kernel(const MergeParams p, const int* __restrict__ cms,
                   const int* __restrict__ topk_ids,
                   const int* __restrict__ topk_est) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.topk + p.cand_n) return;
  int id, est = -1;
  if (e < p.topk) {
    id = topk_ids[e];
    if (id >= 0) est = max(query_fast(cms, p.depth, p.cols, id), topk_est[e]);
  } else {
    const int c = e - p.topk;
    id = p.cand[c];
    if (id != kPad && p.dup[c] == 0) {
      est = query_fast(cms, p.depth, p.cols, id);
    }
  }
  p.all_ids[e] = id;
  p.keys[e] = sel_key(est, static_cast<uint32_t>(e));
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

// Carves the scratch of the pool above the select tile (or, with base
// null, returns its size): the counters and the set, the segment counts,
// the list (every segment, then the pad key's slot) and the radix sort's
// second buffer, histograms and scan partials.
struct BigPoolScratch {
  uint32_t* counters;
  uint32_t* set;
  uint32_t* seg_count;
  unsigned long long* keys[2];
  int* hist;
  int* partials;
};

int64_t carve_big_pool(void* base, int64_t n, const PoolGeometry& g,
                       BigPoolScratch* s) {
  const int64_t len = g.blocks * g.seg + 1;
  const int64_t sizes[] = {clear_bytes(n), g.blocks * 4, len * 8, len * 8,
                           radix_hist_ints(len) * 4,
                           radix_partial_ints(len) * 4};
  void* ptrs[6];
  int64_t off = 0;
  for (int i = 0; i < 6; ++i) {
    ptrs[i] = base == nullptr ? nullptr : static_cast<char*>(base) + off;
    off += align16(sizes[i]);
  }
  if (s != nullptr) {
    s->counters = static_cast<uint32_t*>(ptrs[0]);
    s->set = s->counters + kCounters;
    s->seg_count = static_cast<uint32_t*>(ptrs[1]);
    s->keys[0] = static_cast<unsigned long long*>(ptrs[2]);
    s->keys[1] = static_cast<unsigned long long*>(ptrs[3]);
    s->hist = static_cast<int*>(ptrs[4]);
    s->partials = static_cast<int*>(ptrs[5]);
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

struct UpdPrepared {
  UpdParams p;
  int grid;
  int shared;     // the sketch fits in a CTA's shared memory
  int64_t smem;
};

cudaError_t update_launch(const UpdPrepared& u, void* cms, const void* ids,
                          const void* live, void* count, cudaStream_t st) {
  const int vec = ((reinterpret_cast<uintptr_t>(ids) |
                    reinterpret_cast<uintptr_t>(live)) & 15u) == 0u;
  auto* c = static_cast<int*>(cms);
  auto* i = static_cast<const int*>(ids);
  auto* l = static_cast<const uint8_t*>(live);
  auto* out = static_cast<long long*>(count);
  if (u.shared) {
    cms_update_kernel<true><<<u.grid, kUpdThreads, u.smem, st>>>(
        u.p, c, i, l, vec, out);
  } else {
    cms_update_kernel<false><<<u.grid, kUpdThreads, 0, st>>>(u.p, c, i, l,
                                                              vec, out);
  }
  return cudaGetLastError();
}

int update_prepare(int depth, int buckets, int64_t n, int sms, void* scratch,
                   UpdPrepared* u) {
  if (depth <= 0 || buckets <= 0 || n < 0 || sms <= 0 ||
      static_cast<int64_t>(depth) * buckets > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  memset(u, 0, sizeof(*u));
  u->p.cols = cols_of(buckets);
  u->p.depth = depth;
  u->p.n = n;
  u->p.ticket = static_cast<unsigned long long*>(scratch);
  u->p.partials = reinterpret_cast<long long*>(u->p.ticket + 1);
  u->smem = static_cast<int64_t>(depth) * buckets * 4;
  u->shared = u->smem <= max_dynamic_smem() - 1024;
  if (u->shared) {
    const cudaError_t e = allow_smem(cms_update_kernel<true>, u->smem);
    if (e != cudaSuccess) return e;
  }
  u->grid = sms;  // the scratch holds a partial for each CTA
  return cudaSuccess;
}

// Bytes of K15's device scratch (0 on the one-CTA path) and its carving.
int64_t carve_merge(void* base, int topk, int cand_n, MergeParams* p) {
  const int64_t m = static_cast<int64_t>(topk) + cand_n;
  if (m <= kBlockKeys) return 0;
  // [pool | carried] sorted (tiles, whole), candidates, repeat marks,
  // [carried | candidates] ids, selection keys, their sorted tiles
  const int64_t sizes[] = {m * 8, m * 8, cand_n * 4LL, cand_n * 1LL, m * 4,
                           m * 8, m * 8};
  void* ptrs[7];
  int64_t off = 0;
  for (int i = 0; i < 7; ++i) {
    ptrs[i] = base == nullptr ? nullptr : static_cast<char*>(base) + off;
    off += align16(sizes[i]);
  }
  if (p != nullptr) {
    p->tiles_pool = static_cast<unsigned long long*>(ptrs[0]);
    p->sorted_pool = static_cast<unsigned long long*>(ptrs[1]);
    p->cand = static_cast<int*>(ptrs[2]);
    p->dup = static_cast<uint8_t*>(ptrs[3]);
    p->all_ids = static_cast<int*>(ptrs[4]);
    p->keys = static_cast<unsigned long long*>(ptrs[5]);
    p->tiles_sel = static_cast<unsigned long long*>(ptrs[6]);
  }
  return off;
}

int merge_prepare(int depth, int buckets, int k_pool, int cand_n, int topk,
                  int n_count, void* scratch, MergeParams* p) {
  if (depth <= 0 || buckets <= 0 || k_pool < 0 || k_pool > cand_n ||
      topk <= 0 || n_count < 0 ||
      static_cast<int64_t>(topk) + cand_n > 0x40000000LL) {
    return cudaErrorInvalidValue;
  }
  memset(p, 0, sizeof(*p));
  p->cols = cols_of(buckets);
  p->depth = depth;
  p->k_pool = k_pool;
  p->cand_n = cand_n;
  p->topk = topk;
  p->n_count = n_count;
  p->block = topk + cand_n <= kBlockKeys;
  if (!p->block && scratch == nullptr) return cudaErrorInvalidValue;
  carve_merge(scratch, topk, cand_n, p);
  return cudaSuccess;
}

#define DETPU_LAUNCHED()                                   \
  do {                                                     \
    const cudaError_t e_ = cudaGetLastError();             \
    if (e_ != cudaSuccess) return e_;                      \
  } while (0)

cudaError_t merge_launch(const MergeParams& p, const void* cms,
                         const void* pool, void* topk_ids, void* topk_est,
                         void* ids_acc, const void* count, void* total,
                         int first, cudaStream_t st) {
  const auto* c = static_cast<const int*>(cms);
  const auto* pl = static_cast<const int*>(pool);
  auto* ti = static_cast<int*>(topk_ids);
  auto* te = static_cast<int*>(topk_est);
  auto* acc = static_cast<float*>(ids_acc);
  const auto* cnt = static_cast<const long long*>(count);
  auto* tot = static_cast<float*>(total);
  if (p.block) {
    const int threads = (p.topk + p.cand_n + 4 + 31) / 32 * 32;
    topk_merge_block_kernel<<<1, threads, 0, st>>>(p, c, pl, ti, te, acc, cnt,
                                                   tot, first);
    return cudaGetLastError();
  }
  const SelectOut none{nullptr, nullptr, nullptr, 0};
  // the pool and the carried ids sorted as one list
  const int m1 = p.k_pool + p.topk;
  const unsigned long long* sorted = p.tiles_pool;
  const int tiles1 = (m1 + kSortTile - 1) / kSortTile;
  tile_sort_kernel<<<tiles1, kSortThreads, 0, st>>>(
      nullptr, pl, p.k_pool, ti, m1, p.tiles_pool, none);
  DETPU_LAUNCHED();
  if (tiles1 > 1) {
    tile_rank_kernel<<<(m1 + 255) / 256, 256, 0, st>>>(
        p.tiles_pool, m1, tiles1, p.sorted_pool, none);
    DETPU_LAUNCHED();
    sorted = p.sorted_pool;
  }
  merge_unique_kernel<<<1, kSortThreads, 0, st>>>(p, sorted, m1, cnt, acc,
                                                  tot, first);
  DETPU_LAUNCHED();
  const int m = p.topk + p.cand_n;
  merge_score_kernel<<<(m + 255) / 256, 256, 0, st>>>(p, c, ti, te);
  DETPU_LAUNCHED();
  const SelectOut out{ti, te, p.all_ids, p.topk};
  const int tiles = (m + kSortTile - 1) / kSortTile;
  if (tiles == 1) {
    tile_sort_kernel<<<1, kSortThreads, 0, st>>>(p.keys, nullptr, 0,
                                                 nullptr, m, nullptr, out);
    return cudaGetLastError();
  }
  tile_sort_kernel<<<tiles, kSortThreads, 0, st>>>(p.keys, nullptr, 0,
                                                    nullptr, m, p.tiles_sel,
                                                    none);
  DETPU_LAUNCHED();
  tile_rank_kernel<<<(m + 255) / 256, 256, 0, st>>>(p.tiles_sel, m, tiles,
                                                    nullptr, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ---------------------------------------------------------------- K13 API

// Bytes of a prepared K13 launch (host memory the record owns).
extern "C" int64_t detpu_cms_update_prepared_bytes(void) {
  return sizeof(UpdPrepared);
}

// Bytes of K13's card scratch for a grid over `sms` SMs: the ticket and
// a partial count for each CTA, at most one a SM (zeroed once by the
// caller).
extern "C" int64_t detpu_cms_update_scratch_bytes(int sms) {
  return 8 * (1 + static_cast<int64_t>(sms));
}

// The launch of K13 for a sketch [depth, buckets] and n positions over
// `sms` SMs, on `scratch` (detpu_cms_update_scratch_bytes(sms) bytes,
// zeroed once), into `prepared`.
extern "C" int detpu_cms_update_prepare(int depth, int buckets, int64_t n,
                                        int sms, void* scratch,
                                        void* prepared) {
  UpdPrepared u;
  const int e = update_prepare(depth, buckets, n, sms, scratch, &u);
  if (e == cudaSuccess) memcpy(prepared, &u, sizeof(u));
  return e;
}

// The CTAs of a prepared K13 launch.
extern "C" int detpu_cms_update_grid(const void* prepared) {
  return static_cast<const UpdPrepared*>(prepared)->grid;
}

// cms [depth, buckets] int32, updated in place; ids [n] int32, live [n]
// bool (one byte each); count [1] int64 <- the live positions.
extern "C" int detpu_cms_update_launch(const void* prepared, void* cms,
                                       const void* ids, const void* live,
                                       void* count, void* stream) {
  return update_launch(*static_cast<const UpdPrepared*>(prepared), cms, ids,
                       live, count, static_cast<cudaStream_t>(stream));
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

// ---------------------------------------------------------------- K14 API

extern "C" int detpu_topk_pool_max(void);

// Bytes of scratch detpu_topk_pool needs (0 < k_pool <= n < 2^31).
extern "C" int64_t detpu_topk_pool_scratch_bytes(int64_t n, int k_pool) {
  const PoolGeometry g = pool_geometry(n, k_pool);
  if (k_pool > detpu_topk_pool_max()) {
    return carve_big_pool(nullptr, n, g, nullptr);
  }
  return carve_pool(nullptr, n, k_pool, g, nullptr);
}

// Bytes of that scratch detpu_topk_pool clears each call (its memset).
extern "C" int64_t detpu_topk_pool_clear_bytes(int64_t n) {
  return clear_bytes(n);
}

// The largest k_pool whose select tile fits in shared memory; above it
// detpu_topk_pool sorts the list in device memory.
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
      k_pool <= 0 || k_pool > n) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PoolGeometry g = pool_geometry(n, k_pool);
  const bool big = k_pool > detpu_topk_pool_max();
  PoolScratch s;
  BigPoolScratch bs;
  if (big) {
    if (g.blocks * g.seg + 1 > 0x7fffffffLL) return cudaErrorInvalidValue;
    carve_big_pool(scratch, n, g, &bs);
    s.counters = bs.counters;
    s.set = bs.set;
    s.seg_count = bs.seg_count;
    s.lists[0] = bs.keys[0];
    s.lists[1] = bs.keys[1];
  } else {
    carve_pool(scratch, n, k_pool, g, &s);
  }
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
  if (big) {
    // step 3 in device memory: fill, sort all 64 bits, take k_pool
    const int64_t len = g.blocks * g.seg + 1;
    const int64_t fill = (len + 255) / 256 < 4 * sm_count()
        ? (len + 255) / 256 : 4 * sm_count();
    pool_fill_kernel<<<static_cast<unsigned>(fill), 256, 0, st>>>(
        bs.keys[0], bs.seg_count, g.seg, g.blocks, bs.counters, c, depth,
        buckets, l);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    int cur = 0;
    e = radix_sort<unsigned long long, false>(bs.keys, nullptr, len, 64,
                                              bs.hist, bs.partials, st,
                                              &cur);
    if (e != cudaSuccess) return e;
    pool_take_kernel<<<static_cast<unsigned>((k_pool + 255) / 256), 256,
                       0, st>>>(bs.keys[cur], k_pool,
                                static_cast<int*>(pool));
    return cudaGetLastError();
  }
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

// ---------------------------------------------------------------- K15 API

// The largest topk + candidates merged by one CTA; past it the merge
// runs over the SMs on a device scratch.
extern "C" int detpu_topk_merge_max(void) { return kBlockKeys; }

// Bytes of device scratch K15 needs (0 for one CTA).
extern "C" int64_t detpu_topk_merge_scratch_bytes(int topk, int cand_n) {
  return carve_merge(nullptr, topk, cand_n, nullptr);
}

// Bytes of a prepared K15 launch (host memory the record owns).
extern "C" int64_t detpu_topk_merge_prepared_bytes(void) {
  return sizeof(MergeParams);
}

// The launch of K15 for a sketch [depth, buckets], a pool of k_pool ids
// padded to cand_n candidates, topk carried slots and n_count int64
// live-count words, on `scratch` (detpu_topk_merge_scratch_bytes bytes,
// null when 0), into `prepared`.
extern "C" int detpu_topk_merge_prepare(int depth, int buckets, int k_pool,
                                        int cand_n, int topk, int n_count,
                                        void* scratch, void* prepared) {
  MergeParams p;
  const int e = merge_prepare(depth, buckets, k_pool, cand_n, topk, n_count,
                              scratch, &p);
  if (e == cudaSuccess) memcpy(prepared, &p, sizeof(p));
  return e;
}

// The merge of record_ids (see the header): topk_ids and topk_est [topk]
// int32 and the width's ids accumulator [1] float32 updated in place;
// pool [k_pool] int32 from detpu_topk_pool; counts [n_count] int64 (their
// sum is the live count); total [1] float32 (or null) <- that count
// rounded once to float32 (first), or + it.
extern "C" int detpu_topk_merge_launch(const void* prepared, const void* cms,
                                       const void* pool, void* topk_ids,
                                       void* topk_est, void* ids_acc,
                                       const void* counts, void* total,
                                       int first, void* stream) {
  return merge_launch(*static_cast<const MergeParams*>(prepared), cms, pool,
                      topk_ids, topk_est, ids_acc, counts, total, first,
                      static_cast<cudaStream_t>(stream));
}
