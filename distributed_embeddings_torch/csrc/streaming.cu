// K16 and K17: the streaming vocabulary's slot-map remap with admission
// and eviction, and its guard-gated commit, for Hopper (sm_90a).
//
// K16 replaces the XLA-lowered body of
//   distributed_embeddings_tpu/parallel/streaming.py:remap_width (:265),
// which parallel/dist_embedding.py:_streaming_remap (:1418) runs once per
// width slab and step over the external ids of the streaming tables'
// slots (ext [n] int32 or int64, live [n] bool, and per position the
// owning table's capacity, bucket count, table id and slab row offset).
// Per position, in uint32 arithmetic:
//   u = uint32(ext ^ (ext >> 32)) for int64 ids, uint32(ext) for int32;
//   mix(m) = avalanche(u ^ uint32(tid) * H_SALT, m);
//   fp = mix(H_FP) >> 1 (31 bits, also the admission sketch's key);
//   slot = mix(H_SLOT) % max(cap, 1), bucket = mix(H_BUCKET) % max(nb, 1);
//   row = roff + slot, occ = slot_fp[live ? row : 0];
//   hit = live && occ == fp; local = hit ? slot : cap + bucket
// (local_rows holds ext's low word where not live). A read-only remap
// (an eval step, a serving flush) stops there: one launch of
// stream_lookup_kernel. The update then folds each live fp into the
// STAGED copy of the sketch (K13's integer adds: the same words as
// ops/sketch.py:cms_update) and finishes:
//   est = the count-min estimate of fp in the staged sketch (K14's
//     query);
//   claim = live && !hit && est >= admit_min_count
//           && (occ == SLOT_FREE || est >= slot_freq[row] + evict_margin);
//   one winner per claimed row, the lexicographic max of (est, fp, pos):
//     a 64-bit atomicMax of (est << 31) | fp into best_key[row], then a
//     32-bit atomicMax of pos among the claims that hold the row's best
//     key into best_pos[row]; the winner resets both entries, so the
//     scratch ([rows_cap] each, kept by the wrapper) is 0 and -1 between
//     launches and a launch touches O(n) of it, never O(rows_cap);
//   scrub_rows = winner ? row : rows_cap, hit_rows = hit ? row : rows_cap,
//   and the four counts (admitted, evicted = winners on a non-free slot,
//   bucket_ids = live && !hit, hit_ids) exact in int64.
// JAX resolves the winner with three rows_cap-long max-scatters filled
// with -1 every step; the results are the same values.
//
// K16's update design: ONE launch of persistent CTAs (no more than the
// card holds at once: the record reads the occupancy when it is built)
// in four phases behind grid-wide barriers (stream_remap_kernel):
//   1. hash each position, read the slot map, write local_rows and fp,
//      fold each live fp into the staged sketch (a warp merges its lanes
//      that hit one word, as K13 does); CTA 0 zeroes the counts;
//   2. estimate each position from the folded sketch, decide the claims,
//      take the 64-bit atomicMax of their keys;
//   3. take the position atomicMax among the claims holding their row's
//      best key;
//   4. write est-derived outputs (scrub_rows, hit_rows), reset the
//      touched best_key/best_pos entries, and add the counts (reduced in
//      the CTA, then one atomic each).
// A thread keeps its first kHold positions' fp, row, estimate and flags
// in registers across the phases; past kHold positions a thread (a
// stream longer than kHold x the grid's threads) the row and flags go
// to a scratch the record owns. The barriers are a cooperative launch's
// grid.sync(): it measured ~7 us a call faster than a plain launch with a
// never-reset ticket barrier (as K21's ticket; stream_variants.py's
// "ticket"), replays in a CUDA graph as that does, and refuses a grid
// that cannot be resident at once. The launch leaves nothing to reset. The
// one launch replaces six device operations (the hash, K13's fold and
// its count buffer, a memset, three kernels) and their host work.
//
// K17 replaces the scatters of streaming.py:commit (:366-462), gated by
// the device verdict `enable` (never read on the host; null = commit):
//   per claimed row, each element x of the slab row becomes x + (-x) in
//   the slab dtype (+0 for finite x, NaN otherwise, as JAX's
//   slab.at[rows].add(-cur)), each element c of a slab-shaped optimizer
//   leaf becomes (c + (-c)) + fill in the leaf dtype (JAX's zero-then-add
//   reset to fresh_row_fill), and slot_fp[row] = fp, slot_freq[row] =
//   est; then slot_freq[hit_row] = max(., est) for each hit, so a row
//   both claimed and hit takes the set before the max (remap_width's
//   order, :349 then :353); the staged sketch replaces the carried one,
//   the counts rounded once to float32 are added to the step totals (0
//   when not enabled), and on the step's last width the totals are added
//   to the cumulative counters and `steps` advances by enable.
//
// Everything but the float resets is integer arithmetic, and the resets
// are single IEEE adds, so both kernels equal their plain versions bit
// for bit (a NaN is a NaN). Bound: bytes (the id stream, the gathers of
// slot_fp, slot_freq and the sketch words, the outputs; K17 the claimed
// rows and the n-long row lists).
//
// K17's design: ONE cooperative launch of persistent CTAs (the occupancy
// read when the record is built, kCommitCtasPerSm a SM at most) in two
// phases behind one grid.sync() (commit_kernel). Each CTA reads `enable`
// once; when it is False only CTA 0's fold of zero counts runs. Phase 1
// walks the positions grid-stride: the claimed rows' slot-map entries are
// set and a warp resets each claimed row of the slab and of every leaf,
// 16-byte lanes where the row's bytes and the tensor's address allow;
// every CTA copies its share of the staged sketch into the carried one
// (int4 where aligned) and CTA 0 folds the counts. Phase 2 takes the
// hits' atomicMax, each skipped where the slot, read first, already holds
// as much (stream_variants.py: a warp's merge of the lanes that hit one
// row before the max, and the max on every hit, both measured slower). A
// thread keeps its first kCommitHold positions' hit rows and estimates
// in registers across the barrier. The launch leaves nothing to reset, so
// its record (ops/streaming.py: keyed on layouts, the leaves' dtypes and
// fills, finalize and whether enable is given) replays in a CUDA graph;
// a call passes only its addresses. chip_smoke.py --parent times it in
// turns with an earlier checkout's wrapper.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <cooperative_groups.h>

namespace {

constexpr uint32_t kHSlot = 0x7FEB352Du;
constexpr uint32_t kHBucket = 0x846CA68Bu;
constexpr uint32_t kHFp = 0x9E3779B1u;
constexpr uint32_t kHSalt = 0x85EBCA77u;
constexpr uint32_t kAvalanche = 0x2C1B3C6Du;
constexpr int kSlotFree = -1;
constexpr int kThreads = 256;
constexpr int kMaxLeaves = 4;

constexpr uint8_t kLive = 1;
constexpr uint8_t kHit = 2;
constexpr uint8_t kFree = 4;
constexpr uint8_t kClaim = 8;

// The count-min sketch's column hash and query: the same as K14's
// (sketch.cu), so the fused estimate equals ops/sketch.py:cms_query.
__constant__ uint32_t kMults[8] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                   0x27D4EB2Fu, 0x165667B1u, 0xD3A2646Du,
                                   0xFD7046C5u, 0xB55A4F09u};
constexpr uint32_t kMix = 0x2C1B3C6Du;

__device__ __forceinline__ uint32_t column(uint32_t id, int d,
                                           uint32_t buckets) {
  uint32_t h = id * (kMults[d & 7] ^ static_cast<uint32_t>(d));
  h ^= h >> 15;
  h *= kMix;
  h ^= h >> 13;
  return h % buckets;
}

// Count-min estimate of a key (keys are fingerprints, never negative).
__device__ __forceinline__ int query(const int* __restrict__ cms, int depth,
                                     int buckets, int key) {
  const uint32_t u = static_cast<uint32_t>(key < 0 ? 0 : key);
  int est = 0x7fffffff;
  for (int d = 0; d < depth; ++d) {
    const int v = cms[static_cast<int64_t>(d) * buckets +
                      column(u, d, static_cast<uint32_t>(buckets))];
    est = v < est ? v : est;
  }
  return est;
}

__device__ __forceinline__ uint32_t mix(uint32_t u, uint32_t salt,
                                        uint32_t mult) {
  uint32_t h = u ^ salt;
  h *= mult;
  h ^= h >> 15;
  h *= kAvalanche;
  h ^= h >> 13;
  return h;
}

__device__ __forceinline__ unsigned long long claim_key(int est, int fp) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(est))
          << 31) | static_cast<uint32_t>(fp);
}

// ------------------------------------------------------------------ K16

constexpr int kRemapThreads = 256;
constexpr int kRemapCtasPerSm = 4;  // at most, as the occupancy allows
constexpr int kHold = 4;            // positions a thread keeps in registers

// What a K16 record fixes.
struct RemapConsts {
  int64_t n;
  int64_t n4;  // an int32 output's stride in the call's allocation
  int32_t update, ids64, rows_cap, depth, buckets, admit, margin, grid;
  unsigned long long* best_key;  // [rows_cap], all 0 between launches
  int* best_pos;                 // [rows_cap], all -1 between launches
  int* rowc;                     // [n] past kHold a thread, else null
  uint8_t* flags;                // [n] likewise
};

// What a K16 call passes.
struct RemapPtrs {
  const void* ext;
  const uint8_t* live;
  const int* cap;
  const int* nb;
  const int* tid;
  const int* roff;
  const int* slot_fp;
  const int* slot_freq;
  int* cms;
  int* local_rows;
  int* fp;
  int* est;
  int* scrub_rows;
  int* hit_rows;
  unsigned long long* counts;
};

// One position's state across the phases (est holds local_rows's value
// until phase 2).
struct Pos {
  int fp, row, est;
  uint8_t flags;
};

// Phase 1's hash of position i (loads only): fp, the row read (row when
// live, else 0), the flags, and in est the row it reads (local_rows).
template <typename IdT>
__device__ __forceinline__ Pos hash_pos(const RemapPtrs& q, int64_t i) {
  const long long x = static_cast<const IdT*>(q.ext)[i];
  const uint32_t u = sizeof(IdT) == 8
      ? static_cast<uint32_t>(static_cast<unsigned long long>(x ^ (x >> 32)))
      : static_cast<uint32_t>(x);
  const bool lv = q.live[i] != 0 && x >= 0;
  const uint32_t salt = static_cast<uint32_t>(q.tid[i]) * kHSalt;
  const int fp = static_cast<int>(mix(u, salt, kHFp) >> 1);
  const int c = q.cap[i];
  const int b = q.nb[i];
  const uint32_t cs = static_cast<uint32_t>(c > 1 ? c : 1);
  const uint32_t bs = static_cast<uint32_t>(b > 1 ? b : 1);
  const int slot = static_cast<int>(mix(u, salt, kHSlot) % cs);
  const int bucket = static_cast<int>(mix(u, salt, kHBucket) % bs);
  const int row = static_cast<int>(static_cast<uint32_t>(q.roff[i]) +
                                   static_cast<uint32_t>(slot));
  const int r = lv ? row : 0;
  const int occ = q.slot_fp[r];
  const bool hit = lv && occ == fp;
  const int local = hit ? slot : static_cast<int>(static_cast<uint32_t>(c) +
                                                  static_cast<uint32_t>(bucket));
  return Pos{fp, r,
             lv ? local : static_cast<int>(static_cast<uint32_t>(
                              static_cast<unsigned long long>(x))),
             static_cast<uint8_t>((lv ? kLive : 0) | (hit ? kHit : 0) |
                                  (occ == kSlotFree ? kFree : 0))};
}

// The read-only remap: local_rows only, one thread a position.
template <typename IdT>
__global__ void __launch_bounds__(kThreads)
stream_lookup_kernel(const RemapPtrs q, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < n) q.local_rows[i] = hash_pos<IdT>(q, i).est;
}

// The grid-wide barrier of the cooperative launch.
__device__ __forceinline__ void grid_barrier() {
  cooperative_groups::this_grid().sync();
}

// Phase 1's fold of a warp's live fingerprints into the staged sketch:
// the lanes that hit one word add their count once (every lane of the
// warp calls it).
__device__ __forceinline__ void fold(int* cms, int depth, int buckets,
                                     bool ok, int fp) {
  const unsigned mask = __ballot_sync(0xffffffffu, ok);
  if (!ok) return;
  const int lane = threadIdx.x & 31;
  for (int d = 0; d < depth; ++d) {
    const uint32_t col = column(static_cast<uint32_t>(fp), d,
                                static_cast<uint32_t>(buckets));
    const unsigned peers = __match_any_sync(mask, col);
    if (lane == __ffs(peers) - 1) {
      atomicAdd(cms + static_cast<int64_t>(d) * buckets + col,
                __popc(peers));
    }
  }
}

// Phase 2's estimate of a fingerprint in the folded sketch (read past the
// L1: other SMs' adds).
__device__ __forceinline__ int estimate(const RemapConsts& c,
                                        const RemapPtrs& q, int fp) {
  const uint32_t key = static_cast<uint32_t>(fp);
  int e = 0x7fffffff;
  for (int d = 0; d < c.depth; ++d) {
    const int v = __ldcg(q.cms + static_cast<int64_t>(d) * c.buckets +
                         column(key, d, static_cast<uint32_t>(c.buckets)));
    e = v < e ? v : e;
  }
  return e;
}

// Phase 2 for one position whose estimate p.est is known: its claim.
__device__ __forceinline__ void claim_pos(const RemapConsts& c,
                                          const RemapPtrs& q, int64_t i,
                                          Pos& p) {
  const int e = p.est;
  q.est[i] = e;
  if ((p.flags & kLive) && !(p.flags & kHit) && e >= c.admit) {
    // int32 wrap, as JAX's slot_freq + evict_margin
    const int thr = static_cast<int>(
        static_cast<uint32_t>(q.slot_freq[p.row]) +
        static_cast<uint32_t>(c.margin));
    if ((p.flags & kFree) || e >= thr) {
      p.flags |= kClaim;
      atomicMax(c.best_key + p.row, claim_key(e, p.fp));
    }
  }
}

// Phase 3 for one position: the claims holding their row's best key
// take the position max.
__device__ __forceinline__ void claim_best(const RemapConsts& c, int64_t i,
                                           const Pos& p) {
  if ((p.flags & kClaim) &&
      __ldcg(c.best_key + p.row) == claim_key(p.est, p.fp)) {
    atomicMax(c.best_pos + p.row, static_cast<int>(i));
  }
}

// Phase 4 for one position: its outputs, the winner's reset of the
// scratch entries, and its share of the counts.
__device__ __forceinline__ void finish_pos(const RemapConsts& c,
                                           const RemapPtrs& q, int64_t i,
                                           const Pos& p, unsigned* cnt) {
  // only the winner reads its own position here: a loser reads the
  // winner's position or the reset -1, neither of which is its own
  const bool scrub = (p.flags & kClaim) &&
                     __ldcg(c.best_pos + p.row) == static_cast<int>(i);
  if (scrub) {
    c.best_key[p.row] = 0ull;
    c.best_pos[p.row] = -1;
  }
  const bool hit = (p.flags & kHit) != 0;
  q.scrub_rows[i] = scrub ? p.row : c.rows_cap;
  q.hit_rows[i] = hit ? p.row : c.rows_cap;
  cnt[0] += scrub;
  cnt[1] += scrub && !(p.flags & kFree);
  cnt[2] += (p.flags & kLive) && !hit;
  cnt[3] += hit;
}

// A position past kHold a thread: its state in the record's scratch (fp
// and est in the call's own outputs).
__device__ __forceinline__ Pos load_pos(const RemapConsts& c,
                                        const RemapPtrs& q, int64_t i) {
  return Pos{q.fp[i], c.rowc[i], q.est[i], c.flags[i]};
}

__device__ __forceinline__ void keep_pos(const RemapConsts& c, int64_t i,
                                         const Pos& p) {
  c.rowc[i] = p.row;
  c.flags[i] = p.flags;
}

// K16's update: ONE launch of persistent CTAs, four phases, three
// grid-wide barriers (see the header). Position i = t + k * T (t the
// thread's rank in the grid, T the grid's threads): k < kHold in
// registers, the rest through the scratch; every loop's bound is uniform
// over a block, so the fold's warps run whole. Each phase starts all its
// held positions' loads before their stores and atomics, so their
// latencies overlap.
template <typename IdT>
__global__ void __launch_bounds__(kRemapThreads, kRemapCtasPerSm)
stream_remap_kernel(const RemapConsts c, const RemapPtrs q) {
  const int64_t T = static_cast<int64_t>(gridDim.x) * kRemapThreads;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kRemapThreads;
  const int64_t n = c.n;
  Pos reg[kHold] = {};
  // 1. hash, slot map, fold
  if (blockIdx.x == 0 && threadIdx.x < 4) q.counts[threadIdx.x] = 0ull;
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    const int64_t i = t0 + k * T + threadIdx.x;
    if (i < n) reg[k] = hash_pos<IdT>(q, i);
  }
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    const int64_t i = t0 + k * T + threadIdx.x;
    if (i < n) {
      q.local_rows[i] = reg[k].est;
      q.fp[i] = reg[k].fp;
    }
  }
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    const int64_t i = t0 + k * T + threadIdx.x;
    if (t0 + k * T < n) {
      fold(q.cms, c.depth, c.buckets, i < n && (reg[k].flags & kLive),
           reg[k].fp);
    }
  }
  for (int64_t b0 = t0 + kHold * T; b0 < n; b0 += T) {
    const int64_t i = b0 + threadIdx.x;
    Pos p{};
    if (i < n) {
      p = hash_pos<IdT>(q, i);
      q.local_rows[i] = p.est;
      q.fp[i] = p.fp;
      keep_pos(c, i, p);
    }
    fold(q.cms, c.depth, c.buckets, i < n && (p.flags & kLive), p.fp);
  }
  grid_barrier();
  // 2. estimates and claims
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    const int64_t i = t0 + k * T + threadIdx.x;
    if (i < n) reg[k].est = estimate(c, q, reg[k].fp);
  }
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    const int64_t i = t0 + k * T + threadIdx.x;
    if (i < n) claim_pos(c, q, i, reg[k]);
  }
  for (int64_t i = t0 + kHold * T + threadIdx.x; i < n; i += T) {
    Pos p = load_pos(c, q, i);
    p.est = estimate(c, q, p.fp);
    claim_pos(c, q, i, p);
    keep_pos(c, i, p);
  }
  grid_barrier();
  // 3. the position max among the best keys
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    const int64_t i = t0 + k * T + threadIdx.x;
    if (i < n) claim_best(c, i, reg[k]);
  }
  for (int64_t i = t0 + kHold * T + threadIdx.x; i < n; i += T) {
    claim_best(c, i, load_pos(c, q, i));
  }
  grid_barrier();
  // 4. outputs, resets, counts
  unsigned cnt[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    const int64_t i = t0 + k * T + threadIdx.x;
    if (i < n) finish_pos(c, q, i, reg[k], cnt);
  }
  for (int64_t i = t0 + kHold * T + threadIdx.x; i < n; i += T) {
    finish_pos(c, q, i, load_pos(c, q, i), cnt);
  }
  __shared__ unsigned warp_sums[4][kRemapThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned s = __reduce_add_sync(0xffffffffu, cnt[k]);
    if (lane == 0) warp_sums[k][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    unsigned long long s = 0;
    for (int w = 0; w < kRemapThreads / 32; ++w) {
      s += warp_sums[threadIdx.x][w];
    }
    if (s) atomicAdd(q.counts + threadIdx.x, s);
  }
}

// The CTAs of an update launch over n positions: no more than the card
// holds at once (kRemapCtasPerSm a SM at most), nor than n fills; 0 on
// an error.
int remap_grid(int ids64, int64_t n, int sms) {
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm,
      ids64 ? stream_remap_kernel<long long> : stream_remap_kernel<int>,
      kRemapThreads, 0);
  if (e != cudaSuccess || per_sm <= 0) return 0;
  if (per_sm > kRemapCtasPerSm) per_sm = kRemapCtasPerSm;
  int64_t g = (n + kRemapThreads - 1) / kRemapThreads;
  const int64_t most = static_cast<int64_t>(sms) * per_sm;
  if (g > most) g = most;
  return static_cast<int>(g < 1 ? 1 : g);
}

// ------------------------------------------------------------------ K17

constexpr int kCommitThreads = 256;
constexpr int kCommitCtasPerSm = 4;  // at most, as the occupancy allows
constexpr int kCommitHold = 4;       // hits a thread keeps across the barrier
constexpr int kRowTensors = 1 + kMaxLeaves;  // the slab, then the leaves
constexpr uint32_t kVecCopy = 1u << kRowTensors;  // cms <- staged by int4

// What a K17 record fixes.
struct CommitConsts {
  int64_t n;          // positions
  int64_t cms_numel;  // the sketch's words
  int32_t width, rows_cap, n_leaves, finalize, has_enable, grid;
  int32_t dtype[kRowTensors];  // 0 float32, 1 bfloat16
  float fill[kRowTensors];     // 0 for the slab
};

// What a K17 call passes.
struct CommitPtrs {
  void* row_t[kRowTensors];  // the slab, then the leaves
  const int* scrub_rows;
  const int* fp;
  const int* est;
  const int* hit_rows;
  const unsigned long long* counts;
  int* slot_fp;
  int* slot_freq;
  int* cms;
  const int* staged;
  float* totals;
  float* counter[4];
  int* steps;
  const uint8_t* enable;  // null: commit
  uint32_t vec;  // bit t: row tensor t takes 16-byte lanes; kVecCopy
};

// x + (-x), then + fill when add_fill, each add rounded to the dtype
// (fill arrives rounded to it).
__device__ __forceinline__ float reset_f32(float x, bool add_fill,
                                           float fill) {
  const float z = __fadd_rn(x, -x);
  return add_fill ? __fadd_rn(z, fill) : z;
}

__device__ __forceinline__ uint16_t reset_bf16(uint16_t bits, bool add_fill,
                                               float fill) {
  const float x = __uint_as_float(static_cast<uint32_t>(bits) << 16);
  float z = __bfloat162float(__float2bfloat16_rn(__fadd_rn(x, -x)));
  if (add_fill) z = __bfloat162float(__float2bfloat16_rn(__fadd_rn(z, fill)));
  return __bfloat16_as_ushort(__float2bfloat16_rn(z));
}

__device__ __forceinline__ uint32_t reset_bf16x2(uint32_t w, bool add_fill,
                                                 float fill) {
  return static_cast<uint32_t>(reset_bf16(static_cast<uint16_t>(w),
                                          add_fill, fill)) |
         (static_cast<uint32_t>(reset_bf16(static_cast<uint16_t>(w >> 16),
                                           add_fill, fill)) << 16);
}

// One row of row tensor t reset by the warp's lanes: 16 bytes a lane a
// load where vec, one element otherwise.
__device__ void reset_row(const CommitConsts& c, const CommitPtrs& q, int t,
                          int64_t row, int lane) {
  const int w = c.width;
  const float f = c.fill[t];
  const bool add = f != 0.0f;
  const bool vec = (q.vec >> t) & 1u;
  if (c.dtype[t] == 0) {
    float* p = static_cast<float*>(q.row_t[t]) + row * w;
    if (vec) {
      float4* v = reinterpret_cast<float4*>(p);
      for (int k = lane; k < w / 4; k += 32) {
        float4 x = v[k];
        x.x = reset_f32(x.x, add, f);
        x.y = reset_f32(x.y, add, f);
        x.z = reset_f32(x.z, add, f);
        x.w = reset_f32(x.w, add, f);
        v[k] = x;
      }
    } else {
      for (int k = lane; k < w; k += 32) p[k] = reset_f32(p[k], add, f);
    }
  } else {
    uint16_t* p = static_cast<uint16_t*>(q.row_t[t]) + row * w;
    if (vec) {
      uint4* v = reinterpret_cast<uint4*>(p);
      for (int k = lane; k < w / 8; k += 32) {
        uint4 x = v[k];
        x.x = reset_bf16x2(x.x, add, f);
        x.y = reset_bf16x2(x.y, add, f);
        x.z = reset_bf16x2(x.z, add, f);
        x.w = reset_bf16x2(x.w, add, f);
        v[k] = x;
      }
    } else {
      for (int k = lane; k < w; k += 32) p[k] = reset_bf16(p[k], add, f);
    }
  }
}

// Phase 1 for the warp's 32 positions (every lane calls; r the lane's
// scrub row or rows_cap): each claimed row's slot-map entry is set, then
// the warp resets the claimed rows one after another, lanes over the
// width.
__device__ __forceinline__ void claim_rows(const CommitConsts& c,
                                           const CommitPtrs& q, int64_t i,
                                           int r) {
  const bool mine = r >= 0 && r < c.rows_cap;
  if (mine) {
    q.slot_fp[r] = q.fp[i];
    q.slot_freq[r] = q.est[i];
  }
  unsigned m = __ballot_sync(0xffffffffu, mine);
  const int lane = threadIdx.x & 31;
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const int64_t row = __shfl_sync(0xffffffffu, r, src);
    for (int t = 0; t <= c.n_leaves; ++t) reset_row(c, q, t, row, lane);
  }
}

// Phase 2 for one position (r its hit row or rows_cap, e its estimate):
// the atomicMax where e passes the slot's value as read (slot_freq only
// grows in phase 2, so a value read is never above the final one: the
// skipped max is a no-op).
__device__ __forceinline__ void hit_max(const CommitConsts& c,
                                        const CommitPtrs& q, int r, int e) {
  if (r >= 0 && r < c.rows_cap && e > __ldcg(q.slot_freq + r)) {
    atomicMax(q.slot_freq + r, e);
  }
}

// K17: ONE launch of persistent CTAs, two phases behind one grid-wide
// barrier (see the header). Every CTA reads `enable` once; when it is
// False no CTA goes past CTA 0's fold of zero counts, so none waits at
// the barrier. Position i = t + k * T (t the thread's rank in the grid,
// T the grid's threads): the first kCommitHold a thread keep their hit
// row and estimate in registers across the barrier, the rest are read
// again after it. Phase 1's loop bounds are uniform over a block, so the
// warps run whole through claim_rows' ballot.
__global__ void __launch_bounds__(kCommitThreads, kCommitCtasPerSm)
commit_kernel(const CommitConsts c, const CommitPtrs q) {
  __shared__ int s_en;
  if (threadIdx.x == 0) s_en = q.enable == nullptr || *q.enable != 0;
  __syncthreads();
  const bool en = s_en != 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) {
      const float g = en ? __ull2float_rn(q.counts[k]) : 0.0f;
      q.totals[k] = __fadd_rn(q.totals[k], g);
      if (c.finalize) *q.counter[k] = __fadd_rn(*q.counter[k], q.totals[k]);
    }
    if (c.finalize) *q.steps += en ? 1 : 0;
  }
  if (!en) return;
  const int64_t T = static_cast<int64_t>(gridDim.x) * kCommitThreads;
  const int64_t tg = static_cast<int64_t>(blockIdx.x) * kCommitThreads +
                     threadIdx.x;
  // 1. the staged sketch, the claims' slot map and row resets
  if (q.vec & kVecCopy) {
    for (int64_t k = tg; k < c.cms_numel / 4; k += T) {
      reinterpret_cast<int4*>(q.cms)[k] =
          reinterpret_cast<const int4*>(q.staged)[k];
    }
  } else {
    for (int64_t k = tg; k < c.cms_numel; k += T) q.cms[k] = q.staged[k];
  }
  const int64_t t0 = tg - threadIdx.x;
  const int64_t n = c.n;
  int sr[kCommitHold], hr[kCommitHold], he[kCommitHold];
#pragma unroll
  for (int k = 0; k < kCommitHold; ++k) {
    const int64_t i = tg + k * T;
    const bool in = i < n;
    sr[k] = in ? q.scrub_rows[i] : c.rows_cap;
    hr[k] = in ? q.hit_rows[i] : c.rows_cap;
    he[k] = in ? q.est[i] : 0;
  }
#pragma unroll
  for (int k = 0; k < kCommitHold; ++k) {
    if (t0 + k * T < n) claim_rows(c, q, tg + k * T, sr[k]);
  }
  for (int64_t b0 = t0 + kCommitHold * T; b0 < n; b0 += T) {
    const int64_t i = b0 + threadIdx.x;
    claim_rows(c, q, i, i < n ? q.scrub_rows[i] : c.rows_cap);
  }
  grid_barrier();
  // 2. the hits' max, after every claim's set
#pragma unroll
  for (int k = 0; k < kCommitHold; ++k) hit_max(c, q, hr[k], he[k]);
  for (int64_t i = tg + kCommitHold * T; i < n; i += T) {
    hit_max(c, q, q.hit_rows[i], q.est[i]);
  }
}

// The CTAs of a commit over n positions: no more than the card holds at
// once (kCommitCtasPerSm a SM at most), nor than n fills, at least one
// (the sketch copy and the counts); 0 on an error.
int commit_grid(int64_t n, int sms) {
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, commit_kernel, kCommitThreads, 0);
  if (e != cudaSuccess || per_sm <= 0) return 0;
  if (per_sm > kCommitCtasPerSm) per_sm = kCommitCtasPerSm;
  int64_t g = (n + kCommitThreads - 1) / kCommitThreads;
  const int64_t most = static_cast<int64_t>(sms) * per_sm;
  if (g > most) g = most;
  return static_cast<int>(g < 1 ? 1 : g);
}

unsigned grid(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The bytes of a prepared K16 launch.
extern "C" int64_t detpu_stream_remap_prepared_bytes() {
  return static_cast<int64_t>(sizeof(RemapConsts));
}

// The bytes of card scratch a K16 update record owns: when n passes
// kHold positions a thread of the grid, the rows and flags of the
// positions past them; else 0. -1 when the kernel has no launch
// configuration.
extern "C" int64_t detpu_stream_remap_scratch_bytes(int ids_is_64, int64_t n,
                                                    int sms) {
  const int g = remap_grid(ids_is_64, n, sms);
  if (g <= 0) return -1;
  const int64_t held = static_cast<int64_t>(g) * kRemapThreads * kHold;
  return n > held ? n * 5 : 0;
}

// Validate a K16 record and write its prepared launch to `out`
// (detpu_stream_remap_prepared_bytes() bytes of host memory). update: 1
// for the update (the sketch fold and the staged claims), 0 for the
// read-only remap (local_rows alone). ext [n] int32 (ids_is_64 = 0) or
// int64; rows_cap the slot map's rows; depth x buckets the sketch;
// best_key [rows_cap] uint64 (all 0) and best_pos [rows_cap] int32 (all
// -1), left as found by every launch; scratch
// (detpu_stream_remap_scratch_bytes of it, or null for none); n4 the
// stride of the
// call allocation's int32 outputs. The update's grid (the occupancy,
// sms) is fixed here. Launches nothing.
extern "C" int detpu_stream_remap_prepare(int update, int ids_is_64,
                                          int64_t n, int64_t n4,
                                          int rows_cap, int depth,
                                          int buckets, int admit,
                                          int margin, int sms,
                                          void* best_key, void* best_pos,
                                          void* scratch, void* out) {
  if (n < 0 || n >= (1ll << 31) || n4 < n || rows_cap <= 0 || sms <= 0 ||
      out == nullptr ||
      (update && (depth <= 0 || buckets <= 0 || best_key == nullptr ||
                  best_pos == nullptr))) {
    return cudaErrorInvalidValue;
  }
  RemapConsts* c = static_cast<RemapConsts*>(out);
  memset(c, 0, sizeof(RemapConsts));
  c->n = n;
  c->n4 = n4;
  c->update = update != 0;
  c->ids64 = ids_is_64 != 0;
  c->rows_cap = rows_cap;
  c->depth = depth;
  c->buckets = buckets;
  c->admit = admit;
  c->margin = margin;
  if (update) {
    c->grid = remap_grid(ids_is_64, n, sms);
    if (c->grid <= 0) return cudaErrorInvalidConfiguration;
    c->best_key = static_cast<unsigned long long*>(best_key);
    c->best_pos = static_cast<int*>(best_pos);
    const int64_t held =
        static_cast<int64_t>(c->grid) * kRemapThreads * kHold;
    if (n > held) {
      if (scratch == nullptr) return cudaErrorInvalidValue;
      c->rowc = static_cast<int*>(scratch);
      c->flags = static_cast<uint8_t*>(scratch) + n * 4;
    }
  }
  return cudaSuccess;
}

// K16 through a prepared launch. ext, live [n] bool, cap/nb/tid/roff [n]
// int32, slot_fp [rows_cap] int32; the update also reads slot_freq
// [rows_cap] int32 and folds into cms [depth, buckets] int32 (the staged
// sketch, in place). out: the read-only remap's local_rows [n] int32;
// the update's one allocation: counts [4] int64 at its start, then
// local_rows, fp, est, scrub_rows and hit_rows [n] int32 at 32 + k * 4
// * n4 bytes.
extern "C" int detpu_stream_remap_launch(const void* prepared,
                                         const void* ext, const void* live,
                                         const void* cap, const void* nb,
                                         const void* tid, const void* roff,
                                         const void* slot_fp,
                                         const void* slot_freq, void* cms,
                                         void* out, void* stream) {
  const RemapConsts* c = static_cast<const RemapConsts*>(prepared);
  if (c == nullptr || out == nullptr ||
      (c->update && (slot_freq == nullptr || cms == nullptr))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RemapPtrs q{};
  q.ext = ext;
  q.live = static_cast<const uint8_t*>(live);
  q.cap = static_cast<const int*>(cap);
  q.nb = static_cast<const int*>(nb);
  q.tid = static_cast<const int*>(tid);
  q.roff = static_cast<const int*>(roff);
  q.slot_fp = static_cast<const int*>(slot_fp);
  if (!c->update) {
    if (c->n == 0) return cudaSuccess;
    q.local_rows = static_cast<int*>(out);
    if (c->ids64) {
      stream_lookup_kernel<long long><<<grid(c->n), kThreads, 0, st>>>(q,
                                                                        c->n);
    } else {
      stream_lookup_kernel<int><<<grid(c->n), kThreads, 0, st>>>(q, c->n);
    }
    return cudaGetLastError();
  }
  q.slot_freq = static_cast<const int*>(slot_freq);
  q.cms = static_cast<int*>(cms);
  q.counts = static_cast<unsigned long long*>(out);
  int* o = reinterpret_cast<int*>(static_cast<uint8_t*>(out) + 32);
  q.local_rows = o;
  q.fp = o + c->n4;
  q.est = o + 2 * c->n4;
  q.scrub_rows = o + 3 * c->n4;
  q.hit_rows = o + 4 * c->n4;
  void* kernel = c->ids64
      ? reinterpret_cast<void*>(stream_remap_kernel<long long>)
      : reinterpret_cast<void*>(stream_remap_kernel<int>);
  RemapConsts cc = *c;
  void* args[] = {&cc, &q};
  return cudaLaunchCooperativeKernel(kernel, c->grid, kRemapThreads, args, 0,
                                     st);
}

// The bytes of a prepared K17 launch.
extern "C" int64_t detpu_stream_commit_prepared_bytes() {
  return static_cast<int64_t>(sizeof(CommitConsts));
}

// Validate a K17 record and write its prepared launch to `out`
// (detpu_stream_commit_prepared_bytes() bytes of host memory): a slab
// [rows_cap, width] (dtype 0 float32, 1 bfloat16) and n_leaves (at most
// four) leaves of its shape (leaf_dtypes int32 and leaf_fills float32,
// host arrays of n_leaves); n positions; a sketch of cms_numel words;
// finalize: the step's last width (the counters and steps advance);
// has_enable: each call passes a bool on the card. The grid (the
// occupancy, sms) is fixed here. Launches nothing.
extern "C" int detpu_stream_commit_prepare(int slab_dtype, int width,
                                           int rows_cap, int n_leaves,
                                           const void* leaf_dtypes,
                                           const void* leaf_fills,
                                           int64_t n, int64_t cms_numel,
                                           int finalize, int has_enable,
                                           int sms, void* out) {
  if (n < 0 || n >= (1ll << 31) || width <= 0 || rows_cap <= 0 ||
      n_leaves < 0 || n_leaves > kMaxLeaves || cms_numel < 0 || sms <= 0 ||
      out == nullptr || (slab_dtype != 0 && slab_dtype != 1) ||
      (n_leaves > 0 && (leaf_dtypes == nullptr || leaf_fills == nullptr))) {
    return cudaErrorInvalidValue;
  }
  CommitConsts* c = static_cast<CommitConsts*>(out);
  memset(c, 0, sizeof(CommitConsts));
  c->n = n;
  c->cms_numel = cms_numel;
  c->width = width;
  c->rows_cap = rows_cap;
  c->n_leaves = n_leaves;
  c->finalize = finalize != 0;
  c->has_enable = has_enable != 0;
  c->dtype[0] = slab_dtype;
  for (int k = 0; k < n_leaves; ++k) {
    const int d = static_cast<const int*>(leaf_dtypes)[k];
    if (d != 0 && d != 1) return cudaErrorInvalidValue;
    c->dtype[1 + k] = d;
    float f = static_cast<const float*>(leaf_fills)[k];
    if (d == 1) {  // rounded to bfloat16 (nearest even; fills are finite)
      uint32_t u;
      memcpy(&u, &f, 4);
      u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
      memcpy(&f, &u, 4);
    }
    c->fill[1 + k] = f;
  }
  c->grid = commit_grid(n, sms);
  return c->grid > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// K17 through a prepared launch: scrub_rows, fp, est, hit_rows [n]
// int32, counts [4] int64, slot_fp, slot_freq [rows_cap] int32, cms and
// staged [cms_numel] int32, totals [4] float32 (the step's gated totals,
// accumulated), the four cumulative counters [1] float32 and steps [1]
// int32 (which take the totals when the record finalizes), the slab,
// then x0..x4: each leaf in order, then the enable bool when the record
// has one, null past them. The slab's and each leaf's rows take 16-byte
// lanes where the row's bytes and the tensor's address allow; the
// sketch copy likewise.
extern "C" int detpu_stream_commit_launch(
    const void* prepared, const void* scrub_rows, const void* fp,
    const void* est, const void* hit_rows, const void* counts, void* slot_fp,
    void* slot_freq, void* cms, const void* staged, void* totals, void* c0,
    void* c1, void* c2, void* c3, void* steps, void* slab, void* x0,
    void* x1, void* x2, void* x3, void* x4, void* stream) {
  const CommitConsts* c = static_cast<const CommitConsts*>(prepared);
  if (c == nullptr) return cudaErrorInvalidValue;
  void* const x[] = {x0, x1, x2, x3, x4};
  CommitPtrs q{};
  for (int t = 0; t <= c->n_leaves; ++t) {
    q.row_t[t] = t == 0 ? slab : x[t - 1];
    const int64_t row_bytes =
        static_cast<int64_t>(c->width) * (c->dtype[t] == 0 ? 4 : 2);
    if (q.row_t[t] == nullptr) return cudaErrorInvalidValue;
    if (row_bytes % 16 == 0 &&
        reinterpret_cast<uintptr_t>(q.row_t[t]) % 16 == 0) {
      q.vec |= 1u << t;
    }
  }
  q.scrub_rows = static_cast<const int*>(scrub_rows);
  q.fp = static_cast<const int*>(fp);
  q.est = static_cast<const int*>(est);
  q.hit_rows = static_cast<const int*>(hit_rows);
  q.counts = static_cast<const unsigned long long*>(counts);
  q.slot_fp = static_cast<int*>(slot_fp);
  q.slot_freq = static_cast<int*>(slot_freq);
  q.cms = static_cast<int*>(cms);
  q.staged = static_cast<const int*>(staged);
  q.totals = static_cast<float*>(totals);
  q.counter[0] = static_cast<float*>(c0);
  q.counter[1] = static_cast<float*>(c1);
  q.counter[2] = static_cast<float*>(c2);
  q.counter[3] = static_cast<float*>(c3);
  q.steps = static_cast<int*>(steps);
  q.enable =
      c->has_enable ? static_cast<const uint8_t*>(x[c->n_leaves]) : nullptr;
  // the [n] lists and the sketch may be empty; nothing else
  const bool lists = c->n > 0, sketch = c->cms_numel > 0;
  if ((lists && (!scrub_rows || !fp || !est || !hit_rows)) ||
      (sketch && (!cms || !staged)) || !counts || !slot_fp || !slot_freq ||
      !totals || !c0 || !c1 || !c2 || !c3 || !steps ||
      (c->has_enable && q.enable == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (c->cms_numel % 4 == 0 && reinterpret_cast<uintptr_t>(cms) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(staged) % 16 == 0) {
    q.vec |= kVecCopy;
  }
  CommitConsts cc = *c;
  void* kargs[] = {&cc, &q};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(commit_kernel),
                                     c->grid, kCommitThreads, kargs, 0,
                                     static_cast<cudaStream_t>(stream));
}
