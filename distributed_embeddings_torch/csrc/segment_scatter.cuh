// The sorted-segment scatter engine of K3 (sgd_scatter.cu) and K18
// (sgd_promoted.cu), and of SparseAdagrad's dense-apply branch (the
// Adagrad mode, sgd_scatter.cu), for Hopper (sm_90a).
//
// K3 and K18 replace the XLA-lowered row scatter of the JAX package,
//   distributed_embeddings_tpu/parallel/optimizers.py:_sorted_scatter_add
//   under SparseSGD.apply_rows,
// slab.at[ids].add(update, mode="drop"). They differ only in the rounding
// chain a row's updates go through (the `Chain` below). The Adagrad mode
// replaces SparseAdagrad.apply_rows's dense-apply branch (:197-209): the
// scatter-sum of the stream into a zero gradient slab, then the Adagrad
// transition over the slab. It sums each hit row as K3 would into a
// zero-filled gradient row (from +0.0 in registers, every add rounded to
// the accumulator dtype A, the same fixed order), and where the row's sum
// is complete (the end of its unit in seg_rows, or seg_combine after the
// last chunk) applies the transition (adagrad_step.cuh) to that row of
// the accumulator and the slab: no gradient slab, no pass over rows no id
// hit. Untouched rows keep their bits, which the slab-wide transition
// gives them too wherever g = 0 is a no-op (ops/adagrad.py says when).
// Everything else is this engine, which applies every distinct hit row
// ONCE, with no atomics on the row path, deterministically:
//
// 1. Keys. Each id becomes its row under JAX indexing (a negative id
//    counts from the end once; anything outside [0, rows) is dropped, the
//    sentinel included). Dropped positions are never counted or written:
//    the histogram below counts kept ids only, and the first sort pass
//    reads the ids themselves, so the compaction is part of the sort. The
//    kept count stays on the card (the first pass writes it; every later
//    launch reads it and sizes nothing by it on the host).
// 2. Sort. A stable onesweep LSD radix sort of (row, stream position) on
//    the key's ceil(log2(rows)) bits, 8 bits a digit: one histogram launch
//    counts every digit of every kept id at once (16 bits: 2 passes, 24:
//    3, 28: 4), then one launch a digit. A pass tile of 4,096 pairs ranks
//    its items by digit in shared memory (warp match + per-warp counters:
//    stable), publishes its per-digit counts and finds the counts of the
//    earlier tiles by a decoupled look-back (one thread a digit), then
//    writes its pairs out in digit runs. Tiles take their index from a
//    64-bit ticket that is never reset: ticket / tiles numbers the pass,
//    and each status word carries that number beside its count in one
//    64-bit store, so a word left by an earlier pass reads as
//    unpublished. Nothing is reset between calls on the host; the
//    counters the call needs are zeroed by a launch of the call that
//    runs between their last and their next use (the histogram by the
//    segment launch, the segment counters by the histogram launch).
//    Stability keeps each row's positions in stream order.
// 3. Segments. One launch finds each run of equal rows (its start, and
//    its length by galloping then bisecting), and files it by length
//    class floor(log2(length)) into a list of its own (class c holds at
//    most n >> c segments, so the lists' places are fixed by n). The
//    rows pass takes the classes longest first, so a Zipfian hot row's
//    serial chain starts at the beginning of the pass, not at its end.
//    K3 and the Adagrad mode first cut a segment longer than `split` (L)
//    into chunks of L.
// 4. Rows. A persistent launch. A group of lanes takes a work unit (a
//    segment, or a chunk, and a block of columns); each lane owns 4
//    columns (16-byte update loads where width and alignment allow, one
//    column otherwise), reads its slab row once into float32 registers,
//    adds the segment's updates in stream order with the next batch's
//    positions and update rows loaded before the current batch is added,
//    and writes the row once. K3 adds a chunk's updates into a float32
//    partial instead, and one last launch adds each long segment's
//    partials into its row in chunk order (a fixed order: deterministic).
//    The Adagrad mode does the same with a zero row in registers in place
//    of the slab row, and ends each row in the transition's epilogue.
//    K18 gives each segment of 256 or more entries whole blocks, one a
//    32-column block: all 256 threads stream the segment's update rows
//    into a 3-stage shared-memory ring with cp.async while one warp runs
//    the column chains out of shared memory, a lane a column.
//
// The sort is also K5's (dedup.cu): a key policy (RowKey here, K5's
// IdKey there) says how the histogram and the first pass read a stream
// position, so K5 sorts every id, sign-flipped, with no compaction, on
// 32 or 64-bit keys.
//
// Bound: bytes. The stream is read once (ids, positions, update rows),
// each distinct hit row read and written once; the sort moves 8-byte
// (key, position) pairs once a digit. Row arithmetic is int64 (187.8M
// rows x 128 elements); positions are int32 (n < 2^31) and keys uint32
// (rows < 2^32).
//
// Everything here is in an anonymous namespace: each source that
// includes it is its own library (ops/_kernels.py), and the kernels keep
// their names in a profile ("(anonymous namespace)::seg_rows<...>").

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "adagrad_step.cuh"

namespace {

constexpr int kThreads = 256;          // every launch's block
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;             // 8-bit digits
constexpr int kMaxPasses = 4;          // uint32 keys (K5's uint64: 8)
constexpr int kItems = 16;             // pairs a thread in a sort tile
constexpr int kTile = kThreads * kItems;  // 4,096 pairs a sort tile
constexpr int kClasses = 32;           // segment length classes
// update rows a lane loads ahead: 4 beats 8 and 16 (more warps resident;
// K3 on the example and ragged streams, PR 14's variant runs)
constexpr int kBatch = 4;
// K3's chunk L: a segment of at most kSplit entries is added into its row
// in stream order (bit-exact to the stream-order plain version); a longer
// one is cut into chunks of kSplit summed by groups of their own.
// Chosen by measurement (segment_variants.py: K3 at L = 64, 256 and 1,024
// on the zoo's w8 scatter-sum and the ragged stream; PERF.md, PR 14).
constexpr int kSplit = 256;
constexpr int kLongClass = 8;          // K18: 256 entries or more
constexpr int kCombBatch = 16;         // K3's partials a lane loads ahead
constexpr int kBlockCols = 32;         // K18's block path: columns a block
constexpr int kStages = 3;             // ... its ring of stages
constexpr int kStageBytes = 16384;     // ... of 16 KB each
constexpr unsigned long long kInclusive = 1ull << 31;

// the words a call counts in
constexpr int kWordKept = 0;
constexpr int kWordClass = 1;                       // kClasses counters
constexpr int kWordChunks = kWordClass + kClasses;  // K3's chunk count
constexpr int kWordCombs = kWordChunks + 1;         // K3's long segments
constexpr int kWords = 64;

enum Mode : int { kModeK3 = 0, kModeK18 = 1, kModeAdagrad = 2 };

// One call's launches: fixed when the call is prepared (sizes, scratch,
// the chain's constants), and the per-call pointers filled in at launch.
struct Params {
  int64_t rows;
  int64_t n;
  int64_t tiles;                 // sort tiles: ceil(n / kTile)
  int width;
  int slab_dtype;                // 0 float32, 1 bfloat16
  int vals_dtype;
  int ids64;
  int cast_vals;                 // K3: 1 the stream chain, 0 the dedup one
  int lr_on_card;                // the lr is a float32 scalar on the card
  float neg_lr;                  // else -lr, rounded by the caller
  float ada_lr;                  // Adagrad: the constant lr, rounded to A
  float eps;                     // Adagrad: eps, rounded to A
  int passes;
  int split;                     // K3: L; K18: 0
  int long_class;                // K18: kLongClass; K3: kClasses (none)
  int sms;
  int* hist;                     // [kMaxPasses][kBins]
  int* words;                    // [kWords]
  unsigned long long* ticket;
  unsigned long long* status;    // [tiles][kBins]
  uint32_t* keys[2];
  int* pos[2];
  int2* items;                   // (start, length) by class
  int2* chunks;                  // K3: (start, length) of each chunk
  int2* combs;                   // K3: (first chunk, chunks) a long segment
  float* partials;               // K3: [chunks, width]
  int64_t class_off[kClasses];   // class c's list: sum_{c' < c} (n >> c')
  // K5's key policy (IdKey in dedup.cu): the valid mask and the pad id
  const unsigned char* valid;    // null: every position is valid
  int64_t pad_id;
  // per call
  void* slab;
  void* acc;                     // Adagrad: the accumulator (vals' dtype)
  const void* ids;
  const void* vals;
  const float* lr;
  int vec;                       // 4 columns a lane (else 1)
  int vec16;                     // K18's ring copies 16-byte parts
  int g_log2;                    // lanes a group, log2
  int ncb;                       // column blocks a unit of the group path
};

struct F32 {
  using E = float;
  __device__ static float load(E v) { return v; }
  __device__ static float rnd(float f) { return f; }
  __device__ static E store(float f) { return f; }
};

struct BF16 {
  using E = uint16_t;  // raw bf16 bits
  __device__ static float load(E v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  __device__ static float rnd(float f) {
    return __bfloat162float(__float2bfloat16_rn(f));
  }
  __device__ static E store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

__device__ __forceinline__ float bf16_round(float f) { return BF16::rnd(f); }

// f32(bf16(x)) of a raw update element (a bf16 element already is one)
template <typename Tv>
__device__ __forceinline__ float vals_bf16(typename Tv::E x) {
  if constexpr (sizeof(typename Tv::E) == 2) {
    return Tv::load(x);
  } else {
    return bf16_round(Tv::load(x));
  }
}

template <typename IdT>
__device__ __forceinline__ bool row_key(IdT raw, int64_t rows,
                                        uint32_t* key) {
  int64_t id = static_cast<int64_t>(raw);
  if (id < 0) id += rows;                 // JAX counts negatives from the end
  if (id < 0 || id >= rows) return false;  // mode="drop" (and the sentinel)
  *key = static_cast<uint32_t>(id);
  return true;
}

// The engine's key policy: a position keys by its row under JAX
// indexing, and a dropped id (outside the slab) is not kept.
template <typename IdT>
struct RowKey {
  using U = uint32_t;
  static constexpr int kMaxPasses = 4;
  static constexpr int kItems = 16;  // kTile / kThreads
  __device__ static bool of(const Params& p, int64_t j, U* key) {
    return row_key(static_cast<const IdT*>(p.ids)[j], p.rows, key);
  }
};

// Exclusive scan of one int per thread over the block; *total gets the
// block's sum. Ends with a barrier, so it can be called again.
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int ws[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) ws[lane] = s;
  }
  __syncthreads();
  *total = ws[kWarps - 1];
  const int r = (warp > 0 ? ws[warp - 1] : 0) + x - v;
  __syncthreads();
  return r;
}

// ----------------------------------------------------------------- sort

// Every digit of every kept id, counted at once; block 0 zeroes the
// call's counters (their last use was the previous call's last launch).
template <typename KeyOf>
__global__ void __launch_bounds__(kThreads)
seg_hist(const __grid_constant__ Params p) {
  constexpr int kPasses = KeyOf::kMaxPasses;
  __shared__ int sh[kPasses * kBins];
  for (int i = threadIdx.x; i < kPasses * kBins; i += kThreads) sh[i] = 0;
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < kWords; i += kThreads) p.words[i] = 0;
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       j < p.n; j += stride) {
    typename KeyOf::U key;
    if (KeyOf::of(p, j, &key)) {
      for (int q = 0; q < p.passes; ++q) {
        atomicAdd(&sh[q * kBins + static_cast<int>((key >> (8 * q)) &
                                                   (kBins - 1))], 1);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.passes * kBins; i += kThreads) {
    if (sh[i] != 0) atomicAdd(&p.hist[i], sh[i]);
  }
}

__device__ __forceinline__ void st_volatile(unsigned long long* a,
                                            unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(a) = v;
}

__device__ __forceinline__ unsigned long long ld_volatile(
    const unsigned long long* a) {
  return *reinterpret_cast<const volatile unsigned long long*>(a);
}

// Digit d's count in the tiles before `tile` of this pass (`epoch`); the
// tile's own count is `count`. Published as (epoch << 32 | flag | value)
// in one store: an aggregate first, the inclusive prefix once known.
__device__ __forceinline__ int look_back(unsigned long long* status,
                                         int64_t tile, int d, int count,
                                         uint32_t epoch) {
  const unsigned long long mark = static_cast<unsigned long long>(epoch)
                                  << 32;
  unsigned long long* mine = status + tile * kBins + d;
  if (tile == 0) {
    st_volatile(mine, mark | kInclusive | static_cast<uint32_t>(count));
    return 0;
  }
  st_volatile(mine, mark | static_cast<uint32_t>(count));
  int prefix = 0;
  for (int64_t q = tile - 1;; --q) {
    unsigned long long w;
    do {
      w = ld_volatile(status + q * kBins + d);
    } while (static_cast<uint32_t>(w >> 32) != epoch);
    prefix += static_cast<int>(w & 0x7fffffffull);
    if (w & kInclusive) break;
  }
  st_volatile(mine, mark | kInclusive |
                        static_cast<uint32_t>(prefix + count));
  return prefix;
}

// One digit pass: pass 0 reads the ids (and drops what the key policy
// drops), a later pass the previous pass's pairs; writes
// keys[(pass + 1) & 1] (keys of the policy's type U).
template <typename KeyOf, bool kFirst>
__global__ void __launch_bounds__(kThreads)
seg_sort_pass(const __grid_constant__ Params p, int pass) {
  using U = typename KeyOf::U;
  constexpr int kIt = KeyOf::kItems;
  constexpr int kTileIt = kThreads * kIt;
  __shared__ U s_key[kTileIt];
  __shared__ int s_pos[kTileIt];
  __shared__ int wh[kWarps][kBins];
  __shared__ int s_local[kBins];
  __shared__ int s_global[kBins];
  __shared__ unsigned long long s_ticket;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_ticket = atomicAdd(p.ticket, 1ull);
  int m;  // kept pairs
  const int excl = block_scan(p.hist[pass * kBins + tid], &m);
  const unsigned long long ticket = s_ticket;
  const int64_t tile = static_cast<int64_t>(ticket % gridDim.x);
  const uint32_t epoch = static_cast<uint32_t>(ticket / gridDim.x) + 1u;
  if (kFirst && tile == 0 && tid == 0) p.words[kWordKept] = m;
  const int64_t base = tile * kTileIt;
  const int64_t limit = kFirst ? p.n : static_cast<int64_t>(m);
  if (base >= limit) return;  // a later pass's tiles past the kept pairs
  const int shift = 8 * pass;
  const U* keys_in = reinterpret_cast<const U*>(p.keys[pass & 1]);
  const int* pos_in = p.pos[pass & 1];
  U* keys_out = reinterpret_cast<U*>(p.keys[(pass + 1) & 1]);
  int* pos_out = p.pos[(pass + 1) & 1];
  for (int d = lane; d < kBins; d += 32) wh[warp][d] = 0;
  const int64_t wbase = base + warp * (32 * kIt);
  U key[kIt];
  int val[kIt];
  uint32_t live = 0;  // bit k: item k is kept
#pragma unroll
  for (int k = 0; k < kIt; ++k) {
    const int64_t j = wbase + k * 32 + lane;
    key[k] = 0;
    val[k] = 0;
    if (j < limit) {
      if (kFirst) {
        if (KeyOf::of(p, j, &key[k])) {
          val[k] = static_cast<int>(j);
          live |= 1u << k;
        }
      } else {
        key[k] = keys_in[j];
        val[k] = pos_in[j];
        live |= 1u << k;
      }
    }
  }
  __syncwarp();
  // rank within the warp, in stream order (k-major, lane-minor)
  const unsigned lt = (1u << lane) - 1u;
  int rank[kIt];
#pragma unroll
  for (int k = 0; k < kIt; ++k) {
    const int d = (live >> k) & 1u
                      ? static_cast<int>((key[k] >> shift) & (kBins - 1))
                      : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    int r = 0;
    if (d >= 0) r = wh[warp][d] + __popc(peers & lt);
    __syncwarp();
    if (d >= 0 && (peers & lt) == 0u) wh[warp][d] += __popc(peers);
    __syncwarp();
    rank[k] = r;
  }
  __syncthreads();
  // thread d: digit d's count in the tile, each warp's start within it
  int count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = wh[w][tid];
    wh[w][tid] = count;
    count += c;
  }
  int tile_total;
  const int local = block_scan(count, &tile_total);
  s_local[tid] = local;
  s_global[tid] = excl + look_back(p.status, tile, tid, count, epoch);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kIt; ++k) {
    if ((live >> k) & 1u) {
      const int d = static_cast<int>((key[k] >> shift) & (kBins - 1));
      const int li = s_local[d] + wh[warp][d] + rank[k];
      s_key[li] = key[k];
      s_pos[li] = val[k];
    }
  }
  __syncthreads();
  // out in digit runs: neighbouring threads on neighbouring addresses
  for (int i = tid; i < tile_total; i += kThreads) {
    const U kk = s_key[i];
    const int d = static_cast<int>((kk >> shift) & (kBins - 1));
    const int64_t dst = static_cast<int64_t>(s_global[d]) + (i - s_local[d]);
    keys_out[dst] = kk;
    pos_out[dst] = s_pos[i];
  }
}

// ------------------------------------------------------------- segments

// The end of the run of `key` that starts at j: gallop, then bisect.
template <typename U>
__device__ __forceinline__ int run_length(const U* sk, int64_t j, int64_t m,
                                          U key) {
  int64_t lo = j;          // sk[lo] == key
  int64_t hi = j + 1;      // sk[hi] != key, or hi == m
  int64_t step = 1;
  while (hi < m && sk[hi] == key) {
    lo = hi;
    step <<= 1;
    hi = j + step;
  }
  if (hi > m) hi = m;
  while (hi - lo > 1) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (sk[mid] == key) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return static_cast<int>(hi - j);
}

// Files every run of equal rows by length class (K3 cuts those longer
// than `split` into chunks); block 0 zeroes the sort's histogram (its
// last use was this call's last pass).
__global__ void __launch_bounds__(kThreads)
seg_list(const __grid_constant__ Params p) {
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < kMaxPasses * kBins; i += kThreads) {
      p.hist[i] = 0;
    }
  }
  const uint32_t* sk = p.keys[p.passes & 1];
  const int64_t m = p.words[kWordKept];
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t wb = (static_cast<int64_t>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5)) * 32;
       wb < m; wb += warps * 32) {
    const int64_t j = wb + lane;
    int cls = -1;
    int len = 0;
    if (j < m) {
      const uint32_t key = sk[j];
      if (j == 0 || sk[j - 1] != key) {
        len = run_length(sk, j, m, key);
        if (p.split > 0 && len > p.split) {
          const int c = (len + p.split - 1) / p.split;
          const int b = atomicAdd(&p.words[kWordChunks], c);
          for (int q = 0; q < c; ++q) {
            const int off = q * p.split;
            p.chunks[b + q] = make_int2(static_cast<int>(j) + off,
                                        min(p.split, len - off));
          }
          p.combs[atomicAdd(&p.words[kWordCombs], 1)] = make_int2(b, c);
        } else {
          cls = 31 - __clz(len);
        }
      }
    }
    // one counter add per class a warp
    const unsigned peers = __match_any_sync(0xffffffffu, cls);
    const int leader = __ffs(peers) - 1;
    int slot = 0;
    if (cls >= 0 && lane == leader) {
      slot = atomicAdd(&p.words[kWordClass + cls], __popc(peers));
    }
    slot = __shfl_sync(0xffffffffu, slot, leader);
    if (cls >= 0) {
      p.items[p.class_off[cls] + slot + __popc(peers & lt)] =
          make_int2(static_cast<int>(j), len);
    }
  }
}

// ----------------------------------------------------------------- rows

template <typename Ts, typename Tv, int kMode>
struct Chain {
  float nl;
  bool cast;
  bool dev;
  // one stream row's update of one element
  __device__ __forceinline__ float update(float x) const {
    // Adagrad: vals are in A and the sum's lr is -1, so K3's
    // rA(1 * rA(x)) is x (a NaN's payload aside: the add below makes it
    // the canonical NaN K3 gives)
    if (kMode == kModeAdagrad) return x;
    if (kMode == kModeK18) {
      // x is a bf16 value already when the update rows are bf16
      return __fmul_rn(nl, sizeof(typename Tv::E) == 2 ? x : bf16_round(x));
    }
    if (cast) return Ts::rnd(__fmul_rn(nl, Ts::rnd(x)));
    const float q = __fmul_rn(nl, x);
    return Ts::rnd(dev ? q : Tv::rnd(q));
  }
  // the row's value after adding u: K3 rounds every add to the slab
  // dtype, K18 keeps float32 until the row is written
  __device__ __forceinline__ float add(float acc, float u) const {
    if (kMode == kModeAdagrad) return Tv::rnd(__fadd_rn(acc, u));
    return kMode == kModeK18 ? __fadd_rn(acc, u) : Ts::rnd(__fadd_rn(acc, u));
  }
};

// load / store E consecutive elements (E = 4: one vector access)
template <int E, typename T>
__device__ __forceinline__ void load_e(T* dst, const T* src) {
  if constexpr (E == 4 && sizeof(T) == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(src));
    memcpy(dst, &t, 16);
  } else if constexpr (E == 4 && sizeof(T) == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(src));
    memcpy(dst, &t, 8);
  } else {
    static_assert(E == 1, "load_e: 1 or 4 elements");
    dst[0] = src[0];
  }
}

template <int E, typename T>
__device__ __forceinline__ void store_e(T* dst, const T* src) {
  if constexpr (E == 4 && sizeof(T) == 4) {
    float4 t;
    memcpy(&t, src, 16);
    *reinterpret_cast<float4*>(dst) = t;
  } else if constexpr (E == 4 && sizeof(T) == 2) {
    uint2 t;
    memcpy(&t, src, 8);
    *reinterpret_cast<uint2*>(dst) = t;
  } else {
    dst[0] = src[0];
  }
}

// The Adagrad mode's epilogue: E columns from c0 of `row`, whose summed
// gradient g (in A, the vals' dtype Ta) is complete, through the
// transition into the accumulator and the slab. One unit owns these
// elements in the launch, so the read-only cache may serve their loads.
// The loads come after the sum: loading them before it, to hide their
// latency behind the sum, measured slower (PERF.md, Findings).
template <typename Ts, typename Ta, int E>
__device__ __forceinline__ void adagrad_apply(const Params& p, uint32_t row,
                                              int c0, const float* g) {
  using SE = typename Ts::E;
  using AE = typename Ta::E;
  const int64_t off = static_cast<int64_t>(row) * p.width + c0;
  SE s[E];
  AE a[E];
  load_e<E>(s, static_cast<const SE*>(p.slab) + off);
  load_e<E>(a, static_cast<const AE*>(p.acc) + off);
  const bool on_card = p.lr_on_card != 0;
  const float lr = on_card ? __ldg(p.lr) : p.ada_lr;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    float upd;
    const float na = detpu::adagrad_transition<Ts, Ta>(
        Ta::load(a[e]), g[e], lr, on_card, p.eps, &upd);
    a[e] = Ta::store(na);
    s[e] = Ts::store(__fsub_rn(Ts::load(s[e]), upd));
  }
  store_e<E>(static_cast<AE*>(p.acc) + off, a);
  store_e<E>(static_cast<SE*>(p.slab) + off, s);
}

template <typename Ts, typename Tv, int kMode>
__device__ __forceinline__ Chain<Ts, Tv, kMode> chain_of(const Params& p) {
  Chain<Ts, Tv, kMode> ch;
  ch.nl = p.lr_on_card ? -__ldg(p.lr) : p.neg_lr;
  ch.cast = p.cast_vals != 0;
  ch.dev = p.lr_on_card != 0;
  return ch;
}

// One unit of the group path: the `len` sorted entries from `start`, the
// lane's E columns of column block cb. partial == nullptr: into the slab
// row (the Adagrad mode: into a zero row in registers, then through the
// epilogue); else (a K3 or Adagrad chunk) into that float32 partial row.
template <typename Ts, typename Tv, int kMode, int E>
__device__ __forceinline__ void group_unit(
    const Params& p, const Chain<Ts, Tv, kMode>& ch, const uint32_t* sk,
    const int* sp, int start, int len, int cb, int lane_g, float* partial) {
  using SE = typename Ts::E;
  using VE = typename Tv::E;
  const int c0 = cb * (32 * E) + lane_g * E;
  if (c0 >= p.width) return;
  const int64_t w = p.width;
  const VE* vals = static_cast<const VE*>(p.vals);
  SE* row = static_cast<SE*>(p.slab) + static_cast<int64_t>(sk[start]) * w +
            c0;
  float acc[E];
  if (partial == nullptr) {
    if constexpr (kMode == kModeAdagrad) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.0f;
    } else {
      SE s[E];
      load_e<E>(s, row);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = Ts::load(s[e]);
    }
  }
  int pn[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) pn[b] = b < len ? sp[start + b] : -1;
  bool first = partial != nullptr;
  for (int k = 0; k < len; k += kBatch) {
    int pc[kBatch];
    VE raw[kBatch][E];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      pc[b] = pn[b];
      if (pc[b] >= 0) {
        load_e<E>(raw[b], vals + static_cast<int64_t>(pc[b]) * w + c0);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = k + kBatch + b;
      pn[b] = q < len ? sp[start + q] : -1;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (pc[b] >= 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float u = ch.update(Tv::load(raw[b][e]));
          if (partial != nullptr) {
            acc[e] = first ? u : __fadd_rn(acc[e], u);
          } else {
            acc[e] = ch.add(acc[e], u);
          }
        }
        first = false;
      }
    }
  }
  if (partial != nullptr) {
    store_e<E>(partial + c0, acc);
  } else if constexpr (kMode == kModeAdagrad) {
    adagrad_apply<Ts, Tv, E>(p, sk[start], c0, acc);
  } else {
    SE s[E];
#pragma unroll
    for (int e = 0; e < E; ++e) s[e] = Ts::store(acc[e]);
    store_e<E>(row, s);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// K18's block path: one long segment's 32-column block. All threads
// stream its update rows into the ring (stage t % kStages holds tile t
// of kTE entries); warp 0 runs the column chains, lane c column c. Each
// thread's stream positions for a tile are loaded one tile ahead of its
// copies, so no copy waits on a position load.
template <typename Tv>
__device__ void block_unit(const Params& p, float nl, const uint32_t* sk,
                           const int* sp, int start, int len, int cb,
                           unsigned char* ring) {
  using VE = typename Tv::E;
  constexpr int kEsz = static_cast<int>(sizeof(VE));
  constexpr int kTE = kStageBytes / (kBlockCols * kEsz);  // entries a stage
  constexpr int kParts = kBlockCols * kEsz / 16;          // 16-B parts
  constexpr int kPer = (kTE * kParts + kThreads - 1) / kThreads;
  const int64_t w = p.width;
  const int col0 = cb * kBlockCols;
  const int ncols = min(kBlockCols, p.width - col0);
  const int ntiles = (len + kTE - 1) / kTE;
  const VE* vals = static_cast<const VE*>(p.vals) + col0;
  uint16_t* row = static_cast<uint16_t*>(p.slab) +
                  static_cast<int64_t>(sk[start]) * w + col0;
  const bool mine = threadIdx.x < ncols;
  float acc = mine ? BF16::load(row[threadIdx.x]) : 0.f;
  // the positions of this thread's parts of tile t (-1: none)
  auto positions = [&](int t, int* pos) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * kThreads;
      const int e = t * kTE + q / kParts;
      const int col = (q % kParts) * (16 / kEsz);
      pos[i] = t < ntiles && q < kTE * kParts && e < len && col < ncols
                   ? sp[start + e] : -1;
    }
  };
  auto issue = [&](int t, const int* pos) {
    VE* st = reinterpret_cast<VE*>(ring + (t % kStages) * kStageBytes);
    if (p.vec16) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int q = threadIdx.x + i * kThreads;
        if (pos[i] >= 0) {
          const int col = (q % kParts) * (16 / kEsz);
          cp_async16(st + (q / kParts) * kBlockCols + col,
                     vals + static_cast<int64_t>(pos[i]) * w + col);
        }
      }
    } else if (t < ntiles) {
      const int e0 = t * kTE;
      const int te = min(kTE, len - e0);
      for (int q = threadIdx.x; q < te * kBlockCols; q += kThreads) {
        const int e = q / kBlockCols;
        const int col = q % kBlockCols;
        if (col < ncols) {
          st[e * kBlockCols + col] =
              vals[static_cast<int64_t>(sp[start + e0 + e]) * w + col];
        }
      }
    }
    cp_async_commit();
  };
  int pos[kPer];
  for (int t = 0; t < kStages - 1; ++t) {
    positions(t, pos);
    issue(t, pos);
  }
  positions(kStages - 1, pos);
  for (int t = 0; t < ntiles; ++t) {
    issue(t + kStages - 1, pos);     // positions loaded a tile ago
    positions(t + kStages, pos);     // the next tile's, in flight now
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (mine) {
      const VE* st = reinterpret_cast<const VE*>(ring +
                                                 (t % kStages) * kStageBytes);
      const int te = min(kTE, len - t * kTE);
      // kChain entries read from shared memory before they are added: the
      // adds are the only dependent chain
      constexpr int kChain = 16;
      int e = 0;
      for (; e + kChain <= te; e += kChain) {
        VE x[kChain];
#pragma unroll
        for (int b = 0; b < kChain; ++b) {
          x[b] = st[(e + b) * kBlockCols + threadIdx.x];
        }
#pragma unroll
        for (int b = 0; b < kChain; ++b) {
          acc = __fadd_rn(acc, __fmul_rn(nl, vals_bf16<Tv>(x[b])));
        }
      }
      for (; e < te; ++e) {
        acc = __fadd_rn(acc, __fmul_rn(
            nl, vals_bf16<Tv>(st[e * kBlockCols + threadIdx.x])));
      }
    }
    __syncthreads();
  }
  if (mine) row[threadIdx.x] = BF16::store(acc);
}

// Virtual work lists, longest first: entry k covers units
// [begin[k], begin[k + 1]) of list cls[k] (-1: K3's chunks).
struct Lists {
  long long begin[kClasses + 2];
  int cls[kClasses + 1];
  int count;
};

// Units of the group path: K3's chunks, then the classes below
// long_class in descending order, each item times ncb column blocks.
__device__ __forceinline__ void group_lists(const Params& p, Lists* l) {
  long long v = 0;
  int k = 0;
  if (p.split > 0) {
    l->begin[k] = v;
    l->cls[k] = -1;
    v += static_cast<long long>(p.words[kWordChunks]) * p.ncb;
    ++k;
  }
  for (int c = min(p.long_class, kClasses) - 1; c >= 0; --c) {
    l->begin[k] = v;
    l->cls[k] = c;
    v += static_cast<long long>(p.words[kWordClass + c]) * p.ncb;
    ++k;
  }
  l->begin[k] = v;
  l->count = k;
}

// the list entry holding unit v (binary search: the last begin <= v)
__device__ __forceinline__ int list_of(const Lists& l, long long v) {
  int lo = 0, hi = l.count;  // begin[lo] <= v < begin[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (l.begin[mid] <= v) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename Ts, typename Tv, int kMode, int E>
__global__ void __launch_bounds__(kThreads)
seg_rows(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ Lists s_lists;
  const uint32_t* sk = p.keys[p.passes & 1];
  const int* sp = p.pos[p.passes & 1];
  const auto ch = chain_of<Ts, Tv, kMode>(p);
  if constexpr (kMode == kModeK18) {
    // the long segments first, a block a 32-column block, longest first
    __shared__ long long s_long[kClasses + 1];
    __shared__ int s_long_cls[kClasses];
    __shared__ int s_nlong;
    const int ncb32 = (p.width + kBlockCols - 1) / kBlockCols;
    if (threadIdx.x == 0) {
      long long v = 0;
      int k = 0;
      for (int c = kClasses - 1; c >= p.long_class; --c) {
        s_long[k] = v;
        s_long_cls[k] = c;
        v += static_cast<long long>(p.words[kWordClass + c]) * ncb32;
        ++k;
      }
      s_long[k] = v;
      s_nlong = k;
    }
    __syncthreads();
    const long long total = s_long[s_nlong];
    for (long long v = blockIdx.x; v < total; v += gridDim.x) {
      int k = 0;
      while (s_long[k + 1] <= v) ++k;
      const long long u = v - s_long[k];
      const int c = s_long_cls[k];
      const int2 it = p.items[p.class_off[c] + u / ncb32];
      block_unit<Tv>(p, ch.nl, sk, sp, it.x, it.y,
                     static_cast<int>(u % ncb32), ring);
    }
  }
  if (threadIdx.x == 0) group_lists(p, &s_lists);
  __syncthreads();
  const long long total = s_lists.begin[s_lists.count];
  const int lane_g = threadIdx.x & ((1 << p.g_log2) - 1);
  const long long ngroups =
      (static_cast<long long>(gridDim.x) * kThreads) >> p.g_log2;
  for (long long v = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) >> p.g_log2;
       v < total; v += ngroups) {
    const int k = list_of(s_lists, v);
    const long long u = v - s_lists.begin[k];
    const long long idx = u / p.ncb;
    const int cb = static_cast<int>(u % p.ncb);
    const int c = s_lists.cls[k];
    if (c < 0) {  // a K3 chunk: into its partial row
      const int2 it = p.chunks[idx];
      group_unit<Ts, Tv, kMode, E>(p, ch, sk, sp, it.x, it.y, cb, lane_g,
                                   p.partials + idx * p.width);
    } else {
      const int2 it = p.items[p.class_off[c] + idx];
      group_unit<Ts, Tv, kMode, E>(p, ch, sk, sp, it.x, it.y, cb, lane_g,
                                   nullptr);
    }
  }
}

// K3's long segments: each row gets its chunks' partials in chunk order,
// every add rounded to the slab dtype (the Adagrad mode: into a zero row
// in registers, every add rounded to A, then through the epilogue).
template <typename Ts, typename Tv, int kMode, int E>
__global__ void __launch_bounds__(kThreads)
seg_combine(const __grid_constant__ Params p) {
  using SE = typename Ts::E;
  const uint32_t* sk = p.keys[p.passes & 1];
  const long long total =
      static_cast<long long>(p.words[kWordCombs]) * p.ncb;
  const int lane_g = threadIdx.x & ((1 << p.g_log2) - 1);
  const long long ngroups =
      (static_cast<long long>(gridDim.x) * kThreads) >> p.g_log2;
  const int64_t w = p.width;
  for (long long v = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) >> p.g_log2;
       v < total; v += ngroups) {
    const int2 cm = p.combs[v / p.ncb];
    const int c0 = static_cast<int>(v % p.ncb) * (32 * E) + lane_g * E;
    if (c0 >= p.width) continue;
    const uint32_t key = sk[p.chunks[cm.x].x];
    SE* row = static_cast<SE*>(p.slab) + static_cast<int64_t>(key) * w + c0;
    SE s[E];
    float acc[E];
    if constexpr (kMode == kModeAdagrad) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.0f;
    } else {
      load_e<E>(s, row);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = Ts::load(s[e]);
    }
    for (int q0 = 0; q0 < cm.y; q0 += kCombBatch) {
      float part[kCombBatch][E];
#pragma unroll
      for (int b = 0; b < kCombBatch; ++b) {
        if (q0 + b < cm.y) {
          load_e<E>(part[b], p.partials +
                                 static_cast<int64_t>(cm.x + q0 + b) * w + c0);
        }
      }
#pragma unroll
      for (int b = 0; b < kCombBatch; ++b) {
        if (q0 + b < cm.y) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            acc[e] = kMode == kModeAdagrad
                         ? Tv::rnd(__fadd_rn(acc[e], part[b][e]))
                         : Ts::rnd(__fadd_rn(acc[e], part[b][e]));
          }
        }
      }
    }
    if constexpr (kMode == kModeAdagrad) {
      adagrad_apply<Ts, Tv, E>(p, key, c0, acc);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) s[e] = Ts::store(acc[e]);
      store_e<E>(row, s);
    }
  }
}

// ------------------------------------------------------------------ host

int64_t align256(int64_t b) { return (b + 255) / 256 * 256; }

int64_t tiles_of(int64_t n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }

// places of the chunk lists: sum ceil(len / split) over segments longer
// than split is below 2n / split + 1
int64_t chunk_cap(int64_t n, int split) {
  return split > 0 ? 2 * n / split + 2 : 0;
}

int64_t comb_cap(int64_t n, int split) {
  return split > 0 ? n / split + 2 : 0;
}

int64_t item_cap(int64_t n) {
  int64_t c = 0;
  for (int k = 0; k < kClasses; ++k) c += n >> k;
  return c > 0 ? c : 1;
}

// Carves the scratch of a call of n ids (base null: only its size).
int64_t carve(void* base, int64_t n, int width, int split, Params* p) {
  const int64_t tiles = tiles_of(n);
  const int64_t sizes[] = {
      kMaxPasses * kBins * 4, kWords * 4, 8, tiles * kBins * 8,
      n * 4, n * 4, n * 4, n * 4, item_cap(n) * 8, chunk_cap(n, split) * 8,
      comb_cap(n, split) * 8, chunk_cap(n, split) * width * 4};
  constexpr int kParts = sizeof(sizes) / sizeof(sizes[0]);
  char* ptrs[kParts];
  int64_t off = 0;
  for (int i = 0; i < kParts; ++i) {
    ptrs[i] = base == nullptr ? nullptr : static_cast<char*>(base) + off;
    off += align256(sizes[i]);
  }
  if (p != nullptr) {
    p->hist = reinterpret_cast<int*>(ptrs[0]);
    p->words = reinterpret_cast<int*>(ptrs[1]);
    p->ticket = reinterpret_cast<unsigned long long*>(ptrs[2]);
    p->status = reinterpret_cast<unsigned long long*>(ptrs[3]);
    p->keys[0] = reinterpret_cast<uint32_t*>(ptrs[4]);
    p->keys[1] = reinterpret_cast<uint32_t*>(ptrs[5]);
    p->pos[0] = reinterpret_cast<int*>(ptrs[6]);
    p->pos[1] = reinterpret_cast<int*>(ptrs[7]);
    p->items = reinterpret_cast<int2*>(ptrs[8]);
    p->chunks = reinterpret_cast<int2*>(ptrs[9]);
    p->combs = reinterpret_cast<int2*>(ptrs[10]);
    p->partials = reinterpret_cast<float*>(ptrs[11]);
  }
  return off;
}

// bits of the largest row, rounded up to whole digits (at least one pass:
// the first pass is also the compaction)
int passes_of(int64_t rows) {
  int bits = 0;
  while (bits < 32 && ((rows - 1) >> bits) != 0) ++bits;
  const int passes = (bits + 7) / 8;
  return passes > 0 ? passes : 1;
}

// Validates one call's layout and fills the prepared launch (scratch
// zeroed by the caller before the first launch, then kept for this
// prepared launch alone: one stream at a time).
cudaError_t prepare(int64_t rows, int width, int slab_dtype, int vals_dtype,
                    int ids64, int64_t n, int mode, int cast_vals,
                    float neg_lr, int lr_on_card, int split, void* scratch,
                    Params* out) {
  if (rows <= 0 || rows > 0xffffffffLL || width <= 0 || n < 0 ||
      n > 0x7fffffffLL || (slab_dtype != 0 && slab_dtype != 1) ||
      (vals_dtype != 0 && vals_dtype != 1) || split < 0 ||
      (n > 0 && scratch == nullptr) ||
      reinterpret_cast<uintptr_t>(scratch) % 256 != 0) {
    return cudaErrorInvalidValue;
  }
  if (tiles_of(n) > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  memset(out, 0, sizeof(Params));
  out->rows = rows;
  out->n = n;
  out->tiles = tiles_of(n);
  out->width = width;
  out->slab_dtype = slab_dtype;
  out->vals_dtype = vals_dtype;
  out->ids64 = ids64 != 0;
  out->cast_vals = cast_vals != 0;
  out->lr_on_card = lr_on_card != 0;
  out->neg_lr = neg_lr;
  out->passes = passes_of(rows);
  out->split = split;
  out->long_class = mode == kModeK18 ? kLongClass : kClasses;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&out->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (n > 0) carve(scratch, n, width, split, out);
  int64_t off = 0;
  for (int c = 0; c < kClasses; ++c) {
    out->class_off[c] = off;
    off += n >> c;
  }
  return cudaSuccess;
}

template <typename K>
int resident_blocks(K kernel, int dyn, int sms) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                dyn);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// the group path's shape for this call's alignment
void shape_groups(Params* p) {
  const int e = p->vec ? 4 : 1;
  const int lanes = (min(p->width, 32 * e) + e - 1) / e;
  int g = 0;
  while ((1 << g) < lanes) ++g;
  p->g_log2 = g;
  p->ncb = (p->width + 32 * e - 1) / (32 * e);
}

bool aligned(const void* a, int bytes) {
  return reinterpret_cast<uintptr_t>(a) % bytes == 0;
}

// The sort and the segment lists: everything before the rows pass.
// The histogram and the digit passes under the key policy KeyOf.
template <typename KeyOf>
cudaError_t sort_keys(const Params& p, cudaStream_t st) {
  const int64_t hist_blocks = min(static_cast<int64_t>(p.sms) * 4,
                                  (p.n + kThreads * 8 - 1) / (kThreads * 8));
  seg_hist<KeyOf><<<static_cast<unsigned>(hist_blocks), kThreads, 0, st>>>(
      p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const unsigned tiles = static_cast<unsigned>(p.tiles);
  seg_sort_pass<KeyOf, true><<<tiles, kThreads, 0, st>>>(p, 0);
  e = cudaGetLastError();
  for (int q = 1; q < p.passes && e == cudaSuccess; ++q) {
    seg_sort_pass<KeyOf, false><<<tiles, kThreads, 0, st>>>(p, q);
    e = cudaGetLastError();
  }
  return e;
}

template <typename IdT>
cudaError_t sort_and_list(const Params& p, cudaStream_t st) {
  cudaError_t e = sort_keys<RowKey<IdT>>(p, st);
  if (e != cudaSuccess) return e;
  const int64_t list_blocks = min(static_cast<int64_t>(p.sms) * 8,
                                  (p.n + kThreads - 1) / kThreads);
  seg_list<<<static_cast<unsigned>(list_blocks), kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace
