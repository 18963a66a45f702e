// K10: CSR bookkeeping of ragged id batches, for Hopper (sm_90a).
//
// Replaces the XLA-lowered index arithmetic of the JAX package's ragged
// path (ROADMAP queue B9):
//   distributed_embeddings_tpu/ops/embedding_lookup.py:row_to_split
//     COO row ids -> CSR row splits (a vectorized searchsorted);
//   distributed_embeddings_tpu/ops/embedding_lookup.py:ragged_row_ids
//     CSR splits -> the row of every value position (marks + cumsum);
//   distributed_embeddings_tpu/parallel/lookup.py:csr_seg
//     per-slot row lengths -> CSR splits (a cumsum per slot).
// They are the reference library's RowToSplit and
// OffsetToWeightsAndRowId (embedding_lookup_kernels.cu:331-361).
//
// Bound: bytes, and small. At the ragged DLRM's shapes (26 slots of
// 65,536 rows, ~1.02M ids a slot) lengths -> splits reads 6.8 MB and
// writes 13.6 MB (0.0061 ms at 3.35 TB/s), row_to_split reads ~4-8 MB of
// COO rows and writes 65,537 splits (~0.0013 ms), ragged_row_ids writes
// 26 x 1.02M positions (~0.0675 ms in int64). Integer work only: every
// result is exact whatever the order of execution. Design:
//   * lengths -> splits: a single-pass scan over tiles of 4,096 lengths
//     (256 threads x 16), 26 x 16 = 416 blocks at the DLRM shapes rather
//     than one block a slot. Neighbouring threads load neighbouring
//     lengths into shared memory (padded against bank conflicts), each
//     thread scans its own 16, a warp-shuffle block scan gives each run
//     its offset, and the tile's offset within its slot comes from a
//     decoupled look-back by one warp over the slot's earlier tiles, 32 a
//     round (an aggregate or an inclusive prefix a tile, published behind
//     a status word). Tiles take their index from a 64-bit counter in
//     launch order, so a tile only waits on tiles that already run. The
//     counter is never reset: its value also numbers the call, and the
//     status words carry that number, so a word left by an earlier call
//     reads as unpublished. No reset runs between calls, on the host or
//     in a CUDA-graph replay; the record zeroes its scratch once. Sums
//     are int64; a slot whose `valid` flag is 0 reads zero lengths, as
//     the JAX decode multiplies them by it.
//   * row_to_split and ragged_row_ids: one block-cooperative fill. Both
//     write value k over the half-open interval [B(k-1), B(k)) of the
//     output for k = 0..m, with B(-1) = 0 and B(m) = the output length:
//     row_to_split takes B(k) = clip(row_k + 1, 0, dim0 + 1) (so target
//     t gets the first k with row_k >= t: searchsorted side="left", with
//     negative rows and padding rows >= dim0 in place), ragged_row_ids
//     B(r) = clip(splits[r + 1], 0, cap) (position p gets the number of
//     clipped row ends at or before p; positions past the last end get
//     nrows). A block reads the boundaries of its 1,024 entries once,
//     coalesced, into shared memory and then writes its whole output
//     range [B(k0 - 1), B(k0 + 1023)) with neighbouring threads on
//     neighbouring positions, each position's value found by a binary
//     search in shared memory. No dependent chain of device loads is
//     left (the old kernels ran ~20 dependent loads a thread). For
//     boundaries that do not ascend (outside the contract, for JAX as
//     for the port) the block ranges still chain from 0 to the output
//     length, so every output entry is written, with a value in [0, m].
// Index arithmetic is int64 throughout.
//
// C interface (ctypes): detpu_*_prepare validates one call's layout and
// writes a prepared launch (detpu_csr_prepared_bytes() bytes of host
// memory the caller owns); detpu_csr_launch takes it with the per-call
// input and output pointers and the stream. Both return a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// ------------------------------------------------------ lengths -> splits

constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr int kScanTile = kScanThreads * kScanItems;
// one pad slot every kScanItems entries: a thread's 16 contiguous items
// then fall on distinct banks across a half warp
constexpr int kScanSmem = kScanTile + kScanTile / kScanItems;

__device__ __forceinline__ int padded(int i) { return i + i / kScanItems; }

// exclusive block-wide scan of one int64 per thread; returns the prefix
// and writes the block total to *total
__device__ int64_t block_exclusive_scan(int64_t x, int64_t* total) {
  __shared__ int64_t warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    constexpr int nw = kScanThreads / 32;
    int64_t s = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < nw) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const int64_t before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kScanThreads / 32 - 1];
  return before + incl - x;
}

// Tile status words. A call's tiles take indices t = counter++ from a
// 64-bit counter that is never reset: t % tiles is the tile and
// t / tiles the call's epoch e. A tile publishes (e + 1) * 4 + 1 once its
// aggregate is stored and (e + 1) * 4 + 2 once its inclusive prefix is,
// so a flag at or below (e + 1) * 4 is from an earlier call: nothing is
// reset between calls, on the host or in a CUDA-graph replay.
constexpr int64_t kAggregate = 1;
constexpr int64_t kInclusive = 2;

__device__ __forceinline__ void publish(int64_t* flag, int64_t* slot,
                                        int64_t v, int64_t state) {
  *reinterpret_cast<volatile int64_t*>(slot) = v;
  __threadfence();
  *reinterpret_cast<volatile int64_t*>(flag) = state;
}

__device__ __forceinline__ int64_t ld_volatile(const int64_t* p) {
  return *reinterpret_cast<const volatile int64_t*>(p);
}

// The exclusive prefix of tile `tile` (index j within its slot) whose
// own sum is `agg`: the decoupled look-back, run by one warp, 32 earlier
// tiles a round, back to the nearest inclusive prefix (tile 0 of the
// slot always publishes one). Every lane returns the prefix.
__device__ int64_t look_back(int64_t tile, int64_t j, int64_t agg,
                             int64_t mark, int64_t* flags,
                             int64_t* aggregate, int64_t* inclusive) {
  const int lane = threadIdx.x & 31;
  if (j == 0) {
    if (lane == 0) publish(flags + tile, inclusive + tile, agg,
                           mark + kInclusive);
    return 0;
  }
  if (lane == 0) publish(flags + tile, aggregate + tile, agg,
                         mark + kAggregate);
  const int64_t first = tile - j;  // the slot's tile 0
  int64_t prefix = 0;
  for (int64_t hi = tile - 1;; hi -= 32) {
    const int64_t p = hi - lane;
    const bool in = p >= first;
    int64_t f = 0;
    if (in) {
      do {
        f = ld_volatile(flags + p);
      } while (f <= mark);
    }
    __threadfence();
    const bool inc = !in || f == mark + kInclusive;
    const unsigned m = __ballot_sync(0xffffffffu, inc);
    const int stop = m ? __ffs(m) - 1 : 32;  // the nearest inclusive
    int64_t v = 0;
    if (in && lane <= stop) {
      v = f == mark + kInclusive ? ld_volatile(inclusive + p)
                                 : ld_volatile(aggregate + p);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
    prefix += __shfl_sync(0xffffffffu, v, 0);
    if (m) break;
  }
  if (lane == 0) publish(flags + tile, inclusive + tile, prefix + agg,
                         mark + kInclusive);
  return prefix;
}

template <typename LenT>
__global__ void __launch_bounds__(kScanThreads)
lengths_to_splits_kernel(const LenT* __restrict__ lengths,
                         int64_t slot_stride, int64_t b,
                         int64_t tiles_per_slot, const int* valid,
                         int64_t* __restrict__ splits, int64_t* flags,
                         int64_t* aggregate, int64_t* inclusive,
                         unsigned long long* counter) {
  __shared__ int64_t items[kScanSmem];
  __shared__ int64_t s_prefix;
  __shared__ unsigned long long s_ticket;
  // tiles in launch order: a tile waits only on tiles already running
  if (threadIdx.x == 0) s_ticket = atomicAdd(counter, 1ull);
  __syncthreads();
  const int64_t tiles = gridDim.x;
  const int64_t tile = static_cast<int64_t>(s_ticket % tiles);
  const int64_t mark = static_cast<int64_t>(s_ticket / tiles + 1) * 4;
  const int64_t slot = tile / tiles_per_slot;
  const int64_t j = tile - slot * tiles_per_slot;
  const int64_t start = j * kScanTile;
  const int64_t rest = b - start;
  const int count = rest < kScanTile ? static_cast<int>(rest > 0 ? rest : 0)
                                     : kScanTile;
  const bool live = valid == nullptr || valid[slot] != 0;
  const LenT* src = lengths + slot * slot_stride + start;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int i = k * kScanThreads + threadIdx.x;
    items[padded(i)] = (live && i < count)
                           ? static_cast<int64_t>(__ldg(src + i)) : 0;
  }
  __syncthreads();
  int64_t run[kScanItems];
  int64_t sum = 0;
  const int first = threadIdx.x * kScanItems;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    sum += items[padded(first + k)];
    run[k] = sum;
  }
  int64_t agg;
  const int64_t before = block_exclusive_scan(sum, &agg);
  if (threadIdx.x < 32) {
    const int64_t prefix = look_back(tile, j, agg, mark, flags, aggregate,
                                     inclusive);
    if (threadIdx.x == 0) s_prefix = prefix;
  }
  __syncthreads();
  const int64_t off = s_prefix + before;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) items[padded(first + k)] = off + run[k];
  __syncthreads();
  int64_t* out = splits + slot * (b + 1);
  if (j == 0 && threadIdx.x == 0) out[0] = 0;
  out += 1 + start;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int i = k * kScanThreads + threadIdx.x;
    if (i < count) out[i] = items[padded(i)];
  }
}

// ---------------------------------------- row_to_split / ragged_row_ids

constexpr int kFillThreads = 256;
constexpr int kFillEntries = 1024;  // entries (boundaries) a block

// B(k) of entry k in [0, m) of slot `slot`
template <typename InT, bool kRows>
__device__ __forceinline__ int64_t boundary(const InT* src, int64_t stride,
                                            int64_t slot_off, int64_t k,
                                            int64_t total) {
  const int64_t x = static_cast<int64_t>(__ldg(src + slot_off + k * stride));
  if (kRows) {  // row_to_split: clip(row + 1, 0, dim0 + 1)
    return x < 0 ? 0 : (x >= total - 1 ? total : x + 1);
  }
  return x < 0 ? 0 : (x > total ? total : x);  // clip(end, 0, cap)
}

// Writes value k over [B(k-1), B(k)) for k = 0..m of each slot, B(-1) = 0,
// B(m) = total: src holds the m boundaries of a slot at src[slot *
// src_slot + first + k * stride]; out [n_slots, total].
template <typename InT, typename OutT, bool kRows>
__global__ void __launch_bounds__(kFillThreads)
fill_kernel(const InT* __restrict__ src, int64_t stride, int64_t src_slot,
            int64_t first, int64_t m, int64_t total,
            OutT* __restrict__ out, int n_slots) {
  __shared__ int64_t bnd[kFillEntries + 1];  // bnd[i] = B(k0 - 1 + i)
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kFillEntries;
  const int64_t left = m + 1 - k0;
  const int c = left < kFillEntries ? static_cast<int>(left) : kFillEntries;
  for (int slot = blockIdx.y; slot < n_slots; slot += gridDim.y) {
    const int64_t soff = static_cast<int64_t>(slot) * src_slot + first;
    for (int i = threadIdx.x; i <= c; i += kFillThreads) {
      const int64_t k = k0 - 1 + i;
      bnd[i] = k < 0 ? 0
               : k >= m ? total
                        : boundary<InT, kRows>(src, stride, soff, k, total);
    }
    __syncthreads();
    OutT* o = out + static_cast<int64_t>(slot) * total;
    const int64_t hi = bnd[c];
    for (int64_t p = bnd[0] + threadIdx.x; p < hi; p += kFillThreads) {
      // the first i in [1, c] with B(k0 - 1 + i) > p
      int lo = 1, up = c;
      while (lo < up) {
        const int mid = (lo + up) >> 1;
        if (bnd[mid] > p) {
          up = mid;
        } else {
          lo = mid + 1;
        }
      }
      o[p] = static_cast<OutT>(k0 - 1 + lo);
    }
    __syncthreads();  // bnd is refilled for the next slot
  }
}

// ------------------------------------------------------ prepared launches

enum Kind : int { kLengths = 0, kRowToSplit = 1, kRowIds = 2 };

struct Prepared {
  int kind;
  int in64;
  int out64;
  int n_slots;
  int64_t stride;    // lengths: slot stride; rows: element stride
  int64_t m;         // lengths: b; rows: nnz; row ids: nrows
  int64_t total;     // rows: dim0 + 1; row ids: cap
  int64_t tiles;     // lengths: tiles a slot
  const int* valid;  // lengths: [n_slots] or null
  void* scratch;     // lengths: aggregate, inclusive, flags + counter
};

int64_t scan_tiles(int64_t b) {
  const int64_t t = (b + kScanTile - 1) / kScanTile;
  return t > 0 ? t : 1;
}

template <typename InT, typename OutT, bool kRows>
cudaError_t launch_fill(const Prepared& p, const void* src, void* dst,
                        int64_t stride, int64_t src_slot, int64_t first,
                        cudaStream_t st) {
  const int64_t gx = (p.m + 1 + kFillEntries - 1) / kFillEntries;
  const int gy = p.n_slots < 65535 ? p.n_slots : 65535;
  fill_kernel<InT, OutT, kRows>
      <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
         kFillThreads, 0, st>>>(static_cast<const InT*>(src), stride,
                                src_slot, first, p.m, p.total,
                                static_cast<OutT*>(dst), p.n_slots);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int64_t detpu_csr_prepared_bytes() {
  return static_cast<int64_t>(sizeof(Prepared));
}

// The lengths a scan tile covers.
extern "C" int64_t detpu_csr_scan_tile() { return kScanTile; }

// The scratch bytes of a lengths -> splits record: per tile an int64
// aggregate, inclusive prefix and status word, then the 64-bit tile
// counter. Zeroed once when it is made; no call resets it.
extern "C" int64_t detpu_lengths_to_splits_scratch_bytes(int n_slots,
                                                         int64_t b) {
  const int64_t tiles = static_cast<int64_t>(n_slots) * scan_tiles(b);
  return tiles * 24 + 8;
}

// lengths [n, b] with row stride slot_stride (elements), int32/int64;
// valid [n] int32 or null; splits [n, b + 1] int64 (the launch's dst);
// scratch: detpu_lengths_to_splits_scratch_bytes(n, b) bytes on the card,
// 8-byte aligned, zero before the first launch and then kept for this
// prepared launch alone (one stream at a time).
extern "C" int detpu_lengths_to_splits_prepare(int len_is_64,
                                               int64_t slot_stride,
                                               int n_slots, int64_t b,
                                               const void* valid,
                                               void* scratch, void* out) {
  if (n_slots < 0 || b < 0 || (n_slots > 1 && slot_stride < b) ||
      (n_slots > 0 && scratch == nullptr) ||
      reinterpret_cast<uintptr_t>(scratch) % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t tiles = static_cast<int64_t>(n_slots) * scan_tiles(b);
  if (tiles >= 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  Prepared* p = static_cast<Prepared*>(out);
  memset(p, 0, sizeof(Prepared));
  *p = Prepared{kLengths, len_is_64 != 0, 1, n_slots, slot_stride, b, b + 1,
                scan_tiles(b), static_cast<const int*>(valid), scratch};
  return cudaSuccess;
}

// rows: the COO row ids, element k at rows[k * stride] (stride 2 for
// [nnz, 2] indices), ascending; splits [dim0 + 1] (the launch's dst).
extern "C" int detpu_row_to_split_prepare(int rows_is_64, int64_t stride,
                                          int64_t nnz, int64_t dim0,
                                          int out_is_64, void* out) {
  if (nnz < 0 || dim0 < 0 || stride < 1) return cudaErrorInvalidValue;
  if ((nnz + 1 + kFillEntries - 1) / kFillEntries >= 0x7fffffffLL) {
    return cudaErrorInvalidConfiguration;
  }
  Prepared* p = static_cast<Prepared*>(out);
  memset(p, 0, sizeof(Prepared));
  *p = Prepared{kRowToSplit, rows_is_64 != 0, out_is_64 != 0, 1, stride,
                nnz, dim0 + 1, 0, nullptr, nullptr};
  return cudaSuccess;
}

// splits [n, nrows + 1] and out [n, cap] (the launch's src and dst), both
// int32 or both int64.
extern "C" int detpu_ragged_row_ids_prepare(int is64, int n_slots,
                                            int64_t nrows, int64_t cap,
                                            void* out) {
  if (n_slots < 0 || nrows < 0 || cap < 0) return cudaErrorInvalidValue;
  if ((nrows + 1 + kFillEntries - 1) / kFillEntries >= 0x7fffffffLL) {
    return cudaErrorInvalidConfiguration;
  }
  Prepared* p = static_cast<Prepared*>(out);
  memset(p, 0, sizeof(Prepared));
  *p = Prepared{kRowIds, is64 != 0, is64 != 0, n_slots, 1, nrows, cap, 0,
                nullptr, nullptr};
  return cudaSuccess;
}

// Launch a prepared K10 call on `stream`: src is the lengths, the COO
// rows or the splits, dst the splits or the row ids.
extern "C" int detpu_csr_launch(const void* prepared, const void* src,
                                void* dst, void* stream) {
  const Prepared* pp = static_cast<const Prepared*>(prepared);
  if (pp == nullptr) return cudaErrorInvalidValue;
  const Prepared& p = *pp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.n_slots == 0) return cudaSuccess;
  if (p.kind == kLengths) {
    const int64_t tiles = static_cast<int64_t>(p.n_slots) * p.tiles;
    int64_t* aggregate = static_cast<int64_t*>(p.scratch);
    int64_t* inclusive = aggregate + tiles;
    int64_t* flags = inclusive + tiles;
    auto* counter = reinterpret_cast<unsigned long long*>(flags + tiles);
    if (p.in64) {
      lengths_to_splits_kernel<int64_t>
          <<<static_cast<unsigned>(tiles), kScanThreads, 0, st>>>(
              static_cast<const int64_t*>(src), p.stride, p.m, p.tiles,
              p.valid, static_cast<int64_t*>(dst), flags, aggregate,
              inclusive, counter);
    } else {
      lengths_to_splits_kernel<int32_t>
          <<<static_cast<unsigned>(tiles), kScanThreads, 0, st>>>(
              static_cast<const int32_t*>(src), p.stride, p.m, p.tiles,
              p.valid, static_cast<int64_t*>(dst), flags, aggregate,
              inclusive, counter);
    }
    return cudaGetLastError();
  }
  if (p.total == 0) return cudaSuccess;
  if (p.kind == kRowToSplit) {
    if (p.in64) {
      return p.out64 ? launch_fill<int64_t, int64_t, true>(
                           p, src, dst, p.stride, 0, 0, st)
                     : launch_fill<int64_t, int32_t, true>(
                           p, src, dst, p.stride, 0, 0, st);
    }
    return p.out64 ? launch_fill<int32_t, int64_t, true>(
                         p, src, dst, p.stride, 0, 0, st)
                   : launch_fill<int32_t, int32_t, true>(
                         p, src, dst, p.stride, 0, 0, st);
  }
  if (p.kind == kRowIds) {
    // splits[slot, r + 1] is row r's end
    return p.in64 ? launch_fill<int64_t, int64_t, false>(
                        p, src, dst, 1, p.m + 1, 1, st)
                  : launch_fill<int32_t, int32_t, false>(
                        p, src, dst, 1, p.m + 1, 1, st);
  }
  return cudaErrorInvalidValue;
}
