// A stable LSD radix sort of unsigned keys, 8 bits a pass, with an
// optional int payload, and the device-wide exclusive scan it runs on,
// for Hopper (sm_90a). Shared by K5 (dedup.cu: (key, position) pairs)
// and K14 (sketch.cu: keys only).
//
// A pass is per-tile digit histograms (shared-memory atomics), an
// exclusive scan over the digit-major [256, tiles] counts (three
// launches: tile sums, one block over those, tile scans), and a stable
// scatter in which each warp ranks its items with __match_any_sync and
// per-warp digit counters, and the block adds the earlier warps' counts
// and the tile's global offset. Signed ids sort as unsigned keys with
// their sign bit flipped (Key<IdT>).
//
// Everything here is in an anonymous namespace: each source that
// includes it is its own library (ops/_kernels.py), and the kernels keep
// the names a profile shows for them ("(anonymous namespace)::
// radix_hist").

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;             // 8-bit digits
constexpr int kWarps = 8;              // warps per radix block
constexpr int kThreads = kWarps * 32;
constexpr int kItemsPerLane = 8;
constexpr int kWarpItems = 32 * kItemsPerLane;
constexpr int kTile = kWarps * kWarpItems;  // 2048 pairs per radix block
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;

__host__ __device__ inline int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <typename IdT>
struct Key;

template <>
struct Key<int32_t> {
  using U = uint32_t;
  __device__ static U of(int32_t v) {
    return static_cast<uint32_t>(v) ^ 0x80000000u;
  }
  __device__ static int32_t id(U k) {
    return static_cast<int32_t>(k ^ 0x80000000u);
  }
};

template <>
struct Key<int64_t> {
  using U = unsigned long long;
  __device__ static U of(int64_t v) {
    return static_cast<unsigned long long>(v) ^ (1ull << 63);
  }
  __device__ static int64_t id(U k) {
    return static_cast<int64_t>(k ^ (1ull << 63));
  }
};

template <typename U>
__global__ void __launch_bounds__(kThreads)
radix_hist(const U* __restrict__ keys, int64_t n, int shift,
           int* __restrict__ hist, int ntiles) {
  __shared__ int sh[kBins];
  for (int d = threadIdx.x; d < kBins; d += kThreads) sh[d] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int64_t j = base + i;
    if (j < n) {
      atomicAdd(&sh[static_cast<int>((keys[j] >> shift) & (kBins - 1))], 1);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kBins; d += kThreads) {
    hist[static_cast<int64_t>(d) * ntiles + blockIdx.x] = sh[d];
  }
}

// Exclusive scan of one int per thread across a block of kScanThreads;
// *total gets the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;  // inclusive scan within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[31];
  return x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// A device-wide exclusive scan in three launches: per-tile sums
// (scan_reduce), one block scanning those (scan_partials, which also
// writes the total), and per-tile scans plus the tile's offset
// (scan_apply). A tile is kScanThreads x kScanItems consecutive ints,
// each thread owning kScanItems of them.
__global__ void __launch_bounds__(kScanThreads)
scan_reduce(const int* __restrict__ data, int64_t m,
            int* __restrict__ partials) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile +
                       static_cast<int64_t>(threadIdx.x) * kScanItems;
  int s = 0;
#pragma unroll
  for (int q = 0; q < kScanItems; ++q) {
    if (base + q < m) s += data[base + q];
  }
  int total;
  block_exclusive_scan(s, warp_sums, &total);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// In-place exclusive scan of the m tile sums by one block; *total gets
// their sum. Each thread scans a contiguous run (m is small).
__global__ void __launch_bounds__(kScanThreads)
scan_partials(int* __restrict__ data, int64_t m, int* __restrict__ total) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int64_t per = (m + kScanThreads - 1) / kScanThreads;
  const int64_t lo = min64(m, threadIdx.x * per);
  const int64_t hi = min64(m, lo + per);
  int s = 0;
  for (int64_t i = lo; i < hi; ++i) s += data[i];
  int sum;
  int run = block_exclusive_scan(s, warp_sums, &sum);
  for (int64_t i = lo; i < hi; ++i) {
    const int v = data[i];
    data[i] = run;
    run += v;
  }
  if (threadIdx.x == 0 && total != nullptr) *total = sum;
}

__global__ void __launch_bounds__(kScanThreads)
scan_apply(int* __restrict__ data, int64_t m,
           const int* __restrict__ partials) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile +
                       static_cast<int64_t>(threadIdx.x) * kScanItems;
  int v[kScanItems];
  int s = 0;
#pragma unroll
  for (int q = 0; q < kScanItems; ++q) {
    v[q] = base + q < m ? data[base + q] : 0;
    s += v[q];
  }
  int total;
  int run = block_exclusive_scan(s, warp_sums, &total) + partials[blockIdx.x];
#pragma unroll
  for (int q = 0; q < kScanItems; ++q) {
    if (base + q < m) data[base + q] = run;
    run += v[q];
  }
}

int64_t scan_tiles(int64_t m) { return (m + kScanTile - 1) / kScanTile; }

// data[0, m) <- its exclusive scan; *total (nullable) <- its sum.
cudaError_t exclusive_scan(int* data, int64_t m, int* partials, int* total,
                           cudaStream_t st) {
  const int64_t tiles = scan_tiles(m);
  scan_reduce<<<static_cast<unsigned>(tiles), kScanThreads, 0, st>>>(
      data, m, partials);
  scan_partials<<<1, kScanThreads, 0, st>>>(partials, tiles, total);
  scan_apply<<<static_cast<unsigned>(tiles), kScanThreads, 0, st>>>(
      data, m, partials);
  return cudaGetLastError();
}

// Stable scatter of one radix pass; offsets is the scanned histogram.
// kPairs: the keys carry an int payload (pos_in / pos_out); otherwise
// those are null and only the keys move.
template <typename U, bool kPairs>
__global__ void __launch_bounds__(kThreads)
radix_scatter(const U* __restrict__ keys_in, const int* __restrict__ pos_in,
              U* __restrict__ keys_out, int* __restrict__ pos_out, int64_t n,
              int shift, const int* __restrict__ offsets, int ntiles) {
  __shared__ int wh[kWarps][kBins];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int d = lane; d < kBins; d += 32) wh[warp][d] = 0;
  __syncwarp();
  const unsigned lt = (1u << lane) - 1u;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile +
                       static_cast<int64_t>(warp) * kWarpItems;
  U key[kItemsPerLane];
  int val[kItemsPerLane];
  int dig[kItemsPerLane];
  int rank[kItemsPerLane];
#pragma unroll
  for (int k = 0; k < kItemsPerLane; ++k) {
    const int64_t j = base + k * 32 + lane;
    const bool ok = j < n;
    int d = -1;
    key[k] = 0;
    val[k] = 0;
    if (ok) {
      key[k] = keys_in[j];
      if constexpr (kPairs) val[k] = pos_in[j];
      d = static_cast<int>((key[k] >> shift) & (kBins - 1));
    }
    dig[k] = d;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    int r = 0;
    if (ok) r = wh[warp][d] + __popc(peers & lt);
    __syncwarp();
    if (ok && (peers & lt) == 0u) wh[warp][d] += __popc(peers);
    __syncwarp();
    rank[k] = r;
  }
  __syncthreads();
  // per digit: the tile's global offset plus the earlier warps' counts
  for (int d = threadIdx.x; d < kBins; d += kThreads) {
    int run = offsets[static_cast<int64_t>(d) * ntiles + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) {
      const int c = wh[w][d];
      wh[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItemsPerLane; ++k) {
    if (dig[k] >= 0) {
      const int p = wh[warp][dig[k]] + rank[k];
      keys_out[p] = key[k];
      if constexpr (kPairs) pos_out[p] = val[k];
    }
  }
}


int64_t ntiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

// Ints of scratch radix_sort needs beside its key (and payload) buffers:
// the digit histograms, then the scan's tile sums.
int64_t radix_hist_ints(int64_t n) { return kBins * ntiles_of(n); }
int64_t radix_partial_ints(int64_t n) {
  return scan_tiles(radix_hist_ints(n)) + 1;
}

// Sorts n < 2^31 keys in keys[0] (and, with kPairs, their payload in
// pos[0]) on their low `bits` bits (a multiple of 8), stably, through
// the double buffers keys[0..1] / pos[0..1]; *cur gets the index of the
// buffer that holds the result. hist: radix_hist_ints(n) ints; partials:
// radix_partial_ints(n) ints.
template <typename U, bool kPairs>
cudaError_t radix_sort(U* keys[2], int* pos[2], int64_t n, int bits,
                       int* hist, int* partials, cudaStream_t st, int* cur) {
  const int64_t ntiles = ntiles_of(n);
  if (ntiles > 0x7fffffffLL / kBins) return cudaErrorInvalidValue;
  int c = 0;
  for (int shift = 0; shift < bits; shift += 8) {
    radix_hist<U><<<static_cast<unsigned>(ntiles), kThreads, 0, st>>>(
        keys[c], n, shift, hist, static_cast<int>(ntiles));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = exclusive_scan(hist, kBins * ntiles, partials, nullptr, st);
    if (e != cudaSuccess) return e;
    radix_scatter<U, kPairs>
        <<<static_cast<unsigned>(ntiles), kThreads, 0, st>>>(
            keys[c], kPairs ? pos[c] : nullptr, keys[1 - c],
            kPairs ? pos[1 - c] : nullptr, n, shift, hist,
            static_cast<int>(ntiles));
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    c = 1 - c;
  }
  *cur = c;
  return cudaSuccess;
}

}  // namespace
