// K5: sort + unique + segment-sum dedup of a sparse gradient stream, for
// Hopper (sm_90a).
//
// Replaces the XLA-lowered sort and segment-sum of the JAX package:
//   distributed_embeddings_tpu/ops/sparse_grad.py:dedup_sparse_grad
//   (body _dedup_sparse_grad: lax.sort_key_val, boundary flags, cumsum,
//   .at[seg].add / .at[seg].set)
// the pass the stateful optimizers (SparseAdagrad's sparse regime) run
// before their per-row read-modify-write. Given ids [n] and rows
// vals [n, w], it writes U = min(n, max_unique) outputs: position k below
// the number of distinct ids holds the k-th smallest distinct id and the
// fp32 sum of its rows (rounded once to the rows' dtype); the tail holds
// pad_id and zero rows.
//
// Bound: bytes. The sort moves each (key, position) pair through a few
// passes of 8 B read and written; the segment-sum reads every row once
// and writes each unique row once.
//
// Design, a simple kernel chain on the caller's stream, all scratch from
// one caller-allocated buffer (detpu_dedup_scratch_bytes):
// 1. Sort. A stable LSD radix sort of (key, position) pairs, 8 bits a
//    pass. The key is the id with its sign bit flipped, so unsigned order
//    is the ids' signed order and negative ids and ids past pad_id sort
//    where JAX's sort puts them; 32-bit ids take 4 passes (as the 27 bits
//    of a 70M-row slab would), 64-bit ids 8. A pass is per-tile digit
//    histograms (shared-memory atomics), an exclusive scan over the
//    digit-major [256, tiles] counts (three launches: tile sums, one
//    block over those, tile scans), and a stable scatter in which each
//    warp ranks its items with __match_any_sync and per-warp digit
//    counters, and the block adds the earlier warps' counts and the
//    tile's global offset.
// 2. Boundaries. One warp per chunk of 256 sorted rows counts the rows
//    whose key differs from the previous one; an exclusive scan of the
//    counts gives each chunk its first segment index and the number of
//    distinct ids.
// 3. Segment-sum, deterministic. One warp per chunk walks its rows in
//    sorted (stable) order, one lane per column, summing in fp32; a
//    segment that starts and ends in the chunk is written at once. A
//    segment that crosses chunk edges (a hot id repeated 50K times)
//    leaves its first piece and the pieces of the chunks it runs through
//    in fp32 scratch, and a fix-up pass adds them in chunk order (its warp
//    finds the last chunk with a ballot over 32 chunks at a time), so a
//    hot id's rows are summed by many warps yet in a fixed order.
// 4. The tail [num_unique, U) is filled with pad_id and zero rows.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;             // 8-bit digits
constexpr int kWarps = 8;              // warps per radix block
constexpr int kThreads = kWarps * 32;
constexpr int kItemsPerLane = 8;
constexpr int kWarpItems = 32 * kItemsPerLane;
constexpr int kTile = kWarps * kWarpItems;  // 2048 pairs per radix block
constexpr int kChunk = 256;            // sorted rows per segment-sum warp
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

struct F32 {
  using E = float;
  __device__ static float load(E v) { return v; }
  __device__ static E store(float f) { return f; }
};

struct BF16 {
  using E = uint16_t;  // raw bf16 bits
  __device__ static float load(E v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  __device__ static E store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

template <typename IdT>
__global__ void __launch_bounds__(256)
init_keys(const IdT* __restrict__ ids, int64_t n,
          typename Key<IdT>::U* __restrict__ keys, int* __restrict__ pos) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j < n) {
    keys[j] = Key<IdT>::of(ids[j]);
    pos[j] = static_cast<int>(j);
  }
}

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
template <typename U>
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
      val[k] = pos_in[j];
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
      pos_out[p] = val[k];
    }
  }
}

// Rows of chunk c whose key differs from the previous row's.
template <typename U>
__global__ void __launch_bounds__(256)
count_bounds(const U* __restrict__ sk, int64_t n, int* __restrict__ cnt,
             int64_t nchunks) {
  const int64_t c = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) >> 5;
  if (c >= nchunks) return;
  const int lane = threadIdx.x & 31;
  const int64_t start = c * kChunk;
  const int64_t end = min64(n, start + kChunk);
  int local = 0;
  for (int64_t j = start + lane; j < end; j += 32) {
    local += (j == 0 || sk[j] != sk[j - 1]) ? 1 : 0;
  }
  const int total = __reduce_add_sync(0xffffffffu, local);
  if (lane == 0) cnt[c] = total;
}

// One warp per chunk: sum the chunk's pieces of segments (see the header).
template <typename IdT, typename V>
__global__ void __launch_bounds__(256)
seg_sum(const typename Key<IdT>::U* __restrict__ sk,
        const int* __restrict__ sp, int64_t n,
        const typename V::E* __restrict__ vals, int width,
        const int* __restrict__ excl, int64_t nchunks, int64_t u_cap,
        IdT* __restrict__ uids, typename V::E* __restrict__ ugrads,
        float* __restrict__ cont, float* __restrict__ tailp) {
  using U = typename Key<IdT>::U;
  const int64_t c = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) >> 5;
  if (c >= nchunks) return;
  const int lane = threadIdx.x & 31;
  const int64_t start = c * kChunk;
  const int64_t end = min64(n, start + kChunk);
  const bool cont_first = start > 0 && sk[start] == sk[start - 1];
  const bool cont_last = end < n && sk[end] == sk[end - 1];
  const int64_t seg0 = static_cast<int64_t>(excl[c]) + (cont_first ? -1 : 0);
  for (int col0 = 0; col0 < width; col0 += 32) {
    const int col = col0 + lane;
    const bool on = col < width;
    int64_t s = seg0;
    bool first = true;
    float acc = 0.f;
    U prev = start > 0 ? sk[start - 1] : U(0);
    auto flush = [&](bool last) {
      if (!on) return;
      if (first && cont_first) {
        cont[c * width + col] = acc;
      } else if (last && cont_last) {
        tailp[c * width + col] = acc;
      } else if (s < u_cap) {
        ugrads[s * width + col] = V::store(acc);
      }
    };
    for (int64_t j0 = start; j0 < end; j0 += 8) {
      U kk[8];
      float vv[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int64_t j = j0 + q;
        kk[q] = 0;
        vv[q] = 0.f;
        if (j < end) {
          kk[q] = sk[j];
          if (on) {
            vv[q] = V::load(vals[static_cast<int64_t>(sp[j]) * width + col]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int64_t j = j0 + q;
        if (j < end) {
          const bool b = j == 0 || kk[q] != prev;
          if (b && j > start) {
            flush(false);
            ++s;
            first = false;
            acc = 0.f;
          }
          if (b && lane == 0 && col0 == 0 && s < u_cap) {
            uids[s] = Key<IdT>::id(kk[q]);
          }
          acc = __fadd_rn(acc, vv[q]);
          prev = kk[q];
        }
      }
    }
    flush(true);
  }
}

// One warp per chunk that owns the start of a segment running past its
// end: find the chunk the segment ends in (32 chunks a probe), then add
// the pieces of the chunks between, in order.
template <typename U, typename V>
__global__ void __launch_bounds__(256)
seg_fix(const U* __restrict__ sk, int64_t n, int width,
        const int* __restrict__ excl, const int* __restrict__ num_seg,
        int64_t nchunks, int64_t u_cap, typename V::E* __restrict__ ugrads,
        const float* __restrict__ cont, const float* __restrict__ tailp) {
  const int64_t c = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) >> 5;
  if (c >= nchunks) return;
  const int lane = threadIdx.x & 31;
  const int64_t end = min64(n, (c + 1) * kChunk);
  if (end >= n || sk[end] != sk[end - 1]) return;  // ends in this chunk
  auto count = [&](int64_t k) {
    return (k + 1 < nchunks ? excl[k + 1] : *num_seg) - excl[k];
  };
  const int cnt_c = count(c);
  if (cnt_c == 0) return;  // the segment started in an earlier chunk
  const int64_t s = static_cast<int64_t>(excl[c]) + cnt_c - 1;
  if (s >= u_cap) return;
  // the segment ends in chunk k if k holds a boundary, or if the chunk
  // after k starts a new segment (or k is the last chunk)
  int64_t kend = -1;
  for (int64_t k0 = c + 1; kend < 0; k0 += 32) {
    const int64_t k = k0 + lane;
    bool stop = false;
    if (k < nchunks) {
      const int64_t e = min64(n, (k + 1) * kChunk);
      stop = count(k) > 0 || e >= n || sk[e] != sk[e - 1];
    }
    const unsigned b = __ballot_sync(0xffffffffu, stop);
    if (b != 0u) kend = k0 + __ffs(b) - 1;
  }
  for (int col = lane; col < width; col += 32) {
    float acc = tailp[c * width + col];
    int64_t k = c + 1;
    for (; k + 8 <= kend + 1; k += 8) {
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = cont[(k + q) * width + col];
#pragma unroll
      for (int q = 0; q < 8; ++q) acc = __fadd_rn(acc, v[q]);
    }
    for (; k <= kend; ++k) acc = __fadd_rn(acc, cont[k * width + col]);
    ugrads[s * width + col] = V::store(acc);
  }
}

template <typename IdT, typename V>
__global__ void __launch_bounds__(256)
fill_tail(IdT* __restrict__ uids, typename V::E* __restrict__ ugrads,
          int width, int64_t u_cap, const int* __restrict__ num_seg,
          IdT pad_id) {
  const int64_t first = static_cast<int64_t>(*num_seg) * width;
  const int64_t total = u_cap * width;
  for (int64_t i = first + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    ugrads[i] = V::store(0.f);
    if (i % width == 0) uids[i / width] = pad_id;
  }
}

int64_t align16(int64_t b) { return (b + 15) / 16 * 16; }

struct Scratch {
  void* keys[2];
  int* pos[2];
  int* hist;
  int* excl;
  float* cont;
  float* tailp;
  int* num_seg;
  int* partials;  // the scans' tile sums
};

int64_t ntiles_of(int64_t n) { return (n + kTile - 1) / kTile; }
int64_t nchunks_of(int64_t n) { return (n + kChunk - 1) / kChunk; }

// Carves the scratch buffer (or, with base null, returns its size).
int64_t carve(void* base, int64_t n, int width, int key_bytes, Scratch* s) {
  const int64_t sizes[] = {
      n * key_bytes, n * key_bytes, n * 4, n * 4,
      kBins * ntiles_of(n) * 4, nchunks_of(n) * 4,
      nchunks_of(n) * width * 4, nchunks_of(n) * width * 4, 16,
      (scan_tiles(kBins * ntiles_of(n)) + scan_tiles(nchunks_of(n)) + 1) * 4};
  void* ptrs[10];
  int64_t off = 0;
  for (int i = 0; i < 10; ++i) {
    ptrs[i] = base == nullptr ? nullptr : static_cast<char*>(base) + off;
    off += align16(sizes[i]);
  }
  if (s != nullptr) {
    s->keys[0] = ptrs[0];
    s->keys[1] = ptrs[1];
    s->pos[0] = static_cast<int*>(ptrs[2]);
    s->pos[1] = static_cast<int*>(ptrs[3]);
    s->hist = static_cast<int*>(ptrs[4]);
    s->excl = static_cast<int*>(ptrs[5]);
    s->cont = static_cast<float*>(ptrs[6]);
    s->tailp = static_cast<float*>(ptrs[7]);
    s->num_seg = static_cast<int*>(ptrs[8]);
    s->partials = static_cast<int*>(ptrs[9]);
  }
  return off;
}

#define DETPU_CHECK_LAUNCH()                      \
  do {                                            \
    const cudaError_t e_ = cudaGetLastError();    \
    if (e_ != cudaSuccess) return e_;             \
  } while (0)

template <typename IdT, typename V>
cudaError_t run(const void* ids_v, int64_t n, const void* vals_v, int width,
                int64_t pad_id, int64_t u_cap, void* uids_v, void* ugrads_v,
                void* scratch, cudaStream_t st) {
  using U = typename Key<IdT>::U;
  using E = typename V::E;
  Scratch s;
  carve(scratch, n, width, static_cast<int>(sizeof(U)), &s);
  const IdT* ids = static_cast<const IdT*>(ids_v);
  const E* vals = static_cast<const E*>(vals_v);
  IdT* uids = static_cast<IdT*>(uids_v);
  E* ugrads = static_cast<E*>(ugrads_v);
  const int64_t ntiles = ntiles_of(n);
  const int64_t nchunks = nchunks_of(n);
  if (ntiles > 0x7fffffffLL / kBins) return cudaErrorInvalidValue;

  init_keys<IdT><<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      ids, n, static_cast<U*>(s.keys[0]), s.pos[0]);
  DETPU_CHECK_LAUNCH();
  int cur = 0;
  for (int shift = 0; shift < static_cast<int>(8 * sizeof(U)); shift += 8) {
    const U* kin = static_cast<const U*>(s.keys[cur]);
    radix_hist<U><<<static_cast<unsigned>(ntiles), kThreads, 0, st>>>(
        kin, n, shift, s.hist, static_cast<int>(ntiles));
    DETPU_CHECK_LAUNCH();
    const cudaError_t e = exclusive_scan(s.hist, kBins * ntiles, s.partials,
                                         nullptr, st);
    if (e != cudaSuccess) return e;
    radix_scatter<U><<<static_cast<unsigned>(ntiles), kThreads, 0, st>>>(
        kin, s.pos[cur], static_cast<U*>(s.keys[1 - cur]), s.pos[1 - cur], n,
        shift, s.hist, static_cast<int>(ntiles));
    DETPU_CHECK_LAUNCH();
    cur = 1 - cur;
  }
  const U* sk = static_cast<const U*>(s.keys[cur]);
  const int* sp = s.pos[cur];
  const unsigned warp_blocks = static_cast<unsigned>((nchunks * 32 + 255) / 256);
  count_bounds<U><<<warp_blocks, 256, 0, st>>>(sk, n, s.excl, nchunks);
  DETPU_CHECK_LAUNCH();
  const cudaError_t e = exclusive_scan(s.excl, nchunks, s.partials,
                                       s.num_seg, st);
  if (e != cudaSuccess) return e;
  seg_sum<IdT, V><<<warp_blocks, 256, 0, st>>>(
      sk, sp, n, vals, width, s.excl, nchunks, u_cap, uids, ugrads, s.cont,
      s.tailp);
  DETPU_CHECK_LAUNCH();
  seg_fix<U, V><<<warp_blocks, 256, 0, st>>>(
      sk, n, width, s.excl, s.num_seg, nchunks, u_cap, ugrads, s.cont,
      s.tailp);
  DETPU_CHECK_LAUNCH();
  const int64_t tail_blocks = min64(1024, (u_cap * width + 255) / 256);
  fill_tail<IdT, V><<<static_cast<unsigned>(tail_blocks), 256, 0, st>>>(
      uids, ugrads, width, u_cap, s.num_seg, static_cast<IdT>(pad_id));
  DETPU_CHECK_LAUNCH();
  return cudaSuccess;
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of scratch detpu_dedup needs for n ids of rows of `width`.
extern "C" int64_t detpu_dedup_scratch_bytes(int64_t n, int width,
                                             int ids_is_64) {
  return carve(nullptr, n, width, ids_is_64 ? 8 : 4, nullptr);
}

// ids [n] (int32, or int64 when ids_is_64), vals [n, width] (vals_dtype
// 0 = float32, 1 = bfloat16); writes uids [u_cap] (the ids' type) and
// ugrads [u_cap, width] (the rows' type), u_cap <= n < 2^31. scratch:
// detpu_dedup_scratch_bytes(n, width, ids_is_64) bytes, 16-B aligned.
extern "C" int detpu_dedup(const void* ids, int ids_is_64, int64_t n,
                           const void* vals, int vals_dtype, int width,
                           int64_t pad_id, int64_t u_cap, void* uids,
                           void* ugrads, void* scratch, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || width <= 0 || u_cap < 0 || u_cap > n ||
      (vals_dtype != 0 && vals_dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  if (u_cap == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ids_is_64) {
    return vals_dtype == 0
        ? run<int64_t, F32>(ids, n, vals, width, pad_id, u_cap, uids, ugrads,
                            scratch, st)
        : run<int64_t, BF16>(ids, n, vals, width, pad_id, u_cap, uids,
                             ugrads, scratch, st);
  }
  return vals_dtype == 0
      ? run<int32_t, F32>(ids, n, vals, width, pad_id, u_cap, uids, ugrads,
                          scratch, st)
      : run<int32_t, BF16>(ids, n, vals, width, pad_id, u_cap, uids, ugrads,
                           scratch, st);
}
