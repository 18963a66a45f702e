// K5: sort + unique + segment-sum dedup of a sparse gradient stream, for
// Hopper (sm_90a), on the sorted-segment engine (segment_scatter.cuh).
//
// Replaces the XLA-lowered sort and segment-sum of the JAX package:
//   distributed_embeddings_tpu/ops/sparse_grad.py:dedup_sparse_grad
//   (body _dedup_sparse_grad: lax.sort_key_val, boundary flags, cumsum,
//   .at[seg].add / .at[seg].set)
// the pass the stateful optimizers (SparseAdagrad's sparse regime,
// SparseAdam, SparseMomentum) run before their per-row read-modify-write.
// Given ids [n] and rows vals [n, w], it writes U = min(n, max_unique)
// outputs: position k below the number of distinct ids holds the k-th
// smallest distinct id and the fp32 sum of its rows (rounded once to the
// rows' dtype); the tail holds pad_id and zero rows. An entry the valid
// mask clears counts as pad_id.
//
// Bound: bytes. The ids and rows are read once, the U outputs written
// once; the sort moves (key, position) pairs once a digit.
//
// Design, one launch chain on the caller's stream, all scratch in one
// buffer the caller keeps (the launch record's) and zeroed once:
// 1. Sort: the engine's onesweep LSD radix sort under K5's key policy
//    (IdKey): every id is kept, its sign bit flipped so that unsigned
//    order is the ids' signed order (negative ids and ids past pad_id
//    sort where JAX's sort puts them), the valid mask folded into the
//    key (a cleared entry keys as pad_id); 32-bit ids take 4 digit
//    passes, 64-bit ids 8, after one histogram launch. Stable: each id's
//    positions stay in stream order.
// 2. Rank: one launch over the sort's tiles flags each run start, scans
//    the flags in the block and across tiles by the engine's decoupled
//    look-back (its never-reset ticket numbers the launch), so each run
//    gets its rank (its output row) in one pass; it writes the rank's id
//    and files the run by length class (one global add a class a block).
//    A run longer than the engine's L (kSplit) is cut into chunks of L.
//    Runs ranked at or past U (max_unique below the distinct count) are
//    dropped: the largest ids, as in JAX.
// 3. Sum: a persistent launch, classes longest first (chunks first), a
//    lane group a run sized to the width (each lane 4 columns where
//    width and alignment allow: at w16, 4 lanes of 16 B, so a warp sums 8
//    runs; at w128, a warp), adding the run's rows in stream order in
//    fp32 with the next rows' loads in flight; a chunk's sum goes to an
//    fp32 partial row.
//    The same launch fills the tail [distinct, U) with pad_id and zero
//    rows.
// 4. Finish: each long run's partials added in chunk order over the grid
//    (a hot id repeated 50K times: deterministic; in the sum's last CTA
//    alone the long runs of a Zipfian stream took 0.1 ms more on an
//    NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
//
// C interface (ctypes): detpu_dedup_prepare validates a call's layout
// and writes its launch into host memory (scratch carved);
// detpu_dedup_launch runs the chain with the per-call pointers and the
// stream. Each returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "segment_scatter.cuh"

namespace {

constexpr int kWordUnique = kWordCombs + 1;  // distinct ids (all ranks)
constexpr int kKeyPasses = 8;                // the histogram's rows

template <int BYTES> struct KeyType;
template <> struct KeyType<4> { using U = uint32_t; };
template <> struct KeyType<8> { using U = uint64_t; };

// K5's key policy: every id kept, sign bit flipped; a position the valid
// mask clears keys as pad_id.
template <typename IdT>
struct IdKey {
  using U = typename KeyType<sizeof(IdT)>::U;
  static constexpr int kMaxPasses = sizeof(U);
  static constexpr int kItems = sizeof(U) == 8 ? 8 : 16;
  static constexpr U kSign = U(1) << (8 * sizeof(U) - 1);
  __device__ static bool of(const Params& p, int64_t j, U* key) {
    IdT id = static_cast<const IdT*>(p.ids)[j];
    if (p.valid != nullptr && p.valid[j] == 0) {
      id = static_cast<IdT>(p.pad_id);
    }
    *key = static_cast<U>(id) ^ kSign;
    return true;
  }
  __device__ static IdT id_of(U key) {
    return static_cast<IdT>(key ^ kSign);
  }
};

struct DedupArgs {
  Params p;           // the engine's: sort, counters, lists, chunks
  int4* items;        // (start, length, rank) by length class
  int4* combs;        // (first chunk, chunks, rank) of each long run
  void* uids;         // [u_cap] the ids' type
  void* ugrads;       // [u_cap, width] the rows' type
  int64_t u_cap;
};

// Flag the tile's run starts, rank them (block scan + look-back), write
// their ids and file them by length class (a shared counter a class, one
// global add a class a block: one a warp, as the engine's seg_list files
// them, took 0.073 ms against 0.051 at the zoo's 2.88M ids on an NVIDIA
// H100 80GB HBM3 at 700 W).
template <typename IdT>
__global__ void __launch_bounds__(kThreads)
dd_rank(const __grid_constant__ DedupArgs d) {
  using K = IdKey<IdT>;
  using U = typename K::U;
  constexpr int kIt = K::kItems;
  const Params& p = d.p;
  __shared__ unsigned long long s_ticket;
  __shared__ int s_prefix;
  __shared__ int s_cls[kClasses];
  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = atomicAdd(p.ticket, 1ull);
  if (tid < kClasses) s_cls[tid] = 0;
  if (blockIdx.x == 0) {  // the sort's histogram, for the next call
    for (int i = tid; i < kKeyPasses * kBins; i += kThreads) p.hist[i] = 0;
  }
  __syncthreads();
  const unsigned long long ticket = s_ticket;
  const int64_t tile = static_cast<int64_t>(ticket % gridDim.x);
  const uint32_t epoch = static_cast<uint32_t>(ticket / gridDim.x) + 1u;
  const U* sk = reinterpret_cast<const U*>(p.keys[p.passes & 1]);
  const int64_t j0 = (tile * kThreads + tid) * kIt;
  uint32_t bnd = 0;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kIt; ++k) {
    const int64_t j = j0 + k;
    if (j < p.n && (j == 0 || sk[j] != sk[j - 1])) {
      bnd |= 1u << k;
      ++cnt;
    }
  }
  int total;
  const int local = block_scan(cnt, &total);
  if (tid == 0) {
    s_prefix = look_back(p.status, tile, 0, total, epoch);
    if (tile == gridDim.x - 1) p.words[kWordUnique] = s_prefix + total;
  }
  __syncthreads();
  IdT* uids = static_cast<IdT*>(d.uids);
  int rank = s_prefix + local;
  int cls[kIt], off[kIt], len[kIt], rk[kIt];
#pragma unroll
  for (int k = 0; k < kIt; ++k) {
    cls[k] = -1;
    if (!((bnd >> k) & 1u)) continue;
    const int r = rank++;
    if (r >= d.u_cap) continue;
    const int64_t j = j0 + k;
    const U key = sk[j];
    uids[r] = K::id_of(key);
    const int l = run_length(sk, j, p.n, key);
    if (l > p.split) {  // chunks of L, combined in order after the sum
      const int c = (l + p.split - 1) / p.split;
      const int b = atomicAdd(&p.words[kWordChunks], c);
      for (int q = 0; q < c; ++q) {
        const int o = q * p.split;
        p.chunks[b + q] = make_int2(static_cast<int>(j) + o,
                                    min(p.split, l - o));
      }
      d.combs[atomicAdd(&p.words[kWordCombs], 1)] = make_int4(b, c, r, 0);
    } else {
      cls[k] = 31 - __clz(l);
      off[k] = atomicAdd(&s_cls[cls[k]], 1);
      len[k] = l;
      rk[k] = r;
    }
  }
  __syncthreads();
  if (tid < kClasses && s_cls[tid] > 0) {
    s_cls[tid] = atomicAdd(&p.words[kWordClass + tid], s_cls[tid]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kIt; ++k) {
    if (cls[k] >= 0) {
      d.items[p.class_off[cls[k]] + s_cls[cls[k]] + off[k]] = make_int4(
          static_cast<int>(j0 + k), len[k], rk[k], 0);
    }
  }
}

// One unit: the `len` sorted entries from `start`, the lane's E columns
// of column block cb, summed in fp32 in stream order; into the float32
// partial row, or rounded once into the output row.
template <typename Tv, int E>
__device__ __forceinline__ void sum_unit(const Params& p, const int* sp,
                                         int start, int len, int cb,
                                         int lane_g, float* partial,
                                         typename Tv::E* out) {
  using VE = typename Tv::E;
  const int c0 = cb * (32 * E) + lane_g * E;
  if (c0 >= p.width) return;
  const int64_t w = p.width;
  const VE* vals = static_cast<const VE*>(p.vals);
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  int pn[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) pn[b] = b < len ? sp[start + b] : -1;
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
          acc[e] = __fadd_rn(acc[e], Tv::load(raw[b][e]));
        }
      }
    }
  }
  if (partial != nullptr) {
    store_e<E>(partial + c0, acc);
  } else {
    VE o[E];
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = Tv::store(acc[e]);
    store_e<E>(out + c0, o);
  }
}

// The sum: every filed unit, chunks first, then the classes longest
// first; then the tail [distinct, U), beside the sums' reads.
template <typename Tv, int E, typename IdT>
__global__ void __launch_bounds__(kThreads)
dd_sum(const __grid_constant__ DedupArgs d) {
  const Params& p = d.p;
  __shared__ Lists s_lists;
  const int* sp = p.pos[p.passes & 1];
  if (threadIdx.x == 0) group_lists(p, &s_lists);
  __syncthreads();
  const long long total = s_lists.begin[s_lists.count];
  const int lane_g = threadIdx.x & ((1 << p.g_log2) - 1);
  const long long ngroups =
      (static_cast<long long>(gridDim.x) * kThreads) >> p.g_log2;
  typename Tv::E* ugrads = static_cast<typename Tv::E*>(d.ugrads);
  for (long long v = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) >> p.g_log2;
       v < total; v += ngroups) {
    const int k = list_of(s_lists, v);
    const long long u = v - s_lists.begin[k];
    const long long idx = u / p.ncb;
    const int cb = static_cast<int>(u % p.ncb);
    const int c = s_lists.cls[k];
    if (c < 0) {
      const int2 it = p.chunks[idx];
      sum_unit<Tv, E>(p, sp, it.x, it.y, cb, lane_g,
                      p.partials + idx * p.width, nullptr);
    } else {
      const int4 it = d.items[p.class_off[c] + idx];
      sum_unit<Tv, E>(p, sp, it.x, it.y, cb, lane_g, nullptr,
                      ugrads + static_cast<int64_t>(it.z) * p.width);
    }
  }
  using VE = typename Tv::E;
  const int64_t w = p.width;
  const int64_t distinct = p.words[kWordUnique];
  const int64_t nu = distinct < d.u_cap ? distinct : d.u_cap;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
  // the zero rows (0 bits in either dtype): 16-B stores between an
  // element head and tail
  constexpr int64_t es = sizeof(VE);
  const int64_t b0 = nu * w * es, b1 = d.u_cap * w * es;
  const int64_t h = min(b1, (b0 + 15) / 16 * 16);
  const int64_t e = max(h, b1 / 16 * 16);
  for (int64_t i = b0 / es + g0; i < h / es; i += stride) ugrads[i] = VE(0);
  uint4* body = reinterpret_cast<uint4*>(d.ugrads);
  for (int64_t i = h / 16 + g0; i < e / 16; i += stride) {
    body[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int64_t i = e / es + g0; i < b1 / es; i += stride) ugrads[i] = VE(0);
  IdT* uids = static_cast<IdT*>(d.uids);
  for (int64_t r = nu + g0; r < d.u_cap; r += stride) {
    uids[r] = static_cast<IdT>(p.pad_id);
  }
}

// Each long run's partials added in chunk order, kCombBatch loads in
// flight, a lane group a run's column block over the grid.
template <typename Tv, int E>
__global__ void __launch_bounds__(kThreads)
dd_finish(const __grid_constant__ DedupArgs d) {
  using VE = typename Tv::E;
  const Params& p = d.p;
  const int64_t w = p.width;
  VE* ugrads = static_cast<VE*>(d.ugrads);
  const int lane_g = threadIdx.x & ((1 << p.g_log2) - 1);
  const long long combs =
      static_cast<long long>(p.words[kWordCombs]) * p.ncb;
  const long long ngroups =
      (static_cast<long long>(gridDim.x) * kThreads) >> p.g_log2;
  for (long long v = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) >> p.g_log2;
       v < combs; v += ngroups) {
    const int4 cm = d.combs[v / p.ncb];
    const int c0 = static_cast<int>(v % p.ncb) * (32 * E) + lane_g * E;
    if (c0 >= p.width) continue;
    float acc[E];
    load_e<E>(acc, p.partials + static_cast<int64_t>(cm.x) * w + c0);
    for (int q0 = 1; q0 < cm.y; q0 += kCombBatch) {
      float part[kCombBatch][E];
#pragma unroll
      for (int b = 0; b < kCombBatch; ++b) {
        if (q0 + b < cm.y) {
          load_e<E>(part[b],
                    p.partials + static_cast<int64_t>(cm.x + q0 + b) * w + c0);
        }
      }
#pragma unroll
      for (int b = 0; b < kCombBatch; ++b) {
        if (q0 + b < cm.y) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] = __fadd_rn(acc[e], part[b][e]);
        }
      }
    }
    VE o[E];
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = Tv::store(acc[e]);
    store_e<E>(ugrads + static_cast<int64_t>(cm.z) * w + c0, o);
  }
}

// the sort's tiles for n ids of this key width
int64_t dd_tiles(int64_t n, int key_bytes) {
  const int64_t per = kThreads * static_cast<int64_t>(key_bytes == 8 ? 8 : 16);
  return n > 0 ? (n + per - 1) / per : 1;
}

// Carves the scratch of a call of n ids (base null: only its size).
int64_t dd_carve(void* base, int64_t n, int width, int key_bytes,
                 DedupArgs* d) {
  const int64_t tiles = dd_tiles(n, key_bytes);
  const int64_t sizes[] = {
      kKeyPasses * kBins * 4, kWords * 4, 8, tiles * kBins * 8,
      n * key_bytes, n * key_bytes, n * 4, n * 4, item_cap(n) * 16,
      chunk_cap(n, kSplit) * 8, comb_cap(n, kSplit) * 16,
      chunk_cap(n, kSplit) * width * 4};
  constexpr int kParts = sizeof(sizes) / sizeof(sizes[0]);
  char* ptrs[kParts];
  int64_t off = 0;
  for (int i = 0; i < kParts; ++i) {
    ptrs[i] = base == nullptr ? nullptr : static_cast<char*>(base) + off;
    off += align256(sizes[i]);
  }
  if (d != nullptr) {
    Params& p = d->p;
    p.hist = reinterpret_cast<int*>(ptrs[0]);
    p.words = reinterpret_cast<int*>(ptrs[1]);
    p.ticket = reinterpret_cast<unsigned long long*>(ptrs[2]);
    p.status = reinterpret_cast<unsigned long long*>(ptrs[3]);
    p.keys[0] = reinterpret_cast<uint32_t*>(ptrs[4]);
    p.keys[1] = reinterpret_cast<uint32_t*>(ptrs[5]);
    p.pos[0] = reinterpret_cast<int*>(ptrs[6]);
    p.pos[1] = reinterpret_cast<int*>(ptrs[7]);
    d->items = reinterpret_cast<int4*>(ptrs[8]);
    p.chunks = reinterpret_cast<int2*>(ptrs[9]);
    d->combs = reinterpret_cast<int4*>(ptrs[10]);
    p.partials = reinterpret_cast<float*>(ptrs[11]);
  }
  return off;
}

struct Prepared {
  DedupArgs d;
  int sum_grid[4];     // dd_sum's resident CTAs: [vals dtype][vec]
  int finish_grid;
};

template <typename Tv, int E, typename IdT>
cudaError_t dd_launch_sum(const DedupArgs& d, int grid, int fin_grid,
                          cudaStream_t st) {
  dd_sum<Tv, E, IdT><<<grid, kThreads, 0, st>>>(d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dd_finish<Tv, E><<<fin_grid, kThreads, 0, st>>>(d);
  return cudaGetLastError();
}

template <typename IdT>
cudaError_t dd_run(const Prepared& pr, const DedupArgs& d, cudaStream_t st) {
  cudaError_t e = sort_keys<IdKey<IdT>>(d.p, st);
  if (e != cudaSuccess) return e;
  dd_rank<IdT><<<static_cast<unsigned>(d.p.tiles), kThreads, 0, st>>>(d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int sg = pr.sum_grid[d.p.vals_dtype * 2 + d.p.vec];
  const int fg = pr.finish_grid;
  if (d.p.vals_dtype == 0) {
    return d.p.vec ? dd_launch_sum<F32, 4, IdT>(d, sg, fg, st)
                   : dd_launch_sum<F32, 1, IdT>(d, sg, fg, st);
  }
  return d.p.vec ? dd_launch_sum<BF16, 4, IdT>(d, sg, fg, st)
                 : dd_launch_sum<BF16, 1, IdT>(d, sg, fg, st);
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int64_t detpu_dedup_prepared_bytes() {
  return static_cast<int64_t>(sizeof(Prepared));
}

// Bytes of scratch a call of n ids of rows of `width` needs (zeroed
// once before its first launch, then kept for that prepared call alone:
// one stream at a time).
extern "C" int64_t detpu_dedup_scratch_bytes(int64_t n, int width,
                                             int ids_is_64) {
  return dd_carve(nullptr, n, width, ids_is_64 ? 8 : 4, nullptr);
}

// Validate one call's layout and write its launch into `prepared`
// (detpu_dedup_prepared_bytes() bytes of host memory): n ids (int32, or
// int64 when ids_is_64), rows of `width` (vals_dtype 0 = float32, 1 =
// bfloat16), pad_id, u_cap <= n < 2^31 outputs, `scratch` 256-B aligned.
extern "C" int detpu_dedup_prepare(int64_t n, int width, int ids_is_64,
                                   int vals_dtype, int64_t pad_id,
                                   int64_t u_cap, void* scratch,
                                   void* prepared) {
  if (n < 0 || n > 0x7fffffffLL || width <= 0 || u_cap < 0 || u_cap > n ||
      (vals_dtype != 0 && vals_dtype != 1) || prepared == nullptr ||
      (n > 0 && scratch == nullptr) ||
      reinterpret_cast<uintptr_t>(scratch) % 256 != 0) {
    return cudaErrorInvalidValue;
  }
  Prepared* pr = static_cast<Prepared*>(prepared);
  memset(pr, 0, sizeof(Prepared));
  DedupArgs& d = pr->d;
  Params& p = d.p;
  const int key_bytes = ids_is_64 ? 8 : 4;
  p.n = n;
  p.tiles = dd_tiles(n, key_bytes);
  p.width = width;
  p.vals_dtype = vals_dtype;
  p.ids64 = ids_is_64 != 0;
  p.passes = key_bytes;
  p.split = kSplit;
  p.long_class = kClasses;  // every class on the group path
  p.pad_id = pad_id;
  d.u_cap = u_cap;
  if (p.tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return e;
  if (n > 0) dd_carve(scratch, n, width, key_bytes, &d);
  int64_t off = 0;
  for (int c = 0; c < kClasses; ++c) {
    p.class_off[c] = off;
    off += n >> c;
  }
  pr->sum_grid[0] = resident_blocks(dd_sum<F32, 1, int32_t>, 0, p.sms);
  pr->sum_grid[1] = resident_blocks(dd_sum<F32, 4, int32_t>, 0, p.sms);
  pr->sum_grid[2] = resident_blocks(dd_sum<BF16, 1, int32_t>, 0, p.sms);
  pr->sum_grid[3] = resident_blocks(dd_sum<BF16, 4, int32_t>, 0, p.sms);
  pr->finish_grid = p.sms * 4;
  return cudaGetLastError();
}

// ids [n] contiguous, vals [n, width] contiguous, valid [n] (bool bytes)
// or null; writes uids [u_cap] and ugrads [u_cap, width].
extern "C" int detpu_dedup_launch(const void* prepared, const void* ids,
                                  const void* vals, const void* valid,
                                  void* uids, void* ugrads, void* stream) {
  const Prepared* pr = static_cast<const Prepared*>(prepared);
  if (pr == nullptr || uids == nullptr || ugrads == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (pr->d.u_cap == 0) return cudaSuccess;
  DedupArgs d = pr->d;
  Params& p = d.p;
  p.ids = ids;
  p.vals = vals;
  p.valid = static_cast<const unsigned char*>(valid);
  d.uids = uids;
  d.ugrads = ugrads;
  const int esize = p.vals_dtype == 0 ? 4 : 2;
  p.vec = p.width % 4 == 0 && aligned(vals, 4 * esize) &&
          aligned(ugrads, 4 * esize);
  shape_groups(&p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p.ids64 ? dd_run<int64_t>(*pr, d, st) : dd_run<int32_t>(*pr, d, st);
}
