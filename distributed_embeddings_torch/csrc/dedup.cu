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
// 1. Sort. The stable LSD radix sort of radix_sort.cuh over (key,
//    position) pairs, 8 bits a pass. The key is the id with its sign bit
//    flipped, so unsigned order is the ids' signed order and negative ids
//    and ids past pad_id sort where JAX's sort puts them; 32-bit ids take
//    4 passes (as the 27 bits of a 70M-row slab would), 64-bit ids 8.
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

#include "radix_sort.cuh"

namespace {

constexpr int kChunk = 256;  // sorted rows per segment-sum warp

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
  const int64_t nchunks = nchunks_of(n);

  init_keys<IdT><<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      ids, n, static_cast<U*>(s.keys[0]), s.pos[0]);
  DETPU_CHECK_LAUNCH();
  U* keys[2] = {static_cast<U*>(s.keys[0]), static_cast<U*>(s.keys[1])};
  int cur = 0;
  const cudaError_t es = radix_sort<U, true>(
      keys, s.pos, n, static_cast<int>(8 * sizeof(U)), s.hist, s.partials,
      st, &cur);
  if (es != cudaSuccess) return es;
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
