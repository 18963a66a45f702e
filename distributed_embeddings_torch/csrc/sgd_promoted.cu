// K18: sparse SGD into a bfloat16 slab with a float32 learning rate (the
// promoted scatter), for Hopper (sm_90a).
//
// Replaces the XLA-lowered scatter of the JAX package when the lr is a
// traced float32 scalar (a callable schedule) and the slab is bfloat16:
//   distributed_embeddings_tpu/parallel/optimizers.py:_sorted_scatter_add
//   under SparseSGD.apply_rows
// slab.at[ids].add(-lr * vals.astype(bf16), mode="drop"): the update is
// float32 (lr is a strong f32 scalar), so XLA converts the WHOLE slab to
// float32, scatter-adds in float32 in stream order, and rounds every
// element back to bfloat16 once. For each slab row r hit by an in-range id
// (a negative id counts from the end once; anything else outside [0, rows)
// is dropped, the dropped-row sentinel included) this kernel computes
//   slab[r] = bf16_rn(((f32(slab[r]) + u_i0) + u_i1) + ...)
//   u_i = f32(-lr) * f32(bf16(vals[i]))   (one float32 rounding)
// over the ids i hitting r in stream order; rows not hit keep their bits
// (the f32 round trip of a bf16 value is exact), and no float32 copy of
// the slab is ever made.
//
// Bound: bytes. Each stream row reads its id and its update row once;
// each distinct hit row is read and written once; the sort moves each
// (key, position) pair through a few passes of 8 B.
//
// Design, deterministic and bit-exact to the stream-order plain version
// (ops/scatter_add.py:sgd_scatter_promoted_plain):
// 1. Keys. Each id becomes its row (or `rows` when dropped, sorting
//    last) with its stream position as payload.
// 2. Sort. The stable LSD radix sort of radix_sort.cuh over (row,
//    position), on just the bits `rows` needs: stability keeps each row's
//    positions in stream order.
// 3. Segments. One thread per sorted entry lists the segment starts (a
//    kept row differing from the previous key).
// 4. Rows. Persistent warps stride over (segment, 32-column group)
//    items; a lane carries one column of the row in float32, adds the
//    segment's products in order with __fadd_rn/__fmul_rn (no FMA
//    contraction) and stores one __float2bfloat16_rn. The adds of a
//    column are a serial chain, so what can overlap are the loads: the
//    warp walks the segment 32 sorted entries at a time, loading the next
//    32 keys and positions before adding the current ones, and each lane
//    issues the loads of the chunk's update rows (up to 32) before it
//    adds them. A Zipfian hot row is one long serial segment; its
//    columns go to width/32 warps.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_sort.cuh"

namespace {

constexpr int kBatch = 32;  // update rows a lane loads before adding them

struct F32 {
  using E = float;
  __device__ static float load(E v) { return v; }
};

struct BF16 {
  using E = uint16_t;  // raw bf16 bits
  __device__ static float load(E v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
};

__device__ __forceinline__ float bf16_round(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

template <typename IdT, typename U>
__global__ void __launch_bounds__(256)
row_keys(const IdT* __restrict__ ids, int64_t n, int64_t rows,
         U* __restrict__ keys, int* __restrict__ pos) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= n) return;
  int64_t id = static_cast<int64_t>(ids[j]);
  if (id < 0) id += rows;                     // negatives count from the end
  if (id < 0 || id >= rows) id = rows;        // dropped: sorts last
  keys[j] = static_cast<U>(id);
  pos[j] = static_cast<int>(j);
}

// Segment starts (a kept row differing from the previous sorted key),
// listed in no particular order: a warp's starts take one atomicAdd.
template <typename U>
__global__ void __launch_bounds__(256)
seg_starts(const U* __restrict__ sk, int64_t n, int64_t rows,
           int* __restrict__ starts, int* __restrict__ count) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  bool is_start = false;
  if (j < n) {
    const U key = sk[j];
    is_start = key < static_cast<U>(rows) && (j == 0 || sk[j - 1] != key);
  }
  const unsigned mask = __ballot_sync(0xffffffffu, is_start);
  if (mask == 0u) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (is_start) {
    starts[base + __popc(mask & ((1u << lane) - 1u))] = static_cast<int>(j);
  }
}

// Persistent warps over the work items (segment, 32-column group), item
// i going to warp i mod (the grid's warps): lane l of the warp on item
// (s, g) owns column 32g + l of segment s's row. It carries that column in float32 from the slab row,
// walks the segment 32 sorted entries at a time (a ballot finds where it
// ends; the next 32 keys and positions load before the current ones are
// added), issues the loads of kBatch update rows before adding them in
// order with __fadd_rn/__fmul_rn (no FMA contraction), and stores one
// __float2bfloat16_rn. The columns of a hot row go to width/32 warps.
template <typename U, typename Tv>
__global__ void __launch_bounds__(256)
seg_rows(uint16_t* __restrict__ slab, int64_t rows, int width,
         const U* __restrict__ sk, const int* __restrict__ sp, int64_t n,
         const typename Tv::E* __restrict__ vals,
         const float* __restrict__ neg_lr_dev,
         const int* __restrict__ starts, const int* __restrict__ count) {
  using E = typename Tv::E;
  const int lane = threadIdx.x & 31;
  const int groups = (width + 31) / 32;
  const int64_t items = static_cast<int64_t>(*count) * groups;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  const float nl = __ldg(neg_lr_dev);
  const U other_key = static_cast<U>(rows);           // past n: not this row
  for (int64_t item = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x) >> 5;
       item < items; item += warps) {
    const int64_t start = starts[item / groups];
    const int c = (item % groups) * 32 + lane;
    const bool in = c < width;
    const U key = sk[start];
    uint16_t* row = slab + static_cast<int64_t>(key) * width;
    float acc = in ? BF16::load(row[c]) : 0.f;
    int64_t j0 = start;
    U ck = j0 + lane < n ? sk[j0 + lane] : other_key;
    int cp = j0 + lane < n ? sp[j0 + lane] : 0;
    bool more = true;
    while (more) {
      const unsigned other = __ballot_sync(0xffffffffu, ck != key);
      const int m = other != 0u ? __ffs(other) - 1 : 32;
      more = m == 32;
      const int64_t jn = j0 + 32 + lane;
      U nk = other_key;
      int np = 0;
      if (more && jn < n) {
        nk = sk[jn];
        np = sp[jn];
      }
      // the loads first (predicated, nothing else under the predicate,
      // so none waits on another), then the adds, in stream order
      E raw[kBatch] = {};
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int p = __shfl_sync(0xffffffffu, cp, b);
        if (b < m && in) raw[b] = vals[static_cast<int64_t>(p) * width + c];
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (b < m) {
          acc = __fadd_rn(acc, __fmul_rn(nl, bf16_round(Tv::load(raw[b]))));
        }
      }
      j0 += 32;
      ck = nk;
      cp = np;
    }
    if (in) row[c] = __bfloat16_as_ushort(__float2bfloat16_rn(acc));
  }
}

int64_t align16(int64_t b) { return (b + 15) / 16 * 16; }

struct Scratch {
  void* keys[2];
  int* pos[2];
  int* hist;
  int* partials;
  int* starts;
  int* count;     // segments listed
};

// Carves the scratch buffer (or, with base null, returns its size).
int64_t carve(void* base, int64_t n, int key_bytes, Scratch* s) {
  const int64_t sizes[] = {n * key_bytes, n * key_bytes, n * 4, n * 4,
                           radix_hist_ints(n) * 4, radix_partial_ints(n) * 4,
                           n * 4, 4};
  void* ptrs[8];
  int64_t off = 0;
  for (int i = 0; i < 8; ++i) {
    ptrs[i] = base == nullptr ? nullptr : static_cast<char*>(base) + off;
    off += align16(sizes[i]);
  }
  if (s != nullptr) {
    s->keys[0] = ptrs[0];
    s->keys[1] = ptrs[1];
    s->pos[0] = static_cast<int*>(ptrs[2]);
    s->pos[1] = static_cast<int*>(ptrs[3]);
    s->hist = static_cast<int*>(ptrs[4]);
    s->partials = static_cast<int*>(ptrs[5]);
    s->starts = static_cast<int*>(ptrs[6]);
    s->count = static_cast<int*>(ptrs[7]);
  }
  return off;
}

// Blocks of the persistent seg_rows grid: as many as stay resident.
template <typename U, typename Tv>
int persistent_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seg_rows<U, Tv>,
                                                  256, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

// 32-bit keys while `rows` (the drop key) fits, else 64-bit.
int key_bytes_of(int64_t rows) { return rows < 0xffffffffLL ? 4 : 8; }

// Bits the keys [0, rows] need, rounded up to whole radix passes.
int sort_bits(int64_t rows) {
  int bits = 8;
  while (bits < 64 && (rows >> bits) != 0) bits += 8;
  return bits;
}

template <typename IdT, typename U, typename Tv>
cudaError_t run(void* slab, int64_t rows, int width, const void* ids_v,
                int64_t n, const void* vals_v, const float* neg_lr_dev,
                void* scratch, cudaStream_t st) {
  Scratch s;
  carve(scratch, n, static_cast<int>(sizeof(U)), &s);
  U* keys[2] = {static_cast<U*>(s.keys[0]), static_cast<U*>(s.keys[1])};
  row_keys<IdT, U><<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const IdT*>(ids_v), n, rows, keys[0], s.pos[0]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  int cur = 0;
  e = radix_sort<U, true>(keys, s.pos, n, sort_bits(rows), s.hist,
                          s.partials, st, &cur);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(s.count, 0, 4, st);
  if (e != cudaSuccess) return e;
  seg_starts<U><<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      keys[cur], n, rows, s.starts, s.count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  seg_rows<U, Tv><<<persistent_blocks<U, Tv>(), 256, 0, st>>>(
      static_cast<uint16_t*>(slab), rows, width, keys[cur], s.pos[cur], n,
      static_cast<const typename Tv::E*>(vals_v), neg_lr_dev, s.starts,
      s.count);
  return cudaGetLastError();
}

template <typename IdT, typename Tv>
cudaError_t by_key(void* slab, int64_t rows, int width, const void* ids,
                   int64_t n, const void* vals, const float* nl,
                   void* scratch, cudaStream_t st) {
  return key_bytes_of(rows) == 4
      ? run<IdT, uint32_t, Tv>(slab, rows, width, ids, n, vals, nl, scratch,
                               st)
      : run<IdT, unsigned long long, Tv>(slab, rows, width, ids, n, vals, nl,
                                         scratch, st);
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of scratch detpu_sgd_promoted needs for n ids into `rows` rows.
extern "C" int64_t detpu_sgd_promoted_scratch_bytes(int64_t n, int64_t rows) {
  return carve(nullptr, n, key_bytes_of(rows), nullptr);
}

// slab [rows, width] bfloat16 (updated in place), ids [n] (int32, or int64
// when ids_is_64), vals [n, width] (vals_dtype 0 = float32, 1 = bfloat16),
// neg_lr_dev: the float32 scalar -lr on the card; n < 2^31. scratch:
// detpu_sgd_promoted_scratch_bytes(n, rows) bytes, 16-B aligned.
extern "C" int detpu_sgd_promoted(void* slab, int64_t rows, int width,
                                  const void* ids, int ids_is_64, int64_t n,
                                  const void* vals, int vals_dtype,
                                  const void* neg_lr_dev, void* scratch,
                                  void* stream) {
  if (rows <= 0 || width <= 0 || n < 0 || n > 0x7fffffffLL ||
      (vals_dtype != 0 && vals_dtype != 1) || neg_lr_dev == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const float* nl = static_cast<const float*>(neg_lr_dev);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ids_is_64) {
    return vals_dtype == 0
        ? by_key<int64_t, F32>(slab, rows, width, ids, n, vals, nl, scratch,
                               st)
        : by_key<int64_t, BF16>(slab, rows, width, ids, n, vals, nl, scratch,
                                st);
  }
  return vals_dtype == 0
      ? by_key<int32_t, F32>(slab, rows, width, ids, n, vals, nl, scratch, st)
      : by_key<int32_t, BF16>(slab, rows, width, ids, n, vals, nl, scratch,
                              st);
}
