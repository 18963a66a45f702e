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
// Bound: bytes, and small: at the ragged DLRM's shapes (26 slots of
// 65,536 rows) lengths -> splits reads 6.8 MB and writes 13.6 MB.
// Design:
//   * lengths -> splits: one 1024-thread block per slot; each thread
//     sums a contiguous chunk of the slot's lengths, a block-wide scan of
//     the chunk sums (warp shuffles, then one warp over the 32 warp
//     totals) gives each chunk its offset, and each thread writes its
//     chunk's running sums. Sums are int64. A slot whose `valid` flag is
//     0 gets zero lengths, as the JAX decode multiplies them by it.
//   * row_to_split: one thread per target row t in [0, dim_0], a binary
//     search for the first COO row id >= t (searchsorted side="left");
//     padding rows (>= dim_0) fall past the end.
//   * ragged_row_ids: one thread per value position p, a binary search
//     for the number of row ends, clipped to [0, cap], at or before p:
//     exactly the JAX marks/cumsum result for splits that do not
//     decrease. Positions past the last clipped end get nrows.
// Index arithmetic is int64 throughout.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ int64_t ld(const void* p, int64_t i) {
  return static_cast<int64_t>(static_cast<const T*>(p)[i]);
}

__device__ __forceinline__ int64_t ld_any(const void* p, int is64,
                                          int64_t i) {
  return is64 ? ld<int64_t>(p, i) : ld<int32_t>(p, i);
}

__device__ __forceinline__ void st_any(void* p, int is64, int64_t i,
                                       int64_t v) {
  if (is64) {
    static_cast<int64_t*>(p)[i] = v;
  } else {
    static_cast<int32_t*>(p)[i] = static_cast<int32_t>(v);
  }
}

constexpr int kScanThreads = 1024;

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
    const int nw = blockDim.x >> 5;
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
  *total = warp_sums[(blockDim.x >> 5) - 1];
  return before + incl - x;
}

__global__ void __launch_bounds__(kScanThreads)
lengths_to_splits_kernel(const void* lengths, int len_is_64,
                         int64_t slot_stride, int64_t b, const int* valid,
                         int64_t* splits) {
  const int slot = blockIdx.x;
  const bool live = valid == nullptr || valid[slot] != 0;
  const int64_t chunk = (b + blockDim.x - 1) / blockDim.x;
  const int64_t lo = static_cast<int64_t>(threadIdx.x) * chunk;
  const int64_t hi = lo + chunk < b ? lo + chunk : b;
  const int64_t base = static_cast<int64_t>(slot) * slot_stride;
  int64_t part = 0;
  if (live) {
    for (int64_t i = lo; i < hi; ++i) {
      part += ld_any(lengths, len_is_64, base + i);
    }
  }
  int64_t total;
  int64_t run = block_exclusive_scan(part, &total);
  int64_t* out = splits + static_cast<int64_t>(slot) * (b + 1);
  if (threadIdx.x == 0) out[0] = 0;
  for (int64_t i = lo; i < hi; ++i) {
    if (live) run += ld_any(lengths, len_is_64, base + i);
    out[i + 1] = run;
  }
}

__global__ void row_to_split_kernel(const void* rows, int rows_is_64,
                                    int64_t stride, int64_t nnz,
                                    int64_t dim0, void* splits,
                                    int out_is_64) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t > dim0) return;
  // first k with rows[k] >= t
  int64_t lo = 0, hi = nnz;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (ld_any(rows, rows_is_64, mid * stride) < t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  st_any(splits, out_is_64, t, lo);
}

__global__ void ragged_row_ids_kernel(const void* splits, int is64,
                                      int n_slots, int64_t nrows,
                                      int64_t cap, void* out) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (q >= static_cast<int64_t>(n_slots) * cap) return;
  const int64_t slot = q / cap;
  const int64_t p = q - slot * cap;
  const int64_t ends = slot * (nrows + 1) + 1;  // splits[slot, 1:]
  // number of r < nrows with clip(ends[r], 0, cap) <= p
  int64_t lo = 0, hi = nrows;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    int64_t e = ld_any(splits, is64, ends + mid);
    e = e < 0 ? 0 : (e > cap ? cap : e);
    if (e <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  st_any(out, is64, q, lo);
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lengths [n, b] with row stride slot_stride (elements), int32/int64;
// valid [n] int32 or null; splits [n, b + 1] int64.
extern "C" int detpu_lengths_to_splits(const void* lengths, int len_is_64,
                                       int64_t slot_stride, int n_slots,
                                       int64_t b, const void* valid,
                                       void* splits, void* stream) {
  if (n_slots < 0 || b < 0 || slot_stride < b) return cudaErrorInvalidValue;
  if (n_slots == 0) return cudaSuccess;
  lengths_to_splits_kernel<<<n_slots, kScanThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      lengths, len_is_64, slot_stride, b, static_cast<const int*>(valid),
      static_cast<int64_t*>(splits));
  return cudaGetLastError();
}

// rows: the COO row ids, element k at rows[k * stride] (stride 2 for
// [nnz, 2] indices), ascending; splits [dim0 + 1].
extern "C" int detpu_row_to_split(const void* rows, int rows_is_64,
                                  int64_t stride, int64_t nnz, int64_t dim0,
                                  void* splits, int out_is_64,
                                  void* stream) {
  if (nnz < 0 || dim0 < 0 || stride < 1) return cudaErrorInvalidValue;
  const int64_t blocks = (dim0 + 1 + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  row_to_split_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      rows, rows_is_64, stride, nnz, dim0, splits, out_is_64);
  return cudaGetLastError();
}

// splits [n, nrows + 1] and out [n, cap], both int32 or both int64.
extern "C" int detpu_ragged_row_ids(const void* splits, int is64,
                                    int n_slots, int64_t nrows, int64_t cap,
                                    void* out, void* stream) {
  if (n_slots < 0 || nrows < 0 || cap < 0) return cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(n_slots) * cap;
  if (total == 0) return cudaSuccess;
  const int64_t blocks = (total + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  ragged_row_ids_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      splits, is64, n_slots, nrows, cap, out);
  return cudaGetLastError();
}
