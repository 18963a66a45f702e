// K3: sparse SGD scatter-add, for Hopper (sm_90a).
//
// Replaces the XLA-lowered row scatter of the JAX package:
//   distributed_embeddings_tpu/parallel/optimizers.py:_sorted_scatter_add
//   distributed_embeddings_tpu/parallel/optimizers.py:SparseSGD.apply_rows
// which computes slab.at[ids].add(-lr * vals.astype(slab.dtype),
// mode="drop"). For every stream row i whose id lies in the slab (a
// negative id counts from the end once, as JAX indexing does; anything
// else outside [0, rows) is dropped, the dropped-row sentinel included)
// it adds round(nl * round(vals[i])) to slab[id] in the slab's dtype,
// where nl is -lr: rounded to the slab dtype by the wrapper for a
// constant lr, or the fp32 -lr the kernel reads for a device scalar lr.
// Each atomic add rounds to the slab dtype, as the JAX scatter does
// after every add; duplicate ids add in another order than XLA's.
//
// With cast_vals = 0 the update is that of SparseSGD's DETPU_SGD_DEDUP
// branch, slab.at[uids].add((-lr * uvals).astype(slab.dtype)): vals are
// NOT rounded to the slab dtype first; the product rounds to the vals
// dtype for a constant lr (nl rounded to it by the wrapper), stays
// float32 for a device scalar lr, and rounds once to the slab dtype.
//
// Bound: bytes. Each stream row reads its update row and its id and
// reads and writes the slab row it hits: about one operation per byte.
// Design: a group of G lanes per stream row, each lane loading 16 B of
// update row and adding it with vector atomics (bfloat16 x2 or
// float4, both native on compute capability 9.x), so one bf16 row of
// 128 is a 16-lane group and a warp serves two rows. Duplicate ids
// (Zipfian streams repeat hot rows) resolve in the L2's atomic units
// without a sort. Row arithmetic is int64: 187.8M rows x 128 elements is
// 2.4e10 elements.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

struct F32 {
  using E = float;
  __device__ static float load(E v) { return v; }
  // the float value of f rounded to this dtype
  __device__ static float rnd(float f) { return f; }
};

struct BF16 {
  using E = uint16_t;  // raw bf16 bits
  __device__ static float load(E v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  __device__ static float rnd(float f) {
    return __bfloat162float(__float2bfloat16_rn(f));
  }
};

// copy BYTES bytes (a multiple of 2, at most 32) from aligned global src
template <int BYTES>
__device__ __forceinline__ void load_raw(void* dst, const void* src) {
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k) {
      const uint4 t = __ldg(static_cast<const uint4*>(src) + k);
      memcpy(static_cast<char*>(dst) + 16 * k, &t, 16);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 t = __ldg(static_cast<const uint2*>(src));
    memcpy(dst, &t, 8);
  } else if constexpr (BYTES == 4) {
    const uint32_t t = __ldg(static_cast<const unsigned int*>(src));
    memcpy(dst, &t, 4);
  } else {
    static_assert(BYTES == 2, "load_raw: 2, 4, 8, 16 or 32 bytes");
    const uint16_t t = __ldg(static_cast<const unsigned short*>(src));
    memcpy(dst, &t, 2);
  }
}

// add CH already-rounded values u to CH slab elements at p
template <int CH>
__device__ __forceinline__ void atomic_add(float* p, const float* u) {
  if constexpr (CH == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(u[0], u[1], u[2], u[3]));
  } else {
#pragma unroll
    for (int e = 0; e < CH; ++e) atomicAdd(p + e, u[e]);
  }
}

template <int CH>
__device__ __forceinline__ void atomic_add(uint16_t* p, const float* u) {
  if constexpr (CH % 2 == 0) {
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
#pragma unroll
    for (int k = 0; k < CH / 2; ++k) {
      atomicAdd(q + k, __floats2bfloat162_rn(u[2 * k], u[2 * k + 1]));
    }
  } else {
    __nv_bfloat16* q = reinterpret_cast<__nv_bfloat16*>(p);
#pragma unroll
    for (int e = 0; e < CH; ++e) atomicAdd(q + e, __float2bfloat16_rn(u[e]));
  }
}

template <typename Ts, typename Tv, typename IdT, bool VEC>
__global__ void __launch_bounds__(256)
sgd_scatter_kernel(typename Ts::E* __restrict__ slab, int64_t rows,
                   int width, const IdT* __restrict__ ids, int64_t n,
                   const typename Tv::E* __restrict__ vals, float neg_lr,
                   const float* __restrict__ neg_lr_dev, int group_log2,
                   int cast_vals) {
  using SE = typename Ts::E;
  using VE = typename Tv::E;
  // elements per lane step: 16 B of slab row, or one element
  constexpr int CH = VEC ? 16 / static_cast<int>(sizeof(SE)) : 1;
  const int G = 1 << group_log2;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t i = tid >> group_log2;  // stream row
  if (i >= n) return;
  int64_t id = static_cast<int64_t>(ids[i]);
  if (id < 0) id += rows;                 // JAX counts negatives from the end
  if (id < 0 || id >= rows) return;       // mode="drop" (and the sentinel)
  const float nl = neg_lr_dev != nullptr ? __ldg(neg_lr_dev) : neg_lr;
  const int lane = static_cast<int>(tid & (G - 1));
  SE* row = slab + id * width;
  const VE* v = vals + i * width;
  for (int c = lane * CH; c < width; c += G * CH) {
    VE raw[CH];
    load_raw<CH * static_cast<int>(sizeof(VE))>(raw, v + c);
    float u[CH];
#pragma unroll
    for (int e = 0; e < CH; ++e) {
      const float x = Tv::load(raw[e]);
      if (cast_vals) {
        u[e] = Ts::rnd(__fmul_rn(nl, Ts::rnd(x)));
      } else {
        const float p = __fmul_rn(nl, x);
        u[e] = Ts::rnd(neg_lr_dev != nullptr ? p : Tv::rnd(p));
      }
    }
    atomic_add<CH>(row + c, u);
  }
}

template <typename Ts, typename Tv, typename IdT>
cudaError_t launch(void* slab, int64_t rows, int width, const void* ids,
                   int64_t n, const void* vals, float neg_lr,
                   const float* neg_lr_dev, int cast_vals,
                   cudaStream_t stream) {
  using SE = typename Ts::E;
  using VE = typename Tv::E;
  constexpr int CH = 16 / static_cast<int>(sizeof(SE));
  constexpr int VB = CH * static_cast<int>(sizeof(VE)) < 16
                         ? CH * static_cast<int>(sizeof(VE)) : 16;
  const bool vec = width % CH == 0 &&
                   reinterpret_cast<uintptr_t>(slab) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % VB == 0;
  const int chunks = vec ? width / CH : width;
  int group_log2 = 0;
  while ((1 << group_log2) < chunks && group_log2 < 5) ++group_log2;
  const int64_t blocks = ((n << group_log2) + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const unsigned grid = static_cast<unsigned>(blocks);
  SE* s = static_cast<SE*>(slab);
  const IdT* d = static_cast<const IdT*>(ids);
  const VE* v = static_cast<const VE*>(vals);
  if (vec) {
    sgd_scatter_kernel<Ts, Tv, IdT, true><<<grid, 256, 0, stream>>>(
        s, rows, width, d, n, v, neg_lr, neg_lr_dev, group_log2, cast_vals);
  } else {
    sgd_scatter_kernel<Ts, Tv, IdT, false><<<grid, 256, 0, stream>>>(
        s, rows, width, d, n, v, neg_lr, neg_lr_dev, group_log2, cast_vals);
  }
  return cudaGetLastError();
}

template <typename Ts, typename Tv>
cudaError_t by_ids(bool ids64, void* slab, int64_t rows, int width,
                   const void* ids, int64_t n, const void* vals, float neg_lr,
                   const float* neg_lr_dev, int cast_vals,
                   cudaStream_t stream) {
  return ids64 ? launch<Ts, Tv, int64_t>(slab, rows, width, ids, n, vals,
                                         neg_lr, neg_lr_dev, cast_vals,
                                         stream)
               : launch<Ts, Tv, int32_t>(slab, rows, width, ids, n, vals,
                                         neg_lr, neg_lr_dev, cast_vals,
                                         stream);
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// slab [rows, width] (updated in place), ids [n], vals [n, width];
// slab_dtype / vals_dtype: 0 = float32, 1 = bfloat16; ids_is_64: ids
// are int64 (else int32). neg_lr is used when neg_lr_dev is null;
// otherwise the update reads the fp32 scalar -lr at neg_lr_dev.
// cast_vals: 1 rounds vals to the slab dtype before the product (the
// stream update), 0 takes the dedup branch's chain (see the header).
extern "C" int detpu_sgd_scatter(void* slab, int64_t rows, int width,
                                 int slab_dtype, const void* ids,
                                 int ids_is_64, int64_t n, const void* vals,
                                 int vals_dtype, float neg_lr,
                                 const void* neg_lr_dev, int cast_vals,
                                 void* stream) {
  if (rows <= 0 || width <= 0 || n < 0 || (slab_dtype != 0 &&
      slab_dtype != 1) || (vals_dtype != 0 && vals_dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const bool i64 = ids_is_64 != 0;
  const float* lr = static_cast<const float*>(neg_lr_dev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cv = cast_vals != 0;
  if (slab_dtype == 0) {
    return vals_dtype == 0
        ? by_ids<F32, F32>(i64, slab, rows, width, ids, n, vals, neg_lr, lr,
                           cv, s)
        : by_ids<F32, BF16>(i64, slab, rows, width, ids, n, vals, neg_lr, lr,
                            cv, s);
  }
  return vals_dtype == 0
      ? by_ids<BF16, F32>(i64, slab, rows, width, ids, n, vals, neg_lr, lr,
                          cv, s)
      : by_ids<BF16, BF16>(i64, slab, rows, width, ids, n, vals, neg_lr, lr,
                           cv, s);
}
