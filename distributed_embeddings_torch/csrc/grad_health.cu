// K21: the gradient-health reduction of the train step, for Hopper
// (sm_90a).
//
// Replaces the XLA-lowered reductions over the step's gradients in
//   distributed_embeddings_tpu/parallel/trainer.py: _sq_sum (:60), which
//   the non-finite guard runs over the dense gradients and the embedding
//   cotangents (:354-359, :515-520); _table_sentinels (:67), the per-input
//   sum of squares, max |g| and non-finite count of the cotangents; and
//   the two norms of _finish_metrics (:230-232).
// One call takes a list of tensors (bfloat16 or float32, each a 2-D view
// [rows, cols] with unit column stride, or contiguous) and returns, per
// tensor i, three float32 values in out [3, n]:
//   out[0, i] = sum(float32(g)^2)   (each square and sum rounded to fp32)
//   out[1, i] = max(|g|)            (NaN when any element is NaN; 0 empty)
//   out[2, i] = count(!isfinite(g)) (exact, rounded once to float32)
// so the guard, both norms and the three sentinels come from one read of
// the gradients, each element read once in its own dtype.
//
// Design: the tensors' descriptors travel BY VALUE (a __grid_constant__
// parameter, as K19/K20's do). Pass 1 cuts every tensor into chunks of
// kChunk elements, one block a chunk (a block finds its tensor by a binary
// search over the first chunks); a thread takes groups of 16 bytes
// (8 bf16 or 4 fp32) kThreads apart and folds each group's elements in
// order, then the block folds its threads in a fixed tree (warp shuffles,
// then one warp over the warps). The block writes one partial triple.
// Pass 2, one block a tensor, folds that tensor's partials the same way.
// No float atomics and an order fixed by the shapes alone (the same
// whether a group is read as one vector or element by element), so the
// same inputs give the same bits on every run. The sum's order differs
// from the plain version's, so the two agree within float32 rounding;
// the max and the count are exact.
// max(|g|) folds with a NaN-propagating max (fmaxf drops NaN; jnp.max
// does not). A finite gradient whose squares overflow float32 gives an
// infinite sum, as JAX's does, and the guard skips the step.
//
// Bound: bytes. Each element is read once (the DLRM step: 26 bf16
// [65536, 128] cotangents and ~2.4M fp32 dense gradients, ~446 MB,
// 0.133 ms at 3.35 TB/s); the partials are 12 bytes a chunk.
//
// C interface (ctypes): the descriptors as a host pointer to int64
// [n, 6] (address, numel, cols, row stride, first chunk, dtype code), the
// partials and out as device pointers, the stream as void*; returns the
// cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 16384;  // elements a pass-1 block folds
constexpr int kMaxTensors = 512;   // descriptors a call takes (48 B each)
constexpr int kBatch = 4;          // groups a thread loads before folding

struct Desc {
  int64_t ptr;     // address of element 0
  int64_t numel;   // elements
  int64_t cols;    // elements a row (numel when contiguous)
  int64_t stride;  // elements between rows
  int64_t chunk0;  // this tensor's first chunk
  int32_t dtype;   // 0 float32, 1 bfloat16
  int32_t vec;     // 16-byte loads allowed (address, cols, stride aligned)
};

template <int CAP>
struct Params {
  int64_t n;
  int64_t chunks;
  Desc d[CAP];
};

struct Triple {
  float sq;
  float mx;
  uint32_t nf;
};

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ void fold(Triple& t, float x) {
  t.sq = __fadd_rn(t.sq, __fmul_rn(x, x));
  t.mx = max_nan(t.mx, fabsf(x));
  t.nf += (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u ? 1u : 0u;
}

__device__ __forceinline__ Triple combine(Triple a, const Triple& b) {
  a.sq = __fadd_rn(a.sq, b.sq);
  a.mx = max_nan(a.mx, b.mx);
  a.nf += b.nf;
  return a;
}

// Fixed-tree fold of one Triple a thread over the block; thread 0 gets
// the result.
__device__ Triple block_fold(Triple t) {
  __shared__ Triple warps[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    Triple u;
    u.sq = __shfl_down_sync(0xffffffffu, t.sq, o);
    u.mx = __shfl_down_sync(0xffffffffu, t.mx, o);
    u.nf = __shfl_down_sync(0xffffffffu, t.nf, o);
    t = combine(t, u);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = t;
  __syncthreads();
  if (warp == 0) {
    t = lane < kThreads / 32 ? warps[lane] : Triple{0.0f, 0.0f, 0u};
    for (int o = 16; o > 0; o >>= 1) {
      Triple u;
      u.sq = __shfl_down_sync(0xffffffffu, t.sq, o);
      u.mx = __shfl_down_sync(0xffffffffu, t.mx, o);
      u.nf = __shfl_down_sync(0xffffffffu, t.nf, o);
      t = combine(t, u);
    }
  }
  return t;
}

__device__ __forceinline__ float load1(const Desc& d, int64_t e) {
  const int64_t at = d.cols == d.numel ? e : e / d.cols * d.stride +
                                             e % d.cols;
  if (d.dtype == 1) {
    return __bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(d.ptr)[at]);
  }
  return reinterpret_cast<const float*>(d.ptr)[at];
}

// One chunk of one tensor: groups of G elements (16 bytes), kThreads
// apart, folded in element order.
template <typename T, int G>
__device__ Triple fold_chunk(const Desc& d, int64_t begin, int64_t len) {
  Triple t{0.0f, 0.0f, 0u};
  const int64_t groups = (len + G - 1) / G;
  for (int64_t g0 = threadIdx.x; g0 < groups;
       g0 += static_cast<int64_t>(kThreads) * kBatch) {
    uint4 v[kBatch];
    bool full[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int64_t g = g0 + static_cast<int64_t>(b) * kThreads;
      full[b] = d.vec && g < groups && (g + 1) * G <= len;
      if (full[b]) {
        const int64_t e = begin + g * G;
        const int64_t at = d.cols == d.numel
            ? e : e / d.cols * d.stride + e % d.cols;
        v[b] = __ldg(reinterpret_cast<const uint4*>(
            reinterpret_cast<const T*>(d.ptr) + at));
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int64_t g = g0 + static_cast<int64_t>(b) * kThreads;
      if (g >= groups) continue;
      if (full[b]) {
        if constexpr (G == 8) {
          const __nv_bfloat162* h =
              reinterpret_cast<const __nv_bfloat162*>(&v[b]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 f = __bfloat1622float2(h[q]);
            fold(t, f.x);
            fold(t, f.y);
          }
        } else {
          fold(t, __uint_as_float(v[b].x));
          fold(t, __uint_as_float(v[b].y));
          fold(t, __uint_as_float(v[b].z));
          fold(t, __uint_as_float(v[b].w));
        }
      } else {
        const int64_t e0 = g * G;
        const int64_t e1 = e0 + G < len ? e0 + G : len;
        for (int64_t e = e0; e < e1; ++e) fold(t, load1(d, begin + e));
      }
    }
  }
  return t;
}

// Pass 1: block b folds chunk b into partials[b].
template <int CAP>
__global__ void __launch_bounds__(kThreads)
health_partials_kernel(const __grid_constant__ Params<CAP> p,
                       Triple* __restrict__ partials) {
  const int64_t chunk = blockIdx.x;
  // the last tensor whose first chunk is at or before this one (a tensor
  // without elements owns no chunk, and the next one starts where it
  // would have)
  int lo = 0;
  int hi = static_cast<int>(p.n) - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.d[mid].chunk0 <= chunk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Desc& d = p.d[lo];
  const int64_t begin = (chunk - d.chunk0) * kChunk;
  const int64_t len = d.numel - begin < kChunk ? d.numel - begin : kChunk;
  const Triple t = d.dtype == 1 ? fold_chunk<__nv_bfloat16, 8>(d, begin, len)
                                : fold_chunk<float, 4>(d, begin, len);
  const Triple r = block_fold(t);
  if (threadIdx.x == 0) partials[chunk] = r;
}

// Pass 2: block i folds tensor i's partials, in chunk order per thread
// and the fixed tree over threads, into out[:, i].
template <int CAP>
__global__ void __launch_bounds__(kThreads)
health_final_kernel(const __grid_constant__ Params<CAP> p,
                    const Triple* __restrict__ partials,
                    float* __restrict__ out) {
  const int i = blockIdx.x;
  const Desc& d = p.d[i];
  const int64_t count = (d.numel + kChunk - 1) / kChunk;
  Triple t{0.0f, 0.0f, 0u};
  for (int64_t c = threadIdx.x; c < count; c += kThreads) {
    t = combine(t, partials[d.chunk0 + c]);
  }
  const Triple r = block_fold(t);
  if (threadIdx.x == 0) {
    const int64_t n = p.n;
    out[i] = r.sq;
    out[n + i] = r.mx;
    out[2 * n + i] = __uint2float_rn(r.nf);
  }
}

template <int CAP>
cudaError_t launch_cap(const int64_t* descs, int n, int64_t chunks,
                       void* partials, void* out, cudaStream_t st) {
  Params<CAP> p;
  p.n = n;
  p.chunks = chunks;
  memcpy(p.d, descs, sizeof(Desc) * static_cast<size_t>(n));
  if (chunks > 0) {
    health_partials_kernel<CAP>
        <<<static_cast<unsigned>(chunks), kThreads, 0, st>>>(
            p, static_cast<Triple*>(partials));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  health_final_kernel<CAP><<<static_cast<unsigned>(n), kThreads, 0, st>>>(
      p, static_cast<const Triple*>(partials), static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most tensors one call takes.
extern "C" int detpu_grad_health_max_tensors() { return kMaxTensors; }

// The elements a chunk (a pass-1 block) covers.
extern "C" int64_t detpu_grad_health_chunk() { return kChunk; }

// K21 over n tensors: descs int64 [n, 6] on the host (address, numel,
// cols, row stride, first chunk, dtype code | vec << 32), chunks the
// total of ceil(numel / chunk); partials: 12 bytes a chunk; out float32
// [3, n].
extern "C" int detpu_grad_health(const int64_t* descs, int n, int64_t chunks,
                                 void* partials, void* out, void* stream) {
  if (n <= 0 || n > kMaxTensors || chunks < 0 || chunks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  int64_t next = 0;
  for (int i = 0; i < n; ++i) {
    const Desc* d = reinterpret_cast<const Desc*>(descs) + i;
    if (d->numel < 0 || (d->numel > 0 && (d->ptr == 0 || d->cols <= 0 ||
                                          d->stride < d->cols)) ||
        d->chunk0 != next || (d->dtype != 0 && d->dtype != 1)) {
      return cudaErrorInvalidValue;
    }
    next += (d->numel + kChunk - 1) / kChunk;
  }
  if (next != chunks || (chunks > 0 && partials == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 16) return launch_cap<16>(descs, n, chunks, partials, out, st);
  if (n <= 128) return launch_cap<128>(descs, n, chunks, partials, out, st);
  return launch_cap<kMaxTensors>(descs, n, chunks, partials, out, st);
}
