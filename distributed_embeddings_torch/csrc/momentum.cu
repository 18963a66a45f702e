// K12: the momentum row update of SparseMomentum (lazy traces), for
// Hopper (sm_90a).
//
// Replaces the XLA-lowered body of
//   distributed_embeddings_tpu/parallel/optimizers.py:
//   SparseMomentum.apply_rows
// after its dedup (K5): per unique row of the dedup output (optax.trace
// numerics),
//   trace[id] = g + m*trace
//   slab[id] -= lr * (trace            , or with Nesterov
//                     g + m*trace_new)
// (take(mode="clip") reads, .at[].set/.add(mode="drop") writes).
//
// Arithmetic, per element, with JAX's rounding chain: g and the trace
// are in the trace dtype A, m arrives rounded to A, and every product and
// sum rounds to A (a bf16 chain rounds after each op):
//   t' = rA(g + rA(m*t));   step = t'  or  rA(g + rA(m*t'))
// A constant lr is rounded to A and the product -lr*step rounds to A; a
// float32 device lr (a schedule's) promotes the product to float32. The
// update rounds once to the slab dtype S before the slab add:
//   slab = rS(slab + rS(rA(-lr*step)))   or   rS(slab + rS(-lr*step))
// The _rn intrinsics keep FMA contraction out.
//
// Index rules (as K6 and K11): an id >= rows is skipped; a negative id
// reads row 0 (clip) and writes row id + rows, and one still negative is
// skipped.
//
// Bound: bytes. Per unique row the kernel reads the gradient, trace and
// slab rows and writes the trace and slab rows. Design: as K11, a group
// of G lanes per unique row, 16-byte (float32) or 8-byte (bf16) loads
// where width and alignment allow (V = 4), single elements otherwise.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The build (ops/_kernels.py) names each library by the hash of its one
// source, so no source includes a header of the repo: these load and
// store helpers repeat those of adam.cu.
struct F32 {
  using E = float;
  __device__ static float load(E v) { return v; }
  __device__ static E store(float f) { return f; }
  __device__ static float rnd(float f) { return f; }
  __device__ static void load4(const E* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static void store4(E* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

struct BF16 {
  using E = uint16_t;  // raw bf16 bits
  __device__ static float load(E v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  __device__ static E store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  __device__ static float rnd(float f) {
    return __bfloat162float(__float2bfloat16_rn(f));
  }
  __device__ static void load4(const E* p, float* f) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  __device__ static void store4(E* p, const float* f) {
    uint2 v;
    v.x = static_cast<uint32_t>(store(f[0])) |
          (static_cast<uint32_t>(store(f[1])) << 16);
    v.y = static_cast<uint32_t>(store(f[2])) |
          (static_cast<uint32_t>(store(f[3])) << 16);
    *reinterpret_cast<uint2*>(p) = v;
  }
};

template <typename T, int V>
__device__ __forceinline__ void ld(const typename T::E* p, float* f) {
  if constexpr (V == 4) {
    T::load4(p, f);
  } else {
    f[0] = T::load(*p);
  }
}

template <typename T, int V>
__device__ __forceinline__ void st(typename T::E* p, const float* f) {
  if constexpr (V == 4) {
    T::store4(p, f);
  } else {
    *p = T::store(f[0]);
  }
}

template <typename TS, typename TA, typename IdT, int V>
__global__ void __launch_bounds__(256)
momentum_rows_kernel(typename TS::E* __restrict__ slab,
                     typename TA::E* __restrict__ trace, int64_t rows,
                     int width, const IdT* __restrict__ uids, int64_t u,
                     const typename TA::E* __restrict__ ug, float m,
                     int nesterov, float neg_lr,
                     const float* __restrict__ lr_dev, int group_log2) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t s = tid >> group_log2;  // unique row
  if (s >= u) return;
  const int64_t id = static_cast<int64_t>(uids[s]);
  if (id >= rows) return;                      // sentinel, pad tail, past
  const int64_t wr = id < 0 ? id + rows : id;  // drop mode wraps once
  if (wr < 0) return;
  const int64_t rd = id < 0 ? 0 : id;          // take(mode="clip")
  const bool dev_lr = lr_dev != nullptr;
  const float nl = dev_lr ? -__ldg(lr_dev) : neg_lr;
  const int G = 1 << group_log2;
  for (int c = static_cast<int>(tid & (G - 1)) * V; c < width; c += G * V) {
    float g[V], t[V], p[V];
    ld<TA, V>(ug + s * width + c, g);
    ld<TA, V>(trace + rd * width + c, t);
    ld<TS, V>(slab + wr * width + c, p);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float tn = TA::rnd(__fadd_rn(g[k], TA::rnd(__fmul_rn(m, t[k]))));
      const float step =
          nesterov ? TA::rnd(__fadd_rn(g[k], TA::rnd(__fmul_rn(m, tn))))
                   : tn;
      const float upd = dev_lr ? __fmul_rn(nl, step)
                               : TA::rnd(__fmul_rn(nl, step));
      p[k] = __fadd_rn(p[k], TS::rnd(upd));
      t[k] = tn;
    }
    st<TA, V>(trace + wr * width + c, t);
    st<TS, V>(slab + wr * width + c, p);
  }
}

struct Args {
  void* slab;
  void* trace;
  int64_t rows;
  int width;
  const void* uids;
  bool ids64;
  int64_t u;
  const void* ug;
  float m;
  int nesterov;
  float neg_lr;
  const float* lr_dev;
  bool vec;
};

template <typename TS, typename TA, typename IdT, int V>
cudaError_t launch_v(const Args& a, cudaStream_t st) {
  int group_log2 = 0;
  const int chunks = (a.width + V - 1) / V;
  while ((1 << group_log2) < chunks && group_log2 < 5) ++group_log2;
  const int64_t blocks = ((a.u << group_log2) + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  momentum_rows_kernel<TS, TA, IdT, V>
      <<<static_cast<unsigned>(blocks), 256, 0, st>>>(
          static_cast<typename TS::E*>(a.slab),
          static_cast<typename TA::E*>(a.trace), a.rows, a.width,
          static_cast<const IdT*>(a.uids), a.u,
          static_cast<const typename TA::E*>(a.ug), a.m, a.nesterov,
          a.neg_lr, a.lr_dev, group_log2);
  return cudaGetLastError();
}

template <typename TS, typename TA>
cudaError_t launch(const Args& a, cudaStream_t st) {
  if (a.ids64) {
    return a.vec ? launch_v<TS, TA, int64_t, 4>(a, st)
                 : launch_v<TS, TA, int64_t, 1>(a, st);
  }
  return a.vec ? launch_v<TS, TA, int32_t, 4>(a, st)
               : launch_v<TS, TA, int32_t, 1>(a, st);
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// slab [rows, width] (slab_dtype) and trace [rows, width] (tr_dtype),
// updated in place; uids [u] (int32, or int64 when ids_is_64), ugrads
// [u, width] in tr_dtype. Dtype codes: 0 = float32, 1 = bfloat16. m and
// neg_lr (-lr) rounded to tr_dtype by the caller; lr_dev (nullable) a
// float32 lr on the card, used instead of neg_lr. vec: every pointer is
// aligned to 4 elements and width % 4 == 0.
extern "C" int detpu_momentum_rows(void* slab, int slab_dtype, void* trace,
                                   int tr_dtype, int64_t rows, int width,
                                   const void* uids, int ids_is_64,
                                   int64_t u, const void* ugrads, float m,
                                   int nesterov, float neg_lr,
                                   const void* lr_dev, int vec,
                                   void* stream) {
  if (rows <= 0 || width <= 0 || u < 0 ||
      (slab_dtype != 0 && slab_dtype != 1) ||
      (tr_dtype != 0 && tr_dtype != 1) || (vec != 0 && width % 4 != 0)) {
    return cudaErrorInvalidValue;
  }
  if (u == 0) return cudaSuccess;
  const Args a{slab, trace, rows, width, uids, ids_is_64 != 0, u, ugrads,
               m, nesterov, neg_lr, static_cast<const float*>(lr_dev),
               vec != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slab_dtype == 0) {
    return tr_dtype == 0 ? launch<F32, F32>(a, st) : launch<F32, BF16>(a, st);
  }
  return tr_dtype == 0 ? launch<BF16, F32>(a, st) : launch<BF16, BF16>(a, st);
}
