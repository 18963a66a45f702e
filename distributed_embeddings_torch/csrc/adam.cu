// K11: the Adam row update of SparseAdam (lazy moments), for Hopper
// (sm_90a).
//
// Replaces the XLA-lowered body of
//   distributed_embeddings_tpu/parallel/optimizers.py:SparseAdam.apply_rows
// after its dedup (K5): per unique row of the dedup output,
//   mu[id] = b1*mu + (1-b1)*g;  nu[id] = b2*nu + (1-b2)*g*g
//   slab[id] -= lr * (mu/c1) / (sqrt(nu/c2 + eps_root) + eps)
// with c1 = 1 - b1^t, c2 = 1 - b2^t from the slab's global step count t
// (the LazyAdam convention; take(mode="clip") reads, .at[].set/.add(
// mode="drop") writes).
//
// Arithmetic, per element, with JAX's rounding chain: g and the moments
// are in the moment dtype A; b1, 1-b1, b2 and 1-b2 arrive rounded to A;
// every moment product and sum rounds to A (a bf16 chain rounds after
// each op):
//   mu' = rA(rA(b1*mu) + rA(omb1*g))
//   nu' = rA(rA(b2*nu) + rA(rA(omb2*g)*g))
// The step count is float32, so the bias-corrected update promotes to
// float32 and rounds once to the slab dtype S before the slab add:
//   u = (lr * (mu'/c1)) / (sqrt(nu'/c2 + eps_root) + eps)   (float32)
//   slab = rS(slab - rS(u))
// lr (a constant, or a float32 device lr), eps and eps_root are float32;
// b1^t and b2^t are read on the device (the wrapper computes them from
// the count on the card, one way for the kernel and its plain version)
// and c = 1 - b^t is formed here, so nothing syncs with the host.
// Products, sums, quotients and the square root use the _rn intrinsics:
// no FMA contracts them, and each is correctly rounded as PyTorch's
// elementwise ops are.
//
// Index rules: an id >= rows (the dropped-row sentinel, the dedup's pad
// tail, ids past the slab) is skipped; a negative id reads row 0 (clip)
// and writes row id + rows (JAX's drop mode wraps once), and one still
// negative is skipped.
//
// Bound: bytes. Per unique row the kernel reads the gradient row, the
// two moment rows and the slab row and writes the three state rows back.
// Design: each unique row gets a group of G lanes (G the number of
// 4-element chunks of a row rounded up to a power of two, at most 32),
// each lane moving 16 bytes of a float32 row (8 of a bf16 one) per load
// where the width and the pointers' alignment allow it (V = 4), single
// elements otherwise (V = 1).
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The build (ops/_kernels.py) names each library by the hash of its one
// source, so no source includes a header of the repo: these load and
// store helpers repeat those of momentum.cu.
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
adam_rows_kernel(typename TS::E* __restrict__ slab,
                 typename TA::E* __restrict__ mu,
                 typename TA::E* __restrict__ nu, int64_t rows, int width,
                 const IdT* __restrict__ uids, int64_t u,
                 const typename TA::E* __restrict__ ug, float b1, float omb1,
                 float b2, float omb2, const float* __restrict__ bp, float lr,
                 const float* __restrict__ lr_dev, float eps, float eps_root,
                 int group_log2) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t s = tid >> group_log2;  // unique row
  if (s >= u) return;
  const int64_t id = static_cast<int64_t>(uids[s]);
  if (id >= rows) return;                      // sentinel, pad tail, past
  const int64_t wr = id < 0 ? id + rows : id;  // drop mode wraps once
  if (wr < 0) return;
  const int64_t rd = id < 0 ? 0 : id;          // take(mode="clip")
  const float c1 = __fsub_rn(1.0f, __ldg(bp));
  const float c2 = __fsub_rn(1.0f, __ldg(bp + 1));
  const float l = lr_dev != nullptr ? __ldg(lr_dev) : lr;
  const int G = 1 << group_log2;
  for (int c = static_cast<int>(tid & (G - 1)) * V; c < width; c += G * V) {
    float g[V], m[V], n[V], p[V];
    ld<TA, V>(ug + s * width + c, g);
    ld<TA, V>(mu + rd * width + c, m);
    ld<TA, V>(nu + rd * width + c, n);
    ld<TS, V>(slab + wr * width + c, p);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float mn = TA::rnd(__fadd_rn(TA::rnd(__fmul_rn(b1, m[k])),
                                         TA::rnd(__fmul_rn(omb1, g[k]))));
      const float g2 = TA::rnd(__fmul_rn(TA::rnd(__fmul_rn(omb2, g[k])),
                                         g[k]));
      const float nn = TA::rnd(__fadd_rn(TA::rnd(__fmul_rn(b2, n[k])), g2));
      const float den = __fadd_rn(
          __fsqrt_rn(__fadd_rn(__fdiv_rn(nn, c2), eps_root)), eps);
      const float upd = __fdiv_rn(__fmul_rn(l, __fdiv_rn(mn, c1)), den);
      p[k] = __fsub_rn(p[k], TS::rnd(upd));
      m[k] = mn;
      n[k] = nn;
    }
    st<TA, V>(mu + wr * width + c, m);
    st<TA, V>(nu + wr * width + c, n);
    st<TS, V>(slab + wr * width + c, p);
  }
}

struct Args {
  void* slab;
  void* mu;
  void* nu;
  int64_t rows;
  int width;
  const void* uids;
  bool ids64;
  int64_t u;
  const void* ug;
  float b1, omb1, b2, omb2;
  const float* bp;
  float lr;
  const float* lr_dev;
  float eps, eps_root;
  bool vec;
};

template <typename TS, typename TA, typename IdT, int V>
cudaError_t launch_v(const Args& a, cudaStream_t st) {
  int group_log2 = 0;
  const int chunks = (a.width + V - 1) / V;
  while ((1 << group_log2) < chunks && group_log2 < 5) ++group_log2;
  const int64_t blocks = ((a.u << group_log2) + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  adam_rows_kernel<TS, TA, IdT, V>
      <<<static_cast<unsigned>(blocks), 256, 0, st>>>(
          static_cast<typename TS::E*>(a.slab),
          static_cast<typename TA::E*>(a.mu),
          static_cast<typename TA::E*>(a.nu), a.rows, a.width,
          static_cast<const IdT*>(a.uids), a.u,
          static_cast<const typename TA::E*>(a.ug), a.b1, a.omb1, a.b2,
          a.omb2, a.bp, a.lr, a.lr_dev, a.eps, a.eps_root, group_log2);
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

// slab [rows, width] (slab_dtype), mu and nu [rows, width] (mom_dtype),
// updated in place; uids [u] (int32, or int64 when ids_is_64), ugrads
// [u, width] in mom_dtype. Dtype codes: 0 = float32, 1 = bfloat16. b1,
// omb1 (1 - b1), b2 and omb2 rounded to mom_dtype by the caller; bp a
// float32 [2] on the card holding b1^t and b2^t; lr_dev
// (nullable) a float32 lr on the card, used instead of lr. vec: every
// pointer is aligned to 4 elements and width % 4 == 0.
extern "C" int detpu_adam_rows(void* slab, int slab_dtype, void* mu,
                               void* nu, int mom_dtype, int64_t rows,
                               int width, const void* uids, int ids_is_64,
                               int64_t u, const void* ugrads, float b1,
                               float omb1, float b2, float omb2,
                               const void* bp, float lr, const void* lr_dev,
                               float eps, float eps_root, int vec,
                               void* stream) {
  if (rows <= 0 || width <= 0 || u < 0 || bp == nullptr ||
      (slab_dtype != 0 && slab_dtype != 1) ||
      (mom_dtype != 0 && mom_dtype != 1) || (vec != 0 && width % 4 != 0)) {
    return cudaErrorInvalidValue;
  }
  if (u == 0) return cudaSuccess;
  const Args a{slab, mu, nu, rows, width, uids, ids_is_64 != 0, u, ugrads,
               b1, omb1, b2, omb2, static_cast<const float*>(bp), lr,
               static_cast<const float*>(lr_dev), eps, eps_root, vec != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slab_dtype == 0) {
    return mom_dtype == 0 ? launch<F32, F32>(a, st) : launch<F32, BF16>(a, st);
  }
  return mom_dtype == 0 ? launch<BF16, F32>(a, st) : launch<BF16, BF16>(a, st);
}
