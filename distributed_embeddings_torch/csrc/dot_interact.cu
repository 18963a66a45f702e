// K2: DLRM dot-interaction forward, and K4: its backward, for Hopper
// (sm_90a).
//
// K2 replaces the XLA-lowered forward of the JAX package's
//   distributed_embeddings_tpu/models/dlrm.py:dot_interact
// which stacks [B, F, D] features (bottom-MLP output first), forms the
// per-sample Gram matrix F.F^T, keeps its strict lower triangle in
// np.tril_indices(F, -1) order (row-major: (1,0), (2,0), (2,1), ...),
// and appends the bottom-MLP row: out [B, F(F-1)/2 + D]. The JAX code
// gets the triangle through a 0/1 selection matmul; here the same kernel
// writes the pairs straight into place.
//
// K4 replaces what JAX's autodiff makes of the same function (the
// transposed selection matmul and the two einsum cotangents): with dG
// the symmetric [F, F] matrix whose (i, j) and (j, i) entries are the
// cotangent of pair (i, j), dfeats[b, f] = sum_g dG[f, g] feats[b, g],
// plus the cotangent of the appended bottom-MLP row on feature 0.
//
// Bound: bytes, both ways. At F=27, D=128, bf16 a sample's K2 reads
// 6.9 KB and writes 958 B for 351 x 128 multiply-adds; its K4 reads
// 6.9 KB + 958 B and writes 6.9 KB for 729 x 128: under 15 operations a
// byte, far below the card's ~295 for the bf16 tensor cores. Design: a
// CTA stages S samples' [F, D] tiles in shared memory (rows padded by
// 16 B so the 16-B reads of different rows fall in different banks);
// K2's threads take (sample, pair) tasks and K4's (sample, feature, 16-B
// column chunk) tasks, accumulate in fp32 from 16-B shared reads (K4
// reads its coefficients from the [F, F] dG staged beside the tile), and
// store once in the input dtype. Tensor-core MMA is for a later version;
// the work is memory-bound either way.
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

constexpr int kThreads = 256;
constexpr int kMaxSamples = 16;
constexpr int kSmemBudget = 48 * 1024;

template <typename Tr, bool VEC>
__global__ void __launch_bounds__(kThreads)
dot_interact_fwd_kernel(const typename Tr::E* __restrict__ feats,
                        typename Tr::E* __restrict__ out, int64_t batch,
                        int F, int D, int Dpad, int S) {
  using E = typename Tr::E;
  constexpr int VE = 16 / static_cast<int>(sizeof(E));  // elements per 16 B
  extern __shared__ __align__(16) unsigned char smem[];
  E* tile = reinterpret_cast<E*>(smem);  // [S][F][Dpad]
  uint16_t* pairs = reinterpret_cast<uint16_t*>(
      smem + static_cast<size_t>(S) * F * Dpad * sizeof(E));
  const int P = F * (F - 1) / 2;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * S;
  const int64_t rem = batch - s0;
  const int ns = rem < S ? static_cast<int>(rem) : S;
  const int out_w = P + D;

  // pair table in np.tril_indices(F, -1) order: p = i(i-1)/2 + j, j < i
  for (int t = threadIdx.x; t < F * F; t += blockDim.x) {
    const int i = t / F, j = t % F;
    if (j < i) pairs[i * (i - 1) / 2 + j] =
        static_cast<uint16_t>((i << 8) | j);
  }
  // stage the tile's [ns*F, D] rows into padded shared rows
  const E* src = feats + s0 * F * D;
  if (VEC) {
    const int dv = D / VE;
    for (int t = threadIdx.x; t < ns * F * dv; t += blockDim.x) {
      const int r = t / dv, c = t % dv;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(r) * D + c * VE));
      *reinterpret_cast<uint4*>(tile + r * Dpad + c * VE) = v;
    }
  } else {
    for (int t = threadIdx.x; t < ns * F * D; t += blockDim.x) {
      const int r = t / D, c = t % D;
      tile[r * Dpad + c] = src[static_cast<int64_t>(r) * D + c];
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < ns * P; t += blockDim.x) {
    const int s = t / P, p = t % P;
    const int i = pairs[p] >> 8, j = pairs[p] & 0xff;
    const E* ri = tile + (s * F + i) * Dpad;
    const E* rj = tile + (s * F + j) * Dpad;
    float acc = 0.f;
    if (VEC) {
      for (int k = 0; k < D; k += VE) {
        const uint4 a = *reinterpret_cast<const uint4*>(ri + k);
        const uint4 b = *reinterpret_cast<const uint4*>(rj + k);
        E ea[VE], eb[VE];
        memcpy(ea, &a, 16);
        memcpy(eb, &b, 16);
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          acc = fmaf(Tr::load(ea[e]), Tr::load(eb[e]), acc);
        }
      }
    } else {
      for (int k = 0; k < D; ++k) {
        acc = fmaf(Tr::load(ri[k]), Tr::load(rj[k]), acc);
      }
    }
    out[(s0 + s) * out_w + p] = Tr::store(acc);
  }
  // the bottom-MLP row (feature 0) follows the triangle
  for (int t = threadIdx.x; t < ns * D; t += blockDim.x) {
    const int s = t / D, d = t % D;
    out[(s0 + s) * out_w + P + d] = tile[(s * F) * Dpad + d];
  }
}

template <typename Tr>
cudaError_t launch(const void* feats, void* out, int64_t batch, int F, int D,
                   cudaStream_t stream) {
  using E = typename Tr::E;
  constexpr int VE = 16 / static_cast<int>(sizeof(E));
  const bool vec = (D % VE == 0) &&
                   reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const int Dpad = vec ? D + VE : D + 1;
  const size_t per = static_cast<size_t>(F) * Dpad * sizeof(E);
  const size_t pair_bytes = static_cast<size_t>(F) * (F - 1) / 2 * 2;
  int S = static_cast<int>((kSmemBudget - pair_bytes) / per);
  S = S < 1 ? 1 : (S > kMaxSamples ? kMaxSamples : S);
  const size_t smem = S * per + pair_bytes;
  auto kernel = vec ? dot_interact_fwd_kernel<Tr, true>
                    : dot_interact_fwd_kernel<Tr, false>;
  if (smem > kSmemBudget) {  // one sample above 48 KB needs the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (batch + S - 1) / S;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const E*>(feats), static_cast<E*>(out), batch, F, D, Dpad,
      S);
  return cudaGetLastError();
}

template <typename Tr, bool VEC>
__global__ void __launch_bounds__(kThreads)
dot_interact_bwd_kernel(const typename Tr::E* __restrict__ feats,
                        const typename Tr::E* __restrict__ dy,
                        typename Tr::E* __restrict__ dfeats, int64_t batch,
                        int F, int D, int Dpad, int S, size_t tile_bytes) {
  using E = typename Tr::E;
  constexpr int VE = 16 / static_cast<int>(sizeof(E));
  extern __shared__ __align__(16) unsigned char smem[];
  E* tile = reinterpret_cast<E*>(smem);                      // [S][F][Dpad]
  float* dg = reinterpret_cast<float*>(smem + tile_bytes);   // [S][F][F]
  uint16_t* pairs = reinterpret_cast<uint16_t*>(
      smem + tile_bytes + static_cast<size_t>(S) * F * F * sizeof(float));
  const int P = F * (F - 1) / 2;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * S;
  const int64_t rem = batch - s0;
  const int ns = rem < S ? static_cast<int>(rem) : S;
  const int out_w = P + D;

  for (int t = threadIdx.x; t < F * F; t += blockDim.x) {
    const int i = t / F, j = t % F;
    if (j < i) pairs[i * (i - 1) / 2 + j] =
        static_cast<uint16_t>((i << 8) | j);
  }
  const E* src = feats + s0 * F * D;
  if (VEC) {
    const int dv = D / VE;
    for (int t = threadIdx.x; t < ns * F * dv; t += blockDim.x) {
      const int r = t / dv, c = t % dv;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(r) * D + c * VE));
      *reinterpret_cast<uint4*>(tile + r * Dpad + c * VE) = v;
    }
  } else {
    for (int t = threadIdx.x; t < ns * F * D; t += blockDim.x) {
      const int r = t / D, c = t % D;
      tile[r * Dpad + c] = src[static_cast<int64_t>(r) * D + c];
    }
  }
  // zero diagonals, then the symmetric dG from each sample's triangle
  for (int t = threadIdx.x; t < ns * F; t += blockDim.x) {
    const int s = t / F, f = t % F;
    dg[(s * F + f) * F + f] = 0.f;
  }
  __syncthreads();  // the pair table is read below
  for (int t = threadIdx.x; t < ns * P; t += blockDim.x) {
    const int s = t / P, p = t % P;
    const int i = pairs[p] >> 8, j = pairs[p] & 0xff;
    const float v = Tr::load(dy[(s0 + s) * out_w + p]);
    dg[(s * F + i) * F + j] = v;
    dg[(s * F + j) * F + i] = v;
  }
  __syncthreads();

  if (VEC) {
    const int dv = D / VE;
    for (int t = threadIdx.x; t < ns * F * dv; t += blockDim.x) {
      const int s = t / (F * dv), r = t % (F * dv);
      const int f = r / dv, c = r % dv;
      float acc[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        // the appended bottom-MLP row's cotangent goes to feature 0
        acc[e] = f == 0 ? Tr::load(dy[(s0 + s) * out_w + P + c * VE + e])
                        : 0.f;
      }
      const float* coef = dg + (s * F + f) * F;
      const E* col = tile + s * F * Dpad + c * VE;
      for (int g = 0; g < F; ++g) {
        const float k = coef[g];
        const uint4 a = *reinterpret_cast<const uint4*>(col + g * Dpad);
        E ea[VE];
        memcpy(ea, &a, 16);
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[e] = fmaf(k, Tr::load(ea[e]), acc[e]);
      }
      E eo[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) eo[e] = Tr::store(acc[e]);
      uint4 o;
      memcpy(&o, eo, 16);
      *reinterpret_cast<uint4*>(dfeats + ((s0 + s) * F + f) * D + c * VE) = o;
    }
  } else {
    for (int t = threadIdx.x; t < ns * F * D; t += blockDim.x) {
      const int s = t / (F * D), r = t % (F * D);
      const int f = r / D, d = r % D;
      float acc = f == 0 ? Tr::load(dy[(s0 + s) * out_w + P + d]) : 0.f;
      const float* coef = dg + (s * F + f) * F;
      for (int g = 0; g < F; ++g) {
        acc = fmaf(coef[g], Tr::load(tile[(s * F + g) * Dpad + d]), acc);
      }
      dfeats[((s0 + s) * F + f) * D + d] = Tr::store(acc);
    }
  }
}

template <typename Tr>
cudaError_t launch_bwd(const void* feats, const void* dy, void* dfeats,
                       int64_t batch, int F, int D, cudaStream_t stream) {
  using E = typename Tr::E;
  constexpr int VE = 16 / static_cast<int>(sizeof(E));
  const bool vec = (D % VE == 0) &&
                   reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dfeats) % 16 == 0;
  const int Dpad = vec ? D + VE : D + 1;
  const size_t per_tile = static_cast<size_t>(F) * Dpad * sizeof(E);
  const size_t per_dg = static_cast<size_t>(F) * F * sizeof(float);
  const size_t pair_bytes = static_cast<size_t>(F) * (F - 1) / 2 * 2;
  int S = static_cast<int>((kSmemBudget - pair_bytes - 16) /
                           (per_tile + per_dg));
  S = S < 1 ? 1 : (S > kMaxSamples ? kMaxSamples : S);
  const size_t tile_bytes = (S * per_tile + 15) / 16 * 16;
  const size_t smem = tile_bytes + S * per_dg + pair_bytes;
  auto kernel = vec ? dot_interact_bwd_kernel<Tr, true>
                    : dot_interact_bwd_kernel<Tr, false>;
  if (smem > kSmemBudget) {  // one sample above 48 KB needs the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (batch + S - 1) / S;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const E*>(feats), static_cast<const E*>(dy),
      static_cast<E*>(dfeats), batch, F, D, Dpad, S, tile_bytes);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// feats [batch, F, D] contiguous, out [batch, F(F-1)/2 + D];
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int detpu_dot_interact_fwd(const void* feats, void* out,
                                      int64_t batch, int F, int D, int dtype,
                                      void* stream) {
  if (F < 2 || F > 255 || D <= 0 || batch < 0 || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<F32>(feats, out, batch, F, D, s)
                    : launch<BF16>(feats, out, batch, F, D, s);
}

// feats [batch, F, D] and dy [batch, F(F-1)/2 + D] contiguous, dfeats
// [batch, F, D]; dtype: 0 = float32, 1 = bfloat16 (all three alike).
extern "C" int detpu_dot_interact_bwd(const void* feats, const void* dy,
                                      void* dfeats, int64_t batch, int F,
                                      int D, int dtype, void* stream) {
  if (F < 2 || F > 255 || D <= 0 || batch < 0 || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_bwd<F32>(feats, dy, dfeats, batch, F, D, s)
                    : launch_bwd<BF16>(feats, dy, dfeats, batch, F, D, s);
}
