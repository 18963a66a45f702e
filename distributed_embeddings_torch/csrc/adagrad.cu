// K6 and K7: the Adagrad row update of SparseAdagrad, for Hopper (sm_90a).
//
// Replace the XLA-lowered halves of
//   distributed_embeddings_tpu/parallel/optimizers.py:SparseAdagrad.apply_rows
// K6 (adagrad_rows), the sparse regime: per unique row of the dedup
// output (K5), accum[id] += g*g, then slab[id] -= lr*g*rsqrt(accum+eps)
// (take(mode="clip") reads, .at[].set/.add(mode="drop") writes);
// K7 (adagrad_dense), the dense-apply regime: the same transition
// elementwise over the whole slab, from the gradient slab that the
// scatter-sum (K3) built.
//
// Arithmetic, per element, with JAX's rounding chain: g, the accumulator
// and every intermediate are in the accumulator dtype A (rounded after
// each operation when A is bf16), the update is rounded to the slab
// dtype S, and the slab add rounds to S:
//   new = rA(acc + rA(g*g));  r = rA(rsqrt(rA(new + eps)))
//   u = rA(rA(lr*g) * r)           (a constant lr, rounded to A)
//   u = (lr*g) * r in fp32         (a device fp32 lr: JAX promotes)
//   slab = rS(slab - rS(u))
// The fp32 rsqrt is the correctly rounded __frsqrt_rn; products and sums
// use the _rn intrinsics so no FMA contracts them.
//
// K6 index rules (row_update.cuh): an id >= rows (the dropped-row
// sentinel, the dedup's pad tail, ids past the slab) is skipped; a
// negative id reads row 0 as it was before the launch and writes row
// id + rows (JAX's drop mode wraps once), one still negative is
// skipped; a negative id and its wrapped row in one stream both add to
// the slab row (the negative one first) and the wrapped row's state
// transition stays. K6 runs its rows in two passes for that.
//
// Bound: bytes. K6 reads a gradient row and an accumulator and slab row
// and writes the two rows back per unique id; K7 streams g, acc and slab
// once and writes acc and slab once. Design: K6 gives each unique row a
// group of G lanes (G the width rounded up to a power of two, at most
// 32), so a warp serves 32/G rows; K7 is a grid-stride elementwise loop.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launches.

#include "row_update.cuh"

namespace {

using detpu::BF16;
using detpu::F32;

// One element's transition; a, g in A; returns the new accumulator and
// writes the update (rounded to S) to *upd. lr and eps arrive rounded to
// A for a constant lr; lr_dev (when not null) is the fp32 device lr.
template <typename TS, typename TA>
__device__ __forceinline__ float transition(float a, float g, float lr,
                                            const float* lr_dev, float eps,
                                            float* upd) {
  const float na = TA::rnd(__fadd_rn(a, TA::rnd(__fmul_rn(g, g))));
  const float r = TA::rnd(__frsqrt_rn(TA::rnd(__fadd_rn(na, eps))));
  float u;
  if (lr_dev != nullptr) {
    u = __fmul_rn(__fmul_rn(__ldg(lr_dev), g), r);
  } else {
    u = TA::rnd(__fmul_rn(TA::rnd(__fmul_rn(lr, g)), r));
  }
  *upd = TS::rnd(u);
  return na;
}

template <typename TS, typename TA, typename IdT>
__global__ void __launch_bounds__(256)
adagrad_rows_kernel(typename TS::E* __restrict__ slab,
                    typename TA::E* __restrict__ acc, int64_t rows, int width,
                    const IdT* __restrict__ uids, int64_t u,
                    const typename TA::E* __restrict__ ug, float lr,
                    const float* __restrict__ lr_dev, float eps,
                    int group_log2, int pass) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t s = tid >> group_log2;  // unique row
  if (s >= u) return;
  detpu::RowJob j;
  if (!detpu::row_job(uids, u, s, rows, pass, &j)) return;
  const int G = 1 << group_log2;
  for (int c = static_cast<int>(tid & (G - 1)); c < width; c += G) {
    const float a = TA::load(acc[j.rd * width + c]);
    const float g = TA::load(ug[s * width + c]);
    float upd;
    const float na = transition<TS, TA>(a, g, lr, lr_dev, eps, &upd);
    if (j.state) acc[j.wr * width + c] = TA::store(na);
    if (j.slab) {
      const float old = TS::load(slab[j.wr * width + c]);
      slab[j.wr * width + c] = TS::store(__fsub_rn(old, upd));
    }
  }
}

template <typename TS, typename TA>
__global__ void __launch_bounds__(256)
adagrad_dense_kernel(typename TS::E* __restrict__ slab,
                     typename TA::E* __restrict__ acc,
                     const typename TA::E* __restrict__ grad, int64_t numel,
                     float lr, const float* __restrict__ lr_dev, float eps) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < numel; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float g = TA::load(grad[i]);
    float upd;
    const float na = transition<TS, TA>(TA::load(acc[i]), g, lr, lr_dev,
                                        eps, &upd);
    acc[i] = TA::store(na);
    slab[i] = TS::store(__fsub_rn(TS::load(slab[i]), upd));
  }
}

template <typename TS, typename TA>
cudaError_t rows_launch(void* slab, void* acc, int64_t rows, int width,
                        const void* uids, bool ids64, int64_t u,
                        const void* ug, float lr, const float* lr_dev,
                        float eps, cudaStream_t st) {
  int group_log2 = 0;
  while ((1 << group_log2) < width && group_log2 < 5) ++group_log2;
  const int64_t blocks = ((u << group_log2) + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  auto* s = static_cast<typename TS::E*>(slab);
  auto* a = static_cast<typename TA::E*>(acc);
  auto* g = static_cast<const typename TA::E*>(ug);
  // pass 0 (the negative ids, rare) gives each id one lane that walks
  // its whole row; pass 1 a group of 2^group_log2 lanes per id
  for (int pass = 0; pass < 2; ++pass) {
    const int gl = pass == 0 ? 0 : group_log2;
    const unsigned nb = static_cast<unsigned>(((u << gl) + 255) / 256);
    if (ids64) {
      adagrad_rows_kernel<TS, TA, int64_t>
          <<<nb, 256, 0, st>>>(
              s, a, rows, width, static_cast<const int64_t*>(uids), u, g,
              lr, lr_dev, eps, gl, pass);
    } else {
      adagrad_rows_kernel<TS, TA, int32_t>
          <<<nb, 256, 0, st>>>(
              s, a, rows, width, static_cast<const int32_t*>(uids), u, g,
              lr, lr_dev, eps, gl, pass);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <typename TS, typename TA>
cudaError_t dense_launch(void* slab, void* acc, const void* grad,
                         int64_t numel, float lr, const float* lr_dev,
                         float eps, cudaStream_t st) {
  int64_t blocks = (numel + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond that
  adagrad_dense_kernel<TS, TA><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<typename TS::E*>(slab), static_cast<typename TA::E*>(acc),
      static_cast<const typename TA::E*>(grad), numel, lr, lr_dev, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// slab [rows, width] (slab_dtype) and acc [rows, width] (acc_dtype),
// updated in place; uids [u] (int32, or int64 when ids_is_64; sorted,
// each id once: the dedup's output), ugrads [u, width] in acc_dtype.
// Dtype codes: 0 = float32, 1 = bfloat16. lr and
// eps rounded to acc_dtype by the caller; lr_dev (nullable) an fp32 lr on
// the card, used instead of lr.
extern "C" int detpu_adagrad_rows(void* slab, int slab_dtype, void* acc,
                                  int acc_dtype, int64_t rows, int width,
                                  const void* uids, int ids_is_64, int64_t u,
                                  const void* ugrads, float lr,
                                  const void* lr_dev, float eps,
                                  void* stream) {
  if (rows <= 0 || width <= 0 || u < 0 || (slab_dtype != 0 &&
      slab_dtype != 1) || (acc_dtype != 0 && acc_dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  if (u == 0) return cudaSuccess;
  const float* l = static_cast<const float*>(lr_dev);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool i64 = ids_is_64 != 0;
  if (slab_dtype == 0) {
    return acc_dtype == 0
        ? rows_launch<F32, F32>(slab, acc, rows, width, uids, i64, u, ugrads,
                                lr, l, eps, st)
        : rows_launch<F32, BF16>(slab, acc, rows, width, uids, i64, u,
                                 ugrads, lr, l, eps, st);
  }
  return acc_dtype == 0
      ? rows_launch<BF16, F32>(slab, acc, rows, width, uids, i64, u, ugrads,
                               lr, l, eps, st)
      : rows_launch<BF16, BF16>(slab, acc, rows, width, uids, i64, u, ugrads,
                                lr, l, eps, st);
}

// slab and acc [numel] (as above), grad [numel] in acc_dtype.
extern "C" int detpu_adagrad_dense(void* slab, int slab_dtype, void* acc,
                                   int acc_dtype, const void* grad,
                                   int64_t numel, float lr,
                                   const void* lr_dev, float eps,
                                   void* stream) {
  if (numel < 0 || (slab_dtype != 0 && slab_dtype != 1) ||
      (acc_dtype != 0 && acc_dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  if (numel == 0) return cudaSuccess;
  const float* l = static_cast<const float*>(lr_dev);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slab_dtype == 0) {
    return acc_dtype == 0
        ? dense_launch<F32, F32>(slab, acc, grad, numel, lr, l, eps, st)
        : dense_launch<F32, BF16>(slab, acc, grad, numel, lr, l, eps, st);
  }
  return acc_dtype == 0
      ? dense_launch<BF16, F32>(slab, acc, grad, numel, lr, l, eps, st)
      : dense_launch<BF16, BF16>(slab, acc, grad, numel, lr, l, eps, st);
}
