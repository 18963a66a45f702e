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
// Index rules (row_update.cuh, as K6): an id >= rows (the dropped-row
// sentinel, the dedup's pad tail, ids past the slab) is skipped; a
// negative id reads row 0 as it was before the launch and writes row
// id + rows (JAX's drop mode wraps once), one still negative is
// skipped; a negative id and its wrapped row in one stream both add to
// the slab row (the negative one first) and the wrapped row's state
// transition stays, so the rows run in two passes.
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
// cudaError_t of the launches.

#include "row_update.cuh"

namespace {

using detpu::BF16;
using detpu::F32;
using detpu::ld;
using detpu::st;

template <typename TS, typename TA, typename IdT, int V>
__global__ void __launch_bounds__(256)
adam_rows_kernel(typename TS::E* __restrict__ slab,
                 typename TA::E* __restrict__ mu,
                 typename TA::E* __restrict__ nu, int64_t rows, int width,
                 const IdT* __restrict__ uids, int64_t u,
                 const typename TA::E* __restrict__ ug, float b1, float omb1,
                 float b2, float omb2, const float* __restrict__ bp, float lr,
                 const float* __restrict__ lr_dev, float eps, float eps_root,
                 int group_log2, int pass) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t s = tid >> group_log2;  // unique row
  if (s >= u) return;
  detpu::RowJob j;
  if (!detpu::row_job(uids, u, s, rows, pass, &j)) return;
  const int64_t rd = j.rd, wr = j.wr;
  const float c1 = __fsub_rn(1.0f, __ldg(bp));
  const float c2 = __fsub_rn(1.0f, __ldg(bp + 1));
  const float l = lr_dev != nullptr ? __ldg(lr_dev) : lr;
  const int G = 1 << group_log2;
  for (int c = static_cast<int>(tid & (G - 1)) * V; c < width; c += G * V) {
    float g[V], m[V], n[V], p[V] = {};
    ld<TA, V>(ug + s * width + c, g);
    ld<TA, V>(mu + rd * width + c, m);
    ld<TA, V>(nu + rd * width + c, n);
    if (j.slab) ld<TS, V>(slab + wr * width + c, p);
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
    if (j.state) {
      st<TA, V>(mu + wr * width + c, m);
      st<TA, V>(nu + wr * width + c, n);
    }
    if (j.slab) st<TS, V>(slab + wr * width + c, p);
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
  // pass 0 (the negative ids, rare) gives each id one lane that walks
  // its whole row; pass 1 a group of 2^group_log2 lanes per id
  for (int pass = 0; pass < 2; ++pass) {
    const int gl = pass == 0 ? 0 : group_log2;
    const unsigned nb = static_cast<unsigned>(((a.u << gl) + 255) / 256);
    adam_rows_kernel<TS, TA, IdT, V>
        <<<nb, 256, 0, st>>>(
            static_cast<typename TS::E*>(a.slab),
            static_cast<typename TA::E*>(a.mu),
            static_cast<typename TA::E*>(a.nu), a.rows, a.width,
            static_cast<const IdT*>(a.uids), a.u,
            static_cast<const typename TA::E*>(a.ug), a.b1, a.omb1, a.b2,
            a.omb2, a.bp, a.lr, a.lr_dev, a.eps, a.eps_root, gl, pass);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
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
// updated in place; uids [u] (int32, or int64 when ids_is_64; sorted,
// each id once: the dedup's output), ugrads
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
