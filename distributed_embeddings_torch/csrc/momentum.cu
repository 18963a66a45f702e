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
// Index rules (row_update.cuh, as K6 and K11): an id >= rows is skipped;
// a negative id reads row 0 as it was before the launch and writes row
// id + rows, one still negative is skipped; a negative id and its
// wrapped row both add to the slab row (the negative one first) and the
// wrapped row's state transition stays, so the rows run in two passes.
//
// Bound: bytes. Per unique row the kernel reads the gradient, trace and
// slab rows and writes the trace and slab rows. Design: as K11, a group
// of G lanes per unique row, 16-byte (float32) or 8-byte (bf16) loads
// where width and alignment allow (V = 4), single elements otherwise.
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
momentum_rows_kernel(typename TS::E* __restrict__ slab,
                     typename TA::E* __restrict__ trace, int64_t rows,
                     int width, const IdT* __restrict__ uids, int64_t u,
                     const typename TA::E* __restrict__ ug, float m,
                     int nesterov, float neg_lr,
                     const float* __restrict__ lr_dev, int group_log2,
                     int pass) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t s = tid >> group_log2;  // unique row
  if (s >= u) return;
  detpu::RowJob j;
  if (!detpu::row_job(uids, u, s, rows, pass, &j)) return;
  const int64_t rd = j.rd, wr = j.wr;
  const bool dev_lr = lr_dev != nullptr;
  const float nl = dev_lr ? -__ldg(lr_dev) : neg_lr;
  const int G = 1 << group_log2;
  for (int c = static_cast<int>(tid & (G - 1)) * V; c < width; c += G * V) {
    float g[V], t[V], p[V] = {};
    ld<TA, V>(ug + s * width + c, g);
    ld<TA, V>(trace + rd * width + c, t);
    if (j.slab) ld<TS, V>(slab + wr * width + c, p);
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
    if (j.state) st<TA, V>(trace + wr * width + c, t);
    if (j.slab) st<TS, V>(slab + wr * width + c, p);
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
  // pass 0 (the negative ids, rare) gives each id one lane that walks
  // its whole row; pass 1 a group of 2^group_log2 lanes per id
  for (int pass = 0; pass < 2; ++pass) {
    const int gl = pass == 0 ? 0 : group_log2;
    const unsigned nb = static_cast<unsigned>(((a.u << gl) + 255) / 256);
    momentum_rows_kernel<TS, TA, IdT, V>
        <<<nb, 256, 0, st>>>(
            static_cast<typename TS::E*>(a.slab),
            static_cast<typename TA::E*>(a.trace), a.rows, a.width,
            static_cast<const IdT*>(a.uids), a.u,
            static_cast<const typename TA::E*>(a.ug), a.m, a.nesterov,
            a.neg_lr, a.lr_dev, gl, pass);
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

// slab [rows, width] (slab_dtype) and trace [rows, width] (tr_dtype),
// updated in place; uids [u] (int32, or int64 when ids_is_64; sorted,
// each id once: the dedup's output), ugrads
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
