// K6 and K7: the Adagrad row update of SparseAdagrad, for Hopper (sm_90a).
//
// Replace the XLA-lowered halves of
//   distributed_embeddings_tpu/parallel/optimizers.py:SparseAdagrad.apply_rows
// K6 (adagrad_rows), the sparse regime: per unique row of the dedup
// output (K5), accum[id] += g*g, then slab[id] -= lr*g*rsqrt(accum+eps)
// (take(mode="clip") reads, .at[].set/.add(mode="drop") writes);
// K7 (adagrad_dense), the slab-wide half of the dense-apply regime: the
// same transition elementwise over the whole slab, from the gradient slab
// that the scatter-sum (K3) built. The dense-apply regime runs K7 only
// where the constants do not make an untouched element a no-op (eps = 0
// over a zero accumulator: JAX turns those elements into NaN); otherwise
// it is one call of the sorted-segment engine whose epilogue applies the
// transition to each hit row (segment_scatter.cuh, kModeAdagrad).
//
// Arithmetic, per element: adagrad_step.cuh (the one copy K6, K7 and the
// engine's epilogue share), JAX's rounding chain in the accumulator dtype
// A, the update rounded to the slab dtype S, then slab = rS(slab - u).
//
// K6 index rules (row_update.cuh): an id >= rows (the dropped-row
// sentinel, the dedup's pad tail, ids past the slab) is skipped; a
// negative id reads row 0 as it was before the launch and writes row
// id + rows (JAX's drop mode wraps once), one still negative is
// skipped; a negative id and its wrapped row in one stream both add to
// the slab row (the negative one first) and the wrapped row's state
// transition stays.
//
// Bound: bytes. K6 reads a gradient row and an accumulator and slab row
// and writes the two rows back per live unique id (the dedup's pad tail
// is not its work); K7 streams g, acc and slab once and writes acc and
// slab once.
//
// K6's design: the live-range walk of row_update.cuh (walk_live_rows),
// K11's: ONE launch of persistent CTAs (kCtasPerSm a SM), each of which
// finds the live range of the SORTED dedup output (block_bounds) and
// walks only its share of it, a lane group a row, 16 bytes a lane a load
// (8 for bf16) where the width and the call's pointers allow it (V = 4),
// single elements otherwise; CTA 0 runs a negative prefix and, behind a
// barrier, the rows the index rules order after it. The kernel is its Op
// (AdagradOp). The first design (two launches over all U ids, pad
// included, one element a lane a load) is timed as the parent checkout's
// wrapper in turns with it (row_variants.py and chip_smoke.py
// --parent). K7's design: a grid-stride loop over 4-element chunks, each
// thread moving 16 bytes of a float32 tensor (8 of a bf16 one) a load,
// the gradient by a streaming load (read once), where the element count
// and the three pointers allow it; one element a thread otherwise.
//
// Host side: a launch record each (ops/adagrad.py) keyed on the layouts,
// the dtypes, eps and a constant lr holds the constants, rounded once, in
// a prepared launch (detpu_adagrad_prepare, detpu_adagrad_dense_prepare);
// each call passes its pointers to detpu_adagrad_launch /
// detpu_adagrad_dense_launch. Neither launch keeps state between calls,
// so both records replay in a CUDA graph.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include "adagrad_step.cuh"
#include "row_update.cuh"

#include <string.h>

namespace {

using detpu::BF16;
using detpu::F32;
using detpu::ld;
using detpu::st;

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 4;
constexpr int kRows = 1;  // rows a lane group has in flight
constexpr int kDenseCtasPerSm = 8;  // K7: a full SM of 256-thread CTAs

// What a K6 record fixes: the shapes, dtypes and constants, rounded once.
struct Consts {
  int64_t rows;
  int64_t u;  // the dedup output's length (its capacity)
  int32_t width;
  int32_t slab_dtype, acc_dtype, ids64;
  int32_t lr_on_card;
  int32_t sms;
  float lr, eps;  // rounded to the accumulator dtype
};

// What a K6 call passes.
struct Ptrs {
  void* slab;
  void* acc;
  const void* uids;
  const void* ug;
  const float* lr_dev;
};

// K6's Op for the walk: one row chunk's loads, transition and stores.
template <typename TS, typename TA, int V>
struct AdagradOp {
  static constexpr int kV = V;
  struct Chunk {
    float g[V], a[V], p[V];
  };
  typename TS::E* slab;
  typename TA::E* acc;
  const typename TA::E* ug;
  int w;
  float lr, eps;
  bool lr_on_card;

  __device__ void load(Chunk& k, int64_t src, const detpu::RowJob& j,
                       int col) const {
    detpu::ld_once<TA, V>(ug + src * w + col, k.g);
    ld<TA, V>(acc + j.rd * w + col, k.a);
    if (j.slab) {
      ld<TS, V>(slab + j.wr * w + col, k.p);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) k.p[e] = 0.0f;
    }
  }

  __device__ void step(Chunk& k) const {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float upd;
      k.a[e] = detpu::adagrad_transition<TS, TA>(
          k.a[e], k.g[e], lr, lr_on_card, eps, &upd);
      k.p[e] = __fsub_rn(k.p[e], upd);
    }
  }

  __device__ void store(const Chunk& k, const detpu::RowJob& j,
                        int col) const {
    if (j.state) st<TA, V>(acc + j.wr * w + col, k.a);
    if (j.slab) st<TS, V>(slab + j.wr * w + col, k.p);
  }
};

// ONE launch of persistent CTAs: the live range (block_bounds), then
// the walk (row_update.cuh) with AdagradOp.
template <typename TS, typename TA, typename IdT, int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
adagrad_rows_kernel(const Consts c, const Ptrs q, int group_log2) {
  const IdT* uids = static_cast<const IdT*>(q.uids);
  int64_t neg_end, live_end;
  detpu::block_bounds<kThreads>(uids, c.u, 0, c.rows, &neg_end, &live_end);
  if (live_end == 0) return;
  const AdagradOp<TS, TA, V> op{
      static_cast<typename TS::E*>(q.slab),
      static_cast<typename TA::E*>(q.acc),
      static_cast<const typename TA::E*>(q.ug), c.width,
      c.lr_on_card ? __ldg(q.lr_dev) : c.lr, c.eps, c.lr_on_card != 0};
  detpu::walk_live_rows<kThreads, kRows>(op, uids, c.u, c.rows, c.width,
                                         group_log2, neg_end, live_end);
}

// K7: a grid-stride loop over V-element chunks of the three tensors.
template <typename TS, typename TA, int V>
__global__ void __launch_bounds__(kThreads)
adagrad_dense_kernel(typename TS::E* __restrict__ slab,
                     typename TA::E* __restrict__ acc,
                     const typename TA::E* __restrict__ grad, int64_t chunks,
                     float lr, const float* __restrict__ lr_dev, float eps) {
  const bool on_card = lr_dev != nullptr;
  const float l = on_card ? __ldg(lr_dev) : lr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < chunks; i += stride) {
    const int64_t at = i * V;
    float g[V], a[V], p[V];
    detpu::ld_once<TA, V>(grad + at, g);
    ld<TA, V>(acc + at, a);
    ld<TS, V>(slab + at, p);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float upd;
      a[e] = detpu::adagrad_transition<TS, TA>(a[e], g[e], l, on_card, eps,
                                               &upd);
      p[e] = __fsub_rn(p[e], upd);
    }
    st<TA, V>(acc + at, a);
    st<TS, V>(slab + at, p);
  }
}

template <typename TS, typename TA, typename IdT, int V>
cudaError_t rows_launch_v(const Consts& c, const Ptrs& q, cudaStream_t st) {
  const int gl = detpu::walk_group_log2(c.width, V);
  const int64_t grid = detpu::walk_grid(c.u, gl, kThreads, kRows, c.sms,
                                        kCtasPerSm);
  adagrad_rows_kernel<TS, TA, IdT, V>
      <<<static_cast<unsigned>(grid), kThreads, 0, st>>>(c, q, gl);
  return cudaGetLastError();
}

template <typename TS, typename TA>
cudaError_t rows_launch(const Consts& c, const Ptrs& q, bool vec,
                        cudaStream_t st) {
  if (c.ids64) {
    return vec ? rows_launch_v<TS, TA, int64_t, 4>(c, q, st)
               : rows_launch_v<TS, TA, int64_t, 1>(c, q, st);
  }
  return vec ? rows_launch_v<TS, TA, int32_t, 4>(c, q, st)
             : rows_launch_v<TS, TA, int32_t, 1>(c, q, st);
}

// What a K7 record fixes: the element count, dtypes and constants.
struct DenseConsts {
  int64_t numel;
  int32_t slab_dtype, acc_dtype;
  int32_t lr_on_card;
  int32_t sms;
  float lr, eps;  // rounded to the accumulator dtype
};

template <typename TS, typename TA, int V>
cudaError_t dense_launch_v(const DenseConsts& c, void* slab, void* acc,
                           const void* grad, const float* lr_dev,
                           cudaStream_t st) {
  const int64_t chunks = c.numel / V;
  int64_t blocks = (chunks + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(c.sms) * kDenseCtasPerSm;
  if (blocks > resident) blocks = resident;  // grid-stride beyond that
  adagrad_dense_kernel<TS, TA, V>
      <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
          static_cast<typename TS::E*>(slab),
          static_cast<typename TA::E*>(acc),
          static_cast<const typename TA::E*>(grad), chunks, c.lr, lr_dev,
          c.eps);
  return cudaGetLastError();
}

template <typename TS, typename TA>
cudaError_t dense_launch(const DenseConsts& c, void* slab, void* acc,
                         const void* grad, const float* lr_dev, bool vec,
                         cudaStream_t st) {
  return vec ? dense_launch_v<TS, TA, 4>(c, slab, acc, grad, lr_dev, st)
             : dense_launch_v<TS, TA, 1>(c, slab, acc, grad, lr_dev, st);
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The bytes of a prepared K6 launch.
extern "C" int64_t detpu_adagrad_prepared_bytes() {
  return static_cast<int64_t>(sizeof(Consts));
}

// Validate a K6 record and write its prepared launch to `out`
// (detpu_adagrad_prepared_bytes() bytes of host memory): slab [rows,
// width] (slab_dtype) and acc [rows, width] (acc_dtype), updated in
// place; uids [u] (int32, or int64 when ids_is_64; sorted, each id once:
// the dedup's output), ugrads [u, width] in acc_dtype. Dtype codes: 0 =
// float32, 1 = bfloat16. lr and eps rounded to acc_dtype by the caller;
// lr_on_card set when each call passes a float32 lr on the card instead;
// sms the card's SMs. Launches nothing.
extern "C" int detpu_adagrad_prepare(int slab_dtype, int acc_dtype,
                                     int64_t rows, int width, int ids_is_64,
                                     int64_t u, float lr, int lr_on_card,
                                     float eps, int sms, void* out) {
  if (rows <= 0 || width <= 0 || u <= 0 || sms <= 0 || out == nullptr ||
      (slab_dtype != 0 && slab_dtype != 1) ||
      (acc_dtype != 0 && acc_dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  Consts* c = static_cast<Consts*>(out);
  memset(c, 0, sizeof(Consts));
  c->rows = rows;
  c->u = u;
  c->width = width;
  c->slab_dtype = slab_dtype;
  c->acc_dtype = acc_dtype;
  c->ids64 = ids_is_64 != 0;
  c->lr_on_card = lr_on_card != 0;
  c->sms = sms;
  c->lr = lr;
  c->eps = eps;
  return cudaSuccess;
}

// K6 through a prepared launch: the call's pointers (lr_dev null unless
// the record takes a card lr). 4-element loads where the width is a
// multiple of 4 and slab, acc and ugrads are aligned to 4 of their
// elements.
extern "C" int detpu_adagrad_launch(const void* prepared, void* slab,
                                    void* acc, const void* uids,
                                    const void* ugrads, const void* lr_dev,
                                    void* stream) {
  const Consts* c = static_cast<const Consts*>(prepared);
  if (c == nullptr || slab == nullptr || acc == nullptr ||
      uids == nullptr || ugrads == nullptr ||
      (c->lr_on_card && lr_dev == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Ptrs q{slab, acc, uids, ugrads, static_cast<const float*>(lr_dev)};
  const int es = c->slab_dtype == 0 ? 4 : 2, ea = c->acc_dtype == 0 ? 4 : 2;
  const bool vec = c->width % 4 == 0 && detpu::aligned4(slab, es) &&
                   detpu::aligned4(acc, ea) && detpu::aligned4(ugrads, ea);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c->slab_dtype == 0) {
    return c->acc_dtype == 0 ? rows_launch<F32, F32>(*c, q, vec, st)
                             : rows_launch<F32, BF16>(*c, q, vec, st);
  }
  return c->acc_dtype == 0 ? rows_launch<BF16, F32>(*c, q, vec, st)
                           : rows_launch<BF16, BF16>(*c, q, vec, st);
}

// The bytes of a prepared K7 launch.
extern "C" int64_t detpu_adagrad_dense_prepared_bytes() {
  return static_cast<int64_t>(sizeof(DenseConsts));
}

// Validate a K7 record and write its prepared launch to `out`
// (detpu_adagrad_dense_prepared_bytes() bytes of host memory): slab and
// acc [numel] (dtype codes as K6's), updated in place, from grad [numel]
// in acc_dtype; lr and eps rounded to acc_dtype by the caller; lr_on_card
// set when each call passes a float32 lr on the card instead; sms the
// card's SMs. Launches nothing.
extern "C" int detpu_adagrad_dense_prepare(int slab_dtype, int acc_dtype,
                                           int64_t numel, float lr,
                                           int lr_on_card, float eps, int sms,
                                           void* out) {
  if (numel <= 0 || sms <= 0 || out == nullptr ||
      (slab_dtype != 0 && slab_dtype != 1) ||
      (acc_dtype != 0 && acc_dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  DenseConsts* c = static_cast<DenseConsts*>(out);
  memset(c, 0, sizeof(DenseConsts));
  c->numel = numel;
  c->slab_dtype = slab_dtype;
  c->acc_dtype = acc_dtype;
  c->lr_on_card = lr_on_card != 0;
  c->sms = sms;
  c->lr = lr;
  c->eps = eps;
  return cudaSuccess;
}

// K7 through a prepared launch: the call's pointers (lr_dev null unless
// the record takes a card lr). 4-element chunks where the element count
// is a multiple of 4 and slab, acc and grad are aligned to 4 of their
// elements; one element a thread otherwise.
extern "C" int detpu_adagrad_dense_launch(const void* prepared, void* slab,
                                          void* acc, const void* grad,
                                          const void* lr_dev, void* stream) {
  const DenseConsts* c = static_cast<const DenseConsts*>(prepared);
  if (c == nullptr || slab == nullptr || acc == nullptr || grad == nullptr ||
      (c->lr_on_card && lr_dev == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const float* l = c->lr_on_card ? static_cast<const float*>(lr_dev)
                                 : nullptr;
  const int es = c->slab_dtype == 0 ? 4 : 2, ea = c->acc_dtype == 0 ? 4 : 2;
  const bool vec = c->numel % 4 == 0 && detpu::aligned4(slab, es) &&
                   detpu::aligned4(acc, ea) && detpu::aligned4(grad, ea);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c->slab_dtype == 0) {
    return c->acc_dtype == 0
        ? dense_launch<F32, F32>(*c, slab, acc, grad, l, vec, st)
        : dense_launch<F32, BF16>(*c, slab, acc, grad, l, vec, st);
  }
  return c->acc_dtype == 0
      ? dense_launch<BF16, F32>(*c, slab, acc, grad, l, vec, st)
      : dense_launch<BF16, BF16>(*c, slab, acc, grad, l, vec, st);
}
