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
// --parent). K7 is a grid-stride elementwise loop.
//
// Host side (K6): a launch record (ops/adagrad.py) keyed on the layouts,
// the dtypes, eps and a constant lr holds the constants, rounded once, in
// a prepared launch (detpu_adagrad_prepare); each call passes the slab,
// accumulator, uids, ugrads and device-lr pointers to
// detpu_adagrad_launch. The launch keeps no state between calls, so its
// record replays in a CUDA graph.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

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

// One element's transition; a, g in A; returns the new accumulator and
// writes the update (rounded to S) to *upd. lr and eps arrive rounded to
// A for a constant lr; with lr_on_card, lr is the fp32 device lr.
template <typename TS, typename TA>
__device__ __forceinline__ float transition(float a, float g, float lr,
                                            bool lr_on_card, float eps,
                                            float* upd) {
  const float na = TA::rnd(__fadd_rn(a, TA::rnd(__fmul_rn(g, g))));
  const float r = TA::rnd(__frsqrt_rn(TA::rnd(__fadd_rn(na, eps))));
  float u;
  if (lr_on_card) {
    u = __fmul_rn(__fmul_rn(lr, g), r);
  } else {
    u = TA::rnd(__fmul_rn(TA::rnd(__fmul_rn(lr, g)), r));
  }
  *upd = TS::rnd(u);
  return na;
}

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
      k.a[e] = transition<TS, TA>(k.a[e], k.g[e], lr, lr_on_card, eps,
                                  &upd);
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
    const float na = transition<TS, TA>(
        TA::load(acc[i]), g, lr_dev != nullptr ? __ldg(lr_dev) : lr,
        lr_dev != nullptr, eps, &upd);
    acc[i] = TA::store(na);
    slab[i] = TS::store(__fsub_rn(TS::load(slab[i]), upd));
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

// K7: slab and acc [numel] (dtype codes as K6's), grad [numel] in
// acc_dtype; lr and eps rounded to acc_dtype by the caller; lr_dev
// (nullable) an fp32 lr on the card, used instead of lr.
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
