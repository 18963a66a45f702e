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
// wrapped row's state transition stays.
//
// Bound: bytes. Per live unique id the kernel reads the gradient, trace
// and slab rows and writes the trace and slab rows (the dedup's pad tail
// is not its work).
//
// Design: the live-range walk of row_update.cuh (walk_live_rows), shared
// with K6 and K11: ONE launch of persistent CTAs (kCtasPerSm a SM), each
// of which finds the negative prefix and the live range of the SORTED
// dedup output (block_bounds) and walks only its share of the live rows,
// a lane group a row, 16 bytes a lane a load (8 for bf16) where the
// width and the call's pointers allow it (V = 4), single elements
// otherwise; CTA 0 runs a negative prefix and, behind a barrier, the rows
// the index rules order after it. The kernel is its Op (MomentumOp).
// chip_smoke.py --parent times it in turns with an earlier checkout's
// wrapper.
//
// Host side: a launch record (ops/momentum.py) keyed on the layouts, the
// dtypes, m, Nesterov and a constant lr holds the constants, rounded
// once, in a prepared launch (detpu_momentum_prepare); each call passes
// the slab, trace, uids, ugrads and device-lr pointers to
// detpu_momentum_launch. The launch keeps no state between calls, so its
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

// What a K12 record fixes: the shapes, dtypes and constants, rounded
// once, and the grid and lane-group size of each load width (index 0:
// V = 4, index 1: V = 1).
struct Consts {
  int64_t rows;
  int64_t u;  // the dedup output's length (its capacity)
  int64_t grid[2];
  int32_t group_log2[2];
  int32_t width;
  int32_t slab_dtype, tr_dtype, ids64;
  int32_t nesterov, lr_on_card;
  float m, neg_lr;  // rounded to the trace dtype
};

// What a K12 call passes.
struct Ptrs {
  void* slab;
  void* trace;
  const void* uids;
  const void* ug;
  const float* lr_dev;
};

// K12's Op for the walk: one row chunk's loads, transition and stores.
// nl is -lr: rounded to A for a constant lr, the fp32 device lr negated
// with lr_on_card.
template <typename TS, typename TA, int V>
struct MomentumOp {
  static constexpr int kV = V;
  struct Chunk {
    float g[V], t[V], p[V];
  };
  typename TS::E* slab;
  typename TA::E* trace;
  const typename TA::E* ug;
  int w;
  float m, nl;
  bool nesterov, lr_on_card;

  __device__ void load(Chunk& k, int64_t src, const detpu::RowJob& j,
                       int col) const {
    detpu::ld_once<TA, V>(ug + src * w + col, k.g);
    ld<TA, V>(trace + j.rd * w + col, k.t);
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
      const float g = k.g[e];
      const float tn = TA::rnd(__fadd_rn(g, TA::rnd(__fmul_rn(m, k.t[e]))));
      const float s =
          nesterov ? TA::rnd(__fadd_rn(g, TA::rnd(__fmul_rn(m, tn)))) : tn;
      const float upd = lr_on_card ? __fmul_rn(nl, s)
                                   : TA::rnd(__fmul_rn(nl, s));
      k.p[e] = __fadd_rn(k.p[e], TS::rnd(upd));
      k.t[e] = tn;
    }
  }

  __device__ void store(const Chunk& k, const detpu::RowJob& j,
                        int col) const {
    if (j.state) st<TA, V>(trace + j.wr * w + col, k.t);
    if (j.slab) st<TS, V>(slab + j.wr * w + col, k.p);
  }
};

// ONE launch of persistent CTAs: the live range (block_bounds), then
// the walk (row_update.cuh) with MomentumOp.
template <typename TS, typename TA, typename IdT, int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
momentum_rows_kernel(const Consts c, const Ptrs q, int group_log2) {
  const IdT* uids = static_cast<const IdT*>(q.uids);
  int64_t neg_end, live_end;
  detpu::block_bounds<kThreads>(uids, c.u, 0, c.rows, &neg_end, &live_end);
  if (live_end == 0) return;
  const MomentumOp<TS, TA, V> op{
      static_cast<typename TS::E*>(q.slab),
      static_cast<typename TA::E*>(q.trace),
      static_cast<const typename TA::E*>(q.ug), c.width, c.m,
      c.lr_on_card ? -__ldg(q.lr_dev) : c.neg_lr, c.nesterov != 0,
      c.lr_on_card != 0};
  detpu::walk_live_rows<kThreads, kRows>(op, uids, c.u, c.rows, c.width,
                                         group_log2, neg_end, live_end);
}

template <typename TS, typename TA, typename IdT, int V>
cudaError_t launch_v(const Consts& c, const Ptrs& q, cudaStream_t st) {
  const int k = V == 4 ? 0 : 1;
  momentum_rows_kernel<TS, TA, IdT, V>
      <<<static_cast<unsigned>(c.grid[k]), kThreads, 0, st>>>(
          c, q, c.group_log2[k]);
  return cudaGetLastError();
}

template <typename TS, typename TA>
cudaError_t launch(const Consts& c, const Ptrs& q, bool vec,
                   cudaStream_t st) {
  if (c.ids64) {
    return vec ? launch_v<TS, TA, int64_t, 4>(c, q, st)
               : launch_v<TS, TA, int64_t, 1>(c, q, st);
  }
  return vec ? launch_v<TS, TA, int32_t, 4>(c, q, st)
             : launch_v<TS, TA, int32_t, 1>(c, q, st);
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The bytes of a prepared K12 launch.
extern "C" int64_t detpu_momentum_prepared_bytes() {
  return static_cast<int64_t>(sizeof(Consts));
}

// Validate a K12 record and write its prepared launch to `out`
// (detpu_momentum_prepared_bytes() bytes of host memory): slab [rows,
// width] (slab_dtype) and trace [rows, width] (tr_dtype), updated in
// place; uids [u] (int32, or int64 when ids_is_64; sorted, each id once:
// the dedup's output), ugrads [u, width] in tr_dtype. Dtype codes: 0 =
// float32, 1 = bfloat16. m and neg_lr (-lr) rounded to tr_dtype by the
// caller; lr_on_card set when each call passes a float32 lr on the card
// instead of neg_lr; sms the card's SMs. Launches nothing.
extern "C" int detpu_momentum_prepare(int slab_dtype, int tr_dtype,
                                      int64_t rows, int width, int ids_is_64,
                                      int64_t u, float m, int nesterov,
                                      float neg_lr, int lr_on_card, int sms,
                                      void* out) {
  if (rows <= 0 || width <= 0 || u <= 0 || sms <= 0 || out == nullptr ||
      (slab_dtype != 0 && slab_dtype != 1) ||
      (tr_dtype != 0 && tr_dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  Consts* c = static_cast<Consts*>(out);
  memset(c, 0, sizeof(Consts));
  c->rows = rows;
  c->u = u;
  c->width = width;
  c->slab_dtype = slab_dtype;
  c->tr_dtype = tr_dtype;
  c->ids64 = ids_is_64 != 0;
  c->nesterov = nesterov != 0;
  c->lr_on_card = lr_on_card != 0;
  c->m = m;
  c->neg_lr = neg_lr;
  for (int k = 0; k < 2; ++k) {
    c->group_log2[k] = detpu::walk_group_log2(width, k == 0 ? 4 : 1);
    c->grid[k] = detpu::walk_grid(u, c->group_log2[k], kThreads, kRows, sms,
                                  kCtasPerSm);
  }
  return cudaSuccess;
}

// K12 through a prepared launch: the call's pointers (lr_dev null unless
// the record takes a card lr). 4-element loads where the width is a
// multiple of 4 and slab, trace and ugrads are aligned to 4 of their
// elements.
extern "C" int detpu_momentum_launch(const void* prepared, void* slab,
                                     void* trace, const void* uids,
                                     const void* ugrads, const void* lr_dev,
                                     void* stream) {
  const Consts* c = static_cast<const Consts*>(prepared);
  if (c == nullptr || slab == nullptr || trace == nullptr ||
      uids == nullptr || ugrads == nullptr ||
      (c->lr_on_card && lr_dev == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Ptrs q{slab, trace, uids, ugrads, static_cast<const float*>(lr_dev)};
  const int es = c->slab_dtype == 0 ? 4 : 2, et = c->tr_dtype == 0 ? 4 : 2;
  const bool vec = c->width % 4 == 0 && detpu::aligned4(slab, es) &&
                   detpu::aligned4(trace, et) && detpu::aligned4(ugrads, et);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c->slab_dtype == 0) {
    return c->tr_dtype == 0 ? launch<F32, F32>(*c, q, vec, st)
                            : launch<F32, BF16>(*c, q, vec, st);
  }
  return c->tr_dtype == 0 ? launch<BF16, F32>(*c, q, vec, st)
                          : launch<BF16, BF16>(*c, q, vec, st);
}
