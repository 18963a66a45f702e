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
// lr (a constant, or a float32 device lr), eps and eps_root are float32.
// b1^t and b2^t are powf of the float32 bases b1, b2 and the count read on
// the card (the same libdevice powf that torch.pow runs for float32 on the
// card, so the plain version's ops/adam.py:bias_powers gives the same
// bits), and c = 1 - b^t is formed here: nothing syncs with the host.
// Products, sums, quotients and the square root use the _rn intrinsics:
// no FMA contracts them, and each is correctly rounded as PyTorch's
// elementwise ops are.
//
// Index rules (row_update.cuh, as K6): an id >= rows (the dropped-row
// sentinel, the dedup's pad tail, ids past the slab) is skipped; a
// negative id reads row 0 as it was before the launch and writes row
// id + rows (JAX's drop mode wraps once), one still negative is skipped;
// a negative id and its wrapped row in one stream both add to the slab
// row (the negative one first) and the wrapped row's state transition
// stays; row 0 is read by every negative id before anything writes it.
//
// Bound: bytes. Per live row the kernel reads the gradient row, the two
// moment rows and the slab row and writes the three state rows back.
//
// Design: the live-range walk of row_update.cuh (walk_live_rows), which
// K6 shares: ONE launch of persistent CTAs (kCtasPerSm a SM), each of
// which finds the live range of the SORTED dedup output and walks only
// its share of it; CTA 0 runs a negative prefix and the rows the index
// rules order after it. The kernel is its Op (AdamOp: the loads, the
// transition and the stores of one row chunk). kRows is 1: two or four
// rows a lane group (more loads in flight a lane, more registers)
// measured slower at the zoo's w16 (row_variants.py: the slabs' random
// 64-byte rows bound it, not the loads in flight), as did 2 or 8 CTAs a
// SM and one block of the live range a CTA; two launches (a one-CTA
// search and prefix pass, then the live rows) cost ~5 us more of host
// and a launch gap.
//
// Host side: a launch record (ops/adam.py) keyed on the layouts, the
// dtypes and the hyperparameters holds the constants, rounded once, in a
// prepared launch (detpu_adam_prepare); each call passes the seven
// pointers (slab, mu, nu, uids, ugrads, count, the device lr or null) to
// detpu_adam_launch. The launch keeps no state between calls, so its
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

// What a record fixes: the shapes, dtypes and constants, rounded once.
struct Consts {
  int64_t rows;
  int64_t u;         // the dedup output's length (its capacity)
  int32_t width;
  int32_t slab_dtype, mom_dtype, ids64;
  int32_t lr_on_card;
  int32_t sms;
  float b1, omb1, b2, omb2;  // rounded to the moments' dtype
  float pb1, pb2;            // b1, b2 in float32: the bias powers' bases
  float lr, eps, eps_root;   // float32
};

// What a call passes.
struct Ptrs {
  void* slab;
  void* mu;
  void* nu;
  const void* uids;
  const void* ug;
  const float* count;
  const float* lr_dev;
};

struct Scalars {
  float c1, c2, lr;
};

__device__ __forceinline__ Scalars scalars(const Consts& c, const Ptrs& q) {
  const float t = __ldg(q.count);
  return Scalars{__fsub_rn(1.0f, powf(c.pb1, t)),
                 __fsub_rn(1.0f, powf(c.pb2, t)),
                 c.lr_on_card ? __ldg(q.lr_dev) : c.lr};
}

// K11's Op for the walk: one row chunk's loads, transition and stores.
template <typename TS, typename TA, int V>
struct AdamOp {
  static constexpr int kV = V;
  struct Chunk {
    float g[V], m[V], n[V], p[V];
  };
  Consts c;
  Scalars s;
  typename TS::E* slab;
  typename TA::E* mu;
  typename TA::E* nu;
  const typename TA::E* ug;

  __device__ void load(Chunk& k, int64_t src, const detpu::RowJob& j,
                       int col) const {
    const int w = c.width;
    detpu::ld_once<TA, V>(ug + src * w + col, k.g);
    ld<TA, V>(mu + j.rd * w + col, k.m);
    ld<TA, V>(nu + j.rd * w + col, k.n);
    if (j.slab) {
      ld<TS, V>(slab + j.wr * w + col, k.p);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) k.p[e] = 0.0f;
    }
  }

  // m, n (in A) and the slab values p (in S) updated in place from g
  __device__ void step(Chunk& k) const {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float mn = TA::rnd(__fadd_rn(TA::rnd(__fmul_rn(c.b1, k.m[e])),
                                         TA::rnd(__fmul_rn(c.omb1, k.g[e]))));
      const float g2 = TA::rnd(__fmul_rn(TA::rnd(__fmul_rn(c.omb2, k.g[e])),
                                         k.g[e]));
      const float nn = TA::rnd(__fadd_rn(TA::rnd(__fmul_rn(c.b2, k.n[e])),
                                         g2));
      const float den = __fadd_rn(
          __fsqrt_rn(__fadd_rn(__fdiv_rn(nn, s.c2), c.eps_root)), c.eps);
      const float upd = __fdiv_rn(__fmul_rn(s.lr, __fdiv_rn(mn, s.c1)), den);
      k.p[e] = __fsub_rn(k.p[e], TS::rnd(upd));
      k.m[e] = mn;
      k.n[e] = nn;
    }
  }

  __device__ void store(const Chunk& k, const detpu::RowJob& j,
                        int col) const {
    const int w = c.width;
    if (j.state) {
      st<TA, V>(mu + j.wr * w + col, k.m);
      st<TA, V>(nu + j.wr * w + col, k.n);
    }
    if (j.slab) st<TS, V>(slab + j.wr * w + col, k.p);
  }
};

// ONE launch of persistent CTAs: the live range (block_bounds), then
// the walk (row_update.cuh) with AdamOp.
template <typename TS, typename TA, typename IdT, int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
adam_rows_kernel(const Consts c, const Ptrs q, int group_log2) {
  const IdT* uids = static_cast<const IdT*>(q.uids);
  int64_t neg_end, live_end;
  detpu::block_bounds<kThreads>(uids, c.u, 0, c.rows, &neg_end, &live_end);
  if (live_end == 0) return;
  const AdamOp<TS, TA, V> op{
      c, scalars(c, q), static_cast<typename TS::E*>(q.slab),
      static_cast<typename TA::E*>(q.mu), static_cast<typename TA::E*>(q.nu),
      static_cast<const typename TA::E*>(q.ug)};
  detpu::walk_live_rows<kThreads, kRows>(op, uids, c.u, c.rows, c.width,
                                         group_log2, neg_end, live_end);
}

template <typename TS, typename TA, typename IdT, int V>
cudaError_t launch_v(const Consts& c, const Ptrs& q, cudaStream_t st) {
  const int gl = detpu::walk_group_log2(c.width, V);
  const int64_t grid = detpu::walk_grid(c.u, gl, kThreads, kRows, c.sms,
                                        kCtasPerSm);
  adam_rows_kernel<TS, TA, IdT, V>
      <<<static_cast<unsigned>(grid), kThreads, 0, st>>>(c, q, gl);
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

// The bytes of a prepared launch.
extern "C" int64_t detpu_adam_prepared_bytes() {
  return static_cast<int64_t>(sizeof(Consts));
}

// Validate a record and write its prepared launch to `out`
// (detpu_adam_prepared_bytes() bytes of host memory): slab [rows, width]
// (slab_dtype), mu and nu [rows, width] (mom_dtype), uids [u] (int32, or
// int64 when ids_is_64; sorted, the dedup's output), ugrads [u, width] in
// mom_dtype. Dtype codes: 0 = float32, 1 = bfloat16. b1, omb1 (1 - b1),
// b2 and omb2 rounded to mom_dtype by the caller; pb1, pb2 the float32
// b1, b2 (the bias powers' bases); lr the constant float32 lr, or
// lr_on_card set when each call passes a float32 lr on the card; sms the
// card's SMs. Launches nothing.
extern "C" int detpu_adam_prepare(int slab_dtype, int mom_dtype,
                                  int64_t rows, int width, int ids_is_64,
                                  int64_t u, float b1, float omb1, float b2,
                                  float omb2, float pb1, float pb2, float lr,
                                  int lr_on_card, float eps, float eps_root,
                                  int sms, void* out) {
  if (rows <= 0 || width <= 0 || u <= 0 || sms <= 0 || out == nullptr ||
      (slab_dtype != 0 && slab_dtype != 1) ||
      (mom_dtype != 0 && mom_dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  Consts* c = static_cast<Consts*>(out);
  memset(c, 0, sizeof(Consts));
  c->rows = rows;
  c->u = u;
  c->width = width;
  c->slab_dtype = slab_dtype;
  c->mom_dtype = mom_dtype;
  c->ids64 = ids_is_64 != 0;
  c->lr_on_card = lr_on_card != 0;
  c->sms = sms;
  c->b1 = b1;
  c->omb1 = omb1;
  c->b2 = b2;
  c->omb2 = omb2;
  c->pb1 = pb1;
  c->pb2 = pb2;
  c->lr = lr;
  c->eps = eps;
  c->eps_root = eps_root;
  return cudaSuccess;
}

// K11 through a prepared launch: the call's pointers (lr_dev null unless
// the record takes a card lr; count one float32 on the card, already
// advanced). 4-element loads where the width is a multiple of 4 and
// slab, mu, nu and ugrads are aligned to 4 of their elements.
extern "C" int detpu_adam_launch(const void* prepared, void* slab, void* mu,
                                 void* nu, const void* uids,
                                 const void* ugrads, const void* count,
                                 const void* lr_dev, void* stream) {
  const Consts* c = static_cast<const Consts*>(prepared);
  if (c == nullptr || slab == nullptr || mu == nullptr || nu == nullptr ||
      uids == nullptr || ugrads == nullptr || count == nullptr ||
      (c->lr_on_card && lr_dev == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Ptrs q{slab, mu, nu, uids, ugrads, static_cast<const float*>(count),
               static_cast<const float*>(lr_dev)};
  const int es = c->slab_dtype == 0 ? 4 : 2, ea = c->mom_dtype == 0 ? 4 : 2;
  const bool vec = c->width % 4 == 0 && detpu::aligned4(slab, es) &&
                   detpu::aligned4(mu, ea) && detpu::aligned4(nu, ea) &&
                   detpu::aligned4(ugrads, ea);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c->slab_dtype == 0) {
    return c->mom_dtype == 0 ? launch<F32, F32>(*c, q, vec, st)
                             : launch<F32, BF16>(*c, q, vec, st);
  }
  return c->mom_dtype == 0 ? launch<BF16, F32>(*c, q, vec, st)
                           : launch<BF16, BF16>(*c, q, vec, st);
}
