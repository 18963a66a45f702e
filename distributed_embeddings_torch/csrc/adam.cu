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
// Design: the uids are the dedup's SORTED output (signed order: negative
// ids first, the ids >= rows, the pad tail and the sentinel, last), of
// which K5's zoo streams leave ~70% pad. So nothing walks the pad: ONE
// launch of persistent CTAs (kCtasPerSm a SM), each of which finds the
// end of the negative prefix and the end of the live range by a
// block-wide search (kThreads evenly spaced probes a round, 3 rounds for
// 2.9M ids) and walks its share of the live range. The index rules'
// order is kept inside the launch (adam_rows_kernel): CTA 0 runs the
// negative prefix (rare: the zoo has none) and, behind a barrier, the few
// rows the rules put after it, which every CTA skips. A lane group of G
// lanes (G the 4-element chunks of a row rounded up to a power of two, at
// most 32) takes kRows consecutive live rows at a time and starts all of
// their loads (gradient rows by a streaming load: read once) before the
// math; each lane moves 16 bytes of a float32 row (8 of a bf16 one) a
// load where the width and this call's pointers' alignment allow it
// (V = 4), single elements otherwise. kRows is 1: two or four rows a lane
// group (more loads in flight a lane, more registers) measured slower at
// the zoo's w16 (row_variants.py: the slabs' random 64-byte rows bound
// it, not the loads in flight), as did 2 or 8 CTAs a SM and one block of
// the live range a CTA; two launches (a one-CTA search and prefix pass,
// then the live rows) cost ~5 us more of host and a launch gap.
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

// Streaming loads of the gradient rows (read once).
template <typename T, int V>
__device__ __forceinline__ void ld_once(const typename T::E* p, float* f) {
  if constexpr (V == 4) {
    if constexpr (sizeof(typename T::E) == 4) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
      f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
    } else {
      const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
      f[0] = __uint_as_float(v.x << 16);
      f[1] = __uint_as_float(v.x & 0xffff0000u);
      f[2] = __uint_as_float(v.y << 16);
      f[3] = __uint_as_float(v.y & 0xffff0000u);
    }
  } else {
    f[0] = T::load(__ldcs(p));
  }
}

struct Scalars {
  float c1, c2, lr;
};

__device__ __forceinline__ Scalars scalars(const Consts& c, const Ptrs& q) {
  const float t = __ldg(q.count);
  return Scalars{__fsub_rn(1.0f, powf(c.pb1, t)),
                 __fsub_rn(1.0f, powf(c.pb2, t)),
                 c.lr_on_card ? __ldg(q.lr_dev) : c.lr};
}

// One row chunk's transition: m, n (in A) and the slab values p (in S)
// updated in place from g.
template <typename TS, typename TA, int V>
__device__ __forceinline__ void transition(const Consts& c, const Scalars& s,
                                           const float* g, float* m, float* n,
                                           float* p) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float mn = TA::rnd(__fadd_rn(TA::rnd(__fmul_rn(c.b1, m[k])),
                                       TA::rnd(__fmul_rn(c.omb1, g[k]))));
    const float g2 = TA::rnd(__fmul_rn(TA::rnd(__fmul_rn(c.omb2, g[k])),
                                       g[k]));
    const float nn = TA::rnd(__fadd_rn(TA::rnd(__fmul_rn(c.b2, n[k])), g2));
    const float den = __fadd_rn(
        __fsqrt_rn(__fadd_rn(__fdiv_rn(nn, s.c2), c.eps_root)), c.eps);
    const float upd = __fdiv_rn(__fmul_rn(s.lr, __fdiv_rn(mn, s.c1)), den);
    p[k] = __fsub_rn(p[k], TS::rnd(upd));
    m[k] = mn;
    n[k] = nn;
  }
}

// The first indices of the sorted ids [u] holding a value >= v0 and >= v1
// (u where none), found by the whole block: each round every thread
// probes one of kThreads evenly spaced positions of each open range.
template <typename IdT>
__device__ void block_bounds(const IdT* __restrict__ ids, int64_t u,
                             int64_t v0, int64_t v1, int64_t* a0,
                             int64_t* a1) {
  int64_t lo[2] = {0, 0}, hi[2] = {u, u};
  const int64_t v[2] = {v0, v1};
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    int64_t step[2];
    bool below[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      step[k] = (hi[k] - lo[k] + kThreads - 1) / kThreads;
      const int64_t at = lo[k] + threadIdx.x * step[k];
      below[k] = lo[k] < hi[k] && at < hi[k] &&
                 static_cast<int64_t>(ids[at]) < v[k];
    }
    const int c0 = __syncthreads_count(below[0]);
    const int c1 = __syncthreads_count(below[1]);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = k == 0 ? c0 : c1;
      if (lo[k] >= hi[k]) continue;
      if (c == 0) {
        hi[k] = lo[k];
      } else {
        const int64_t last = lo[k] + (c - 1) * step[k];
        lo[k] = last + 1;
        if (last + step[k] < hi[k]) hi[k] = last + step[k];
      }
    }
  }
  *a0 = lo[0];
  *a1 = lo[1];
}

// The first index in [lo, hi) of the sorted ids holding v, or -1.
template <typename IdT>
__device__ int64_t find_id(const IdT* __restrict__ ids, int64_t lo,
                           int64_t hi, int64_t v) {
  const int64_t end = hi;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(ids[mid]) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < end && static_cast<int64_t>(ids[lo]) == v ? lo : -1;
}

// One lane group's job: the transition of the gradient row at position
// src, reading the state of row j.rd and writing row j.wr (the state when
// j.state, the slab when j.slab), chunk by chunk.
template <typename TS, typename TA, int V>
__device__ void run_job(const Consts& c, const Scalars& s, const Ptrs& q,
                        int64_t src, const detpu::RowJob& j, int lane,
                        int G) {
  const int w = c.width;
  auto* slab = static_cast<typename TS::E*>(q.slab);
  auto* mu = static_cast<typename TA::E*>(q.mu);
  auto* nu = static_cast<typename TA::E*>(q.nu);
  const auto* ug = static_cast<const typename TA::E*>(q.ug);
  for (int col = lane * V; col < w; col += G * V) {
    float g[V], m[V], n[V], p[V] = {};
    ld_once<TA, V>(ug + src * w + col, g);
    ld<TA, V>(mu + j.rd * w + col, m);
    ld<TA, V>(nu + j.rd * w + col, n);
    if (j.slab) ld<TS, V>(slab + j.wr * w + col, p);
    transition<TS, TA, V>(c, s, g, m, n, p);
    if (j.state) {
      st<TA, V>(mu + j.wr * w + col, m);
      st<TA, V>(nu + j.wr * w + col, n);
    }
    if (j.slab) st<TS, V>(slab + j.wr * w + col, p);
  }
}

// ONE launch of persistent CTAs. Each CTA finds the end of the negative
// prefix and of the live range (block_bounds). CTA 0 first runs the
// prefix's rows by row_job's pass-0 rules (each reads row 0 as it was),
// then, behind a barrier, every row those rules order after them: live
// row 0, each live row R - k whose -k is in the prefix (both deltas land
// on it, -k's first; its own state transition stays), and -rows's state
// transition onto row 0 where 0 is not in the stream (row_job's pass-1
// case). Every CTA walks the live range, kRows rows a lane group at a
// time, skipping those deferred rows: each other row is its own
// read-modify-write. Without a negative prefix (the zoo's streams) no row
// is deferred and no CTA waits.
template <typename TS, typename TA, typename IdT, int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
adam_rows_kernel(const Consts c, const Ptrs q, int group_log2) {
  const IdT* uids = static_cast<const IdT*>(q.uids);
  int64_t neg_end, live_end;
  block_bounds(uids, c.u, 0, c.rows, &neg_end, &live_end);
  if (live_end == 0) return;
  const Scalars s = scalars(c, q);
  const int G = 1 << group_log2;
  const int lane = static_cast<int>(threadIdx.x) & (G - 1);
  const int64_t lgroup = threadIdx.x >> group_log2;
  const int64_t lgroups = kThreads >> group_log2;
  const bool neg = neg_end > 0;
  const bool has0 = neg_end < live_end && uids[neg_end] == 0;
  if (neg && blockIdx.x == 0) {
    for (int64_t r = lgroup; r < neg_end; r += lgroups) {
      detpu::RowJob j;
      if (detpu::row_job(uids, c.u, r, c.rows, 0, &j)) {
        run_job<TS, TA, V>(c, s, q, r, j, lane, G);
      }
    }
    __syncthreads();
    // item r < neg_end: what prefix id r orders after it; item neg_end:
    // live row 0
    for (int64_t r = lgroup; r <= neg_end; r += lgroups) {
      int64_t src = r;
      detpu::RowJob j{0, 0, true, true};
      if (r == neg_end) {
        if (!has0) continue;
      } else {
        const int64_t wr = static_cast<int64_t>(uids[r]) + c.rows;
        if (wr < 0 || (wr == 0 && has0)) continue;
        if (wr == 0) {
          j.slab = false;  // -rows's state transition onto row 0
        } else {
          src = find_id(uids, neg_end, live_end, wr);
          if (src < 0) continue;
          j = detpu::RowJob{wr, wr, true, true};
        }
      }
      run_job<TS, TA, V>(c, s, q, src, j, lane, G);
    }
  }
  auto* slab = static_cast<typename TS::E*>(q.slab);
  auto* mu = static_cast<typename TA::E*>(q.mu);
  auto* nu = static_cast<typename TA::E*>(q.nu);
  const auto* ug = static_cast<const typename TA::E*>(q.ug);
  const int w = c.width;
  const int64_t group = blockIdx.x * lgroups + lgroup;
  const int64_t groups = gridDim.x * lgroups;
  for (int64_t v0 = neg_end + group * kRows; v0 < live_end;
       v0 += groups * kRows) {
    int64_t row[kRows];
    bool live[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t v = v0 + r;
      live[r] = v < live_end;
      row[r] = live[r] ? static_cast<int64_t>(uids[v]) : 0;
      if (live[r] && neg &&
          (row[r] == 0 || detpu::sorted_has(uids, neg_end, row[r] - c.rows))) {
        live[r] = false;  // CTA 0's, behind the prefix
      }
    }
    for (int col = lane * V; col < w; col += G * V) {
      float g[kRows][V], m[kRows][V], n[kRows][V], p[kRows][V];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!live[r]) continue;
        ld_once<TA, V>(ug + (v0 + r) * w + col, g[r]);
        ld<TA, V>(mu + row[r] * w + col, m[r]);
        ld<TA, V>(nu + row[r] * w + col, n[r]);
        ld<TS, V>(slab + row[r] * w + col, p[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!live[r]) continue;
        transition<TS, TA, V>(c, s, g[r], m[r], n[r], p[r]);
        st<TA, V>(mu + row[r] * w + col, m[r]);
        st<TA, V>(nu + row[r] * w + col, n[r]);
        st<TS, V>(slab + row[r] * w + col, p[r]);
      }
    }
  }
}

template <typename TS, typename TA, typename IdT, int V>
cudaError_t launch_v(const Consts& c, const Ptrs& q, cudaStream_t st) {
  int group_log2 = 0;
  const int chunks = (c.width + V - 1) / V;
  while ((1 << group_log2) < chunks && group_log2 < 5) ++group_log2;
  // every lane group of the grid takes kRows rows a round; no more CTAs
  // than the whole output's rows fill, nor than kCtasPerSm a SM
  const int64_t per_cta = static_cast<int64_t>(kThreads >> group_log2) *
                          kRows;
  int64_t grid = (c.u + per_cta - 1) / per_cta;
  const int64_t most = static_cast<int64_t>(c.sms) * kCtasPerSm;
  if (grid > most) grid = most;
  adam_rows_kernel<TS, TA, IdT, V>
      <<<static_cast<unsigned>(grid), kThreads, 0, st>>>(c, q, group_log2);
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

bool aligned(const void* p, int esize) {
  return reinterpret_cast<uintptr_t>(p) % (4 * esize) == 0;
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
  const bool vec = c->width % 4 == 0 && aligned(slab, es) &&
                   aligned(mu, ea) && aligned(nu, ea) && aligned(ugrads, ea);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c->slab_dtype == 0) {
    return c->mom_dtype == 0 ? launch<F32, F32>(*c, q, vec, st)
                             : launch<F32, BF16>(*c, q, vec, st);
  }
  return c->mom_dtype == 0 ? launch<BF16, F32>(*c, q, vec, st)
                           : launch<BF16, BF16>(*c, q, vec, st);
}
