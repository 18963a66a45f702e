// Shared by the row kernels K6 (adagrad.cu), K11 (adam.cu) and K12
// (momentum.cu): the float32 / bfloat16 element types, their row loads
// and stores, the index rules by which a kernel over the dedup output
// uids [u] (sorted, each id once) reads and writes its rows, and the
// live-range walk all three run (walk_live_rows).
//
// The rules are those of JAX's take(mode="clip") reads and
// .at[uids].set / .add(mode="drop", indices_are_sorted=True) writes
// (distributed_embeddings_tpu/parallel/optimizers.py:214-230, :289-306,
// :336-369):
// - an id >= rows (the dropped-row sentinel, the dedup's pad tail, ids
//   past the slab) is skipped;
// - a negative id -k reads row 0 as it was before the update, and writes
//   row R - k (drop mode wraps once); one still negative is skipped;
// - when the stream holds both -k and R - k, row R - k of the slab takes
//   both deltas, -k's first (it sorts first): rS(rS(slab - u_neg) -
//   u_pos); its state rows take R - k's transition (the later set wins).
// K6, K11 and K12 keep that order inside ONE launch (walk_live_rows): the
// uids are the dedup's SORTED output (signed order: negative ids first,
// then the live ids, then the ids >= rows, the pad tail and the
// sentinel, last), of which the zoo's streams leave ~70% pad. Each CTA
// finds the end of the negative prefix and of the live range by a
// block-wide search (block_bounds: kThreads evenly spaced probes a
// round, 3 rounds for 2.9M ids) and walks only its share of the live
// rows. CTA 0 runs the negative prefix (rare: the zoo has none) first:
// each negative id reads row 0's state (nothing has been written yet),
// adds its delta to its slab row, and writes its state row unless a
// live id of the stream owns that row (or the row is row 0, which the
// other negative ids are still reading; prefix_job). Behind a barrier
// CTA 0 then runs the few rows the rules put after the prefix, which
// every CTA skips: live row 0, each live row R - k whose -k is in the
// prefix, and -R's state transition onto row 0 where 0 is not in the
// stream. A lane group of G lanes (G the V-element chunks of a row
// rounded up to a power of two, at most 32) takes kRows consecutive live
// rows at a time and starts all their loads (gradient rows by a
// streaming load: read once) before the math; each lane moves 16 bytes
// of a float32 row (8 of a bf16 one) a load where the width and the
// call's pointers' alignment allow it (V = 4), single elements
// otherwise. The kernel's per-element transition is its Op (see
// walk_live_rows).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace detpu {

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

// V elements from p (V = 4: one 8- or 16-byte load; V = 1: one element).
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

// Whether the sorted uids [u] hold the value v (binary search).
template <typename IdT>
__device__ bool sorted_has(const IdT* __restrict__ uids, int64_t u,
                           int64_t v) {
  int64_t lo = 0, hi = u;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(uids[mid]) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < u && static_cast<int64_t>(uids[lo]) == v;
}

// What a lane group does for unique row s: read row rd, write the state
// rows at wr when `state`, add the delta to slab row wr when `slab`.
struct RowJob {
  int64_t rd, wr;
  bool state, slab;
};

// The job of the negative prefix id at position s (CTA 0's, first): read
// row 0 as it was, add the delta to row id + rows, and write the state
// there unless the stream's own id of that row does (or the row is row
// 0, which the other prefix ids are reading). False: the wrapped row is
// still negative (skipped).
template <typename IdT>
__device__ bool prefix_job(const IdT* __restrict__ uids, int64_t u,
                           int64_t s, int64_t rows, RowJob* j) {
  const int64_t wr = static_cast<int64_t>(uids[s]) + rows;
  if (wr < 0) return false;
  *j = RowJob{0, wr, wr != 0 && !sorted_has(uids, u, wr), true};
  return true;
}

// ------------------------------------------------ the live-range walk

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

// The first indices of the sorted ids [u] holding a value >= v0 and >= v1
// (u where none), found by the whole block of kThreads threads: each
// round every thread probes one of kThreads evenly spaced positions of
// each open range.
template <int kThreads, typename IdT>
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
template <typename Op>
__device__ void run_job(const Op& op, int64_t src, const RowJob& j,
                        int lane, int G, int w) {
  constexpr int V = Op::kV;
  for (int col = lane * V; col < w; col += G * V) {
    typename Op::Chunk c;
    op.load(c, src, j, col);
    op.step(c);
    op.store(c, j, col);
  }
}

// The walk of one launch of persistent CTAs over the dedup output uids
// [u] (sorted) of a slab of `rows` rows and width w, by the Op of a row
// kernel: V = Op::kV elements a lane a load, and, for a Chunk (the
// registers of V elements of one row),
//   op.load(chunk, src, job, col): the gradient row at position src
//     (ld_once), the state rows at job.rd and the slab row at job.wr
//     when job.slab;
//   op.step(chunk): the transition;
//   op.store(chunk, job, col): the state rows at job.wr when job.state,
//     the slab row when job.slab.
// [neg_end, live_end) is the live range (block_bounds of 0 and rows).
// CTA 0 first runs the prefix's rows (prefix_job: each reads row 0 as it
// was), then, behind a barrier, every row the index rules order after
// them: live row 0, each live row R - k whose -k is in the prefix (both
// deltas land on it, -k's first; its own state transition stays), and
// -rows's state transition onto row 0 where 0 is not in the stream. Every CTA walks the live range, kRows
// rows a lane group at a time, skipping those deferred rows: each other
// row is its own read-modify-write. Without a negative prefix (the zoo's
// streams) no row is deferred and no CTA waits.
template <int kThreads, int kRows, typename IdT, typename Op>
__device__ void walk_live_rows(const Op& op, const IdT* __restrict__ uids,
                               int64_t u, int64_t rows, int w,
                               int group_log2, int64_t neg_end,
                               int64_t live_end) {
  constexpr int V = Op::kV;
  const int G = 1 << group_log2;
  const int lane = static_cast<int>(threadIdx.x) & (G - 1);
  const int64_t lgroup = threadIdx.x >> group_log2;
  const int64_t lgroups = kThreads >> group_log2;
  const bool neg = neg_end > 0;
  const bool has0 = neg_end < live_end && uids[neg_end] == 0;
  if (neg && blockIdx.x == 0) {
    for (int64_t r = lgroup; r < neg_end; r += lgroups) {
      RowJob j;
      if (prefix_job(uids, u, r, rows, &j)) run_job(op, r, j, lane, G, w);
    }
    __syncthreads();
    // item r < neg_end: what prefix id r orders after it; item neg_end:
    // live row 0
    for (int64_t r = lgroup; r <= neg_end; r += lgroups) {
      int64_t src = r;
      RowJob j{0, 0, true, true};
      if (r == neg_end) {
        if (!has0) continue;
      } else {
        const int64_t wr = static_cast<int64_t>(uids[r]) + rows;
        if (wr < 0 || (wr == 0 && has0)) continue;
        if (wr == 0) {
          j.slab = false;  // -rows's state transition onto row 0
        } else {
          src = find_id(uids, neg_end, live_end, wr);
          if (src < 0) continue;
          j = RowJob{wr, wr, true, true};
        }
      }
      run_job(op, src, j, lane, G, w);
    }
  }
  const int64_t group = blockIdx.x * lgroups + lgroup;
  const int64_t groups = gridDim.x * lgroups;
  for (int64_t v0 = neg_end + group * kRows; v0 < live_end;
       v0 += groups * kRows) {
    RowJob job[kRows];
    bool live[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t v = v0 + r;
      live[r] = v < live_end;
      const int64_t row = live[r] ? static_cast<int64_t>(uids[v]) : 0;
      if (live[r] && neg &&
          (row == 0 || sorted_has(uids, neg_end, row - rows))) {
        live[r] = false;  // CTA 0's, behind the prefix
      }
      job[r] = RowJob{row, row, true, true};
    }
    for (int col = lane * V; col < w; col += G * V) {
      typename Op::Chunk c[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (live[r]) op.load(c[r], v0 + r, job[r], col);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!live[r]) continue;
        op.step(c[r]);
        op.store(c[r], job[r], col);
      }
    }
  }
}

// The lane-group size (log2) of a walk over rows of `width` elements, V
// a load: the row's chunks rounded up to a power of two, at most 32.
inline int walk_group_log2(int width, int V) {
  int g = 0;
  const int chunks = (width + V - 1) / V;
  while ((1 << g) < chunks && g < 5) ++g;
  return g;
}

// A walk's grid: every lane group takes kRows rows a round; no more CTAs
// than the whole output's rows fill, nor than ctas_per_sm a SM.
inline int64_t walk_grid(int64_t u, int group_log2, int threads, int rows,
                         int sms, int ctas_per_sm) {
  const int64_t per_cta = static_cast<int64_t>(threads >> group_log2) * rows;
  const int64_t grid = (u + per_cta - 1) / per_cta;
  const int64_t most = static_cast<int64_t>(sms) * ctas_per_sm;
  return grid > most ? most : grid;
}

// Whether p is aligned to 4 elements of esize bytes (a V = 4 load).
inline bool aligned4(const void* p, int esize) {
  return reinterpret_cast<uintptr_t>(p) % (4 * esize) == 0;
}

}  // namespace detpu
