// Shared by the row kernels K6 (adagrad.cu), K11 (adam.cu) and K12
// (momentum.cu): the float32 / bfloat16 element types, their row loads
// and stores, and the index rules by which a kernel over the dedup
// output uids [u] (sorted, each id once) reads and writes its rows.
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
// So a launch runs two passes over uids, in order on the stream:
// pass 0, the negative ids: each reads row 0's state (nothing has been
//   written yet), adds its delta to its slab row, and writes its state
//   row unless a non-negative id of the stream owns that row (or the
//   row is row 0, which the other negative ids are still reading);
// pass 1, the other ids as one read-modify-write each; and -R, whose
//   row is row 0, writes its state transition there unless id 0 is in
//   the stream (no other thread reads row 0 in this pass then).

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

// What the thread group of unique row s does in pass `pass` (see the
// header): read row rd, write the state rows at wr when `state`, add the
// delta to slab row wr when `slab`. False: nothing.
struct RowJob {
  int64_t rd, wr;
  bool state, slab;
};

template <typename IdT>
__device__ bool row_job(const IdT* __restrict__ uids, int64_t u, int64_t s,
                        int64_t rows, int pass, RowJob* j) {
  const int64_t id = static_cast<int64_t>(uids[s]);
  if (id >= rows) return false;
  if (id >= 0) {
    if (pass == 0) return false;
    *j = RowJob{id, id, true, true};
    return true;
  }
  const int64_t wr = id + rows;
  if (wr < 0) return false;
  if (pass == 0) {
    *j = RowJob{0, wr, wr != 0 && !sorted_has(uids, u, wr), true};
    return true;
  }
  if (wr == 0 && !sorted_has(uids, u, 0)) {
    *j = RowJob{0, 0, true, false};
    return true;
  }
  return false;
}

}  // namespace detpu
