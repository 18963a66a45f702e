// The Adagrad transition of one element, with JAX's rounding chain: the
// one copy that K6 and K7 (adagrad.cu) and the dense-apply epilogue of
// the sorted-segment engine (segment_scatter.cuh, kModeAdagrad) run.
//
// a and g are in the accumulator dtype A (rounded after each operation
// when A is bf16), the update is rounded to the slab dtype S:
//   new = rA(acc + rA(g*g));  r = rA(rsqrt(rA(new + eps)))
//   u = rA(rA(lr*g) * r)           (a constant lr, rounded to A)
//   u = (lr*g) * r in fp32         (a device fp32 lr: JAX promotes)
// The fp32 rsqrt is the correctly rounded __frsqrt_rn; products and sums
// use the _rn intrinsics so no FMA contracts them.
//
// TS and TA are element types with a static rnd(float) (row_update.cuh's
// detpu::F32/BF16 or segment_scatter.cuh's own): the header defines no
// types and no constants, so either source may include it.

#pragma once

#include <cuda_runtime.h>

namespace detpu {

// One element's transition: returns the new accumulator and writes the
// update, rounded to S, to *upd. lr and eps arrive rounded to A for a
// constant lr; with lr_on_card, lr is the fp32 device lr.
template <typename TS, typename TA>
__device__ __forceinline__ float adagrad_transition(float a, float g,
                                                    float lr, bool lr_on_card,
                                                    float eps, float* upd) {
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

}  // namespace detpu
