// K18: sparse SGD into a bfloat16 slab with a float32 learning rate (the
// promoted scatter), for Hopper (sm_90a), on the sorted-segment engine of
// segment_scatter.cuh.
//
// Replaces the XLA-lowered scatter of the JAX package when the lr is a
// traced float32 scalar (a callable schedule) and the slab is bfloat16:
//   distributed_embeddings_tpu/parallel/optimizers.py:_sorted_scatter_add
//   under SparseSGD.apply_rows
// slab.at[ids].add(-lr * vals.astype(bf16), mode="drop"): the update is
// float32 (lr is a strong f32 scalar), so XLA converts the WHOLE slab to
// float32, scatter-adds in float32 in stream order, and rounds every
// element back to bfloat16 once. For each slab row r hit by an in-range id
// (a negative id counts from the end once; anything else outside [0, rows)
// is dropped, the dropped-row sentinel included) this kernel computes
//   slab[r] = bf16_rn(((f32(slab[r]) + u_i0) + u_i1) + ...)
//   u_i = f32(-lr) * f32(bf16(vals[i]))   (one float32 rounding)
// over the ids i hitting r in stream order; rows not hit keep their bits
// (the f32 round trip of a bf16 value is exact), and no float32 copy of
// the slab is ever made.
//
// The chain is never split: every row is bit-exact to the stream-order
// plain version (ops/scatter_add.py:sgd_scatter_promoted_plain). What the
// engine changes is how the chain is fed: a segment of 256 entries or
// more (a Zipfian hot row: 33,334 at the example's stream) gets a block
// for each 32 columns, whose threads stream its update rows through a
// shared-memory ring while one warp runs the column chains; it starts at
// the beginning of the rows pass (longest first), so its serial chain is
// bounded by its dependent adds, not by load latency.
//
// C interface (ctypes): as K3's (sgd_scatter.cu), without cast_vals,
// constant lr or split.

#include "segment_scatter.cuh"

namespace {

struct Prepared {
  Params p;
  int rows_blocks[2];  // [one column a lane, four]
};

constexpr int kRing = kStages * kStageBytes;

template <typename Tv>
cudaError_t occupancy(Prepared* pr) {
  auto k1 = seg_rows<BF16, Tv, kModeK18, 1>;
  auto k4 = seg_rows<BF16, Tv, kModeK18, 4>;
  cudaError_t e = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, kRing);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(k4, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kRing);
  if (e != cudaSuccess) return e;
  pr->rows_blocks[0] = resident_blocks(k1, kRing, pr->p.sms);
  pr->rows_blocks[1] = resident_blocks(k4, kRing, pr->p.sms);
  return cudaGetLastError();
}

template <typename Tv>
cudaError_t rows_of(const Prepared& pr, const Params& p, cudaStream_t st) {
  if (p.vec) {
    seg_rows<BF16, Tv, kModeK18, 4>
        <<<pr.rows_blocks[1], kThreads, kRing, st>>>(p);
  } else {
    seg_rows<BF16, Tv, kModeK18, 1>
        <<<pr.rows_blocks[0], kThreads, kRing, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int64_t detpu_segment_prepared_bytes() {
  return static_cast<int64_t>(sizeof(Prepared));
}

// The entries from which a segment takes the block path.
extern "C" int64_t detpu_segment_long() { return 1ll << kLongClass; }

// Bytes of card scratch a call of n ids needs.
extern "C" int64_t detpu_sgd_promoted_scratch_bytes(int64_t n, int width) {
  return carve(nullptr, n, width, 0, nullptr);
}

// slab [rows, width] bfloat16, ids [n] (int32, or int64 when ids_is_64),
// vals [n, width] (vals_dtype 0 = float32, 1 = bfloat16), n < 2^31,
// rows < 2^32; each launch reads the float32 lr at its `lr` pointer.
// scratch: detpu_sgd_promoted_scratch_bytes bytes, 256-B aligned.
extern "C" int detpu_sgd_promoted_prepare(int64_t rows, int width,
                                          int ids_is_64, int64_t n,
                                          int vals_dtype, void* scratch,
                                          void* out) {
  Prepared* pr = static_cast<Prepared*>(out);
  if (pr == nullptr) return cudaErrorInvalidValue;
  memset(pr, 0, sizeof(Prepared));
  cudaError_t e = prepare(rows, width, 1, vals_dtype, ids_is_64, n,
                          kModeK18, 1, 0.f, 1, 0, scratch, &pr->p);
  if (e != cudaSuccess) return e;
  return vals_dtype == 0 ? occupancy<F32>(pr) : occupancy<BF16>(pr);
}

// Launch a prepared K18 call on `stream`: the bfloat16 slab (updated in
// place), ids, vals and the float32 lr on the card.
extern "C" int detpu_sgd_promoted_launch(const void* prepared, void* slab,
                                         const void* ids, const void* vals,
                                         const void* lr, void* stream) {
  const Prepared* pr = static_cast<const Prepared*>(prepared);
  if (pr == nullptr || lr == nullptr) return cudaErrorInvalidValue;
  if (pr->p.n == 0) return cudaSuccess;
  Params p = pr->p;
  p.slab = slab;
  p.ids = ids;
  p.vals = vals;
  p.lr = static_cast<const float*>(lr);
  const int vsz = p.vals_dtype == 0 ? 4 : 2;
  p.vec = p.width % 4 == 0 && aligned(slab, 8) && aligned(vals, 4 * vsz);
  p.vec16 = (p.width * vsz) % 16 == 0 && aligned(vals, 16);
  shape_groups(&p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = p.ids64 ? sort_and_list<int64_t>(p, st)
                          : sort_and_list<int32_t>(p, st);
  if (e != cudaSuccess) return e;
  return p.vals_dtype == 0 ? rows_of<F32>(*pr, p, st)
                           : rows_of<BF16>(*pr, p, st);
}
