// K3: sparse SGD scatter-add, for Hopper (sm_90a), on the sorted-segment
// engine of segment_scatter.cuh.
//
// Replaces the XLA-lowered row scatter of the JAX package:
//   distributed_embeddings_tpu/parallel/optimizers.py:_sorted_scatter_add
//   distributed_embeddings_tpu/parallel/optimizers.py:SparseSGD.apply_rows
//   (and SparseAdagrad's dense-apply sum, :197-209)
// which computes slab.at[ids].add(-lr * vals.astype(slab.dtype),
// mode="drop"). For every stream row i whose id lies in the slab (a
// negative id counts from the end once, as JAX indexing does; anything
// else outside [0, rows) is dropped, the dropped-row sentinel included)
// it adds round(nl * round(vals[i])) to slab[id] in the slab's dtype,
// where nl is -lr: rounded to the slab dtype by the wrapper for a
// constant lr, or the float32 -lr of the lr the kernel reads for a
// device scalar lr. Every add rounds to the slab dtype, as the JAX
// scatter does after every add.
//
// With cast_vals = 0 the update is that of SparseSGD's DETPU_SGD_DEDUP
// branch, slab.at[uids].add((-lr * uvals).astype(slab.dtype)): vals are
// NOT rounded to the slab dtype first; the product rounds to the vals
// dtype for a constant lr (nl rounded to it by the wrapper), stays
// float32 for a device scalar lr, and rounds once to the slab dtype.
//
// Order and determinism: the engine adds a row's updates in stream order
// (a stable sort), so a row hit at most L = kSplit times gets exactly the
// stream-order plain version's bits (ops/scatter_add.py:
// sgd_scatter_plain, index_add_ on the CPU), and a row hit once the bits
// of the single add. A row hit more often is cut into chunks of L; each
// chunk is summed in float32 by a group of its own and the row gets the
// chunks' sums in chunk order, each add rounded to the slab dtype: the
// same bits on every run, within k ulps of the plain version for k hits.
// No atomics touch a row.
//
// The Adagrad mode (detpu_adagrad_scatter_*): SparseAdagrad's dense-apply
// branch as one call of the engine (segment_scatter.cuh, kModeAdagrad):
// each hit row's gradient summed as K3 sums it into a zero gradient slab
// with lr = -1 (vals already in the accumulator dtype), then the Adagrad
// transition applied to that row of the accumulator and the slab where
// its sum is complete. The bits of the zero-fill + K3 + K7 chain on every
// row it writes; rows no id hits are never read or written.
//
// C interface (ctypes): detpu_sgd_scatter_prepare validates one call's
// layout and writes a prepared launch (detpu_segment_prepared_bytes()
// bytes of host memory the caller owns) over a scratch buffer on the card
// (detpu_sgd_scatter_scratch_bytes, zeroed once by the caller and kept
// for that prepared launch: one stream at a time); detpu_sgd_scatter_
// launch takes it with the per-call pointers and the stream. Both return
// a cudaError_t.

#include "segment_scatter.cuh"

namespace {

struct Prepared {
  Params p;
  int rows_blocks[2];  // [one column a lane, four]
  int comb_blocks[2];
};

template <typename Ts, typename Tv, int kMode>
void occupancy(Prepared* pr) {
  const int sms = pr->p.sms;
  pr->rows_blocks[0] = resident_blocks(seg_rows<Ts, Tv, kMode, 1>, 0, sms);
  pr->rows_blocks[1] = resident_blocks(seg_rows<Ts, Tv, kMode, 4>, 0, sms);
  pr->comb_blocks[0] = resident_blocks(seg_combine<Ts, Tv, kMode, 1>, 0,
                                       sms);
  pr->comb_blocks[1] = resident_blocks(seg_combine<Ts, Tv, kMode, 4>, 0,
                                       sms);
}

template <int kMode>
void occupancy_of(Prepared* pr) {
  if (pr->p.slab_dtype == 0) {
    if (pr->p.vals_dtype == 0) {
      occupancy<F32, F32, kMode>(pr);
    } else {
      occupancy<F32, BF16, kMode>(pr);
    }
  } else if (pr->p.vals_dtype == 0) {
    occupancy<BF16, F32, kMode>(pr);
  } else {
    occupancy<BF16, BF16, kMode>(pr);
  }
}

template <typename Ts, typename Tv, int kMode, int E>
cudaError_t rows_pass(const Params& p, int blocks, int comb_blocks,
                      cudaStream_t st) {
  seg_rows<Ts, Tv, kMode, E><<<blocks, kThreads, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.split == 0) return e;
  seg_combine<Ts, Tv, kMode, E><<<comb_blocks, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename Ts, typename Tv, int kMode>
cudaError_t rows_of(const Prepared& pr, const Params& p, cudaStream_t st) {
  return p.vec ? rows_pass<Ts, Tv, kMode, 4>(p, pr.rows_blocks[1],
                                             pr.comb_blocks[1], st)
               : rows_pass<Ts, Tv, kMode, 1>(p, pr.rows_blocks[0],
                                             pr.comb_blocks[0], st);
}

// The sort, the segment lists and the rows pass of a prepared call whose
// per-call pointers are set.
template <int kMode>
cudaError_t run(const Prepared& pr, const Params& p, cudaStream_t st) {
  cudaError_t e = p.ids64 ? sort_and_list<int64_t>(p, st)
                          : sort_and_list<int32_t>(p, st);
  if (e != cudaSuccess) return e;
  if (p.slab_dtype == 0) {
    return p.vals_dtype == 0 ? rows_of<F32, F32, kMode>(pr, p, st)
                             : rows_of<F32, BF16, kMode>(pr, p, st);
  }
  return p.vals_dtype == 0 ? rows_of<BF16, F32, kMode>(pr, p, st)
                           : rows_of<BF16, BF16, kMode>(pr, p, st);
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int64_t detpu_segment_prepared_bytes() {
  return static_cast<int64_t>(sizeof(Prepared));
}

// K3's chunk L and the pairs a sort tile takes.
extern "C" int64_t detpu_segment_split() { return kSplit; }
extern "C" int64_t detpu_segment_sort_tile() { return kTile; }

// Bytes of card scratch a call of n ids (width columns) needs.
extern "C" int64_t detpu_sgd_scatter_scratch_bytes(int64_t n, int width) {
  return carve(nullptr, n, width, kSplit, nullptr);
}

// slab [rows, width] (slab_dtype 0 = float32, 1 = bfloat16), ids [n]
// (int32, or int64 when ids_is_64), vals [n, width] (vals_dtype as the
// slab's), n < 2^31, rows < 2^32. neg_lr is used unless lr_on_card, when
// each launch reads the float32 lr at its `lr` pointer. cast_vals: 1
// rounds vals to the slab dtype before the product (the stream update), 0
// takes the dedup branch's chain. scratch: detpu_sgd_scatter_scratch_bytes
// bytes, 256-B aligned.
extern "C" int detpu_sgd_scatter_prepare(int64_t rows, int width,
                                         int slab_dtype, int ids_is_64,
                                         int64_t n, int vals_dtype,
                                         float neg_lr, int lr_on_card,
                                         int cast_vals, void* scratch,
                                         void* out) {
  Prepared* pr = static_cast<Prepared*>(out);
  if (pr == nullptr) return cudaErrorInvalidValue;
  memset(pr, 0, sizeof(Prepared));
  cudaError_t e = prepare(rows, width, slab_dtype, vals_dtype, ids_is_64, n,
                          kModeK3, cast_vals, neg_lr, lr_on_card, kSplit,
                          scratch, &pr->p);
  if (e != cudaSuccess) return e;
  occupancy_of<kModeK3>(pr);
  return cudaGetLastError();
}

// Launch a prepared K3 call on `stream`: the slab (updated in place), ids,
// vals, and the float32 lr on the card (null for a constant lr).
extern "C" int detpu_sgd_scatter_launch(const void* prepared, void* slab,
                                        const void* ids, const void* vals,
                                        const void* lr, void* stream) {
  const Prepared* pr = static_cast<const Prepared*>(prepared);
  if (pr == nullptr || (pr->p.lr_on_card && lr == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (pr->p.n == 0) return cudaSuccess;
  Params p = pr->p;
  p.slab = slab;
  p.ids = ids;
  p.vals = vals;
  p.lr = static_cast<const float*>(lr);
  const int ssz = p.slab_dtype == 0 ? 4 : 2;
  const int vsz = p.vals_dtype == 0 ? 4 : 2;
  p.vec = p.width % 4 == 0 && aligned(slab, 4 * ssz) &&
          aligned(vals, 4 * vsz);
  shape_groups(&p);
  return run<kModeK3>(*pr, p, static_cast<cudaStream_t>(stream));
}

// The Adagrad mode: slab [rows, width] (slab_dtype) and acc [rows, width]
// (acc_dtype; dtype codes as K3's), updated in place from ids [n] (int32,
// or int64 when ids_is_64) and vals [n, width] in acc_dtype, n < 2^31,
// rows < 2^32. lr and eps rounded to acc_dtype by the caller; lr is used
// unless lr_on_card, when each launch reads the float32 lr at its `lr`
// pointer. scratch: detpu_sgd_scatter_scratch_bytes bytes, 256-B aligned.
extern "C" int detpu_adagrad_scatter_prepare(int64_t rows, int width,
                                             int slab_dtype, int acc_dtype,
                                             int ids_is_64, int64_t n,
                                             float lr, int lr_on_card,
                                             float eps, void* scratch,
                                             void* out) {
  Prepared* pr = static_cast<Prepared*>(out);
  if (pr == nullptr) return cudaErrorInvalidValue;
  memset(pr, 0, sizeof(Prepared));
  cudaError_t e = prepare(rows, width, slab_dtype, acc_dtype, ids_is_64, n,
                          kModeAdagrad, 1, 0.0f, lr_on_card, kSplit, scratch,
                          &pr->p);
  if (e != cudaSuccess) return e;
  pr->p.ada_lr = lr;
  pr->p.eps = eps;
  occupancy_of<kModeAdagrad>(pr);
  return cudaGetLastError();
}

// Launch a prepared Adagrad-mode call on `stream`: the slab and the
// accumulator (updated in place), ids, vals, and the float32 lr on the
// card (null for a constant lr).
extern "C" int detpu_adagrad_scatter_launch(const void* prepared, void* slab,
                                            void* acc, const void* ids,
                                            const void* vals, const void* lr,
                                            void* stream) {
  const Prepared* pr = static_cast<const Prepared*>(prepared);
  if (pr == nullptr || slab == nullptr || acc == nullptr ||
      (pr->p.lr_on_card && lr == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (pr->p.n == 0) return cudaSuccess;
  Params p = pr->p;
  p.slab = slab;
  p.acc = acc;
  p.ids = ids;
  p.vals = vals;
  p.lr = static_cast<const float*>(lr);
  const int ssz = p.slab_dtype == 0 ? 4 : 2;
  const int asz = p.vals_dtype == 0 ? 4 : 2;
  p.vec = p.width % 4 == 0 && aligned(slab, 4 * ssz) &&
          aligned(acc, 4 * asz) && aligned(vals, 4 * asz);
  shape_groups(&p);
  return run<kModeAdagrad>(*pr, p, static_cast<cudaStream_t>(stream));
}
