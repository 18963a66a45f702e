// K9: the ragged backward's per-position cotangent stream, for Hopper
// (sm_90a).
//
// Replaces the XLA-lowered ragged backward of the JAX package (ROADMAP
// queue B6):
//   distributed_embeddings_tpu/parallel/apply.py:cotangent_width_streams,
//     ragged branch (:222-261): take the row's cotangent for every value
//     position, times the position's weight, divided by the row's length
//     on mean slots; the id, or the dropped-row sentinel;
//   distributed_embeddings_tpu/ops/sparse_grad.py:combiner_grad_values
//     (the same rows without ids, mean as a multiply by 1/length)
// the counterpart of the reference library's variable-hotness backward
// (embedding_lookup_kernels.cu:493-494, 539-627).
// For every slot and every position p < cap it writes
//   * the id v + roff if p lies in a row and 0 <= v < rows, else the
//     sentinel (a row past the slab: the optimizer drops it), when ids
//     are asked for; v is values[p], less the slot's row base where the
//     launch has bases (a row-sliced slot holds the rows [rbase, rbase +
//     rows) of its table: ids outside the slice drop; a template flag, so
//     the launch without bases keeps the registers and instruction stream
//     it had);
//   * the row g[row(p)] * w_p / len (a row slice's cotangent is the
//     row's whole cotangent, len its whole length), in the cotangent's
//     dtype, rounded
//     after each op as JAX does: the weight rounds to the dtype and the
//     product rounds, then the division by max(len, 1) (rounded to the
//     dtype) rounds; the reciprocal mode multiplies by round(1 / len).
// Positions past the slot's last row get the sentinel and zero rows.
// Every position is written: the caller's buffers are uninitialized, and
// an unwritten id would be a corrupt update.
//
// Bound: bytes. The stream it writes (26.4M rows x 256 B of bf16 plus
// 4 B ids at the ragged DLRM's shapes, 6.9 GB) dominates; it reads each
// cotangent row once per row, the ids and weights once. Design: a group
// of G lanes per (slot, row), each lane 16 B of the row, so a 128-wide
// bf16 row is 16 lanes; the group holds its cotangent row in registers
// and writes one coalesced 256 B row per position. Extra blocks past the
// row groups fill each slot's tail in a grid-stride loop. Element offsets
// are int64: the stream holds 3.4e9 elements, past 2^31.
//
// Host side: a launch record (ops/sparse_grad.py) keyed on the layouts,
// the dtypes and the call's constant facts (cap, sentinel, the id
// dtypes, the mean mode, which optional inputs are given) holds them in a
// prepared launch (detpu_ragged_grad_prepare); each call passes its
// pointers to detpu_ragged_grad_launch, which picks the widest row access
// the cotangent's and the output's alignment allow. The launch keeps no
// state between calls, so the record replays in a CUDA graph.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

template <int BYTES> struct Raw;
template <> struct Raw<16> { using T = uint4; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<4> { using T = uint32_t; };
template <> struct Raw<2> { using T = uint16_t; };

struct F32 {
  using E = float;
  __device__ static float load(E v) { return v; }
  __device__ static float rnd(float f) { return f; }
  __device__ static E store(float f) { return f; }
};

struct BF16 {
  using E = uint16_t;  // raw bf16 bits
  __device__ static float load(E v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  __device__ static float rnd(float f) {
    return __bfloat162float(__float2bfloat16_rn(f));
  }
  __device__ static E store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

struct Args {
  const void* g;          // cotangent rows, (slot, r) at
  int64_t g_slot_stride;  //   g + slot * g_slot_stride + r * g_row_stride
  int64_t g_row_stride;
  int width;
  const int64_t* splits;  // [n_slots, b + 1]
  const void* values;     // [n_slots, *] ids, row stride v_stride, or null
  int64_t v_stride;
  const int64_t* rows;    // [n_slots] table rows per slot
  const int64_t* roff;    // [n_slots] first slab row per slot
  const int64_t* rbase;   // [n_slots] row base per slot, or null
  int64_t sentinel;
  void* ids_out;          // [n_slots, cap] or null
  const int* mean;        // [n_slots] or null
  int reciprocal;         // 1: multiply by round(1 / len); 0: divide
  const void* weights;    // [n_slots, *] f32 bits, row stride w_stride
  int64_t w_stride;
  int w_esize;            // 4: f32/int32 elements; 8: int64 (low half)
  void* vals_out;         // [n_slots, cap, width]
  int n_slots;
  int64_t b;
  int64_t cap;
  int group_log2;
  int64_t row_blocks;     // blocks of row groups; the rest fill tails
};

__device__ __forceinline__ void put_id(void* out, int ids64, int64_t i,
                                       int64_t v) {
  if (ids64) {
    static_cast<int64_t*>(out)[i] = v;
  } else {
    static_cast<int32_t*>(out)[i] = static_cast<int32_t>(v);
  }
}

template <typename Tr, int VB, typename IdT, bool RB>
__global__ void __launch_bounds__(256)
ragged_grad_kernel(const Args a, int ids64) {
  using E = typename Tr::E;
  using RawT = typename Raw<VB>::T;
  constexpr int V = VB / static_cast<int>(sizeof(E));
  const int G = 1 << a.group_log2;
  const int nv = a.width / V;
  E* vals = static_cast<E*>(a.vals_out);

  if (blockIdx.x >= a.row_blocks) {
    // tails: positions [min(splits[b], cap), cap) of every slot
    const int64_t tid =
        static_cast<int64_t>(blockIdx.x - a.row_blocks) * blockDim.x +
        threadIdx.x;
    const int64_t groups =
        (static_cast<int64_t>(gridDim.x - a.row_blocks) * blockDim.x) >>
        a.group_log2;
    const int64_t gid = tid >> a.group_log2;
    const int lane = static_cast<int>(tid & (G - 1));
    RawT zero;
    memset(&zero, 0, sizeof(zero));
    for (int slot = 0; slot < a.n_slots; ++slot) {
      int64_t t0 = a.splits[static_cast<int64_t>(slot) * (a.b + 1) + a.b];
      t0 = t0 < 0 ? 0 : (t0 > a.cap ? a.cap : t0);
      for (int64_t p = t0 + gid; p < a.cap; p += groups) {
        const int64_t q = static_cast<int64_t>(slot) * a.cap + p;
        for (int v = lane; v < nv; v += G) {
          *reinterpret_cast<RawT*>(vals + q * a.width +
                                   static_cast<int64_t>(v) * V) = zero;
        }
        if (a.ids_out != nullptr && lane == 0) {
          put_id(a.ids_out, ids64, q, a.sentinel);
        }
      }
    }
    return;
  }

  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t row = tid >> a.group_log2;  // (slot, r)
  if (row >= static_cast<int64_t>(a.n_slots) * a.b) return;
  const int lane = static_cast<int>(tid & (G - 1));
  const int slot = static_cast<int>(row / a.b);
  const int64_t r = row - static_cast<int64_t>(slot) * a.b;
  const int64_t* sp = a.splits + static_cast<int64_t>(slot) * (a.b + 1);
  const int64_t s0 = sp[r], s1 = sp[r + 1];
  const int64_t start =
      r == 0 ? 0 : (s0 < 0 ? 0 : (s0 > a.cap ? a.cap : s0));
  const int64_t end = s1 < start ? start : (s1 > a.cap ? a.cap : s1);
  if (start == end) return;
  const bool is_mean = a.mean != nullptr && a.mean[slot] != 0;
  const int64_t len = s1 - s0;
  const float count = Tr::rnd(static_cast<float>(len > 1 ? len : 1));
  const float inv = Tr::rnd(__fdiv_rn(1.f, count));
  const E* g = static_cast<const E*>(a.g) + slot * a.g_slot_stride +
               r * a.g_row_stride;
  const uint32_t* wb = static_cast<const uint32_t*>(a.weights);
  const int64_t wstep = a.w_esize / 4;
  const int64_t wbase = static_cast<int64_t>(slot) * a.w_stride * wstep;
  const IdT* ids = a.values == nullptr ? nullptr
      : static_cast<const IdT*>(a.values) +
            static_cast<int64_t>(slot) * a.v_stride;
  const int64_t nrows = a.rows != nullptr ? a.rows[slot] : 0;
  const int64_t base = a.roff != nullptr ? a.roff[slot] : 0;
  const int64_t rb = RB ? a.rbase[slot] : 0;

  for (int v = lane; v < nv; v += G) {
    const int64_t col = static_cast<int64_t>(v) * V;
    const RawT graw = *reinterpret_cast<const RawT*>(g + col);
    E ge[V];
    memcpy(ge, &graw, sizeof(graw));
    float gf[V];
#pragma unroll
    for (int e = 0; e < V; ++e) gf[e] = Tr::load(ge[e]);
    for (int64_t p = start; p < end; ++p) {
      const float w =
          wb ? Tr::rnd(__uint_as_float(wb[wbase + p * wstep])) : 1.f;
      E o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float t = gf[e];
        if (wb) t = Tr::rnd(__fmul_rn(t, w));
        if (is_mean) {
          t = a.reciprocal ? Tr::rnd(__fmul_rn(t, inv))
                           : Tr::rnd(__fdiv_rn(t, count));
        }
        o[e] = Tr::store(t);
      }
      RawT raw;
      memcpy(&raw, o, sizeof(raw));
      const int64_t q = static_cast<int64_t>(slot) * a.cap + p;
      *reinterpret_cast<RawT*>(vals + q * a.width + col) = raw;
      if (a.ids_out != nullptr && v == 0) {
        int64_t id = static_cast<int64_t>(ids[p]);
        if constexpr (RB) id -= rb;  // the slot's range-local id
        put_id(a.ids_out, ids64, q,
                    id >= 0 && id < nrows ? id + base : a.sentinel);
      }
    }
  }
}

template <typename Tr, int VB, bool RB>
cudaError_t launch_based(const Args& a, bool in64, int out64, int64_t blocks,
                         cudaStream_t stream) {
  if (in64) {
    ragged_grad_kernel<Tr, VB, int64_t, RB>
        <<<static_cast<unsigned>(blocks), 256, 0, stream>>>(a, out64);
  } else {
    ragged_grad_kernel<Tr, VB, int32_t, RB>
        <<<static_cast<unsigned>(blocks), 256, 0, stream>>>(a, out64);
  }
  return cudaGetLastError();
}

template <typename Tr, int VB>
cudaError_t launch(const Args& a, bool in64, int out64, int64_t blocks,
                   cudaStream_t stream) {
  return a.rbase != nullptr
      ? launch_based<Tr, VB, true>(a, in64, out64, blocks, stream)
      : launch_based<Tr, VB, false>(a, in64, out64, blocks, stream);
}

template <typename Tr>
cudaError_t dispatch(int vb, const Args& a, bool in64, int out64,
                     int64_t blocks, cudaStream_t stream) {
  switch (vb) {
    case 16: return launch<Tr, 16>(a, in64, out64, blocks, stream);
    case 8: return launch<Tr, 8>(a, in64, out64, blocks, stream);
    case 4: return launch<Tr, 4>(a, in64, out64, blocks, stream);
    case 2:
      if constexpr (sizeof(typename Tr::E) <= 2) {
        return launch<Tr, 2>(a, in64, out64, blocks, stream);
      }
      break;
    default: break;
  }
  return cudaErrorInvalidValue;
}

// What a K9 record fixes: the layout, the dtypes and the constants.
struct Prepared {
  int64_t g_slot_stride, g_row_stride, v_stride, w_stride, sentinel, b, cap;
  int width, dtype, ids_in_64, ids_out_64, has_ids, has_mean, reciprocal;
  int w_esize;  // 0: no weights
  int n_slots;
  int has_rbase;
};

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The bytes of a prepared K9 launch.
extern "C" int64_t detpu_ragged_grad_prepared_bytes() {
  return static_cast<int64_t>(sizeof(Prepared));
}

// Validate a K9 record and write its prepared launch to `out`
// (detpu_ragged_grad_prepared_bytes() bytes of host memory). dtype: 0 =
// float32, 1 = bfloat16 (cotangent and output rows); the cotangent row of
// (slot, r) at slot * g_slot_stride + r * g_row_stride elements. has_ids:
// an id stream (values of ids_in_64 width, row stride v_stride, and
// rows/roff) into ids_out of ids_out_64 width. w_esize: 0 = no weights,
// 4 = float32 (or int32 bits), 8 = int64 elements whose low 32 bits are
// the float32 bits, row stride w_stride. has_rbase: the id stream
// subtracts per-slot row bases (int64). Launches nothing.
extern "C" int detpu_ragged_grad_prepare(
    int64_t g_slot_stride, int64_t g_row_stride, int width, int dtype,
    int has_ids, int ids_in_64, int64_t v_stride, int64_t sentinel,
    int ids_out_64, int has_mean, int reciprocal, int w_esize,
    int64_t w_stride, int n_slots, int64_t b, int64_t cap, int has_rbase,
    void* out) {
  if (out == nullptr || width <= 0 || n_slots < 0 || b < 0 || cap < 0 ||
      (dtype != 0 && dtype != 1) ||
      (w_esize != 0 && w_esize != 4 && w_esize != 8) ||
      (has_rbase != 0 && has_ids == 0)) {
    return cudaErrorInvalidValue;
  }
  Prepared* pr = static_cast<Prepared*>(out);
  memset(pr, 0, sizeof(Prepared));
  *pr = Prepared{g_slot_stride, g_row_stride, v_stride, w_stride, sentinel,
                 b, cap, width, dtype, ids_in_64 != 0, ids_out_64 != 0,
                 has_ids != 0, has_mean != 0, reciprocal != 0, w_esize,
                 n_slots, has_rbase != 0};
  return cudaSuccess;
}

// K9 through a prepared launch: the call's pointers (values, rows, roff
// and ids_out given exactly when the record has an id stream, mean,
// rbase and weights when it has them; null otherwise). Rows move 16
// bytes a lane where the width, the cotangent's strides and the two row
// pointers allow it, else 8, 4 or 2.
extern "C" int detpu_ragged_grad_launch(
    const void* prepared, const void* g, const void* splits,
    const void* values, const void* rows, const void* roff, const void* rbase,
    const void* mean, const void* weights, void* ids_out, void* vals_out,
    void* stream) {
  const Prepared* pr = static_cast<const Prepared*>(prepared);
  if (pr == nullptr) return cudaErrorInvalidValue;
  const bool ids = pr->has_ids != 0;
  if (g == nullptr || splits == nullptr || vals_out == nullptr ||
      (values != nullptr) != ids || (ids_out != nullptr) != ids ||
      (ids && (rows == nullptr || roff == nullptr)) ||
      (mean != nullptr) != (pr->has_mean != 0) ||
      (rbase != nullptr) != (pr->has_rbase != 0) ||
      (weights != nullptr) != (pr->w_esize != 0)) {
    return cudaErrorInvalidValue;
  }
  if (static_cast<int64_t>(pr->n_slots) * pr->cap == 0) return cudaSuccess;
  const int esize = pr->dtype == 0 ? 4 : 2;
  int vb = 16;
  while (vb > esize && ((pr->width * esize) % vb != 0 ||
                        (pr->g_slot_stride * esize) % vb != 0 ||
                        (pr->g_row_stride * esize) % vb != 0 ||
                        reinterpret_cast<uintptr_t>(g) % vb != 0 ||
                        reinterpret_cast<uintptr_t>(vals_out) % vb != 0)) {
    vb /= 2;
  }
  const int nv = pr->width * esize / vb;
  int group_log2 = 0;
  while ((1 << group_log2) < nv && group_log2 < 5) ++group_log2;
  const int64_t row_threads =
      (static_cast<int64_t>(pr->n_slots) * pr->b) << group_log2;
  const int64_t row_blocks = (row_threads + 255) / 256;
  const int64_t tail_blocks = 264;  // two waves of 132 SMs
  const int64_t blocks = row_blocks + tail_blocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const Args a{g, pr->g_slot_stride, pr->g_row_stride, pr->width,
               static_cast<const int64_t*>(splits), values, pr->v_stride,
               static_cast<const int64_t*>(rows),
               static_cast<const int64_t*>(roff),
               static_cast<const int64_t*>(rbase), pr->sentinel, ids_out,
               static_cast<const int*>(mean), pr->reciprocal, weights,
               pr->w_stride, pr->w_esize ? pr->w_esize : 4, vals_out,
               pr->n_slots, pr->b, pr->cap, group_log2, row_blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool in64 = pr->ids_in_64 != 0;
  return pr->dtype == 0
      ? dispatch<F32>(vb, a, in64, pr->ids_out_64, blocks, s)
      : dispatch<BF16>(vb, a, in64, pr->ids_out_64, blocks, s);
}
