// K1: row gather with its hotness combine, for Hopper (sm_90a).
//
// Replaces the XLA-lowered gather of the JAX package:
//   distributed_embeddings_tpu/parallel/lookup.py:lookup_group, kind "d"
//   distributed_embeddings_tpu/ops/packed_slab.py:packed_gather
//   distributed_embeddings_tpu/ops/embedding_lookup.py:embedding_lookup
//     (dense branch)
// For every (slot, sample) output row it clips each of the row's `hot`
// ids into the slot's table [0, rows-1], adds the slot's slab row offset,
// reads the slab row, optionally scales it by a per-id weight and zeroes
// it where the slot masks out-of-range ids, sums over `hot` in fp32,
// divides by the slot's divisor (hot for mean slots), and stores once in
// the slab's dtype.
//
// Bound: bytes. The rows read (26 x b x hot x 256 B at the DLRM shapes)
// and the output written dominate; the arithmetic is one add per element
// read. Design: a group of G lanes per output row, each lane moving 16 B
// per load (8 bf16), so a 128-wide bf16 row is one 16-lane load round and
// a warp serves two rows; enough rows are in flight to hide the latency
// of random row reads. Row arithmetic is int64 throughout: 187.8M rows x
// 128 elements is 2.4e10 elements, far past int32.
//
// C interface (ctypes): every pointer and the stream as void*, returns the
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
  __device__ static E store(float f) { return f; }
};

struct BF16 {
  using E = uint16_t;  // raw bf16 bits
  __device__ static float load(E v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  __device__ static E store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

struct Args {
  const void* slab;
  int64_t slab_rows;
  int width;
  const void* ids;      // [n_slots, b, hot]
  const int64_t* rows;  // [n_slots] table rows per slot
  const int64_t* roff;  // [n_slots] first slab row per slot
  const float* div;     // [n_slots] divisor per slot
  const int* mask;      // [n_slots] or null: 1 = out-of-range ids read 0
  const float* weights; // [n_slots, b, hot] or null
  void* out;            // [n_slots, b, width]
  int n_slots;
  int64_t b;
  int hot;
  int group_log2;       // lanes per output row = 1 << group_log2
};

template <typename Tr, int VB, typename IdT>
__global__ void __launch_bounds__(256)
gather_combine_kernel(const Args a) {
  using E = typename Tr::E;
  using RawT = typename Raw<VB>::T;
  constexpr int V = VB / static_cast<int>(sizeof(E));
  const int G = 1 << a.group_log2;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t row = tid >> a.group_log2;  // (slot, sample) output row
  if (row >= static_cast<int64_t>(a.n_slots) * a.b) return;
  const int lane = static_cast<int>(tid & (G - 1));
  const int slot = static_cast<int>(row / a.b);
  const int64_t nrows = a.rows[slot];
  const int64_t base = a.roff[slot];
  const bool masked = a.mask != nullptr && a.mask[slot] != 0;
  const float d = a.div[slot];
  const E* slab = static_cast<const E*>(a.slab);
  const IdT* ids = static_cast<const IdT*>(a.ids) + row * a.hot;
  const float* w = a.weights ? a.weights + row * a.hot : nullptr;
  E* out = static_cast<E*>(a.out) + row * a.width;
  const int nv = a.width / V;
  for (int v = lane; v < nv; v += G) {
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    for (int h = 0; h < a.hot; ++h) {
      const int64_t id = static_cast<int64_t>(ids[h]);
      const int64_t loc = id < 0 ? 0 : (id >= nrows ? nrows - 1 : id);
      int64_t grow = loc + base;
      if (grow >= a.slab_rows) grow = a.slab_rows - 1;  // clip to the slab
      float f = w ? w[h] : 1.f;
      // the JAX lookup multiplies by the 0/1 in-range mask (not a select)
      if (masked && (id < 0 || id >= nrows)) f *= 0.f;
      const RawT raw = __ldg(reinterpret_cast<const RawT*>(
          slab + grow * a.width + static_cast<int64_t>(v) * V));
      E e_in[V];
      memcpy(e_in, &raw, sizeof(raw));
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(f, Tr::load(e_in[e]), acc[e]);
    }
    E e_out[V];
#pragma unroll
    for (int e = 0; e < V; ++e) e_out[e] = Tr::store(acc[e] / d);
    RawT raw_out;
    memcpy(&raw_out, e_out, sizeof(raw_out));
    *reinterpret_cast<RawT*>(out + static_cast<int64_t>(v) * V) = raw_out;
  }
}

template <typename Tr, int VB>
cudaError_t launch(const Args& a, bool ids64, int64_t blocks,
                   cudaStream_t stream) {
  if (ids64) {
    gather_combine_kernel<Tr, VB, int64_t>
        <<<static_cast<unsigned>(blocks), 256, 0, stream>>>(a);
  } else {
    gather_combine_kernel<Tr, VB, int32_t>
        <<<static_cast<unsigned>(blocks), 256, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename Tr>
cudaError_t dispatch(int vb, const Args& a, bool ids64, int64_t blocks,
                     cudaStream_t stream) {
  switch (vb) {
    case 16: return launch<Tr, 16>(a, ids64, blocks, stream);
    case 8: return launch<Tr, 8>(a, ids64, blocks, stream);
    case 4: return launch<Tr, 4>(a, ids64, blocks, stream);
    case 2:
      if constexpr (sizeof(typename Tr::E) <= 2) {
        return launch<Tr, 2>(a, ids64, blocks, stream);
      }
      break;
    default: break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. ids_is_64: ids are int64 (else int32).
extern "C" int detpu_gather_combine(
    const void* slab, int64_t slab_rows, int width, const void* ids,
    int ids_is_64, const void* rows, const void* roff, const void* div,
    const void* mask, const void* weights, void* out, int n_slots,
    int64_t b, int hot, int dtype, void* stream) {
  if (width <= 0 || hot <= 0 || slab_rows <= 0 || n_slots < 0 || b < 0 ||
      (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  const int64_t out_rows = static_cast<int64_t>(n_slots) * b;
  if (out_rows == 0) return cudaSuccess;
  const int esize = dtype == 0 ? 4 : 2;
  // widest vector (16/8/4/2 B) that divides a row and both base pointers
  int vb = 16;
  while (vb > esize &&
         ((width * esize) % vb != 0 ||
          reinterpret_cast<uintptr_t>(slab) % vb != 0 ||
          reinterpret_cast<uintptr_t>(out) % vb != 0)) {
    vb /= 2;
  }
  const int nv = width * esize / vb;
  int group_log2 = 0;
  while ((1 << group_log2) < nv && group_log2 < 5) ++group_log2;
  Args a{slab, slab_rows, width, ids,
         static_cast<const int64_t*>(rows), static_cast<const int64_t*>(roff),
         static_cast<const float*>(div), static_cast<const int*>(mask),
         static_cast<const float*>(weights), out, n_slots, b, hot,
         group_log2};
  const int64_t threads = out_rows << group_log2;
  const int64_t blocks = (threads + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<F32>(vb, a, ids_is_64 != 0, blocks, s)
                    : dispatch<BF16>(vb, a, ids_is_64 != 0, blocks, s);
}
