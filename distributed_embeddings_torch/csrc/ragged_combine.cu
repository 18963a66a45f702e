// K8: ragged (CSR) gather + combine, for Hopper (sm_90a).
//
// Replaces the XLA-lowered ragged lookup of the JAX package (ROADMAP
// queue B5):
//   distributed_embeddings_tpu/ops/embedding_lookup.py:_ragged_combine
//   distributed_embeddings_tpu/parallel/lookup.py:lookup_group,
//     kinds "r" and "rw" (gather, weights, mask, segment scatter-add,
//     mean divide)
// the counterpart of the reference library's
// EmbeddingLookupVariableHotness (embedding_lookup_kernels.cu:175-249).
// For every (slot, row) it walks the row's value positions
// p in [start, min(splits[r + 1], cap)) (start = min(splits[r], cap),
// 0 for the first row, as the JAX marks/cumsum segment ids assign
// positions), clips each id into the slot's table, adds the slot's slab
// row offset, reads the slab row, multiplies it by the position's weight
// rounded to the slab dtype (and by 0 where the slot masks an
// out-of-range id), and adds the products in fp32, in position order.
// The sum rounds to the slab dtype (the dtype JAX sums in), a mean slot
// divides it by max(splits[r + 1] - splits[r], 1) rounded to the slab
// dtype (the CLAIMED length, even where capacity truncated the row), and
// the result is stored in the output dtype. Products and adds use
// __fmul_rn/__fadd_rn, so nvcc does not contract them into FMAs: for a
// float32 slab the result is the plain version's bit for bit.
//
// Bound: bytes. The slab rows the positions read (26.4M x 512 B at the
// ragged DLRM's shapes, most of them hot rows that the 50 MB L2 keeps)
// and the ids dominate; one add per element read. Design: a group of G
// lanes per output row, each lane 16 B of the row (4 fp32 or 8 bf16
// elements), so a 128-wide fp32 row is one full warp; positions are
// unrolled four at a time so four row reads are in flight per group.
// Row and element arithmetic is int64.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

struct alignas(16) U32B { uint4 lo, hi; };  // 32 B: bf16 in, fp32 out

template <int BYTES> struct Raw;
template <> struct Raw<32> { using T = U32B; };
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
  const void* slab;
  int64_t slab_rows;
  int width;
  const void* values;     // [n_slots, *] ids, row stride v_stride
  int64_t v_stride;
  const int64_t* splits;  // [n_slots, b + 1]
  const int64_t* rows;    // [n_slots] table rows per slot
  const int64_t* roff;    // [n_slots] first slab row per slot
  const int* mean;        // [n_slots] or null: 1 = divide by the length
  const int* mask;        // [n_slots] or null: 1 = out-of-range ids read 0
  const void* weights;    // [n_slots, *] f32 bits, row stride w_stride
  int64_t w_stride;
  int w_esize;            // 4: f32/int32 elements; 8: int64 (low half)
  void* out;              // [n_slots, b, width]
  int n_slots;
  int64_t b;
  int64_t cap;
  int group_log2;         // lanes per output row = 1 << group_log2
};

template <typename Tr, typename To, int VB, typename IdT>
__global__ void __launch_bounds__(256)
ragged_combine_kernel(const Args a) {
  using E = typename Tr::E;
  using RawT = typename Raw<VB>::T;
  constexpr int V = VB / static_cast<int>(sizeof(E));
  using OE = typename To::E;
  constexpr int OB = V * static_cast<int>(sizeof(OE));
  using RawO = typename Raw<OB>::T;
  const int G = 1 << a.group_log2;
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
  const int64_t nrows = a.rows[slot];
  const int64_t base = a.roff[slot];
  const bool masked = a.mask != nullptr && a.mask[slot] != 0;
  const bool is_mean = a.mean != nullptr && a.mean[slot] != 0;
  const int64_t len = s1 - s0;
  const float count = Tr::rnd(static_cast<float>(len > 1 ? len : 1));
  const E* slab = static_cast<const E*>(a.slab);
  const IdT* ids = static_cast<const IdT*>(a.values) +
                   static_cast<int64_t>(slot) * a.v_stride;
  const uint32_t* wb = static_cast<const uint32_t*>(a.weights);
  const int64_t wstep = a.w_esize / 4;  // uint32 words per weight
  const int64_t wbase = static_cast<int64_t>(slot) * a.w_stride * wstep;
  OE* out = static_cast<OE*>(a.out) + row * a.width;
  const int nv = a.width / V;

  for (int v = lane; v < nv; v += G) {
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    const int64_t col = static_cast<int64_t>(v) * V;
    int64_t p = start;
    // four positions at a time: four row reads in flight, added in order
    for (; p + 4 <= end; p += 4) {
      RawT raw[4];
      float f[4];
      bool zero[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int64_t id = static_cast<int64_t>(ids[p + u]);
        const int64_t loc = id < 0 ? 0 : (id >= nrows ? nrows - 1 : id);
        int64_t grow = loc + base;
        if (grow >= a.slab_rows) grow = a.slab_rows - 1;
        raw[u] = __ldg(reinterpret_cast<const RawT*>(
            slab + grow * a.width + col));
        f[u] = wb ? Tr::rnd(__uint_as_float(wb[wbase + (p + u) * wstep]))
                  : 1.f;
        zero[u] = masked && (id < 0 || id >= nrows);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        E x[V];
        memcpy(x, &raw[u], sizeof(raw[u]));
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float t = Tr::load(x[e]);
          if (wb) t = Tr::rnd(__fmul_rn(t, f[u]));
          if (zero[u]) t = __fmul_rn(t, 0.f);
          acc[e] = __fadd_rn(acc[e], t);
        }
      }
    }
    for (; p < end; ++p) {
      const int64_t id = static_cast<int64_t>(ids[p]);
      const int64_t loc = id < 0 ? 0 : (id >= nrows ? nrows - 1 : id);
      int64_t grow = loc + base;
      if (grow >= a.slab_rows) grow = a.slab_rows - 1;
      const RawT raw = __ldg(reinterpret_cast<const RawT*>(
          slab + grow * a.width + col));
      const float f =
          wb ? Tr::rnd(__uint_as_float(wb[wbase + p * wstep])) : 1.f;
      const bool zero = masked && (id < 0 || id >= nrows);
      E x[V];
      memcpy(x, &raw, sizeof(raw));
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float t = Tr::load(x[e]);
        if (wb) t = Tr::rnd(__fmul_rn(t, f));
        if (zero) t = __fmul_rn(t, 0.f);
        acc[e] = __fadd_rn(acc[e], t);
      }
    }
    OE o[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float t = Tr::rnd(acc[e]);
      if (is_mean) t = Tr::rnd(__fdiv_rn(t, count));
      o[e] = To::store(t);
    }
    RawO raw_out;
    memcpy(&raw_out, o, sizeof(raw_out));
    *reinterpret_cast<RawO*>(out + col) = raw_out;
  }
}

template <typename Tr, typename To, int VB>
cudaError_t launch(const Args& a, bool ids64, int64_t blocks,
                   cudaStream_t stream) {
  if (ids64) {
    ragged_combine_kernel<Tr, To, VB, int64_t>
        <<<static_cast<unsigned>(blocks), 256, 0, stream>>>(a);
  } else {
    ragged_combine_kernel<Tr, To, VB, int32_t>
        <<<static_cast<unsigned>(blocks), 256, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename Tr, typename To>
cudaError_t dispatch(int vb, const Args& a, bool ids64, int64_t blocks,
                     cudaStream_t stream) {
  switch (vb) {
    case 16: return launch<Tr, To, 16>(a, ids64, blocks, stream);
    case 8: return launch<Tr, To, 8>(a, ids64, blocks, stream);
    case 4: return launch<Tr, To, 4>(a, ids64, blocks, stream);
    case 2:
      if constexpr (sizeof(typename Tr::E) <= 2) {
        return launch<Tr, To, 2>(a, ids64, blocks, stream);
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

// dtype / out_dtype: 0 = float32, 1 = bfloat16. ids_is_64: values are
// int64 (else int32). w_esize: 0 = no weights, 4 = float32 (or int32
// bits), 8 = int64 elements whose low 32 bits are the float32 bits.
extern "C" int detpu_ragged_combine(
    const void* slab, int64_t slab_rows, int width, int dtype,
    const void* values, int ids_is_64, int64_t v_stride, const void* splits,
    const void* rows, const void* roff, const void* mean, const void* mask,
    const void* weights, int w_esize, int64_t w_stride, void* out,
    int out_dtype, int n_slots, int64_t b, int64_t cap, void* stream) {
  if (width <= 0 || slab_rows <= 0 || n_slots < 0 || b < 0 || cap < 0 ||
      (dtype != 0 && dtype != 1) || (out_dtype != 0 && out_dtype != 1) ||
      (weights != nullptr && w_esize != 4 && w_esize != 8)) {
    return cudaErrorInvalidValue;
  }
  const int64_t out_rows = static_cast<int64_t>(n_slots) * b;
  if (out_rows == 0) return cudaSuccess;
  const int esize = dtype == 0 ? 4 : 2;
  const int osize = out_dtype == 0 ? 4 : 2;
  // widest vector (16/8/4/2 B of slab) that divides a row and keeps the
  // slab and the output aligned
  int vb = 16;
  while (vb > esize) {
    const int ob = vb / esize * osize;
    if ((width * esize) % vb == 0 &&
        reinterpret_cast<uintptr_t>(slab) % vb == 0 &&
        reinterpret_cast<uintptr_t>(out) % ob == 0) {
      break;
    }
    vb /= 2;
  }
  const int nv = width * esize / vb;
  int group_log2 = 0;
  while ((1 << group_log2) < nv && group_log2 < 5) ++group_log2;
  Args a{slab, slab_rows, width, values, v_stride,
         static_cast<const int64_t*>(splits),
         static_cast<const int64_t*>(rows), static_cast<const int64_t*>(roff),
         static_cast<const int*>(mean), static_cast<const int*>(mask),
         weights, w_stride, weights ? w_esize : 4, out, n_slots, b, cap,
         group_log2};
  const int64_t threads = out_rows << group_log2;
  const int64_t blocks = (threads + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool i64 = ids_is_64 != 0;
  if (dtype == 0) {
    return out_dtype == 0 ? dispatch<F32, F32>(vb, a, i64, blocks, s)
                          : dispatch<F32, BF16>(vb, a, i64, blocks, s);
  }
  return out_dtype == 0 ? dispatch<BF16, F32>(vb, a, i64, blocks, s)
                        : dispatch<BF16, BF16>(vb, a, i64, blocks, s);
}
