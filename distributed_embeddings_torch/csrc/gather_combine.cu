// K1: row gather with its hotness combine, for Hopper (sm_90a).
//
// Replaces the XLA-lowered gather of the JAX package:
//   distributed_embeddings_tpu/parallel/lookup.py:lookup_group, kind "d"
//     (row-sliced slots included, :167-184)
//   distributed_embeddings_tpu/ops/packed_slab.py:packed_gather
//   distributed_embeddings_tpu/ops/embedding_lookup.py:embedding_lookup
//     (dense branch)
// For every (slot, sample) output row it subtracts the slot's row base
// from each of the row's `hot` ids where the launch has bases (a
// row-sliced table's slot holds the rows [rbase, rbase + rows) of its
// table; a template flag, so the launch without bases keeps the
// instruction stream it had), clips the id into [0, rows-1], adds the
// slot's slab row offset, reads the slab row, optionally scales it by a
// per-id weight and zeroes it where the slot masks ids outside [0, rows)
// (a multiply by 0, not a select: a NaN row stays NaN), sums over `hot`
// in fp32 as a chain of fmaf(f, x, acc) over h = 0..hot-1, divides by the
// slot's divisor (hot for mean slots), and stores once in the slab's
// dtype.
//
// Bound: bytes. The distinct rows read (Zipfian: many hit L2) and the
// output written dominate (26 x 65536 x 256 B = 436 MB at the DLRM
// training batch, 0.153 ms with its distinct rows at 3.35 TB/s); the
// arithmetic is one fma per element read. What held the first design to
// 44% of that bound is memory-level parallelism: one output row in flight
// per lane group, its single row load issued only after its id load
// returned, plus a 64-bit divide and four metadata loads a thread.
// Design:
//   * a two-dimensional grid, blockIdx.y the slot (a grid-stride loop past
//     65,535 slots) and blockIdx.x a tile of samples: a block reads its
//     slot's rows, offset, divisor and mask flag once, into registers;
//   * a group of G lanes per output row, each lane moving 16 B per load
//     where the row and the slab allow (8 bf16; 8/4/2 B otherwise), so a
//     128-wide bf16 row is one 16-lane load round;
//   * R = 2 output rows a group: for each h the group loads its R ids,
//     then issues both row loads, then combines, so two independent row
//     loads are in flight a lane rather than one behind an id load. A
//     warp's groups take neighbouring samples, so its stores stay
//     contiguous. Blocks of 128 threads. k1_variants.py times the
//     alternatives in turns at the DLRM training batch (b=65536, hot 1 /
//     hot 3 mean; NVIDIA H100 80GB HBM3, 700 W): R = 2 0.277 / 0.427 ms,
//     R = 1 0.291 / 0.454, R = 3 0.289 / 0.443, R = 2 with 256 threads
//     0.285 / 0.435, R = 4 with 256 threads 0.361 / 0.559 (its registers
//     cut the blocks an SM), the first design 0.359 / 0.480. Streaming
//     output stores (st.global.cs, 0.279 / 0.436) measured no gain and
//     were left out.
//   * rows are read through the non-coherent path (__ldg).
// The per-element arithmetic (fmaf chain, then acc / div, one rounding) is
// the first design's, so the output is bit-exact to it.
// Row arithmetic is int64 throughout: 187.8M rows x 128 elements is
// 2.4e10 elements, far past int32.
//
// C interface (ctypes): detpu_gather_combine_prepare validates one call's
// fixed arguments and writes a prepared launch
// (detpu_gather_combine_prepared_bytes() bytes of host memory the caller
// owns); detpu_gather_combine_launch takes it with the per-call ids,
// weights and output and the stream. Both return a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

template <int BYTES> struct Raw;
template <> struct Raw<16> { using T = uint4; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<4> { using T = unsigned int; };
template <> struct Raw<2> { using T = unsigned short; };

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

constexpr int kThreads = 128;
constexpr int kRows = 2;  // output rows a lane group

struct Args {
  const void* slab;
  int64_t slab_rows;
  int width;
  const void* ids;      // [n_slots, b, hot]
  const int64_t* rows;  // [n_slots] table rows per slot
  const int64_t* roff;  // [n_slots] first slab row per slot
  const float* div;     // [n_slots] divisor per slot
  const int* mask;      // [n_slots] or null: 1 = out-of-range ids read 0
  const int64_t* rbase; // [n_slots] row base per slot (read when RB)
  const float* weights; // [n_slots, b, hot] or null
  void* out;            // [n_slots, b, width]
  int n_slots;
  int64_t b;
  int hot;
  int group_log2;       // lanes per output row = 1 << group_log2
};

template <typename Tr, int VB, typename IdT, bool RB>
__global__ void __launch_bounds__(kThreads)
gather_combine_kernel(const Args a) {
  constexpr int R = kRows;
  using E = typename Tr::E;
  using RawT = typename Raw<VB>::T;
  constexpr int V = VB / static_cast<int>(sizeof(E));
  const int G = 1 << a.group_log2;
  const int lane = threadIdx.x & (G - 1);
  const int group = threadIdx.x >> a.group_log2;
  const int gpb = kThreads >> a.group_log2;  // lane groups a block
  const int nv = a.width / V;
  const E* slab = static_cast<const E*>(a.slab);
  const IdT* ids = static_cast<const IdT*>(a.ids);
  // the samples of this group: s0 + r * gpb, r < R
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * gpb * R + group;
  for (int slot = blockIdx.y; slot < a.n_slots; slot += gridDim.y) {
    const int64_t nrows = a.rows[slot];
    const int64_t base = a.roff[slot];
    const bool masked = a.mask != nullptr && a.mask[slot] != 0;
    const float d = a.div[slot];
    const int64_t rb = RB ? a.rbase[slot] : 0;
    const int64_t row0 = static_cast<int64_t>(slot) * a.b;
    bool live[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      live[r] = s0 + static_cast<int64_t>(r) * gpb < a.b;
    }
    for (int v = lane; v < nv; v += G) {
      float acc[R][V];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
      }
      for (int h = 0; h < a.hot; ++h) {
        int64_t q[R];
        int64_t id[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          q[r] = (row0 + s0 + static_cast<int64_t>(r) * gpb) * a.hot + h;
          id[r] = live[r] ? static_cast<int64_t>(ids[q[r]]) : 0;
          if constexpr (RB) id[r] -= rb;  // the slot's range-local id
        }
        RawT raw[R];
        float f[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int64_t loc =
              id[r] < 0 ? 0 : (id[r] >= nrows ? nrows - 1 : id[r]);
          int64_t grow = loc + base;
          if (grow >= a.slab_rows) grow = a.slab_rows - 1;  // clip to the slab
          float ff = (a.weights && live[r]) ? a.weights[q[r]] : 1.f;
          // the JAX lookup multiplies by the 0/1 in-range mask (not a select)
          if (masked && (id[r] < 0 || id[r] >= nrows)) ff *= 0.f;
          f[r] = ff;
          if (live[r]) {
            raw[r] = __ldg(reinterpret_cast<const RawT*>(
                slab + grow * a.width + static_cast<int64_t>(v) * V));
          } else {
            raw[r] = RawT{};
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          E e_in[V];
          memcpy(e_in, &raw[r], sizeof(RawT));
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc[r][e] = fmaf(f[r], Tr::load(e_in[e]), acc[r][e]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!live[r]) continue;
        E e_out[V];
#pragma unroll
        for (int e = 0; e < V; ++e) e_out[e] = Tr::store(acc[r][e] / d);
        RawT raw_out;
        memcpy(&raw_out, e_out, sizeof(raw_out));
        E* out = static_cast<E*>(a.out) +
                 (row0 + s0 + static_cast<int64_t>(r) * gpb) * a.width +
                 static_cast<int64_t>(v) * V;
        *reinterpret_cast<RawT*>(out) = raw_out;
      }
    }
  }
}

struct Prepared {
  Args a;
  int vb;          // bytes a lane moves per load
  int ids64;       // ids are int64
  int dtype;       // 0 = float32, 1 = bfloat16
  int weighted;    // the launch reads per-id weights
  int based;       // the launch subtracts per-slot row bases
  unsigned grid_x;
  unsigned grid_y;
};

template <typename Tr, int VB, bool RB>
cudaError_t launch_based(const Prepared& p, const Args& a, cudaStream_t st) {
  const dim3 grid(p.grid_x, p.grid_y);
  if (p.ids64) {
    gather_combine_kernel<Tr, VB, int64_t, RB><<<grid, kThreads, 0, st>>>(a);
  } else {
    gather_combine_kernel<Tr, VB, int32_t, RB><<<grid, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

template <typename Tr, int VB>
cudaError_t launch_ids(const Prepared& p, const Args& a, cudaStream_t st) {
  return p.based ? launch_based<Tr, VB, true>(p, a, st)
                 : launch_based<Tr, VB, false>(p, a, st);
}

template <typename Tr>
cudaError_t dispatch(const Prepared& p, const Args& a, cudaStream_t st) {
  switch (p.vb) {
    case 16: return launch_ids<Tr, 16>(p, a, st);
    case 8: return launch_ids<Tr, 8>(p, a, st);
    case 4: return launch_ids<Tr, 4>(p, a, st);
    case 2:
      if constexpr (sizeof(typename Tr::E) <= 2) {
        return launch_ids<Tr, 2>(p, a, st);
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

extern "C" int64_t detpu_gather_combine_prepared_bytes() {
  return static_cast<int64_t>(sizeof(Prepared));
}

// Validate one K1 call's fixed arguments and write its prepared launch to
// `out`: the slab [slab_rows, width] (dtype 0 = float32, 1 = bfloat16),
// ids of n_slots x b x hot (int64 when ids_is_64, else int32), the
// per-slot rows, roff, div, mask (null: none) and row bases (int64,
// null: none), whether the launch reads weights, and vb, the bytes a
// lane loads: 16, 8, 4 or 2, at least the element size, dividing a row's
// bytes and the slab's address (the output the launch gets must be
// vb-aligned too).
extern "C" int detpu_gather_combine_prepare(
    const void* slab, int64_t slab_rows, int width, int ids_is_64,
    const void* rows, const void* roff, const void* div, const void* mask,
    const void* rbase, int weighted, int n_slots, int64_t b, int hot,
    int dtype, int vb, void* out) {
  const int esize = dtype == 0 ? 4 : 2;
  if (width <= 0 || hot <= 0 || slab_rows <= 0 || n_slots < 0 || b < 0 ||
      (dtype != 0 && dtype != 1) ||
      (vb != 16 && vb != 8 && vb != 4 && vb != 2) || vb < esize ||
      (static_cast<int64_t>(width) * esize) % vb != 0 ||
      reinterpret_cast<uintptr_t>(slab) % vb != 0) {
    return cudaErrorInvalidValue;
  }
  const int nv = width * esize / vb;
  int group_log2 = 0;
  while ((1 << group_log2) < nv && group_log2 < 5) ++group_log2;
  const int64_t gpb = kThreads >> group_log2;
  const int gy = n_slots < 65535 ? n_slots : 65535;
  const int64_t gx = (b + gpb * kRows - 1) / (gpb * kRows);
  if (gx > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  Prepared* p = static_cast<Prepared*>(out);
  memset(p, 0, sizeof(Prepared));
  p->a = Args{slab, slab_rows, width, nullptr,
              static_cast<const int64_t*>(rows),
              static_cast<const int64_t*>(roff),
              static_cast<const float*>(div), static_cast<const int*>(mask),
              static_cast<const int64_t*>(rbase), nullptr, nullptr, n_slots,
              b, hot, group_log2};
  p->vb = vb;
  p->ids64 = ids_is_64 != 0;
  p->dtype = dtype;
  p->weighted = weighted != 0;
  p->based = rbase != nullptr;
  p->grid_x = static_cast<unsigned>(gx);
  p->grid_y = static_cast<unsigned>(gy);
  return cudaSuccess;
}

// Launch a prepared K1 on `stream` with this call's ids, weights (null
// unless the launch was prepared weighted) and output [n_slots, b, width].
extern "C" int detpu_gather_combine_launch(const void* prepared,
                                           const void* ids,
                                           const void* weights, void* out,
                                           void* stream) {
  const Prepared* p = static_cast<const Prepared*>(prepared);
  if (p == nullptr || ids == nullptr || out == nullptr ||
      (p->weighted != 0) != (weights != nullptr) ||
      reinterpret_cast<uintptr_t>(out) % p->vb != 0) {
    return cudaErrorInvalidValue;
  }
  if (p->grid_x == 0 || p->grid_y == 0) return cudaSuccess;  // n * b == 0
  Args a = p->a;
  a.ids = ids;
  a.weights = static_cast<const float*>(weights);
  a.out = out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p->dtype == 0 ? dispatch<F32>(*p, a, st) : dispatch<BF16>(*p, a, st);
}
