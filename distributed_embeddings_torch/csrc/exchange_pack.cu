// K19 and K20: the exchange-block packing of the hybrid step, for Hopper
// (sm_90a).
//
// Replace the XLA-lowered layout copies of the JAX package's exchange
// (ROADMAP queue B4):
//   K19 (pack_ids_kernel):
//     distributed_embeddings_tpu/parallel/exchange.py:build_send_blocks
//     (through assemble_cells): the dp->mp id blocks [world, l_max], each
//     instance's ids at its (rank, group, slot) cell, multi-slot
//     instances slot-major, ragged values, lengths and weight bits, dead
//     cells zero;
//   K20 (pack_cols_kernel):
//     distributed_embeddings_tpu/parallel/exchange.py:pack_grad_blocks
//     and its inverse-collapse prologue (parallel/apply.py:134-169): the
//     output cotangents into the [world, b, s_max] column layout;
//     distributed_embeddings_tpu/parallel/lookup.py:plan_lookup: the
//     groups' [world, n, b, w] lookups into the [world, b, s_max] rows,
//     with the compute-dtype cast;
//     distributed_embeddings_tpu/parallel/dist_embedding.py:1085-1110:
//     the dp-side unpack of the received rows into one output per input,
//     the column slices of a sliced table concatenated in place and the
//     row slices of a row-sliced table SUMMED (`total = total + part` in
//     ascending slice order, in the output dtype);
//     distributed_embeddings_tpu/parallel/apply.py:147-149: a row-sliced
//     table's cotangent replicated to each of its slices (one copy a
//     slice, all reading the same source).
//
// Every one of them is a batch of 2-D strided copies, so one kernel
// serves each: a DESCRIPTOR per copy holds the source and destination
// addresses, their row strides, the rows and the columns (a null source
// zero-fills), all counted in the descriptor's copy UNIT, and the unit
// kind (`mode`): a raw 2/4/8/16-byte unit, or 1/2/4 elements cast
// float32 -> bfloat16 (round to nearest even, __float2bfloat16_rn) or
// bfloat16 -> float32 (exact). The host picks the widest unit that the
// addresses, strides and row length allow, so rows of 8 bf16 or more
// move as 16-byte loads and stores.
//
// A SUMMING descriptor (K20 only) adds k >= 2 source blocks of one dtype
// into its destination: part 0, then each later part added in order, in
// float32 and rounded to the dtype after each add (__fadd_rn, then
// __float2bfloat16_rn for bfloat16), so it is bit-exact to the same
// chain of PyTorch adds. Its k source addresses follow the launch's
// descriptors in the parameter block (address rows, 8 a row); its `src`
// holds the index of its first address there and its mode the unit kind
// and k. The parts share one row stride (rows of one received block).
//
// The descriptors travel BY VALUE, as a __grid_constant__ kernel
// parameter (Hopper takes up to 32,764 bytes of parameters, CUDA >=
// 12.1): no host-to-device copy a step. A launch holds at most
// kMaxDescs; the host splits a longer list into several launches.
//
// Bound: bytes. Each element is read once and written once; there is no
// arithmetic beyond the cast. At the world-8 Criteo-1TB rank shapes K20
// moves 105-117 MB a call (31-35 us at 3.35 TB/s) and K19 2.4 MB (0.7
// us: bound by its launch and the host's descriptor work, which the
// wrapper caches per tensor addresses). A sum of k parts reads k blocks
// and writes one.
// Design: the grid is a flat list of TILES, each 1,024 units of one
// descriptor (256 threads x 4 units, each thread's units 256 apart so a
// warp's accesses are contiguous); a block finds its descriptor by a
// binary search over the descriptors' first tiles. A descriptor's
// unit index splits into (row, column) by one division (32-bit when the
// descriptor's units fit). Both kernels are copies, so they are
// bit-exact to their plain versions.
//
// C interface (ctypes): the descriptors as a host pointer to int64
// [n, 8] (src, dst, src_stride, dst_stride, rows, cols, tile0, mode)
// followed, for K20, by its address rows, the stream as void*; returns
// the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kTileUnits = kThreads * kUnroll;
constexpr int kMaxDescs = 504;  // 16 + 504 * 64 bytes <= 32,764

struct Desc {
  int64_t src;         // address of the source's first unit; 0: zero fill
  int64_t dst;         // address of the destination's first unit
  int64_t src_stride;  // units between source rows
  int64_t dst_stride;  // units between destination rows
  int64_t rows;
  int64_t cols;        // units a row
  int64_t tile0;       // the descriptor's first tile in the launch
  int64_t mode;        // unit kind, see `run_desc`; a sum's k above bit 8
};
static_assert(sizeof(Desc) == 64, "Desc is 8 int64 fields");

// n descriptors, then n_rows address rows (8 int64 addresses a row, read
// by summing descriptors) in the same array.
template <int CAP>
struct Params {
  int64_t n;
  int64_t n_rows;
  Desc d[CAP];
};
static_assert(sizeof(Params<kMaxDescs>) <= 32764,
              "kernel parameters must fit Hopper's 32,764 bytes");

// ---- unit conversions -------------------------------------------------

template <typename S, typename D>
struct Conv;

template <typename T>
struct Conv<T, T> {
  __device__ static T cvt(const T& v) { return v; }
};

__device__ __forceinline__ uint16_t bf(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}
__device__ __forceinline__ float fb(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

struct Bf16x2 { uint32_t v; };
struct Bf16x4 { uint2 v; };
struct Bf16x1 { uint16_t v; };

template <>
struct Conv<float, Bf16x1> {
  __device__ static Bf16x1 cvt(float a) { return {bf(a)}; }
};
template <>
struct Conv<float2, Bf16x2> {
  __device__ static Bf16x2 cvt(float2 a) {
    return {static_cast<uint32_t>(bf(a.x)) |
            (static_cast<uint32_t>(bf(a.y)) << 16)};
  }
};
template <>
struct Conv<float4, Bf16x4> {
  __device__ static Bf16x4 cvt(float4 a) {
    return {make_uint2(static_cast<uint32_t>(bf(a.x)) |
                           (static_cast<uint32_t>(bf(a.y)) << 16),
                       static_cast<uint32_t>(bf(a.z)) |
                           (static_cast<uint32_t>(bf(a.w)) << 16))};
  }
};
template <>
struct Conv<Bf16x1, float> {
  __device__ static float cvt(Bf16x1 a) { return fb(a.v); }
};
template <>
struct Conv<Bf16x2, float2> {
  __device__ static float2 cvt(Bf16x2 a) {
    return make_float2(fb(a.v & 0xffffu), fb(a.v >> 16));
  }
};
template <>
struct Conv<Bf16x4, float4> {
  __device__ static float4 cvt(Bf16x4 a) {
    return make_float4(fb(a.v.x & 0xffffu), fb(a.v.x >> 16),
                       fb(a.v.y & 0xffffu), fb(a.v.y >> 16));
  }
};

// One tile of one descriptor: units [base, base + kTileUnits).
template <typename S, typename D, typename I>
__device__ __forceinline__ void copy_tile(const Desc& d, int64_t base) {
  const S* __restrict__ src = reinterpret_cast<const S*>(d.src);
  D* __restrict__ dst = reinterpret_cast<D*>(d.dst);
  const I total = static_cast<I>(d.rows * d.cols);
  const I cols = static_cast<I>(d.cols);
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const I u = static_cast<I>(base) + static_cast<I>(k * kThreads +
                                                      threadIdx.x);
    if (u >= total) break;
    const I r = u / cols;
    const I c = u - r * cols;
    const D v = src != nullptr
        ? Conv<S, D>::cvt(src[static_cast<int64_t>(r) * d.src_stride + c])
        : D{};
    dst[static_cast<int64_t>(r) * d.dst_stride + c] = v;
  }
}

template <typename S, typename D>
__device__ __forceinline__ void copy_desc(const Desc& d, int64_t base) {
  if (d.rows * d.cols <= 0xffffffffLL) {
    copy_tile<S, D, uint32_t>(d, base);
  } else {
    copy_tile<S, D, int64_t>(d, base);
  }
}

// modes: 0-3 raw units of 2, 4, 8, 16 bytes; 4-6 float32 -> bfloat16 in
// units of 1, 2, 4 elements; 7-9 bfloat16 -> float32 in units of 1, 2, 4.
// ---- sums ---------------------------------------------------------------

struct SumF32 {
  using E = float;
  __device__ static float load(E v) { return v; }
  __device__ static float rnd(float f) { return f; }
  __device__ static E store(float f) { return f; }
};

struct SumBF16 {
  using E = uint16_t;  // raw bf16 bits
  __device__ static float load(E v) { return fb(v); }
  __device__ static float rnd(float f) {
    return __bfloat162float(__float2bfloat16_rn(f));
  }
  __device__ static E store(float f) { return bf(f); }
};

template <typename E, int P>
struct alignas(sizeof(E) * P) Vec {
  E v[P];
};

// One tile of a summing descriptor: each unit of P elements is part 0's,
// plus each later part's in order, rounded to the dtype after each add.
template <typename Op, int P, typename I>
__device__ __forceinline__ void sum_tile(const Desc& d, const int64_t* addr,
                                         int k, int64_t base) {
  using E = typename Op::E;
  using U = Vec<E, P>;
  U* __restrict__ dst = reinterpret_cast<U*>(d.dst);
  const I total = static_cast<I>(d.rows * d.cols);
  const I cols = static_cast<I>(d.cols);
#pragma unroll
  for (int kk = 0; kk < kUnroll; ++kk) {
    const I u = static_cast<I>(base) + static_cast<I>(kk * kThreads +
                                                      threadIdx.x);
    if (u >= total) break;
    const I r = u / cols;
    const I c = u - r * cols;
    const int64_t off = static_cast<int64_t>(r) * d.src_stride + c;
    const U x0 = reinterpret_cast<const U*>(addr[0])[off];
    float acc[P];
#pragma unroll
    for (int e = 0; e < P; ++e) acc[e] = Op::load(x0.v[e]);
    for (int j = 1; j < k; ++j) {
      const U x = reinterpret_cast<const U*>(addr[j])[off];
#pragma unroll
      for (int e = 0; e < P; ++e) {
        acc[e] = Op::rnd(__fadd_rn(acc[e], Op::load(x.v[e])));
      }
    }
    U out;
#pragma unroll
    for (int e = 0; e < P; ++e) out.v[e] = Op::store(acc[e]);
    dst[static_cast<int64_t>(r) * d.dst_stride + c] = out;
  }
}

template <typename Op, int P>
__device__ __forceinline__ void sum_desc(const Desc& d, const int64_t* addr,
                                         int k, int64_t base) {
  if (d.rows * d.cols <= 0xffffffffLL) {
    sum_tile<Op, P, uint32_t>(d, addr, k, base);
  } else {
    sum_tile<Op, P, int64_t>(d, addr, k, base);
  }
}

// modes 10-12: float32 sums in units of 1, 2, 4 elements; 13-15:
// bfloat16 sums in units of 1, 2, 4 elements; k parts in bits 8 and up.
constexpr int64_t kSumBase = 10;

__device__ __forceinline__ void run_sum(const Desc& d, const int64_t* addrs,
                                        int64_t base) {
  const int k = static_cast<int>(d.mode >> 8);
  const int64_t* addr = addrs + d.src;
  switch (d.mode & 0xff) {
    case 10: sum_desc<SumF32, 1>(d, addr, k, base); return;
    case 11: sum_desc<SumF32, 2>(d, addr, k, base); return;
    case 12: sum_desc<SumF32, 4>(d, addr, k, base); return;
    case 13: sum_desc<SumBF16, 1>(d, addr, k, base); return;
    case 14: sum_desc<SumBF16, 2>(d, addr, k, base); return;
    case 15: sum_desc<SumBF16, 4>(d, addr, k, base); return;
    default: return;
  }
}

template <bool kCast>
__device__ __forceinline__ void run_desc(const Desc& d, int64_t base) {
  switch (d.mode) {
    case 0: copy_desc<uint16_t, uint16_t>(d, base); return;
    case 1: copy_desc<uint32_t, uint32_t>(d, base); return;
    case 2: copy_desc<uint2, uint2>(d, base); return;
    case 3: copy_desc<uint4, uint4>(d, base); return;
    default: break;
  }
  if constexpr (kCast) {
    switch (d.mode) {
      case 4: copy_desc<float, Bf16x1>(d, base); return;
      case 5: copy_desc<float2, Bf16x2>(d, base); return;
      case 6: copy_desc<float4, Bf16x4>(d, base); return;
      case 7: copy_desc<Bf16x1, float>(d, base); return;
      case 8: copy_desc<Bf16x2, float2>(d, base); return;
      case 9: copy_desc<Bf16x4, float4>(d, base); return;
      default: break;
    }
  }
}

template <int CAP, bool kCast>
__device__ __forceinline__ void pack_body(const Params<CAP>& p) {
  const int64_t tile = blockIdx.x;
  // the last descriptor whose first tile is at or before this one (the
  // host drops descriptors without units, so tile0 increases strictly)
  int lo = 0;
  int hi = static_cast<int>(p.n) - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.d[mid].tile0 <= tile) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Desc& d = p.d[lo];
  const int64_t base = (tile - d.tile0) * kTileUnits;
  if (kCast && d.mode >= kSumBase) {
    run_sum(d, reinterpret_cast<const int64_t*>(p.d + p.n), base);
  } else {
    run_desc<kCast>(d, base);
  }
}

// K19: the id blocks (raw integer units).
template <int CAP>
__global__ void __launch_bounds__(kThreads)
    pack_ids_kernel(const __grid_constant__ Params<CAP> p) {
  pack_body<CAP, false>(p);
}

// K20: the float column blocks (raw units and the two casts).
template <int CAP>
__global__ void __launch_bounds__(kThreads)
    pack_cols_kernel(const __grid_constant__ Params<CAP> p) {
  pack_body<CAP, true>(p);
}

template <int CAP>
cudaError_t launch_cap(bool cast, const int64_t* descs, int n, int n_rows,
                       int64_t n_tiles, cudaStream_t stream) {
  Params<CAP> p;
  p.n = n;
  p.n_rows = n_rows;
  memcpy(p.d, descs, sizeof(Desc) * static_cast<size_t>(n + n_rows));
  if (cast) {
    pack_cols_kernel<CAP><<<static_cast<unsigned>(n_tiles), kThreads, 0,
                            stream>>>(p);
  } else {
    pack_ids_kernel<CAP><<<static_cast<unsigned>(n_tiles), kThreads, 0,
                           stream>>>(p);
  }
  return cudaGetLastError();
}

cudaError_t launch(bool cast, const int64_t* descs, int n, int n_rows,
                   int64_t n_tiles, void* stream) {
  if (n <= 0 || n_rows < 0 || n + n_rows > kMaxDescs || n_tiles <= 0 ||
      n_tiles > 0x7fffffffLL || (!cast && n_rows != 0)) {
    return cudaErrorInvalidValue;
  }
  const int64_t* addrs = descs + 8 * static_cast<int64_t>(n);
  const int64_t n_addrs = 8 * static_cast<int64_t>(n_rows);
  const int64_t max_mode = cast ? 9 : 3;
  for (int i = 0; i < n; ++i) {
    const int64_t* d = descs + 8 * static_cast<int64_t>(i);
    if (d[1] == 0 || d[4] <= 0 || d[5] <= 0 || d[7] < 0 || d[6] < 0 ||
        d[6] >= n_tiles ||
        (i > 0 && d[6] <= descs[8 * static_cast<int64_t>(i - 1) + 6])) {
      return cudaErrorInvalidValue;
    }
    if (d[7] <= max_mode) continue;
    // a sum: its kind, k >= 2 parts, and k non-null addresses in range
    const int64_t kind = d[7] & 0xff, k = d[7] >> 8;
    if (!cast || kind < kSumBase || kind > kSumBase + 5 || k < 2 ||
        d[0] < 0 || d[0] + k > n_addrs) {
      return cudaErrorInvalidValue;
    }
    for (int64_t j = 0; j < k; ++j) {
      if (addrs[d[0] + j] == 0) return cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the smallest parameter block that holds the descriptors and rows
  const int used = n + n_rows;
  if (used <= 8) return launch_cap<8>(cast, descs, n, n_rows, n_tiles, s);
  if (used <= 32) return launch_cap<32>(cast, descs, n, n_rows, n_tiles, s);
  if (used <= 128) {
    return launch_cap<128>(cast, descs, n, n_rows, n_tiles, s);
  }
  return launch_cap<kMaxDescs>(cast, descs, n, n_rows, n_tiles, s);
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most descriptors (and, for K20, address rows) one launch takes.
extern "C" int detpu_pack_max_descs() { return kMaxDescs; }

// The units one tile covers.
extern "C" int detpu_pack_tile_units() {
  return static_cast<int>(kTileUnits);
}

// K19: descs int64 [n, 8] on the host, raw modes (0-3) only.
extern "C" int detpu_pack_ids(const int64_t* descs, int n, int64_t n_tiles,
                              void* stream) {
  return static_cast<int>(launch(false, descs, n, 0, n_tiles, stream));
}

// K20: descs int64 [n + n_rows, 8] on the host: n descriptors of raw,
// cast (0-9) and sum (10-15, k << 8) modes, then n_rows address rows.
extern "C" int detpu_pack_cols(const int64_t* descs, int n, int n_rows,
                               int64_t n_tiles, void* stream) {
  return static_cast<int>(launch(true, descs, n, n_rows, n_tiles, stream));
}
