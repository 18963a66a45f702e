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
//     the column slices of a sliced table concatenated in place.
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
// The descriptors travel BY VALUE, as a __grid_constant__ kernel
// parameter (Hopper takes up to 32,764 bytes of parameters, CUDA >=
// 12.1): no host-to-device copy a step. A launch holds at most
// kMaxDescs; the host splits a longer list into several launches.
//
// Bound: bytes. Each element is read once and written once; there is no
// arithmetic beyond the cast. At the world-8 Criteo-1TB rank shapes K20
// moves 105-117 MB a call (31-35 us at 3.35 TB/s) and K19 2.4 MB (0.7
// us: bound by its launch and the host's descriptor work, which the
// wrapper caches per tensor addresses).
// Design: the grid is a flat list of TILES, each 1,024 units of one
// descriptor (256 threads x 4 units, each thread's units 256 apart so a
// warp's accesses are contiguous); a block finds its descriptor by a
// binary search over the descriptors' first tiles. A descriptor's
// unit index splits into (row, column) by one division (32-bit when the
// descriptor's units fit). Both kernels are copies, so they are
// bit-exact to their plain versions.
//
// C interface (ctypes): the descriptors as a host pointer to int64
// [n, 8] (src, dst, src_stride, dst_stride, rows, cols, tile0, mode),
// the stream as void*; returns the cudaError_t of the launch.

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
  int64_t mode;        // unit kind, see `copy_desc`
};
static_assert(sizeof(Desc) == 64, "Desc is 8 int64 fields");

template <int CAP>
struct Params {
  int64_t n;
  int64_t pad;
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
  run_desc<kCast>(d, (tile - d.tile0) * kTileUnits);
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
cudaError_t launch_cap(bool cast, const int64_t* descs, int n,
                       int64_t n_tiles, cudaStream_t stream) {
  Params<CAP> p;
  p.n = n;
  p.pad = 0;
  memcpy(p.d, descs, sizeof(Desc) * static_cast<size_t>(n));
  if (cast) {
    pack_cols_kernel<CAP><<<static_cast<unsigned>(n_tiles), kThreads, 0,
                            stream>>>(p);
  } else {
    pack_ids_kernel<CAP><<<static_cast<unsigned>(n_tiles), kThreads, 0,
                           stream>>>(p);
  }
  return cudaGetLastError();
}

cudaError_t launch(bool cast, const int64_t* descs, int n, int64_t n_tiles,
                   void* stream) {
  if (n <= 0 || n > kMaxDescs || n_tiles <= 0 || n_tiles > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const int64_t max_mode = cast ? 9 : 3;
  for (int i = 0; i < n; ++i) {
    const int64_t* d = descs + 8 * static_cast<int64_t>(i);
    if (d[1] == 0 || d[4] <= 0 || d[5] <= 0 || d[7] < 0 ||
        d[7] > max_mode || d[6] < 0 || d[6] >= n_tiles ||
        (i > 0 && d[6] <= descs[8 * static_cast<int64_t>(i - 1) + 6])) {
      return cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the smallest parameter block that holds the descriptors
  if (n <= 8) return launch_cap<8>(cast, descs, n, n_tiles, s);
  if (n <= 32) return launch_cap<32>(cast, descs, n, n_tiles, s);
  if (n <= 128) return launch_cap<128>(cast, descs, n, n_tiles, s);
  return launch_cap<kMaxDescs>(cast, descs, n, n_tiles, s);
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most descriptors one launch takes.
extern "C" int detpu_pack_max_descs() { return kMaxDescs; }

// The units one tile covers.
extern "C" int detpu_pack_tile_units() {
  return static_cast<int>(kTileUnits);
}

// K19: descs int64 [n, 8] on the host, raw modes (0-3) only.
extern "C" int detpu_pack_ids(const int64_t* descs, int n, int64_t n_tiles,
                              void* stream) {
  return static_cast<int>(launch(false, descs, n, n_tiles, stream));
}

// K20: descs int64 [n, 8] on the host, raw and cast modes (0-9).
extern "C" int detpu_pack_cols(const int64_t* descs, int n, int64_t n_tiles,
                               void* stream) {
  return static_cast<int>(launch(true, descs, n, n_tiles, stream));
}
