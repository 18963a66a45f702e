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
// Bound: bytes. Each position reads one slab row, in position order (the
// adds must stay in that order to be bit-exact), so at the ragged DLRM's
// shapes (26.4M positions x 512 B) the row reads are 13.5 GB a call,
// while the distinct rows are 0.7 GB. Read through the L1 they run at
// 6.5 TB/s on an NVIDIA H100 80GB HBM3 at 700 W, 7.5 with every row
// L2-resident (PERF.md).
//
// Design: persistent CTAs walk tiles of kTile samples of one slot (the
// slot's tiles in order, so neighbouring CTAs read one table). A tile
// whose rows' positions follow one another (a CSR batch's always do)
// takes the flat form, in passes of as many whole rows as the source
// words hold (max_pos positions: the call's capacity a sample over a
// tile and a quarter more, within the CTA's share of the SM; one pass a
// tile at the ragged step's shapes):
// 1. Source words. One pass reads the rows' ids, kCountUnroll of a
//    thread's at once (coalesced), and writes each position's source word
//    into shared memory: its clipped global row, and a flag for a masked
//    bad id.
// 2. Combine. A lane group takes a row at a time, each lane 16 B of the
//    row (4 fp32 or 8 bf16 elements; a 128-wide fp32 row is one warp),
//    and walks its positions in order, kUnroll reads in flight, reading
//    each position's source word from shared memory in place of its id.
// The first design (a lane group a row over a grid of every row, the id
// read before each row read) ran 2.49-2.54 ms at the ragged step's
// shapes on that card; this form 2.02-2.09 (PERF.md): the ids' latency
// leaves the chain of dependent reads each row waits on. Serving each
// tile's most-hit rows from shared memory as well (a hash count, a pick
// of the up-to-S hottest rows, TMA bulk copies) took 71-80% of the
// reads off the L2 and ran slower (3.0-3.5 ms): the walk is bound by its
// chain of dependent reads, not by the L2's bytes (k8_variants.py keeps
// that stage as a patched variant; PERF.md).
// Any other tile (rows that do not follow one another, a slab past 2^31
// rows, an empty table) and a row with more positions than the source
// words hold take the general form: a lane group a row, from its ids. A
// masked out-of-range id reads its clipped row (and multiplies it by 0),
// so a NaN or Inf there still propagates. Both forms add every
// position's value in the same order: they give the same bits. Row and
// element arithmetic is int64.
//
// C interface (ctypes): detpu_ragged_combine_prepare validates a call's
// fixed layout and writes its launch into host memory;
// detpu_ragged_combine_launch reads it and launches with the per-call
// pointers (values, splits, weights, out) and the stream. Each returns a
// cudaError_t.

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

constexpr int kMaxThreads = 1024;  // 64 registers a thread
constexpr int kCountUnroll = 4;    // ids a thread loads at once
constexpr int kUnroll = 4;         // reads a lane group has in flight
// the launch (k8_variants.py on an NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md): two CTAs of 512 threads a SM, tiles of 256 samples (2.0236
// ms at the ragged step's shapes; tiles of 512 2.0061, within the runs'
// spread, and slower on long rows; one CTA of 1024 threads 2.0992)
constexpr int kTile = 256;
constexpr int kThreads = 512;
constexpr int kCtas = 2;
// a source word: the slab row in the low 31 bits, a masked bad id's flag
constexpr uint32_t kRowMask = 0x7fffffffu;
constexpr uint32_t kZero = 0x80000000u;

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
  int64_t tiles_per_slot;
  int64_t tiles;
  int max_pos;            // source words a pass (0: the general form only)
  int rend_off;           // the tile's row ends' offset in shared memory
};

// The slab row a position reads: the id clipped into its table, plus the
// slot's offset, clipped to the slab.
__device__ __forceinline__ int64_t global_row(int64_t id, int64_t nrows,
                                              int64_t base,
                                              int64_t slab_rows) {
  const int64_t loc = id < 0 ? 0 : (id >= nrows ? nrows - 1 : id);
  const int64_t g = loc + base;
  return g >= slab_rows ? slab_rows - 1 : g;
}

// Row r's positions [start, end).
struct Span {
  int64_t start, end;
};

__device__ __forceinline__ Span span_of(const int64_t* sp, int64_t r,
                                        int64_t cap) {
  const int64_t s0 = sp[r], s1 = sp[r + 1];
  Span s;
  s.start = r == 0 ? 0 : (s0 < 0 ? 0 : (s0 > cap ? cap : s0));
  s.end = s1 < s.start ? s.start : (s1 > cap ? cap : s1);
  return s;
}

// One tile's slot: its splits, table, ids and options.
template <typename IdT>
struct Slot {
  int slot;
  const int64_t* sp;
  int64_t nrows, base, wbase;
  const IdT* ids;
  bool masked, is_mean;
};

// Row r's sum done: round it to the slab dtype, divide a mean slot's by
// the claimed length (rounded to the slab dtype), store it.
template <typename Tr, typename To, int V, typename IdT>
__device__ __forceinline__ void finish_row(const Args& a,
                                           const Slot<IdT>& s, int64_t r,
                                           int64_t col, const float* acc) {
  using OE = typename To::E;
  constexpr int OB = V * static_cast<int>(sizeof(OE));
  using RawO = typename Raw<OB>::T;
  float count = 1.f;
  if (s.is_mean) {
    const int64_t len = s.sp[r + 1] - s.sp[r];
    count = Tr::rnd(static_cast<float>(len > 1 ? len : 1));
  }
  OE o[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float y = Tr::rnd(acc[e]);
    if (s.is_mean) y = Tr::rnd(__fdiv_rn(y, count));
    o[e] = To::store(y);
  }
  RawO raw;
  memcpy(&raw, o, sizeof(raw));
  *reinterpret_cast<RawO*>(static_cast<OE*>(a.out) +
                           (static_cast<int64_t>(s.slot) * a.b + r) *
                               a.width + col) = raw;
}

// acc += one position's row (times its weight rounded to the slab dtype,
// times 0 for a masked bad id), in the plain version's order.
template <typename Tr, int V, typename RawT>
__device__ __forceinline__ void add_row(float* acc, const RawT& raw,
                                        bool weighted, float f, bool zero) {
  typename Tr::E x[V];
  memcpy(x, &raw, sizeof(raw));
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float y = Tr::load(x[e]);
    if (weighted) y = Tr::rnd(__fmul_rn(y, f));
    if (zero) y = __fmul_rn(y, 0.f);
    acc[e] = __fadd_rn(acc[e], y);
  }
}

// The row a source word names, at column col.
template <typename RawT, typename E>
__device__ __forceinline__ RawT word_row(const Args& a, const E* slab,
                                         uint32_t w, int64_t col) {
  return __ldg(reinterpret_cast<const RawT*>(
      slab + static_cast<int64_t>(w & kRowMask) * a.width + col));
}

// The general form: rows [r_begin, r_end) of the slot, a lane group a
// row, each position's row read from its id.
template <typename Tr, typename To, int VB, typename IdT>
__device__ void general_rows(const Args& a, const Slot<IdT>& s,
                             int64_t r_begin, int64_t r_end, int gi,
                             int groups, int lane_g, int G) {
  using E = typename Tr::E;
  using RawT = typename Raw<VB>::T;
  constexpr int V = VB / static_cast<int>(sizeof(E));
  const E* slab = static_cast<const E*>(a.slab);
  const uint32_t* wb = static_cast<const uint32_t*>(a.weights);
  const int64_t wstep = a.w_esize / 4;  // uint32 words per weight
  const int nv = a.width / V;
  for (int64_t r = r_begin + gi; r < r_end; r += groups) {
    const Span sp = span_of(s.sp, r, a.cap);
    for (int v = lane_g; v < nv; v += G) {
      const int64_t col = static_cast<int64_t>(v) * V;
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      for (int64_t p = sp.start; p < sp.end; p += kUnroll) {
        RawT raw[kUnroll];
        float f[kUnroll];
        bool zero[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (p + u < sp.end) {
            const int64_t id = static_cast<int64_t>(s.ids[p + u]);
            const int64_t g = global_row(id, s.nrows, s.base, a.slab_rows);
            raw[u] = __ldg(reinterpret_cast<const RawT*>(
                slab + g * a.width + col));
            f[u] = wb ? Tr::rnd(__uint_as_float(
                            wb[s.wbase + (p + u) * wstep]))
                      : 1.f;
            zero[u] = s.masked && (id < 0 || id >= s.nrows);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (p + u < sp.end) {
            add_row<Tr, V>(acc, raw[u], wb != nullptr, f[u], zero[u]);
          }
        }
      }
      finish_row<Tr, To, V>(a, s, r, col, acc);
    }
  }
}

template <typename Tr, typename To, int VB, typename IdT>
__global__ void __launch_bounds__(kMaxThreads, 1)
ragged_combine_kernel(const __grid_constant__ Args a) {
  using E = typename Tr::E;
  using RawT = typename Raw<VB>::T;
  constexpr int V = VB / static_cast<int>(sizeof(E));
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  uint32_t* src = reinterpret_cast<uint32_t*>(smem);
  int* rend = reinterpret_cast<int*>(smem + a.rend_off);
  const E* slab = static_cast<const E*>(a.slab);
  const int G = 1 << a.group_log2;
  const int lane_g = tid & (G - 1);
  const int gi = tid >> a.group_log2;
  const int groups = nthreads >> a.group_log2;
  const int nv = a.width / V;
  const uint32_t* wb = static_cast<const uint32_t*>(a.weights);
  const int64_t wstep = a.w_esize / 4;  // uint32 words per weight

  for (int64_t t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    Slot<IdT> s;
    s.slot = static_cast<int>(t / a.tiles_per_slot);
    const int64_t r0 = (t - s.slot * a.tiles_per_slot) * kTile;
    const int nr = static_cast<int>(r0 + kTile < a.b ? kTile : a.b - r0);
    s.sp = a.splits + static_cast<int64_t>(s.slot) * (a.b + 1);
    s.nrows = a.rows[s.slot];
    s.base = a.roff[s.slot];
    s.ids = static_cast<const IdT*>(a.values) +
            static_cast<int64_t>(s.slot) * a.v_stride;
    s.masked = a.mask != nullptr && a.mask[s.slot] != 0;
    s.is_mean = a.mean != nullptr && a.mean[s.slot] != 0;
    s.wbase = static_cast<int64_t>(s.slot) * a.w_stride * wstep;
    const int64_t ps = span_of(s.sp, r0, a.cap).start;
    // the flat form: rows that follow one another; rend[i]: row i's end
    // from the tile's first position
    bool ok = a.max_pos > 0 && s.nrows > 0;
    if (ok) {
      for (int i = tid; i < nr; i += nthreads) {
        const Span sp = span_of(s.sp, r0 + i, a.cap);
        const int64_t prev =
            i == 0 ? ps : span_of(s.sp, r0 + i - 1, a.cap).end;
        const bool fits = sp.start == prev && sp.end - ps <= 0x7fffffffLL;
        ok = ok && fits;
        rend[i] = fits ? static_cast<int>(sp.end - ps) : 0;
      }
    }
    if (__syncthreads_and(ok) == 0) {
      general_rows<Tr, To, VB>(a, s, r0, r0 + nr, gi, groups, lane_g, G);
      __syncthreads();  // the next tile rewrites the row ends
      continue;
    }
    // passes of the rows [i0, i1) whose positions fit the source words
    for (int i0 = 0; i0 < nr;) {
      const int q0 = i0 == 0 ? 0 : rend[i0 - 1];
      int i1 = i0, hi = nr;  // the first row ending past q0 + max_pos
      while (i1 < hi) {
        const int mid = (i1 + hi) >> 1;
        if (rend[mid] - q0 <= a.max_pos) {
          i1 = mid + 1;
        } else {
          hi = mid;
        }
      }
      if (i1 == i0) {  // one row past the source words: from its ids
        general_rows<Tr, To, VB>(a, s, r0 + i0, r0 + i0 + 1, gi, groups,
                                 lane_g, G);
        ++i0;
        continue;
      }
      const int npos = rend[i1 - 1] - q0;
      const int64_t pq = ps + q0;  // the pass's first position
      // 1. source words: the row, or a masked bad id's flag
      for (int qb = 0; qb < npos; qb += kCountUnroll * nthreads) {
        IdT idv[kCountUnroll];
#pragma unroll
        for (int k = 0; k < kCountUnroll; ++k) {  // every id load at once
          const int q = qb + k * nthreads + tid;
          if (q < npos) idv[k] = s.ids[pq + q];
        }
#pragma unroll
        for (int k = 0; k < kCountUnroll; ++k) {
          const int q = qb + k * nthreads + tid;
          if (q < npos) {
            const int64_t id = static_cast<int64_t>(idv[k]);
            src[q] = static_cast<uint32_t>(
                         global_row(id, s.nrows, s.base, a.slab_rows)) |
                     (s.masked && (id < 0 || id >= s.nrows) ? kZero : 0u);
          }
        }
      }
      __syncthreads();
      // 2. combine: a lane group a row, each position's row named by its
      // source word, kUnroll reads in flight, then the row's last
      // positions one at a time
      for (int rr = i0 + gi; rr < i1; rr += groups) {
        const int qs = (rr == 0 ? 0 : rend[rr - 1]) - q0;
        const int qe = rend[rr] - q0;
        for (int v = lane_g; v < nv; v += G) {
          const int64_t col = static_cast<int64_t>(v) * V;
          float acc[V];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = 0.f;
          int q = qs;
          for (; q + kUnroll <= qe; q += kUnroll) {
            RawT raw[kUnroll];
            uint32_t w[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              w[u] = src[q + u];
              raw[u] = word_row<RawT>(a, slab, w[u], col);
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const float f = wb ? Tr::rnd(__uint_as_float(
                                       wb[s.wbase + (pq + q + u) * wstep]))
                                 : 1.f;
              add_row<Tr, V>(acc, raw[u], wb != nullptr, f,
                             (w[u] & kZero) != 0u);
            }
          }
          for (; q < qe; ++q) {
            const uint32_t w = src[q];
            const RawT raw = word_row<RawT>(a, slab, w, col);
            const float f = wb ? Tr::rnd(__uint_as_float(
                                     wb[s.wbase + (pq + q) * wstep]))
                               : 1.f;
            add_row<Tr, V>(acc, raw, wb != nullptr, f, (w & kZero) != 0u);
          }
          finish_row<Tr, To, V>(a, s, r0 + rr, col, acc);
        }
      }
      __syncthreads();  // the next pass rewrites the source words
      i0 = i1;
    }
    __syncthreads();  // the next tile rewrites the row ends
  }
}

using Kernel = const void*;

template <typename Tr, typename To, int VB>
Kernel pick_ids(bool ids64) {
  return ids64 ? reinterpret_cast<Kernel>(
                     &ragged_combine_kernel<Tr, To, VB, int64_t>)
               : reinterpret_cast<Kernel>(
                     &ragged_combine_kernel<Tr, To, VB, int32_t>);
}

template <typename Tr, typename To>
Kernel pick_vb(int vb, bool ids64) {
  switch (vb) {
    case 16: return pick_ids<Tr, To, 16>(ids64);
    case 8: return pick_ids<Tr, To, 8>(ids64);
    case 4: return pick_ids<Tr, To, 4>(ids64);
    case 2:
      if constexpr (sizeof(typename Tr::E) <= 2) {
        return pick_ids<Tr, To, 2>(ids64);
      }
      break;
    default: break;
  }
  return nullptr;
}

struct Prepared {
  Args a;
  Kernel kernel;
  unsigned grid;
  int smem;
};

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int64_t detpu_ragged_combine_prepared_bytes() {
  return static_cast<int64_t>(sizeof(Prepared));
}

// Validate one call's fixed layout and write its launch into `prepared`
// (detpu_ragged_combine_prepared_bytes() bytes of host memory).
//   dtype / out_dtype: 0 = float32, 1 = bfloat16; ids_is_64: values are
//   int64 (else int32); w_esize: 0 = no weights, 4 = float32 (or int32
//   bits), 8 = int64 elements whose low 32 bits are the float32 bits.
extern "C" int detpu_ragged_combine_prepare(
    const void* slab, int64_t slab_rows, int width, int dtype, int ids_is_64,
    int64_t v_stride, const void* rows, const void* roff, const void* mean,
    const void* mask, int w_esize, int64_t w_stride, int out_dtype,
    int n_slots, int64_t b, int64_t cap, void* prepared) {
  if (width <= 0 || slab_rows <= 0 || n_slots < 0 || b < 0 || cap < 0 ||
      (dtype != 0 && dtype != 1) || (out_dtype != 0 && out_dtype != 1) ||
      (w_esize != 0 && w_esize != 4 && w_esize != 8) ||
      prepared == nullptr) {
    return cudaErrorInvalidValue;
  }
  Prepared* p = static_cast<Prepared*>(prepared);
  memset(p, 0, sizeof(Prepared));
  const int esize = dtype == 0 ? 4 : 2;
  // widest vector (16/8/4/2 B of slab) that divides a row and keeps the
  // slab aligned (the output, a fresh allocation, is aligned to 16 B)
  int vb = 16;
  while (vb > esize) {
    if ((width * esize) % vb == 0 &&
        reinterpret_cast<uintptr_t>(slab) % vb == 0) {
      break;
    }
    vb /= 2;
  }
  const int nv = width * esize / vb;
  int group_log2 = 0;
  while ((1 << group_log2) < nv && group_log2 < 5) ++group_log2;
  Args& a = p->a;
  a.slab = slab;
  a.slab_rows = slab_rows;
  a.width = width;
  a.v_stride = v_stride;
  a.rows = static_cast<const int64_t*>(rows);
  a.roff = static_cast<const int64_t*>(roff);
  a.mean = static_cast<const int*>(mean);
  a.mask = static_cast<const int*>(mask);
  a.w_stride = w_stride;
  a.w_esize = w_esize ? w_esize : 4;
  a.n_slots = n_slots;
  a.b = b;
  a.cap = cap;
  a.group_log2 = group_log2;
  a.tiles_per_slot = (b + kTile - 1) / kTile;
  a.tiles = a.tiles_per_slot * n_slots;
  const bool ids64 = ids_is_64 != 0;
  Kernel k = dtype == 0
      ? (out_dtype == 0 ? pick_vb<F32, F32>(vb, ids64)
                        : pick_vb<F32, BF16>(vb, ids64))
      : (out_dtype == 0 ? pick_vb<BF16, F32>(vb, ids64)
                        : pick_vb<BF16, BF16>(vb, ids64));
  if (k == nullptr) return cudaErrorInvalidValue;
  p->kernel = k;
  if (a.tiles == 0) return cudaSuccess;
  // shared memory: the CTA's share of the SM, less its static part
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  cudaFuncAttributes attr;
  if (e == cudaSuccess) {
    e = cudaFuncGetAttributes(&attr, k);
  }
  if (e != cudaSuccess) return e;
  const int dyn_max = optin - static_cast<int>(attr.sharedSizeBytes);
  int budget = per_sm / kCtas - 1024;  // 1 KB a CTA is the system's
  if (budget > dyn_max) budget = dyn_max;
  // the source words, then the row ends. Words for the call's capacity a
  // sample (cap / b, rounded up) over a tile, and a quarter more for
  // tiles past the mean, within the CTA's share of the SM: at the ragged
  // step's shapes (21 KB a CTA) 2.02 ms, with the whole share (113 KB)
  // 2.28, the L1 then left 30 KB of the SM's 256 (k8_variants.py; PERF.md)
  const int64_t most = (budget - 4 * kTile) / 4;
  const int64_t want = (b > 0 ? (cap + b - 1) / b : 1) * kTile * 5 / 4 + 1;
  a.max_pos = slab_rows <= (1ll << 31) && most > 0
                  ? static_cast<int>(want < most ? want : most) : 0;
  a.rend_off = 4 * a.max_pos;
  p->smem = a.max_pos > 0 ? a.rend_off + 4 * kTile : 0;
  // the kernel's limit at its most, so no record's launch is refused
  // after another record set it lower
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dyn_max);
  int resident = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, k, kThreads,
                                                      p->smem);
  }
  if (e != cudaSuccess) return e;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int64_t cap_grid =
      static_cast<int64_t>(sms) * (resident < kCtas ? resident : kCtas);
  p->grid = static_cast<unsigned>(a.tiles < cap_grid ? a.tiles : cap_grid);
  return cudaSuccess;
}

// values [n_slots, *] (row stride as prepared), splits [n_slots, b + 1]
// int64, weights as prepared (or null), out [n_slots, b, width] 16-B
// aligned.
extern "C" int detpu_ragged_combine_launch(const void* prepared,
                                           const void* values,
                                           const void* splits,
                                           const void* weights, void* out,
                                           void* stream) {
  const Prepared* p = static_cast<const Prepared*>(prepared);
  if (p == nullptr || p->kernel == nullptr || out == nullptr ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (p->a.tiles == 0) return cudaSuccess;
  Args a = p->a;
  a.values = values;
  a.splits = static_cast<const int64_t*>(splits);
  a.weights = weights;
  a.out = out;
  void* args[] = {&a};
  return cudaLaunchKernel(p->kernel, dim3(p->grid), dim3(kThreads), args,
                          p->smem, static_cast<cudaStream_t>(stream));
}
