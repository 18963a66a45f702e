// K21: the gradient-health reduction of the train step, for Hopper
// (sm_90a).
//
// Replaces the XLA-lowered reductions over the step's gradients in
//   distributed_embeddings_tpu/parallel/trainer.py: _sq_sum (:60), which
//   the non-finite guard runs over the dense gradients and the embedding
//   cotangents (:354-359, :515-520); _table_sentinels (:67), the per-input
//   sum of squares, max |g| and non-finite count of the cotangents; and
//   the two norms of _finish_metrics (:230-232).
// One call takes a list of tensors (bfloat16 or float32, each a 2-D view
// [rows, cols] with unit column stride; a contiguous tensor is one row)
// and returns, per tensor i, three float32 values in out [3, n] (more than
// kMaxTensors tensors: one launch a slice of them, each into its columns):
//   out[0, i] = sum(float32(g)^2)   (each square and sum rounded to fp32)
//   out[1, i] = max(|g|)            (NaN when any element is NaN; 0 empty)
//   out[2, i] = count(!isfinite(g)) (exact, rounded once to float32)
// so the guard, both norms and the three sentinels come from one read of
// the gradients, each element read once in its own dtype.
//
// Bound: bytes. Each element is read once (the DLRM step: 26 bf16
// [65536, 128] cotangents and ~2.4M fp32 dense gradients, ~446 MB,
// 0.133 ms at 3.35 TB/s); the partials are 12 bytes a chunk.
//
// Design: ONE launch of persistent CTAs (kCtasPerSm a SM). Every tensor
// is cut into chunks of about kChunkBytes: whole rows where a row fits
// (rows a chunk = the chunk's elements over the row's), else pieces of
// one row, so a chunk is a rectangle [rows, columns] of the view and no
// element's address needs a division. CTA b walks chunks b, b + grid, ...
// (its tensor found by stepping a cursor, the chunks being in tensor
// order). In a chunk a thread takes 16-byte groups of the rows (8 bf16 or
// 4 fp32, a row's last group possibly short) kThreads apart, kBatch
// groups' loads in flight (streaming loads: each byte is read once and
// should not displace the L2), stepping a (row, group) counter; it folds
// each group's elements in order, then the block folds its threads in a
// fixed tree (warp shuffles, then one warp over the warps) and writes the
// chunk's partial. Then the CTA takes a ticket of the chunk's tensor (a
// 64-bit counter a tensor in the record's scratch, never reset: a call
// adds the tensor's chunk count, so the ticket that completes a multiple
// of it is the call's last); the CTA holding the last ticket folds that
// tensor's partials in chunk order (a thread every kThreads-th chunk,
// then the same tree) and writes out[:, i]. Tensors without elements are
// written 0 by CTA 0. The counters never being reset, a launch record
// replays in a CUDA graph; one stream at a time a record (the scratch is
// the record's). 4 loads a thread, 128 KB chunks and 4 CTAs a SM measured
// fastest at the DLRM step's shapes (row_variants.py: against 8 or 16
// loads, 32 to 256 KB chunks, 2, 3 or 8 CTAs a SM).
// No float atomics and an order fixed by the shapes alone (the same
// whether a group is read as one vector or element by element, so an
// address's alignment does not change it), so the same inputs give the
// same bits on every run. The sum's order differs from the plain
// version's, so the two agree within float32 rounding; the max and the
// count are exact. max(|g|) folds with a NaN-propagating max (fmaxf drops
// NaN; jnp.max does not). A finite gradient whose squares overflow
// float32 gives an infinite sum, as JAX's does, and the guard skips the
// step.
//
// Host side: autograd hands the step fresh gradient tensors every call,
// so a launch record (ops/grad_health.py) is keyed on the LAYOUTS (count,
// shapes, strides, dtypes, device) and holds everything here but the
// addresses: detpu_grad_health_prepare validates the chunk map once and
// writes the parameter block; each call passes the n addresses and the
// output to detpu_grad_health_launch, which copies the block, patches
// the addresses in, allows 16-byte loads per tensor from its address's
// alignment, and launches.
//
// C interface (ctypes): pointers and the stream as void*, sizes as
// int64/int; every function returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 4;
constexpr int kBatch = 4;            // 16-byte groups a thread has in flight
constexpr int kChunkBytes = 131072;  // bytes a chunk covers (about)
constexpr int kMaxTensors = 512;     // descriptors a call takes (48 B each)

// flags of a descriptor
constexpr int kBf16 = 1;       // bfloat16 elements (else float32)
constexpr int kVecLayout = 2;  // the layout allows 16-byte loads
constexpr int kVec = 4;        // ... and so does this call's address

struct Desc {
  int64_t ptr;     // address of element 0 (patched each call)
  int64_t cols;    // elements a row
  int64_t stride;  // elements between rows
  int32_t chunk0;  // this tensor's first chunk
  int32_t chunks;  // its chunks (0 without elements)
  int32_t rows;    // rows of the view
  int32_t rpc;     // rows a chunk (1 when a row takes several chunks)
  int32_t ppr;     // chunks a row (1 when a chunk takes whole rows)
  int32_t flags;
};
static_assert(sizeof(Desc) == 48, "descriptor layout");

struct Triple {
  float sq;
  float mx;
  uint32_t nf;
};

struct Header {
  int32_t n;        // tensors
  int32_t total;    // chunks
  int64_t tickets;  // uint64 [n], the record's scratch
  int64_t partials; // Triple [total], the record's scratch
  int64_t out;      // float32 [3, out_ld] (patched each call)
  int32_t out_ld;   // elements between out's rows
  int32_t pad;
};

template <int CAP>
struct Params {
  Header h;
  Desc d[CAP];
};

// A record's launch: the capacity the descriptors need, the grid and
// the parameter block (addresses still 0).
struct Prepared {
  int32_t cap;
  int32_t grid;
  Params<kMaxTensors> p;
};

template <typename T>
__host__ __device__ constexpr int chunk_elems() {
  return kChunkBytes / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ void fold(Triple& t, float x) {
  t.sq = __fadd_rn(t.sq, __fmul_rn(x, x));
  t.mx = max_nan(t.mx, fabsf(x));
  t.nf += (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u ? 1u : 0u;
}

__device__ __forceinline__ Triple combine(Triple a, const Triple& b) {
  a.sq = __fadd_rn(a.sq, b.sq);
  a.mx = max_nan(a.mx, b.mx);
  a.nf += b.nf;
  return a;
}

__device__ __forceinline__ Triple shfl_fold(Triple t) {
  for (int o = 16; o > 0; o >>= 1) {
    Triple u;
    u.sq = __shfl_down_sync(0xffffffffu, t.sq, o);
    u.mx = __shfl_down_sync(0xffffffffu, t.mx, o);
    u.nf = __shfl_down_sync(0xffffffffu, t.nf, o);
    t = combine(t, u);
  }
  return t;
}

// Fixed-tree fold of one Triple a thread over the block; thread 0 gets
// the result. The caller syncs before `warps` is written again.
__device__ Triple block_fold(Triple t, Triple* warps) {
  t = shfl_fold(t);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = t;
  __syncthreads();
  if (warp == 0) {
    t = lane < kThreads / 32 ? warps[lane] : Triple{0.0f, 0.0f, 0u};
    t = shfl_fold(t);
  }
  return t;
}

__device__ __forceinline__ float elem(const float* p) { return __ldcs(p); }

__device__ __forceinline__ float elem(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<uint32_t>(__ldcs(reinterpret_cast<const uint16_t*>(p)))
      << 16);
}

template <int G>
__device__ __forceinline__ void fold_vec(Triple& t, const uint4& v) {
  if constexpr (G == 8) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      fold(t, __uint_as_float(w[q] << 16));
      fold(t, __uint_as_float(w[q] & 0xffff0000u));
    }
  } else {
    fold(t, __uint_as_float(v.x));
    fold(t, __uint_as_float(v.y));
    fold(t, __uint_as_float(v.z));
    fold(t, __uint_as_float(v.w));
  }
}

// Chunk lc of tensor d: its rectangle's groups of G elements (16 bytes),
// kThreads apart, each folded in element order.
template <typename T, int G>
__device__ Triple fold_chunk(const Desc& d, int32_t lc) {
  constexpr int CE = chunk_elems<T>();
  int64_t r0, c0;
  int rn, cn;
  if (d.ppr > 1) {
    r0 = lc / d.ppr;
    c0 = static_cast<int64_t>(lc % d.ppr) * CE;
    rn = 1;
    cn = static_cast<int>(d.cols - c0 < CE ? d.cols - c0 : CE);
  } else {
    r0 = static_cast<int64_t>(lc) * d.rpc;
    rn = static_cast<int>(d.rows - r0 < d.rpc ? d.rows - r0 : d.rpc);
    c0 = 0;
    cn = static_cast<int>(d.cols);
  }
  const T* base = reinterpret_cast<const T*>(d.ptr) + r0 * d.stride + c0;
  const int gpr = (cn + G - 1) / G;  // groups a row
  const int total = rn * gpr;
  const bool vec = (d.flags & kVec) != 0;
  // this thread's (row, group) and the step kThreads groups make
  int r = threadIdx.x / gpr, q = threadIdx.x % gpr;
  const int dr = kThreads / gpr, dq = kThreads % gpr;
  Triple t{0.0f, 0.0f, 0u};
  for (int g0 = threadIdx.x; g0 < total; g0 += kThreads * kBatch) {
    uint4 v[kBatch];
    int rr[kBatch], qq[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      rr[b] = r;
      qq[b] = q;
      if (vec && g0 + b * kThreads < total && (q + 1) * G <= cn) {
        v[b] = __ldcs(reinterpret_cast<const uint4*>(
            base + static_cast<int64_t>(r) * d.stride + q * G));
      }
      q += dq;
      r += dr;
      if (q >= gpr) {
        q -= gpr;
        ++r;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (g0 + b * kThreads >= total) break;
      const int e0 = qq[b] * G;
      if (vec && e0 + G <= cn) {
        fold_vec<G>(t, v[b]);
      } else {
        const T* row = base + static_cast<int64_t>(rr[b]) * d.stride;
        const int e1 = e0 + G < cn ? e0 + G : cn;
        for (int e = e0; e < e1; ++e) fold(t, elem(row + e));
      }
    }
  }
  return t;
}

__device__ __forceinline__ Triple load_partial(const Triple* p) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
  return Triple{__uint_as_float(__ldcg(w)), __uint_as_float(__ldcg(w + 1)),
                __ldcg(w + 2)};
}

template <int CAP>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
health_kernel(const __grid_constant__ Params<CAP> p) {
  __shared__ Triple warps[kThreads / 32];
  __shared__ int last;
  const int n = p.h.n, ld = p.h.out_ld;
  float* out = reinterpret_cast<float*>(p.h.out);
  Triple* partials = reinterpret_cast<Triple*>(p.h.partials);
  unsigned long long* tickets =
      reinterpret_cast<unsigned long long*>(p.h.tickets);
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (p.d[i].chunks == 0) {
        out[i] = 0.0f;
        out[ld + i] = 0.0f;
        out[2 * ld + i] = 0.0f;
      }
    }
  }
  int i = 0;
  for (int c = blockIdx.x; c < p.h.total; c += gridDim.x) {
    // the last tensor whose first chunk is at or before c (a tensor
    // without elements owns no chunk and shares the next one's first)
    while (i + 1 < n && p.d[i + 1].chunk0 <= c) ++i;
    const Desc& d = p.d[i];
    Triple t = (d.flags & kBf16) ? fold_chunk<__nv_bfloat16, 8>(d, c - d.chunk0)
                                 : fold_chunk<float, 4>(d, c - d.chunk0);
    t = block_fold(t, warps);
    if (threadIdx.x == 0) {
      partials[c] = t;
      __threadfence();
      const unsigned long long old = atomicAdd(tickets + i, 1ull);
      last = (old + 1) % static_cast<unsigned long long>(d.chunks) == 0;
    }
    __syncthreads();
    if (last) {
      __threadfence();
      Triple u{0.0f, 0.0f, 0u};
      for (int k = threadIdx.x; k < d.chunks; k += kThreads) {
        u = combine(u, load_partial(partials + d.chunk0 + k));
      }
      u = block_fold(u, warps);
      if (threadIdx.x == 0) {
        out[i] = u.sq;
        out[ld + i] = u.mx;
        out[2 * ld + i] = __uint2float_rn(u.nf);
      }
    }
    __syncthreads();
  }
}

template <int CAP>
cudaError_t launch_cap(const Prepared& pr, const int64_t* addrs, void* out,
                       cudaStream_t st) {
  Params<CAP> p;
  const int n = pr.p.h.n;
  p.h = pr.p.h;
  p.h.out = reinterpret_cast<int64_t>(out);
  memcpy(p.d, pr.p.d, sizeof(Desc) * static_cast<size_t>(n));
  for (int i = 0; i < n; ++i) {
    Desc& d = p.d[i];
    d.ptr = addrs[i];
    if (d.chunks > 0 && d.ptr == 0) return cudaErrorInvalidValue;
    if ((d.flags & kVecLayout) && d.ptr % 16 == 0) d.flags |= kVec;
  }
  health_kernel<CAP><<<pr.grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most tensors one call takes.
extern "C" int detpu_grad_health_max_tensors() { return kMaxTensors; }

// The bytes a chunk covers (about: whole rows, or kChunkBytes of a row).
extern "C" int detpu_grad_health_chunk_bytes() { return kChunkBytes; }

// The bytes of a prepared launch.
extern "C" int64_t detpu_grad_health_prepared_bytes() {
  return static_cast<int64_t>(sizeof(Prepared));
}

// The bytes of card scratch a record over n tensors and `chunks` chunks
// owns (zeroed once by the caller): the tickets, then the partials.
extern "C" int64_t detpu_grad_health_scratch_bytes(int n, int64_t chunks) {
  return 8 * static_cast<int64_t>(n) +
         static_cast<int64_t>(sizeof(Triple)) * chunks;
}

// Validate a record's chunk map and write its prepared launch to `out`
// (detpu_grad_health_prepared_bytes() bytes of host memory): descs int64
// [n, 8] on the host, per tensor (rows, cols, row stride, first chunk,
// chunks, rows a chunk, chunks a row, flags: 1 bfloat16, 2 the layout
// allows 16-byte loads); scratch the record's zeroed card scratch; sms the
// card's SMs; out_ld the elements between the output's rows (n, or more
// where one call's tensors take several launches). Launches nothing.
extern "C" int detpu_grad_health_prepare(const int64_t* descs, int n,
                                         void* scratch, int sms, int out_ld,
                                         void* out) {
  if (n <= 0 || n > kMaxTensors || sms <= 0 || out_ld < n ||
      out == nullptr) {
    return cudaErrorInvalidValue;
  }
  Prepared* pr = static_cast<Prepared*>(out);
  memset(pr, 0, sizeof(Prepared));
  int64_t next = 0;
  for (int i = 0; i < n; ++i) {
    const int64_t* s = descs + 8 * i;
    const int64_t rows = s[0], cols = s[1], stride = s[2], chunk0 = s[3],
                  chunks = s[4], rpc = s[5], ppr = s[6], flags = s[7];
    const int64_t ce = (flags & kBf16) ? chunk_elems<__nv_bfloat16>()
                                       : chunk_elems<float>();
    const bool empty = rows == 0 || cols == 0;
    const int64_t want =
        empty ? 0 : (ppr > 1 ? rows * ppr : (rows + rpc - 1) / rpc);
    if (rows < 0 || rows > 0x7fffffffLL || cols < 0 || chunk0 != next ||
        chunks != want || rpc < 1 || ppr < 1 || (flags & ~3) != 0 ||
        (ppr > 1 && (rpc != 1 || (cols + ce - 1) / ce != ppr)) ||
        (ppr == 1 && (cols > ce || (cols > 0 && rpc * cols > ce &&
                                    rpc > 1))) ||
        (rows > 1 && stride < cols)) {
      return cudaErrorInvalidValue;
    }
    Desc& d = pr->p.d[i];
    d.cols = cols;
    d.stride = stride;
    d.chunk0 = static_cast<int32_t>(chunk0);
    d.chunks = static_cast<int32_t>(chunks);
    d.rows = static_cast<int32_t>(rows);
    d.rpc = static_cast<int32_t>(rpc);
    d.ppr = static_cast<int32_t>(ppr);
    d.flags = static_cast<int32_t>(flags);
    next += chunks;
    if (next > 0x7fffffffLL) return cudaErrorInvalidValue;
  }
  if (next > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  pr->cap = n <= 16 ? 16 : n <= 64 ? 64 : kMaxTensors;
  const int64_t most = static_cast<int64_t>(sms) * kCtasPerSm;
  pr->grid = static_cast<int32_t>(next < most ? (next > 0 ? next : 1) : most);
  pr->p.h.n = n;
  pr->p.h.out_ld = out_ld;
  pr->p.h.total = static_cast<int32_t>(next);
  pr->p.h.tickets = reinterpret_cast<int64_t>(scratch);
  pr->p.h.partials = reinterpret_cast<int64_t>(scratch) + 8 * n;
  return cudaSuccess;
}

// K21 through a prepared launch: addrs int64 [n] on the host (each
// tensor's element 0), out the launch's first column of a float32
// [3, out_ld] on the card.
extern "C" int detpu_grad_health_launch(const void* prepared,
                                        const void* addrs, void* out,
                                        void* stream) {
  const Prepared* pr = static_cast<const Prepared*>(prepared);
  if (pr == nullptr || addrs == nullptr || out == nullptr) {
    return cudaErrorInvalidValue;
  }
  const int64_t* a = static_cast<const int64_t*>(addrs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pr->cap) {
    case 16:
      return launch_cap<16>(*pr, a, out, st);
    case 64:
      return launch_cap<64>(*pr, a, out, st);
    default:
      return launch_cap<kMaxTensors>(*pr, a, out, st);
  }
}
