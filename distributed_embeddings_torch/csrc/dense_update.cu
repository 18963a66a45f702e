// K22: the dense optimizer update of the train step, multi-tensor and in
// place, for Hopper (sm_90a).
//
// Replaces the XLA-fused epilogue of
//   distributed_embeddings_tpu/parallel/trainer.py:_apply_dense_and_assemble
//   (:180-215): optax's update and apply_updates over every dense
//   parameter (optax.sgd with or without momentum / Nesterov,
//   optax.adagrad, optax.adam), then the non-finite guard's
//   where(ok, new, old) over the parameters and the optimizer state.
// One launch updates every parameter and its state IN PLACE, each element
// by the chain of parallel/optimizers.py's update followed by p + u, in
// the same order and with the same rounding (every product, quotient and
// sum through __fmul_rn / __fdiv_rn / __fadd_rn, so nvcc contracts
// nothing into an FMA):
//   sgd       u = g * nlr
//   momentum  t' = g + m * t;  u = t' * nlr
//   nesterov  t' = g + m * t;  u = (g + m * t') * nlr
//   adagrad   s' = g * g + s;  u = (where(s' > 0, rsqrt(s' + eps), 0) * g)
//                                  * nlr
//   adam      mu' = (1 - b1) * g + b1 * mu;
//             nu' = (1 - b2) * (g * g) + b2 * nu
//             u = (mu' / (1 - bp1)) / (sqrt(nu' / (1 - bp2) + eps_root) + eps)
//                 * nlr
//   then      p' = p + u
// nlr is -lr: a constant (the float32 of -lr) or read on the card (a
// schedule's -lr(count), as K18 reads its lr); bp1, bp2 are b1**t, b2**t
// of the advanced Adam count, read on the card (ops/adam.py:bias_powers).
// rsqrt and sqrt are the correctly rounded __frsqrt_rn and __fsqrt_rn; the
// plain version takes them in float64 and rounds once (as K6 and K11).
// The guard's select is fused: with `ok` given and false the kernel writes
// nothing, and the Adam and schedule counts advance by ok (block 0,
// thread 0; nothing else reads them in the launch).
//
// Bound: bytes. Each element reads p, g and its state (0 to 2 floats)
// and writes p and its state once: 8 B (sgd) to 16 B (adam) an element
// read, 4 to 12 B written.
// Design: the descriptors (p, g, state pointers, numel, first tile) travel
// BY VALUE as a __grid_constant__ parameter; the grid is a flat list of
// tiles of `tile` elements of one tensor, a block finding its tensor by a
// binary search over the first tiles; a thread takes 4 elements kThreads
// apart each round, as one float4 when every pointer is 16-byte aligned.
// The tile is chosen per launch by the host (4096, 2048 or 1024
// elements), so that the grid has at least two blocks an SM where the
// elements allow: the DLRM SGD set (2.37M floats) keeps 4096, a set of
// ~0.2M floats (the zoo's Adam) takes 1024 and ~200 blocks, not 51.
// Host side: the parameters, the optimizer state and the gradients keep
// their addresses from step to step, so the wrapper validates the
// descriptors and converts the constant scalars ONCE, into a prepared
// launch (detpu_dense_update_prepare); each step then passes only the
// per-call pointers (the schedule's -lr, bp, ok, the counts) and the
// stream to detpu_dense_update_launch, which copies the prepared
// parameter block, patches them in and launches.
//
// C interface (ctypes): detpu_dense_update_prepare takes the descriptors
// as a host pointer to int64 [n, 6] (p, g, s0, s1, numel, first tile in
// units of `tile`), the tile, the kind and the constant scalars, and
// writes a prepared launch of detpu_dense_update_prepared_bytes() bytes
// into host memory the caller owns; detpu_dense_update_launch takes that
// and the device pointers (null when absent). Both return a cudaError_t
// (the launch's).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 512;  // descriptors a launch takes (48 B each)
constexpr int64_t kMaxTile = 1 << 20;  // elements a block may update

enum Kind { kSgd = 0, kMomentum = 1, kNesterov = 2, kAdagrad = 3, kAdam = 4 };

struct Desc {
  int64_t p;      // float32 parameter
  int64_t g;      // float32 gradient
  int64_t s0;     // trace / accumulator / mu (0 for plain sgd)
  int64_t s1;     // nu (adam)
  int64_t numel;
  int64_t tile0;  // this tensor's first tile
};

struct Scalars {
  int kind;
  float nlr;       // -lr, when nlr_dev is null
  float m;         // momentum
  float b1, omb1, b2, omb2;
  float eps, eps_root;
  const float* nlr_dev;  // -lr on the card (a schedule), or null
  const float* bp;       // [b1**t, b2**t] (adam)
  const bool* ok;        // the guard's verdict, or null (always write)
  int* count_a;          // Adam's count, advanced by ok (or null)
  int* count_s;          // the schedule's count, advanced by ok (or null)
};

template <int CAP>
struct Params {
  int64_t n;
  int64_t tile;  // elements a block updates (a multiple of 4)
  Scalars s;
  Desc d[CAP];
};
// A Params<CAP> is a prefix of a Params<kMaxTensors>: a prepared launch
// keeps the largest and launches the first sizeof(Params<CAP>) bytes.
static_assert(offsetof(Params<16>, d) == offsetof(Params<kMaxTensors>, d),
              "Params layouts differ");

struct Prepared {
  int64_t cap;          // the Params<cap> launched: 16, 128 or kMaxTensors
  int64_t tiles;        // blocks of the launch (at least 1)
  int64_t nlr_on_card;  // -lr is read from the launch's nlr_dev
  int64_t advance;      // this launch advances the counts (the first one)
  Params<kMaxTensors> p;
};

template <int KIND>
__device__ __forceinline__ void update1(const Scalars& s, float nlr,
                                        float bc1, float bc2, float& p,
                                        float g, float& s0, float& s1) {
  float u;
  if constexpr (KIND == kSgd) {
    u = __fmul_rn(g, nlr);
  } else if constexpr (KIND == kMomentum || KIND == kNesterov) {
    const float t = __fadd_rn(g, __fmul_rn(s.m, s0));
    const float step = KIND == kNesterov ? __fadd_rn(g, __fmul_rn(s.m, t))
                                         : t;
    s0 = t;
    u = __fmul_rn(step, nlr);
  } else if constexpr (KIND == kAdagrad) {
    const float acc = __fadd_rn(__fmul_rn(g, g), s0);
    const float r = acc > 0.0f ? __frsqrt_rn(__fadd_rn(acc, s.eps)) : 0.0f;
    s0 = acc;
    u = __fmul_rn(__fmul_rn(r, g), nlr);
  } else {
    const float mu = __fadd_rn(__fmul_rn(s.omb1, g), __fmul_rn(s.b1, s0));
    const float nu = __fadd_rn(__fmul_rn(s.omb2, __fmul_rn(g, g)),
                               __fmul_rn(s.b2, s1));
    const float den = __fadd_rn(
        __fsqrt_rn(__fadd_rn(__fdiv_rn(nu, bc2), s.eps_root)), s.eps);
    s0 = mu;
    s1 = nu;
    u = __fmul_rn(__fdiv_rn(__fdiv_rn(mu, bc1), den), nlr);
  }
  p = __fadd_rn(p, u);
}

template <int KIND>
__device__ __forceinline__ void run_tile(const Scalars& s, const Desc& d,
                                         int64_t begin, int64_t len,
                                         float nlr, float bc1, float bc2) {
  float* p = reinterpret_cast<float*>(d.p) + begin;
  const float* g = reinterpret_cast<const float*>(d.g) + begin;
  float* s0 = reinterpret_cast<float*>(d.s0) + (d.s0 ? begin : 0);
  float* s1 = reinterpret_cast<float*>(d.s1) + (d.s1 ? begin : 0);
  const bool vec = ((d.p | d.g | d.s0 | d.s1) & 15) == 0;
  if (vec) {
    for (int64_t q = threadIdx.x; q * 4 < len; q += kThreads) {
      if (q * 4 + 4 <= len) {
        float4 pv = reinterpret_cast<float4*>(p)[q];
        const float4 gv = reinterpret_cast<const float4*>(g)[q];
        float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
        if (KIND != kSgd) av = reinterpret_cast<float4*>(s0)[q];
        if (KIND == kAdam) bv = reinterpret_cast<float4*>(s1)[q];
        update1<KIND>(s, nlr, bc1, bc2, pv.x, gv.x, av.x, bv.x);
        update1<KIND>(s, nlr, bc1, bc2, pv.y, gv.y, av.y, bv.y);
        update1<KIND>(s, nlr, bc1, bc2, pv.z, gv.z, av.z, bv.z);
        update1<KIND>(s, nlr, bc1, bc2, pv.w, gv.w, av.w, bv.w);
        reinterpret_cast<float4*>(p)[q] = pv;
        if (KIND != kSgd) reinterpret_cast<float4*>(s0)[q] = av;
        if (KIND == kAdam) reinterpret_cast<float4*>(s1)[q] = bv;
        continue;
      }
      for (int64_t e = q * 4; e < len; ++e) {
        float a = KIND != kSgd ? s0[e] : 0.f, b = KIND == kAdam ? s1[e] : 0.f;
        update1<KIND>(s, nlr, bc1, bc2, p[e], g[e], a, b);
        if (KIND != kSgd) s0[e] = a;
        if (KIND == kAdam) s1[e] = b;
      }
    }
    return;
  }
  for (int64_t e = threadIdx.x; e < len; e += kThreads) {
    float a = KIND != kSgd ? s0[e] : 0.f, b = KIND == kAdam ? s1[e] : 0.f;
    update1<KIND>(s, nlr, bc1, bc2, p[e], g[e], a, b);
    if (KIND != kSgd) s0[e] = a;
    if (KIND == kAdam) s1[e] = b;
  }
}

template <int CAP>
__global__ void __launch_bounds__(kThreads)
dense_update_kernel(const __grid_constant__ Params<CAP> prm) {
  const Scalars& s = prm.s;
  const bool ok = s.ok == nullptr || *s.ok;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int inc = ok ? 1 : 0;
    if (s.count_a != nullptr) *s.count_a += inc;
    if (s.count_s != nullptr) *s.count_s += inc;
  }
  if (!ok) return;
  const int64_t tile = blockIdx.x;
  int lo = 0;
  int hi = static_cast<int>(prm.n) - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (prm.d[mid].tile0 <= tile) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Desc& d = prm.d[lo];
  const int64_t begin = (tile - d.tile0) * prm.tile;
  if (begin >= d.numel) return;
  const int64_t len = d.numel - begin < prm.tile ? d.numel - begin
                                                 : prm.tile;
  const float nlr = s.nlr_dev != nullptr ? *s.nlr_dev : s.nlr;
  float bc1 = 1.0f, bc2 = 1.0f;
  if (s.kind == kAdam) {
    bc1 = __fsub_rn(1.0f, s.bp[0]);
    bc2 = __fsub_rn(1.0f, s.bp[1]);
  }
  switch (s.kind) {
    case kSgd: run_tile<kSgd>(s, d, begin, len, nlr, bc1, bc2); break;
    case kMomentum:
      run_tile<kMomentum>(s, d, begin, len, nlr, bc1, bc2);
      break;
    case kNesterov:
      run_tile<kNesterov>(s, d, begin, len, nlr, bc1, bc2);
      break;
    case kAdagrad:
      run_tile<kAdagrad>(s, d, begin, len, nlr, bc1, bc2);
      break;
    default: run_tile<kAdam>(s, d, begin, len, nlr, bc1, bc2); break;
  }
}

template <int CAP>
cudaError_t launch_cap(const Prepared& pr, const void* nlr_dev,
                       const void* bp, const void* ok, void* count_a,
                       void* count_s, cudaStream_t st) {
  Params<CAP> p;
  memcpy(&p, &pr.p, sizeof(Params<CAP>));
  p.s.nlr_dev = pr.nlr_on_card ? static_cast<const float*>(nlr_dev)
                               : nullptr;
  p.s.bp = static_cast<const float*>(bp);
  p.s.ok = static_cast<const bool*>(ok);
  p.s.count_a = pr.advance ? static_cast<int*>(count_a) : nullptr;
  p.s.count_s = pr.advance ? static_cast<int*>(count_s) : nullptr;
  dense_update_kernel<CAP>
      <<<static_cast<unsigned>(pr.tiles), kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most tensors one launch takes.
extern "C" int detpu_dense_update_max_tensors() { return kMaxTensors; }

// The bytes of a prepared launch.
extern "C" int64_t detpu_dense_update_prepared_bytes() {
  return static_cast<int64_t>(sizeof(Prepared));
}

// Validate one launch of K22 over n tensors (see the header) and write it
// to `out` (detpu_dense_update_prepared_bytes() bytes of host memory):
// descs int64 [n, 6] on the host (p, g, s0, s1, numel, first tile), tile
// the elements a block updates; nlr the constant -lr, or nlr_on_card set
// when each launch passes it on the card; advance set on the one launch
// of a call that advances the counts. Launches nothing.
extern "C" int detpu_dense_update_prepare(const int64_t* descs, int n,
                                          int64_t tile, int kind, float nlr,
                                          int nlr_on_card, float m, float b1,
                                          float omb1, float b2, float omb2,
                                          float eps, float eps_root,
                                          int advance, void* out) {
  if (n < 1 || n > kMaxTensors || tile < 4 || tile > kMaxTile ||
      tile % 4 != 0 || kind < kSgd || kind > kAdam || out == nullptr) {
    return cudaErrorInvalidValue;
  }
  int64_t next = 0;
  for (int i = 0; i < n; ++i) {
    const Desc* d = reinterpret_cast<const Desc*>(descs) + i;
    const bool need0 = kind != kSgd, need1 = kind == kAdam;
    if (d->numel < 0 || d->tile0 != next ||
        (d->numel > 0 && (d->p == 0 || d->g == 0 || (need0 && !d->s0) ||
                          (need1 && !d->s1)))) {
      return cudaErrorInvalidValue;
    }
    next += (d->numel + tile - 1) / tile;
  }
  if (next > 0x7fffffffLL) return cudaErrorInvalidValue;
  Prepared* pr = static_cast<Prepared*>(out);
  memset(pr, 0, sizeof(Prepared));
  pr->cap = n <= 16 ? 16 : n <= 128 ? 128 : kMaxTensors;
  pr->tiles = next > 0 ? next : 1;  // an empty launch still advances counts
  pr->nlr_on_card = nlr_on_card != 0;
  pr->advance = advance != 0;
  pr->p.n = n;
  pr->p.tile = tile;
  Scalars& s = pr->p.s;
  s.kind = kind;
  s.nlr = nlr;
  s.m = m;
  s.b1 = b1;
  s.omb1 = omb1;
  s.b2 = b2;
  s.omb2 = omb2;
  s.eps = eps;
  s.eps_root = eps_root;
  memcpy(pr->p.d, descs, sizeof(Desc) * static_cast<size_t>(n));
  return cudaSuccess;
}

// Launch a prepared K22 on `stream`: nlr_dev (-lr on the card, when the
// launch was prepared so), bp ([b1**t, b2**t], adam), ok and the counts
// (each null when absent).
extern "C" int detpu_dense_update_launch(const void* prepared,
                                         const void* nlr_dev, const void* bp,
                                         const void* ok, void* count_a,
                                         void* count_s, void* stream) {
  const Prepared* pr = static_cast<const Prepared*>(prepared);
  if (pr == nullptr || (pr->nlr_on_card && nlr_dev == nullptr) ||
      (pr->p.s.kind == kAdam && bp == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pr->cap) {
    case 16:
      return launch_cap<16>(*pr, nlr_dev, bp, ok, count_a, count_s, st);
    case 128:
      return launch_cap<128>(*pr, nlr_dev, bp, ok, count_a, count_s, st);
    default:
      return launch_cap<kMaxTensors>(*pr, nlr_dev, bp, ok, count_a, count_s,
                                     st);
  }
}
