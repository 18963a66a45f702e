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
// tiles of kTile elements of one tensor, a block finding its tensor by a
// binary search over the first tiles; a thread takes 4 elements kThreads
// apart each round, as one float4 when every pointer is 16-byte aligned.
//
// C interface (ctypes): the descriptors as a host pointer to int64
// [n, 6] (p, g, s0, s1, numel, first tile), the scalars by value, the
// device scalars as pointers (null when absent); returns the cudaError_t
// of the launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTile = 4096;   // elements a block updates
constexpr int kMaxTensors = 512;  // descriptors a launch takes (48 B each)

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
  int64_t pad;
  Scalars s;
  Desc d[CAP];
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
  const int64_t begin = (tile - d.tile0) * kTile;
  if (begin >= d.numel) return;
  const int64_t len = d.numel - begin < kTile ? d.numel - begin : kTile;
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
cudaError_t launch_cap(const int64_t* descs, int n, int64_t tiles,
                       const Scalars& s, cudaStream_t st) {
  Params<CAP> p;
  p.n = n;
  p.pad = 0;
  p.s = s;
  memcpy(p.d, descs, sizeof(Desc) * static_cast<size_t>(n));
  dense_update_kernel<CAP>
      <<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most tensors one launch takes.
extern "C" int detpu_dense_update_max_tensors() { return kMaxTensors; }

// The elements a tile (a block) covers.
extern "C" int64_t detpu_dense_update_tile() { return kTile; }

// K22 over n tensors (see the header): descs int64 [n, 6] on the host
// (p, g, s0, s1, numel, first tile), tiles their total (at least 1: a
// launch over no element still advances the counts).
extern "C" int detpu_dense_update(const int64_t* descs, int n, int64_t tiles,
                                  int kind, float nlr, const void* nlr_dev,
                                  float m, float b1, float omb1, float b2,
                                  float omb2, float eps, float eps_root,
                                  const void* bp, const void* ok,
                                  void* count_a, void* count_s,
                                  void* stream) {
  if (n < 1 || n > kMaxTensors || tiles < 1 || tiles > 0x7fffffffLL ||
      kind < kSgd || kind > kAdam || (kind == kAdam && bp == nullptr)) {
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
    next += (d->numel + kTile - 1) / kTile;
  }
  if (next > tiles) return cudaErrorInvalidValue;
  Scalars s;
  s.kind = kind;
  s.nlr = nlr;
  s.m = m;
  s.b1 = b1;
  s.omb1 = omb1;
  s.b2 = b2;
  s.omb2 = omb2;
  s.eps = eps;
  s.eps_root = eps_root;
  s.nlr_dev = static_cast<const float*>(nlr_dev);
  s.bp = static_cast<const float*>(bp);
  s.ok = static_cast<const bool*>(ok);
  s.count_a = static_cast<int*>(count_a);
  s.count_s = static_cast<int*>(count_s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 16) return launch_cap<16>(descs, n, tiles, s, st);
  if (n <= 128) return launch_cap<128>(descs, n, tiles, s, st);
  return launch_cap<kMaxTensors>(descs, n, tiles, s, st);
}
