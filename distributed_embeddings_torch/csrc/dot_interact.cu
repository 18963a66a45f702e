// K2: DLRM dot-interaction forward, and K4: its backward, for Hopper
// (sm_90a).
//
// K2 replaces the XLA-lowered forward of the JAX package's
//   distributed_embeddings_tpu/models/dlrm.py:dot_interact
// which stacks [B, F, D] features (bottom-MLP output first), forms the
// per-sample Gram matrix F.F^T, keeps its strict lower triangle in
// np.tril_indices(F, -1) order (row-major: (1,0), (2,0), (2,1), ...),
// and appends the bottom-MLP row: out [B, F(F-1)/2 + D]. The stack is
// part of that function, and K2 takes it over: it reads the F features
// where they lie, through a table of (pointer, row stride) pairs passed
// by value in the kernel's parameters (F <= 32), or through one stacked
// tensor's (base, feature stride, row stride) above that.
//
// K4 replaces what JAX's autodiff makes of the same function (the
// transposed selection matmul, the two einsum cotangents and the
// unstack): with dG the symmetric [F, F] matrix whose (i, j) and (j, i)
// entries are the cotangent of pair (i, j) and whose diagonal is 0,
// dfeats[f] = sum_g dG[f, g] feats[g], plus the cotangent of the
// appended bottom-MLP row on feature 0; it writes feature f's rows at
// (out_fs * f + out_rs * b) elements (the port's list form: one [F, B, D]
// buffer, each feature's gradient a contiguous [B, D] view).
//
// Bound: bytes, both ways. At F=27, D=128, bf16 a sample's K2 reads
// 6.9 KB and writes 958 B for 351 x 128 multiply-adds; its K4 reads
// 6.9 KB + 958 B and writes 6.9 KB for 729 x 128: under 15 operations a
// byte, far below the ~295 a byte at which the bf16 tensor cores become
// the limit. What held the first design back was not the device memory
// but the shared memory's bandwidth, spent by CUDA-core dot products
// (each of a sample's 351 pairs read both 256-B rows: ~180 KB of shared
// reads a sample), 48-KB tiles loaded synchronously, and the stack's
// copy in front of K2.
//
// Design of the bf16 path (2 <= F <= 32, D a multiple of 16, every row
// 16-B aligned): persistent CTAs of four warps walk tiles of four
// samples. A ring of two stages in dynamic shared memory (up to three
// CTAs a SM, as many as fit), each with an mbarrier, is filled by bulk
// copies (TMA, cp.async.bulk): a stage holds [32 features][4 samples][D],
// so one thread copies feature f's four rows of the tile in one
// instruction where they are contiguous (the step's features are), one
// thread a row otherwise, and for K4 one copy brings the 16-B chunks that
// cover the tile's dy rows. Tile t+1's loads are in flight while tile t
// is multiplied; a stage is refilled once a block barrier shows every
// warp done with it. Each feature's rows are padded by 16 B
// (features F..31 zeroed once, never loaded), so the eight row addresses
// of an ldmatrix phase (eight features of one sample) fall in eight
// different bank groups. One warp multiplies one sample on the tensor
// cores with
// mma.sync.aligned.m16n8k16 (bf16 in, fp32 accumulators):
//   K2: the Gram's A fragments of rows 0-15 and 16-31 come from
//     ldmatrix (no .trans) on the staged rows, and since the Gram is
//     X X^T the same registers are the B fragments of every 8-row
//     column block; only the (16-row, 8-column) tiles that hold part of
//     the strict lower triangle are multiplied (6 of 8 at F = 27:
//     48 MMAs a sample for D = 128), so a sample's rows are read from
//     shared memory once (8 KB instead of ~180 KB). Each entry is
//     rounded once to bf16 into a per-warp staging row at its tril
//     position (each lane's 24 positions computed once a launch),
//     feature 0's row follows, and the 958-B output row, which is not
//     16-B aligned, is written head / 16-B body / tail.
//     The cancellation guard: the tensor cores add each 16-product chunk
//     at once, aligned to its largest term and truncated, where the plain
//     version (cuBLAS) adds one product at a time in fp32; the two sums
//     part by a few fp32 ulps of the sum of |products|, which is more than
//     1 bf16 ulp of a pair that nearly cancels. So a pair whose Gram entry
//     is below 2^-kGuardBits of |x_i| |x_j| (the Gram's diagonal, computed
//     in the same tiles; Cauchy-Schwarz bounds the sum of |products| by
//     it) is summed again by its lane from the staged rows, one product at
//     a time in fp32, in the CUDA-core kernel's order (0.9% of the pairs
//     of random features at 2^-10). On random features
//     the unguarded sums strayed beyond 1 bf16 ulp only below 2^-14
//     (dot_variants.py counts them), so the guard keeps a 16x margin.
//   K4: dX = dG X with M = 32 (features), K = 32, N = D in chunks of 16
//     columns; dG's A fragments are built in registers straight from the
//     staged dy triangle (entry (i, j) is dy[p(max, min)], 0 on the
//     diagonal and in the padding: bf16 values, so dG in bf16 is exact;
//     each lane's 32 source positions computed once a launch), X's B
//     fragments come from the same staged rows through ldmatrix.trans
//     (64 MMAs a sample at F = 27, D = 128); the appended row's cotangent
//     is added to feature 0 in fp32 before the one rounding, each chunk's
//     result overwrites the chunk of X it was computed from (no chunk
//     reads another's columns), and the sample's rows leave as 256-B runs
//     of 16-B stores.
// A CTA's tile is bound by its warps' instruction chains as much as by
// the bytes (four warps a CTA, one a scheduler): bulk copies and the
// per-launch index tables keep those chains short, and three CTAs a SM
// hide their latency (dot_variants.py times the choices; a third stage
// moved neither kernel beyond the calls' spread).
// mma.sync and not wgmma: a sample's products are 32 x 32 x D, and
// wgmma's 64-row tile would pair two samples' rows in one product and
// waste half of it (the cross-sample blocks) on top of its warpgroup
// synchronisation; the work is bound by the bytes either way, so the
// smaller instruction that fits one sample is the better one.
//
// Other shapes (float32, D not a multiple of 16, F > 32, rows that are
// not 16-B aligned) take the CUDA-core kernels: a CTA stages S samples'
// rows in shared memory (padded by 16 B), K2's threads take (sample,
// pair) tasks and K4's (sample, feature, column chunk) tasks, each
// accumulating in fp32 in sequential order and storing once.
//
// C interface (ctypes): detpu_dot_interact_prepare validates a call and
// writes its launch parameters into host memory (the features' table,
// the path, the grid); detpu_dot_interact_fwd_launch / _bwd_launch read
// them and launch with the per-call output (and dy) pointers and the
// stream. Each returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTable = 32;     // features passed one by one (pointer, stride)
constexpr int kMaxF = 255;     // the largest F (pair codes are 8 + 8 bits)

// Where feature f's row of sample b lies, in bytes: a table of (pointer,
// row stride) a feature, or one stacked tensor (base, feature stride, row
// stride).
struct Rows {
  const unsigned char* ptr[kTable];
  int64_t stride[kTable];
  const unsigned char* base;
  int64_t fstride, rstride;
  int table;
};

__device__ __forceinline__ const unsigned char* row_of(const Rows& r, int f,
                                                       int64_t b) {
  return r.table ? r.ptr[f] + b * r.stride[f]
                 : r.base + f * r.fstride + b * r.rstride;
}

// One launch's arguments, passed by value (__grid_constant__).
struct Args {
  Rows in;
  void* out;          // K2: [batch, P + D]; K4: rows at out_fs*f + out_rs*b
  const void* dy;     // K4: [batch, P + D], contiguous
  int64_t batch;
  int64_t out_fs, out_rs;  // K4's output strides (elements)
  int F, D;
  // CUDA-core path
  int S, Dpad;
  int64_t tile_bytes;
  // tensor-core path (bytes); a stage is [32 features][4 samples][D],
  // each feature's rows padded by 16 B
  int rs;              // a staged feature: 4 rows of D * 2, + 16
  int sample_bytes;    // a staged row, D * 2 (a sample's offset)
  int stage_bytes;     // a ring stage
  int dy_off;          // K4: the dy span's offset in a stage
  int warp_out_bytes;  // K2: a warp's output staging row
};

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

// ------------------------------------------------------ CUDA-core path

constexpr int kThreads = 256;
constexpr int kMaxSamples = 16;
constexpr int kSmemBudget = 48 * 1024;

template <typename Tr, bool VEC>
__device__ __forceinline__ void stage_rows(const Args& a,
                                           typename Tr::E* tile,
                                           int64_t s0, int ns) {
  using E = typename Tr::E;
  constexpr int VE = 16 / static_cast<int>(sizeof(E));
  const int F = a.F, D = a.D, Dpad = a.Dpad;
  if (VEC) {
    const int dv = D / VE;
    for (int t = threadIdx.x; t < ns * F * dv; t += blockDim.x) {
      const int r = t / dv, c = t % dv;
      const E* src = reinterpret_cast<const E*>(
          row_of(a.in, r % F, s0 + r / F));
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + c * VE));
      *reinterpret_cast<uint4*>(tile + r * Dpad + c * VE) = v;
    }
  } else {
    for (int t = threadIdx.x; t < ns * F * D; t += blockDim.x) {
      const int r = t / D, c = t % D;
      const E* src = reinterpret_cast<const E*>(
          row_of(a.in, r % F, s0 + r / F));
      tile[r * Dpad + c] = src[c];
    }
  }
}

template <typename Tr, bool VEC>
__global__ void __launch_bounds__(kThreads)
dot_interact_fwd_kernel(const __grid_constant__ Args a) {
  using E = typename Tr::E;
  constexpr int VE = 16 / static_cast<int>(sizeof(E));
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = a.F, D = a.D, Dpad = a.Dpad, S = a.S;
  E* tile = reinterpret_cast<E*>(smem);  // [S][F][Dpad]
  uint16_t* pairs = reinterpret_cast<uint16_t*>(
      smem + static_cast<size_t>(S) * F * Dpad * sizeof(E));
  const int P = F * (F - 1) / 2;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * S;
  const int64_t rem = a.batch - s0;
  const int ns = rem < S ? static_cast<int>(rem) : S;
  const int out_w = P + D;
  E* out = static_cast<E*>(a.out);

  // pair table in np.tril_indices(F, -1) order: p = i(i-1)/2 + j, j < i
  for (int t = threadIdx.x; t < F * F; t += blockDim.x) {
    const int i = t / F, j = t % F;
    if (j < i) pairs[i * (i - 1) / 2 + j] =
        static_cast<uint16_t>((i << 8) | j);
  }
  stage_rows<Tr, VEC>(a, tile, s0, ns);
  __syncthreads();

  for (int t = threadIdx.x; t < ns * P; t += blockDim.x) {
    const int s = t / P, p = t % P;
    const int i = pairs[p] >> 8, j = pairs[p] & 0xff;
    const E* ri = tile + (s * F + i) * Dpad;
    const E* rj = tile + (s * F + j) * Dpad;
    float acc = 0.f;
    if (VEC) {
      for (int k = 0; k < D; k += VE) {
        const uint4 x = *reinterpret_cast<const uint4*>(ri + k);
        const uint4 y = *reinterpret_cast<const uint4*>(rj + k);
        E ea[VE], eb[VE];
        memcpy(ea, &x, 16);
        memcpy(eb, &y, 16);
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          acc = fmaf(Tr::load(ea[e]), Tr::load(eb[e]), acc);
        }
      }
    } else {
      for (int k = 0; k < D; ++k) {
        acc = fmaf(Tr::load(ri[k]), Tr::load(rj[k]), acc);
      }
    }
    out[(s0 + s) * out_w + p] = Tr::store(acc);
  }
  // the bottom-MLP row (feature 0) follows the triangle
  for (int t = threadIdx.x; t < ns * D; t += blockDim.x) {
    const int s = t / D, d = t % D;
    out[(s0 + s) * out_w + P + d] = tile[(s * F) * Dpad + d];
  }
}

template <typename Tr, bool VEC>
__global__ void __launch_bounds__(kThreads)
dot_interact_bwd_kernel(const __grid_constant__ Args a) {
  using E = typename Tr::E;
  constexpr int VE = 16 / static_cast<int>(sizeof(E));
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = a.F, D = a.D, Dpad = a.Dpad, S = a.S;
  E* tile = reinterpret_cast<E*>(smem);                       // [S][F][Dpad]
  float* dg = reinterpret_cast<float*>(smem + a.tile_bytes);  // [S][F][F]
  uint16_t* pairs = reinterpret_cast<uint16_t*>(
      smem + a.tile_bytes + static_cast<size_t>(S) * F * F * sizeof(float));
  const int P = F * (F - 1) / 2;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * S;
  const int64_t rem = a.batch - s0;
  const int ns = rem < S ? static_cast<int>(rem) : S;
  const int out_w = P + D;
  const E* dy = static_cast<const E*>(a.dy);
  E* dfeats = static_cast<E*>(a.out);

  for (int t = threadIdx.x; t < F * F; t += blockDim.x) {
    const int i = t / F, j = t % F;
    if (j < i) pairs[i * (i - 1) / 2 + j] =
        static_cast<uint16_t>((i << 8) | j);
  }
  stage_rows<Tr, VEC>(a, tile, s0, ns);
  // zero diagonals, then the symmetric dG from each sample's triangle
  for (int t = threadIdx.x; t < ns * F; t += blockDim.x) {
    const int s = t / F, f = t % F;
    dg[(s * F + f) * F + f] = 0.f;
  }
  __syncthreads();  // the pair table is read below
  for (int t = threadIdx.x; t < ns * P; t += blockDim.x) {
    const int s = t / P, p = t % P;
    const int i = pairs[p] >> 8, j = pairs[p] & 0xff;
    const float v = Tr::load(dy[(s0 + s) * out_w + p]);
    dg[(s * F + i) * F + j] = v;
    dg[(s * F + j) * F + i] = v;
  }
  __syncthreads();

  if (VEC) {
    const int dv = D / VE;
    for (int t = threadIdx.x; t < ns * F * dv; t += blockDim.x) {
      const int s = t / (F * dv), r = t % (F * dv);
      const int f = r / dv, c = r % dv;
      float acc[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        // the appended bottom-MLP row's cotangent goes to feature 0
        acc[e] = f == 0 ? Tr::load(dy[(s0 + s) * out_w + P + c * VE + e])
                        : 0.f;
      }
      const float* coef = dg + (s * F + f) * F;
      const E* col = tile + s * F * Dpad + c * VE;
      for (int g = 0; g < F; ++g) {
        const float k = coef[g];
        const uint4 x = *reinterpret_cast<const uint4*>(col + g * Dpad);
        E ea[VE];
        memcpy(ea, &x, 16);
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[e] = fmaf(k, Tr::load(ea[e]), acc[e]);
      }
      E eo[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) eo[e] = Tr::store(acc[e]);
      uint4 o;
      memcpy(&o, eo, 16);
      *reinterpret_cast<uint4*>(dfeats + f * a.out_fs + (s0 + s) * a.out_rs
                                + c * VE) = o;
    }
  } else {
    for (int t = threadIdx.x; t < ns * F * D; t += blockDim.x) {
      const int s = t / (F * D), r = t % (F * D);
      const int f = r / D, d = r % D;
      float acc = f == 0 ? Tr::load(dy[(s0 + s) * out_w + P + d]) : 0.f;
      const float* coef = dg + (s * F + f) * F;
      for (int g = 0; g < F; ++g) {
        acc = fmaf(coef[g], Tr::load(tile[(s * F + g) * Dpad + d]), acc);
      }
      dfeats[f * a.out_fs + (s0 + s) * a.out_rs + d] = Tr::store(acc);
    }
  }
}

// ---------------------------------------------------- tensor-core path

constexpr int kTcWarps = 4;     // a tile's samples: one warp a sample
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = 32;     // staged features a stage (F padded to 32)
constexpr int kStages = 2;      // the ring's stages
constexpr int kTcCtas = 3;      // persistent CTAs a SM, at most
constexpr int kGuardBits = 10;  // K2 sums a pair again below 2^-this
constexpr int kNormBytes = kTcRows * 4;  // a warp's Gram diagonal (fp32)
constexpr int kSmemMax = 227 * 1024;
constexpr int kBarBytes = 128;  // the ring's mbarriers, ahead of the ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A bulk copy (TMA) of `bytes` (a multiple of 16, both addresses 16-B
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// One arrival on `bar` that also expects `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Order this thread's earlier (and, after a barrier, its CTA's) generic
// accesses to shared memory before its later bulk copies into it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(const void* p,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// Zero the padding rows F..31 of every stage (the loads never write
// them).
__device__ __forceinline__ void zero_padding(const Args& a,
                                             unsigned char* ring,
                                             int stages) {
  const int per = (kTcRows - a.F) * (a.rs >> 4);  // 16-B chunks a stage
  for (int i = threadIdx.x; i < stages * per; i += blockDim.x) {
    const int st = i / per, r = i - st * per;
    *reinterpret_cast<uint4*>(ring + st * a.stage_bytes + a.F * a.rs +
                              16 * r) = make_uint4(0, 0, 0, 0);
  }
}

// Start tile t's loads into a stage: one arrival expecting its bytes,
// then the bulk copies: the tile's rows of a feature whose rows are
// contiguous in one copy, else one copy a row, each by its own thread
// (F <= 32 on this path); for K4 also the 16-B
// chunks covering the tile's dy rows (a contiguous span) in one copy,
// and the bytes of a chunk that runs past the tensor's end copied element
// by element (they are read after a later block barrier).
__device__ __forceinline__ void load_tile(const Args& a,
                                          unsigned char* stage,
                                          uint64_t* bar, int64_t t,
                                          bool with_dy) {
  const int64_t s0 = t * kTcWarps;
  const int64_t left = a.batch - s0;
  const int ns = left < kTcWarps ? static_cast<int>(left) : kTcWarps;
  const uint32_t row = 2 * a.D;
  int64_t lo = 0, end = 0, hi = 0, total = 0;
  if (with_dy) {
    const int64_t ow2 =
        2 * (static_cast<int64_t>(a.F) * (a.F - 1) / 2 + a.D);
    total = a.batch * ow2;
    lo = s0 * ow2 & ~static_cast<int64_t>(15);
    hi = ((s0 + ns) * ow2 + 15) & ~static_cast<int64_t>(15);
    const int64_t whole = total & ~static_cast<int64_t>(15);
    end = hi < whole ? hi : whole;
  }
  if (threadIdx.x == 0) {
    mbar_expect(bar, static_cast<uint32_t>(ns * a.F * row + (end - lo)));
  }
  // thread (s, f) = (i / F, i % F): F * kTcWarps <= the block's threads
  const int s = threadIdx.x / a.F, f = threadIdx.x - s * a.F;
  if (s < ns) {
    unsigned char* dst = stage + f * a.rs;
    if (a.in.table && a.in.stride[f] == row) {
      if (s == 0) bulk_load(dst, row_of(a.in, f, s0), ns * row, bar);
    } else {
      bulk_load(dst + s * row, row_of(a.in, f, s0 + s), row, bar);
    }
  }
  if (with_dy && threadIdx.x == 32) {
    const unsigned char* src = static_cast<const unsigned char*>(a.dy);
    unsigned char* dst = stage + a.dy_off;
    if (end > lo) {
      bulk_load(dst, src + lo, static_cast<uint32_t>(end - lo), bar);
    }
    for (int64_t k = end; k < total && k < hi; k += 2) {
      *reinterpret_cast<uint16_t*>(dst + (k - lo)) =
          *reinterpret_cast<const uint16_t*>(src + k);
    }
  }
}

// The Gram tiles a sample multiplies: tile t covers rows 16 tm(t) +
// (0..15) and columns 8 tn(t) + (0..7); entry e of a lane (g, c) is row
// g + 8 (e >> 1), column 2c + (e & 1) of its tile.
__host__ __device__ constexpr int tile_m(int t) { return t < 2 ? 0 : 1; }
__host__ __device__ constexpr int tile_n(int t) { return t < 2 ? t : t - 2; }

__device__ __forceinline__ int entry_row(int t, int e, int lane) {
  return 16 * tile_m(t) + (lane >> 2) + 8 * (e >> 1);
}

__device__ __forceinline__ int entry_col(int t, int e, int lane) {
  return 8 * tile_n(t) + 2 * (lane & 3) + (e & 1);
}

// Where each of a lane's 24 Gram accumulator entries goes: its output
// position (tril order) in the strict lower triangle, -2 - i for the
// diagonal entry (i, i) of a feature, -1 for the rest.
struct GramSlots {
  int pos[6][4];
};

__device__ __forceinline__ GramSlots gram_slots(int F, int lane) {
  GramSlots s;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = entry_row(t, e, lane), j = entry_col(t, e, lane);
      s.pos[t][e] = i >= F ? -1
                    : j < i ? i * (i - 1) / 2 + j
                    : j == i ? -2 - i : -1;
    }
  }
  return s;
}

// The pair (i, j) summed again, one product at a time in fp32 from the
// staged rows, in the CUDA-core kernel's order.
__device__ __forceinline__ float dot_in_order(const unsigned char* xs, int rs,
                                              int D, int i, int j) {
  const unsigned char* ri = xs + i * rs;
  const unsigned char* rj = xs + j * rs;
  float acc = 0.f;
#pragma unroll 4
  for (int k = 0; k < 2 * D; k += 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(ri + k);
    const uint4 y = *reinterpret_cast<const uint4*>(rj + k);
    const uint32_t xw[4] = {x.x, x.y, x.z, x.w};
    const uint32_t yw[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      acc = fmaf(__uint_as_float(xw[w] << 16), __uint_as_float(yw[w] << 16),
                 acc);
      acc = fmaf(__uint_as_float(xw[w] & 0xffff0000u),
                 __uint_as_float(yw[w] & 0xffff0000u), acc);
    }
  }
  return acc;
}

// K2 for one sample (one warp): the lower-triangle Gram tiles on the
// tensor cores, the entries rounded once into the warp's staging row,
// feature 0's row appended, the row written out.
__device__ __forceinline__ void gram_sample(const Args& a,
                                            const unsigned char* xs,
                                            unsigned char* wout, int64_t b,
                                            int lane, const GramSlots& sl) {
  const int F = a.F, D = a.D, rs = a.rs;
  const int P = F * (F - 1) / 2, ow = P + D;
  // the tiles that hold part of the strict lower triangle or of the
  // features' diagonal (the guard's norms)
  const bool two = F > 16;      // rows 16..31 hold features
  const bool t01 = F >= 9;      // (0-15, 8-15)
  const bool t12 = F >= 17;     // (16-31, 16-23)
  const bool t13 = F >= 25;     // (16-31, 24-31)
  float acc[6][4];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
  // lane -> the row and 8-column half it addresses in an x4 ldmatrix
  const unsigned char* a0p = xs + (lane & 15) * rs + ((lane >> 4) << 4);
  const unsigned char* a1p = a0p + 16 * rs;
  for (int k = 0; k < D; k += 16) {
    uint32_t x0[4], x1[4];
    ldsm_x4(a0p + 2 * k, x0);
    // rows 0-15 against column blocks 0-7 ({x0[0], x0[2]}) and 8-15
    // ({x0[1], x0[3]}): the A fragment's halves are the B fragments
    mma_bf16(acc[0], x0, x0[0], x0[2]);
    if (t01) mma_bf16(acc[1], x0, x0[1], x0[3]);
    if (two) {
      ldsm_x4(a1p + 2 * k, x1);
      mma_bf16(acc[2], x1, x0[0], x0[2]);
      mma_bf16(acc[3], x1, x0[1], x0[3]);
      if (t12) mma_bf16(acc[4], x1, x1[0], x1[2]);
      if (t13) mma_bf16(acc[5], x1, x1[1], x1[3]);
    }
  }
  // the warp's staging row sits at the output row's address mod 16, so
  // the row's 16-B-aligned body moves as 16-B loads and stores
  uint16_t* gout = static_cast<uint16_t*>(a.out) + b * ow;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(gout) & 15);
  uint16_t* o = reinterpret_cast<uint16_t*>(wout + mis);
  float* norm = reinterpret_cast<float*>(wout + a.warp_out_bytes -
                                         kNormBytes);
#pragma unroll
  for (int t = 0; t < 6; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = sl.pos[t][e];
      if (p >= 0) {
        o[p] = bf16_bits(acc[t][e]);
      } else if (p < -1) {
        norm[-2 - p] = acc[t][e];
      }
    }
  }
  const uint16_t* row0 = reinterpret_cast<const uint16_t*>(xs);
  for (int d = lane; d < D; d += 32) o[P + d] = row0[d];
  __syncwarp();
  // the cancellation guard: G_ij^2 < 2^-2kGuardBits G_ii G_jj
  constexpr float kGuard = 1.0f / (1ull << (2 * kGuardBits));
  uint32_t again = 0;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (sl.pos[t][e] >= 0) {
        const float v = acc[t][e];
        const float n = norm[entry_row(t, e, lane)] *
                        norm[entry_col(t, e, lane)];
        if (v * v < kGuard * n) again |= 1u << (4 * t + e);
      }
    }
  }
  while (again) {
    const int k = __ffs(again) - 1;
    again &= again - 1;
    const int i = entry_row(k >> 2, k & 3, lane);
    const int j = entry_col(k >> 2, k & 3, lane);
    o[i * (i - 1) / 2 + j] = bf16_bits(dot_in_order(xs, rs, D, i, j));
  }
  __syncwarp();
  const int head_raw = ((16 - mis) & 15) >> 1;
  const int head = head_raw < ow ? head_raw : ow;
  const int body = (ow - head) >> 3;
  const int tail0 = head + 8 * body;
  if (lane < head) gout[lane] = o[lane];
  for (int q = lane; q < body; q += 32) {
    reinterpret_cast<uint4*>(gout + head)[q] =
        reinterpret_cast<const uint4*>(o + head)[q];
  }
  if (tail0 + lane < ow) gout[tail0 + lane] = o[tail0 + lane];
  __syncwarp();
}

// Where each half of a lane's dG A-fragment registers comes from in the
// sample's dy triangle: idx[m][ks][r] packs two 16-bit indices (entries
// (16m + g + 8 (r & 1), 16 ks + 2c + 8 (r >> 1) + {0, 1})), 0xffff for a
// zero (the diagonal and the padding).
struct DgSlots {
  uint32_t idx[2][2][4];
};

__device__ __forceinline__ DgSlots dg_slots(int F, int lane) {
  DgSlots s;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 16 * m + g + 8 * (r & 1);
        uint32_t v = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 16 * ks + 2 * c + 8 * (r >> 1) + h;
          const int hi = i > j ? i : j, lo = i > j ? j : i;
          const uint32_t p = i != j && i < F && j < F
                                 ? static_cast<uint32_t>(hi * (hi - 1) / 2 + lo)
                                 : 0xffffu;
          v |= p << (16 * h);
        }
        s.idx[m][ks][r] = v;
      }
    }
  }
  return s;
}

// K4 for one sample (one warp): dX = dG X on the tensor cores, 16 columns
// at a time, each chunk's rounded result written over the chunk of X it
// came from; then the sample's F rows leave as 16-B stores.
__device__ __forceinline__ void grad_sample(const Args& a, unsigned char* xs,
                                            const uint16_t* dys, int64_t b,
                                            int lane, const DgSlots& sl) {
  const int F = a.F, D = a.D, rs = a.rs;
  const int P = F * (F - 1) / 2;
  const int mt = F > 16 ? 2 : 1;  // 16-row blocks of features (and of K)
  const int g = lane >> 2, c = lane & 3;
  // dG's A fragments from the staged triangle
  uint32_t af[2][2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t ix = sl.idx[m][ks][r];
        const uint32_t lo = ix & 0xffffu, hi = ix >> 16;
        af[m][ks][r] = (lo != 0xffffu ? dys[lo] : 0u) |
                       (hi != 0xffffu ? static_cast<uint32_t>(dys[hi]) << 16
                                      : 0u);
      }
    }
  }
  const unsigned char* bp = xs + (lane & 15) * rs + ((lane >> 4) << 4);
  for (int n0 = 0; n0 < D; n0 += 16) {
    float acc[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;
      }
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if (ks < mt) {
        // X rows 16 ks .. 16 ks + 15, columns n0 .. n0 + 15, transposed:
        // {b[0], b[1]} is columns n0..n0+7's B fragment, {b[2], b[3]}
        // columns n0+8..n0+15's
        uint32_t bf[4];
        ldsm_x4_trans(bp + 16 * ks * rs + 2 * n0, bf);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m < mt) {
            mma_bf16(acc[m][0], af[m][ks], bf[0], bf[1]);
            mma_bf16(acc[m][1], af[m][ks], bf[2], bf[3]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 16 * m + g + 8 * h;
          const int d = n0 + 8 * q + 2 * c;
          float v0 = acc[m][q][2 * h], v1 = acc[m][q][2 * h + 1];
          if (f == 0) {  // the appended row's cotangent, in fp32
            v0 += bf16_float(dys[P + d]);
            v1 += bf16_float(dys[P + d + 1]);
          }
          if (m < mt && f < F) {
            *reinterpret_cast<uint32_t*>(xs + f * rs + 2 * d) =
                static_cast<uint32_t>(bf16_bits(v0)) |
                (static_cast<uint32_t>(bf16_bits(v1)) << 16);
          }
        }
      }
    }
  }
  __syncwarp();
  uint16_t* out = static_cast<uint16_t*>(a.out);
  const int cpr = D >> 3;
  for (int i = lane; i < F * cpr; i += 32) {
    const int f = i / cpr, ch = i - f * cpr;
    *reinterpret_cast<uint4*>(out + f * a.out_fs + b * a.out_rs + 8 * ch) =
        *reinterpret_cast<const uint4*>(xs + f * rs + 16 * ch);
  }
}

// The ring both kernels walk: kStages stages, each with its mbarrier;
// tiles blockIdx.x, + gridDim.x, ...; tile t waits for its stage's
// copies, is multiplied (`work(stage, t)`), then after a block barrier
// (every warp done with the stage) the stage is refilled with tile t +
// kStages grids on.
template <typename Work>
__device__ __forceinline__ void walk_ring(const Args& a, unsigned char* smem,
                                          bool with_dy, Work work) {
  const int64_t tiles = (a.batch + kTcWarps - 1) / kTcWarps;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarBytes;
  zero_padding(a, ring, kStages);
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) mbar_init(bars + k, 1);
    fence_barrier_init();
  }
  __syncthreads();
  fence_proxy_async();
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    const int64_t t = blockIdx.x + static_cast<int64_t>(k) * gridDim.x;
    if (t < tiles) {
      load_tile(a, ring + k * a.stage_bytes, bars + k, t, with_dy);
    }
  }
  __syncthreads();  // a dy tail copied by hand is seen
  uint32_t phases = 0;
  int cur = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    mbar_wait(bars + cur, (phases >> cur) & 1u);
    phases ^= 1u << cur;
    unsigned char* stage = ring + cur * a.stage_bytes;
    work(stage, t);
    __syncthreads();  // every warp is done with the stage
    const int64_t next = t + static_cast<int64_t>(kStages) * gridDim.x;
    if (next < tiles) {
      fence_proxy_async();
      load_tile(a, stage, bars + cur, next, with_dy);
    }
    cur = cur + 1 == kStages ? 0 : cur + 1;
  }
}

__global__ void __launch_bounds__(kTcThreads, 2)
dot_interact_fwd_tc(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wout = smem + kBarBytes + kStages * a.stage_bytes +
                        warp * a.warp_out_bytes;
  const GramSlots slots = gram_slots(a.F, lane);
  walk_ring(a, smem, false, [&](unsigned char* stage, int64_t t) {
    const int64_t b = t * kTcWarps + warp;
    if (b < a.batch) {
      gram_sample(a, stage + warp * a.sample_bytes, wout, b, lane, slots);
    }
  });
}

__global__ void __launch_bounds__(kTcThreads, 2)
dot_interact_bwd_tc(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t ow2 = 2 * (static_cast<int64_t>(a.F) * (a.F - 1) / 2 + a.D);
  const DgSlots slots = dg_slots(a.F, lane);
  walk_ring(a, smem, true, [&](unsigned char* stage, int64_t t) {
    const int64_t b = t * kTcWarps + warp;
    if (b < a.batch) {
      const int64_t s0 = t * kTcWarps;
      const uint16_t* dys = reinterpret_cast<const uint16_t*>(
          stage + a.dy_off + ((s0 * ow2) & 15) + warp * ow2);
      grad_sample(a, stage + warp * a.sample_bytes, dys, b, lane, slots);
    }
  });
}

// ------------------------------------------------------------ the host

enum Kind {
  kNone = 0,
  kCoreF32,
  kCoreF32Vec,
  kCoreBf16,
  kCoreBf16Vec,
  kTc,  // the tensor-core kernels
};

struct Launch {
  int kind;
  unsigned grid;
  int threads;
  int smem;
};

struct Prepared {
  Args fa, ba;  // K2's and K4's arguments
  Launch fwd, bwd;
  int dy_aligned;
};

// A CUDA-core launch: S samples a CTA, their rows padded in shared memory.
void core_plan(bool bwd, bool vec, int esize, Args* a, Launch* l) {
  const int F = a->F, D = a->D;
  const int VE = 16 / esize;
  const int Dpad = vec ? D + VE : D + 1;
  const size_t per_tile = static_cast<size_t>(F) * Dpad * esize;
  const size_t per_dg = bwd ? static_cast<size_t>(F) * F * sizeof(float)
                            : 0;
  const size_t pair_bytes = static_cast<size_t>(F) * (F - 1) / 2 * 2;
  int S = static_cast<int>((kSmemBudget - pair_bytes - 16) /
                           (per_tile + per_dg));
  S = S < 1 ? 1 : (S > kMaxSamples ? kMaxSamples : S);
  const size_t tile_bytes = (S * per_tile + 15) / 16 * 16;
  a->S = S;
  a->Dpad = Dpad;
  a->tile_bytes = static_cast<int64_t>(tile_bytes);
  l->kind = esize == 4 ? (vec ? kCoreF32Vec : kCoreF32)
                       : (vec ? kCoreBf16Vec : kCoreBf16);
  l->threads = kThreads;
  l->smem = static_cast<int>(tile_bytes + S * per_dg + pair_bytes);
  const int64_t blocks = (a->batch + S - 1) / S;
  l->grid = blocks > 0x7fffffffLL ? 0u : static_cast<unsigned>(blocks);
}

template <typename K>
cudaError_t raise_smem(K kernel, int smem) {
  if (smem <= kSmemBudget) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// Persistent CTAs: as many a SM as fit, at most kTcCtas, at most one a
// tile.
template <typename K>
cudaError_t persistent_grid(K kernel, int smem, int64_t tiles,
                            unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = raise_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kTcThreads, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t cap =
      static_cast<int64_t>(sms) * (per_sm < kTcCtas ? per_sm : kTcCtas);
  *grid = static_cast<unsigned>(tiles < cap ? tiles : cap);
  return cudaSuccess;
}

// A tensor-core launch: the ring and `fixed` bytes more in shared memory;
// kind kNone if they do not fit.
cudaError_t tc_plan(bool bwd, int64_t fixed, const Args& a, Launch* l) {
  const int64_t smem =
      kBarBytes + kStages * static_cast<int64_t>(a.stage_bytes) + fixed;
  if (smem > kSmemMax) {
    l->kind = kNone;
    return cudaSuccess;
  }
  l->kind = kTc;
  l->threads = kTcThreads;
  l->smem = static_cast<int>(smem);
  const int64_t tiles = (a.batch + kTcWarps - 1) / kTcWarps;
  return bwd ? persistent_grid(dot_interact_bwd_tc, l->smem, tiles, &l->grid)
             : persistent_grid(dot_interact_fwd_tc, l->smem, tiles, &l->grid);
}

template <typename Tr, bool VEC>
cudaError_t launch_core(const Launch& l, const Args& a, bool bwd,
                        cudaStream_t s) {
  if (bwd) {
    auto k = dot_interact_bwd_kernel<Tr, VEC>;
    cudaError_t err = raise_smem(k, l.smem);
    if (err != cudaSuccess) return err;
    k<<<l.grid, l.threads, l.smem, s>>>(a);
  } else {
    auto k = dot_interact_fwd_kernel<Tr, VEC>;
    cudaError_t err = raise_smem(k, l.smem);
    if (err != cudaSuccess) return err;
    k<<<l.grid, l.threads, l.smem, s>>>(a);
  }
  return cudaGetLastError();
}

cudaError_t launch(const Launch& l, const Args& a, bool bwd,
                   cudaStream_t s) {
  if (l.grid == 0) return cudaErrorInvalidConfiguration;
  switch (l.kind) {
    case kCoreF32: return launch_core<F32, false>(l, a, bwd, s);
    case kCoreF32Vec: return launch_core<F32, true>(l, a, bwd, s);
    case kCoreBf16: return launch_core<BF16, false>(l, a, bwd, s);
    case kCoreBf16Vec: return launch_core<BF16, true>(l, a, bwd, s);
    case kTc:
      if (bwd) {
        dot_interact_bwd_tc<<<l.grid, l.threads, l.smem, s>>>(a);
      } else {
        dot_interact_fwd_tc<<<l.grid, l.threads, l.smem, s>>>(a);
      }
      return cudaGetLastError();
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int64_t detpu_dot_interact_prepared_bytes() {
  return static_cast<int64_t>(sizeof(Prepared));
}

// Validate one call and write its launches' parameters into `prepared`
// (detpu_dot_interact_prepared_bytes() bytes of host memory).
//   ptrs, strides: host int64 [n_table]: each feature's address and row
//     stride in elements (the table form, n_table == F <= 32); or, with
//     n_table == 0, ptrs[0] / strides[0] one stacked tensor's address and
//     row stride and fstride its feature stride (elements);
//   dtype: 0 = float32, 1 = bfloat16;
//   out_fs, out_rs: K4's output feature and row strides (elements);
//   dy_aligned: K4's dy address is a multiple of 16.
extern "C" int detpu_dot_interact_prepare(
    const int64_t* ptrs, const int64_t* strides, int n_table,
    int64_t fstride, int64_t batch, int F, int D, int dtype, int64_t out_fs,
    int64_t out_rs, int dy_aligned, void* prepared) {
  if (F < 2 || F > kMaxF || D <= 0 || batch < 0 ||
      (dtype != 0 && dtype != 1) || prepared == nullptr ||
      (n_table != 0 && n_table != F) || n_table > kTable ||
      ptrs == nullptr || strides == nullptr) {
    return cudaErrorInvalidValue;
  }
  Prepared* p = static_cast<Prepared*>(prepared);
  memset(p, 0, sizeof(Prepared));
  Args& a = p->fa;
  const int esize = dtype == 0 ? 4 : 2;
  a.batch = batch;
  a.F = F;
  a.D = D;
  a.out_fs = out_fs;
  a.out_rs = out_rs;
  a.in.table = n_table != 0;
  // every row's 16-B alignment decides the vector paths
  bool aligned = true;
  if (a.in.table) {
    for (int f = 0; f < F; ++f) {
      a.in.ptr[f] = reinterpret_cast<const unsigned char*>(ptrs[f]);
      a.in.stride[f] = strides[f] * esize;
      aligned = aligned && ptrs[f] % 16 == 0 && a.in.stride[f] % 16 == 0;
    }
  } else {
    a.in.base = reinterpret_cast<const unsigned char*>(ptrs[0]);
    a.in.rstride = strides[0] * esize;
    a.in.fstride = fstride * esize;
    aligned = ptrs[0] % 16 == 0 && a.in.rstride % 16 == 0 &&
              a.in.fstride % 16 == 0;
  }
  const bool out_aligned = (out_fs * esize) % 16 == 0 &&
                           (out_rs * esize) % 16 == 0;
  p->dy_aligned = dy_aligned != 0;
  p->ba = a;
  if (batch == 0) return cudaSuccess;
  const int VE = 16 / esize;
  const bool vec = D % VE == 0 && aligned;
  cudaError_t err = cudaSuccess;
  if (dtype == 1 && F <= kTable && D % 16 == 0 && aligned) {
    const int P = F * (F - 1) / 2;
    a.sample_bytes = 2 * D;
    a.rs = kTcWarps * a.sample_bytes + 16;
    a.stage_bytes = kTcRows * a.rs;
    a.warp_out_bytes = (2 * (P + D) + 15) / 16 * 16 + 16 + kNormBytes;
    err = tc_plan(false, kTcWarps * static_cast<int64_t>(a.warp_out_bytes),
                  a, &p->fwd);
    if (err != cudaSuccess) return err;
    if (out_aligned && p->dy_aligned) {
      Args& b = p->ba;
      b.rs = a.rs;
      b.sample_bytes = a.sample_bytes;
      b.dy_off = a.stage_bytes;
      // the 16-B chunks covering a tile's dy rows, wherever they start
      b.stage_bytes = a.stage_bytes + (kTcWarps * 2 * (P + D) + 31) / 16 * 16;
      err = tc_plan(true, 0, b, &p->bwd);
      if (err != cudaSuccess) return err;
    }
  }
  if (p->fwd.kind == kNone) core_plan(false, vec, esize, &a, &p->fwd);
  if (p->bwd.kind == kNone) {
    core_plan(true, vec && out_aligned, esize, &p->ba, &p->bwd);
  }
  if (p->fwd.grid == 0 || p->bwd.grid == 0) {
    return cudaErrorInvalidConfiguration;
  }
  return cudaSuccess;
}

// 1 where K2 (bit 0) and K4 (bit 1) of a prepared call run on the tensor
// cores.
extern "C" int detpu_dot_interact_paths(const void* prepared) {
  const Prepared* p = static_cast<const Prepared*>(prepared);
  return (p->fwd.kind == kTc ? 1 : 0) | (p->bwd.kind == kTc ? 2 : 0);
}

// K2: out [batch, F(F-1)/2 + D] contiguous, in the inputs' dtype.
extern "C" int detpu_dot_interact_fwd_launch(const void* prepared, void* out,
                                             void* stream) {
  const Prepared* p = static_cast<const Prepared*>(prepared);
  if (p == nullptr || out == nullptr ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (p->fa.batch == 0) return cudaSuccess;
  Args a = p->fa;
  a.out = out;
  return launch(p->fwd, a, false, static_cast<cudaStream_t>(stream));
}

// K4: dy [batch, F(F-1)/2 + D] contiguous; dfeats written at out_fs * f +
// out_rs * b (elements).
extern "C" int detpu_dot_interact_bwd_launch(const void* prepared,
                                             const void* dy, void* dfeats,
                                             void* stream) {
  const Prepared* p = static_cast<const Prepared*>(prepared);
  if (p == nullptr || dy == nullptr || dfeats == nullptr ||
      reinterpret_cast<uintptr_t>(dfeats) % 16 != 0 ||
      (p->dy_aligned && reinterpret_cast<uintptr_t>(dy) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  if (p->ba.batch == 0) return cudaSuccess;
  Args a = p->ba;
  a.dy = dy;
  a.out = dfeats;
  return launch(p->bwd, a, true, static_cast<cudaStream_t>(stream));
}
