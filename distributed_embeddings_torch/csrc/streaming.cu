// K16 and K17: the streaming vocabulary's slot-map remap with admission
// and eviction, and its guard-gated commit, for Hopper (sm_90a).
//
// K16 replaces the XLA-lowered body of
//   distributed_embeddings_tpu/parallel/streaming.py:remap_width (:265),
// which parallel/dist_embedding.py:_streaming_remap (:1418) runs once per
// width slab and step over the external ids of the streaming tables'
// slots (ext [n] int32 or int64, live [n] bool, and per position the
// owning table's capacity, bucket count, table id and slab row offset).
// Per position, in uint32 arithmetic:
//   u = uint32(ext ^ (ext >> 32)) for int64 ids, uint32(ext) for int32;
//   mix(m) = avalanche(u ^ uint32(tid) * H_SALT, m);
//   fp = mix(H_FP) >> 1 (31 bits, also the admission sketch's key);
//   slot = mix(H_SLOT) % max(cap, 1), bucket = mix(H_BUCKET) % max(nb, 1);
//   row = roff + slot, occ = slot_fp[live ? row : 0];
//   hit = live && occ == fp; local = hit ? slot : cap + bucket.
// detpu_stream_hash writes local (ext's low word where not live) and, for
// the update, fp, the live mask, a flag byte and the row. The wrapper
// (ops/streaming.py) then folds fp into the STAGED copy of the sketch
// with K13 (ops/sketch.py:cms_update) and detpu_stream_stage finishes:
//   est = the count-min estimate of fp in the staged sketch (K14's query,
//     fused);
//   claim = live && !hit && est >= admit_min_count
//           && (occ == SLOT_FREE || est >= slot_freq[row] + evict_margin);
//   one winner per claimed row, the lexicographic max of (est, fp, pos):
//     a 64-bit atomicMax of (est << 31) | fp into best_key[row], then a
//     32-bit atomicMax of pos among the claims that hold the row's best
//     key into best_pos[row]; the winner resets both entries, so the
//     scratch ([rows_cap] each, kept by the wrapper) is 0 and -1 between
//     launches and a launch touches O(n) of it, never O(rows_cap);
//   scrub_rows = winner ? row : rows_cap, hit_rows = hit ? row : rows_cap,
//   and the four counts (admitted, evicted = winners on a non-free slot,
//   bucket_ids = live && !hit, hit_ids) exact in int64.
// JAX resolves the winner with three rows_cap-long max-scatters filled
// with -1 every step; the results are the same values.
//
// K17 replaces the scatters of streaming.py:commit (:366-462), gated by
// the device verdict `enable` (never read on the host; null = commit):
//   per claimed row, each element x of the slab row becomes x + (-x) in
//   the slab dtype (+0 for finite x, NaN otherwise, as JAX's
//   slab.at[rows].add(-cur)), each element c of a slab-shaped optimizer
//   leaf becomes (c + (-c)) + fill in the leaf dtype (JAX's zero-then-add
//   reset to fresh_row_fill), and slot_fp[row] = fp, slot_freq[row] =
//   est; then, in a second launch so a row both hit and claimed takes the
//   set before the max, slot_freq[hit_row] = max(., est) (atomicMax);
//   then the staged sketch is copied into the carried one, the counts
//   rounded once to float32 are added to the step totals (0 when not
//   enabled), and on the step's last width the totals are added to the
//   cumulative counters and `steps` advances by enable.
//
// Everything but the float resets is integer arithmetic, and the resets
// are single IEEE adds, so both kernels equal their plain versions bit
// for bit (a NaN is a NaN). Bound: bytes (the id stream, the gathers of
// slot_fp, slot_freq and the sketch words, the outputs; K17 the claimed
// rows and the n-long row lists).
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kHSlot = 0x7FEB352Du;
constexpr uint32_t kHBucket = 0x846CA68Bu;
constexpr uint32_t kHFp = 0x9E3779B1u;
constexpr uint32_t kHSalt = 0x85EBCA77u;
constexpr uint32_t kAvalanche = 0x2C1B3C6Du;
constexpr int kSlotFree = -1;
constexpr int kThreads = 256;
constexpr int kMaxLeaves = 4;

constexpr uint8_t kLive = 1;
constexpr uint8_t kHit = 2;
constexpr uint8_t kFree = 4;
constexpr uint8_t kClaim = 8;

// The count-min sketch's column hash and query: the same as K14's
// (sketch.cu), so the fused estimate equals ops/sketch.py:cms_query.
__constant__ uint32_t kMults[8] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                   0x27D4EB2Fu, 0x165667B1u, 0xD3A2646Du,
                                   0xFD7046C5u, 0xB55A4F09u};
constexpr uint32_t kMix = 0x2C1B3C6Du;

__device__ __forceinline__ uint32_t column(uint32_t id, int d,
                                           uint32_t buckets) {
  uint32_t h = id * (kMults[d & 7] ^ static_cast<uint32_t>(d));
  h ^= h >> 15;
  h *= kMix;
  h ^= h >> 13;
  return h % buckets;
}

// Count-min estimate of a key (keys are fingerprints, never negative).
__device__ __forceinline__ int query(const int* __restrict__ cms, int depth,
                                     int buckets, int key) {
  const uint32_t u = static_cast<uint32_t>(key < 0 ? 0 : key);
  int est = 0x7fffffff;
  for (int d = 0; d < depth; ++d) {
    const int v = cms[static_cast<int64_t>(d) * buckets +
                      column(u, d, static_cast<uint32_t>(buckets))];
    est = v < est ? v : est;
  }
  return est;
}

__device__ __forceinline__ uint32_t mix(uint32_t u, uint32_t salt,
                                        uint32_t mult) {
  uint32_t h = u ^ salt;
  h *= mult;
  h ^= h >> 15;
  h *= kAvalanche;
  h ^= h >> 13;
  return h;
}

__device__ __forceinline__ unsigned long long claim_key(int est, int fp) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(est))
          << 31) | static_cast<uint32_t>(fp);
}

// ------------------------------------------------------------------ K16

__global__ void __launch_bounds__(kThreads)
stream_hash_kernel(const void* __restrict__ ext, int is64,
                   const uint8_t* __restrict__ live,
                   const int* __restrict__ cap, const int* __restrict__ nb,
                   const int* __restrict__ tid,
                   const int* __restrict__ roff,
                   const int* __restrict__ slot_fp, int64_t n,
                   int* __restrict__ local_rows, int* __restrict__ key,
                   uint8_t* __restrict__ live_out,
                   uint8_t* __restrict__ flags, int* __restrict__ rowc) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  long long x;
  uint32_t u;
  if (is64) {
    x = static_cast<const long long*>(ext)[i];
    u = static_cast<uint32_t>(static_cast<unsigned long long>(x ^ (x >> 32)));
  } else {
    x = static_cast<const int*>(ext)[i];
    u = static_cast<uint32_t>(x);
  }
  const bool lv = live[i] != 0 && x >= 0;
  const uint32_t salt = static_cast<uint32_t>(tid[i]) * kHSalt;
  const int fp = static_cast<int>(mix(u, salt, kHFp) >> 1);
  const int c = cap[i];
  const int b = nb[i];
  const uint32_t cs = static_cast<uint32_t>(c > 1 ? c : 1);
  const uint32_t bs = static_cast<uint32_t>(b > 1 ? b : 1);
  const int slot = static_cast<int>(mix(u, salt, kHSlot) % cs);
  const int bucket = static_cast<int>(mix(u, salt, kHBucket) % bs);
  const int row = static_cast<int>(static_cast<uint32_t>(roff[i]) +
                                   static_cast<uint32_t>(slot));
  const int r = lv ? row : 0;
  const int occ = slot_fp[r];
  const bool hit = lv && occ == fp;
  const int local = hit ? slot : static_cast<int>(static_cast<uint32_t>(c) +
                                                  static_cast<uint32_t>(bucket));
  local_rows[i] = lv ? local : static_cast<int>(static_cast<uint32_t>(
                                   static_cast<unsigned long long>(x)));
  if (key != nullptr) {
    key[i] = fp;
    live_out[i] = lv ? 1 : 0;
    flags[i] = static_cast<uint8_t>((lv ? kLive : 0) | (hit ? kHit : 0) |
                                    (occ == kSlotFree ? kFree : 0));
    rowc[i] = r;
  }
}

__global__ void __launch_bounds__(kThreads)
stream_claim_kernel(const int* __restrict__ cms, int depth, int buckets,
                    const int* __restrict__ key,
                    const int* __restrict__ rowc,
                    const int* __restrict__ slot_freq, int admit,
                    int margin, int64_t n, int* __restrict__ est,
                    uint8_t* __restrict__ flags,
                    unsigned long long* __restrict__ best_key) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int k = key[i];
  const int e = query(cms, depth, buckets, k);
  est[i] = e;
  const uint8_t f = flags[i];
  if ((f & kLive) && !(f & kHit) && e >= admit) {
    const int r = rowc[i];
    // int32 wrap, as JAX's slot_freq + evict_margin
    const int thr = static_cast<int>(static_cast<uint32_t>(slot_freq[r]) +
                                     static_cast<uint32_t>(margin));
    if ((f & kFree) || e >= thr) {
      flags[i] = f | kClaim;
      atomicMax(best_key + r, claim_key(e, k));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
stream_claim_pos_kernel(const int* __restrict__ key,
                        const int* __restrict__ est,
                        const uint8_t* __restrict__ flags,
                        const int* __restrict__ rowc,
                        const unsigned long long* __restrict__ best_key,
                        int* __restrict__ best_pos, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n || !(flags[i] & kClaim)) return;
  const int r = rowc[i];
  if (best_key[r] == claim_key(est[i], key[i])) {
    atomicMax(best_pos + r, static_cast<int>(i));
  }
}

__global__ void __launch_bounds__(kThreads)
stream_outputs_kernel(const uint8_t* __restrict__ flags,
                      const int* __restrict__ rowc,
                      unsigned long long* __restrict__ best_key,
                      int* __restrict__ best_pos, int64_t n, int rows_cap,
                      int* __restrict__ scrub_rows,
                      int* __restrict__ hit_rows,
                      unsigned long long* __restrict__ counts) {
  __shared__ unsigned warp_sums[4][kThreads / 32];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  unsigned c[4] = {0u, 0u, 0u, 0u};
  if (i < n) {
    const uint8_t f = flags[i];
    const int r = rowc[i];
    // only the winner reads its own position here: a loser reads the
    // winner's position or the reset -1, neither of which is its own
    const bool scrub = (f & kClaim) && best_pos[r] == static_cast<int>(i);
    if (scrub) {
      best_key[r] = 0ull;
      best_pos[r] = -1;
    }
    const bool hit = (f & kHit) != 0;
    scrub_rows[i] = scrub ? r : rows_cap;
    hit_rows[i] = hit ? r : rows_cap;
    c[0] = scrub;
    c[1] = scrub && !(f & kFree);
    c[2] = (f & kLive) && !hit;
    c[3] = hit;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned s = __reduce_add_sync(0xffffffffu, c[k]);
    if (lane == 0) warp_sums[k][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    unsigned long long s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[threadIdx.x][w];
    if (s) atomicAdd(counts + threadIdx.x, s);
  }
}

// ------------------------------------------------------------------ K17

struct Leaves {
  void* ptr[kMaxLeaves];
  int dtype[kMaxLeaves];  // 0 float32, 1 bfloat16
  float fill[kMaxLeaves];
  int count;
};

__device__ __forceinline__ bool enabled(const uint8_t* enable) {
  return enable == nullptr || *enable != 0;
}

// x + (-x), then + fill when add_fill, each add rounded to the dtype.
__device__ __forceinline__ void reset(void* base, int dtype, int64_t idx,
                                      bool add_fill, float fill) {
  if (dtype == 0) {
    float* p = static_cast<float*>(base) + idx;
    float z = __fadd_rn(*p, -*p);
    if (add_fill) z = __fadd_rn(z, fill);
    *p = z;
  } else {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(base) + idx;
    const float x = __bfloat162float(*p);
    __nv_bfloat16 z = __float2bfloat16_rn(__fadd_rn(x, -x));
    if (add_fill) {
      const float fb = __bfloat162float(__float2bfloat16_rn(fill));
      z = __float2bfloat16_rn(__fadd_rn(__bfloat162float(z), fb));
    }
    *p = z;
  }
}

// One warp per 32 positions: the lanes holding a claimed row set its
// slot-map entry; the warp then resets each claimed row, lanes over the
// width.
__global__ void __launch_bounds__(kThreads)
commit_scrub_kernel(void* slab, int slab_dtype, int width, Leaves leaves,
                    const int* __restrict__ scrub_rows,
                    const int* __restrict__ fp, const int* __restrict__ est,
                    int64_t n, int rows_cap, int* __restrict__ slot_fp,
                    int* __restrict__ slot_freq,
                    const uint8_t* __restrict__ enable) {
  if (!enabled(enable)) return;
  const int lane = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int r = i < n ? scrub_rows[i] : rows_cap;
  const bool mine = r >= 0 && r < rows_cap;
  if (mine) {
    slot_fp[r] = fp[i];
    slot_freq[r] = est[i];
  }
  unsigned m = __ballot_sync(0xffffffffu, mine);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const int64_t row = __shfl_sync(0xffffffffu, r, src);
    for (int j = lane; j < width; j += 32) {
      const int64_t idx = row * width + j;
      reset(slab, slab_dtype, idx, false, 0.0f);
      for (int k = 0; k < leaves.count; ++k) {
        reset(leaves.ptr[k], leaves.dtype[k], idx, leaves.fill[k] != 0.0f,
              leaves.fill[k]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
commit_hits_kernel(const int* __restrict__ hit_rows,
                   const int* __restrict__ est, int64_t n, int rows_cap,
                   int* __restrict__ slot_freq,
                   const uint8_t* __restrict__ enable) {
  if (!enabled(enable)) return;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int r = hit_rows[i];
  if (r >= 0 && r < rows_cap) atomicMax(slot_freq + r, est[i]);
}

__global__ void __launch_bounds__(kThreads)
commit_state_kernel(int* __restrict__ cms,
                    const int* __restrict__ staged, int64_t cms_numel,
                    const unsigned long long* __restrict__ counts,
                    float* __restrict__ totals, float* c0, float* c1,
                    float* c2, float* c3, int* steps, int finalize,
                    const uint8_t* __restrict__ enable) {
  const bool en = enabled(enable);
  if (en) {
    for (int64_t k = threadIdx.x; k < cms_numel; k += blockDim.x) {
      cms[k] = staged[k];
    }
  }
  if (threadIdx.x != 0) return;
  float* counters[4] = {c0, c1, c2, c3};
  for (int k = 0; k < 4; ++k) {
    const float g = en ? __ull2float_rn(counts[k]) : 0.0f;
    totals[k] = __fadd_rn(totals[k], g);
    if (finalize) *counters[k] = __fadd_rn(*counters[k], totals[k]);
  }
  if (finalize) *steps += en ? 1 : 0;
}

unsigned grid(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" const char* detpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K16's first half. ext [n] int32 (ext_is_64 = 0) or int64, live [n]
// bool, cap/nb/tid/roff [n] int32, slot_fp [rows_cap] int32; writes
// local_rows [n] int32 and, when key is not null, key [n] int32,
// live_out [n] bool, flags [n] uint8 and rowc [n] int32.
extern "C" int detpu_stream_hash(const void* ext, int ext_is_64,
                                 const void* live, const void* cap,
                                 const void* nb, const void* tid,
                                 const void* roff, const void* slot_fp,
                                 int64_t n, void* local_rows, void* key,
                                 void* live_out, void* flags, void* rowc,
                                 void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  stream_hash_kernel<<<grid(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      ext, ext_is_64, static_cast<const uint8_t*>(live),
      static_cast<const int*>(cap), static_cast<const int*>(nb),
      static_cast<const int*>(tid), static_cast<const int*>(roff),
      static_cast<const int*>(slot_fp), n, static_cast<int*>(local_rows),
      static_cast<int*>(key), static_cast<uint8_t*>(live_out),
      static_cast<uint8_t*>(flags), static_cast<int*>(rowc));
  return cudaGetLastError();
}

// K16's second half, after K13 folded key/live_out into the staged
// sketch cms [depth, buckets]: est [n], the claim resolution through
// best_key [rows_cap] uint64 (all 0) and best_pos [rows_cap] int32 (all
// -1), left as found; scrub_rows and hit_rows [n] int32; counts [4]
// int64 (zeroed here).
extern "C" int detpu_stream_stage(const void* cms, int depth, int buckets,
                                  const void* key, void* flags,
                                  const void* rowc, const void* slot_freq,
                                  int admit, int margin, int64_t n,
                                  int rows_cap, void* best_key,
                                  void* best_pos, void* est,
                                  void* scrub_rows, void* hit_rows,
                                  void* counts, void* stream) {
  if (n < 0 || depth <= 0 || buckets <= 0 || rows_cap <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(counts, 0, 4 * sizeof(long long), st);
  if (e != cudaSuccess || n == 0) return e;
  auto* k = static_cast<const int*>(key);
  auto* f = static_cast<uint8_t*>(flags);
  auto* r = static_cast<const int*>(rowc);
  auto* bk = static_cast<unsigned long long*>(best_key);
  auto* bp = static_cast<int*>(best_pos);
  auto* es = static_cast<int*>(est);
  stream_claim_kernel<<<grid(n), kThreads, 0, st>>>(
      static_cast<const int*>(cms), depth, buckets, k, r,
      static_cast<const int*>(slot_freq), admit, margin, n, es, f, bk);
  stream_claim_pos_kernel<<<grid(n), kThreads, 0, st>>>(k, es, f, r, bk, bp,
                                                         n);
  stream_outputs_kernel<<<grid(n), kThreads, 0, st>>>(
      f, r, bk, bp, n, rows_cap, static_cast<int*>(scrub_rows),
      static_cast<int*>(hit_rows),
      static_cast<unsigned long long*>(counts));
  return cudaGetLastError();
}

// K17 for one width slab. slab [rows_cap, width] (dtype 0 float32, 1
// bfloat16) and up to four leaves of its shape (leaf_ptrs/leaf_dtypes/
// leaf_fills, n_leaves of them), reset on the scrub rows; slot_fp,
// slot_freq [rows_cap] int32; cms and staged [cms_numel] int32; counts
// [4] int64; totals [4] float32 (the step's gated totals, accumulated);
// the four cumulative counters [1] float32 and steps [1] int32 take the
// totals when finalize is set; enable: a bool on the card, or null.
extern "C" int detpu_stream_commit(
    void* slab, int slab_dtype, int width, int rows_cap,
    const void* leaf_ptrs, const void* leaf_dtypes, const void* leaf_fills,
    int n_leaves, const void* scrub_rows, const void* fp, const void* est,
    const void* hit_rows, int64_t n, void* slot_fp, void* slot_freq,
    void* cms, const void* staged, int64_t cms_numel, const void* counts,
    void* totals, void* c_admitted, void* c_evicted, void* c_bucket,
    void* c_hit, void* steps, int finalize, const void* enable,
    void* stream) {
  if (n < 0 || width <= 0 || rows_cap <= 0 || n_leaves < 0 ||
      n_leaves > kMaxLeaves) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Leaves lv{};
  lv.count = n_leaves;
  for (int k = 0; k < n_leaves; ++k) {
    lv.ptr[k] = static_cast<void* const*>(leaf_ptrs)[k];
    lv.dtype[k] = static_cast<const int*>(leaf_dtypes)[k];
    lv.fill[k] = static_cast<const float*>(leaf_fills)[k];
  }
  auto* en = static_cast<const uint8_t*>(enable);
  auto* es = static_cast<const int*>(est);
  auto* sf = static_cast<int*>(slot_freq);
  if (n > 0) {
    commit_scrub_kernel<<<grid(n), kThreads, 0, st>>>(
        slab, slab_dtype, width, lv, static_cast<const int*>(scrub_rows),
        static_cast<const int*>(fp), es, n, rows_cap,
        static_cast<int*>(slot_fp), sf, en);
    commit_hits_kernel<<<grid(n), kThreads, 0, st>>>(
        static_cast<const int*>(hit_rows), es, n, rows_cap, sf, en);
  }
  commit_state_kernel<<<1, kThreads, 0, st>>>(
      static_cast<int*>(cms), static_cast<const int*>(staged), cms_numel,
      static_cast<const unsigned long long*>(counts),
      static_cast<float*>(totals), static_cast<float*>(c_admitted),
      static_cast<float*>(c_evicted), static_cast<float*>(c_bucket),
      static_cast<float*>(c_hit), static_cast<int*>(steps), finalize, en);
  return cudaGetLastError();
}
