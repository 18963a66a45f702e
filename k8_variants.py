#!/usr/bin/env python3
"""K8's variants (the ragged gather + combine, ``csrc/ragged_combine.cu``):
patched builds of the kernel (``variants.py``), timed against the tree's
build in turns on one NVIDIA GPU.

- ``tile128``, ``tile512``, ``threads1024`` (one CTA of 1024 threads a
  SM): the launch constants;
- the source words a pass (the tree's: the call's capacity a sample over
  a tile and a quarter more, within the CTA's share of the SM):
  ``budget``, the CTA's whole share (113 KB with two CTAs a SM, leaving
  the L1 30 KB of the SM's 256); ``smem14k`` to ``smem48k``, held to that
  many bytes a CTA (``smem24k_carve25`` with the kernel's preferred
  shared-memory carveout at 25%); ``pos20``, 20 a sample, the first
  sizing;
- ``general``: every tile from its ids (the general form alone: the
  first design's walk on the persistent grid);
- ``staged``, ``staged_t128``: each tile's most-hit rows also served from
  shared memory (:func:`stage`: a shared-memory hash counts the pass's
  rows, a histogram picks the up-to-S most-hit rows hit at least twice,
  TMA bulk copies on an mbarrier stage them, their source words point at
  the stage; S sized from the row's bytes). Its counts: the share of
  positions served from shared memory, the rows staged a pass, and the
  clock cycles in count + pick, stage + translate and combine.

Inputs: the ragged DLRM step's K8 call, made as ``chip_smoke.py`` makes
its batches (the Criteo-Kaggle tables capped at 2M rows, 10,569,296 rows
of width 128 in float32; 26 features of U{1..30} Zipfian ids a sample,
alpha 1.05; b=65536; bf16 output), and a long-row stream on the same
tables (U{1..200} ids a sample, b=8192), where the source words may take
several passes a tile.
Every variant must give the tree's bits; each is timed with CUDA events
in turns (each variant, then each again in the reverse order; the median
of the two runs' medians).

Run from the root of a checkout: ``python3 k8_variants.py``. Prints the
card's name and power limit, then one JSON line a variant and input.
"""

import contextlib
import ctypes
import importlib
import json

import numpy as np

import variants as vs

#: a patch counting the kernel's general-form calls (a CTA's call for a
#: tile, or for one row past the source words) in a device counter, read
#: by ``detpu_k8_general_calls()``; the card tests hold the flat form with
#: it
COUNT_GENERAL = vs.replace(
    ("// The general form: rows [r_begin, r_end) of the slot",
     "__device__ unsigned long long g_general_calls = 0;\n\n"
     "// The general form: rows [r_begin, r_end) of the slot"),
    ("  const int nv = a.width / V;\n"
     "  for (int64_t r = r_begin + gi; r < r_end; r += groups) {",
     "  const int nv = a.width / V;\n"
     "  if (threadIdx.x == 0) atomicAdd(&g_general_calls, 1ull);\n"
     "  for (int64_t r = r_begin + gi; r < r_end; r += groups) {"),
    ("}  // namespace\n",
     "}  // namespace\n\n"
     "extern \"C\" unsigned long long detpu_k8_general_calls() {\n"
     "  unsigned long long v = 0;\n"
     "  if (cudaMemcpyFromSymbol(&v, g_general_calls, sizeof(v)) !=\n"
     "      cudaSuccess) return ~0ull;\n"
     "  return v;\n"
     "}\n"))

#: the stage's device code, put ahead of ``word_row``
_STAGE_CODE = r"""
__device__ unsigned long long g_stage_stats[7];  // see main()
__device__ int g_stage_count_on = 0;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ uint32_t hash_of(uint32_t key) {
  return (key * 0x9E3779B1u) >> (32 - kHashLog2);
}

// Count n hits of key (a warp's peers at once).
__device__ __forceinline__ void hash_add(uint32_t* hkey, int* hval,
                                         uint32_t key, int n) {
  const uint32_t m = (1u << kHashLog2) - 1u;
  uint32_t h = hash_of(key);
  for (int q = 0; q < kProbes; ++q, h = (h + 1) & m) {
    uint32_t k = *reinterpret_cast<volatile uint32_t*>(hkey + h);
    if (k == kEmpty) k = atomicCAS(hkey + h, kEmpty, key);
    if (k == kEmpty || k == key) {
      atomicAdd(hval + h, n);
      return;
    }
  }
}

// The stage slot of key, or -1.
__device__ __forceinline__ int hash_find(const uint32_t* hkey,
                                         const int* hval, uint32_t key) {
  const uint32_t m = (1u << kHashLog2) - 1u;
  uint32_t h = hash_of(key);
  for (int q = 0; q < kProbes; ++q, h = (h + 1) & m) {
    const uint32_t k = hkey[h];
    if (k == key) return hval[h];
    if (k == kEmpty) return -1;
  }
  return -1;
}

struct StageMem {
  uint64_t* bar;
  uint32_t* hkey;
  int* hval;
  uint32_t* srow;
  unsigned char* stage;
};

__device__ __forceinline__ StageMem stage_mem(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  StageMem m;
  m.bar = reinterpret_cast<uint64_t*>(smem + a.bar_off);
  m.hkey = reinterpret_cast<uint32_t*>(smem + a.bar_off + 16);
  m.hval = reinterpret_cast<int*>(m.hkey + (1 << kHashLog2));
  m.srow = reinterpret_cast<uint32_t*>(m.hval + (1 << kHashLog2));
  m.stage = smem + a.stage_off;
  return m;
}

__device__ __forceinline__ void stage_init(const Args& a) {
  if (a.stage_rows > 0 && threadIdx.x == 0) {
    mbar_init(stage_mem(a).bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ void stage_reset(const Args& a, long long* clk) {
  if (a.stage_rows == 0) return;
  const StageMem m = stage_mem(a);
  for (int i = threadIdx.x; i < (1 << kHashLog2); i += blockDim.x) {
    m.hkey[i] = kEmpty;
    m.hval[i] = 0;
  }
  if (threadIdx.x == 0) clk[0] = clock64();
  __syncthreads();
}

// After the pass's source words (and their count): pick the up-to-S
// most-hit rows hit at least twice, stage them, point their source words
// at the stage, wait for the copies.
template <typename E>
__device__ void stage_pass(const Args& a, uint32_t* src, int npos,
                           uint32_t& parity, long long* clk) {
  __shared__ int s_hist[kBins];
  __shared__ int s_sfx[kBins + 1];
  __shared__ int s_thr, s_hi, s_fill, s_hits;
  const int S = a.stage_rows;
  if (S == 0) return;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int H = 1 << kHashLog2;
  const StageMem m = stage_mem(a);
  for (int i = tid; i < kBins; i += nthreads) s_hist[i] = 0;
  if (tid == 0) {
    s_thr = kBins;
    s_hi = 0;
    s_fill = 0;
    s_hits = 0;
    s_sfx[kBins] = 0;
  }
  __syncthreads();
  for (int i = tid; i < H; i += nthreads) {
    if (m.hkey[i] != kEmpty && m.hval[i] >= 2) {
      atomicAdd(&s_hist[min(m.hval[i], kBins - 1)], 1);
    }
  }
  __syncthreads();
  if (tid < 32) {  // s_sfx[c]: rows hit at least c times (c < kBins)
    int v[kBins / 32];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kBins / 32; ++k) {
      v[k] = s_hist[kBins - 1 - (tid * (kBins / 32) + k)];
      sum += v[k];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int k = 0; k < kBins / 32; ++k) {
      run += v[k];
      s_sfx[kBins - 1 - (tid * (kBins / 32) + k)] = run;
    }
  }
  __syncthreads();
  // the threshold: the least count >= 2 whose rows fit in S
  for (int c = tid + 2; c < kBins; c += nthreads) {
    if (s_sfx[c] <= S && (c == 2 || s_sfx[c - 1] > S)) s_thr = c;
  }
  __syncthreads();
  const int thr = s_thr;
  const int n_hi = s_sfx[thr];
  for (int i = tid; i < H; i += nthreads) {
    const uint32_t k = m.hkey[i];
    if (k == kEmpty) continue;
    const int c = min(m.hval[i], kBins - 1);
    int at = -1;
    if (c >= 2) {
      if (c >= thr) {
        at = atomicAdd(&s_hi, 1);
      } else if (c == thr - 1) {
        const int qq = atomicAdd(&s_fill, 1);
        if (n_hi + qq < S) at = n_hi + qq;
      }
    }
    m.hval[i] = at;
    if (at >= 0) m.srow[at] = k;
  }
  __syncthreads();
  if (tid == 0) clk[1] = clock64();
  const int n_stage = min(S, n_hi + s_fill);
  if (a.tma) {
    if (tid < 32) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (tid == 0) {
        mbar_expect(m.bar, static_cast<uint32_t>(n_stage) * a.row_bytes);
      }
      __syncwarp();
      const unsigned char* from = static_cast<const unsigned char*>(a.slab);
      for (int s = tid; s < n_stage; s += 32) {
        bulk_load(m.stage + static_cast<int64_t>(s) * a.pitch,
                  from + static_cast<int64_t>(m.srow[s]) * a.row_bytes,
                  a.row_bytes, m.bar);
      }
    }
  } else {
    const E* slab = static_cast<const E*>(a.slab);
    for (int64_t i = tid; i < static_cast<int64_t>(n_stage) * a.width;
         i += nthreads) {
      const int s = static_cast<int>(i / a.width);
      const int c = static_cast<int>(i - static_cast<int64_t>(s) * a.width);
      reinterpret_cast<E*>(m.stage + static_cast<int64_t>(s) * a.pitch)[c] =
          slab[static_cast<int64_t>(m.srow[s]) * a.width + c];
    }
  }
  int hits = 0;
  for (int q = tid; q < npos; q += nthreads) {
    const uint32_t w = src[q];
    const int at = hash_find(m.hkey, m.hval, w & kRowMask);
    if (at >= 0) {
      src[q] = kStaged | (w & kZero) | static_cast<uint32_t>(at);
      ++hits;
    }
  }
  if (g_stage_count_on && hits) atomicAdd(&s_hits, hits);
  __syncthreads();
  if (a.tma) {
    mbar_wait(m.bar, parity);
    parity ^= 1u;
  }
  if (tid == 0) {
    clk[2] = clock64();
    if (g_stage_count_on) {
      atomicAdd(g_stage_stats + 0, static_cast<unsigned long long>(s_hits));
      atomicAdd(g_stage_stats + 1, static_cast<unsigned long long>(npos));
      atomicAdd(g_stage_stats + 2, static_cast<unsigned long long>(n_stage));
      atomicAdd(g_stage_stats + 3, 1ull);
    }
  }
}

// After the pass's combine: its cycles a phase.
__device__ __forceinline__ void stage_done(const Args& a, long long* clk) {
  if (a.stage_rows > 0 && threadIdx.x == 0 && g_stage_count_on) {
    const long long end = clock64();
    atomicAdd(g_stage_stats + 4,
              static_cast<unsigned long long>(clk[1] - clk[0]));
    atomicAdd(g_stage_stats + 5,
              static_cast<unsigned long long>(clk[2] - clk[1]));
    atomicAdd(g_stage_stats + 6,
              static_cast<unsigned long long>(end - clk[2]));
  }
}

"""

_STAGE_C = r"""
extern "C" int detpu_k8_stage_rows(const void* prepared) {
  return static_cast<const Prepared*>(prepared)->a.stage_rows;
}

extern "C" int detpu_k8_stage_count(int on) {
  unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
  cudaError_t e = cudaMemcpyToSymbol(g_stage_count_on, &on, sizeof(on));
  if (e == cudaSuccess) {
    e = cudaMemcpyToSymbol(g_stage_stats, zero, sizeof(zero));
  }
  return e;
}

extern "C" int detpu_k8_stage_stats(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_stage_stats, 7 * sizeof(*out));
}
"""


def stage(hash_log2=12, tile=256):
    """The stage patch (a hash of 2^``hash_log2`` entries, tiles of
    ``tile`` samples): 20 source words a sample as the first sizing, S
    from what the CTA's share of shared memory holds after them, the
    tile's row ends, the mbarrier and the hash."""
    return chain(
        vs.constants(kTile=tile),
        vs.replace(
            ("// a source word: the slab row in the low 31 bits, a masked "
             "bad id's flag\nconstexpr uint32_t kRowMask = 0x7fffffffu;\n"
             "constexpr uint32_t kZero = 0x80000000u;\n",
             "constexpr uint32_t kRowMask = 0x3fffffffu;\n"
             "constexpr uint32_t kZero = 0x40000000u;\n"
             "constexpr uint32_t kStaged = 0x80000000u;\n"
             "constexpr uint32_t kEmpty = 0xffffffffu;\n"
             "constexpr int kProbes = 16;\nconstexpr int kBins = 256;\n"
             "constexpr int kMinStage = 8;\nconstexpr int kMaxStage = 4096;\n"
             f"constexpr int kHashLog2 = {hash_log2};\n"),
            ("  int rend_off;           // the tile's row ends' offset in "
             "shared memory\n};",
             "  int rend_off;           // the tile's row ends' offset in "
             "shared memory\n  int stage_rows, row_bytes, pitch, bar_off, "
             "stage_off, tma;\n};"),
            ("// The row a source word names, at column col.\n",
             _STAGE_CODE
             + "// The row a source word names, at column col.\n"),
            ("  return __ldg(reinterpret_cast<const RawT*>(\n"
             "      slab + static_cast<int64_t>(w & kRowMask) * a.width "
             "+ col));\n}",
             "  extern __shared__ __align__(16) unsigned char smem[];\n"
             "  if (w & kStaged) {\n"
             "    return *reinterpret_cast<const RawT*>(\n"
             "        smem + a.stage_off + static_cast<int64_t>(w & "
             "kRowMask) * a.pitch +\n"
             "        col * static_cast<int64_t>(sizeof(E)));\n  }\n"
             "  return __ldg(reinterpret_cast<const RawT*>(\n"
             "      slab + static_cast<int64_t>(w & kRowMask) * a.width "
             "+ col));\n}"),
            ("  for (int64_t t = blockIdx.x; t < a.tiles; t += gridDim.x) {",
             "  uint32_t parity = 0;\n  long long clk[3] = {0, 0, 0};\n"
             "  const unsigned lt = (1u << (tid & 31)) - 1u;\n"
             "  const StageMem sm = stage_mem(a);\n  stage_init(a);\n"
             "  for (int64_t t = blockIdx.x; t < a.tiles; t += gridDim.x) {"),
            ("      // 1. source words: the row, or a masked bad id's flag\n",
             "      stage_reset(a, clk);\n"
             "      // 1. source words: the row, or a masked bad id's flag\n"),
            ("          if (q < npos) {\n"
             "            const int64_t id = static_cast<int64_t>(idv[k]);\n"
             "            src[q] = static_cast<uint32_t>(\n"
             "                         global_row(id, s.nrows, s.base, "
             "a.slab_rows)) |\n"
             "                     (s.masked && (id < 0 || id >= s.nrows) "
             "? kZero : 0u);\n"
             "          }\n",
             "          uint32_t key = kEmpty;\n"
             "          if (q < npos) {\n"
             "            const int64_t id = static_cast<int64_t>(idv[k]);\n"
             "            key = static_cast<uint32_t>(\n"
             "                global_row(id, s.nrows, s.base, a.slab_rows));\n"
             "            src[q] = key | (s.masked && (id < 0 || id >= "
             "s.nrows) ? kZero : 0u);\n"
             "          }\n"
             "          if (a.stage_rows > 0) {\n"
             "            const unsigned peers =\n"
             "                __match_any_sync(0xffffffffu, key);\n"
             "            if (key != kEmpty && (peers & lt) == 0u) {\n"
             "              hash_add(sm.hkey, sm.hval, key, __popc(peers));\n"
             "            }\n"
             "          }\n"),
            ("      __syncthreads();\n      // 2. combine:",
             "      __syncthreads();\n"
             "      stage_pass<E>(a, src, npos, parity, clk);\n"
             "      // 2. combine:"),
            ("      __syncthreads();  // the next pass rewrites the source "
             "words\n",
             "      stage_done(a, clk);\n"
             "      __syncthreads();  // the next pass rewrites the source "
             "words\n"),
            ("  a.max_pos = slab_rows <= (1ll << 31) && most > 0\n"
             "                  ? static_cast<int>(want < most ? want : most)"
             " : 0;\n"
             "  a.rend_off = 4 * a.max_pos;\n"
             "  p->smem = a.max_pos > 0 ? a.rend_off + 4 * kTile : 0;\n",
             "  a.max_pos = slab_rows <= (1ll << 30) ? 20 * kTile : 0;\n"
             "  a.rend_off = 4 * a.max_pos;\n"
             "  a.row_bytes = width * esize;\n"
             "  a.pitch = (a.row_bytes + 15) / 16 * 16;\n"
             "  a.tma = a.row_bytes % 16 == 0 &&\n"
             "          reinterpret_cast<uintptr_t>(slab) % 16 == 0;\n"
             "  a.bar_off = (a.rend_off + 4 * kTile + 15) / 16 * 16;\n"
             "  const int fixed = a.bar_off + 16 + 8 * (1 << kHashLog2);\n"
             "  int S = a.max_pos > 0 && budget > fixed\n"
             "              ? (budget - fixed - 15) / (a.pitch + 4) : 0;\n"
             "  if (S > kMaxStage) S = kMaxStage;\n"
             "  if (S > (1 << kHashLog2) / 2) S = (1 << kHashLog2) / 2;\n"
             "  if (S < kMinStage) S = 0;\n"
             "  a.stage_rows = S;\n"
             "  a.stage_off = (fixed + 4 * S + 15) / 16 * 16;\n"
             "  p->smem = a.max_pos > 0 ? a.stage_off + S * a.pitch : 0;\n"
             "  if (p->smem > budget) return cudaErrorInvalidValue;\n"),
            ("// values [n_slots, *] (row stride as prepared)",
             _STAGE_C + "\n// values [n_slots, *] (row stride as prepared)")))


def chain(*patches):
    """One variant made of several patches, applied in order."""
    def patch(text, what):
        for p in patches:
            text = p(text, what)
        return text
    return patch


def launch(**values):
    """A variant of the launch constants (``kTile``, ``kThreads``,
    ``kCtas``)."""
    return vs.constants(**values)


def words(expr):
    """The source words a pass set to ``expr`` (C, over ``most``, the
    CTA's share of the SM in words, and ``want``, the tree's sizing)."""
    return vs.replace(("static_cast<int>(want < most ? want : most)",
                       f"static_cast<int>({expr})"))


def smem(nbytes):
    """The source words and row ends held to ``nbytes`` a CTA."""
    cap = f"({nbytes} - 4 * kTile) / 4"
    return words(f"most < {cap} ? most : {cap}")


def carveout(percent):
    """The kernel's preferred shared-memory carveout set to ``percent``
    of the SM's most (the L1 takes the rest)."""
    return vs.replace((
        "  // the kernel's limit at its most, so no record's launch is "
        "refused\n",
        "  cudaFuncSetAttribute(k, "
        "cudaFuncAttributePreferredSharedMemoryCarveout, %d);\n"
        "  // the kernel's limit at its most, so no record's launch is "
        "refused\n" % percent))


#: variant -> patch (None: the tree's source)
VARIANTS = {
    "tree": None,
    "tile128": launch(kTile=128),
    "tile512": launch(kTile=512),
    "threads1024": launch(kThreads=1024, kCtas=1),
    "budget": words("most"),
    "smem14k": smem(14848),
    "smem24k": smem(24576),
    "smem32k": smem(32768),
    "smem48k": smem(49152),
    "smem24k_carve25": chain(smem(24576), carveout(25)),
    "smem24k_threads1024": chain(smem(24576),
                                 launch(kThreads=1024, kCtas=1)),
    "pos20": words("20 * kTile"),
    "general": vs.replace(("  bool ok = a.max_pos > 0 && s.nrows > 0;",
                           "  bool ok = false;")),
    "staged": stage(),
    "staged_t128": stage(hash_log2=11, tile=128),
}


@contextlib.contextmanager
def library(el, lib):
    """K8's wrapper building its records on ``lib`` (a patched build)."""
    kernels = el._kernels
    saved = kernels.library
    kernels.library = lambda name: lib if name == "ragged_combine" \
        else saved(name)
    try:
        yield
    finally:
        kernels.library = saved


def long_row_call(torch, cs, sizes, b, seed):
    """The ragged step's tables with U{1..200} Zipfian ids a sample."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    vals, splits = [], []
    for v in sizes:
        hots = torch.randint(1, 201, (b,), generator=gen, device="cuda")
        sp = torch.zeros(b + 1, dtype=torch.int64, device="cuda")
        torch.cumsum(hots, 0, out=sp[1:])
        splits.append(sp)
        vals.append(cs.device_power_law(torch, gen, v, int(sp[-1])))
    cap = max(int(sp[-1]) for sp in splits)
    values = torch.zeros((len(sizes), cap), dtype=torch.int32,
                         device="cuda")
    for k, v in enumerate(vals):
        values[k, :v.numel()] = v
    return values, torch.stack(splits)


def main():
    import torch

    import chip_smoke as cs
    el = importlib.import_module(
        "distributed_embeddings_torch.ops.embedding_lookup")
    kernels = el._kernels

    if not torch.cuda.is_available():
        raise SystemExit("k8_variants.py needs a CUDA card")
    print(vs.card_line(), flush=True)
    libs = vs.build(kernels, "ragged_combine", VARIANTS, "k8_variants")
    for name in ("staged", "staged_t128"):
        lib = libs[name]
        lib.detpu_k8_stage_rows.argtypes = [ctypes.c_void_p]
        lib.detpu_k8_stage_count.argtypes = [ctypes.c_int]
        lib.detpu_k8_stage_stats.argtypes = [ctypes.c_void_p]
    sizes = cs.ragged_sizes()
    (batch,), _ = cs.ragged_batches(torch, sizes, cs.TRAIN_BATCH, 1,
                                    cs.SEED + 90)
    step = (torch.stack([r.values for r in batch[0]]),
            torch.stack([r.row_splits.long() for r in batch[0]]))
    inputs = {"step": step,
              "long_rows": long_row_call(torch, cs, sizes, 8192,
                                         cs.SEED + 92)}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 91)
    slab = torch.randn((sum(sizes), 128), generator=gen, device="cuda")
    rows = torch.tensor(sizes, dtype=torch.int64, device="cuda")
    roff = torch.tensor(np.r_[0, np.cumsum(sizes)[:-1]], dtype=torch.int64,
                        device="cuda")
    row = 128 * 4
    for what, (values, splits) in inputs.items():
        recs, outs, info = {}, {}, {}
        for name, lib in libs.items():
            with library(el, lib):
                rec = el.build_ragged_record(slab, values, splits, rows,
                                             roff, out_dtype=torch.bfloat16)
            out = torch.empty(*rec.payload[0], dtype=torch.bfloat16,
                              device="cuda")
            recs[name], outs[name] = rec, out
            info[name] = {}
            staged = name.startswith("staged")
            if staged:
                kernels.check(lib, lib.detpu_k8_stage_count(1), name)
            rec.replay(values.data_ptr(), splits.data_ptr(), None,
                       out.data_ptr())
            torch.cuda.synchronize()
            if staged:
                st = (ctypes.c_ulonglong * 7)()
                kernels.check(lib, lib.detpu_k8_stage_stats(st), name)
                kernels.check(lib, lib.detpu_k8_stage_count(0), name)
                hits, seen, n_staged, passes, *cyc = (int(v) for v in st)
                info[name] = dict(
                    stage_rows=lib.detpu_k8_stage_rows(
                        rec.payload[3].ctypes.data),
                    hit_share=hits / max(seen, 1), positions=seen,
                    staged_rows_per_pass=n_staged / max(passes, 1),
                    passes=passes, phase_cycle_share=dict(zip(
                        ("count_pick", "stage_translate", "combine"),
                        (c / max(sum(cyc), 1) for c in cyc))))
            if not torch.equal(out.view(torch.int16),
                               outs["tree"].view(torch.int16)):
                raise SystemExit(f"{what} {name}: K8's bits differ from "
                                 "the tree's")
        positions = int((splits[:, -1]).sum())
        ptrs = (values.data_ptr(), splits.data_ptr(), None)
        out = outs["tree"].data_ptr()
        times = {n: [] for n in recs}
        for order in (list(recs), list(reversed(recs))):
            for name in order:
                rec = recs[name]
                times[name].append(cs.time_ms(
                    torch, lambda rec=rec: rec.replay(*ptrs, out), [()]))
        for name in recs:
            ms = float(np.median(times[name]))
            print(json.dumps({"input": what, "variant": name, "ms": ms,
                              "runs": times[name],
                              "row_read_tb_per_s": positions * row
                              / (ms * 1e-3) / 1e12, **info[name]}),
                  flush=True)


if __name__ == "__main__":
    main()
