#!/usr/bin/env python3
"""K13's and K15's variants (the telemetry sketch update and top-k
merge, ``csrc/sketch.cu``): patched builds (``variants.py``), held bit
for bit to the plain versions, and timed against the tree's build in
turns on one NVIDIA GPU.

K13, the tree: one launch of persistent CTAs (one a SM), 16 positions
a lane a round from 16-byte loads, each CTA counting into its
shared-memory copy of the sketch with one atomic a live position and
depth row, then flushing its copy's nonzero words. Variants:

- ``match``: each warp first merges its lanes that hit one column
  (``__match_any_sync`` a depth row) and adds their count once;
- ``cluster2``, ``cluster8``: thread-block clusters of 2 and 8 CTAs
  (``cudaLaunchKernelEx``, the clusters that run at once), one flush a
  cluster: after ``cluster.sync()`` each CTA sums its share of the
  columns over the cluster's copies through distributed shared memory.

Each variant's grid is printed beside its times.

K15, the tree: one CTA of a thread an entry up to kBlockKeys = 512
(topk + candidates; the default 32 + 128), by counting and ranks; past it
tiles of kSortTile = 1024 keys sorted in shared memory and ranked by
binary searches. Variants: ``warp_sort`` (the first design of the
default path: one warp, the keys in registers bitonic-sorted with
shuffles, no barrier); ``tile512``, ``tile2048`` (tiles of 512 and 2048
keys); ``stamps`` (thread 0's ``clock64()`` at the end of each phase of
the one-CTA merge: loads, keep flags, unique places, scores, ranks and
outputs, the count), whose split is printed for the default sizes, with
the SASS instruction counts of the tree's and ``warp_sort``'s kernels
(``cuobjdump``, where the toolkit has it). Past one CTA, the tree's
device time split by kernel. Each K15 line carries the merge's bound
(``chip_smoke.merge_bytes`` over the HBM rate).

Inputs: the telemetry phase's one-hot stream (26 Zipfian ids a sample
over the capped Criteo-Kaggle vocabularies, b = 16384: 425,984
positions, all live), a ragged stream of 26,562,562 positions (26
features of 1,021,637, 2% dead), the default sketch 4 x 2048 and a
non-power-of-two 4 x 2047 (fastmod). K15 merges the one-hot stream's
pool at the default 32 + 128 and at the C5 sizes (topk 2048 with 8192
candidates, 32 with 16384).

Timing (as ``row_variants.py``): ``ms`` the CUDA-event time of 20
back-to-back launches over 20, ``device_ms`` ``torch.profiler``'s device
time a launch, variants in turns; the wrappers (``wrapper``, and with
``--parent DIR`` that checkout's ``parent_wrapper``) one call between
two events, host included, and their host ms a call; the width fold
(``analysis/telemetry.py:_record``) its host ms a call against the
parent's, as ``chip_smoke.py`` measures it.

Run from the root of a checkout: ``python3 sketch_variants.py [--parent
DIR] [--only k13,k15]``. Prints the card's name and power limit, then
one JSON line a case.
"""

import ctypes
import importlib
import json
import os
import subprocess
import sys

import numpy as np

import row_variants as rv
import variants as vs

#: K13's warp merge of lanes that hit one column (the first design)
MATCH = vs.replace(("""  if (!ok) return;
  for (int d = 0; d < p.depth; ++d) {
    atomicAdd(target + static_cast<int64_t>(d) * p.cols.buckets +
                  fast_col(hash_of(id, d), p.cols), 1);
  }""", """  const int lane = threadIdx.x & 31;
  const unsigned mask = __ballot_sync(0xffffffffu, ok);
  if (!ok) return;
  for (int d = 0; d < p.depth; ++d) {
    const uint32_t col = fast_col(hash_of(id, d), p.cols);
    const unsigned peers = __match_any_sync(mask, col);
    if (lane == __ffs(peers) - 1) {
      atomicAdd(target + static_cast<int64_t>(d) * p.cols.buckets + col,
                __popc(peers));
    }
  }"""))


def cluster(size):
    """K13 in thread-block clusters of ``size`` CTAs, one flush a
    cluster through distributed shared memory."""
    return vs.replace(
        ("#include <cuda_runtime.h>\n",
         "#include <cooperative_groups.h>\n#include <cuda_runtime.h>\n"),
        ("""  __syncthreads();  // the CTA's copy and its warps' counts are complete
  if constexpr (kShared) {
    for (int c = threadIdx.x; c < cells; c += kUpdThreads) {
      const int s = sh[c];
      if (s != 0) atomicAdd(cms + c, s);
    }
  }
""", """  if constexpr (kShared) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int size = static_cast<int>(cluster.num_blocks());
    const int share = (cells + size - 1) / size;
    const int lo = min(cells, static_cast<int>(cluster.block_rank()) * share);
    const int hi = min(cells, lo + share);
    for (int c = lo + threadIdx.x; c < hi; c += kUpdThreads) {
      int s = 0;
      for (int q = 0; q < size; ++q) s += cluster.map_shared_rank(sh, q)[c];
      if (s != 0) atomicAdd(cms + c, s);
    }
    cluster.sync();  // no CTA leaves while another reads its copy
  } else {
    __syncthreads();
  }
"""),
        ("""    cms_update_kernel<true><<<u.grid, kUpdThreads, u.smem, st>>>(
        u.p, c, i, l, vec, out);
""", """    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(u.grid));
    cfg.blockDim = dim3(kUpdThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(u.smem);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = %(size)d;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, cms_update_kernel<true>,
                                             u.p, c, i, l, vec, out);
    if (e != cudaSuccess) return e;
""" % {"size": size}),
        ("""  u->grid = sms;  // the scratch holds a partial for each CTA
""", """  u->grid = sms;  // the scratch holds a partial for each CTA
  if (u->shared) {  // the clusters that run at once
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(sms));
    cfg.blockDim = dim3(kUpdThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(u->smem);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = %(size)d;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, cms_update_kernel<true>,
                                       &cfg) != cudaSuccess || clusters < 1) {
      cudaGetLastError();
      clusters = sms / %(size)d;
    }
    if (clusters > sms / %(size)d) clusters = sms / %(size)d;
    u->grid = (clusters > 0 ? clusters : 1) * %(size)d;
  }
""" % {"size": size}))


K13_VARIANTS = {"tree": None, "match": MATCH, "cluster2": cluster(2),
                "cluster8": cluster(8)}
#: the first design of K15's default path: one warp, the keys in registers
#: bitonic-sorted with shuffles (no barrier); replaces the one-CTA merge
WARP_KERNEL = r'''// One in-register stage of warp_sort: keys r and r ^ JR of a lane.
template <int JR, int R>
__device__ __forceinline__ void reg_stage(unsigned long long (&k)[R],
                                          int ru, int s, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if ((r & JR) == 0 && (r | JR) < R && r < ru) {
      const int q = r | JR;
      const bool up = ((r * 32 + lane) & s) == 0;
      const unsigned long long a = k[r], b = k[q];
      if ((a > b) == up) {
        k[r] = b;
        k[q] = a;
      }
    }
  }
}

// Ascending bitonic sort of the 32 * ru keys k[r] (key r * 32 + lane; ru
// a power of two <= R) by one warp: shuffles between lanes, swaps within.
template <int R>
__device__ __forceinline__ void warp_sort(unsigned long long (&k)[R],
                                          int ru) {
  const int lane = threadIdx.x & 31;
  for (int s = 2; s <= 32 * ru; s <<= 1) {
    for (int j = s >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
        switch (j >> 5) {
          case 1: reg_stage<1>(k, ru, s, lane); break;
          case 2: reg_stage<2>(k, ru, s, lane); break;
          case 4: reg_stage<4>(k, ru, s, lane); break;
          default: reg_stage<8>(k, ru, s, lane); break;
        }
        continue;
      }
      const bool lower = (lane & j) == 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < ru) {
          const unsigned long long x = __shfl_xor_sync(0xffffffffu, k[r], j);
          const bool up = ((r * 32 + lane) & s) == 0;
          k[r] = (lower == up) ? (x < k[r] ? x : k[r])
                               : (x > k[r] ? x : k[r]);
        }
      }
    }
  }
}

// The merge by one warp (topk + cand_n <= 32 R).
template <int R>
__global__ void __launch_bounds__(32)
topk_merge_warp_kernel(const MergeParams p, const int* __restrict__ cms,
                       const int* __restrict__ pool, int* topk_ids,
                       int* topk_est, float* ids_acc,
                       const long long* __restrict__ count, float* total,
                       int first) {
  __shared__ int s_ids[32 * R];  // [carried | candidates]
  const int lane = threadIdx.x;
  const int topk = p.topk, P = p.k_pool, M = topk + p.cand_n;
  int rp = 0, ru = 1;
  while (32 * rp < P) rp = rp ? 2 * rp : 1;
  while (32 * ru < M) ru *= 2;
  for (int e = lane; e < topk; e += 32) s_ids[e] = topk_ids[e];
  int cest[R];
  unsigned long long k[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    cest[r] = e < topk ? topk_est[e] : 0;
    k[r] = r < rp && e < P ? static_cast<unsigned long long>(flip(pool[e]))
                             : kNoKey;
  }
  // 1. jnp.unique(pool, size=cand_n, fill_value=pad): sort, keep each
  // value's first copy (the pads past P sort after every value)
  warp_sort<R>(k, rp);
  const unsigned lt = (1u << lane) - 1u;
  int uniq = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rp) {
      const unsigned long long up1 = __shfl_up_sync(0xffffffffu, k[r], 1);
      const unsigned long long wrap =
          __shfl_sync(0xffffffffu, k[r > 0 ? r - 1 : 0], 31);
      const unsigned long long prev = lane > 0 ? up1 : wrap;
      const int j = r * 32 + lane;
      const bool keep = j < P && (j == 0 || k[r] != prev);
      const unsigned b = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        s_ids[topk + uniq + __popc(b & lt)] =
            unflip(static_cast<uint32_t>(k[r]));
      }
      uniq += __popc(b);
    }
  }
  for (int c = uniq + lane; c < p.cand_n; c += 32) s_ids[topk + c] = kPad;
  __syncwarp();
  // 2. scores: carried slots re-query (the carried estimate a floor);
  // candidates that repeat a carried id, and pads, score -1
  int id[R];
  bool need[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    id[r] = e < M ? s_ids[e] : 0;
    need[r] = e < topk ? id[r] >= 0 : e < M && id[r] != kPad;
  }
  for (int q = 0; q < topk; ++q) {
    const int c = s_ids[q];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r * 32 + lane >= topk && id[r] == c) need[r] = false;
    }
  }
  int est[R];
#pragma unroll
  for (int r = 0; r < R; ++r) est[r] = 0x7fffffff;
#pragma unroll 4
  for (int d = 0; d < p.depth; ++d) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (need[r]) {
        const uint32_t u = static_cast<uint32_t>(id[r] < 0 ? 0 : id[r]);
        const int v = __ldg(cms + static_cast<int64_t>(d) * p.cols.buckets +
                            fast_col(hash_of(u, d), p.cols));
        est[r] = v < est[r] ? v : est[r];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    const int s = !need[r] ? -1 : e < topk ? max(est[r], cest[r]) : est[r];
    k[r] = e < M ? sel_key(s, static_cast<uint32_t>(e)) : kNoKey;
  }
  // 3. the top `topk` of [carried | candidates]
  warp_sort<R>(k, ru);
  SelectOut o{topk_ids, topk_est, s_ids, topk};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    if (e < topk) write_top(o, e, k[r]);
  }
  // 4. the live count, rounded once
  fold_count(load_count(count, p.n_count, ids_acc, total, first),
             ids_acc, total, first);
}

'''
WARP_SORT = vs.replace(
    ("// Past one CTA. Sorts tiles of kSortTile keys in shared memory",
     WARP_KERNEL + "// Past one CTA. Sorts tiles of kSortTile keys in shared "
     "memory"),
    ("""    topk_merge_block_kernel<<<1, threads, 0, st>>>(p, c, pl, ti, te, acc, cnt,
                                                   tot, first);""",
     """    if (threads <= 256) {
      topk_merge_warp_kernel<8><<<1, 32, 0, st>>>(p, c, pl, ti, te, acc, cnt,
                                                  tot, first);
    } else {
      topk_merge_warp_kernel<16><<<1, 32, 0, st>>>(p, c, pl, ti, te, acc,
                                                   cnt, tot, first);
    }"""))


#: clock64() of thread 0 of the one-CTA merge at its phases' ends
STAMPS = (
    ("  const int v = t < P ? pool[t] : kPad;\n",
     "  STAMP(0);\n  const int v = t < P ? pool[t] : kPad;\n"),
    ("  if (t < topk) s_ids[t] = topk_ids[t];\n  __syncthreads();\n",
     "  if (t < topk) s_ids[t] = topk_ids[t];\n  __syncthreads();\n"
     "  STAMP(1);\n"),
    ("  const int uniq = __syncthreads_count(keep);\n",
     "  const int uniq = __syncthreads_count(keep);\n  STAMP(2);\n"),
    ("    s_ids[topk + c] = kPad;\n  }\n  __syncthreads();\n",
     "    s_ids[topk + c] = kPad;\n  }\n  __syncthreads();\n  STAMP(3);\n"),
    ("  s_keys[t] = key;  // kNoKey past M counts below no key\n"
     "  __syncthreads();\n",
     "  s_keys[t] = key;  // kNoKey past M counts below no key\n"
     "  __syncthreads();\n  STAMP(4);\n"),
    ("  // 4. the live count, rounded once\n  if (t < 32)",
     "  STAMP(5);\n  // 4. the live count, rounded once\n  if (t < 32)"),
    ("  if (t < 32) fold_count(in, ids_acc, total, first);\n}",
     "  if (t < 32) fold_count(in, ids_acc, total, first);\n"
     "  STAMP(6);\n}"),
    ("constexpr int kRankBatch = 8;",
     "__device__ long long g_stamps[16];\n#define STAMP(k) if (threadIdx.x"
     " == 0) g_stamps[k] = clock64()\nconstexpr int kRankBatch = 8;"))
STAMP_PHASES = ("loads", "keep_flags", "unique_places", "scores",
                "ranks_and_outputs", "count")


def stamps_patch(text, what):
    text = vs.replace(*STAMPS)(text, what)
    return text + ("\nextern \"C\" int detpu_sketch_stamps(void* host) {\n"
                   "  return cudaMemcpyFromSymbol(host, g_stamps, "
                   "sizeof(g_stamps));\n}\n")


K15_VARIANTS = {"tree": None, "warp_sort": WARP_SORT,
                "tile512": vs.constants(kSortTile=512),
                "tile2048": vs.constants(kSortTile=2048),
                "stamps": stamps_patch}
BATCH = 16384
RAGGED_PER_FEATURE = 1_021_637


def streams(torch, cs):
    """The one-hot and the ragged streams: name -> (ids, live)."""
    gen = torch.Generator(device="cuda").manual_seed(2000)
    sizes = cs.ragged_sizes()
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    out = {}
    for name, per in (("one-hot", BATCH), ("ragged", RAGGED_PER_FEATURE)):
        ids = torch.cat([cs.device_power_law(torch, gen, v, per) + int(o)
                         for v, o in zip(sizes, offs)])
        live = torch.ones(ids.numel(), dtype=torch.bool, device="cuda")
        if name == "ragged":
            live = torch.rand(ids.numel(), generator=gen,
                              device="cuda") >= 0.02
        out[name] = (ids.contiguous(), live)
    return out


def run_k13(torch, cs, kernels, sk, parent, data):
    libs = vs.build(kernels, "sketch", K13_VARIANTS, "sketch_variants_k13")
    for (name, (ids, live)), buckets in (
            ((k, v), b) for k, v in data.items() for b in (2048, 2047)):
        if name == "ragged" and buckets != 2048:
            continue
        want = torch.zeros((4, buckets), dtype=torch.int32, device="cuda")
        n_live = int(sk.cms_update_plain(want, ids, live))
        fns, grids = {}, {}
        for var, lib in libs.items():
            with rv.library(kernels, "sketch", lib):
                rec = sk.build_update_record(want, ids, live)
            grids[var] = lib.detpu_cms_update_grid(rec.payload[0].ctypes.data)
            got = torch.zeros_like(want)
            count = torch.zeros(1, dtype=torch.int64, device="cuda")
            for _ in range(2):  # a second call: the ticket carries over
                got.zero_()
                rec.replay(got.data_ptr(), ids.data_ptr(), live.data_ptr(),
                           count.data_ptr())
            torch.cuda.synchronize()
            if not torch.equal(got, want) or int(count) != n_live:
                raise SystemExit(f"K13 {var} {name} {buckets}: differs from "
                                 "the plain version")
            fns[var] = (lambda rec=rec, got=got, count=count: rec.replay(
                got.data_ptr(), ids.data_ptr(), live.data_ptr(),
                count.data_ptr()))
        sketch = torch.zeros_like(want)
        fns["wrapper"] = lambda: sk.cms_update(sketch, ids, live)
        if parent is not None:
            psk = parent["sketch"]
            psketch = torch.zeros_like(want)
            fns["parent_wrapper"] = lambda: psk.cms_update(psketch, ids,
                                                           live)
        out = rv.timed(torch, cs, fns)
        host = {k: cs.host_ms(torch, fns[k]) for k in fns
                if k.endswith("wrapper")}
        print(json.dumps({"kernel": "K13", "stream": name, "n": ids.numel(),
                          "buckets": buckets, "grids": grids, "times": out,
                          "host_ms": host}), flush=True)


def run_k15(torch, cs, kernels, sk, parent, data):
    libs = vs.build(kernels, "sketch", K15_VARIANTS, "sketch_variants_k15")
    ids, live = data["one-hot"]
    for topk, cand in ((32, 128), (2048, 8192), (32, 16384)):
        cms = torch.zeros((4, 2048), dtype=torch.int32, device="cuda")
        counts = sk.cms_update_plain(cms, ids, live)
        pool = sk.topk_pool(cms, ids, live, min(cand, ids.numel()))
        gen = np.random.default_rng(topk + cand)
        tids = np.full(topk, -1, np.int32)
        tids[:topk // 2] = np.asarray(pool[:topk // 2].cpu())[::-1]
        tids[topk // 2:topk // 2 + topk // 4] = gen.integers(
            0, 10 ** 7, topk // 4)
        state = (torch.as_tensor(tids, device="cuda"),
                 torch.as_tensor(gen.integers(0, 50, topk), dtype=torch.int32,
                                 device="cuda"),
                 torch.zeros(1, device="cuda"))
        want = [t.clone() for t in state]
        sk.topk_merge_plain(cms, pool, counts, *want, cand)
        fns = {}
        for var, lib in libs.items():
            with rv.library(kernels, "sketch", lib):
                rec = sk.build_merge_record(cms, pool, counts, *state, cand)
            got = [t.clone() for t in state]
            out_c = torch.empty(1, device="cuda")
            rec.replay(cms.data_ptr(), pool.data_ptr(), *(
                t.data_ptr() for t in got), counts.data_ptr(),
                out_c.data_ptr(), 1)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"K15 {var} {topk}/{cand}: differs from "
                                 "the plain version")
            run = [t.clone() for t in state]
            fns[var] = (lambda rec=rec, run=run, out_c=out_c: rec.replay(
                cms.data_ptr(), pool.data_ptr(), *(t.data_ptr() for t in run),
                counts.data_ptr(), out_c.data_ptr(), 1))
        w = [t.clone() for t in state]
        fns["wrapper"] = lambda: sk.topk_merge(cms, pool, counts, *w, cand)
        if parent is not None:
            psk = parent["sketch"]
            pw = [t.clone() for t in state]
            pcounts = counts.reshape(1)
            fns["parent_wrapper"] = lambda: psk.topk_merge(
                cms, pool, pcounts, *pw, cand)
        lib_all = torch.cat([state[1], pool])

        def library():
            torch.unique(pool)
            return torch.topk(lib_all, topk)

        fns["library_single"] = library
        stamps = fns.pop("stamps")
        out = rv.timed(torch, cs, fns)
        host = {k: cs.host_ms(torch, fns[k]) for k in fns
                if k.endswith("wrapper")}
        extra = {}
        if sk.merge_path(topk, cand) == "block":
            extra["phase_cycles"] = phase_split(torch, libs["stamps"],
                                                stamps)
        else:
            extra["device_split"] = kernel_split(torch, fns["tree"])
        bound = cs.merge_bytes(4, 2048, topk, pool.numel(), 1) \
            / cs.HBM_BYTES_PER_S * 1e3
        print(json.dumps({"kernel": "K15", "topk": topk, "candidates": cand,
                          "path": sk.merge_path(topk, cand), "times": out,
                          "host_ms": host, "bound_ms": bound, **extra}),
              flush=True)
    print(json.dumps({"kernel": "K15", "sass": {
        "tree": sass_counts(kernels._lib_path("sketch")),
        "warp_sort": sass_counts(os.path.join(
            vs.HERE, "build", "sketch_variants_k15", "sketch", "warp_sort",
            "sketch.so"))}}), flush=True)


def phase_split(torch, lib, fn, calls=20):
    """Thread 0's cycles in each phase of the one-CTA merge (the
    ``stamps`` build), the median over ``calls`` calls."""
    lib.detpu_sketch_stamps.argtypes = [ctypes.c_void_p]
    per = []
    for _ in range(calls):
        fn()
        torch.cuda.synchronize()
        host = (ctypes.c_longlong * 16)()
        err = lib.detpu_sketch_stamps(ctypes.addressof(host))
        if err:
            raise SystemExit(f"stamps: cudaError_t {err}")
        st = list(host)[:len(STAMP_PHASES) + 1]
        per.append([st[k + 1] - st[k] for k in range(len(STAMP_PHASES))])
    cyc = np.median(np.array(per, dtype=np.float64), axis=0)
    return {name: float(c) for name, c in zip(STAMP_PHASES, cyc)}


def kernel_split(torch, fn, calls=10):
    """Device ms a call of ``fn`` by kernel (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.split("::")[-1].split("(")[0][:40]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 \
                / calls
    return out


def sass_counts(path):
    """Instruction counts by opcode of K15's default-path kernels (the
    one-CTA or the one-warp merge) in the library at ``path``
    (``cuobjdump -sass``), or why there are none."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        return "cuobjdump not found"
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=120).stdout
    out, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if ("topk_merge_warp_kernel" in fn
                        or "topk_merge_block_kernel" in fn) else None
        elif fn is not None and "/*" in line and ";" in line:
            op = line.split("*/")[1].strip().split()[0] if "*/" in line \
                else ""
            op = op.split(".")[0].lstrip("@!P0123456789 ")
            if op:
                counts = out.setdefault(fn[:60], {})
                counts[op] = counts.get(op, 0) + 1
    return out


def run_fold(torch, cs, tel, ptel, data):
    """The width fold's host ms a call (``_record``) against the parent's
    in turns, and its event ms."""
    ids, live = data["one-hot"]
    cfg = tel.TelemetryConfig()

    def state():
        return {"cms": torch.zeros((4, 2048), dtype=torch.int32,
                                   device="cuda"),
                "topk_ids": torch.full((32,), -1, dtype=torch.int32,
                                       device="cuda"),
                "topk_est": torch.zeros(32, dtype=torch.int32,
                                        device="cuda"),
                "ids": torch.zeros(1, device="cuda")}

    ws, total = state(), torch.empty(1, device="cuda")
    fns = {"fold_wrapper": lambda: tel._record(ws, ids, live, cfg, total)}
    if ptel is not None:
        pws = state()
        fns["parent_fold_wrapper"] = lambda: ptel._record(pws, ids, live,
                                                          cfg)
    host = {}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            host.setdefault(k, []).append(cs.host_ms(torch, fns[k]))
    print(json.dumps({"fold": "one-hot", "host_ms": {
        k: float(np.median(v)) for k, v in host.items()},
        "ms": {k: cs.time_ms(torch, f, [()]) for k, f in fns.items()}}),
        flush=True)


def main():
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("sketch_variants.py needs a CUDA card")
    argv = sys.argv[1:]
    only = {"k13", "k15", "fold"}
    while argv:
        if len(argv) >= 2 and argv[0] == "--parent":
            cs.PARENT_DIR = os.path.abspath(argv[1])
        elif len(argv) >= 2 and argv[0] == "--only":
            only = set(argv[1].split(","))
        else:
            raise SystemExit("usage: python3 sketch_variants.py [--parent "
                             "DIR] [--only k13,k15,fold]")
        argv = argv[2:]
    print(vs.card_line(), flush=True)
    kernels = importlib.import_module(
        "distributed_embeddings_torch.ops._kernels")
    sk = importlib.import_module("distributed_embeddings_torch.ops.sketch")
    tel = importlib.import_module(
        "distributed_embeddings_torch.analysis.telemetry")
    parent = cs.parent_ops()
    ptel = (importlib.import_module("detpu_parent.analysis.telemetry")
            if parent is not None else None)
    data = streams(torch, cs)
    if "k13" in only:
        run_k13(torch, cs, kernels, sk, parent, data)
    if "k15" in only:
        run_k15(torch, cs, kernels, sk, parent, data)
    if "fold" in only:
        run_fold(torch, cs, tel, ptel, data)


if __name__ == "__main__":
    main()
