#!/usr/bin/env python3
"""K16's variants (the streaming slot-map remap, ``csrc/streaming.cu``):
patched builds of the update kernel (``variants.py``), held bit-equal to
the tree's build and to the plain version, and timed against it in turns
on one NVIDIA GPU.

The tree: ONE cooperative launch of persistent CTAs (at most 4 a SM, as
the occupancy allows) in four phases behind grid-wide barriers
(grid.sync()), a thread holding its first kHold = 4 positions in
registers across the phases. Variants:

- ``ctas2``, ``ctas8``: CTAs a SM at most (``__launch_bounds__``'s floor
  follows: 8 caps a thread at 32 registers);
- ``hold2`` (the streaming step's 327,680 positions then pass what the
  grid holds in registers, so the rest go through the record's
  scratch), ``hold8``: positions a thread holds in registers;
- ``no_match``: the sketch fold as one atomic add a lane and word, with
  no warp merge of equal words;
- ``threads512``, ``threads1024``: 2 CTAs of 512 threads, 1 of 1024, a
  SM (fewer CTAs at each barrier);
- ``ticket``: a plain launch with a never-reset ticket barrier (the
  first design: thread 0 of each CTA takes a ticket and polls every 32
  ns until the count reaches the next multiple of the grid) in place of
  the cooperative launch's grid.sync(); whether the tree's and the
  ticket's launches replay in a CUDA graph is tried last;
- ``stamps``: the tree with CTA 0's ``clock64()`` taken at its start and
  after each phase (the barriers' exits and its own end of phase 4), the
  device split by phase;
- diagnostics, timed but not held to the plain version (their outputs
  are not the function's): ``diag_no_fold`` (the sketch fold left out),
  ``diag_phase1`` and ``diag_phases12`` (the launch stopped after phase 1
  and after phase 2; the claim scratch is reset after them).

Inputs: the streaming DLRM's width-128 stream: five streaming tables of
1,882,353 slots + 117,647 buckets (the capped Criteo-Kaggle features 2, 3,
11, 15 and 20) stacked in a 10,569,296-row slot map, 65,536 Zipfian ids
(alpha 1.05) a feature over its full vocabulary (327,680 positions), the
slot map warmed by 30 steps of remap and commit so that most positions
hit, as in the step; the sketch 4 x 4096. Each variant runs on the same
inputs from the same staged sketch and must give the tree's bits and the
plain version's (every output and the folded sketch).

Timing (as ``row_variants.py``): ``ms`` the CUDA-event time of 20
back-to-back launches over 20, ``device_ms`` ``torch.profiler``'s device
time a launch; variants in turns (each, then each again in reverse). The
wrappers (``wrapper``: ``remap_stage``; ``parent_wrapper`` with ``--parent
DIR``: that checkout's, which folds with its own K13) are timed in the
same turns, event ms a call with the host, for the update and the
read-only remap.

K17's variants (the guard-gated commit: ONE cooperative launch of
persistent CTAs, the claims' slot map and row resets, the sketch copy and
the counts, then the hits' max behind one grid.sync(); a thread holding
its first kCommitHold = 4 hits across the barrier; each hit's atomicMax
taken only where its estimate passes the slot's value read first):

- ``ctas2``: 2 CTAs a SM at most; ``threads512``: 2 CTAs of 512;
- ``hold8``: 8 hits a thread held in registers;
- ``warp_merge``: the lanes of a warp that hit one row merged first
  (``__match_any_sync``, ``__reduce_max_sync``), one max a row;
- ``warp_merge_no_preread``: merged, the max on every hit row without
  reading the slot first (the kernel's first form);
- ``no_preread``: the max on every hit, unmerged, without the read;
- ``ticket``: a plain launch with K16's never-reset ticket barrier in
  place of grid.sync() (the ticket variant of K16 above, the commit's
  launch made plain too).

K17's input: the commit of the step above's staged transitions (its
claims and hits) on a float32 w128 slab of ROWS_CAP rows and one float32
leaf (Adagrad's accumulator, fill 0.1), enable on the card; each variant
is held bit for bit to the plain version from the same state. Timed as
K16's, with the wrappers (``wrapper``: ``commit_rows``;
``parent_wrapper``: that checkout's three launches).

Run from the root of a checkout: ``python3 stream_variants.py [--parent
DIR] [--only k16,k17]``. Prints the card's name and power limit, then
one JSON line a mode and variant, the stamps' phase split, and the graph
trials.
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

STAMP_BEFORE = (
    ("  grid_barrier();\n  // 2. estimates and claims",
     "  grid_barrier();\n  STAMP(1);\n  // 2. estimates and claims"),
    ("  grid_barrier();\n  // 3. the position max",
     "  grid_barrier();\n  STAMP(2);\n  // 3. the position max"),
    ("  grid_barrier();\n  // 4. outputs, resets, counts",
     "  grid_barrier();\n  STAMP(3);\n  // 4. outputs, resets, "
     "counts"),
    ("  __shared__ unsigned warp_sums[4][kRemapThreads / 32];\n",
     "  STAMP(4);\n  __shared__ unsigned warp_sums[4][kRemapThreads / 32];"
     "\n"),
    ("  Pos reg[kHold] = {};\n", "  Pos reg[kHold] = {};\n  STAMP(0);\n"),
    ("constexpr int kHold = 4;            // positions a thread keeps in "
     "registers\n",
     "constexpr int kHold = 4;            // positions a thread keeps in "
     "registers\n__device__ long long g_stamps[8];\n#define STAMP(k) "
     "if (blockIdx.x == 0 && threadIdx.x == 0) g_stamps[k] = clock64()\n"),
)


def stamps_patch(text, what):
    text = vs.replace(*STAMP_BEFORE)(text, what)
    return text + ("\nextern \"C\" int detpu_stream_stamps(void* host) {\n"
                   "  return cudaMemcpyFromSymbol(host, g_stamps, "
                   "sizeof(g_stamps));\n}\n")


#: a plain launch and a never-reset 64-bit ticket as the grid-wide
#: barrier (in a device global here), in place of the cooperative launch
TICKET = vs.replace(
    ("// The grid-wide barrier of the cooperative launch.\n"
     "__device__ __forceinline__ void grid_barrier() {\n"
     "  cooperative_groups::this_grid().sync();\n}\n",
     "__device__ unsigned long long g_ticket = 0;\n"
     "__device__ __forceinline__ void grid_barrier() {\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n"
     "    __threadfence();\n"
     "    const unsigned long long g = gridDim.x;\n"
     "    const unsigned long long open =\n"
     "        (atomicAdd(&g_ticket, 1ull) / g + 1) * g;\n"
     "    while (true) {\n"
     "      unsigned long long v;\n"
     "      asm volatile(\"ld.acquire.gpu.global.u64 %0, [%1];\"\n"
     "                   : \"=l\"(v) : \"l\"(&g_ticket) : \"memory\");\n"
     "      if (v >= open) break;\n"
     "      __nanosleep(32);\n"
     "    }\n"
     "    __threadfence();\n"
     "  }\n"
     "  __syncthreads();\n"
     "}\n"),
    ("  return cudaLaunchCooperativeKernel(kernel, c->grid, kRemapThreads, "
     "args, 0,\n                                     st);",
     "  return cudaLaunchKernel(kernel, c->grid, kRemapThreads, args, 0, "
     "st);"))

#: the sketch fold as one atomic add a lane and word
NO_MATCH = vs.replace(
    ("    const unsigned peers = __match_any_sync(mask, col);\n"
     "    if (lane == __ffs(peers) - 1) {\n"
     "      atomicAdd(cms + static_cast<int64_t>(d) * buckets + col,\n"
     "                __popc(peers));\n    }\n",
     "    atomicAdd(cms + static_cast<int64_t>(d) * buckets + col, 1 + 0 * "
     "lane);\n"))

VARIANTS = {
    "tree": None,
    "ctas2": vs.constants(kRemapCtasPerSm=2),
    "ctas8": vs.constants(kRemapCtasPerSm=8),
    "hold2": vs.constants(kHold=2),
    "hold8": vs.constants(kHold=8),
    "no_match": NO_MATCH,
    "threads512": vs.constants(kRemapThreads=512, kRemapCtasPerSm=2),
    "threads1024": vs.constants(kRemapThreads=1024, kRemapCtasPerSm=1),
    "ticket": TICKET,
    "stamps": stamps_patch,
}

#: diagnostics, timed only (their outputs are not the function's): the
#: fold left out, the launch stopped after phase 1 and after phase 2 (the
#: claim scratch is reset after them)
DIAGNOSTICS = {
    "diag_no_fold": vs.replace(
        ("  const unsigned mask = __ballot_sync(0xffffffffu, ok);\n"
         "  if (!ok) return;\n",
         "  return;\n  const unsigned mask = __ballot_sync(0xffffffffu, "
         "ok);\n  if (!ok) return;\n")),
    "diag_phase1": vs.replace(
        ("  grid_barrier();\n  // 2. estimates and claims",
         "  grid_barrier();\n  return;\n  // 2. estimates and claims")),
    "diag_phases12": vs.replace(
        ("  grid_barrier();\n  // 3. the position max",
         "  grid_barrier();\n  return;\n  // 3. the position max")),
}

#: K17: the cooperative launch made plain, with K16's ticket barrier
K17_TICKET = vs.replace(
    ("// The grid-wide barrier of the cooperative launch.\n__device__ __forceinline__ void grid_barrier() {\n"
     "  cooperative_groups::this_grid().sync();\n}\n",
     "__device__ unsigned long long g_ticket = 0;\n"
     "__device__ __forceinline__ void grid_barrier() {\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n"
     "    __threadfence();\n"
     "    const unsigned long long g = gridDim.x;\n"
     "    const unsigned long long open =\n"
     "        (atomicAdd(&g_ticket, 1ull) / g + 1) * g;\n"
     "    while (true) {\n"
     "      unsigned long long v;\n"
     "      asm volatile(\"ld.acquire.gpu.global.u64 %0, [%1];\"\n"
     "                   : \"=l\"(v) : \"l\"(&g_ticket) : \"memory\");\n"
     "      if (v >= open) break;\n"
     "      __nanosleep(32);\n"
     "    }\n"
     "    __threadfence();\n"
     "  }\n"
     "  __syncthreads();\n"
     "}\n"),
    ("  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>("
     "commit_kernel),",
     "  return cudaLaunchKernel(reinterpret_cast<void*>(commit_kernel),"))

K17_VARIANTS = {
    "tree": None,
    "ctas2": vs.constants(kCommitCtasPerSm=2),
    "threads512": vs.constants(kCommitThreads=512, kCommitCtasPerSm=2),
    "hold8": vs.constants(kCommitHold=8),
    "warp_merge": vs.replace(
        ("  if (r >= 0 && r < c.rows_cap && e > __ldcg(q.slot_freq + r)) {\n"
         "    atomicMax(q.slot_freq + r, e);\n  }\n",
         "  const bool ok = r >= 0 && r < c.rows_cap;\n"
         "  const unsigned mask = __ballot_sync(__activemask(), ok);\n"
         "  if (!ok) return;\n"
         "  const unsigned peers = __match_any_sync(mask, r);\n"
         "  const int best = __reduce_max_sync(peers, e);\n"
         "  if ((threadIdx.x & 31) == __ffs(peers) - 1 &&\n"
         "      best > __ldcg(q.slot_freq + r)) {\n"
         "    atomicMax(q.slot_freq + r, best);\n  }\n")),
    "warp_merge_no_preread": vs.replace(
        ("  if (r >= 0 && r < c.rows_cap && e > __ldcg(q.slot_freq + r)) {\n"
         "    atomicMax(q.slot_freq + r, e);\n  }\n",
         "  const bool ok = r >= 0 && r < c.rows_cap;\n"
         "  const unsigned mask = __ballot_sync(__activemask(), ok);\n"
         "  if (!ok) return;\n"
         "  const unsigned peers = __match_any_sync(mask, r);\n"
         "  const int best = __reduce_max_sync(peers, e);\n"
         "  if ((threadIdx.x & 31) == __ffs(peers) - 1) "
         "atomicMax(q.slot_freq + r, best);\n")),
    "no_preread": vs.replace(
        ("  if (r >= 0 && r < c.rows_cap && e > __ldcg(q.slot_freq + r)) {\n",
         "  if (r >= 0 && r < c.rows_cap) {\n")),
    "ticket": K17_TICKET,
}

KAGGLE_FEATURES = (2, 3, 11, 15, 20)   # the streaming DLRM's over-cap five
CAPACITY, BUCKETS = 1_882_353, 117_647
ROWS_CAP = 10_569_296
BATCH = 65_536
WARM_STEPS = 30


def stream_case(torch, cs, sops, gen):
    """One step's width stream over the five streaming tables, as
    ``remap_stage``'s leading arguments (ext, live, cap, nb, tid, roff)."""
    ext, tid, roff = [], [], []
    for k, f in enumerate(KAGGLE_FEATURES):
        ext.append(cs.device_power_law(torch, gen, cs.CRITEO_KAGGLE_SIZES[f],
                                       BATCH))
        tid.append(torch.full((BATCH,), f, dtype=torch.int32, device="cuda"))
        roff.append(torch.full((BATCH,), k * (CAPACITY + BUCKETS),
                               dtype=torch.int32, device="cuda"))
    ext = torch.cat(ext).to(torch.int32)
    n = ext.numel()
    i32 = torch.int32
    return (ext, torch.ones(n, dtype=torch.bool, device="cuda"),
            torch.full((n,), CAPACITY, dtype=i32, device="cuda"),
            torch.full((n,), BUCKETS, dtype=i32, device="cuda"),
            torch.cat(tid), torch.cat(roff))


def warm_state(torch, cs, sops, gen, pol):
    """A slot map and sketch after WARM_STEPS steps of remap and commit
    (the tree's kernels), as the step leaves them."""
    slot_fp = torch.full((ROWS_CAP,), -1, dtype=torch.int32, device="cuda")
    slot_freq = torch.zeros(ROWS_CAP, dtype=torch.int32, device="cuda")
    cms = torch.zeros((4, 4096), dtype=torch.int32, device="cuda")
    slab = torch.zeros((ROWS_CAP, 1), device="cuda")
    totals = torch.zeros(4, device="cuda")
    counters = [torch.zeros(1, device="cuda") for _ in range(4)]
    steps = torch.zeros(1, dtype=torch.int32, device="cuda")
    for _ in range(WARM_STEPS):
        s = stream_case(torch, cs, sops, gen)
        staged = cms.clone()
        r = sops.remap_stage(*s, slot_fp, slot_freq, staged, *pol)
        sops.commit_rows(slab, [], r, slot_fp, slot_freq, cms, staged,
                         totals, counters, steps)
    torch.cuda.synchronize()
    return slot_fp, slot_freq, cms, [float(c) for c in counters]


def sm_clock_mhz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    try:
        return float(out.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def graph_trial(torch, fn, check):
    """Whether ``fn`` captured in a CUDA graph replays to ``check()``'s
    satisfaction twice; the error text where it does not."""
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            if not check():
                return {"replays": False, "error": "bits differ"}
        return {"replays": True}
    except Exception as e:  # the trial's result is the report
        torch.cuda.synchronize()
        return {"replays": False, "error": str(e)[:300]}


def run_k17(torch, cs, sops, kernels, parent, pend, slot_fp, slot_freq,
            cms, staged):
    """K17's variants on the commit of ``pend`` (the step's staged
    transitions), each held to the plain version from the same state."""
    libs = vs.build(kernels, "streaming", K17_VARIANTS, "stream_variants_k17")
    slab = torch.zeros((ROWS_CAP, 128), device="cuda")
    acc = torch.full_like(slab, 0.1)
    on = torch.tensor(True, device="cuda")
    totals = torch.zeros(4, device="cuda")
    counters = [torch.zeros(1, device="cuda") for _ in range(4)]
    steps = torch.zeros(1, dtype=torch.int32, device="cuda")
    base = [t.clone() for t in (slot_fp, slot_freq, cms)]
    out = [slot_fp, slot_freq, cms, totals, steps, *counters]
    args = (slab, [(acc, 0.1)], pend, slot_fp, slot_freq, cms, staged,
            totals, counters, steps)

    def reset():
        for t, b in zip((slot_fp, slot_freq, cms), base):
            t.copy_(b)
        for t in [totals, steps, *counters]:
            t.zero_()

    # the claimed rows' resets leave a zero slab row and a 0.1
    # accumulator row as they were: only the slot map, sketch and counts
    # need a reset between launches
    reset()
    sops.commit_rows_plain(*args, enable=on)
    want = [t.clone() for t in out]
    claims = int((pend.scrub_rows < ROWS_CAP).sum())
    hits = int((pend.hit_rows < ROWS_CAP).sum())
    n = pend.scrub_rows.numel()
    ts = sops._commit_tensors(*args, on)
    fns = {}
    for name, lib in libs.items():
        with rv.library(kernels, "streaming", lib):
            rec = sops.build_commit_record(*args, enable=on)
        tail = (*(t.data_ptr() for t in ts), *rec.payload[1])
        reset()
        rec.replay(*tail)
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(out, want)):
            if not torch.equal(a, b):
                raise SystemExit(f"K17 {name}: output {k} differs from the "
                                 "plain version")
        fns[name] = lambda rec=rec, tail=tail: rec.replay(*tail)
    fns["wrapper"] = lambda: sops.commit_rows(*args, enable=on)
    if parent is not None:
        fns["parent_wrapper"] = lambda: parent["streaming"].commit_rows(
            *args, enable=on)
    nbytes = cs.commit_bytes(torch, pend, ROWS_CAP, 2 * 128 * 4,
                             cms.numel())
    for name, t in rv.timed(torch, cs, fns).items():
        print(json.dumps({"kernel": "K17", "variant": name, "positions": n,
                          "claims": claims, "hits": hits, "bytes": nbytes,
                          "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                          **t}), flush=True)
    for name in ("tree", "ticket"):
        def same():
            ok = all(torch.equal(a, b) for a, b in zip(out, want))
            reset()
            return ok

        reset()
        print(json.dumps({"kernel": "K17", "variant": name,
                          "cuda_graph": graph_trial(torch, fns[name],
                                                    same)}), flush=True)
    reset()
    torch.cuda.synchronize()
    del slab, acc


def main():
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("stream_variants.py needs a CUDA card")
    argv = sys.argv[1:]
    only = {"k16", "k17"}
    while argv:
        if len(argv) >= 2 and argv[0] == "--parent":
            cs.PARENT_DIR = os.path.abspath(argv[1])
        elif len(argv) >= 2 and argv[0] == "--only":
            only = set(argv[1].split(","))
        else:
            raise SystemExit("usage: python3 stream_variants.py [--parent "
                             "DIR] [--only k16,k17]")
        argv = argv[2:]
    print(vs.card_line(), flush=True)
    kernels = importlib.import_module(
        "distributed_embeddings_torch.ops._kernels")
    sops = importlib.import_module("distributed_embeddings_torch.ops."
                                   "streaming")
    parent = cs.parent_ops()
    gen = torch.Generator(device="cuda").manual_seed(1600)
    pol = (2, 1)
    slot_fp, slot_freq, cms, counters = warm_state(torch, cs, sops, gen, pol)
    s = stream_case(torch, cs, sops, gen)
    a0 = s + (slot_fp, slot_freq)
    n = s[0].numel()
    want_cms = cms.clone()
    want = sops.remap_stage_plain(*a0, want_cms, *pol)
    hits = int((want.hit_rows < ROWS_CAP).sum())
    print(json.dumps({"positions": n, "hits": hits,
                      "claims": int((want.scrub_rows < ROWS_CAP).sum()),
                      "warm_counters": counters}), flush=True)
    if "k17" in only:
        # the step's claims, then only its first 246 (a streaming DLRM
        # step's commit after its warm-up claims a few hundred rows)
        claimed = torch.nonzero(want.scrub_rows < ROWS_CAP).flatten()
        few = want._replace(scrub_rows=want.scrub_rows.clone())
        few.scrub_rows[claimed[246:]] = ROWS_CAP
        for pend in (want, few):
            run_k17(torch, cs, sops, kernels, parent, pend, slot_fp,
                    slot_freq, cms.clone(), want_cms)
            torch.cuda.empty_cache()
    if "k16" not in only:
        return
    libs = vs.build(kernels, "streaming", {**VARIANTS, **DIAGNOSTICS},
                    "stream_variants")
    diag = {k: libs.pop(k) for k in DIAGNOSTICS}
    libs["stamps"].detpu_stream_stamps.argtypes = [ctypes.c_void_p]
    fns, staged_t = {}, cms.clone()
    buf_t, _ = sops.update_outputs(n, "cuda")
    recs = {}
    for name, lib in libs.items():
        with rv.library(kernels, "streaming", lib):
            rec = sops.build_remap_record(*a0, cms, *pol)
        staged = cms.clone()
        buf, out = sops.update_outputs(n, "cuda")
        rec.replay(*(t.data_ptr() for t in a0), staged.data_ptr(),
                   buf.data_ptr())
        torch.cuda.synchronize()
        for f in sops.Remap._fields:
            if not torch.equal(getattr(out, f), getattr(want, f)):
                raise SystemExit(f"K16 {name}: {f} differs from the plain "
                                 "version (and the tree)")
        if not torch.equal(staged, want_cms):
            raise SystemExit(f"K16 {name}: the folded sketch differs")
        fns[name] = (lambda rec=rec: rec.replay(
            *(t.data_ptr() for t in a0), staged_t.data_ptr(),
            buf_t.data_ptr()))
    staged_w = cms.clone()
    fns["wrapper"] = lambda: sops.remap_stage(*a0, staged_w, *pol)
    if parent is not None:
        staged_p = cms.clone()
        fns["parent_wrapper"] = lambda: parent["streaming"].remap_stage(
            *a0, staged_p, *pol)
    esz = s[0].element_size()
    upd_bytes = n * (esz + 1 + 16 + 4 + 4 + 4 * 5) + 32 + 2 * 4 * 4096 * 4
    ro_bytes = n * (esz + 1 + 16 + 4 + 4)
    for name, t in rv.timed(torch, cs, fns).items():
        print(json.dumps({"kernel": "K16", "mode": "update", "variant": name,
                          "positions": n, "bytes": upd_bytes,
                          "bound_ms": upd_bytes / cs.HBM_BYTES_PER_S * 1e3,
                          **t}), flush=True)
    # the device split by phase: CTA 0's clock at its start and after
    # each phase, over a few launches of the stamps build
    per = []
    for _ in range(5):
        fns["stamps"]()
        torch.cuda.synchronize()
        host = (ctypes.c_longlong * 8)()
        err = libs["stamps"].detpu_stream_stamps(ctypes.addressof(host))
        if err:
            raise SystemExit(f"stamps: cudaError_t {err}")
        st = list(host)[:5]
        per.append([st[k + 1] - st[k] for k in range(4)])
    cyc = np.median(np.array(per, dtype=np.float64), axis=0)
    mhz = sm_clock_mhz()
    names = ("hash_and_fold", "estimates_and_claims", "position_max",
             "outputs_and_counts_cta0")
    print(json.dumps({"kernel": "K16", "phase_split": {
        k: {"cycles": float(c), "frac": float(c / cyc.sum()),
            "ms_at_sm_clock": (float(c / (mhz * 1e3)) if mhz else None)}
        for k, c in zip(names, cyc)}, "sm_clock_mhz": mhz}), flush=True)
    # the diagnostics, in turns with the tree; the claim scratch they
    # leave dirty is reset after
    dfns = {"tree": fns["tree"]}
    for name, lib in diag.items():
        with rv.library(kernels, "streaming", lib):
            rec = sops.build_remap_record(*a0, cms, *pol)
        dfns[name] = (lambda rec=rec: rec.replay(
            *(t.data_ptr() for t in a0), staged_t.data_ptr(),
            buf_t.data_ptr()))
    for name, t in rv.timed(torch, cs, dfns).items():
        print(json.dumps({"kernel": "K16", "mode": "update_diagnostic",
                          "variant": name, **t}), flush=True)
    best_key, best_pos = sops._claim_scratch(slot_fp.device, ROWS_CAP)
    best_key.zero_()
    best_pos.fill_(-1)
    torch.cuda.synchronize()
    # the read-only remap
    out_r = torch.empty(n, dtype=torch.int32, device="cuda")
    ro = {}
    ro_rec = sops.build_remap_record(*a0[:7], None, None, *pol, update=False)
    ro["tree"] = lambda: ro_rec.replay(*(t.data_ptr() for t in a0[:7]),
                                       None, None, out_r.data_ptr())
    ro["tree"]()
    torch.cuda.synchronize()
    if not torch.equal(out_r, want.local_rows):
        raise SystemExit("K16 read-only: local_rows differ from the plain "
                         "version")
    ro["wrapper"] = lambda: sops.remap_stage(*a0[:7], None, None, *pol,
                                             update=False)
    if parent is not None:
        ro["parent_wrapper"] = lambda: parent["streaming"].remap_stage(
            *a0, None, *pol, update=False)
    for name, t in rv.timed(torch, cs, ro).items():
        print(json.dumps({"kernel": "K16", "mode": "read_only",
                          "variant": name, "positions": n,
                          "bytes": ro_bytes,
                          "bound_ms": ro_bytes / cs.HBM_BYTES_PER_S * 1e3,
                          **t}), flush=True)
    # CUDA-graph trials, last: a refused capture may leave the stream
    # unusable
    for name in ("tree", "ticket"):
        staged_g, base = cms.clone(), cms.clone()
        buf_g, out_g = sops.update_outputs(n, "cuda")

        def launch(rec=recs[name]):
            rec.replay(*(t.data_ptr() for t in a0), staged_g.data_ptr(),
                       buf_g.data_ptr())

        def same():
            ok = all(torch.equal(getattr(out_g, f), getattr(want, f))
                     for f in sops.Remap._fields)
            ok = ok and torch.equal(staged_g, want_cms)
            staged_g.copy_(base)
            return ok

        print(json.dumps({"kernel": "K16", "variant": name,
                          "cuda_graph": graph_trial(torch, launch, same)}),
              flush=True)


if __name__ == "__main__":
    main()
