#!/usr/bin/env python3
"""K21's, K11's and K6's variants (the gradient-health reduction,
``csrc/grad_health.cu``, the SparseAdam row update, ``csrc/adam.cu``, and
the SparseAdagrad row update, ``csrc/adagrad.cu``): patched builds of
each kernel (``variants.py``), held bit-equal to the tree's build and
timed against it in turns on one NVIDIA GPU; and the two designs of
SparseAdagrad's dense-apply branch against each other (K7).

K21 (one launch of persistent CTAs over chunks of ~128 KB, a ticket a
tensor, the last CTA of a tensor folding its partials; 4 16-byte loads
a thread in flight, 4 CTAs a SM):

- ``batch8``, ``batch16``: 16-byte loads a thread has in flight;
- ``batch8_chunk64k``: the first design (8 loads, 64 KB chunks);
- ``ctas2``, ``ctas3``, ``ctas8``: CTAs a SM (``__launch_bounds__``'s
  floor follows), and ``no_floor``: no floor of CTAs a SM;
- ``chunk32k``, ``chunk64k``, ``chunk256k``: the bytes a chunk covers
  (the wrapper's plan follows the build);
- ``cached_loads``: the gradients read through the read-only cache
  (``__ldg``) in place of streaming loads.

K11 (one launch of persistent CTAs, each finding the live range in the
sorted ids and walking its share, a lane group taking kRows = 1 row at a
time, every load before the math):

- ``rows2``, ``rows4``: rows a lane group has in flight, all their loads
  started before the math (``rows2`` is the first design);
- ``ctas2``, ``ctas8``: CTAs a SM, and ``no_floor``;
- ``blocked``: pass 1 over one block of the live range a CTA in place of
  a grid-stride walk;
- ``cached_grads``: the gradient rows read through the read-only cache
  in place of streaming loads.

K6 (the same walk, ``csrc/row_update.cuh:walk_live_rows``, with K6's
transition): ``rows2``, ``ctas2``, ``ctas8``, ``no_floor``, ``blocked``
and ``cached_grads`` as K11's, and ``scalar_loads``: one element a lane
a load on every call (V = 1, the first design's loads). The first
design itself (two launches over every id) is the parent checkout's
wrapper (``--parent``).

K12 (the momentum row update, ``csrc/momentum.cu``, on the same walk
with its transition, Nesterov on): ``rows2``, ``rows4``, ``ctas2``,
``ctas8`` and ``scalar_loads`` as K6's. The first design (two launches
over every id) is the parent checkout's wrapper. On the power-law input
two diagnostics (timed, not held to the plain version): ``diag_empty``
(the kernel returns at once: the launch alone) and ``diag_bounds`` (it
returns after the live-range search), each also timed one call between
events (``*_single``, as a wrapper is) beside the tree.

K7, the dense-apply branch (``--only k7``): ``fused``, the tree's one
engine call with the Adagrad transition in its epilogue
(``csrc/segment_scatter.cuh``, ``ops/adagrad.py:adagrad_dense_scatter``),
against
``k3_then_k7``, the slab-wide chain (a zero gradient slab, K3
into it, the 16-byte-lane K7 over the slab), and ``k3_then_k7_scalar``
(the same with K7 one element a thread, the first design's loads, a
patched ``csrc/adagrad.cu``); all three from the same state must give
the same bits on every row. Inputs: the zoo's w8 call (2,686,976 ids
into 60,336 rows of width 8, one row hit 66,981 times) and the w16 slab
forced dense (2,883,584 ids into 70.2M rows of width 16), both float32,
lr 0.01, eps 1e-7. ``wrapper`` is the tree's fused call through its
wrapper, ``parent_wrapper`` (``--parent``) the parent checkout's chain.

Inputs: K21 on the DLRM step's gradients at b=65536 (26 bf16 [65536, 128]
cotangents, contiguous views of one [26, 65536, 128] buffer as K4 leaves
them, and the 16 float32 gradients of the MLPs 512-256-128 /
1024-1024-512-256-1), on world 8's two calls a rank (the 26 cotangents
at 8192 rows, then the 16 dense gradients), and on the 26 cotangents as
column slices of one [65536, 27, 128] block (the strided form). K11 on
the Adam zoo's shapes: the w16 slab of 70.2M rows in float32 (and with
bfloat16 tables and moments), 859,157 live unique rows of a 2,883,584-id
dedup output (the rest the pad tail), and the w8 slab of 60,336 rows,
48,689 live of 60,337. K6 on the zoo's w16 slab in float32 and in
bfloat16 (tables and accumulators), and on the streaming DLRM's w128 slab
(10,569,296 rows, 400,000 live rows of a 1,703,936-id output). K12 on the
zoo's w16 slab in float32 and bfloat16 and on its w8 slab (float32). Rows drawn
at random, gradients normal. Each
variant runs from the same state (the touched rows restored between
variants) and must give the tree's bits (K21's chunk variants, which fold
in an order of their own, are held to the plain version as the tree is
instead); the tree is held to the plain
version (K21 by ``chip_smoke.health_err``, K11 and K6 bit for bit), and
K11's
in-kernel ``powf`` bias powers to ``torch.pow``'s over the step counts
1 to 2,000 and five larger ones.

Timing: ``ms`` is the CUDA-event time of 20 back-to-back launches over
20 (the device's time a launch where the host keeps ahead), ``device_ms``
``torch.profiler``'s device time a launch; variants in turns (each, then
each again in the reverse order; the median of the runs). With ``--parent
DIR`` (a checkout of another commit) the two wrappers, this tree's and
that checkout's, are timed in the same turns as ``wrapper`` and
``parent_wrapper`` (event ms a call, host included).

Run from the root of a checkout: ``python3 row_variants.py [--parent
DIR] [--only k21,k11,k6,k12,k7]``. Prints the card's name and power limit, then
one JSON line a kernel, input and variant.
"""

import contextlib
import importlib
import json
import os
import sys

import numpy as np

import variants as vs

#: the kernels' launch bounds without a floor of CTAs a SM (the
#: registers the compiler wants; fewer CTAs may then fit a SM)
K21_NO_FLOOR = vs.replace(("__launch_bounds__(kThreads, kCtasPerSm)\n"
                           "health_kernel(",
                           "__launch_bounds__(kThreads)\nhealth_kernel("))
K11_NO_FLOOR = vs.replace(("__launch_bounds__(kThreads, kCtasPerSm)\n"
                           "adam_rows_kernel(",
                           "__launch_bounds__(kThreads)\n"
                           "adam_rows_kernel("))

K21_VARIANTS = {
    "tree": None,
    "batch8": vs.constants(kBatch=8),
    "batch16": vs.constants(kBatch=16),
    "batch8_chunk64k": vs.constants(kBatch=8, kChunkBytes=65536),
    "ctas2": vs.constants(kCtasPerSm=2),
    "ctas3": vs.constants(kCtasPerSm=3),
    "ctas8": vs.constants(kCtasPerSm=8),
    "no_floor": K21_NO_FLOOR,
    "chunk32k": vs.constants(kChunkBytes=32768),
    "chunk64k": vs.constants(kChunkBytes=65536),
    "chunk256k": vs.constants(kChunkBytes=262144),
    "cached_loads": vs.replace(
        ("v[b] = __ldcs(reinterpret_cast<const uint4*>(",
         "v[b] = __ldg(reinterpret_cast<const uint4*>(")),
}
#: the chunk bytes of each K21 variant's build (the wrapper plans by it)
K21_CHUNK = {"batch8_chunk64k": 65536, "chunk32k": 32768,
             "chunk64k": 65536, "chunk256k": 262144}

#: the live range in blocks, one a CTA (in place of a grid-stride walk):
#: a CTA's rows lie together in the slabs (the walk K6 and K11 share, in
#: csrc/row_update.cuh)
WALK_BLOCKED = ("row_update.cuh", vs.replace(
    ("  const int64_t group = blockIdx.x * lgroups + lgroup;\n"
     "  const int64_t groups = gridDim.x * lgroups;\n"
     "  for (int64_t v0 = neg_end + group * kRows; v0 < live_end;\n"
     "       v0 += groups * kRows) {",
     "  const int64_t per = (live_end - neg_end + gridDim.x - 1) / "
     "gridDim.x;\n"
     "  const int64_t blo = neg_end + blockIdx.x * per;\n"
     "  const int64_t bhi = blo + per < live_end ? blo + per : live_end;\n"
     "  for (int64_t v0 = blo + lgroup * kRows; v0 < bhi;\n"
     "       v0 += lgroups * kRows) {"),
    ("      live[r] = v < live_end;", "      live[r] = v < bhi;")))
#: the gradient rows through the read-only cache in place of streaming
#: loads (the shared walk's ld_once)
WALK_CACHED_GRADS = ("row_update.cuh", vs.replace(
    ("__ldcs(reinterpret_cast<const float4*>(p))",
     "__ldg(reinterpret_cast<const float4*>(p))"),
    ("__ldcs(reinterpret_cast<const uint2*>(p))",
     "__ldg(reinterpret_cast<const uint2*>(p))"),
    ("f[0] = T::load(__ldcs(p));", "f[0] = T::load(__ldg(p));")))

K11_VARIANTS = {
    "tree": None,
    "rows2": vs.constants(kRows=2),
    "rows4": vs.constants(kRows=4),
    "ctas2": vs.constants(kCtasPerSm=2),
    "ctas8": vs.constants(kCtasPerSm=8),
    "no_floor": K11_NO_FLOOR,
    "blocked": WALK_BLOCKED,
    "cached_grads": WALK_CACHED_GRADS,
}

#: K6 on the walk it shares with K11: the same knobs, and one element a
#: lane a load (V = 1) on every call
K6_VARIANTS = {
    "tree": None,
    "rows2": vs.constants(kRows=2),
    "ctas2": vs.constants(kCtasPerSm=2),
    "ctas8": vs.constants(kCtasPerSm=8),
    "no_floor": vs.replace(("__launch_bounds__(kThreads, kCtasPerSm)\n"
                            "adagrad_rows_kernel(",
                            "__launch_bounds__(kThreads)\n"
                            "adagrad_rows_kernel(")),
    "blocked": WALK_BLOCKED,
    "cached_grads": WALK_CACHED_GRADS,
    "scalar_loads": vs.replace(("  const bool vec = c->width % 4 == 0 && "
                                "detpu::aligned4(slab, es) &&\n"
                                "                   detpu::aligned4(acc, "
                                "ea)",
                                "  const bool vec = false && "
                                "detpu::aligned4(slab, es) &&\n"
                                "                   detpu::aligned4(acc, "
                                "ea)")),
}

#: K12 on the walk: K6's knobs
K12_VARIANTS = {
    "tree": None,
    "rows2": vs.constants(kRows=2),
    "rows4": vs.constants(kRows=4),
    "ctas2": vs.constants(kCtasPerSm=2),
    "ctas8": vs.constants(kCtasPerSm=8),
    "scalar_loads": vs.replace(("  const bool vec = c->width % 4 == 0 && "
                                "detpu::aligned4(slab, es) &&",
                                "  const bool vec = false && "
                                "detpu::aligned4(slab, es) &&")),
}

#: K12's diagnostics: the launch alone, the launch and the live-range
#: search
K12_DIAGNOSTICS = {
    "diag_empty": vs.replace(
        ("  const IdT* uids = static_cast<const IdT*>(q.uids);\n"
         "  int64_t neg_end, live_end;\n",
         "  if (group_log2 >= 0) return;\n"
         "  const IdT* uids = static_cast<const IdT*>(q.uids);\n"
         "  int64_t neg_end, live_end;\n")),
    "diag_bounds": vs.replace(
        ("  if (live_end == 0) return;\n  const MomentumOp",
         "  if (live_end >= 0) return;\n  const MomentumOp")),
}

ZOO_W16_ROWS = 70_200_000      # the zoo's w16 slab (4.49 GB in float32)
ZOO_W16_LIVE = 859_157         # unique rows of one step's K5 output
ZOO_W16_U = 2_883_584          # that output's length (its pad tail)
ZOO_W8_ROWS = 60_336
ZOO_W8_LIVE = 48_689
#: the capped Criteo-Kaggle w128 slab of the streaming DLRM (its K5 output
#: over 1,703,936 ids, the live rows a guess of its order: the smoke run
#: times the real call)
STREAM_W128_ROWS = 10_569_296
STREAM_W128_LIVE = 400_000
STREAM_W128_U = 1_703_936
LAUNCHES = 20                  # back-to-back launches a timing


@contextlib.contextmanager
def library(kernels, name, lib):
    """The wrappers building their records on ``lib`` (a patched build
    of ``csrc/<name>.cu``)."""
    saved = kernels.library
    kernels.library = lambda n: lib if n == name else saved(n)
    try:
        yield
    finally:
        kernels.library = saved


def batch_ms(torch, fn, n=LAUNCHES, repeat=5):
    """CUDA-event ms a call of ``n`` back-to-back calls of ``fn`` (the
    median of ``repeat`` timings, after a warmup)."""
    for _ in range(3):
        fn()
    out = []
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n)
    return float(np.median(out))


def timed(torch, cs, fns):
    """``ms`` (``batch_ms``) and ``device_ms`` of each of ``fns`` (name
    -> call), in turns; a wrapper's ``ms`` is ``cs.time_ms`` (one call
    between events, host included)."""
    ms = {n: [] for n in fns}
    for order in (list(fns), list(reversed(list(fns)))):
        for name in order:
            fn = fns[name]
            if name.endswith("wrapper") or name.endswith("_single"):
                ms[name].append(cs.time_ms(torch, fn, [()]))
            else:
                ms[name].append(batch_ms(torch, fn))
    return {n: {"ms": float(np.median(v)), "runs": v,
                "device_ms": cs.device_ms(torch, fns[n])}
            for n, v in ms.items()}


def k21_inputs(torch):
    """The K21 calls: name -> list of gradients."""
    gen = torch.Generator(device="cuda").manual_seed(2100)
    dense_shapes = ((512, 13), (512,), (256, 512), (256,), (128, 256),
                    (128,), (1024, 479), (1024,), (1024, 1024), (1024,),
                    (512, 1024), (512,), (256, 512), (256,), (1, 256), (1,))
    dense = [torch.randn(s, generator=gen, device="cuda") * 1e-2
             for s in dense_shapes]
    cot = (torch.randn((26, 65536, 128), generator=gen, device="cuda")
           * 1e-3).to(torch.bfloat16)
    rank = (torch.randn((26, 8192, 128), generator=gen, device="cuda")
            * 1e-3).to(torch.bfloat16)
    block = (torch.randn((65536, 27, 128), generator=gen, device="cuda")
             * 1e-3).to(torch.bfloat16)
    return {"dlrm_b65536": list(cot.unbind(0)) + dense,
            "w8_rank_cotangents": list(rank.unbind(0)),
            "w8_rank_dense": dense,
            "dlrm_strided": [block[:, i + 1] for i in range(26)] + dense}


def run_k21(torch, cs, kernels, gh, parent):
    libs = vs.build(kernels, "grad_health", K21_VARIANTS, "row_variants")
    for what, ts in k21_inputs(torch).items():
        nbytes = sum(t.numel() * t.element_size() for t in ts)
        addrs = gh._addresses(ts)
        outs, fns = {}, {}
        for name, lib in libs.items():
            saved = gh.CHUNK_BYTES
            gh.CHUNK_BYTES = K21_CHUNK.get(name, saved)
            try:
                with library(kernels, "grad_health", lib):
                    rec = gh.build_record(ts)
            finally:
                gh.CHUNK_BYTES = saved
            out = torch.empty(3, len(ts), device="cuda")
            rec.replay(addrs, out.data_ptr())
            torch.cuda.synchronize()
            outs[name] = out
            fns[name] = (lambda rec=rec, out=out:
                         rec.replay(addrs, out.data_ptr()))
            # a chunk size of its own folds in another order: held to the
            # plain version as the tree is, not to the tree's bits
            if name not in K21_CHUNK and not torch.equal(
                    out.view(torch.int32), outs["tree"].view(torch.int32)):
                raise SystemExit(f"K21 {what} {name}: bits differ from the "
                                 "tree's")
        plain = gh.grad_health_plain(ts)
        for name in K21_CHUNK:
            cs.health_err(torch, outs[name], plain, f"K21 {what} {name}")
        err = cs.health_err(torch, outs["tree"], plain, f"K21 {what}")
        fns["wrapper"] = lambda: gh.grad_health(ts)
        if parent is not None:
            fns["parent_wrapper"] = lambda: parent["grad_health"] \
                .grad_health(ts)
        for name, t in timed(torch, cs, fns).items():
            print(json.dumps({"kernel": "K21", "input": what,
                              "variant": name, "tensors": len(ts),
                              "bytes": nbytes, "bound_ms": nbytes
                              / cs.HBM_BYTES_PER_S * 1e3,
                              "tree_vs_plain_max_abs_err": err, **t}),
                  flush=True)


def k11_case(torch, rows, width, live, u, dtype, seed, zipf=False):
    """A slab, its moments and count, and a sorted dedup output of
    ``live`` unique random rows padded with ``rows`` to ``u`` ids
    (``zipf``: the distinct rows of ``u`` power-law ids, hot rows first,
    as a zoo table's stream gives them)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    slab = torch.randn((rows, width), generator=gen, device="cuda").to(dtype)
    mu = (torch.randn((rows, width), generator=gen, device="cuda")
          * 0.1).to(dtype)
    nu = (torch.rand((rows, width), generator=gen, device="cuda")
          * 0.1).to(dtype)
    if zipf:
        import chip_smoke as cs

        pick = torch.unique(cs.device_power_law(
            torch, torch.Generator(device="cuda").manual_seed(1202), rows,
            u))
    else:
        pick = torch.randperm(rows, generator=gen, device="cuda")[:live]
    uids = torch.full((u,), rows, dtype=torch.int32, device="cuda")
    uids[:live] = pick.sort().values.int()
    uvals = torch.zeros((u, width), device="cuda", dtype=dtype)
    uvals[:live] = torch.randn((live, width), generator=gen,
                               device="cuda").to(dtype)
    count = torch.full((1, 1), 7.0, device="cuda")
    return slab, mu, nu, count, uids, uvals


def k11_powf_check(torch, adam):
    """K11 against its plain version (``torch.pow`` bias powers) at every
    count 1..2000 and five larger ones: the counts whose bits differ."""
    gen = torch.Generator(device="cuda").manual_seed(1100)
    rows, width = 64, 8
    uids = torch.arange(1, 33, dtype=torch.int32, device="cuda")
    g = torch.randn((32, width), generator=gen, device="cuda")
    slab = torch.randn((rows, width), generator=gen, device="cuda")
    mu = torch.randn((rows, width), generator=gen, device="cuda") * 0.1
    nu = torch.rand((rows, width), generator=gen, device="cuda") * 0.1
    bad = []
    counts = list(range(1, 2001)) + [10_000, 65_536, 100_000, 1_000_000,
                                     16_777_216]
    for t in counts:
        cnt = torch.full((1, 1), float(t), device="cuda")
        got = [slab.clone(), mu.clone(), nu.clone()]
        want = [slab.clone(), mu.clone(), nu.clone()]
        adam.adam_rows(*got, cnt, uids, g, 0.01, 0.9, 0.999, 1e-8, 0.0)
        adam.adam_rows_plain(*want, cnt, uids, g, 0.01, 0.9, 0.999, 1e-8,
                             0.0)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            bad.append(t)
    return counts, bad


def run_k11(torch, cs, kernels, adam, parent):
    counts, bad = k11_powf_check(torch, adam)
    print(json.dumps({"kernel": "K11", "powf_counts_checked": len(counts),
                      "powf_counts_differing": bad}), flush=True)
    libs = vs.build(kernels, "adam", K11_VARIANTS, "row_variants")
    f32, bf16 = torch.float32, torch.bfloat16
    for what, (rows, width, live, u, dt) in (
            ("zoo_w16_fp32", (ZOO_W16_ROWS, 16, ZOO_W16_LIVE, ZOO_W16_U,
                              f32)),
            ("zoo_w8_fp32", (ZOO_W8_ROWS, 8, ZOO_W8_LIVE, ZOO_W8_ROWS + 1,
                             f32)),
            ("zoo_w16_bf16", (ZOO_W16_ROWS, 16, ZOO_W16_LIVE, ZOO_W16_U,
                              bf16))):
        slab, mu, nu, count, uids, uvals = k11_case(
            torch, rows, width, live, u, dt, seed=1101)
        hit = uids[:live].long()
        start = [t[hit].clone() for t in (slab, mu, nu)]

        def restore():
            for t, s in zip((slab, mu, nu), start):
                t[hit] = s

        args = (slab, mu, nu, count, uids, uvals, 0.01, 0.9, 0.999, 1e-8,
                0.0)
        adam.adam_rows_plain(*args)
        want = [t[hit] for t in (slab, mu, nu)]
        ptrs = (slab.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                uids.data_ptr(), uvals.data_ptr(), count.data_ptr(), None)
        fns = {}
        for name, lib in libs.items():
            with library(kernels, "adam", lib):
                rec = adam.build_record(*args)
            restore()
            rec.replay(*ptrs)
            torch.cuda.synchronize()
            got = [t[hit] for t in (slab, mu, nu)]
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"K11 {what} {name}: bits differ from the "
                                 "plain version (and the tree)")
            fns[name] = lambda rec=rec: rec.replay(*ptrs)
        restore()
        fns["wrapper"] = lambda: adam.adam_rows(*args)
        if parent is not None:
            fns["parent_wrapper"] = lambda: parent["adam"].adam_rows(*args)
        es, eg = slab.element_size(), uvals.element_size()
        nbytes = uids.numel() * 4 + live * width * (eg + 2 * (es + 2 * eg))
        for name, t in timed(torch, cs, fns).items():
            print(json.dumps({"kernel": "K11", "input": what,
                              "variant": name, "live_rows": live, "ids": u,
                              "bytes": nbytes, "bound_ms": nbytes
                              / cs.HBM_BYTES_PER_S * 1e3, **t}), flush=True)
        del slab, mu, nu, uvals, start, want, fns, args
        torch.cuda.empty_cache()


def run_k6(torch, cs, kernels, ada, parent):
    libs = vs.build(kernels, "adagrad", K6_VARIANTS, "row_variants")
    f32, bf16 = torch.float32, torch.bfloat16
    for what, (rows, width, live, u, dt) in (
            ("zoo_w16_fp32", (ZOO_W16_ROWS, 16, ZOO_W16_LIVE, ZOO_W16_U,
                              f32)),
            ("zoo_w16_bf16", (ZOO_W16_ROWS, 16, ZOO_W16_LIVE, ZOO_W16_U,
                              bf16)),
            ("stream_w128_fp32", (STREAM_W128_ROWS, 128, STREAM_W128_LIVE,
                                  STREAM_W128_U, f32))):
        slab, acc, _, _, uids, ugrads = k11_case(
            torch, rows, width, live, u, dt, seed=601)
        acc.abs_().add_(0.1)
        hit = uids[:live].long()
        start = [t[hit].clone() for t in (slab, acc)]

        def restore():
            for t, s in zip((slab, acc), start):
                t[hit] = s

        args = (slab, acc, uids, ugrads, 0.01, 1e-7)
        ada.adagrad_rows_plain(*args)
        want = [t[hit] for t in (slab, acc)]
        ptrs = (slab.data_ptr(), acc.data_ptr(), uids.data_ptr(),
                ugrads.data_ptr(), None)
        fns = {}
        for name, lib in libs.items():
            with library(kernels, "adagrad", lib):
                rec = ada.build_record(*args)
            restore()
            rec.replay(*ptrs)
            torch.cuda.synchronize()
            got = [t[hit] for t in (slab, acc)]
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"K6 {what} {name}: bits differ from the "
                                 "plain version (and the tree)")
            fns[name] = lambda rec=rec: rec.replay(*ptrs)
        restore()
        fns["wrapper"] = lambda: ada.adagrad_rows(*args)
        if parent is not None:
            fns["parent_wrapper"] = lambda: parent["adagrad"].adagrad_rows(
                *args)
        es, ea = slab.element_size(), acc.element_size()
        nbytes = live * (uids.element_size() + width * (ea + 2 * (es + ea)))
        for name, t in timed(torch, cs, fns).items():
            print(json.dumps({"kernel": "K6", "input": what,
                              "variant": name, "live_rows": live, "ids": u,
                              "bytes": nbytes, "bound_ms": nbytes
                              / cs.HBM_BYTES_PER_S * 1e3, **t}), flush=True)
        restore()
        del slab, acc, ugrads, start, want, fns, args
        torch.cuda.empty_cache()


def run_k12(torch, cs, kernels, mom, parent):
    libs = vs.build(kernels, "momentum", {**K12_VARIANTS, **K12_DIAGNOSTICS},
                    "row_variants")
    diag = {k: libs.pop(k) for k in K12_DIAGNOSTICS}
    f32, bf16 = torch.float32, torch.bfloat16
    for what, (rows, width, live, u, dt) in (
            ("zoo_w16_fp32", (ZOO_W16_ROWS, 16, ZOO_W16_LIVE, ZOO_W16_U,
                              f32)),
            ("zoo_w16_bf16", (ZOO_W16_ROWS, 16, ZOO_W16_LIVE, ZOO_W16_U,
                              bf16)),
            ("zoo_w16_fp32_zipf", (ZOO_W16_ROWS, 16, None, ZOO_W16_U,
                                   f32)),
            ("zoo_w8_fp32", (ZOO_W8_ROWS, 8, ZOO_W8_LIVE, ZOO_W8_ROWS + 1,
                             f32))):
        if live is None:  # the live rows of a power-law stream of u ids
            gen = torch.Generator(device="cuda").manual_seed(1202)
            live = int(torch.unique(cs.device_power_law(
                torch, gen, rows, u)).numel())
        slab, trace, _, _, uids, ugrads = k11_case(
            torch, rows, width, live, u, dt, seed=1201,
            zipf=what.endswith("zipf"))
        hit = uids[:live].long()
        start = [t[hit].clone() for t in (slab, trace)]

        def restore():
            for t, s in zip((slab, trace), start):
                t[hit] = s

        args = (slab, trace, uids, ugrads, 0.01, 0.9, True)
        mom.momentum_rows_plain(*args)
        want = [t[hit] for t in (slab, trace)]
        ptrs = (slab.data_ptr(), trace.data_ptr(), uids.data_ptr(),
                ugrads.data_ptr(), None)
        fns = {}
        for name, lib in libs.items():
            with library(kernels, "momentum", lib):
                rec = mom.build_record(*args)
            restore()
            rec.replay(*ptrs)
            torch.cuda.synchronize()
            got = [t[hit] for t in (slab, trace)]
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"K12 {what} {name}: bits differ from the "
                                 "plain version (and the tree)")
            fns[name] = lambda rec=rec: rec.replay(*ptrs)
        restore()
        if what.endswith("zipf"):
            fns["tree_single"] = fns["tree"]
            for name, lib in diag.items():
                with library(kernels, "momentum", lib):
                    rec = mom.build_record(*args)
                fns[name] = fns[name + "_single"] = (
                    lambda rec=rec: rec.replay(*ptrs))
        fns["wrapper"] = lambda: mom.momentum_rows(*args)
        if parent is not None:
            fns["parent_wrapper"] = lambda: parent["momentum"].momentum_rows(
                *args)
        es, et = slab.element_size(), trace.element_size()
        nbytes = live * (uids.element_size() + width * (et + 2 * (es + et)))
        for name, t in timed(torch, cs, fns).items():
            print(json.dumps({"kernel": "K12", "input": what,
                              "variant": name, "live_rows": live, "ids": u,
                              "bytes": nbytes, "bound_ms": nbytes
                              / cs.HBM_BYTES_PER_S * 1e3, **t}), flush=True)
        restore()
        del slab, trace, ugrads, start, want, fns, args
        torch.cuda.empty_cache()


#: K7 one element a thread on every call (V = 1)
K7_SCALAR = vs.replace(("  const bool vec = c->numel % 4 == 0 && "
                        "detpu::aligned4(slab, es) &&",
                        "  const bool vec = false && "
                        "detpu::aligned4(slab, es) &&"))


def k7_stream(torch, rows, n, hot, seed):
    """``n`` ids into ``rows`` (a power-law draw, one row hit ``hot``
    more times, shuffled) and N(0, 0.25) float32 rows of width 8 or 16."""
    import chip_smoke as cs

    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.cat([cs.device_power_law(torch, gen, rows, n - hot),
                     torch.full((hot,), rows // 2, dtype=torch.int32,
                                device="cuda")])
    ids = ids[torch.randperm(n, generator=gen, device="cuda")].int()
    return ids, gen


def run_k7(torch, cs, kernels, ada, parent):
    libs = vs.build(kernels, "adagrad", {"tree": None,
                                         "scalar": K7_SCALAR},
                    "row_variants")
    sa = importlib.import_module("distributed_embeddings_torch.ops."
                                 "scatter_add")
    for what, (rows, width, n, hot) in (
            ("zoo_w8_fp32", (ZOO_W8_ROWS, 8, 2_686_976, 66_981)),
            ("zoo_w16_fp32_forced_dense", (ZOO_W16_ROWS, 16, ZOO_W16_U,
                                           0))):
        ids, gen = k7_stream(torch, rows, n, hot, seed=700 + width)
        vals = torch.randn((n, width), generator=gen, device="cuda") * 0.5
        slab0 = torch.randn((rows, width), generator=gen, device="cuda")
        acc0 = torch.rand((rows, width), generator=gen, device="cuda") + 0.1
        slab, acc = slab0.clone(), acc0.clone()
        g = torch.zeros_like(acc)
        args = (slab, acc, ids, vals, 0.01, 1e-7)
        k7 = {}
        for name, lib in libs.items():
            with library(kernels, "adagrad", lib):
                k7[name] = ada.build_dense_record(slab, acc, g, 0.01, 1e-7)
        k3 = sa.find_sgd_record(sa._K3, g, ids, vals, -1.0)
        fused = ada.build_scatter_record(*args)
        ptrs = (slab.data_ptr(), acc.data_ptr(), ids.data_ptr(),
                vals.data_ptr(), None)

        def chain(rec):
            g.zero_()
            k3.replay(g.data_ptr(), ids.data_ptr(), vals.data_ptr(), None)
            rec.replay(slab.data_ptr(), acc.data_ptr(), g.data_ptr(), None)

        fns = {"fused": lambda: fused.replay(*ptrs),
               "k3_then_k7": lambda: chain(k7["tree"]),
               "k3_then_k7_scalar": lambda: chain(k7["scalar"])}
        want = None
        for name, fn in fns.items():  # the fused call first
            slab.copy_(slab0)
            acc.copy_(acc0)
            fn()
            torch.cuda.synchronize()
            if want is None:
                want = (slab.clone(), acc.clone())
            elif not all(torch.equal(x.view(torch.int32),
                                     y.view(torch.int32))
                         for x, y in zip((slab, acc), want)):
                raise SystemExit(f"K7 {what} {name}: bits differ from the "
                                 "fused call's")
        del want
        fns["wrapper"] = lambda: ada.adagrad_dense_scatter(*args)
        if parent is not None:
            fns["parent_wrapper"] = lambda: cs.parent_dense_branch(*args)
        hit = int(torch.unique(ids).numel())
        fused_bytes = n * (4 + width * 4) + hit * width * 16
        chain_bytes = n * (4 + width * 4) + rows * width * 4 * 6
        for name, t in timed(torch, cs, fns).items():
            nbytes = (fused_bytes if name.startswith("fused")
                      or name == "wrapper" else chain_bytes)
            print(json.dumps({"kernel": "K7", "input": what,
                              "variant": name, "ids": n, "hit_rows": hit,
                              "bytes": nbytes, "bound_ms": nbytes
                              / cs.HBM_BYTES_PER_S * 1e3, **t}), flush=True)
        del slab, acc, g, slab0, acc0, vals, ids, fns, args, k7, k3, fused
        torch.cuda.empty_cache()


def main():
    import torch
def main():
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("row_variants.py needs a CUDA card")
    argv = sys.argv[1:]
    only = {"k21", "k11", "k6", "k12", "k7"}
    while argv:
        if len(argv) >= 2 and argv[0] == "--parent":
            cs.PARENT_DIR = os.path.abspath(argv[1])
        elif len(argv) >= 2 and argv[0] == "--only":
            only = set(argv[1].split(","))
        else:
            raise SystemExit("usage: python3 row_variants.py [--parent DIR]"
                             " [--only k21,k11,k6,k12,k7]")
        argv = argv[2:]
    print(vs.card_line(), flush=True)
    kernels = importlib.import_module(
        "distributed_embeddings_torch.ops._kernels")
    parent = cs.parent_ops()
    if "k21" in only:
        gh = importlib.import_module("distributed_embeddings_torch.ops."
                                     "grad_health")
        run_k21(torch, cs, kernels, gh, parent)
        torch.cuda.empty_cache()
    if "k11" in only:
        adam = importlib.import_module("distributed_embeddings_torch.ops."
                                       "adam")
        run_k11(torch, cs, kernels, adam, parent)
        torch.cuda.empty_cache()
    if "k6" in only:
        ada = importlib.import_module("distributed_embeddings_torch.ops."
                                      "adagrad")
        run_k6(torch, cs, kernels, ada, parent)
        torch.cuda.empty_cache()
    if "k12" in only:
        mom = importlib.import_module("distributed_embeddings_torch.ops."
                                      "momentum")
        run_k12(torch, cs, kernels, mom, parent)
        torch.cuda.empty_cache()
    if "k7" in only:
        ada = importlib.import_module("distributed_embeddings_torch.ops."
                                      "adagrad")
        run_k7(torch, cs, kernels, ada, parent)


if __name__ == "__main__":
    main()
