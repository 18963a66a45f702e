#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

Drives the port's serving and training paths end to end at full width
and real size: DLRM with the 26 Criteo-1TB (MLPerf DLRM) tables of width
128 in bf16 (187,767,425 rows, a 48.1 GB slab), 13 dense features,
bottom MLP 512-256-128, top MLP 1024-1024-512-256-1, random weights from
a seed, served through ``ServingRuntime`` with its default ladder, then
trained at batch 65536 by ``make_hybrid_train_step`` (``SparseSGD`` on
the tables and ``SGD`` on the dense half, both at lr 0.005, as the JAX
package's DLRM bench trains it).

Phases (any failure raises and the script exits non-zero):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the kernels (``csrc/*.cu``) with nvcc for sm_90a;
3. model: builds the Criteo-1TB DLRM, filling the slab in place;
4. check: holds each kernel against its plain PyTorch version on the
   card at the serving and training shapes (K1 at rung 256 and at
   b=65536, hot 1 and hot 3 mean, with negative and out-of-range ids;
   K2 at B=256 and B=65536);
5. serve: a few hundred Zipfian requests of 1-8 samples through
   ``drive`` with the kernel launch counters zeroed just before and
   read just after; every result must be ``Served`` with finite
   predictions in (0, 1), a sample of requests must match the same
   samples run through the plain functions, and both serving kernels
   must have launched;
6. train, on the same state after serving:
   a. small tables (capped at 20000 rows) at batch 4096, float32 and
      bf16: 5 steps with the kernels against the same 5 steps with the
      package's calls routed to the plain versions, on the card;
   b. full size, batch 65536, Zipfian ids: one step whose touched slab
      rows (snapshotted before it) must match the snapshot updated by
      the plain scatter from the same cotangents, and whose interaction
      backward must match its plain version on the same inputs;
   c. a NaN batch must leave the touched rows and the dense parameters
      bitwise unchanged and advance the step;
   d. 3 warmup + 20 timed steps with the launch counters zeroed just
      before and read just after (every kernel once per step), then the
      same stages called one by one for a per-stage split;
7. time: CUDA-event medians (20+ runs after warmup) of each kernel, its
   plain version, one PyTorch library call for the same function, and
   the least time the card could take (bytes over 3.35 TB/s, operations
   over 989 TFLOP/s bf16, the H100 SXM data-sheet peaks).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Run from the root of a checkout:
``python3 chip_smoke.py``.
"""

import contextlib
import copy
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_OPS_PER_S = 989e12        # H100 SXM data sheet, dense bf16
CRITEO_1TB_SIZES = [s + 1 for s in [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36,
]]
SEED = 0
RUNG = 256                     # the ladder's top rung (DETPU_SERVE_MAX_BATCH)
TRAIN_BATCH = 65536            # the training batch of the DLRM bench
TIMED_RUNS = 25
WARMUP_RUNS = 3
TRAIN_LR = 0.005               # both optimizers' lr in the DLRM bench
TRAIN_STEPS = 20
SMALL_BATCH = 4096
SMALL_STEPS = 5
SMALL_ROWS = 20000             # table-size cap of the small training check


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ timing


def time_ms(torch, fn, arg_sets):
    """Median CUDA-event time of ``fn(*args)`` in ms, cycling through
    ``arg_sets`` (different ids each launch), after a warmup."""
    for k in range(WARMUP_RUNS):
        fn(*arg_sets[k % len(arg_sets)])
    times = []
    for k in range(TIMED_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        args = arg_sets[k % len(arg_sets)]
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(torch, got, want, exact, what):
    """Max abs error of kernel vs plain (compared on the card in fp32,
    which holds every bf16 value); raises beyond the tolerance:
    bit-exact, or within 1 bf16 ulp of the plain result."""
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite kernel output")
    err = (g - w).abs()
    if exact:
        bad = int(torch.count_nonzero(err))
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            w.abs().clamp(min=2.0 ** -126))) - 7)
        bad = int(torch.count_nonzero(err > ulp))
    max_err = float(err.max())
    check(bad == 0, f"{what}: {bad} values beyond tolerance "
          f"(max err {max_err})")
    log(f"  {what}: max_abs_err {max_err} "
        f"({'bit-exact' if exact else '<= 1 bf16 ulp'} required)")
    return max_err


# ------------------------------------------------------------------ phases


def phase_device(torch):
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    lines = smi.stdout.strip().splitlines()
    check(lines, "nvidia-smi printed nothing")
    log(lines[0].strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return lines[0].strip()


def phase_build():
    from distributed_embeddings_torch.ops import _kernels

    t0 = time.perf_counter()
    paths = _kernels.build_all()
    log(f"build: {len(paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(_kernels.NVCC_FLAGS)})")
    for name in _kernels.SIGNATURES:
        text = _kernels.build_log(name)
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill", text)]
        log(f"  ptxas {name}: {len(regs)} kernel instances, "
            f"{min(regs)}-{max(regs)} registers, "
            f"{max(spills, default=0)} bytes spilled at most")


def phase_model(torch):
    from distributed_embeddings_torch.models import DLRMConfig, DLRMDense
    from distributed_embeddings_torch.parallel import (
        DistributedEmbedding, HybridTrainState)

    t0 = time.perf_counter()
    cfg = DLRMConfig(table_sizes=CRITEO_1TB_SIZES, embedding_dim=128,
                     num_numerical_features=13,
                     bottom_mlp_dims=(512, 256, 128),
                     top_mlp_dims=(1024, 1024, 512, 256, 1),
                     compute_dtype=torch.bfloat16)
    de = DistributedEmbedding(cfg.embedding_configs(), world_size=1,
                              compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = de.init(gen, dtype=torch.bfloat16, device="cuda")
    dense = DLRMDense(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    slab = params["w128"]
    check(tuple(slab.shape) == (1, sum(CRITEO_1TB_SIZES), 128),
          f"slab shape {tuple(slab.shape)}")
    log(f"model: Criteo-1TB DLRM, slab {tuple(slab.shape)} bf16 = "
        f"{slab.numel() * 2 / 1e9:.1f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    return cfg, de, HybridTrainState(emb_params=params, dense_params=dense)


def k1_case(torch, de, b, hot, seed, bad_ids=True):
    """Per-slot ids ``[26, b, hot]`` (Zipfian, with ~1% negative and
    out-of-range ids) and the plan metadata a serving flush hands K1."""
    from distributed_embeddings_torch.utils.data import power_law_ids

    rng = np.random.default_rng(seed)
    sizes = CRITEO_1TB_SIZES
    ids = np.stack([power_law_ids(rng, v, (b, hot)) for v in sizes])
    if bad_ids:
        flip = rng.random(ids.shape) < 0.01
        over = np.asarray(sizes)[:, None, None] + rng.integers(
            0, 1000, size=ids.shape)
        ids = np.where(flip, np.where(rng.random(ids.shape) < 0.5,
                                      -rng.integers(1, 1000, ids.shape),
                                      over), ids)
    dev = torch.device("cuda")
    n = len(sizes)
    return dict(
        ids=torch.as_tensor(ids.astype(np.int32), device=dev),
        rows=torch.as_tensor(sizes, dtype=torch.int64, device=dev),
        roff=torch.as_tensor(de.row_offsets_list[0], dtype=torch.int64,
                             device=dev),
        div=torch.full((n,), float(hot), dtype=torch.float32, device=dev))


def phase_check(torch, de, state):
    from distributed_embeddings_torch.ops import (
        dot_interact_fwd, dot_interact_fwd_plain, gather_combine,
        gather_combine_plain)

    errs = {"gather_combine": 0.0, "dot_interact_fwd": 0.0}
    log("check: kernels against their plain versions on the card")
    slab = state.emb_params["w128"][0]
    for b, hot in ((RUNG, 1), (RUNG, 3), (TRAIN_BATCH, 1), (TRAIN_BATCH, 3)):
        c = k1_case(torch, de, b, hot, seed=b + hot)
        got = gather_combine(slab, c["ids"], c["rows"], c["roff"], c["div"])
        want = gather_combine_plain(slab, c["ids"], c["rows"], c["roff"],
                                    c["div"])
        errs["gather_combine"] = max(errs["gather_combine"], compare(
            torch, got, want, exact=hot == 1,
            what=f"gather_combine b={b} hot={hot}"
                 f"{' mean' if hot > 1 else ''}"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for b in (RUNG, TRAIN_BATCH):
        feats = torch.randn((b, 27, 128), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
        got = dot_interact_fwd(feats)
        want = dot_interact_fwd_plain(feats)
        compare(torch, got[:, 351:], want[:, 351:], exact=True,
                what=f"dot_interact_fwd B={b} bottom-row copy")
        errs["dot_interact_fwd"] = max(errs["dot_interact_fwd"], compare(
            torch, got, want, exact=False, what=f"dot_interact_fwd B={b}"))
    return errs


def plain_predictions(torch, de, state, req):
    """The same samples through the plain functions, called by name."""
    import torch.nn.functional as F
    from distributed_embeddings_torch.ops import (dot_interact_fwd_plain,
                                                  gather_combine_plain)

    slab = state.emb_params["w128"][0]
    dense = state.dense_params
    dt = torch.bfloat16
    one = torch.ones(1, dtype=torch.float32, device="cuda")
    embs = []
    for t, ids in enumerate(req.cats):
        embs.append(gather_combine_plain(
            slab, torch.as_tensor(ids, device="cuda").view(1, -1, 1),
            torch.tensor([CRITEO_1TB_SIZES[t]], device="cuda"),
            torch.tensor([de.row_offsets_list[0][t]], device="cuda"),
            one)[0])
    x = torch.as_tensor(req.batch, device="cuda").to(dt)
    with torch.inference_mode():
        for lin in dense.bottom:
            x = F.relu(F.linear(x, lin.weight.to(dt), lin.bias.to(dt)))
        y = dot_interact_fwd_plain(torch.stack([x] + embs, dim=1))
        for lin in dense.top[:-1]:
            y = F.relu(F.linear(y, lin.weight.to(dt), lin.bias.to(dt)))
        last = dense.top[-1]
        logits = F.linear(y.float(), last.weight, last.bias)
    return torch.sigmoid(logits)[:, 0].cpu().numpy()


def phase_serve(torch, de, state):
    from distributed_embeddings_torch.parallel import (
        ServeConfig, Served, ServingRuntime, drive, synthetic_request)

    rt = ServingRuntime(
        de, lambda d, outs, n: torch.sigmoid(d(n, outs))[:, 0], state,
        config=ServeConfig())
    rng = np.random.default_rng(SEED + 2)
    tmpl = synthetic_request(rng, CRITEO_1TB_SIZES, 2, numerical=13)
    t0 = time.perf_counter()
    rt.warmup((tmpl.cats, tmpl.batch))
    log(f"serve: ladder {rt.rungs} warmed in "
        f"{time.perf_counter() - t0:.2f} s")
    sent = {}

    def make_request(i):
        req = synthetic_request(rng, CRITEO_1TB_SIZES,
                                int(rng.integers(1, 9)), numerical=13)
        sent[i] = req
        return req

    zero_counts()
    results = drive(rt, make_request, qps=400.0, duration_s=1.0)
    launches = read_counts()
    kinds = {}
    for r in results:
        kinds[type(r).__name__] = kinds.get(type(r).__name__, 0) + 1
    log(f"serve: {len(sent)} requests submitted, outcomes {kinds}, "
        f"kernel launches {launches}")
    check(len(sent) >= 300, f"only {len(sent)} requests were sent")
    check(len(results) == len(sent), f"{len(results)} results for "
          f"{len(sent)} requests")
    check(all(isinstance(r, Served) for r in results),
          f"not every request was Served: {kinds}")
    for r in results:
        p = np.asarray(r.predictions)
        check(p.shape == (sent[r.rid].n,), f"rid {r.rid}: shape {p.shape}")
        check(np.isfinite(p).all() and (p > 0).all() and (p < 1).all(),
              f"rid {r.rid}: predictions outside (0, 1): {p}")
    for name in ("gather_combine", "dot_interact_fwd"):
        check(launches[name] > 0, f"{name} never launched on the served "
              "path")
    for name in ("dot_interact_bwd", "sgd_scatter"):
        check(launches[name] == 0, f"{name} launched on the served path")
    by_rid = {r.rid: r for r in results}
    worst = 0.0
    for rid in sorted(by_rid)[::max(1, len(by_rid) // 16)]:
        want = plain_predictions(torch, de, state, sent[rid])
        err = float(np.abs(by_rid[rid].predictions - want).max())
        worst = max(worst, err)
        check(err <= 2e-2, f"rid {rid}: served vs plain functions differ "
              f"by {err} (> 2e-2)")
    log(f"serve: sampled requests match the plain functions, max abs err "
        f"{worst} (atol 2e-2: bf16 MLP products round at other places)")
    s = rt.stats()
    for name in ("gather_combine", "dot_interact_fwd"):
        check(launches[name] == s["flushes"], f"{name}: {launches[name]} "
              f"launches for {s['flushes']} flushes (expected one each)")
    log("serve stats: " + json.dumps({k: s[k] for k in (
        "served", "served_samples", "flushes", "pad_fraction",
        "latency_p50_ms", "latency_p95_ms", "latency_p99_ms",
        "deadline_missed", "rung_flushes", "p99_dominant_stage")}))
    log("serve stages (ms): " + json.dumps({
        stage: {q: v[q] for q in ("p50", "p99", "mean")}
        for stage, v in s["latency_stages_ms"].items()}))
    return launches, s


# ------------------------------------------------------------------ training


def kernel_fns():
    """Every kernel wrapper of the port, by name (each counts its own
    launches)."""
    from distributed_embeddings_torch.ops import (
        dot_interact_bwd, dot_interact_fwd, gather_combine, sgd_scatter)

    return {"gather_combine": gather_combine,
            "dot_interact_fwd": dot_interact_fwd,
            "dot_interact_bwd": dot_interact_bwd, "sgd_scatter": sgd_scatter}


def zero_counts():
    for fn in kernel_fns().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_fns().items()}


@contextlib.contextmanager
def plain_kernels():
    """Route the package's four kernel calls to their plain versions
    (the reference run of the small training check)."""
    from distributed_embeddings_torch.ops import (gather_combine_plain,
                                                  interaction, scatter_add)
    from distributed_embeddings_torch.parallel import lookup, optimizers

    swaps = [(lookup, "gather_combine", gather_combine_plain),
             (interaction, "dot_interact_fwd",
              interaction.dot_interact_fwd_plain),
             (interaction, "dot_interact_bwd",
              interaction.dot_interact_bwd_plain),
             (optimizers, "sgd_scatter", scatter_add.sgd_scatter_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_batch(torch, sizes, b, seed, bad_ids=False, nan=False):
    """Zipfian ids ``[b]`` per table (int32; ``bad_ids``: ~1% negative
    or past the table), N(0, 1) numerical features ``[b, 13]`` (``nan``:
    one NaN) and 0/1 labels, on the card."""
    from distributed_embeddings_torch.utils.data import power_law_ids

    rng = np.random.default_rng(seed)
    cats = []
    for v in sizes:
        ids = power_law_ids(rng, v, (b,))
        if bad_ids:
            flip = rng.random(b) < 0.01
            ids = np.where(flip, np.where(
                rng.random(b) < 0.5, -rng.integers(1, 1000, b),
                v + rng.integers(0, 1000, b)), ids)
        cats.append(torch.as_tensor(ids.astype(np.int32), device="cuda"))
    num = rng.normal(size=(b, 13)).astype(np.float32)
    if nan:
        num[b // 2, 3] = np.nan
    lab = (rng.random(b) < 0.25).astype(np.float32)
    return cats, (torch.as_tensor(num, device="cuda"),
                  torch.as_tensor(lab, device="cuda"))


def loss_fn(dense, outs, batch):
    from distributed_embeddings_torch.models import bce_with_logits

    num, lab = batch
    return bce_with_logits(dense(num, outs), lab)


def train_state(torch, state):
    """A train state over ``state``'s slabs and dense module (shared)."""
    from distributed_embeddings_torch.parallel import (SGD, HybridTrainState,
                                                       SparseSGD)

    return HybridTrainState(
        emb_params=state.emb_params,
        emb_opt_state=SparseSGD().init(state.emb_params),
        dense_params=state.dense_params,
        dense_opt_state=SGD(TRAIN_LR).init(
            list(state.dense_params.parameters())),
        step=torch.zeros((), dtype=torch.int32, device="cuda"))


def global_rows(torch, de, cats, sizes):
    """The slab rows a batch's in-range ids hit, one entry per id."""
    rows = []
    for t, ids in enumerate(cats):
        ids = ids.long()
        ok = (ids >= 0) & (ids < sizes[t])
        rows.append(ids[ok] + de.row_offsets_list[0][t])
    return torch.cat(rows)


def ulp(torch, x, dtype):
    """One ulp of ``dtype`` at magnitude ``|x|`` (float32 tensor)."""
    mant = 7 if dtype == torch.bfloat16 else 23
    return torch.exp2(torch.floor(torch.log2(
        x.abs().clamp(min=2.0 ** -126))) - mant)


def small_train_check(torch, dtype):
    """5 steps with the kernels against the same 5 steps through the
    plain versions, on the card, from one state (small tables)."""
    from distributed_embeddings_torch.models import DLRMConfig, DLRMDense
    from distributed_embeddings_torch.parallel import (
        SGD, DistributedEmbedding, HybridTrainState, SparseSGD,
        init_hybrid_state, make_hybrid_train_step)

    sizes = [min(s, SMALL_ROWS) for s in CRITEO_1TB_SIZES]
    cfg = DLRMConfig(table_sizes=sizes, embedding_dim=128,
                     num_numerical_features=13,
                     bottom_mlp_dims=(512, 256, 128),
                     top_mlp_dims=(1024, 1024, 512, 256, 1),
                     compute_dtype=dtype)
    de = DistributedEmbedding(cfg.embedding_configs(), world_size=1,
                              compute_dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    dense = DLRMDense(cfg, device="cuda", generator=gen)
    sk = init_hybrid_state(de, SparseSGD(), dense, SGD(TRAIN_LR),
                           generator=gen, dtype=dtype, device="cuda")
    sp = HybridTrainState(
        emb_params={k: v.clone() for k, v in sk.emb_params.items()},
        emb_opt_state=sk.emb_opt_state,
        dense_params=copy.deepcopy(sk.dense_params),
        dense_opt_state=sk.dense_opt_state, step=sk.step.clone())
    init = sk.emb_params["w128"][0].float().clone()
    step = make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), SparseSGD(),
                                  lr_schedule=TRAIN_LR, nan_guard=True)
    batches = [train_batch(torch, sizes, SMALL_BATCH, seed=100 + k,
                           bad_ids=True) for k in range(SMALL_STEPS)]
    runs = {}
    for name, state in (("kernels", sk), ("plain", sp)):
        zero_counts()
        with (plain_kernels() if name == "plain"
              else contextlib.nullcontext()):
            losses = []
            for cats, batch in batches:
                loss, state = step(state, cats, batch)
                losses.append(loss)
        torch.cuda.synchronize()
        counts = read_counts()
        want = SMALL_STEPS if name == "kernels" else 0
        check(all(n == want for n in counts.values()),
              f"small train check ({name}): launches {counts}, expected "
              f"{want} of each")
        runs[name] = (torch.stack(losses).float(), state)
    (lk, stk), (lp, stp) = runs["kernels"], runs["plain"]
    check(bool(torch.isfinite(lk).all()), "small train check: loss "
          "not finite")
    f32 = dtype == torch.float32
    loss_tol, dense_tol = (1e-5, 1e-5) if f32 else (1e-2, 1e-3)
    loss_err = float((lk - lp).abs().max())
    check(loss_err <= loss_tol, f"small train check {dtype}: losses differ "
          f"by {loss_err} (> {loss_tol})")
    dense_err = max(float((a.detach() - b.detach()).abs().max())
                    for a, b in zip(stk.dense_params.parameters(),
                                    stp.dense_params.parameters()))
    check(dense_err <= dense_tol, f"small train check {dtype}: dense params "
          f"differ by {dense_err} (> {dense_tol})")
    # a slab row that k ids updated: within k + 1 ulps of twice the
    # largest magnitude it held (both sides add with atomics in their own
    # order; upstream fp32 order differences move an add by one ulp)
    a = stk.emb_params["w128"][0].float()
    b = stp.emb_params["w128"][0].float()
    k = torch.bincount(torch.cat([global_rows(torch, de, cats, sizes)
                                  for cats, _ in batches]),
                       minlength=a.shape[0]).float()[:, None]
    scale = 2 * torch.maximum(torch.maximum(init.abs(), a.abs()), b.abs())
    err = (a - b).abs()
    bad = int(torch.count_nonzero(err > (k + 1) * ulp(torch, scale, dtype)))
    check(bad == 0, f"small train check {dtype}: {bad} slab values beyond "
          f"(k + 1) ulps (max err {float(err.max())})")
    check(bool((a != init).any()), "small train check: no slab row changed")
    log(f"  small train check {str(dtype)[6:]}: {SMALL_STEPS} steps at "
        f"b={SMALL_BATCH}, losses {[round(float(x), 5) for x in lk]}; "
        f"kernels vs plain: loss {loss_err} (tol {loss_tol}), dense "
        f"{dense_err} (tol {dense_tol}), slab max {float(err.max())} "
        "(tol (k+1) ulp)")
    return float(err.max())


def phase_train(torch, de, state):
    from distributed_embeddings_torch.ops import dot_interact_bwd_plain
    from distributed_embeddings_torch.ops import interaction, scatter_add
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, make_hybrid_train_step)

    errs = {"sgd_scatter": 0.0, "dot_interact_bwd": 0.0}
    log("train: small-table check, kernels against plain versions")
    for dtype in (torch.float32, torch.bfloat16):
        errs["sgd_scatter"] = max(errs["sgd_scatter"],
                                  small_train_check(torch, dtype))

    st = train_state(torch, state)
    slab = st.emb_params["w128"][0]
    rows = slab.shape[0]

    class RecordingSGD(SparseSGD):
        """SparseSGD that snapshots the rows its stream touches first."""

        def apply_rows(self, slab, state, ids, vals, lr):
            gid = ids.long()
            gid = torch.where(gid < 0, gid + rows, gid)
            keep = (gid >= 0) & (gid < rows)
            uniq, inv = torch.unique(gid[keep], return_inverse=True)
            self.seen = dict(uniq=uniq, inv=inv, vals=vals[keep], lr=lr,
                             before=slab[uniq].clone())
            return super().apply_rows(slab, state, ids, vals, lr)

    seen_bwd = {}
    real_bwd = interaction.DotInteract.backward

    def recording_bwd(ctx, dy):
        """``DotInteract.backward`` (one K4 launch), keeping its inputs
        and output for the comparison with the plain version."""
        out = real_bwd(ctx, dy)
        seen_bwd.update(feats=ctx.saved_tensors[0].detach(),
                        dy=dy.contiguous(), out=out)
        return out

    rec = RecordingSGD()
    check_step = make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), rec,
                                        lr_schedule=TRAIN_LR, nan_guard=True)
    cats, batch = train_batch(torch, CRITEO_1TB_SIZES, TRAIN_BATCH,
                              seed=SEED + 20)
    interaction.DotInteract.backward = staticmethod(recording_bwd)
    try:
        loss, st = check_step(st, cats, batch)
    finally:
        interaction.DotInteract.backward = staticmethod(real_bwd)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(loss)), f"full-size step: loss {float(loss)}")
    r = rec.seen
    want = r["before"].clone()
    scatter_add.sgd_scatter_plain(want, r["inv"], r["vals"], r["lr"])
    got = slab[r["uniq"]]
    k = torch.bincount(r["inv"], minlength=len(r["uniq"])).float()[:, None]
    mag = torch.zeros_like(want, dtype=torch.float32).index_add_(
        0, r["inv"], r["vals"].float().abs() * TRAIN_LR)
    err = (got.float() - want.float()).abs()
    single = int(torch.count_nonzero(err[k[:, 0] == 1]))
    bound = k * ulp(torch, r["before"].float().abs() + mag, torch.bfloat16)
    multi = int(torch.count_nonzero(err > bound))
    check(single == 0 and multi == 0, f"full-size step: {single} values of "
          f"rows hit once differ from the plain scatter, {multi} beyond k "
          f"ulps (max err {float(err.max())})")
    changed = int(torch.count_nonzero((got != r["before"]).any(1)))
    errs["sgd_scatter"] = max(errs["sgd_scatter"], float(err.max()))
    log(f"train: full-size step at b={TRAIN_BATCH}: loss {float(loss):.5f}, "
        f"{len(r['uniq'])} touched rows ({int((k > 1).sum())} hit more than "
        f"once, {changed} changed), sgd_scatter vs plain max_abs_err "
        f"{float(err.max())} (rows hit once bit-exact, k hits within k bf16 "
        "ulps)")
    b = seen_bwd
    want = dot_interact_bwd_plain(b["feats"], b["dy"])
    scale = dot_interact_bwd_plain(b["feats"].float().abs(),
                                   b["dy"].float().abs())
    err = (b["out"].float() - want.float()).abs()
    bad = int(torch.count_nonzero(err > ulp(torch, want.float(),
                                             torch.bfloat16)
                                  + 2.0 ** -20 * scale))
    check(bad == 0, f"full-size step: dot_interact_bwd differs from plain "
          f"in {bad} values (max err {float(err.max())})")
    errs["dot_interact_bwd"] = float(err.max())
    log(f"train: dot_interact_bwd {tuple(b['feats'].shape)} vs plain "
        f"max_abs_err {float(err.max())} (<= 1 bf16 ulp + 2^-20 of the "
        "sum of |terms|)")
    del seen_bwd["feats"], seen_bwd["dy"], seen_bwd["out"], rec.seen

    step = make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), SparseSGD(),
                                  lr_schedule=TRAIN_LR, nan_guard=True)
    cats, batch = train_batch(torch, CRITEO_1TB_SIZES, TRAIN_BATCH,
                              seed=SEED + 21, nan=True)
    touched = torch.unique(global_rows(torch, de, cats, CRITEO_1TB_SIZES))
    before = slab[touched].clone()
    dense_before = [p.detach().clone()
                    for p in st.dense_params.parameters()]
    step_before = int(st.step)
    loss, st = step(st, cats, batch)
    torch.cuda.synchronize()
    check(not bool(torch.isfinite(loss)), "NaN batch: loss is finite")
    check(torch.equal(slab[touched], before), "NaN batch: slab rows changed")
    check(all(torch.equal(p, q) for p, q in zip(
        st.dense_params.parameters(), dense_before)),
        "NaN batch: dense params changed")
    check(int(st.step) == step_before + 1, "NaN batch: step did not advance")
    log(f"train: NaN batch skipped, {len(touched)} touched rows and the "
        f"dense params bitwise unchanged, step {step_before} -> "
        f"{int(st.step)}")
    del before, dense_before

    batches = [train_batch(torch, CRITEO_1TB_SIZES, TRAIN_BATCH,
                           seed=SEED + 30 + k) for k in range(8)]
    for k in range(WARMUP_RUNS):
        _, st = step(st, *batches[k % len(batches)])
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    losses, times = [], []
    for k in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, st = step(st, *batches[k % len(batches)])
        end.record()
        losses.append(loss)
        times.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    losses = torch.stack(losses).float().cpu().numpy()
    check(np.isfinite(losses).all(), f"train: non-finite loss {losses}")
    for name, n in launches.items():
        check(n == TRAIN_STEPS, f"train: {name} launched {n} times in "
              f"{TRAIN_STEPS} steps (expected once per step)")
    step_ms = [s.elapsed_time(e) for s, e in times]

    # the step's stages, called one by one with events between them
    stage_ms = {"embedding_forward": [], "dense_forward_backward": [],
                "nan_guard": [], "sparse_apply": [], "dense_update": []}
    params = list(st.dense_params.parameters())
    for k in range(WARMUP_RUNS + 10):
        cats, batch = batches[k % len(batches)]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        with torch.no_grad():
            outs, res = de.forward_with_residuals(st.emb_params, cats)
        ev[1].record()
        outs = [o.detach().requires_grad_() for o in outs]
        loss = loss_fn(st.dense_params, outs, batch)
        grads = torch.autograd.grad(loss, params + outs)
        ev[2].record()
        out_grads = list(grads[len(params):])
        ok = torch.isfinite(loss) & torch.isfinite(sum(
            g.float().square().sum() for g in grads))
        ev[3].record()
        de.sparse_apply_gradients(st.emb_params, st.emb_opt_state, res,
                                  out_grads, SparseSGD(), TRAIN_LR, enable=ok)
        ev[4].record()
        with torch.no_grad():
            for p, g in zip(params, grads[:len(params)]):
                p.copy_(torch.where(ok, p + g * -TRAIN_LR, p))
        ev[5].record()
        torch.cuda.synchronize()
        if k >= WARMUP_RUNS:
            for i, name in enumerate(stage_ms):
                stage_ms[name].append(ev[i].elapsed_time(ev[i + 1]))
    stages = {n: float(np.median(v)) for n, v in stage_ms.items()}
    result = {
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
        "samples_per_s": TRAIN_STEPS * TRAIN_BATCH / wall,
        "wall_step_ms": wall / TRAIN_STEPS * 1e3,
        "step_ms_p50": float(np.median(step_ms)),
        "step_ms_min": float(np.min(step_ms)),
        "stage_ms_p50": stages,
        "launches_per_step": {n: v / TRAIN_STEPS
                              for n, v in launches.items()},
        "loss_first": float(losses[0]), "loss_last": float(losses[-1])}
    log("train: " + json.dumps(result))
    return launches, errs, result


def phase_time(torch, de, state, errs, launches):
    import torch.nn.functional as F
    from distributed_embeddings_torch.ops import (
        dot_interact_fwd, dot_interact_fwd_plain, gather_combine,
        gather_combine_plain)

    slab = state.emb_params["w128"][0]
    w = slab.shape[1]
    k1_cases = []
    for label, b, hot in (("rung256_hot1", RUNG, 1),
                          ("b65536_hot1", TRAIN_BATCH, 1),
                          ("b65536_hot3_mean", TRAIN_BATCH, 3)):
        cases = [k1_case(torch, de, b, hot, seed=1000 + k, bad_ids=False)
                 for k in range(8)]
        args = [(c["ids"], c["rows"], c["roff"], c["div"]) for c in cases]
        # the library call's input: the same global rows, clipped and
        # offset outside the timed region
        grows = [(torch.minimum(c["ids"].long().clamp(min=0),
                                c["rows"].view(-1, 1, 1) - 1)
                  + c["roff"].view(-1, 1, 1)) for c in cases]
        ms = time_ms(torch, lambda *a: gather_combine(slab, *a), args)
        plain = time_ms(torch, lambda *a: gather_combine_plain(slab, *a),
                        args)
        if hot == 1:
            lib = time_ms(torch, lambda g: F.embedding(g.view(-1), slab),
                          [(g,) for g in grows])
        else:
            lib = time_ms(torch, lambda g: F.embedding_bag(
                g.view(-1, hot), slab, mode="mean"), [(g,) for g in grows])
        uniq = int(torch.unique(grows[0]).numel())
        nbytes = (uniq * w * 2 + cases[0]["ids"].numel() * 4
                  + len(CRITEO_1TB_SIZES) * b * w * 2)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        k1_cases.append({"case": label, "ms": ms, "plain_ms": plain,
                         "library_ms": lib, "bound_ms": bound,
                         "bound_by": "bytes", "unique_rows": uniq,
                         "bytes": nbytes})
        log(f"time gather_combine {label}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f}, library {lib:.4f}, bound {bound:.4f} "
            f"({uniq} unique rows)")
    k2_cases = []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for label, b in (("rung256", RUNG), ("b65536", TRAIN_BATCH)):
        feats = [(torch.randn((b, 27, 128), generator=gen, device="cuda"
                              ).to(torch.bfloat16),) for _ in range(4)]
        li, lj = np.tril_indices(27, k=-1)
        li = torch.as_tensor(li, device="cuda")
        lj = torch.as_tensor(lj, device="cuda")

        def library(f):
            gram = torch.bmm(f, f.transpose(1, 2))
            return torch.cat([gram[:, li, lj], f[:, 0]], dim=1)

        ms = time_ms(torch, dot_interact_fwd, feats)
        plain = time_ms(torch, dot_interact_fwd_plain, feats)
        lib = time_ms(torch, library, feats)
        p = 27 * 26 // 2
        nbytes = b * 27 * 128 * 2 + b * (p + 128) * 2
        ops = 2 * b * p * 128
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / BF16_OPS_PER_S * 1e3
        k2_cases.append({"case": label, "ms": ms, "plain_ms": plain,
                         "library_ms": lib, "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops
                         else "operations", "bytes": nbytes, "ops": ops})
        log(f"time dot_interact_fwd {label}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f}, library {lib:.4f}, bound "
            f"{max(t_bytes, t_ops):.4f}")
    k3_cases = time_sgd_scatter(torch, de, slab)
    k4_cases = time_dot_interact_bwd(torch)
    kernels = []
    for name, src, repl, cases, path in (
            ("gather_combine", "distributed_embeddings_torch/csrc/"
             "gather_combine.cu",
             "distributed_embeddings_tpu/parallel/lookup.py:167", k1_cases,
             "serve"),
            ("dot_interact_fwd", "distributed_embeddings_torch/csrc/"
             "dot_interact.cu",
             "distributed_embeddings_tpu/models/dlrm.py:39", k2_cases,
             "serve"),
            ("sgd_scatter", "distributed_embeddings_torch/csrc/"
             "sgd_scatter.cu",
             "distributed_embeddings_tpu/parallel/optimizers.py:95",
             k3_cases, "train"),
            ("dot_interact_bwd", "distributed_embeddings_torch/csrc/"
             "dot_interact.cu",
             "distributed_embeddings_tpu/models/dlrm.py:39", k4_cases,
             "train")):
        # the main case: K1/K2 at the serving shape (the ladder's top
        # rung), K3/K4 at the training batch
        main = cases[0]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[path][name],
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": errs[name],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["case"],
            "cases": cases})
    return kernels


def time_sgd_scatter(torch, de, slab):
    """K3 at the training stream (26 x 65536 ids, b-major, as the step
    builds it) on the real slab, with 8 Zipfian id sets."""
    from distributed_embeddings_torch.ops import (sgd_scatter,
                                                  sgd_scatter_plain)

    w = slab.shape[1]
    roff = torch.as_tensor(de.row_offsets_list[0], dtype=torch.int32,
                           device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    args, lib_args, uniq = [], [], []
    for k in range(8):
        cats, _ = train_batch(torch, CRITEO_1TB_SIZES, TRAIN_BATCH,
                              seed=2000 + k)
        ids = (torch.stack(cats, dim=1) + roff).reshape(-1).contiguous()
        vals = (torch.randn((ids.numel(), w), generator=gen, device="cuda")
                * 1e-3).to(torch.bfloat16)
        args.append((ids, vals))
        nl = torch.tensor(-TRAIN_LR, dtype=torch.bfloat16, device="cuda")
        lib_args.append((ids.long(), vals * nl))
        uniq.append(int(torch.unique(ids).numel()))
    ms = time_ms(torch, lambda i, v: sgd_scatter(slab, i, v, TRAIN_LR), args)
    plain = time_ms(torch, lambda i, v: sgd_scatter_plain(slab, i, v,
                                                          TRAIN_LR), args)
    lib = time_ms(torch, lambda i, u: slab.index_add_(0, i, u), lib_args)
    n = args[0][0].numel()
    nbytes = n * w * 2 + n * 4 + 2 * uniq[0] * w * 2
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"time sgd_scatter b65536: kernel {ms:.4f} ms, plain {plain:.4f}, "
        f"library {lib:.4f}, bound {bound:.4f} ({uniq[0]} unique rows of "
        f"{n} ids)")
    return [{"case": "b65536", "ms": ms, "plain_ms": plain,
             "library_ms": lib, "bound_ms": bound, "bound_by": "bytes",
             "unique_rows": uniq[0], "ids": n, "bytes": nbytes}]


def time_dot_interact_bwd(torch):
    """K4 at the training batch: feats [65536, 27, 128] and dy
    [65536, 479], bf16."""
    from distributed_embeddings_torch.ops import (dot_interact_bwd,
                                                  dot_interact_bwd_plain)

    b, f, d = TRAIN_BATCH, 27, 128
    p = f * (f - 1) // 2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    args = [(torch.randn((b, f, d), generator=gen, device="cuda"
                         ).to(torch.bfloat16),
             torch.randn((b, p + d), generator=gen, device="cuda"
                         ).to(torch.bfloat16)) for _ in range(4)]
    li, lj = np.tril_indices(f, k=-1)
    li = torch.as_tensor(li, device="cuda")
    lj = torch.as_tensor(lj, device="cuda")

    def library(feats, dy):
        dg = torch.zeros((b, f, f), dtype=feats.dtype, device="cuda")
        dg[:, li, lj] = dy[:, :p]
        dg[:, lj, li] = dy[:, :p]
        out = torch.bmm(dg, feats)
        out[:, 0] += dy[:, p:]
        return out

    ms = time_ms(torch, dot_interact_bwd, args)
    plain = time_ms(torch, dot_interact_bwd_plain, args)
    lib = time_ms(torch, library, args)
    nbytes = 2 * b * f * d * 2 + b * (p + d) * 2
    ops = 2 * b * f * f * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    log(f"time dot_interact_bwd b65536: kernel {ms:.4f} ms, plain "
        f"{plain:.4f}, library {lib:.4f}, bound {max(t_bytes, t_ops):.4f}")
    return [{"case": "b65536", "ms": ms, "plain_ms": plain,
             "library_ms": lib, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bytes": nbytes, "ops": ops}]


def main():
    try:
        import torch
    except ImportError as e:
        raise SystemExit(f"chip_smoke: PyTorch is not installed ({e})")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs only on a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "distributed_embeddings_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(distributed_embeddings_torch/ is missing)")
    sys.path.insert(0, here)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device(torch)
    phase_build()
    _, de, state = phase_model(torch)
    errs = phase_check(torch, de, state)
    serve_launches, _ = phase_serve(torch, de, state)
    train_launches, train_errs, _ = phase_train(torch, de, state)
    errs.update(train_errs)
    launches = {"serve": serve_launches, "train": train_launches}
    kernels = phase_time(torch, de, state, errs, launches)
    log(f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
