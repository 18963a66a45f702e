#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

Drives the port's serving path end to end at full width and real size:
DLRM with the 26 Criteo-1TB (MLPerf DLRM) tables of width 128 in bf16
(187,767,425 rows, a 48.1 GB slab), 13 dense features, bottom MLP
512-256-128, top MLP 1024-1024-512-256-1, random weights from a seed,
served through ``ServingRuntime`` with its default ladder.

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
   samples run through the plain functions, and both kernels must have
   launched;
6. time: CUDA-event medians (20+ runs after warmup) of each kernel, its
   plain version, one PyTorch library call for the same function, and
   the least time the card could take (bytes over 3.35 TB/s, operations
   over 989 TFLOP/s bf16, the H100 SXM data-sheet peaks).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Run from the root of a checkout:
``python3 chip_smoke.py``.
"""

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
    from distributed_embeddings_torch.ops import (dot_interact_fwd,
                                                  gather_combine)
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

    gather_combine.launches = 0
    dot_interact_fwd.launches = 0
    results = drive(rt, make_request, qps=400.0, duration_s=1.0)
    launches = {"gather_combine": gather_combine.launches,
                "dot_interact_fwd": dot_interact_fwd.launches}
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
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the served path")
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
    log("serve stats: " + json.dumps({k: s[k] for k in (
        "served", "served_samples", "flushes", "pad_fraction",
        "latency_p50_ms", "latency_p95_ms", "latency_p99_ms",
        "deadline_missed", "rung_flushes", "p99_dominant_stage")}))
    log("serve stages (ms): " + json.dumps({
        stage: {q: v[q] for q in ("p50", "p99", "mean")}
        for stage, v in s["latency_stages_ms"].items()}))
    return launches, s


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
    kernels = []
    for name, src, repl, cases in (
            ("gather_combine", "distributed_embeddings_torch/csrc/"
             "gather_combine.cu",
             "distributed_embeddings_tpu/parallel/lookup.py:167", k1_cases),
            ("dot_interact_fwd", "distributed_embeddings_torch/csrc/"
             "dot_interact.cu",
             "distributed_embeddings_tpu/models/dlrm.py:39", k2_cases)):
        main = cases[0]  # the serving shape: the ladder's top rung
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["case"],
            "cases": cases})
    return kernels


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
    launches, _ = phase_serve(torch, de, state)
    kernels = phase_time(torch, de, state, errs, launches)
    log(f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
