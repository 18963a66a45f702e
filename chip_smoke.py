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
   over 989 TFLOP/s bf16, the H100 SXM data-sheet peaks);
8. zoo, after freeing the DLRM state: the synthetic zoo's tiny model
   (55 tables, a w8 slab run dense-apply and a 70.2M-row w16 slab run
   sparse) trained by ``SparseAdagrad`` + ``Adagrad`` at lr 0.01, MSE:
   a. capped at 20000 rows, batch 4096: 5 steps with the kernels
      against 5 through ``plain_kernels()``, fp32, bf16 tables over
      fp32 accumulators and bf16/bf16, each regime forced;
   b. uncapped, batch 65536, fp32 then bf16 tables: one step, each
      kernel of the sparse apply (K3 + K7 on w8, K5 + K6 on w16) held
      to its plain version on the inputs the step gave it;
   c. a NaN batch must leave the touched rows and accumulators, the
      dense params and their Adagrad state bitwise unchanged;
   d. 3 warmup + 20 timed steps, fp32 and bf16 tables, launches counted
      as in 6d, a stage split and a ``torch.profiler`` window (device
      busy share, K5's launch chain);
   e. K1 (hot 10, w16), K3 (the w8 scatter-sum), K5, K6 and K7 timed
      as in 7, and the w16 slab through both Adagrad regimes;
9. ragged, after freeing the zoo state: the multi-hot ragged DLRM
   (``bench.py``'s ``multihot_ragged``): the Criteo-Kaggle tables capped
   at 2M rows in fp32 (10,569,296 rows, a 5.41 GB slab), 26 ragged
   features of U{1..30} Zipfian ids a row in one plan group, bf16
   compute, ``SparseSGD`` + SGD at lr 0.005, batch 65536:
   a. K8, K9 and K10 against their plain versions on the card,
      bit-exact, at the edge cases (sum/mean, weights, bad ids clipped
      and masked, empty rows, rows past the capacity, a row of 1,200
      ids);
   b. capped at 20000 rows, batch 4096, one mean table and one weighted
      feature, fp32 and bf16 tables: 5 steps in lockstep, each run with
      the kernels and, from a copy of the same state, with K8-K10
      through ``plain_kernels(RAGGED_SITES)``: losses and dense params
      bitwise equal, slabs within K3's atomic-order bound, and a control
      run that drops half the stream must fail that bound;
   c. one full-size step (~1% bad ids): K10's splits, K8's output and
      K9's stream bit-exact against their plain versions on the step's
      own inputs,
      the touched slab rows against the plain scatter of the stream,
      and three features given as ``SparseIds`` (``row_to_split``, K10)
      giving a bitwise-equal forward;
   d. a NaN batch leaving the touched rows and the dense params
      bitwise unchanged;
   e. 3 warmup + 20 timed steps over 4 pre-staged batches with the
      launches counted (K8 1, K9 1, K10 2, K3 1, K2 1, K4 1 a step) and
      a stage split;
   f. K8, K9 and K10 timed at this shape as in 7 (K10's
      ``ragged_row_ids`` on the step's own splits, beside
      ``torch.searchsorted``);
10. adam, after freeing the ragged state: lazy ``SparseAdam`` and
    ``SparseMomentum`` on K5 then K11 (``csrc/adam.cu``) / K12
    (``csrc/momentum.cu``):
   a. K11 and K12 against their plain versions on the card, bit-exact,
      at the edge cases (fp32/bf16 tables and state, widths 16, 8 and 3,
      a Python and a device lr, counts 1 and 1000, Nesterov, negative
      ids, the sentinel, the pad tail, an id repeated 50,000 times),
      and K6, K11 and K12 on a stream holding a negative id beside its
      wrapped row and id 0 beside -R;
   b. the tiny zoo capped at 20000 rows, b=4096, 5 lockstep steps with
      ``SparseAdam`` + ``Adam`` and with ``SparseMomentum`` + ``Adagrad``,
      fp32 and bf16 tables, each step also run from a copy of the same
      state with only K11/K12 plain: everything bitwise equal;
   c. the planted-signal DLRM (``models/learnable.py``) trained on the
      card: the JAX learning test's configuration (240 steps, fp32 seeds
      0 and 11, bf16 seed 11) against that test's bounds, and the bench's
      ``convergence`` configuration (360 steps at b=8192, fp32 and bf16),
      its AUCs printed;
   d. the uncapped tiny zoo with ``SparseAdam`` + ``Adam(0.01)``, fp32
      tables: one step with K5 and K11 held to their plain versions on
      the step's own inputs, a NaN batch (slab rows, mu/nu, the counts,
      the dense params and dense Adam state bitwise unchanged), 3 warmup
      + 20 timed steps (launches a step: K1 4, K5 2, K11 2), a stage
      split, and K11 timed at the w16 and w8 shapes beside its plain
      version, its byte bound and ``torch.optim.SparseAdam.step``;
   e. the same slabs with ``SparseMomentum(0.9)`` and with Nesterov: one
      checked step and 5 timed steps each, K12 timed;
   f. bf16 tables with ``SparseAdam``: one checked step, 20 timed steps.
11. telemetry, after freeing the Adam state: access telemetry
    (``analysis/telemetry.py``, K13-K15 in ``csrc/sketch.cu``) on
    ``bench.py:run_telemetry_overhead``'s configuration (the one-hot
    DLRM over the Criteo-Kaggle vocabularies capped at 2M rows, bf16
    tables and compute, ``SparseSGD`` + SGD at lr 0.005, b=16384, guard
    off, the default sketch):
   a. 3 steps with K13-K15 and 3 with their plain versions: every
      telemetry leaf bitwise equal;
   b. 3 lockstep steps with telemetry on and off: losses, dense params
      and K3's inputs bitwise, the slab within K3's atomic order;
   c. a NaN batch under the guard: the train state bitwise unchanged,
      its ids folded (bitwise the plain fold of them);
   d. planted hot rows ranked first in their tables by ``hot_rows``;
   e. 2 warmup + 12 timed steps off and on (launches a step: K1, K2,
      K4, K3, K13, K14, K15 once), ``telemetry_overhead_frac``;
   f. K13, K14 and K15 timed on the step's stream (and, in phase 9f, on
      the ragged step's ~26.4M positions) beside their plain versions,
      a PyTorch yardstick and their byte bounds.
12. streaming, after freeing the telemetry state: streaming vocabularies
    (``parallel/streaming.py``; K16 remap and K17 commit in
    ``csrc/streaming.cu``, K13 for the admission sketch):
   a. K16 and K17 against their plain versions on the card, bit-exact,
      at the edge cases (free slots, a claim below the gate, eviction at
      exactly the margin and at one less, equal estimates decided by the
      fingerprint and equal (estimate, fingerprint) by the position, a
      row hit by its occupant and claimed by another id, dead, negative
      and int64 ids past 2^32, enable false, a bf16 slab over fp32
      accumulators, Adam's mu/nu, an Inf in a claimed row);
   b. ``bench.py:run_streaming`` at its full size (vocab 400,000,
      capacity 50,000 + 3,125 buckets at dim 16 beside a 100-row table,
      ``SparseAdagrad`` at 0.5 and SGD(0.01) on a scalar, b=4096, 200
      day-k steps, guard off) against its static twin (an 800,000-row
      table): the first 5 steps in lockstep with K16/K17 through their
      plain versions (everything bitwise), both day-k+1 AUCs (drift
      0.15, 4 batches through ``make_hybrid_eval_step(dynamic=)``),
      samples/s, the counters and the bytes;
   c. the capped Criteo-Kaggle one-hot DLRM (fp32 tables, bf16 compute,
      ``SparseAdagrad`` at 0.01 + SGD at 0.005, guard on, b=65536, one
      Zipfian id a feature over its full vocabulary) with tables 2, 3,
      11, 15 and 20 streaming (1,882,353 slots + 117,647 buckets each):
      one step with K16 (and its K13 fold), K5, K6 and K17 each held to
      its plain version on the step's own inputs, a NaN batch (all state
      bitwise unchanged), 3 warmup + 20 timed steps against the static
      twin (the same slabs without the streaming entries) with
      ``streaming_overhead_frac``, Zipfian requests through
      ``ServingRuntime(streaming=)``, and K16 (update and read-only) and
      K17 timed beside their plain versions and byte bounds.
13. example, after freeing the streaming state: the DLRM example
    (``distributed_embeddings_torch/examples/dlrm_main.py``) with bf16
    tables under the MLPerf schedule, whose ``SparseSGD`` update is JAX's
    promoted float32 scatter (K18, ``csrc/sgd_promoted.cu``):
   a. K18 against its stream-order plain version (on CPU copies),
      bit-exact, at the edge cases (widths 3, 16, 128, 200, fp32 and
      bf16 update rows, int32 and int64 ids, an empty stream, a row hit
      5,000 and one 50,000 times, negative ids, the sentinel, ids past
      the slab, NaN and Inf), and K3's dedup chain;
   b. (run at the end of phase 7, on the Criteo-1TB bf16 DLRM) one step
      under ``warmup_poly_decay_schedule(24, 8000, 48000, 24000)`` at
      step 24000 (lr 24): K18's touched rows bit-exact to the plain version on the
      step's own inputs, then K18 timed on that 1,703,936-id stream
      beside K3, the plain version, ``index_add_`` and its byte bound;
   c. the example in process at the capped Criteo-Kaggle size (10,569,296
      rows, 2.71 GB bf16), dim 128, the default MLPs, b=65536, lr 24:
      run A 40 steps with eval every 20 and 1 s of serving at 200 QPS
      (every request ``Served``), launches counted (K1, K2, K4, K18);
      run B 20 steps with ``--save_state``, then ``--restore_state`` to
      step 40: losses, slab, dense params, schedule count and step
      bitwise equal to A's; samples/s, save and restore seconds,
      checkpoint bytes, AUC; K18 timed at this shape;
   d. a NaN batch under the guard on A's final state: the bf16 slab, the
      dense params and the schedule's count bitwise unchanged, the step
      advanced.
14. world 8, after freeing the example state: the DLRM hybrid step at
    world 8 on this one card, eight rank processes on ``cuda:0`` joined
    in one gloo group (a ``file://`` store), every exchange staged
    through host memory (``parallel/bootstrap.py``). The exchange
    packing is K19 (id blocks) and K20 (column blocks), both in
    ``csrc/exchange_pack.cu``; every world-1 step above also packs its
    id block (K19) and, in training, its cotangents (K20) once:
   a. K19/K20 against their plain versions on the card, bit-exact, at
      the edge cases (worlds 1 and 8, multi-slot and column-sliced
      instances, ragged weighted blocks, int32/int64 ids, every
      float32/bfloat16 pair, NaN and Inf bits, unaligned copies, 1,300
      copies in three launches) and at the slice's rank shapes (ranks 0
      and 7), the id block and the cotangent block also against the
      reference concatenation of cells;
   d. (run here, in this process alone: eight contending ranks would
      distort kernel times) K19 and K20 timed at rank 0's shapes and at
      the world-1 DLRM step's b=65536 beside their plain versions, one
      ``torch.cat`` of the same parts and their byte bounds, with each
      call's host time; and the world-1 DLRM's embedding forward and
      sparse apply stages (capped tables, b=65536) with K19/K20 and with
      the reference concatenation of cells (what the step ran before),
      in turns;
   b. the 26 tables capped at 20,000 rows, ``column_slice_threshold``
      2,400,000 (the capped tables slice), fp32, b=4096 global: 5
      world-8 steps and an eval batch against 5 world-1 steps in this
      process from the same tables and dense params: losses, dense
      params and eval predictions within 1e-5, slab values within 1e-6
      and the slabs' updates within 1e-3 of world 1's in relative L2
      norm (atomic add order and five steps of fp32 drift: 3.5e-8 at
      most on the CPU); every rank's
      K19/K20 calls bit-exact to their plain versions on the step's own
      inputs; a control run that drops source rank 3's cotangent block
      on every rank must fail the update bound;
   c. the Criteo-1TB tables at width 128, ``comm_balanced``,
      ``column_slice_threshold`` 1.4e9 (tools/_profcommon.py), bf16
      tables and compute, ``SparseSGD`` + SGD at 0.005, guard on, global
      batch 65536 (8192 a rank), Zipfian ids: one checked step (K19/K20
      bit-exact on every rank, each width slab's touched rows against
      the plain scatter), a NaN batch on rank 5 only (every rank's
      touched rows and dense params bitwise unchanged, the step
      advanced), 2 warmup + 10 timed steps with the launches counted
      (a rank a step: K1 2, K19 1, K20 3, K2 1, K4 1, K3 2), and a
      per-stage split (id exchange, lookup, output exchange, dense,
      all-reduce, cotangent exchange, apply; host and device ms). Its
      samples/s are those of 8 ranks time-sharing one H100 over gloo:
      not a multi-GPU and not an NCCL number.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Run from the root of a checkout:
``python3 chip_smoke.py``.
"""

import contextlib
import copy
import gc
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
SMALL_ROWS = 20000             # table-size cap of the small training checks
# every world-1 train step packs its id block (K19) and its cotangents
# (K20) once
EXCHANGE_KERNELS = ("pack_ids", "pack_columns")
DLRM_KERNELS = ("gather_combine", "dot_interact_fwd", "dot_interact_bwd",
                "sgd_scatter") + EXCHANGE_KERNELS
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, fp32 (no tensor cores)
ZOO_LR = 0.01                  # both optimizers' lr in bench.py:run_tiny_zoo
ZOO_BATCH = 65536
ZOO_BATCHES = 4                # distinct batches the timed steps cycle over
K5_KERNELS = ("init_keys", "radix_hist", "scan_reduce", "scan_partials",
              "scan_apply", "radix_scatter", "count_bounds", "seg_sum",
              "seg_fix", "fill_tail")  # csrc/dedup.cu's launch chain
K5_CHAIN = re.compile(r"namespace\)::(" + "|".join(K5_KERNELS) + r")[<(]")


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
    uuid = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,pci.bus_id",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"host: {host_cpu()}; {len(os.sched_getaffinity(0))} cores usable "
        f"of {os.cpu_count()}; card {uuid.stdout.strip()}")
    return lines[0].strip()


def host_cpu():
    """The host CPU as ``/proc/cpuinfo`` describes its first core (a
    host-bound step's time depends on it)."""
    keys = ("vendor_id", "cpu family", "model", "model name", "stepping",
            "cpu MHz")
    found = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _, val = line.partition(":")
            if key.strip() in keys:
                found[key.strip()] = val.strip()
    return ", ".join(f"{k} {found[k]}" for k in keys if k in found)


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
    served_kernels = ("gather_combine", "dot_interact_fwd", "pack_ids")
    for name in served_kernels:
        check(launches[name] > 0, f"{name} never launched on the served "
              "path")
    for name in launches:
        if name not in served_kernels:
            check(launches[name] == 0, f"{name} launched on the served "
                  "path")
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
    for name in served_kernels:
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
        adagrad_dense, adagrad_rows, adam_rows, cms_query, cms_update,
        commit_rows, dedup_sparse_grad, dot_interact_bwd, dot_interact_fwd,
        gather_combine, lengths_to_splits, momentum_rows, pack_columns,
        pack_ids, ragged_combine, ragged_grad, ragged_row_ids, remap_stage,
        row_to_split, sgd_scatter, sgd_scatter_promoted, topk_merge,
        topk_pool)

    return {"gather_combine": gather_combine,
            "dot_interact_fwd": dot_interact_fwd,
            "dot_interact_bwd": dot_interact_bwd, "sgd_scatter": sgd_scatter,
            "dedup_sparse_grad": dedup_sparse_grad,
            "adagrad_rows": adagrad_rows, "adagrad_dense": adagrad_dense,
            "ragged_combine": ragged_combine, "ragged_grad": ragged_grad,
            "lengths_to_splits": lengths_to_splits,
            "row_to_split": row_to_split, "ragged_row_ids": ragged_row_ids,
            "adam_rows": adam_rows, "momentum_rows": momentum_rows,
            "cms_update": cms_update, "cms_query": cms_query,
            "topk_pool": topk_pool, "topk_merge": topk_merge,
            "remap_stage": remap_stage, "commit_rows": commit_rows,
            "sgd_scatter_promoted": sgd_scatter_promoted,
            "pack_ids": pack_ids, "pack_columns": pack_columns}


def zero_counts():
    for fn in kernel_fns().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_fns().items()}


@contextlib.contextmanager
def plain_kernels(names=None):
    """Route every kernel call site of the package (or, with ``names``,
    those of the wrappers so named) to its plain version (the reference
    run of the small training checks)."""
    from distributed_embeddings_torch.analysis import telemetry
    from distributed_embeddings_torch.ops import (
        adagrad, adam, exchange_pack, gather_combine_plain, interaction,
        lengths_to_splits_plain, momentum, ragged_combine_plain,
        row_to_split_plain, scatter_add, sketch, sparse_grad)
    from distributed_embeddings_torch.ops import streaming as sops
    from distributed_embeddings_torch.parallel import (
        apply, dist_embedding, exchange, lookup, optimizers, streaming)

    swaps = [(lookup, "gather_combine", gather_combine_plain),
             (lookup, "ragged_combine", ragged_combine_plain),
             (lookup, "lengths_to_splits", lengths_to_splits_plain),
             (apply, "lengths_to_splits", lengths_to_splits_plain),
             (apply, "ragged_grad", sparse_grad.ragged_grad_plain),
             (dist_embedding, "row_to_split", row_to_split_plain),
             (interaction, "dot_interact_fwd",
              interaction.dot_interact_fwd_plain),
             (interaction, "dot_interact_bwd",
              interaction.dot_interact_bwd_plain),
             (optimizers, "sgd_scatter", scatter_add.sgd_scatter_plain),
             (scatter_add, "sgd_scatter_promoted",
              scatter_add.sgd_scatter_promoted_plain),
             (optimizers, "dedup_sparse_grad",
              sparse_grad.dedup_sparse_grad_plain),
             (optimizers, "adagrad_rows", adagrad.adagrad_rows_plain),
             (optimizers, "adagrad_dense", adagrad.adagrad_dense_plain),
             (optimizers, "adam_rows", adam.adam_rows_plain),
             (optimizers, "momentum_rows", momentum.momentum_rows_plain),
             (telemetry, "sketch_update", sketch.cms_update_plain),
             (telemetry, "sketch_query", sketch.cms_query_plain),
             (telemetry, "topk_pool", sketch.topk_pool_plain),
             (telemetry, "topk_merge", sketch.topk_merge_plain),
             (streaming, "remap_stage", sops.remap_stage_plain),
             (streaming, "commit_rows", sops.commit_rows_plain),
             (exchange, "pack_ids", exchange_pack.pack_ids_plain),
             (exchange, "pack_columns", exchange_pack.pack_columns_plain)]
    if names is not None:
        swaps = [sw for sw in swaps if sw[1] in names]
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
        check(all(counts[k] == (want if k in DLRM_KERNELS else 0)
                  for k in counts),
              f"small train check ({name}): launches {counts}, expected "
              f"{want} of each DLRM kernel and none of the others")
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
        want = TRAIN_STEPS if name in DLRM_KERNELS else 0
        check(n == want, f"train: {name} launched {n} times in "
              f"{TRAIN_STEPS} steps (expected {want})")
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


# ------------------------------------------------------------------ zoo


def zoo_loss(dense, outs, batch):
    """MSE of the synthetic model's output, as ``bench.py:run_tiny_zoo``."""
    num, lab = batch
    return (dense(num, outs) - lab).square().mean()


def zoo_streams(cfg, b):
    """Ids per step of each width slab: ``{width: n}``."""
    from distributed_embeddings_torch.models import expand_embedding_configs

    tables, imap, hot = expand_embedding_configs(cfg)
    out = {}
    for t, h in zip(imap, hot):
        w = tables[t]["output_dim"]
        out[w] = out.get(w, 0) + b * h
    return out


def zoo_expected(de, opt, cfg, b):
    """Launches per step of each kernel on the zoo path: K1 once per plan
    group; per slab K3 + K7 (dense-apply) or K5 + K6 (sparse)."""
    plan = next(iter(de._plan_cache.values()))
    want = {name: 0 for name in kernel_fns()}
    want.update(gather_combine=len(plan.groups), pack_ids=1, pack_columns=1)
    regimes = {}
    for w, n in zoo_streams(cfg, b).items():
        dense = opt.dense_apply(de.rows_cap[w], n)
        regimes[f"w{w}"] = "dense-apply" if dense else "sparse"
        for name in (("sgd_scatter", "adagrad_dense") if dense
                     else ("dedup_sparse_grad", "adagrad_rows")):
            want[name] += 1
    return want, regimes


def zoo_model(torch, dtype, row_cap=None, ratio=6.0, seed=SEED + 40,
              opt=None, tx=None):
    """The tiny zoo (``row_cap`` rows a table at most), its train state
    and the optimizer: ``SparseAdagrad`` + ``Adagrad`` unless ``opt`` and
    ``tx`` are given."""
    from distributed_embeddings_torch.models import (build_synthetic,
                                                     synthetic_models_v3)
    from distributed_embeddings_torch.parallel import (
        Adagrad, SparseAdagrad, init_hybrid_state)

    cfg = synthetic_models_v3["tiny"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    de, dense, _ = build_synthetic(cfg, 1, row_cap=row_cap, device="cuda",
                                   generator=gen)
    if opt is None:
        opt, tx = SparseAdagrad(dense_apply_ratio=ratio), Adagrad(ZOO_LR)
    st = init_hybrid_state(de, opt, dense, tx, generator=gen, dtype=dtype,
                           device="cuda")
    return cfg, de, opt, st


def clone_tree(t):
    """A copy of every tensor of a dict / tuple / named-tuple state."""
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda v: v.clone() if hasattr(v, "clone")
                           else v, t)


def clone_state(st):
    from distributed_embeddings_torch.parallel import HybridTrainState

    return HybridTrainState(
        emb_params=clone_tree(st.emb_params),
        emb_opt_state=clone_tree(st.emb_opt_state),
        dense_params=copy.deepcopy(st.dense_params),
        dense_opt_state=clone_tree(st.dense_opt_state),
        step=st.step.clone())


def zoo_small_check(torch, dtype, acc_dtype, ratio):
    """5 steps of the tiny zoo capped at SMALL_ROWS rows a table, b=4096,
    with the kernels against the same 5 steps through the plain
    versions, on the card, from one state (tables in ``dtype``,
    accumulators in ``acc_dtype``).

    Bounds: both runs compute the dense half alike, but the kernels sum
    duplicate ids in another order than the plain versions (K3's atomics,
    K5's pieces) and round ``rsqrt`` differently, and the synthetic
    model's raw numerical features (x100) can make a ReLU whose
    pre-activation is at rounding level flip sign, after which that
    unit's Adagrad steps differ by up to lr:
    - fp32 tables: losses within 2e-3 relative, dense params within
      2e-3, slabs within 1e-4, accumulators within 1e-3 relative;
    - bf16 tables: losses 2e-2, dense 1e-2, slabs within 8 bf16 ulps of
      the slab's largest entry, accumulators 1e-3 (fp32) or 1/8 (bf16)
      relative;
    - bf16 accumulators in the dense-apply regime: the scatter-sum adds
      a ten-row table's ~6,500 ids a step in bf16, rounding after each
      add (as JAX does), in each run's own atomic order, so a row's
      gradient sum, and the sign of its Adagrad step, differ between
      the runs, and the 5-step trajectories part: finite losses, dense
      params, slabs and accumulators, and trained slabs, are all that
      is checked (the differences are logged). ``zoo_full_check`` holds
      this path's K3 and K7 to their bounds on the step's own inputs."""
    from distributed_embeddings_torch.models import InputGenerator
    from distributed_embeddings_torch.parallel import (
        Adagrad, make_hybrid_train_step)

    cfg, de, opt, sk = zoo_model(torch, dtype, SMALL_ROWS, ratio)
    sk = sk._replace(emb_opt_state={k: v.to(acc_dtype) for k, v in
                                    sk.emb_opt_state.items()})
    sp = clone_state(sk)
    init = {k: v.float().clone() for k, v in sk.emb_params.items()}
    step = make_hybrid_train_step(de, zoo_loss, Adagrad(ZOO_LR), opt,
                                  lr_schedule=ZOO_LR, nan_guard=True)
    data = InputGenerator(cfg, SMALL_BATCH, alpha=1.05,
                          num_batches=SMALL_STEPS, seed=SEED + 41,
                          row_cap=SMALL_ROWS, device="cuda")
    runs, want, regimes = {}, None, None
    for name, st in (("kernels", sk), ("plain", sp)):
        zero_counts()
        with (plain_kernels() if name == "plain"
              else contextlib.nullcontext()):
            losses = []
            for k in range(SMALL_STEPS):
                num, cats, lab = data[k]
                loss, st = step(st, cats, (num, lab))
                losses.append(loss)
        torch.cuda.synchronize()
        counts = read_counts()
        if want is None:
            want, regimes = zoo_expected(de, opt, cfg, SMALL_BATCH)
        expect = {k: (v * SMALL_STEPS if name == "kernels" else 0)
                  for k, v in want.items()}
        check(counts == expect, f"zoo small check ({name}): launches "
              f"{counts}, expected {expect}")
        runs[name] = (torch.stack(losses).float(), st)
    (lk, stk), (lp, stp) = runs["kernels"], runs["plain"]
    check(bool(torch.isfinite(lk).all() and torch.isfinite(lp).all()),
          "zoo small check: loss not finite")
    noisy = acc_dtype == torch.bfloat16 and ratio is not None
    if noisy:
        t_loss = t_dense = t_acc = None
    elif dtype == torch.float32:
        t_loss, t_dense, t_acc = 2e-3, 2e-3, 1e-3
    else:
        t_loss, t_dense = 2e-2, 1e-2
        t_acc = 1e-3 if acc_dtype == torch.float32 else 0.125
    loss_err = float(((lk - lp).abs() / lp.abs()).max())
    dense_err = max(float((a.detach() - b.detach()).abs().max())
                    for a, b in zip(stk.dense_params.parameters(),
                                    stp.dense_params.parameters()))
    slab_err, acc_err, t_slabs = 0.0, 0.0, {}
    for key in stk.emb_params:
        a, b = stk.emb_params[key].float(), stp.emb_params[key].float()
        t_slabs[key] = (None if noisy else 1e-4 if dtype == torch.float32
                        else 8 * float(ulp(torch, b.abs().max(),
                                           torch.bfloat16)))
        e = float((a - b).abs().max())
        check(bool(torch.isfinite(a).all()), f"zoo small check: {key} "
              "not finite")
        check(noisy or e <= t_slabs[key], f"zoo small check {dtype}/"
              f"{acc_dtype} ratio {ratio} {key}: slabs differ by {e} (> "
              f"{t_slabs[key]})")
        check(bool((a != init[key]).any()), f"zoo small check: {key} "
              "did not train")
        slab_err = max(slab_err, e)
        a, b = stk.emb_opt_state[key].float(), stp.emb_opt_state[key].float()
        check(bool(torch.isfinite(a).all()), f"zoo small check: {key} "
              "accumulators not finite")
        acc_err = max(acc_err, float(((a - b).abs() / b).max()))
    log(f"  zoo small check {str(dtype)[6:]} tables, {str(acc_dtype)[6:]} "
        f"accumulators, {regimes}: {SMALL_STEPS} steps at b={SMALL_BATCH}, "
        f"losses {[round(float(x), 4) for x in lk]}; kernels vs plain"
        f"{' (logged; finiteness only, see the docstring)' if noisy else ''}"
        f": loss rel {loss_err} (tol {t_loss}), dense {dense_err} (tol "
        f"{t_dense}), slab {slab_err} (tol {t_slabs}), accumulators rel "
        f"{acc_err} (tol {t_acc})")
    check(all(bool(torch.isfinite(p).all())
              for p in stk.dense_params.parameters()),
          "zoo small check: dense params not finite")
    check(noisy or (loss_err <= t_loss and dense_err <= t_dense
                    and acc_err <= t_acc),
          f"zoo small check {dtype}/{acc_dtype} ratio {ratio}: beyond the "
          "bounds above")
    return slab_err


@contextlib.contextmanager
def recording(torch, opt, snapshot=True):
    """Yields ``{"w<width>": record}``: what each ``apply_rows`` call of a
    ``SparseAdagrad``, ``SparseAdam`` or ``SparseMomentum`` is given
    (and, with ``snapshot``, before it runs, the rows of the slab and of
    each row-state leaf it will touch, whole leaves in Adagrad's
    dense-apply regime, and Adam's count), and what its own K3 (``g``,
    the gradient slab) or K5 (``uids``, ``ugrads``) call gave the update
    kernel."""
    from torch.utils import _pytree as pytree

    from distributed_embeddings_torch.parallel import optimizers

    seen, cur = {}, {}
    real_apply = opt.apply_rows
    real_scatter = optimizers.sgd_scatter
    real_dedup = optimizers.dedup_sparse_grad

    def apply_rows(slab, state, ids, vals, lr):
        rows, w = slab.shape
        first = pytree.tree_leaves(state)[0]
        dense = (hasattr(opt, "dense_apply")
                 and opt.dense_apply(rows, ids.shape[0]))
        rec = dict(ids=ids.clone(), vals=vals.to(first.dtype).clone(),
                   lr=lr, dense=dense)
        if snapshot:
            uniq = (None if dense else
                    torch.unique(ids[(ids >= 0) & (ids < rows)].long()))
            rows_of = (lambda t: t.clone() if dense or t.shape[0] != rows
                       else t[uniq])
            rec["uniq"], rec["slab"] = uniq, rows_of(slab)
            rec["state"] = pytree.tree_map(rows_of, state)
        seen[f"w{w}"] = cur["rec"] = rec
        return real_apply(slab, state, ids, vals, lr)

    def sgd_scatter(g, *args, **kw):
        out = real_scatter(g, *args, **kw)
        cur["rec"]["g"] = g.clone()
        return out

    def dedup_sparse_grad(*args, **kw):
        uids, ugrads = real_dedup(*args, **kw)
        cur["rec"]["uids"], cur["rec"]["ugrads"] = uids.clone(), ugrads.clone()
        return uids, ugrads

    opt.apply_rows = apply_rows
    optimizers.sgd_scatter = sgd_scatter
    optimizers.dedup_sparse_grad = dedup_sparse_grad
    try:
        yield seen
    finally:
        opt.__dict__.pop("apply_rows", None)
        optimizers.sgd_scatter = real_scatter
        optimizers.dedup_sparse_grad = real_dedup


def k5_check(torch, r, rows, what):
    """K5's output in a ``recording()`` record held to the plain dedup on
    the same stream: unique ids equal, sums within 2 k 2^-24 of the sum
    of |rows| (``k`` the ids a row sums; both sum in fp32, in other
    orders, each within (k - 1) 2^-24 of it; bf16 sums 1 bf16 ulp more:
    each rounds once), and every unique id below ``rows`` a touched row.
    Returns ``(max_abs_err, keep, pos)``: the ids that are rows, and
    their places among the record's touched rows."""
    from distributed_embeddings_torch.ops import dedup_sparse_grad_plain

    ids, vals = r["ids"], r["vals"]
    kw = dict(pad_id=rows, max_unique=rows + 1)
    u, s = r["uids"], r["ugrads"]
    pu, ps = dedup_sparse_grad_plain(ids, vals, **kw)
    check(bool(torch.equal(u, pu)), f"{what}: K5 unique ids differ from "
          "the plain dedup's")
    _, mag = dedup_sparse_grad_plain(ids, vals.float().abs(), **kw)
    ones = torch.ones((ids.numel(), 1), device="cuda")
    _, cnt = dedup_sparse_grad_plain(ids, ones, **kw)
    tol = 2 * cnt * 2.0 ** -24 * mag
    if s.dtype == torch.bfloat16:
        tol = tol + ulp(torch, ps.float(), torch.bfloat16)
    e5 = (s.float() - ps.float()).abs()
    bad = int((e5 > tol + 1e-30).sum())
    check(bad == 0, f"{what}: {bad} K5 sums beyond 2 k 2^-24 of the sum of "
          f"|rows| (max err {float(e5.max())})")
    keep = u < rows
    pos = torch.searchsorted(r["uniq"], u[keep].long())
    check(bool(torch.equal(r["uniq"][pos], u[keep].long())),
          f"{what}: K5's ids differ from the touched rows")
    return float(e5.max()), keep, pos


def zoo_full_check(torch, de, opt, st, data, cfg, label):
    """One full-size step; each kernel of the sparse apply is held to its
    plain version on the very inputs the step gave it (the step's own K3
    gradient slab, the step's own K5 output), so no bound has to cover
    a difference the kernel before it made.

    Bounds (``k`` the ids a row sums, ``mag`` their fp32 sum of |rows|):
    - K5 (w16, sparse): unique ids equal the plain dedup's; both sum in
      fp32, in other orders, each within (k - 1) 2^-24 mag, so within
      2 k 2^-24 mag (bf16: and 1 bf16 ulp more, each rounds once);
    - K3 as the w8 scatter-sum (dense-apply): fp32 as K5; in bf16 both
      round after each add, in the card's atomic order, so within k bf16
      ulps of mag (the bound of ``tests/test_torch_cuda.py``);
    - K6 (touched rows) and K7 (whole slab): accumulators bit-exact (the
      same per-op rounding); the kernels' correctly rounded ``rsqrt``
      and PyTorch's ``rsqrtf`` differ by up to 2 ulps, so slab values
      within 3 ulps of their dtype of |old| + lr."""
    from distributed_embeddings_torch.ops import (
        adagrad_dense_plain, adagrad_rows_plain, sgd_scatter_plain)
    from distributed_embeddings_torch.parallel import (
        Adagrad, make_hybrid_train_step)

    step = make_hybrid_train_step(de, zoo_loss, Adagrad(ZOO_LR), opt,
                                  lr_schedule=ZOO_LR, nan_guard=True)
    num, cats, lab = data[0]
    with recording(torch, opt) as seen:
        zero_counts()
        loss, st = step(st, cats, (num, lab))
        torch.cuda.synchronize()
        counts = read_counts()
    want, regimes = zoo_expected(de, opt, cfg, ZOO_BATCH)
    check(counts == want, f"zoo full-size step {label}: launches {counts}, "
          f"expected {want}")
    check(bool(torch.isfinite(loss)), f"zoo full-size step {label}: loss "
          f"{float(loss)}")
    errs = {}
    for key, r in seen.items():
        slab = st.emb_params[key][0]
        acc = st.emb_opt_state[key][0]
        rows = slab.shape[0]
        ids, vals = r["ids"], r["vals"]
        what = f"zoo full-size step {label} {key}"
        if r["dense"]:
            g = r["g"]
            ones = torch.ones((ids.numel(), 1), device="cuda")
            pg = sgd_scatter_plain(torch.zeros_like(g), ids, vals, -1.0)
            mag = sgd_scatter_plain(torch.zeros(g.shape, device="cuda"), ids,
                                    vals.float().abs(), -1.0)
            cnt = sgd_scatter_plain(torch.zeros((rows, 1), device="cuda"),
                                    ids, ones, -1.0)
            tol = (2 * cnt * 2.0 ** -24 * mag if g.dtype == torch.float32
                   else cnt * ulp(torch, mag, torch.bfloat16))
            first, upd = "sgd_scatter", "adagrad_dense"
            bound = ("2 k 2^-24" if g.dtype == torch.float32
                     else "k bf16 ulps") + " of the sum of |rows|"
            e1 = (g.float() - pg.float()).abs()
            bad = int((e1 > tol + 1e-30).sum())
            check(bad == 0, f"{what}: {bad} sgd_scatter values beyond their "
                  f"bound (max err {float(e1.max())})")
            e_first = float(e1.max())
            ws, wa = r["slab"].clone(), r["state"].clone()
            adagrad_dense_plain(ws, wa, g, r["lr"], opt.eps)
            gs, ga = slab, acc
            touched = int(torch.count_nonzero(cnt))
        else:
            e_first, keep, pos = k5_check(torch, r, rows, what)
            first, upd = "dedup_sparse_grad", "adagrad_rows"
            bound = "2 k 2^-24 of the sum of |rows|" + (
                "" if r["ugrads"].dtype == torch.float32 else " + 1 bf16 ulp")
            ws, wa = r["slab"].clone(), r["state"].clone()
            adagrad_rows_plain(ws, wa, pos, r["ugrads"][keep], r["lr"],
                               opt.eps)
            gs, ga = slab[r["uniq"]], acc[r["uniq"]]
            touched = len(r["uniq"])
        check(bool(torch.equal(ga, wa)), f"{what}: {upd} accumulators "
              f"differ from the plain update's ({int((ga != wa).sum())} "
              "values)")
        es = (gs.float() - ws.float()).abs()
        ts = 3 * ulp(torch, r["slab"].float().abs() + ZOO_LR, slab.dtype)
        bad = int((es > ts).sum())
        check(bad == 0, f"{what}: {bad} {upd} slab values beyond 3 ulps "
              f"(max err {float(es.max())})")
        changed = int(torch.count_nonzero((gs != r["slab"]).any(1)))
        errs[first], errs[upd] = e_first, float(es.max())
        log(f"zoo: full-size step {label} {key} ({regimes[key]}): "
            f"{ids.numel()} ids, {touched} touched rows, {changed} changed; "
            f"vs plain on the step's own inputs: {first} max_abs_err "
            f"{errs[first]} (<= {bound}), "
            f"{upd} accumulators bit-exact, slab max_abs_err {errs[upd]} "
            f"(<= 3 ulps)")
    log(f"zoo: full-size step {label} at b={ZOO_BATCH}: loss "
        f"{float(loss):.5f}, launches {counts} (regimes {regimes})")
    return st, errs, regimes


def zoo_touched(torch, de, cats):
    """``{"w<width>": unique slab rows}`` a batch's ids hit."""
    strat = de.strategy
    rows = {}
    for i, ids in enumerate(cats):
        t = strat.input_table_map[i]
        m = strat.table_ids_list[0].index(t)
        w = int(strat.global_configs[t]["output_dim"])
        rows.setdefault(f"w{w}", []).append(
            ids.reshape(-1).long() + de.row_offsets_list[0][m])
    return {k: torch.unique(torch.cat(v)) for k, v in rows.items()}


def zoo_nan_check(torch, de, opt, st, data, tx=None, label="zoo"):
    """A NaN batch: the touched rows of the slabs and of their optimizer
    state (Adagrad's accumulators, Adam's ``mu``/``nu`` and counts,
    momentum's trace), the dense params and the dense optimizer state
    (``tx``, by default ``Adagrad``; its count too) stay bitwise
    unchanged; the step advances."""
    from torch.utils import _pytree as pytree

    from distributed_embeddings_torch.parallel import (
        Adagrad, make_hybrid_train_step)

    tx = tx or Adagrad(ZOO_LR)
    step = make_hybrid_train_step(de, zoo_loss, tx, opt, lr_schedule=ZOO_LR,
                                  nan_guard=True)
    num, cats, lab = data[1]
    num = num.clone()
    num[ZOO_BATCH // 2, 3] = float("nan")
    touched = zoo_touched(torch, de, cats)

    def rows_of(k, r):
        local = de.local_view(st.emb_opt_state)[k]
        return (st.emb_params[k][0][r].clone(), pytree.tree_map(
            lambda t: t[r].clone() if t.dim() == 2 and t.shape[0] > 1
            else t.clone(), local))

    before = {k: rows_of(k, r) for k, r in touched.items()}
    dense_before = [p.detach().clone() for p in st.dense_params.parameters()]
    dstate_before = clone_tree(st.dense_opt_state)
    step_before = int(st.step)
    loss, st = step(st, cats, (num, lab))
    torch.cuda.synchronize()
    check(not bool(torch.isfinite(loss)), f"{label} NaN batch: loss is "
          "finite")
    for k, r in touched.items():
        check(tree_equal(torch, rows_of(k, r), before[k]),
              f"{label} NaN batch: {k} rows or their state changed")
    check(all(torch.equal(p, q) for p, q in zip(
        st.dense_params.parameters(), dense_before)),
        f"{label} NaN batch: dense params changed")
    check(tree_equal(torch, st.dense_opt_state, dstate_before),
          f"{label} NaN batch: dense optimizer state changed")
    check(int(st.step) == step_before + 1, f"{label} NaN batch: step did "
          "not advance")
    log(f"{label}: NaN batch skipped, "
        f"{ {k: len(r) for k, r in touched.items()} } touched rows and "
        f"their optimizer state, the dense params and the dense optimizer "
        f"state bitwise unchanged, step {step_before} -> {int(st.step)}")
    return st


def zoo_timed(torch, de, opt, st, data, cfg, label, tx=None, want=None,
              steps=TRAIN_STEPS):
    """3 warmup + ``steps`` timed steps (no guard, as ``run_tiny_zoo``
    builds the step) with the launch counters zeroed just before and
    read just after (``want``: launches a step, by default those of
    ``SparseAdagrad``'s regimes; ``tx``: the dense optimizer, by default
    ``Adagrad``)."""
    from distributed_embeddings_torch.parallel import (
        Adagrad, make_hybrid_train_step)

    tx = Adagrad(ZOO_LR) if tx is None else tx
    step = make_hybrid_train_step(de, zoo_loss, tx, opt,
                                  lr_schedule=ZOO_LR, nan_guard=False)
    for k in range(WARMUP_RUNS):
        num, cats, lab = data[k]
        _, st = step(st, cats, (num, lab))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    losses, times = [], []
    for k in range(steps):
        num, cats, lab = data[k]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, st = step(st, cats, (num, lab))
        end.record()
        losses.append(loss)
        times.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    losses = torch.stack(losses).float().cpu().numpy()
    check(np.isfinite(losses).all(), f"zoo {label}: non-finite loss")
    regimes = None
    if want is None:
        want, regimes = zoo_expected(de, opt, cfg, ZOO_BATCH)
    for name, n in launches.items():
        check(n == want[name] * steps, f"zoo {label}: {name} launched "
              f"{n} times in {steps} steps (expected {want[name]} a step)")
    step_ms = [s.elapsed_time(e) for s, e in times]
    result = {
        "tables": label, "batch": ZOO_BATCH, "steps": steps,
        "samples_per_s": steps * ZOO_BATCH / wall,
        "wall_step_ms": wall / steps * 1e3,
        "step_ms_p50": float(np.median(step_ms)),
        "step_ms_min": float(np.min(step_ms)), "regimes": regimes,
        "launches_per_step": {n: v / steps for n, v in launches.items()},
        "loss_first": float(losses[0]), "loss_last": float(losses[-1])}
    log(f"zoo timed {label}: " + json.dumps(result))
    return st, launches, result


def zoo_profile(torch, de, opt, st, data, steps=5, tx=None, label="fp32"):
    """``torch.profiler`` over a few steps of the timed program: the
    device's busy time (the sum of the self time of the events that ran
    on the card, its kernels and copies on one stream; the host ops that
    launched them also carry that time and are left out) against the
    window's host-clock time, and the kernels that take most of it. The
    profiler's own cost lengthens the window, so the busy share it gives
    is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distributed_embeddings_torch.parallel import (
        Adagrad, make_hybrid_train_step)

    tx = Adagrad(ZOO_LR) if tx is None else tx
    step = make_hybrid_train_step(de, zoo_loss, tx, opt,
                                  lr_schedule=ZOO_LR, nan_guard=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(steps):
            num, cats, lab = data[k % len(data)]
            _, st = step(st, cats, (num, lab))
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    dev = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            dev[e.key] = e.self_device_time_total / 1e3
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
    # K5's launch chain (csrc/dedup.cu), its kernels summed over their
    # template instances
    k5 = {}
    for key, ms in dev.items():
        m = K5_CHAIN.search(key)
        if m:
            k5[m.group(1)] = k5.get(m.group(1), 0.0) + ms / steps
    out = {"steps": steps, "window_ms_per_step": window / steps,
           "device_busy_ms_per_step": busy / steps,
           "device_busy_share": busy / window,
           "top_device_ms_per_step": [(k[:60], v / steps) for k, v in top],
           "k5_chain_ms_per_step": dict(sorted(k5.items(),
                                               key=lambda kv: -kv[1]))}
    log(f"zoo profile {label}: " + json.dumps(out))
    check(busy > 0, "zoo profile: the trace holds no device time")
    check(set(k5) == set(K5_KERNELS), f"zoo profile: K5's launch chain "
          f"is incomplete in the trace: {k5}")
    return st, out


def zoo_stages(torch, de, opt, st, data, tx=None):
    """The step's stages called one by one with events between them
    (``tx``: the dense optimizer, by default ``Adagrad``; its state is
    ``st``'s, carried on from step to step)."""
    from distributed_embeddings_torch.parallel import Adagrad
    from distributed_embeddings_torch.parallel import apply as apply_mod

    tx = Adagrad(ZOO_LR) if tx is None else tx
    params = list(st.dense_params.parameters())
    dstate = st.dense_opt_state
    names = ["embedding_forward", "dense_forward_backward",
             "cotangent_streams"]
    stage_ms = {}
    for k in range(WARMUP_RUNS + 10):
        num, cats, lab = data[k % len(data)]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        with torch.no_grad():
            outs, res = de.forward_with_residuals(st.emb_params, cats)
        ev[1].record()
        outs = [o.detach().requires_grad_() for o in outs]
        loss = zoo_loss(st.dense_params, outs, (num, lab))
        grads = torch.autograd.grad(loss, params + outs)
        ev[2].record()
        per_width = apply_mod.cotangent_width_streams(
            de, res, list(grads[len(params):]))
        ev[3].record()
        local = de.local_view(st.emb_params)
        lstate = de.local_view(st.emb_opt_state)
        keys = sorted(per_width)
        for i, key in enumerate(keys):
            apply_mod.apply_width_streams(de, local, lstate,
                                          {key: per_width[key]}, opt,
                                          ZOO_LR, 1.0)
            ev[4 + i].record()
        updates, dstate = tx.update(list(grads[:len(params)]), dstate)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        ev[4 + len(keys)].record()
        torch.cuda.synchronize()
        labels = names + [f"sparse_apply_{key}" for key in keys] + [
            "dense_update"]
        if k >= WARMUP_RUNS:
            for i, name in enumerate(labels):
                stage_ms.setdefault(name, []).append(
                    ev[i].elapsed_time(ev[i + 1]))
    return {n: float(np.median(v)) for n, v in stage_ms.items()}


def zoo_kernel_times(torch, de, opt, st, data, cfg):
    """CUDA-event medians of K5, K6, K7, and of K1 (hot 10, w16) and K3
    (the w8 scatter-sum), at the shapes one full-size step gives them,
    each against its plain version, one library call where there is one,
    and its byte bound."""
    import torch.nn.functional as F
    from distributed_embeddings_torch.ops import (
        adagrad_dense, adagrad_dense_plain, adagrad_rows, adagrad_rows_plain,
        dedup_sparse_grad, dedup_sparse_grad_plain, gather_combine,
        gather_combine_plain, sgd_scatter, sgd_scatter_plain)
    from distributed_embeddings_torch.parallel import (
        Adagrad, lookup, make_hybrid_train_step)

    k1_calls = []
    real_k1 = lookup.gather_combine

    def recording_k1(slab, ids, rows, roff, div=None, mask=None):
        k1_calls.append((slab, ids, rows, roff, div, mask))
        return real_k1(slab, ids, rows, roff, div, mask)

    step = make_hybrid_train_step(de, zoo_loss, Adagrad(ZOO_LR), opt,
                                  lr_schedule=ZOO_LR, nan_guard=False)
    num, cats, lab = data[2]
    lookup.gather_combine = recording_k1
    try:
        with recording(torch, opt, snapshot=False) as seen:
            _, st = step(st, cats, (num, lab))
    finally:
        lookup.gather_combine = real_k1
    torch.cuda.synchronize()
    out = {}

    # K1, the w16 hot-10 group
    slab, ids, rows, roff, div, mask = next(
        c for c in k1_calls if c[0].shape[1] == 16 and c[1].shape[2] == 10)
    hot, w = ids.shape[2], slab.shape[1]
    grows = (torch.minimum(ids.long().clamp(min=0), rows.view(-1, 1, 1) - 1)
             + roff.view(-1, 1, 1))
    got = gather_combine(slab, ids, rows, roff, div, mask)
    want = gather_combine_plain(slab, ids, rows, roff, div, mask)
    err = float((got - want).abs().max())
    scale = gather_combine_plain(slab.abs(), ids, rows, roff, div, mask)
    check(bool(((got - want).abs() <= 1e-6 * scale + 1e-30).all()),
          f"K1 w16 hot 10: beyond 1e-6 of the sum of |rows| (max {err})")
    uniq = int(torch.unique(grows).numel())
    nbytes = uniq * w * 4 + ids.numel() * 4 + ids.shape[0] * ids.shape[1] * w * 4
    out["gather_combine"] = {
        "case": "zoo_w16_hot10_sum",
        "ms": time_ms(torch, lambda: gather_combine(slab, ids, rows, roff,
                                                    div, mask), [()]),
        "plain_ms": time_ms(torch, lambda: gather_combine_plain(
            slab, ids, rows, roff, div, mask), [()]),
        "library_ms": time_ms(torch, lambda: F.embedding_bag(
            grows.view(-1, hot), slab, mode="sum"), [()]),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "unique_rows": uniq, "bytes": nbytes, "max_abs_err": err,
        "shape": list(ids.shape)}
    del k1_calls

    # K3, the w8 scatter-sum into a zero gradient slab
    r8, r16 = seen["w8"], seen["w16"]
    R8, w8 = st.emb_params["w8"].shape[1:]
    ids8, vals8 = r8["ids"], r8["vals"]
    ids8l = ids8.long()
    touched8 = int(torch.unique(ids8l[ids8l < R8]).numel())
    gz = torch.zeros((R8, w8), device="cuda")
    nbytes = ids8.numel() * (4 + w8 * 4) + 2 * touched8 * w8 * 4
    out["sgd_scatter"] = {
        "case": "zoo_w8_scatter_sum",
        "ms": time_ms(torch, lambda: sgd_scatter(gz.zero_(), ids8, vals8,
                                                 -1.0), [()]),
        "plain_ms": time_ms(torch, lambda: sgd_scatter_plain(
            gz.zero_(), ids8, vals8, -1.0), [()]),
        "library_ms": time_ms(torch, lambda: gz.zero_().index_add_(
            0, ids8l, vals8), [()]),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "ids": ids8.numel(), "unique_rows": touched8, "bytes": nbytes}

    # K7 over the w8 slab (dense-apply)
    s8, a8 = st.emb_params["w8"][0], st.emb_opt_state["w8"][0]
    sgd_scatter(gz.zero_(), ids8, vals8, -1.0)
    nbytes = 5 * s8.numel() * 4
    ops = 9 * s8.numel()
    out["adagrad_dense"] = {
        "case": "zoo_w8_dense_apply",
        "ms": time_ms(torch, lambda: adagrad_dense(s8, a8, gz, ZOO_LR,
                                                   opt.eps), [()]),
        "plain_ms": time_ms(torch, lambda: adagrad_dense_plain(
            s8, a8, gz, ZOO_LR, opt.eps), [()]),
        "library_ms": None,
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
        else "operations", "elements": s8.numel(), "bytes": nbytes}

    # K5 on the w16 stream
    R16, w16 = st.emb_params["w16"].shape[1:]
    ids16, vals16 = r16["ids"], r16["vals"]
    n = ids16.numel()
    u_cap = min(n, R16 + 1)
    uids, ugrads = dedup_sparse_grad(ids16, vals16, pad_id=R16,
                                     max_unique=R16 + 1)
    distinct = int((uids < R16).sum())
    nbytes = n * (4 + w16 * 4) + u_cap * (4 + w16 * 4)

    def library_dedup():
        u, inv = torch.unique(ids16, sorted=True, return_inverse=True)
        return u, torch.zeros((u.numel(), w16), device="cuda").index_add_(
            0, inv, vals16)

    out["dedup_sparse_grad"] = {
        "case": "zoo_w16_stream",
        "ms": time_ms(torch, lambda: dedup_sparse_grad(
            ids16, vals16, pad_id=R16, max_unique=R16 + 1), [()]),
        "plain_ms": time_ms(torch, lambda: dedup_sparse_grad_plain(
            ids16, vals16, pad_id=R16, max_unique=R16 + 1), [()]),
        "library_ms": time_ms(torch, library_dedup, [()]),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "ids": n, "unique_ids": distinct, "bytes": nbytes}

    # K6 on K5's output, into the w16 slab: it reads every id, and the
    # gradient, accumulator and slab row of each id below R16 only (the
    # pad tail's gradient rows are never read)
    s16, a16 = st.emb_params["w16"][0], st.emb_opt_state["w16"][0]
    touched16 = int((uids < R16).sum())
    nbytes = u_cap * 4 + touched16 * w16 * 4 + touched16 * w16 * 4 * 4
    ops = 9 * touched16 * w16
    out["adagrad_rows"] = {
        "case": "zoo_w16_sparse",
        "ms": time_ms(torch, lambda: adagrad_rows(s16, a16, uids, ugrads,
                                                  ZOO_LR, opt.eps), [()]),
        "plain_ms": time_ms(torch, lambda: adagrad_rows_plain(
            s16, a16, uids, ugrads, ZOO_LR, opt.eps), [()]),
        "library_ms": None,
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
        else "operations", "unique_rows": touched16, "bytes": nbytes}
    for name, c in out.items():
        lib = "—" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        log(f"time {name} {c['case']}: kernel {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f}, library {lib}, bound "
            f"{c['bound_ms']:.4f}")

    # both regimes on the w16 slab
    from distributed_embeddings_torch.parallel import SparseAdagrad

    regime_ms = {}
    for label, ratio in (("dense_apply", 1e9), ("sparse", None)):
        o = SparseAdagrad(dense_apply_ratio=ratio)
        regime_ms[label] = time_ms(
            torch, lambda: o.apply_rows(s16, a16, ids16, vals16, ZOO_LR),
            [()])
    dense_bytes = s16.numel() * 4 * 6 + n * (4 + w16 * 4)
    regime = {"w16_rows": R16, "ids": n, "unique_ids": distinct,
              "dense_apply_ms": regime_ms["dense_apply"],
              "sparse_ms": regime_ms["sparse"],
              "dense_apply_bound_ms": dense_bytes / HBM_BYTES_PER_S * 1e3}
    log("zoo regimes on w16: " + json.dumps(regime))
    return st, out, regime


def phase_zoo(torch):
    """The synthetic zoo's tiny model trained with SparseAdagrad."""
    from distributed_embeddings_torch.models import InputGenerator

    log("zoo: small-table check, kernels against plain versions")
    errs = {"adagrad_rows": 0.0, "adagrad_dense": 0.0}
    for dtype, acc_dtype in ((torch.float32, torch.float32),
                             (torch.bfloat16, torch.float32),
                             (torch.bfloat16, torch.bfloat16)):
        for ratio in (6.0, None):
            e = zoo_small_check(torch, dtype, acc_dtype, ratio)
            if dtype == torch.float32:
                name = "adagrad_dense" if ratio else "adagrad_rows"
                errs[name] = max(errs[name], e)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, de, opt, st = zoo_model(torch, torch.float32, seed=SEED + 50)
    torch.cuda.synchronize()
    log(f"zoo: tiny model, slabs "
        f"{ {k: tuple(v.shape) for k, v in st.emb_params.items()} } fp32 "
        f"+ accumulators = "
        f"{2 * sum(v.numel() for v in st.emb_params.values()) * 4 / 1e9:.2f}"
        f" GB, built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    data = InputGenerator(cfg, ZOO_BATCH, alpha=1.05, num_batches=ZOO_BATCHES,
                          seed=0, device="cuda")
    log(f"zoo: {ZOO_BATCHES} batches of {ZOO_BATCH} made in "
        f"{time.perf_counter() - t0:.1f} s")
    st, full_errs, regimes = zoo_full_check(torch, de, opt, st, data, cfg,
                                            "fp32")
    for k, v in full_errs.items():
        errs[k] = max(errs.get(k, 0.0), v)
    st = zoo_nan_check(torch, de, opt, st, data)
    st, launches, fp32 = zoo_timed(torch, de, opt, st, data, cfg, "fp32")
    fp32["stage_ms_p50"] = zoo_stages(torch, de, opt, st, data)
    log("zoo stages fp32 (ms): " + json.dumps(fp32["stage_ms_p50"]))
    st, fp32["profile"] = zoo_profile(torch, de, opt, st, data)
    st, kcases, regime = zoo_kernel_times(torch, de, opt, st, data, cfg)
    log(f"zoo peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del st
    torch.cuda.empty_cache()
    cfg, de, opt, st = zoo_model(torch, torch.bfloat16, seed=SEED + 60)
    st, bf16_errs, _ = zoo_full_check(torch, de, opt, st, data, cfg, "bf16")
    st, _, bf16 = zoo_timed(torch, de, opt, st, data, cfg, "bf16")
    bf16["full_step_max_abs_err"] = bf16_errs
    del st
    torch.cuda.empty_cache()
    return launches, errs, kcases, {"fp32": fp32, "bf16": bf16,
                                    "regimes_w16": regime}


# ------------------------------------------------------------------ ragged

# Criteo-Kaggle vocabularies (bench.py:63-67), frequency-capped at 2M rows
# as bench.py's "capped" DLRM variants cap them
CRITEO_KAGGLE_SIZES = [
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
]
KAGGLE_CAP = 2_000_000
RAGGED_HOT = 15                # bench.py multihot_ragged: U{1..2*15} ids a row
RAGGED_BATCHES = 4             # distinct batches the timed steps cycle over
SPARSE_FEATURES = (0, 5, 13)   # given as SparseIds in the forward check


def ragged_sizes(row_cap=KAGGLE_CAP):
    return [min(s, row_cap) for s in CRITEO_KAGGLE_SIZES]


def ragged_per_step(groups):
    """Launches per ragged DLRM step: K8 and K9 once per ragged plan
    group, K10 twice (forward and backward), K3 once (one slab), K2 and
    K4 once; nothing else."""
    want = {name: 0 for name in kernel_fns()}
    want.update(ragged_combine=groups, ragged_grad=groups,
                lengths_to_splits=2 * groups, sgd_scatter=1,
                dot_interact_fwd=1, dot_interact_bwd=1, pack_ids=1,
                pack_columns=1)
    return want


def device_power_law(torch, gen, vocab, n):
    """``utils.data.power_law_ids`` (alpha 1.05) drawn on the card: the
    same inverse CDF over float64 uniforms of the card's generator."""
    u = torch.rand(n, dtype=torch.float64, generator=gen, device="cuda")
    exp = 1.0 - 1.05
    ids = ((vocab + 1) ** exp * u + (1 - u)) ** (1.0 / exp) - 1.0
    return ids.long().clamp(0, vocab - 1).to(torch.int32)


def ragged_batches(torch, sizes, b, n_batches, seed, bad_ids=False,
                   weighted=(), nan=False):
    """``n_batches`` batches of ``bench.py:run_dlrm``'s ragged traffic,
    made on the card: per feature and row ``U{1..30}`` Zipfian ids, one
    capacity for every feature and batch (the largest feature's total),
    values zero-padded past each feature's total (``bad_ids``: ~1%
    negative or past the table; ``weighted`` features carry weights in
    [0.25, 1.75)); N(0, 1) numerical features (``nan``: one NaN) and 0/1
    labels. Returns ``(batches, cap)``."""
    from distributed_embeddings_torch import Ragged

    gen = torch.Generator(device="cuda").manual_seed(seed)
    splits = []
    for _ in range(n_batches):
        row = []
        for _ in sizes:
            hots = torch.randint(1, 2 * RAGGED_HOT + 1, (b,), generator=gen,
                                 device="cuda", dtype=torch.int32)
            sp = torch.zeros(b + 1, dtype=torch.int32, device="cuda")
            torch.cumsum(hots, 0, out=sp[1:])
            row.append(sp)
        splits.append(row)
    cap = int(torch.stack([sp[-1] for row in splits for sp in row]).max())
    batches = []
    for k in range(n_batches):
        cats = []
        for t, v in enumerate(sizes):
            sp = splits[k][t]
            nnz = int(sp[-1])
            ids = device_power_law(torch, gen, v, nnz)
            if bad_ids:
                u = torch.rand((2, nnz), generator=gen, device="cuda")
                bad = torch.where(
                    u[1] < 0.5, -1 - (u[1] * 1000).int(),
                    v + ((u[1] - 0.5) * 2000).int())
                ids = torch.where(u[0] < 0.01, bad, ids)
            vals = torch.zeros(cap, dtype=torch.int32, device="cuda")
            vals[:nnz] = ids
            w = None
            if t in weighted:
                w = torch.zeros(cap, dtype=torch.float32, device="cuda")
                w[:nnz] = 0.25 + 1.5 * torch.rand(nnz, generator=gen,
                                                  device="cuda")
            cats.append(Ragged(values=vals, row_splits=sp, weights=w))
        num = torch.randn((b, 13), generator=gen, device="cuda")
        if nan:
            num[b // 2, 3] = float("nan")
        lab = (torch.rand(b, generator=gen, device="cuda") < 0.25).float()
        batches.append((cats, (num, lab)))
    return batches, cap


def as_sparse_ids(torch, r, b):
    """A ``Ragged`` batch as the same ids in COO form: row ``r`` for its
    ids, padding rows ``b`` past the total."""
    from distributed_embeddings_torch import SparseIds

    lengths = (r.row_splits[1:] - r.row_splits[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(b, device="cuda"), lengths)
    pad = r.values.shape[0] - rows.shape[0]
    rows = torch.cat([rows, torch.full((pad,), b, device="cuda")])
    rows = rows.to(torch.int32)
    return SparseIds(indices=torch.stack([rows, torch.zeros_like(rows)], 1),
                     values=r.values, dense_shape=(b, 2 * RAGGED_HOT),
                     weights=r.weights)


def ragged_rows(torch, de, cats, sizes):
    """The slab rows a ragged batch's live in-range ids hit, one entry
    per id."""
    out = []
    for t, c in enumerate(cats):
        nnz = min(int(c.row_splits[-1]), c.values.shape[0])
        v = c.values[:nnz].long()
        ok = (v >= 0) & (v < sizes[t])
        out.append(v[ok] + de.row_offsets_list[0][t])
    return torch.cat(out)


def ragged_model(torch, sizes, table_dtype, seed, mean_table=None):
    """The bench's DLRM over ``sizes`` with ``combiner="sum"`` tables
    (``mean_table``: that one ``"mean"``), bf16 compute, tables in
    ``table_dtype``, and its ``SparseSGD`` + SGD train state."""
    from distributed_embeddings_torch.models import DLRMConfig, DLRMDense
    from distributed_embeddings_torch.parallel import (
        SGD, DistributedEmbedding, SparseSGD, init_hybrid_state)

    cfg = DLRMConfig(table_sizes=sizes, embedding_dim=128,
                     num_numerical_features=13,
                     bottom_mlp_dims=(512, 256, 128),
                     top_mlp_dims=(1024, 1024, 512, 256, 1),
                     compute_dtype=torch.bfloat16)
    configs = cfg.embedding_configs(combiner="sum")
    if mean_table is not None:
        configs[mean_table]["combiner"] = "mean"
    de = DistributedEmbedding(configs, world_size=1,
                              compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dense = DLRMDense(cfg, device="cuda", generator=gen)
    st = init_hybrid_state(de, SparseSGD(), dense, SGD(TRAIN_LR),
                           generator=gen, dtype=table_dtype, device="cuda")
    return de, st


def exact(torch, got, want, what):
    """Bitwise equality of kernel and plain outputs; returns the max abs
    error (0)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {got.dtype} {tuple(got.shape)} != {want.dtype} "
          f"{tuple(want.shape)}")
    if got.is_floating_point():
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    ok = bool(torch.equal(got, want))
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    check(ok, f"{what}: differs from the plain version (max err {err})")
    return err


def ragged_kernel_checks(torch):
    """K8, K9 and K10 against their plain versions on the card, bit-exact
    (each kernel repeats its plain version's arithmetic, in the same
    order): sum and mean slots, no / float32 / in-block int64 weights,
    clipped and masked bad ids, empty rows, rows past the capacity, a
    row of 1,200 ids, padding holding id 0."""
    from distributed_embeddings_torch.ops import (
        lengths_to_splits, lengths_to_splits_plain, ragged_combine,
        ragged_combine_plain, ragged_grad, ragged_grad_plain, ragged_row_ids,
        ragged_row_ids_plain, row_to_split, row_to_split_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    n, b, vocab, w = 4, 4096, 5000, 128
    lengths = torch.randint(0, 2 * RAGGED_HOT + 1, (n, b), generator=gen,
                            device="cuda")
    lengths[:, 7] = 0
    lengths[1, 100] = 1200
    tot = lengths.sum(1)
    cases = 0
    errs = {"csr": 0.0, "ragged_combine": 0.0, "ragged_grad": 0.0}
    for frac in (1.0, 0.7):
        cap = int(int(tot.max()) * frac)
        for ids_dt in (torch.int32, torch.int64):
            vals = torch.randint(-3, vocab + 3, (n, cap), generator=gen,
                                 device="cuda")
            for k in range(n):
                vals[k, min(int(tot[k]), cap):] = 0
            wts = 0.25 + 1.5 * torch.rand((n, cap), generator=gen,
                                          device="cuda")
            block = torch.cat([vals, lengths, wts.view(torch.int32).long()],
                              1).to(ids_dt)
            values, lview = block[:, :cap], block[:, cap:cap + b]
            valid = torch.tensor([1, 1, 0, 1], dtype=torch.int32,
                                 device="cuda")
            for vd in (None, valid):
                errs["csr"] = max(errs["csr"], exact(
                    torch, lengths_to_splits(lview, vd),
                    lengths_to_splits_plain(lview, vd), "lengths_to_splits"))
            splits = lengths_to_splits(lview)
            for c in (cap, cap // 3):
                errs["csr"] = max(errs["csr"], exact(
                    torch, ragged_row_ids(splits, c),
                    ragged_row_ids_plain(splits, c), "ragged_row_ids"))
            rows = torch.repeat_interleave(
                torch.arange(b, device="cuda"), lengths[0]).to(ids_dt)
            rows = torch.cat([rows, torch.full((5,), b + 2, device="cuda",
                                               dtype=ids_dt)])
            for idx in (rows, torch.stack([rows, torch.zeros_like(rows)],
                                          1)):
                errs["csr"] = max(errs["csr"], exact(
                    torch, row_to_split(idx, b), row_to_split_plain(idx, b),
                    "row_to_split"))
            meta = dict(rows=torch.full((n,), vocab, dtype=torch.int64,
                                        device="cuda"),
                        roff=torch.arange(n, device="cuda") * vocab)
            for dtype in (torch.float32, torch.bfloat16):
                slab = torch.randn((n * vocab, w), generator=gen,
                                   device="cuda").to(dtype)
                g = torch.randn((b, n * w + 8), generator=gen,
                                device="cuda").to(dtype)
                g = g[:, :n * w].reshape(b, n, w).transpose(0, 1)
                for wk, wt in (("none", None), ("f32", wts),
                               ("bits", block[:, cap + b:])):
                    for mean, mask in (((0, 1, 0, 1), None),
                                       ((1, 0, 1, 1), (1, 1, 0, 1))):
                        mt = torch.tensor(mean, dtype=torch.int32,
                                          device="cuda")
                        kw = dict(meta, mean=mt, weights=wt,
                                  mask=None if mask is None else torch.tensor(
                                      mask, dtype=torch.int32,
                                      device="cuda"))
                        errs["ragged_combine"] = max(
                            errs["ragged_combine"], exact(
                                torch, ragged_combine(
                                    slab, values, splits, **kw,
                                    out_dtype=torch.bfloat16),
                                ragged_combine_plain(
                                    slab, values, splits, **kw,
                                    out_dtype=torch.bfloat16),
                                f"ragged_combine {dtype} {wk} mean={mean}"))
                        if wk == "f32":
                            continue
                        gkw = dict(meta, values=values, sentinel=n * vocab,
                                   mean=mt, weights=wt)
                        gi, gv = ragged_grad(g, splits, **gkw)
                        pi, pv = ragged_grad_plain(g, splits, **gkw)
                        exact(torch, gi, pi, "ragged_grad ids")
                        errs["ragged_grad"] = max(
                            errs["ragged_grad"], exact(
                                torch, gv, pv,
                                f"ragged_grad {dtype} {wk} mean={mean}"))
                        cases += 1
    torch.cuda.synchronize()
    log(f"ragged: K8/K9/K10 vs plain on the card, bit-exact, {cases} K9 "
        f"cases and twice as many K8 ones (b={b}, rows of 0-30 ids and one "
        "of 1,200, capacity 100% and 70% of the largest total, int32 and "
        "int64 blocks, bad ids clipped and masked)")
    return errs


RAGGED_SITES = ("ragged_combine", "lengths_to_splits", "ragged_grad",
                "row_to_split")  # the call sites of K8, K10 and K9


def stream_bounds(torch, streams, before):
    """Per slab row, the number of live ids ``hits`` that K9's recorded
    streams send to it, and per value ``mag``: ``|old|`` plus the sum of
    ``|lr x update|`` over those ids."""
    nrows, w = before.shape
    mag = before.float().abs()
    hits = torch.zeros(nrows, device="cuda")
    for _, _, (ids, vals) in streams:
        ids, vals = ids.reshape(-1), vals.reshape(-1, w)
        keep = ids < nrows
        gid = ids[keep].long()
        mag.index_add_(0, gid, vals[keep].float().abs() * TRAIN_LR)
        hits.index_add_(0, gid, torch.ones_like(gid, dtype=torch.float32))
    return hits, mag


def slab_misses(torch, got, want, hits, mag):
    """Values of ``got`` beyond the atomic-order bound around ``want``:
    rows hit at most once bit-exact, a row k ids hit within k ulps of
    the slab dtype of ``mag``. Returns ``(count, max abs error)``."""
    e = (got.float() - want.float()).abs()
    tol = torch.where(hits[:, None] > 1,
                      hits[:, None] * ulp(torch, mag, got.dtype),
                      torch.zeros_like(mag))
    return int(torch.count_nonzero(e > tol)), float(e.max())


def ragged_small_check(torch, table_dtype):
    """5 steps of the ragged DLRM with tables capped at SMALL_ROWS rows,
    b=4096, bf16 compute, one mean table and one weighted feature (two
    ragged plan groups), in lockstep: each step runs once with the
    kernels and once, from a copy of the same state, with only K8, K9
    and K10 routed to their plain versions (``RAGGED_SITES``); the
    kernels' run goes on to the next step.

    Bounds: K8-K10 repeat their plain versions' arithmetic and every
    other kernel is the same in both runs, so the loss and the dense
    params must be bitwise equal, and the slabs may differ only by the
    order of K3's atomic adds: rows hit once bit-exact, a row k ids hit
    within k ulps (of the table dtype) of |old| + the sum of
    |lr x update|. A control run whose stream loses every other
    position must fail that bound."""
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, apply, make_hybrid_train_step)

    sizes = ragged_sizes(SMALL_ROWS)
    de, st = ragged_model(torch, sizes, table_dtype, SEED + 80,
                          mean_table=1)
    init = st.emb_params["w128"][0].clone()
    step = make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), SparseSGD(),
                                  lr_schedule=TRAIN_LR, nan_guard=True)
    batches, cap = ragged_batches(torch, sizes, SMALL_BATCH, SMALL_STEPS,
                                  SEED + 81, bad_ids=True, weighted=(2,))
    losses, worst = [], 0.0
    control = None
    for i, (cats, batch) in enumerate(batches):
        ref = clone_state(st)
        ctrl = clone_state(st) if i == 0 else None
        before = st.emb_params["w128"][0].clone()
        zero_counts()
        with record_calls(apply, "ragged_grad") as streams:
            loss, st = step(st, cats, batch)
        torch.cuda.synchronize()
        kcounts = read_counts()
        zero_counts()
        with plain_kernels(RAGGED_SITES):
            ploss, ref = step(ref, cats, batch)
        torch.cuda.synchronize()
        pcounts = read_counts()
        groups = len(next(iter(de._plan_cache.values())).groups)
        want = ragged_per_step(groups)
        check(groups == 2 and kcounts == want, f"ragged small check step "
              f"{i}: launches {kcounts}, expected {want}")
        want = dict(want, **{k: 0 for k in RAGGED_SITES})
        check(pcounts == want, f"ragged small check step {i} (plain ragged "
              f"sites): launches {pcounts}, expected {want}")
        check(bool(torch.isfinite(loss)), f"ragged small check step {i}: "
              f"loss {float(loss)}")
        check(torch.equal(loss, ploss), f"ragged small check "
              f"{table_dtype} step {i}: loss {float(loss)} != "
              f"{float(ploss)} of the plain ragged kernels")
        check(all(torch.equal(a, b) for a, b in zip(
            st.dense_params.parameters(), ref.dense_params.parameters())),
            f"ragged small check {table_dtype} step {i}: dense params "
            "differ from those of the plain ragged kernels")
        hits, mag = stream_bounds(torch, streams, before)
        bad, err = slab_misses(torch, st.emb_params["w128"][0],
                               ref.emb_params["w128"][0], hits, mag)
        check(bad == 0, f"ragged small check {table_dtype} step {i}: "
              f"{bad} slab values beyond k ulps of |old| + sum |lr x "
              f"update| (max err {err})")
        worst = max(worst, err)
        losses.append(float(loss))
        if ctrl is not None:  # the planted fault: half the stream lost
            real = apply.ragged_grad

            def dropping(g, splits, **kw):
                ids, vals = real(g, splits, **kw)
                ids = ids.clone()
                ids.view(-1)[::2] = kw["sentinel"]
                return ids, vals

            apply.ragged_grad = dropping
            try:
                _, ctrl = step(ctrl, cats, batch)
            finally:
                apply.ragged_grad = real
            control = slab_misses(torch, ctrl.emb_params["w128"][0],
                                  ref.emb_params["w128"][0], hits, mag)
            check(control[0] > 0, "ragged small check: the control run "
                  "that drops half the stream passes the slab bound")
            del ctrl
        del ref, streams, before, hits, mag
    check(not torch.equal(st.emb_params["w128"][0], init),
          "ragged small check: no slab row changed")
    log(f"  ragged small check {str(table_dtype)[6:]} tables: "
        f"{SMALL_STEPS} lockstep steps at b={SMALL_BATCH}, cap {cap}, "
        f"losses {[round(x, 5) for x in losses]}; vs the plain K8/K9/K10: "
        f"losses and dense params bitwise equal, slab max err {worst} "
        f"(rows hit once bit-exact, k hits within k ulps); control with "
        f"half the stream dropped: {control[0]} values beyond the bound "
        f"(max err {control[1]})")


@contextlib.contextmanager
def record_calls(module, name, keep_out=True, on_call=None):
    """Wrap ``module.<name>`` (a kernel wrapper the package calls by that
    global) so each call's arguments, and its output if ``keep_out``,
    are kept; ``on_call(args, kw, out)`` runs right after each call,
    before the step goes on (and, say, updates the slab in place)."""
    real = getattr(module, name)
    calls = []

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        if on_call is not None:
            on_call(args, kw, out)
        calls.append((args, kw, out if keep_out else None))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def ragged_full_check(torch, de, st, sizes):
    """One full-size ragged step (~1% bad ids), each ragged kernel held
    to its plain version on the inputs the step gave it: K10's splits
    (forward and backward), K8's output and K9's stream bit-exact, and the touched slab rows against the plain
    scatter of K9's stream (rows one id hit bit-exact; a row k ids hit
    within k fp32 ulps of |old| + the sum of |lr x update|: both add in
    an atomic order of the card's choosing). Then the same batch with
    three features as ``SparseIds`` must give a bitwise-equal forward."""
    from distributed_embeddings_torch.ops import (
        lengths_to_splits_plain, ragged_combine_plain, ragged_grad_plain,
        row_to_split, sgd_scatter_plain)
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, apply, lookup, make_hybrid_train_step)

    slab = st.emb_params["w128"][0]
    nrows = slab.shape[0]

    class RecordingSGD(SparseSGD):
        """SparseSGD that keeps its stream and snapshots the rows it
        touches first."""

        def apply_rows(self, slab, state, ids, vals, lr):
            gid = ids.long()
            uniq = torch.unique(gid[(gid >= 0) & (gid < nrows)])
            self.seen = dict(ids=ids, vals=vals, lr=lr, uniq=uniq,
                             before=slab[uniq].clone())
            return super().apply_rows(slab, state, ids, vals, lr)

    rec = RecordingSGD()
    step = make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), rec,
                                  lr_schedule=TRAIN_LR, nan_guard=True)
    (cats, batch), = ragged_batches(torch, sizes, TRAIN_BATCH, 1,
                                    SEED + 90, bad_ids=True)[0]
    errs = {}

    def k8_check(args, kw, out):
        # now, before the step's update changes the slab the plain
        # version would read
        errs["ragged_combine"] = exact(torch, out, ragged_combine_plain(
            *args, **kw), "ragged_combine full-size")

    def k10_check(args, kw, out):
        errs["csr"] = max(errs.get("csr", 0.0), exact(
            torch, out, lengths_to_splits_plain(*args, **kw),
            "lengths_to_splits full-size"))

    zero_counts()
    with record_calls(lookup, "ragged_combine", keep_out=False,
                      on_call=k8_check) as k8, \
            record_calls(lookup, "lengths_to_splits", keep_out=False,
                         on_call=k10_check) as k10f, \
            record_calls(apply, "lengths_to_splits", keep_out=False,
                         on_call=k10_check) as k10b, \
            record_calls(apply, "ragged_grad") as k9:
        loss, st = step(st, cats, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == ragged_per_step(1), f"ragged full-size step: launches "
          f"{counts}, expected {ragged_per_step(1)}")
    check(bool(torch.isfinite(loss)), f"ragged full-size step: loss "
          f"{float(loss)}")
    check(len(k8) == 1 and "ragged_combine" in errs, "ragged full-size "
          "step: K8 was not checked")
    check(len(k10f) == len(k10b) == 1 and "csr" in errs, "ragged "
          "full-size step: K10 (lengths_to_splits) was not checked in the "
          "forward and the backward")
    del k8[:]
    (args, kw, (ids, vals)), = k9
    n = args[0].shape[0]
    err = 0.0
    for s in range(n):  # slot by slot: the plain version's float32 rows
        one = {k: (v[s:s + 1] if isinstance(v, torch.Tensor) and v.dim()
                   and v.shape[0] == n else v) for k, v in kw.items()}
        pi, pv = ragged_grad_plain(args[0][s:s + 1], args[1][s:s + 1], **one)
        exact(torch, ids[s:s + 1], pi, f"ragged_grad ids, slot {s}")
        err = max(err, exact(torch, vals[s:s + 1], pv,
                             f"ragged_grad rows, slot {s}"))
    errs["ragged_grad"] = err
    cap = ids.shape[1]
    del k9[:], ids, vals, args, kw
    # K3: the touched rows against the plain scatter of the same stream,
    # in chunks of the stream
    r = rec.seen
    want = r["before"].clone()
    mag = r["before"].float().abs()
    hits = torch.zeros(len(r["uniq"]), device="cuda")
    chunk = 1 << 22
    for lo in range(0, r["ids"].numel(), chunk):
        gid = r["ids"][lo:lo + chunk].long()
        keep = (gid >= 0) & (gid < nrows)
        pos = torch.searchsorted(r["uniq"], gid[keep])
        v = r["vals"][lo:lo + chunk][keep]
        sgd_scatter_plain(want, pos, v, r["lr"])
        mag.index_add_(0, pos, v.float().abs() * TRAIN_LR)
        hits.index_add_(0, pos, torch.ones_like(pos, dtype=torch.float32))
    got = slab[r["uniq"]]
    e = (got - want).abs()
    once = int(torch.count_nonzero(e[hits == 1]))
    multi = int(torch.count_nonzero(
        e > hits[:, None] * ulp(torch, mag, torch.float32)))
    check(once == 0 and multi == 0, f"ragged full-size step: {once} values "
          f"of rows hit once differ from the plain scatter, {multi} beyond "
          f"k fp32 ulps (max err {float(e.max())})")
    errs["sgd_scatter"] = float(e.max())
    changed = int(torch.count_nonzero((got != r["before"]).any(1)))
    log(f"ragged: full-size step at b={TRAIN_BATCH}, cap {cap}: loss "
        f"{float(loss):.5f}; {r['ids'].numel()} stream positions, "
        f"{len(r['uniq'])} touched rows ({int((hits > 1).sum())} hit more "
        f"than once, {changed} changed); vs plain on the step's inputs: "
        f"lengths_to_splits (forward and backward), ragged_combine and "
        f"ragged_grad bit-exact, sgd_scatter max_abs_err "
        f"{errs['sgd_scatter']} (rows hit once bit-exact, k hits within k "
        "fp32 ulps)")
    del rec.seen, r, want, mag, got, e
    # the same ids with three features as SparseIds: row_to_split (K10)
    mixed = [as_sparse_ids(torch, c, TRAIN_BATCH) if t in SPARSE_FEATURES
             else c for t, c in enumerate(cats)]
    zero_counts()
    with torch.no_grad():
        a = de(st.emb_params, cats)
        s = de(st.emb_params, mixed)
    torch.cuda.synchronize()
    check(row_to_split.launches == len(SPARSE_FEATURES),
          f"SparseIds forward: row_to_split launched "
          f"{row_to_split.launches} times")
    check(all(torch.equal(x, y) for x, y in zip(a, s)), "SparseIds forward "
          "differs from its Ragged twin")
    log(f"ragged: features {SPARSE_FEATURES} as SparseIds give a bitwise-"
        f"equal forward ({row_to_split.launches} row_to_split launches)")
    return st, errs, cats


def ragged_nan_check(torch, de, st, sizes):
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, make_hybrid_train_step)

    slab = st.emb_params["w128"][0]
    step = make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), SparseSGD(),
                                  lr_schedule=TRAIN_LR, nan_guard=True)
    (cats, batch), = ragged_batches(torch, sizes, TRAIN_BATCH, 1,
                                    SEED + 91, bad_ids=True, nan=True)[0]
    touched = torch.unique(ragged_rows(torch, de, cats, sizes))
    before = slab[touched].clone()
    dense_before = [p.detach().clone() for p in st.dense_params.parameters()]
    step_before = int(st.step)
    loss, st = step(st, cats, batch)
    torch.cuda.synchronize()
    check(not bool(torch.isfinite(loss)), "ragged NaN batch: loss is finite")
    check(torch.equal(slab[touched], before), "ragged NaN batch: slab rows "
          "changed")
    check(all(torch.equal(p, q) for p, q in zip(
        st.dense_params.parameters(), dense_before)),
        "ragged NaN batch: dense params changed")
    check(int(st.step) == step_before + 1, "ragged NaN batch: step did not "
          "advance")
    log(f"ragged: NaN batch skipped, {len(touched)} touched rows and the "
        f"dense params bitwise unchanged, step {step_before} -> "
        f"{int(st.step)}")
    return st


def ragged_timed(torch, de, st, batches):
    """3 warmup + 20 timed steps cycling over the pre-staged batches,
    launch counters zeroed just before and read just after, then the
    step's stages one by one for a split."""
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, make_hybrid_train_step)
    from distributed_embeddings_torch.parallel import apply as apply_mod

    step = make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), SparseSGD(),
                                  lr_schedule=TRAIN_LR, nan_guard=True)
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
    check(np.isfinite(losses).all(), f"ragged: non-finite loss {losses}")
    want = ragged_per_step(1)
    for name, n in launches.items():
        check(n == want[name] * TRAIN_STEPS, f"ragged: {name} launched {n} "
              f"times in {TRAIN_STEPS} steps (expected {want[name]} a step)")
    step_ms = [s.elapsed_time(e) for s, e in times]

    names = ["embedding_forward", "dense_forward_backward", "nan_guard",
             "cotangent_streams", "sparse_apply", "dense_update"]
    stage_ms = {n: [] for n in names}
    params = list(st.dense_params.parameters())
    local = de.local_view(st.emb_params)
    for k in range(WARMUP_RUNS + 10):
        cats, batch = batches[k % len(batches)]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
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
        per_width = apply_mod.cotangent_width_streams(de, res, out_grads)
        ev[4].record()
        apply_mod.apply_width_streams(de, local, st.emb_opt_state,
                                      per_width, SparseSGD(), TRAIN_LR, 1.0,
                                      enable=ok)
        ev[5].record()
        with torch.no_grad():
            for p, g in zip(params, grads[:len(params)]):
                p.copy_(torch.where(ok, p + g * -TRAIN_LR, p))
        ev[6].record()
        del per_width, grads, outs, res
        torch.cuda.synchronize()
        if k >= WARMUP_RUNS:
            for i, name in enumerate(names):
                stage_ms[name].append(ev[i].elapsed_time(ev[i + 1]))
    stages = {n: float(np.median(v)) for n, v in stage_ms.items()}
    b = batches[0][1][0].shape[0]
    result = {
        "batch": b, "steps": TRAIN_STEPS,
        "samples_per_s": TRAIN_STEPS * b / wall,
        "wall_step_ms": wall / TRAIN_STEPS * 1e3,
        "step_ms_p50": float(np.median(step_ms)),
        "step_ms_min": float(np.min(step_ms)),
        "stage_ms_p50": stages,
        "launches_per_step": {n: v / TRAIN_STEPS
                              for n, v in launches.items()},
        "loss_first": float(losses[0]), "loss_last": float(losses[-1])}
    log("ragged timed: " + json.dumps(result))
    return st, launches, result


def ragged_kernel_times(torch, de, st, batches):
    """CUDA-event medians of K8, K9 and K10 at the shapes the full-size
    step gives them (recorded from the step itself, one set per
    pre-staged batch), and of K3 on one step's ragged stream, each
    against its plain version, one library call for the same function,
    and its byte bound: each input read once, each output written once,
    each distinct slab row read (and, for K3, written) once."""
    import torch.nn.functional as F
    from distributed_embeddings_torch.ops import (
        lengths_to_splits, lengths_to_splits_plain, ragged_combine,
        ragged_combine_plain, ragged_grad, ragged_grad_plain, ragged_row_ids,
        ragged_row_ids_plain, row_to_split, row_to_split_plain, sgd_scatter,
        sgd_scatter_plain)
    from distributed_embeddings_torch.parallel import apply, lookup

    slab = st.emb_params["w128"][0]
    w = slab.shape[1]
    k8, k9, k10 = [], [], []
    stream = tstream = None
    for cats, batch in batches:
        with record_calls(lookup, "ragged_combine", keep_out=False) as c8, \
                record_calls(lookup, "lengths_to_splits",
                             keep_out=False) as c10, \
                torch.no_grad():
            outs, res = de.forward_with_residuals(st.emb_params, cats)
        if tstream is None:  # K13-K15's input: the step's telemetry stream
            tstream = de.telemetry_streams(res)[w]
        grads = [torch.randn_like(o) * 1e-3 for o in outs]
        with record_calls(apply, "ragged_grad", keep_out=False) as c9:
            per_width = apply.cotangent_width_streams(de, res, grads)
        if stream is None:  # K3's input: one step's (ids, rows)
            ids, vals, _ = per_width["w128"][0]
            stream = (ids.reshape(-1), vals.reshape(-1, w))
        del per_width
        k8 += c8
        k9 += c9
        k10 += c10
    n, cap = k8[0][0][1].shape
    b = k8[0][0][2].shape[1] - 1
    cases = {}

    # K8 --------------------------------------------------------------
    args8 = [(a, kw) for a, kw, _ in k8]
    lib8 = []
    uniq8 = []
    for (_, values, splits, rows, roff), _ in args8:
        ends = splits[:, -1].clamp(max=cap)
        live = torch.arange(cap, device="cuda")[None, :] < ends[:, None]
        grow = (torch.minimum(values.long().clamp(min=0), rows[:, None] - 1)
                + roff[:, None])[live]
        base = torch.cumsum(ends, 0) - ends
        offsets = (splits[:, :-1].clamp(max=cap) + base[:, None]).reshape(-1)
        lib8.append((grow, offsets))
        uniq8.append(int(torch.unique(grow).numel()))
    fn8 = lambda a, kw: ragged_combine(*a, **kw)  # noqa: E731
    ms = time_ms(torch, fn8, args8)
    plain = time_ms(torch, lambda a, kw: ragged_combine_plain(*a, **kw),
                    args8)
    lib = time_ms(torch, lambda g, o: F.embedding_bag(g, slab, o,
                                                      mode="sum"), lib8)
    live_ids = int(lib8[0][0].numel())
    nbytes = (live_ids * 4 + n * (b + 1) * 8 + uniq8[0] * w * 4
              + n * b * w * 2)
    cases["ragged_combine"] = dict(
        case=f"{n}x{b} rows, cap {cap}", ms=ms, plain_ms=plain,
        library_ms=lib, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", unique_rows=uniq8[0], ids=live_ids, bytes=nbytes)

    # K9 --------------------------------------------------------------
    args9 = [(a, kw) for a, kw, _ in k9]
    lib9 = []
    for a, kw in args9:
        g, splits = a[0], a[1]
        seg = ragged_row_ids_plain(splits, cap).long()
        sidx = (torch.arange(n, device="cuda")[:, None] * (b + 1)
                + seg).reshape(-1)
        gpad = torch.cat([g, torch.zeros((n, 1, w), dtype=g.dtype,
                                         device="cuda")], 1).reshape(-1, w)
        lib9.append((gpad, sidx))
    ms = time_ms(torch, lambda a, kw: ragged_grad(*a, **kw), args9)
    plain = time_ms(torch, lambda a, kw: ragged_grad_plain(*a, **kw),
                    args9)
    lib = time_ms(torch, lambda g, i: torch.index_select(g, 0, i), lib9)
    esize = args9[0][0][0].element_size()
    nbytes = (n * b * w * esize + live_ids * 4 + n * (b + 1) * 8
              + n * cap * (4 + w * esize))
    cases["ragged_grad"] = dict(
        case=f"{n}x{cap} positions", ms=ms, plain_ms=plain, library_ms=lib,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        positions=n * cap, bytes=nbytes)
    del lib9

    # K10 -------------------------------------------------------------
    args10 = [(a, kw) for a, kw, _ in k10]
    ms = time_ms(torch, lambda a, kw: lengths_to_splits(*a, **kw), args10)
    plain = time_ms(torch, lambda a, kw: lengths_to_splits_plain(*a, **kw),
                    args10)
    lib = time_ms(torch, lambda a, kw: torch.cumsum(a[0], 1), args10)
    nbytes = n * b * args10[0][0][0].element_size() + n * (b + 1) * 8
    csr = [dict(case=f"lengths_to_splits {n}x{b}", ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", bytes=nbytes)]
    coo = [as_sparse_ids(torch, cats[0], b).indices for cats, _ in batches]
    ms = time_ms(torch, lambda i: row_to_split(i, b), [(i,) for i in coo])
    plain = time_ms(torch, lambda i: row_to_split_plain(i, b),
                    [(i,) for i in coo])
    targets = torch.arange(b + 1, dtype=torch.int32, device="cuda")
    rows = [(i[:, 0].contiguous(),) for i in coo]
    lib = time_ms(torch, lambda r: torch.searchsorted(r, targets), rows)
    nbytes = coo[0].shape[0] * 4 + (b + 1) * 4
    csr.append(dict(case=f"row_to_split {coo[0].shape[0]} ids", ms=ms,
                    plain_ms=plain, library_ms=lib,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", bytes=nbytes))
    # ragged_row_ids on the step's own splits (no path of the step
    # calls it: the JAX package's ragged_row_ids entry point)
    rid_args = [(a[1],) for a, _ in args9]
    for (sp,) in rid_args:
        exact(torch, ragged_row_ids(sp, cap), ragged_row_ids_plain(sp, cap),
              "ragged_row_ids on the step's splits")
    ms = time_ms(torch, lambda sp: ragged_row_ids(sp, cap), rid_args)
    plain = time_ms(torch, lambda sp: ragged_row_ids_plain(sp, cap),
                    rid_args)
    pos = torch.arange(cap, dtype=rid_args[0][0].dtype,
                       device="cuda").expand(n, cap).contiguous()
    ends = [(sp[:, 1:].clamp(0, cap).contiguous(),) for (sp,) in rid_args]
    lib = time_ms(torch, lambda e: torch.searchsorted(e, pos, right=True),
                  ends)
    es = rid_args[0][0].element_size()
    nbytes = n * (b + 1) * es + n * cap * es
    csr.append(dict(case=f"ragged_row_ids {n}x{cap} positions", ms=ms,
                    plain_ms=plain, library_ms=lib,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", bytes=nbytes))
    del pos, ends
    cases["csr"] = csr

    # K3 on the ragged stream: 26.5M positions, ~19 ids per distinct row
    ids, vals = stream
    rows = slab.shape[0]

    def k3_plain(i, v):
        for lo in range(0, i.numel(), 1 << 22):  # chunks: float32 copies
            sgd_scatter_plain(slab, i[lo:lo + (1 << 22)],
                              v[lo:lo + (1 << 22)], TRAIN_LR)

    keep = ids < rows
    uniq = int(torch.unique(ids[keep]).numel())
    ms = time_ms(torch, lambda i, v: sgd_scatter(slab, i, v, TRAIN_LR),
                 [stream])
    plain = time_ms(torch, k3_plain, [stream])
    nl = torch.tensor(-TRAIN_LR, dtype=torch.float32, device="cuda")
    lib_args = [(ids[keep].long(), vals[keep].float() * nl)]
    del keep
    lib = time_ms(torch, lambda i, u: slab.index_add_(0, i, u), lib_args)
    del lib_args
    n3 = ids.numel()
    nbytes = n3 * w * vals.element_size() + n3 * 4 + 2 * uniq * w * 4
    cases["sgd_scatter"] = dict(
        case=f"ragged b65536 stream ({n3} positions)", ms=ms,
        plain_ms=plain, library_ms=lib,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        unique_rows=uniq, ids=n3, bytes=nbytes)
    del stream, ids, vals
    # K13-K15 on the step's telemetry stream (~26.4M positions)
    from distributed_embeddings_torch.analysis import telemetry as tel

    cases["telemetry"] = sketch_kernel_times(
        torch, *tstream, tel.config_from_env(), f"ragged b{TRAIN_BATCH}")
    del tstream
    for name in ("ragged_combine", "ragged_grad", "sgd_scatter"):
        c = cases[name]
        log(f"time {name} {c['case']}: kernel {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f}, bound "
            f"{c['bound_ms']:.4f}")
    for c in csr:
        log(f"time csr {c['case']}: kernel {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f}, bound "
            f"{c['bound_ms']:.4f}")
    return cases


def phase_ragged(torch):
    """The multi-hot ragged DLRM (``bench.py`` ``multihot_ragged``): the
    capped Criteo-Kaggle tables in fp32, 26 ragged features of U{1..30}
    Zipfian ids a row, bf16 compute, ``SparseSGD`` + SGD at lr 0.005,
    batch 65536, on K10 (lengths -> splits), K8, K2/K4, K9 and K3."""
    t_phase = time.perf_counter()
    errs = ragged_kernel_checks(torch)
    log("ragged: small-table check, kernels against plain versions")
    for dtype in (torch.float32, torch.bfloat16):
        ragged_small_check(torch, dtype)
    torch.cuda.empty_cache()

    sizes = ragged_sizes()
    t0 = time.perf_counter()
    de, st = ragged_model(torch, sizes, torch.float32, SEED + 85)
    torch.cuda.synchronize()
    slab = st.emb_params["w128"]
    check(tuple(slab.shape) == (1, sum(sizes), 128),
          f"ragged slab shape {tuple(slab.shape)}")
    log(f"ragged: capped Criteo-Kaggle DLRM, slab {tuple(slab.shape)} fp32 "
        f"= {slab.numel() * 4 / 1e9:.2f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    st, full_errs, _ = ragged_full_check(torch, de, st, sizes)
    for k, v in full_errs.items():
        errs[k] = max(errs.get(k, 0.0), v)
    st = ragged_nan_check(torch, de, st, sizes)
    t0 = time.perf_counter()
    batches, cap = ragged_batches(torch, sizes, TRAIN_BATCH, RAGGED_BATCHES,
                                  SEED + 92)
    nnz = [int(c.row_splits[-1]) for c in batches[0][0]]
    distinct = torch.unique(ragged_rows(torch, de, batches[0][0], sizes))
    log(f"ragged: {RAGGED_BATCHES} batches of {TRAIN_BATCH} made on the "
        f"card in {time.perf_counter() - t0:.1f} s; cap {cap}, ids a step "
        f"{sum(nnz)} (largest feature {max(nnz)}), distinct slab rows "
        f"{distinct.numel()}")
    result_data = {"cap": cap, "ids_per_step": sum(nnz),
                   "largest_feature": max(nnz),
                   "distinct_rows": int(distinct.numel())}
    del distinct
    st, launches, result = ragged_timed(torch, de, st, batches)
    result.update(result_data)
    cases = ragged_kernel_times(torch, de, st, batches)
    result["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"ragged: phase done in {result['phase_s']:.1f} s, peak memory "
        f"{result['peak_memory_gb']:.1f} GB")
    del st, de, batches
    gc.collect()
    torch.cuda.empty_cache()
    return launches, errs, cases, result


# ------------------------------------------------------------------ adam

ROW_SITES = {"adam": "adam_rows", "momentum": "momentum_rows"}
CONV_SCHEDULE = (0.01, 20, 180, 60)  # tests/test_convergence.py:29-30
CONV_JAX_CPU_AUC = 0.740             # docs/perf_tpu.md Round 9, JAX on CPU
# dense lr of momentum SGD on the zoo: at the zoo's 0.01 (and at 1e-3)
# momentum SGD diverges on its dense half (MSE over numerical features
# x100; loss past 1e22 within ten steps of a 20k-row-capped CPU run at
# b=1024), at 1e-4 the loss falls over 30 steps there
MOM_DENSE_LR = 1e-4


def tree_equal(torch, a, b):
    """Bitwise equality of two states of one structure."""
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        bool(torch.equal(x, y)) for x, y in zip(la, lb))


def row_optimizer(name, nesterov=False):
    """``(sparse, dense)`` optimizers of a row-kernel path:
    ``SparseAdam`` + ``Adam`` at the zoo's lr, or ``SparseMomentum`` +
    momentum ``SGD`` (with ``nesterov`` on both) at the zoo's sparse lr
    and the dense lr ``MOM_DENSE_LR``."""
    from distributed_embeddings_torch.parallel import (
        SGD, Adam, SparseAdam, SparseMomentum)

    if name == "adam":
        return SparseAdam(), Adam(ZOO_LR)
    return (SparseMomentum(0.9, nesterov=nesterov),
            SGD(MOM_DENSE_LR, momentum=0.9, nesterov=nesterov))


def row_update(torch, name, kernel, slab, st, uids, uvals, lr, nesterov):
    """One K11/K12 call (``kernel``) or its plain version, in place."""
    from distributed_embeddings_torch.ops import (
        adam_rows, adam_rows_plain, momentum_rows, momentum_rows_plain)

    if name == "adam":
        fn = adam_rows if kernel else adam_rows_plain
        return fn(slab, st[0], st[1], st[2], uids, uvals, lr, 0.9, 0.999,
                  1e-8, 0.0)
    fn = momentum_rows if kernel else momentum_rows_plain
    return fn(slab, st, uids, uvals, lr, 0.9, nesterov)


def adam_kernel_checks(torch):
    """K11 and K12 against their plain versions on the card, bit-exact:
    float32 tables and state, bf16 tables and state, bf16 tables over
    float32 state; widths 16, 8 (4-element loads) and 3 (one-element);
    int32 and int64 ids; a Python and a device lr; counts 1 and 1000
    (K11); Nesterov off and on (K12); negative ids, the sentinel, ids
    past the slab and a pad tail (no id 0 beside negative ids: both read
    row 0, in no set order on the card). Then one ``apply_rows`` of each
    optimizer on a stream where one id repeats 50,000 times, its row
    kernel held to the plain version on the K5 output of that call."""
    from distributed_embeddings_torch.parallel import optimizers

    rng = np.random.default_rng(SEED + 100)
    R = 4096
    errs = {"adam_rows": 0.0, "momentum_rows": 0.0}
    n_cases = 0
    f32, bf16 = torch.float32, torch.bfloat16
    for sd, md in ((f32, f32), (bf16, bf16), (bf16, f32)):
        for w in (16, 8, 3):
            rows = 1 + rng.permutation(R - 21)[:1500]
            uids = np.concatenate([np.sort(rows), [-1, -7, R, R + 5, -R - 3],
                                   [R] * 64])
            untouched = torch.as_tensor(np.setdiff1d(
                np.arange(R), np.union1d(rows, [R - 1, R - 7])),
                device="cuda")
            g = torch.as_tensor(rng.normal(size=(len(uids), w)).astype(
                np.float32), device="cuda").to(md)
            for ids_dt, lr in ((torch.int32, ZOO_LR),
                               (torch.int64, torch.tensor(
                                   0.013, device="cuda"))):
                tid = torch.as_tensor(uids, device="cuda").to(ids_dt)
                for name, variant in (("adam", 1.0), ("adam", 1000.0),
                                      ("momentum", False),
                                      ("momentum", True)):
                    slab = torch.randn((R, w), device="cuda").to(sd)
                    if name == "adam":
                        st = (0.1 * torch.randn((R, w), device="cuda"),
                              0.1 * torch.rand((R, w), device="cuda"),
                              torch.full((1, 1), variant, device="cuda"))
                        st = (st[0].to(md), st[1].to(md), st[2])
                    else:
                        st = (0.1 * torch.randn((R, w), device="cuda")
                              ).to(md)
                    nest = variant is True
                    got_s, got = slab.clone(), clone_tree(st)
                    want_s, want = slab.clone(), clone_tree(st)
                    row_update(torch, name, True, got_s, got, tid, g, lr,
                               nest)
                    row_update(torch, name, False, want_s, want, tid, g, lr,
                               nest)
                    what = (f"{ROW_SITES[name]} {str(sd)[6:]}/{str(md)[6:]} "
                            f"w{w} {ids_dt} lr {float(lr)} {variant}")
                    outs = [(got_s, want_s, slab)] + (
                        [(got[0], want[0], st[0]), (got[1], want[1], st[1])]
                        if name == "adam" else [(got, want, st)])
                    for a, b, old in outs:
                        errs[ROW_SITES[name]] = max(
                            errs[ROW_SITES[name]], exact(torch, a, b, what))
                        check(torch.equal(a[untouched], old[untouched]),
                              f"{what}: an untouched row changed")
                    check(not torch.equal(got_s, slab), f"{what}: no row "
                          "moved")
                    n_cases += 1
    # a hot id through the whole apply_rows: K5, then K11/K12
    R2, w, n = 100_000, 16, 200_000
    ids = rng.zipf(1.2, size=n) % R2
    ids[rng.permutation(n)[:50_000]] = 777
    ids = torch.as_tensor(ids.astype(np.int32), device="cuda")
    vals = torch.randn((n, w), device="cuda")
    for name in ("adam", "momentum"):
        opt, _ = row_optimizer(name)
        slab = torch.randn((R2, w), device="cuda")
        st = opt.init({"w": slab[None]})["w"]
        st = tuple(t[0] if t.dim() == 3 else t for t in st) \
            if isinstance(st, tuple) else st[0]
        before_s, before = slab.clone(), clone_tree(st)
        with record_calls(optimizers, "dedup_sparse_grad") as c5:
            opt.apply_rows(slab, st, ids, vals, ZOO_LR)
        uids, uvals = c5[0][2]
        check(int((uids == 777).sum()) == 1, f"hot id: {name}: K5 output "
              "holds the hot id other than once")
        if name == "adam":
            before = (before[0], before[1], st[2])  # the advanced count
        row_update(torch, name, False, before_s, before, uids, uvals,
                   ZOO_LR, False)
        what = f"{ROW_SITES[name]} hot id (50,000 repeats)"
        errs[ROW_SITES[name]] = max(errs[ROW_SITES[name]],
                                    exact(torch, slab, before_s, what))
        pairs = zip(st[:2], before[:2]) if name == "adam" else [(st, before)]
        for a, b in pairs:
            exact(torch, a, b, what + " state")
        n_cases += 1
    n_cases += wrapped_row_checks(torch, errs)
    torch.cuda.synchronize()
    log(f"adam: K6/K11/K12 edge cases on the card: {n_cases} cases "
        f"bit-exact against the plain versions (max_abs_err {errs})")
    return errs


def wrapped_row_checks(torch, errs):
    """A negative id beside its wrapped row, and id 0 beside -R (which
    wraps to row 0), in one sorted stream: K6, K11 and K12 (and
    Nesterov) against their plain versions, fp32 and bf16 tables and
    state, slab and state bit-exact. The plain versions hold JAX's order
    (tests/test_torch_wrapped_rows.py): both deltas land on the wrapped
    row, the negative id's first, and the row's own state transition
    stays. Returns the number of cases."""
    from distributed_embeddings_torch.ops import (
        adagrad_rows, adagrad_rows_plain)

    R, w = 4096, 16
    uids = torch.tensor([-R - 2, -R, -9, -3, 0, 11, 40, R - 9, R - 3, R, R],
                        dtype=torch.int32, device="cuda")
    errs.setdefault("adagrad_rows", 0.0)
    n_cases = 0
    for dt in (torch.float32, torch.bfloat16):
        g = torch.randn((uids.numel(), w), device="cuda").to(dt)
        for name in ("adagrad", "adam", "momentum", "nesterov"):
            slab = torch.randn((R, w), device="cuda").to(dt)
            if name == "adam":
                st = ((0.1 * torch.randn((R, w), device="cuda")).to(dt),
                      (0.1 * torch.rand((R, w), device="cuda")).to(dt),
                      torch.full((1, 1), 7.0, device="cuda"))
            else:
                st = (0.05 + 0.2 * torch.rand((R, w), device="cuda")).to(dt)
            runs = []
            for kernel in (True, False):
                s_, t_ = slab.clone(), clone_tree(st)
                if name == "adagrad":
                    (adagrad_rows if kernel else adagrad_rows_plain)(
                        s_, t_, uids, g, ZOO_LR, 1e-7)
                else:
                    row_update(torch, "adam" if name == "adam" else
                               "momentum", kernel, s_, t_, uids, g, ZOO_LR,
                               name == "nesterov")
                runs.append([s_] + (list(t_[:2]) if name == "adam"
                                    else [t_]))
            site = {"adagrad": "adagrad_rows", "adam": "adam_rows"}.get(
                name, "momentum_rows")
            what = f"{site} wrapped rows {name} {str(dt)[6:]}"
            for a, b in zip(*runs):
                errs[site] = max(errs[site], exact(torch, a, b, what))
            check(not torch.equal(runs[0][0][R - 3], slab[R - 3]),
                  f"{what}: the wrapped row did not move")
            n_cases += 1
    return n_cases


def adam_small_check(torch, dtype, name):
    """5 steps of the tiny zoo capped at SMALL_ROWS rows a table, b=4096,
    with ``SparseAdam`` or ``SparseMomentum`` (``row_optimizer``), in
    lockstep: each step runs with the kernels and, from a copy of the
    same state, with only K11/K12 routed to their plain versions
    (``plain_kernels``); the kernels' run goes on. Every other kernel
    (K1, the deterministic K5) is the same in both runs and K11/K12
    repeat their plain versions' arithmetic, so losses, dense params
    and the dense optimizer state, and the slabs, moments, traces and
    counts, must all be bitwise equal."""
    from distributed_embeddings_torch.models import InputGenerator
    from distributed_embeddings_torch.parallel import make_hybrid_train_step

    opt, tx = row_optimizer(name)
    site = ROW_SITES[name]
    cfg, de, opt, st = zoo_model(torch, dtype, SMALL_ROWS, seed=SEED + 101,
                                 opt=opt, tx=tx)
    init = clone_tree(st.emb_params)
    step = make_hybrid_train_step(de, zoo_loss, tx, opt, lr_schedule=ZOO_LR,
                                  nan_guard=True)
    data = InputGenerator(cfg, SMALL_BATCH, alpha=1.05,
                          num_batches=SMALL_STEPS, seed=SEED + 102,
                          row_cap=SMALL_ROWS, device="cuda")
    losses = []
    for k in range(SMALL_STEPS):
        num, cats, lab = data[k]
        ref = clone_state(st)
        zero_counts()
        loss, st = step(st, cats, (num, lab))
        torch.cuda.synchronize()
        kc = read_counts()
        zero_counts()
        with plain_kernels((site,)):
            ploss, ref = step(ref, cats, (num, lab))
        torch.cuda.synchronize()
        pc = read_counts()
        check(kc[site] == 2 and kc["dedup_sparse_grad"] == 2 and pc[site] == 0
              and pc["dedup_sparse_grad"] == 2, f"{name} small check step "
              f"{k}: launches {kc} / plain {pc}")
        what = f"{name} small check {str(dtype)[6:]} step {k}"
        check(bool(torch.isfinite(loss)), f"{what}: loss {float(loss)}")
        check(torch.equal(loss, ploss), f"{what}: loss {float(loss)} != "
              f"{float(ploss)} with the plain {site}")
        check(all(torch.equal(a, b) for a, b in zip(
            st.dense_params.parameters(), ref.dense_params.parameters())),
            f"{what}: dense params differ from the plain {site} run's")
        check(tree_equal(torch, st.dense_opt_state, ref.dense_opt_state),
              f"{what}: dense optimizer state differs")
        check(tree_equal(torch, st.emb_params, ref.emb_params),
              f"{what}: slabs differ from the plain {site} run's")
        check(tree_equal(torch, st.emb_opt_state, ref.emb_opt_state),
              f"{what}: slab optimizer state differs")
        losses.append(float(loss))
        del ref
    check(not tree_equal(torch, st.emb_params, init),
          f"{name} small check: no slab row changed")
    log(f"  {name} small check {str(dtype)[6:]} tables: {SMALL_STEPS} "
        f"lockstep steps at b={SMALL_BATCH}, losses "
        f"{[round(x, 5) for x in losses]}; vs the plain {site}: losses, "
        f"dense params and state, slabs and their state bitwise equal")


def convergence_runs(torch):
    """The planted-signal DLRM trained by ``train_dlrm_convergence`` on
    the card (``SparseAdam`` + ``Adam``): (i) the JAX learning test's
    configuration (``tests/test_convergence.py``) at world 1, held to
    that test's learning bounds (fp32 seed 0 ends above 0.82 and rises
    through its midpoint; seed 11 ends above 0.82 in bf16 tables and
    within 0.03 of fp32), its bound on the untrained model's AUC (0.45 <
    auc0 < 0.58) reported: the initial weights come from the port's
    torch generator, not JAX's keys, so that AUC is another draw;
    (ii) the bench's ``convergence`` configuration
    (``bench.py:run_convergence``), whose AUCs are printed. The launch
    counters are zeroed before (i) and read after (ii)."""
    from distributed_embeddings_torch.models import (
        LearnableClicks, train_dlrm_convergence, warmup_poly_decay_schedule)

    sched = warmup_poly_decay_schedule(*CONV_SCHEDULE)
    task = LearnableClicks([200] * 8, num_numerical=4, seed=123, scale=1.2)
    out = {}
    zero_counts()
    for label, dtype, seed in (("fp32_seed0", torch.float32, 0),
                               ("fp32_seed11", torch.float32, 11),
                               ("bf16_seed11", torch.bfloat16, 11)):
        t0 = time.perf_counter()
        aucs = train_dlrm_convergence(
            task, steps=240, batch=1024, embedding_dim=8,
            lr_schedule=sched, param_dtype=dtype, eval_n=8192, seed=seed,
            device="cuda")
        out[label] = {"aucs": list(aucs),
                      "wall_s": time.perf_counter() - t0}
        log(f"convergence (learning test, {label}): auc start/mid/end "
            f"{aucs}, {out[label]['wall_s']:.1f} s")
    task = LearnableClicks([2000] * 8, num_numerical=4, seed=123, scale=1.2)
    for label, dtype in (("bench_fp32", torch.float32),
                         ("bench_bf16", torch.bfloat16)):
        t0 = time.perf_counter()
        aucs = train_dlrm_convergence(
            task, steps=360, batch=8192, embedding_dim=16, lr_schedule=0.01,
            param_dtype=dtype, device="cuda")
        out[label] = {"aucs": list(aucs),
                      "wall_s": time.perf_counter() - t0}
        log(f"convergence (bench, {label}): auc start/mid/end {aucs} in "
            f"{out[label]['wall_s']:.1f} s (the JAX package on the CPU: "
            f"{CONV_JAX_CPU_AUC} at the end, docs/perf_tpu.md Round 9)")
    torch.cuda.synchronize()
    launches = read_counts()
    steps = 3 * 240 + 2 * 360
    check(launches["adam_rows"] == steps and
          launches["dedup_sparse_grad"] == steps and
          launches["sgd_scatter"] == 0 and launches["dot_interact_fwd"] > 0
          and launches["dot_interact_bwd"] == steps
          and launches["gather_combine"] > 0,
          f"convergence: launches {launches}")
    a0, mid, end = out["fp32_seed0"]["aucs"]
    fp32, bf16 = out["fp32_seed11"]["aucs"][2], out["bf16_seed11"]["aucs"][2]
    bounds = {"0.45 < auc0 < 0.58": 0.45 < a0 < 0.58,
              "auc_end > 0.82": end > 0.82,
              "auc_end > auc_mid > auc0": end > mid > a0,
              "bf16 auc_end > 0.82": bf16 > 0.82,
              "|auc_fp32 - auc_bf16| < 0.03": abs(fp32 - bf16) < 0.03}
    out["bounds"] = bounds
    log(f"convergence: the learning test's bounds {bounds}")
    # what the runs learn is held; the untrained model's AUC is a draw of
    # the port's own initializer (not JAX's keys) and is reported
    learned = [k for k in bounds if k != "0.45 < auc0 < 0.58"]
    check(all(bounds[k] for k in learned), f"convergence: a learning "
          f"bound of tests/test_convergence.py is missed: {bounds}")
    if not bounds["0.45 < auc0 < 0.58"]:
        log(f"convergence: MISSED 0.45 < auc0 < 0.58 at the port's initial "
            f"weights (auc0 {a0}; the seed and bound kept as they are)")
    return launches, out


def row_expected(de, name):
    """Launches a zoo step makes with ``SparseAdam``/``SparseMomentum``:
    K1 once per plan group, K5 and K11/K12 once per width slab."""
    plan = next(iter(de._plan_cache.values()))
    want = {k: 0 for k in kernel_fns()}
    want.update(gather_combine=len(plan.groups), pack_ids=1, pack_columns=1)
    want["dedup_sparse_grad"] = len(de.widths)
    want[ROW_SITES[name]] = len(de.widths)
    return want


def row_zoo_full_check(torch, de, opt, tx, st, data, name, label,
                       nesterov=False):
    """One full-size zoo step with each slab's K5 and K11/K12 held to
    their plain versions on the step's own inputs: K5's unique ids equal
    the plain dedup's and its sums within 2 k 2^-24 of the sum of |rows|
    (plus 1 bf16 ulp for bf16 state); K11/K12 on K5's output, applied to
    the snapshot of the touched rows taken before the step, bit-exact
    in the slab and in its state (and Adam's count advanced once)."""
    from distributed_embeddings_torch.parallel import make_hybrid_train_step

    step = make_hybrid_train_step(de, zoo_loss, tx, opt, lr_schedule=ZOO_LR,
                                  nan_guard=True)
    num, cats, lab = data[0]
    with recording(torch, opt) as seen:
        zero_counts()
        loss, st = step(st, cats, (num, lab))
        torch.cuda.synchronize()
        counts = read_counts()
    want = row_expected(de, name)
    check(counts == want, f"{name} zoo step {label}: launches {counts}, "
          f"expected {want}")
    check(bool(torch.isfinite(loss)), f"{name} zoo step {label}: loss "
          f"{float(loss)}")
    errs = {"dedup_sparse_grad": 0.0, ROW_SITES[name]: 0.0}
    for key, r in seen.items():
        slab = st.emb_params[key][0]
        state = de.local_view(st.emb_opt_state)[key]
        rows = slab.shape[0]
        what = f"{name} zoo step {label} {key}"
        e5, keep, pos = k5_check(torch, r, rows, what)
        ws, wst = r["slab"].clone(), clone_tree(r["state"])
        if name == "adam":
            check(float(state[2].reshape(())) ==
                  float(r["state"][2].reshape(())) + 1, f"{what}: the count "
                  "did not advance once")
            wst = (wst[0], wst[1], state[2])
        row_update(torch, name, False, ws, wst, pos, r["ugrads"][keep],
                   r["lr"], nesterov)
        uq = r["uniq"]
        e = exact(torch, slab[uq], ws, what + " slab")
        if name == "adam":
            exact(torch, state[0][uq], wst[0], what + " mu")
            exact(torch, state[1][uq], wst[1], what + " nu")
        else:
            exact(torch, state[uq], wst, what + " trace")
        errs["dedup_sparse_grad"] = max(errs["dedup_sparse_grad"], e5)
        errs[ROW_SITES[name]] = max(errs[ROW_SITES[name]], e)
        log(f"{name} zoo: full-size step {label} {key}: "
            f"{r['ids'].numel()} ids, {len(uq)} touched rows; K5 max_abs_err "
            f"{e5} (<= 2 k 2^-24 of the sum of |rows|), "
            f"{ROW_SITES[name]} slab and state bit-exact on K5's output")
    log(f"{name} zoo: full-size step {label} at b={ZOO_BATCH}: loss "
        f"{float(loss):.5f}, launches {counts}")
    return st, errs


def row_kernel_times(torch, de, opt, st, data, name):
    """CUDA-event medians of K11 or K12 at the zoo's w16 and w8 shapes
    (the unique rows of one step's K5 output), each against its plain
    version, its byte bound (each touched row's gradient, state and slab
    rows read once and written once, and the ids), and for K11
    ``torch.optim.SparseAdam.step`` on a coalesced sparse COO gradient of
    the same unique rows (its ``eps`` sits outside the bias correction:
    a yardstick of the same traffic, not the same function); K12 has no
    single library call."""
    from distributed_embeddings_torch.parallel import (
        make_hybrid_train_step, optimizers)

    tx = row_optimizer(name)[1]
    step = make_hybrid_train_step(de, zoo_loss, tx, opt, lr_schedule=ZOO_LR,
                                  nan_guard=False)
    num, cats, lab = data[2]
    with record_calls(optimizers, "dedup_sparse_grad") as c5:
        _, st = step(st, cats, (num, lab))
    torch.cuda.synchronize()
    local = de.local_view(st.emb_opt_state)
    cases = []
    for (_, _, (uids, ugrads)), key in zip(c5, sorted(local)):
        slab = st.emb_params[key][0]
        state = local[key]
        rows, w = slab.shape
        check(ugrads.shape[1] == w, f"{name} times: {key} stream order")
        touched = int((uids < rows).sum())
        es, eg = slab.element_size(), ugrads.element_size()
        n_state = 2 if name == "adam" else 1
        nest = name != "adam" and opt.nesterov

        def run(kernel):
            return row_update(torch, name, kernel, slab, state, uids, ugrads,
                              ZOO_LR, nest)

        nbytes = (uids.numel() * uids.element_size()
                  + touched * w * (eg + 2 * (es + n_state * eg)))
        ops = touched * w * (15 if name == "adam" else 6)
        c = {"case": f"zoo {key}: {touched} unique rows of {w}",
             "ms": time_ms(torch, run, [(True,)]),
             "plain_ms": time_ms(torch, run, [(False,)]),
             "library_ms": None,
             "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                             ops / F32_OPS_PER_S) * 1e3,
             "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                          >= ops / F32_OPS_PER_S else "operations"),
             "unique_rows": touched, "bytes": nbytes}
        if name == "adam" and slab.dtype == torch.float32:
            keep = uids < rows
            param = torch.nn.Parameter(slab, requires_grad=False)
            param.grad = torch.sparse_coo_tensor(
                uids[keep].long()[None], ugrads[keep].float(),
                tuple(slab.shape)).coalesce()
            lib = torch.optim.SparseAdam([param], lr=ZOO_LR)
            c["library_ms"] = time_ms(torch, lib.step, [()])
            c["library_call"] = "torch.optim.SparseAdam.step"
            del lib, param
        cases.append(c)
        log(f"time {ROW_SITES[name]} {c['case']}: kernel {c['ms']:.4f} ms, "
            f"plain {c['plain_ms']:.4f}, library {c['library_ms']}, bound "
            f"{c['bound_ms']:.4f}")
    gc.collect()
    torch.cuda.empty_cache()
    return st, sorted(cases, key=lambda c: -c["unique_rows"])


def phase_adam(torch):
    """Lazy ``SparseAdam`` and ``SparseMomentum`` on K11/K12 after K5:
    the edge cases, the small lockstep checks, the planted-signal
    convergence runs, then the uncapped tiny zoo with ``SparseAdam`` +
    ``Adam`` (fp32 tables: a checked step, a NaN batch, 20 timed steps,
    a stage split and K11's times), with ``SparseMomentum`` and Nesterov
    on the same slabs (a checked step and 5 timed steps each, K12's
    times), and with ``SparseAdam`` on bf16 tables (a checked step, a
    NaN batch, 20 timed steps and a stage split)."""
    from distributed_embeddings_torch.models import InputGenerator

    t_phase = time.perf_counter()
    errs = adam_kernel_checks(torch)
    log("adam: small-table lockstep checks, K11/K12 against plain")
    for name in ("adam", "momentum"):
        for dtype in (torch.float32, torch.bfloat16):
            adam_small_check(torch, dtype, name)
    torch.cuda.empty_cache()
    conv_launches, conv = convergence_runs(torch)
    result = {"convergence": conv}

    opt, tx = row_optimizer("adam")
    t0 = time.perf_counter()
    cfg, de, opt, st = zoo_model(torch, torch.float32, seed=SEED + 110,
                                 opt=opt, tx=tx)
    torch.cuda.synchronize()
    log(f"adam zoo: tiny model, slabs "
        f"{ {k: tuple(v.shape) for k, v in st.emb_params.items()} } fp32 "
        f"+ mu + nu = "
        f"{3 * sum(v.numel() for v in st.emb_params.values()) * 4 / 1e9:.2f}"
        f" GB, built in {time.perf_counter() - t0:.1f} s")
    data = InputGenerator(cfg, ZOO_BATCH, alpha=1.05, num_batches=ZOO_BATCHES,
                          seed=0, device="cuda")
    st, full = row_zoo_full_check(torch, de, opt, tx, st, data, "adam", "fp32")
    for k, v in full.items():
        errs[k] = max(errs.get(k, 0.0), v)
    st = zoo_nan_check(torch, de, opt, st, data, tx=tx,
                       label="adam zoo fp32")
    want = row_expected(de, "adam")
    st, adam_launches, fp32 = zoo_timed(torch, de, opt, st, data, cfg,
                                        "adam fp32", tx=tx, want=want)
    fp32["stage_ms_p50"] = zoo_stages(torch, de, opt, st, data, tx=tx)
    log("adam zoo stages fp32 (ms): " + json.dumps(fp32["stage_ms_p50"]))
    st, fp32["profile"] = zoo_profile(torch, de, opt, st, data, tx=tx,
                                      label="adam fp32")
    st, adam_cases = row_kernel_times(torch, de, opt, st, data, "adam")
    result["adam_fp32"] = fp32
    result["adam_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # the same slabs with SparseMomentum (and Nesterov): Adam's state goes
    mom = {}
    mom_launches = mom_cases = None
    for nest in (False, True):
        label = "nesterov" if nest else "momentum"
        opt, tx = row_optimizer("momentum", nest)
        st = st._replace(
            emb_opt_state=None, dense_opt_state=None)
        gc.collect()
        torch.cuda.empty_cache()
        st = st._replace(
            emb_opt_state=opt.init(st.emb_params),
            dense_opt_state=tx.init(list(st.dense_params.parameters())))
        st, full = row_zoo_full_check(torch, de, opt, tx, st, data,
                                      "momentum", label, nesterov=nest)
        for k, v in full.items():
            errs[k] = max(errs.get(k, 0.0), v)
        st, launches, mom[label] = zoo_timed(
            torch, de, opt, st, data, cfg, label, tx=tx,
            want=row_expected(de, "momentum"), steps=5)
        if not nest:
            mom_launches = launches
            st, mom_cases = row_kernel_times(torch, de, opt, st, data,
                                             "momentum")
    result.update(mom)
    del st
    gc.collect()
    torch.cuda.empty_cache()

    opt, tx = row_optimizer("adam")
    cfg, de, opt, st = zoo_model(torch, torch.bfloat16, seed=SEED + 120,
                                 opt=opt, tx=tx)
    st, full = row_zoo_full_check(torch, de, opt, tx, st, data, "adam",
                                  "bf16")
    st = zoo_nan_check(torch, de, opt, st, data, tx=tx,
                       label="adam zoo bf16")
    st, _, bf16 = zoo_timed(torch, de, opt, st, data, cfg, "adam bf16",
                            tx=tx, want=row_expected(de, "adam"))
    bf16["stage_ms_p50"] = zoo_stages(torch, de, opt, st, data, tx=tx)
    log("adam zoo stages bf16 (ms): " + json.dumps(bf16["stage_ms_p50"]))
    bf16["full_step_max_abs_err"] = full
    result["adam_bf16"] = bf16
    del st, de, data
    gc.collect()
    torch.cuda.empty_cache()
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"adam: phase done in {result['phase_s']:.1f} s")
    launches = {"adam": adam_launches, "momentum": mom_launches,
                "convergence": conv_launches}
    return launches, errs, {"adam_rows": adam_cases,
                            "momentum_rows": mom_cases}, result



# ------------------------------------------------------------- telemetry

TELEM_BATCH = 16384            # bench.py:run_telemetry_overhead's batch
TELEM_STEPS = 12               # its timed steps (bench.py RESIL_STEPS)
TELEM_WARMUP = 2
TELEM_CHECK_STEPS = 3
TELEMETRY_SITES = ("sketch_update", "sketch_query", "topk_pool",
                   "topk_merge")  # the call sites of K13-K15
#: planted hot rows (table: row), each given half its table's ids
TELEM_PLANTED = {2: 123_457, 11: 999, 20: KAGGLE_CAP - 1}


def telemetry_model(torch, seed):
    """``run_telemetry_overhead``'s model: the one-hot DLRM over the
    Criteo-Kaggle vocabularies capped at 2M rows, bf16 tables and
    compute, ``SparseSGD`` + SGD at lr 0.005."""
    from distributed_embeddings_torch.models import DLRMConfig, DLRMDense
    from distributed_embeddings_torch.parallel import (
        SGD, DistributedEmbedding, SparseSGD, init_hybrid_state)

    cfg = DLRMConfig(table_sizes=ragged_sizes(), embedding_dim=128,
                     num_numerical_features=13,
                     bottom_mlp_dims=(512, 256, 128),
                     top_mlp_dims=(1024, 1024, 512, 256, 1),
                     compute_dtype=torch.bfloat16)
    de = DistributedEmbedding(cfg.embedding_configs(), world_size=1,
                              compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dense = DLRMDense(cfg, device="cuda", generator=gen)
    st = init_hybrid_state(de, SparseSGD(), dense, SGD(TRAIN_LR),
                           generator=gen, dtype=torch.bfloat16,
                           device="cuda")
    return de, st


def telemetry_step(de, telemetry, nan_guard=False):
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, make_hybrid_train_step)

    return make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), SparseSGD(),
                                  lr_schedule=TRAIN_LR, nan_guard=nan_guard,
                                  telemetry=telemetry)


def telem_equal(torch, a, b, what):
    """Every leaf of two telemetry states bitwise equal."""
    for k in a:
        if isinstance(a[k], dict):
            telem_equal(torch, a[k], b[k], f"{what} {k}")
        else:
            exact(torch, a[k], b[k], f"{what} {k}")


def telemetry_per_step(launches):
    """Launches of one telemetry step of the one-hot DLRM (one width):
    K1, K2, K4 and K3 once, K13, K14 (the pool) and K15 once."""
    want = {name: 0 for name in kernel_fns()}
    want.update(gather_combine=1, dot_interact_fwd=1, dot_interact_bwd=1,
                sgd_scatter=1, cms_update=1, topk_pool=1, topk_merge=1,
                pack_ids=1, pack_columns=1)
    return {k: v * launches for k, v in want.items()}


def pool_edge_streams(rng):
    """Small ``(name, ids, live, k_pool)`` streams at the edges of K14's
    candidate pool (int32 ids, bool live)."""
    pad = 2 ** 31 - 1
    out = []

    def add(name, ids, live, k_pool):
        out.append((name, np.asarray(ids, np.int64).astype(np.int32),
                    np.asarray(live, bool), k_pool))

    ids = np.concatenate([-rng.integers(1, 30, 400),
                          rng.integers(0, 20, 400)])
    add("negative ids", ids, rng.random(800) < 0.85, 10)
    ids = np.concatenate([np.full(60, pad), rng.integers(0, 300, 600)])
    ids = rng.permutation(ids)
    ids[0] = pad
    live = rng.random(ids.size) < 0.8
    live[0] = True
    add("live INT32_MAX first", ids, live, 10)
    live = live.copy()
    live[0] = False
    add("dead pad-valued position first", ids, live, 10)
    ids = rng.permutation(np.concatenate([
        np.repeat(rng.permutation(300)[:6], 9),
        np.repeat(300 + rng.permutation(300)[:14], 5)]))
    add("estimate ties across the boundary", ids, np.ones(ids.size), 10)
    add("k_pool above the distinct ids", rng.integers(0, 4, 40),
        rng.random(40) < 0.9, 10)
    add("n == 1", [7], [True], 1)
    add("n == 1, dead", [7], [False], 1)
    ends = np.array([-2 ** 31, -2 ** 31 + 1, -1, 0, pad - 2, pad - 1, pad])
    add("ids at both ends of int32",
        np.concatenate([rng.choice(ends, 300),
                        rng.integers(-2 ** 31, pad, 100)]),
        rng.random(400) < 0.9, 16)
    ids = (rng.zipf(1.25, 200_000) - 1) % 20_000
    add("Zipfian, ~19 positions a distinct id", ids,
        rng.random(ids.size) < 0.95, 128)
    add("all live and distinct", rng.permutation(400_000)[:100_000] - 200_000,
        np.ones(100_000), 128)
    add("all dead", rng.integers(0, 9, 5_000), np.zeros(5_000), 128)
    return out


def pool_edge_checks(torch, cfg):
    """K14's pool against ``topk_pool_plain`` on the card, bit-exact, at
    the streams of ``pool_edge_streams``, over a sketch each stream has
    folded (and, for the largest pool, at the kernel's limit)."""
    from distributed_embeddings_torch.ops import sketch as sk

    rng = np.random.default_rng(SEED + 160)
    streams = pool_edge_streams(rng)
    name, ids, live, _ = streams[-3]
    streams.append((f"{name}, the largest pool", ids, live, sk._pool_max()))
    for name, ids, live, k_pool in streams:
        cms = torch.as_tensor(rng.integers(0, 3, (cfg.depth, cfg.buckets)),
                              dtype=torch.int32, device="cuda")
        ti = torch.as_tensor(ids, device="cuda")
        tl = torch.as_tensor(live, device="cuda")
        sk.cms_update_plain(cms, ti, tl)
        got = sk.topk_pool(cms, ti, tl, k_pool)
        want = sk.topk_pool_plain(cms, ti, tl, k_pool)
        exact(torch, got, want, f"topk_pool edge case '{name}'")
        log(f"  topk_pool edge case '{name}' (n {ids.size}, k_pool "
            f"{k_pool}): bit-exact, {int((got != sk.PAD).sum())} ids "
            f"{'and the pad id ' if bool((got == sk.PAD).any()) else ''}"
            f"in the pool")
    return len(streams)


def telemetry_checks(torch, de, st, sizes, cfg):
    """The telemetry path held on the card (see ``phase_telemetry``).
    Returns the state and the errors (0: bitwise)."""
    from distributed_embeddings_torch.analysis import telemetry as tel
    from distributed_embeddings_torch.parallel import optimizers

    step_on = telemetry_step(de, cfg)
    step_off = telemetry_step(de, None)
    batches = [train_batch(torch, sizes, TELEM_BATCH, SEED + 131 + i)
               for i in range(TELEM_CHECK_STEPS)]
    # (a) K13-K15 against their plain versions over three steps: the
    # telemetry state is the ids' alone, so each run trains its own copy
    ref = clone_state(st)
    tk, tp = (tel.init_telemetry(de, cfg, device="cuda") for _ in range(2))
    for i, (cats, batch) in enumerate(batches):
        zero_counts()
        _, st, tk = step_on(st, cats, batch, tk)
        torch.cuda.synchronize()
        got = read_counts()
        check(got == telemetry_per_step(1), f"telemetry step {i}: "
              f"launches {got}, expected {telemetry_per_step(1)}")
        zero_counts()
        with plain_kernels(TELEMETRY_SITES):
            _, ref, tp = step_on(ref, cats, batch, tp)
        torch.cuda.synchronize()
        got = read_counts()
        want = dict(telemetry_per_step(1), cms_update=0, topk_pool=0,
                    topk_merge=0)
        check(got == want, f"telemetry step {i} (plain K13-K15): "
              f"launches {got}, expected {want}")
        telem_equal(torch, tk, tp, f"telemetry step {i} kernels vs plain")
    live = TELEM_CHECK_STEPS * len(sizes) * TELEM_BATCH
    check(float(tk["ids_total"][0, 0]) == live and int(tk["steps"][0, 0])
          == TELEM_CHECK_STEPS, f"telemetry: ids_total "
          f"{float(tk['ids_total'][0, 0])} != {live}")
    log(f"  telemetry: {TELEM_CHECK_STEPS} steps with K13-K15 and with "
        f"their plain versions: cms, topk_ids, topk_est, ids, steps and "
        f"ids_total bitwise equal; {live} ids counted")
    del ref, tp
    # (b) telemetry on against off, in lockstep from one state: losses,
    # dense params and K3's inputs bitwise; the slab within the order of
    # K3's atomic adds (rows hit once bitwise)
    telem = tel.init_telemetry(de, cfg, device="cuda")
    slab_bitwise = True
    worst = 0.0
    for i, (cats, batch) in enumerate(batches):
        off = clone_state(st)
        before = st.emb_params["w128"][0].clone()
        with record_calls(optimizers, "sgd_scatter", keep_out=False) as kon:
            loss_on, st, telem = step_on(st, cats, batch, telem)
        with record_calls(optimizers, "sgd_scatter", keep_out=False) as koff:
            loss_off, off = step_off(off, cats, batch)
        torch.cuda.synchronize()
        check(torch.equal(loss_on, loss_off), f"telemetry on/off step {i}: "
              f"loss {float(loss_on)} != {float(loss_off)}")
        check(all(torch.equal(a, b) for a, b in zip(
            st.dense_params.parameters(), off.dense_params.parameters())),
            f"telemetry on/off step {i}: dense params differ")
        (a_on, _), (a_off, _) = kon[0][:2], koff[0][:2]
        for x, y in zip(a_on[1:3], a_off[1:3]):
            exact(torch, x, y, f"telemetry on/off step {i}: K3's inputs")
        streams = [(None, None, (a_on[1], a_on[2]))]
        hits, mag = stream_bounds(torch, streams, before)
        bad, err = slab_misses(torch, st.emb_params["w128"][0],
                               off.emb_params["w128"][0], hits, mag)
        check(bad == 0, f"telemetry on/off step {i}: {bad} slab values "
              f"beyond K3's atomic-order bound (max err {err})")
        worst = max(worst, err)
        slab_bitwise &= torch.equal(st.emb_params["w128"],
                                    off.emb_params["w128"])
        del off, before, hits, mag, streams
    log(f"  telemetry on vs off, {TELEM_CHECK_STEPS} lockstep steps: losses,"
        f" dense params and K3's inputs bitwise equal; slab "
        f"{'bitwise equal' if slab_bitwise else 'within K3 atomic order'} "
        f"(max err {worst})")
    # (c) the guard: a NaN batch leaves the train state bitwise unchanged
    # and still folds its ids, exactly as the plain fold of those ids
    guarded = telemetry_step(de, cfg, nan_guard=True)
    cats, batch = train_batch(torch, sizes, TELEM_BATCH, SEED + 139,
                              nan=True)
    slab0 = st.emb_params["w128"].clone()
    dense0 = [p.detach().clone() for p in st.dense_params.parameters()]
    step0 = int(st.step)
    want = clone_tree(telem)
    with torch.no_grad(), plain_kernels(TELEMETRY_SITES):
        _, res = de.forward_with_residuals(st.emb_params, cats)
        de.update_telemetry(tel.local_state(want), res, cfg)
    loss, st, telem = guarded(st, cats, batch, telem)
    torch.cuda.synchronize()
    check(not bool(torch.isfinite(loss)), "telemetry NaN batch: finite loss")
    check(torch.equal(st.emb_params["w128"], slab0), "telemetry NaN batch: "
          "the slab changed")
    check(all(torch.equal(p, q) for p, q in zip(
        st.dense_params.parameters(), dense0)),
        "telemetry NaN batch: dense params changed")
    check(int(st.step) == step0 + 1, "telemetry NaN batch: step did not "
          "advance")
    telem_equal(torch, telem, want, "telemetry NaN batch")
    log("  telemetry NaN batch (guard on): slab, dense params bitwise "
        "unchanged, step advanced, ids folded (bitwise the plain fold)")
    del slab0, dense0, want
    # (d) planted hot rows: each planted row ranks first in its table
    telem = tel.init_telemetry(de, cfg, device="cuda")
    rng = np.random.default_rng(SEED + 140)
    for i in range(TELEM_CHECK_STEPS):
        cats, batch = train_batch(torch, sizes, TELEM_BATCH, SEED + 141 + i)
        for t, row in TELEM_PLANTED.items():
            at = torch.as_tensor(rng.permutation(TELEM_BATCH)[
                :TELEM_BATCH // 2], device="cuda")
            cats[t][at] = row
        _, st, telem = step_on(st, cats, batch, telem)
    hot = tel.hot_rows(de, telem)
    for t, row in TELEM_PLANTED.items():
        check(t in hot and hot[t][0][0] == row, f"telemetry: planted row "
              f"{row} of table {t} not first: {hot.get(t, [])[:3]}")
        check(hot[t][0][1] >= TELEM_CHECK_STEPS * TELEM_BATCH // 2,
              f"telemetry: planted row {row} undercounted {hot[t][0]}")
    lb = tel.load_balance(telem)
    check(lb["per_rank_ids"] == [float(live)] and lb["steps"] ==
          TELEM_CHECK_STEPS, f"telemetry load balance {lb}")
    log(f"  telemetry planted hot rows first in their tables: "
        f"{ {t: hot[t][0] for t in TELEM_PLANTED} }; load {lb}")
    return st, {"cms_update": 0.0, "cms_query": 0.0, "topk_merge": 0.0}


def telemetry_timed(torch, de, st, sizes, cfg):
    """``run_telemetry_overhead``: the step timed with telemetry off and
    on, host clock over TELEM_STEPS steps after TELEM_WARMUP, the same
    batch each step, in the order off, on, on, off (each mode's time is
    the mean of its two runs); launches counted over the timed
    on-steps."""
    from distributed_embeddings_torch.analysis import telemetry as tel

    cats, batch = train_batch(torch, sizes, TELEM_BATCH, SEED + 150)
    runs = {"off": [], "on": []}
    launches = None
    for on in (False, True, True, False):
        step = telemetry_step(de, cfg if on else None)
        extra = (tel.init_telemetry(de, cfg, device="cuda"),) if on else ()
        for _ in range(TELEM_WARMUP):
            loss, st, *extra = step(st, cats, batch, *extra)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(TELEM_STEPS):
            loss, st, *extra = step(st, cats, batch, *extra)
        torch.cuda.synchronize()
        runs["on" if on else "off"].append(
            (time.perf_counter() - t0) / TELEM_STEPS)
        if on:
            launches = read_counts()
            check(launches == telemetry_per_step(TELEM_STEPS),
                  f"telemetry timed launches {launches}, expected "
                  f"{telemetry_per_step(TELEM_STEPS)}")
        check(bool(torch.isfinite(loss)), f"telemetry timed loss {loss}")
    off, on = (float(np.mean(runs[k])) for k in ("off", "on"))
    metrics = {
        "telemetry_off_samples_per_sec": TELEM_BATCH / off,
        "telemetry_samples_per_sec": TELEM_BATCH / on,
        "telemetry_overhead_frac": on / off - 1.0,
        "step_ms_off": off * 1e3, "step_ms_on": on * 1e3,
        "step_ms_runs": {k: [t * 1e3 for t in v] for k, v in runs.items()},
        "sketch": dict(cfg._asdict()), "batch": TELEM_BATCH,
        "steps": TELEM_STEPS}
    return st, launches, metrics


SKETCH_KERNELS = ("cms_update_kernel", "pool_insert_kernel",
                  "pool_select_kernel", "topk_merge_kernel")
SKETCH_CHAIN = re.compile(r"namespace\)::(" + "|".join(SKETCH_KERNELS)
                          + r")[<(]")


def telemetry_profile(torch, de, st, sizes, cfg, steps=5):
    """``torch.profiler`` over a few telemetry steps (as ``zoo_profile``):
    the device's busy time against the window, the top kernels, and
    K13-K15's launch chain (csrc/sketch.cu) per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distributed_embeddings_torch.analysis import telemetry as tel

    step = telemetry_step(de, cfg)
    telem = tel.init_telemetry(de, cfg, device="cuda")
    cats, batch = train_batch(torch, sizes, TELEM_BATCH, SEED + 150)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            _, st, telem = step(st, cats, batch, telem)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    dev = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            dev[e.key] = e.self_device_time_total / 1e3
    busy = sum(dev.values())
    chain = {}
    for key, ms in dev.items():
        m = SKETCH_CHAIN.search(key)
        if m:
            chain[m.group(1)] = chain.get(m.group(1), 0.0) + ms / steps
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    out = {"steps": steps, "window_ms_per_step": window / steps,
           "device_busy_ms_per_step": busy / steps,
           "device_busy_share": busy / window,
           "sketch_chain_ms_per_step": chain,
           "top_device_ms_per_step": [(k[:60], v / steps) for k, v in top]}
    log("telemetry profile: " + json.dumps(out))
    check(busy > 0, "telemetry profile: the trace holds no device time")
    check(set(chain) == set(SKETCH_KERNELS), f"telemetry profile: the "
          f"sketch chain is incomplete in the trace: {chain}")
    return st, out


DEVICE_FN = re.compile(r"::(\w+(?:<[^<>()]*>)?)\(")


def pool_split(torch, cms, ids, live, k_pool, calls=10):
    """K14's pool call split by what it runs on the device:
    ``torch.profiler`` over ``calls`` calls, each kernel's (and memset's)
    device ms and launches a call, by name; and the wrapper's host ms a
    call (median of the calls' host clock, no synchronize between)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distributed_embeddings_torch.ops import sketch as sk

    sk.topk_pool(cms, ids, live, k_pool)
    torch.cuda.synchronize()
    stages = {}
    # the tracer has come back without device events in one run of
    # several: try again, and report the split as not measured after three
    for _ in range(3):
        host = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                t0 = time.perf_counter()
                sk.topk_pool(cms, ids, live, k_pool)
                host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if (e.device_type != DeviceType.CUDA
                    or e.self_device_time_total <= 0):
                continue
            m = DEVICE_FN.search(e.key)
            name = m.group(1) if m else e.key[:40]
            ms, n = stages.get(name, (0.0, 0.0))
            stages[name] = (ms + e.self_device_time_total / 1e3 / calls,
                            n + e.count / calls)
        if stages:
            break
    if not stages:
        log("pool split: not measured (three traces held no device time)")
        return {"stages_ms": None,
                "host_ms_per_call": float(np.median(host))}
    return {"stages_ms": {k: v[0] for k, v in stages.items()},
            "launches_by_stage": {k: v[1] for k, v in stages.items()},
            "launches_per_call": sum(v[1] for v in stages.values()),
            "device_ms_per_call": sum(v[0] for v in stages.values()),
            "host_ms_per_call": float(np.median(host))}


def sketch_kernel_times(torch, ids, live, cfg, what):
    """CUDA-event medians of K13, K14 (the query alone, and the candidate
    pool with its split by launch) and K15 on one width's telemetry
    stream (``ids``, ``live``), each held bitwise to its plain version
    first, beside its plain version, a PyTorch yardstick and its byte
    bound (each input read once, each output written once). The live
    count is held to the exact count, rounded once to float32."""
    from distributed_embeddings_torch.ops import _kernels
    from distributed_embeddings_torch.ops import sketch as sk

    n = ids.numel()
    k_pool = min(cfg.candidates, n)
    sketch_bytes = cfg.depth * cfg.buckets * 4
    fresh = lambda: torch.zeros((cfg.depth, cfg.buckets),  # noqa: E731
                                dtype=torch.int32, device="cuda")
    # bitwise: one fold from a fresh state, kernels against plain
    ck, cp = fresh(), fresh()
    counts = sk.cms_update(ck, ids, live)
    pcounts = sk.cms_update_plain(cp, ids, live)
    exact(torch, ck, cp, f"cms_update {what}")
    n_live = int(live.sum())
    check(int(counts.sum()) == int(pcounts.sum()) == n_live,
          f"cms_update {what}: live count {int(counts.sum())} != {n_live}")
    pool = sk.topk_pool(ck, ids, live, k_pool)
    exact(torch, pool, sk.topk_pool_plain(cp, ids, live, k_pool),
          f"topk_pool {what}")
    exact(torch, sk.cms_query(ck, ids), sk.cms_query_plain(cp, ids),
          f"cms_query {what}")
    tstate = lambda: (torch.full((cfg.topk,), -1, dtype=torch.int32,  # noqa
                                 device="cuda"),
                      torch.zeros(cfg.topk, dtype=torch.int32,
                                  device="cuda"),
                      torch.zeros(1, device="cuda"))
    kt, pt = tstate(), tstate()
    cnt = sk.topk_merge(ck, pool, counts, *kt, cfg.candidates)
    sk.topk_merge_plain(cp, pool, pcounts, *pt, cfg.candidates)
    for a, b in zip(kt, pt):
        exact(torch, a, b, f"topk_merge {what}")
    check(float(cnt) == float(np.float32(n_live)), f"topk_merge {what}: "
          f"count {float(cnt)} is not {n_live} rounded once")
    cases = {}
    # K13
    flat = sk._flat(sk.buckets_of_plain(torch.where(live, ids, 0),
                                        cfg.depth, cfg.buckets),
                    cfg.buckets)
    inc = live.to(torch.int32)[None].expand(cfg.depth, -1).reshape(-1)
    sketch = fresh()
    ms = time_ms(torch, lambda: sk.cms_update(sketch, ids, live), [()])
    plain = time_ms(torch, lambda: sk.cms_update_plain(sketch, ids, live),
                    [()])
    lib = time_ms(torch, lambda: sketch.view(-1).index_add_(0, flat, inc),
                  [()])
    nbytes = n * 5 + 2 * sketch_bytes
    cases["cms_update"] = dict(
        case=f"{what}: {n} positions ({n_live} live), sketch "
        f"{cfg.depth}x{cfg.buckets}", ms=ms, plain_ms=plain, library_ms=lib,
        library="index_add_ on precomputed flat indices",
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        bytes=nbytes)
    del flat, inc
    # K14: the pool (sort, score, select) and the standalone query
    keys = torch.where(live, ids, sk.PAD)
    ms = time_ms(torch, lambda: sk.topk_pool(ck, ids, live, k_pool), [()])
    plain = time_ms(torch, lambda: sk.topk_pool_plain(ck, ids, live, k_pool),
                    [()])

    def lib_pool():
        u, c = torch.unique(keys, return_counts=True)
        return u[torch.topk(c, min(k_pool, u.numel())).indices]

    lib = time_ms(torch, lib_pool, [()])
    nbytes = n * 5 + sketch_bytes + k_pool * 4
    split = pool_split(torch, ck, ids, live, k_pool)
    klib = _kernels.library("sketch")
    scratch = klib.detpu_topk_pool_scratch_bytes(n, k_pool)
    cleared = klib.detpu_topk_pool_clear_bytes(n)
    pool_case = dict(
        case=f"{what}: pool of {k_pool} from {n} positions", ms=ms,
        plain_ms=plain, library_ms=lib,
        library="torch.unique + torch.topk (sort and select; no sketch "
        "query, not tie-exact)", bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", bytes=nbytes, scratch_bytes=scratch,
        cleared_bytes=cleared,
        distinct_live=int(torch.unique(keys[keys != sk.PAD]).numel()),
        split=split)
    log(f"topk_pool {what} split: scratch {scratch} B, memset {cleared} B, "
        + json.dumps(split))
    del keys
    ms = time_ms(torch, lambda: sk.cms_query(ck, ids), [()])
    plain = time_ms(torch, lambda: sk.cms_query_plain(ck, ids), [()])
    cols = sk._flat(sk.buckets_of_plain(ids.clamp(min=0), cfg.depth,
                                        cfg.buckets), cfg.buckets)
    lib = time_ms(torch, lambda: torch.amin(
        ck.view(-1)[cols].view(cfg.depth, -1), 0), [()])
    del cols
    nbytes = n * 8 + sketch_bytes
    query_case = dict(
        case=f"{what}: query of {n} ids", ms=ms, plain_ms=plain,
        library_ms=lib, library="gather + amin on precomputed columns",
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        bytes=nbytes)
    cases["cms_query"] = [pool_case, query_case]
    # K15
    ms = time_ms(torch, lambda: sk.topk_merge(ck, pool, counts, *kt,
                                              cfg.candidates), [()])
    plain = time_ms(torch, lambda: sk.topk_merge_plain(
        ck, pool, pcounts, *pt, cfg.candidates), [()])
    all_est = torch.cat([kt[1], pool])

    def lib_merge():
        torch.unique(pool)
        return torch.topk(all_est, cfg.topk)

    lib = time_ms(torch, lib_merge, [()])
    nbytes = (sketch_bytes + k_pool * 4 + counts.numel() * 8
              + cfg.topk * 16 + 8)
    cases["topk_merge"] = dict(
        case=f"{what}: pool {k_pool} into top {cfg.topk}", ms=ms,
        plain_ms=plain, library_ms=lib,
        library="torch.unique + torch.topk (not tie-exact)",
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        bytes=nbytes)
    for name, c in (("cms_update", cases["cms_update"]),
                    ("topk_pool", pool_case), ("cms_query", query_case),
                    ("topk_merge", cases["topk_merge"])):
        log(f"time {name} {c['case']}: kernel {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f}, bound "
            f"{c['bound_ms']:.5f}")
    return cases


def phase_telemetry(torch):
    """Access telemetry on ``bench.py:run_telemetry_overhead``'s
    configuration: the one-hot DLRM over the 26 Criteo-Kaggle vocabularies
    capped at 2M rows (10,569,296 rows, 2.7 GB of bf16 tables), bf16
    compute, ``SparseSGD`` + SGD at lr 0.005, batch 16384, guard off,
    one Zipfian id a table, the default sketch (4 x 2048, top 32, 128
    candidates): the checks of ``telemetry_checks``, the step timed with
    telemetry off and on, and K13-K15 timed at the step's stream."""
    from distributed_embeddings_torch.analysis import telemetry as tel

    t_phase = time.perf_counter()
    log(f"telemetry: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        "at the start of the phase")
    sizes = ragged_sizes()
    cfg = tel.config_from_env()
    t0 = time.perf_counter()
    de, st = telemetry_model(torch, SEED + 130)
    torch.cuda.synchronize()
    slab = st.emb_params["w128"]
    check(tuple(slab.shape) == (1, sum(sizes), 128),
          f"telemetry slab shape {tuple(slab.shape)}")
    log(f"telemetry: capped Criteo-Kaggle one-hot DLRM, slab "
        f"{tuple(slab.shape)} bf16 = {slab.numel() * 2 / 1e9:.2f} GB, built "
        f"in {time.perf_counter() - t0:.1f} s; sketch {cfg}")
    log(f"telemetry: {pool_edge_checks(torch, cfg)} K14 pool edge cases "
        "bit-exact")
    st, errs = telemetry_checks(torch, de, st, sizes, cfg)
    st, launches, metrics = telemetry_timed(torch, de, st, sizes, cfg)
    log(json.dumps({k: metrics[k] for k in (
        "telemetry_off_samples_per_sec", "telemetry_samples_per_sec",
        "telemetry_overhead_frac")}))
    log(f"telemetry: step {metrics['step_ms_off']:.3f} ms off, "
        f"{metrics['step_ms_on']:.3f} ms on (runs off, on, on, off: "
        f"{metrics['step_ms_runs']})")
    st, metrics["profile"] = telemetry_profile(torch, de, st, sizes, cfg)
    cats, _ = train_batch(torch, sizes, TELEM_BATCH, SEED + 150)
    with torch.no_grad():
        _, res = de.forward_with_residuals(st.emb_params, cats)
    ids, live = de.telemetry_streams(res)[128]
    cases = sketch_kernel_times(torch, ids, live, cfg,
                                f"one-hot b{TELEM_BATCH}")
    metrics["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"telemetry: phase done in {metrics['phase_s']:.1f} s, peak memory "
        f"{metrics['peak_memory_gb']:.1f} GB")
    del st, de, res, ids, live
    gc.collect()
    torch.cuda.empty_cache()
    return {"telemetry": launches}, errs, cases, metrics


# ------------------------------------------------------------------ streaming

STREAM_SITES = ("remap_stage", "commit_rows")  # the call sites of K16-K17
#: the five Criteo-Kaggle features whose vocabularies pass the 2M cap
#: (bench.py:63-67), served from 2M rows each by admission
STREAM_OVERCAP = (2, 3, 11, 15, 20)
STREAM_CAPACITY = 1_882_353    # KAGGLE_CAP = capacity + capacity // 16
STREAM_BUCKETS = KAGGLE_CAP - STREAM_CAPACITY
STREAM_LR = 0.01               # SparseAdagrad at the zoo's lr
STREAM_BATCHES = 4             # distinct batches the timed steps cycle over
STREAM_QPS = 300.0             # Zipfian requests a second, for 1 s
#: bench.py:run_streaming with SMOKE off
BENCH_VOCAB = 400_000
BENCH_CAPACITY = BENCH_VOCAB // 8
BENCH_BUCKETS = max(64, BENCH_CAPACITY // 16)
BENCH_DIM = 16
BENCH_BATCH = 4096
BENCH_STEPS = 200
BENCH_DRIFT = 0.15
BENCH_LOCKSTEP = 5


def stream_config():
    from distributed_embeddings_torch.parallel import StreamingConfig

    return StreamingConfig(admit_min_count=2, evict_margin=1, depth=4,
                           buckets=4096)


def same_bits(torch, got, want, what):
    """Bitwise equality where a NaN equals a NaN (a claimed row holding
    an Inf resets to NaN on both sides); returns the max abs error over
    the finite values."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {got.dtype} {tuple(got.shape)} != {want.dtype} "
          f"{tuple(want.shape)}")
    if got.is_floating_point():
        g, w = got.float(), want.float()
        ok = bool(((g == w) | (torch.isnan(g) & torch.isnan(w))).all())
        fin = torch.isfinite(g) & torch.isfinite(w)
        err = float((g[fin] - w[fin]).abs().max()) if fin.any() else 0.0
    else:
        ok = bool(torch.equal(got, want))
        err = float((got.double() - want.double()).abs().max()) \
            if got.numel() else 0.0
    check(ok, f"{what}: differs from the plain version (max err {err})")
    return err


def stream_per_step(k16=1, k17=1, ro=0):
    """K16 (update), K13 and K17 launches of ``k16``/``k17`` streaming
    steps (one width) and ``ro`` read-only remaps."""
    return dict(remap_stage=k16 + ro, cms_update=k16, commit_rows=k17)


@contextlib.contextmanager
def stream_checks(torch, errs, what, before_commit=None):
    """Hold every K16 and K17 call of the streaming path (the module
    globals ``parallel.streaming.remap_stage``/``commit_rows``) to its
    plain version on the same inputs, right where the step calls it:
    K16's outputs and the staged sketch K13 folded, bit-exact; K17's
    slab, leaves, slot map, sketch, totals, counters and steps, bitwise
    (a NaN equals a NaN). ``before_commit()`` runs before each K17."""
    from distributed_embeddings_torch.ops import streaming as sops
    from distributed_embeddings_torch.parallel import streaming as smod

    real_remap, real_commit = smod.remap_stage, smod.commit_rows
    calls = {"remap": 0, "commit": 0}

    def clone(a):
        return a.clone() if torch.is_tensor(a) else a

    def remap(*args, **kw):
        ins = [clone(a) for a in args]
        out = real_remap(*args, **kw)
        want = sops.remap_stage_plain(*ins, **kw)
        for f in sops.Remap._fields:
            g, w = getattr(out, f), getattr(want, f)
            if w is not None:
                errs["remap_stage"] = max(errs.get("remap_stage", 0.0),
                                          same_bits(torch, g, w,
                                                    f"{what} K16 {f}"))
        if args[8] is not None:
            same_bits(torch, args[8], ins[8], f"{what} K16 staged sketch")
        calls["remap"] += 1
        calls["positions"] = args[0].numel()
        return out

    def commit(slab, leaves, pend, *rest, enable=None, finalize=True):
        if before_commit is not None:
            before_commit()
        ws, wl = slab.clone(), [(t.clone(), f) for t, f in leaves]
        wrest = [[clone(x) for x in a] if isinstance(a, list) else clone(a)
                 for a in rest]
        sops.commit_rows_plain(ws, wl, pend, *wrest, enable=enable,
                               finalize=finalize)
        real_commit(slab, leaves, pend, *rest, enable=enable,
                    finalize=finalize)
        got = [slab] + [t for t, _ in leaves] + list(rest[:5]) + list(
            rest[5]) + [rest[6]]
        want = [ws] + [t for t, _ in wl] + list(wrest[:5]) + list(
            wrest[5]) + [wrest[6]]
        for k, (g, w) in enumerate(zip(got, want)):
            errs["commit_rows"] = max(errs.get("commit_rows", 0.0),
                                      same_bits(torch, g, w,
                                                f"{what} K17 output {k}"))
        del ws, wl, wrest
        calls["commit"] += 1

    smod.remap_stage, smod.commit_rows = remap, commit
    try:
        yield calls
    finally:
        smod.remap_stage, smod.commit_rows = real_remap, real_commit


def stream_kernel_checks(torch):
    """K16 and K17 against their plain versions on the card, bit-exact,
    at the edge cases of a small slot map (64 rows: a 20-slot table with
    4 buckets at row 0 and a 1-slot table with 3 buckets at row 32),
    each case checking the outcome it is named for. Returns the max
    abs errors (0)."""
    from distributed_embeddings_torch.ops import streaming as sops

    dev, rows_cap, w = "cuda", 64, 8
    tabs = {0: (20, 4, 3, 0), 1: (1, 3, 8, 32)}  # cap, nb, tid, roff
    errs = {}

    def where(ids, t):
        """``(row, fp)`` of external ids in table ``t`` (plain hashes)."""
        cap, nb, tid, roff = tabs[t]
        e = torch.as_tensor(ids)
        tt = torch.full(e.shape, tid, dtype=torch.int32)
        slot, _ = sops.slot_bucket_plain(e, tt, torch.full_like(tt, cap),
                                         torch.full_like(tt, nb))
        return (roff + slot).tolist(), sops.fingerprint_plain(e, tt).tolist()

    def run(name, ext, t, occupy=(), admit=2, margin=1, enable=None,
            slab_dtype=torch.float32, leaves=("acc",), inf_rows=(),
            live=None):
        ext = torch.as_tensor(ext)
        t = torch.as_tensor(t)
        n = ext.numel()
        meta = [torch.as_tensor([tabs[int(k)][j] for k in t],
                                dtype=torch.int32, device=dev)
                for j in range(4)]
        live = (torch.ones(n, dtype=torch.bool) if live is None
                else torch.as_tensor(live)).to(dev)
        out = []
        for use_kernel in (True, False):
            g = torch.Generator(device=dev).manual_seed(7)
            slot_fp = torch.full((rows_cap,), -1, dtype=torch.int32,
                                 device=dev)
            slot_freq = torch.zeros(rows_cap, dtype=torch.int32, device=dev)
            for row, fp, freq in occupy:
                slot_fp[row], slot_freq[row] = fp, freq
            cms = torch.zeros((4, 4096), dtype=torch.int32, device=dev)
            slab = torch.randn(rows_cap, w, generator=g, device=dev).to(
                slab_dtype)
            for r in inf_rows:
                slab[r, 1] = float("inf")
            lv = [(torch.rand(rows_cap, w, generator=g, device=dev) + 0.5,
                   0.1 if leaves == ("acc",) else 0.0) for _ in leaves]
            totals = torch.zeros(4, device=dev)
            counters = [torch.zeros(1, device=dev) for _ in range(4)]
            steps = torch.zeros(1, dtype=torch.int32, device=dev)
            staged = cms.clone()
            remap = sops.remap_stage if use_kernel else sops.remap_stage_plain
            commit = sops.commit_rows if use_kernel else \
                sops.commit_rows_plain
            args = (ext.to(dev), live, *meta, slot_fp, slot_freq)
            ro = remap(*args, None, admit, margin, update=False)
            r = remap(*args, staged, admit, margin)
            en = None if enable is None else torch.tensor(enable,
                                                          device=dev)
            commit(slab, lv, r, slot_fp, slot_freq, cms, staged, totals,
                   counters, steps, enable=en)
            out.append([ro.local_rows] + list(r) + [
                slot_fp, slot_freq, cms, staged, slab, totals, steps]
                + [x for x, _ in lv] + counters)
        for k, (a, b) in enumerate(zip(*out)):
            err = same_bits(torch, a, b, f"streaming edge case {name} "
                            f"output {k}")
            key = "remap_stage" if k < 7 else "commit_rows"
            errs[key] = max(errs.get(key, 0.0), err)
        got = out[0]
        return dict(zip(("admitted", "evicted", "bucket_ids", "hit_ids"),
                        got[6].tolist()), slot_fp=got[7].cpu(),
                    slot_freq=got[8].cpu(), slab=got[11].float().cpu(),
                    steps=int(got[13]), leaves=[x.cpu() for x in got[14:-4]],
                    counters=[float(c) for c in got[-4:]])

    x0 = 10 ** 6
    # free slots: 3 ids twice each claim their free slots, nothing evicted
    c = run("free_slots", [x0, x0, x0 + 1, x0 + 1, x0 + 2, x0 + 2], [0] * 6)
    check(c["admitted"] >= 1 and c["evicted"] == 0 and c["hit_ids"] == 0
          and c["admitted"] == int((c["slot_fp"] >= 0).sum()),
          f"free slots: {c}")
    # a claim below the gate: one sighting each, admit_min_count 3
    c = run("below_gate", [x0 + k for k in range(8)], [0] * 8, admit=3)
    check(c["admitted"] == 0 and c["bucket_ids"] == 8, f"below gate: {c}")
    # eviction at exactly evict_margin, and at one less (occupant freq 4)
    (row,), _ = where([x0 + 5], 1)
    for reps, want in ((6, 1), (5, 0)):
        c = run(f"evict_at_margin_{reps}", [x0 + 5] * reps, [1] * reps,
                occupy=[(row, 12345, 4)], margin=2)
        check(c["evicted"] == want and c["admitted"] == want,
              f"eviction with est {reps} against freq 4 + margin 2: {c}")
    # several ids claim the one-slot table's row with equal est: fp decides
    ids = [x0 + 11, x0 + 12, x0 + 13]
    _, fps = where(ids, 1)
    c = run("equal_est_fp", ids * 3, [1] * 9)
    check(c["admitted"] == 1 and int(c["slot_fp"][32]) == max(fps),
          f"equal est: the winner is the max fingerprint: {c['slot_fp'][32]}"
          f" vs {fps}")
    # equal (est, fp): one id repeated, the position decides (one claim)
    c = run("equal_est_fp_pos", [x0 + 21] * 5, [1] * 5)
    check(c["admitted"] == 1, f"equal (est, fp): {c}")
    # a row hit by its occupant and claimed by another id in one step
    (r1,), (fp_a,) = where([x0 + 31], 1)
    c = run("hit_and_claim", [x0 + 31] + [x0 + 32] * 4, [1] * 5,
            occupy=[(r1, fp_a, 1)])
    check(c["hit_ids"] == 1 and c["evicted"] == 1
          and int(c["slot_freq"][r1]) == 4,
          f"hit and claim: {c} (slot_freq {int(c['slot_freq'][r1])})")
    # dead, negative and int64 ids at and past 2^32 (congruent pairs)
    big = [2 ** 32 + 7, 7, 2 ** 33 + 7, 2 ** 40, 2 ** 40, -3, -(2 ** 40),
           2 ** 32 + 7]
    c = run("dead_negative_int64", torch.tensor(big, dtype=torch.int64),
            [0] * 8, live=[True, True, True, True, True, True, True, False])
    check(c["bucket_ids"] + c["hit_ids"] == 5, f"int64 ids: {c}")
    # enable false: nothing changes, the step does not count
    c = run("enable_false", [x0] * 4, [0] * 4, enable=False)
    check(c["steps"] == 0 and int((c["slot_fp"] >= 0).sum()) == 0
          and c["counters"] == [0.0] * 4, f"enable false: {c}")
    # bf16 slab with an fp32 accumulator; Adam's mu/nu; an Inf row
    (r2,), _ = where([x0 + 40], 0)
    c = run("bf16_slab_fp32_acc", [x0 + 40] * 3, [0] * 3,
            slab_dtype=torch.bfloat16, inf_rows=(r2,))
    check(bool(torch.isnan(c["slab"][r2, 1])) and
          float(c["slab"][r2].nan_to_num().abs().sum()) == 0 and
          bool((c["leaves"][0][r2] == torch.tensor(
              0.1, dtype=torch.float32)).all()),
          f"bf16 slab: the claimed Inf row {c['slab'][r2]}")
    c = run("adam_mu_nu", [x0 + 40] * 3, [0] * 3, leaves=("mu", "nu"))
    check(all(float(x[r2].abs().sum()) == 0 for x in c["leaves"]),
          "adam: mu/nu of the claimed row not reset")
    log(f"streaming: K16 and K17 against their plain versions in 11 edge "
        f"cases (free slots, below the gate, eviction at the margin and one "
        f"less, equal est, equal (est, fp), hit and claim, dead/negative/"
        f"int64 ids, enable false, bf16 slab over fp32 accumulators, Adam "
        f"mu/nu, an Inf row): bit-exact, outcomes as named")
    return errs


# -------------------------------------------- 12b: bench.py:run_streaming


def bench_dense(torch):
    """The bench's dense half: one scalar ``s``, initialized to 1."""
    m = torch.nn.Module()
    m.s = torch.nn.Parameter(torch.ones((), device="cuda"))
    return m


def bench_stream_batch(logits, day, i):
    """``run_streaming``'s ``day_batch``: Zipfian ids over the vocab (day
    k+1: a drift fraction of never-seen ids past it) and labels drawn
    from the planted per-id logit."""
    from distributed_embeddings_torch.utils.data import power_law_ids

    r = np.random.default_rng(1000 * day + i)
    ids = power_law_ids(r, BENCH_VOCAB, (BENCH_BATCH,)).astype(np.int64)
    if day > 0:
        fresh = r.random(BENCH_BATCH) < BENCH_DRIFT
        ids = np.where(fresh, BENCH_VOCAB + power_law_ids(
            r, BENCH_VOCAB, (BENCH_BATCH,)), ids)
    y = (r.random(BENCH_BATCH) < 1.0 / (1.0 + np.exp(-logits[ids]))
         ).astype(np.float32)
    return ids, y


def bench_loss(dense, outs, y):
    from distributed_embeddings_torch.models import bce_with_logits

    logit = outs[0].sum(dim=-1) * dense.s + 0.0 * outs[1].sum()
    return bce_with_logits(logit, y)


def bench_pred(dense, outs, y):
    return outs[0].sum(dim=-1) * dense.s


def bench_model(torch, dynamic):
    from distributed_embeddings_torch.parallel import (
        SGD, DistributedEmbedding, SparseAdagrad, init_hybrid_state)

    if dynamic:
        configs = [{"input_dim": BENCH_CAPACITY + BENCH_BUCKETS,
                    "output_dim": BENCH_DIM,
                    "streaming": {"capacity": BENCH_CAPACITY,
                                  "buckets": BENCH_BUCKETS}}]
    else:
        configs = [{"input_dim": 2 * BENCH_VOCAB, "output_dim": BENCH_DIM}]
    configs.append({"input_dim": 100, "output_dim": BENCH_DIM})
    de = DistributedEmbedding(configs, world_size=1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 160)
    st = init_hybrid_state(de, SparseAdagrad(), bench_dense(torch),
                           SGD(0.01), generator=gen, device="cuda")
    return de, st


def state_bytes(tree):
    from torch.utils import _pytree as pytree

    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if hasattr(t, "numel"))


def stream_bench(torch):
    """``bench.py:run_streaming`` at its full size (see ``phase_streaming``).
    Returns ``(metrics, launches of the dynamic timed run)``."""
    from distributed_embeddings_torch.parallel import (
        SGD, SparseAdagrad, init_streaming, make_hybrid_eval_step,
        make_hybrid_train_step)
    from distributed_embeddings_torch.parallel import streaming as smod
    from distributed_embeddings_torch.utils.metrics import binary_auc

    cfg = stream_config()
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(2 * BENCH_VOCAB,)).astype(np.float32) * 2.0
    side = torch.zeros(BENCH_BATCH, dtype=torch.int32, device="cuda")
    data = []
    for i in range(BENCH_STEPS):
        ids, y = bench_stream_batch(logits, 0, i)
        data.append((torch.as_tensor(ids, device="cuda"),
                     torch.as_tensor(y, device="cuda")))
    out, launches = {}, None
    for label, dyn in (("static", None), ("dynamic", cfg)):
        de, st = bench_model(torch, dyn is not None)
        step = make_hybrid_train_step(de, bench_loss, SGD(0.01),
                                      SparseAdagrad(), lr_schedule=0.5,
                                      nan_guard=False, dynamic=dyn)
        aux = (init_streaming(de, cfg, device="cuda"),) if dyn else ()
        for i, (ids, y) in enumerate(data):
            if dyn and i < BENCH_LOCKSTEP:
                # lockstep: the same step from a copy of the state with
                # K16 and K17 through their plain versions
                ref, ref_ss = clone_state(st), clone_tree(aux[0])
                with plain_kernels(STREAM_SITES):
                    rl, ref, ref_ss = step(ref, [ids, side], y, ref_ss)
            if i == BENCH_LOCKSTEP:  # both models clock the same steps
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
            loss, st, *aux = step(st, [ids, side], y, *aux)
            if dyn and i < BENCH_LOCKSTEP:
                same_bits(torch, loss, rl, f"bench lockstep {i} loss")
                telem_equal(torch, aux[0], ref_ss, f"bench lockstep {i}")
                for k in st.emb_params:
                    same_bits(torch, st.emb_params[k], ref.emb_params[k],
                              f"bench lockstep {i} slab {k}")
                    same_bits(torch, st.emb_opt_state[k],
                              ref.emb_opt_state[k],
                              f"bench lockstep {i} accumulators {k}")
                del ref, ref_ss
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if dyn:
            launches = read_counts()
            timed = BENCH_STEPS - BENCH_LOCKSTEP
            want = stream_per_step(timed, timed)
            check_launches({k: launches[k] for k in want}, want,
                           "bench streaming timed run")
        check(bool(torch.isfinite(loss)), f"bench {label}: loss {loss}")
        ev = make_hybrid_eval_step(de, bench_pred, dynamic=dyn)
        scores, labels = [], []
        before = clone_tree(aux[0]) if dyn else None
        zero_counts()
        for i in range(4):
            ids, y = bench_stream_batch(logits, 1, 10_000 + i)
            p = ev(st, [torch.as_tensor(ids, device="cuda"), side], None,
                   *aux)
            scores.append(p.float().cpu().numpy())
            labels.append(y)
        if dyn:
            check_launches({k: read_counts()[k] for k in stream_per_step()},
                           stream_per_step(0, 0, 4), "bench eval")
            telem_equal(torch, aux[0], before, "bench eval leaves the "
                        "streaming state")
        auc = binary_auc(np.concatenate(labels), np.concatenate(scores))
        out[f"{label}_auc_day_k1"] = float(auc)
        out[f"{label}_samples_per_sec"] = BENCH_BATCH * (
            BENCH_STEPS - BENCH_LOCKSTEP) / dt
        out[f"{label}_slab_bytes"] = state_bytes(st.emb_params)
        out[f"{label}_opt_bytes"] = state_bytes(st.emb_opt_state)
        if dyn:
            occ = smod.occupancy(de, aux[0])
            out.update({k: occ[k] for k in ("admitted", "evicted",
                                            "bucket_ids", "hit_ids")})
            out["occupancy_frac"] = occ["tables"][0]["occupancy_frac"]
            out["streaming_state_bytes"] = state_bytes(aux[0])
        del st, de, aux
    out["auc_delta_vs_static"] = (out["dynamic_auc_day_k1"]
                                  - out["static_auc_day_k1"])
    out["bytes_frac_of_static"] = (
        (out["dynamic_slab_bytes"] + out["streaming_state_bytes"])
        / out["static_slab_bytes"])
    out.update(vocab=BENCH_VOCAB, capacity=BENCH_CAPACITY,
               buckets=BENCH_BUCKETS, batch=BENCH_BATCH, steps=BENCH_STEPS,
               drift_frac=BENCH_DRIFT)
    for k in ("admitted", "evicted", "bucket_ids", "hit_ids"):
        check(out[k] > 0, f"bench streaming: no {k}: {out}")
    for k in ("static_auc_day_k1", "dynamic_auc_day_k1"):
        check(0.5 < out[k] <= 1.0, f"bench streaming: {k} {out[k]}")
    log(f"streaming bench: {BENCH_LOCKSTEP} lockstep steps with K16/K17 "
        "and with their plain versions: losses, slabs, accumulators, slot "
        "map, sketch and counters bitwise equal")
    return out, launches


# ----------------------------------------- 12c: the capped DLRM streaming


def check_launches(got, want, what):
    check(got == want, f"{what}: launches {got}, expected {want}")


def stream_dlrm_model(torch, seed):
    """The one-hot DLRM over the 26 Criteo-Kaggle vocabularies at width
    128, fp32 tables, bf16 compute; the five tables past 2M rows
    streaming (capacity 1,882,353 + 117,647 buckets = 2M rows each), and
    the static twin: the same tables without the streaming entries.
    ``SparseAdagrad`` at lr 0.01 + SGD at 0.005, the guard on."""
    from distributed_embeddings_torch.models import DLRMConfig, DLRMDense
    from distributed_embeddings_torch.parallel import (
        SGD, DistributedEmbedding, SparseAdagrad, init_hybrid_state)

    sizes = ragged_sizes()
    cfg = DLRMConfig(table_sizes=sizes, embedding_dim=128,
                     num_numerical_features=13,
                     bottom_mlp_dims=(512, 256, 128),
                     top_mlp_dims=(1024, 1024, 512, 256, 1),
                     compute_dtype=torch.bfloat16)
    static = cfg.embedding_configs()
    dynamic = [dict(c, streaming={"capacity": STREAM_CAPACITY,
                                  "buckets": STREAM_BUCKETS})
               if t in STREAM_OVERCAP else c for t, c in enumerate(static)]
    de = DistributedEmbedding(dynamic, world_size=1,
                              compute_dtype=torch.bfloat16)
    twin = DistributedEmbedding(static, world_size=1,
                                compute_dtype=torch.bfloat16)
    check(de.rows_cap == twin.rows_cap and de.row_offsets_list ==
          twin.row_offsets_list, "the static twin's layout differs")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dense = DLRMDense(cfg, device="cuda", generator=gen)
    st = init_hybrid_state(de, SparseAdagrad(), dense, SGD(TRAIN_LR),
                           generator=gen, dtype=torch.float32,
                           device="cuda")
    return de, twin, st


def stream_dlrm_batch(torch, gen, b, nan=False):
    """One Zipfian id (alpha 1.05) a feature over its FULL Kaggle
    vocabulary (ids past 2M in the five streaming features), N(0, 1)
    numerical features and 0/1 labels, made on the card."""
    cats = [device_power_law(torch, gen, v, b) for v in CRITEO_KAGGLE_SIZES]
    num = torch.randn(b, 13, generator=gen, device="cuda")
    if nan:
        num[b // 2, 3] = float("nan")
    lab = (torch.rand(b, generator=gen, device="cuda") < 0.25).float()
    return cats, (num, lab)


def dlrm_stream_per_step(steps=1):
    """Launches of ``steps`` streaming DLRM steps: K1, K2, K4, K5, K6,
    K16, K13 and K17 once each (one width, the sparse Adagrad regime)."""
    want = {name: 0 for name in kernel_fns()}
    want.update(gather_combine=steps, dot_interact_fwd=steps,
                dot_interact_bwd=steps, dedup_sparse_grad=steps,
                adagrad_rows=steps, remap_stage=steps, cms_update=steps,
                commit_rows=steps, pack_ids=steps, pack_columns=steps)
    return want


def stream_dlrm_checks(torch, de, st, ss, cfg, gen, errs):
    """12c's checked step (K16 and its K13 fold, K5, K6 and K17 each
    against its plain version on the step's own inputs) and its NaN
    batch."""
    from distributed_embeddings_torch.ops import adagrad_rows_plain
    from distributed_embeddings_torch.parallel import SparseAdagrad

    opt = SparseAdagrad()
    step = make_step_with(de, cfg, opt)
    cats, batch = stream_dlrm_batch(torch, gen, TRAIN_BATCH)
    k56 = {}

    def before_commit():
        # the sparse apply has run, the commit has not: K5 and K6 against
        # their plain versions on what the step gave them
        r = seen["w128"]
        slab = st.emb_params["w128"][0]
        acc = st.emb_opt_state["w128"][0]
        rows = slab.shape[0]
        what = "streaming DLRM checked step"
        e5, keep, pos = k5_check(torch, r, rows, what)
        ws, wa = r["slab"].clone(), r["state"].clone()
        adagrad_rows_plain(ws, wa, pos, r["ugrads"][keep], r["lr"], opt.eps)
        gs, ga = slab[r["uniq"]], acc[r["uniq"]]
        check(bool(torch.equal(ga, wa)), f"{what}: adagrad_rows "
              "accumulators differ from the plain update's")
        es = (gs.float() - ws.float()).abs()
        ts = 3 * ulp(torch, r["slab"].float().abs() + STREAM_LR, slab.dtype)
        check(int((es > ts).sum()) == 0, f"{what}: adagrad_rows slab beyond "
              f"3 ulps (max err {float(es.max())})")
        k56.update(dedup_sparse_grad=e5, adagrad_rows=float(es.max()),
                   ids=r["ids"].numel(), unique=len(r["uniq"]))

    with recording(torch, opt) as seen, \
            stream_checks(torch, errs, "streaming DLRM checked step",
                          before_commit) as calls:
        zero_counts()
        loss, st, ss = step(st, cats, batch, ss)
        torch.cuda.synchronize()
        got = read_counts()
    n = calls.pop("positions")
    check(calls == {"remap": 1, "commit": 1}, f"checked step calls {calls}")
    check_launches(got, dlrm_stream_per_step(), "streaming DLRM checked step")
    check(bool(torch.isfinite(loss)), f"streaming DLRM loss {float(loss)}")
    for k in ("dedup_sparse_grad", "adagrad_rows"):
        errs[k] = max(errs.get(k, 0.0), k56[k])
    log(f"streaming DLRM: checked step, loss {float(loss):.5f}; K16 (and "
        f"the K13 fold) bit-exact to the plain remap on the step's own "
        f"{n} streaming positions; K5 max_abs_err "
        f"{k56['dedup_sparse_grad']} on {k56['ids']} ids ({k56['unique']} "
        f"unique), K6 accumulators bit-exact and slab max_abs_err "
        f"{k56['adagrad_rows']} (<= 3 ulps); K17 bitwise on the slab, "
        f"accumulators, slot map, sketch, totals and counters")
    # a NaN batch: the train state and the streaming state bitwise unchanged
    cats, batch = stream_dlrm_batch(torch, gen, TRAIN_BATCH, nan=True)
    before = (clone_tree(st.emb_params), clone_tree(st.emb_opt_state),
              clone_tree(ss),
              [p.detach().clone() for p in st.dense_params.parameters()],
              int(st.step))
    loss, st, ss = step(st, cats, batch, ss)
    check(not bool(torch.isfinite(loss)), "the NaN batch's loss is finite")
    for k in st.emb_params:
        exact(torch, st.emb_params[k], before[0][k], "NaN batch slab")
        exact(torch, st.emb_opt_state[k], before[1][k],
              "NaN batch accumulators")
    telem_equal(torch, ss, before[2], "NaN batch streaming state")
    for p, q in zip(st.dense_params.parameters(), before[3]):
        exact(torch, p.detach(), q, "NaN batch dense params")
    check(int(st.step) == before[4] + 1, "the NaN batch did not advance "
          "the step")
    log("streaming DLRM: a NaN batch left the slab, accumulators, dense "
        "params, slot map, sketch and counters bitwise unchanged; step "
        "advanced")
    del before
    return st, ss


def make_step_with(de, cfg, opt, nan_guard=True):
    from distributed_embeddings_torch.parallel import (
        SGD, make_hybrid_train_step)

    return make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), opt,
                                  lr_schedule=STREAM_LR,
                                  nan_guard=nan_guard, dynamic=cfg)


def stream_dlrm_timed(torch, de, twin, st, ss, cfg, batches):
    """The dynamic step and the static twin's (the same slab tensors; ids
    past 2M clip onto each table's last row), 3 warmup + 20 timed steps
    each, host clock, in the order dynamic, static, static, dynamic;
    launches counted over the first dynamic run."""
    from distributed_embeddings_torch.parallel import SparseAdagrad

    runs = {"dynamic": [], "static": []}
    launches = None
    for label in ("dynamic", "static", "static", "dynamic"):
        dyn = label == "dynamic"
        step = make_step_with(de if dyn else twin, cfg if dyn else None,
                              SparseAdagrad())
        aux = (ss,) if dyn else ()
        for k in range(WARMUP_RUNS):
            cats, batch = batches[k % len(batches)]
            loss, st, *aux = step(st, cats, batch, *aux)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for k in range(TRAIN_STEPS):
            cats, batch = batches[k % len(batches)]
            loss, st, *aux = step(st, cats, batch, *aux)
        torch.cuda.synchronize()
        runs[label].append((time.perf_counter() - t0) / TRAIN_STEPS)
        if dyn and launches is None:
            launches = read_counts()
            check_launches(launches, dlrm_stream_per_step(TRAIN_STEPS),
                           "streaming DLRM timed run")
        check(bool(torch.isfinite(loss)), f"streaming DLRM {label} loss "
              f"{float(loss)}")
    dyn_s, sta_s = (float(np.mean(runs[k])) for k in ("dynamic", "static"))
    metrics = {
        "dynamic_step_ms": dyn_s * 1e3, "static_step_ms": sta_s * 1e3,
        "dynamic_samples_per_sec": TRAIN_BATCH / dyn_s,
        "static_samples_per_sec": TRAIN_BATCH / sta_s,
        "streaming_overhead_frac": dyn_s / sta_s - 1.0,
        "step_ms_runs": {k: [t * 1e3 for t in v] for k, v in runs.items()},
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS}
    return st, ss, launches, metrics


STREAM_KERNELS = ("stream_hash_kernel", "cms_update_kernel",
                  "stream_claim_kernel", "stream_claim_pos_kernel",
                  "stream_outputs_kernel", "commit_scrub_kernel",
                  "commit_hits_kernel", "commit_state_kernel")
STREAM_CHAIN = re.compile(r"namespace\)::(" + "|".join(STREAM_KERNELS)
                          + r")[<(]")


def stream_profile(torch, de, st, ss, cfg, batches, steps=5):
    """``torch.profiler`` over a few streaming DLRM steps (as
    ``telemetry_profile``): the device's busy time against the window,
    the top kernels, K16/K13/K17's launch chain per step, and the host
    time spent in the remap (``_streaming_remap``: the stream's
    assembly, K16, the write-back) and the commit per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distributed_embeddings_torch.parallel import SparseAdagrad
    from distributed_embeddings_torch.parallel import streaming as smod

    step = make_step_with(de, cfg, SparseAdagrad())
    host = {"remap": 0.0, "commit": 0.0}
    real_remap, real_commit = de._streaming_remap, smod.commit

    def timed(key, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            host[key] += (time.perf_counter() - t) * 1e3
            return out
        return wrapper

    de._streaming_remap = timed("remap", real_remap)
    smod.commit = timed("commit", real_commit)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for k in range(steps):
                cats, batch = batches[k % len(batches)]
                _, st, ss = step(st, cats, batch, ss)
            torch.cuda.synchronize()
            window = (time.perf_counter() - t0) * 1e3
    finally:
        del de._streaming_remap
        smod.commit = real_commit
    dev = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            dev[e.key] = e.self_device_time_total / 1e3
    busy = sum(dev.values())
    chain = {}
    for key, ms in dev.items():
        m = STREAM_CHAIN.search(key)
        if m:
            chain[m.group(1)] = chain.get(m.group(1), 0.0) + ms / steps
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
    out = {"steps": steps, "window_ms_per_step": window / steps,
           "device_busy_ms_per_step": busy / steps,
           "device_busy_share": busy / window,
           "stream_chain_ms_per_step": chain,
           "host_ms_per_step": {k: v / steps for k, v in host.items()},
           "top_device_ms_per_step": [(k[:60], v / steps) for k, v in top]}
    log("streaming profile: " + json.dumps(out))
    check(busy > 0, "streaming profile: the trace holds no device time")
    check(set(chain) == set(STREAM_KERNELS), f"streaming profile: the "
          f"K16/K13/K17 chain is incomplete in the trace: {chain}")
    return st, ss, out


def stream_dlrm_serve(torch, de, st, ss, cfg):
    """Zipfian requests over the full vocabularies through
    ``ServingRuntime(streaming=)``: every one ``Served``, a sample equal
    to ``make_hybrid_eval_step(dynamic=)`` on the same inputs, and the
    streaming state left alone."""
    from distributed_embeddings_torch.parallel import (
        ServeConfig, Served, ServingRuntime, drive, make_hybrid_eval_step,
        synthetic_request)

    def pred(d, outs, n):
        return torch.sigmoid(d(n, outs))[:, 0]

    rt = ServingRuntime(de, pred, st, config=ServeConfig(),
                        streaming=(cfg, ss))
    ev = make_hybrid_eval_step(de, pred, dynamic=cfg)
    rng = np.random.default_rng(SEED + 170)
    tmpl = synthetic_request(rng, CRITEO_KAGGLE_SIZES, 2, numerical=13)
    rt.warmup((tmpl.cats, tmpl.batch))
    before = clone_tree(ss)
    sent = {}

    def make_request(i):
        req = synthetic_request(rng, CRITEO_KAGGLE_SIZES,
                                int(rng.integers(1, 9)), numerical=13)
        sent[i] = req
        return req

    zero_counts()
    results = drive(rt, make_request, qps=STREAM_QPS, duration_s=1.0)
    launches = read_counts()
    check(len(sent) >= 200 and len(results) == len(sent) and all(
        isinstance(r, Served) for r in results),
        f"{len(results)} results for {len(sent)} requests, kinds "
        f"{sorted({type(r).__name__ for r in results})}")
    flushes = rt.stats()["flushes"]
    check_launches({k: launches[k] for k in stream_per_step()},
                   stream_per_step(0, 0, flushes),
                   f"streaming serving ({flushes} flushes)")
    worst = 0.0
    for r in results[::max(1, len(results) // 16)]:
        req = sent[r.rid]
        want = ev(st, [torch.as_tensor(c, device="cuda") for c in req.cats],
                  torch.as_tensor(req.batch, device="cuda"), ss)
        err = float(np.abs(np.asarray(r.predictions)
                           - want.float().cpu().numpy()).max())
        worst = max(worst, err)
        check(err <= 2e-2, f"rid {r.rid}: served vs eval step differ by "
              f"{err}")
    telem_equal(torch, ss, before, "serving leaves the streaming state")
    s = rt.stats()
    log(f"streaming DLRM serve: {len(results)} requests Served in "
        f"{flushes} flushes (K16 read-only once a flush), p50 "
        f"{s['latency_p50_ms']:.2f} / p99 {s['latency_p99_ms']:.2f} ms; "
        f"sampled requests match the "
        f"eval step, max abs err {worst} (atol 2e-2: a flush pads to its "
        f"rung, so bf16 GEMMs run at other shapes)")
    return launches, {"served": len(results), "flushes": flushes,
                      "latency_p50_ms": s["latency_p50_ms"],
                      "latency_p99_ms": s["latency_p99_ms"],
                      "max_abs_err_vs_eval": worst}


def stream_kernel_times(torch, de, st, ss, cfg, batches):
    """K16 (update and read-only) and K17 timed on the streaming DLRM
    step's own stream (the 5 streaming features' 327,680 positions),
    beside their plain versions, their byte bounds and a PyTorch
    yardstick."""
    from distributed_embeddings_torch.ops import sketch as sk
    from distributed_embeddings_torch.ops import streaming as sops
    from distributed_embeddings_torch.parallel import streaming as smod

    streams = []
    real = smod.remap_width

    def grab(wstate, stream, rows_cap, config, update=True):
        streams.append(stream)
        return real(wstate, stream, rows_cap, config, update)

    smod.remap_width = grab
    try:
        with torch.no_grad():
            for cats, _ in batches[:2]:
                de.forward_with_residuals(
                    st.emb_params, cats,
                    streaming=(cfg, smod.local_state(ss), False))
    finally:
        smod.remap_width = real
    ws = smod.local_state(ss)["w128"]
    rows_cap = ws["slot_fp"].numel()
    n = streams[0].ext.numel()
    args = [(s.ext, s.live, s.cap, s.nbuckets, s.tid, s.roff,
             ws["slot_fp"], ws["slot_freq"]) for s in streams]
    staged = ws["cms"].clone()
    pol = (cfg.admit_min_count, cfg.evict_margin)
    ro_ms = time_ms(torch, lambda *a: sops.remap_stage(
        *a, None, *pol, update=False), args)
    ro_plain = time_ms(torch, lambda *a: sops.remap_stage_plain(
        *a, None, *pol, update=False), args)
    upd_ms = time_ms(torch, lambda *a: sops.remap_stage(*a, staged, *pol),
                     args)
    upd_plain = time_ms(torch, lambda *a: sops.remap_stage_plain(
        *a, staged.clone(), *pol), args)

    def yardstick(ext, live, cap, nb, tid, roff, slot_fp, slot_freq):
        # part of the function: the sketch query by gather + amin on
        # precomputed columns, and the slot-map gathers
        v = flat[cols].view(cfg.depth, -1).amin(dim=0)
        return v, slot_fp.index_select(0, rows), slot_freq.index_select(
            0, rows)

    key = sops.fingerprint_plain(streams[0].ext, streams[0].tid)
    cols = (sk.buckets_of_plain(key, cfg.depth, cfg.buckets)
            + torch.arange(cfg.depth, device="cuda")[:, None] * cfg.buckets
            ).reshape(-1)
    flat = staged.reshape(-1)
    slot, _ = sops.slot_bucket_plain(streams[0].ext, streams[0].tid,
                                     streams[0].cap, streams[0].nbuckets)
    rows = (streams[0].roff + slot).long()
    lib_ms = time_ms(torch, yardstick, args[:1])
    esz = streams[0].ext.element_size()
    sketch_b = 2 * cfg.depth * cfg.buckets * 4
    ro_bytes = n * (esz + 1 + 16 + 4 + 4)
    upd_bytes = n * (esz + 1 + 16 + 4 + 4 + 4 * 5) + 32 + sketch_b
    # K17 on the first stream's staged transitions
    pend = sops.remap_stage(*args[0], ws["cms"].clone(), *pol)
    claims = int((pend.scrub_rows < rows_cap).sum())
    hits = int((pend.hit_rows < rows_cap).sum())
    slab = st.emb_params["w128"][0]
    acc = st.emb_opt_state["w128"][0]
    totals = torch.zeros(4, device="cuda")
    counters = [torch.zeros(1, device="cuda") for _ in range(4)]
    steps = torch.zeros(1, dtype=torch.int32, device="cuda")
    on = torch.tensor(True, device="cuda")
    slot_fp, slot_freq = ws["slot_fp"].clone(), ws["slot_freq"].clone()
    cms, staged2 = ws["cms"].clone(), ws["cms"].clone()
    c_args = [(slab, [(acc, 0.1)], pend, slot_fp, slot_freq, cms, staged2,
               totals, counters, steps)]
    commit_ms = time_ms(torch, lambda *a: sops.commit_rows(*a, enable=on),
                        c_args)
    commit_plain = time_ms(torch, lambda *a: sops.commit_rows_plain(
        *a, enable=on), c_args)
    commit_bytes = (n * 16 + claims * (2 * 2 * 128 * 4 + 8) + hits * 8
                    + sketch_b + 64)
    cases = {
        "remap_stage": [dict(
            case=f"update, {n} streaming positions of the DLRM step into "
                 f"{rows_cap} slot rows (with its K13 fold)",
            ms=upd_ms, plain_ms=upd_plain, library_ms=lib_ms,
            library="sketch gather + amin and the slot-map gathers "
                    "(partial)",
            bound_ms=upd_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bytes=upd_bytes), dict(
            case=f"read-only, {n} positions", ms=ro_ms, plain_ms=ro_plain,
            library_ms=lib_ms, library="as above (partial)",
            bound_ms=ro_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bytes=ro_bytes)],
        "commit_rows": [dict(
            case=f"{claims} claimed rows (slab and fp32 accumulator, "
                 f"w128), {hits} hits, of {n} positions",
            ms=commit_ms, plain_ms=commit_plain, library_ms=None,
            library="none: no PyTorch call computes the guarded commit",
            bound_ms=commit_bytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", bytes=commit_bytes)]}
    for name, cs in cases.items():
        for c in cs:
            lib = ("none" if c["library_ms"] is None
                   else f"{c['library_ms']:.4f}")
            log(f"time {name} {c['case']}: kernel {c['ms']:.4f} ms, plain "
                f"{c['plain_ms']:.4f}, library {lib}, bound "
                f"{c['bound_ms']:.5f}")
    return cases


def phase_streaming(torch):
    """Streaming vocabularies (``parallel/streaming.py``, K16 and K17 in
    ``csrc/streaming.cu``, K13 for the admission sketch):
    12a. K16/K17 edge cases against their plain versions;
    12b. ``bench.py:run_streaming`` at its full size: day-k training and
         day-k+1 AUC, static against dynamic, the first steps in lockstep
         with K16/K17 through their plain versions;
    12c. the capped Criteo-Kaggle one-hot DLRM (fp32 tables, bf16
         compute, ``SparseAdagrad``) with its five over-cap tables
         streaming: a checked step, a NaN batch, timed steps against the
         static twin, serving, and K16/K17 timed."""
    from distributed_embeddings_torch.parallel import init_streaming
    from distributed_embeddings_torch.parallel import streaming as smod

    t_phase = time.perf_counter()
    errs = stream_kernel_checks(torch)
    bench, bench_launches = stream_bench(torch)
    log("streaming bench: " + json.dumps(bench))
    gc.collect()
    torch.cuda.empty_cache()
    cfg = stream_config()
    t0 = time.perf_counter()
    de, twin, st = stream_dlrm_model(torch, SEED + 180)
    ss = init_streaming(de, cfg, device="cuda")
    torch.cuda.synchronize()
    slab = st.emb_params["w128"]
    check(tuple(slab.shape) == (1, sum(ragged_sizes()), 128),
          f"streaming slab shape {tuple(slab.shape)}")
    sbytes = state_bytes(ss)
    log(f"streaming DLRM: slab {tuple(slab.shape)} fp32 = "
        f"{slab.numel() * 4 / 1e9:.2f} GB (+ the same in Adagrad "
        f"accumulators), streaming state {sbytes / 1e6:.1f} MB, tables "
        f"{list(STREAM_OVERCAP)} streaming ({STREAM_CAPACITY} slots + "
        f"{STREAM_BUCKETS} buckets each), built in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 181)
    st, ss = stream_dlrm_checks(torch, de, st, ss, cfg, gen, errs)
    batches = [stream_dlrm_batch(torch, gen, TRAIN_BATCH)
               for _ in range(STREAM_BATCHES)]
    st, ss, launches, metrics = stream_dlrm_timed(torch, de, twin, st, ss,
                                                  cfg, batches)
    occ = smod.occupancy(de, ss)
    metrics.update({k: occ[k] for k in ("steps", "admitted", "evicted",
                                        "bucket_ids", "hit_ids")})
    metrics["occupancy_frac"] = [t["occupancy_frac"] for t in occ["tables"]]
    metrics["streaming_state_bytes"] = sbytes
    log(json.dumps({k: metrics[k] for k in (
        "static_samples_per_sec", "dynamic_samples_per_sec",
        "streaming_overhead_frac")}))
    log(f"streaming DLRM: step {metrics['dynamic_step_ms']:.3f} ms dynamic, "
        f"{metrics['static_step_ms']:.3f} static (runs dynamic, static, "
        f"static, dynamic: {metrics['step_ms_runs']})")
    st, ss, metrics["profile"] = stream_profile(torch, de, st, ss, cfg,
                                                batches)
    serve_launches, metrics["serve"] = stream_dlrm_serve(torch, de, st, ss,
                                                         cfg)
    cases = stream_kernel_times(torch, de, st, ss, cfg, batches)
    metrics["bench"] = bench
    metrics["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"streaming: phase done in {metrics['phase_s']:.1f} s, peak memory "
        f"{metrics['peak_memory_gb']:.1f} GB")
    del st, ss, de, twin, batches
    gc.collect()
    torch.cuda.empty_cache()
    return ({"streaming": launches, "streaming_serve": serve_launches,
             "streaming_bench": bench_launches}, errs, cases, metrics)


# ------------------------------------------------------------------ example

PROMOTED_SCHEDULE = (24.0, 8000, 48000, 24000)  # examples/dlrm/main.py:248
PROMOTED_STEP = 24000          # on that schedule's plateau: lr 24
EXAMPLE_STEPS = 40
EXAMPLE_SAVE_AT = 20
EXAMPLE_EVAL_INTERVAL = 20
EXAMPLE_SERVE_QPS = 200.0
EXAMPLE_WARMUP = 3             # steps left out of the example's step rate


def bf16_bits(torch, got, want, what):
    """Bitwise bfloat16 equality (a NaN matches any NaN; the two sides
    may give it another payload); returns the max abs error over the
    finite values, 0 when equal."""
    check(got.shape == want.shape and got.dtype == want.dtype
          == torch.bfloat16, f"{what}: {got.dtype} {tuple(got.shape)} != "
          f"{want.dtype} {tuple(want.shape)}")
    g = got.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    w = want.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    gnan, wnan = (g & 0x7FFF) > 0x7F80, (w & 0x7FFF) > 0x7F80
    bad = int(((g != w) & ~(gnan & wnan)).sum())
    gf = got.detach().cpu().float()
    wf = want.detach().cpu().float()
    fin = torch.isfinite(gf) & torch.isfinite(wf)
    err = float((gf[fin] - wf[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(bad == 0, f"{what}: {bad} of {g.size} values differ from the "
          f"plain version (max err {err})")
    return err


def promoted_kernel_checks(torch):
    """13a. K18 against its stream-order plain version, run on CPU copies
    (the card's ``index_add_`` adds in no fixed order), bit-exact: widths
    3, 16, 128 and 200, float32 and bf16 update rows, int32 and int64
    ids, an empty stream, Zipfian duplicates with a row hit 5,000 times
    and (w128) one hit 50,000 times, negative ids, the sentinel, ids past
    the slab, a NaN and an Inf in hit rows, update rows at an odd offset
    in memory. Then K3's ``cast_vals=False``
    chain (SparseSGD's DETPU_SGD_DEDUP branch) on unique rows of a bf16
    slab, a constant and a tensor lr, bit-exact."""
    from distributed_embeddings_torch.ops import (
        sgd_scatter, sgd_scatter_plain, sgd_scatter_promoted,
        sgd_scatter_promoted_plain)

    rng = np.random.default_rng(SEED + 190)
    R, n_cases = 5000, 0
    for width in (3, 16, 128, 200):
        for vals_dtype in (torch.float32, torch.bfloat16):
            for ids_dtype in (torch.int32, torch.int64):
                for n, hot in ((0, 0), (3000, 0), (9000, 5000),
                               (60000, 50000)):
                    if hot == 50000 and width != 128:
                        continue
                    ids = (rng.zipf(1.2, size=n) - 1) % R
                    ids[rng.permutation(n)[:hot]] = 11
                    ids = np.concatenate([ids, [-1, -R, R, R + 3, -R - 1,
                                                10 ** 6]])
                    slab = rng.normal(size=(R, width)).astype(np.float32)
                    slab[ids[0] if n else R - 1, 0] = np.nan
                    vals = rng.normal(scale=3.0, size=(len(ids), width)
                                      ).astype(np.float32)
                    vals[1, -1] = np.inf
                    s = torch.from_numpy(slab).to(torch.bfloat16)
                    v = torch.from_numpy(vals).to(vals_dtype)
                    i = torch.from_numpy(ids).to(ids_dtype)
                    lr = torch.tensor(0.0173)
                    got = s.cuda()
                    sgd_scatter_promoted(got, i.cuda(), v.cuda(), lr.cuda())
                    torch.cuda.synchronize()
                    want = sgd_scatter_promoted_plain(s.clone(), i, v, lr)
                    bf16_bits(torch, got, want, f"K18 w{width} n{n} "
                              f"{vals_dtype} {ids_dtype}")
                    n_cases += 1
                    if width == 128 and n == 3000:
                        # update rows at an odd offset (a view into a
                        # larger buffer)
                        flat = torch.empty(v.numel() + 1, dtype=v.dtype,
                                           device="cuda")
                        vm = flat[1:].view(v.shape)
                        vm.copy_(v)
                        got = s.cuda()
                        sgd_scatter_promoted(got, i.cuda(), vm, lr.cuda())
                        bf16_bits(torch, got, want, f"K18 w{width} n{n} "
                                  f"{vals_dtype} {ids_dtype} misaligned")
                        n_cases += 1
    for vals_dtype in (torch.float32, torch.bfloat16):
        for lr in (0.37, torch.tensor(0.0123)):
            ids = np.concatenate([rng.permutation(R)[:3000], [R]]).astype(
                np.int32)
            s = torch.from_numpy(rng.normal(size=(R, 128)).astype(
                np.float32)).to(torch.bfloat16)
            v = torch.from_numpy(rng.normal(size=(len(ids), 128)).astype(
                np.float32)).to(vals_dtype)
            got = s.cuda()
            sgd_scatter(got, torch.from_numpy(ids).cuda(), v.cuda(),
                        lr.cuda() if isinstance(lr, torch.Tensor) else lr,
                        cast_vals=False)
            want = sgd_scatter_plain(s.clone(), torch.from_numpy(ids), v, lr,
                                     cast_vals=False)
            bf16_bits(torch, got, want, f"K3 dedup chain lr={lr}")
            n_cases += 1
    log(f"example: K18 bit-exact to its plain version in {n_cases - 4} "
        "edge cases, K3's dedup chain in 4")
    return {"sgd_scatter_promoted": 0.0, "sgd_scatter": 0.0}


def time_sgd_promoted(torch, de, slab, sizes, label, seed):
    """K18 timed on a training stream (26 x 65536 ids, b-major as the
    step builds it, 8 Zipfian id sets) into ``slab``, beside K3 on the
    same stream (K3 rounds each add to bf16: not the same function), the
    plain version, ``index_add_`` of the bf16-rounded products (K3's
    chain: the nearest one PyTorch call) and the byte bound."""
    from distributed_embeddings_torch.ops import (
        sgd_scatter, sgd_scatter_promoted, sgd_scatter_promoted_plain)

    w = slab.shape[1]
    lr_val = PROMOTED_SCHEDULE[0]  # the schedule at PROMOTED_STEP
    lr = torch.tensor(lr_val, device="cuda")
    roff = torch.as_tensor(de.row_offsets_list[0], dtype=torch.int32,
                           device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args, lib_args, uniq, hot = [], [], [], []
    for k in range(8):
        cats, _ = train_batch(torch, sizes, TRAIN_BATCH, seed=seed + k)
        ids = (torch.stack(cats, dim=1) + roff).reshape(-1).contiguous()
        vals = (torch.randn((ids.numel(), w), generator=gen, device="cuda")
                * 1e-3).to(torch.bfloat16)
        args.append((ids, vals))
        nl = torch.tensor(-lr_val, dtype=torch.bfloat16, device="cuda")
        lib_args.append((ids.long(), vals * nl))
        _, counts = torch.unique(ids, return_counts=True)
        uniq.append(int(counts.numel()))
        hot.append(int(counts.max()))
    ms = time_ms(torch, lambda i, v: sgd_scatter_promoted(slab, i, v, lr),
                 args)
    k3 = time_ms(torch, lambda i, v: sgd_scatter(slab, i, v, lr_val), args)
    plain = time_ms(torch, lambda i, v: sgd_scatter_promoted_plain(
        slab, i, v, lr), args)
    lib = time_ms(torch, lambda i, u: slab.index_add_(0, i, u), lib_args)
    n = args[0][0].numel()
    nbytes = n * w * 2 + n * 4 + 2 * uniq[0] * w * 2
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"time sgd_scatter_promoted {label}: kernel {ms:.4f} ms, K3 on the "
        f"same stream {k3:.4f}, plain {plain:.4f}, library (index_add_, "
        f"K3's chain) {lib:.4f}, bound {bound:.4f} ({uniq[0]} unique rows "
        f"of {n} ids, the hottest hit {hot[0]} times)")
    return {"case": label, "ms": ms, "plain_ms": plain, "library_ms": lib,
            "library_call": "index_add_ of bf16-rounded products (K3's "
                            "chain, not the promoted one)",
            "k3_same_stream_ms": k3, "bound_ms": bound, "bound_by": "bytes",
            "unique_rows": uniq[0], "hottest_row_hits": hot[0], "ids": n,
            "bytes": nbytes}


def promoted_full_check(torch, de, state):
    """13b. One step of the Criteo-1TB bf16 DLRM (48.1 GB slab) under the
    example's schedule at step 24000 (lr 24): K18's touched rows against
    the plain version on the step's own inputs (on CPU copies), bit-exact;
    then K18 timed on the 1TB stream."""
    from distributed_embeddings_torch.models.schedules import (
        warmup_poly_decay_schedule)
    from distributed_embeddings_torch.ops import sgd_scatter_promoted_plain
    from distributed_embeddings_torch.parallel import (
        SGD, HybridTrainState, ScheduleState, SparseSGD,
        make_hybrid_train_step)

    sched = warmup_poly_decay_schedule(*PROMOTED_SCHEDULE)
    slab = state.emb_params["w128"][0]
    rows = slab.shape[0]
    seen = {}

    class RecordingSGD(SparseSGD):
        """SparseSGD that snapshots the rows its stream touches first."""

        def apply_rows(self, slab, st, ids, vals, lr):
            gid = ids.long()
            gid = torch.where(gid < 0, gid + rows, gid)
            keep = (gid >= 0) & (gid < rows)
            uniq, inv = torch.unique(gid[keep], return_inverse=True)
            seen.update(uniq=uniq, inv=inv, vals=vals[keep], lr=lr,
                        before=slab[uniq].clone())
            return super().apply_rows(slab, st, ids, vals, lr)

    count = torch.tensor(PROMOTED_STEP, dtype=torch.int32, device="cuda")
    st = HybridTrainState(
        emb_params=state.emb_params,
        emb_opt_state=SparseSGD().init(state.emb_params),
        dense_params=state.dense_params,
        dense_opt_state=(ScheduleState(count.clone()),), step=count.clone())
    step = make_hybrid_train_step(de, loss_fn, SGD(sched), RecordingSGD(),
                                  lr_schedule=sched, nan_guard=True)
    cats, batch = train_batch(torch, CRITEO_1TB_SIZES, TRAIN_BATCH,
                              seed=SEED + 191)
    zero_counts()
    loss, st = step(st, cats, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    check(bool(torch.isfinite(loss)), f"1TB promoted step: loss {loss}")
    check(counts["sgd_scatter_promoted"] == 1 and counts["sgd_scatter"] == 0,
          f"1TB promoted step: K18 {counts['sgd_scatter_promoted']}, K3 "
          f"{counts['sgd_scatter']} launches (expected 1 and 0)")
    check(abs(float(seen["lr"]) - PROMOTED_SCHEDULE[0]) < 1e-6,
          f"1TB promoted step: lr {float(seen['lr'])}")
    want = sgd_scatter_promoted_plain(
        seen["before"].cpu(), seen["inv"].cpu(), seen["vals"].cpu(),
        seen["lr"].cpu())
    got = slab[seen["uniq"]]
    err = bf16_bits(torch, got, want, "1TB promoted step, touched rows")
    changed = int(torch.count_nonzero((got != seen["before"]).any(1)))
    check(changed > 0, "1TB promoted step: no touched row changed")
    log(f"example: 1TB bf16 step under the schedule at step {PROMOTED_STEP} "
        f"(lr {float(seen['lr'])}): loss {float(loss):.5f}, "
        f"{len(seen['uniq'])} touched rows ({changed} changed) bit-exact to "
        f"the plain version of {seen['vals'].shape[0]} stream rows")
    seen.clear()
    case = time_sgd_promoted(torch, de, slab, CRITEO_1TB_SIZES, "1tb_b65536",
                             SEED + 200)
    return err, case


def example_args(tmp, sizes):
    """The example's command line at the capped Criteo-Kaggle size: its
    default width, MLPs, batch and lr, bf16 tables, eval every 20."""
    return ["--table_sizes", ",".join(map(str, sizes)),
            "--param_dtype", "bfloat16",
            "--eval_interval", str(EXAMPLE_EVAL_INTERVAL),
            "--checkpoint_out", os.path.join(tmp, "embedding_weights")]


def example_state_equal(torch, a, b, what):
    """Bitwise equality of two example train states (SparseSGD + SGD
    with a schedule)."""
    check(int(a.step) == int(b.step), f"{what}: step {int(a.step)} != "
          f"{int(b.step)}")
    for k, v in a.emb_params.items():
        check(torch.equal(v.view(torch.int16),
                          b.emb_params[k].view(torch.int16)),
              f"{what}: slab {k} differs")
    for p, q in zip(a.dense_params.parameters(),
                    b.dense_params.parameters()):
        check(torch.equal(p, q), f"{what}: dense params differ")
    for p, q in zip(a.dense_opt_state, b.dense_opt_state):
        check(torch.equal(p.count, q.count), f"{what}: schedule count")


def example_nan_check(torch, run, sizes):
    """13d. A NaN batch through the example's step on run A's final
    state: the bf16 slab, the dense params and the schedule's count
    bitwise unchanged, the step advanced."""
    from distributed_embeddings_torch.examples import dlrm_main
    from distributed_embeddings_torch.models import DLRMConfig
    from distributed_embeddings_torch.models.schedules import (
        warmup_poly_decay_schedule)
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, make_hybrid_train_step)

    sched = warmup_poly_decay_schedule(24, 8000, 48000, 24000)
    step = make_hybrid_train_step(run.de, loss_fn, SGD(sched), SparseSGD(),
                                  lr_schedule=sched)
    cfg = DLRMConfig(table_sizes=sizes)
    num, cats, lab = next(dlrm_main.synthetic_batches(cfg, 1, TRAIN_BATCH,
                                                      seed=SEED + 210))
    num[TRAIN_BATCH // 3, 5] = np.nan
    st = run.state
    key = next(iter(st.emb_params))
    slab_before = st.emb_params[key].clone()
    dense_before = [p.detach().clone() for p in st.dense_params.parameters()]
    count_before = st.dense_opt_state[0].count.clone()
    step_before = int(st.step)
    zero_counts()
    loss, st = step(st, [torch.from_numpy(c).cuda() for c in cats],
                    (torch.from_numpy(num).cuda(),
                     torch.from_numpy(lab).cuda()))
    torch.cuda.synchronize()
    check(not bool(torch.isfinite(loss)), "example NaN batch: finite loss")
    check(read_counts()["sgd_scatter_promoted"] == 1,
          "example NaN batch: K18 did not launch")
    check(torch.equal(st.emb_params[key].view(torch.int16),
                      slab_before.view(torch.int16)),
          "example NaN batch: the bf16 slab changed")
    check(all(torch.equal(p, q) for p, q in zip(
        st.dense_params.parameters(), dense_before)),
        "example NaN batch: dense params changed")
    check(torch.equal(st.dense_opt_state[0].count, count_before),
          "example NaN batch: the schedule's count changed")
    check(int(st.step) == step_before + 1,
          "example NaN batch: step did not advance")
    log(f"example: NaN batch skipped, the {slab_before.numel() * 2 / 1e9:.2f} "
        f"GB bf16 slab, the dense params and the schedule count "
        f"({int(count_before)}) bitwise unchanged, step {step_before} -> "
        f"{int(st.step)}")


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def phase_example(torch, promoted_1tb):
    """The DLRM example (``examples/dlrm_main.py``) on the card:
    13a. K18 (and K3's dedup chain) edge cases against the plain version;
    (13b ran in the Criteo-1TB phase: ``promoted_1tb``;)
    13c. the example in process at the capped Criteo-Kaggle size (26
         vocabularies capped at 2M rows, 10,569,296 rows, 2.71 GB bf16),
         dim 128, MLPs 512-256-128 / 1024-1024-512-256-1, b=65536, lr 24
         with the MLPerf warmup: run A 40 steps with eval every 20 and
         1 s of serving at 200 QPS, launches counted; run B 20 steps
         saving the full train state, then a run restored to step 40:
         losses and state bitwise equal to A's; K18 timed at this shape;
    13d. a NaN batch under the guard on A's final state."""
    import shutil
    import tempfile

    from distributed_embeddings_torch.examples import dlrm_main
    from distributed_embeddings_torch.parallel import Served

    t_phase = time.perf_counter()
    errs = promoted_kernel_checks(torch)
    sizes = ragged_sizes()
    tmp = tempfile.mkdtemp(prefix="detpu_example_")
    try:
        args = example_args(tmp, sizes)
        zero_counts()
        t0 = time.perf_counter()
        a = dlrm_main.main(args + [
            "--num_batches", str(EXAMPLE_STEPS),
            "--serve_qps", str(EXAMPLE_SERVE_QPS), "--serve_seconds", "1"])
        torch.cuda.synchronize()
        launches = read_counts()
        run_a_s = time.perf_counter() - t0
        check(a.steps_run == EXAMPLE_STEPS and np.isfinite(a.losses).all(),
              f"example run A: {a.steps_run} steps, losses {a.losses}")
        check(launches["sgd_scatter_promoted"] == EXAMPLE_STEPS
              and launches["dot_interact_bwd"] == EXAMPLE_STEPS
              and launches["gather_combine"] >= EXAMPLE_STEPS
              and launches["dot_interact_fwd"] >= EXAMPLE_STEPS
              and launches["pack_ids"] >= EXAMPLE_STEPS
              and launches["pack_columns"] == EXAMPLE_STEPS
              and launches["sgd_scatter"] == 0,
              f"example run A launches {launches}")
        served = a.serve_results
        check(len(served) >= EXAMPLE_SERVE_QPS * 0.9 and all(
            isinstance(r, Served) for r in served),
            f"example serving: {len(served)} results, "
            f"{sum(not isinstance(r, Served) for r in served)} not Served")
        check(a.auc is not None and 0.0 <= a.auc <= 1.0,
              f"example AUC {a.auc}")
        timed = a.step_s[EXAMPLE_WARMUP:]
        ck = os.path.join(tmp, "state")
        b1 = dlrm_main.main(args + ["--num_batches", str(EXAMPLE_SAVE_AT),
                                    "--save_state", ck])
        ck_bytes = dir_bytes(ck)
        save_s = b1.save_s[-1]
        b1_losses = b1.losses
        del b1
        gc.collect()
        b2 = dlrm_main.main(args + ["--num_batches", str(EXAMPLE_STEPS),
                                    "--restore_state", ck])
        torch.cuda.synchronize()
        check(b1_losses + b2.losses == a.losses,
              f"example resumed losses differ: "
              f"{[x for x in zip(b1_losses + b2.losses, a.losses)]}")
        example_state_equal(torch, a.state, b2.state,
                            f"example resumed at step {EXAMPLE_SAVE_AT}")
        restore_s = b2.restore_s
        del b2
        gc.collect()
        log(f"example: resumed run ({EXAMPLE_SAVE_AT} steps, save, restore, "
            f"{EXAMPLE_STEPS - EXAMPLE_SAVE_AT} more) bitwise equal to the "
            f"uninterrupted {EXAMPLE_STEPS}: losses, the bf16 slab, the dense "
            "params, the schedule count and the step")
        slab = next(iter(a.state.emb_params.values()))[0]
        case = time_sgd_promoted(torch, a.de, slab, sizes, "kaggle_b65536",
                                 SEED + 220)
        del slab
        example_nan_check(torch, a, sizes)
        metrics = {
            "table_rows": sum(sizes), "batch": TRAIN_BATCH,
            "steps": EXAMPLE_STEPS,
            "samples_per_s_step": TRAIN_BATCH * len(timed) / sum(timed),
            "step_ms_p50": float(np.median(timed)) * 1e3,
            "samples_per_s_loop": TRAIN_BATCH * EXAMPLE_STEPS / a.loop_s,
            "loop_s": a.loop_s, "run_a_s": run_a_s,
            "loss_first": a.losses[0], "loss_last": a.losses[-1],
            "auc": a.auc, "save_s": save_s, "restore_s": restore_s,
            "checkpoint_bytes": ck_bytes,
            "serve": {k: a.serving[k] for k in (
                "served", "shed", "latency_p50_ms", "latency_p99_ms",
                "pad_fraction")},
            "launches_per_step": {n: v / EXAMPLE_STEPS
                                  for n, v in launches.items() if v}}
        log("example: " + json.dumps(metrics))
        del a
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    return ({"example": launches}, errs, [case, promoted_1tb], metrics)



# ------------------------------------------------------- world 8 (phase 14)

W8 = 8                         # the JAX multichip dryrun's world
W8_BATCH = 65536               # global: 8192 a rank
W8_CST = 1_400_000_000         # tools/_profcommon.py:57-60 (CRITEO1TB_COL_SLICE)
W8_SMALL_CST = 2_400_000       # slices the 20,000-row tables of width 128
W8_SMALL_BATCH = 4096
W8_SMALL_LR = 0.1
W8_STEPS = 10
W8_WARMUP = 2
W8_STAGE_STEPS = 3
W8_NAN_RANK = 5
W8_DROP_RANK = 3               # the control drops this source's cotangents
W8_TIMEOUT_S = 600
W8_STAGES = ("id_exchange", "lookup", "output_exchange", "dense",
             "all_reduce", "cotangent_exchange", "apply")


def w8_per_step(groups, widths, steps=1):
    """Launches of ``steps`` world-8 DLRM steps on one rank: K1 once per
    plan group, K3 once per width slab, K19 once, K20 three times (the
    lookup rows, the unpack, the cotangent pack), K2 and K4 once."""
    want = {name: 0 for name in kernel_fns()}
    want.update(gather_combine=groups, sgd_scatter=widths, pack_ids=1,
                pack_columns=3, dot_interact_fwd=1, dot_interact_bwd=1)
    return {k: v * steps for k, v in want.items()}


def w8_bits(torch, t):
    """A float tensor's bits (NaN equals NaN), an int tensor itself."""
    if not t.is_floating_point():
        return t
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def bits_err(torch, got, want, what):
    """Kernel against plain, compared as bits (NaN equals NaN): fails
    unless every element's bits agree; returns the largest |got - want|
    over the elements whose bits differ (inf where one side is NaN), 0.0
    when none do."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {got.dtype} {tuple(got.shape)} != {want.dtype} "
          f"{tuple(want.shape)}")
    diff = w8_bits(torch, got) != w8_bits(torch, want)
    err = 0.0
    if bool(diff.any()):
        d = (got[diff].double() - want[diff].double()).abs()
        err = float(torch.nan_to_num(d, nan=float("inf")).max())
    check(err == 0.0 and not bool(diff.any()),
          f"{what}: kernel differs from plain (max err {err})")
    return err


@contextlib.contextmanager
def pack_checks(torch):
    """Route the exchange layer's K19/K20 calls through checkers: each
    launch's output must equal the plain version's on the same inputs,
    bitwise. Yields the number of checked calls by kernel, and under
    ``"err"`` the largest difference each kernel's checks measured."""
    from distributed_embeddings_torch.ops import exchange_pack as xp
    from distributed_embeddings_torch.parallel import exchange

    real_ids, real_cols = exchange.pack_ids, exchange.pack_columns
    n = {"pack_ids": 0, "pack_columns": 0,
         "err": {"pack_ids": 0.0, "pack_columns": 0.0}}

    def ids(plan, srcs, out):
        got = real_ids(plan, srcs, out)
        want = xp.pack_ids_plain(plan, srcs, torch.empty_like(out))
        n["err"]["pack_ids"] = max(n["err"]["pack_ids"], bits_err(
            torch, got, want, "pack_ids on the step's inputs"))
        n["pack_ids"] += 1
        return got

    def cols(plan, srcs, dsts):
        got = real_cols(plan, srcs, dsts)
        want = xp.pack_columns_plain(plan, srcs,
                                     [torch.empty_like(d) for d in dsts])
        for a, b in zip(got, want):
            n["err"]["pack_columns"] = max(n["err"]["pack_columns"], bits_err(
                torch, a, b, "pack_columns on the step's inputs"))
        n["pack_columns"] += 1
        return got

    exchange.pack_ids, exchange.pack_columns = ids, cols
    try:
        yield n
    finally:
        exchange.pack_ids, exchange.pack_columns = real_ids, real_cols


def w8_model(torch, sizes, cst, compute_dtype):
    from distributed_embeddings_torch.models import DLRMConfig
    from distributed_embeddings_torch.parallel import DistributedEmbedding

    cfg = DLRMConfig(table_sizes=sizes, embedding_dim=128,
                     num_numerical_features=13,
                     bottom_mlp_dims=(512, 256, 128),
                     top_mlp_dims=(1024, 1024, 512, 256, 1),
                     compute_dtype=compute_dtype)
    de = DistributedEmbedding(cfg.embedding_configs(), world_size=W8,
                              strategy="comm_balanced",
                              column_slice_threshold=cst,
                              compute_dtype=compute_dtype)
    return cfg, de


def w8_small_sizes():
    return [min(s, SMALL_ROWS) for s in CRITEO_1TB_SIZES]


def w8_small_batch(seed, b=W8_SMALL_BATCH):
    """A global batch of the small check as numpy: Zipfian ids a table,
    N(0, 1) numerical features, 0/1 labels."""
    from distributed_embeddings_torch.utils.data import power_law_ids

    rng = np.random.default_rng(seed)
    cats = [power_law_ids(rng, v, (b,)).astype(np.int32)
            for v in w8_small_sizes()]
    return (cats, rng.normal(size=(b, 13)).astype(np.float32),
            (rng.random(b) < 0.25).astype(np.float32))


def w8_small_state(torch, de, dense, tmp):
    from distributed_embeddings_torch.parallel import (SGD, HybridTrainState,
                                                       SparseSGD)

    dense.load_state_dict(torch.load(os.path.join(tmp, "dense.pt")))
    params = de.set_weights([os.path.join(tmp, f"table_{t}.npy")
                             for t in range(len(CRITEO_1TB_SIZES))],
                            device="cuda")
    return HybridTrainState(
        emb_params=params, emb_opt_state=SparseSGD().init(params),
        dense_params=dense,
        dense_opt_state=SGD(W8_SMALL_LR).init(list(dense.parameters())),
        step=torch.zeros((), dtype=torch.int32, device="cuda"))


def w8_small_run(torch, de, st, shard):
    """SMALL_STEPS steps and an eval batch (``shard`` picks this
    process's rows of a global numpy batch); returns losses, state and
    eval predictions."""
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, make_hybrid_eval_step, make_hybrid_train_step)

    step = make_hybrid_train_step(de, loss_fn, SGD(W8_SMALL_LR), SparseSGD(),
                                  lr_schedule=W8_SMALL_LR, nan_guard=True)
    losses = []
    for k in range(SMALL_STEPS):
        cats, num, lab = shard(w8_small_batch(SEED + 500 + k))
        loss, st = step(st, cats, (num, lab))
        losses.append(float(loss))
    cats, num, _ = shard(w8_small_batch(SEED + 599))
    pred = make_hybrid_eval_step(
        de, lambda m, outs, n: torch.sigmoid(m(n, outs).float()))(
        st, cats, num)
    return losses, st, pred


def w8_to_card(torch, batch, rows=None):
    """A numpy global batch on the card, all rows or ``rows``."""
    cats, num, lab = batch
    sl = slice(None) if rows is None else rows
    return ([torch.from_numpy(c[sl].copy()).cuda() for c in cats],
            torch.from_numpy(num[sl].copy()).cuda(),
            torch.from_numpy(lab[sl].copy()).cuda())


def w8_small_reference(torch, tmp):
    """14b's world-1 side: the small tables and dense params written to
    ``tmp`` (the ranks load them), then SMALL_STEPS world-1 steps on the
    card. Returns the losses, tables, dense params, eval predictions and
    the number of ids that hit each table row."""
    from distributed_embeddings_torch.models import DLRMConfig, DLRMDense
    from distributed_embeddings_torch.parallel import DistributedEmbedding

    sizes = w8_small_sizes()
    rng = np.random.default_rng(SEED + 501)
    for t, v in enumerate(sizes):
        np.save(os.path.join(tmp, f"table_{t}.npy"),
                rng.uniform(-0.05, 0.05, size=(v, 128)).astype(np.float32))
    cfg = DLRMConfig(table_sizes=sizes, embedding_dim=128,
                     num_numerical_features=13,
                     bottom_mlp_dims=(512, 256, 128),
                     top_mlp_dims=(1024, 1024, 512, 256, 1))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 502)
    dense = DLRMDense(cfg, device="cuda", generator=gen)
    torch.save(dense.state_dict(), os.path.join(tmp, "dense.pt"))
    de = DistributedEmbedding(cfg.embedding_configs(), world_size=1)
    st = w8_small_state(torch, de, dense, tmp)
    losses, st, pred = w8_small_run(torch, de, st,
                                    lambda b: w8_to_card(torch, b))
    hits = [np.zeros(v, np.int64) for v in sizes]
    for k in range(SMALL_STEPS):
        for h, c in zip(hits, w8_small_batch(SEED + 500 + k)[0]):
            np.add.at(h, c, 1)
    return {"losses": losses, "tables": de.get_weights(st.emb_params),
            "dense": [p.detach().cpu().numpy()
                      for p in st.dense_params.parameters()],
            "pred": pred.float().cpu().numpy(), "hits": hits}


def w8_rank_small(torch, rank, tmp):
    """14b on one rank: the small check, then its control (source rank
    W8_DROP_RANK's cotangent block dropped on every rank); rank 0 writes
    both runs' tables to ``tmp``."""
    from distributed_embeddings_torch.models import DLRMDense
    from distributed_embeddings_torch.parallel import bootstrap, exchange

    cfg, de = w8_model(torch, w8_small_sizes(), W8_SMALL_CST, None)
    b = W8_SMALL_BATCH // W8
    rows = slice(rank * b, (rank + 1) * b)
    out = {"slices": sum(map(len, de.strategy.table_ids_list))}
    for run in ("main", "control"):
        dense = DLRMDense(cfg, device="cuda")
        st = w8_small_state(torch, de, dense, tmp)
        real = exchange.exchange_grads

        def dropped(de_, packed):
            got = real(de_, packed)
            got[W8_DROP_RANK].zero_()
            return got

        if run == "control":
            exchange.exchange_grads = dropped
        try:
            with pack_checks(torch) as n:
                losses, st, pred = w8_small_run(
                    torch, de, st, lambda bt: w8_to_card(torch, bt, rows))
        finally:
            exchange.exchange_grads = real
        tables = de.get_weights(st.emb_params, all_ranks=False)
        if rank == 0:
            for t, a in enumerate(tables):
                np.save(os.path.join(tmp, f"w8_{run}_{t}.npy"), a)
        out[run] = {"losses": losses, "checked": dict(n),
                    "dense": [p.detach().cpu().numpy()
                              for p in st.dense_params.parameters()],
                    "pred": bootstrap.to_host(pred)}
        del st, dense, tables
    torch.cuda.empty_cache()
    return out


def w8_recording_sgd(torch):
    from distributed_embeddings_torch.parallel import SparseSGD

    class RecordingSGD(SparseSGD):
        """SparseSGD that snapshots, per width slab, the rows its
        stream touches before it updates them."""

        seen = {}

        def apply_rows(self, slab, state, ids, vals, lr):
            rows = slab.shape[0]
            gid = ids.long()
            gid = torch.where(gid < 0, gid + rows, gid)
            keep = (gid >= 0) & (gid < rows)
            uniq, inv = torch.unique(gid[keep], return_inverse=True)
            self.seen[slab.shape[1]] = dict(
                slab=slab, uniq=uniq, inv=inv, vals=vals[keep], lr=lr,
                before=slab[uniq].clone())
            return super().apply_rows(slab, state, ids, vals, lr)

    return RecordingSGD()


def w8_scatter_check(torch, seen):
    """Each width slab's touched rows against the plain scatter of the
    step's stream applied to their snapshot: rows hit once bit-exact,
    rows hit k times within k bf16 ulps (both add with atomics)."""
    from distributed_embeddings_torch.ops import scatter_add

    worst = 0.0
    for w, r in sorted(seen.items()):
        want = r["before"].clone()
        scatter_add.sgd_scatter_plain(want, r["inv"], r["vals"], r["lr"])
        got = r["slab"][r["uniq"]]
        k = torch.bincount(r["inv"], minlength=len(r["uniq"])).float()[:, None]
        mag = torch.zeros_like(want, dtype=torch.float32).index_add_(
            0, r["inv"], r["vals"].float().abs() * float(r["lr"]))
        err = (got.float() - want.float()).abs()
        single = int(torch.count_nonzero(err[k[:, 0] == 1]))
        bound = k * ulp(torch, r["before"].float().abs() + mag, got.dtype)
        multi = int(torch.count_nonzero(err > bound))
        check(single == 0 and multi == 0, f"world 8 w{w}: {single} values of "
              f"rows hit once differ from the plain scatter, {multi} beyond "
              f"k ulps (max err {float(err.max())})")
        worst = max(worst, float(err.max()))
    return worst


def w8_touched_recorder(torch):
    """Wrap ``apply.apply_width_streams`` to snapshot, before the update,
    the slab rows the step's streams name (the guard's skip routes the
    ids to the sentinel inside it)."""
    from distributed_embeddings_torch.parallel import apply

    real = apply.apply_width_streams
    snaps = {}

    def wrapper(de, params, opt_state, per_width, *a, **kw):
        for k, tris in per_width.items():
            ids = torch.cat([t[0].reshape(-1).long() for t in tris])
            w = tris[0][2]
            uniq = torch.unique(ids[(ids >= 0) & (ids < de.rows_cap[w])])
            snaps[k] = (params[k], uniq, params[k][uniq].clone())
        return real(de, params, opt_state, per_width, *a, **kw)

    return real, wrapper, snaps


@contextlib.contextmanager
def w8_stage_marks(torch):
    """Mark the stage bounds of the real world-8 step (the trainer's
    own ``make_hybrid_train_step``): the exchange layer's three
    all-to-alls, the unpack and ``grads.mean_flat`` are wrapped so that
    each bound records an event and synchronizes. Yields ``mark`` (call
    it before and after the step) and the list of ``(host s, event)``
    marks; the stages are W8_STAGES, in order."""
    from distributed_embeddings_torch.parallel import exchange, grads

    marks = []

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), ev))

    def wrap(fn, before, after):
        def wrapper(*a, **kw):
            if before:
                mark()
            out = fn(*a, **kw)
            if after:
                mark()
            return out
        return wrapper

    # step start | id_exchange | lookup | output_exchange (with the
    # unpack) | dense | all_reduce | cotangent_exchange (with the pack) |
    # apply (with the dense update) | step end
    real = {(exchange, "exchange_ids"): (False, True),
            (exchange, "exchange_outputs"): (True, False),
            (exchange, "unpack_outputs"): (False, True),
            (grads, "mean_flat"): (True, True),
            (exchange, "exchange_grads"): (False, True)}
    saved = {k: getattr(*k) for k in real}
    for (mod, name), (before, after) in real.items():
        setattr(mod, name, wrap(saved[(mod, name)], before, after))
    try:
        yield mark, marks
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def w8_staged_steps(torch, step, st, batches, steps):
    """``steps`` real world-8 steps (after one unmarked) with their stage
    bounds marked: per stage the medians of host ms and device ms."""
    split = []
    with w8_stage_marks(torch) as (mark, marks):
        for k in range(1 + steps):
            marks.clear()
            mark()
            _, st = step(st, *batches[k % len(batches)])
            mark()
            check(len(marks) == len(W8_STAGES) + 1, f"world 8 stage split: "
                  f"{len(marks)} marks a step, expected "
                  f"{len(W8_STAGES) + 1}")
            if k:
                split.append({name: (
                    (marks[i + 1][0] - marks[i][0]) * 1e3,
                    marks[i][1].elapsed_time(marks[i + 1][1]))
                    for i, name in enumerate(W8_STAGES)})
    return st, {name: {"host_ms": float(np.median([s[name][0] for s in split])),
                       "device_ms": float(np.median([s[name][1]
                                                     for s in split]))}
                for name in W8_STAGES}


def w8_rank_full(torch, rank):
    """14c on one rank: the Criteo-1TB world-8 step (see main's
    docstring, phase 14c)."""
    from distributed_embeddings_torch.models import DLRMDense
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, apply, init_hybrid_state, make_hybrid_train_step)

    cfg, de = w8_model(torch, CRITEO_1TB_SIZES, W8_CST, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dense = DLRMDense(cfg, device="cuda", generator=gen)
    st = init_hybrid_state(de, SparseSGD(), dense, SGD(TRAIN_LR),
                           generator=gen, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    out = {"slab_bytes": sum(v.numel() * v.element_size()
                             for v in st.emb_params.values()),
           "instances": len(de.strategy.table_ids_list[rank])}
    b = W8_BATCH // W8
    batches = [train_batch(torch, CRITEO_1TB_SIZES, b,
                           seed=SEED + 400 + 16 * k + rank)
               for k in range(4)]
    # c1: one checked step
    rec = w8_recording_sgd(torch)
    step = make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), rec,
                                  lr_schedule=TRAIN_LR, nan_guard=True)
    zero_counts()
    with pack_checks(torch) as n:
        loss, st = step(st, *batches[0])
        torch.cuda.synchronize()
    counts = read_counts()
    plan = next(iter(de._plan_cache.values()))
    want = w8_per_step(len(plan.groups), len(de.widths))
    check(counts == want, f"world 8 rank {rank} checked step: launches "
          f"{counts}, expected {want}")
    check(bool(torch.isfinite(loss)), f"world 8 rank {rank}: loss {loss}")
    out["checked"] = dict(n)
    out["scatter_err"] = w8_scatter_check(torch, rec.seen)
    out["plan"] = {"groups": [(g.kind, g.width, g.hot, g.n)
                              for g in plan.groups],
                   "l_max": plan.l_max, "s_max": plan.s_max,
                   "rows_cap": dict(de.rows_cap)}
    rec.seen.clear()
    # c2: a NaN batch on one rank only
    step = make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), SparseSGD(),
                                  lr_schedule=TRAIN_LR, nan_guard=True)
    cats, batch = train_batch(torch, CRITEO_1TB_SIZES, b,
                              seed=SEED + 450 + rank,
                              nan=rank == W8_NAN_RANK)
    real, wrapper, snaps = w8_touched_recorder(torch)
    dense_before = [p.detach().clone() for p in st.dense_params.parameters()]
    step_before = int(st.step)
    apply.apply_width_streams = wrapper
    try:
        loss, st = step(st, cats, batch)
    finally:
        apply.apply_width_streams = real
    torch.cuda.synchronize()
    check(not bool(torch.isfinite(loss)), f"world 8 rank {rank}: the NaN "
          "batch gave a finite loss")
    check(all(torch.equal(p[u], before) for p, u, before in snaps.values()),
          f"world 8 rank {rank}: NaN batch changed slab rows")
    check(all(torch.equal(p, q) for p, q in zip(
        st.dense_params.parameters(), dense_before)),
        f"world 8 rank {rank}: NaN batch changed the dense params")
    check(int(st.step) == step_before + 1, f"world 8 rank {rank}: the "
          "step did not advance")
    out["nan_rows"] = int(sum(len(u) for _, u, _ in snaps.values()))
    snaps.clear()
    del dense_before
    # c3: warmup, then timed steps with the launches counted
    for k in range(W8_WARMUP):
        _, st = step(st, *batches[k % len(batches)])
    torch.cuda.synchronize()
    zero_counts()
    times, losses = [], []
    t0 = time.perf_counter()
    for k in range(W8_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss, st = step(st, *batches[k % len(batches)])
        ev[1].record()
        times.append(ev)
        losses.append(loss)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    counts = read_counts()
    want = w8_per_step(len(plan.groups), len(de.widths), W8_STEPS)
    check(counts == want, f"world 8 rank {rank} timed: launches {counts}, "
          f"expected {want}")
    out["launches"] = counts
    out["step_ms"] = [s.elapsed_time(e) for s, e in times]
    out["losses"] = [float(x) for x in losses]
    check(np.isfinite(out["losses"]).all(), f"world 8 rank {rank}: "
          "non-finite loss")
    # c4: the stage split of the same step
    st, out["stages"] = w8_staged_steps(torch, step, st, batches,
                                        W8_STAGE_STEPS)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def w8_rank(rank, store, tmp, results):
    """A rank process of phase 14: join the gloo group on the one card,
    run 14b and 14c, send the results. Any failure raises (the process
    exits non-zero and the phase fails)."""
    import torch

    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from distributed_embeddings_torch.parallel import bootstrap

    bootstrap.initialize("gloo", f"file://{store}", W8, rank,
                         timeout_s=W8_TIMEOUT_S)
    t0 = time.perf_counter()
    small = w8_rank_small(torch, rank, tmp)
    small["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = w8_rank_full(torch, rank)
    full["seconds"] = time.perf_counter() - t0
    results.put((rank, {"small": small, "full": full}))
    torch.distributed.destroy_process_group()


def w8_run_ranks(torch, tmp):
    """Start the W8 rank processes, wait for every result; a rank that
    exits non-zero fails the phase. Stops every process it started."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=w8_rank, args=(r, store, tmp, results))
             for r in range(W8)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < W8:
            try:
                rank, res = results.get(timeout=5)
                got[rank] = res
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                check(not dead, f"world 8: rank(s) failed (rank, exit "
                      f"code) {dead}")
                check(time.perf_counter() - t0 < W8_TIMEOUT_S,
                      f"world 8: ranks {sorted(set(range(W8)) - set(got))} "
                      f"gave no result in {W8_TIMEOUT_S} s")
        for r, p in enumerate(procs):
            p.join(timeout=120)
            check(p.exitcode == 0, f"world 8: rank {r} exit code "
                  f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(W8)], time.perf_counter() - t0


def w8_compare_small(torch, ref, ranks, tmp):
    """14b: the world-8 run within its bound of world 1, the control
    beyond it."""
    first = ranks[0]["small"]
    check(first["slices"] > len(CRITEO_1TB_SIZES), "world 8 small: no "
          "table was column-sliced")
    out = {}
    for run in ("main", "control"):
        r0 = first[run]
        for r, res in enumerate(ranks):
            got = res["small"][run]
            check(got["losses"] == r0["losses"], f"world 8 small {run}: "
                  f"rank {r}'s losses differ from rank 0's")
            check(all(np.array_equal(a, b) for a, b in zip(
                got["dense"], r0["dense"])), f"world 8 small {run}: rank "
                f"{r}'s dense params differ from rank 0's")
            if run == "main":
                check(got["checked"]["pack_ids"] >= SMALL_STEPS + 1
                      and got["checked"]["pack_columns"]
                      >= 3 * SMALL_STEPS + 2, f"world 8 small rank {r}: "
                      f"checked K19/K20 calls {got['checked']}")
        loss_err = float(np.abs(np.subtract(r0["losses"],
                                            ref["losses"])).max())
        dense_err = max(float(np.abs(a - b).max())
                        for a, b in zip(r0["dense"], ref["dense"]))
        pred_err = float(np.abs(r0["pred"].reshape(-1)
                                - ref["pred"].reshape(-1)).max())
        sq_err, sq_upd, worst = 0.0, 0.0, 0.0
        for t, want in enumerate(ref["tables"]):
            a = np.load(os.path.join(tmp, f"w8_{run}_{t}.npy"))
            init = np.load(os.path.join(tmp, f"table_{t}.npy"))
            err = a.astype(np.float64) - want
            sq_err += float(np.square(err).sum())
            sq_upd += float(np.square(want.astype(np.float64) - init).sum())
            worst = max(worst, float(np.abs(err).max()))
        out[run] = {"loss_err": loss_err, "dense_err": dense_err,
                    "pred_err": pred_err, "slab_max_err": worst,
                    "slab_rel_err": (sq_err / max(sq_upd, 1e-300)) ** 0.5,
                    "losses": r0["losses"]}
    m, c = out["main"], out["control"]
    check(m["loss_err"] <= 1e-5 and m["dense_err"] <= 1e-5
          and m["pred_err"] <= 1e-5 and m["slab_max_err"] <= 1e-6
          and m["slab_rel_err"] <= 1e-3,
          f"world 8 small: beyond the bound of world 1: {m}")
    check(c["slab_rel_err"] > 1e-3, f"world 8 small control (source rank "
          f"{W8_DROP_RANK}'s cotangents dropped) stays within the bound: "
          f"{c}")
    out["checked"] = first["main"]["checked"]
    return out


def pack_edge_checks(torch):
    """14a: K19/K20 against their plain versions (and the id block and
    cotangent pack against the reference concatenation of cells) on the
    card, bit-exact: worlds 1 and 8, multi-slot instances, column slices,
    ragged weighted blocks, int64 ids, every float dtype pair (casts),
    NaN and Inf bits, unaligned copies and more copies than one launch
    carries. Returns the number of checks by kernel."""
    from distributed_embeddings_torch.ops import exchange_pack as xp
    from distributed_embeddings_torch.ops.embedding_lookup import Ragged
    from distributed_embeddings_torch.parallel import (DistributedEmbedding,
                                                       exchange)

    dev = torch.device("cuda")
    n = {"pack_ids": 0, "pack_columns": 0,
         "err": {"pack_ids": 0.0, "pack_columns": 0.0}}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 600)

    def rand(shape, dtype):
        t = torch.randn(shape, generator=gen, device="cuda")
        t.view(-1)[::17] = float("nan")
        t.view(-1)[5::31] = float("inf")
        return t.to(dtype)

    def same(a, b, what, kernel="pack_columns"):
        n["err"][kernel] = max(n["err"][kernel], bits_err(
            torch, a, b, f"pack edge case {what}"))

    for world in (1, W8):
        for ragged in (False, True):
            rng = np.random.default_rng(world + 10 * ragged)
            configs = [{"input_dim": int(rng.integers(4, 100)),
                        "output_dim": int(rng.integers(1, 9)),
                        "combiner": (str(rng.choice(["sum", "mean"]))
                                     if ragged else
                                     rng.choice([None, "sum", "mean"]))}
                       for _ in range(12)]
            de = DistributedEmbedding(
                configs, world, strategy="comm_balanced",
                column_slice_threshold=150 if world > 1 else None)
            b = 6
            for ids_dt in (torch.int32, torch.int64):
                if ragged:
                    inputs = []
                    for c in configs:
                        rows = [list(rng.integers(0, c["input_dim"],
                                                  size=rng.integers(0, 4)))
                                for _ in range(b)]
                        inputs.append(Ragged.from_lists(
                            rows, capacity=16, dtype=ids_dt, weights=[
                                list(rng.uniform(0.5, 2, len(r)))
                                for r in rows]))
                else:
                    inputs = [torch.from_numpy(rng.integers(
                        0, c["input_dim"], size=(b, int(rng.integers(1, 5))
                                                 if c["combiner"] or world == 1
                                                 else 1))).to(ids_dt)
                        for c in configs]
                entries, encs, _, dt = de._normalize_inputs(inputs, dev)
                plan = de._get_plan(encs, b)
                got = exchange.build_send_blocks(de, plan, entries, dt, dev)
                same(got, exchange.build_send_blocks_plain(
                    de, plan, entries, dt, dev), f"ids w{world} {dt}",
                    "pack_ids")
                n["pack_ids"] += 1
            _, widths = exchange.slice_map(de, plan)
            for src_dt in (torch.float32, torch.bfloat16):
                for dst_dt in (torch.float32, torch.bfloat16):
                    for r in range(world):
                        de._rank = r
                        reds = [rand((world * g.n, b, g.width), src_dt)
                                for g in plan.groups]
                        got = exchange.pack_lookup_rows(de, plan, reds,
                                                        dst_dt, dev)
                        want = torch.empty_like(got)
                        xp.batched_copy_plain(
                            exchange.lookup_copy_plan(de, plan),
                            [x.reshape(-1) for x in reds], [want])
                        same(got, want, f"lookup rows w{world} rank {r}")
                        n["pack_columns"] += 1
                grads = [rand((b, w), src_dt) for w in widths]
                same(exchange.pack_grad_blocks(de, plan, grads, b, src_dt),
                     exchange.pack_grad_blocks_plain(de, plan, grads, b,
                                                     src_dt),
                     f"grad pack w{world}")
                dp = rand((world, b, plan.s_max), src_dt)
                outs = exchange.unpack_outputs(de, plan, dp)
                cplan, pieces = exchange._unpack_copy_plan(de, plan)
                buf = torch.empty(sum(b * w for _, w in pieces),
                                  dtype=src_dt, device=dev)
                xp.batched_copy_plain(cplan, [dp], [buf])
                for o, (off, w) in zip(outs, pieces):
                    same(o, buf[off:off + b * w].view(b, w),
                         f"unpack w{world}")
                n["pack_columns"] += 2
    rng = np.random.default_rng(SEED + 601)
    copies = []
    for k in range(1300):
        rows, cols = int(rng.integers(1, 5)), int(rng.integers(1, 20))
        copies.append((-1 if k % 11 == 0 else 0, int(rng.integers(0, 50)),
                       cols + int(rng.integers(0, 3)), 0, k * 100 + (k % 3),
                       cols + (k % 2), rows, cols))
    plan = xp.CopyPlan(copies)
    for dtype in (torch.float32, torch.bfloat16):
        src = rand((400,), dtype)
        got = torch.full((1300 * 100 + 200,), 7.0, device=dev, dtype=dtype)
        want = got.clone()
        before = xp.pack_columns.launches
        xp.pack_columns(plan, [src], [got])
        check(xp.pack_columns.launches - before == -(-1300 // xp.MAX_DESCS),
              "pack edge case: 1300 copies did not split into launches")
        xp.batched_copy_plain(plan, [src], [want])
        same(got, want, f"unaligned copies {dtype}")
        n["pack_columns"] += 1
    torch.cuda.synchronize()
    log(f"world 8 a: K19/K20 edge cases bit-exact to their plain versions "
        f"({n})")
    return n


def w8_rank_shapes(torch, rank):
    """The slice's K19/K20 inputs on one rank of the Criteo-1TB world-8
    layer (planner only): its batch's id entries, the groups' lookups,
    the cotangents and a received output block, bf16."""
    from distributed_embeddings_torch.parallel import exchange

    cfg, de = w8_model(torch, CRITEO_1TB_SIZES, W8_CST, torch.bfloat16)
    de._rank = rank
    b = W8_BATCH // W8
    cats, _ = train_batch(torch, CRITEO_1TB_SIZES, b, seed=SEED + 400 + rank)
    dev = torch.device("cuda")
    entries, encs, _, dt = de._normalize_inputs(cats, dev)
    plan = de._get_plan(encs, b)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 610 + rank)
    reds = [torch.randn((W8 * g.n, b, g.width), generator=gen, device="cuda"
                        ).to(torch.bfloat16) for g in plan.groups]
    _, widths = exchange.slice_map(de, plan)
    grads = [torch.randn((b, w), generator=gen, device="cuda"
                         ).to(torch.bfloat16) for w in widths]
    dp = torch.randn((W8, b, plan.s_max), generator=gen, device="cuda"
                     ).to(torch.bfloat16)
    return de, plan, entries, dt, reds, grads, dp


def w8_shape_checks(torch):
    """14a at the slice's rank shapes (ranks 0 and W8 - 1): each of the
    four packs, kernel against plain and (id block, cotangents) against
    the reference concatenation of cells, bit-exact."""
    from distributed_embeddings_torch.parallel import exchange

    dev = torch.device("cuda")
    errs = {"pack_ids": 0.0, "pack_columns": 0.0}
    for rank in (0, W8 - 1):
        de, plan, entries, dt, reds, grads, dp = w8_rank_shapes(torch, rank)
        b = plan.b
        with pack_checks(torch) as n:
            ids = exchange.build_send_blocks(de, plan, entries, dt, dev)
            check(torch.equal(ids, exchange.build_send_blocks_plain(
                de, plan, entries, dt, dev)), "world 8 rank shapes: id "
                "block differs from the concatenation of cells")
            exchange.pack_lookup_rows(de, plan, reds, torch.bfloat16, dev)
            packed = exchange.pack_grad_blocks(de, plan, grads, b,
                                               torch.bfloat16)
            check(torch.equal(w8_bits(torch, packed), w8_bits(
                torch, exchange.pack_grad_blocks_plain(
                    de, plan, grads, b, torch.bfloat16))),
                "world 8 rank shapes: cotangent block differs from the "
                "concatenation of cells")
            exchange.unpack_outputs(de, plan, dp)
        torch.cuda.synchronize()
        errs = {k: max(v, n["err"][k]) for k, v in errs.items()}
        log(f"world 8 a: rank {rank} shapes (ids [{W8}, {plan.l_max}] "
            f"{str(dt)[6:]}, rows [{W8}, {b}, {plan.s_max}] bf16, groups "
            f"{[(g.width, g.n) for g in plan.groups]}) bit-exact")
        del de, plan, entries, reds, grads, dp, packed, ids
    return errs


def host_ms(torch, fn, runs=TIMED_RUNS):
    """The host's time a call of ``fn`` (launches queued, not waited
    for), in ms: the enqueue cost a step pays when the card keeps up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    t = (time.perf_counter() - t0) / runs * 1e3
    torch.cuda.synchronize()
    return t


def w1_stage_yardstick(torch):
    """The world-1 DLRM's embedding forward and sparse apply stages at
    b=65536 (the 26 tables capped at SMALL_ROWS rows, bf16) with K19/K20,
    and with the id block and the cotangent pack assembled by the
    reference concatenation of cells (torch.cat, what the step ran
    before K19/K20), in one call: CUDA-event medians."""
    from distributed_embeddings_torch.models import DLRMConfig
    from distributed_embeddings_torch.parallel import (DistributedEmbedding,
                                                       SparseSGD, exchange)

    sizes = w8_small_sizes()
    cfg = DLRMConfig(table_sizes=sizes, embedding_dim=128)
    de = DistributedEmbedding(cfg.embedding_configs(), world_size=1,
                              compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 630)
    params = de.init(gen, dtype=torch.bfloat16, device="cuda")
    cats, _ = train_batch(torch, sizes, TRAIN_BATCH, seed=SEED + 631)
    _, res = de.forward_with_residuals(params, cats)
    # the step's cotangents: column slices of the interaction's gradient
    g27 = torch.randn((TRAIN_BATCH, 27, 128), generator=gen, device="cuda"
                      ).to(torch.bfloat16)
    grads = [g27[:, 1 + t] for t in range(len(sizes))]
    opt = SparseSGD()
    st = opt.init(params)
    ok = torch.ones((), dtype=torch.bool, device="cuda")
    stages = {
        "embedding_forward": lambda: de.forward_with_residuals(params, cats),
        "sparse_apply": lambda: de.sparse_apply_gradients(
            params, st, res, grads, opt, TRAIN_LR, enable=ok)}
    real = exchange.build_send_blocks, exchange.pack_grad_blocks
    out = {}
    for via in ("K19/K20", "torch.cat", "K19/K20 again"):
        if via == "torch.cat":
            exchange.build_send_blocks = exchange.build_send_blocks_plain
            exchange.pack_grad_blocks = exchange.pack_grad_blocks_plain
        try:
            for name, fn in stages.items():
                out[f"{name} {via}"] = time_ms(torch, fn, [()])
        finally:
            exchange.build_send_blocks, exchange.pack_grad_blocks = real
    log("world-1 stages (b=65536, capped tables), ms: " + json.dumps(out))
    return out


def pack_kernel_times(torch):
    """14d: K19 and K20 timed alone at rank 0's shapes beside their plain
    versions, one ``torch.cat`` of the same parts (the yardstick) and
    their byte bounds."""
    from distributed_embeddings_torch.ops import exchange_pack as xp
    from distributed_embeddings_torch.parallel import exchange

    de, plan, entries, dt, reds, grads, dp = w8_rank_shapes(torch, 0)
    b, dev = plan.b, torch.device("cuda")
    cells = exchange._cells(de, plan)
    smap, widths = exchange.slice_map(de, plan)
    es = 2  # bf16
    # K19
    cp = exchange._ids_copy_plan(de, plan, entries)
    srcs = [t.contiguous() for t in entries]
    out = torch.empty((W8, plan.l_max), dtype=dt, device=dev)
    zero = {}

    def zeros(n, dtype):
        key = (n, dtype)
        if key not in zero:
            zero[key] = torch.zeros(n, dtype=dtype, device=dev)
        return zero[key]

    parts = []
    for row in cells:
        for gi, g in enumerate(plan.groups):
            for c in row[gi]:
                if c is not exchange._SPANNED:
                    parts.append(
                        zeros(g.blen, dt) if c is None else
                        srcs[plan.instances[c].input_id].reshape(-1))
    read = sum(t.numel() * t.element_size() for t in srcs)
    cases = {"pack_ids": [], "pack_columns": []}

    def case(name, label, fn, plain, lib, nbytes):
        ms = time_ms(torch, fn, [()])
        pms = time_ms(torch, plain, [()])
        lms = time_ms(torch, lib, [()])
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        host = host_ms(torch, fn)
        cases[name].append({"case": label, "ms": ms, "plain_ms": pms,
                            "library_ms": lms, "bound_ms": bound,
                            "bound_by": "bytes", "bytes": nbytes,
                            "host_ms": host,
                            "library_host_ms": host_ms(torch, lib)})
        log(f"time {name} {label}: kernel {ms:.4f} ms, plain {pms:.4f}, "
            f"torch.cat {lms:.4f}, bound {bound:.4f} ({nbytes} bytes); "
            f"host {host:.4f} a call")

    case("pack_ids", "rank0_ids", lambda: xp.pack_ids(cp, srcs, out),
         lambda: xp.pack_ids_plain(cp, srcs, out), lambda: torch.cat(parts),
         read + out.numel() * out.element_size())
    # K20: the cotangent pack, the lookup rows, the unpack
    gp = exchange._grad_copy_plan(de, plan, b)
    packed = torch.empty((W8, b, plan.s_max), dtype=torch.bfloat16,
                         device=dev)
    parts = []
    for dest, row in enumerate(cells):
        for gi, g in enumerate(plan.groups):
            for s, c in enumerate(row[gi]):
                if c is None:
                    parts.append(zeros(b * g.width, torch.bfloat16
                                       ).view(b, g.width))
                elif c is not exchange._SPANNED:
                    i, pos = smap[c]
                    w = plan.out_width(plan.instances[c])
                    parts.append(grads[i][:, pos:pos + w])
    case("pack_columns", "rank0_cotangent_pack",
         lambda: xp.pack_columns(gp, grads, [packed]),
         lambda: xp.pack_columns_plain(gp, grads, [packed]),
         lambda: torch.cat(parts, dim=1),
         sum(g.numel() for g in grads) * es + packed.numel() * es)
    lp = exchange.lookup_copy_plan(de, plan)
    flat = [x.reshape(-1) for x in reds]
    rows_out = torch.empty_like(packed)
    parts = []
    for r in range(W8):
        for gi, g in enumerate(plan.groups):
            live = plan.valid[gi][0] > 0
            for s in range(g.n):
                parts.append(reds[gi][r * g.n + s] if live[s] else
                             zeros(b * g.width, torch.bfloat16
                                   ).view(b, g.width))
    live_read = sum(g.width * b * W8 * int((plan.valid[gi][0] > 0).sum())
                    for gi, g in enumerate(plan.groups)) * es
    case("pack_columns", "rank0_lookup_rows",
         lambda: xp.pack_columns(lp, flat, [rows_out]),
         lambda: xp.pack_columns_plain(lp, flat, [rows_out]),
         lambda: torch.cat(parts, dim=1), live_read + rows_out.numel() * es)
    up, pieces = exchange._unpack_copy_plan(de, plan)
    buf = torch.empty(sum(b * w for _, w in pieces), dtype=torch.bfloat16,
                      device=dev)
    order = []
    for j, inst in enumerate(plan.instances):
        i, pos = smap[j]
        g = plan.groups[inst.group]
        c0 = g.col + inst.slot0 * g.width
        order.append(((i, pos), dp[inst.rank, :, c0:c0 + plan.out_width(
            inst)]))
    parts = [p for _, p in sorted(order, key=lambda t: t[0])]
    case("pack_columns", "rank0_unpack",
         lambda: xp.pack_columns(up, [dp], [buf]),
         lambda: xp.pack_columns_plain(up, [dp], [buf]),
         lambda: torch.cat(parts, dim=1), 2 * buf.numel() * es)
    del reds, grads, dp, buf, packed, rows_out, parts, flat
    # world 1: the DLRM train step's K20 cotangent pack at b=65536, and
    # its K19 id block
    from distributed_embeddings_torch.parallel import DistributedEmbedding

    cfg, _ = w8_model(torch, CRITEO_1TB_SIZES, W8_CST, torch.bfloat16)
    de1 = DistributedEmbedding(cfg.embedding_configs(), world_size=1,
                               compute_dtype=torch.bfloat16)
    cats, _ = train_batch(torch, CRITEO_1TB_SIZES, TRAIN_BATCH, seed=SEED + 620)
    entries, encs, _, dt = de1._normalize_inputs(cats, dev)
    plan = de1._get_plan(encs, TRAIN_BATCH)
    cp = exchange._ids_copy_plan(de1, plan, entries)
    srcs = [t.contiguous() for t in entries]
    out = torch.empty((1, plan.l_max), dtype=dt, device=dev)
    case("pack_ids", "world1_b65536_ids", lambda: xp.pack_ids(cp, srcs, out),
         lambda: xp.pack_ids_plain(cp, srcs, out),
         lambda: torch.cat([t.reshape(-1) for t in srcs]),
         2 * sum(t.numel() * t.element_size() for t in srcs))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 621)
    # the step's cotangents: column slices of the interaction's gradient
    # [b, 27, 128], read in place
    g27 = torch.randn((TRAIN_BATCH, 27, 128), generator=gen, device="cuda"
                      ).to(torch.bfloat16)
    grads = [g27[:, 1 + t] for t in range(len(CRITEO_1TB_SIZES))]
    gp = exchange._grad_copy_plan(de1, plan, TRAIN_BATCH)
    packed = torch.empty((1, TRAIN_BATCH, plan.s_max), dtype=torch.bfloat16,
                         device=dev)
    case("pack_columns", "world1_b65536_cotangent_pack",
         lambda: xp.pack_columns(gp, grads, [packed]),
         lambda: xp.pack_columns_plain(gp, grads, [packed]),
         lambda: torch.cat(grads, dim=1), 2 * packed.numel() * es)
    del grads, g27, packed, srcs, out
    return cases, w1_stage_yardstick(torch)


def phase_world8(torch):
    """Phase 14: the hybrid train step at world 8 on one card (see
    main's docstring). Returns (launches of rank 0's timed window, the
    K19/K20 rows' cases, the largest kernel-vs-plain difference each of
    K19/K20 showed in the phase's checks, the result)."""
    import shutil
    import tempfile

    t_start = time.perf_counter()
    edge = pack_edge_checks(torch)
    errs = dict(edge["err"])
    for k, v in w8_shape_checks(torch).items():
        errs[k] = max(errs[k], v)
    cases, w1_stages = pack_kernel_times(torch)
    _, de = w8_model(torch, CRITEO_1TB_SIZES, W8_CST, torch.bfloat16)
    per_rank = [sum(de.rows_cap[w] * w * 2 for w in de.widths)
                for _ in range(W8)]
    slices = [t for t, n in enumerate(de.slices_per_table) if n > 1]
    log(f"world 8: Criteo-1TB tables, comm_balanced, column slices of "
        f"tables {slices}; rows_cap {de.rows_cap}; bf16 slabs "
        f"{per_rank[0] / 1e9:.2f} GB a rank, {sum(per_rank) / 1e9:.1f} GB "
        f"for {W8} ranks on one card; instances a rank "
        f"{[len(t) for t in de.strategy.table_ids_list]}")
    del de
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="w8_")
    try:
        ref = w8_small_reference(torch, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"world 8 b: world-1 reference on the card, losses "
            f"{[round(x, 5) for x in ref['losses']]}; "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated "
            "before the ranks start")
        ranks, rank_s = w8_run_ranks(torch, tmp)
        small = w8_compare_small(torch, ref, ranks, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("world 8 b: " + json.dumps(small))
    full = [r["full"] for r in ranks]
    r0 = full[0]
    for res in ranks:
        for n in (res["small"]["main"]["checked"],
                  res["small"]["control"]["checked"], res["full"]["checked"]):
            for k, v in n["err"].items():
                errs[k] = max(errs[k], v)
    for r, f in enumerate(full):
        check(f["losses"] == r0["losses"], f"world 8: rank {r}'s losses "
              "differ from rank 0's (one global mean)")
        check(f["checked"]["pack_ids"] == 1
              and f["checked"]["pack_columns"] == 3, f"world 8 rank {r}: "
              f"checked K19/K20 calls {f['checked']}")
    step_ms = [float(np.median(f["step_ms"])) for f in full]
    wall = max(f["wall_s"] for f in full)
    result = {
        "world": W8, "global_batch": W8_BATCH, "steps": W8_STEPS,
        "transport": "gloo over host memory, 8 ranks time-sharing one "
                     "H100 (not a multi-GPU or NCCL number)",
        "samples_per_s_8_ranks_on_one_h100_over_gloo":
            W8_STEPS * W8_BATCH / wall,
        "wall_step_ms": wall / W8_STEPS * 1e3,
        "rank_step_ms_p50": step_ms,
        "stage_ms_p50_by_rank": [f["stages"] for f in full],
        "slab_gb_by_rank": [f["slab_bytes"] / 1e9 for f in full],
        "peak_gb_by_rank": [f["peak_gb"] for f in full],
        "instances_by_rank": [f["instances"] for f in full],
        "plan": r0["plan"], "launches_per_step_rank0": {
            n: v / W8_STEPS for n, v in r0["launches"].items() if v},
        "scatter_max_err": max(f["scatter_err"] for f in full),
        "nan_batch_rows_checked": [f["nan_rows"] for f in full],
        "loss_first": r0["losses"][0], "loss_last": r0["losses"][-1],
        "small": small, "edge_checks": edge, "pack_max_abs_err": errs,
        "world1_stage_ms_k19_k20_vs_cat": w1_stages,
        "rank_seconds": {"small": [r["small"]["seconds"] for r in ranks],
                         "full": [f["seconds"] for f in full],
                         "ranks_total": rank_s},
        "phase_seconds": time.perf_counter() - t_start}
    log("world 8: " + json.dumps(result))
    return r0["launches"], cases, errs, result


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
    promoted_err, promoted_1tb = promoted_full_check(torch, de, state)
    log(f"DLRM peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} "
        f"GB, {time.perf_counter() - t_start:.1f} s so far")
    # the 48.1 GB DLRM slab leaves no room for the zoo: free it
    del state, de
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"DLRM state freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "still allocated")
    zoo_launches, zoo_errs, zoo_cases, zoo = phase_zoo(torch)
    launches["zoo"] = zoo_launches
    for k in kernels:
        k["launches_by_path"]["zoo"] = zoo_launches[k["name"]]
        k["max_abs_err"] = max(k["max_abs_err"], zoo_errs.get(k["name"], 0.0))
        if k["name"] in zoo_cases:
            k["cases"].append(zoo_cases[k["name"]])
    for name, src, repl in (
            ("dedup_sparse_grad", "dedup.cu",
             "distributed_embeddings_tpu/ops/sparse_grad.py:58"),
            ("adagrad_rows", "adagrad.cu",
             "distributed_embeddings_tpu/parallel/optimizers.py:214"),
            ("adagrad_dense", "adagrad.cu",
             "distributed_embeddings_tpu/parallel/optimizers.py:197")):
        c = zoo_cases[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"distributed_embeddings_torch/csrc/{src}",
            "replaces": repl, "launches": zoo_launches[name],
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": zoo_errs[name], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["case"], "cases": [c]})
    log("zoo: " + json.dumps(zoo))
    log(f"zoo peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
        f"{time.perf_counter() - t_start:.1f} s so far")
    torch.cuda.reset_peak_memory_stats()
    ragged_launches, ragged_errs, ragged_cases, ragged = phase_ragged(torch)
    launches["ragged"] = ragged_launches
    for k in kernels:
        k["launches_by_path"]["ragged"] = ragged_launches[k["name"]]
        k["max_abs_err"] = max(k["max_abs_err"],
                               ragged_errs.get(k["name"], 0.0))
        if k["name"] == "sgd_scatter":
            k["cases"].append(ragged_cases["sgd_scatter"])
    csr_names = ("lengths_to_splits", "row_to_split", "ragged_row_ids")
    for name, src, repl, names in (
            ("ragged_combine", "ragged_combine.cu",
             "distributed_embeddings_tpu/ops/embedding_lookup.py:156",
             ("ragged_combine",)),
            ("ragged_grad", "ragged_grad.cu",
             "distributed_embeddings_tpu/parallel/apply.py:222",
             ("ragged_grad",)),
            ("csr", "csr.cu",
             "distributed_embeddings_tpu/parallel/lookup.py:38", csr_names)):
        cases = ragged_cases[name]
        cases = cases if isinstance(cases, list) else [cases]
        c = cases[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"distributed_embeddings_torch/csrc/{src}",
            "replaces": repl,
            "launches": sum(ragged_launches[n] for n in names),
            "launches_by_path": {p: sum(launches[p][n] for n in names)
                                 for p in launches},
            "max_abs_err": ragged_errs[name], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["case"], "cases": cases})
    kernels[-1]["entry_points"] = {
        "lengths_to_splits": "distributed_embeddings_tpu/parallel/"
                             "lookup.py:38",
        "row_to_split": "distributed_embeddings_tpu/ops/"
                        "embedding_lookup.py:116",
        "ragged_row_ids": "distributed_embeddings_tpu/ops/"
                          "embedding_lookup.py:131"}
    log("ragged: " + json.dumps(ragged))
    log(f"ragged peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} "
        f"GB, {time.perf_counter() - t_start:.1f} s so far")
    torch.cuda.reset_peak_memory_stats()
    adam_launches, adam_errs, adam_cases, adam = phase_adam(torch)
    launches.update(adam_launches)
    for k in kernels:
        names = csr_names if k["name"] == "csr" else (k["name"],)
        for p in adam_launches:
            k["launches_by_path"][p] = sum(adam_launches[p][n]
                                           for n in names)
        k["max_abs_err"] = max(k["max_abs_err"],
                               adam_errs.get(k["name"], 0.0))
    for name, src, repl, path in (
            ("adam_rows", "adam.cu",
             "distributed_embeddings_tpu/parallel/optimizers.py:336",
             "adam"),
            ("momentum_rows", "momentum.cu",
             "distributed_embeddings_tpu/parallel/optimizers.py:289",
             "momentum")):
        cases = adam_cases[name]
        c = cases[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"distributed_embeddings_torch/csrc/{src}",
            "replaces": repl, "launches": launches[path][name],
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": adam_errs[name], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["case"], "cases": cases})
    log("adam: " + json.dumps(adam))
    log(f"adam peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    torch.cuda.reset_peak_memory_stats()
    tel_launches, tel_errs, tel_cases, tel = phase_telemetry(torch)
    launches.update(tel_launches)
    k14 = ("topk_pool", "cms_query")
    for k in kernels:
        names = csr_names if k["name"] == "csr" else (k["name"],)
        k["launches_by_path"]["telemetry"] = sum(
            tel_launches["telemetry"][n] for n in names)
    for name, repl, names in (
            ("cms_update",
             "distributed_embeddings_tpu/analysis/telemetry.py:190",
             ("cms_update",)),
            ("cms_query",
             "distributed_embeddings_tpu/analysis/telemetry.py:204", k14),
            ("topk_merge",
             "distributed_embeddings_tpu/analysis/telemetry.py:214",
             ("topk_merge",))):
        cases = []
        for c in (tel_cases[name], ragged_cases["telemetry"][name]):
            cases += c if isinstance(c, list) else [c]
        c = cases[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "distributed_embeddings_torch/csrc/sketch.cu",
            "replaces": repl,
            "launches": sum(launches["telemetry"][n] for n in names),
            "launches_by_path": {p: sum(launches[p][n] for n in names)
                                 for p in launches},
            "max_abs_err": tel_errs[name], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["case"], "cases": cases})
    kernels[-2]["entry_points"] = {
        "topk_pool": "distributed_embeddings_tpu/analysis/telemetry.py:214",
        "cms_query": "distributed_embeddings_tpu/analysis/telemetry.py:204"}
    log("telemetry: " + json.dumps(tel))
    log(f"telemetry peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} "
        f"GB, {time.perf_counter() - t_start:.1f} s so far")
    torch.cuda.reset_peak_memory_stats()
    st_launches, st_errs, st_cases, stream = phase_streaming(torch)
    launches.update(st_launches)
    for k in kernels:
        names = (csr_names if k["name"] == "csr" else k14 if k["name"] ==
                 "cms_query" else (k["name"],))
        for p in st_launches:
            k["launches_by_path"][p] = sum(st_launches[p][n] for n in names)
        k["max_abs_err"] = max(k["max_abs_err"],
                               st_errs.get(k["name"], 0.0))
    for name, repl in (
            ("remap_stage",
             "distributed_embeddings_tpu/parallel/streaming.py:265"),
            ("commit_rows",
             "distributed_embeddings_tpu/parallel/streaming.py:366")):
        cases = st_cases[name]
        c = cases[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "distributed_embeddings_torch/csrc/streaming.cu",
            "replaces": repl, "launches": launches["streaming"][name],
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": st_errs[name], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["case"], "cases": cases})
    kernels[-2]["entry_points"] = {
        "remap_width": "distributed_embeddings_tpu/parallel/streaming.py:265",
        "_streaming_remap": "distributed_embeddings_tpu/parallel/"
                            "dist_embedding.py:1418"}
    log("streaming: " + json.dumps(stream))
    log(f"streaming peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} "
        f"GB, {time.perf_counter() - t_start:.1f} s so far")
    torch.cuda.reset_peak_memory_stats()
    ex_launches, ex_errs, ex_cases, example = phase_example(torch,
                                                            promoted_1tb)
    launches.update(ex_launches)
    for k in kernels:
        names = (csr_names if k["name"] == "csr" else k14 if k["name"] ==
                 "cms_query" else (k["name"],))
        k["launches_by_path"]["example"] = sum(
            ex_launches["example"][n] for n in names)
        k["max_abs_err"] = max(k["max_abs_err"],
                               ex_errs.get(k["name"], 0.0))
    c = ex_cases[0]
    kernels.append({
        "name": "sgd_scatter_promoted", "route": "cuda",
        "source": "distributed_embeddings_torch/csrc/sgd_promoted.cu",
        "replaces": "distributed_embeddings_tpu/parallel/optimizers.py:95",
        "launches": launches["example"]["sgd_scatter_promoted"],
        "launches_by_path": {p: launches[p].get("sgd_scatter_promoted", 0)
                             for p in launches},
        "max_abs_err": max(promoted_err,
                           ex_errs["sgd_scatter_promoted"]),
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        "shape": c["case"], "cases": ex_cases})
    for name in ("gather_combine", "dot_interact_fwd", "dot_interact_bwd",
                 "sgd_scatter_promoted"):
        check(launches["example"][name] > 0,
              f"{name}: no launch on the example's path")
    log("example: " + json.dumps(example))
    log(f"example peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} "
        f"GB, {time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    w8_launches, w8_cases, w8_errs, world8 = phase_world8(torch)
    launches["world8"] = w8_launches
    for k in kernels:
        names = (csr_names if k["name"] == "csr" else k14 if k["name"] ==
                 "cms_query" else (k["name"],))
        k["launches_by_path"]["world8"] = sum(w8_launches[n] for n in names)
    for name, repl, entry_points in (
            ("pack_ids", "distributed_embeddings_tpu/parallel/exchange.py:89",
             {"build_send_blocks": "distributed_embeddings_tpu/parallel/"
                                   "exchange.py:89",
              "assemble_cells": "distributed_embeddings_tpu/parallel/"
                                "exchange.py:43"}),
            ("pack_columns",
             "distributed_embeddings_tpu/parallel/exchange.py:137",
             {"pack_grad_blocks": "distributed_embeddings_tpu/parallel/"
                                  "exchange.py:137",
              "plan_lookup": "distributed_embeddings_tpu/parallel/"
                             "lookup.py:99",
              "unpack": "distributed_embeddings_tpu/parallel/"
                        "dist_embedding.py:1085",
              "collapse_inverse": "distributed_embeddings_tpu/parallel/"
                                  "apply.py:134"})):
        cases = w8_cases[name]
        c = cases[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "distributed_embeddings_torch/csrc/exchange_pack.cu",
            "replaces": repl, "launches": w8_launches[name],
            "launches_by_path": {p: launches[p].get(name, 0)
                                 for p in launches},
            "max_abs_err": w8_errs[name], "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "shape": c["case"],
            "cases": cases, "entry_points": entry_points})
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']}: no launch on its main path")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
