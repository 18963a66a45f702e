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
   K2 at B=256 and B=65536 on the features where the step leaves them,
   the bottom-MLP output and 26 pieces of one buffer: on the tensor
   cores, the appended row bit-exact, the pairs within 1 bf16 ulp,
   bit-identical to the stacked form); K2 and K4 at 1 and 256 features
   (the model's ``dot_interact`` with no tables launches nothing);
5. serve: a few hundred Zipfian requests of 1-8 samples through
   ``drive`` with the kernel launch counters zeroed just before and
   read just after; every result must be ``Served`` with finite
   predictions in (0, 1), a sample of requests must match the same
   samples run through the plain functions, and both serving kernels
   must have launched;
6. train, on the same state after serving:
   a. small tables (capped at 20000 rows) at batch 4096, float32 and
      bf16: 5 instrumented steps (``with_metrics``) with the kernels
      against the same 5 steps with the package's calls routed to the
      plain versions, on the card, the step metrics included;
   b. full size, batch 65536, Zipfian ids: one step whose touched slab
      rows (snapshotted before it) must match the snapshot updated by
      the plain scatter from the same cotangents, whose interaction
      forward (K2) and backward (K4) must match their plain versions on
      the inputs the step gave them, and whose gradient-health
      reduction (K21) and dense update (K22) are held to their plain
      versions where the step calls them;
   c. a NaN batch must leave the touched rows and the dense parameters
      bitwise unchanged and advance the step;
   d. 3 warmup + 20 timed steps with the launch counters zeroed just
      before and read just after (every kernel once per step), 10
      timed instrumented steps, then the same stages called one by one
      for a per-stage split, with K21/K22 and, in turns, with their
      plain versions (the guard's and the dense update's "before");
      with ``--parent`` the step's and the instrumented step's stage
      splits in turns with the parent's wrappers; K21 and K22 timed on
      the step's own gradients and parameters (K21 also on world 8's
      two calls a rank: each cotangent's first 8192 rows, then the dense
      gradients), each with its launch record's host split;
7. time: CUDA-event medians (20+ runs after warmup) of each kernel, its
   plain version, one PyTorch library call for the same function, and
   the least time the card could take (bytes over 3.35 TB/s, operations
   over 989 TFLOP/s bf16, the H100 SXM data-sheet peaks); K2 (rung 256
   and b=65536) and K4 (b=65536) on the step's features through
   ``kernel_case``, in turns with the parent's (its stack and its K2);
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
      as in 7 (K5 also in turns with the parent's and with
      ``torch.unique`` + ``index_add_``, its device ms split by stage:
      sort, boundaries, sum, finish; K6 in turns with the parent's and
      ``torch.optim.Adagrad``'s sparse step, with its record's host
      split, and again at the bf16 tables' w16 shapes), and the w16
      slab through both Adagrad regimes;
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
      bitwise equal, slabs within the k-ulp bound (bitwise since K3 is
      deterministic: K3 runs in both), and a control
      run that drops half the stream must fail that bound;
   c. one full-size step (~1% bad ids): K10's splits, K8's output and
      K9's stream bit-exact against their plain versions on the step's
      own inputs, K3's touched slab rows bit-exact to the stream-order
      sum where a row has at most L (``SPLIT``) hits and within k fp32
      ulps elsewhere (a control dropping every other position must fail),
      K2 and K4 held to their plain versions on the step's own inputs,
      and three features given as ``SparseIds`` (``row_to_split``, K10)
      giving a bitwise-equal forward;
   d. a NaN batch leaving the touched rows and the dense params
      bitwise unchanged;
   e. 3 warmup + 20 timed steps over 4 pre-staged batches with the
      launches counted (K8 1, K9 1, K10 2, K3 1, K2 1, K4 1 a step) and
      a stage split (with ``--parent`` in turns with the parent's);
   f. K8, K9 and K10 timed at this shape as in 7 (K10's
      ``ragged_row_ids`` on the step's own splits, beside
      ``torch.searchsorted``; K8 also with every id folded into the
      first 2,048 rows of its table, all rows resident in the L2, and
      its row reads a second, every one from global memory; the stage
      that served hot rows from shared memory is ``k8_variants.py``'s),
      and K3 on the step's stream with its
      engine's device split, in turns with ``DETPU_SGD_DEDUP=1``'s K5 +
      K3 chain;
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
      its AUCs printed, and K11 timed on the last call of its fp32 run;
   d. the uncapped tiny zoo with ``SparseAdam`` + ``Adam(0.01)``, fp32
      tables: one step with K5 and K11 held to their plain versions on
      the step's own inputs, a NaN batch (slab rows, mu/nu, the counts,
      the dense params and dense Adam state bitwise unchanged), 3 warmup
      + 20 timed steps (launches a step: K1 4, K5 2, K11 2), a stage
      split, the steps in turns with the parent's wrappers, and K11
      timed at the w16 and w8 shapes beside its plain version, its byte
      bound and ``torch.optim.SparseAdam.step``, with its launch
      record's host split (the rows it touches put back after);
   e. the same slabs with ``SparseMomentum(0.9)`` and with Nesterov: one
      checked step and 5 timed steps each, K12 timed; every checked step
      holds K21/K22 to their plain versions where the step calls them,
      and the Adam zoo's stage split and profile run with K22 and with
      its plain version; K22's Adam timed beside
      ``torch.optim.Adam(fused=True)``;
   f. bf16 tables with ``SparseAdam``: one checked step, 20 timed steps,
      the steps in turns with the parent's wrappers, K11 timed as in d.
11. telemetry, after freeing the Adam state: access telemetry
    (``analysis/telemetry.py``, K13-K15 in ``csrc/sketch.cu``) on
    ``bench.py:run_telemetry_overhead``'s configuration (the one-hot
    DLRM over the Criteo-Kaggle vocabularies capped at 2M rows, bf16
    tables and compute, ``SparseSGD`` + SGD at lr 0.005, b=16384, guard
    off, the default sketch):
   a. 3 steps with K13-K15 (a width's fold replayed from one launch
      record) and 3 with their plain versions: every telemetry leaf
      bitwise equal;
   b. 3 lockstep steps with telemetry on and off: losses, dense params
      and K3's inputs bitwise, the slab within the k-ulp bound (bitwise:
      K3 is deterministic);
   c. a NaN batch under the guard: the train state bitwise unchanged,
      its ids folded (bitwise the plain fold of them);
   d. planted hot rows ranked first in their tables by ``hot_rows``;
   e. 2 warmup + 12 timed steps off and on (launches a step: K1, K2,
      K4, K3, K13, K14, K15 once), ``telemetry_overhead_frac`` (with
      ``--parent`` in turns with the parent's K13-K15), and a profile
      window: the device busy share and the sketch chain's device ms a
      step (with ``--parent`` the parent's after it);
   f. K13, K14 and K15 timed on the step's stream (and, in phase 9f, on
      the ragged step's ~26.4M positions) beside their plain versions,
      a PyTorch yardstick and their byte bounds, K13 and K15 through
      ``kernel_case`` (host and device ms, in turns with the parent's),
      the width fold bitwise to its plain version; the host splits of
      K13's, K15's and the fold's records (the fold's beside the
      parent's three wrappers in turns); K14 and K15 also at ``topk``
      2048 with its default 8192 candidates and at 16384 candidates,
      past their tiles (bit-exact first).
12. streaming, after freeing the telemetry state: streaming vocabularies
    (``parallel/streaming.py``; K16 remap and K17 commit in
    ``csrc/streaming.cu``; K16's update folds the admission sketch
    itself, K13's integer adds in its own launch):
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
      one step with K16 (and its sketch fold), K5, K6 and K17 each held to
      its plain version on the step's own inputs, a NaN batch (all state
      bitwise unchanged), 3 warmup + 20 timed steps against the static
      twin (the same slabs without the streaming entries) with
      ``streaming_overhead_frac``, a profile window, the step's stage
      split (remap, forward/dense/guard, sparse apply, commit, dense
      update; with ``--parent`` in turns with the parent's wrappers, as
      is ``streaming_overhead_frac``), Zipfian requests through
      ``ServingRuntime(streaming=)``, K16 (update and read-only, in turns
      with the parent's, each with its record's host split) and K17
      timed beside their plain versions and byte bounds, K5 timed on the
      checked step's w128 stream as in 8e, and K6 on that step's K5
      output as in 8e.
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
      step 24000 (lr 24): K18's touched rows bit-exact to the plain
      version on the step's own inputs, then K18 timed on that
      1,703,936-id stream beside K3 in turns, the plain version,
      ``index_add_`` and its byte bound, with its engine's device split;
   c. the example in process at the capped Criteo-Kaggle size (10,569,296
      rows, 2.71 GB bf16), dim 128, the default MLPs, b=65536, lr 24:
      run A 40 steps with eval every 20 and 1 s of serving at 200 QPS
      (every request ``Served``), launches counted (K1, K2, K4, K18);
      run B 20 steps with ``--save_state``, then ``--restore_state`` to
      step 40: losses, slab, dense params, schedule count and step
      bitwise equal to A's; samples/s, save and restore seconds,
      checkpoint bytes, AUC; the example's step in turns with the
      parent's wrappers (``--parent``); K18 timed at this shape;
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
   e. row-sliced tables (``row_slice``) and model-parallel input
      (``MpInputs``, ``pack_mp_inputs``):
      a. (run after 14a, in this process) K1, K8 and K9 with per-slot
         row bases and K20's summing descriptor against their plain
         versions, bit-exact: slice-edge ids (``rbase - 1``, ``rbase``,
         ``rbase + rows - 1``, ``rbase + rows``, negative, past the
         table), fp32 and bf16, masked and unmasked slots in one launch,
         in-block weights, rows past the capacity; sums of k = 2, 4 and
         8 parts in fp32 and bf16 with NaN and Inf bits and an unaligned
         width; a CUDA-graph replay of each new record. Then (after 14d,
         alone) K1 with row bases and K20's unpack with its sums timed at
         e-c's rank-0 shapes, K8 and K9 with row bases on a ragged block
         of 32 slots (8 sources x 4 row slices of a 2M-row table) at
         b=2048, beside their plain versions and byte bounds;
      b. 14b's small tables and world-1 run, row-sliced (``row_slice``
         700,000, no column slicing), fed by ``pack_mp_inputs``: 5 world-8
         steps and an eval batch within 14b's bounds of world 1; the same
         steps with data-parallel input equal bit for bit; a control with
         rank 3's row bases dropped must fail the bounds; every K20 call
         and every K1 call with row bases bit-exact to its plain version
         on the step's own inputs;
      c. the Criteo-1TB tables at width 128, ``row_slice`` 1.4e9 and no
         column slicing (tables 0, 9, 19, 20 and 21 split 4 ways; 6.67 GB
         of bf16 slab a rank), bf16, ``SparseSGD`` + SGD at 0.005, guard
         on, global batch 65536 of Zipfian ids as ``MpInputs``: one
         checked step (K1 with row bases and K20 bit-exact on every rank,
         each width slab's touched rows against the plain scatter), 2
         warmup + 5 timed steps with the launches counted (a rank a step:
         K1 1 with row bases, K19 0, K20 3 with one sum, K2 1, K4 1, K3
         1, K21 2, K22 1) and the stage split (no id exchange runs);
      d. ``distributed_embeddings_torch.dryrun.dryrun_multichip(8)`` on
         ``cuda:0``: both slicing modes engaged, a finite loss, every
         row-slice mode launched (K8 and K9 with row bases on its ragged
         feature).
   f. the instrumented hybrid step at world 8 (``with_metrics``,
      ``telemetry=``, ``dynamic=``; run in the same rank processes after
      14e-c): every rank carries its own row of the telemetry and
      streaming state, folds the ids it received (K13, K14's pool and
      K15 a width), remaps and commits its own streaming tables (K16,
      K17), runs K21 on its cotangents and on the averaged dense
      gradients, and gathers every rank's metrics (one all-gather):
      a. 14b's small tables, row-sliced (``row_slice`` 700,000), tables
         7, 13, 15, 17 and 24 streaming (their ids Zipfian over 4x their
         rows), fp32, the guard, the metrics and the default telemetry
         on, b=4096 global: 5 lockstep steps, each with the kernels and,
         from a copy of the same state, through ``plain_kernels()``: on
         every rank the telemetry and streaming states bitwise equal,
         the metrics' counts exact (the loss and norms within 1e-3
         relative, 6a's bound), the slabs within 14b's bounds; a NaN
         batch on rank 5 (every rank skips: slabs, dense parameters and
         streaming state bitwise unchanged, ``skipped_steps`` all 1,
         telemetry still counts); a control dropping the row bases of
         one rank's telemetry stream must change that rank's telemetry
         and no other's;
      b. 14c's Criteo-1TB configuration with ``with_metrics`` and the
         default ``TelemetryConfig``: one checked step (each width fold
         bitwise its plain fold on the same state and stream, K19/K20
         bit-exact, the per-rank ``ids_routed`` summing to every slice's
         65,536 ids, no overflow or invalid id, the byte metrics the
         plan's), 2 warmup steps, then 3 timed steps each with
         telemetry and metrics off, on, on, off (launches a rank a step
         counted: 14c's plus K13, K14's pool and K15 once), the calls of
         the fold and of K21 timed inside the step, and the stage splits
         off and on (the fold and the metrics gather as stages);
      c. 12c's streaming DLRM (the capped Criteo-Kaggle tables, five
         streaming, ``SparseAdagrad``, the guard on) across the 8 ranks,
         b=65,536 global: one checked step (every K16 and K17 call held
         to its plain version on the owning rank), 2 warmup + 3 timed
         steps (K16 and K17 timed inside the step), ``occupancy``
         gathered on every rank.
      Its samples/s are those of 8 ranks time-sharing one H100 over
      gloo. ``python3 chip_smoke.py --world8f`` runs phases 1, 2 and 14f
      alone (to debug it; it prints no result).
   g. the K-microbatch pipelined step (``schedule=pipelined_schedule(2)``;
      run in the same rank processes after 14f): each rank's id, output
      and cotangent exchanges stay in flight (gloo ``async_op``) under
      the other microbatch's lookups and dense work:
      a. 14f-a's model, batches, telemetry, metrics and guard with the
         pipelined K = 2 step: 3 lockstep steps, each with the kernels,
         from a copy of the same state through ``plain_kernels()``
         (telemetry, streaming state and metric counts bitwise, slabs
         within 14b's bounds) and, from another copy, the serialized
         step on the kernels (losses, slabs and dense parameters within
         JAX's rtol 2e-5 / atol 2e-6, the integer state and metric
         counts bitwise); launches a rank a step checked (K16 read-only
         once a microbatch and its update once on the ranks holding a
         streaming table); a NaN batch on rank 5 skipped on every rank
         with the state's bits kept and telemetry counting;
      b. 14c's Criteo-1TB step (bf16, b=65,536 global), one layer
         serialized and one pipelined over one state: one checked
         pipelined step (K19/K20 bit-exact, launches a rank a step: K19,
         K1, K20, K2 and K4 once a microbatch, K3 once a slab, K21
         twice, K22 once), 2 warmup steps each, then 3 timed steps each
         serialized, pipelined, pipelined, serialized (launches counted),
         and 3 steps each with every phase scope timed (host ms and
         CUDA-event ms by phase, the exchanges' waits among them);
   And in the main process, on the DLRM state right after phase 6: c.
   the world-1 DLRM step pipelined K = 2 beside the
   serialized one, 10 timed steps each in turns (serialized, pipelined,
   pipelined, serialized), launches counted (K19, K1, K20, K2 and K4
   once a microbatch, K3, K21 and K22 once a step).
   ``python3 chip_smoke.py --world8g`` runs phases 1, 2 and 14g-a/b
   alone (to debug it; it prints no result).
   h. the DLRM example, its checkpoints and the convergence driver at
      world 8 (eight more rank processes on ``cuda:0``, each calling
      ``examples/dlrm_main.py``'s ``main`` with ``--world_size 8
      --rank r --backend gloo``, or ``train_dlrm_convergence(world_size=
      8)``):
      a. 14b's small tables row-sliced as 14e-b's (``--row_slice``
         700,000), bf16, telemetry on (``DETPU_TELEMETRY=1``),
         ``--dp_input``, b=4096 global, base lr 240: from one state saved
         at step 0, 6 steps on the card (launches a rank counted: K1,
         K2, K4, K18, K19, K20, K21 twice a step, K22, K13, K14's pool,
         K15), the same as 3 steps + ``--save_state`` + a resume to 6
         (bitwise equal on every rank), and the same 6 steps with
         ``--device cpu`` (the plain versions): losses and dense
         parameters within 1e-5, every bf16 slab element within one
         bf16 ulp of its magnitude or 1e-6, and the slabs' update within
         ``W8H_BOUNDS``' relative L2 of the CPU's (two controls must
         fail that on every rank: the state before the steps, and half
         of the CPU run's update);
      b. 13c's configuration at world 8 with ``MpInputs`` (26 capped
         Kaggle vocabularies, 10,569,296 rows, 2.71 GB bf16, dim 128,
         b=65,536 global, lr 24): run A 40 steps with eval every 20 and
         ``--metrics_out`` every 10; run B 20 steps with
         ``--save_state``; run C restored from B to 40: losses and every
         rank's slabs, dense parameters and schedule count bitwise A's;
         step ms and samples/s, the chief-written save's and the
         restore's seconds, the checkpoint's bytes; then B's world-8
         checkpoint restored by the example at world 1 under
         ``DETPU_ON_MISMATCH=reshard`` in the main process: its dump
         bitwise the world-8 dump of step 20;
      c. ``tests/test_convergence.py``'s run uncut (8 tables of 200,
         dim 8, b=1024, 240 steps): end AUC > 0.82 and start < middle <
         end, the same AUCs on every rank.
      ``python3 chip_smoke.py --world8h`` runs phases 1, 2 and 14h alone
      (to debug it; it prints no result).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Run from the root of a checkout:
``python3 chip_smoke.py``. With ``--parent DIR`` (a checkout of another
commit, e.g. unpacked with ``git archive``), the launch-record kernels
K1-K6, K8, K10-K13, K15-K22 are also timed through that
checkout's wrappers, in turns with this tree's (``in_turns``), K1 is
held bit-exact to that checkout's K1 at phase 4's shapes and the zoo's
(and K2 within its tolerance of that checkout's), and the DLRM,
instrumented, ragged and example steps, their stage splits and serving
latency run through both sides' wrappers in turns (``steps_in_turns``,
``stages_in_turns``, ``serve_in_turns``); without it those "before"
numbers are not measured.
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
# every train step updates its dense half once (K22); a guarded or
# instrumented step also reads its gradients' health once (K21)
EPILOGUE_KERNELS = ("grad_health", "dense_update")
DLRM_KERNELS = ("gather_combine", "dot_interact_fwd", "dot_interact_bwd",
                "sgd_scatter") + EXCHANGE_KERNELS + EPILOGUE_KERNELS
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, fp32 (no tensor cores)
ZOO_LR = 0.01                  # both optimizers' lr in bench.py:run_tiny_zoo
ZOO_BATCH = 65536
ZOO_BATCHES = 4                # distinct batches the timed steps cycle over
K5_KERNELS = ("seg_hist", "seg_sort_pass", "dd_rank", "dd_sum",
              "dd_finish")  # csrc/dedup.cu's launch chain on the engine
# the engine's sort launches under K5's key policy (K3's run under RowKey)
K5_CHAIN = re.compile(r"namespace\)::((?:seg_hist|seg_sort_pass)(?=<[^>]*"
                      r"IdKey)|dd_rank|dd_sum|dd_finish)[<(]")
#: K5's launches by the stage of the call each belongs to: this tree's
#: chain on the engine and the first design's (``--parent``) chain on
#: ``radix_sort.cuh`` (its scans serve the sort and the boundary count)
DEDUP_STAGES = (("seg_hist", "sort"), ("seg_sort_pass", "sort"),
                ("dd_rank", "boundaries"), ("dd_sum", "sum"),
                ("dd_finish", "finish"), ("init_keys", "sort"),
                ("radix_hist", "sort"), ("scan_reduce", "sort"),
                ("scan_partials", "sort"), ("scan_apply", "sort"),
                ("radix_scatter", "sort"), ("count_bounds", "boundaries"),
                ("seg_sum", "sum"), ("seg_fix", "finish"),
                ("fill_tail", "finish"))


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


#: a checkout of the parent commit (``--parent DIR``): its K19/K20/K22
#: wrappers are timed in turns with this tree's; None: not measured
PARENT_DIR = None
_parent = {}


def parent_ops():
    """The parent checkout's ``ops.dense_update``, ``ops.exchange_pack``,
    ``ops.embedding_lookup``, ``ops.scatter_add``, ``ops.interaction``,
    ``ops.sparse_grad``, ``ops.grad_health``, ``ops.adam``,
    ``ops.adagrad``, ``ops.momentum``, ``ops.streaming`` and
    ``ops.sketch`` modules, its ``models.dlrm`` (key ``"dlrm"``) and its
    ``analysis.telemetry`` (key ``"telemetry"``), loaded under the
    package name
    ``detpu_parent`` (its kernels built from its own sources into its own
    ``build/``), or None without ``--parent``."""
    if PARENT_DIR is None:
        return None
    if not _parent:
        import importlib
        import importlib.util

        root = os.path.join(PARENT_DIR, "distributed_embeddings_torch")
        spec = importlib.util.spec_from_file_location(
            "detpu_parent", os.path.join(root, "__init__.py"),
            submodule_search_locations=[root])
        mod = importlib.util.module_from_spec(spec)
        sys.modules["detpu_parent"] = mod
        spec.loader.exec_module(mod)
        importlib.import_module("detpu_parent.ops._kernels").build_all(
            ["dense_update", "exchange_pack", "gather_combine", "csr",
             "sgd_scatter", "sgd_promoted", "dot_interact",
             "ragged_combine", "ragged_grad", "dedup", "grad_health", "adam",
             "adagrad", "momentum", "streaming", "sketch"])
        for name in ("dense_update", "exchange_pack", "embedding_lookup",
                     "scatter_add", "interaction", "sparse_grad",
                     "grad_health", "adam", "adagrad", "momentum",
                     "streaming", "sketch"):
            _parent[name] = importlib.import_module(
                f"detpu_parent.ops.{name}")
        _parent["dlrm"] = importlib.import_module("detpu_parent.models.dlrm")
        _parent["telemetry"] = importlib.import_module(
            "detpu_parent.analysis.telemetry")
    return _parent


def in_turns(torch, fn, parent_fn, lib=None):
    """CUDA-event ms and host ms a call of ``fn`` (this tree's wrapper),
    ``lib`` (the library call, or None) and ``parent_fn`` (the parent's,
    or None), in turns: change, library, parent, parent, library,
    change; each side's ms is the median of its two runs' medians."""
    out = {f"{tag}{m}": [] for tag in ("", "library_", "parent_")
           for m in ("ms", "host_ms")}
    order = ((fn, ""), (lib, "library_"), (parent_fn, "parent_"),
             (parent_fn, "parent_"), (lib, "library_"), (fn, ""))
    for f, tag in order:
        if f is None:
            continue
        out[tag + "ms"].append(time_ms(torch, f, [()]))
        out[tag + "host_ms"].append(host_ms(torch, f))
    return {k: float(np.median(v)) if v else None for k, v in out.items()}


#: the K1, K8 and K10 call sites of the steps and the forward: (module,
#: global) pairs that ``parent_wrappers`` routes to the parent's wrappers
LOOKUP_SITES = (("lookup", "gather_combine"), ("lookup", "lengths_to_splits"),
                ("lookup", "ragged_combine"), ("apply", "lengths_to_splits"),
                ("dist_embedding", "row_to_split"))


def parent_fold(wstate, ids, live, candidates, total=None, first=True):
    """A width's fold through the parent checkout's K13, K14 pool and K15
    wrappers (its ``analysis.telemetry._record``), its count set into or
    added to ``total`` as ``ops.sketch.fold_ids`` does."""
    par = parent_ops()
    sk = par["sketch"]
    counts = sk.cms_update(wstate["cms"], ids, live)
    pool = sk.topk_pool(wstate["cms"], ids, live, min(candidates,
                                                      ids.numel()))
    count = sk.topk_merge(wstate["cms"], pool, counts, wstate["topk_ids"],
                          wstate["topk_est"], wstate["ids"], candidates)
    if total is not None:
        if first:
            total.copy_(count)
        else:
            total.add_(count)


def parent_dense_branch(slab, acc, ids, vals, lr, eps):
    """``SparseAdagrad``'s dense-apply branch as the parent checkout runs
    it: a zero gradient slab, its K3 into it, its K7 over the slab."""
    import torch

    par = parent_ops()
    g = torch.zeros(slab.shape, dtype=acc.dtype, device=slab.device)
    par["scatter_add"].sgd_scatter(g, ids, vals, -1.0)
    par["adagrad"].adagrad_dense(slab, acc, g, lr, eps)
    return slab, acc


@contextlib.contextmanager
def parent_wrappers():
    """Route the steps' K19/K20/K22, K3/K18, K5, K6, K7, K11, K12, K16,
    K17, K21 and K13-K15 call sites (the module globals
    ``parallel.exchange.pack_ids``/
    ``pack_columns``, ``parallel.optimizers.dense_update``/
    ``sgd_scatter``/``dedup_sparse_grad``/``adagrad_rows``/``adam_rows``/
    ``momentum_rows``/``adagrad_dense``, ``parallel.optimizers.
    adagrad_dense_scatter`` (the parent's chain, ``parent_dense_branch``),
    ``parallel.streaming.remap_stage``/``commit_rows``,
    ``parallel.trainer.grad_health`` and ``analysis.telemetry.
    sketch_fold``, which ``parent_fold`` serves: the parent's
    ``sgd_scatter`` takes its own K18 for the promoted chain), the
    interaction (``models.dlrm.dot_interact``: the parent's stacks the
    features and runs its K2 and K4) and their K1/K8/K10 call sites
    (``LOOKUP_SITES``) to the parent checkout's wrappers, each copy plan
    handed over as the parent's ``CopyPlan`` of the same copies."""
    import importlib

    from distributed_embeddings_torch.analysis import telemetry as tmod
    from distributed_embeddings_torch.models import dlrm
    from distributed_embeddings_torch.parallel import (exchange, optimizers,
                                                       trainer)
    from distributed_embeddings_torch.parallel import streaming as smod

    par = parent_ops()
    plans = {}

    def their(plan):
        got = plans.get(id(plan))
        if got is None:
            got = plans[id(plan)] = (plan, par["exchange_pack"].CopyPlan(
                plan.a.tolist(), plan.src_width))
        return got[1]

    saved = (exchange.pack_ids, exchange.pack_columns,
             optimizers.dense_update, optimizers.sgd_scatter,
             optimizers.dedup_sparse_grad, dlrm.dot_interact,
             trainer.grad_health, optimizers.adam_rows,
             optimizers.adagrad_rows, smod.remap_stage,
             optimizers.momentum_rows, smod.commit_rows, tmod.sketch_fold,
             optimizers.adagrad_dense, optimizers.adagrad_dense_scatter)
    # the parent's interaction: its stack of the features, then its K2
    # (and, through its autograd Function, its K4)
    dlrm.dot_interact = par["dlrm"].dot_interact
    exchange.pack_ids = (lambda plan, srcs, out: par["exchange_pack"]
                         .pack_ids(their(plan), srcs, out))
    exchange.pack_columns = (lambda plan, srcs, dsts: par["exchange_pack"]
                             .pack_columns(their(plan), srcs, dsts))
    optimizers.dense_update = par["dense_update"].dense_update
    optimizers.sgd_scatter = par["scatter_add"].sgd_scatter
    optimizers.dedup_sparse_grad = par["sparse_grad"].dedup_sparse_grad
    trainer.grad_health = par["grad_health"].grad_health
    optimizers.adam_rows = par["adam"].adam_rows
    optimizers.adagrad_rows = par["adagrad"].adagrad_rows
    smod.remap_stage = par["streaming"].remap_stage
    optimizers.momentum_rows = par["momentum"].momentum_rows
    smod.commit_rows = par["streaming"].commit_rows
    tmod.sketch_fold = parent_fold
    optimizers.adagrad_dense = par["adagrad"].adagrad_dense
    optimizers.adagrad_dense_scatter = parent_dense_branch
    mods = {m: importlib.import_module(
        f"distributed_embeddings_torch.parallel.{m}")
        for m, _ in LOOKUP_SITES}
    lookups = [getattr(mods[m], name) for m, name in LOOKUP_SITES]

    def without_rbase(fn):
        # the parent's wrappers have no row bases: this tree's call sites
        # pass rbase=None on an unsliced group
        def call(*a, rbase=None, **kw):
            check(rbase is None, "the parent's lookups take no row bases")
            return fn(*a, **kw)
        return call

    for m, name in LOOKUP_SITES:
        fn = getattr(par["embedding_lookup"], name)
        setattr(mods[m], name, without_rbase(fn) if name in (
            "gather_combine", "ragged_combine") else fn)
    try:
        yield
    finally:
        (exchange.pack_ids, exchange.pack_columns,
         optimizers.dense_update, optimizers.sgd_scatter,
         optimizers.dedup_sparse_grad, dlrm.dot_interact,
         trainer.grad_health, optimizers.adam_rows,
         optimizers.adagrad_rows, smod.remap_stage,
         optimizers.momentum_rows, smod.commit_rows, tmod.sketch_fold,
         optimizers.adagrad_dense, optimizers.adagrad_dense_scatter) = saved
        for (m, name), fn in zip(LOOKUP_SITES, lookups):
            setattr(mods[m], name, fn)


def steps_in_turns(torch, run_step, rounds=2, steps=10, warmup=2):
    """A step through this tree's K1/K3/K10/K18/K19/K20/K22 wrappers and
    through
    the parent's (``parent_wrappers``) in turns: change, parent, parent,
    change, ``rounds`` times; ``run_step(k)`` runs step ``k``. Per side
    the median CUDA-event ms a step and the median of the turns' host
    wall ms a step; None without ``--parent``."""
    if parent_ops() is None:
        return None
    ms = {"change": [], "parent": []}
    wall = {"change": [], "parent": []}
    k = 0
    for _ in range(rounds):
        for side in ("change", "parent", "parent", "change"):
            with (parent_wrappers() if side == "parent"
                  else contextlib.nullcontext()):
                for _ in range(warmup):
                    run_step(k)
                    k += 1
                torch.cuda.synchronize()
                ev = []
                t0 = time.perf_counter()
                for _ in range(steps):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    run_step(k)
                    end.record()
                    ev.append((start, end))
                    k += 1
                torch.cuda.synchronize()
                wall[side].append((time.perf_counter() - t0) / steps * 1e3)
                ms[side] += [a.elapsed_time(b) for a, b in ev]
    return {f"{side}_{what}": float(np.median(v[side]))
            for what, v in (("step_ms_p50", ms), ("wall_step_ms", wall))
            for side in ("change", "parent")}


def host_profile_in_turns(torch, run_step, steps=6, top=14):
    """The host's self time a step by operation (``torch.profiler``, CPU
    events only), through this tree's wrappers and the parent's
    (``parent_wrappers``), change then parent, after two warmup steps
    each: per side the ``top`` operations by self time and the sum over
    all of them, in microseconds a step."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for side in ("change", "parent"):
        with (parent_wrappers() if side == "parent"
              else contextlib.nullcontext()):
            for k in range(2):
                run_step(k)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                for k in range(steps):
                    run_step(k)
                torch.cuda.synchronize()
        ev = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        out[side] = {
            "self_cpu_us_a_step": sum(e.self_cpu_time_total for e in ev)
            / steps,
            "top": {e.key: [round(e.self_cpu_time_total / steps, 1),
                            e.count / steps] for e in ev[:top]}}
    return out


def device_ms(torch, fn, calls=20):
    """Device-only ms a call of ``fn``: ``torch.profiler``'s CUDA events
    (kernels and copies on the card) over ``calls`` calls, as
    ``zoo_profile`` reads them; None if three traces hold no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
        if busy > 0:
            return busy / 1e3 / calls
    return None


def us_per_call(fn, n=2000, repeat=5):
    """Host microseconds a call of ``fn`` (best of ``repeat`` loops of
    ``n`` calls)."""
    import timeit

    fn()
    return min(timeit.repeat(fn, number=n, repeat=repeat)) / n * 1e6


def launch_host_split(torch, what, key_fn, cache, tail, wrapper, ts,
                      extra=None, calls=500, launches=None):
    """The host time of a launch record's hit path, split: building the
    key (``key_fn``), finding the record (``cache``'s dict, with a fresh
    key each call, as the wrapper hashes one), the ``ctypes`` calls of
    its replay (``tail``: the per-call pointers) and the stream read,
    against the whole wrapper call; beside them the stream read through
    ``torch.cuda.current_stream(dev).cuda_stream`` and the key of the
    same tensors built one tuple a tensor (``ts``), the forms the
    launch path did not take, and ``extra`` (name -> a call: more parts
    of the wrapper, timed alone and also taken out of ``rest_us``).
    ``calls``: launching calls a timing (few where the card takes longer
    than the host, so that the launch queue never fills). ``launches``:
    ``(call, count)``, the record's ``ctypes`` calls where they are not
    its own ``calls`` with ``tail`` (a record of records). Microseconds."""
    from distributed_embeddings_torch.ops import _kernels

    torch.cuda.synchronize()
    rec = cache.records[key_fn()]
    dev = torch.device("cuda", rec.device)
    keys = [key_fn() for _ in range(2000)]
    it = iter(keys * 6)
    stream = _kernels.stream_handle(rec.device)

    def own_launches():
        for fn, head in rec.calls:
            fn(*head, *tail, stream)

    launch, n_launches = launches or (own_launches, len(rec.calls))
    out = {
        "key_us": us_per_call(key_fn),
        "lookup_us": us_per_call(lambda: cache.get(next(it)),
                                 n=2000, repeat=5),
        "ctypes_us": us_per_call(launch, n=calls),
        "stream_us": us_per_call(lambda: _kernels.stream_handle(
            rec.device)),
        "wrapper_us": us_per_call(wrapper, n=calls),
        "stream_object_us": us_per_call(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "key_tuple_a_tensor_us": us_per_call(lambda: tuple(
            (t.data_ptr(), t.shape, t.stride(), t.dtype, t.get_device())
            for t in ts)),
        "tensors_in_key": len(ts), "launches_per_call": n_launches}
    parts = ["key_us", "lookup_us", "ctypes_us", "stream_us"]
    for name, fn in (extra or {}).items():
        out[name] = us_per_call(fn, n=calls)
        if name != "through_forward_record_us":
            parts.append(name)
    torch.cuda.synchronize()
    out["rest_us"] = out["wrapper_us"] - sum(out[k] for k in parts)
    log(f"host split {what} (us a call): " + json.dumps(out))
    return out


def call_floor(torch, what, fn, parent_fn=None, calls=20, runs=5):
    """Where a single call's event ms goes beyond its host and device
    time: CUDA-event ms a call of ``fn`` (and of ``parent_fn``, in turns
    with it) with ``calls`` calls between two events, over ``calls``
    (``back_to_back_ms``: the host enqueues while the card runs), the
    median of ``runs``; the host's time of one call right after the card
    went idle (``single_host_ms``, the median of ``calls``: what a
    single call between two events pays before its launch, where
    ``host_ms`` is the mean of a loop of calls); and of one call of
    ``fn`` captured in a CUDA graph, each replay between two events
    (``graph_ms``: the launches with no wrapper host work; None where
    the capture fails, with the error)."""
    def back_to_back(f):
        for _ in range(calls):
            f()
        torch.cuda.synchronize()
        ms = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                f()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end) / calls)
        return float(np.median(ms))

    def single_host(f):
        ms = []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f()
            ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return float(np.median(ms))

    sides = [(fn, "")] + ([(parent_fn, "parent_")] if parent_fn else [])
    out = {}
    for name, how in (("back_to_back_ms", back_to_back),
                      ("single_host_ms", single_host)):
        got = {}
        for f, tag in sides + sides[::-1]:
            got.setdefault(tag, []).append(how(f))
        out.update({f"{tag}{name}": float(np.median(v))
                    for tag, v in got.items()})
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        out["graph_ms"] = time_ms(torch, graph.replay, [()])
        del graph
    except Exception as e:  # the diagnostic's result is the report
        torch.cuda.synchronize()
        out.update(graph_ms=None, graph_error=str(e)[:200])
    log(f"call floor {what} (ms a call): " + json.dumps(out))
    return out


def kernel_case(torch, name, label, fn, parent_fn, lib, nbytes, plain=None,
                extra=None):
    """One timed case of a launch-record kernel: event ms and host ms a
    call of this tree's wrapper and, in turns, the parent's; device-only
    ms; the plain version's ms; the library call's event ms and host ms
    (in the same turns); the byte bound."""
    t = in_turns(torch, fn, parent_fn, lib)
    case = {"case": label, "ms": t["ms"], "host_ms": t["host_ms"],
            "device_ms": device_ms(torch, fn),
            "parent_ms": t["parent_ms"],
            "parent_host_ms": t["parent_host_ms"],
            "parent_device_ms": (device_ms(torch, parent_fn) if parent_fn
                                 else None),
            "plain_ms": time_ms(torch, plain, [()]) if plain else None,
            "library_ms": t["library_ms"],
            "library_host_ms": t["library_host_ms"],
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": nbytes, **(extra or {})}
    fmt = {k: ("not measured" if v is None else f"{v:.4f}")
           for k, v in case.items() if k.endswith("ms")}
    log(f"time {name} {label}: kernel {fmt['ms']} ms (host {fmt['host_ms']}"
        f" a call, device {fmt['device_ms']}); parent {fmt['parent_ms']} "
        f"(host {fmt['parent_host_ms']}); plain {fmt['plain_ms']}; library "
        f"{fmt['library_ms']} (host {fmt['library_host_ms']}); parent device "
        f"{fmt['parent_device_ms']}; bound "
        f"{fmt['bound_ms']} ({nbytes} B)")
    return case


#: the launches of K3's and K18's engine (csrc/segment_scatter.cuh), by
#: the stage of the call each belongs to
SEGMENT_STAGES = (("seg_hist", "sort"), ("seg_sort_pass", "sort"),
                  ("seg_list", "segments"), ("seg_rows", "rows"),
                  ("seg_combine", "rows"))


def segment_split(torch, fn, calls=10, stages=SEGMENT_STAGES):
    """Device ms a call of a K3/K18 wrapper split into the engine's sort
    (the histogram and the digit passes), segment lists and rows pass
    (with K3's combine), and its launches a call: ``torch.profiler``'s
    CUDA events over ``calls`` calls (``stages``: kernel name -> stage,
    ``DEDUP_STAGES`` for K5)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {f"{st}_ms": 0.0 for _, st in stages}
    out.update(other_ms=0.0, launches_per_call=0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        stage = next((st for name, st in stages
                      if f"::{name}<" in e.key or f"::{name}(" in e.key),
                     "other")
        out[f"{stage}_ms"] += e.self_device_time_total / 1e3 / calls
        if stage != "other":
            out["launches_per_call"] += e.count / calls
    return out


def ab_ms(torch, a, b):
    """CUDA-event ms of ``a`` and ``b`` in turns a, b, b, a (each side the
    median of its two runs' medians)."""
    ta, tb = [], []
    for f, out in ((a, ta), (b, tb), (b, tb), (a, ta)):
        out.append(time_ms(torch, f, [()]))
    return float(np.median(ta)), float(np.median(tb))


def segment_case(torch, name, label, fn, parent_fn, lib, nbytes, plain,
                 ids, rows, extra=None):
    """``kernel_case`` for a K3/K18 call, with the engine's device split
    (``segment_split``), the stream's distinct rows and its longest
    segment (the hottest row's hits)."""
    from distributed_embeddings_torch.ops.scatter_add import SPLIT

    keep = ids.long()
    keep = torch.where(keep < 0, keep + rows, keep)
    keep = keep[(keep >= 0) & (keep < rows)]
    counts = torch.unique(keep, return_counts=True)[1]
    ext = {"ids": ids.numel(), "kept": keep.numel(),
           "unique_rows": counts.numel(),
           "longest_segment": int(counts.max()) if counts.numel() else 0,
           "rows_over_split": int((counts > SPLIT).sum()),
           **(extra or {})}
    del keep, counts
    case = kernel_case(torch, name, label, fn, parent_fn, lib, nbytes,
                       plain=plain, extra=ext)
    case["device_split"] = segment_split(torch, fn)
    log(f"  {name} {label}: device split {json.dumps(case['device_split'])}"
        f"; longest segment {ext['longest_segment']}, "
        f"{ext['rows_over_split']} rows over L")
    return case


def compare(torch, got, want, exact, what, scale=None):
    """Max abs error of kernel vs plain (compared on the card in fp32,
    which holds every bf16 value); raises beyond the tolerance:
    bit-exact, or within 1 bf16 ulp of the plain result, plus 2^-20 of
    ``scale`` (the sum of |terms| of each output) where given (K4, whose
    sums of F terms a column the plain version orders otherwise)."""
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
        if scale is not None:
            ulp = ulp + 2.0 ** -20 * scale
        bad = int(torch.count_nonzero(err > ulp))
    max_err = float(err.max())
    check(bad == 0, f"{what}: {bad} values beyond tolerance "
          f"(max err {max_err})")
    log(f"  {what}: max_abs_err {max_err} ("
        + ("bit-exact" if exact else "<= 1 bf16 ulp" if scale is None
           else "<= 1 bf16 ulp + 2^-20 of the sum of |terms|")
        + " required)")
    return max_err


def step_features(torch, gen, b, f=27, d=128, dtype=None):
    """K2's input as the DLRM step hands it over: the bottom-MLP output
    and f - 1 pieces of one embedding buffer (the lookup's unpack),
    bf16."""
    dtype = dtype or torch.bfloat16
    bottom = torch.randn((b, d), generator=gen, device="cuda").to(dtype)
    buf = torch.randn(((f - 1) * b, d), generator=gen, device="cuda").to(
        dtype)
    return [bottom] + [buf[i * b:(i + 1) * b] for i in range(f - 1)]


@contextlib.contextmanager
def interaction_checks(torch, errs, what):
    """Hold the step's K2 and K4 calls (``DotInteract``'s forward and
    backward) to their plain versions on the inputs the step gave them,
    right after each call: K2 within 1 bf16 ulp with the appended row
    bit-exact, K4 within 1 bf16 ulp + 2^-20 of the sum of |terms| (phase
    4's and phase 6's tolerances). Yields the calls checked."""
    from distributed_embeddings_torch.ops import interaction

    seen = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = (interaction.DotInteract.forward,
                          interaction.DotInteract.backward)

    def fwd(ctx, *feats):
        out = real_fwd(ctx, *feats)
        want = interaction.dot_interact_fwd_plain(list(feats))
        p = out.shape[1] - feats[0].shape[1]
        compare(torch, out[:, p:], want[:, p:], exact=True,
                what=f"{what}: dot_interact_fwd bottom-row copy")
        errs["dot_interact_fwd"] = max(errs.get("dot_interact_fwd", 0.0),
                                       compare(
            torch, out, want, exact=False,
            what=f"{what}: dot_interact_fwd {tuple(out.shape)}"))
        seen["fwd"] += 1
        return out

    def bwd(ctx, dy):
        grads = real_bwd(ctx, dy)
        feats = list(ctx.saved_tensors)
        want = interaction.dot_interact_bwd_plain(feats, dy.contiguous())
        scale = interaction.dot_interact_bwd_plain(
            [f.float().abs() for f in feats], dy.float().abs())
        errs["dot_interact_bwd"] = max(errs.get("dot_interact_bwd", 0.0),
                                       compare(
            torch, torch.stack(list(grads), 1), torch.stack(list(want), 1),
            exact=False, scale=torch.stack(list(scale), 1),
            what=f"{what}: dot_interact_bwd {len(feats)} x "
                 f"{tuple(feats[0].shape)}"))
        seen["bwd"] += 1
        return grads

    interaction.DotInteract.forward = staticmethod(fwd)
    interaction.DotInteract.backward = staticmethod(bwd)
    try:
        yield seen
    finally:
        interaction.DotInteract.forward = staticmethod(real_fwd)
        interaction.DotInteract.backward = staticmethod(real_bwd)


def interaction_builds():
    """The launch records K2's and K4's wrappers have built so far (a
    timed window that builds none finds its records on every call)."""
    from distributed_embeddings_torch.ops import interaction

    return interaction._FWD.builds + interaction._BWD.builds


def stages_in_turns(torch, split):
    """A stage split (``split()``: a dict of stage ms) through this
    tree's wrappers and the parent's (``parent_wrappers``) in turns:
    change, parent, parent, change; per side and stage the median of its
    two runs. None without ``--parent``."""
    if parent_ops() is None:
        return None
    runs = {"change": [], "parent": []}
    for side in ("change", "parent", "parent", "change"):
        with (parent_wrappers() if side == "parent"
              else contextlib.nullcontext()):
            runs[side].append(split())
    return {side: {n: float(np.median([r[n] for r in v])) for n in v[0]}
            for side, v in runs.items()}


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
    parent = parent_ops()
    for b, hot in ((RUNG, 1), (RUNG, 3), (TRAIN_BATCH, 1), (TRAIN_BATCH, 3)):
        c = k1_case(torch, de, b, hot, seed=b + hot)
        got = gather_combine(slab, c["ids"], c["rows"], c["roff"], c["div"])
        want = gather_combine_plain(slab, c["ids"], c["rows"], c["roff"],
                                    c["div"])
        what = f"gather_combine b={b} hot={hot}{' mean' if hot > 1 else ''}"
        errs["gather_combine"] = max(errs["gather_combine"], compare(
            torch, got, want, exact=hot == 1, what=what))
        if parent:  # the redesign keeps the first design's arithmetic
            theirs = parent["embedding_lookup"].gather_combine(
                slab, c["ids"], c["rows"], c["roff"], c["div"])
            check(torch.equal(got.view(torch.int16),
                              theirs.view(torch.int16)),
                  f"{what}: not bit-exact to the parent's K1")
            log(f"  {what}: bit-exact to the parent's K1")
    from distributed_embeddings_torch.ops.interaction import (
        tensor_core_paths)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for b in (RUNG, TRAIN_BATCH):
        # the features where the step leaves them (no stack)
        feats = step_features(torch, gen, b)
        check(tensor_core_paths(feats) == 1, f"dot_interact_fwd B={b}: not "
              "on the tensor-core kernel")
        got = dot_interact_fwd(feats)
        want = dot_interact_fwd_plain(feats)
        compare(torch, got[:, 351:], want[:, 351:], exact=True,
                what=f"dot_interact_fwd B={b} bottom-row copy")
        errs["dot_interact_fwd"] = max(errs["dot_interact_fwd"], compare(
            torch, got, want, exact=False, what=f"dot_interact_fwd B={b}"))
        stacked = dot_interact_fwd(torch.stack(feats, 1))
        check(torch.equal(got.view(torch.int16), stacked.view(torch.int16)),
              f"dot_interact_fwd B={b}: the list and the stacked form "
              "differ")
        if parent:  # the first design (on the stack) within 1 bf16 ulp
            theirs = parent["interaction"].dot_interact_fwd(
                torch.stack(feats, 1))
            compare(torch, got, theirs, exact=False,
                    what=f"dot_interact_fwd B={b} against the parent's K2")
    feature_count_checks(torch, gen, errs)
    return errs


def feature_count_checks(torch, gen, errs):
    """The feature counts JAX's ``dot_interact`` takes beyond the DLRM's
    27 (C6), bf16 at b=RUNG and width 128: one feature (the model's
    ``dot_interact`` hands the bottom output through and launches
    nothing; K2 and K4 take it too) and 256 (the stacked CUDA-core
    kernels), each launch counted and held to the plain version at phase
    4's tolerances (K4: 1 bf16 ulp plus 2^-20 of the sum of |terms|)."""
    from distributed_embeddings_torch.models import dot_interact
    from distributed_embeddings_torch.ops import (
        dot_interact_bwd, dot_interact_bwd_plain, dot_interact_fwd,
        dot_interact_fwd_plain)

    for f in (1, 256):
        x = torch.randn((RUNG, f, 128), generator=gen, device="cuda").to(
            torch.bfloat16)
        feats = list(x.unbind(1))
        dy = torch.randn((RUNG, f * (f - 1) // 2 + 128), generator=gen,
                         device="cuda").to(torch.bfloat16)
        n0 = (dot_interact_fwd.launches, dot_interact_bwd.launches)
        if f == 1:
            bottom = feats[0].clone().requires_grad_(True)
            out = dot_interact([], bottom)
            out.backward(dy)
            check(out is bottom and bool(torch.equal(bottom.grad, dy)),
                  "dot_interact with no tables: not the bottom output")
            check((dot_interact_fwd.launches, dot_interact_bwd.launches)
                  == n0, "dot_interact with no tables launched a kernel")
        got = dot_interact_fwd(feats)
        grads = dot_interact_bwd(feats, dy)
        check((dot_interact_fwd.launches - n0[0],
               dot_interact_bwd.launches - n0[1]) == (1, 1),
              f"dot_interact F={f}: not one launch of K2 and of K4")
        errs["dot_interact_fwd"] = max(errs["dot_interact_fwd"], compare(
            torch, got, dot_interact_fwd_plain(x), exact=False,
            what=f"dot_interact_fwd F={f} B={RUNG}"))
        scale = dot_interact_bwd_plain(x.float().abs(), dy.float().abs())
        errs["dot_interact_bwd"] = max(errs.get("dot_interact_bwd", 0.0),
                                       compare(
            torch, torch.stack(grads, 1), dot_interact_bwd_plain(x, dy),
            exact=False, what=f"dot_interact_bwd F={f} B={RUNG}",
            scale=scale))


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
    s["in_turns_with_parent"] = serve_in_turns(torch, de, state)
    if s["in_turns_with_parent"]:
        log("serve: latency in turns with the parent's K1/K10/K19 wrappers "
            "(ms): " + json.dumps(s["in_turns_with_parent"]))
    return launches, s


def serve_in_turns(torch, de, state, rounds=2):
    """Serving latency through this tree's wrappers and the parent's
    (``parent_wrappers``) in turns, change, parent, parent, change,
    ``rounds`` times: per turn a fresh runtime, warmed, then 1 s of
    Zipfian requests at 400 QPS through ``drive``. Per side the median
    of the turns' p50 and p99; None without ``--parent``."""
    from distributed_embeddings_torch.parallel import (
        ServeConfig, Served, ServingRuntime, drive, synthetic_request)

    if parent_ops() is None:
        return None
    got = {"change": [], "parent": []}
    k = 0
    for _ in range(rounds):
        for side in ("change", "parent", "parent", "change"):
            with (parent_wrappers() if side == "parent"
                  else contextlib.nullcontext()):
                rt = ServingRuntime(
                    de, lambda d, outs, n: torch.sigmoid(d(n, outs))[:, 0],
                    state, config=ServeConfig())
                rng = np.random.default_rng(SEED + 50 + k)
                k += 1
                tmpl = synthetic_request(rng, CRITEO_1TB_SIZES, 2,
                                         numerical=13)
                rt.warmup((tmpl.cats, tmpl.batch))
                res = drive(rt, lambda i: synthetic_request(
                    rng, CRITEO_1TB_SIZES, int(rng.integers(1, 9)),
                    numerical=13), qps=400.0, duration_s=1.0)
                check(all(isinstance(r, Served) for r in res),
                      f"serve in turns ({side}): a request was not Served")
                st = rt.stats()
                got[side].append((st["latency_p50_ms"],
                                  st["latency_p99_ms"]))
    return {f"{side}_{q}_ms": float(np.median([v[i] for v in got[side]]))
            for side in got for i, q in enumerate(("p50", "p99"))}


# ------------------------------------------------------------------ training


def kernel_fns():
    """Every kernel wrapper of the port, by name (each counts its own
    launches)."""
    from distributed_embeddings_torch.ops import (
        adagrad_dense, adagrad_dense_scatter, adagrad_rows, adam_rows,
        cms_query, cms_update, commit_rows, dedup_sparse_grad, dense_update,
        dot_interact_bwd,
        dot_interact_fwd, gather_combine, grad_health, lengths_to_splits,
        momentum_rows, pack_columns, pack_ids, ragged_combine, ragged_grad,
        ragged_row_ids, remap_stage, row_to_split, sgd_scatter,
        sgd_scatter_promoted, topk_merge, topk_pool)

    return {"gather_combine": gather_combine,
            "dot_interact_fwd": dot_interact_fwd,
            "dot_interact_bwd": dot_interact_bwd, "sgd_scatter": sgd_scatter,
            "dedup_sparse_grad": dedup_sparse_grad,
            "adagrad_rows": adagrad_rows, "adagrad_dense": adagrad_dense,
            "adagrad_dense_scatter": adagrad_dense_scatter,
            "ragged_combine": ragged_combine, "ragged_grad": ragged_grad,
            "lengths_to_splits": lengths_to_splits,
            "row_to_split": row_to_split, "ragged_row_ids": ragged_row_ids,
            "adam_rows": adam_rows, "momentum_rows": momentum_rows,
            "cms_update": cms_update, "cms_query": cms_query,
            "topk_pool": topk_pool, "topk_merge": topk_merge,
            "remap_stage": remap_stage, "commit_rows": commit_rows,
            "sgd_scatter_promoted": sgd_scatter_promoted,
            "pack_ids": pack_ids, "pack_columns": pack_columns,
            "grad_health": grad_health, "dense_update": dense_update}


def epilogue(steps=1, guard=True):
    """Launches of K21 and K22 in ``steps`` world-1 train steps (K21
    only under the guard or the metrics)."""
    return {"grad_health": steps if guard else 0, "dense_update": steps}


#: the row-slice modes of K1, K8 and K9 and K20's sums: (kernels-line
#: name, wrapper, the wrapper's count of those launches)
MODE_COUNTS = (
    ("gather_combine_row_base", "gather_combine", "launches_rbase"),
    ("ragged_combine_row_base", "ragged_combine", "launches_rbase"),
    ("ragged_grad_row_base", "ragged_grad", "launches_rbase"),
    ("pack_columns_sum", "pack_columns", "launches_sum"))


def zero_counts():
    fns = kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    for _, name, attr in MODE_COUNTS:
        setattr(fns[name], attr, 0)


def read_counts():
    return {name: fn.launches for name, fn in kernel_fns().items()}


def read_mode_counts():
    fns = kernel_fns()
    return {mode: getattr(fns[name], attr)
            for mode, name, attr in MODE_COUNTS}


@contextlib.contextmanager
def plain_kernels(names=None):
    """Route every kernel call site of the package (or, with ``names``,
    those of the wrappers so named) to its plain version (the reference
    run of the small training checks)."""
    from distributed_embeddings_torch.analysis import telemetry
    from distributed_embeddings_torch.ops import (
        adagrad, adam, dense_update_plain, exchange_pack,
        gather_combine_plain, grad_health_plain, interaction,
        lengths_to_splits_plain, momentum, ragged_combine_plain,
        row_to_split_plain, scatter_add, sketch, sparse_grad)
    from distributed_embeddings_torch.ops import streaming as sops
    from distributed_embeddings_torch.parallel import (
        apply, dist_embedding, exchange, lookup, optimizers, streaming,
        trainer)

    swaps = [(lookup, "gather_combine", gather_combine_plain),
             (lookup, "ragged_combine", ragged_combine_plain),
             (lookup, "lengths_to_splits", lengths_to_splits_plain),
             (apply, "lengths_to_splits", lengths_to_splits_plain),
             (apply, "ragged_grad", sparse_grad.ragged_grad_plain),
             (dist_embedding, "row_to_split", row_to_split_plain),
             (interaction, "dot_interact_fwd",
              lambda feats, record=None: interaction.dot_interact_fwd_plain(
                  feats)),
             (interaction, "dot_interact_bwd",
              lambda feats, dy, fwd_record=None:
              interaction.dot_interact_bwd_plain(feats, dy)),
             (optimizers, "sgd_scatter", scatter_add.sgd_scatter_plain),
             (scatter_add, "sgd_scatter_promoted",
              scatter_add.sgd_scatter_promoted_plain),
             (optimizers, "dedup_sparse_grad",
              sparse_grad.dedup_sparse_grad_plain),
             (optimizers, "adagrad_rows", adagrad.adagrad_rows_plain),
             (optimizers, "adagrad_dense", adagrad.adagrad_dense_plain),
             (optimizers, "adagrad_dense_scatter",
              adagrad.adagrad_dense_scatter_plain),
             (optimizers, "adam_rows", adam.adam_rows_plain),
             (optimizers, "momentum_rows", momentum.momentum_rows_plain),
             (telemetry, "sketch_update", sketch.cms_update_plain),
             (telemetry, "sketch_query", sketch.cms_query_plain),
             (telemetry, "sketch_fold", sketch.fold_ids_plain),
             (streaming, "remap_stage", sops.remap_stage_plain),
             (streaming, "commit_rows", sops.commit_rows_plain),
             (exchange, "pack_ids", exchange_pack.pack_ids_plain),
             (exchange, "pack_columns", exchange_pack.pack_columns_plain),
             (trainer, "grad_health", grad_health_plain),
             (optimizers, "dense_update", dense_update_plain)]
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
    """5 steps with the kernels against the same steps through the plain
    versions, on the card, small tables, in lockstep: each step runs with
    the kernels and, from a copy of the same state, with every DLRM call
    site routed to its plain version; the kernels' run goes on to the
    next step. Lockstep, since K3 rounds a row's adds in stream order and
    the plain ``index_add_`` in its atomics' order: two free-running
    trajectories part from those last-bit differences (by 1.59e-5 in
    the slab over 5 steps in one run, every K3 call of which was correct),
    while one step from one state holds each kernel to its plain
    version."""
    from distributed_embeddings_torch.models import DLRMConfig, DLRMDense
    from distributed_embeddings_torch.parallel import (
        SGD, DistributedEmbedding, SparseSGD, init_hybrid_state,
        make_hybrid_train_step)

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
    init = sk.emb_params["w128"][0].float().clone()
    # instrumented: the metrics of each step are held to the plain run's
    step = make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), SparseSGD(),
                                  lr_schedule=TRAIN_LR, nan_guard=True,
                                  with_metrics=True)
    batches = [train_batch(torch, sizes, SMALL_BATCH, seed=100 + k,
                           bad_ids=True) for k in range(SMALL_STEPS)]
    f32 = dtype == torch.float32
    loss_tol, dense_tol = (1e-5, 1e-5) if f32 else (1e-2, 1e-3)
    metric_tol = 1e-3 if f32 else 5e-2
    counts = {"kernels": {}, "plain": {}}
    losses, loss_err, dense_err, slab_err, metric_err = [], 0.0, 0.0, 0.0, 0.0
    for i, (cats, batch) in enumerate(batches):
        twin = clone_state(sk)
        before = sk.emb_params["w128"][0].float().clone()
        out = {}
        for name in ("kernels", "plain"):
            zero_counts()
            with (plain_kernels() if name == "plain"
                  else contextlib.nullcontext()):
                out[name] = step(sk if name == "kernels" else twin, cats,
                                 batch)
            torch.cuda.synchronize()
            for k, v in read_counts().items():
                counts[name][k] = counts[name].get(k, 0) + v
        (lk, sk, mk), (lp, stp, mp) = out["kernels"], out["plain"]
        check(bool(torch.isfinite(lk)), f"small train check step {i}: "
              "loss not finite")
        losses.append(float(lk))
        loss_err = max(loss_err, float((lk.float() - lp.float()).abs()))
        dense_err = max(dense_err, max(
            float((a.detach() - b.detach()).abs().max())
            for a, b in zip(sk.dense_params.parameters(),
                            stp.dense_params.parameters())))
        # a slab row that k ids updated this step: within k + 1 ulps of
        # twice the largest magnitude it held (K3 and index_add_ round
        # the adds in their own orders; the cotangents of the two sides
        # differ by the dense kernels' float order)
        a = sk.emb_params["w128"][0].float()
        b = stp.emb_params["w128"][0].float()
        k = torch.bincount(global_rows(torch, de, cats, sizes),
                           minlength=a.shape[0]).float()[:, None]
        scale = 2 * torch.maximum(torch.maximum(before.abs(), a.abs()),
                                  b.abs())
        err = (a - b).abs()
        bad = int(torch.count_nonzero(err > (k + 1) * ulp(torch, scale,
                                                          dtype)))
        check(bad == 0, f"small train check {dtype} step {i}: {bad} slab "
              f"values beyond (k + 1) ulps (max err {float(err.max())})")
        slab_err = max(slab_err, float(err.max()))
        metric_err = max(metric_err, metrics_close(
            torch, [mk], [mp], metric_tol,
            f"small train check {dtype} step {i}"))
        del twin, stp, before, a, b, err
    for name, want in (("kernels", SMALL_STEPS), ("plain", 0)):
        check(all(counts[name][k] == (want if k in DLRM_KERNELS else 0)
                  for k in counts[name]),
              f"small train check ({name}): launches {counts[name]}, "
              f"expected {want} of each DLRM kernel and none of the others")
    check(loss_err <= loss_tol, f"small train check {dtype}: losses differ "
          f"by {loss_err} (> {loss_tol})")
    check(dense_err <= dense_tol, f"small train check {dtype}: dense params "
          f"differ by {dense_err} (> {dense_tol})")
    check(bool((sk.emb_params["w128"][0].float() != init).any()),
          "small train check: no slab row changed")
    log(f"  small train check {str(dtype)[6:]}: {SMALL_STEPS} steps at "
        f"b={SMALL_BATCH} in lockstep, losses "
        f"{[round(x, 5) for x in losses]}; kernels vs plain: loss "
        f"{loss_err} (tol {loss_tol}), dense {dense_err} (tol {dense_tol}),"
        f" slab max {slab_err} (tol (k+1) ulp), step metrics max relative "
        f"{metric_err} (counts exact, the rest within {metric_tol})")
    return slab_err


METRIC_COUNTS = ("ids_routed", "id_overflow", "invalid_id_count",
                 "skipped_steps", "step", "id_a2a_bytes", "out_a2a_bytes",
                 "grad_a2a_bytes", "out_pad_frac", "table_nonfinite")


def metrics_close(torch, got, want, tol, what):
    """Two runs' step metrics, step by step: every key of
    ``STEP_METRIC_KEYS``, counts exact, the rest (loss, norms, update
    bounds) within ``tol`` relative. Returns the largest relative
    difference."""
    from distributed_embeddings_torch.utils import obs

    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(set(g) == set(w) == set(obs.STEP_METRIC_KEYS),
              f"{what} step {i}: metric keys {sorted(g)}")
        for k in g:
            a, b = g[k].float(), w[k].float()
            check(a.shape == b.shape, f"{what} step {i} {k}: shape")
            if k in METRIC_COUNTS:
                check(torch.equal(a, b), f"{what} step {i} {k}: "
                      f"{a.tolist()} != {b.tolist()}")
                continue
            check(bool(torch.isfinite(a).all()), f"{what} step {i} {k}: "
                  f"not finite {a.tolist()}")
            rel = float(((a - b).abs() / torch.maximum(
                a.abs(), b.abs()).clamp(min=1e-12)).max())
            check(rel <= tol, f"{what} step {i} {k}: {a.tolist()} vs "
                  f"{b.tolist()} (relative {rel} > {tol})")
            worst = max(worst, rel)
    return worst


def health_err(torch, got, want, what):
    """K21 against its plain version on the same tensors: max |g| and
    the non-finite counts exact (NaN equals NaN), the sums of squares
    within 1.2e-5 relative (all terms positive: each order is within ~100
    float32 roundings of the exact sum, 2 * 100 * 2^-24 = 1.2e-5), and
    equal where not finite. Returns the largest absolute difference of
    the finite sums."""
    check(got.shape == want.shape, f"{what}: K21 shape {tuple(got.shape)}")
    same = (got[1:] == want[1:]) | (torch.isnan(got[1:])
                                    & torch.isnan(want[1:]))
    check(bool(same.all()), f"{what}: K21 max/count differ from plain")
    fin = torch.isfinite(want[0])
    check(bool((torch.isfinite(got[0]) == fin).all())
          and bool((got[0][~fin].nan_to_num(posinf=1, neginf=-1)
                    == want[0][~fin].nan_to_num(posinf=1, neginf=-1)
                    ).all()), f"{what}: K21 non-finite sums differ")
    err = (got[0][fin] - want[0][fin]).abs()
    bad = int(torch.count_nonzero(err > 1.2e-5 * want[0][fin].abs()))
    check(bad == 0, f"{what}: {bad} K21 sums beyond 1.2e-5 relative "
          f"(max err {float(err.max()) if err.numel() else 0.0})")
    return float(err.max()) if err.numel() else 0.0


@contextlib.contextmanager
def epilogue_checks(torch, errs, what, keep=None):
    """Hold every K21 and K22 call the step makes (the module globals
    ``parallel.trainer.grad_health`` and ``parallel.optimizers.
    dense_update``) to its plain version on the same inputs, right where
    the step calls it: K21 by ``health_err``; K22 bit for bit, its plain
    version run on copies of the parameters, state and counts taken just
    before the call. ``keep`` (a dict) gets the last call's arguments."""
    from distributed_embeddings_torch.ops import (dense_update_plain,
                                                  grad_health_plain)
    from distributed_embeddings_torch.parallel import optimizers, trainer

    real_h, real_u = trainer.grad_health, optimizers.dense_update
    calls = {"grad_health": 0, "dense_update": 0}

    def health(tensors):
        out = real_h(tensors)
        errs["grad_health"] = max(errs.get("grad_health", 0.0), health_err(
            torch, out, grad_health_plain(tensors), what))
        calls["grad_health"] += 1
        if keep is not None:
            keep["grad_health"] = list(tensors)
        return out

    def update(kind, params, grads, s0, s1, nlr, hyper, bp=None, ok=None,
               counts=()):
        def copies(ts):
            return None if ts is None else [t.clone() for t in ts]

        cp, c0, c1, cc = (copies(params), copies(s0), copies(s1),
                          copies(counts))
        real_u(kind, params, grads, s0, s1, nlr, hyper, bp=bp, ok=ok,
               counts=counts)
        dense_update_plain(kind, cp, grads, c0, c1, nlr, hyper, bp=bp,
                           ok=ok, counts=cc)
        got = list(params) + list(s0 or ()) + list(s1 or ()) + list(counts)
        want = cp + (c0 or []) + (c1 or []) + cc
        for a, b in zip(got, want):
            check(torch.equal(a, b), f"{what}: K22 ({kind}) differs from "
                  "its plain version")
        errs["dense_update"] = 0.0
        calls["dense_update"] += 1
        if keep is not None:
            keep["dense_update"] = (kind, list(params), list(grads), s0, s1,
                                    nlr, hyper, bp)
        return None

    trainer.grad_health, optimizers.dense_update = health, update
    try:
        yield calls
    finally:
        trainer.grad_health, optimizers.dense_update = real_h, real_u


def phase_train(torch, de, state):
    from distributed_embeddings_torch.ops import scatter_add
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, make_hybrid_train_step)

    errs = {"sgd_scatter": 0.0, "dot_interact_bwd": 0.0, "grad_health": 0.0,
            "dense_update": 0.0}
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

    rec = RecordingSGD()
    check_step = make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), rec,
                                        lr_schedule=TRAIN_LR, nan_guard=True)
    cats, batch = train_batch(torch, CRITEO_1TB_SIZES, TRAIN_BATCH,
                              seed=SEED + 20)
    epi = {}
    with epilogue_checks(torch, errs, "full-size step", keep=epi) as ec, \
            interaction_checks(torch, errs, "full-size step") as ic:
        loss, st = check_step(st, cats, batch)
    torch.cuda.synchronize()
    check(ic == {"fwd": 1, "bwd": 1}, f"full-size step: interaction calls "
          f"{ic}")
    check(ec == {"grad_health": 1, "dense_update": 1}, f"full-size step: "
          f"epilogue calls {ec}")
    log(f"train: full-size step's K21 over {len(epi['grad_health'])} "
        f"gradients within its bound of the plain version (max abs err "
        f"{errs['grad_health']}), K22 bit-exact")
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
    log(f"train: K2 and K4 in the step within their bounds of the plain "
        f"versions (max abs err {errs['dot_interact_fwd']}, "
        f"{errs['dot_interact_bwd']})")
    del rec.seen

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
    b0 = interaction_builds()
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
    builds = interaction_builds() - b0
    losses = torch.stack(losses).float().cpu().numpy()
    check(np.isfinite(losses).all(), f"train: non-finite loss {losses}")
    for name, n in launches.items():
        want = TRAIN_STEPS if name in DLRM_KERNELS else 0
        check(n == want, f"train: {name} launched {n} times in "
              f"{TRAIN_STEPS} steps (expected {want})")
    step_ms = [s.elapsed_time(e) for s, e in times]

    # the instrumented step (with_metrics): timed, every metric finite
    mstep = make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), SparseSGD(),
                                   lr_schedule=TRAIN_LR, nan_guard=True,
                                   with_metrics=True)
    mtimes = []
    for k in range(WARMUP_RUNS + 10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, st, mets = mstep(st, *batches[k % len(batches)])
        end.record()
        mtimes.append((start, end))
    torch.cuda.synchronize()
    metrics_ms = [s.elapsed_time(e) for s, e in mtimes[WARMUP_RUNS:]]
    for k, v in mets.items():
        check(bool(torch.isfinite(v.float()).all()), f"train: metric {k} "
              f"not finite: {v.tolist()}")
    check(int(mets["ids_routed"][0]) == TRAIN_BATCH * len(CRITEO_1TB_SIZES)
          and int(mets["skipped_steps"][0]) == 0,
          f"train: metrics {mets['ids_routed'].tolist()} ids routed, "
          f"{mets['skipped_steps'].tolist()} skipped")

    # the step's stages, called one by one with events between them; the
    # guard's and the dense update's through the step's own calls, with
    # K21/K22 and then with their plain versions (what the step ran
    # before them), in turns
    stages, stages_plain = [], []
    for k in range(4):
        plain = k in (1, 2)
        with (plain_kernels(EPILOGUE_KERNELS) if plain
              else contextlib.nullcontext()):
            (stages_plain if plain else stages).append(
                dlrm_stages(torch, de, st, batches))
    stages = {n: float(np.median([r[n] for r in stages]))
              for n in stages[0]}
    stages_plain = {n: float(np.median([r[n] for r in stages_plain]))
                    for n in stages_plain[0]}
    epi_cases = time_epilogue(torch, epi)
    holder = [st]

    def plain_step(k):
        holder[0] = step(holder[0], *batches[k % len(batches)])[1]

    def metrics_step(k):
        holder[0] = mstep(holder[0], *batches[k % len(batches)])[1]

    # the step at the serving rung's batch, where the host sets the pace
    small = [train_batch(torch, CRITEO_1TB_SIZES, RUNG, seed=SEED + 40 + k)
             for k in range(4)]

    def small_step(k):
        holder[0] = step(holder[0], *small[k % len(small)])[1]

    turns = {"step": steps_in_turns(torch, plain_step),
             "instrumented_step": steps_in_turns(torch, metrics_step)}
    built = interaction_builds()
    turns["step_b256"] = steps_in_turns(torch, small_step)
    if turns["step_b256"]:
        turns["step_b256"]["interaction_records_built"] = (
            interaction_builds() - built)
        turns["step_b256"]["host_profile"] = host_profile_in_turns(
            torch, small_step)
    st = holder[0]
    # the stage splits through both sides' wrappers, in turns
    turns["stages"] = stages_in_turns(
        torch, lambda: dlrm_stages(torch, de, st, batches))
    turns["instrumented_stages"] = stages_in_turns(
        torch, lambda: dlrm_stages(torch, de, st, batches, metrics=True))
    if turns["step"]:
        log("train: steps and stage splits in turns with the parent's "
            "K1/K2/K3/K4/K10/K19/K20/K22 wrappers (ms): "
            + json.dumps(turns))
    result = {
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
        "samples_per_s": TRAIN_STEPS * TRAIN_BATCH / wall,
        "wall_step_ms": wall / TRAIN_STEPS * 1e3,
        "step_ms_p50": float(np.median(step_ms)),
        "step_ms_min": float(np.min(step_ms)),
        "metrics_step_ms_p50": float(np.median(metrics_ms)),
        "stage_ms_p50": stages,
        "stage_ms_p50_plain_epilogue": stages_plain,
        "in_turns_with_parent": turns,
        "launches_per_step": {n: v / TRAIN_STEPS
                              for n, v in launches.items()},
        "interaction_records_built": builds,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1])}
    log("train: " + json.dumps(result))
    return launches, errs, result, epi_cases


def dlrm_stages(torch, de, st, batches, runs=6, loss=None, tx=None,
                lr=TRAIN_LR, metrics=False):
    """Median device ms of the DLRM step's stages over ``runs`` steps
    (after one warmup), each stage called as the step calls it, with
    events between them: the guard is K21 over every gradient and its
    verdict, the dense update ``tx.update_`` (K22; ``SGD(TRAIN_LR)`` by
    default) and, with ``metrics``, the instrumented step's metrics
    (``step_metrics`` and ``_finish_metrics``). ``lr`` is the sparse
    apply's (a tensor: the promoted chain, K18)."""
    from distributed_embeddings_torch.parallel import SGD, SparseSGD, trainer

    loss = loss or loss_fn
    tx = tx or SGD(TRAIN_LR)
    names = ["embedding_forward", "dense_forward_backward", "nan_guard",
             "sparse_apply", "dense_update"] + (["metrics"] if metrics
                                                else [])
    stage_ms = {n: [] for n in names}
    params = list(st.dense_params.parameters())
    for k in range(1 + runs):
        cats, batch = batches[k % len(batches)]
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(names) + 1)]
        ev[0].record()
        with torch.no_grad():
            outs, res = de.forward_with_residuals(st.emb_params, cats)
        ev[1].record()
        outs = [o.detach().requires_grad_() for o in outs]
        lv = loss(st.dense_params, outs, batch)
        grads = torch.autograd.grad(lv, params + outs)
        ev[2].record()
        dense_grads, out_grads = (list(grads[:len(params)]),
                                  list(grads[len(params):]))
        health = trainer.grad_health(out_grads + dense_grads)
        n = len(out_grads)
        ok = (torch.isfinite(lv.float())
              & torch.isfinite(health[0, n:].sum())
              & torch.isfinite(0.0 * health[0, :n].sum()))
        ev[3].record()
        de.sparse_apply_gradients(st.emb_params, st.emb_opt_state, res,
                                  out_grads, SparseSGD(), lr, enable=ok)
        ev[4].record()
        tx.update_(dense_grads, st.dense_opt_state, params, ok=ok)
        ev[5].record()
        if metrics:
            m = de.step_metrics(res, out_dtype=out_grads[0].dtype)
            trainer._finish_metrics(de, m, health, n, lv, ok, st, None, lr)
            ev[6].record()
        torch.cuda.synchronize()
        if k:
            for i, name in enumerate(names):
                stage_ms[name].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: float(np.median(v)) for n, v in stage_ms.items()}


def time_epilogue(torch, epi):
    """K21 on the full-size step's own gradients (and on world 8's two
    calls a rank: the first 8192 rows of each cotangent, then the dense
    gradients) and K22 on its dense parameters (copies), each beside its
    plain version, one PyTorch call for the same function
    (``torch._foreach_norm``; ``torch._foreach_add_`` for SGD) and its
    byte bound, in turns with the parent's wrappers."""
    from distributed_embeddings_torch.ops import dense_update, dense_update_plain

    ts = epi["grad_health"]
    n_out = len(ts) - sum(1 for t in ts if t.dtype == torch.float32)
    # world 8's two calls a rank: the rank's 26 cotangents at its 8192
    # rows (contiguous [8192, 128] views, as K4 leaves them), then the 16
    # dense gradients after the all-reduce
    rank = TRAIN_BATCH // 8
    k21 = [k21_case(torch, f"dlrm_b{TRAIN_BATCH}", ts),
           k21_case(torch, f"world8_rank_cotangents_b{rank}",
                    [t[:rank] for t in ts[:n_out]]),
           k21_case(torch, "world8_rank_dense", ts[n_out:])]
    kind, params, grads, s0, s1, nlr, hyper, bp = epi["dense_update"]
    check(kind == "sgd", f"the DLRM step's dense update is {kind}")
    cp = [p.detach().clone() for p in params]
    numel = sum(p.numel() for p in cp)
    parent = parent_ops()

    def kernel():
        dense_update(kind, cp, grads, None, None, nlr, hyper)

    def parent_kernel():
        parent["dense_update"].dense_update(kind, cp, grads, None, None, nlr,
                                            hyper)

    def plain_fn():
        dense_update_plain(kind, cp, grads, None, None, nlr, hyper)

    k22 = kernel_case(
        torch, "dense_update", "dlrm_sgd", kernel,
        parent_kernel if parent else None,
        lambda: torch._foreach_add_(cp, grads, alpha=nlr),
        3 * 4 * numel, plain=plain_fn,  # read p and g, write p
        extra={"tensors": len(cp), "elements": numel})
    k22["host_split_us"] = k22_host_split(torch, kind, cp, grads, (), nlr,
                                          hyper, None, None, (), kernel)
    return {"grad_health": k21, "dense_update": [k22]}


def k21_case(torch, label, ts):
    """K21 on the gradients ``ts`` through ``kernel_case`` (in turns with
    the parent's wrapper and ``torch._foreach_norm``, the library call),
    beside its plain version and its byte bound (each element read once),
    with its record's host split (``launch_host_split``: the layout key,
    the lookup, the ``ctypes`` call and the stream, the addresses and the
    output's allocation timed alone)."""
    import importlib

    from distributed_embeddings_torch.ops import grad_health, grad_health_plain

    gh = importlib.import_module("distributed_embeddings_torch.ops."
                                 "grad_health")
    parent = parent_ops()
    nbytes = sum(t.numel() * t.element_size() for t in ts)
    case = kernel_case(
        torch, "grad_health", label, lambda: grad_health(ts),
        (lambda: parent["grad_health"].grad_health(ts)) if parent else None,
        lambda: torch._foreach_norm(ts), nbytes,
        plain=lambda: grad_health_plain(ts),
        extra={"tensors": len(ts), "library_call": "torch._foreach_norm"})
    out = grad_health(ts)
    case["host_split_us"] = launch_host_split(
        torch, f"grad_health {label}", lambda: gh.record_key(ts), gh._CACHE,
        (gh._addresses(ts), out.data_ptr()), lambda: grad_health(ts), ts,
        extra={"addresses_us": lambda: gh._addresses(ts),
               "output_us": lambda: torch.empty(
                   3, len(ts), dtype=torch.float32, device=out.device)})
    return case


def cycling(fn, arg_sets):
    """A call of ``fn`` taking no arguments that cycles through
    ``arg_sets`` (a new input each call, as a step gives it)."""
    import itertools

    it = itertools.cycle(arg_sets)
    return lambda: fn(*next(it))


def time_k1(torch, de, slab, label, b, hot):
    """K1 at one shape as a step calls it: ONE set of slot metadata (the
    plan's, cached) and fresh ids each call (8 Zipfian id sets), through
    this tree's wrapper and, in turns, the parent's (``kernel_case``),
    beside the plain version, the library call on the same global rows
    (clipped and offset outside the timed region) and the byte bound
    (each distinct row read once, the ids read, the output written)."""
    import importlib

    import torch.nn.functional as F
    from distributed_embeddings_torch.ops import (gather_combine,
                                                  gather_combine_plain)

    el = importlib.import_module("distributed_embeddings_torch.ops."
                                 "embedding_lookup")
    w = slab.shape[1]
    cases = [k1_case(torch, de, b, hot, seed=1000 + k, bad_ids=False)
             for k in range(8)]
    meta = (cases[0]["rows"], cases[0]["roff"], cases[0]["div"])
    ids = [(c["ids"],) for c in cases]
    grows = [(torch.minimum(i.long().clamp(min=0), meta[0].view(-1, 1, 1) - 1)
              + meta[1].view(-1, 1, 1),) for (i,) in ids]
    parent = parent_ops()
    parent_fn = None
    if parent:
        parent_fn = cycling(lambda i: parent["embedding_lookup"]
                            .gather_combine(slab, i, *meta), ids)
    if hot == 1:
        lib = cycling(lambda g: F.embedding(g.view(-1), slab), grows)
    else:
        lib = cycling(lambda g: F.embedding_bag(g.view(-1, hot), slab,
                                                mode="mean"), grows)
    uniq = int(torch.unique(grows[0][0]).numel())
    nbytes = (uniq * w * 2 + ids[0][0].numel() * 4
              + len(CRITEO_1TB_SIZES) * b * w * 2)
    c = kernel_case(
        torch, "gather_combine", label,
        cycling(lambda i: gather_combine(slab, i, *meta), ids), parent_fn,
        lib, nbytes,
        plain=cycling(lambda i: gather_combine_plain(slab, i, *meta), ids),
        extra={"unique_rows": uniq})
    i0 = ids[0][0]
    out = gather_combine(slab, i0, *meta)
    c["host_split_us"] = launch_host_split(
        torch, f"gather_combine {label}",
        lambda: el.gather_record_key(slab, i0, *meta), el._GATHER,
        (i0.data_ptr(), None, out.data_ptr()),
        lambda: gather_combine(slab, i0, *meta), [slab, *meta])
    return c


def phase_time(torch, de, state, errs, launches):
    slab = state.emb_params["w128"][0]
    k1_cases = [time_k1(torch, de, slab, label, b, hot)
                for label, b, hot in (("rung256_hot1", RUNG, 1),
                                      ("b65536_hot1", TRAIN_BATCH, 1),
                                      ("b65536_hot3_mean", TRAIN_BATCH, 3))]
    k2_cases = time_dot_interact_fwd(torch)
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
    builds it) on the real slab, cycling 8 Zipfian id sets: this tree's
    wrapper, the parent's (``--parent``) and ``index_add_`` in turns, the
    plain version, the engine's device split and the byte bound."""
    from distributed_embeddings_torch.ops import (sgd_scatter,
                                                  sgd_scatter_plain)

    w = slab.shape[1]
    roff = torch.as_tensor(de.row_offsets_list[0], dtype=torch.int32,
                           device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    args, lib_args = [], []
    for k in range(8):
        cats, _ = train_batch(torch, CRITEO_1TB_SIZES, TRAIN_BATCH,
                              seed=2000 + k)
        ids = (torch.stack(cats, dim=1) + roff).reshape(-1).contiguous()
        vals = (torch.randn((ids.numel(), w), generator=gen, device="cuda")
                * 1e-3).to(torch.bfloat16)
        args.append((ids, vals))
        nl = torch.tensor(-TRAIN_LR, dtype=torch.bfloat16, device="cuda")
        lib_args.append((ids.long(), vals * nl))
    parent = parent_ops()
    n = args[0][0].numel()
    uniq = int(torch.unique(args[0][0]).numel())
    nbytes = n * w * 2 + n * 4 + 2 * uniq * w * 2
    case = segment_case(
        torch, "sgd_scatter", "b65536",
        cycling(lambda i, v: sgd_scatter(slab, i, v, TRAIN_LR), args),
        cycling(lambda i, v: parent["scatter_add"].sgd_scatter(
            slab, i, v, TRAIN_LR), args) if parent else None,
        cycling(lambda i, u: slab.index_add_(0, i, u), lib_args), nbytes,
        cycling(lambda i, v: sgd_scatter_plain(slab, i, v, TRAIN_LR), args),
        args[0][0], slab.shape[0])
    return [case]


def interaction_bound(b, f=27, d=128, es=2, bwd=False):
    """The least time of K2 (or K4) on the card: its bytes (the features
    read once, dy read once, the output written once) over the HBM rate,
    or its multiply-adds over the bf16 tensor-core rate, the larger."""
    p = f * (f - 1) // 2
    nbytes = (2 if bwd else 1) * b * f * d * es + b * (p + d) * es
    ops = 2 * b * (f * f if bwd else p) * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return nbytes, ops, max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                              else "operations")


def time_dot_interact_fwd(torch):
    """K2 at the serving rung and the training batch, on the features as
    the step hands them over (``step_features``): this tree's wrapper and,
    in turns, the parent's (``kernel_case``; the parent's K2 took a stack,
    so its turn is the stack and its K2, the function the parent's step
    ran; its K2 alone on a stack made beforehand is timed beside it), the
    plain version, the library yardstick (the stack, ``bmm``, the
    triangle's index and ``cat``: several calls, no single PyTorch call
    computes the function), the byte bound and the host split of a hit."""
    from distributed_embeddings_torch.ops import interaction as it

    parent = parent_ops()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    li, lj = (torch.as_tensor(a, device="cuda")
              for a in np.tril_indices(27, k=-1))

    def library(feats):
        f = torch.stack(feats, 1)
        gram = torch.bmm(f, f.transpose(1, 2))
        return torch.cat([gram[:, li, lj], f[:, 0]], dim=1)

    cases = []
    for label, b in (("rung256", RUNG), ("b65536", TRAIN_BATCH)):
        sets = [(step_features(torch, gen, b),) for _ in range(4)]
        nbytes, ops, bound, by = interaction_bound(b)
        parent_fn = parent_stacked = None
        if parent:
            parent_fn = cycling(lambda fs: parent["interaction"]
                                .dot_interact_fwd(torch.stack(fs, 1)), sets)
            stacks = [(torch.stack(fs, 1),) for fs, in sets]
            parent_stacked = cycling(
                parent["interaction"].dot_interact_fwd, stacks)
        c = kernel_case(
            torch, "dot_interact_fwd", label,
            cycling(it.dot_interact_fwd, sets), parent_fn,
            cycling(library, sets), nbytes,
            plain=cycling(it.dot_interact_fwd_plain, sets),
            extra={"ops": ops, "bound_by_ops": by,
                   "tensor_core_paths": it.tensor_core_paths(sets[0][0])})
        c["bound_ms"], c["bound_by"] = bound, by
        if parent_stacked:
            c["parent_on_stack_ms"] = time_ms(torch, parent_stacked, [()])
            log(f"  dot_interact_fwd {label}: the parent's K2 alone on a "
                f"stack made beforehand {c['parent_on_stack_ms']:.4f} ms")
            del stacks
        fs = sets[0][0]
        out = it.dot_interact_fwd(fs)
        c["host_split_us"] = launch_host_split(
            torch, f"dot_interact_fwd {label}",
            lambda: it.fwd_record_key(fs), it._FWD, (out.data_ptr(),),
            lambda: it.dot_interact_fwd(fs), fs)
        cases.append(c)
        del sets, out
    return cases


def time_dot_interact_bwd(torch):
    """K4 at the training batch: the step's features (``step_features``)
    and dy [65536, 479], bf16; this tree's wrapper and, in turns, the
    parent's on the stack of the same features (its step stacked them in
    the forward), the plain version, the library yardstick (the dG
    scatter, ``bmm`` and the appended row's add on the stack) and the
    byte bound."""
    from distributed_embeddings_torch.ops import interaction as it

    b, f, d = TRAIN_BATCH, 27, 128
    p = f * (f - 1) // 2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    sets = [(step_features(torch, gen, b),
             torch.randn((b, p + d), generator=gen, device="cuda"
                         ).to(torch.bfloat16)) for _ in range(4)]
    stacks = [(torch.stack(fs, 1), dy) for fs, dy in sets]
    li, lj = (torch.as_tensor(a, device="cuda")
              for a in np.tril_indices(f, k=-1))

    def library(feats, dy):
        dg = torch.zeros((b, f, f), dtype=feats.dtype, device="cuda")
        dg[:, li, lj] = dy[:, :p]
        dg[:, lj, li] = dy[:, :p]
        out = torch.bmm(dg, feats)
        out[:, 0] += dy[:, p:]
        return out

    parent = parent_ops()
    nbytes, ops, bound, by = interaction_bound(b, bwd=True)
    c = kernel_case(
        torch, "dot_interact_bwd", "b65536", cycling(it.dot_interact_bwd,
                                                     sets),
        cycling(parent["interaction"].dot_interact_bwd, stacks)
        if parent else None, cycling(library, stacks), nbytes,
        plain=cycling(it.dot_interact_bwd_plain, sets),
        extra={"ops": ops, "bound_by_ops": by,
               "tensor_core_paths": it.tensor_core_paths(*sets[0])})
    c["bound_ms"], c["bound_by"] = bound, by
    fs, dy = sets[0]
    c["host_split_us"] = k4_host_split(torch, "b65536", fs, dy)
    del sets, stacks
    # the host's share alone, at the serving rung (the card keeps up)
    c["host_split_rung256_us"] = k4_host_split(
        torch, "rung256", step_features(torch, gen, RUNG),
        torch.randn((RUNG, p + d), generator=gen, device="cuda").to(
            torch.bfloat16))
    return [c]


def k4_host_split(torch, label, fs, dy):
    """``launch_host_split`` of K4's record for the features ``fs`` and
    ``dy``, with the wrapper's other parts: the output's allocation, its
    27 views (``unbind``) and the call as ``DotInteract``'s backward
    makes it (the record found through K2's, no key of the features)."""
    from distributed_embeddings_torch.ops import interaction as it

    b, d = fs[0].shape
    f = len(fs)
    out = torch.empty((f, b, d), dtype=torch.bfloat16, device="cuda")
    found = []
    it.dot_interact_fwd(fs, record=found)
    fwd = found[0]
    it.dot_interact_bwd(fs, dy)
    it.dot_interact_bwd(fs, dy, fwd_record=fwd)
    return launch_host_split(
        torch, f"dot_interact_bwd {label}",
        lambda: it.bwd_record_key(fs, dy), it._BWD,
        (dy.data_ptr(), out.data_ptr()), lambda: it.dot_interact_bwd(fs, dy),
        fs + [dy], extra={
            "alloc_us": lambda: torch.empty((f, b, d), dtype=torch.bfloat16,
                                            device="cuda"),
            "views_us": lambda: out.unbind(0),
            "through_forward_record_us": lambda: it.dot_interact_bwd(
                fs, dy, fwd_record=fwd)})


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


def zoo_expected(de, opt, cfg, b, guard=True, acc_dtype=None):
    """Launches per step of each kernel on the zoo path: K1 once per plan
    group; per slab the fused dense-apply call (dense-apply, where the
    optimizer's constants make an untouched element a no-op: the zoo's
    defaults), K3 + K7 (dense-apply otherwise) or K5 + K6 (sparse); K22
    once, and K21 once under the guard."""
    import torch

    from distributed_embeddings_torch.ops.adagrad import (
        untouched_rows_keep_bits)

    plan = next(iter(de._plan_cache.values()))
    want = {name: 0 for name in kernel_fns()}
    want.update(gather_combine=len(plan.groups), pack_ids=1, pack_columns=1)
    want.update(epilogue(guard=guard))
    regimes = {}
    for w, n in zoo_streams(cfg, b).items():
        dense = opt.dense_apply(de.rows_cap[w], n)
        fused = dense and untouched_rows_keep_bits(
            opt.initial_accumulator_value, opt.eps,
            acc_dtype or torch.float32, ZOO_LR)
        regimes[f"w{w}"] = ("dense-apply, fused" if fused else "dense-apply"
                            if dense else "sparse")
        for name in (("adagrad_dense_scatter",) if fused
                     else ("sgd_scatter", "adagrad_dense") if dense
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
    duplicate ids in another order than the plain versions (K3 in stream
    order or chunks of L against ``index_add_``'s atomics, K5's pieces)
    and round ``rsqrt`` differently, and the synthetic
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
      add (as JAX does), in each run's own order, so a row's
      gradient sum, and the sign of its Adagrad step, differ between
      the runs, and the 5-step trajectories part: finite losses, dense
      params, slabs and accumulators, and trained slabs, are all that
      is checked (the differences are logged). ``zoo_full_check`` holds
      this path's fused call to its bounds on the step's own inputs."""
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
            want, regimes = zoo_expected(de, opt, cfg, SMALL_BATCH,
                                         acc_dtype=acc_dtype)
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
    the gradient slab, on the slab-wide chain only) or K5 (``uids``,
    ``ugrads``) call gave the update kernel."""
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
      round after each add, K3 in stream order (chunks of L past L hits)
      and the plain ``index_add_`` in its atomics' order, so within k
      bf16 ulps of mag (the bound of ``tests/test_torch_cuda.py``);
    - K6 (touched rows) and K7 (whole slab): accumulators bit-exact (the
      same per-op rounding); the kernels' correctly rounded ``rsqrt``
      and PyTorch's ``rsqrtf`` differ by up to 2 ulps, so slab values
      within 3 ulps of their dtype of |old| + lr;
    - the fused dense-apply call (w8 at the zoo's constants):
      ``fused_check``."""
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
        if r["dense"] and "g" not in r:  # the fused dense-apply call
            errs["adagrad_dense_scatter"] = fused_check(torch, r, slab, acc,
                                                        opt.eps, what)
            continue
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


def host_bits(t):
    """A float tensor's bits, NaN payloads included."""
    import torch

    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def fused_check(torch, r, slab, acc, eps, what):
    """The dense-apply branch's one engine call (``adagrad_dense_scatter``)
    held, on the step's own inputs (``recording``'s snapshot of the whole
    slab and accumulator, the stream and the lr), to the chain it
    replaces run on the card (a zero gradient slab, K3, K7: the parent's
    branch): every row bit-exact; and to its plain version (the gradient
    summed in stream order: ``add_in_stream_order`` on the card for the
    rows hit at most L times, ``sgd_scatter_plain`` on CPU copies for the
    rest; then ``adagrad_dense_plain``): the rows hit at most L times and
    the untouched rows bit-exact, and on the rows hit more often the
    chain's gradient within K3's bound of the plain one (k ulps of the
    accumulator dtype of the sum of |rows|, k the hits). Returns the
    largest slab difference to the plain version."""
    from distributed_embeddings_torch.ops import (
        adagrad_dense, adagrad_dense_plain, sgd_scatter, sgd_scatter_plain)
    from distributed_embeddings_torch.ops.scatter_add import (
        SPLIT, add_in_stream_order)

    ids, vals, lr = r["ids"], r["vals"], r["lr"]
    rows, w = slab.shape
    cs, ca = r["slab"].clone(), r["state"].clone()
    g = torch.zeros_like(ca)
    sgd_scatter(g, ids, vals, -1.0)
    adagrad_dense(cs, ca, g, lr, eps)
    check(torch.equal(host_bits(slab), host_bits(cs))
          and torch.equal(host_bits(acc), host_bits(ca)),
          f"{what}: the fused call's slab or accumulators differ from the "
          "chain's (zero slab + K3 + K7) bits")
    wr = ids.long()
    wr = torch.where(wr < 0, wr + rows, wr)
    keep = (wr >= 0) & (wr < rows)
    wr, v = wr[keep], vals[keep]
    hits = torch.bincount(wr, minlength=rows)
    few = hits <= SPLIT
    sel = few[wr]
    gp = add_in_stream_order(torch.zeros_like(ca), wr[sel], v[sel])
    gl = sgd_scatter_plain(torch.zeros(ca.shape, dtype=ca.dtype), wr[~sel]
                           .cpu(), v[~sel].cpu(), -1.0).to(ca.device)
    gp[~few] = gl[~few]
    ps, pa = r["slab"].clone(), r["state"].clone()
    adagrad_dense_plain(ps, pa, gp, lr, eps)
    check(torch.equal(host_bits(slab[few]), host_bits(ps[few]))
          and torch.equal(host_bits(acc[few]), host_bits(pa[few])),
          f"{what}: the fused call differs from the plain version on rows "
          f"hit at most {SPLIT} times")
    mag = torch.zeros((rows, w), device=ca.device).index_add_(
        0, wr, v.float().abs())
    tol = hits[:, None].float() * ulp(torch, mag, ca.dtype)
    e3 = (g.float() - gp.float()).abs()
    bad = int((e3 > tol + 1e-30)[~few].sum())
    check(bad == 0, f"{what}: {bad} gradient values of the rows hit more "
          f"than {SPLIT} times beyond K3's bound (max err "
          f"{float(e3.max())})")
    err = float((slab.float() - ps.float()).abs().max())
    e_long = float(e3[~few].max()) if bool((~few).any()) else 0.0
    log(f"zoo: {what} (dense-apply, fused): {ids.numel()} ids, "
        f"{int((hits > 0).sum())} touched rows, {int((~few).sum())} hit "
        f"more than {SPLIT} times (the most {int(hits.max())}); bit-exact "
        f"to zero slab + K3 + K7 on every row and to the plain version on "
        f"{int(few.sum())} rows; the gradient of the others within K3's "
        f"bound (max err {e_long}); slab max_abs_err to the plain version "
        f"{err}")
    return err


def zoo_slab_wide_check(torch):
    """The dense-apply regime where the optimizer's constants keep the
    slab-wide chain: ``SparseAdagrad(initial_accumulator_value=0,
    eps=0)``, whose untouched elements JAX turns into NaN (``lr * 0 *
    rsqrt(0)``). The tiny zoo capped at SMALL_ROWS rows a table, fp32,
    one guarded step at b=SMALL_BATCH through the kernels (per
    dense-apply slab K3 into a gradient slab, K7 over it; the launch
    counts zeroed just before and read just after: this path's
    launches), each kernel held to its plain version on the step's own
    inputs (``recording``): K3's gradient slab within 2 k 2^-24 of the
    sum of |rows| (``zoo_full_check``'s bound: the plain version's
    ``index_add_`` adds in its atomics' order), K7 on that gradient slab
    against ``adagrad_dense_plain``: NaN positions equal and every untouched
    row all NaN, the accumulators (no NaN: 0 + g*g) bit-exact, the other
    slab values within 3 ulps of |old| + lr. Returns ``(launches, slab
    max_abs_err)``."""
    from distributed_embeddings_torch.models import InputGenerator
    from distributed_embeddings_torch.ops import (adagrad_dense_plain,
                                                  sgd_scatter_plain)
    from distributed_embeddings_torch.parallel import (
        Adagrad, SparseAdagrad, make_hybrid_train_step)

    opt = SparseAdagrad(initial_accumulator_value=0.0, eps=0.0)
    cfg, de, opt, st = zoo_model(torch, torch.float32, SMALL_ROWS,
                                 opt=opt, tx=Adagrad(ZOO_LR))
    step = make_hybrid_train_step(de, zoo_loss, Adagrad(ZOO_LR), opt,
                                  lr_schedule=ZOO_LR, nan_guard=True)
    num, cats, lab = InputGenerator(cfg, SMALL_BATCH, alpha=1.05,
                                    num_batches=1, seed=SEED + 43,
                                    row_cap=SMALL_ROWS, device="cuda")[0]
    with recording(torch, opt) as seen:
        zero_counts()
        loss, st = step(st, cats, (num, lab))
        torch.cuda.synchronize()
        launches = read_counts()
    want, regimes = zoo_expected(de, opt, cfg, SMALL_BATCH)
    check(launches == want, f"zoo slab-wide step: launches {launches}, "
          f"expected {want}")
    check(bool(torch.isfinite(loss)), f"zoo slab-wide step: loss "
          f"{float(loss)}")
    check("dense-apply" in regimes.values(), "zoo slab-wide step: no slab "
          f"runs the dense-apply regime ({regimes})")
    touched = zoo_touched(torch, de, cats)
    err = 0.0
    for key, r in seen.items():
        if not r["dense"]:
            continue
        slab, acc = st.emb_params[key][0], st.emb_opt_state[key][0]
        rows = slab.shape[0]
        what = f"zoo slab-wide step {key}"
        g, ids, vals = r["g"], r["ids"], r["vals"]
        ones = torch.ones((ids.numel(), 1), device="cuda")
        pg = sgd_scatter_plain(torch.zeros_like(g), ids, vals, -1.0)
        mag = sgd_scatter_plain(torch.zeros_like(g), ids, vals.abs(), -1.0)
        cnt = sgd_scatter_plain(torch.zeros((rows, 1), device="cuda"), ids,
                                ones, -1.0)
        e3 = (g - pg).abs()
        bad = int((e3 > 2 * cnt * 2.0 ** -24 * mag + 1e-30).sum())
        check(bad == 0, f"{what}: {bad} sgd_scatter values beyond 2 k "
              f"2^-24 of the sum of |rows| (max err {float(e3.max())})")
        ws, wa = r["slab"].clone(), r["state"].clone()
        adagrad_dense_plain(ws, wa, g, r["lr"], opt.eps)
        na = torch.isnan(slab)
        untouched = torch.ones(rows, dtype=torch.bool, device="cuda")
        untouched[touched[key]] = False
        check(torch.equal(na, torch.isnan(ws))
              and bool(na[untouched].all()) and bool(untouched.any()),
              f"{what}: NaN positions differ from the plain version's, or "
              "an untouched row is not all NaN")
        check(torch.equal(acc, wa), f"{what}: adagrad_dense accumulators "
              f"differ from the plain update's ({int((acc != wa).sum())} "
              "values)")
        es = (slab[~na] - ws[~na]).abs()
        ts = 3 * ulp(torch, r["slab"][~na].abs() + ZOO_LR, slab.dtype)
        bad = int((es > ts).sum())
        check(bad == 0, f"{what}: {bad} adagrad_dense slab values beyond 3 "
              f"ulps (max err {float(es.max())})")
        err = max(err, float(es.max()))
        log(f"  {what} ({regimes[key]}): {ids.numel()} ids, "
            f"{int(untouched.sum())} untouched rows all NaN as JAX writes "
            f"them; sgd_scatter max_abs_err {float(e3.max())} (<= 2 k "
            f"2^-24 of the sum of |rows|), adagrad_dense NaN positions "
            f"equal, accumulators bit-exact, slab max_abs_err "
            f"{float(es.max())} (<= 3 ulps)")
    log(f"zoo slab-wide step: launches {launches}")
    del st, de, seen
    return launches, err


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
    want = dict(want, **epilogue(guard=False))  # the step runs unguarded
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
    ``st``'s, updated in place by ``tx.update_`` as the step does)."""
    from distributed_embeddings_torch.parallel import Adagrad
    from distributed_embeddings_torch.parallel import apply as apply_mod

    tx = Adagrad(ZOO_LR) if tx is None else tx
    params = list(st.dense_params.parameters())
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
        tx.update_(list(grads[:len(params)]), st.dense_opt_state, params)
        ev[4 + len(keys)].record()
        torch.cuda.synchronize()
        labels = names + [f"sparse_apply_{key}" for key in keys] + [
            "dense_update"]
        if k >= WARMUP_RUNS:
            for i, name in enumerate(labels):
                stage_ms.setdefault(name, []).append(
                    ev[i].elapsed_time(ev[i + 1]))
    return {n: float(np.median(v)) for n, v in stage_ms.items()}


def dedup_case(torch, label, ids, vals, rows):
    """K5 timed on one call's stream (``kernel_case``: in turns with the
    parent's K5 and with ``torch.unique`` + ``index_add_``, the library
    call for the same function), its device ms split by stage
    (``DEDUP_STAGES``: sort, boundaries, sum, finish) and, with
    ``--parent``, the parent's split, beside its byte bound (the ids and
    rows read once, the U outputs written once)."""
    from distributed_embeddings_torch.ops import (dedup_sparse_grad,
                                                  dedup_sparse_grad_plain)

    kw = dict(pad_id=rows, max_unique=rows + 1)
    n, w = vals.shape
    u_cap = min(n, rows + 1)
    uids, _ = dedup_sparse_grad(ids, vals, **kw)
    row = ids.element_size() + w * vals.element_size()
    par = parent_ops()
    parent = None if par is None else (
        lambda: par["sparse_grad"].dedup_sparse_grad(ids, vals, **kw))

    def library():
        u, inv = torch.unique(ids, sorted=True, return_inverse=True)
        return u, torch.zeros((u.numel(), w), dtype=vals.dtype,
                              device="cuda").index_add_(0, inv, vals)

    def fn():
        return dedup_sparse_grad(ids, vals, **kw)

    case = kernel_case(
        torch, "dedup_sparse_grad", label, fn, parent, library,
        (n + u_cap) * row, plain=lambda: dedup_sparse_grad_plain(
            ids, vals, **kw),
        extra={"ids": n, "width": w,
               "unique_ids": int((uids < rows).sum())})
    case["split"] = segment_split(torch, fn, stages=DEDUP_STAGES)
    case["parent_split"] = (segment_split(torch, parent, stages=DEDUP_STAGES)
                            if parent else None)
    log(f"dedup_sparse_grad {label} split (device ms a call): "
        + json.dumps({"change": case["split"],
                      "parent": case["parent_split"]}))
    return case


def zoo_kernel_times(torch, de, opt, st, data, cfg):
    """CUDA-event medians of K5, K6, the dense-apply branch (the fused
    call against the parent's zero slab + K3 + K7), K7 alone, and of K1
    (hot 10, w16) and K3 (the w8 scatter-sum), at the shapes one
    full-size step gives them, each against its plain version, one
    library call where there is one, and its bound."""
    import importlib

    import torch.nn.functional as F
    from distributed_embeddings_torch.ops import (
        adagrad_dense, adagrad_dense_plain, adagrad_dense_scatter,
        adagrad_dense_scatter_plain, dedup_sparse_grad, gather_combine,
        gather_combine_plain, sgd_scatter, sgd_scatter_plain)
    from distributed_embeddings_torch.ops.scatter_add import (
        SPLIT, add_in_stream_order)
    from distributed_embeddings_torch.parallel import (
        Adagrad, lookup, make_hybrid_train_step)

    k1_calls = []
    real_k1 = lookup.gather_combine

    def recording_k1(slab, ids, rows, roff, div=None, mask=None,
                     rbase=None):
        k1_calls.append((slab, ids, rows, roff, div, mask))
        return real_k1(slab, ids, rows, roff, div, mask, rbase=rbase)

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
    parent = parent_ops()
    parent_fn = None
    if parent:
        pk1 = parent["embedding_lookup"].gather_combine
        check(torch.equal(got.view(torch.int32), pk1(
            slab, ids, rows, roff, div, mask).view(torch.int32)),
            "K1 w16 hot 10: not bit-exact to the parent's K1")

        def parent_fn():
            pk1(slab, ids, rows, roff, div, mask)
    out["gather_combine"] = kernel_case(
        torch, "gather_combine", "zoo_w16_hot10_sum",
        lambda: gather_combine(slab, ids, rows, roff, div, mask), parent_fn,
        lambda: F.embedding_bag(grows.view(-1, hot), slab, mode="sum"),
        nbytes, plain=lambda: gather_combine_plain(slab, ids, rows, roff,
                                                   div, mask),
        extra={"unique_rows": uniq, "max_abs_err": err,
               "shape": list(ids.shape)})
    del k1_calls

    # K3, the w8 scatter-sum into a zero gradient slab (the zeroing in
    # every timed call, as the step makes a zero slab)
    r8, r16 = seen["w8"], seen["w16"]
    R8, w8 = st.emb_params["w8"].shape[1:]
    ids8, vals8 = r8["ids"], r8["vals"]
    ids8l = ids8.long()
    touched8 = int(torch.unique(ids8l[ids8l < R8]).numel())
    gz = torch.zeros((R8, w8), device="cuda")
    nbytes = ids8.numel() * (4 + w8 * 4) + 2 * touched8 * w8 * 4
    out["sgd_scatter"] = segment_case(
        torch, "sgd_scatter", "zoo_w8_scatter_sum",
        lambda: sgd_scatter(gz.zero_(), ids8, vals8, -1.0),
        (lambda: parent["scatter_add"].sgd_scatter(gz.zero_(), ids8, vals8,
                                                   -1.0)) if parent else None,
        lambda: gz.zero_().index_add_(0, ids8l, vals8), nbytes,
        lambda: sgd_scatter_plain(gz.zero_(), ids8, vals8, -1.0), ids8, R8)
    # the scatter-sum against the stream-order sum on the rows with at
    # most L hits, and the same bits twice
    a = sgd_scatter(torch.zeros_like(gz), ids8, vals8, -1.0)
    check(torch.equal(a, sgd_scatter(torch.zeros_like(gz), ids8, vals8,
                                     -1.0)), "K3 zoo w8: two calls differ")
    cnt = torch.bincount(ids8l[(ids8l >= 0) & (ids8l < R8)], minlength=R8)
    few = cnt <= SPLIT
    sel = (ids8l >= 0) & (ids8l < R8)
    sel &= few[ids8l.clamp(0, R8 - 1)]
    want = add_in_stream_order(torch.zeros_like(gz), ids8l[sel], vals8[sel])
    check(torch.equal(a[few], want[few]), "K3 zoo w8: rows with at most L "
          "hits differ from the stream-order sum")
    log(f"  sgd_scatter zoo w8: deterministic, {int(few.sum())} rows with "
        f"at most {SPLIT} hits bit-exact to the stream-order sum")
    del a, want, sel, cnt, few

    # the dense-apply branch on the w8 slab: the fused call (one engine
    # call, the transition in its epilogue) in turns with the parent's
    # chain (zero slab + K3 + K7) and the library yardstick (index_add_
    # into a zeroed slab, then torch.optim.Adagrad(foreach=True).step on
    # that dense gradient: its eps sits outside the square root). Each
    # call updates the step's w8 slab and accumulators in place, as the
    # step does.
    ada = importlib.import_module("distributed_embeddings_torch.ops.adagrad")
    s8, a8 = st.emb_params["w8"][0], st.emb_opt_state["w8"][0]
    bargs = (s8, a8, ids8, vals8, ZOO_LR, opt.eps)
    es, ea = s8.element_size(), a8.element_size()
    # the stream read once, each hit row's accumulator and slab row read
    # and written once; 9 operations an element of a hit row and one add
    # a stream element
    nbytes = (ids8.numel() * (ids8.element_size() + w8 * ea)
              + touched8 * w8 * 2 * (es + ea))
    ops = 9 * touched8 * w8 + ids8.numel() * w8
    param = torch.nn.Parameter(s8.clone(), requires_grad=False)
    glib = torch.zeros_like(param)
    tlib = torch.optim.Adagrad([param], lr=ZOO_LR, eps=opt.eps,
                               initial_accumulator_value=0.1, foreach=True)

    def library():
        param.grad = glib.zero_().index_add_(0, ids8l, vals8)
        tlib.step()

    case = segment_case(
        torch, "adagrad_dense_scatter", "zoo_w8_dense_apply",
        lambda: adagrad_dense_scatter(*bargs),
        (lambda: parent_dense_branch(*bargs)) if parent else None, library,
        nbytes, lambda: adagrad_dense_scatter_plain(*bargs), ids8, R8,
        extra={"library_call": "index_add_ + torch.optim.Adagrad("
               "foreach=True).step", "touched_rows": touched8})
    if ops / F32_OPS_PER_S > nbytes / HBM_BYTES_PER_S:
        case.update(bound_ms=ops / F32_OPS_PER_S * 1e3,
                    bound_by="operations")

    def tree_chain():
        sgd_scatter(gz.zero_(), ids8, vals8, -1.0)
        adagrad_dense(s8, a8, gz, ZOO_LR, opt.eps)

    case["tree_chain_ms"], _ = ab_ms(torch, tree_chain,
                                     lambda: adagrad_dense_scatter(*bargs))
    if parent:
        case["parent_split"] = segment_split(
            torch, lambda: parent_dense_branch(*bargs),
            stages=SEGMENT_STAGES + (("adagrad_dense_kernel", "k7"),))
        log("  adagrad_dense_scatter zoo w8: the parent chain's device "
            "split " + json.dumps(case["parent_split"]))
    case["host_split_us"] = launch_host_split(
        torch, "adagrad_dense_scatter zoo w8",
        lambda: ada.scatter_record_key(*bargs), ada._SCATTER,
        (s8.data_ptr(), a8.data_ptr(), ids8.data_ptr(), vals8.data_ptr(),
         None), lambda: adagrad_dense_scatter(*bargs), [s8, a8, ids8, vals8],
        calls=10)
    out["adagrad_dense_scatter"] = case
    del param, glib, tlib

    # K7 alone over the w8 slab (the slab-wide chain's second half), in
    # turns with the parent's K7
    sgd_scatter(gz.zero_(), ids8, vals8, -1.0)
    kargs = (s8, a8, gz, ZOO_LR, opt.eps)
    nbytes = 5 * s8.numel() * es
    ops = 9 * s8.numel()
    case = kernel_case(
        torch, "adagrad_dense", "zoo_w8_slab_wide",
        lambda: adagrad_dense(*kargs),
        (lambda: parent["adagrad"].adagrad_dense(*kargs)) if parent
        else None, None, nbytes,
        plain=lambda: adagrad_dense_plain(*kargs),
        extra={"elements": s8.numel()})
    if ops / F32_OPS_PER_S > nbytes / HBM_BYTES_PER_S:
        case.update(bound_ms=ops / F32_OPS_PER_S * 1e3,
                    bound_by="operations")
    case["host_split_us"] = launch_host_split(
        torch, "adagrad_dense zoo w8", lambda: ada.dense_record_key(*kargs),
        ada._DENSE, (s8.data_ptr(), a8.data_ptr(), gz.data_ptr(), None),
        lambda: adagrad_dense(*kargs), [s8, a8, gz], calls=10)
    out["adagrad_dense"] = case

    # K5 on the w16 stream
    R16, w16 = st.emb_params["w16"].shape[1:]
    ids16, vals16 = r16["ids"], r16["vals"]
    n = ids16.numel()
    uids, ugrads = dedup_sparse_grad(ids16, vals16, pad_id=R16,
                                     max_unique=R16 + 1)
    distinct = int((uids < R16).sum())
    out["dedup_sparse_grad"] = dedup_case(torch, "zoo_w16_stream", ids16,
                                          vals16, R16)

    # K6 on K5's output, into the w16 slab (in turns with the parent's
    # and torch.optim.Adagrad's sparse step; the rows put back after)
    s16, a16 = st.emb_params["w16"][0], st.emb_opt_state["w16"][0]
    out["adagrad_rows"] = k6_case(torch, "zoo_w16_sparse", (
        s16, a16, uids, ugrads, ZOO_LR, opt.eps))
    for name, c in out.items():
        lib = "—" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        log(f"time {name} {c['case']}: kernel {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f}, library {lib}, bound "
            f"{c['bound_ms']:.4f}")

    # both regimes on the w16 slab, in turns with the parent's wrappers
    # (change, parent, parent, change: its dense-apply regime is the
    # zero slab + K3 + K7 chain)
    from distributed_embeddings_torch.parallel import SparseAdagrad

    regime_ms = {}
    sides = ("change", "parent", "parent", "change") if parent else (
        "change",)
    for label, ratio in (("dense_apply", 1e9), ("sparse", None)):
        o = SparseAdagrad(dense_apply_ratio=ratio)
        got = {}
        for side in sides:
            with (parent_wrappers() if side == "parent"
                  else contextlib.nullcontext()):
                got.setdefault(side, []).append(time_ms(
                    torch, lambda: o.apply_rows(s16, a16, ids16, vals16,
                                                ZOO_LR), [()]))
        regime_ms[label] = float(np.median(got["change"]))
        regime_ms["parent_" + label] = (float(np.median(got["parent"]))
                                        if parent else None)
    # the fused call: the stream read once, each distinct row's
    # accumulator and slab row read and written once; the slab-wide
    # chain: also the zero fill and K7's five slab-wide passes
    fused_bytes = n * (4 + w16 * 4) + distinct * w16 * 4 * 4
    chain_bytes = s16.numel() * 4 * 6 + n * (4 + w16 * 4)
    regime = {"w16_rows": R16, "ids": n, "unique_ids": distinct,
              "dense_apply_ms": regime_ms["dense_apply"],
              "parent_dense_apply_ms": regime_ms["parent_dense_apply"],
              "sparse_ms": regime_ms["sparse"],
              "parent_sparse_ms": regime_ms["parent_sparse"],
              "dense_apply_bound_ms": fused_bytes / HBM_BYTES_PER_S * 1e3,
              "slab_wide_bound_ms": chain_bytes / HBM_BYTES_PER_S * 1e3}
    log("zoo regimes on w16: " + json.dumps(regime))
    return st, out, regime


def phase_zoo(torch):
    """The synthetic zoo's tiny model trained with SparseAdagrad."""
    from distributed_embeddings_torch.models import InputGenerator

    log("zoo: small-table check, kernels against plain versions")
    errs = {"adagrad_rows": 0.0, "adagrad_dense_scatter": 0.0}
    for dtype, acc_dtype in ((torch.float32, torch.float32),
                             (torch.bfloat16, torch.float32),
                             (torch.bfloat16, torch.bfloat16)):
        for ratio in (6.0, None):
            e = zoo_small_check(torch, dtype, acc_dtype, ratio)
            if dtype == torch.float32:
                name = "adagrad_dense_scatter" if ratio else "adagrad_rows"
                errs[name] = max(errs[name], e)
    # the dense-apply regime's slab-wide chain (K3 + K7): eps = 0 over a
    # zero accumulator
    slab_wide_launches, errs["adagrad_dense"] = zoo_slab_wide_check(torch)
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
    # the fp32 Adagrad step (K3 the w8 scatter-sum) through the parent's
    # wrappers in turns (--parent)
    from distributed_embeddings_torch.parallel import (
        Adagrad, make_hybrid_train_step)

    holder = [st]
    zstep = make_hybrid_train_step(de, zoo_loss, Adagrad(ZOO_LR), opt,
                                   lr_schedule=ZOO_LR, nan_guard=False)

    def zoo_step(k):
        num, cats, lab = data[k % len(data)]
        holder[0] = zstep(holder[0], cats, (num, lab))[1]

    fp32["in_turns_with_parent"] = steps_in_turns(torch, zoo_step, rounds=3)
    st = holder[0]
    if fp32["in_turns_with_parent"]:
        log("zoo fp32: steps in turns with the parent's K1/K3/K10/K19/K20/"
            "K22 wrappers (ms): " + json.dumps(fp32["in_turns_with_parent"]))
    st, kcases, regime = zoo_kernel_times(torch, de, opt, st, data, cfg)
    log(f"zoo peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del st
    torch.cuda.empty_cache()
    cfg, de, opt, st = zoo_model(torch, torch.bfloat16, seed=SEED + 60)
    st, bf16_errs, _ = zoo_full_check(torch, de, opt, st, data, cfg, "bf16")
    st, _, bf16 = zoo_timed(torch, de, opt, st, data, cfg, "bf16")
    bf16["full_step_max_abs_err"] = bf16_errs
    # K6 at the bf16 tables' w16 shapes, on one step's K5 output
    bstep = make_hybrid_train_step(de, zoo_loss, Adagrad(ZOO_LR), opt,
                                   lr_schedule=ZOO_LR, nan_guard=False)
    num, cats, lab = data[1]
    with recording(torch, opt, snapshot=False) as seen:
        _, st = bstep(st, cats, (num, lab))
    r16 = seen["w16"]
    kcases["adagrad_rows_bf16"] = k6_case(
        torch, "zoo_w16_sparse_bf16", (st.emb_params["w16"][0],
                                       st.emb_opt_state["w16"][0],
                                       r16["uids"], r16["ugrads"], ZOO_LR,
                                       opt.eps))
    del seen, r16
    del st
    torch.cuda.empty_cache()
    return launches, errs, kcases, {"fp32": fp32, "bf16": bf16,
                                    "regimes_w16": regime,
                                    "slab_wide_launches": slab_wide_launches}


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
    K4 once, K21 and K22 once (the step is guarded); nothing else."""
    want = {name: 0 for name in kernel_fns()}
    want.update(ragged_combine=groups, ragged_grad=groups,
                lengths_to_splits=2 * groups, sgd_scatter=1,
                dot_interact_fwd=1, dot_interact_bwd=1, pack_ids=1,
                pack_columns=1, **epilogue())
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
    """Values of ``got`` beyond the reordered-scatter bound around
    ``want``: rows hit at most once bit-exact, a row k ids hit within k
    ulps of the slab dtype of ``mag``. Returns ``(count, max abs
    error)``."""
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
    params must be bitwise equal, and the slabs are held within the
    bound of a reordered scatter (K3 runs in both, and is deterministic:
    they come out bitwise equal): rows hit once bit-exact, a row k ids
    hit within k ulps (of the table dtype) of |old| + the sum of
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


def unbased(kw):
    """A recorded call's keywords for the parent's wrappers, which take no
    row base (the call's ``rbase`` is None: an unsliced group)."""
    check(kw.get("rbase") is None, "the parent's wrappers take no row base")
    return {k: v for k, v in kw.items() if k != "rbase"}


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
    (forward and backward), K8's output and K9's stream bit-exact, and the
    touched slab rows against K9's stream: rows hit at most L (``SPLIT``)
    times bit-exact to the stream-order sum, a row k ids hit within k
    fp32 ulps of |old| + the sum of |lr x update| (K3 sums its chunks of
    L in a fixed order, the reference ``index_add_`` in its atomics'
    order), and a control dropping every other position must fail the
    bit-exact part. Then the same batch with three features as
    ``SparseIds`` must give a bitwise-equal forward."""
    from distributed_embeddings_torch.ops import (
        lengths_to_splits_plain, ragged_combine_plain, ragged_grad_plain,
        row_to_split, scatter_add)
    from distributed_embeddings_torch.ops.scatter_add import SPLIT
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
            record_calls(apply, "ragged_grad") as k9, \
            interaction_checks(torch, errs, "ragged full-size step") as ic:
        loss, st = step(st, cats, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == ragged_per_step(1), f"ragged full-size step: launches "
          f"{counts}, expected {ragged_per_step(1)}")
    check(ic == {"fwd": 1, "bwd": 1}, f"ragged full-size step: "
          f"interaction calls {ic}")
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
    # K3: the touched rows against the stream: rows hit at most L times
    # bit-exact to the stream-order sum, the rest within k fp32 ulps of an
    # index_add_ of their updates (its atomics' order)
    r = rec.seen
    gid = r["ids"].long()
    keep = torch.nonzero((gid >= 0) & (gid < nrows)).squeeze(1)
    pos = torch.searchsorted(r["uniq"], gid[keep])
    del gid
    hits = torch.bincount(pos, minlength=len(r["uniq"]))
    few = hits <= SPLIT
    nl = scatter_add._neg_lr(r["lr"], torch.float32).cuda()

    def upd(i):  # K3's float32 chain: fp32(-lr) * vals
        return r["vals"][keep[i]].float() * nl

    def stream_order(at):
        """``before`` plus the updates at ``at`` (indices into the kept
        positions, rows with at most L hits), the k-th update of every row
        in pass k."""
        out = r["before"].clone()
        rr = pos[at]
        order = torch.sort(rr, stable=True).indices
        s_ = rr[order]
        idx = torch.arange(len(s_), device="cuda")
        first = torch.ones_like(s_, dtype=torch.bool)
        first[1:] = s_[1:] != s_[:-1]
        rank = idx - torch.cummax(torch.where(first, idx, 0), 0).values
        by_rank = at[order][torch.sort(rank, stable=True).indices]
        lo = 0
        for hi in torch.cumsum(torch.bincount(rank), 0).tolist():
            i = by_rank[lo:hi]
            out[pos[i]] = out[pos[i]] + upd(i)
            lo = hi
        return out

    exact_at = torch.nonzero(few[pos]).squeeze(1)
    want = stream_order(exact_at)
    mag = r["before"].float().abs()
    many_at = torch.nonzero(~few[pos]).squeeze(1)
    chunk = 1 << 22
    for lo in range(0, len(many_at), chunk):
        i = many_at[lo:lo + chunk]
        want.index_add_(0, pos[i], upd(i))
    for lo in range(0, len(pos), chunk):
        i = torch.arange(lo, min(lo + chunk, len(pos)), device="cuda")
        mag.index_add_(0, pos[i], upd(i).abs())
    got = slab[r["uniq"]]
    e = (got - want).abs()
    once = int(torch.count_nonzero(e[few]))
    multi = int(torch.count_nonzero(
        e > hits[:, None] * ulp(torch, mag, torch.float32)))
    check(once == 0 and multi == 0, f"ragged full-size step: {once} values "
          f"of rows hit at most {SPLIT} times differ from the stream-order "
          f"sum, {multi} beyond k fp32 ulps (max err {float(e.max())})")
    # the control: every other position of the stream is not the function
    ctrl = stream_order(exact_at[keep[exact_at] % 2 == 0])
    ctrl_bad = int(torch.count_nonzero((got != ctrl)[few]))
    check(ctrl_bad > 0, "ragged full-size step: the control (every other "
          "position dropped) passed the bit-exact check")
    errs["sgd_scatter"] = float(e.max())
    log(f"ragged: K3 on the step's stream: {int(few.sum())} rows with at "
        f"most {SPLIT} hits bit-exact to the stream-order sum, "
        f"{int((~few).sum())} rows (up to {int(hits.max())} hits) within k "
        f"fp32 ulps; the control differs in {ctrl_bad} values")
    del want, ctrl, mag, pos, keep, exact_at, many_at
    changed = int(torch.count_nonzero((got != r["before"]).any(1)))
    log(f"ragged: full-size step at b={TRAIN_BATCH}, cap {cap}: loss "
        f"{float(loss):.5f}; {r['ids'].numel()} stream positions, "
        f"{len(r['uniq'])} touched rows ({int((hits > 1).sum())} hit more "
        f"than once, {changed} changed); vs plain on the step's inputs: "
        f"lengths_to_splits (forward and backward), ragged_combine and "
        f"ragged_grad bit-exact, sgd_scatter max_abs_err "
        f"{errs['sgd_scatter']} (rows hit at most {SPLIT} times bit-exact, "
        "k hits within k fp32 ulps)")
    del rec.seen, r, got, e
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

    stages = ragged_stages(torch, de, st, batches)
    holder = [st]

    def run_step(k):
        holder[0] = step(holder[0], *batches[k % len(batches)])[1]

    turns = steps_in_turns(torch, run_step)
    st = holder[0]
    if turns:
        turns["stages"] = stages_in_turns(
            torch, lambda: ragged_stages(torch, de, st, batches))
        log("ragged: steps and stage splits in turns with the parent's "
            "K1/K2/K3/K4/K10/K19/K20/K22 wrappers (ms): " + json.dumps(turns))
    b = batches[0][1][0].shape[0]
    result = {
        "batch": b, "steps": TRAIN_STEPS,
        "samples_per_s": TRAIN_STEPS * b / wall,
        "wall_step_ms": wall / TRAIN_STEPS * 1e3,
        "step_ms_p50": float(np.median(step_ms)),
        "step_ms_min": float(np.min(step_ms)),
        "stage_ms_p50": stages,
        "in_turns_with_parent": turns,
        "launches_per_step": {n: v / TRAIN_STEPS
                              for n, v in launches.items()},
        "loss_first": float(losses[0]), "loss_last": float(losses[-1])}
    log("ragged timed: " + json.dumps(result))
    return st, launches, result


def ragged_stages(torch, de, st, batches, runs=10):
    """Median device ms of the ragged step's stages over ``runs`` steps
    (after the warmup), each called as the step calls it with events
    between them (the cotangent streams, K9 and K10, apart from the
    sparse apply, K3)."""
    from distributed_embeddings_torch.parallel import SGD, SparseSGD, trainer
    from distributed_embeddings_torch.parallel import apply as apply_mod

    tx = SGD(TRAIN_LR)
    names = ["embedding_forward", "dense_forward_backward", "nan_guard",
             "cotangent_streams", "sparse_apply", "dense_update"]
    stage_ms = {n: [] for n in names}
    params = list(st.dense_params.parameters())
    local = de.local_view(st.emb_params)
    for k in range(WARMUP_RUNS + runs):
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
        dense_grads, out_grads = (list(grads[:len(params)]),
                                  list(grads[len(params):]))
        # the guard and the dense update as the step calls them (K21, K22)
        health = trainer.grad_health(out_grads + dense_grads)
        n = len(out_grads)
        ok = (torch.isfinite(loss.float())
              & torch.isfinite(health[0, n:].sum())
              & torch.isfinite(0.0 * health[0, :n].sum()))
        ev[3].record()
        per_width = apply_mod.cotangent_width_streams(de, res, out_grads)
        ev[4].record()
        apply_mod.apply_width_streams(de, local, st.emb_opt_state,
                                      per_width, SparseSGD(), TRAIN_LR, 1.0,
                                      enable=ok)
        ev[5].record()
        tx.update_(dense_grads, st.dense_opt_state, params, ok=ok)
        ev[6].record()
        del per_width, grads, outs, res
        torch.cuda.synchronize()
        if k >= WARMUP_RUNS:
            for i, name in enumerate(names):
                stage_ms[name].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: float(np.median(v)) for n, v in stage_ms.items()}


def ragged_kernel_times(torch, de, st, batches):
    """CUDA-event medians of K8, K9 and K10 at the shapes the full-size
    step gives them (recorded from the step itself, one set per
    pre-staged batch), and of K3 on one step's ragged stream, each
    against its plain version, one library call for the same function,
    and its byte bound: each input read once, each output written once,
    each distinct slab row read (and, for K3, written) once."""
    import importlib

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
    a0, kw0 = args8[0]
    g0, o0 = lib8[0]
    live_ids = int(g0.numel())
    esize = slab.element_size()
    row = w * esize
    out_bytes = n * b * w * torch.empty(
        (), dtype=kw0.get("out_dtype") or slab.dtype).element_size()
    nbytes = live_ids * 4 + n * (b + 1) * 8 + uniq8[0] * row + out_bytes
    par = parent_ops()
    parent8 = None if par is None else (
        lambda: par["embedding_lookup"].ragged_combine(*a0,
                                                       **unbased(kw0)))
    case = kernel_case(
        torch, "ragged_combine", f"{n}x{b} rows, cap {cap}",
        lambda: ragged_combine(*a0, **kw0), parent8,
        lambda: F.embedding_bag(g0, slab, o0, mode="sum"), nbytes,
        plain=lambda: ragged_combine_plain(*a0, **kw0),
        extra=dict(unique_rows=uniq8[0], ids=live_ids))
    case.update(out_bytes=out_bytes,
                row_read_tb_per_s=live_ids * row / (case["ms"] * 1e-3) / 1e12)
    # the same positions and splits with every id folded into the first
    # 2,048 rows of its table: all rows resident in the 50 MB L2 (26 x
    # 2,048 x 512 B = 27 MB)
    fold = [((a[0], a[1].remainder(2048), *a[2:]), kw) for a, kw in args8]
    ms_l2 = time_ms(torch, fn8, fold)
    case.update(l2_resident_ms=ms_l2, row_reads=live_ids, row_bytes=row,
                l2_row_read_tb_per_s=live_ids * row / (ms_l2 * 1e-3) / 1e12)
    cases["ragged_combine"] = case
    log(f"time ragged_combine: {case['ms']:.4f} ms at the step's ids "
        f"({case['row_read_tb_per_s']:.2f} TB/s of row reads, every one "
        f"from global memory (L2 or HBM); parent {case['parent_ms']}); "
        f"{ms_l2:.4f} ms with every id folded into its table's first "
        f"2,048 rows")
    del fold

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
    # each batch's call in turn (the step's cycle), then the first batch's
    # call through kernel_case: in turns with the parent's wrapper and
    # index_select, its device ms and its record's host split
    ms = time_ms(torch, lambda a, kw: ragged_grad(*a, **kw), args9)
    esize = args9[0][0][0].element_size()
    nbytes = (n * b * w * esize + live_ids * 4 + n * (b + 1) * 8
              + n * cap * (4 + w * esize))
    (g9, sp9), kw9 = args9[0]
    gpad0, sidx0 = lib9[0]
    case = kernel_case(
        torch, "ragged_grad", f"{n}x{cap} positions",
        lambda: ragged_grad(g9, sp9, **kw9),
        None if par is None else (
            lambda: par["sparse_grad"].ragged_grad(g9, sp9,
                                                   **unbased(kw9))),
        lambda: torch.index_select(gpad0, 0, sidx0), nbytes,
        plain=lambda: ragged_grad_plain(g9, sp9, **kw9),
        extra=dict(positions=n * cap, cycling_ms=ms))
    sg = importlib.import_module(
        "distributed_embeddings_torch.ops.sparse_grad")
    key9 = (g9, sp9, kw9.get("cap") or kw9["values"].shape[1],
            kw9.get("values"), kw9.get("rows"), kw9.get("roff"),
            int(kw9.get("sentinel", 0)), kw9.get("ids_dtype"),
            kw9.get("mean"), kw9.get("weights"), kw9.get("reciprocal", False),
            kw9.get("rbase"))
    ids_o, vals_o = ragged_grad(g9, sp9, **kw9)
    case["host_split_us"] = launch_host_split(
        torch, "ragged_grad", lambda: sg.ragged_grad_key(*key9), sg._K9,
        tuple(None if t is None else t.data_ptr() for t in (
            g9, sp9, *key9[3:6], kw9.get("rbase"), key9[8], key9[9], ids_o,
            vals_o)),
        lambda: ragged_grad(g9, sp9, **kw9),
        [t for t in key9 if isinstance(t, torch.Tensor)], calls=20)
    cases["ragged_grad"] = case
    del lib9, ids_o, vals_o

    # K10 -------------------------------------------------------------
    # each entry point through this tree's wrapper and, in turns, the
    # parent's, on the step's own inputs (``kernel_case``)
    import importlib

    el = importlib.import_module("distributed_embeddings_torch.ops."
                                 "embedding_lookup")
    parent = parent_ops()
    pel = parent["embedding_lookup"] if parent else None

    def parent_of(name, arg_sets):
        if pel is None:
            return None
        return cycling(getattr(pel, name), arg_sets)

    args10 = [tuple(a) + tuple(kw.values()) for a, kw, _ in k10]
    lengths0, valid0 = args10[0][0], args10[0][1]
    nbytes = n * b * lengths0.element_size() + n * (b + 1) * 8
    csr = [kernel_case(
        torch, "csr", f"lengths_to_splits {n}x{b}",
        cycling(lengths_to_splits, args10),
        parent_of("lengths_to_splits", args10),
        cycling(lambda ln, *_: torch.cumsum(ln, 1), args10), nbytes,
        plain=cycling(lengths_to_splits_plain, args10))]
    out10 = lengths_to_splits(lengths0, valid0)
    csr[-1]["host_split_us"] = launch_host_split(
        torch, f"lengths_to_splits {n}x{b}",
        lambda: el.splits_record_key(lengths0, valid0), el._SPLITS,
        (lengths0.data_ptr(), out10.data_ptr()),
        lambda: lengths_to_splits(lengths0, valid0),
        [lengths0] if valid0 is None else [lengths0, valid0])
    del out10
    coo = [(as_sparse_ids(torch, cats[0], b).indices, b)
           for cats, _ in batches]
    targets = torch.arange(b + 1, dtype=torch.int32, device="cuda")
    rows = [(i[:, 0].contiguous(),) for i, _ in coo]
    nbytes = coo[0][0].shape[0] * 4 + (b + 1) * 4
    csr.append(kernel_case(
        torch, "csr", f"row_to_split {coo[0][0].shape[0]} ids",
        cycling(row_to_split, coo), parent_of("row_to_split", coo),
        cycling(lambda r: torch.searchsorted(r, targets), rows), nbytes,
        plain=cycling(row_to_split_plain, coo)))
    # ragged_row_ids on the step's own splits (no path of the step
    # calls it: the JAX package's ragged_row_ids entry point)
    rid_args = [(a[1], cap) for a, _ in args9]
    for sp, c in rid_args:
        exact(torch, ragged_row_ids(sp, c), ragged_row_ids_plain(sp, c),
              "ragged_row_ids on the step's splits")
    pos = torch.arange(cap, dtype=rid_args[0][0].dtype,
                       device="cuda").expand(n, cap).contiguous()
    ends = [(sp[:, 1:].clamp(0, cap).contiguous(),) for sp, _ in rid_args]
    es = rid_args[0][0].element_size()
    nbytes = n * (b + 1) * es + n * cap * es
    csr.append(kernel_case(
        torch, "csr", f"ragged_row_ids {n}x{cap} positions",
        cycling(ragged_row_ids, rid_args),
        parent_of("ragged_row_ids", rid_args),
        cycling(lambda e: torch.searchsorted(e, pos, right=True), ends),
        nbytes, plain=cycling(ragged_row_ids_plain, rid_args)))
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
    nl = torch.tensor(-TRAIN_LR, dtype=torch.float32, device="cuda")
    lib_i, lib_u = ids[keep].long(), vals[keep].float() * nl
    del keep
    n3 = ids.numel()
    nbytes = n3 * w * vals.element_size() + n3 * 4 + 2 * uniq * w * 4
    parent = parent_ops()
    from distributed_embeddings_torch.ops import scatter_add

    scratch = scatter_add.find_sgd_record(
        scatter_add._K3, slab, ids, vals, TRAIN_LR,
        build_on_cpu=True).payload[0]
    scratch_gb = 0.0 if scratch is None else scratch.numel() / 1e9
    del scratch
    case = segment_case(
        torch, "sgd_scatter", f"ragged b65536 stream ({n3} positions)",
        lambda: sgd_scatter(slab, ids, vals, TRAIN_LR),
        (lambda: parent["scatter_add"].sgd_scatter(slab, ids, vals,
                                                   TRAIN_LR))
        if parent else None,
        lambda: slab.index_add_(0, lib_i, lib_u), nbytes,
        lambda: k3_plain(ids, vals), ids, rows,
        extra={"scratch_gb": scratch_gb})
    del lib_i, lib_u
    log(f"  sgd_scatter ragged: the record's scratch (sort buffers, lists "
        f"and partials) holds {scratch_gb:.3f} GB")
    # DETPU_SGD_DEDUP=1's chain (K5 then K3's dedup chain) in turns
    from distributed_embeddings_torch.ops import dedup_sparse_grad

    def dedup_chain():
        u, v = dedup_sparse_grad(ids, vals, pad_id=rows, max_unique=rows + 1)
        sgd_scatter(slab, u, v, TRAIN_LR, cast_vals=False)

    case["k3_ms_in_turns"], case["dedup_chain_ms"] = ab_ms(
        torch, lambda: sgd_scatter(slab, ids, vals, TRAIN_LR), dedup_chain)
    log(f"  sgd_scatter ragged: K3 {case['k3_ms_in_turns']:.4f} ms against "
        f"DETPU_SGD_DEDUP=1's K5 + K3 {case['dedup_chain_ms']:.4f} ms in "
        "turns")
    cases["sgd_scatter"] = case
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
    (K11); Nesterov off and on (K12); negative ids beside id 0, the
    sentinel, ids past the slab and a pad tail, in the dedup's signed
    order (the walk K11 and K12 share runs the negative prefix, which
    reads row 0 as it was, before row 0's own update). Then one
    ``apply_rows`` of each optimizer on a stream where one id repeats
    50,000 times, its row kernel held to the plain version on the K5
    output of that call."""
    from distributed_embeddings_torch.parallel import optimizers

    rng = np.random.default_rng(SEED + 100)
    R = 4096
    errs = {"adam_rows": 0.0, "momentum_rows": 0.0}
    n_cases = 0
    f32, bf16 = torch.float32, torch.bfloat16
    for sd, md in ((f32, f32), (bf16, bf16), (bf16, f32)):
        for w in (16, 8, 3):
            rows = 1 + rng.permutation(R - 21)[:1500]
            # the dedup's signed order (K11 finds its live range in it)
            uids = np.sort(np.concatenate([rows, [0, -1, -7, R, R + 5,
                                                  -R - 3], [R] * 64]))
            untouched = torch.as_tensor(np.setdiff1d(
                np.arange(R), np.union1d(rows, [0, R - 1, R - 7])),
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
    from distributed_embeddings_torch.parallel import optimizers

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
    last = []
    for label, dtype in (("bench_fp32", torch.float32),
                         ("bench_bf16", torch.bfloat16)):
        t0 = time.perf_counter()
        with last_call(optimizers, "adam_rows", last, label == "bench_fp32"):
            aucs = train_dlrm_convergence(
                task, steps=360, batch=8192, embedding_dim=16,
                lr_schedule=0.01, param_dtype=dtype, device="cuda")
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
    # K11 at the convergence run's shapes: the last call of its fp32 run
    args = last[0]
    out["k11_case"] = k11_case(
        torch, f"convergence bench fp32 w{args[0].shape[1]}: "
        f"{int((args[4] < args[0].shape[0]).sum())} unique rows", args)
    return launches, out


@contextlib.contextmanager
def last_call(module, name, keep, on=True):
    """Wrap ``module.<name>`` so that ``keep`` holds the arguments of its
    last call only (``keep[0]``); nothing when not ``on``."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        keep[:] = [args]
        return real(*args, **kw)

    if on:
        setattr(module, name, wrapper)
    try:
        yield keep
    finally:
        setattr(module, name, real)


def row_expected(de, name):
    """Launches a zoo step makes with ``SparseAdam``/``SparseMomentum``:
    K1 once per plan group, K5 and K11/K12 once per width slab."""
    plan = next(iter(de._plan_cache.values()))
    want = {k: 0 for k in kernel_fns()}
    want.update(gather_combine=len(plan.groups), pack_ids=1, pack_columns=1)
    want["dedup_sparse_grad"] = len(de.widths)
    want[ROW_SITES[name]] = len(de.widths)
    want.update(epilogue())
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
    epi_errs = {}
    with recording(torch, opt) as seen, epilogue_checks(
            torch, epi_errs, f"{name} zoo step {label}") as ec:
        zero_counts()
        loss, st = step(st, cats, (num, lab))
        torch.cuda.synchronize()
        counts = read_counts()
    want = row_expected(de, name)
    check(counts == want, f"{name} zoo step {label}: launches {counts}, "
          f"expected {want}")
    check(ec == {"grad_health": 1, "dense_update": 1}, f"{name} zoo step "
          f"{label}: epilogue calls {ec}")
    check(bool(torch.isfinite(loss)), f"{name} zoo step {label}: loss "
          f"{float(loss)}")
    errs = {"dedup_sparse_grad": 0.0, ROW_SITES[name]: 0.0, **epi_errs}
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
    """K11 or K12 at the zoo's w16 and w8 shapes (the unique rows of one
    step's K5 output) through ``k11_case`` / ``k12_case``: in turns with
    the parent's wrapper, beside the plain version, the byte bound of the
    live rows and the record's host split (K12 has no single library
    call)."""
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
        label = (f"zoo {key} {str(slab.dtype)[6:]}: {touched} unique rows "
                 f"of {w}")
        if name == "adam":
            cases.append(k11_case(torch, label, (
                slab, *state, uids, ugrads, ZOO_LR, opt.b1, opt.b2, opt.eps,
                opt.eps_root)))
        else:
            cases.append(k12_case(torch, label, (
                slab, state, uids, ugrads, ZOO_LR, opt.momentum,
                opt.nesterov)))
    gc.collect()
    torch.cuda.empty_cache()
    return st, sorted(cases, key=lambda c: -c["unique_rows"])


def k6_case(torch, label, args):
    """K6 on one call's arguments (slab, acc, uids, ugrads, lr, eps)
    through ``kernel_case``: in turns with the parent's wrapper and, on a
    float32 slab, ``torch.optim.Adagrad(..., eps=eps).step`` on a
    coalesced COO gradient of the same live rows (the library call: its
    ``eps`` sits outside the square root, a yardstick of the same
    traffic), beside its plain version and its byte bound (each live
    row's gradient row read once, its accumulator and slab rows read and
    written once, and the live ids: the pad tail is not the function's
    work), with its record's host split. The rows it touches are put
    back after, so the state goes on as the step left it."""
    import importlib

    from distributed_embeddings_torch.ops import (adagrad_rows,
                                                  adagrad_rows_plain)

    ada = importlib.import_module("distributed_embeddings_torch.ops.adagrad")
    slab, acc, uids, ugrads, lr, eps = args
    rows, w = slab.shape
    live = uids < rows
    touched = int(live.sum())
    hit = uids[live].long()
    hit = torch.unique(torch.cat([torch.where(hit < 0, hit + rows, hit),
                                  hit.new_zeros(1)]))
    hit = hit[hit >= 0]
    kept = [t[hit].clone() for t in (slab, acc)]
    es, ea = slab.element_size(), acc.element_size()
    nbytes = touched * (uids.element_size() + w * (ea + 2 * (es + ea)))
    ops = 9 * touched * w
    lib = param = None
    if slab.dtype == torch.float32:
        param = torch.nn.Parameter(slab, requires_grad=False)
        param.grad = torch.sparse_coo_tensor(
            uids[live].long()[None], ugrads[live].float(),
            tuple(slab.shape)).coalesce()
        lib = torch.optim.Adagrad([param], lr=float(lr), eps=eps).step
    parent = parent_ops()
    case = kernel_case(
        torch, "adagrad_rows", label, lambda: adagrad_rows(*args),
        (lambda: parent["adagrad"].adagrad_rows(*args)) if parent else None,
        lib, nbytes, plain=lambda: adagrad_rows_plain(*args),
        extra={"unique_rows": touched, "ids": uids.numel(),
               "dtypes": [str(slab.dtype)[6:], str(acc.dtype)[6:]],
               "library_call": "torch.optim.Adagrad.step" if lib
               else None})
    if ops / F32_OPS_PER_S > nbytes / HBM_BYTES_PER_S:
        case.update(bound_ms=ops / F32_OPS_PER_S * 1e3, bound_by="operations")
    del lib, param
    case["host_split_us"] = launch_host_split(
        torch, f"adagrad_rows {label}", lambda: ada.record_key(*args),
        ada._CACHE,
        (slab.data_ptr(), acc.data_ptr(), uids.data_ptr(), ugrads.data_ptr(),
         lr.data_ptr() if isinstance(lr, torch.Tensor) else None),
        lambda: adagrad_rows(*args), [slab, acc, uids, ugrads])
    for t, k in zip((slab, acc), kept):
        t[hit] = k
    return case


def k12_case(torch, label, args):
    """K12 on one call's arguments (slab, trace, uids, uvals, lr,
    momentum, nesterov) through ``kernel_case``: in turns with the
    parent's wrapper (the first design's two launches over every id),
    beside its plain version and its byte bound (each live row's gradient
    row read once, its trace and slab rows read and written once, and the
    live ids: the pad tail is not the function's work), with its
    record's host split; no single PyTorch call computes the momentum
    row update. The rows it touches are put back after, so the state
    goes on as the step left it."""
    import importlib

    from distributed_embeddings_torch.ops import (momentum_rows,
                                                  momentum_rows_plain)

    mom = importlib.import_module("distributed_embeddings_torch.ops."
                                  "momentum")
    slab, trace, uids, uvals, lr = args[:5]
    rows, w = slab.shape
    live = uids < rows
    touched = int(live.sum())
    hit = uids[live].long()
    hit = torch.unique(torch.cat([torch.where(hit < 0, hit + rows, hit),
                                  hit.new_zeros(1)]))
    hit = hit[hit >= 0]
    kept = [t[hit].clone() for t in (slab, trace)]
    es, et = slab.element_size(), trace.element_size()
    nbytes = touched * (uids.element_size() + w * (et + 2 * (es + et)))
    ops = 6 * touched * w
    parent = parent_ops()
    case = kernel_case(
        torch, "momentum_rows", label, lambda: momentum_rows(*args),
        (lambda: parent["momentum"].momentum_rows(*args)) if parent
        else None, None, nbytes, plain=lambda: momentum_rows_plain(*args),
        extra={"unique_rows": touched, "ids": uids.numel(),
               "dtypes": [str(slab.dtype)[6:], str(trace.dtype)[6:]],
               "nesterov": bool(args[6]),
               "library_call": "none: no single PyTorch call on CUDA "
                               "computes the momentum row update"})
    if ops / F32_OPS_PER_S > nbytes / HBM_BYTES_PER_S:
        case.update(bound_ms=ops / F32_OPS_PER_S * 1e3, bound_by="operations")
    case.update(call_floor(
        torch, f"momentum_rows {label}", lambda: momentum_rows(*args),
        (lambda: parent["momentum"].momentum_rows(*args)) if parent
        else None))
    case["host_split_us"] = launch_host_split(
        torch, f"momentum_rows {label}", lambda: mom.record_key(*args),
        mom._CACHE,
        (slab.data_ptr(), trace.data_ptr(), uids.data_ptr(),
         uvals.data_ptr(),
         lr.data_ptr() if isinstance(lr, torch.Tensor) else None),
        lambda: momentum_rows(*args), [slab, trace, uids, uvals])
    for t, k in zip((slab, trace), kept):
        t[hit] = k
    return case


def k11_case(torch, label, args):
    """K11 on one call's arguments (slab, mu, nu, count, uids, uvals, lr,
    b1, b2, eps, eps_root) through ``kernel_case``: in turns with the
    parent's wrapper and, on a float32 slab, ``torch.optim.SparseAdam.
    step`` on a coalesced COO gradient of the same live rows (the
    library call: its ``eps`` sits outside the bias correction, a
    yardstick of the same traffic), beside its plain version and its
    byte bound (each live row's gradient, state and slab rows read once
    and the state and slab written once, and the live ids: the pad tail
    is not the function's work), and its record's host split. The rows it touches are put back after, so the
    state goes on as the step left it."""
    import importlib

    from distributed_embeddings_torch.ops import adam_rows, adam_rows_plain

    am = importlib.import_module("distributed_embeddings_torch.ops.adam")
    slab, mu, nu, count, uids, uvals, lr = args[:7]
    rows, w = slab.shape
    touched = int((uids < rows).sum())
    # the timing runs K11 (and the library call) thousands of times on the
    # same rows: keep the rows it touches and put them back after
    hit = uids[uids < rows].long()
    hit = torch.unique(torch.cat([torch.where(hit < 0, hit + rows, hit),
                                  hit.new_zeros(1)]))
    hit = hit[hit >= 0]
    kept = [t[hit].clone() for t in (slab, mu, nu)]
    es, eg = slab.element_size(), uvals.element_size()
    nbytes = touched * (uids.element_size() + w * (eg + 2 * (es + 2 * eg)))
    lib = param = None
    if slab.dtype == torch.float32:
        keep = uids < rows
        param = torch.nn.Parameter(slab, requires_grad=False)
        param.grad = torch.sparse_coo_tensor(
            uids[keep].long()[None], uvals[keep].float(),
            tuple(slab.shape)).coalesce()
        lib = torch.optim.SparseAdam([param], lr=float(lr)).step
    parent = parent_ops()
    case = kernel_case(
        torch, "adam_rows", label, lambda: adam_rows(*args),
        (lambda: parent["adam"].adam_rows(*args)) if parent else None, lib,
        nbytes, plain=lambda: adam_rows_plain(*args),
        extra={"unique_rows": touched, "ids": uids.numel(),
               "library_call": "torch.optim.SparseAdam.step" if lib
               else None})
    del lib, param
    case["host_split_us"] = launch_host_split(
        torch, f"adam_rows {label}", lambda: am.record_key(*args), am._CACHE,
        (slab.data_ptr(), mu.data_ptr(), nu.data_ptr(), uids.data_ptr(),
         uvals.data_ptr(), count.data_ptr(),
         lr.data_ptr() if isinstance(lr, torch.Tensor) else None),
        lambda: adam_rows(*args), [slab, mu, nu, count, uids, uvals])
    for t, k in zip((slab, mu, nu), kept):
        t[hit] = k
    return case


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
    from distributed_embeddings_torch.parallel import make_hybrid_train_step

    t_phase = time.perf_counter()
    errs = adam_kernel_checks(torch)
    log("adam: small-table lockstep checks, K11/K12 against plain")
    for name in ("adam", "momentum"):
        for dtype in (torch.float32, torch.bfloat16):
            adam_small_check(torch, dtype, name)
    torch.cuda.empty_cache()
    conv_launches, conv = convergence_runs(torch)
    conv_k11 = conv.pop("k11_case")
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
    # the stage split and the device busy share with K22 and, in turns,
    # with its plain version (the dense Adam chain the step ran before)
    for plain in (False, True):
        tag = "_plain_dense_update" if plain else ""
        with (plain_kernels(("dense_update",)) if plain
              else contextlib.nullcontext()):
            fp32["stage_ms_p50" + tag] = zoo_stages(torch, de, opt, st,
                                                    data, tx=tx)
            log(f"adam zoo stages fp32{tag} (ms): "
                + json.dumps(fp32["stage_ms_p50" + tag]))
            st, fp32["profile" + tag] = zoo_profile(
                torch, de, opt, st, data, tx=tx, label="adam fp32" + tag)
    holder = [st]
    astep = make_hybrid_train_step(de, zoo_loss, tx, opt,
                                   lr_schedule=ZOO_LR, nan_guard=False)

    def adam_step(k):
        num, cats, lab = data[k % len(data)]
        holder[0] = astep(holder[0], cats, (num, lab))[1]

    fp32["in_turns_with_parent"] = steps_in_turns(torch, adam_step,
                                                  rounds=3)
    st = holder[0]
    if fp32["in_turns_with_parent"]:
        log("adam zoo fp32: steps in turns with the parent's "
            "K1/K5/K10/K11/K19/K20/K22 wrappers (ms): "
            + json.dumps(fp32["in_turns_with_parent"]))
    st, adam_cases = row_kernel_times(torch, de, opt, st, data, "adam")
    adam_cases.append(conv_k11)
    adam_cases_k22 = time_dense_adam(torch, st, tx)
    result["adam_fp32"] = fp32
    result["adam_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # the same slabs with SparseMomentum (and Nesterov): Adam's state goes
    mom = {}
    mom_launches = mom_cases = None

    def fresh_state(st, opt, tx):
        st = st._replace(emb_opt_state=None, dense_opt_state=None)
        gc.collect()
        torch.cuda.empty_cache()
        return st._replace(
            emb_opt_state=opt.init(st.emb_params),
            dense_opt_state=tx.init(list(st.dense_params.parameters())))

    for nest in (False, True):
        label = "nesterov" if nest else "momentum"
        opt, tx = row_optimizer("momentum", nest)
        st = fresh_state(st, opt, tx)
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
    # both momentum steps in turns with the parent's wrappers (K12's
    # first design among them), after every check: Nesterov on the state
    # its checks left, then plain momentum from a fresh trace
    for nest in (True, False):
        label = "nesterov" if nest else "momentum"
        if not nest:
            opt, tx = row_optimizer("momentum", False)
            st = fresh_state(st, opt, tx)
        holder = [st]
        mstep = make_hybrid_train_step(de, zoo_loss, tx, opt,
                                       lr_schedule=ZOO_LR, nan_guard=False)

        def mom_step(k, mstep=mstep):
            num, cats, lab = data[k % len(data)]
            holder[0] = mstep(holder[0], cats, (num, lab))[1]

        turns = steps_in_turns(torch, mom_step, rounds=2)
        st = holder[0]
        if turns:
            mom[label]["in_turns_with_parent"] = turns
            log(f"{label} zoo fp32: steps in turns with the parent's "
                "wrappers (K12 among them; ms): " + json.dumps(turns))
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
    holder = [st]
    astep = make_hybrid_train_step(de, zoo_loss, tx, opt,
                                   lr_schedule=ZOO_LR, nan_guard=False)
    bf16["in_turns_with_parent"] = steps_in_turns(torch, adam_step,
                                                  rounds=3)
    st = holder[0]
    if bf16["in_turns_with_parent"]:
        log("adam zoo bf16: steps in turns with the parent's wrappers (ms): "
            + json.dumps(bf16["in_turns_with_parent"]))
    st, bf16_cases = row_kernel_times(torch, de, opt, st, data, "adam")
    adam_cases += bf16_cases
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
                            "momentum_rows": mom_cases,
                            "dense_update": adam_cases_k22}, result


def k22_host_split(torch, kind, params, grads, states, nlr, hyper, bp, ok,
                   counts, wrapper):
    """``launch_host_split`` of K22's record for one call."""
    import importlib

    du = importlib.import_module("distributed_embeddings_torch.ops."
                                 "dense_update")
    wrapper()
    return launch_host_split(
        torch, f"dense_update {kind}",
        lambda: du.record_key(kind, params, grads, states, nlr, hyper, bp, ok,
                              counts), du._CACHE,
        (nlr.data_ptr() if isinstance(nlr, torch.Tensor) else None,
         None if bp is None else bp.data_ptr(),
         None if ok is None else ok.data_ptr(),
         counts[0].data_ptr() if counts else None,
         counts[1].data_ptr() if len(counts) > 1 else None),
        wrapper, [*params, *grads, *(t for s in states for t in s)])


def time_dense_adam(torch, st, tx):
    """K22's Adam update on copies of the zoo's dense parameters and
    their Adam state, beside its plain version and, in turns, the
    parent's wrapper; one ``torch.optim.Adam(fused=True).step()`` over
    the same parameters and gradients (the library yardstick) and its
    byte bound (read p, g, mu, nu; write p, mu, nu: 28 B an element)."""
    from distributed_embeddings_torch.ops import (bias_powers, dense_update,
                                                  dense_update_plain)

    (ad,) = st.dense_opt_state[:1]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 160)
    params = [p.detach().clone() for p in st.dense_params.parameters()]
    grads = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-2
             for p in params]
    mu = [m.clone() for m in ad.mu]
    nu = [v.clone() for v in ad.nu]
    bp = bias_powers(ad.count + 1, tx.b1, tx.b2)
    hyper = {"b1": tx.b1, "b2": tx.b2, "eps": tx.eps,
             "eps_root": tx.eps_root}
    nlr = -tx.learning_rate
    parent = parent_ops()

    def kernel():
        dense_update("adam", params, grads, mu, nu, nlr, hyper, bp=bp)

    def parent_kernel():
        parent["dense_update"].dense_update("adam", params, grads, mu, nu,
                                            nlr, hyper, bp=bp)

    def plain():
        dense_update_plain("adam", params, grads, mu, nu, nlr, hyper, bp=bp)

    lp = [torch.nn.Parameter(p.clone()) for p in params]
    for p, g in zip(lp, grads):
        p.grad = g
    fused = torch.optim.Adam(lp, lr=tx.learning_rate, betas=(tx.b1, tx.b2),
                             eps=tx.eps, fused=True)
    numel = sum(p.numel() for p in params)
    case = kernel_case(torch, "dense_update", "zoo_adam", kernel,
                       parent_kernel if parent else None, fused.step,
                       28 * numel, plain=plain,
                       extra={"tensors": len(params), "elements": numel})
    case["host_split_us"] = k22_host_split(
        torch, "adam", params, grads, (mu, nu), nlr, hyper, bp, None, (),
        kernel)
    return [case]


# ------------------------------------------------------------- telemetry

TELEM_BATCH = 16384            # bench.py:run_telemetry_overhead's batch
TELEM_STEPS = 12               # its timed steps (bench.py RESIL_STEPS)
TELEM_WARMUP = 2
TELEM_CHECK_STEPS = 3
#: the call sites of K13-K15 (``sketch_fold``: a width's fold, all three)
TELEMETRY_SITES = ("sketch_update", "sketch_query", "sketch_fold")
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
    K1, K2, K4 and K3 once, K13, K14 (the pool) and K15 once, K22 once
    (the step is unguarded: no K21)."""
    want = {name: 0 for name in kernel_fns()}
    want.update(gather_combine=1, dot_interact_fwd=1, dot_interact_bwd=1,
                sgd_scatter=1, cms_update=1, topk_pool=1, topk_merge=1,
                pack_ids=1, pack_columns=1, **epilogue(guard=False))
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
    # dense params and K3's inputs bitwise; the slab within the bound of a
    # reordered scatter (K3 is deterministic: bitwise)
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
              f"beyond the reordered-scatter bound (max err {err})")
        worst = max(worst, err)
        slab_bitwise &= torch.equal(st.emb_params["w128"],
                                    off.emb_params["w128"])
        del off, before, hits, mag, streams
    log(f"  telemetry on vs off, {TELEM_CHECK_STEPS} lockstep steps: losses,"
        f" dense params and K3's inputs bitwise equal; slab "
        f"{'bitwise equal' if slab_bitwise else 'within the k-ulp bound'} "
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
    batch each step. A turn times off then on; the turns run change,
    parent, parent, change (the parent's K13-K15 through
    ``parent_wrappers``; without ``--parent`` the change's turns alone),
    each mode's time the mean of its side's turns. Launches counted over
    the change's timed on-steps."""
    from distributed_embeddings_torch.analysis import telemetry as tel

    cats, batch = train_batch(torch, sizes, TELEM_BATCH, SEED + 150)
    sides = (("change", "parent", "parent", "change")
             if parent_ops() is not None else ("change", "change"))
    runs = {side: {"off": [], "on": []} for side in set(sides)}
    launches = None
    for side in sides:
        for on in (False, True):
            step = telemetry_step(de, cfg if on else None)
            extra = (tel.init_telemetry(de, cfg, device="cuda"),) if on \
                else ()
            with (parent_wrappers() if side == "parent"
                  else contextlib.nullcontext()):
                for _ in range(TELEM_WARMUP):
                    loss, st, *extra = step(st, cats, batch, *extra)
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                for _ in range(TELEM_STEPS):
                    loss, st, *extra = step(st, cats, batch, *extra)
                torch.cuda.synchronize()
            runs[side]["on" if on else "off"].append(
                (time.perf_counter() - t0) / TELEM_STEPS)
            if on and side == "change":
                launches = read_counts()
                check(launches == telemetry_per_step(TELEM_STEPS),
                      f"telemetry timed launches {launches}, expected "
                      f"{telemetry_per_step(TELEM_STEPS)}")
            check(bool(torch.isfinite(loss)), f"telemetry timed loss {loss}")
    off, on = (float(np.mean(runs["change"][k])) for k in ("off", "on"))
    metrics = {
        "telemetry_off_samples_per_sec": TELEM_BATCH / off,
        "telemetry_samples_per_sec": TELEM_BATCH / on,
        "telemetry_overhead_frac": on / off - 1.0,
        "step_ms_off": off * 1e3, "step_ms_on": on * 1e3,
        "step_ms_runs": {k: [t * 1e3 for t in v]
                         for k, v in runs["change"].items()},
        "sketch": dict(cfg._asdict()), "batch": TELEM_BATCH,
        "steps": TELEM_STEPS}
    if "parent" in runs:
        poff, pon = (float(np.mean(runs["parent"][k])) for k in ("off",
                                                                 "on"))
        metrics["parent"] = {
            "telemetry_overhead_frac": pon / poff - 1.0,
            "step_ms_off": poff * 1e3, "step_ms_on": pon * 1e3,
            "step_ms_runs": {k: [t * 1e3 for t in v]
                             for k, v in runs["parent"].items()}}
    return st, launches, metrics


#: the sketch chain's kernels a telemetry step runs (csrc/sketch.cu): K13,
#: K14's pool (insert, select), K15 (the parent's 1024-thread CTA, or the
#: one-CTA merge of a thread an entry)
SKETCH_KERNELS = ("cms_update_kernel", "pool_insert_kernel",
                  "pool_select_kernel", "topk_merge_block_kernel")
PARENT_K15 = "topk_merge_kernel"
SKETCH_CHAIN = re.compile(r"namespace\)::(" + "|".join(
    SKETCH_KERNELS + (PARENT_K15,)) + r")[<(]")


def telemetry_profile(torch, de, st, sizes, cfg, steps=5):
    """``torch.profiler`` over a few telemetry steps (as ``zoo_profile``):
    the device's busy time against the window, the top kernels, and
    K13-K15's launch chain (csrc/sketch.cu) per step; with ``--parent``
    the same window through the parent's K13-K15 (``parent_wrappers``)
    after it, under ``"parent"``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distributed_embeddings_torch.analysis import telemetry as tel

    step = telemetry_step(de, cfg)
    cats, batch = train_batch(torch, sizes, TELEM_BATCH, SEED + 150)
    out = {}
    for side in ("change", "parent") if parent_ops() else ("change",):
        telem = tel.init_telemetry(de, cfg, device="cuda")
        with (parent_wrappers() if side == "parent"
              else contextlib.nullcontext()):
            _, st, telem = step(st, cats, batch, telem)
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
            if (e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0):
                dev[e.key] = e.self_device_time_total / 1e3
        busy = sum(dev.values())
        chain = {}
        for key, ms in dev.items():
            m = SKETCH_CHAIN.search(key)
            if m:
                chain[m.group(1)] = chain.get(m.group(1), 0.0) + ms / steps
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
        out[side] = {
            "steps": steps, "window_ms_per_step": window / steps,
            "device_busy_ms_per_step": busy / steps,
            "device_busy_share": busy / window,
            "sketch_chain_ms_per_step": chain,
            "sketch_chain_total_ms_per_step": sum(chain.values()),
            "top_device_ms_per_step": [(k[:60], v / steps) for k, v in top]}
        check(busy > 0, f"telemetry profile ({side}): the trace holds no "
              "device time")
        # a parent checkout from before K15's one-CTA merge names its
        # K15 launch PARENT_K15
        want = [set(SKETCH_KERNELS)] + ([] if side == "change" else [set(
            SKETCH_KERNELS[:3] + (PARENT_K15,))])
        check(set(chain) in want, f"telemetry profile ({side}): the sketch "
              f"chain is not {sorted(want)} in the trace: {chain}")
    res = dict(out["change"])
    if "parent" in out:
        res["parent"] = out["parent"]
    log("telemetry profile: " + json.dumps(res))
    return st, res


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


def merge_bytes(depth, buckets, topk, k_pool, n_counts):
    """The bytes K15 must move: the sketch words it reads (``depth`` a
    carried id and a candidate, or the whole sketch where that is
    fewer), the pool, the count words, the carried ids and estimates
    read and written, and the accumulator read and written."""
    return (min(depth * buckets, depth * (topk + k_pool)) * 4 + k_pool * 4
            + n_counts * 8 + topk * 16 + 8)


def fold_host_split(torch, ids, live, cfg):
    """A width fold's host time a call (``analysis.telemetry._record``:
    K13, K14's pool and K15 from one launch record) split as
    ``launch_host_split`` splits a record's hit (10 calls a timing: the
    card takes longer than the host over a fold), beside the parent's
    ``_record`` (three wrappers that check and allocate), ``host_ms`` a
    side in turns (change, parent, parent, change): microseconds a
    call."""
    from distributed_embeddings_torch.analysis import telemetry as tel
    from distributed_embeddings_torch.ops import _kernels
    from distributed_embeddings_torch.ops import sketch as sk

    def state():
        return {"cms": torch.zeros((cfg.depth, cfg.buckets),
                                   dtype=torch.int32, device="cuda"),
                "topk_ids": torch.full((cfg.topk,), -1, dtype=torch.int32,
                                       device="cuda"),
                "topk_est": torch.zeros(cfg.topk, dtype=torch.int32,
                                        device="cuda"),
                "ids": torch.zeros(1, device="cuda")}

    ws, total = state(), torch.empty(1, device="cuda")
    args = (ws["cms"], ids, live, ws["topk_ids"], ws["topk_est"], ws["ids"],
            total, cfg.candidates)
    wrapper = lambda: tel._record(ws, ids, live, cfg, total)  # noqa: E731
    wrapper()
    rec = sk._FOLD.records[sk.fold_key(*args)]
    k_pool, upd, mrg, _, (pool, scratch, count) = rec.payload
    c, i, l, ti, te, acc, tot = (t.data_ptr() for t in args[:7])

    def fold_launches():  # the hit's three ctypes calls
        stream = _kernels.stream_handle(rec.device)
        for fn, head in upd.calls:
            fn(*head, c, i, l, count, stream)
        rec.lib.detpu_topk_pool(c, cfg.depth, cfg.buckets, i, l, ids.numel(),
                                k_pool, pool, scratch, stream)
        for fn, head in mrg.calls:
            fn(*head, c, pool, ti, te, acc, count, tot, 1, stream)

    out = launch_host_split(
        torch, "fold_ids", lambda: sk.fold_key(*args), sk._FOLD, (),
        wrapper, args[:7], calls=10, launches=(fold_launches, 3))
    par = parent_ops()
    if par is not None:
        pws = state()
        pwrap = lambda: par["telemetry"]._record(  # noqa: E731
            pws, ids, live, cfg)
        turns = {"wrapper_us": [], "parent_wrapper_us": []}
        for name in ("wrapper_us", "parent_wrapper_us", "parent_wrapper_us",
                     "wrapper_us"):
            turns[name].append(1e3 * host_ms(
                torch, wrapper if name == "wrapper_us" else pwrap))
        torch.cuda.synchronize()
        out["in_turns"] = {k: float(np.median(v)) for k, v in turns.items()}
        log("fold host in turns (us a call): " + json.dumps(out["in_turns"]))
    return out


def sketch_kernel_times(torch, ids, live, cfg, what, host_split=False):
    """K13, K14 (the query alone, and the candidate pool with its split by
    launch) and K15 on one width's telemetry stream (``ids``, ``live``),
    each held bitwise to its plain version first, and the width's fold
    (``ops.sketch.fold_ids``) bitwise to ``record_ids_plain``. K13 and
    K15 through ``kernel_case`` (event, host and device ms in turns with
    the parent's wrappers, the plain version, a PyTorch yardstick, the
    byte bound: each input read once, each output written once); K14 by
    its CUDA-event median. The live count is held to the exact count,
    rounded once to float32. ``host_split``: also the K13, K15 and fold
    host splits."""
    from distributed_embeddings_torch.ops import _kernels
    from distributed_embeddings_torch.ops import sketch as sk

    n = ids.numel()
    k_pool = min(cfg.candidates, n)
    sketch_bytes = cfg.depth * cfg.buckets * 4
    par = parent_ops()
    psk = par["sketch"] if par is not None else None
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
    # the fold, twice from one prior state: kernels against plain
    fws, pws = ({"cms": ck.clone(), "topk_ids": kt[0].clone(),
                 "topk_est": kt[1].clone(), "ids": kt[2].clone()}
                for _ in range(2))
    ftot, ptot = torch.empty(1, device="cuda"), torch.empty(1,
                                                            device="cuda")
    for first in (True, False):
        sk.fold_ids(fws, ids, live, cfg.candidates, ftot, first)
        sk.fold_ids_plain(pws, ids, live, cfg.candidates, ptot, first)
    for key in fws:
        exact(torch, fws[key], pws[key], f"fold_ids {what} {key}")
    exact(torch, ftot, ptot, f"fold_ids {what} total")
    del fws, pws
    cases = {}
    # K13
    flat = sk._flat(sk.buckets_of_plain(torch.where(live, ids, 0),
                                        cfg.depth, cfg.buckets),
                    cfg.buckets)
    inc = live.to(torch.int32)[None].expand(cfg.depth, -1).reshape(-1)
    sketch, psketch = fresh(), fresh()
    nbytes = n * 5 + 2 * sketch_bytes + 8
    cases["cms_update"] = kernel_case(
        torch, "cms_update",
        f"{what}: {n} positions ({n_live} live), sketch "
        f"{cfg.depth}x{cfg.buckets}",
        lambda: sk.cms_update(sketch, ids, live),
        (lambda: psk.cms_update(psketch, ids, live)) if psk else None,
        lambda: sketch.view(-1).index_add_(0, flat, inc), nbytes,
        plain=lambda: sk.cms_update_plain(sketch, ids, live),
        extra={"library": "index_add_ on precomputed flat indices"})
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
    # K15 (each side merges into its own copy of the carried state)
    pk = tuple(t.clone() for t in kt)
    all_est = torch.cat([kt[1], pool])

    def lib_merge():
        torch.unique(pool)
        return torch.topk(all_est, cfg.topk)

    nbytes = merge_bytes(cfg.depth, cfg.buckets, cfg.topk, k_pool,
                         counts.numel())
    cases["topk_merge"] = kernel_case(
        torch, "topk_merge", f"{what}: pool {k_pool} into top {cfg.topk} "
        f"({sk.merge_path(cfg.topk, cfg.candidates)})",
        lambda: sk.topk_merge(ck, pool, counts, *kt, cfg.candidates),
        (lambda: psk.topk_merge(ck, pool, counts, *pk, cfg.candidates))
        if psk else None, lib_merge, nbytes,
        plain=lambda: sk.topk_merge_plain(ck, pool, pcounts, *pt,
                                          cfg.candidates),
        extra={"library": "torch.unique + torch.topk (not tie-exact)"})
    if host_split:
        ts = (sketch, ids, live)
        cases["cms_update"]["host_split"] = launch_host_split(
            torch, "cms_update", lambda: sk.update_key(*ts), sk._UPDATE,
            tuple(t.data_ptr() for t in ts) + (counts.data_ptr(),),
            lambda: sk.cms_update(*ts), ts, calls=20)
        mt = (ck, pool, counts, *kt)
        out_c = torch.empty(1, device="cuda")
        cases["topk_merge"]["host_split"] = launch_host_split(
            torch, "topk_merge",
            lambda: sk.merge_key(*mt, cfg.candidates), sk._MERGE,
            (ck.data_ptr(), pool.data_ptr(), kt[0].data_ptr(),
             kt[1].data_ptr(), kt[2].data_ptr(), counts.data_ptr(),
             out_c.data_ptr(), 1),
            lambda: sk.topk_merge(*mt, cfg.candidates), mt, calls=20)
        cases["fold_host_split"] = fold_host_split(torch, ids, live, cfg)
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
                                f"one-hot b{TELEM_BATCH}", host_split=True)
    metrics["fold_host_split"] = cases.pop("fold_host_split")
    # sizes past the shared-memory tiles (C5): topk 2048 with its default
    # 4 * topk candidates, and 16384 candidates; K14 and K15 bit-exact to
    # their plain versions on this stream, then timed
    from distributed_embeddings_torch.ops import sketch as sk

    cases["cms_query"] = list(cases["cms_query"])
    cases["topk_merge"] = [cases["topk_merge"]]
    for topk, cand in ((2048, 4 * 2048), (32, 16384)):
        big = tel.TelemetryConfig(depth=cfg.depth, buckets=cfg.buckets,
                                  topk=topk, candidates=cand)
        k_pool = min(cand, ids.numel())
        what = (f"one-hot b{TELEM_BATCH} topk {topk} candidates {cand} "
                f"(pool {sk.pool_path(k_pool)}, merge "
                f"{sk.merge_path(topk, cand)})")
        c5 = sketch_kernel_times(torch, ids, live, big, what)
        cases["cms_query"].insert(len(cases["cms_query"]) - 1,
                                  c5["cms_query"][0])
        cases["topk_merge"].append(c5["topk_merge"])
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
    steps (one width) and ``ro`` read-only remaps: K16's update folds the
    admission sketch itself, so no K13 launch."""
    return dict(remap_stage=k16 + ro, cms_update=0, commit_rows=k17)


@contextlib.contextmanager
def stream_checks(torch, errs, what, before_commit=None):
    """Hold every K16 and K17 call of the streaming path (the module
    globals ``parallel.streaming.remap_stage``/``commit_rows``) to its
    plain version on the same inputs, right where the step calls it:
    K16's outputs and the staged sketch it folded, bit-exact; K17's
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
    K16, K17, K21 and K22 once each (one width, the sparse Adagrad
    regime, the guard on; K16 folds the sketch itself, no K13)."""
    want = {name: 0 for name in kernel_fns()}
    want.update(gather_combine=steps, dot_interact_fwd=steps,
                dot_interact_bwd=steps, dedup_sparse_grad=steps,
                adagrad_rows=steps, remap_stage=steps, cms_update=0,
                commit_rows=steps, pack_ids=steps, pack_columns=steps,
                **epilogue(steps))
    return want


def stream_dlrm_checks(torch, de, st, ss, cfg, gen, errs):
    """12c's checked step (K16 and its sketch fold, K5, K6 and K17 each
    against its plain version on the step's own inputs) and its NaN
    batch. Returns the state, K5's inputs in the step (the w128 stream,
    to time K5 at) and K6's (its K5 output, lr and eps)."""
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
    k5_args = (seen["w128"]["ids"], seen["w128"]["vals"],
               st.emb_params["w128"].shape[1], seen["w128"]["uids"],
               seen["w128"]["ugrads"], seen["w128"]["lr"], opt.eps)
    log(f"streaming DLRM: checked step, loss {float(loss):.5f}; K16 (and "
        f"its sketch fold) bit-exact to the plain remap on the step's own "
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
    return st, ss, k5_args


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
    builds = {"dynamic": 0, "static": 0}
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
        b0 = interaction_builds()
        t0 = time.perf_counter()
        for k in range(TRAIN_STEPS):
            cats, batch = batches[k % len(batches)]
            loss, st, *aux = step(st, cats, batch, *aux)
        torch.cuda.synchronize()
        runs[label].append((time.perf_counter() - t0) / TRAIN_STEPS)
        builds[label] += interaction_builds() - b0
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
        "interaction_records_built": builds,
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS}
    return st, ss, launches, metrics


STREAM_KERNELS = ("stream_remap_kernel", "commit_kernel")
STREAM_CHAIN = re.compile(r"namespace\)::(" + "|".join(STREAM_KERNELS)
                          + r")[<(]")


def stream_profile(torch, de, st, ss, cfg, batches, steps=5):
    """``torch.profiler`` over a few streaming DLRM steps (as
    ``telemetry_profile``): the device's busy time against the window,
    the top kernels, K16/K17's launch chain per step, and the host
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
          f"K16/K17 chain is incomplete in the trace: {chain}")
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


def commit_bytes(torch, pend, rows_cap, row_bytes, sketch_words):
    """K17's byte bound for one call on ``pend``'s data: each position's
    scrub row, hit row and estimate read once; per claimed row its
    fingerprint read, its two slot-map words written and its rows of the
    slab and the leaves (``row_bytes``, summed over them) read and
    written; per distinct hit row its ``slot_freq`` word read and
    written; the staged sketch read and the carried one written; the
    counts, totals, counters and ``steps`` (64 bytes)."""
    def rows_of(r):
        return r[(r >= 0) & (r < rows_cap)]

    claims = rows_of(pend.scrub_rows).numel()
    hit_rows = torch.unique(rows_of(pend.hit_rows)).numel()
    return (pend.scrub_rows.numel() * 12 + claims * (12 + 2 * row_bytes)
            + hit_rows * 8 + 2 * sketch_words * 4 + 64)


def stream_kernel_times(torch, de, st, ss, cfg, batches):
    """K16 (update and read-only) and K17 timed on the streaming DLRM
    step's own stream (the 5 streaming features' 327,680 positions),
    beside their plain versions, their byte bounds and (K16) a PyTorch
    yardstick; both through ``kernel_case`` (in turns with the parent's
    wrappers: its K16 folds with its own K13, its K17 is three launches)
    with their records' host splits."""
    import importlib

    from distributed_embeddings_torch.ops import sketch as sk
    from distributed_embeddings_torch.parallel import streaming as smod

    sops = importlib.import_module("distributed_embeddings_torch.ops."
                                   "streaming")
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
    a0 = (streams[0].ext, streams[0].live, *(
        getattr(streams[0], f).to(torch.int32)
        for f in ("cap", "nbuckets", "tid", "roff")),
        ws["slot_fp"], ws["slot_freq"])
    staged = ws["cms"].clone()
    staged_p = ws["cms"].clone()
    pol = (cfg.admit_min_count, cfg.evict_margin)
    parent = parent_ops()
    psops = parent["streaming"] if parent else None

    def yardstick():
        # part of the function: the sketch query by gather + amin on
        # precomputed columns, and the slot-map gathers
        v = flat[cols].view(cfg.depth, -1).amin(dim=0)
        return v, ws["slot_fp"].index_select(0, rows), \
            ws["slot_freq"].index_select(0, rows)

    key = sops.fingerprint_plain(streams[0].ext, streams[0].tid)
    cols = (sk.buckets_of_plain(key, cfg.depth, cfg.buckets)
            + torch.arange(cfg.depth, device="cuda")[:, None] * cfg.buckets
            ).reshape(-1)
    flat = staged.reshape(-1)
    slot, _ = sops.slot_bucket_plain(streams[0].ext, streams[0].tid,
                                     streams[0].cap, streams[0].nbuckets)
    rows = (streams[0].roff + slot).long()
    esz = streams[0].ext.element_size()
    sketch_b = 2 * cfg.depth * cfg.buckets * 4
    ro_bytes = n * (esz + 1 + 16 + 4 + 4)
    upd_bytes = n * (esz + 1 + 16 + 4 + 4 + 4 * 5) + 32 + sketch_b
    live = int(streams[0].live.sum())
    extra = {"positions": n, "live": live, "rows_cap": rows_cap,
             "library": "sketch gather + amin and the slot-map gathers "
                        "(partial)"}
    upd = kernel_case(
        torch, "remap_stage",
        f"update, {n} streaming positions of the DLRM step into "
        f"{rows_cap} slot rows (the sketch fold included)",
        lambda: sops.remap_stage(*a0, staged, *pol),
        (lambda: psops.remap_stage(*a0, staged_p, *pol)) if parent
        else None, yardstick, upd_bytes,
        plain=lambda: sops.remap_stage_plain(*a0, staged.clone(), *pol),
        extra=dict(extra))
    buf, _ = sops.update_outputs(n, staged.device)
    upd["host_split_us"] = launch_host_split(
        torch, "remap_stage update",
        lambda: sops.remap_key(*a0, staged, *pol), sops._CACHE,
        tuple(t.data_ptr() for t in a0) + (staged.data_ptr(),
                                           buf.data_ptr()),
        lambda: sops.remap_stage(*a0, staged, *pol), list(a0) + [staged],
        extra={"outputs_us": lambda: sops.update_outputs(n, staged.device)})
    ro = kernel_case(
        torch, "remap_stage", f"read-only, {n} positions",
        lambda: sops.remap_stage(*a0, None, *pol, update=False),
        (lambda: psops.remap_stage(*a0, None, *pol, update=False))
        if parent else None, yardstick, ro_bytes,
        plain=lambda: sops.remap_stage_plain(*a0, None, *pol, update=False),
        extra=dict(extra))
    local = torch.empty(n, dtype=torch.int32, device=staged.device)
    ro["host_split_us"] = launch_host_split(
        torch, "remap_stage read-only",
        lambda: sops.remap_key(*a0, None, *pol, update=False), sops._CACHE,
        tuple(t.data_ptr() for t in a0[:7]) + (None, None,
                                                local.data_ptr()),
        lambda: sops.remap_stage(*a0, None, *pol, update=False),
        list(a0[:7]))
    del buf, local
    # K17 on the first stream's staged transitions
    pend = sops.remap_stage(*a0, ws["cms"].clone(), *pol)
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
    c_args = (slab, [(acc, 0.1)], pend, slot_fp, slot_freq, cms, staged2,
              totals, counters, steps)
    nbytes = commit_bytes(torch, pend, rows_cap,
                          slab.element_size() * 128 + acc.element_size()
                          * 128, ws["cms"].numel())
    ts = sops._commit_tensors(*c_args, on)
    commit = kernel_case(
        torch, "commit_rows",
        f"{claims} claimed rows (slab and fp32 accumulator, w128), {hits} "
        f"hits, of {n} positions",
        lambda: sops.commit_rows(*c_args, enable=on),
        (lambda: psops.commit_rows(*c_args, enable=on)) if parent else None,
        None, nbytes,
        plain=lambda: sops.commit_rows_plain(*c_args, enable=on),
        extra={"positions": n, "claims": claims, "hits": hits,
               "distinct_hit_rows": int(torch.unique(
                   pend.hit_rows[pend.hit_rows < rows_cap]).numel()),
               "library": "none: no PyTorch call computes the guarded "
                          "commit"})
    commit.update(call_floor(
        torch, "commit_rows", lambda: sops.commit_rows(*c_args, enable=on),
        (lambda: psops.commit_rows(*c_args, enable=on)) if parent
        else None))
    pad = sops.find_commit_record(*c_args, enable=on).payload[1]
    commit["host_split_us"] = launch_host_split(
        torch, "commit_rows", lambda: sops.commit_key(*c_args, enable=on),
        sops._COMMIT, (*(t.data_ptr() for t in ts), *pad),
        lambda: sops.commit_rows(*c_args, enable=on), list(ts),
        extra={"addresses_us": lambda: (*(t.data_ptr() for t in ts),
                                        *pad)})
    return {"remap_stage": [upd, ro], "commit_rows": [commit]}


def stream_stages(torch, de, holder, cfg, batches, runs=8):
    """The streaming DLRM step's stages, with CUDA events recorded around
    the step's own calls (the step runs whole, through whichever
    wrappers are in place): the remap (``_streaming_remap``: the
    stream's assembly, K16, the write-back), the rest of the forward and
    the dense forward and backward with the guard, the sparse apply (K5
    + K6), the commit (K17) and the dense update; median ms a step over
    ``runs`` steps after two warmups. ``holder``: ``[state, streaming
    state]``, advanced in place."""
    from distributed_embeddings_torch.parallel import SparseAdagrad
    from distributed_embeddings_torch.parallel import streaming as smod

    opt = SparseAdagrad()
    step = make_step_with(de, cfg, opt)
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    def around(name, fn):
        def wrapper(*a, **kw):
            mark(f"{name}<")
            out = fn(*a, **kw)
            mark(f"{name}>")
            return out
        return wrapper

    real = (de._streaming_remap, opt.apply_rows, smod.commit)
    de._streaming_remap = around("remap", real[0])
    opt.apply_rows = around("sparse_apply", real[1])
    smod.commit = around("commit", real[2])
    stage_ms = {}
    try:
        for k in range(2 + runs):
            cats, batch = batches[k % len(batches)]
            marks.clear()
            mark("start")
            _, holder[0], holder[1] = step(holder[0], cats, batch, holder[1])
            mark("end")
            torch.cuda.synchronize()
            if k < 2:
                continue
            ev = dict(marks)
            split = {
                "remap": ev["remap<"].elapsed_time(ev["remap>"]),
                "forward_dense_guard": ev["remap>"].elapsed_time(
                    ev["sparse_apply<"]),
                "sparse_apply": ev["sparse_apply<"].elapsed_time(
                    ev["sparse_apply>"]),
                "commit": ev["commit<"].elapsed_time(ev["commit>"]),
                "dense_update": ev["commit>"].elapsed_time(ev["end"]),
                "before_remap": ev["start"].elapsed_time(ev["remap<"]),
                "between_apply_and_commit": ev["sparse_apply>"].elapsed_time(
                    ev["commit<"]),
                "step": ev["start"].elapsed_time(ev["end"])}
            for name, v in split.items():
                stage_ms.setdefault(name, []).append(v)
    finally:
        del de._streaming_remap
        opt.__dict__.pop("apply_rows", None)
        smod.commit = real[2]
    return {n: float(np.median(v)) for n, v in stage_ms.items()}


def stream_overhead_in_turns(torch, de, twin, holder, cfg, batches,
                             steps=10):
    """``streaming_overhead_frac`` through this tree's wrappers and the
    parent's (``parent_wrappers``: K5, K6, K16, K17 and the rest), in turns
    change, parent, parent, change; each turn times the dynamic step and
    the static twin's, ``steps`` steps each after two warmups (host
    clock). Per side the medians; None without ``--parent``.
    ``holder``: ``[state, streaming state]``, advanced in place."""
    from distributed_embeddings_torch.parallel import SparseAdagrad

    if parent_ops() is None:
        return None
    runs = {side: {"dynamic": [], "static": []}
            for side in ("change", "parent")}
    for side in ("change", "parent", "parent", "change"):
        with (parent_wrappers() if side == "parent"
              else contextlib.nullcontext()):
            for label in ("dynamic", "static"):
                dyn = label == "dynamic"
                step = make_step_with(de if dyn else twin,
                                      cfg if dyn else None, SparseAdagrad())
                for k in range(2 + steps):
                    if k == 2:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                    cats, batch = batches[k % len(batches)]
                    if dyn:
                        _, holder[0], holder[1] = step(holder[0], cats,
                                                       batch, holder[1])
                    else:
                        _, holder[0] = step(holder[0], cats, batch)
                torch.cuda.synchronize()
                runs[side][label].append(
                    (time.perf_counter() - t0) / steps * 1e3)
    out = {}
    for side, r in runs.items():
        d, s = float(np.median(r["dynamic"])), float(np.median(r["static"]))
        out[side] = {"dynamic_step_ms": d, "static_step_ms": s,
                     "streaming_overhead_frac": d / s - 1.0,
                     "runs_ms": r}
    return out


def phase_streaming(torch):
    """Streaming vocabularies (``parallel/streaming.py``, K16 and K17 in
    ``csrc/streaming.cu``; K16's update folds the admission sketch):
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
    st, ss, k5_args = stream_dlrm_checks(torch, de, st, ss, cfg, gen, errs)
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
    holder = [st, ss]
    metrics["stage_ms_p50"] = stream_stages(torch, de, holder, cfg, batches)
    log("streaming DLRM stages (ms): " + json.dumps(metrics["stage_ms_p50"]))
    turns = stages_in_turns(torch, lambda: stream_stages(
        torch, de, holder, cfg, batches))
    if turns:
        metrics["stages_in_turns_with_parent"] = turns
        log("streaming DLRM stages in turns with the parent's wrappers "
            "(ms): " + json.dumps(turns))
    turns = stream_overhead_in_turns(torch, de, twin, holder, cfg, batches)
    st, ss = holder
    if turns:
        metrics["overhead_in_turns_with_parent"] = turns
        log("streaming_overhead_frac in turns with the parent's wrappers: "
            + json.dumps({k: v["streaming_overhead_frac"]
                          for k, v in turns.items()}) + " "
            + json.dumps(turns))
    cases = stream_kernel_times(torch, de, st, ss, cfg, batches)
    cases["dedup_sparse_grad"] = dedup_case(torch, "streaming_dlrm_w128",
                                            *k5_args[:3])
    cases["adagrad_rows"] = k6_case(torch, "streaming_dlrm_w128", (
        st.emb_params["w128"][0], st.emb_opt_state["w128"][0],
        *k5_args[3:]))
    del k5_args
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
    step builds it, 8 Zipfian id sets) into ``slab``: this tree's wrapper,
    the parent's (``--parent``) and ``index_add_`` of the bf16-rounded
    products (K3's chain: the nearest one PyTorch call) in turns, the
    plain version, the engine's device split and the byte bound; then K3
    on the same stream (K3 rounds each add to bf16: not the same
    function), this tree's and the parent's, in turns with K18."""
    from distributed_embeddings_torch.ops import (
        sgd_scatter, sgd_scatter_promoted, sgd_scatter_promoted_plain)

    w = slab.shape[1]
    lr_val = PROMOTED_SCHEDULE[0]  # the schedule at PROMOTED_STEP
    lr = torch.tensor(lr_val, device="cuda")
    roff = torch.as_tensor(de.row_offsets_list[0], dtype=torch.int32,
                           device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args, lib_args = [], []
    for k in range(8):
        cats, _ = train_batch(torch, sizes, TRAIN_BATCH, seed=seed + k)
        ids = (torch.stack(cats, dim=1) + roff).reshape(-1).contiguous()
        vals = (torch.randn((ids.numel(), w), generator=gen, device="cuda")
                * 1e-3).to(torch.bfloat16)
        args.append((ids, vals))
        nl = torch.tensor(-lr_val, dtype=torch.bfloat16, device="cuda")
        lib_args.append((ids.long(), vals * nl))
    parent = parent_ops()
    par = parent["scatter_add"] if parent else None
    n = args[0][0].numel()
    uniq = int(torch.unique(args[0][0]).numel())
    nbytes = n * w * 2 + n * 4 + 2 * uniq * w * 2
    case = segment_case(
        torch, "sgd_scatter_promoted", label,
        cycling(lambda i, v: sgd_scatter_promoted(slab, i, v, lr), args),
        cycling(lambda i, v: par.sgd_scatter_promoted(slab, i, v, lr), args)
        if par else None,
        cycling(lambda i, u: slab.index_add_(0, i, u), lib_args), nbytes,
        cycling(lambda i, v: sgd_scatter_promoted_plain(slab, i, v, lr),
                args), args[0][0], slab.shape[0])
    case["library_call"] = ("index_add_ of bf16-rounded products (K3's "
                            "chain, not the promoted one)")
    k18 = cycling(lambda i, v: sgd_scatter_promoted(slab, i, v, lr), args)
    k3 = cycling(lambda i, v: sgd_scatter(slab, i, v, lr_val), args)
    case["k18_ms_in_turns"], case["k3_same_stream_ms"] = ab_ms(torch, k18,
                                                               k3)
    case["parent_k3_same_stream_ms"] = None
    if par is not None:
        _, case["parent_k3_same_stream_ms"] = ab_ms(torch, k18, cycling(
            lambda i, v: par.sgd_scatter(slab, i, v, lr_val), args))
    # the hottest row's serial chain alone: its entries of the stream
    ids0, vals0 = args[0]
    rows0, counts0 = torch.unique(ids0, return_counts=True)
    hot = ids0 == rows0[counts0.argmax()]
    hot_ids, hot_vals = ids0[hot].contiguous(), vals0[hot].contiguous()
    case["hottest_row_alone_ms"] = time_ms(
        torch, lambda: sgd_scatter_promoted(slab, hot_ids, hot_vals, lr),
        [()])
    del rows0, counts0, hot, hot_ids, hot_vals
    log(f"  sgd_scatter_promoted {label}: K18 {case['k18_ms_in_turns']:.4f}"
        f" ms, K3 on the same stream {case['k3_same_stream_ms']:.4f}, the "
        f"parent's K3 {case['parent_k3_same_stream_ms']}; the hottest row's "
        f"{case['longest_segment']} entries alone "
        f"{case['hottest_row_alone_ms']:.4f} ms")
    return case


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


def example_steps_in_turns(torch, run, sizes):
    """The example's train step (its loss, SGD under its schedule on
    both halves, bf16 tables: K18 once a step) on run A's layer and
    final state, through this tree's wrappers and the parent's in turns
    (``steps_in_turns``); None without ``--parent``. Updates the state
    in place."""
    from distributed_embeddings_torch.models import bce_with_logits
    from distributed_embeddings_torch.models.schedules import (
        warmup_poly_decay_schedule)
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, make_hybrid_train_step)

    if parent_ops() is None:
        return None
    sched = warmup_poly_decay_schedule(*PROMOTED_SCHEDULE)
    step = make_hybrid_train_step(
        run.de, lambda dp, outs, batch: bce_with_logits(dp(batch[0], outs),
                                                        batch[1]),
        SGD(sched), SparseSGD(), lr_schedule=sched)
    data = [train_batch(torch, sizes, TRAIN_BATCH, seed=SEED + 230 + k)
            for k in range(4)]
    holder = [run.state]

    def run_step(k):
        cats, batch = data[k % len(data)]
        _, holder[0] = step(holder[0], cats, batch)

    turns = steps_in_turns(torch, run_step)

    def loss(dp, outs, batch):
        return bce_with_logits(dp(batch[0], outs), batch[1])

    turns["stages"] = stages_in_turns(torch, lambda: dlrm_stages(
        torch, run.de, holder[0], data, loss=loss, tx=SGD(sched),
        lr=sched(holder[0].step)))
    log("example: steps and stage splits in turns with the parent's "
        "wrappers (ms): " + json.dumps(turns))
    return turns


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
         with the MLPerf warmup: run A 40 steps with eval every 20,
         1 s of serving at 200 QPS and ``--metrics_out`` every 10
         steps, launches counted; run B 20 steps
         saving the full train state, then a run restored to step 40:
         losses and state bitwise equal to A's; K18 timed at this shape;
    13d. a NaN batch under the guard on A's final state."""
    import shutil
    import tempfile

    from distributed_embeddings_torch.examples import dlrm_main
    from distributed_embeddings_torch.parallel import Served
    from distributed_embeddings_torch.utils import obs

    t_phase = time.perf_counter()
    errs = promoted_kernel_checks(torch)
    sizes = ragged_sizes()
    tmp = tempfile.mkdtemp(prefix="detpu_example_")
    try:
        args = example_args(tmp, sizes)
        zero_counts()
        t0 = time.perf_counter()
        mpath = os.path.join(tmp, "metrics.jsonl")
        a = dlrm_main.main(args + [
            "--num_batches", str(EXAMPLE_STEPS),
            "--serve_qps", str(EXAMPLE_SERVE_QPS), "--serve_seconds", "1",
            "--metrics_out", mpath, "--metrics_interval", "10"])
        torch.cuda.synchronize()
        launches = read_counts()
        recs = obs.MetricsLogger.load(mpath)
        check([r["section"] for r in recs] == ["step_metrics"] * 4
              + ["counters"] and [r["step"] for r in recs[:4]]
              == [0, 10, 20, 30] and all(
                  set(r["metrics"]) == set(obs.STEP_METRIC_KEYS)
                  and r["metrics"]["skipped_steps"] == [0]
                  and np.isfinite(r["metrics"]["emb_grad_norm"][0])
                  for r in recs[:4]),
              f"example --metrics_out records: {recs}")
        log(f"example: --metrics_out wrote {len(recs)} records (steps 0, "
            "10, 20, 30 and the counters), every metric key present")
        run_a_s = time.perf_counter() - t0
        check(a.steps_run == EXAMPLE_STEPS and np.isfinite(a.losses).all(),
              f"example run A: {a.steps_run} steps, losses {a.losses}")
        check(launches["sgd_scatter_promoted"] == EXAMPLE_STEPS
              and launches["dot_interact_bwd"] == EXAMPLE_STEPS
              and launches["gather_combine"] >= EXAMPLE_STEPS
              and launches["dot_interact_fwd"] >= EXAMPLE_STEPS
              and launches["pack_ids"] >= EXAMPLE_STEPS
              and launches["pack_columns"] == EXAMPLE_STEPS
              and launches["grad_health"] == EXAMPLE_STEPS
              and launches["dense_update"] == EXAMPLE_STEPS
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
        example_turns = example_steps_in_turns(torch, a, sizes)
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
                                  for n, v in launches.items() if v},
            "in_turns_with_parent": example_turns}
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


def w8_per_step(groups, widths, steps=1, mp=False):
    """Launches of ``steps`` world-8 DLRM steps on one rank: K1 once per
    plan group, K3 once per width slab, K19 once (none with
    model-parallel input, ``mp``: no id block is packed), K20 three
    times (the lookup rows, the unpack, the cotangent pack), K2 and K4
    once, K21 twice (the local cotangents before the all-reduce, the
    averaged dense gradients after it) and K22 once."""
    want = {name: 0 for name in kernel_fns()}
    want.update(gather_combine=groups, sgd_scatter=widths,
                pack_ids=0 if mp else 1, pack_columns=3,
                dot_interact_fwd=1, dot_interact_bwd=1, grad_health=2,
                dense_update=1)
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


def w8_model(torch, sizes, cst, compute_dtype, row_slice=None,
             dp_input=True, schedule=None):
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
                              row_slice=row_slice, dp_input=dp_input,
                              compute_dtype=compute_dtype,
                              schedule=schedule)
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

        def dropped(de_, packed, *a, **kw):
            got = real(de_, packed, *a, **kw)
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
    rows hit k times within k bf16 ulps (K3 and the plain ``index_add_``
    add in their own orders)."""
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
def w8_stage_marks(torch, extra=()):
    """Mark the stage bounds of the real world-8 step (the trainer's
    own ``make_hybrid_train_step``): the exchange layer's three
    all-to-alls, the unpack and ``grads.mean_flat`` are wrapped so that
    each bound records an event and synchronizes (and each ``(owner,
    name, before, after)`` of ``extra``). Yields ``mark`` (call it
    before and after the step) and the list of ``(host s, event)``
    marks; the stages are W8_STAGES, in order (W8F_STAGES with 14f-b's
    ``extra``)."""
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
    real.update({(owner, name): (before, after)
                 for owner, name, before, after in extra})
    saved = {k: getattr(*k) for k in real}
    for (mod, name), (before, after) in real.items():
        setattr(mod, name, wrap(saved[(mod, name)], before, after))
    try:
        yield mark, marks
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def w8_staged_steps(torch, step, st, batches, steps, stages=W8_STAGES,
                    extra=()):
    """``steps`` real world-8 steps (after one unmarked) with their stage
    bounds marked: per stage the medians of host ms and device ms
    (``stages``: W8_STAGES, or with model-parallel input, where no id
    exchange runs, the stages after it; more with ``extra`` bounds, see
    :func:`w8_stage_marks`)."""
    split = []
    with w8_stage_marks(torch, extra) as (mark, marks):
        for k in range(1 + steps):
            marks.clear()
            mark()
            _, st = step(st, *batches[k % len(batches)])
            mark()
            check(len(marks) == len(stages) + 1, f"world 8 stage split: "
                  f"{len(marks)} marks a step, expected {len(stages) + 1}")
            if k:
                split.append({name: (
                    (marks[i + 1][0] - marks[i][0]) * 1e3,
                    marks[i][1].elapsed_time(marks[i + 1][1]))
                    for i, name in enumerate(stages)})
    return st, {name: {"host_ms": float(np.median([s[name][0] for s in split])),
                       "device_ms": float(np.median([s[name][1]
                                                     for s in split]))}
                for name in stages}


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


# ----------------------------------- row slices and model-parallel input (14e)

W8E_SMALL_RS = 700_000         # the 20,000-row tables split 4 ways, the
                               # 7,421-row one 2 ways
W8E_RS = 1_400_000_000         # the 25.6M-40M-row tables split 4 ways
W8E_STEPS = 5
W8E_WARMUP = 2
W8E_DROP_RANK = 3              # the control drops this rank's row bases
#: the small check's bounds of world 1 (14b's)
W8_SMALL_BOUNDS = {"loss_err": 1e-5, "dense_err": 1e-5, "pred_err": 1e-5,
                   "slab_max_err": 1e-6, "slab_rel_err": 1e-3}


def drop_row_bases(torch, de):
    """The control: this layer's row-sliced slots read their table's
    first rows (its row bases zeroed)."""
    real = de._plan_rbase

    def zeros(plan, gi, device, reps=1):
        rb = real(plan, gi, device, reps)
        return None if rb is None else torch.zeros_like(rb)

    de._plan_rbase = zeros


def mp_feed(torch, de, batch, rows):
    """A numpy global batch as this rank takes it with model-parallel
    input: its block of the packed ids (``pack_mp_inputs`` on the host,
    then to the card) and its rows of the dense batch."""
    cats, num, lab = batch
    return (de.pack_mp_inputs(cats, device="cuda"),
            torch.from_numpy(num[rows].copy()).cuda(),
            torch.from_numpy(lab[rows].copy()).cuda())


@contextlib.contextmanager
def row_base_checks(torch):
    """Route the step's K1, K8 and K9 call sites through checkers: each
    launch with row bases must give the plain version's bits on the same
    inputs (K1 at hotness 1 without weights, where its sum is one term).
    Yields the checked calls by kernel and, under ``"err"``, the largest
    difference each showed."""
    from distributed_embeddings_torch.ops import (gather_combine_plain,
                                                  ragged_combine_plain)
    from distributed_embeddings_torch.ops.sparse_grad import (
        ragged_grad_plain)
    from distributed_embeddings_torch.parallel import apply, lookup

    real = (lookup.gather_combine, lookup.ragged_combine, apply.ragged_grad)
    names = ("gather_combine", "ragged_combine", "ragged_grad")
    n = dict.fromkeys(names, 0)
    n["err"] = dict.fromkeys(names, 0.0)

    def note(name, got, want):
        n["err"][name] = max(n["err"][name], bits_err(
            torch, got, want, f"{name} with row bases on the step's inputs"))
        n[name] += 1

    def k1(slab, ids, rows, roff, div, mask=None, weights=None, rbase=None):
        got = real[0](slab, ids, rows, roff, div, mask, weights, rbase=rbase)
        if rbase is not None and ids.shape[2] == 1 and weights is None:
            note("gather_combine", got, gather_combine_plain(
                slab, ids, rows, roff, div, mask, weights, rbase))
        return got

    def k8(*a, **kw):
        got = real[1](*a, **kw)
        if kw.get("rbase") is not None:
            note("ragged_combine", got, ragged_combine_plain(*a, **kw))
        return got

    def k9(*a, **kw):
        got = real[2](*a, **kw)
        if kw.get("rbase") is not None:
            want = ragged_grad_plain(*a, **kw)
            note("ragged_grad", got[0], want[0])
            note("ragged_grad", got[1], want[1])
        return got

    lookup.gather_combine, lookup.ragged_combine, apply.ragged_grad = (
        k1, k8, k9)
    try:
        yield n
    finally:
        lookup.gather_combine, lookup.ragged_combine, apply.ragged_grad = real


def w8e_rank_small(torch, rank, tmp):
    """14e-b on one rank: the small tables row-sliced (``row_slice``
    W8E_SMALL_RS, no column slicing) from 14b's tables and dense
    parameters: the model-parallel run (``pack_mp_inputs``), the same
    steps with data-parallel input, and the control (rank
    W8E_DROP_RANK's row bases dropped, model-parallel input); rank 0
    writes each run's tables to ``tmp``."""
    from distributed_embeddings_torch.models import DLRMDense
    from distributed_embeddings_torch.parallel import bootstrap

    b = W8_SMALL_BATCH // W8
    rows = slice(rank * b, (rank + 1) * b)
    out = {}
    for run in ("mp", "dp", "control"):
        cfg, de = w8_model(torch, w8_small_sizes(), None, None,
                           row_slice=W8E_SMALL_RS, dp_input=run == "dp")
        if run == "control" and rank == W8E_DROP_RANK:
            drop_row_bases(torch, de)
        dense = DLRMDense(cfg, device="cuda")
        st = w8_small_state(torch, de, dense, tmp)
        if run == "dp":
            def feed(bt):
                return w8_to_card(torch, bt, rows)
        else:
            def feed(bt, de=de):
                return mp_feed(torch, de, bt, rows)
        zero_counts()
        with pack_checks(torch) as n, row_base_checks(torch) as nr:
            losses, st, pred = w8_small_run(torch, de, st, feed)
        tables = de.get_weights(st.emb_params, all_ranks=False)
        if rank == 0:
            for t, a in enumerate(tables):
                np.save(os.path.join(tmp, f"w8e_{run}_{t}.npy"), a)
        plan = next(iter(de._plan_cache.values()))
        out[run] = {"losses": losses, "checked": dict(n),
                    "row_base_checked": dict(nr),
                    "launches": read_counts(), "modes": read_mode_counts(),
                    "dense": [p.detach().cpu().numpy()
                              for p in st.dense_params.parameters()],
                    "pred": bootstrap.to_host(pred),
                    "row_sliced": sorted(de.strategy.row_sliced_tables),
                    "based_groups": int(sum(bool(r.any())
                                            for r in plan.rsliced))}
        del st, dense, tables
    torch.cuda.empty_cache()
    return out


def mp_full_batch(torch, de, rank, seed):
    """A global batch of 14e-c (Zipfian ids over each Criteo-1TB table,
    W8_BATCH rows) as rank ``rank`` takes it: its packed block of the
    ids on the card and its rows of N(0, 1) features and 0/1 labels."""
    from distributed_embeddings_torch.utils.data import power_law_ids

    rng = np.random.default_rng(seed)
    cats = [power_law_ids(rng, v, (W8_BATCH,)).astype(np.int32)
            for v in CRITEO_1TB_SIZES]
    num = rng.normal(size=(W8_BATCH, 13)).astype(np.float32)
    lab = (rng.random(W8_BATCH) < 0.25).astype(np.float32)
    b = W8_BATCH // W8
    mp, num_t, lab_t = mp_feed(torch, de, (cats, num, lab),
                               slice(rank * b, (rank + 1) * b))
    return mp, (num_t, lab_t)


def w8e_rank_full(torch, rank):
    """14e-c on one rank: the Criteo-1TB tables row-sliced (``row_slice``
    1.4e9, no column slicing), model-parallel input (see main's
    docstring, phase 14e-c)."""
    from distributed_embeddings_torch.models import DLRMDense
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, init_hybrid_state, make_hybrid_train_step)

    cfg, de = w8_model(torch, CRITEO_1TB_SIZES, None, torch.bfloat16,
                       row_slice=W8E_RS, dp_input=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dense = DLRMDense(cfg, device="cuda", generator=gen)
    st = init_hybrid_state(de, SparseSGD(), dense, SGD(TRAIN_LR),
                           generator=gen, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    out = {"slab_bytes": sum(v.numel() * v.element_size()
                             for v in st.emb_params.values()),
           "instances": len(de.strategy.table_ids_list[rank]),
           "row_sliced": sorted(de.strategy.row_sliced_tables),
           "column_sliced": len(de.strategy.sliced_out_ranges)}
    t0 = time.perf_counter()
    batches = [mp_full_batch(torch, de, rank, SEED + 700 + k)
               for k in range(4)]
    out["pack_ms_a_batch"] = (time.perf_counter() - t0) / 4 * 1e3
    # e-c1: one checked step
    rec = w8_recording_sgd(torch)
    step = make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), rec,
                                  lr_schedule=TRAIN_LR, nan_guard=True)
    zero_counts()
    with pack_checks(torch) as n, row_base_checks(torch) as nr:
        loss, st = step(st, *batches[0])
        torch.cuda.synchronize()
    counts, modes = read_counts(), read_mode_counts()
    plan = next(iter(de._plan_cache.values()))
    based = int(sum(bool(r.any()) for r in plan.rsliced))
    want = w8_per_step(len(plan.groups), len(de.widths), mp=True)
    check(counts == want, f"world 8 e rank {rank} checked step: launches "
          f"{counts}, expected {want}")
    check(modes["gather_combine_row_base"] == based
          and modes["pack_columns_sum"] == 1, f"world 8 e rank {rank}: "
          f"row-slice launches {modes}, expected K1 {based} and one sum")
    check(nr["gather_combine"] == based and n["pack_columns"] == 3,
          f"world 8 e rank {rank}: checked calls {dict(n)} {dict(nr)}")
    check(bool(torch.isfinite(loss)), f"world 8 e rank {rank}: loss {loss}")
    out["checked"], out["row_base_checked"] = dict(n), dict(nr)
    out["scatter_err"] = w8_scatter_check(torch, rec.seen)
    out["plan"] = {"groups": [(g.kind, g.width, g.hot, g.n)
                              for g in plan.groups],
                   "based_groups": based, "l_max": plan.l_max,
                   "s_max": plan.s_max, "rows_cap": dict(de.rows_cap)}
    rec.seen.clear()
    # e-c2: warmup, then timed steps with the launches counted
    step = make_hybrid_train_step(de, loss_fn, SGD(TRAIN_LR), SparseSGD(),
                                  lr_schedule=TRAIN_LR, nan_guard=True)
    for k in range(W8E_WARMUP):
        _, st = step(st, *batches[k % len(batches)])
    torch.cuda.synchronize()
    zero_counts()
    times, losses = [], []
    t0 = time.perf_counter()
    for k in range(W8E_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss, st = step(st, *batches[k % len(batches)])
        ev[1].record()
        times.append(ev)
        losses.append(loss)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    counts, modes = read_counts(), read_mode_counts()
    want = w8_per_step(len(plan.groups), len(de.widths), W8E_STEPS, mp=True)
    check(counts == want, f"world 8 e rank {rank} timed: launches {counts}, "
          f"expected {want}")
    out["launches"], out["modes"] = counts, modes
    out["step_ms"] = [s.elapsed_time(e) for s, e in times]
    out["losses"] = [float(x) for x in losses]
    check(np.isfinite(out["losses"]).all(), f"world 8 e rank {rank}: "
          "non-finite loss")
    # e-c3: the stage split (no id exchange with model-parallel input)
    st, out["stages"] = w8_staged_steps(torch, step, st, batches,
                                        W8_STAGE_STEPS, stages=W8_STAGES[1:])
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def w8_run_errors(ref, r0, tmp, prefix):
    """One world-8 small run (rank 0's result ``r0``, its tables in
    ``tmp`` as ``<prefix>_<t>.npy``) against the world-1 reference: the
    largest loss, dense-parameter and prediction differences, the
    largest slab difference and the update's relative L2 error."""
    loss_err = float(np.abs(np.subtract(r0["losses"], ref["losses"])).max())
    dense_err = max(float(np.abs(a - b).max())
                    for a, b in zip(r0["dense"], ref["dense"]))
    pred_err = float(np.abs(r0["pred"].reshape(-1)
                            - ref["pred"].reshape(-1)).max())
    sq_err, sq_upd, worst = 0.0, 0.0, 0.0
    for t, want in enumerate(ref["tables"]):
        a = np.load(os.path.join(tmp, f"{prefix}_{t}.npy"))
        init = np.load(os.path.join(tmp, f"table_{t}.npy"))
        err = a.astype(np.float64) - want
        sq_err += float(np.square(err).sum())
        sq_upd += float(np.square(want.astype(np.float64) - init).sum())
        worst = max(worst, float(np.abs(err).max()))
    return {"loss_err": loss_err, "dense_err": dense_err,
            "pred_err": pred_err, "slab_max_err": worst,
            "slab_rel_err": (sq_err / max(sq_upd, 1e-300)) ** 0.5,
            "losses": r0["losses"]}


def within_bounds(errs):
    return all(errs[k] <= v for k, v in W8_SMALL_BOUNDS.items())


def w8e_compare_small(torch, ref, ranks, tmp):
    """14e-b: the model-parallel row-sliced run within 14b's bounds of
    world 1, the control beyond them, the data-parallel run equal to the
    model-parallel one bit for bit."""
    first = ranks[0]["small_e"]
    out = {}
    for run in ("mp", "dp", "control"):
        r0 = first[run]
        check(r0["row_sliced"], f"world 8 e small {run}: no table was "
              "row-sliced")
        for r, res in enumerate(ranks):
            got = res["small_e"][run]
            check(got["losses"] == r0["losses"] and all(
                np.array_equal(a, b) for a, b in zip(got["dense"],
                                                     r0["dense"])),
                f"world 8 e small {run}: rank {r} differs from rank 0")
            if run != "control":
                calls = SMALL_STEPS + 1
                want = calls * r0["based_groups"]
                check(got["checked"]["pack_columns"] >= 3 * SMALL_STEPS + 2
                      and got["row_base_checked"]["gather_combine"] == want
                      and got["modes"]["gather_combine_row_base"] == want
                      and got["modes"]["pack_columns_sum"] == calls
                      and got["launches"]["pack_ids"] == (
                          calls if run == "dp" else 0),
                      f"world 8 e small {run} rank {r}: checked "
                      f"{got['checked']} {got['row_base_checked']}, "
                      f"launches {got['modes']} {got['launches']}")
        out[run] = w8_run_errors(ref, r0, tmp, f"w8e_{run}")
    m, c = out["mp"], out["control"]
    check(within_bounds(m), f"world 8 e small: beyond the bound of world "
          f"1: {m}")
    check(not within_bounds(c), f"world 8 e small control (rank "
          f"{W8E_DROP_RANK}'s row bases dropped) stays within the bound: "
          f"{c}")
    mp, dp = first["mp"], first["dp"]
    same = (mp["losses"] == dp["losses"]
            and all(np.array_equal(a, b) for a, b in zip(mp["dense"],
                                                         dp["dense"]))
            and np.array_equal(mp["pred"], dp["pred"])
            and all(np.array_equal(
                np.load(os.path.join(tmp, f"w8e_mp_{t}.npy")),
                np.load(os.path.join(tmp, f"w8e_dp_{t}.npy")))
                for t in range(len(CRITEO_1TB_SIZES))))
    check(same, "world 8 e small: the data-parallel run differs from the "
          "model-parallel one")
    out["dp_equals_mp"] = same
    out["row_sliced"] = first["mp"]["row_sliced"]
    out["checked"] = {run: first[run]["checked"] for run in ("mp", "dp")}
    out["err"] = {
        "pack_columns": max(first[run]["checked"]["err"]["pack_columns"]
                            for run in ("mp", "dp")),
        "gather_combine": max(first[run]["row_base_checked"]["err"][
            "gather_combine"] for run in ("mp", "dp"))}
    return out


# ------------------------------- the instrumented step at world 8 (14f)

#: 14f-a's streaming tables: small unsliced tables (under W8E_SMALL_RS)
W8F_STREAM = (7, 13, 15, 17, 24)
W8F_EXT = 4                    # their external ids span 4x their rows
W8F_STEPS = 3                  # timed steps a run of 14f-b and 14f-c
#: 14f-b's stage bounds: W8_STAGES with the telemetry fold after the
#: unpack and the metrics gather after the dense update
W8F_STAGES = ("id_exchange", "lookup", "output_exchange", "telemetry",
              "dense", "all_reduce", "cotangent_exchange",
              "apply_and_tallies", "metrics_gather", "tail")


def w8f_small_model(torch, schedule=None):
    """14f-a's layer: 14b's capped tables, row-sliced (``row_slice``
    W8E_SMALL_RS), tables W8F_STREAM streaming (capacity + buckets = the
    table's rows, a 17th of them buckets), ``comm_balanced``, fp32 (14g-a
    passes the pipelined schedule)."""
    from distributed_embeddings_torch.models import DLRMConfig
    from distributed_embeddings_torch.parallel import DistributedEmbedding

    cfg = DLRMConfig(table_sizes=w8_small_sizes(), embedding_dim=128,
                     num_numerical_features=13,
                     bottom_mlp_dims=(512, 256, 128),
                     top_mlp_dims=(1024, 1024, 512, 256, 1))
    configs = []
    for t, c in enumerate(cfg.embedding_configs()):
        if t in W8F_STREAM:
            nb = max(1, int(c["input_dim"]) // 17)
            c = dict(c, streaming={"capacity": int(c["input_dim"]) - nb,
                                   "buckets": nb})
        configs.append(c)
    de = DistributedEmbedding(configs, world_size=W8,
                              strategy="comm_balanced",
                              row_slice=W8E_SMALL_RS, schedule=schedule)
    return cfg, de


def w8f_small_batch(seed, b=W8_SMALL_BATCH):
    """14b's batch with the streaming tables' ids Zipfian over W8F_EXT
    times their rows (external ids past the slot map)."""
    from distributed_embeddings_torch.utils.data import power_law_ids

    rng = np.random.default_rng(seed)
    cats = [power_law_ids(rng, v * (W8F_EXT if t in W8F_STREAM else 1),
                          (b,)).astype(np.int32)
            for t, v in enumerate(w8_small_sizes())]
    return (cats, rng.normal(size=(b, 13)).astype(np.float32),
            (rng.random(b) < 0.25).astype(np.float32))


def same_tree(torch, a, b):
    """Whether two state trees hold the same bits everywhere."""
    if isinstance(a, dict):
        return all(same_tree(torch, a[k], b[k]) for k in a)
    return bool(torch.equal(a, b))


def w8f_metrics_close(torch, got, want, tol, what):
    """:func:`metrics_close` with a streaming step's ``stream_*`` counts
    held exactly."""
    got, want = dict(got), dict(want)
    for k in [k for k in got if k.startswith("stream_")]:
        check(torch.equal(got.pop(k), want.pop(k)), f"{what} {k}")
    return metrics_close(torch, [got], [want], tol, what)


def w8f_control_rank(de):
    """The first rank holding a row slice that does not start at row 0
    (dropping its row bases changes what it reads)."""
    for r, cfgs in enumerate(de.strategy.local_configs_list):
        if any(int(c.get("_row_base", 0)) > 0 for c in cfgs):
            return r
    raise RuntimeError("chip_smoke: no rank holds a based row slice")


@contextlib.contextmanager
def telemetry_without_row_bases(torch, de):
    """The control: this layer's telemetry stream reads its row-sliced
    slots with their row bases dropped (the lookup keeps them)."""
    real = de.telemetry_streams
    real_rbase = de._plan_rbase

    def zeros(plan, gi, device, reps=1):
        rb = real_rbase(plan, gi, device, reps)
        return None if rb is None else torch.zeros_like(rb)

    def streams(residuals):
        de._plan_rbase = zeros
        try:
            return real(residuals)
        finally:
            del de._plan_rbase

    de.telemetry_streams = streams
    try:
        yield
    finally:
        del de.telemetry_streams


#: 14f-a's plain run: every call site but K3's. K3's plain version
#: (``index_add_``) adds each id's update into the slab, rounding at the
#: slab's magnitude (an fp32 ulp of 0.05 is 3.7e-9 against updates of
#: ~1e-6 a step), so with it one lockstep step's slab update differs by
#: 6.05e-3 relative on an H100 at these sizes; K3 is held to it in 6a,
#: 14c and 14f-b's scatter checks. With K3 on both sides the slabs are
#: held to 14b's bounds.
W8F_PLAIN = (
    "gather_combine", "ragged_combine", "lengths_to_splits", "ragged_grad",
    "row_to_split", "dot_interact_fwd", "dot_interact_bwd",
    "sgd_scatter_promoted", "dedup_sparse_grad", "adagrad_rows",
    "adagrad_dense", "adagrad_dense_scatter", "adam_rows", "momentum_rows",
    "sketch_update", "sketch_query", "sketch_fold", "remap_stage",
    "commit_rows", "pack_ids", "pack_columns", "grad_health",
    "dense_update")


def w8f_rank_small(torch, rank, tmp):
    """14f-a on one rank: 5 guarded instrumented steps with telemetry and
    streaming, each with the kernels and, from a copy of the same state,
    with every call site but K3's routed to its plain version
    (W8F_PLAIN; lockstep), a NaN batch on rank W8_NAN_RANK, and the
    control dropping one rank's row bases in its telemetry stream."""
    from distributed_embeddings_torch.analysis import telemetry as tel
    from distributed_embeddings_torch.models import DLRMDense
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, init_streaming, make_hybrid_train_step)
    from distributed_embeddings_torch.utils import obs

    cfg, de = w8f_small_model(torch)
    dense = DLRMDense(cfg, device="cuda")
    st = w8_small_state(torch, de, dense, tmp)
    tcfg, scfg = tel.TelemetryConfig(), stream_config()
    telem = tel.init_telemetry(de, tcfg, device="cuda")
    ss = init_streaming(de, scfg, device="cuda")
    step = make_hybrid_train_step(
        de, loss_fn, SGD(W8_SMALL_LR), SparseSGD(), lr_schedule=W8_SMALL_LR,
        nan_guard=True, with_metrics=True, telemetry=tcfg, dynamic=scfg)
    b = W8_SMALL_BATCH // W8
    rows = slice(rank * b, (rank + 1) * b)
    counts = {"kernels": {}, "plain": {}}
    slab_max = slab_rel = metric_err = 0.0
    summaries = []
    for k in range(SMALL_STEPS):
        cats, num, lab = w8_to_card(torch, w8f_small_batch(SEED + 800 + k),
                                    rows)
        twin, t2, s2 = clone_state(st), clone_tree(telem), clone_tree(ss)
        before = {key: v.float().clone() for key, v in st.emb_params.items()}
        out = {}
        for name in ("kernels", "plain"):
            zero_counts()
            with (plain_kernels(W8F_PLAIN) if name == "plain"
                  else contextlib.nullcontext()):
                out[name] = (step(st, cats, (num, lab), telem, ss)
                             if name == "kernels" else
                             step(twin, cats, (num, lab), t2, s2))
            torch.cuda.synchronize()
            for key, v in read_counts().items():
                counts[name][key] = counts[name].get(key, 0) + v
        (lk, st, mk, telem, ss), (_, twin, mp, t2, s2) = (out["kernels"],
                                                          out["plain"])
        what = f"world 8 f small rank {rank} step {k}"
        check(bool(torch.isfinite(lk)), f"{what}: loss {lk}")
        telem_equal(torch, telem, t2, f"{what} telemetry")
        telem_equal(torch, ss, s2, f"{what} streaming state")
        metric_err = max(metric_err, w8f_metrics_close(torch, mk, mp, 1e-3,
                                                       what))
        for key in st.emb_params:
            a = st.emb_params[key].float()
            p = twin.emb_params[key].float()
            slab_max = max(slab_max, float((a - p).abs().max()))
            upd = float((p - before[key]).norm())
            slab_rel = max(slab_rel, float((a - p).norm()) / max(upd, 1e-30))
        summaries.append(obs.summarize(mk))
        del twin, t2, s2, before, out
    owns = any(t in de.streaming_tables
               for t in de.strategy.table_ids_list[rank])
    # the NaN batch: every rank skips, telemetry still counts
    cats, num, lab = w8_to_card(torch, w8f_small_batch(SEED + 850), rows)
    if rank == W8_NAN_RANK:
        num[0, 3] = float("nan")
    snap, s_snap = clone_state(st), clone_tree(ss)
    t_steps = int(telem["steps"])
    loss, st, m, telem, ss = step(st, cats, (num, lab), telem, ss)
    torch.cuda.synchronize()
    check(not bool(torch.isfinite(loss)), f"world 8 f rank {rank}: the NaN "
          "batch gave a finite loss")
    check(bool((m["skipped_steps"] == 1).all()), f"world 8 f rank {rank}: "
          f"skipped_steps {m['skipped_steps'].tolist()}")
    check(same_tree(torch, st.emb_params, snap.emb_params)
          and same_tree(torch, ss, s_snap)
          and all(torch.equal(a, c) for a, c in zip(
              st.dense_params.parameters(), snap.dense_params.parameters())),
          f"world 8 f rank {rank}: the NaN batch changed the state")
    check(int(telem["steps"]) == t_steps + 1, f"world 8 f rank {rank}: "
          "telemetry did not count the skipped step")
    del snap, s_snap
    # the control: one rank's telemetry stream without its row bases
    control = w8f_control_rank(de)
    cats, num, lab = w8_to_card(torch, w8f_small_batch(SEED + 860), rows)
    twin, t2, s2 = clone_state(st), clone_tree(telem), clone_tree(ss)
    with (telemetry_without_row_bases(torch, de) if rank == control
          else contextlib.nullcontext()):
        step(st, cats, (num, lab), telem, ss)
    with plain_kernels(W8F_PLAIN):
        step(twin, cats, (num, lab), t2, s2)
    torch.cuda.synchronize()
    control_differs = not same_tree(torch, telem, t2)
    del twin, t2, s2
    torch.cuda.empty_cache()
    return {"counts": counts, "slab_max_err": slab_max,
            "slab_rel_err": slab_rel, "metric_rel_err": metric_err,
            "owns_streaming": owns, "control_rank": control,
            "control_differs": control_differs,
            "row_sliced": sorted(de.strategy.row_sliced_tables),
            "streaming": sorted(de.streaming_tables),
            "summary_last": summaries[-1]}


@contextlib.contextmanager
def fold_checks(torch):
    """Route the telemetry's width folds (``analysis.telemetry.
    sketch_fold``) through a checker: each fold (K13, K14's pool, K15)
    must leave the width's state and the step's count as the plain fold
    does on copies of the same state and stream, bitwise. Yields the
    checked folds and the positions of the last."""
    from distributed_embeddings_torch.analysis import telemetry as tmod
    from distributed_embeddings_torch.ops import sketch

    real = tmod.sketch_fold
    n = {"folds": 0, "positions": 0}

    def fold(wstate, ids, live, candidates, total=None, first=True):
        ws = {k: v.clone() for k, v in wstate.items()}
        tot = None if total is None else total.clone()
        real(wstate, ids, live, candidates, total, first)
        sketch.fold_ids_plain(ws, ids, live, candidates, tot, first)
        for k in ws:
            exact(torch, wstate[k], ws[k], f"world 8 fold {k}")
        if total is not None:
            exact(torch, total, tot, "world 8 fold count")
        n["folds"] += 1
        n["positions"] = int(ids.numel())

    tmod.sketch_fold = fold
    try:
        yield n
    finally:
        tmod.sketch_fold = real


@contextlib.contextmanager
def call_times(torch, sites):
    """CUDA-event ms of every call through the ``(module, name)`` call
    sites, inside the real step (8 ranks time-share the card, so these
    are contended times). Yields ``{name: [ms, ...]}``, filled on
    exit."""
    saved = {(m, n): getattr(m, n) for m, n in sites}
    evs = {n: [] for _, n in sites}

    def wrap(fn, name):
        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            evs[name].append((e0, e1))
            return out
        return timed

    for (m, n), fn in saved.items():
        setattr(m, n, wrap(fn, n))
    ms = {}
    try:
        yield ms
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
        torch.cuda.synchronize()
        ms.update({n: [a.elapsed_time(b) for a, b in v]
                   for n, v in evs.items()})


def w8f_per_step(groups, widths, folds, steps=1):
    """Launches of ``steps`` instrumented world-8 DLRM steps with
    telemetry on one rank: 14c's (K21 twice: the cotangents, the averaged
    dense gradients) and, per folded width, K13, K14's pool and K15
    once."""
    want = w8_per_step(groups, widths, steps)
    for name in ("cms_update", "topk_pool", "topk_merge"):
        want[name] = folds * steps
    return want


def w8f_rank_full(torch, rank):
    """14f-b on one rank: 14c's Criteo-1TB step with ``with_metrics``
    and the default telemetry (see main's docstring, phase 14f-b)."""
    from distributed_embeddings_torch.analysis import telemetry as tmod
    from distributed_embeddings_torch.models import DLRMDense
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, init_hybrid_state, make_hybrid_train_step, trainer)

    cfg, de = w8_model(torch, CRITEO_1TB_SIZES, W8_CST, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    dense = DLRMDense(cfg, device="cuda", generator=gen)
    st = init_hybrid_state(de, SparseSGD(), dense, SGD(TRAIN_LR),
                           generator=gen, dtype=torch.bfloat16, device="cuda")
    tcfg = tmod.TelemetryConfig()
    telem = tmod.init_telemetry(de, tcfg, device="cuda")
    torch.cuda.synchronize()
    out = {"slab_bytes": sum(v.numel() * v.element_size()
                             for v in st.emb_params.values())}
    b = W8_BATCH // W8
    batches = [train_batch(torch, CRITEO_1TB_SIZES, b,
                           seed=SEED + 900 + 16 * k + rank)
               for k in range(4)]
    args = (de, loss_fn, SGD(TRAIN_LR), SparseSGD())
    on = make_hybrid_train_step(*args, lr_schedule=TRAIN_LR, nan_guard=True,
                                with_metrics=True, telemetry=tcfg)
    off = make_hybrid_train_step(*args, lr_schedule=TRAIN_LR, nan_guard=True)
    # f-b1: one checked step
    zero_counts()
    with fold_checks(torch) as nf, pack_checks(torch) as n:
        loss, st, m, telem = on(st, *batches[0], telem)
        torch.cuda.synchronize()
    counts = read_counts()
    plan = next(iter(de._plan_cache.values()))
    want = w8f_per_step(len(plan.groups), len(de.widths), len(de.widths))
    check(counts == want, f"world 8 f rank {rank} checked step: launches "
          f"{counts}, expected {want}")
    check(bool(torch.isfinite(loss)), f"world 8 f rank {rank}: loss {loss}")
    routed = int(m["ids_routed"].sum())
    check(routed == sum(de.slices_per_table) * W8_BATCH, f"world 8 f rank "
          f"{rank}: ids_routed sum {routed}, expected every id of every "
          f"slice {sum(de.slices_per_table)} x {W8_BATCH}")
    check(int(m["id_overflow"].sum()) == 0
          and int(m["invalid_id_count"].sum()) == 0, f"world 8 f rank "
          f"{rank}: overflow {m['id_overflow'].tolist()}, invalid "
          f"{m['invalid_id_count'].tolist()}")
    plan_bytes = {"id_a2a_bytes": (W8 - 1) * plan.l_max * 4,
                  "out_a2a_bytes": (W8 - 1) * b * plan.s_max * 2,
                  "grad_a2a_bytes": (W8 - 1) * b * plan.s_max * 2}
    for k, v in plan_bytes.items():
        check(bool((m[k] == v).all()), f"world 8 f rank {rank}: {k} "
              f"{m[k].tolist()}, the plan's {v}")
    out.update(checked=dict(n), folds_checked=dict(nf),
               ids_routed=m["ids_routed"].tolist(), plan_bytes=plan_bytes,
               ids_total=float(telem["ids_total"]))
    # f-b2: warmup, then off, on, on, off, the launches counted
    for k in range(W8_WARMUP):
        _, st = off(st, *batches[k % len(batches)])
        _, st, _, telem = on(st, *batches[k % len(batches)], telem)
    torch.cuda.synchronize()
    runs = {"off": [], "on": []}
    launches = {}
    in_step = {}
    sites = ((tmod, "sketch_fold"), (trainer, "grad_health"))
    for label in ("off", "on", "on", "off"):
        zero_counts()
        ctx = (call_times(torch, sites) if label == "on" and not in_step
               else contextlib.nullcontext({}))
        with ctx as ms:
            times = []
            for k in range(W8F_STEPS):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                if label == "on":
                    _, st, _, telem = on(st, *batches[k % len(batches)],
                                         telem)
                else:
                    _, st = off(st, *batches[k % len(batches)])
                ev[1].record()
                times.append(ev)
            torch.cuda.synchronize()
        if ms:
            in_step = {k: float(np.median(v)) for k, v in ms.items()}
        runs[label].append(float(np.median([a.elapsed_time(c)
                                            for a, c in times])))
        launches.setdefault(label, read_counts())
    want_on = w8f_per_step(len(plan.groups), len(de.widths), len(de.widths),
                           W8F_STEPS)
    want_off = w8_per_step(len(plan.groups), len(de.widths), W8F_STEPS)
    check(launches["on"] == want_on and launches["off"] == want_off,
          f"world 8 f rank {rank} timed: launches {launches}, expected "
          f"on {want_on}, off {want_off}")
    out.update(step_ms={k: float(np.median(v)) for k, v in runs.items()},
               launches=launches["on"], in_step_ms=in_step)
    # f-b3: the stage splits, off and on
    st, out["stages_off"] = w8_staged_steps(torch, off, st, batches,
                                            W8_STAGE_STEPS)
    extra = ((de, "update_telemetry", False, True),
             (trainer, "_gather_metrics", True, True))

    def on_step(s, cats, batch):
        loss, s, _, _ = on(s, cats, batch, telem)
        return loss, s

    st, out["stages_on"] = w8_staged_steps(torch, on_step, st, batches,
                                           W8_STAGE_STEPS, stages=W8F_STAGES,
                                           extra=extra)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def w8f_stream_model(torch):
    """12c's streaming DLRM at world 8: the 26 Criteo-Kaggle tables at
    width 128 capped at 2M rows, the five past the cap streaming, fp32
    tables, bf16 compute, ``SparseAdagrad``; the basic strategy."""
    from distributed_embeddings_torch.models import DLRMConfig
    from distributed_embeddings_torch.parallel import DistributedEmbedding

    cfg = DLRMConfig(table_sizes=ragged_sizes(), embedding_dim=128,
                     num_numerical_features=13,
                     bottom_mlp_dims=(512, 256, 128),
                     top_mlp_dims=(1024, 1024, 512, 256, 1),
                     compute_dtype=torch.bfloat16)
    dynamic = [dict(c, streaming={"capacity": STREAM_CAPACITY,
                                  "buckets": STREAM_BUCKETS})
               if t in STREAM_OVERCAP else c
               for t, c in enumerate(cfg.embedding_configs())]
    return cfg, DistributedEmbedding(dynamic, world_size=W8,
                                     compute_dtype=torch.bfloat16)


@contextlib.contextmanager
def commits_in_turns(torch, rank):
    """The streaming commits of one step taken by the ranks in rank order
    (gloo barriers around every rank's ``parallel.streaming.commit``):
    the checks of K17 copy a rank's whole slab and accumulator, and eight
    ranks doing so at once do not fit on the card."""
    import torch.distributed as dist

    from distributed_embeddings_torch.parallel import streaming as smod

    real = smod.commit

    def commit(*a, **kw):
        for _ in range(rank):
            dist.barrier()
        try:
            return real(*a, **kw)
        finally:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            for _ in range(rank, W8):
                dist.barrier()

    smod.commit = commit
    try:
        yield
    finally:
        smod.commit = real


def w8f_rank_stream(torch, rank):
    """14f-c on one rank (see main's docstring, phase 14f-c)."""
    from distributed_embeddings_torch.models import DLRMDense
    from distributed_embeddings_torch.parallel import (
        SGD, SparseAdagrad, init_hybrid_state, init_streaming)
    from distributed_embeddings_torch.parallel import streaming as smod

    cfg, de = w8f_stream_model(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 180)
    dense = DLRMDense(cfg, device="cuda", generator=gen)
    st = init_hybrid_state(de, SparseAdagrad(), dense, SGD(TRAIN_LR),
                           generator=gen, dtype=torch.float32,
                           device="cuda")
    scfg = stream_config()
    ss = init_streaming(de, scfg, device="cuda")
    step = make_step_with(de, scfg, SparseAdagrad())
    b = TRAIN_BATCH // W8
    bgen = torch.Generator(device="cuda").manual_seed(SEED + 181)
    batches = []
    for _ in range(STREAM_BATCHES):
        cats, (num, lab) = stream_dlrm_batch(torch, bgen, TRAIN_BATCH)
        sl = slice(rank * b, (rank + 1) * b)
        batches.append(([c[sl].contiguous() for c in cats],
                        (num[sl].contiguous(), lab[sl].contiguous())))
    torch.cuda.synchronize()
    out = {"slab_bytes": sum(v.numel() * v.element_size()
                             for v in st.emb_params.values()),
           "streaming_here": sorted(
               t for t in de.strategy.table_ids_list[rank]
               if t in de.streaming_tables)}
    # f-c1: one checked step, K16 and K17 held to their plain versions
    errs = {}
    zero_counts()
    with stream_checks(torch, errs, f"world 8 f stream rank {rank}"
                       ) as calls, commits_in_turns(torch, rank):
        loss, st, ss = step(st, *batches[0], ss)
        torch.cuda.synchronize()
    counts = read_counts()
    here = 1 if out["streaming_here"] else 0
    check(counts["remap_stage"] == here and counts["commit_rows"] == here
          and calls["remap"] == here and calls["commit"] == here,
          f"world 8 f stream rank {rank}: K16/K17 launches {counts}, "
          f"checked {calls}, streaming tables here {out['streaming_here']}")
    check(bool(torch.isfinite(loss)), f"world 8 f stream rank {rank}: loss "
          f"{loss}")
    out.update(checked=dict(calls), errs=errs)
    # f-c2: warmup, then timed steps with the launches counted
    for k in range(W8_WARMUP):
        _, st, ss = step(st, *batches[k % len(batches)], ss)
    torch.cuda.synchronize()
    zero_counts()
    times = []
    t0 = time.perf_counter()
    with call_times(torch, ((smod, "remap_stage"),
                            (smod, "commit_rows"))) as ms:
        for k in range(W8F_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            _, st, ss = step(st, *batches[k % len(batches)], ss)
            ev[1].record()
            times.append(ev)
        torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = read_counts()
    out["step_ms"] = float(np.median([a.elapsed_time(c) for a, c in times]))
    out["in_step_ms"] = {k: float(np.median(v)) for k, v in ms.items() if v}
    out["occupancy"] = smod.occupancy(de, ss)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def w8f_reckon(torch):
    """14f's device memory reckoned from the layouts before the ranks
    start (GB): 14f-b's bf16 slabs a rank (14c's) and 14f-c's fp32 slabs,
    Adagrad accumulators and slot maps a rank, and 14f-c's checked-step
    peak on the card (every rank's state, one rank at a time holding its
    K17 check's copies: slab and accumulator, and the float comparison's
    three slab-sized temporaries)."""
    _, de_b = w8_model(torch, CRITEO_1TB_SIZES, W8_CST, torch.bfloat16)
    _, de_c = w8f_stream_model(torch)
    b = sum(de_b.rows_cap[w] * w * 2 for w in de_b.widths)
    c = sum(de_c.rows_cap[w] * (w * 4 * 2 + 8) for w in de_c.widths)
    slab_c = max(de_c.rows_cap[w] * w * 4 for w in de_c.widths)
    return {"14f-b_slab_gb_a_rank": b / 1e9,
            "14f-b_slabs_gb": W8 * b / 1e9,
            "14f-c_state_gb_a_rank": c / 1e9,
            "14f-c_checked_step_peak_gb": (W8 * c + 5 * slab_c) / 1e9}


def w8f_results(torch, ranks):
    """14f's checks across the ranks; returns the paths' launches (rank
    0's a step of 14f-b with telemetry and metrics on, and of 14f-c the
    first rank holding a streaming table) and the logged result."""
    small = [r["small_f"] for r in ranks]
    full = [r["full_f"] for r in ranks]
    stream = [r["stream_f"] for r in ranks]
    s0 = small[0]
    b0 = full[0]
    occ = [s["occupancy"] for s in stream]
    owner = next(r for r, s in enumerate(stream) if s["streaming_here"])
    err = {"remap_stage": 0.0, "commit_rows": 0.0}
    for s in stream:
        for k, v in s["errs"].items():
            err[k] = max(err.get(k, 0.0), v)
    result = {
        "transport": "gloo over host memory, 8 ranks time-sharing one "
                     "H100 (not a multi-GPU or NCCL number)",
        "small": {"row_sliced": s0["row_sliced"],
                  "streaming": s0["streaming"],
                  "owns_streaming": [s["owns_streaming"] for s in small],
                  "slab_max_err_by_rank": [s["slab_max_err"] for s in small],
                  "slab_rel_err_by_rank": [s["slab_rel_err"] for s in small],
                  "launches_per_step_rank0": {
                      n: v / SMALL_STEPS for n, v in
                      s0["counts"]["kernels"].items() if v},
                  "metric_rel_err": max(s["metric_rel_err"] for s in small),
                  "control_rank": s0["control_rank"],
                  "summary_last_step": s0["summary_last"]},
        "full": {
            "samples_per_s_8_ranks_on_one_h100_over_gloo": {
                k: W8_BATCH / (max(f["step_ms"][k] for f in full) / 1e3)
                for k in ("off", "on")},
            "rank_step_ms_p50": {k: [f["step_ms"][k] for f in full]
                                 for k in ("off", "on")},
            "metrics_and_telemetry_overhead_frac": (
                max(f["step_ms"]["on"] for f in full)
                / max(f["step_ms"]["off"] for f in full) - 1.0),
            "launches_per_step_rank0": {
                n: v / W8F_STEPS for n, v in b0["launches"].items() if v},
            "in_step_ms_rank0": b0["in_step_ms"],
            "in_step_ms_max_rank": {
                k: max(f["in_step_ms"].get(k, 0.0) for f in full)
                for k in b0["in_step_ms"]},
            "stages_off_rank0": b0["stages_off"],
            "stages_on_rank0": b0["stages_on"],
            "ids_routed_by_rank": b0["ids_routed"],
            "ids_total_by_rank": [f["ids_total"] for f in full],
            "plan_bytes": b0["plan_bytes"],
            "folds_checked_rank0": b0["folds_checked"],
            "slab_gb_by_rank": [f["slab_bytes"] / 1e9 for f in full],
            "peak_gb_by_rank": [f["peak_gb"] for f in full]},
        "stream": {
            "samples_per_s_8_ranks_on_one_h100_over_gloo":
                W8F_STEPS * TRAIN_BATCH / max(s["wall_s"] for s in stream),
            "rank_step_ms_p50": [s["step_ms"] for s in stream],
            "streaming_tables_by_rank": [s["streaming_here"] for s in stream],
            "launches_per_step_owner": {
                n: v / W8F_STEPS for n, v in stream[owner]["launches"].items()
                if v},
            "owner": owner,
            "in_step_ms_by_rank": [s["in_step_ms"] for s in stream],
            "checked": [s["checked"] for s in stream],
            "kernel_errs": err, "occupancy": occ[0],
            "slab_gb_by_rank": [s["slab_bytes"] / 1e9 for s in stream],
            "peak_gb_by_rank": [s["peak_gb"] for s in stream]}}
    log("world 8 f: " + json.dumps(result))
    for r, s in enumerate(small):
        check(s["slab_max_err"] <= W8_SMALL_BOUNDS["slab_max_err"]
              and s["slab_rel_err"] <= W8_SMALL_BOUNDS["slab_rel_err"],
              f"world 8 f small rank {r}: slabs beyond 14b's bounds "
              f"({s['slab_max_err']}, {s['slab_rel_err']})")
        kc, pc = s["counts"]["kernels"], s["counts"]["plain"]
        check(not any(v for k, v in pc.items() if k != "sgd_scatter"),
              f"world 8 f small rank {r}: the plain run launched {pc}")
        here = SMALL_STEPS if s["owns_streaming"] else 0
        check(kc["cms_update"] == kc["topk_pool"] == kc["topk_merge"]
              == SMALL_STEPS and kc["grad_health"] == 2 * SMALL_STEPS
              and kc["remap_stage"] == kc["commit_rows"] == here,
              f"world 8 f small rank {r}: launches {kc}")
        check(s["control_differs"] == (r == s0["control_rank"]),
              f"world 8 f small control (rank {s0['control_rank']}'s "
              f"telemetry without its row bases): rank {r} "
              f"{'differs' if s['control_differs'] else 'agrees'}")
    check(any(s["owns_streaming"] for s in small), "world 8 f small: no rank "
          "holds a streaming table")
    check(all(o == occ[0] for o in occ), "world 8 f stream: occupancy "
          "differs between ranks")
    check(occ[0]["admitted"] > 0 and occ[0]["hit_ids"] > 0,
          f"world 8 f stream: nothing admitted or hit {occ[0]}")
    launches = {"world8_instrumented": {
        n: v // W8F_STEPS for n, v in b0["launches"].items()},
        "world8_streaming": {
        n: v // W8F_STEPS for n, v in stream[owner]["launches"].items()}}
    return launches, err, result


# ------------------------------------------- the pipelined step (14g)

W8G_K = 2                      # microbatches of the pipelined step
W8G_SMALL_STEPS = 3            # 14g-a's lockstep steps
W8G_STEPS = 3                  # timed steps a turn of 14g-b
W1G_STEPS = 10                 # timed steps a turn of 14g-c
#: JAX's pipelined-vs-serialized bounds (tests/test_pipeline.py)
W8G_RTOL, W8G_ATOL = 2e-5, 2e-6
#: the kernels the pipelined step launches once a microbatch (the rest
#: once a step): the id blocks (K19), the lookups (K1; K8 and K10 on
#: ragged groups), the lookup rows, the unpack and the cotangent pack
#: (K20), the interaction (K2, K4) and the ragged cotangent rows (K9)
PER_MICROBATCH = ("pack_ids", "gather_combine", "ragged_combine",
                  "lengths_to_splits", "pack_columns", "dot_interact_fwd",
                  "dot_interact_bwd", "ragged_grad")


def pipelined_per_step(want, K=W8G_K):
    """The serialized step's launches ``want`` as the pipelined step's
    with K microbatches: PER_MICROBATCH K times as often, the rest (the
    sparse apply a slab, the telemetry fold a width, K16's update and
    K17, K21, K22) as often."""
    return {k: v * K if k in PER_MICROBATCH else v for k, v in want.items()}


def allclose(torch, a, b):
    """Within JAX's pipelined-vs-serialized bounds (W8G_RTOL, W8G_ATOL)."""
    return bool(torch.allclose(a.float(), b.float(), rtol=W8G_RTOL,
                               atol=W8G_ATOL))


def w8g_rank_small(torch, rank, tmp):
    """14g-a on one rank (see main's docstring, phase 14g-a)."""
    from distributed_embeddings_torch.analysis import telemetry as tel
    from distributed_embeddings_torch.models import DLRMDense
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, init_streaming, make_hybrid_train_step)
    from distributed_embeddings_torch.parallel.schedule import (
        pipelined_schedule)

    cfg, de = w8f_small_model(
        torch, schedule=pipelined_schedule(W8G_K, streaming=True))
    _, de_s = w8f_small_model(torch)
    check(de.schedule.microbatches == W8G_K
          and de_s.schedule.microbatches == 1, "world 8 g: schedules "
          f"{de.schedule.name}, {de_s.schedule.name}")
    dense = DLRMDense(cfg, device="cuda")
    st = w8_small_state(torch, de, dense, tmp)
    tcfg, scfg = tel.TelemetryConfig(), stream_config()
    telem = tel.init_telemetry(de, tcfg, device="cuda")
    ss = init_streaming(de, scfg, device="cuda")
    kw = dict(lr_schedule=W8_SMALL_LR, nan_guard=True, with_metrics=True,
              telemetry=tcfg, dynamic=scfg)
    pipe = make_hybrid_train_step(de, loss_fn, SGD(W8_SMALL_LR),
                                  SparseSGD(), **kw)
    ser = make_hybrid_train_step(de_s, loss_fn, SGD(W8_SMALL_LR),
                                 SparseSGD(), **kw)
    b = W8_SMALL_BATCH // W8
    rows = slice(rank * b, (rank + 1) * b)
    owns = any(t in de.streaming_tables
               for t in de.strategy.table_ids_list[rank])
    counts = {"kernels": {}, "plain": {}, "serialized": {}}
    err = {"slab_max": 0.0, "slab_rel": 0.0, "metric_rel": 0.0,
           "ser_loss": 0.0, "ser_slab": 0.0, "ser_dense": 0.0,
           "ser_metric_rel": 0.0}
    for k in range(W8G_SMALL_STEPS):
        cats, num, lab = w8_to_card(
            torch, w8f_small_batch(SEED + 1000 + k), rows)
        twin, t2, s2 = clone_state(st), clone_tree(telem), clone_tree(ss)
        sst, t3, s3 = clone_state(st), clone_tree(telem), clone_tree(ss)
        before = {key: v.float().clone() for key, v in st.emb_params.items()}
        out = {}
        for name, (fn, args) in (
                ("kernels", (pipe, (st, cats, (num, lab), telem, ss))),
                ("plain", (pipe, (twin, cats, (num, lab), t2, s2))),
                ("serialized", (ser, (sst, cats, (num, lab), t3, s3)))):
            zero_counts()
            with (plain_kernels(W8F_PLAIN) if name == "plain"
                  else contextlib.nullcontext()):
                out[name] = fn(*args)
            torch.cuda.synchronize()
            for key, v in read_counts().items():
                counts[name][key] = counts[name].get(key, 0) + v
        (lk, st, mk, telem, ss), (_, twin, mp, t2, s2), \
            (ls, sst, ms, t3, s3) = (out["kernels"], out["plain"],
                                     out["serialized"])
        what = f"world 8 g small rank {rank} step {k}"
        check(bool(torch.isfinite(lk)), f"{what}: loss {lk}")
        # kernels against plain, in lockstep
        telem_equal(torch, telem, t2, f"{what} telemetry")
        telem_equal(torch, ss, s2, f"{what} streaming state")
        err["metric_rel"] = max(err["metric_rel"], w8f_metrics_close(
            torch, mk, mp, 1e-3, what))
        for key in st.emb_params:
            a = st.emb_params[key].float()
            p = twin.emb_params[key].float()
            err["slab_max"] = max(err["slab_max"], float((a - p).abs().max()))
            upd = float((p - before[key]).norm())
            err["slab_rel"] = max(err["slab_rel"], float((a - p).norm())
                                  / max(upd, 1e-30))
        # pipelined against serialized, both on the kernels
        what_s = f"{what} pipelined vs serialized"
        telem_equal(torch, telem, t3, f"{what_s} telemetry")
        telem_equal(torch, ss, s3, f"{what_s} streaming state")
        err["ser_metric_rel"] = max(err["ser_metric_rel"], w8f_metrics_close(
            torch, mk, ms, 1e-3, what_s))
        check(allclose(torch, lk, ls), f"{what_s}: loss {float(lk)} vs "
              f"{float(ls)}")
        err["ser_loss"] = max(err["ser_loss"], abs(float(lk) - float(ls)))
        for key in st.emb_params:
            a, c = st.emb_params[key], sst.emb_params[key]
            check(allclose(torch, a, c), f"{what_s}: slab {key} beyond "
                  f"rtol {W8G_RTOL} / atol {W8G_ATOL}")
            err["ser_slab"] = max(err["ser_slab"], float(
                (a.float() - c.float()).abs().max()))
        for a, c in zip(st.dense_params.parameters(),
                        sst.dense_params.parameters()):
            check(allclose(torch, a, c), f"{what_s}: dense parameters")
            err["ser_dense"] = max(err["ser_dense"], float(
                (a.detach().float() - c.detach().float()).abs().max()))
        del twin, t2, s2, sst, t3, s3, before, out
    check(err["slab_max"] <= W8_SMALL_BOUNDS["slab_max_err"]
          and err["slab_rel"] <= W8_SMALL_BOUNDS["slab_rel_err"],
          f"world 8 g small rank {rank}: slabs beyond 14b's bounds {err}")
    here = W8G_SMALL_STEPS if owns else 0
    kc = counts["kernels"]
    check(kc["remap_stage"] == (W8G_K + 1) * here
          and kc["commit_rows"] == here
          and kc["cms_update"] == kc["topk_pool"] == kc["topk_merge"]
          == W8G_SMALL_STEPS and kc["grad_health"] == 2 * W8G_SMALL_STEPS
          and kc["pack_ids"] == W8G_K * W8G_SMALL_STEPS
          and kc["pack_columns"] == 3 * W8G_K * W8G_SMALL_STEPS,
          f"world 8 g small rank {rank}: launches {kc}")
    check(not any(v for n, v in counts["plain"].items()
                  if n != "sgd_scatter"),
          f"world 8 g small rank {rank}: the plain run launched "
          f"{counts['plain']}")
    # the NaN batch: every rank skips, telemetry still counts
    cats, num, lab = w8_to_card(torch, w8f_small_batch(SEED + 1050), rows)
    if rank == W8_NAN_RANK:
        num[0, 3] = float("nan")
    snap, s_snap = clone_state(st), clone_tree(ss)
    t_steps = int(telem["steps"])
    loss, st, m, telem, ss = pipe(st, cats, (num, lab), telem, ss)
    torch.cuda.synchronize()
    check(not bool(torch.isfinite(loss)), f"world 8 g rank {rank}: the NaN "
          "batch gave a finite loss")
    check(bool((m["skipped_steps"] == 1).all()), f"world 8 g rank {rank}: "
          f"skipped_steps {m['skipped_steps'].tolist()}")
    check(same_tree(torch, st.emb_params, snap.emb_params)
          and same_tree(torch, ss, s_snap)
          and all(torch.equal(a, c) for a, c in zip(
              st.dense_params.parameters(), snap.dense_params.parameters())),
          f"world 8 g rank {rank}: the NaN batch changed the state")
    check(int(telem["steps"]) == t_steps + 1, f"world 8 g rank {rank}: "
          "telemetry did not count the skipped step")
    del snap, s_snap
    torch.cuda.empty_cache()
    return {"counts": counts, "err": err, "owns_streaming": owns,
            "schedule": de.schedule.name}


@contextlib.contextmanager
def scope_times(torch):
    """Time every phase scope the step enters (``utils.obs.scope``,
    replaced for the block by a timer): host ms between its enter and exit
    and CUDA-event ms between events recorded there, without a sync (the
    exchanges stay in flight). Yields the list of spans ``(name, host
    ms, (start event, end event))`` to read after a synchronize."""
    from distributed_embeddings_torch.utils import obs

    spans = []

    class Timed:
        __slots__ = ("name", "t0", "e0")

        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            spans.append((self.name, (time.perf_counter() - self.t0) * 1e3,
                          (self.e0, e1)))
            return False

    real = obs.scope
    obs.scope = Timed
    try:
        yield spans
    finally:
        obs.scope = real


def scoped_steps(torch, step, st, batches, steps):
    """``steps`` real steps (after one untimed) with every phase scope
    timed (:func:`scope_times`): per phase name the medians over the
    steps of its host ms and CUDA-event ms summed over the step (the
    ``*_wait`` phases: the ms the host blocked on each exchange), and the
    step's host ms."""
    per = []
    for k in range(1 + steps):
        torch.cuda.synchronize()
        with scope_times(torch) as spans:
            t0 = time.perf_counter()
            _, st = step(st, *batches[k % len(batches)])
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
        if not k:
            continue
        split = {"step": (host, 0.0)}
        for name, ms, (e0, e1) in spans:
            h, d = split.get(name, (0.0, 0.0))
            split[name] = (h + ms, d + e0.elapsed_time(e1))
        per.append(split)
    names = sorted(set().union(*per))
    return st, {n: {"host_ms": float(np.median([p.get(n, (0.0, 0.0))[0]
                                                for p in per])),
                    "device_ms": float(np.median([p.get(n, (0.0, 0.0))[1]
                                                  for p in per]))}
                for n in names}


def w8g_rank_full(torch, rank):
    """14g-b on one rank (see main's docstring, phase 14g-b)."""
    from distributed_embeddings_torch.models import DLRMDense
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, init_hybrid_state, make_hybrid_train_step)
    from distributed_embeddings_torch.parallel.schedule import (
        pipelined_schedule)

    cfg, de_s = w8_model(torch, CRITEO_1TB_SIZES, W8_CST, torch.bfloat16)
    _, de_p = w8_model(torch, CRITEO_1TB_SIZES, W8_CST, torch.bfloat16,
                       schedule=pipelined_schedule(W8G_K))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    dense = DLRMDense(cfg, device="cuda", generator=gen)
    st = init_hybrid_state(de_s, SparseSGD(), dense, SGD(TRAIN_LR),
                           generator=gen, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    b = W8_BATCH // W8
    batches = [train_batch(torch, CRITEO_1TB_SIZES, b,
                           seed=SEED + 1100 + 16 * k + rank)
               for k in range(4)]
    args = (loss_fn, SGD(TRAIN_LR), SparseSGD())
    kw = dict(lr_schedule=TRAIN_LR, nan_guard=True)
    steps = {"serialized": make_hybrid_train_step(de_s, *args, **kw),
             "pipelined": make_hybrid_train_step(de_p, *args, **kw)}
    out = {"slab_bytes": sum(v.numel() * v.element_size()
                             for v in st.emb_params.values())}
    # g-b1: one checked pipelined step
    zero_counts()
    with pack_checks(torch) as n:
        loss, st = steps["pipelined"](st, *batches[0])
        torch.cuda.synchronize()
    counts = read_counts()
    plan = next(iter(de_p._plan_cache.values()))
    check(plan.b == b // W8G_K, f"world 8 g rank {rank}: the microbatch "
          f"plan's batch {plan.b}")
    serial = w8_per_step(len(plan.groups), len(de_p.widths))
    want = pipelined_per_step(serial)
    check(counts == want, f"world 8 g rank {rank} checked step: launches "
          f"{counts}, expected {want}")
    check(bool(torch.isfinite(loss)), f"world 8 g rank {rank}: loss {loss}")
    out["checked"] = dict(n)
    # g-b2: warmup, then serialized, pipelined, pipelined, serialized
    for k in range(W8_WARMUP):
        for fn in steps.values():
            _, st = fn(st, *batches[k % len(batches)])
    torch.cuda.synchronize()
    runs = {"serialized": [], "pipelined": []}
    launches = {}
    for label in ("serialized", "pipelined", "pipelined", "serialized"):
        zero_counts()
        times = []
        for k in range(W8G_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            _, st = steps[label](st, *batches[k % len(batches)])
            ev[1].record()
            times.append(ev)
        torch.cuda.synchronize()
        runs[label].append(float(np.median([a.elapsed_time(c)
                                            for a, c in times])))
        launches.setdefault(label, read_counts())
    want = {"serialized": {k: v * W8G_STEPS for k, v in serial.items()},
            "pipelined": {k: v * W8G_STEPS for k, v in
                          pipelined_per_step(serial).items()}}
    check(launches == want, f"world 8 g rank {rank} timed: launches "
          f"{launches}, expected {want}")
    out.update(step_ms=runs, launches=launches["pipelined"],
               launches_serialized=launches["serialized"])
    # g-b3: every phase scope timed, serialized then pipelined
    out["phases"] = {}
    for label in ("serialized", "pipelined"):
        st, out["phases"][label] = scoped_steps(torch, steps[label], st,
                                                batches, W8_STAGE_STEPS)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def w8g_results(torch, ranks):
    """14g-a/b's checks across the ranks; returns the paths' launches
    (rank 0's a step of 14g-b pipelined, and of 14g-a the first rank
    holding a streaming table), the K19/K20 checks' largest differences
    and the logged result."""
    small = [r["small_g"] for r in ranks]
    full = [r["full_g"] for r in ranks]
    owner = next(r for r, s in enumerate(small) if s["owns_streaming"])
    b0 = full[0]

    def rate(label):
        return [W8_BATCH / (max(f["step_ms"][label][i] for f in full) / 1e3)
                for i in range(2)]

    def waits(label):
        return {r: {n: v["host_ms"] for n, v in f["phases"][label].items()
                    if n.endswith("_wait") or n in ("step",
                                                    "dense_all_reduce")}
                for r, f in enumerate(full)}

    ser, pipe = rate("serialized"), rate("pipelined")
    result = {
        "transport": "gloo over host memory, 8 ranks time-sharing one "
                     "H100 (not a multi-GPU or NCCL number)",
        "microbatches": W8G_K, "schedule": small[0]["schedule"],
        "small": {"err_by_rank": [s["err"] for s in small],
                  "owns_streaming": [s["owns_streaming"] for s in small],
                  "launches_per_step_owner": {
                      n: v / W8G_SMALL_STEPS for n, v in
                      small[owner]["counts"]["kernels"].items() if v}},
        "full": {
            "samples_per_s_8_ranks_on_one_h100_over_gloo": {
                "serialized_turns_1_4": ser, "pipelined_turns_2_3": pipe},
            "pipelined_over_serialized": float(np.mean(pipe)
                                               / np.mean(ser)),
            "rank_step_ms_p50": {k: [f["step_ms"][k] for f in full]
                                 for k in ("serialized", "pipelined")},
            "launches_per_step_rank0": {
                n: v / W8G_STEPS for n, v in b0["launches"].items() if v},
            "launches_per_step_rank0_serialized": {
                n: v / W8G_STEPS for n, v in
                b0["launches_serialized"].items() if v},
            "phases_rank0": b0["phases"],
            "wait_host_ms_by_rank": {k: waits(k) for k in ("serialized",
                                                           "pipelined")},
            "slab_gb_by_rank": [f["slab_bytes"] / 1e9 for f in full],
            "peak_gb_by_rank": [f["peak_gb"] for f in full]}}
    log("world 8 g: " + json.dumps(result))
    errs = {"pack_ids": 0.0, "pack_columns": 0.0}
    for f in full:
        check(f["checked"]["pack_ids"] == W8G_K
              and f["checked"]["pack_columns"] == 3 * W8G_K,
              f"world 8 g: checked K19/K20 calls {f['checked']}")
        for k, v in f["checked"]["err"].items():
            errs[k] = max(errs[k], v)
    launches = {
        "world8_pipelined": {n: v // W8G_STEPS
                             for n, v in b0["launches"].items()},
        "world8_pipelined_small": {
            n: v // W8G_SMALL_STEPS
            for n, v in small[owner]["counts"]["kernels"].items()}}
    return launches, errs, result


@contextlib.contextmanager
def record_builds():
    """Count the launch records built inside the block, by kind
    (``LaunchCache.add``, wrapped): a step that builds records in its
    steady state pays their validation and descriptors on the host every
    time. Yields ``{kind: builds}``."""
    from distributed_embeddings_torch.ops import _kernels

    real = _kernels.LaunchCache.add
    n = {}

    def add(self, key, record):
        n[record.what] = n.get(record.what, 0) + 1
        return real(self, key, record)

    _kernels.LaunchCache.add = add
    try:
        yield n
    finally:
        _kernels.LaunchCache.add = real


def w1_pipelined(torch, state):
    """14g-c (see main's docstring): the world-1 DLRM step pipelined K = 2
    beside the serialized one on phase 6's state, with the launch records
    built in each timed window and each phase's host and event ms
    (:func:`scoped_steps`). Returns the pipelined step's launches a step
    and the result."""
    from distributed_embeddings_torch.models import DLRMConfig
    from distributed_embeddings_torch.parallel import (
        SGD, DistributedEmbedding, SparseSGD, make_hybrid_train_step)
    from distributed_embeddings_torch.parallel.schedule import (
        pipelined_schedule)

    cfg = DLRMConfig(table_sizes=CRITEO_1TB_SIZES, embedding_dim=128,
                     num_numerical_features=13,
                     bottom_mlp_dims=(512, 256, 128),
                     top_mlp_dims=(1024, 1024, 512, 256, 1),
                     compute_dtype=torch.bfloat16)
    layers = {label: DistributedEmbedding(
        cfg.embedding_configs(), world_size=1, compute_dtype=torch.bfloat16,
        schedule=sched) for label, sched in (
            ("serialized", None), ("pipelined", pipelined_schedule(W8G_K)))}
    st = train_state(torch, state)
    steps = {label: make_hybrid_train_step(
        de, loss_fn, SGD(TRAIN_LR), SparseSGD(), lr_schedule=TRAIN_LR,
        nan_guard=True) for label, de in layers.items()}
    batches = [train_batch(torch, CRITEO_1TB_SIZES, TRAIN_BATCH,
                           seed=SEED + 1200 + k) for k in range(4)]
    for k in range(WARMUP_RUNS):
        for fn in steps.values():
            _, st = fn(st, *batches[k % len(batches)])
    torch.cuda.synchronize()
    runs = {"serialized": [], "pipelined": []}
    launches, builds = {}, {}
    for label in ("serialized", "pipelined", "pipelined", "serialized"):
        zero_counts()
        times, losses = [], []
        with record_builds() as nb:
            for k in range(W1G_STEPS):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                loss, st = steps[label](st, *batches[k % len(batches)])
                ev[1].record()
                times.append(ev)
                losses.append(loss)
            torch.cuda.synchronize()
        check(bool(torch.isfinite(torch.stack(losses)).all()),
              f"world 1 g {label}: non-finite loss")
        runs[label].append(float(np.median([a.elapsed_time(c)
                                            for a, c in times])))
        launches.setdefault(label, read_counts())
        builds.setdefault(label, dict(nb))
    phases = {}
    for label in ("serialized", "pipelined"):
        st, phases[label] = scoped_steps(torch, steps[label], st, batches, 3)
    serial = {n: W1G_STEPS if n in DLRM_KERNELS else 0
              for n in kernel_fns()}
    want = {"serialized": serial, "pipelined": pipelined_per_step(serial)}
    check(launches == want, f"world 1 g: launches {launches}, expected "
          f"{want}")
    result = {"microbatches": W8G_K, "batch": TRAIN_BATCH,
              "step_ms_p50": runs,
              "record_builds_in_timed_steps": builds, "phases": phases,
              "pipelined_over_serialized_ms": float(
                  np.mean(runs["pipelined"]) / np.mean(runs["serialized"])),
              "launches_per_step": {n: v / W1G_STEPS for n, v in
                                    launches["pipelined"].items() if v}}
    log("world 1 g: " + json.dumps(result))
    return {n: v // W1G_STEPS for n, v in launches["pipelined"].items()}, \
        result


def w8_rank(rank, store, tmp, parts=("b", "c", "e", "f", "g")):
    """A rank process of phase 14: join the gloo group (at ``store``) on
    the one card, run 14b, 14c, 14e-b, 14e-c, 14f-a, 14f-b, 14f-c, 14g-a
    and 14g-b (those ``parts`` name), return the results. Any failure
    raises (and fails the phase)."""
    import torch

    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from distributed_embeddings_torch.parallel import bootstrap

    bootstrap.initialize("gloo", store, W8, rank, timeout_s=W8_TIMEOUT_S)
    runs = {"b": (("small", w8_rank_small, True),),
            "c": (("full", w8_rank_full, False),),
            "e": (("small_e", w8e_rank_small, True),
                  ("full_e", w8e_rank_full, False)),
            "f": (("small_f", w8f_rank_small, True),
                  ("full_f", w8f_rank_full, False),
                  ("stream_f", w8f_rank_stream, False)),
            "g": (("small_g", w8g_rank_small, True),
                  ("full_g", w8g_rank_full, False))}
    out = {}
    for part in parts:
        for key, fn, small in runs[part]:
            t0 = time.perf_counter()
            out[key] = fn(torch, rank, tmp) if small else fn(torch, rank)
            out[key]["seconds"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    torch.distributed.destroy_process_group()
    return out


def w8_run_ranks(torch, tmp, parts=("b", "c", "e", "f", "g"), target=None):
    """Start the W8 rank processes (``target``, default :func:`w8_rank`,
    running ``parts`` of phase 14), wait for every result; a rank that
    fails fails the phase. Stops every process it started
    (``bootstrap.spawn_ranks``)."""
    from distributed_embeddings_torch.parallel.bootstrap import spawn_ranks

    t0 = time.perf_counter()
    got = spawn_ranks(target or w8_rank,
                      lambda r, store: (r, store, tmp, parts), W8,
                      W8_TIMEOUT_S, what="chip_smoke: world 8")
    return got, time.perf_counter() - t0


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
        out[run] = w8_run_errors(ref, r0, tmp, f"w8_{run}")
    m, c = out["main"], out["control"]
    check(within_bounds(m), f"world 8 small: beyond the bound of world 1: "
          f"{m}")
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
    # the step's cotangents: K4's contiguous views of one [27, b, 128]
    # buffer
    g27 = torch.randn((27, TRAIN_BATCH, 128), generator=gen, device="cuda"
                      ).to(torch.bfloat16)
    grads = [g27[1 + t] for t in range(len(sizes))]
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
    parent = parent_ops()

    def case(name, label, plan, srcs, dsts, plain, lib, nbytes):
        """``plan``'s copies through this tree's wrapper, the parent's
        (on the same copies) in turns, the plain version and ``lib``."""
        wrap = getattr(xp, name)
        arg = dsts[0] if name == "pack_ids" else dsts
        parent_fn = None
        if parent:
            pp = parent["exchange_pack"].CopyPlan(plan.a.tolist(),
                                                  plan.src_width)
            pwrap = getattr(parent["exchange_pack"], name)

            def parent_fn():
                pwrap(pp, srcs, arg)
        c = kernel_case(torch, name, label, lambda: wrap(plan, srcs, arg),
                        parent_fn, lib, nbytes, plain=plain)
        cases[name].append(c)
        return c

    c = case("pack_ids", "rank0_ids", cp, srcs, [out],
             lambda: xp.pack_ids_plain(cp, srcs, out),
             lambda: torch.cat(parts),
             read + out.numel() * out.element_size())
    c["host_split_us"] = launch_host_split(
        torch, "pack_ids rank0_ids",
        lambda: xp.record_key("pack_ids", srcs, (out,)), cp.launch_cache, (),
        lambda: xp.pack_ids(cp, srcs, out), [*srcs, out])
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
    case("pack_columns", "rank0_cotangent_pack", gp, grads, [packed],
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
    case("pack_columns", "rank0_lookup_rows", lp, flat, [rows_out],
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
    case("pack_columns", "rank0_unpack", up, [dp], [buf],
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
    case("pack_ids", "world1_b65536_ids", cp, srcs, [out],
         lambda: xp.pack_ids_plain(cp, srcs, out),
         lambda: torch.cat([t.reshape(-1) for t in srcs]),
         2 * sum(t.numel() * t.element_size() for t in srcs))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 621)
    # the step's cotangents: K4's contiguous views of one [27, b, 128]
    # buffer, read in place
    g27 = torch.randn((27, TRAIN_BATCH, 128), generator=gen, device="cuda"
                      ).to(torch.bfloat16)
    grads = [g27[1 + t] for t in range(len(CRITEO_1TB_SIZES))]
    gp = exchange._grad_copy_plan(de1, plan, TRAIN_BATCH)
    packed = torch.empty((1, TRAIN_BATCH, plan.s_max), dtype=torch.bfloat16,
                         device=dev)
    case("pack_columns", "world1_b65536_cotangent_pack", gp, grads,
         [packed], lambda: xp.pack_columns_plain(gp, grads, [packed]),
         lambda: torch.cat(grads, dim=1), 2 * packed.numel() * es)
    del grads, g27, packed, srcs, out
    return cases, w1_stage_yardstick(torch)


def _sliced_slots(torch, rng, n, w, dtype, dim=40, k=4):
    """``n`` slots, slot ``s`` the row slice ``s % k`` of one
    ``dim``-row table, on the card: slab, rows, roff, row bases and each
    slot's slice-edge ids (``rbase - 1``, ``rbase``, ``rbase + rows -
    1``, ``rbase + rows``, negative and past the table)."""
    slab = torch.from_numpy(rng.normal(size=(dim, w)).astype(np.float32)
                            ).to(dtype).cuda()
    rows = torch.full((n,), dim // k, dtype=torch.int64, device="cuda")
    rbase = torch.tensor([(s % k) * (dim // k) for s in range(n)],
                         dtype=torch.int64, device="cuda")
    edges = [[rb - 1, rb, rb + dim // k - 1, rb + dim // k, -1, -7, dim,
              dim + 100] for rb in rbase.tolist()]
    return slab, rows, rbase.clone(), rbase, edges


def _edge_csr(torch, rng, n, b, dim, edges, ids_dt, frac=1.0):
    """A CSR id block ``[n, cap + b + cap]`` (values with each slot's
    edge ids first, lengths, float32 weight bits) and its splits, on the
    card; ``frac`` < 1 cuts the capacity below the rows' total."""
    lengths = rng.integers(0, 7, size=(n, b))
    lengths[:, 0] = 8
    splits = np.concatenate([np.zeros((n, 1), np.int64),
                             np.cumsum(lengths, 1)], 1)
    cap = int(splits[:, -1].max() * frac)
    vals = rng.integers(-3, dim + 3, size=(n, cap))
    for s in range(n):
        vals[s, :8] = edges[s]
    w = rng.uniform(0.25, 2.0, size=(n, cap)).astype(np.float32)
    block = np.concatenate([vals, lengths, w.view(np.int32).astype(np.int64)],
                           1)
    block = torch.from_numpy(block).to(ids_dt).cuda()
    return block, cap, torch.from_numpy(splits).cuda()


def _sum_case(torch, k, w, b, unaligned, dtype, seed):
    """A K20 plan summing ``k`` column blocks of a ``[k, b, s]`` source
    (block ``r`` at row ``r``, column ``r * w``) into ``[b, w]``, beside
    a plain copy; the source carries NaN and Inf bits."""
    from distributed_embeddings_torch.ops import exchange_pack as xp

    off = 1 if unaligned else 0
    s = k * w + 4 + off
    plan = xp.CopyPlan([(0, 3, s, 0, b * w, w, b, w)],
                       sums=[(0, 0, w, b, w, [(0, r * b * s + r * w + off, s)
                                              for r in range(k)])])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    src = (torch.randn((k, b, s), generator=gen, device="cuda")
           * torch.logspace(-3, 3, s, device="cuda")).to(dtype)
    flat = src.view(-1)
    flat[::97] = float("nan")
    flat[5::89] = float("inf")
    flat[7::83] = -float("inf")
    return plan, src


def row_slice_kernel_checks(torch):
    """14e-a: K1, K8 and K9 with row bases and K20's summing descriptor
    against their plain versions on the card, bit-exact, and a CUDA-graph
    replay of each new record (see main's docstring). Returns the largest
    difference by mode (0.0: every bit agreed)."""
    from distributed_embeddings_torch.ops import (
        exchange_pack as xp, gather_combine, gather_combine_plain,
        ragged_combine, ragged_combine_plain, ragged_grad, ragged_grad_plain)

    errs = {mode: 0.0 for mode, _, _ in MODE_COUNTS}
    rng = np.random.default_rng(SEED + 800)
    n, b, dim = 8, 70, 40
    mask = torch.tensor([1, 0, 1, 1, 1, 1, 0, 1], dtype=torch.int32,
                        device="cuda")
    mean = torch.tensor([0, 1] * 4, dtype=torch.int32, device="cuda")
    calls = 0
    for dtype in (torch.float32, torch.bfloat16):
        for w in (3, 16, 128):
            slab, rows, roff, rbase, edges = _sliced_slots(torch, rng, n, w,
                                                           dtype)
            div = torch.ones(n, device="cuda")
            g = torch.from_numpy(rng.normal(size=(n, b, w)).astype(
                np.float32)).to(dtype).cuda()
            for ids_dt in (torch.int32, torch.int64):
                ids = rng.integers(-3, dim + 3, size=(n, b, 1))
                for s in range(n):
                    ids[s, :8, 0] = edges[s]
                ids = torch.from_numpy(ids).to(ids_dt).cuda()
                args = (slab, ids, rows, roff, div, mask)
                errs["gather_combine_row_base"] = max(
                    errs["gather_combine_row_base"], bits_err(
                        torch, gather_combine(*args, rbase=rbase),
                        gather_combine_plain(*args, rbase=rbase),
                        f"K1 row bases {dtype} w{w} {ids_dt}"))
                for frac in (1.0, 0.6):
                    block, cap, splits = _edge_csr(torch, rng, n, b, dim,
                                                   edges, ids_dt, frac)
                    values = block[:, :cap]
                    for wts in (None, block[:, cap + b:]):
                        kw = dict(mean=mean, mask=mask, weights=wts,
                                  rbase=rbase)
                        errs["ragged_combine_row_base"] = max(
                            errs["ragged_combine_row_base"], bits_err(
                                torch, ragged_combine(slab, values, splits,
                                                      rows, roff, **kw),
                                ragged_combine_plain(slab, values, splits,
                                                     rows, roff, **kw),
                                f"K8 row bases {dtype} w{w} {ids_dt}"))
                        gkw = dict(values=values, rows=rows, roff=roff,
                                   sentinel=dim + 1, ids_dtype=ids_dt,
                                   mean=mean, weights=wts, rbase=rbase)
                        got = ragged_grad(g, splits, **gkw)
                        want = ragged_grad_plain(g, splits, **gkw)
                        for x, y in zip(got, want):
                            errs["ragged_grad_row_base"] = max(
                                errs["ragged_grad_row_base"], bits_err(
                                    torch, x, y, f"K9 row bases {dtype} "
                                    f"w{w} {ids_dt}"))
                        calls += 2
    for dtype in (torch.float32, torch.bfloat16):
        for k in (2, 4, 8):
            for w, unaligned in ((128, False), (8, False), (7, True)):
                plan, src = _sum_case(torch, k, w, 300, unaligned, dtype,
                                      k + w)
                out = torch.full((600 * w,), 5.0, dtype=dtype, device="cuda")
                want = torch.full_like(out, 5.0)
                xp.pack_columns(plan, [src], [out])
                xp.pack_columns_plain(plan, [src], [want])
                check(bool(torch.isnan(out).any()), "K20 sum: no NaN case")
                errs["pack_columns_sum"] = max(
                    errs["pack_columns_sum"], bits_err(
                        torch, out, want, f"K20 sum k={k} {dtype} w{w}"))
    graphs = row_slice_graph_check(torch)
    log(f"world 8 e a: K1/K8/K9 row bases and K20 sums bit-exact to their "
        f"plain versions ({calls} K8/K9 calls, 18 sums; {graphs} CUDA-graph "
        f"replays bit-exact): {errs}")
    return errs


def row_slice_graph_check(torch):
    """K1, K8 and K9 with row bases and a K20 sum on their records: a
    second call with new inputs of the same layouts builds nothing; a
    capture of the four calls, replayed twice on fresh inputs copied into
    the captured tensors, gives the plain versions' bits. Returns the
    replays checked."""
    import importlib

    from distributed_embeddings_torch.ops import (
        exchange_pack as xp, gather_combine, gather_combine_plain,
        ragged_combine, ragged_combine_plain, ragged_grad, ragged_grad_plain)

    el = importlib.import_module(
        "distributed_embeddings_torch.ops.embedding_lookup")
    sg = importlib.import_module(
        "distributed_embeddings_torch.ops.sparse_grad")
    rng = np.random.default_rng(SEED + 801)
    n, b, w, dim, cap = 8, 64, 16, 40, 320
    slab, rows, roff, rbase, _ = _sliced_slots(torch, rng, n, w,
                                               torch.bfloat16)
    mask = torch.ones(n, dtype=torch.int32, device="cuda")
    div = torch.ones(n, device="cuda")
    mean = torch.tensor([1, 0] * 4, dtype=torch.int32, device="cuda")
    plan, _ = _sum_case(torch, 4, w, b, False, torch.float32, 1)

    def inputs():
        lengths = rng.integers(0, 6, (n, b))
        splits = np.concatenate([np.zeros((n, 1), np.int64),
                                 np.cumsum(lengths, 1)], 1)
        return [torch.from_numpy(x).cuda() for x in (
            rng.integers(-2, dim + 2, size=(n, b, 1)).astype(np.int32),
            splits, rng.integers(-2, dim + 2, (n, cap)).astype(np.int32),
            rng.normal(size=(n, b, w)).astype(np.float32),
            rng.normal(size=(4, b, 4 * w + 4)).astype(np.float32))]

    def calls(ids, splits, values, g, src, out):
        ii, vv = ragged_grad(g, splits, values=values, rows=rows, roff=roff,
                             sentinel=dim, mean=mean, rbase=rbase)
        xp.pack_columns(plan, [src], [out])
        return (gather_combine(slab, ids, rows, roff, div, mask, rbase=rbase),
                ragged_combine(slab, values, splits, rows, roff, mean=mean,
                               mask=mask, rbase=rbase), ii, vv, out)

    def plain(ids, splits, values, g, src):
        out = torch.zeros(2 * b * w, device="cuda")
        xp.pack_columns_plain(plan, [src], [out])
        ii, vv = ragged_grad_plain(g, splits, values=values, rows=rows,
                                   roff=roff, sentinel=dim, mean=mean,
                                   rbase=rbase)
        return (gather_combine_plain(slab, ids, rows, roff, div, mask,
                                     rbase=rbase),
                ragged_combine_plain(slab, values, splits, rows, roff,
                                     mean=mean, mask=mask, rbase=rbase),
                ii, vv, out)

    def same(got, want, what):
        for x, y in zip(got, want):
            bits_err(torch, x, y, what)

    out = torch.zeros(2 * b * w, device="cuda")
    calls(*inputs(), out)
    builds = (el._GATHER.builds, el._RAGGED.builds, sg._K9.builds,
              plan.launch_cache.builds)
    fresh = inputs()
    same(calls(*fresh, out), plain(*fresh), "row-slice records, a hit")
    check((el._GATHER.builds, el._RAGGED.builds, sg._K9.builds,
           plan.launch_cache.builds) == builds,
          "row-slice records: a call of the same layouts built a record")
    ins = [t.clone() for t in inputs()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls(*ins, out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls(*ins, out)
    for k in range(2):
        fresh = inputs()
        for t, f in zip(ins, fresh):
            t.copy_(f)
        graph.replay()
        torch.cuda.synchronize()
        same(outs, plain(*fresh), f"row-slice records, graph replay {k}")
    return 2


def row_slice_kernel_times(torch):
    """14e timing, in this process alone (eight contending ranks would
    distort kernel times): K1 with row bases on each row-sliced group of
    14e-c's rank 0 (its 6.67 GB bf16 slab, a Zipfian model-parallel
    block) and K20's unpack with its sums at that rank's shapes; K8 and K9
    with row bases on a ragged block of 32 slots (8 sources x 4 row
    slices of a 2M-row fp32 table) at b=2048, U{1..30} Zipfian ids a row.
    Each beside its plain version and its byte bound, and K1, K8 and K9
    beside the one PyTorch call that computes their function from
    indices computed before the timing (the ids made range-local, masked
    and offset to slab rows): ``F.embedding_bag`` (sum, the 0/1 mask as
    ``per_sample_weights``) for K1 and K8, ``index_select`` of each
    position's cotangent row for K9. K20's copies and 4-part sums in one
    pass have no one call (``torch.cat`` copies, a sum adds: two)."""
    import torch.nn.functional as F

    from distributed_embeddings_torch.ops import (
        exchange_pack as xp, gather_combine, gather_combine_plain,
        ragged_combine, ragged_combine_plain, ragged_grad, ragged_grad_plain)
    from distributed_embeddings_torch.parallel import exchange
    from distributed_embeddings_torch.utils.data import power_law_ids

    cases = {}
    _, de = w8_model(torch, CRITEO_1TB_SIZES, None, torch.bfloat16,
                     row_slice=W8E_RS, dp_input=False)
    de._rank = 0
    rng = np.random.default_rng(SEED + 810)
    cats = [power_law_ids(rng, v, (W8_BATCH,)).astype(np.int32)
            for v in CRITEO_1TB_SIZES]
    ids_recv, _, b, plan = de._mp_block(de.pack_mp_inputs(cats, rank=0,
                                                          device="cuda"),
                                        "cuda")
    slab = torch.empty((de.rows_cap[128], 128), dtype=torch.bfloat16,
                       device="cuda").uniform_(-0.05, 0.05)
    for gi, g in enumerate(plan.groups):
        rbase = de._plan_rbase(plan, gi, "cuda", reps=W8)
        if rbase is None:
            continue
        meta = de._plan_meta(plan, gi, "cuda", reps=W8)
        ids = ids_recv[:, g.goff:g.goff + g.n * g.blen].reshape(
            W8 * g.n, b, g.hot).contiguous()
        loc = ids.long() - rbase.view(-1, 1, 1)
        inr = (loc >= 0) & (loc < meta[0].view(-1, 1, 1))
        uniq = int(torch.unique((loc + meta[1].view(-1, 1, 1))[inr]).numel())
        nbytes = uniq * 128 * 2 + ids.numel() * 4 + ids.shape[0] * b * 256
        lib_rows = (loc.clamp(min=0).minimum(meta[0].view(-1, 1, 1) - 1)
                    + meta[1].view(-1, 1, 1)).reshape(-1, 1)
        lib_w = inr.to(slab.dtype).reshape(-1, 1)
        cases["gather_combine_row_base"] = kernel_case(
            torch, "gather_combine_row_base", f"world8_rank0_group{gi}",
            lambda: gather_combine(slab, ids, *meta, rbase=rbase), None,
            lambda: F.embedding_bag(lib_rows, slab, mode="sum",
                                    per_sample_weights=lib_w), nbytes,
            plain=lambda: gather_combine_plain(slab, ids, *meta,
                                               rbase=rbase),
            extra={"unique_rows": uniq, "slots": ids.shape[0]})
    del slab
    cplan, pieces = exchange._unpack_copy_plan(de, plan)
    dp = torch.randn((W8, b, plan.s_max), device="cuda").to(torch.bfloat16)
    buf = torch.empty(sum(b * w for _, w in pieces), dtype=torch.bfloat16,
                      device="cuda")
    nbytes = int(sum(r[6] * r[7] * 2 * 2 for r in cplan.a)
                 + sum(p[0, 6] * p[0, 7] * 2 * (len(p) + 1)
                       for p in cplan.sums))
    cases["pack_columns_sum"] = kernel_case(
        torch, "pack_columns_sum", "world8_rank0_unpack",
        lambda: xp.pack_columns(cplan, [dp], [buf]), None, None, nbytes,
        plain=lambda: xp.pack_columns_plain(cplan, [dp], [buf]),
        extra={"sums": len(cplan.sums), "copies": len(cplan.a),
               "parts": [len(p) for p in cplan.sums]})
    del dp, buf
    # K8 / K9: 8 sources x 4 row slices of a 2M-row table
    n, bk, rows_t, k = 32, 2048, 2_000_000, 4
    tab = torch.empty((rows_t, 128), device="cuda").uniform_(-0.05, 0.05)
    rows = torch.full((n,), rows_t // k, dtype=torch.int64, device="cuda")
    rbase = torch.tensor([(s % k) * (rows_t // k) for s in range(n)],
                         dtype=torch.int64, device="cuda")
    roff = rbase.clone()
    lengths = rng.integers(1, 31, size=(n, bk))
    splits = torch.from_numpy(np.concatenate(
        [np.zeros((n, 1), np.int64), np.cumsum(lengths, 1)], 1)).cuda()
    cap = int(lengths.sum(1).max())
    values = torch.from_numpy(power_law_ids(rng, rows_t, (n, cap)).astype(
        np.int32)).cuda()
    mean = torch.zeros(n, dtype=torch.int32, device="cuda")
    mask = torch.ones(n, dtype=torch.int32, device="cuda")
    pos = int(lengths.sum())
    loc = values.long() - rbase.view(-1, 1)
    uniq = int(torch.unique((loc + roff.view(-1, 1))[
        (loc >= 0) & (loc < rows.view(-1, 1))]).numel())
    kw = dict(mean=mean, mask=mask, rbase=rbase)
    # the library calls' inputs: every live position's slab row and 0/1
    # mask, flat, with each row's offset into them (K8), and each
    # position's cotangent row (K9; a dead position reads row 0)
    live = (torch.arange(cap, device="cuda")[None]
            < splits[:, -1:]).reshape(-1)
    lib_rows = (loc.clamp(min=0).minimum(rows.view(-1, 1) - 1)
                + roff.view(-1, 1)).reshape(-1)[live]
    lib_w = ((loc >= 0) & (loc < rows.view(-1, 1))).float().reshape(
        -1)[live]
    lib_off = (splits[:, :-1] + torch.cumsum(splits[:, -1], 0)[:, None]
               - splits[:, -1:]).reshape(-1)
    pos_rows = torch.searchsorted(
        splits[:, 1:].contiguous(),
        torch.arange(cap, device="cuda").expand(n, cap).contiguous(),
        right=True)
    pos_rows = (pos_rows.clamp(max=bk - 1)
                + torch.arange(n, device="cuda")[:, None] * bk).reshape(-1)
    cases["ragged_combine_row_base"] = kernel_case(
        torch, "ragged_combine_row_base", "32_slots_b2048_U1_30",
        lambda: ragged_combine(tab, values, splits, rows, roff, **kw), None,
        lambda: F.embedding_bag(lib_rows, tab, lib_off, mode="sum",
                                per_sample_weights=lib_w),
        uniq * 512 + values.numel() * 4 + splits.numel() * 8
        + n * bk * 512,
        plain=lambda: ragged_combine_plain(tab, values, splits, rows, roff,
                                           **kw),
        extra={"positions": pos, "unique_rows": uniq})
    g = torch.randn((n, bk, 128), device="cuda")
    gkw = dict(values=values, rows=rows, roff=roff, sentinel=rows_t,
               rbase=rbase)
    g2 = g.view(n * bk, 128)
    cases["ragged_grad_row_base"] = kernel_case(
        torch, "ragged_grad_row_base", "32_slots_b2048_U1_30",
        lambda: ragged_grad(g, splits, **gkw), None,
        lambda: torch.index_select(g2, 0, pos_rows),
        g.numel() * 4 + values.numel() * 4 + splits.numel() * 8
        + n * cap * (512 + 4),
        plain=lambda: ragged_grad_plain(g, splits, **gkw),
        extra={"positions": pos})
    del tab, g, g2, lib_rows, lib_w, lib_off, pos_rows
    gc.collect()
    torch.cuda.empty_cache()
    return cases


def row_slice_results(torch, ranks, rs_errs, rs_cases, small_e):
    """14e-c's checks across the ranks and 14e-d (the dryrun twin at
    world 8 on the card); returns the row-slice modes' launches by path
    (``world8_rowslice``: rank 0's timed window of 14e-c; ``dryrun``:
    rank 0's dryrun step), their cases and differences, and the log's
    result."""
    from distributed_embeddings_torch.dryrun import dryrun_multichip

    full = [r["full_e"] for r in ranks]
    r0 = full[0]
    check(r0["row_sliced"] and not r0["column_sliced"], "world 8 e full: "
          f"row-sliced tables {r0['row_sliced']}, column-sliced ranges "
          f"{r0['column_sliced']}")
    for r, f in enumerate(full):
        check(f["losses"] == r0["losses"], f"world 8 e: rank {r}'s losses "
              "differ from rank 0's (one global mean)")
        for k, v in f["checked"]["err"].items():
            check(v == 0.0, f"world 8 e rank {r}: {k} differs from plain")
        for k, v in f["row_base_checked"]["err"].items():
            rs_errs["gather_combine_row_base"] = max(
                rs_errs["gather_combine_row_base"], v)
    t0 = time.perf_counter()
    dry = dryrun_multichip(W8, device="cuda")
    dry_s = time.perf_counter() - t0
    dl = dry["launches"]
    check(np.isfinite(dry["loss"]) and dry["row_sliced_tables"]
          and dry["sliced_out_ranges"], f"dryrun: loss {dry['loss']}, "
          f"slicing {dry['row_sliced_tables']} {dry['sliced_out_ranges']}")
    for mode, _, _ in MODE_COUNTS:
        check(dl[mode] > 0, f"dryrun: {mode} launched no time ({dl})")
    wall = max(f["wall_s"] for f in full)
    result = {
        "world": W8, "global_batch": W8_BATCH, "steps": W8E_STEPS,
        "input": "model-parallel (pack_mp_inputs), row_slice 1.4e9",
        "transport": "gloo over host memory, 8 ranks time-sharing one "
                     "H100 (not a multi-GPU or NCCL number)",
        "samples_per_s_8_ranks_on_one_h100_over_gloo":
            W8E_STEPS * W8_BATCH / wall,
        "wall_step_ms": wall / W8E_STEPS * 1e3,
        "rank_step_ms_p50": [float(np.median(f["step_ms"])) for f in full],
        "stage_ms_p50_by_rank": [f["stages"] for f in full],
        "slab_gb_by_rank": [f["slab_bytes"] / 1e9 for f in full],
        "peak_gb_by_rank": [f["peak_gb"] for f in full],
        "pack_ms_a_batch_by_rank": [f["pack_ms_a_batch"] for f in full],
        "row_sliced": r0["row_sliced"], "plan": r0["plan"],
        "launches_per_step_rank0": {
            n: v / W8E_STEPS for n, v in {**r0["launches"],
                                         **r0["modes"]}.items() if v},
        "scatter_max_err": max(f["scatter_err"] for f in full),
        "loss_first": r0["losses"][0], "loss_last": r0["losses"][-1],
        "small": small_e, "kernel_errs": rs_errs,
        "dryrun": {"loss": dry["loss"], "launches": dl, "seconds": dry_s,
                   "row_sliced_tables": dry["row_sliced_tables"],
                   "sliced_out_ranges": dry["sliced_out_ranges"]}}
    log("world 8 e: " + json.dumps(result))
    return {"launches": {"world8_rowslice": r0["launches"], "dryrun": dl},
            "modes": {"world8_rowslice": r0["modes"],
                      "dryrun": {m: dl[m] for m, _, _ in MODE_COUNTS}},
            "errs": rs_errs, "cases": rs_cases, "result": result}


def phase_world8(torch):
    """Phase 14: the hybrid train step at world 8 on one card (see
    main's docstring). Returns (launches of rank 0's timed window, the
    K19/K20 rows' cases, the largest kernel-vs-plain difference each of
    K19/K20 showed in the phase's checks, the result, and 14e's rows:
    launches by path and mode, cases and differences of the row-slice
    modes)."""
    import shutil
    import tempfile

    t_start = time.perf_counter()
    edge = pack_edge_checks(torch)
    errs = dict(edge["err"])
    for k, v in w8_shape_checks(torch).items():
        errs[k] = max(errs[k], v)
    rs_errs = row_slice_kernel_checks(torch)
    cases, w1_stages = pack_kernel_times(torch)
    rs_cases = row_slice_kernel_times(torch)
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
    log("world 8 f: memory reckoned before the ranks start: "
        + json.dumps(w8f_reckon(torch)))
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
        small_e = w8e_compare_small(torch, ref, ranks, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("world 8 b: " + json.dumps(small))
    log("world 8 e b: " + json.dumps(small_e))
    errs["pack_columns"] = max(errs["pack_columns"],
                               small_e["err"]["pack_columns"])
    rs_errs["gather_combine_row_base"] = max(
        rs_errs["gather_combine_row_base"], small_e["err"]["gather_combine"])
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
                         "small_e": [r["small_e"]["seconds"] for r in ranks],
                         "full_e": [r["full_e"]["seconds"] for r in ranks],
                         "ranks_total": rank_s}}
    log("world 8: " + json.dumps(result))
    rs = row_slice_results(torch, ranks, rs_errs, rs_cases, small_e)
    result["row_slice"] = rs["result"]
    f_launches, f_errs, result["instrumented"] = w8f_results(torch, ranks)
    rs["launches"].update(f_launches)
    rs["errs_f"] = f_errs
    rs["result_f"] = result["instrumented"]
    g_launches, g_errs, result["pipelined"] = w8g_results(torch, ranks)
    rs["launches"].update(g_launches)
    for k, v in g_errs.items():
        errs[k] = max(errs[k], v)
    result["rank_seconds"].update(
        {k: [r[k]["seconds"] for r in ranks]
         for k in ("small_f", "full_f", "stream_f", "small_g", "full_g")})
    result["phase_seconds"] = time.perf_counter() - t_start
    log(f"world 8 phase {result['phase_seconds']:.1f} s")
    return r0["launches"], cases, errs, result, rs


def phase_world8_f_only(torch):
    """Phase 14f alone (``--world8f``): 14b's small tables and dense
    parameters written for the ranks (and 14b's world-1 run), then the
    rank processes run 14f only; its checks and result."""
    import shutil
    import tempfile

    log("world 8 f: memory reckoned before the ranks start: "
        + json.dumps(w8f_reckon(torch)))
    tmp = tempfile.mkdtemp(prefix="w8f_")
    try:
        w8_small_reference(torch, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        ranks, rank_s = w8_run_ranks(torch, tmp, parts=("f",))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches, _, _ = w8f_results(torch, ranks)
    log(f"world 8 f only: ranks {rank_s:.1f} s, seconds by run "
        + json.dumps({k: [r[k]["seconds"] for r in ranks]
                      for k in ("small_f", "full_f", "stream_f")})
        + " launches " + json.dumps(launches))


def phase_world8_g_only(torch):
    """Phase 14g-a/b alone (``--world8g``): 14b's small tables and dense
    parameters written for the ranks (and 14b's world-1 run), then the
    rank processes run 14g only; its checks and result."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="w8g_")
    try:
        w8_small_reference(torch, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        ranks, rank_s = w8_run_ranks(torch, tmp, parts=("g",))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches, _, _ = w8g_results(torch, ranks)
    log(f"world 8 g only: ranks {rank_s:.1f} s, seconds by run "
        + json.dumps({k: [r[k]["seconds"] for r in ranks]
                      for k in ("small_g", "full_g")})
        + " launches " + json.dumps(launches))


# ------------------------------------------- the example at world 8 (14h)

W8H_SMALL_BATCH = 4096         # 14h-a: 14b's global batch
W8H_SMALL_STEPS = 6
W8H_SMALL_SAVE_AT = 3
W8H_SMALL_LR = 240.0           # the schedule's warmup gives 0.03-0.18
W8H_STEPS = 40                 # 14h-b: 13c's runs, at world 8
W8H_SAVE_AT = 20
W8H_CONV_STEPS = 240           # 14h-c: tests/test_convergence.py's run
W8H_DEV = "cuda"               # where 14h's example and driver run
#: 14h-a's bounds, the card's run (kernels) against the CPU's (plain
#: versions): 14b's loss and dense bounds; each bf16 slab element within
#: one bf16 ulp of its magnitude or 14b's 1e-6 (``slab_over``: the
#: elements outside that, which must be none); and the relative L2 of
#: the slabs' update, ``|card - cpu| / |cpu - start|`` (``slab_rel_err``).
#: 14b's 1e-3 for it is an fp32 bound: in bf16 the steps move a touched
#: element by one ulp or a few, so one last bit rounded the other way
#: (an f32 sum that differs in its 7th digit) is of the update's own
#: size. The bound sits between the sound run's largest reading (0.081
#: by rank on one H100) and the controls' smallest, each on every rank:
#: the state before the steps (the rank's update dropped: 1.0) and half
#: of the CPU run's update rounded to bf16 (a kernel that applies half
#: of it: ~0.5). A larger lr moves more elements (``slab_moved``) but
#: parts the card's run from the CPU's past 14b's loss and dense bounds
#: (bf16 last bits rounded the other way on hot rows feed the MLPs: at
#: 1200 and 2400 the dense parameters part by 7e-5 and 3e-4)
W8H_BOUNDS = {"loss_err": 1e-5, "dense_err": 1e-5, "slab_over": 0,
              "slab_rel_err": 0.2}
#: the controls, each held beyond ``slab_rel_err`` on every rank
W8H_CONTROLS = ("control_start_rel", "control_half_rel")
#: the kernels 14h-a's example runs a step on every rank (bf16 tables
#: under the schedule: K18, not K3; data-parallel input: K19; telemetry:
#: K13, K14's pool and K15 in the width's fold)
W8H_KERNELS = ("gather_combine", "dot_interact_fwd", "dot_interact_bwd",
               "sgd_scatter_promoted", "pack_ids", "pack_columns",
               "grad_health", "dense_update", "cms_update", "topk_pool",
               "topk_merge")


def w8h_main(argv, rank, dev=W8H_DEV):
    """``examples/dlrm_main.py``'s ``main`` as rank ``rank`` of the
    group this process has joined, on ``dev``."""
    from distributed_embeddings_torch.examples import dlrm_main

    return dlrm_main.main(list(argv) + [
        "--world_size", str(W8), "--rank", str(rank), "--backend", "gloo",
        "--device", dev])


def w8h_small_args(tmp):
    """14h-a's command line: 14b's small tables, row-sliced as 14e-b's,
    bf16, data-parallel input, b=4096 global."""
    return ["--table_sizes", ",".join(map(str, w8_small_sizes())),
            "--batch_size", str(W8H_SMALL_BATCH),
            "--learning_rate", str(W8H_SMALL_LR),
            "--param_dtype", "bfloat16", "--row_slice", str(W8E_SMALL_RS),
            "--dp_input", "--eval_batches", "1",
            "--checkpoint_out", os.path.join(tmp, "w8h_small_dump")]


def w8h_slab_errs(torch, got, want, start):
    """This rank's bf16 slabs of the card run against the CPU run's:
    the largest difference in bf16 ulps (bits as ordered integers), the
    largest absolute difference, the elements the update moved
    (``want != start``), and the relative L2 of the update
    (``|got - want| / |want - start|``)."""
    ulps, over, moved, abs_err, num, den = 0, 0, 0, 0.0, 0.0, 0.0
    for k, w in want.items():
        g = got[k].cpu()

        def ordered(t):
            b = t.view(torch.int16).to(torch.int32)
            return torch.where(b < 0, -(b & 0x7FFF), b)

        ulps = max(ulps, int((ordered(g) - ordered(w)).abs().max()))
        d = g.double() - w.double()
        mag = torch.maximum(g.double().abs(), w.double().abs())
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
        over += int((d.abs() > torch.maximum(ulp, torch.full_like(
            ulp, 1e-6))).sum())
        abs_err = max(abs_err, float(d.abs().max()))
        num += float((d * d).sum())
        u = w.double() - start[k].double()
        den += float((u * u).sum())
        moved += int((u != 0).sum())
    return {"slab_over": over, "slab_ulps": ulps, "slab_max_err": abs_err,
            "slab_moved": moved,
            "slab_rel_err": (num / den) ** 0.5 if den else 0.0,
            "update_norm": den ** 0.5}


def w8h_rank_small(torch, rank, tmp, dev=W8H_DEV):
    """14h-a on one rank: the example from one saved state at step 0 on
    the card (6 steps, launches counted), as 3 steps + save + a resume to
    6 (bitwise equal), and on the CPU (the plain versions), with
    telemetry on."""
    args = w8h_small_args(tmp)
    s0 = os.path.join(tmp, "w8h_small_s0")
    s3 = os.path.join(tmp, "w8h_small_s3")
    os.environ["DETPU_TELEMETRY"] = "1"
    try:
        w8h_main(args + ["--num_batches", "0", "--save_state", s0], rank,
                 dev)
        zero_counts()
        full = w8h_main(args + ["--num_batches", str(W8H_SMALL_STEPS),
                                "--restore_state", s0], rank, dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        counts = read_counts()
        modes = read_mode_counts()
        first = w8h_main(args + ["--num_batches", str(W8H_SMALL_SAVE_AT),
                                 "--restore_state", s0, "--save_state", s3],
                         rank, dev)
        rest = w8h_main(args + ["--num_batches", str(W8H_SMALL_STEPS),
                                "--restore_state", s3], rank, dev)
        check(first.losses + rest.losses == full.losses,
              f"14h-a rank {rank}: resumed losses differ")
        example_state_equal(torch, full.state, rest.state,
                            f"14h-a rank {rank} resumed at step "
                            f"{W8H_SMALL_SAVE_AT}")
        del first, rest
        start = w8h_main(args + ["--num_batches", "0", "--restore_state",
                                 s0], rank, "cpu")
        plain = w8h_main(args + ["--num_batches", str(W8H_SMALL_STEPS),
                                 "--restore_state", s0], rank, "cpu")
    finally:
        os.environ.pop("DETPU_TELEMETRY", None)
    errs = w8h_slab_errs(torch, full.state.emb_params,
                         plain.state.emb_params, start.state.emb_params)
    # the controls (W8H_BOUNDS): the state before the steps, and half of
    # the plain run's update
    s0, p6 = start.state.emb_params, plain.state.emb_params
    half = {k: (s0[k].double() + (v.double() - s0[k].double()) / 2)
            .to(v.dtype) for k, v in p6.items()}
    for name, got in (("start", s0), ("half", half)):
        e = w8h_slab_errs(torch, got, p6, s0)
        errs[f"control_{name}_rel"] = e["slab_rel_err"]
        errs[f"control_{name}_over"] = e["slab_over"]
    errs["loss_err"] = float(np.abs(np.array(full.losses)
                                    - np.array(plain.losses)).max())
    errs["dense_err"] = max(
        float((p.detach().cpu().double() - q.detach().double()).abs().max())
        for p, q in zip(full.state.dense_params.parameters(),
                        plain.state.dense_params.parameters()))
    return {"losses": full.losses, "plain_losses": plain.losses,
            "auc": full.auc, "plain_auc": plain.auc, "counts": counts,
            "modes": modes, "errs": errs}


def w8h_full_args(tmp, name):
    """14h-b's command line: 13c's (the capped Kaggle vocabularies, the
    example's width, MLPs, b=65,536 and lr 24, bf16, eval every 20), at
    world 8 with model-parallel input (the example's default there)."""
    return example_args(tmp, ragged_sizes())[:-1] + [
        os.path.join(tmp, name)]


def w8h_rank_full(torch, rank, tmp, dev=W8H_DEV):
    """14h-b on one rank: run A (40 steps, ``--metrics_out`` every 10),
    run B (20 steps and ``--save_state``), run C (restored from B to 40):
    C's losses and this rank's slabs, dense parameters and schedule
    count bitwise A's."""
    ck = os.path.join(tmp, "w8h_state")
    t0 = time.perf_counter()
    a = w8h_main(w8h_full_args(tmp, "w8h_dump") + [
        "--num_batches", str(W8H_STEPS), "--metrics_out",
        os.path.join(tmp, "w8h_metrics.jsonl"), "--metrics_interval", "10"],
        rank, dev)
    run_a_s = time.perf_counter() - t0
    b = w8h_main(w8h_full_args(tmp, "w8h_dump_b") + [
        "--num_batches", str(W8H_SAVE_AT), "--save_state", ck], rank, dev)
    ck_bytes = dir_bytes(ck) if rank == 0 else None
    b_losses, save_s = b.losses, b.save_s[-1]
    del b
    gc.collect()
    c = w8h_main(w8h_full_args(tmp, "w8h_dump") + [
        "--num_batches", str(W8H_STEPS), "--restore_state", ck], rank, dev)
    check(b_losses + c.losses == a.losses,
          f"14h-b rank {rank}: resumed losses differ")
    example_state_equal(torch, a.state, c.state,
                        f"14h-b rank {rank} resumed at step {W8H_SAVE_AT}")
    timed = a.step_s[EXAMPLE_WARMUP:]
    slab_bytes = sum(v.numel() * v.element_size()
                     for v in a.state.emb_params.values())
    transfer = w8h_transfer_s(torch, c)
    return {"losses": a.losses, "auc": a.auc, "step_s": a.step_s,
            "transfer_s": transfer,
            "step_ms_p50": float(np.median(timed)) * 1e3,
            "loop_s": a.loop_s, "run_a_s": run_a_s, "save_s": save_s,
            "restore_s": c.restore_s, "checkpoint_bytes": ck_bytes,
            "slab_bytes": slab_bytes}


def w8h_transfer_s(torch, run):
    """Host seconds of moving the largest table of ``run``'s final
    state to the host: to rank 0 alone (``get_table(all_ranks=False)``,
    what a chief-written save does) and broadcast to every rank
    (``all_ranks=True``), each between barriers, in turns (chief,
    broadcast, broadcast, chief)."""
    from distributed_embeddings_torch.parallel import bootstrap

    de = run.de
    tid = int(np.argmax([c["input_dim"] for c in
                         de.strategy.global_configs]))
    out = {"table": tid, "chief": [], "broadcast": []}
    for mode in ("chief", "broadcast", "broadcast", "chief"):
        bootstrap.barrier(de.process_group)
        t0 = time.perf_counter()
        de.get_table(run.state.emb_params, tid,
                     all_ranks=mode == "broadcast")
        bootstrap.barrier(de.process_group)
        out[mode].append(time.perf_counter() - t0)
    return out


def w8h_rank_conv(torch, rank, dev=W8H_DEV):
    """14h-c on one rank: ``train_dlrm_convergence`` at world 8, the JAX
    learning test's configuration uncut."""
    from distributed_embeddings_torch.models import (
        LearnableClicks, train_dlrm_convergence, warmup_poly_decay_schedule)

    t0 = time.perf_counter()
    aucs = train_dlrm_convergence(
        LearnableClicks([200] * 8, num_numerical=4, seed=123, scale=1.2),
        world_size=W8, steps=W8H_CONV_STEPS, batch=1024, embedding_dim=8,
        lr_schedule=warmup_poly_decay_schedule(*CONV_SCHEDULE),
        eval_n=8192, device=dev)
    return {"aucs": list(aucs), "wall_s": time.perf_counter() - t0}


def w8h_rank(rank, store, tmp, parts=("a", "b", "c")):
    """A rank process of phase 14h: join the gloo group (at ``store``) on
    the one card, run 14h-a, 14h-b and 14h-c (those ``parts`` name),
    return the results. Any failure raises (and fails the phase)."""
    import torch

    if W8H_DEV == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from distributed_embeddings_torch.parallel import bootstrap

    bootstrap.initialize("gloo", store, W8, rank, timeout_s=W8_TIMEOUT_S)
    runs = {"a": lambda: w8h_rank_small(torch, rank, tmp),
            "b": lambda: w8h_rank_full(torch, rank, tmp),
            "c": lambda: w8h_rank_conv(torch, rank)}
    out = {}
    for part in parts:
        t0 = time.perf_counter()
        out[part] = runs[part]()
        out[part]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    return out


def w8h_dumps_equal(a, b):
    """Two ``--checkpoint_out`` dumps hold the same tables bit for bit
    (member by member); returns the table count."""
    with np.load(a) as za, np.load(b) as zb:
        check(sorted(za.files) == sorted(zb.files),
              f"dumps {a} and {b} hold other tables")
        for k in za.files:
            x, y = za[k], zb[k]
            check(x.dtype == y.dtype and x.shape == y.shape
                  and x.tobytes() == y.tobytes(),
                  f"dump table {k}: the world-1 restore differs from the "
                  "world-8 dump")
        return len(za.files)


def w8h_reshard_world1(torch, tmp, dev=W8H_DEV):
    """14h-b's last step in the main process: run B's world-8 checkpoint
    restored by the example at world 1 under ``DETPU_ON_MISMATCH=
    reshard`` (no step left to take), its dump bitwise the world-8 dump
    of step 20."""
    from distributed_embeddings_torch.examples import dlrm_main

    os.environ["DETPU_ON_MISMATCH"] = "reshard"
    try:
        w1 = dlrm_main.main(w8h_full_args(tmp, "w8h_dump_w1") + [
            "--num_batches", str(W8H_SAVE_AT), "--eval_batches", "0",
            "--restore_state", os.path.join(tmp, "w8h_state"),
            "--device", dev])
    finally:
        os.environ.pop("DETPU_ON_MISMATCH", None)
    check(int(w1.state.step) == W8H_SAVE_AT and w1.steps_run == 0,
          f"14h-b world-1 restore at step {int(w1.state.step)}")
    restore_s = w1.restore_s
    del w1
    gc.collect()
    n = w8h_dumps_equal(os.path.join(tmp, "w8h_dump_b.npz"),
                        os.path.join(tmp, "w8h_dump_w1.npz"))
    return {"restore_s_world1": restore_s, "tables_bitwise": n}


def phase_world8_h(torch, dev=W8H_DEV):
    """Phase 14h: the DLRM example, its checkpoints and the convergence
    driver at world 8 (see main's docstring). Returns (rank 0's launches
    of 14h-a's 6 steps, the same by row-slice mode, the result)."""
    import shutil
    import tempfile

    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="w8h_")
    try:
        ranks, rank_s = w8_run_ranks(torch, tmp, ("a", "b", "c"), w8h_rank)
        reshard = w8h_reshard_world1(torch, tmp, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    small = [r["a"] for r in ranks]
    full = [r["b"] for r in ranks]
    conv = [r["c"] for r in ranks]
    steps = W8H_SMALL_STEPS
    log("world 8 h a: card against the CPU by rank " + json.dumps(
        [s["errs"] for s in small]))
    log("world 8 h seconds by part and rank: " + json.dumps(
        {p: [r[p]["seconds"] for r in ranks] for p in ("a", "b", "c")}))
    for r, s in enumerate(small):
        check(s["losses"] == small[0]["losses"] and
              s["auc"] == small[0]["auc"],
              f"14h-a rank {r}: losses or AUC differ from rank 0's")
        for k, bound in W8H_BOUNDS.items():
            check(s["errs"][k] <= bound, f"14h-a rank {r}: {k} "
                  f"{s['errs'][k]} > {bound} (card against the CPU)")
        for name in W8H_CONTROLS:
            check(s["errs"][name] > W8H_BOUNDS["slab_rel_err"],
                  f"14h-a rank {r}: the control {name} "
                  f"{s['errs'][name]} passes the slab bound")
        if dev != "cuda":  # the plain versions count no launch
            continue
        c = s["counts"]
        for name in W8H_KERNELS:
            check(c[name] >= steps, f"14h-a rank {r}: {name} launched "
                  f"{c[name]} times in {steps} steps")
        check(c["sgd_scatter_promoted"] == steps
              and c["dot_interact_bwd"] == steps
              and c["dense_update"] == steps
              and c["grad_health"] == 2 * steps
              and c["sgd_scatter"] == 0,
              f"14h-a rank {r}: launches {c}")
    for r, f in enumerate(full):
        check(f["losses"] == full[0]["losses"],
              f"14h-b rank {r}: losses differ from rank 0's")
        check(np.isfinite(f["losses"]).all(), f"14h-b rank {r}: losses")
    for r, c in enumerate(conv):
        a0, mid, end = c["aucs"]
        check(c["aucs"] == conv[0]["aucs"],
              f"14h-c rank {r}: AUCs differ from rank 0's")
        check(end > 0.82 and a0 < mid < end,
              f"14h-c: AUC start/mid/end {c['aucs']} misses the JAX "
              "learning test's limits (end > 0.82, rising)")
    f0 = full[0]
    wall = max(f["loop_s"] for f in full)
    result = {
        "transport": "gloo over host memory, 8 ranks time-sharing one "
                     "H100 (not a multi-GPU or NCCL number)",
        "a": {"bounds": W8H_BOUNDS,
              "errs_max": {k: max(s["errs"][k] for s in small)
                           for k in small[0]["errs"]},
              "losses": small[0]["losses"],
              "plain_losses": small[0]["plain_losses"],
              "auc": small[0]["auc"], "plain_auc": small[0]["plain_auc"],
              "launches_rank0_6_steps_and_eval": {
                  n: v for n, v in small[0]["counts"].items() if v},
              "row_slice_modes_rank0": small[0]["modes"],
              "resume_bitwise": True},
        "b": {"global_batch": TRAIN_BATCH, "steps": W8H_STEPS,
              "step_ms_p50_by_rank": [f["step_ms_p50"] for f in full],
              "samples_per_s_step": TRAIN_BATCH / (f0["step_ms_p50"] / 1e3),
              "samples_per_s_loop": TRAIN_BATCH * W8H_STEPS / wall,
              "loop_s_max": wall, "run_a_s": f0["run_a_s"],
              "save_s": f0["save_s"],
              "restore_s_by_rank": [f["restore_s"] for f in full],
              "checkpoint_bytes": f0["checkpoint_bytes"],
              "largest_table_to_host_s": f0["transfer_s"],
              "slab_bytes_by_rank": [f["slab_bytes"] for f in full],
              "loss_first": f0["losses"][0], "loss_last": f0["losses"][-1],
              "auc": f0["auc"], "resume_bitwise": True, **reshard},
        "c": {"aucs": conv[0]["aucs"],
              "wall_s_by_rank": [c["wall_s"] for c in conv]},
        "rank_seconds": {p: [r[p]["seconds"] for r in ranks]
                         for p in ("a", "b", "c")},
        "ranks_total_s": rank_s}
    result["phase_seconds"] = time.perf_counter() - t_start
    log("world 8 h: " + json.dumps(result))
    return small[0]["counts"], small[0]["modes"], result


def phase_world8_h_only(torch):
    """Phase 14h alone (``--world8h``): its checks and result."""
    launches, _, _ = phase_world8_h(torch)
    log("world 8 h only: launches " + json.dumps(launches))


def main():
    global PARENT_DIR
    try:
        import torch
    except ImportError as e:
        raise SystemExit(f"chip_smoke: PyTorch is not installed ({e})")
    argv = sys.argv[1:]
    only_f = argv == ["--world8f"]
    only_g = argv == ["--world8g"]
    only_h = argv == ["--world8h"]
    if len(argv) == 2 and argv[0] == "--parent":
        PARENT_DIR = os.path.abspath(argv[1])
    elif argv and not (only_f or only_g or only_h):
        raise SystemExit("usage: python3 chip_smoke.py [--parent DIR | "
                         "--world8f | --world8g | --world8h]")
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
    if only_f:  # phase 14f alone, to debug it; prints no result
        phase_world8_f_only(torch)
        return
    if only_g:  # phase 14g-a/b alone, to debug it; prints no result
        phase_world8_g_only(torch)
        return
    if only_h:  # phase 14h alone, to debug it; prints no result
        phase_world8_h_only(torch)
        return
    _, de, state = phase_model(torch)
    errs = phase_check(torch, de, state)
    serve_launches, _ = phase_serve(torch, de, state)
    train_launches, train_errs, _, epi_cases = phase_train(torch, de, state)
    for k, v in train_errs.items():
        errs[k] = max(errs.get(k, 0.0), v)
    launches = {"serve": serve_launches, "train": train_launches}
    # 14g-c: the world-1 DLRM step pipelined, on phase 6's state (before
    # phase 7's lr-24 step of the promoted scatter leaves it diverged)
    launches["world1_pipelined"], _ = w1_pipelined(torch, state)
    kernels = phase_time(torch, de, state, errs, launches)
    for name, src, repl, entry_points in (
            ("grad_health", "grad_health.cu",
             "distributed_embeddings_tpu/parallel/trainer.py:60",
             {"_sq_sum": "distributed_embeddings_tpu/parallel/trainer.py:60",
              "_table_sentinels": "distributed_embeddings_tpu/parallel/"
                                  "trainer.py:67",
              "_finish_metrics": "distributed_embeddings_tpu/parallel/"
                                 "trainer.py:217"}),
            ("dense_update", "dense_update.cu",
             "distributed_embeddings_tpu/parallel/trainer.py:180",
             {"_apply_dense_and_assemble": "distributed_embeddings_tpu/"
                                           "parallel/trainer.py:180"})):
        c = epi_cases[name][0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"distributed_embeddings_torch/csrc/{src}",
            "replaces": repl, "launches": train_launches[name],
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": errs[name], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["case"], "cases": epi_cases[name],
            "entry_points": entry_points})
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
    # the dense-apply regime's slab-wide chain (eps = 0 over a zero
    # accumulator): the path K7 runs on
    launches["zoo_slab_wide"] = zoo.pop("slab_wide_launches")
    for k in kernels:
        for p in ("zoo", "zoo_slab_wide"):
            k["launches_by_path"][p] = launches[p][k["name"]]
        k["max_abs_err"] = max(k["max_abs_err"], zoo_errs.get(k["name"], 0.0))
        if k["name"] in zoo_cases:
            k["cases"].append(zoo_cases[k["name"]])
    for name, src, repl, path in (
            ("dedup_sparse_grad", "dedup.cu",
             "distributed_embeddings_tpu/ops/sparse_grad.py:58", "zoo"),
            ("adagrad_rows", "adagrad.cu",
             "distributed_embeddings_tpu/parallel/optimizers.py:214", "zoo"),
            ("adagrad_dense_scatter", "sgd_scatter.cu",
             "distributed_embeddings_tpu/parallel/optimizers.py:197", "zoo"),
            ("adagrad_dense", "adagrad.cu",
             "distributed_embeddings_tpu/parallel/optimizers.py:203",
             "zoo_slab_wide")):
        c = zoo_cases[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"distributed_embeddings_torch/csrc/{src}",
            "replaces": repl, "launches": launches[path][name],
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": zoo_errs[name], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["case"],
            "cases": [c] + ([zoo_cases["adagrad_rows_bf16"]]
                            if name == "adagrad_rows" else [])})
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
        if k["name"] == "dense_update":
            k["cases"] += adam_cases["dense_update"]
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
    for k in kernels:
        if k["name"] in ("dedup_sparse_grad", "adagrad_rows"):
            k["cases"].append(st_cases[k["name"]])
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
                 "sgd_scatter_promoted", "grad_health", "dense_update"):
        check(launches["example"][name] > 0,
              f"{name}: no launch on the example's path")
    log("example: " + json.dumps(example))
    log(f"example peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} "
        f"GB, {time.perf_counter() - t_start:.1f} s so far")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    w8_launches, w8_cases, w8_errs, world8, rs = phase_world8(torch)
    launches["world8"] = w8_launches
    for k in kernels:
        names = (csr_names if k["name"] == "csr" else k14 if k["name"] ==
                 "cms_query" else (k["name"],))
        k["launches_by_path"]["world8"] = sum(w8_launches[n] for n in names)
        for p, got in rs["launches"].items():
            k["launches_by_path"][p] = sum(got.get(n, 0) for n in names)
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
        if k["name"] in ("pack_ids", "pack_columns"):
            for p, got in rs["launches"].items():
                k["launches_by_path"][p] = got.get(k["name"], 0)
    # the row-slice modes (14e): their launches where the path runs them
    for mode, src, repl, path in (
            ("gather_combine_row_base", "gather_combine.cu",
             "distributed_embeddings_tpu/parallel/lookup.py:167",
             "world8_rowslice"),
            ("ragged_combine_row_base", "ragged_combine.cu",
             "distributed_embeddings_tpu/parallel/lookup.py:55", "dryrun"),
            ("ragged_grad_row_base", "ragged_grad.cu",
             "distributed_embeddings_tpu/parallel/apply.py:222", "dryrun"),
            ("pack_columns_sum", "exchange_pack.cu",
             "distributed_embeddings_tpu/parallel/dist_embedding.py:1093",
             "world8_rowslice")):
        c = rs["cases"][mode]
        kernels.append({
            "name": mode, "route": "cuda",
            "source": f"distributed_embeddings_torch/csrc/{src}",
            "replaces": repl, "launches": rs["modes"][path][mode],
            "launches_by_path": {p: m[mode] for p, m in rs["modes"].items()},
            "max_abs_err": rs["errs"][mode], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["case"], "cases": [c]})
    # 14f: K13-K17 and K21 on each rank's own stream and state at world 8
    f = rs["result_f"]
    f_names = {"cms_update": ("cms_update",),
               "cms_query": k14, "topk_merge": ("topk_merge",),
               "remap_stage": ("remap_stage",),
               "commit_rows": ("commit_rows",),
               "grad_health": ("grad_health",)}
    for k in kernels:
        if k["name"] not in f_names:
            continue
        names = f_names[k["name"]]
        k["max_abs_err"] = max(k["max_abs_err"],
                               rs["errs_f"].get(k["name"], 0.0))
        stream = k["name"] in ("remap_stage", "commit_rows")
        site = {"remap_stage": "remap_stage", "commit_rows": "commit_rows",
                "grad_health": "grad_health"}.get(k["name"], "sketch_fold")
        k["world8"] = {
            "runs_at_world8": True,
            "launches_per_step_rank": {
                p: sum(rs["launches"][p].get(n, 0) for n in names)
                for p in ("world8_instrumented", "world8_streaming")},
            "in_step_ms": (
                {"14f-c_by_rank": [m.get(site) for m in
                                   f["stream"]["in_step_ms_by_rank"]]}
                if stream else
                {"14f-b_rank0": f["full"]["in_step_ms_rank0"].get(site),
                 "14f-b_max_rank": f["full"]["in_step_ms_max_rank"].get(
                     site)}),
            "note": "CUDA-event ms of the call inside the real world-8 "
                    "step, 8 ranks time-sharing one card (contended)"
                    + ("" if site != "sketch_fold" else "; the width "
                       "fold (K13, K14's pool and K15 in one replay)")}
    # 14h: the example, its checkpoints and the convergence driver at
    # world 8; rank 0's launches in 14h-a's counted run
    gc.collect()
    torch.cuda.empty_cache()
    h_launches, h_modes, world8["example"] = phase_world8_h(torch)
    launches["world8_example"] = h_launches
    for k in kernels:
        names = (csr_names if k["name"] == "csr" else k14 if k["name"] ==
                 "cms_query" else (k["name"],))
        k["launches_by_path"]["world8_example"] = (
            h_modes[k["name"]] if k["name"] in h_modes else
            sum(h_launches.get(n, 0) for n in names))
    for name in W8H_KERNELS:
        check(h_launches[name] > 0,
              f"{name}: no launch on the world-8 example's path")
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']}: no launch on its main path")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
