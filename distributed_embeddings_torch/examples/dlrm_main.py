"""DLRM training example (counterpart of the JAX package's
``examples/dlrm/main.py``): the MLPerf DLRM trained with the hybrid
step, embeddings on the hand-written kernels and the MLPs on cuBLAS,
on the Criteo raw-binary dataset (or synthetic data when no
``--dataset_path`` is given). SGD under the MLPerf warmup +
polynomial-decay schedule on both halves, mid-training AUC evaluation
with an early stop, full train-state checkpoints in the JAX package's
format (``utils/checkpoint.py``: ``--save_state``, ``--restore_state``,
``--resume``), a serving epilogue (``--serve_qps``) and the embedding
dump (``np.savez`` to ``--checkpoint_out``, bfloat16 tables in the JAX
package's ``'<V2'`` encoding).

    python -m distributed_embeddings_torch.examples.dlrm_main \\
        --num_batches 100                          # on the card
    python -m distributed_embeddings_torch.examples.dlrm_main \\
        --device cpu --num_batches 20 --batch_size 64 \\
        --table_sizes 50,50,50 --embedding_dim 8 \\
        --bottom_mlp_dims 16,8 --top_mlp_dims 16,1
    python -m distributed_embeddings_torch.examples.dlrm_main \\
        --device cpu --world_size 8 --backend gloo ...   # 8 ranks

The flags are the JAX example's, with its defaults, plus the port's
``--device``, ``--world_size``, ``--rank``, ``--init_method``,
``--backend`` and ``--row_slice``. At world > 1 each rank is one process
of a ``torch.distributed`` group (``parallel/bootstrap.py:initialize``
with ``--backend``, which has no default there, ``--init_method``,
``--bootstrap_timeout_s`` and ``--bootstrap_retries``), on
``cuda:(rank % device_count)`` unless ``--device cpu``. ``--world_size``
without ``--rank`` starts every rank itself (:func:`launch`, a
``file://`` store in a temporary directory); a process already in its
group (as rank ``--rank`` of ``--world_size``) uses that group and needs
no ``--init_method``. As in the JAX example on
its mesh: rank 0 (the chief) alone prints and writes the metrics, the
telemetry JSON and the dump, every rank joining the collectives behind
them; the input is model-parallel (``MpInputs``) unless ``--dp_input``,
which gives each rank its rows of the global batch; the eval predictions
gather in rank order, so every rank computes the same AUC; checkpoints
are the chief-written saves and per-rank restores of
``utils/checkpoint.py``.

The JAX example runs its loop through the resilient driver
(``run_resilient``); here a plain loop does what the example's flags
ask: the step, the ``on_step`` cadence (a log line every 1000 steps,
eval every ``--eval_interval``), a checkpoint every
``--checkpoint_interval`` steps and one at exit, and a resume at
``state.step`` with the data stream fast-forwarded to it. Flags whose
machinery is not ported raise ``NotImplementedError`` naming their
ROADMAP item when set; so does ``--serve_qps`` with ``--dp_input`` at
world > 1 (the serving mesh, ROADMAP A7b). :func:`main` returns a
:class:`RunResult` (or, when it started the ranks, each rank's summary).

Step metrics: ``--metrics_out F`` or ``DETPU_OBS=1`` builds the
instrumented step, and every ``--metrics_interval`` steps (from step 0)
one ``step_metrics`` record is appended, fsynced, to ``F`` (default
``<checkpoint_out>.metrics.jsonl``), with a final ``counters`` record at
exit. JAX's example installs a recompile listener for that record;
eager PyTorch compiles nothing, so the record carries the port's process
counters (``utils/obs.py:counters``) in its place.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..analysis import telemetry
from ..models.dlrm import DLRMConfig, DLRMDense, bce_with_logits
from ..models.schedules import warmup_poly_decay_schedule
from ..parallel import (SGD, DistributedEmbedding, ServeConfig,
                        ServingRuntime, SparseSGD, bootstrap, drive,
                        init_hybrid_state, make_hybrid_eval_step,
                        make_hybrid_train_step, synthetic_request)
from ..utils import checkpoint, envvars, obs
from ..utils.data import RawBinaryDataset, fast_forward, power_law_ids
from ..utils.device import resolve_device
from ..utils.metrics import binary_auc

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bool(v: str) -> bool:
    if v.lower() in ("1", "true", "t", "yes", "y"):
        return True
    if v.lower() in ("0", "false", "f", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"not a bool: {v!r}")


def _list(v: str) -> List[str]:
    return [s for s in v.split(",") if s]


def build_parser() -> argparse.ArgumentParser:
    """The JAX example's flags (names and defaults), plus the port's
    ``--device``, ``--world_size``, ``--rank``, ``--init_method``,
    ``--backend`` and ``--row_slice``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])

    def flag(name, **kw):
        p.add_argument("--" + name, **kw)

    def bool_flag(name, default, help):
        p.add_argument("--" + name, type=_bool, nargs="?", const=True,
                       default=default, help=help)
        p.add_argument("--no" + name, dest=name, action="store_false",
                       help=argparse.SUPPRESS)

    flag("dataset_path", default=None,
         help="Criteo split-binary root (with model_size.json)")
    flag("learning_rate", type=float, default=24, help="base learning rate")
    flag("batch_size", type=int, default=64 * 1024, help="global batch size")
    flag("top_mlp_dims", type=_list, default=["1024", "1024", "512", "256",
                                              "1"], help="top MLP sizes")
    flag("bottom_mlp_dims", type=_list, default=["512", "256", "128"],
         help="bottom MLP sizes")
    flag("num_numerical_features", type=int, default=13,
         help="dense feature count")
    flag("num_batches", type=int, default=340,
         help="synthetic batches when no dataset is given")
    flag("table_sizes", type=_list, default=[str(x) for x in 26 * [1000]],
         help="vocab size per table for the synthetic dataset")
    flag("embedding_dim", type=int, default=128, help="embedding width")
    flag("dist_strategy", default="memory_balanced",
         help="table placement strategy")
    flag("column_slice_threshold", type=int, default=None,
         help="max elements per table slice")
    flag("checkpoint_out", default="/tmp/embedding_weights",
         help="np.savez path for final global embedding weights")
    bool_flag("dp_input", False,
              "feed data-parallel id shards (world > 1: each rank its rows "
              "of the global batch; default model-parallel MpInputs)")
    flag("eval_interval", type=int, default=0,
         help="evaluate every N training steps (0 = only at the end)")
    flag("auc_threshold", type=float, default=None,
         help="stop training early once a mid-training evaluation reaches "
              "this AUC")
    flag("eval_batches", type=int, default=4,
         help="synthetic evaluation batches when no dataset is given")
    flag("save_state", default=None,
         help="directory for a FULL train-state checkpoint")
    flag("restore_state", default=None,
         help="resume from a --save_state checkpoint directory (a torn "
              "checkpoint falls back to <dir>.prev)")
    bool_flag("resume", False,
              "auto-resume from --save_state when a valid checkpoint (or "
              "its .prev fallback) exists there")
    flag("checkpoint_interval", type=int, default=0,
         help="checkpoint the full train state to --save_state every N "
              "steps (0 = only at exit)")
    flag("checkpoint_time_s", type=float, default=0,
         help="wall-clock checkpoint cadence (ROADMAP A12)")
    flag("keep_last_n", type=int, default=None,
         help="checkpoint-ring size; default DETPU_CKPT_RING (2)")
    flag("rollback_max", type=int, default=None,
         help="rollback-and-replay attempts (ROADMAP A12)")
    flag("quarantine_max", type=int, default=None,
         help="quarantined batch budget (ROADMAP A12)")
    flag("bootstrap_timeout_s", type=float, default=None,
         help="process-group join and collective deadline (seconds)")
    flag("bootstrap_retries", type=int, default=2,
         help="process-group join retries")
    flag("metrics_out", default=None,
         help="step-metrics JSONL sidecar path; default "
              "<checkpoint_out>.metrics.jsonl when DETPU_OBS=1")
    flag("metrics_interval", type=int, default=100,
         help="log a step-metrics record every N training steps (only "
              "when metrics are enabled)")
    flag("plan_audit", default="off", choices=["off", "warn", "strict"],
         help="plan-time capacity preflight (ROADMAP A4b)")
    flag("plan_audit_chip", default="v5e",
         help="capacity-registry chip of the preflight (ROADMAP A4b)")
    flag("serve_qps", type=float, default=0,
         help="after training, serve a Zipfian request stream at this rate "
              "through the ServingRuntime (0 = off)")
    flag("serve_seconds", type=float, default=5,
         help="duration of the --serve_qps stream")
    flag("param_dtype", default="float32", choices=list(DTYPES),
         help="embedding table (slab) dtype")
    flag("device", default="cuda",
         help="torch device to run on (default the card, cuda:(rank % "
              "devices) at world > 1; 'cpu' runs every kernel's plain "
              "version)")
    flag("world_size", type=int, default=1,
         help="ranks (processes) of the run; without --rank, start them all")
    flag("rank", type=int, default=None, help="this process's rank")
    flag("init_method", default=None,
         help="the group's rendezvous (tcp://localhost:PORT or "
              "file:///path); not needed in a group already joined")
    flag("backend", default=None, choices=["gloo", "nccl"],
         help="the group's backend; required at world > 1")
    flag("row_slice", type=int, default=None,
         help="row-slice tables above this many elements (world > 1)")
    return p


def _refuse_unported(args) -> None:
    """Raise for a non-default flag whose machinery is not ported."""
    unported = [
        ("plan_audit", args.plan_audit != "off", "A4b"),
        ("checkpoint_time_s", args.checkpoint_time_s != 0, "A12"),
        ("rollback_max", args.rollback_max is not None, "A12"),
        ("quarantine_max", args.quarantine_max is not None, "A12"),
    ]
    for name, is_set, item in unported:
        if is_set:
            raise NotImplementedError(
                f"{name} is not ported yet: ROADMAP {item}")


class SyntheticBatch(NamedTuple):
    numerical: np.ndarray       # [B, F] float32
    cats: List[np.ndarray]      # per table [B] int32
    labels: np.ndarray          # [B, 1] float32


def synthetic_batches(cfg: DLRMConfig, num_batches: int, batch_size: int,
                      seed: int = 0):
    """The JAX example's synthetic stream: per batch, normal numerical
    features, then ``power_law_ids`` per table, then 0/1 labels, drawn
    from one numpy generator in that order, so one seed gives the JAX
    example's batches bit for bit."""
    rng = np.random.default_rng(seed)
    for _ in range(num_batches):
        num = np.asarray(rng.normal(size=(batch_size,
                                          cfg.num_numerical_features)),
                         np.float32)
        cats = [np.asarray(power_law_ids(rng, s, (batch_size,)), np.int32)
                for s in cfg.table_sizes]
        labels = np.asarray(rng.integers(0, 2, size=(batch_size, 1)),
                            np.float32)
        yield SyntheticBatch(num, cats, labels)


class RunResult(NamedTuple):
    """What :func:`main` returns: the embedding layer and the final train
    state, the losses of the steps this run took (host floats), the last
    AUC (``None`` when no evaluation ran), why the loop ended
    (``exhausted`` or ``on_step``), the steps run, the serving stats and
    results (``None`` without ``--serve_qps``), the host seconds of each
    checkpoint save and of the restore, of each step (the step and its
    loss read back, without the batch's generation, eval or saves) and
    of the whole training loop."""
    de: Any
    state: Any
    losses: List[float]
    auc: Optional[float]
    stop_reason: str
    steps_run: int
    serving: Optional[Dict[str, Any]]
    serve_results: Optional[list]
    save_s: List[float]
    restore_s: Optional[float]
    step_s: List[float]
    loop_s: float


def _launched_rank(argv) -> Dict[str, Any]:
    """A rank process of :func:`launch`: run the example, return its
    summary."""
    res = main(argv)
    return {"losses": res.losses, "auc": res.auc,
            "stop_reason": res.stop_reason, "steps_run": res.steps_run,
            "step": int(res.state.step), "save_s": res.save_s,
            "restore_s": res.restore_s, "step_s": res.step_s,
            "loop_s": res.loop_s}


def launch(argv: Sequence[str], world_size: int, backend: str,
           device: str = "cuda", timeout_s: Optional[float] = None
           ) -> List[Dict[str, Any]]:
    """Run the example with ``argv`` in ``world_size`` spawned rank
    processes joined on a ``file://`` store in a temporary directory
    (``backend`` explicit; ``device`` ``"cuda"`` puts rank r on
    ``cuda:(r % device_count)``, ``"cpu"`` runs the plain versions).
    Returns each rank's summary in rank order (its losses, AUC, stop
    reason, steps, final step and timings). When a rank fails (an
    exception, a non-zero exit, or no result in ``timeout_s``), every
    rank is stopped and ``RuntimeError`` carries the rank's traceback
    (:func:`~..parallel.bootstrap.spawn_ranks`)."""
    def args_for_rank(r, store):
        return (list(argv) + ["--world_size", str(world_size), "--rank",
                              str(r), "--backend", backend,
                              "--init_method", store, "--device", device],)

    return bootstrap.spawn_ranks(_launched_rank, args_for_rank, world_size,
                                 timeout_s, what="launch")


def main(argv: Optional[Sequence[str]] = None):
    """Run the example with ``argv`` (the command line without the
    program name; ``sys.argv[1:]`` when ``None``). Returns a
    :class:`RunResult`; with ``--world_size`` > 1 and no ``--rank`` it
    starts the ranks (:func:`launch`) and returns their summaries."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    world = int(args.world_size)
    if world > 1 and args.backend is None:
        raise ValueError("--backend is required at world > 1: 'gloo' or "
                         "'nccl' (nothing switches from one to the other)")
    if world > 1 and args.dp_input and args.serve_qps > 0:
        raise NotImplementedError(
            "--serve_qps with --dp_input at world > 1 serves on the "
            "serving mesh, not ported yet: ROADMAP A7b")
    if world > 1 and args.rank is None:
        return launch(argv, world, args.backend, args.device,
                      args.bootstrap_timeout_s)
    joined = False
    if world > 1 and torch.distributed.is_initialized():
        # this process is already a rank of its group: it must be this one
        have = (torch.distributed.get_world_size(),
                torch.distributed.get_rank())
        if have != (world, args.rank):
            raise ValueError(f"this process is rank {have[1]} of a group of "
                             f"{have[0]}, not --rank {args.rank} of "
                             f"--world_size {world}")
    elif world > 1:
        if args.init_method is None:
            raise ValueError("--rank needs --init_method (the group's "
                             "rendezvous)")
        joined = bootstrap.initialize(
            args.backend, args.init_method, world, args.rank,
            timeout_s=args.bootstrap_timeout_s,
            retries=args.bootstrap_retries)
    try:
        return _run(args, world)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _run(args, world: int) -> RunResult:
    """The example's body on this rank (world 1, or a joined group)."""
    rank = 0 if world == 1 else bootstrap.group_rank(None, world)
    is_chief = rank == 0
    dev = resolve_device(args.device)  # raises without a card
    if world > 1 and dev.type == "cuda":
        dev = torch.device(f"cuda:{rank % torch.cuda.device_count()}")
        torch.cuda.set_device(dev)
    dtype = DTYPES[args.param_dtype]
    use_mp_input = (not args.dp_input) and world > 1

    def say(*a) -> None:
        if is_chief:
            print(*a)

    table_sizes = [int(s) for s in args.table_sizes]
    if args.dataset_path is not None:
        with open(os.path.join(args.dataset_path, "model_size.json"),
                  encoding="utf-8") as f:
            table_sizes = [s + 1 for s in json.load(f).values()]
    cfg = DLRMConfig(
        table_sizes=table_sizes, embedding_dim=args.embedding_dim,
        num_numerical_features=args.num_numerical_features,
        bottom_mlp_dims=[int(d) for d in args.bottom_mlp_dims],
        top_mlp_dims=[int(d) for d in args.top_mlp_dims])
    # model-parallel input only means anything across ranks
    de = DistributedEmbedding(
        cfg.embedding_configs(), world_size=world,
        strategy=args.dist_strategy, dp_input=not use_mp_input,
        column_slice_threshold=args.column_slice_threshold,
        row_slice=args.row_slice)
    say(de.strategy.describe())
    if args.batch_size % world:
        # the per-rank slicing would silently drop the remainder of every
        # global batch: fail loudly instead (the JAX example's check)
        raise ValueError(
            f"--batch_size {args.batch_size} must be divisible by the "
            f"global device count {world} ({world} processes)")
    lb = args.batch_size // world

    dense = DLRMDense(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    emb_opt = SparseSGD()
    sched = warmup_poly_decay_schedule(
        args.learning_rate, warmup_steps=8000, decay_start_step=48000,
        decay_steps=24000)
    # the same schedule drives both halves: the dense SGD natively, the
    # sparse embedding updates through lr_schedule
    tx = SGD(sched)

    def loss_fn(dp, emb_outs, batch):
        n, y = batch
        return bce_with_logits(dp(n, emb_outs), y)

    keep_last_n = (args.keep_last_n if args.keep_last_n is not None
                   else envvars.get_int("DETPU_CKPT_RING"))
    restore_from = args.restore_state
    if args.resume and args.save_state is not None and (
            os.path.isfile(os.path.join(args.save_state, "meta.json"))
            or os.path.isdir(checkpoint.previous_checkpoint_path(
                args.save_state))):
        restore_from = args.save_state
    restore_s = None
    if restore_from:
        t0 = time.perf_counter()
        state = checkpoint.restore_train_state(
            restore_from, de, emb_opt, dense, tx,
            on_mismatch=envvars.get("DETPU_ON_MISMATCH"), device=dev)
        restore_s = time.perf_counter() - t0
        say("restored train state at step", int(state.step), "from",
            restore_from)
    else:
        state = init_hybrid_state(
            de, emb_opt, dense, tx,
            generator=torch.Generator(device=dev).manual_seed(1),
            dtype=dtype, device=dev)
    # step metrics: every rank runs the instrumented step (its metrics
    # are gathered over the group), the chief writes them
    with_metrics = obs.metrics_enabled() or args.metrics_out is not None
    metrics_log = (obs.MetricsLogger(
        args.metrics_out or args.checkpoint_out + ".metrics.jsonl")
        if with_metrics and is_chief else None)
    with_telemetry = telemetry.telemetry_enabled()
    step_fn = make_hybrid_train_step(de, loss_fn, tx, emb_opt,
                                     lr_schedule=sched,
                                     with_metrics=with_metrics,
                                     telemetry=with_telemetry)
    telem = (telemetry.init_telemetry(de, device=dev) if with_telemetry
             else None)
    telemetry_path = (args.save_state.rstrip(os.sep) + ".telemetry.json"
                      if args.save_state is not None else None)
    if telem is not None and restore_from and telemetry_path is not None \
            and os.path.isfile(telemetry_path + ".state.npz"):
        telem = telemetry.restore_telemetry_state(
            telemetry_path + ".state.npz", telem, de)

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            dev, non_blocking=True)

    def rows(a: np.ndarray) -> np.ndarray:
        """This rank's rows of a global batch array."""
        return a if world == 1 else a[rank * lb:(rank + 1) * lb]

    def prep_cats(cats):
        """Global per-feature id arrays -> this rank's embedding input."""
        if use_mp_input:
            return de.pack_mp_inputs(cats, device=dev)
        return [to_dev(rows(c)) for c in cats]

    def data_source(start):
        """Batch stream positioned at absolute step ``start`` (no batch
        replayed or skipped on resume); every rank reads the same global
        batches and takes its part."""
        if args.dataset_path is not None:
            it = RawBinaryDataset(
                data_path=args.dataset_path, batch_size=args.batch_size,
                numerical_features=args.num_numerical_features,
                categorical_features=list(range(len(table_sizes))),
                categorical_feature_sizes=table_sizes,
                drop_last_batch=True, dp_input=not use_mp_input,
                start_batch=start)
        else:
            it = itertools.islice(
                synthetic_batches(cfg, args.num_batches, args.batch_size),
                start, None)
        for num, cats, labels in it:
            yield prep_cats(cats), (to_dev(rows(num)), to_dev(rows(labels)))

    if args.dataset_path is not None:
        eval_data = RawBinaryDataset(
            data_path=args.dataset_path, batch_size=args.batch_size,
            numerical_features=args.num_numerical_features,
            categorical_features=list(range(len(table_sizes))),
            categorical_feature_sizes=table_sizes,
            drop_last_batch=True, valid=True, dp_input=not use_mp_input)
    else:
        # a fixed held-out synthetic set so mid-training eval is meaningful
        eval_data = (list(synthetic_batches(cfg, args.eval_batches,
                                            args.batch_size, seed=1))
                     if args.eval_batches else None)

    eval_fn = make_hybrid_eval_step(
        de, lambda dp, outs, n: torch.sigmoid(dp(n, outs)))

    def evaluate(cur_state) -> float:
        """Full pass over the eval split -> the global AUC (every rank's
        predictions gathered in rank order, on every rank)."""
        all_preds, all_labels = [], []
        for num, cats, labels in eval_data:
            preds = eval_fn(cur_state, prep_cats(cats), to_dev(rows(num)))
            all_preds.append(preds.float().cpu().numpy() if world == 1
                             else bootstrap.to_host(preds, de.process_group))
            all_labels.append(np.asarray(labels))
        return binary_auc(np.concatenate(all_labels),
                          np.concatenate(all_preds))

    last_auc: List[Optional[float]] = [None]

    def on_step(step, loss, cur_state) -> bool:
        """The JAX example's per-step callback (``step``: the ordinal of
        the step just taken, 0 first, as the resilient driver counts)."""
        if step % 1000 == 0:
            say("step:", step, " loss:", float(loss))
        if (args.eval_interval and eval_data is not None and step
                and step % args.eval_interval == 0):
            auc = evaluate(cur_state)
            last_auc[0] = auc
            say(f"eval step: {step} AUC: {auc}")
            if args.auc_threshold is not None and auc >= args.auc_threshold:
                say(f"AUC threshold {args.auc_threshold} reached at "
                    f"step {step}, stopping")
                return True
        return False

    save_s: List[float] = []

    def save(cur_state) -> None:
        t0 = time.perf_counter()
        checkpoint.save_train_state(args.save_state, de, cur_state,
                                    keep_last_n=keep_last_n)
        if telem is not None:
            summary = telemetry.summarize_telemetry(de, telem)
            if is_chief:
                with open(telemetry_path, "w", encoding="utf-8") as f:
                    json.dump(summary, f)
            telemetry.save_telemetry_state(telemetry_path + ".state.npz",
                                           telem, de)
        save_s.append(time.perf_counter() - t0)

    losses: List[float] = []
    step_s: List[float] = []
    stop_reason = "exhausted"
    t_loop = time.perf_counter()
    for cats, batch in fast_forward(data_source, int(state.step)):
        cur = int(state.step)
        t0 = time.perf_counter()
        out = (step_fn(state, cats, batch, telem) if telem is not None
               else step_fn(state, cats, batch))
        loss, state = out[:2]
        if telem is not None:
            telem = out[-1]
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
        if (metrics_log is not None and args.metrics_interval
                and cur % args.metrics_interval == 0):
            metrics_log.log_step(out[2], step=cur)
        if on_step(cur, losses[-1], state):
            stop_reason = "on_step"
            break
        if (args.save_state is not None and args.checkpoint_interval
                and (cur + 1) % args.checkpoint_interval == 0):
            save(state)
    if args.save_state is not None:
        save(state)
    loop_s = time.perf_counter() - t_loop

    # an on_step stop is the AUC-threshold early stop: the end-of-training
    # eval is skipped, as in the JAX example
    if eval_data is not None and stop_reason != "on_step":
        auc = evaluate(state)
        last_auc[0] = auc
        say(f"Evaluation completed, AUC: {auc}")

    serving = serve_results = None
    if args.serve_qps > 0 and use_mp_input:
        say("serving epilogue skipped: the ServingRuntime coalesces "
            "data-parallel requests — rerun with --dp_input")
    elif args.serve_qps > 0:
        # inference epilogue: the deadline-bounded serving runtime over
        # the just-trained state, variable-size Zipfian requests
        rt = ServingRuntime(
            de, lambda dp, outs, n: torch.sigmoid(dp(n, outs))[:, 0],
            state, config=ServeConfig())
        srng = np.random.default_rng(2)
        tmpl = synthetic_request(srng, table_sizes, 2,
                                 numerical=args.num_numerical_features)
        rt.warmup((tmpl.cats, tmpl.batch))
        serve_results = drive(rt, lambda i: synthetic_request(
            srng, table_sizes, int(srng.integers(1, 9)),
            numerical=args.num_numerical_features),
            args.serve_qps, args.serve_seconds)
        serving = s = rt.stats()
        # eager PyTorch compiles nothing, so nothing recompiles
        print(f"serving: {s['served']} served at {args.serve_qps:.0f} "
              f"QPS target — p50/p95/p99 = {s['latency_p50_ms']:.1f}/"
              f"{s['latency_p95_ms']:.1f}/{s['latency_p99_ms']:.1f} ms, "
              f"shed={s['shed']}, deadline_missed={s['deadline_missed']}, "
              f"pad={s['pad_fraction']:.2f}, recompiles=0")

    # the embedding dump, in the JAX package's on-disk dtypes: every rank
    # sends its slices to the chief, which writes
    tables = {f"arr_{t}": de._table_tensor(state.emb_params, t,
                                           all_ranks=False)
              for t in range(len(table_sizes))}
    if is_chief:
        path = args.checkpoint_out
        if not path.endswith(".npz"):
            path += ".npz"  # np.savez's naming
        with open(path, "wb") as f:
            checkpoint.save_npz(f, tables)
    say("saved", len(tables), "tables to", args.checkpoint_out)
    if args.save_state:
        say("saved full train state to", args.save_state)
    if metrics_log is not None:
        # the final process-counter snapshot
        metrics_log.log_counters(final=True)
    return RunResult(de=de, state=state, losses=losses, auc=last_auc[0],
                     stop_reason=stop_reason, steps_run=len(losses),
                     serving=serving, serve_results=serve_results,
                     save_s=save_s, restore_s=restore_s, step_s=step_s,
                     loop_s=loop_s)


if __name__ == "__main__":
    main(sys.argv[1:])
