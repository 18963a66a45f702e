"""The multichip dryrun of the port: one full hybrid train step at world
``n`` (counterpart of the JAX repository's ``dryrun_multichip``).

:func:`dryrun_multichip` starts ``n`` rank processes joined in one gloo
group (a ``file://`` store in a temporary directory), each on the card
(``cuda:<rank % cards>``) unless the caller passes ``device="cpu"``. Every
rank builds the same small DLRM (:func:`small_dlrm`: ``max(8, n)``
tables of width 16, feature 0 a ragged ``sum`` feature of 1-2 ids a
row) behind a ``comm_balanced`` layer with ``column_slice_threshold``
2000 and ``row_slice`` 1000, so both slicing modes engage at ``n > 1``,
and takes one step of ``make_hybrid_train_step`` (``SparseAdagrad`` on
the tables, SGD at 0.01 on the dense half) at global batch ``4 n``, its
rows of the batch data-parallel. The weights and the batch come from
:func:`dryrun_problem` (numpy, from a seed), so a caller can run the
same step elsewhere.

There is no fallback: a rank that fails (or a card that is missing)
fails the call, and every process started is stopped on the way out.

Run it: ``python -m distributed_embeddings_torch.dryrun 8 [cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

#: the layer's slicing thresholds (elements), as in the JAX dryrun
COLUMN_SLICE_THRESHOLD = 2000
ROW_SLICE = 1000
#: the dense and sparse learning rate
LR = 0.01
#: seconds the ranks may take before the call gives up
TIMEOUT_S = 600


def small_dlrm(num_tables: int = 8, dim: int = 16):
    """The dryrun's DLRM configuration (tables of ``100 + 17 i`` rows)."""
    from .models import DLRMConfig

    return DLRMConfig(table_sizes=[100 + 17 * i for i in range(num_tables)],
                      embedding_dim=dim, num_numerical_features=4,
                      bottom_mlp_dims=(32, dim), top_mlp_dims=(64, 32, 1))


def dryrun_problem(n_ranks: int, seed: int = 0) -> dict:
    """Everything the dryrun step reads, as numpy (no card needed):

    * ``config``: :func:`small_dlrm` with ``max(8, n_ranks)`` tables;
    * ``embedding_configs``: its table configs, feature 0 with
      ``combiner="sum"`` (the ragged feature);
    * ``tables``: float32 ``[rows, 16]`` from U(-0.05, 0.05);
    * ``dense_tree``: the dense half's flax-ordered tree
      (``{"params": {"Dense_i": {"kernel", "bias"}}}``) of a
      ``DLRMDense`` drawn from a generator seeded with ``seed``;
    * ``numerical`` ``[4 n, 4]``, ``labels`` ``[4 n, 1]`` and
      ``categorical``: per feature ``[4 n]`` int32 ids, feature 0 as
      ``(values [n, 8], row_splits [n, 5])``, each rank's CSR of 1-2
      ids a row at capacity 8."""
    from .models import DLRMDense
    from .utils.convert import flax_dense_tree

    cfg = small_dlrm(num_tables=max(8, n_ranks), dim=16)
    emb = cfg.embedding_configs()
    emb[0]["combiner"] = "sum"
    rng = np.random.default_rng(seed)
    batch = 4 * n_ranks
    b_local = 4
    tables = [rng.uniform(-0.05, 0.05, size=(s, cfg.embedding_dim))
              .astype(np.float32) for s in cfg.table_sizes]
    cats = [rng.integers(0, s, size=(batch,)).astype(np.int32)
            for s in cfg.table_sizes]
    cap = 2 * b_local
    values = np.zeros((n_ranks, cap), np.int32)
    splits = np.zeros((n_ranks, b_local + 1), np.int32)
    for r in range(n_ranks):
        lens = rng.integers(1, 3, size=b_local)
        splits[r, 1:] = np.cumsum(lens)
        values[r, :lens.sum()] = rng.integers(0, cfg.table_sizes[0],
                                              size=int(lens.sum()))
    cats[0] = (values, splits)
    dense = DLRMDense(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    tree = flax_dense_tree(dense)
    return {
        "config": cfg, "embedding_configs": emb, "tables": tables,
        "dense_tree": {"params": {k: {n: t.numpy() for n, t in v.items()}
                                  for k, v in tree["params"].items()}},
        "numerical": rng.normal(size=(batch, 4)).astype(np.float32),
        "labels": rng.integers(0, 2, size=(batch, 1)).astype(np.float32),
        "categorical": cats}


def dryrun_layer(problem: dict, n_ranks: int, process_group=None):
    """The dryrun's :class:`~.parallel.DistributedEmbedding`."""
    from .parallel import DistributedEmbedding

    return DistributedEmbedding(
        problem["embedding_configs"], world_size=n_ranks,
        strategy="comm_balanced",
        column_slice_threshold=COLUMN_SLICE_THRESHOLD, row_slice=ROW_SLICE,
        process_group=process_group)


def _rank_batch(problem: dict, rank: int, n_ranks: int, device):
    """This rank's rows of the batch: ``(cats, (numerical, labels))``."""
    from .ops.embedding_lookup import Ragged

    b = 4
    rows = slice(rank * b, (rank + 1) * b)
    values, splits = problem["categorical"][0]
    cats = [Ragged(values=torch.from_numpy(values[rank].copy()).to(device),
                   row_splits=torch.from_numpy(splits[rank].copy())
                   .to(device))]
    cats += [torch.from_numpy(c[rows].copy()).to(device)
             for c in problem["categorical"][1:]]
    num = torch.from_numpy(problem["numerical"][rows].copy()).to(device)
    lab = torch.from_numpy(problem["labels"][rows].copy()).to(device)
    return cats, (num, lab)


def _launch_counts() -> dict:
    """The launches the lookup and exchange kernels counted so far: K1,
    K8, K9, K19 and K20, and their row-slice modes (K20's sums)."""
    from .ops import (gather_combine, pack_columns, pack_ids, ragged_combine,
                      ragged_grad)

    out = {"pack_ids": pack_ids.launches,
           "pack_columns": pack_columns.launches,
           "pack_columns_sum": pack_columns.launches_sum}
    for fn in (gather_combine, ragged_combine, ragged_grad):
        out[fn.__name__] = fn.launches
        out[fn.__name__ + "_row_base"] = fn.launches_rbase
    return out


def run_rank(rank: int, n_ranks: int, device, seed: int = 0) -> dict:
    """One rank's dryrun step in a joined group: the step's loss (the
    global batch's), the slicing facts, the step's kernel launches (see
    :func:`_launch_counts`; none on the CPU, where the plain versions
    run) and (rank 0) the tables after the step."""
    from .models import DLRMDense, bce_with_logits
    from .parallel import SGD, SparseAdagrad, make_hybrid_train_step
    from .utils.convert import hybrid_state_from_jax

    problem = dryrun_problem(n_ranks, seed)
    de = dryrun_layer(problem, n_ranks)
    if n_ranks > 1:  # world 1 holds every table whole
        if not de.strategy.row_sliced_tables:
            raise AssertionError("row slicing should engage")
        if not de.strategy.sliced_out_ranges:
            raise AssertionError("column slicing should engage")
    cfg = problem["config"]
    emb_opt, tx = SparseAdagrad(), SGD(LR)
    state = hybrid_state_from_jax(
        de, DLRMDense(cfg, device=device), problem["tables"],
        problem["dense_tree"], 0, device=device, emb_optimizer=emb_opt,
        dense_tx=tx)

    def loss_fn(dense, outs, batch):
        num, lab = batch
        return bce_with_logits(dense(num, outs), lab)

    step = make_hybrid_train_step(de, loss_fn, tx, emb_opt, lr_schedule=LR,
                                  with_metrics=False)
    cats, batch = _rank_batch(problem, rank, n_ranks, device)
    before = _launch_counts()
    loss, state = step(state, cats, batch)
    launches = {k: v - before[k] for k, v in _launch_counts().items()}
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun produced a non-finite loss {loss}")
    return {"loss": loss, "launches": launches,
            "row_sliced_tables": sorted(de.strategy.row_sliced_tables),
            "sliced_out_ranges": [list(r) for r in
                                  de.strategy.sliced_out_ranges],
            "tables": de.get_weights(state.emb_params, all_ranks=False),
            "dense": [p.detach().cpu().numpy()
                      for p in state.dense_params.parameters()]}


def _serve_rank(rank, n_ranks, store, device, seed):
    """A rank process: join the group, run the step, return its result."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from .parallel import bootstrap

    bootstrap.initialize("gloo", store, n_ranks, rank, timeout_s=TIMEOUT_S)
    out = run_rank(rank, n_ranks, dev, seed)
    torch.distributed.destroy_process_group()
    return out


def dryrun_multichip(n_ranks: int, device="cuda", seed: int = 0,
                     timeout_s: float = TIMEOUT_S) -> dict:
    """One hybrid train step at world ``n_ranks`` over gloo (see the
    module docstring). Returns rank 0's result: ``loss`` (the global
    batch's, equal on every rank), ``launches`` (rank 0's kernel
    launches in the step), ``row_sliced_tables``, ``sliced_out_ranges``,
    ``tables`` (the global tables after the step) and ``dense`` (the
    dense parameters after it). Raises if a rank
    fails, the ranks disagree on the loss, or they take longer than
    ``timeout_s``."""
    from .parallel.bootstrap import spawn_ranks
    from .utils.device import resolve_device

    n_ranks = int(n_ranks)
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    dev = resolve_device(device)
    got = spawn_ranks(_serve_rank,
                      lambda r, store: (r, n_ranks, store, dev.type, seed),
                      n_ranks, timeout_s, what="dryrun")
    losses = {g["loss"] for g in got}
    if len(losses) != 1:
        raise AssertionError(f"dryrun: the ranks' losses differ: {losses}")
    return got[0]


def _main(argv) -> None:
    # through the package's module, so the ranks' target pickles by it
    from distributed_embeddings_torch import dryrun

    n = int(argv[0]) if argv else 8
    device = argv[1] if len(argv) > 1 else "cuda"
    out = dryrun.dryrun_multichip(n, device=device)
    print(f"dryrun at world {n} on {device}: loss {out['loss']:.6f}, "
          f"row-sliced tables {out['row_sliced_tables']}, column-sliced "
          f"ranges {out['sliced_out_ranges']}")


if __name__ == "__main__":
    _main(sys.argv[1:])
