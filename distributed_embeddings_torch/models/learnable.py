"""A planted-signal recommender task that DLRM can provably learn, and
the convergence run that trains DLRM on it (counterpart of
``distributed_embeddings_tpu/models/learnable.py``).

The reference publishes trained quality (AUC 0.80248 on Criteo,
``examples/dlrm/README.md:7-8``) as its evidence that the stack learns.
Criteo is not bundled, so the task plants a DLRM-shaped signal in
synthetic data:

* every categorical id carries a hidden scalar preference
  ``s_f[id] ~ N(0, 1)``;
* the click logit mixes PAIRWISE interactions (what DLRM's dot
  interaction models) with a linear numerical term:
  ``logit = scale * (sum over pairs (2k, 2k+1) of s[2k][i]*s[2k+1][j])
  + w . x_num + bias``;
* labels draw ``Bernoulli(sigmoid(logit))``.

A model that learns nothing scores AUC 0.5 on held-out draws; the Bayes
ceiling is well above 0.8 at the default scale. :class:`LearnableClicks`
is host numpy and draws exactly the JAX package's batches from the same
seed and generator.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


class LearnableClicks:
    """Planted-signal synthetic CTR task.

    Args:
      table_sizes: vocab per categorical feature (pairs ``(2k, 2k+1)``
        interact; an odd trailing feature is noise).
      num_numerical: dense feature count (linear signal).
      seed: ground-truth seed (fixed per task instance).
      scale: interaction strength; higher = more separable.
    """

    def __init__(self, table_sizes: Sequence[int], num_numerical: int = 13,
                 seed: int = 0, scale: float = 1.0):
        self.table_sizes = [int(s) for s in table_sizes]
        self.num_numerical = int(num_numerical)
        self.scale = float(scale)
        rng = np.random.default_rng(seed)
        self._scores = [rng.normal(size=s).astype(np.float32)
                        for s in self.table_sizes]
        self._wnum = rng.normal(size=num_numerical).astype(np.float32) * 0.3
        self._bias = 0.0

    def sample(self, rng: np.random.Generator, batch: int
               ) -> Tuple[np.ndarray, List[np.ndarray], np.ndarray]:
        """One batch ``(numerical [B, F] f32, cats list of [B] i32,
        labels [B, 1] f32)``."""
        cats = [rng.integers(0, s, size=batch).astype(np.int32)
                for s in self.table_sizes]
        num = rng.normal(size=(batch, self.num_numerical)).astype(np.float32)
        logit = num @ self._wnum + self._bias
        for k in range(0, len(cats) - 1, 2):
            logit = logit + self.scale * (
                self._scores[k][cats[k]] * self._scores[k + 1][cats[k + 1]])
        p = 1.0 / (1.0 + np.exp(-logit))
        labels = (rng.random(batch) < p).astype(np.float32)[:, None]
        return num, cats, labels


def _scaled(base, s: float):
    """An in-place table initializer ``s * base``."""
    def init(out: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return base(out, generator).mul_(s)
    return init


def train_dlrm_convergence(task: LearnableClicks, *, world_size: int = 1,
                           mesh=None, process_group=None,
                           steps: int = 360, batch: int = 8192,
                           embedding_dim: int = 16, lr_schedule=0.01,
                           param_dtype: Optional[torch.dtype] = None,
                           eval_n: int = 16384, seed: int = 0,
                           optimizer: str = "adam", dense_lr=None,
                           emb_init_scale: Optional[float] = None,
                           device="cuda",
                           init_state: Optional[Callable] = None,
                           on_step: Optional[Callable] = None):
    """Train DLRM on ``task`` through the hybrid path and return
    ``(auc_start, auc_mid, auc_end)`` on a held-out draw (``mid`` after
    step ``steps // 3``).

    The same run as the JAX package's (the bench's ``convergence``
    capture and the slow learning tests): the model is
    ``DLRMConfig(task.table_sizes, embedding_dim, bottom MLP [2d, d],
    top MLP [64, 32, 1])``, the embedding optimizer sparse, the dense one
    optax-like, and the eval :func:`~..parallel.make_hybrid_eval_step` +
    sigmoid + exact :func:`~..utils.metrics.binary_auc`.

    ``optimizer="adam"`` (default): :class:`~..parallel.SparseAdam` +
    :class:`~..parallel.Adam`; ``"sgd"``: :class:`~..parallel.SparseSGD`
    + :class:`~..parallel.SGD` (the reference's DLRM recipe, which at
    lr 0.01 and the default init learns only the linear numerical part:
    the pairwise signal puts SGD at a saddle, see the JAX docstring);
    ``"mixed"``: dense ``Adam`` + ``SparseSGD``. ``lr_schedule`` is a
    float or a ``step -> lr`` schedule (``models/schedules.py``), used by
    both halves unless ``dense_lr`` decouples the dense one;
    ``emb_init_scale`` multiplies the tables' default initializer;
    ``param_dtype`` is the tables' dtype (float32 when ``None``).

    The weights draw from torch generators seeded ``seed`` (dense) and
    ``seed + 1`` (tables), not from JAX's keys, so the AUCs are not the
    JAX package's to the digit. ``init_state(de, dense, emb_optimizer,
    dense_tx) -> HybridTrainState`` replaces that init (the tests carry
    the JAX package's initial state over); ``on_step(i, loss, state)``
    is called after every step.

    ``world_size > 1``: this process is one rank of ``process_group``
    (``None``: the default group), as each device of the JAX package's
    mesh is: every rank draws the same batches and eval set from the
    seeded generators and takes its rows (``batch`` and ``eval_n`` must
    divide by the world), and the eval predictions gather in rank order,
    so every rank computes the same AUCs. ``init_state`` receives this
    rank's layer. The port has no mesh object: ``mesh`` must be
    ``None``."""
    from ..parallel import (SGD, Adam, DistributedEmbedding, SparseAdam,
                            SparseSGD, bootstrap, init_hybrid_state,
                            make_hybrid_eval_step, make_hybrid_train_step)
    from ..utils.device import resolve_device
    from ..utils.metrics import binary_auc
    from .dlrm import DLRMConfig, DLRMDense, bce_with_logits

    if mesh is not None:
        raise NotImplementedError(
            "the port has no mesh object: run one process a rank "
            "(world_size=, process_group=)")
    if batch % world_size or eval_n % world_size:
        raise ValueError(f"batch {batch} and eval_n {eval_n} must be "
                         f"divisible by world_size {world_size}")
    dev = resolve_device(device)
    cfg = DLRMConfig(table_sizes=task.table_sizes,
                     embedding_dim=embedding_dim,
                     num_numerical_features=task.num_numerical,
                     bottom_mlp_dims=[2 * embedding_dim, embedding_dim],
                     top_mlp_dims=[64, 32, 1])
    emb_configs = cfg.embedding_configs()
    if emb_init_scale is not None:
        for c in emb_configs:
            c["embeddings_initializer"] = _scaled(
                c["embeddings_initializer"], float(emb_init_scale))
    de = DistributedEmbedding(emb_configs, world_size=world_size,
                              strategy="memory_balanced",
                              process_group=process_group)
    rank = de.rank
    dense = DLRMDense(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(seed))
    if dense_lr is None:
        dense_lr = lr_schedule
    if optimizer == "adam":
        tx, emb_opt = Adam(dense_lr), SparseAdam()
    elif optimizer == "sgd":
        tx, emb_opt = SGD(dense_lr), SparseSGD()
    elif optimizer == "mixed":
        # dense Adam + embedding SparseSGD: whether the SPARSE path learns
        # under plain SGD when the dense half is not the bottleneck
        tx, emb_opt = Adam(dense_lr), SparseSGD()
    else:
        raise ValueError(f"optimizer must be 'adam' | 'sgd' | 'mixed', "
                         f"got {optimizer!r}")

    def loss_fn(d, outs, batch_):
        num, y = batch_
        return bce_with_logits(d(num, outs), y)

    if init_state is not None:
        state = init_state(de, dense, emb_opt, tx)
    else:
        state = init_hybrid_state(
            de, emb_opt, dense, tx,
            generator=torch.Generator(device=dev).manual_seed(seed + 1),
            dtype=param_dtype or torch.float32, device=dev)
    step = make_hybrid_train_step(de, loss_fn, tx, emb_opt,
                                  lr_schedule=lr_schedule,
                                  with_metrics=False)
    eval_fn = make_hybrid_eval_step(
        de, lambda d, outs, num: torch.sigmoid(d(num, outs)))

    def put(x):
        """This rank's rows of a global array, on the device."""
        n = x.shape[0] // world_size
        return torch.as_tensor(x[rank * n:(rank + 1) * n], device=dev)

    ev_num, ev_cats, ev_y = task.sample(np.random.default_rng(999), eval_n)
    ev_num = put(ev_num)
    ev_cats = [put(c) for c in ev_cats]

    def auc(st):
        pred = eval_fn(st, ev_cats, ev_num)
        pred = (pred.float().cpu().numpy() if world_size == 1 else
                bootstrap.to_host(pred, de.process_group))
        return binary_auc(ev_y, pred)

    auc0 = auc(state)
    rng = np.random.default_rng(seed + 7)
    mid = None
    for i in range(steps):
        num, cats, y = task.sample(rng, batch)
        loss, state = step(state, [put(c) for c in cats], (put(num), put(y)))
        if on_step is not None:
            on_step(i, loss, state)
        if i == steps // 3:
            mid = auc(state)
    return auc0, mid, auc(state)
