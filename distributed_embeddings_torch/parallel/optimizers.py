"""Sparse embedding optimizers over width-grouped table slabs, and the
dense half's optimizers (counterpart of
``distributed_embeddings_tpu/parallel/optimizers.py`` and of the
``optax.sgd`` / ``optax.adagrad`` the JAX trainer takes for the dense
parameters).

The optimizers update only the rows a step looked up, IN PLACE on the
slab (and on its slab-shaped state):

* :class:`SparseSGD` through the scatter kernel K3
  (``ops/scatter_add.py``). Duplicate ids scatter-add directly (the
  update is linear in the gradient, so no dedup pass), and ids at or
  past the slab's rows (the dropped-row sentinel included) train
  nothing. ``DETPU_SGD_DEDUP=1`` forces the dedup pass (K5) in first,
  as in JAX, to compare the two.
* :class:`SparseAdagrad` with slab-shaped accumulators, in one of two
  regimes: dense-apply (K3 scatter-sums the stream into a zero gradient
  slab, then K7 runs the transition over the whole slab) or sparse (K5
  dedups the stream, then K6 updates the unique rows).

``SparseMomentum`` and ``SparseAdam`` are not ported yet (ROADMAP B8).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.adagrad import adagrad_dense, adagrad_rows
from ..ops.scatter_add import Lr, sgd_scatter
from ..ops.sparse_grad import dedup_sparse_grad
from ..utils import envvars

SGD_DEDUP_ENV = "DETPU_SGD_DEDUP"


class SparseSGD:
    """Plain SGD on slab rows: ``slab[ids] -= lr * vals`` in the slab
    dtype, with JAX's rounding chain (see ``ops/scatter_add.py``)."""

    needs_dedup = False
    #: streaming moment hygiene: SGD carries no slab state to reset
    fresh_row_fill = 0.0

    def init(self, params):
        """An empty state per slab."""
        return {k: () for k in params}

    def apply_rows(self, slab: torch.Tensor, state, ids: torch.Tensor,
                   vals: torch.Tensor, lr: Lr):
        """Update ``slab [R, w]`` in place from the stream ``ids [n]``,
        ``vals [n, w]``; ids outside ``[-R, R)`` are dropped, negative
        ones count from the end (JAX's indexing). Returns
        ``(slab, state)``."""
        if envvars.enabled(SGD_DEDUP_ENV):
            # the A/B hatch: pre-sum duplicate rows as the stateful
            # optimizers do (K5), then scatter the unique rows
            rows = slab.shape[0]
            ids, vals = dedup_sparse_grad(ids, vals, pad_id=rows,
                                          max_unique=rows + 1)
        sgd_scatter(slab, ids, vals, lr)
        return slab, state


class SparseAdagrad:
    """Adagrad with slab-shaped accumulators; ``optax.adagrad`` numerics
    (accumulator init 0.1, ``slab -= lr * g * rsqrt(acc_new + eps)``),
    the accumulators in the dtype ``init`` gives them (the slab's).

    Two regimes, chosen per call as in JAX: dense-apply when
    ``n * dense_apply_ratio > slab.shape[0]`` (``n`` the stream's ids),
    sparse otherwise; ``dense_apply_ratio=None`` always takes the sparse
    one. The port's ``slab.shape[0]`` counts LOGICAL rows (the JAX
    package's counts lane-packed physical rows, ``128 // w`` times
    fewer), so a slab the JAX step applies densely may run sparse here.
    The two regimes give the same numbers up to summation order: an
    untouched row sees ``g = 0``, and ``acc + 0 == acc``,
    ``slab - 0 == slab``.

    * dense-apply: K3 scatter-sums the stream into a zero gradient slab
      in the accumulator dtype (with lr -1, exactly), then K7 runs the
      transition elementwise over the whole slab;
    * sparse: K5 sorts and sums duplicate ids (vocab bound: at most
      ``rows + 1`` distinct ids, the sentinel included), then K6 updates
      each unique row.
    """

    needs_dedup = True

    def __init__(self, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7, dense_apply_ratio: float = 6.0):
        self.initial_accumulator_value = initial_accumulator_value
        # streaming moment hygiene: a freshly admitted row's accumulator
        # resets to the value a fresh table init gives it
        self.fresh_row_fill = initial_accumulator_value
        self.eps = eps
        self.dense_apply_ratio = dense_apply_ratio

    def init(self, params):
        """One accumulator per slab, ``full_like(slab, 0.1)`` (the slab's
        shape, dtype and device)."""
        return {k: torch.full_like(v, self.initial_accumulator_value)
                for k, v in params.items()}

    def dense_apply(self, rows: int, n: int) -> bool:
        """Whether a stream of ``n`` ids into ``rows`` logical slab rows
        runs the dense-apply regime."""
        return (self.dense_apply_ratio is not None
                and n * self.dense_apply_ratio > rows)

    def apply_rows(self, slab: torch.Tensor, accum: torch.Tensor,
                   ids: torch.Tensor, vals: torch.Tensor, lr: Lr):
        """Update ``slab [R, w]`` and ``accum [R, w]`` in place from the
        stream ``ids [n]``, ``vals [n, w]``. Returns ``(slab, accum)``.

        ``vals`` are cast to the accumulator dtype first: with bf16
        tables and fp32 accumulators, ``g * g`` squares in fp32. Ids past
        the slab train nothing; a negative id counts from the end once
        where the row is written (in the sparse regime the accumulator is
        read at row 0 for it, JAX's clip)."""
        vals = vals.to(accum.dtype)
        rows = slab.shape[0]
        if self.dense_apply(rows, ids.shape[0]):
            g = torch.zeros(slab.shape, dtype=accum.dtype,
                            device=slab.device)
            sgd_scatter(g, ids, vals, -1.0)
            adagrad_dense(slab, accum, g, lr, self.eps)
            return slab, accum
        uids, uvals = dedup_sparse_grad(ids, vals, pad_id=rows,
                                        max_unique=rows + 1)
        adagrad_rows(slab, accum, uids, uvals, lr, self.eps)
        return slab, accum


class SGD:
    """Counterpart of ``optax.sgd(learning_rate)`` (no momentum) for the
    dense parameters: ``init`` gives an empty state, ``update`` the
    updates ``-learning_rate * g`` in each gradient's dtype."""

    def __init__(self, learning_rate: float):
        self.learning_rate = float(learning_rate)

    def init(self, params: Sequence[torch.Tensor]):
        return ()

    def update(self, grads: Sequence[torch.Tensor], state, params=None):
        return [g * -self.learning_rate for g in grads], state


class Adagrad:
    """Counterpart of ``optax.adagrad(learning_rate)`` for the dense
    parameters (``scale_by_rss`` then ``-learning_rate``): the state is
    one sum of squares per parameter, initialized to
    ``initial_accumulator_value``; ``update`` returns the updates
    ``-lr * g * rsqrt(s + eps)`` (0 where ``s`` is 0) and a NEW state,
    so a skipped step can keep the old one bitwise."""

    def __init__(self, learning_rate: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        self.learning_rate = float(learning_rate)
        self.initial_accumulator_value = initial_accumulator_value
        self.eps = eps

    def init(self, params: Sequence[torch.Tensor]):
        return tuple(torch.full_like(p.detach(),
                                     self.initial_accumulator_value)
                     for p in params)

    def update(self, grads: Sequence[torch.Tensor], state, params=None):
        new_state = tuple(g * g + s for g, s in zip(grads, state))
        updates = [torch.where(s > 0, torch.rsqrt(s + self.eps), 0.0) * g
                   * -self.learning_rate for g, s in zip(grads, new_state)]
        return updates, new_state

