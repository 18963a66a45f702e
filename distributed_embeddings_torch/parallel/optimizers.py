"""Sparse embedding optimizers over width-grouped table slabs, and the
dense half's SGD (counterpart of
``distributed_embeddings_tpu/parallel/optimizers.py`` and of the
``optax.sgd`` the JAX trainer takes for the dense parameters).

:class:`SparseSGD` updates only the rows a step looked up, IN PLACE on
the slab, through the scatter kernel K3 (``ops/scatter_add.py``).
Duplicate ids scatter-add directly (the update is linear in the
gradient, so no dedup pass), and ids at or past the slab's rows (the
dropped-row sentinel included) train nothing. The stateful optimizers
(``SparseAdagrad``, ``SparseMomentum``, ``SparseAdam``) come with the
dedup kernel (ROADMAP B7, B8).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.scatter_add import Lr, sgd_scatter
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
            raise NotImplementedError(
                "DETPU_SGD_DEDUP=1 needs the sort + segment-sum dedup "
                "kernel, which is not ported yet: ROADMAP B7")
        sgd_scatter(slab, ids, vals, lr)
        return slab, state


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

