"""Lookup ops and the hand-written kernels' wrappers."""

from .adagrad import (adagrad_dense, adagrad_dense_plain, adagrad_rows,
                      adagrad_rows_plain)
from .embedding_lookup import (Ragged, SparseIds, embedding_lookup,
                               gather_combine, gather_combine_plain)
from .interaction import (DotInteract, dot_interact_bwd,
                          dot_interact_bwd_plain, dot_interact_fwd,
                          dot_interact_fwd_plain)
from .scatter_add import sgd_scatter, sgd_scatter_plain
from .sparse_grad import dedup_sparse_grad, dedup_sparse_grad_plain

__all__ = ["Ragged", "SparseIds", "embedding_lookup", "gather_combine",
           "gather_combine_plain", "dot_interact_fwd",
           "dot_interact_fwd_plain", "dot_interact_bwd",
           "dot_interact_bwd_plain", "DotInteract", "sgd_scatter",
           "sgd_scatter_plain", "dedup_sparse_grad",
           "dedup_sparse_grad_plain", "adagrad_rows", "adagrad_rows_plain",
           "adagrad_dense", "adagrad_dense_plain"]
