"""Lookup ops and the hand-written kernels' wrappers."""

from .adagrad import (adagrad_dense, adagrad_dense_plain, adagrad_rows,
                      adagrad_rows_plain)
from .adam import adam_rows, adam_rows_plain, bias_powers
from .embedding_lookup import (Ragged, SparseIds, embedding_lookup,
                               gather_combine, gather_combine_plain,
                               lengths_to_splits, lengths_to_splits_plain,
                               ragged_combine, ragged_combine_plain,
                               ragged_row_ids, ragged_row_ids_plain,
                               row_to_split, row_to_split_plain)
from .momentum import momentum_rows, momentum_rows_plain
from .interaction import (DotInteract, dot_interact_bwd,
                          dot_interact_bwd_plain, dot_interact_fwd,
                          dot_interact_fwd_plain)
from .scatter_add import (sgd_scatter, sgd_scatter_plain,
                          sgd_scatter_promoted, sgd_scatter_promoted_plain)
from .sketch import (cms_query, cms_query_plain, cms_update,
                     cms_update_plain, record_ids_plain, topk_merge,
                     topk_merge_plain, topk_pool, topk_pool_plain)
from .sparse_grad import (combiner_grad_values, dedup_sparse_grad,
                          dedup_sparse_grad_plain, ragged_grad,
                          ragged_grad_plain)
from .streaming import (commit_rows, commit_rows_plain, remap_stage,
                        remap_stage_plain)

__all__ = ["Ragged", "SparseIds", "embedding_lookup", "gather_combine",
           "gather_combine_plain", "lengths_to_splits",
           "lengths_to_splits_plain", "row_to_split", "row_to_split_plain",
           "ragged_row_ids", "ragged_row_ids_plain", "ragged_combine",
           "ragged_combine_plain", "dot_interact_fwd",
           "dot_interact_fwd_plain", "dot_interact_bwd",
           "dot_interact_bwd_plain", "DotInteract", "sgd_scatter",
           "sgd_scatter_plain", "sgd_scatter_promoted",
           "sgd_scatter_promoted_plain", "dedup_sparse_grad",
           "dedup_sparse_grad_plain", "ragged_grad", "ragged_grad_plain",
           "combiner_grad_values", "adagrad_rows", "adagrad_rows_plain",
           "adagrad_dense", "adagrad_dense_plain", "adam_rows",
           "adam_rows_plain", "bias_powers", "momentum_rows",
           "momentum_rows_plain", "cms_update", "cms_update_plain",
           "cms_query", "cms_query_plain", "topk_pool", "topk_pool_plain",
           "topk_merge", "topk_merge_plain", "record_ids_plain",
           "remap_stage", "remap_stage_plain", "commit_rows",
           "commit_rows_plain"]
