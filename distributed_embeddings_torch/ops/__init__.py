"""Lookup ops and the hand-written kernels' wrappers."""

from .embedding_lookup import (Ragged, SparseIds, embedding_lookup,
                               gather_combine, gather_combine_plain)
from .interaction import dot_interact_fwd, dot_interact_fwd_plain

__all__ = ["Ragged", "SparseIds", "embedding_lookup", "gather_combine",
           "gather_combine_plain", "dot_interact_fwd",
           "dot_interact_fwd_plain"]
