"""Table initializers."""

from .embedding import default_embeddings_init

__all__ = ["default_embeddings_init"]
