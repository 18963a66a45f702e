"""Table initializers (counterpart of
``distributed_embeddings_tpu/layers/embedding.py:default_embeddings_init``).

An initializer here fills a preallocated tensor IN PLACE,
``init(out, generator)``: a full-size slab (48 GB of bf16 at the
Criteo-1TB vocabulary) is allocated once and filled slice by slice, so
no second copy of it ever exists. The JAX initializers return a new
array from a key; the two draw different numbers from the same seed, so
parity is a distribution match, not a bit match.
"""

from __future__ import annotations

from typing import Optional

import torch


def default_embeddings_init(out: torch.Tensor,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """Keras's 'uniform' default, ``U(-0.05, 0.05)``, in place."""
    return out.uniform_(-0.05, 0.05, generator=generator)
