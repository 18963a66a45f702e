"""Synthetic id generation (counterpart of
``distributed_embeddings_tpu/utils/data.py:power_law_ids``)."""

from __future__ import annotations

import numpy as np


def power_law_ids(rng: np.random.Generator, vocab: int, shape,
                  alpha: float = 1.05) -> np.ndarray:
    """Power-law distributed ids in ``[0, vocab)``: hot ids dominate, as
    in real recommender traffic. Same inverse-CDF draw as the JAX
    package, so one numpy generator gives both packages the same ids."""
    u = rng.random(size=shape)
    # inverse-CDF of p(x) ~ x^(-alpha) on [1, vocab+1)
    exp = 1.0 - alpha
    ids = ((vocab + 1) ** exp * u + (1 - u)) ** (1.0 / exp) - 1.0
    return np.clip(ids.astype(np.int64), 0, vocab - 1)
