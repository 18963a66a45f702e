"""Host-side helpers: env registry, synthetic data, device resolution,
weight conversion from the JAX package and the eval metric."""

from .metrics import binary_auc

__all__ = ["binary_auc"]
