"""Host-side helpers: env registry, synthetic data and the Criteo
reader, device resolution, weight conversion from the JAX package, the
eval metric, and the train-state checkpoint codec (``checkpoint``,
``msgpack_state``, the fault points of ``runtime``)."""

from .metrics import binary_auc

__all__ = ["binary_auc"]
