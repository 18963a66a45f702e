"""Host-side helpers: env registry, synthetic data, device resolution and
weight conversion from the JAX package."""
