"""Runnable examples of the port (``python -m
distributed_embeddings_torch.examples.<name>``)."""
