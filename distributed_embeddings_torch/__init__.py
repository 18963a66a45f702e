"""distributed_embeddings_torch — the PyTorch/CUDA port of
``distributed_embeddings_tpu`` for NVIDIA Hopper (H100).

Same names and layout as the JAX package, PyTorch idiom inside. The
hot functions run on hand-written CUDA kernels (``csrc/``), built with
``nvcc`` for ``sm_90a`` at first use (``ops/_kernels.py``). Entry points
take an explicit ``device=`` that defaults to ``"cuda"`` and raise when
CUDA is absent; pass ``device="cpu"`` to run the plain PyTorch versions
on the CPU.
"""

from .ops.embedding_lookup import Ragged, SparseIds, embedding_lookup

__version__ = "0.1.0"

__all__ = ["__version__", "embedding_lookup", "Ragged", "SparseIds"]
