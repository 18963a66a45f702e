"""Slab geometry of width-grouped tables (counterpart of
``distributed_embeddings_tpu/ops/packed_slab.py``).

The JAX package packs ``p = 128 // w`` narrow logical rows into each
128-lane physical row, a layout for the TPU's full-tile gather path.
The port keeps LOGICAL ``[rows, w]`` slabs: a GPU gathers a 16-wide
row as well as a packed one. What it keeps of the packed layout is the
row ALIGNMENT, so every table starts at the same logical row offset as
in the JAX package and the two packages build identical exchange
plans; parity is held on the logical tables (``get_weights``).
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 128


def pack_factor(width: int) -> int:
    """Logical rows per physical row of the JAX layout: ``floor(128/w)``
    for narrow tables, 1 for ``w >= 128``."""
    return max(1, LANES // int(width))


def align_rows(rows: int, width: int) -> int:
    """Logical row count rounded up to a physical-row boundary of the
    JAX layout (tables never share one)."""
    p = pack_factor(width)
    return -(-int(rows) // p) * p


def unpack_rows_np(phys: np.ndarray, width: int) -> np.ndarray:
    """Host-side unpacking of the JAX package's lane-packed rows (the
    port's copy of its ``ops/packed_slab.py:unpack_rows_np``):
    ``[m, 128]`` physical rows -> ``[m * p, w]`` logical rows."""
    p = pack_factor(width)
    if p == 1:
        return phys
    m = phys.shape[0]
    return phys[:, :p * width].reshape(m * p, width)


def packed_gather(slab: torch.Tensor, logical_ids: torch.Tensor,
                  width: int) -> torch.Tensor:
    """Gather logical rows ``[..., w]`` of a ``[rows, w]`` slab for any id
    shape, clipping ids into ``[0, rows - 1]`` as the JAX gather's
    ``mode="clip"`` does. Runs on the gather kernel (K1)."""
    from .embedding_lookup import embedding_lookup

    if slab.shape[1] != int(width):
        raise ValueError(f"slab width {slab.shape[1]} != {width}")
    return embedding_lookup(slab, logical_ids)
