"""Train state and the eval step (counterpart of
``distributed_embeddings_tpu/parallel/trainer.py``).

This slice carries the serving half: :class:`HybridTrainState` (same
field names; the optimizer fields stay ``None`` for a serving-only
state) and :func:`make_hybrid_eval_step` at world 1. The train step,
its loop and ``init_hybrid_state`` are the next slice (ROADMAP A3–A6).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class HybridTrainState(NamedTuple):
    """All mutable model state. ``emb_params`` is the slab dict
    ``{"w<width>": [world, rows_cap, width]}``; ``dense_params`` is the
    dense module (e.g. a ``DLRMDense``) the ``pred_fn`` calls."""
    emb_params: Any
    emb_opt_state: Any = None
    dense_params: Any = None
    dense_opt_state: Any = None
    step: Any = None


def make_hybrid_eval_step(de, pred_fn: Callable):
    """Build ``eval_step(state, cat_inputs, batch) -> predictions``.

    ``pred_fn(dense_params, emb_outputs, batch)`` maps the embedding
    outputs to predictions. The step runs under ``torch.inference_mode``
    and PyTorch's eager dispatch (nothing to compile). The JAX version's
    ``mesh``, ``dynamic`` and ``donate_inputs`` arguments belong to the
    multi-rank step (ROADMAP A7), streaming tables (A11) and XLA buffer
    reuse; they are not part of this slice.
    """
    if de.world_size != 1:
        raise NotImplementedError(
            "the multi-rank eval step is not ported yet: ROADMAP A7")

    def eval_step(state: HybridTrainState, cat_inputs, batch):
        with torch.inference_mode():
            outs = de(state.emb_params, cat_inputs)
            return pred_fn(state.dense_params, outs, batch)

    return eval_step
