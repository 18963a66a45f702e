"""Learning-rate schedules (counterpart of
``distributed_embeddings_tpu/models/schedules.py``, the reference's
``LearningRateScheduler``, ``examples/dlrm/utils.py:45-88``): linear
warmup, a constant plateau, then polynomial (power-2) decay. A schedule
is a ``step -> lr`` function, usable by the dense optimizers
(``parallel/optimizers.py:SGD``/``Adam``) and by the sparse embedding
optimizers (``make_hybrid_train_step(lr_schedule=...)``) alike.
"""

from __future__ import annotations

import torch


def warmup_poly_decay_schedule(base_lr: float, warmup_steps: int,
                               decay_start_step: int, decay_steps: int,
                               poly_power: int = 2):
    """``step -> lr``: ramp 0 -> ``base_lr`` over ``warmup_steps``, hold,
    then decay to 0 over ``decay_steps`` with ``(remaining /
    decay_steps) ** poly_power``. The step is a tensor (the train
    state's 0-d int32 ``step``, an optimizer's count) or a number; the
    lr is a 0-d float32 tensor on the step's device (the CPU for a
    number), computed in float32 in the JAX package's op order."""
    decay_end_step = decay_start_step + decay_steps

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warmup = 1.0 - (warmup_steps - step) / warmup_steps
        decay = ((decay_end_step - step) / decay_steps).clamp(
            0.0, 1.0) ** poly_power
        factor = torch.where(
            step < warmup_steps, warmup,
            torch.where(step < decay_start_step, torch.ones_like(step),
                        decay))
        return base_lr * factor

    return schedule
