"""Models built on the port's embedding layers."""

from .dlrm import (DLRM, DLRMConfig, DLRMDense, bce_with_logits,
                   dlrm_initializer, dot_interact)
from .learnable import LearnableClicks, train_dlrm_convergence
from .schedules import warmup_poly_decay_schedule
from .synthetic import (InputGenerator, SyntheticDense, average_pool_1d,
                        build_synthetic, expand_embedding_configs)
from .synthetic_configs import (EmbeddingConfig, ModelConfig,
                                synthetic_models_v3)

__all__ = ["DLRM", "DLRMConfig", "DLRMDense", "bce_with_logits",
           "dlrm_initializer", "dot_interact", "InputGenerator",
           "SyntheticDense", "average_pool_1d", "build_synthetic",
           "expand_embedding_configs", "EmbeddingConfig", "ModelConfig",
           "synthetic_models_v3", "LearnableClicks",
           "train_dlrm_convergence", "warmup_poly_decay_schedule"]
