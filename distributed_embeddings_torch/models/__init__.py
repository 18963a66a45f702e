"""Models built on the port's embedding layers."""

from .dlrm import (DLRM, DLRMConfig, DLRMDense, bce_with_logits,
                   dlrm_initializer, dot_interact)

__all__ = ["DLRM", "DLRMConfig", "DLRMDense", "bce_with_logits",
           "dlrm_initializer", "dot_interact"]
