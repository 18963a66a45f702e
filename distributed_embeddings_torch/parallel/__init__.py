"""Placement planner, the world-1 embedding layer, the eval step and the
serving runtime."""

from .dist_embedding import DistributedEmbedding
from .plan import ExchangePlan, build_plan
from .serving import (Expired, Failed, Overloaded, Request, ServeConfig,
                      Served, ServingRuntime, drive, resolve_rungs,
                      synthetic_request)
from .strategy import DistEmbeddingStrategy
from .trainer import HybridTrainState, make_hybrid_eval_step

__all__ = ["DistributedEmbedding", "ExchangePlan", "build_plan",
           "Expired", "Failed", "Overloaded", "Request", "ServeConfig",
           "Served", "ServingRuntime", "drive", "resolve_rungs",
           "synthetic_request", "DistEmbeddingStrategy",
           "HybridTrainState", "make_hybrid_eval_step"]
