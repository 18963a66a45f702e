"""Placement planner, the world-1 embedding layer, its sparse
optimizers, the train and eval steps, streaming vocabularies, and the
serving runtime."""

from . import streaming
from .dist_embedding import DistributedEmbedding
from .optimizers import (SGD, Adagrad, Adam, AdamState, ScheduleState,
                         SparseAdagrad, SparseAdam, SparseMomentum,
                         SparseSGD, TraceState)
from .plan import ExchangePlan, build_plan
from .serving import (Expired, Failed, Overloaded, Request, ServeConfig,
                      Served, ServingRuntime, drive, resolve_rungs,
                      synthetic_request)
from .strategy import DistEmbeddingStrategy
from .streaming import StreamingConfig, init_streaming
from .trainer import (HybridTrainState, init_hybrid_state,
                      make_hybrid_eval_step, make_hybrid_train_loop,
                      make_hybrid_train_step)

__all__ = ["DistributedEmbedding", "ExchangePlan", "build_plan",
           "Expired", "Failed", "Overloaded", "Request", "ServeConfig",
           "Served", "ServingRuntime", "drive", "resolve_rungs",
           "synthetic_request", "DistEmbeddingStrategy",
           "HybridTrainState", "make_hybrid_eval_step",
           "make_hybrid_train_step", "make_hybrid_train_loop",
           "init_hybrid_state", "SGD", "SparseSGD", "Adagrad",
           "SparseAdagrad", "Adam", "SparseAdam", "SparseMomentum",
           "AdamState", "TraceState", "ScheduleState", "StreamingConfig",
           "init_streaming", "streaming"]
