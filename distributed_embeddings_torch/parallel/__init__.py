"""Placement planner, the embedding layer, its sparse optimizers, the
process-group layer and the hybrid gradients, the step schedules, the
train and eval steps, streaming vocabularies, and the serving runtime."""

from . import bootstrap, schedule, streaming
from .dist_embedding import DistributedEmbedding, MpInputs
from .grads import (broadcast_variables, hybrid_gradients, mean_flat,
                    resolve_dp_gradient, split_mp_dp)
from .optimizers import (SGD, Adagrad, Adam, AdamState, ScheduleState,
                         SparseAdagrad, SparseAdam, SparseMomentum,
                         SparseSGD, TraceState)
from .plan import ExchangePlan, build_plan
from .schedule import (PhaseDecl, ScheduleError, StepSchedule,
                       default_schedule, pipelined_schedule,
                       resolve_schedule, streaming_schedule)
from .serving import (Expired, Failed, Overloaded, Request, ServeConfig,
                      Served, ServingRuntime, drive, resolve_rungs,
                      synthetic_request)
from .strategy import DistEmbeddingStrategy
from .streaming import StreamingConfig, init_streaming
from .trainer import (HybridTrainState, init_hybrid_state,
                      make_hybrid_eval_step, make_hybrid_train_loop,
                      make_hybrid_train_step)

__all__ = ["DistributedEmbedding", "MpInputs", "ExchangePlan", "build_plan",
           "Expired", "Failed", "Overloaded", "Request", "ServeConfig",
           "Served", "ServingRuntime", "drive", "resolve_rungs",
           "synthetic_request", "DistEmbeddingStrategy",
           "HybridTrainState", "make_hybrid_eval_step",
           "make_hybrid_train_step", "make_hybrid_train_loop",
           "init_hybrid_state", "SGD", "SparseSGD", "Adagrad",
           "SparseAdagrad", "Adam", "SparseAdam", "SparseMomentum",
           "AdamState", "TraceState", "ScheduleState", "StreamingConfig",
           "init_streaming", "streaming", "bootstrap", "schedule",
           "PhaseDecl", "ScheduleError", "StepSchedule", "default_schedule",
           "pipelined_schedule", "resolve_schedule", "streaming_schedule",
           "broadcast_variables", "hybrid_gradients", "mean_flat",
           "resolve_dp_gradient", "split_mp_dp"]
