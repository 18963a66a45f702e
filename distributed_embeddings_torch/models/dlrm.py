"""DLRM (counterpart of ``distributed_embeddings_tpu/models/dlrm.py``).

Bottom MLP over the dense features, one embedding per categorical
feature, the pairwise dot interaction on the hand-written kernels K2
(forward) and K4 (backward) through ``ops/interaction.py:DotInteract``,
and the top MLP to one logit. The dense half is an ``nn.Module`` that
takes the embedding activations as inputs, so they can come from local
tables (:class:`DLRM`) or from
:class:`~..parallel.dist_embedding.DistributedEmbedding`.

Precision follows the flax module: parameters are float32, every layer
computes in ``compute_dtype`` (its weights cast on the fly, as flax's
``Dense(dtype=...)`` does), except the LAST layer, which computes in
float32. The MLP products stay ``torch.nn.functional.linear`` (cuBLAS),
as the JAX package leaves them to XLA outside any kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.embedding_lookup import embedding_lookup
from ..ops.interaction import DotInteract
from ..utils.device import resolve_device


def dlrm_initializer(rows: int):
    """In-place ``U(-1/sqrt(rows), +1/sqrt(rows))`` table initializer
    (the reference's ``DLRMInitializer``)."""
    maxval = 1.0 / math.sqrt(rows)

    def init(out: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return out.uniform_(-maxval, maxval, generator=generator)

    return init


def dot_interact(emb_outs: Sequence[torch.Tensor],
                 bottom_mlp_out: torch.Tensor) -> torch.Tensor:
    """Pairwise dot-product interaction of the features ``[bottom_mlp_out]
    + emb_outs`` (each ``[B, D]``): the strictly lower triangle of each
    sample's Gram matrix (``np.tril_indices(F, -1)`` order) followed by
    ``bottom_mlp_out``: ``[B, F(F-1)/2 + D]``. One launch of K2, which
    reads the features where they lie (no stack is built); its gradient
    is one launch of K4, each feature's a contiguous ``[B, D]`` view of
    one buffer."""
    return DotInteract.apply(bottom_mlp_out, *emb_outs)


class DLRMConfig:
    """Model hyperparameters (``compute_dtype`` is a torch dtype)."""

    def __init__(self,
                 table_sizes: Sequence[int] = (1000,) * 26,
                 embedding_dim: int = 128,
                 num_numerical_features: int = 13,
                 bottom_mlp_dims: Sequence[int] = (512, 256, 128),
                 top_mlp_dims: Sequence[int] = (1024, 1024, 512, 256, 1),
                 compute_dtype: torch.dtype = torch.float32):
        if bottom_mlp_dims[-1] != embedding_dim:
            raise ValueError(
                "bottom MLP must project to embedding_dim for dot interaction")
        self.table_sizes = list(table_sizes)
        self.embedding_dim = embedding_dim
        self.num_numerical_features = num_numerical_features
        self.bottom_mlp_dims = list(bottom_mlp_dims)
        self.top_mlp_dims = list(top_mlp_dims)
        self.compute_dtype = compute_dtype

    def embedding_configs(self, combiner: Optional[str] = None):
        """Table configs for :class:`DistributedEmbedding`."""
        return [{
            "input_dim": int(s),
            "output_dim": self.embedding_dim,
            "combiner": combiner,
            "embeddings_initializer": dlrm_initializer(int(s)),
        } for s in self.table_sizes]


def _linear(fan_in: int, fan_out: int, dev, generator) -> nn.Linear:
    """A float32 ``Linear`` initialized as the flax module is: truncated-
    normal Glorot kernel, ``N(0, 1/fan_out)`` bias."""
    lin = nn.Linear(fan_in, fan_out, device=dev, dtype=torch.float32)
    # flax's variance_scaling(1, "fan_avg", "truncated_normal"): the std of
    # a unit normal truncated to [-2, 2] is .8796..., divided out
    std = math.sqrt(2.0 / (fan_in + fan_out)) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        lin.bias.normal_(0.0, math.sqrt(1.0 / fan_out), generator=generator)
    return lin


class DLRMDense(nn.Module):
    """The data-parallel half: bottom MLP -> dot interaction -> top MLP.

    ``forward(numerical_features [B, n], embedding_outputs [B, D] each)
    -> logits [B, 1]`` (float32).
    """

    def __init__(self, config: DLRMConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        cfg = config
        dims = [cfg.num_numerical_features] + cfg.bottom_mlp_dims
        self.bottom = nn.ModuleList(
            _linear(a, b, dev, generator) for a, b in zip(dims, dims[1:]))
        n_feat = len(cfg.table_sizes) + 1
        inter = n_feat * (n_feat - 1) // 2 + cfg.embedding_dim
        dims = [inter] + cfg.top_mlp_dims
        self.top = nn.ModuleList(
            _linear(a, b, dev, generator) for a, b in zip(dims, dims[1:]))

    def linears(self):
        """Every ``Linear`` in flax order (``Dense_0`` first)."""
        return list(self.bottom) + list(self.top)

    def forward(self, numerical_features: torch.Tensor,
                embedding_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
        dt = self.config.compute_dtype
        x = numerical_features.to(dt)
        for lin in self.bottom:
            x = F.relu(F.linear(x, lin.weight.to(dt), lin.bias.to(dt)))
        y = dot_interact([e.to(dt) for e in embedding_outputs], x)
        for lin in self.top[:-1]:
            y = F.relu(F.linear(y, lin.weight.to(dt), lin.bias.to(dt)))
        last = self.top[-1]
        return F.linear(y.float(), last.weight, last.bias)


class DLRM(nn.Module):
    """Local (single-device) float32 embedding tables + :class:`DLRMDense`.

    ``forward(numerical_features, categorical_features)`` with one
    ``[B]`` (or ``[B, 1]``) id tensor per table. Ids clip into each
    table, as everywhere in the port."""

    def __init__(self, config: DLRMConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        tables = []
        for size in config.table_sizes:
            t = torch.empty((size, config.embedding_dim), dtype=torch.float32,
                            device=dev)
            dlrm_initializer(size)(t, generator)
            tables.append(nn.Parameter(t, requires_grad=False))
        self.tables = nn.ParameterList(tables)
        self.dense = DLRMDense(config, device=dev, generator=generator)

    def forward(self, numerical_features: torch.Tensor,
                categorical_features: Sequence[torch.Tensor]
                ) -> torch.Tensor:
        embs = [embedding_lookup(t, ids.reshape(-1))
                for t, ids in zip(self.tables, categorical_features)]
        return self.dense(numerical_features, embs)


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits (the JAX package's formula,
    ``max(x, 0) - x*y + log1p(exp(-|x|))``)."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    return torch.mean(logits.clamp(min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))
