"""Synthetic benchmark models (counterpart of
``distributed_embeddings_tpu/models/synthetic.py``).

The reference's benchmark model
(``examples/benchmarks/synthetic_models/synthetic_models.py:116-243``):
multi-hot sum-combiner embeddings (distributed), an optional
average-pooling "interaction" that emulates memory-bound FM/pooling
layers, and an MLP head. The dense half is an ``nn.Module`` fed the
embedding activations, composable with
:class:`~..parallel.dist_embedding.DistributedEmbedding` through the
hybrid trainer, like the DLRM model. Its products are
``torch.nn.functional.linear`` (cuBLAS), as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.data import power_law_ids
from ..utils.device import resolve_device
from .synthetic_configs import ModelConfig


def expand_embedding_configs(model_config: ModelConfig
                             ) -> Tuple[List[dict], List[int], List[int]]:
    """Flatten grouped ``EmbeddingConfig`` rows to per-table configs plus
    the input→table map and per-input hotness (reference
    ``synthetic_models.py:130-143``)."""
    table_configs: List[dict] = []
    input_table_map: List[int] = []
    input_hotness: List[int] = []
    for cfg in model_config.embedding_configs:
        if len(cfg.nnz) > 1 and not cfg.shared:
            raise NotImplementedError(
                "Nonshared multihot embedding is not implemented yet")
        for _ in range(cfg.num_tables):
            table_id = len(table_configs)
            table_configs.append({
                "input_dim": int(cfg.num_rows),
                "output_dim": int(cfg.width),
                "combiner": "sum",
            })
            for hotness in cfg.nnz:
                input_table_map.append(table_id)
                input_hotness.append(int(hotness))
    return table_configs, input_table_map, input_hotness


def average_pool_1d(x: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME-padded 1-D average pooling over the feature axis with window
    == stride (the reference's ``AveragePooling1D(...,
    data_format='channels_first')`` on the concatenated embedding
    vector, ``synthetic_models.py:151-155``). A window's average divides
    by its true element count, as Keras does
    (``count_includes_pad=False``)."""
    b, t = x.shape
    pad = (-t) % stride
    if pad:
        x = torch.cat([x, x.new_zeros((b, pad))], dim=1)
    counts = torch.cat([x.new_ones((t,)), x.new_zeros((pad,))])
    sums = x.reshape(b, -1, stride).sum(-1)
    denom = counts.reshape(-1, stride).sum(-1).clamp(min=1)
    return sums / denom[None, :]


def _dense(fan_in: int, fan_out: int, dev, generator) -> nn.Linear:
    """A float32 ``Linear`` initialized as flax's ``nn.Dense`` default:
    truncated-normal LeCun kernel, zero bias."""
    lin = nn.Linear(fan_in, fan_out, device=dev, dtype=torch.float32)
    # variance_scaling(1, "fan_in", "truncated_normal"): the std of a unit
    # normal truncated to [-2, 2] is .8796..., divided out
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        lin.bias.zero_()
    return lin


class SyntheticDense(nn.Module):
    """Dense half: optional pooled interaction + MLP head (reference
    ``synthetic_models.py:150-175``).

    ``forward(numerical_features [B, F], embedding_outputs [B, w] each)
    -> [B, 1]`` (float32). Unlike the flax module, whose first layer
    infers its input width, the torch module is built with it:
    ``embedding_width`` is the width of the concatenated embedding
    outputs (before pooling)."""

    def __init__(self, mlp_sizes: Sequence[int], embedding_width: int,
                 num_numerical_features: int,
                 interact_stride: Optional[int] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.mlp_sizes = tuple(int(s) for s in mlp_sizes)
        self.interact_stride = interact_stride
        width = int(embedding_width)
        if interact_stride is not None:
            width = -(-width // int(interact_stride))
        dims = [width + int(num_numerical_features)] + list(self.mlp_sizes)
        self.mlp = nn.ModuleList(
            _dense(a, b, dev, generator) for a, b in zip(dims, dims[1:]))
        self.head = _dense(dims[-1], 1, dev, generator)

    def linears(self):
        """Every ``Linear`` in flax order (``Dense_0`` first)."""
        return list(self.mlp) + [self.head]

    def forward(self, numerical_features: torch.Tensor,
                embedding_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
        cat = torch.cat([e.reshape(e.shape[0], -1)
                         for e in embedding_outputs], dim=1)
        if self.interact_stride is not None:
            cat = average_pool_1d(cat, self.interact_stride)
        x = torch.cat([cat, numerical_features], dim=1)
        for lin in self.mlp:
            x = F.relu(lin(x))
        return self.head(x)


def build_synthetic(model_config: ModelConfig, world_size: int,
                    strategy: str = "memory_balanced",
                    column_slice_threshold: Optional[int] = None,
                    row_cap: Optional[int] = None, device="cuda",
                    generator: Optional[torch.Generator] = None):
    """Build ``(dist_embedding, dense_module, input_hotness)`` for a zoo
    model; the dense module is built (and initialized) on ``device``.

    ``row_cap`` optionally clips table vocab sizes so the larger zoo
    scales can smoke-run on small hardware; benchmarks run uncapped.
    """
    from ..parallel import DistributedEmbedding

    table_configs, input_table_map, hotness = expand_embedding_configs(
        model_config)
    if row_cap is not None:
        for cfg in table_configs:
            cfg["input_dim"] = min(cfg["input_dim"], row_cap)
    de = DistributedEmbedding(table_configs, world_size=world_size,
                              strategy=strategy,
                              column_slice_threshold=column_slice_threshold,
                              input_table_map=input_table_map,
                              input_hotness=hotness)
    emb_width = sum(table_configs[t]["output_dim"] for t in input_table_map)
    dense = SyntheticDense(model_config.mlp_sizes, emb_width,
                           model_config.num_numerical_features,
                           interact_stride=model_config.interact_stride,
                           device=device, generator=generator)
    return de, dense, hotness


class InputGenerator:
    """Synthetic data-parallel batches: uniform or power-law ids
    (reference ``InputGenerator``, ``synthetic_models.py:51-113``).

    Yields ``(numerical [lbs, F] float32, cats list of [lbs, hotness]
    int32, labels [lbs, 1] float32)`` on ``device``: ids over the full
    (capped) vocab. The numpy draws are the JAX package's, in the same
    order, so one seed gives both packages identical batches.
    """

    def __init__(self, model_config: ModelConfig, global_batch_size: int,
                 alpha: float = 0.0, num_batches: int = 4, seed: int = 0,
                 row_cap: Optional[int] = None, device="cuda"):
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        table_configs, input_table_map, hotness = expand_embedding_configs(
            model_config)
        self.batches = []
        for _ in range(num_batches):
            cats = []
            for inp, h in zip(input_table_map, hotness):
                rows = table_configs[inp]["input_dim"]
                if row_cap is not None:
                    rows = min(rows, row_cap)
                if alpha == 0.0:
                    ids = rng.integers(0, rows, size=(global_batch_size, h))
                else:
                    ids = power_law_ids(rng, rows, (global_batch_size, h),
                                        alpha)
                cats.append(torch.as_tensor(ids.astype(np.int32),
                                            device=dev))
            numerical = torch.as_tensor(
                (rng.random(size=(global_batch_size,
                                  model_config.num_numerical_features))
                 * 100).astype(np.float32), device=dev)
            labels = torch.as_tensor(
                rng.integers(0, 2, size=(global_batch_size, 1)
                             ).astype(np.float32), device=dev)
            self.batches.append((numerical, cats, labels))

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, idx):
        return self.batches[idx % len(self.batches)]
