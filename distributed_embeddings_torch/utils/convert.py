"""Carry weights from the JAX package into the port.

* Tables: the JAX ``DistributedEmbedding.get_weights`` list (host numpy,
  bfloat16 tables as ``ml_dtypes`` arrays) goes into the port's
  ``DistributedEmbedding.set_weights`` through :func:`host_tensor`.
* Dense half: the flax ``DLRMDense`` parameter tree, as numpy
  (``params/Dense_0..Dense_k/{kernel [in, out], bias [out]}``), goes
  into the torch :class:`~..models.dlrm.DLRMDense` through
  :func:`load_flax_dense`; a flax kernel becomes ``Linear.weight`` of
  shape ``[out, in]``.
* Train state: :func:`hybrid_state_from_jax` builds the port's
  ``HybridTrainState`` from those two plus the JAX state's optimizer
  states and step, so both packages train from one state.

Nothing here imports JAX: the arrays arrive as numpy.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch


def host_tensor(a: Any) -> torch.Tensor:
    """CPU tensor from a numpy array (``ml_dtypes`` bfloat16 included:
    numpy has no bfloat16 of its own, so such arrays cross as float32,
    which holds every bfloat16 value exactly) or from a tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def load_flax_dense(module, params: Mapping[str, Any]) -> None:
    """Copy a flax ``DLRMDense`` tree (``{"params": {...}}`` or its inner
    dict) into ``module`` (a torch ``DLRMDense``) in place."""
    tree = params.get("params", params)
    linears = list(module.linears())
    names = sorted(tree, key=lambda k: int(k.split("_")[-1]))
    if len(names) != len(linears):
        raise ValueError(f"flax tree has {len(names)} Dense layers, the "
                         f"module {len(linears)}")
    with torch.no_grad():
        for name, lin in zip(names, linears):
            kernel = host_tensor(tree[name]["kernel"])
            bias = host_tensor(tree[name]["bias"])
            if tuple(kernel.shape) != (lin.in_features, lin.out_features):
                raise ValueError(f"{name}: kernel {tuple(kernel.shape)} does "
                                 f"not fit Linear({lin.in_features}, "
                                 f"{lin.out_features})")
            lin.weight.copy_(kernel.t())
            lin.bias.copy_(bias)


def _leaf_count(tree) -> int:
    """Array leaves of a nested tuple/list/dict (namedtuples included)."""
    if isinstance(tree, dict):
        return sum(_leaf_count(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_leaf_count(v) for v in tree)
    return 0 if tree is None else 1


def hybrid_state_from_jax(de, dense, tables: Sequence[Any],
                          dense_tree: Mapping[str, Any], step,
                          emb_opt_state=None, dense_opt_state=None,
                          dtype: torch.dtype = torch.float32,
                          device="cuda"):
    """The port's ``HybridTrainState`` from a JAX one, given as numpy:

    * ``tables``: the JAX ``DistributedEmbedding.get_weights`` list;
    * ``dense_tree``: the flax ``DLRMDense`` parameters, loaded into
      ``dense`` (a torch ``DLRMDense`` on ``device``) in place;
    * ``step``: the step counter;
    * ``emb_opt_state`` / ``dense_opt_state``: the optimizer states. The
      port's optimizers (``SparseSGD``, ``SGD``) keep none, so they must
      hold no arrays (the stateful optimizers are ROADMAP B8).
    """
    from ..parallel.trainer import HybridTrainState

    for name, st in (("emb_opt_state", emb_opt_state),
                     ("dense_opt_state", dense_opt_state)):
        if _leaf_count(st):
            raise NotImplementedError(
                f"{name} holds arrays: stateful optimizers are not ported "
                "yet (ROADMAP B8)")
    load_flax_dense(dense, dense_tree)
    params = de.set_weights(tables, dtype=dtype, device=device)
    dev = next(iter(params.values())).device
    return HybridTrainState(
        emb_params=params, emb_opt_state={k: () for k in params},
        dense_params=dense, dense_opt_state=(),
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev))
