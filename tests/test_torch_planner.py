"""The port's planner against the JAX package's: the same table configs
give the same placement (``plan_spec``), the same slab row offsets and
the same exchange-plan arrays, for every strategy at world 1 and 8,
with column and row slicing. Plans are integer bookkeeping: equality is
exact."""

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE)
from distributed_embeddings_tpu.parallel import plan as jax_plan

from distributed_embeddings_torch.parallel import DistEmbeddingStrategy
from distributed_embeddings_torch.parallel import build_plan
from distributed_embeddings_torch.parallel.dist_embedding import slab_layout

torch.set_num_threads(1)

STRATEGIES = ["basic", "memory_balanced", "memory_optimized",
              "comm_balanced"]


def _configs(rng, n=12):
    widths = [8, 16, 128]
    combs = [None, "sum", "mean"]
    return [{"input_dim": int(rng.integers(5, 400)),
             "output_dim": widths[i % 3],
             "combiner": combs[(i // 3) % 3]} for i in range(n)]


def _encs(configs, input_table_map):
    """Mixed dense encodings: hotness 1 and 3 (and an N-D input)."""
    encs = []
    for i, t in enumerate(input_table_map):
        comb = configs[t]["combiner"]
        if comb and i % 4 == 1:
            encs.append(("d", 3, 2))  # [b, 2, 3] ids
        elif comb and i % 2:
            encs.append(("d", 3, 1))
        elif comb is None and i % 5 == 0:
            encs.append(("d", 1, 2))  # [b, 2] ids without combiner
        else:
            encs.append(("d", 1, 1))
    return encs


def _assert_plans_equal(a, b):
    assert a.b == b.b and a.l_max == b.l_max and a.s_max == b.s_max
    assert [g.__dict__ for g in a.groups] == [g.__dict__ for g in b.groups]
    assert [i.__dict__ for i in a.instances] == [
        i.__dict__ for i in b.instances]
    for name in ("rows", "roff", "valid", "mean", "rbase", "rsliced"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("world,slicing", [(1, "none"), (8, "none"),
                                           (8, "column"), (8, "row")])
def test_plan_matches_jax(world, strategy, slicing):
    rng = np.random.default_rng(STRATEGIES.index(strategy) * 10 + world)
    configs = _configs(rng)
    input_table_map = list(range(len(configs))) + [0, 4]  # shared tables
    col = 150 * 8 if slicing == "column" else None
    row = 150 * 16 if slicing == "row" else None
    jde = JaxDE(configs, world_size=world, strategy=strategy,
                column_slice_threshold=col, row_slice=row,
                input_table_map=input_table_map)
    st = DistEmbeddingStrategy(configs, world, strategy=strategy,
                               input_table_map=input_table_map,
                               column_slice_threshold=col,
                               row_slice_threshold=row)
    assert st.plan_spec() == jde.strategy.plan_spec()
    for name in ("table_ids_list", "input_ids_list", "local_map_list",
                 "widths_list_flat", "rev_global_input_ids",
                 "sliced_out_ranges", "row_sliced_out_ranges"):
        assert getattr(st, name) == getattr(jde.strategy, name), name
    assert st.row_sliced_tables == jde.strategy.row_sliced_tables
    widths, offsets, rows_cap = slab_layout(st)
    assert widths == jde.widths
    assert offsets == jde.row_offsets_list
    assert rows_cap == jde.rows_cap
    encs = _encs(configs, input_table_map)
    for b in (4, 16):
        _assert_plans_equal(build_plan(st, offsets, encs, b),
                            jax_plan.build_plan(jde.strategy,
                                                jde.row_offsets_list,
                                                encs, b))


def test_strategy_rejects_unknown_mode():
    with pytest.raises(ValueError, match="Unsupported shard strategy"):
        DistEmbeddingStrategy([{"input_dim": 4, "output_dim": 8}], 1,
                              strategy="round_robin")
