"""The port's world-1 ``DistributedEmbedding`` against the JAX package's:
the same tables (carried across by ``get_weights`` -> ``set_weights``)
and the same ids give the same outputs, in the same order and ranks.

Tolerances: gathers and bf16 sums are bit-exact (both accumulate in
fp32 and round once); ``mean`` over hotness > 1 is within 1 bf16 ulp
(the JAX lookup rounds the sum before dividing); fp32 reductions differ
only in summation order (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE)

from distributed_embeddings_torch import Ragged
from distributed_embeddings_torch.models import dlrm_initializer
from distributed_embeddings_torch.parallel import DistributedEmbedding

from torch_parity import assert_within_ulps, to_np

torch.set_num_threads(1)

CONFIGS = [
    {"input_dim": 40, "output_dim": 8, "combiner": None},
    {"input_dim": 33, "output_dim": 8, "combiner": "sum"},
    {"input_dim": 57, "output_dim": 16, "combiner": "mean"},
    {"input_dim": 21, "output_dim": 16, "combiner": None},
    {"input_dim": 64, "output_dim": 128, "combiner": "sum"},
    {"input_dim": 9, "output_dim": 128, "combiner": "mean"},
]
# input i reads table INPUT_TABLE_MAP[i]; tables 1 and 4 are shared
INPUT_TABLE_MAP = [0, 1, 2, 3, 4, 5, 1, 4]
# (shape after the batch dim) per input; combiner inputs reduce the last
SHAPES = [(), (3,), (3,), (2,), (1,), (2, 3), (1,), (3,)]
B = 5


def _inputs(rng, lo=-2, hi_pad=2):
    out = []
    for t, shp in zip(INPUT_TABLE_MAP, SHAPES):
        v = CONFIGS[t]["input_dim"]
        out.append(rng.integers(lo, v + hi_pad, size=(B,) + shp)
                   .astype(np.int32))
    return out


def _tables(rng):
    return [rng.normal(size=(c["input_dim"], c["output_dim"]))
            .astype(np.float32) for c in CONFIGS]


def _pair(**kw):
    return (JaxDE(CONFIGS, world_size=1, input_table_map=INPUT_TABLE_MAP,
                  **{k: v[0] for k, v in kw.items()}),
            DistributedEmbedding(CONFIGS, world_size=1,
                                 input_table_map=INPUT_TABLE_MAP,
                                 **{k: v[1] for k, v in kw.items()}))


def _jax_forward(jde, params, ids):
    """The JAX forward, jitted (one compile instead of one per op)."""
    fn = jax.jit(lambda p, *xs: jde(p, list(xs)))
    return fn(params, *[jnp.asarray(i) for i in ids])


def _check(got, want, mean_reduced, dtype):
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    elif mean_reduced:
        assert_within_ulps(got, want, want, 1)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,compute", [
    ("float32", None), ("bfloat16", "bfloat16"), ("float32", "bfloat16")])
def test_forward_matches_jax(dtype, compute):
    rng = np.random.default_rng(5)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jde, tde = _pair(compute_dtype=(
        jdt[compute] if compute else None, tdt[compute] if compute else None))
    jparams = jde.set_weights(_tables(rng), dtype=jdt[dtype])
    # the JAX tables (bf16 as ml_dtypes arrays) are what the port loads
    tparams = tde.set_weights(jde.get_weights(jparams), dtype=tdt[dtype],
                              device="cpu")
    ids = _inputs(rng)
    want = _jax_forward(jde, jparams, ids)
    got = tde(tparams, [torch.from_numpy(i) for i in ids])
    assert len(got) == len(want) == len(ids)
    rounded = "bfloat16" in (dtype, compute)
    for i, (g, w) in enumerate(zip(got, want)):
        comb = CONFIGS[INPUT_TABLE_MAP[i]]["combiner"]
        mean3 = comb == "mean" and SHAPES[i][-1] > 1
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        _check(to_np(g), to_np(w), mean3,
               "bfloat16" if rounded else "float32")


@pytest.mark.parametrize("policy", ["masked_reads", "drop"])
def test_masked_reads_match_jax(policy):
    """Out-of-range ids read a zero row instead of clipping."""
    rng = np.random.default_rng(8)
    kw = ({"masked_reads": (True, True)} if policy == "masked_reads"
          else {"invalid_id_policy": ("drop", "drop")})
    jde, tde = _pair(**kw)
    tables = _tables(rng)
    jparams = jde.set_weights(tables)
    tparams = tde.set_weights(tables, device="cpu")
    ids = _inputs(rng, lo=-6, hi_pad=6)
    want = _jax_forward(jde, jparams, ids)
    got = tde(tparams, [torch.from_numpy(i) for i in ids])
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), rtol=1e-6, atol=1e-6)


def test_int64_ids_match_int32():
    rng = np.random.default_rng(9)
    tde = DistributedEmbedding(CONFIGS, world_size=1,
                               input_table_map=INPUT_TABLE_MAP)
    tparams = tde.set_weights(_tables(rng), device="cpu")
    ids = _inputs(rng)
    a = tde(tparams, [torch.from_numpy(i) for i in ids])
    b = tde(tparams, [torch.from_numpy(i.astype(np.int64)) for i in ids])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weights_roundtrip(dtype):
    """JAX tables -> port -> host equals the JAX tables, and the port's
    own get_weights -> set_weights reproduces its slabs bit for bit."""
    rng = np.random.default_rng(3)
    jde, tde = _pair()
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jtables = jde.get_weights(jde.set_weights(_tables(rng), dtype=jdtype))
    tparams = tde.set_weights(jtables, dtype=dtype, device="cpu")
    back = tde.get_weights(tparams)
    for a, b in zip(back, jtables):
        np.testing.assert_array_equal(a, to_np(b))
    again = tde.set_weights(back, dtype=dtype, device="cpu")
    assert again.keys() == tparams.keys()
    for k in tparams:
        assert torch.equal(again[k], tparams[k])
        assert tparams[k].shape == (1, tde.rows_cap[int(k[1:])],
                                    int(k[1:]))


def test_init_fills_in_place_with_the_right_distribution():
    """Defaults draw U(-0.05, 0.05); DLRM tables U(+-1/sqrt(rows)) per
    table; rows between and after tables are zero. A distribution match
    (the two packages draw different numbers from a seed)."""
    configs = [{"input_dim": 3000, "output_dim": 16},
               {"input_dim": 5000, "output_dim": 16,
                "embeddings_initializer": dlrm_initializer(5000)},
               {"input_dim": 4001, "output_dim": 16,
                "embeddings_initializer": dlrm_initializer(4001)},
               {"input_dim": 2000, "output_dim": 8}]
    tde = DistributedEmbedding(configs, world_size=1)
    params = tde.init(torch.Generator().manual_seed(0), device="cpu")
    tables = tde.get_weights(params)
    for t, cfg, bound in zip(tables, configs,
                             [0.05, 5000 ** -0.5, 4001 ** -0.5, 0.05]):
        assert np.abs(t).max() <= bound
        assert np.abs(t).max() > 0.98 * bound
        assert abs(t.mean()) < 0.02 * bound
        np.testing.assert_allclose(t.std(), bound / np.sqrt(3), rtol=0.02)
    w16 = params["w16"][0]
    roff = tde.row_offsets_list[0]
    assert torch.count_nonzero(w16[roff[2] + 4001:]) == 0
    assert torch.count_nonzero(w16[roff[0] + 3000:roff[1]]) == 0


def test_unported_paths_raise():
    # world > 1 is ported: the layer places and slices the tables as the
    # JAX package does, and runs only inside a process group
    configs = CONFIGS + CONFIGS[:2]
    kw = dict(world_size=8, strategy="comm_balanced",
              column_slice_threshold=1000)
    tde, jde = DistributedEmbedding(configs, **kw), JaxDE(configs, **kw)
    assert tde.strategy.table_ids_list == jde.strategy.table_ids_list
    assert tde.row_offsets_list == jde.row_offsets_list
    assert tde.rows_cap == jde.rows_cap
    assert sum(tde.slices_per_table) > len(configs)  # column slices
    with pytest.raises(RuntimeError, match="process group"):
        tde.init(device="cpu")
    # model-parallel input and row slicing are ported; world 1 never
    # row-slices, and the threshold is an int
    assert not DistributedEmbedding(configs, world_size=8,
                                    dp_input=False).dp_input
    one = DistributedEmbedding(CONFIGS, world_size=1, row_slice=100)
    assert not one.strategy.row_sliced_tables
    assert one.slices_per_table == [1] * len(CONFIGS)
    with pytest.raises(TypeError, match="row_slice"):
        DistributedEmbedding(CONFIGS, world_size=1, row_slice=True)
    # ragged inputs are ported; on a table without a combiner they are
    # refused, as in the JAX package
    tde = DistributedEmbedding(CONFIGS[:1], world_size=1)
    params = tde.init(device="cpu")
    with pytest.raises(ValueError, match="combiner"):
        tde(params, [Ragged.from_lists([[1, 2], [3]])])


def test_default_device_is_the_card():
    """Without a card, asking for the default device raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    tde = DistributedEmbedding(CONFIGS[:1], world_size=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tde.init()
