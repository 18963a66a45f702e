"""The synthetic model zoo against the JAX package at toy size: the zoo
configs, ``expand_embedding_configs``, ``average_pool_1d``,
``SyntheticDense`` (with carried flax weights), ``InputGenerator`` and
``build_synthetic``, then the tiny zoo trained 5 steps with
``SparseAdagrad`` on the tables and dense ``Adagrad`` (``optax.adagrad``
in JAX) from one state carried over by ``hybrid_state_from_jax``, in
each Adagrad regime, and a NaN batch after them.

Tolerances, with their reasons:
  - configs, expanded tables, hotness, ids, the slab layout: exact;
  - pooling and the dense half's forward: 1e-6 relative (float32 sums
    in other orders);
  - the trajectory, float32 tables, first 3 steps: losses within 1e-6
    relative; tables within 1e-6; accumulators, dense params and the
    dense Adagrad sums of squares within 1e-5 (MLP sums and ``rsqrt``
    round differently in XLA and PyTorch);
  - steps 4 and 5, float32: at step 4 one ReLU pre-activation of the
    second layer is ~1.8e-7 and rounds to opposite signs in the two
    packages (measured), so that unit's gradient is 0 in one of them and
    Adagrad's normalized step moves its weights there only. Losses
    within 2e-3 relative, tables within 1e-4, accumulators within 1e-3
    relative, dense params within 2e-3 (a fifth of lr), the dense sums
    of squares within 1/4 relative (the flipped unit's g*g);
  - bfloat16 tables and accumulators, all 5 steps: JAX sums duplicate
    ids' rows in bf16, rounding after every add, the port in fp32 with
    one rounding, and the differences feed the next steps: losses within
    2e-2 relative, tables within 8 bf16 ulps of the table's largest
    entry, accumulators within 1/8 relative (a hot row's sum of many
    bf16 adds), dense params within 1e-2, dense sums of squares within
    1/4 relative;
  - the NaN batch: bitwise (both packages skip the whole update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_tpu.models import synthetic as jsyn
from distributed_embeddings_tpu.models import synthetic_configs as jcfgs
from distributed_embeddings_tpu.parallel import (
    SparseAdagrad as JaxSparseAdagrad, init_hybrid_state as jax_init)
from distributed_embeddings_tpu.parallel.trainer import (
    make_hybrid_train_step as jax_train_step)

from distributed_embeddings_torch.models import (
    InputGenerator, SyntheticDense, average_pool_1d, build_synthetic,
    expand_embedding_configs, synthetic_models_v3)
from distributed_embeddings_torch.models import synthetic_configs as tcfgs
from distributed_embeddings_torch.ops.packed_slab import unpack_rows_np
from distributed_embeddings_torch.parallel import (
    Adagrad, SparseAdagrad, init_hybrid_state, make_hybrid_train_loop,
    make_hybrid_train_step)
from distributed_embeddings_torch.utils.convert import (
    hybrid_state_from_jax, load_flax_dense)

from torch_parity import to_np

torch.set_num_threads(1)

CAP = 500       # rows per table
B = 64
LR = 0.01       # both optimizers' lr, as bench.py:run_tiny_zoo trains
STEPS = 5
TIGHT_STEPS = 3  # float32 steps before a ReLU flips (see the docstring)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REGIMES = {"dense": 6.0, "sparse": None}


def _as_tuple(cfg):
    return tuple(tuple(e) for e in cfg.embedding_configs), tuple(
        cfg[1:])


def test_zoo_configs_and_expansion_match_jax():
    assert list(tcfgs.synthetic_models_v3) == list(jcfgs.synthetic_models_v3)
    for name, cfg in tcfgs.synthetic_models_v3.items():
        want = jcfgs.synthetic_models_v3[name]
        assert cfg.name == want.name
        assert _as_tuple(cfg) == _as_tuple(want)
        assert expand_embedding_configs(cfg) == \
            jsyn.expand_embedding_configs(want)
    tables, imap, hot = expand_embedding_configs(synthetic_models_v3["tiny"])
    assert (len(tables), len(imap), sum(hot)) == (55, 58, 85)
    bad = tcfgs.ModelConfig("bad", [tcfgs.EmbeddingConfig(2, [1, 3], 10, 8,
                                                          False)],
                            [4], 1, None)
    with pytest.raises(NotImplementedError, match="Nonshared multihot"):
        expand_embedding_configs(bad)


@pytest.mark.parametrize("t,stride", [(24, 7), (21, 7), (5, 8), (16, 1)])
def test_average_pool_matches_jax(t, stride):
    x = np.random.default_rng(t).normal(size=(3, t)).astype(np.float32)
    got = average_pool_1d(torch.from_numpy(x), stride).numpy()
    want = np.asarray(jsyn.average_pool_1d(jnp.asarray(x), stride))
    assert got.shape == want.shape == (3, -(-t // stride))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("stride", [None, 7])
def test_synthetic_dense_matches_flax(stride):
    widths = [8, 16, 16, 8]
    rng = np.random.default_rng(5)
    num = rng.normal(size=(6, 3)).astype(np.float32)
    embs = [rng.normal(size=(6, w)).astype(np.float32) for w in widths]
    flax_mod = jsyn.SyntheticDense(mlp_sizes=(16, 8), interact_stride=stride)
    params = flax_mod.init(jax.random.key(0), jnp.asarray(num[:2]),
                           [jnp.zeros((2, w)) for w in widths])
    want = np.asarray(flax_mod.apply(params, jnp.asarray(num),
                                     [jnp.asarray(e) for e in embs]))
    mod = SyntheticDense((16, 8), sum(widths), 3, interact_stride=stride,
                         device="cpu")
    assert [lin.bias.abs().sum().item() for lin in mod.linears()] == \
        [0.0] * 3  # flax's zero bias init
    load_flax_dense(mod, jax.tree.map(np.asarray, params))
    got = mod(torch.from_numpy(num), [torch.from_numpy(e) for e in embs])
    assert got.shape == (6, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("alpha,row_cap", [(0.0, None), (1.05, 300)])
def test_input_generator_matches_jax(alpha, row_cap):
    cfg = synthetic_models_v3["tiny"]
    tg = InputGenerator(cfg, 16, alpha=alpha, num_batches=2, seed=3,
                        row_cap=row_cap, device="cpu")
    jg = jsyn.InputGenerator(jcfgs.model_tiny, 16, alpha=alpha,
                             num_batches=2, seed=3, row_cap=row_cap)
    assert len(tg) == len(jg) == 2
    for k in range(3):  # wraps around
        (tn, tc, tl), (jn, jc, jl) = tg[k], jg[k]
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert len(tc) == len(jc) == 58
        for a, b in zip(tc, jc):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if row_cap is not None:
        assert max(int(c.max()) for c in tg[0][1]) < row_cap


def test_build_synthetic_matches_jax():
    jde, _, jhot = jsyn.build_synthetic(jcfgs.model_tiny, 1, row_cap=CAP)
    tde, dense, thot = build_synthetic(synthetic_models_v3["tiny"], 1,
                                       row_cap=CAP, device="cpu")
    assert thot == jhot
    assert tde.rows_cap == jde.rows_cap
    assert tde.row_offsets_list == jde.row_offsets_list
    assert dense.linears()[0].in_features == 32 * 8 + 26 * 16 + 10
    assert [lin.out_features for lin in dense.linears()] == [256, 128, 1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_synthetic(synthetic_models_v3["tiny"], 1, row_cap=CAP)


# ------------------------------------------------------- the tiny zoo, trained


def _mse_jax(dense):
    def loss(p, outs, batch):
        n, y = batch
        return jnp.mean((dense.apply(p, n, outs) - y) ** 2)
    return loss


def _mse(dense_mod, outs, batch):
    n, y = batch
    return torch.mean((dense_mod(n, outs) - y) ** 2)


def _snapshot(tde, state):
    """Host copies of every tensor of a port state."""
    return dict(
        tables=[t.copy() for t in tde.get_weights(state.emb_params)],
        acc={k: v.clone() for k, v in state.emb_opt_state.items()},
        dense=[p.detach().clone() for p in state.dense_params.parameters()],
        dense_state=[t.clone() for t in state.dense_opt_state],
        step=int(state.step))


@pytest.fixture(scope="module", params=[
    ("float32", "dense"), ("float32", "sparse"), ("bfloat16", "dense"),
    ("bfloat16", "sparse")], ids=lambda p: f"{p[0]}-{p[1]}")
def zoo_run(request):
    """One JAX and one port run of the capped tiny zoo from one state:
    STEPS steps, then a NaN batch, then one more step."""
    dtype, regime = request.param
    jdt, tdt = DTYPES[dtype]
    ratio = REGIMES[regime]
    jde, jdense, _ = jsyn.build_synthetic(jcfgs.model_tiny, 1, row_cap=CAP)
    jgen = jsyn.InputGenerator(jcfgs.model_tiny, B, alpha=1.05,
                               num_batches=STEPS, seed=0, row_cap=CAP)
    widths = [int(jde.strategy.global_configs[t]["output_dim"])
              for t in jde.strategy.input_table_map]
    dp = jdense.init(jax.random.key(0), jgen[0][0][:2],
                     [jnp.zeros((2, w)) for w in widths])
    tx = optax.adagrad(LR)
    jopt = JaxSparseAdagrad(dense_apply_ratio=ratio)
    jstate = jax_init(jde, jopt, dp, tx, jax.random.key(1), dtype=jdt)
    jstep = jax_train_step(jde, _mse_jax(jdense), tx, jopt, lr_schedule=LR,
                           with_metrics=False, nan_guard=True,
                           telemetry=False)

    tde, tdense, _ = build_synthetic(synthetic_models_v3["tiny"], 1,
                                     row_cap=CAP, device="cpu")
    topt = SparseAdagrad(dense_apply_ratio=ratio)
    host = jax.tree.map(np.asarray, jstate)  # before any donating step
    init_tables = [np.asarray(t, np.float32)
                   for t in jde.get_weights(jstate.emb_params)]
    tstate = hybrid_state_from_jax(
        tde, tdense, jde.get_weights(jstate.emb_params), host.dense_params,
        host.step, emb_opt_state=host.emb_opt_state,
        dense_opt_state=host.dense_opt_state, dtype=tdt, device="cpu",
        emb_optimizer=topt, dense_tx=Adagrad(LR))
    tstep = make_hybrid_train_step(tde, _mse, Adagrad(LR), topt,
                                   lr_schedule=LR, nan_guard=True)
    tgen = InputGenerator(synthetic_models_v3["tiny"], B, alpha=1.05,
                          num_batches=STEPS, seed=0, row_cap=CAP,
                          device="cpu")
    jl, tl = [], []
    for k in range(STEPS):
        n, c, y = jgen[k]
        loss, jstate = jstep(jstate, c, (n, y))
        jl.append(float(loss))
        n, c, y = tgen[k]
        loss, tstate = tstep(tstate, c, (n, y))
        tl.append(float(loss))
        if k + 1 == TIGHT_STEPS:
            mid = (jax.tree.map(np.array, jstate), _snapshot(tde, tstate))
    out = dict(dtype=dtype, regime=regime, jde=jde, tde=tde,
               init_tables=init_tables, jl=np.array(jl),
               tl=np.array(tl), jstate=jax.tree.map(np.array, jstate),
               tsnap=_snapshot(tde, tstate), mid=mid)
    # a NaN batch: both skip the update
    n, c, y = tgen[0]
    n = n.clone()
    n[3, 4] = float("nan")
    loss, tstate = tstep(tstate, c, (n, y))
    jn = np.asarray(jgen[0][0]).copy()
    jn[3, 4] = np.nan
    jloss, jstate = jstep(jstate, jgen[0][1], (jnp.asarray(jn), jgen[0][2]))
    out.update(nan_losses=(float(jloss), float(loss)),
               nan_jstate=jax.tree.map(np.array, jstate),
               nan_tsnap=_snapshot(tde, tstate))
    return out


def _compare(run, jstate, tsnap, tight):
    """Port state against JAX state; ``tight``: the float32 bounds of the
    first steps, else the bounds of the dtype after 5 steps."""
    jde = run["jde"]
    bf16 = run["dtype"] == "bfloat16"
    t_acc, t_dense, t_sos = ((1e-5, 1e-5, 1e-5) if tight else
                             (0.125, 1e-2, 0.25) if bf16 else
                             (1e-3, 2e-3, 0.25))
    for i, (g, w) in enumerate(zip(tsnap["tables"],
                                   jde.get_weights(jstate.emb_params))):
        w = np.asarray(w, np.float32)
        tol = (8 * 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7) if bf16
               else 1e-6 if tight else 1e-4)
        np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                   err_msg=f"table {i}")
    for k, acc in tsnap["acc"].items():
        want = unpack_rows_np(to_np(jstate.emb_opt_state[k][0]),
                              acc.shape[-1])
        np.testing.assert_allclose(to_np(acc[0]), want, rtol=t_acc, atol=0,
                                   err_msg=f"accumulator {k}")
    tree = jstate.dense_params["params"]
    sos = jstate.dense_opt_state[0].sum_of_squares["params"]
    names = sorted(tree, key=lambda k: int(k.split("_")[-1]))
    want_p, want_s = [], []
    for name in names:
        want_p += [tree[name]["kernel"].T, tree[name]["bias"]]
        want_s += [sos[name]["kernel"].T, sos[name]["bias"]]
    for got, want in zip(tsnap["dense"], want_p):
        np.testing.assert_allclose(got.numpy(), want, atol=t_dense, rtol=0)
    for got, want in zip(tsnap["dense_state"], want_s):
        np.testing.assert_allclose(got.numpy(), want, rtol=t_sos, atol=0)
    assert tsnap["step"] == int(jstate.step)


def test_zoo_trajectory_matches_jax(zoo_run):
    """5 steps of the capped tiny zoo, in each Adagrad regime (the
    default ratio sends both slabs dense at this size; ``None`` forces
    the sparse regime: dedup + per-row update)."""
    run = zoo_run
    bf16 = run["dtype"] == "bfloat16"
    assert np.isfinite(run["tl"]).all()
    k = TIGHT_STEPS
    np.testing.assert_allclose(run["tl"][:k], run["jl"][:k],
                               rtol=2e-2 if bf16 else 1e-6)
    np.testing.assert_allclose(run["tl"], run["jl"],
                               rtol=2e-2 if bf16 else 2e-3)
    _compare(run, *run["mid"], tight=not bf16)
    _compare(run, run["jstate"], run["tsnap"], tight=False)
    assert any((a != b).any() for a, b in zip(run["tsnap"]["tables"],
                                              run["init_tables"]))


def test_zoo_nan_batch_skips_update_bitwise(zoo_run):
    """A NaN numerical feature: both packages return a non-finite loss,
    leave tables, accumulators, dense params and the dense Adagrad state
    bitwise unchanged, and advance the step."""
    run = zoo_run
    assert not any(np.isfinite(run["nan_losses"]))
    before, after = run["tsnap"], run["nan_tsnap"]
    for a, b in zip(before["tables"], after["tables"]):
        np.testing.assert_array_equal(a, b)
    for k in before["acc"]:
        assert torch.equal(before["acc"][k], after["acc"][k])
    for a, b in zip(before["dense"] + before["dense_state"],
                    after["dense"] + after["dense_state"]):
        assert torch.equal(a, b)
    assert after["step"] == before["step"] + 1 == STEPS + 1
    jax.tree.map(np.testing.assert_array_equal,
                 (run["jstate"].emb_params, run["jstate"].emb_opt_state,
                  run["jstate"].dense_params, run["jstate"].dense_opt_state),
                 (run["nan_jstate"].emb_params,
                  run["nan_jstate"].emb_opt_state,
                  run["nan_jstate"].dense_params,
                  run["nan_jstate"].dense_opt_state))
    assert int(run["nan_jstate"].step) == STEPS + 1


def test_init_state_and_loop_on_the_zoo():
    """``init_hybrid_state`` builds the Adagrad accumulators beside the
    slabs (0.1, the slab's dtype) and the dense Adagrad sums; the loop
    over stacked batches equals single steps bitwise."""
    cfg = synthetic_models_v3["tiny"]
    results = []
    for use_loop in (False, True):
        de, dense, _ = build_synthetic(
            cfg, 1, row_cap=60, device="cpu",
            generator=torch.Generator().manual_seed(0))
        state = init_hybrid_state(de, SparseAdagrad(), dense, Adagrad(LR),
                                  generator=torch.Generator().manual_seed(1),
                                  dtype=torch.bfloat16, device="cpu")
        for k, v in state.emb_opt_state.items():
            assert v.shape == state.emb_params[k].shape
            assert v.dtype == torch.bfloat16
            assert torch.equal(v, torch.full_like(v, 0.1))
        assert len(state.dense_opt_state) == 6
        gen = InputGenerator(cfg, 8, alpha=1.05, num_batches=3, seed=2,
                             row_cap=60, device="cpu")
        if use_loop:
            loop = make_hybrid_train_loop(de, _mse, Adagrad(LR),
                                          SparseAdagrad(), lr_schedule=LR)
            cats = [torch.stack([gen[k][1][i] for k in range(3)])
                    for i in range(58)]
            losses, state = loop(state, cats, (
                torch.stack([gen[k][0] for k in range(3)]),
                torch.stack([gen[k][2] for k in range(3)])))
        else:
            step = make_hybrid_train_step(de, _mse, Adagrad(LR),
                                          SparseAdagrad(), lr_schedule=LR)
            losses = []
            for k in range(3):
                n, c, y = gen[k]
                loss, state = step(state, c, (n, y))
                losses.append(loss)
            losses = torch.stack(losses)
        results.append((losses, _snapshot(de, state)))
    (l0, s0), (l1, s1) = results
    assert torch.equal(l0, l1) and s0["step"] == s1["step"] == 3
    for a, b in zip(s0["tables"], s1["tables"]):
        np.testing.assert_array_equal(a, b)
    for k in s0["acc"]:
        assert torch.equal(s0["acc"][k], s1["acc"][k])
        assert not torch.equal(s0["acc"][k],
                               torch.full_like(s0["acc"][k], 0.1))
    for a, b in zip(s0["dense_state"], s1["dense_state"]):
        assert torch.equal(a, b)
