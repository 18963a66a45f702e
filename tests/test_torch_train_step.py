"""The training slice against the JAX package at toy size: the sparse
backward (``parallel/apply.py``), ``sparse_apply_gradients``, and the
hybrid train step, its loop and its non-finite guard on a small DLRM
(4 tables, width 16, small MLPs), both packages starting from one state
carried over with ``utils/convert.py:hybrid_state_from_jax``.

Tolerances, with their reasons:
  - id streams: bit-exact (index arithmetic);
  - update rows: bit-exact in float32; in bfloat16 the ``mean`` division
    rounds the same way in both (one f32 division, one rounding): exact;
  - ``sparse_apply_gradients`` (float32, unique rows and duplicates): the
    same scatter on the same stream, duplicate adds in another order:
    rtol 1e-6;
  - 20-step DLRM trajectory, float32: losses, tables and dense params
    within atol 1e-5 (MLP summation order, compounded over 20 steps);
  - the same in bfloat16 tables and compute: bf16 rounds at other places
    in the two frameworks' matmuls and in the interaction backward (the
    port rounds once, JAX after each einsum): losses within 2e-2, dense
    params within 5e-3, tables within 8 bf16 ulps of the largest entry
    of the table (one ulp per misrounded add, a few adds per row);
  - the non-finite guard: bitwise (both packages skip the whole update).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_tpu.models.dlrm import (
    DLRMConfig as JaxConfig, DLRMDense as JaxDense,
    bce_with_logits as jax_bce)
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE, HybridTrainState as JaxState)
from distributed_embeddings_tpu.parallel import apply as jax_apply
from distributed_embeddings_tpu.parallel.optimizers import (
    SparseSGD as JaxSparseSGD)
from distributed_embeddings_tpu.parallel.trainer import (
    make_hybrid_train_step as jax_train_step)

from distributed_embeddings_torch.models import (
    DLRMConfig, DLRMDense, bce_with_logits)
from distributed_embeddings_torch.parallel import (
    SGD, DistributedEmbedding, SparseSGD, init_hybrid_state,
    make_hybrid_train_loop, make_hybrid_train_step)
from distributed_embeddings_torch.parallel import apply as t_apply
from distributed_embeddings_torch.utils.convert import hybrid_state_from_jax

from torch_parity import to_np

torch.set_num_threads(1)

SIZES = [60, 7, 33, 120]
NUM = 5
DIM = 16
LR = 0.05
B = 64
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _ids(rng, vocab, shape):
    """Ids mostly in range, with negatives and ids past the table."""
    return rng.integers(-3, vocab + 3, size=shape).astype(np.int32)


# ------------------------------------------------- the sparse backward


def _layers(configs, dtype="float32"):
    jdt, tdt = DTYPES[dtype]
    jde = JaxDE(configs, world_size=1, compute_dtype=jdt)
    tde = DistributedEmbedding(configs, world_size=1, compute_dtype=tdt)
    rng = np.random.default_rng(1)
    tables = [rng.normal(size=(c["input_dim"], c["output_dim"]))
              .astype(np.float32) for c in configs]
    return (jde, jde.set_weights(tables, dtype=jdt),
            tde, tde.set_weights(tables, dtype=tdt, device="cpu"))


CONFIGS = [
    {"input_dim": 37, "output_dim": 16, "combiner": "sum"},
    {"input_dim": 50, "output_dim": 16, "combiner": "mean"},
    {"input_dim": 29, "output_dim": 8, "combiner": "mean"},
    {"input_dim": 64, "output_dim": 16, "combiner": None},
    {"input_dim": 23, "output_dim": 8, "combiner": "sum"},
]


def _streams(hot, dtype, invalid_slot=None):
    """Both packages' per-width streams for one batch of hotness ``hot``
    (``invalid_slot``: ``(group, slot)`` to mark a padding slot in both
    plans)."""
    jdt, tdt = DTYPES[dtype]
    jde, jparams, tde, tparams = _layers(CONFIGS, dtype)
    rng = np.random.default_rng(hot)
    cats = [_ids(rng, c["input_dim"], (B, hot) if c["combiner"] else (B,))
            for c in CONFIGS]
    _, jres = jde.forward_with_residuals(
        jde.local_view(jparams), [jnp.asarray(c) for c in cats])
    _, tres = tde.forward_with_residuals(
        tparams, [torch.from_numpy(c) for c in cats])
    if invalid_slot is not None:
        for de, res in ((jde, jres), (tde, tres)):
            plan = de._get_plan(list(res[2]), B)
            valid = [v.copy() for v in plan.valid]
            valid[invalid_slot[0]][0, invalid_slot[1]] = 0.0
            de._plan_cache[(tuple(res[2]), B)] = dataclasses.replace(
                plan, valid=tuple(valid))
    # every output is [B, w]: the combiner-less inputs are [B] ids
    grads = [rng.normal(size=(B, c["output_dim"])).astype(np.float32)
             for c in CONFIGS]
    jw = jax_apply.cotangent_width_streams(
        jde, jres, [jnp.asarray(g, jdt) for g in grads])
    tw = t_apply.cotangent_width_streams(
        tde, tres, [torch.from_numpy(g).to(tdt) for g in grads])
    return jde, tde, jw, tw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hot", [1, 3])
def test_cotangent_width_streams_match_jax(hot, dtype):
    """Ids (with the dropped-row sentinel for negative and out-of-range
    ids) and update rows (the ``/hot`` of mean slots) per width."""
    jde, tde, jw, tw = _streams(hot, dtype)
    assert sorted(jw) == sorted(tw) == ["w16", "w8"]
    for k in jw:
        assert len(jw[k]) == len(tw[k])
        for (ji, jv, jwd), (ti, tv, twd) in zip(jw[k], tw[k]):
            assert jwd == twd
            np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
            np.testing.assert_array_equal(to_np(tv), to_np(jv))
            sent = tde.rows_cap[twd]
            assert sent == jde.rows_cap[jwd]
            assert (to_np(ti) == sent).any()  # bad ids were dropped


def test_cotangent_streams_drop_padding_slots():
    """A padding slot (``valid`` 0 in the plan) trains nothing: all its
    ids become the sentinel, in both packages."""
    groups = DistributedEmbedding(CONFIGS, world_size=1)._get_plan(
        [("d", 3, 1) if c["combiner"] else ("d", 1, 1) for c in CONFIGS],
        B).groups
    gi = next(i for i, g in enumerate(groups) if g.n >= 2)
    k = sum(g.width == groups[gi].width for g in groups[:gi])
    jde, tde, jw, tw = _streams(3, "float32", invalid_slot=(gi, 1))
    for key in jw:
        for (ji, _, w), (ti, _, _) in zip(jw[key], tw[key]):
            np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
    ti = to_np(tw[f"w{groups[gi].width}"][k][0])  # [world, b, n, hot]
    assert (ti[:, :, 1] == tde.rows_cap[groups[gi].width]).all()
    assert (ti[:, :, 0] != tde.rows_cap[groups[gi].width]).any()


@pytest.mark.parametrize("hot", [1, 3])
def test_sparse_apply_gradients_matches_jax(hot):
    jde, jparams, tde, tparams = _layers(CONFIGS)
    rng = np.random.default_rng(10 + hot)
    cats = [_ids(rng, c["input_dim"], (B, hot) if c["combiner"] else (B,))
            for c in CONFIGS]
    # every output is [B, w]: the combiner-less inputs are [B] ids
    grads = [rng.normal(size=(B, c["output_dim"])).astype(np.float32)
             for c in CONFIGS]
    jlocal = jde.local_view(jparams)
    _, jres = jde.forward_with_residuals(jlocal, [jnp.asarray(c)
                                                  for c in cats])
    jnew, _ = jde.sparse_apply_gradients(
        jlocal, JaxSparseSGD().init(jlocal), jres,
        [jnp.asarray(g) for g in grads], JaxSparseSGD(), LR)
    _, tres = tde.forward_with_residuals(tparams,
                                         [torch.from_numpy(c) for c in cats])
    before = {k: v.clone() for k, v in tparams.items()}
    tnew, _ = tde.sparse_apply_gradients(
        tparams, SparseSGD().init(tparams), tres,
        [torch.from_numpy(g) for g in grads], SparseSGD(), LR)
    for k in tnew:  # in place: the returned views share the slabs
        assert tnew[k].data_ptr() == tparams[k].data_ptr()
    want = jde.get_weights(jde.stacked_view(jnew))
    got = tde.get_weights(tparams)
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7,
                                   err_msg=f"table {t}")
    assert any((tparams[k] != before[k]).any() for k in tparams)


# ------------------------------------------------- the train step


def _dlrm(dtype, lr_schedule=LR, nan_guard=True):
    """Both packages' (layer, dense module, state, step) from one state."""
    jdt, tdt = DTYPES[dtype]
    kw = dict(table_sizes=SIZES, embedding_dim=DIM,
              num_numerical_features=NUM, bottom_mlp_dims=(8, DIM),
              top_mlp_dims=(32, 16, 1))
    jcfg = JaxConfig(compute_dtype=jdt, **kw)
    tcfg = DLRMConfig(compute_dtype=tdt, **kw)
    jde = JaxDE(jcfg.embedding_configs(), world_size=1, compute_dtype=jdt)
    rng = np.random.default_rng(0)
    jparams = jde.set_weights(
        [rng.uniform(-s ** -0.5, s ** -0.5, size=(s, DIM)).astype(np.float32)
         for s in SIZES], dtype=jdt)
    jdense = JaxDense(jcfg)
    dp = jdense.init(jax.random.key(1), jnp.zeros((2, NUM)),
                     [jnp.zeros((2, DIM))] * len(SIZES))
    tx = optax.sgd(LR)
    jstate = JaxState(jparams, JaxSparseSGD().init(jparams), dp,
                      tx.init(dp), jnp.zeros((), jnp.int32))

    tde = DistributedEmbedding(tcfg.embedding_configs(), world_size=1,
                               compute_dtype=tdt)
    tdense = DLRMDense(tcfg, device="cpu")
    host = jax.tree.map(np.asarray, jstate)  # before any donating step
    tstate = hybrid_state_from_jax(
        tde, tdense, jde.get_weights(jstate.emb_params), host.dense_params,
        host.step, emb_opt_state=host.emb_opt_state,
        dense_opt_state=host.dense_opt_state, dtype=tdt, device="cpu")

    def jloss(p, outs, batch):
        n, y = batch
        return jax_bce(jdense.apply(p, n, outs), y)

    def tloss(m, outs, batch):
        n, y = batch
        return bce_with_logits(m(n, outs), y)

    jstep = jax_train_step(jde, jloss, tx, JaxSparseSGD(),
                           lr_schedule=lr_schedule, with_metrics=False,
                           nan_guard=nan_guard, telemetry=False)
    tstep = make_hybrid_train_step(tde, tloss, SGD(LR), SparseSGD(),
                                   lr_schedule=lr_schedule,
                                   nan_guard=nan_guard)
    return (jde, jstate, jstep), (tde, tstate, tstep), (jloss, tloss)


def _batches(n_steps, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        cats = [_ids(rng, s, (B,)) for s in SIZES]
        num = rng.normal(size=(B, NUM)).astype(np.float32)
        lab = (rng.random(B) < 0.3).astype(np.float32)
        out.append((cats, num, lab))
    return out


def _run(jax_side, torch_side, batches):
    jde, jstate, jstep = jax_side
    tde, tstate, tstep = torch_side
    jl, tl = [], []
    for cats, num, lab in batches:
        loss, jstate = jstep(jstate, [jnp.asarray(c) for c in cats],
                             (jnp.asarray(num), jnp.asarray(lab)))
        jl.append(float(loss))
        loss, tstate = tstep(tstate, [torch.from_numpy(c) for c in cats],
                             (torch.from_numpy(num), torch.from_numpy(lab)))
        tl.append(float(loss))
    return np.array(jl), np.array(tl), jstate, tstate


def _compare_state(jde, jstate, tde, tstate, atol_tables, atol_dense):
    jt = jde.get_weights(jstate.emb_params)
    tt = tde.get_weights(tstate.emb_params)
    for i, (g, w) in enumerate(zip(tt, jt)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                   atol=atol_tables(np.asarray(
                                       w, np.float32)), rtol=0,
                                   err_msg=f"table {i}")
    tree = jstate.dense_params["params"]
    names = sorted(tree, key=lambda k: int(k.split("_")[-1]))
    for name, lin in zip(names, tstate.dense_params.linears()):
        np.testing.assert_allclose(lin.weight.detach().numpy(),
                                   np.asarray(tree[name]["kernel"]).T,
                                   atol=atol_dense, rtol=0, err_msg=name)
        np.testing.assert_allclose(lin.bias.detach().numpy(),
                                   np.asarray(tree[name]["bias"]),
                                   atol=atol_dense, rtol=0, err_msg=name)
    assert int(tstate.step) == int(jstate.step)


def _ulps8(w):
    """8 bf16 ulps of the table's largest entry."""
    return 8 * 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dlrm_trajectory_matches_jax(dtype):
    """20 steps of the toy DLRM from one carried-over state."""
    js, ts, _ = _dlrm(dtype)
    before = [t.copy() for t in ts[0].get_weights(ts[1].emb_params)]
    jl, tl, jstate, tstate = _run(js, ts, _batches(20))
    assert np.isfinite(tl).all()
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
        _compare_state(js[0], jstate, ts[0], tstate,
                       lambda w: 1e-5, 1e-5)
    else:
        np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0)
        _compare_state(js[0], jstate, ts[0], tstate, _ulps8, 5e-3)
    after = ts[0].get_weights(tstate.emb_params)
    assert any((a != b).any() for a, b in zip(after, before))  # it trained


def test_scheduled_lr_trajectory_matches_jax():
    """A callable ``lr_schedule`` (called with the step tensor, giving a
    float32 lr on the device) over float32 tables."""
    js, ts, _ = _dlrm("float32", lr_schedule=lambda s: 0.2 / (1 + s))
    jl, tl, jstate, tstate = _run(js, ts, _batches(5, seed=4))
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    _compare_state(js[0], jstate, ts[0], tstate, lambda w: 1e-5, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_batch_skips_update_bitwise(dtype):
    """A NaN numerical batch: both packages return a non-finite loss,
    leave tables and dense params bitwise unchanged, advance ``step``,
    and train on from there."""
    js, ts, _ = _dlrm(dtype)
    batches = _batches(3, seed=5)
    jl, tl, jstate, tstate = _run(js, ts, batches[:1])
    host = jax.tree.map(np.asarray, jstate)
    t_tables = [t.copy() for t in ts[0].get_weights(tstate.emb_params)]
    t_dense = [p.detach().clone() for p in tstate.dense_params.parameters()]
    cats, num, lab = batches[1]
    num = num.copy()
    num[5, 2] = np.nan
    jl2, tl2, jstate, tstate = _run(js[:1] + (jstate, js[2]),
                                    ts[:1] + (tstate, ts[2]),
                                    [(cats, num, lab)])
    assert not np.isfinite(jl2).any() and not np.isfinite(tl2).any()
    for a, b in zip(ts[0].get_weights(tstate.emb_params), t_tables):
        np.testing.assert_array_equal(a, b)
    for p, q in zip(tstate.dense_params.parameters(), t_dense):
        assert torch.equal(p, q)
    assert int(tstate.step) == int(jstate.step) == 2
    for a, b in zip(js[0].get_weights(jstate.emb_params),
                    js[0].get_weights(host.emb_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, jstate.dense_params),
                 host.dense_params)
    jl3, tl3, _, _ = _run(js[:1] + (jstate, js[2]), ts[:1] + (tstate, ts[2]),
                          batches[2:])
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(tl3, jl3, atol=atol, rtol=0)


def test_train_loop_equals_single_steps():
    """``make_hybrid_train_loop`` over K stacked batches gives the losses
    and state of K single steps, bitwise (one code path)."""
    K = 4
    batches = _batches(K, seed=6)
    results = []
    for use_loop in (False, True):
        _, (tde, tstate, tstep), (_, tloss) = _dlrm("float32")
        if use_loop:
            loop = make_hybrid_train_loop(tde, tloss, SGD(LR), SparseSGD(),
                                          lr_schedule=LR, nan_guard=True)
            cat_stacks = [torch.from_numpy(np.stack([b[0][t] for b in
                                                     batches]))
                          for t in range(len(SIZES))]
            batch_stacks = (torch.from_numpy(np.stack([b[1] for b in
                                                       batches])),
                            torch.from_numpy(np.stack([b[2] for b in
                                                       batches])))
            losses, tstate = loop(tstate, cat_stacks, batch_stacks)
            assert losses.shape == (K,)
        else:
            losses = []
            for cats, num, lab in batches:
                loss, tstate = tstep(
                    tstate, [torch.from_numpy(c) for c in cats],
                    (torch.from_numpy(num), torch.from_numpy(lab)))
                losses.append(loss)
            losses = torch.stack(losses)
        results.append((losses, tde.get_weights(tstate.emb_params),
                        [p.detach().clone()
                         for p in tstate.dense_params.parameters()],
                        int(tstate.step)))
    (l0, t0, d0, s0), (l1, t1, d1, s1) = results
    assert torch.equal(l0, l1) and s0 == s1 == K
    for a, b in zip(t0, t1):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(d0, d1):
        assert torch.equal(a, b)


def test_init_hybrid_state_and_unported_arguments(monkeypatch):
    cfg = DLRMConfig(table_sizes=SIZES, embedding_dim=DIM,
                     num_numerical_features=NUM, bottom_mlp_dims=(8, DIM),
                     top_mlp_dims=(4, 1))
    de = DistributedEmbedding(cfg.embedding_configs(), world_size=1)
    dense = DLRMDense(cfg, device="cpu")
    state = init_hybrid_state(de, SparseSGD(), dense, SGD(LR),
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
    assert state.emb_opt_state == {"w16": ()} and state.dense_opt_state == ()
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_hybrid_state(de, SparseSGD(), dense, SGD(LR))
    args = (de, lambda *a: None, SGD(LR), SparseSGD())
    # step metrics are ported at world 1 and at world > 1
    assert callable(make_hybrid_train_step(*args, with_metrics=True))
    de2 = DistributedEmbedding(cfg.embedding_configs(), world_size=2)
    args2 = (de2, lambda *a: None, SGD(LR), SparseSGD())
    assert list(inspect.signature(make_hybrid_train_step(
        *args2, with_metrics=True, telemetry=True)).parameters) == [
        "state", "cat_inputs", "batch", "telem"]
    # the multi-rank step is ported: its mesh is the layer's process group
    with pytest.raises(ValueError, match="process group"):
        make_hybrid_train_step(*args, mesh=1)
    # streaming vocabularies are ported: dynamic= builds a step of the
    # streaming arity, which refuses a layer without a streaming table
    dyn = make_hybrid_train_step(*args, dynamic=True)
    assert list(inspect.signature(dyn).parameters) == [
        "state", "cat_inputs", "batch", "stream"]
    with pytest.raises(TypeError, match="StreamingConfig"):
        make_hybrid_train_step(*args, dynamic="on")
    # access telemetry is ported: an explicit opt-in, a TypeError otherwise
    assert callable(make_hybrid_train_step(*args, telemetry=True))
    with pytest.raises(TypeError, match="TelemetryConfig"):
        make_hybrid_train_step(*args, telemetry="on")
    monkeypatch.setenv("DETPU_OBS", "1")
    assert callable(make_hybrid_train_loop(*args))
    assert callable(make_hybrid_train_loop(*args2))
