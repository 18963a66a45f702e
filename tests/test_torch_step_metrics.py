"""The instrumented train step (``with_metrics=True``) at world 1 against
the JAX package's: the small DLRM, a ragged step, a telemetry step and a
streaming step, each from one state carried over to both packages, and
the DLRM example's ``--metrics_out`` sidecar.

Tolerances, with their reasons:
  - integer-valued metrics (``ids_routed``, ``id_overflow``,
    ``invalid_id_count``, ``skipped_steps``, ``step``, the exchange
    bytes, ``out_pad_frac``, ``table_nonfinite``, the ``stream_*``
    counts): exact;
  - the loss, the norms and ``table_update_maxabs``: rtol 1e-5, atol
    1e-7. The gradients come from matmuls and sums in other orders in
    the two frameworks (the same float32 tolerance the train-step
    parity tests hold the parameters to), and the norms' sums of
    squares are taken in other orders. A control (a metric of the next
    step) must fail the bound.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_tpu.analysis import telemetry as jtel
from distributed_embeddings_tpu.models.dlrm import (
    DLRMConfig as JaxConfig, DLRMDense as JaxDense,
    bce_with_logits as jax_bce)
from distributed_embeddings_tpu.ops.embedding_lookup import (
    Ragged as JRagged)
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE, HybridTrainState as JaxState)
from distributed_embeddings_tpu.parallel import optimizers as jopt
from distributed_embeddings_tpu.parallel import streaming as js
from distributed_embeddings_tpu.parallel.trainer import (
    make_hybrid_train_step as jax_train_step)

from distributed_embeddings_torch.analysis import telemetry as tel
from distributed_embeddings_torch.examples import dlrm_main
from distributed_embeddings_torch.models import (
    DLRMConfig, DLRMDense, bce_with_logits)
from distributed_embeddings_torch.ops import Ragged
from distributed_embeddings_torch.parallel import (
    SGD, DistributedEmbedding, HybridTrainState, SparseAdagrad, SparseSGD,
    StreamingConfig, init_streaming, make_hybrid_train_loop,
    make_hybrid_train_step)
from distributed_embeddings_torch.utils import obs
from distributed_embeddings_torch.utils.convert import hybrid_state_from_jax

from torch_parity import to_np

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-7
B, LR = 32, 0.05
EXACT = ("ids_routed", "id_overflow", "invalid_id_count", "skipped_steps",
         "step", "id_a2a_bytes", "out_a2a_bytes", "grad_a2a_bytes",
         "out_pad_frac", "table_nonfinite") + obs.STREAMING_METRIC_KEYS
SIZES = [60, 7, 33, 120]
DIM = 16
NUM = 5

#: a static and a streaming table (one-hot), a sum table with hot 3
D_CONFIGS = [{"input_dim": 50, "output_dim": 8},
             {"input_dim": 16 + 4, "output_dim": 8,
              "streaming": {"capacity": 16, "buckets": 4}},
             {"input_dim": 15, "output_dim": 8, "combiner": "sum"}]
#: ragged features: a sum table and a weighted mean table
R_CONFIGS = [{"input_dim": 40, "output_dim": 8, "combiner": "sum"},
             {"input_dim": 30, "output_dim": 8, "combiner": "mean"}]
R_CAP = 3 * B
SCFG = StreamingConfig(admit_min_count=2, evict_margin=1, depth=3,
                       buckets=37)
TCFG = tel.TelemetryConfig(depth=2, buckets=31, topk=4, candidates=8)


def _ids(rng, vocab, shape):
    """Ids mostly in range, with negatives and ids past the table."""
    return rng.integers(-3, vocab + 3, size=shape).astype(np.int32)


def assert_metrics_match(got, want, what=""):
    """Every JAX key present with its shape and dtype; exact where the
    value is a count, within (RTOL, ATOL) elsewhere."""
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g, w = to_np(got[k]), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        if k in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {k}")


# --------------------------------------------------------- the small DLRM


@functools.lru_cache(maxsize=None)
def _jax_dlrm():
    cfg = JaxConfig(table_sizes=SIZES, embedding_dim=DIM,
                    num_numerical_features=NUM, bottom_mlp_dims=(8, DIM),
                    top_mlp_dims=(16, 1))
    jde = JaxDE(cfg.embedding_configs(), world_size=1)
    rng = np.random.default_rng(0)
    tables = [rng.uniform(-s ** -0.5, s ** -0.5, size=(s, DIM))
              .astype(np.float32) for s in SIZES]
    jdense = JaxDense(cfg)
    dp = jdense.init(jax.random.key(1), jnp.zeros((2, NUM)),
                     [jnp.zeros((2, DIM))] * len(SIZES))
    tx = optax.sgd(LR)

    def jloss(p, outs, batch):
        n, y = batch
        return jax_bce(jdense.apply(p, n, outs), y)

    step = jax_train_step(jde, jloss, tx, jopt.SparseSGD(),
                          lr_schedule=LR, with_metrics=True, nan_guard=True,
                          telemetry=False)
    params = jde.set_weights(tables)
    host = jax.tree.map(np.asarray, JaxState(
        params, jopt.SparseSGD().init(params), dp, tx.init(dp),
        jnp.zeros((), jnp.int32)))
    return jde, step, host, tables


def _dlrm_port(host, tables):
    cfg = DLRMConfig(table_sizes=SIZES, embedding_dim=DIM,
                     num_numerical_features=NUM, bottom_mlp_dims=(8, DIM),
                     top_mlp_dims=(16, 1))
    tde = DistributedEmbedding(cfg.embedding_configs(), world_size=1)
    state = hybrid_state_from_jax(
        tde, DLRMDense(cfg, device="cpu"), tables, host.dense_params,
        host.step, emb_opt_state=host.emb_opt_state,
        dense_opt_state=host.dense_opt_state, device="cpu")

    def tloss(m, outs, batch):
        n, y = batch
        return bce_with_logits(m(n, outs), y)

    return tde, state, tloss


def _dlrm_batches(n, nan_at=None):
    rng = np.random.default_rng(3)
    out = []
    for k in range(n):
        cats = [_ids(rng, s, (B,)) for s in SIZES]
        num = rng.normal(size=(B, NUM)).astype(np.float32)
        lab = (rng.random(B) < 0.3).astype(np.float32)
        if k == nan_at:
            num[4, 1] = np.nan
        out.append((cats, num, lab))
    return out


def test_dlrm_step_metrics_match_jax():
    """Three guarded steps, the second a NaN batch: every metric of
    ``STEP_METRIC_KEYS``, with bad ids counted; then the control."""
    jde, jstep, host, tables = _jax_dlrm()
    jstate = jax.tree.map(jnp.asarray, host)
    tde, tstate, tloss = _dlrm_port(host, tables)
    tstep = make_hybrid_train_step(tde, tloss, SGD(LR), SparseSGD(),
                                   lr_schedule=LR, with_metrics=True,
                                   nan_guard=True)
    mets = []
    for k, (cats, num, lab) in enumerate(_dlrm_batches(3, nan_at=1)):
        jl, jstate, jm = jstep(jstate, [jnp.asarray(c) for c in cats],
                               (jnp.asarray(num), jnp.asarray(lab)))
        tl, tstate, tm = tstep(tstate, [torch.from_numpy(c) for c in cats],
                               (torch.from_numpy(num),
                                torch.from_numpy(lab)))
        assert set(obs.STEP_METRIC_KEYS) == set(tm)
        jm = {key: np.asarray(v) for key, v in jm.items()}
        assert_metrics_match(tm, jm, f"step {k}")
        assert int(tm["invalid_id_count"][0]) > 0
        assert int(tm["skipped_steps"][0]) == (k == 1)
        assert int(tm["step"][0]) == k
        mets.append(tm)
    # the control: step 2's norms against step 0's fail the bound
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(to_np(mets[2]["dense_grad_norm"]),
                                   to_np(mets[0]["dense_grad_norm"]),
                                   rtol=RTOL, atol=ATOL)


def test_loop_stacks_the_step_metrics():
    """``make_hybrid_train_loop(with_metrics=True)``: each metric stacked
    ``[K, ...]``, bitwise the single steps' from the same start."""
    _, _, host, tables = _jax_dlrm()
    batches = _dlrm_batches(3)
    runs = []
    for loop in (False, True):
        tde, state, tloss = _dlrm_port(host, tables)
        kw = dict(lr_schedule=LR, with_metrics=True, nan_guard=True)
        if loop:
            run = make_hybrid_train_loop(tde, tloss, SGD(LR), SparseSGD(),
                                         **kw)
            cats = [torch.from_numpy(np.stack([b[0][t] for b in batches]))
                    for t in range(len(SIZES))]
            batch = (torch.from_numpy(np.stack([b[1] for b in batches])),
                     torch.from_numpy(np.stack([b[2] for b in batches])))
            losses, state, mets = run(state, cats, batch)
        else:
            step = make_hybrid_train_step(tde, tloss, SGD(LR), SparseSGD(),
                                          **kw)
            per = []
            for c, n, y in batches:
                _, state, m = step(state, [torch.from_numpy(x) for x in c],
                                   (torch.from_numpy(n),
                                    torch.from_numpy(y)))
                per.append(m)
            mets = {k: torch.stack([m[k] for m in per]) for k in per[0]}
        runs.append(mets)
    assert runs[1]["loss"].shape == (3, 1)
    assert runs[1]["table_grad_norm"].shape == (3, 1, len(SIZES))
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


# ----------------------------------- ragged, telemetry, streaming steps


def _linear_loss_jax(dp, outs, y):
    x = jnp.concatenate([o.reshape(o.shape[0], -1) for o in outs], axis=1)
    return jnp.mean(((x @ dp["w"])[:, 0] - y) ** 2)


class _Dense(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))


def _linear_loss(m, outs, y):
    x = torch.cat([o.reshape(o.shape[0], -1) for o in outs], dim=1)
    return torch.mean(((x @ m.w)[:, 0] - y) ** 2)


def _configs(kind):
    return R_CONFIGS if kind == "ragged" else D_CONFIGS if \
        kind == "streaming" else [dict(c) for c in D_CONFIGS if
                                  "streaming" not in c]


@functools.lru_cache(maxsize=None)
def _jax_model(kind):
    configs = _configs(kind)
    jde = JaxDE(configs, world_size=1)
    rng = np.random.default_rng(5)
    weights = [rng.normal(size=(c["input_dim"], c["output_dim"]))
               .astype(np.float32) for c in configs]
    params = jde.set_weights(weights)
    width = sum(c["output_dim"] for c in configs)
    dp = {"w": jnp.asarray(rng.normal(size=(width, 1)) * 0.3, jnp.float32)}
    tx = optax.sgd(LR)
    opt = (jopt.SparseAdagrad() if kind == "streaming"
           else jopt.SparseSGD())
    step = jax_train_step(
        jde, _linear_loss_jax, tx, opt, lr_schedule=LR, with_metrics=True,
        nan_guard=True,
        telemetry=jtel.TelemetryConfig(*TCFG) if kind == "telemetry"
        else None,
        dynamic=js.StreamingConfig(*SCFG) if kind == "streaming" else None)
    host = jax.tree.map(np.asarray, JaxState(
        params, opt.init(params), dp, tx.init(dp), jnp.zeros((), jnp.int32)))
    return jde, step, host, weights


def _batch(kind, rng, nan=False):
    if kind == "ragged":
        cats = []
        for t, cfg in enumerate(R_CONFIGS):
            hots = rng.integers(0, 5, B)
            hots[-1] = R_CAP if t == 0 else 0  # past the capacity
            splits = np.zeros(B + 1, np.int32)
            np.cumsum(hots, out=splits[1:])
            vals = _ids(rng, cfg["input_dim"], (R_CAP,))
            w = (rng.uniform(0.5, 2, R_CAP).astype(np.float32) if t == 1
                 else None)
            cats.append((vals, splits, w))
    else:
        ext = 10 ** 6 + (rng.zipf(1.3, B) - 1) % 30
        cats = [_ids(rng, 50, (B,))]
        if kind == "streaming":
            cats.append(ext.astype(np.int32))
        cats.append(_ids(rng, 15, (B, 3)))
    y = rng.normal(size=B).astype(np.float32)
    if nan:
        y[3] = np.nan
    return cats, y


def _inputs(kind, cats, jax_side):
    if kind != "ragged":
        return ([jnp.asarray(c) for c in cats] if jax_side
                else [torch.from_numpy(c.copy()) for c in cats])
    if jax_side:
        return [JRagged(values=jnp.asarray(v), row_splits=jnp.asarray(s),
                        weights=None if w is None else jnp.asarray(w))
                for v, s, w in cats]
    return [Ragged(values=torch.from_numpy(v.copy()),
                   row_splits=torch.from_numpy(s.copy()),
                   weights=None if w is None else torch.from_numpy(w.copy()))
            for v, s, w in cats]


@pytest.mark.parametrize("kind", ["ragged", "telemetry", "streaming"])
def test_step_metrics_match_jax(kind):
    """Four guarded steps (the third a NaN batch) of the ragged (with
    claimed ids past the capacity), telemetry and streaming steps: every
    key of ``STEP_METRIC_KEYS`` (and of ``STREAMING_METRIC_KEYS`` on the
    streaming step) against JAX's."""
    jde, jstep, host, weights = _jax_model(kind)
    jstate = jax.tree.map(jnp.asarray, host)
    tde = DistributedEmbedding(_configs(kind), world_size=1)
    params = tde.set_weights(weights, device="cpu")
    dense = _Dense(np.asarray(host.dense_params["w"]))
    opt = SparseAdagrad() if kind == "streaming" else SparseSGD()
    tstate = HybridTrainState(params, opt.init(params), dense,
                              SGD(LR).init(list(dense.parameters())),
                              torch.zeros((), dtype=torch.int32))
    tstep = make_hybrid_train_step(
        tde, _linear_loss, SGD(LR), opt, lr_schedule=LR, with_metrics=True,
        nan_guard=True, telemetry=TCFG if kind == "telemetry" else None,
        dynamic=SCFG if kind == "streaming" else None)
    jaux, taux = (), ()
    if kind == "telemetry":
        jaux = (jtel.init_telemetry(jde, jtel.TelemetryConfig(*TCFG)),)
        taux = (tel.init_telemetry(tde, TCFG, device="cpu"),)
    elif kind == "streaming":
        jaux = (js.init_streaming(jde, js.StreamingConfig(*SCFG)),)
        taux = (init_streaming(tde, SCFG, device="cpu"),)
    keys = obs.STEP_METRIC_KEYS + (obs.STREAMING_METRIC_KEYS
                                   if kind == "streaming" else ())
    rng = np.random.default_rng(21)
    for k in range(4):
        cats, y = _batch(kind, rng, nan=k == 2)
        jl, jstate, jm, *jaux = jstep(jstate, _inputs(kind, cats, True),
                                      jnp.asarray(y), *jaux)
        tl, tstate, tm, *taux = tstep(tstate, _inputs(kind, cats, False),
                                      torch.from_numpy(y), *taux)
        assert set(tm) == set(keys)
        assert_metrics_match(tm, {key: np.asarray(v)
                                  for key, v in jm.items()},
                             f"{kind} step {k}")
        assert int(tm["skipped_steps"][0]) == (k == 2)
        if kind == "ragged":
            assert int(tm["id_overflow"][0]) > 0
            assert int(tm["invalid_id_count"][0]) > 0
        if kind == "streaming" and k == 2:
            assert all(float(tm[s][0]) == 0
                       for s in obs.STREAMING_METRIC_KEYS)


# ------------------------------------------------------ the example


def test_example_metrics_out_writes_parseable_records(tmp_path):
    """``--metrics_out``: a ``step_metrics`` record at steps 0 and 3 (the
    interval), then the final ``counters`` record, each line JSON with
    every key of ``STEP_METRIC_KEYS``."""
    path = str(tmp_path / "m.jsonl")
    dlrm_main.main(["--device", "cpu", "--batch_size", "64",
                    "--table_sizes", "50,40,30", "--embedding_dim", "8",
                    "--bottom_mlp_dims", "16,8", "--top_mlp_dims", "16,1",
                    "--num_numerical_features", "4", "--num_batches", "5",
                    "--eval_batches", "0",
                    "--checkpoint_out", str(tmp_path / "emb"),
                    "--metrics_out", path, "--metrics_interval", "3"])
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    recs = obs.MetricsLogger.load(path)
    assert len(recs) == len(lines) == 3
    assert [r["section"] for r in recs] == ["step_metrics", "step_metrics",
                                            "counters"]
    assert [r["step"] for r in recs[:2]] == [0, 3]
    for r in recs[:2]:
        assert set(r["metrics"]) == set(obs.STEP_METRIC_KEYS)
        assert r["metrics"]["step"] == [r["step"]]
        assert r["metrics"]["ids_routed"] == [3 * 64]
        assert len(r["metrics"]["table_grad_norm"][0]) == 3
    assert recs[2]["final"] is True
    assert not os.path.exists(str(tmp_path / "emb") + ".metrics.jsonl")
