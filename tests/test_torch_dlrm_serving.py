"""The whole slice against the JAX package: a small DLRM (4 tables,
width 16, small MLPs) with the JAX tables and flax dense parameters
carried into the port (``utils/convert.py``).

* ``make_hybrid_eval_step`` logits: fp32 within atol 1e-5 (summation
  order in the MLP products), bf16 within atol 2e-2 (bf16 rounds at
  other places in the two frameworks' matmuls).
* ``ServingRuntime`` on the same request stream under manual clocks:
  the same typed outcomes (``Served`` with the same rung, ``Overloaded``
  with the same reason, ``Expired``), the same counts, padding and
  flushes per rung, and predictions (sigmoid of the logits) within the
  same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.models.dlrm import (
    DLRMConfig as JaxConfig, DLRMDense as JaxDense)
from distributed_embeddings_tpu.models.dlrm import (
    bce_with_logits as jax_bce, dot_interact as jax_dot)
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE, HybridTrainState as JaxState,
    make_hybrid_eval_step as jax_eval_step)
from distributed_embeddings_tpu.parallel import serving as jsv

from distributed_embeddings_torch.models import (
    DLRM, DLRMConfig, DLRMDense, bce_with_logits, dot_interact)
from distributed_embeddings_torch.parallel import (
    DistributedEmbedding, HybridTrainState, make_hybrid_eval_step)
from distributed_embeddings_torch.parallel import serving as tsv
from distributed_embeddings_torch.utils.convert import load_flax_dense

from torch_parity import to_np

torch.set_num_threads(1)

SIZES = [60, 7, 33, 120]
NUM = 5
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _configs(dtype):
    kw = dict(table_sizes=SIZES, embedding_dim=16,
              num_numerical_features=NUM, bottom_mlp_dims=(8, 16),
              top_mlp_dims=(32, 16, 1))
    return (JaxConfig(compute_dtype={"float32": jnp.float32,
                                     "bfloat16": jnp.bfloat16}[dtype], **kw),
            DLRMConfig(compute_dtype={"float32": torch.float32,
                                      "bfloat16": torch.bfloat16}[dtype],
                       **kw))


def _build(dtype):
    """Both packages' (layer, state, dense) over identical weights."""
    jcfg, tcfg = _configs(dtype)
    jde = JaxDE(jcfg.embedding_configs(), world_size=1,
                compute_dtype=jcfg.compute_dtype)
    rng = np.random.default_rng(0)
    jparams = jde.set_weights(
        [rng.uniform(-s ** -0.5, s ** -0.5, size=(s, 16)).astype(np.float32)
         for s in SIZES], dtype=jcfg.compute_dtype)
    jdense = JaxDense(jcfg)
    dp = jdense.init(jax.random.key(1), jnp.zeros((2, NUM)),
                     [jnp.zeros((2, 16))] * len(SIZES))
    jstate = JaxState(jparams, None, dp, None, jnp.zeros((), jnp.int32))

    tde = DistributedEmbedding(tcfg.embedding_configs(), world_size=1,
                               compute_dtype=tcfg.compute_dtype)
    tparams = tde.set_weights(jde.get_weights(jparams),
                              dtype=tcfg.compute_dtype, device="cpu")
    tdense = DLRMDense(tcfg, device="cpu")
    load_flax_dense(tdense, jax.tree.map(np.asarray, dp))
    tstate = HybridTrainState(emb_params=tparams, dense_params=tdense)
    return (jde, jdense, jstate), (tde, tdense, tstate)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_step_matches_jax(dtype):
    (jde, jdense, jstate), (tde, _, tstate) = _build(dtype)
    rng = np.random.default_rng(4)
    b = 24
    cats = [rng.integers(-1, s + 1, size=(b,)).astype(np.int32)
            for s in SIZES]
    num = rng.normal(size=(b, NUM)).astype(np.float32)
    want = jax_eval_step(jde, lambda dp, outs, n: jdense.apply(dp, n, outs))(
        jstate, [jnp.asarray(c) for c in cats], jnp.asarray(num))
    got = make_hybrid_eval_step(tde, lambda d, outs, n: d(n, outs))(
        tstate, [torch.from_numpy(c) for c in cats], torch.from_numpy(num))
    assert got.dtype == torch.float32 and got.shape == (b, 1)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=ATOL[dtype],
                               rtol=0)
    labels = (rng.random(b) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        float(bce_with_logits(got, torch.from_numpy(labels))),
        float(jax_bce(want, jnp.asarray(labels))), atol=ATOL[dtype])


def test_local_dlrm_and_dot_interact_shapes():
    """The single-device DLRM runs the same dense half over its own
    tables; dot_interact stacks the bottom output first."""
    _, tcfg = _configs("float32")
    model = DLRM(tcfg, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    cats = [torch.randint(0, s, (6,)) for s in SIZES]
    logits = model(torch.randn(6, NUM), cats)
    assert logits.shape == (6, 1) and torch.isfinite(logits).all()
    rng = np.random.default_rng(1)
    feats = [rng.normal(size=(3, 4)).astype(np.float32) for _ in range(4)]
    got = dot_interact([torch.from_numpy(f) for f in feats[1:]],
                       torch.from_numpy(feats[0]))
    want = jax_dot([jnp.asarray(f) for f in feats[1:]], jnp.asarray(feats[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _script():
    """(time, action, n, priority, deadline_ms): a quiet start, a burst
    that fills the ladder and reaches the shed level, a high-priority
    request admitted while shedding, and a request that expires."""
    ev = [(0.000, "submit", 3, 0, None), (0.001, "submit", 2, 0, None),
          (0.002, "poll",), (0.006, "poll",)]
    t = 0.010
    for k in range(7):
        ev.append((t, "submit", 4, 0, None))
        t += 0.0001
    ev += [(t, "submit", 2, 1, None), (t, "submit", 8, 0, None),
           (t + 0.0002, "poll",), (0.030, "submit", 1, 0, 2.0),
           (0.040, "poll",), (0.041, "submit", 5, 0, None),
           (0.041, "submit", 1, 2, None), (0.050, "flush",)]
    return ev


def _run(rt, clock, make_request):
    out = []
    for e in _script():
        clock.t = e[0]
        if e[1] == "submit":
            req = make_request(e[2], e[3])
            req.deadline_ms = e[4]
            rej = rt.submit(req)
            if rej is not None:
                out.append(rej)
        elif e[1] == "poll":
            out.extend(rt.poll())
        else:
            out.extend(rt.flush())
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_runtime_matches_jax(dtype):
    (jde, jdense, jstate), (tde, _, tstate) = _build(dtype)
    kw = dict(max_batch=16, max_wait_ms=5, deadline_ms=100, max_queue=32,
              shed_frac=0.5)
    jclock, tclock = _Clock(), _Clock()
    jrt = jsv.ServingRuntime(
        jde, lambda dp, outs, n: jax.nn.sigmoid(jdense.apply(dp, n, outs))[:, 0],
        jstate, config=jsv.ServeConfig(**kw), clock=jclock)
    trt = tsv.ServingRuntime(
        tde, lambda d, outs, n: torch.sigmoid(d(n, outs))[:, 0],
        tstate, config=tsv.ServeConfig(**kw), clock=tclock)
    assert trt.rungs == jrt.rungs == (8, 16)
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    tmpl = tsv.synthetic_request(np.random.default_rng(0), SIZES, 2,
                                 numerical=NUM)
    jrt.warmup((tmpl.cats, tmpl.batch))
    trt.warmup((tmpl.cats, tmpl.batch))

    def jreq(n, prio):
        return jsv.synthetic_request(jrng, SIZES, n, numerical=NUM,
                                     priority=prio)

    def treq(n, prio):
        r = tsv.synthetic_request(trng, SIZES, n, numerical=NUM,
                                  priority=prio)
        return r

    want = _run(jrt, jclock, jreq)
    got = _run(trt, tclock, treq)

    def key(r):
        return (type(r).__name__, r.rid, getattr(r, "rung", None),
                getattr(r, "reason", None))

    assert [key(r) for r in got] == [key(r) for r in want]
    kinds = {type(r).__name__ for r in got}
    assert kinds == {"Served", "Overloaded", "Expired"}
    for g, w in zip(got, want):
        if type(g).__name__ == "Served":
            np.testing.assert_allclose(g.predictions, to_np(w.predictions),
                                       atol=ATOL[dtype], rtol=0)
            assert sum(g.spans.values()) == pytest.approx(g.latency_ms,
                                                          abs=1e-9)
    ts, js = trt.stats(), jrt.stats()
    for k in ("served", "shed", "deadline_missed", "expired", "failed",
              "flushes", "served_samples", "degraded", "recovered",
              "level", "queued_samples", "pad_fraction", "rung_flushes"):
        assert ts[k] == js[k], k
    lat = np.asarray([r.latency_ms for r in got
                      if type(r).__name__ == "Served"])
    assert ts["latency_p99_ms"] == np.percentile(lat, 99, method="lower")
