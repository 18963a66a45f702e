"""The port's DLRM example (``distributed_embeddings_torch/examples/
dlrm_main.py``) on the CPU at the JAX smoke test's sizes
(``tests/test_dlrm_example.py``: 10 tables of 50, dim 8, b=64), in
process, and its data layer against the JAX package's.

What is held, with its tolerance:
  - the printed lines of the JAX example (eval cadence, the AUC early
    stop, the final eval, the dump): the same strings;
  - ``--param_dtype bfloat16``: the step runs the promoted scatter's
    plain version (K18's) once a step;
  - save at step 3, then ``--restore_state`` (or ``--resume``) to step
    6: the final state and the losses bitwise equal to an uninterrupted
    6-step run (float32 and bfloat16 tables);
  - cross-package: a checkpoint the JAX package wrote at step 3 of the
    JAX example's own program (its ``synthetic_batches``, its schedule),
    resumed by the port's example and by JAX: losses and the dumped
    tables within atol 1e-6 (float32; one state, the MLP summation order
    differs) or 2 bf16 ulps of each table's largest entry (bfloat16
    tables: a cotangent rounds to bf16 after MLP sums in another order);
  - ``synthetic_batches`` and ``RawBinaryDataset`` (with ``start_batch``,
    ``valid``, the data-parallel slice and ``fast_forward``): bitwise
    against the JAX package's.
"""

import functools
import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_tpu.models.dlrm import (
    DLRMConfig as JaxConfig, DLRMDense as JaxDense,
    bce_with_logits as jax_bce)
from distributed_embeddings_tpu.models.schedules import (
    warmup_poly_decay_schedule as jax_schedule)
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE, SparseSGD as JaxSparseSGD,
    init_hybrid_state as jax_init_state,
    make_hybrid_train_step as jax_train_step)
from distributed_embeddings_tpu.utils import checkpoint as jax_ckpt
from distributed_embeddings_tpu.utils import data as jax_data

from distributed_embeddings_torch.examples import dlrm_main
from distributed_embeddings_torch.models import DLRMConfig
from distributed_embeddings_torch.ops import scatter_add
from distributed_embeddings_torch.utils import data as tdata

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [50] * 10
ARGS = ["--device", "cpu", "--batch_size", "64",
        "--table_sizes", ",".join(map(str, SIZES)), "--embedding_dim", "8",
        "--bottom_mlp_dims", "16,8", "--top_mlp_dims", "16,1",
        "--num_numerical_features", "4", "--learning_rate", "0.1"]


def _main(tmp_path, extra, name="emb"):
    """Run the port's example in process; ``(stdout, RunResult)``."""
    out = io.StringIO()
    with redirect_stdout(out):
        res = dlrm_main.main(ARGS + ["--checkpoint_out",
                                     str(tmp_path / name)] + extra)
    return out.getvalue(), res


def _dump(path):
    """The ``--checkpoint_out`` tables as float32 (bf16 from its bits)."""
    with np.load(str(path) + ".npz") as z:
        arrs = [z[f"arr_{i}"] for i in range(len(z.files))]
    return [(np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
             << 16).view(np.float32) if a.dtype.kind == "V" else a
            for a in arrs]


def test_eval_interval_and_early_stop_print_the_jax_lines(tmp_path):
    """The JAX smoke test's run: eval at step 3, the threshold stop at
    step 3, no final eval; the dump is written."""
    out, res = _main(tmp_path, ["--num_batches", "8", "--eval_interval",
                                "3", "--eval_batches", "2",
                                "--auc_threshold", "0.0"])
    assert "eval step: 3 AUC:" in out, out
    assert "threshold 0.0 reached at step 3" in out, out
    assert "Evaluation completed" not in out, out
    assert res.stop_reason == "on_step" and res.steps_run == 4
    assert "step: 0  loss:" in out and "saved 10 tables to" in out
    out, res = _main(tmp_path, ["--num_batches", "4", "--eval_interval",
                                "0", "--eval_batches", "2"])
    assert "Evaluation completed, AUC:" in out, out
    assert "saved 10 tables" in out, out
    assert res.stop_reason == "exhausted" and 0.0 <= res.auc <= 1.0
    assert [t.shape for t in _dump(tmp_path / "emb")] == [(50, 8)] * 10


def test_bfloat16_tables_run_the_promoted_scatter(tmp_path, monkeypatch):
    """``--param_dtype bfloat16``: SparseSGD under the schedule takes the
    promoted chain (K18's plain version on the CPU), once a step."""
    calls = []
    plain = scatter_add.sgd_scatter_promoted_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(scatter_add, "sgd_scatter_promoted_plain", counted)
    _, res = _main(tmp_path, ["--num_batches", "3", "--eval_batches", "1",
                              "--param_dtype", "bfloat16"])
    assert len(calls) == 3 and np.isfinite(res.losses).all()
    assert all(v.dtype == torch.bfloat16
               for v in res.state.emb_params.values())
    with np.load(str(tmp_path / "emb") + ".npz") as z:
        assert z["arr_0"].dtype.str == "|V2"  # the JAX package's encoding


def _bits(state):
    out = [state.step.clone()]
    out += [v.clone() for _, v in sorted(state.emb_params.items())]
    out += [p.detach().clone() for p in state.dense_params.parameters()]
    out += [t.clone() for t in
            torch.utils._pytree.tree_leaves(state.dense_opt_state)]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_then_restore_equals_uninterrupted(tmp_path, dtype):
    """6 steps in one run against 3 steps, save, and a second run
    restored to step 6 (``--restore_state``; then ``--resume``)."""
    common = ["--eval_batches", "0", "--param_dtype", dtype]
    _, ref = _main(tmp_path, common + ["--num_batches", "6"])
    ck = str(tmp_path / "ck")
    _, first = _main(tmp_path, common + ["--num_batches", "3",
                                         "--save_state", ck])
    out, second = _main(tmp_path, common + ["--num_batches", "6",
                                            "--restore_state", ck])
    assert "restored train state at step 3 from" in out, out
    assert first.losses + second.losses == ref.losses
    assert int(second.state.step) == 6
    for a, b in zip(_bits(ref.state), _bits(second.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ck2 = str(tmp_path / "ck2")
    _main(tmp_path, common + ["--num_batches", "3", "--save_state", ck2,
                              "--checkpoint_interval", "2"])
    out, third = _main(tmp_path, common + ["--num_batches", "6",
                                           "--save_state", ck2, "--resume"])
    assert "restored train state at step 3" in out, out
    for a, b in zip(_bits(ref.state), _bits(third.state)):
        assert torch.equal(a, b)
    assert [s for s, _ in dlrm_main.checkpoint.rollback_candidates(ck2)] \
        == [6, 3, 2]


def test_unported_flags_and_no_card_raise(tmp_path, monkeypatch):
    """Flags whose machinery is not ported raise, naming it; the
    bootstrap flags are ported (at world 1 there is no group to join,
    and the run goes on); world > 1 needs an explicit backend."""
    out, res = _main(tmp_path, ["--num_batches", "1", "--eval_batches", "0",
                                "--bootstrap_timeout_s", "5",
                                "--bootstrap_retries", "0"])
    assert res.steps_run == 1 and "saved 10 tables" in out
    with pytest.raises(ValueError, match="--backend is required"):
        _main(tmp_path, ["--world_size", "2", "--rank", "0"])
    for extra, item in ((["--plan_audit", "warn"], "A4b"),
                        (["--checkpoint_time_s", "60"], "A12"),
                        (["--rollback_max", "1"], "A12"),
                        (["--quarantine_max", "1"], "A12")):
        with pytest.raises(NotImplementedError, match=item):
            _main(tmp_path, extra)
    # step metrics are ported: DETPU_OBS=1 writes the default sidecar
    monkeypatch.setenv("DETPU_OBS", "1")
    _main(tmp_path, ["--num_batches", "2"])
    recs = dlrm_main.obs.MetricsLogger.load(
        str(tmp_path / "emb") + ".metrics.jsonl")
    assert [r["section"] for r in recs] == ["step_metrics", "counters"]
    monkeypatch.delenv("DETPU_OBS")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dlrm_main.main(ARGS[2:] + ["--num_batches", "1"])


# ----------------------------------------------- against the JAX package


@functools.lru_cache(maxsize=None)
def _jax_example_module():
    """The JAX example's module (its ``synthetic_batches``)."""
    # one load a process: the module defines absl flags, which a second
    # load (another test file's, on the same worker) would define twice
    mod = sys.modules.get("_jax_dlrm_example")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "_jax_dlrm_example", os.path.join(_REPO, "examples", "dlrm",
                                              "main.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["_jax_dlrm_example"] = mod
    return mod


def test_synthetic_batches_equal_jax():
    jcfg = JaxConfig(table_sizes=[50, 1000, 7], embedding_dim=8,
                     num_numerical_features=4, bottom_mlp_dims=[16, 8],
                     top_mlp_dims=[16, 1])
    tcfg = DLRMConfig(table_sizes=[50, 1000, 7], embedding_dim=8,
                      num_numerical_features=4, bottom_mlp_dims=[16, 8],
                      top_mlp_dims=[16, 1])
    jb = list(_jax_example_module().synthetic_batches(jcfg, 3, 32, seed=1))
    tb = list(dlrm_main.synthetic_batches(tcfg, 3, 32, seed=1))
    for (jn, jc, jy), (tn, tc, ty) in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(jn), tn)
        np.testing.assert_array_equal(np.asarray(jy), ty)
        for a, b in zip(jc, tc):
            assert b.dtype == np.int32
            np.testing.assert_array_equal(np.asarray(a), b)


def _jax_program(dtype):
    """The JAX example's program at world 1 (its model, init keys,
    schedule and step), in process."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    cfg = JaxConfig(table_sizes=SIZES, embedding_dim=8,
                    num_numerical_features=4, bottom_mlp_dims=[16, 8],
                    top_mlp_dims=[16, 1])
    de = JaxDE(cfg.embedding_configs(), world_size=1,
               strategy="memory_balanced")
    dense = JaxDense(cfg)
    dp = dense.init(jax.random.key(0), jnp.zeros((2, 4), jnp.float32),
                    [jnp.zeros((2, 8), jnp.float32) for _ in SIZES])
    sched = jax_schedule(0.1, warmup_steps=8000, decay_start_step=48000,
                         decay_steps=24000)
    tx = optax.sgd(sched)

    def loss_fn(p, outs, batch):
        n, y = batch
        return jax_bce(dense.apply(p, n, outs), y)

    state = jax_init_state(de, JaxSparseSGD(), dp, tx, jax.random.key(1),
                           dtype=jdt)
    step = jax_train_step(de, loss_fn, tx, JaxSparseSGD(),
                          lr_schedule=sched, with_metrics=False,
                          telemetry=False)
    batches = list(_jax_example_module().synthetic_batches(cfg, 6, 64))
    return de, dense, dp, tx, state, step, batches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resume_from_a_jax_checkpoint_matches_jax(tmp_path, dtype):
    """JAX takes 3 steps of its example's program and saves; JAX resumes
    from that checkpoint for steps 3-5, and so does the port's example
    (``--restore_state``): the same losses and dumped tables within the
    stated tolerance."""
    de, dense, dp, tx, st, step, batches = _jax_program(dtype)
    for num, cats, y in batches[:3]:
        _, st = step(st, cats, (num, y))
    ck = str(tmp_path / "jax_ck")
    jax_ckpt.save_train_state(ck, de, st)
    st = jax_ckpt.restore_train_state(ck, de, JaxSparseSGD(), dp, tx)
    jl = []
    for num, cats, y in batches[3:]:
        loss, st = step(st, cats, (num, y))
        jl.append(float(loss))
    jtables = [np.asarray(t, np.float32) for t in de.get_weights(
        st.emb_params)]
    out, res = _main(tmp_path, ["--num_batches", "6", "--eval_batches",
                                "0", "--param_dtype", dtype,
                                "--restore_state", ck])
    assert "restored train state at step 3" in out, out
    got = _dump(tmp_path / "emb")
    if dtype == "float32":
        np.testing.assert_allclose(res.losses, jl, atol=1e-6, rtol=0)
        for a, b in zip(got, jtables):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(res.losses, jl, atol=1e-4, rtol=0)
        for a, b in zip(got, jtables):
            ulp = 2.0 ** (np.floor(np.log2(np.abs(b).max())) - 7)
            np.testing.assert_allclose(a, b, atol=2 * ulp, rtol=0)


def _write_dataset(root, n, sizes, numf):
    """A tiny Criteo split-binary dataset (the reader's layout)."""
    rng = np.random.default_rng(0)
    for split, rows in (("train", n), ("test", n // 2)):
        d = root / split
        d.mkdir(parents=True, exist_ok=True)
        (rng.random(rows) < 0.3).astype(np.bool_).tofile(d / "label.bin")
        rng.normal(size=(rows, numf)).astype(np.float16).tofile(
            d / "numerical.bin")
        for i, s in enumerate(sizes):
            rng.integers(0, s, size=rows).astype(
                tdata.get_categorical_feature_type(s)).tofile(
                d / f"cat_{i}.bin")
    (root / "model_size.json").write_text(
        json.dumps({f"c{i}": s - 1 for i, s in enumerate(sizes)}))


def test_raw_binary_dataset_equals_jax(tmp_path):
    sizes = [50, 300, 70000]
    _write_dataset(tmp_path, 200, sizes, 4)
    kw = dict(data_path=str(tmp_path), batch_size=32, numerical_features=4,
              categorical_features=[0, 1, 2],
              categorical_feature_sizes=sizes)
    cases = [dict(), dict(drop_last_batch=True, start_batch=2),
             dict(valid=True, prefetch_depth=1),
             dict(offset=8, lbs=16, dp_input=True, prefetch_depth=3)]
    for extra in cases:
        j = jax_data.RawBinaryDataset(**kw, **extra)
        t = tdata.RawBinaryDataset(**kw, **extra)
        assert len(j) == len(t)
        jb, tb = list(j), list(t)
        assert len(jb) == len(tb) > 0
        for (jn, jc, jy), (tn, tc, ty) in zip(jb, tb):
            np.testing.assert_array_equal(jn, tn)
            np.testing.assert_array_equal(jy, ty)
            for a, b in zip(jc, tc):
                np.testing.assert_array_equal(a, b)
    j = jax_data.RawBinaryDataset(**kw)
    t = tdata.RawBinaryDataset(**kw)
    for a, b in zip(jax_data.fast_forward(j, 3), tdata.fast_forward(t, 3)):
        np.testing.assert_array_equal(a[0], b[0])
    assert [x.dtype for x in tdata.DummyDataset(8, 4, [5, 6], 2)[0][1]] \
        == [np.int32, np.int32]
    assert tdata.get_categorical_feature_type(300) == np.int16


def test_example_trains_from_a_dataset_directory(tmp_path):
    """``--dataset_path``: vocabularies from ``model_size.json``, the
    train split streamed, the test split evaluated."""
    _write_dataset(tmp_path / "data", 256, [50, 30, 20], 4)
    out, res = _main(tmp_path, ["--dataset_path", str(tmp_path / "data"),
                                "--eval_interval", "2"])
    assert res.steps_run == 4 and "Evaluation completed, AUC:" in out
    assert "eval step: 2 AUC:" in out
