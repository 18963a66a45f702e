"""The port's DLRM example at world 8: eight gloo ranks
(``torch_dist_worker.py:case_example``, one group for the file) run
``examples/dlrm_main.py``'s ``main`` at ``tests/test_torch_dlrm_example
.py``'s sizes (10 tables of 50, dim 8, b=64), against the JAX example's
program on its 8-device CPU mesh; and the launcher.

What is held, with its tolerance:
  - a JAX mesh checkpoint at step 3 of the JAX example's program (its
    ``synthetic_batches``, its schedule with base lr 960: its warmup
    scales that down ~2,000x at steps 3-5, where lr 24 would move a bf16
    table by less than the bf16 bound) resumed to step 6 by the port's
    example (``MpInputs`` and ``--dp_input``) and by JAX: at float32 the
    losses within 1e-5 (``tests/test_torch_dist_train.py``'s
    ``DLRM_BOUNDS``) and the dumped tables within 1e-6 (the world-1
    file's bound: the warmup steps move a table by 3e-5 to 1.4e-4, so
    ``DLRM_BOUNDS``' update bound of 1e-4 of that would be one float32
    ulp at the tables' magnitude, where the MLPs' summation order alone
    parts the two by 1-5 ulps, measured); at bf16 the losses within 1e-4
    and the tables within 2 bf16 ulps of each table's largest entry (the
    world-1 file's bound). Control: the checkpoint's own tables fail the
    table bound;
  - a save at step 3 resumed to step 6 equals the uninterrupted run bit
    for bit on every rank (losses, slabs, dense parameters and their
    optimizer state), with telemetry and step metrics on;
  - only rank 0 prints the JAX example's lines and writes files (each
    rank's ``--checkpoint_out`` lies in a directory of its own); every
    rank computes the same AUC;
  - ``--serve_qps`` with ``MpInputs`` prints JAX's skip line; with
    ``--dp_input`` it raises ``NotImplementedError`` naming the serving
    mesh, before training;
  - a rank of a group already joined runs without ``--init_method``,
    and only as its own rank of its own world;
  - ``launch`` starts two ranks whose losses agree, and fails as a whole
    with JAX's message when the world does not divide the batch.
"""

import functools
import importlib.util
import os
import sys

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

from distributed_embeddings_torch.examples import dlrm_main

from torch_dist_worker import RankGroup
from torch_world_ref import WORLD, mesh

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [50] * 10
LR = 960.0
ARGS = ["--batch_size", "64", "--table_sizes", ",".join(map(str, SIZES)),
        "--embedding_dim", "8", "--bottom_mlp_dims", "16,8",
        "--top_mlp_dims", "16,1", "--num_numerical_features", "4",
        "--learning_rate", str(LR)]
F32_LOSS = 1e-5  # DLRM_BOUNDS["float32"]'s loss bound
F32_TABLE = 1e-6  # tests/test_torch_dlrm_example.py's float32 table bound
BF16_LOSS, BF16_ULPS = 1e-4, 2  # tests/test_torch_dlrm_example.py's


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(WORLD, tmp_path_factory.mktemp("gloo_world_example"))
    yield g
    g.close()


@functools.lru_cache(maxsize=None)
def _jax_example_module():
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


@functools.lru_cache(maxsize=None)
def _jax_mesh_run(dtype, ck):
    """The JAX example's program on the mesh: 3 steps, a checkpoint at
    ``ck``, then JAX's own resume for steps 3-5. Returns (the checkpoint's
    tables, JAX's losses of steps 3-5, its tables after them)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    cfg = JaxConfig(table_sizes=SIZES, embedding_dim=8,
                    num_numerical_features=4, bottom_mlp_dims=[16, 8],
                    top_mlp_dims=[16, 1])
    de = JaxDE(cfg.embedding_configs(), world_size=WORLD,
               strategy="memory_balanced")
    dense = JaxDense(cfg)
    dp = dense.init(jax.random.key(0), jnp.zeros((2, 4), jnp.float32),
                    [jnp.zeros((2, 8), jnp.float32) for _ in SIZES])
    sched = jax_schedule(LR, warmup_steps=8000, decay_start_step=48000,
                         decay_steps=24000)
    tx = optax.sgd(sched)

    def loss_fn(p, outs, batch):
        n, y = batch
        return jax_bce(dense.apply(p, n, outs), y)

    st = jax_init_state(de, JaxSparseSGD(), dp, tx, jax.random.key(1),
                        mesh=mesh(), dtype=jdt)
    step = jax_train_step(de, loss_fn, tx, JaxSparseSGD(), mesh=mesh(),
                          lr_schedule=sched, with_metrics=False,
                          telemetry=False)
    batches = list(_jax_example_module().synthetic_batches(cfg, 6, 64))
    for num, cats, y in batches[:3]:
        _, st = step(st, cats, (num, y))
    jax_ckpt.save_train_state(ck, de, st)
    before = [np.asarray(t, np.float32) for t in de.get_weights(
        st.emb_params)]
    st = jax_ckpt.restore_train_state(ck, de, JaxSparseSGD(), dp, tx,
                                      mesh=mesh())
    losses = []
    for num, cats, y in batches[3:]:
        loss, st = step(st, cats, (num, y))
        losses.append(float(loss))
    return before, losses, [np.asarray(t, np.float32)
                            for t in de.get_weights(st.emb_params)]


def _dump(path):
    with np.load(str(path) + ".npz") as z:
        arrs = [z[f"arr_{i}"] for i in range(len(z.files))]
    return [(np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
             << 16).view(np.float32) if a.dtype.kind == "V" else a
            for a in arrs]


def _table_bound(dtype, got, before, after):
    """Whether tables ``got`` lie within the dtype's bound of JAX's
    ``after`` (float32: absolute; bf16: ulps of each table's largest
    entry)."""
    for a, c in zip(got, after):
        err = np.abs(a.astype(np.float64) - c).max()
        if dtype == "float32":
            if err > F32_TABLE:
                return False
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.abs(c).max())) - 7)
            if err > BF16_ULPS * ulp:
                return False
    return True


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_world8_example_resumes_a_jax_mesh_checkpoint(group, tmp_path,
                                                      tmp_path_factory,
                                                      dtype):
    ck = str(tmp_path_factory.getbasetemp() / f"jax_mesh_ck_{dtype}")
    out_dir = tmp_path / "out"
    (out_dir / "rank0").mkdir(parents=True)
    common = ARGS + ["--num_batches", "6", "--eval_batches", "0",
                     "--param_dtype", dtype, "--restore_state", ck]
    spec = dict(dir=str(out_dir), runs=[("mp", common),
                                        ("dp", common + ["--dp_input"])])
    before, jl, after = _jax_mesh_run(dtype, ck)  # writes ck first
    ranks = group.run("example", spec)
    loss_atol = F32_LOSS if dtype == "float32" else BF16_LOSS
    for mode in ("mp", "dp"):
        for r, got in enumerate(ranks):
            res = got[mode]
            np.testing.assert_allclose(res["losses"], jl, atol=loss_atol,
                                       rtol=0, err_msg=f"{mode} rank {r}")
            assert res["losses"] == ranks[0][mode]["losses"]
            assert (res["stdout"] != "") == (r == 0), (mode, r)
        assert "restored train state at step 3" in ranks[0][mode]["stdout"]
        got = _dump(out_dir / "rank0" / mode)
        assert _table_bound(dtype, got, before, after), mode
        for t, (a, b) in enumerate(zip(got, ranks[0][mode]["snap"][
                "tables"])):
            np.testing.assert_array_equal(a, b, err_msg=f"table {t}")
    assert not _table_bound(dtype, before, before, after)  # the control
    assert sorted(os.listdir(out_dir)) == ["rank0"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_world8_example_resume_is_bitwise_and_chief_only(group, tmp_path,
                                                         dtype):
    out_dir = tmp_path / "out"
    (out_dir / "rank0").mkdir(parents=True)
    st = str(tmp_path / "state")
    common = ARGS + ["--eval_interval", "3", "--eval_batches", "2",
                     "--param_dtype", dtype, "--serve_qps", "5"]
    spec = dict(dir=str(out_dir),
                env={"DETPU_TELEMETRY": "1", "DETPU_OBS": "1"},
                runs=[("full", common + ["--num_batches", "6"]),
                      ("first", common + ["--num_batches", "3",
                                          "--save_state", st]),
                      ("rest", common + ["--num_batches", "6",
                                         "--save_state", st, "--resume"])])
    ranks = group.run("example", spec)
    for r, got in enumerate(ranks):
        full, first, rest = got["full"], got["first"], got["rest"]
        assert first["losses"] + rest["losses"] == full["losses"], r
        a, b = full["snap"], rest["snap"]
        assert a["step"] == b["step"] == 6
        for k in a["emb"]:
            np.testing.assert_array_equal(a["emb"][k], b["emb"][k])
        for x, y in zip(a["dense"] + a["dense_opt"],
                        b["dense"] + b["dense_opt"]):
            np.testing.assert_array_equal(x, y)
        assert full["auc"] == ranks[0]["full"]["auc"]  # one global AUC
        for run in ("full", "first", "rest"):
            assert (got[run]["stdout"] != "") == (r == 0), (run, r)
    out = ranks[0]["rest"]["stdout"]
    assert "restored train state at step 3" in out, out
    assert "Evaluation completed, AUC:" in out
    assert "serving epilogue skipped" in out
    assert "eval step: 3 AUC:" in ranks[0]["full"]["stdout"]
    assert sorted(os.listdir(out_dir)) == ["rank0"]
    files = sorted(os.listdir(out_dir / "rank0"))
    assert files == ["first.metrics.jsonl", "first.npz", "full.metrics.jsonl",
                     "full.npz", "rest.metrics.jsonl", "rest.npz"], files
    assert os.path.isfile(st + ".telemetry.json")
    assert os.path.isfile(st + ".telemetry.json.state.npz")


def test_a_joined_rank_runs_only_as_its_own_rank(group, tmp_path):
    """In a group already joined the example takes no ``--init_method``
    and runs as the group's rank: another ``--rank`` or ``--world_size``
    raises ``ValueError`` on every rank before any collective. Control:
    the rank's own flags run."""
    argv = ARGS + ["--num_batches", "1", "--eval_batches", "0",
                   "--checkpoint_out", str(tmp_path / "emb")]
    ranks = group.run("joined_flags", dict(argv=argv, claims=[
        ("other_rank", WORLD, 1), ("other_world", 2 * WORLD, 0),
        ("own", WORLD, 0)]))
    for r, got in enumerate(ranks):
        assert f"not --rank {(r + 1) % WORLD} of --world_size {WORLD}" \
            in got["other_rank"], got["other_rank"]
        assert f"of --world_size {2 * WORLD}" in got["other_world"], got
        assert got["own"] == "ran", got["own"]


def test_serving_with_dp_input_at_world8_raises():
    with pytest.raises(NotImplementedError, match="serving mesh"):
        dlrm_main.main(ARGS + ["--world_size", "8", "--rank", "0",
                               "--backend", "gloo", "--dp_input",
                               "--serve_qps", "5", "--device", "cpu"])
    with pytest.raises(ValueError, match="--backend is required"):
        dlrm_main.main(ARGS + ["--world_size", "8", "--device", "cpu"])


def test_launch_runs_the_ranks_and_fails_as_a_whole(tmp_path):
    argv = ARGS + ["--num_batches", "3", "--eval_batches", "1",
                   "--checkpoint_out", str(tmp_path / "emb")]
    got = dlrm_main.main(argv + ["--world_size", "2", "--backend", "gloo",
                                 "--device", "cpu"])
    assert len(got) == 2 and got[0]["losses"] == got[1]["losses"]
    assert got[0]["steps_run"] == 3 and np.isfinite(got[0]["losses"]).all()
    assert os.path.isfile(str(tmp_path / "emb") + ".npz")
    bad = [a if a != "64" else "63" for a in argv]
    with pytest.raises(RuntimeError, match="must be divisible by the "
                                           "global device count 2"):
        dlrm_main.launch(bad, world_size=2, backend="gloo", device="cpu",
                         timeout_s=120)
